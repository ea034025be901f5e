"""The ``kubeml`` command line of the port: the port of
``kubeml_tpu/cli.py``. Run as ``python -m kubeml_tpu_torch.cli <command>``.

* ``start [--device cpu] [--backend gloo|nccl]`` boots the all-in-one
  cluster (``cluster.LocalCluster``) on the card unless ``--device cpu``;
  SIGTERM drains the serving decoders (frames to ``KUBEML_SNAP_DIR``) and
  shuts the cluster down with exit code 0. With ``KUBEML_COORDINATOR``,
  ``KUBEML_NUM_PROCESSES`` and ``KUBEML_PROCESS_ID`` set on every rank it
  joins the process group first (``parallel.distributed.
  init_distributed``): rank 0 boots the cluster, every other rank prints
  ``kubeml-tpu-torch follower r/N`` and runs ``engine.follower.
  run_follower`` until the leader shuts down; with ``KUBEML_SERVING_MESH``
  (e.g. ``tp=2``) set on every rank, ``/generate`` of a finished causal LM
  runs over the first ranks of the group;
* ``train``, ``infer``, ``generate`` (token arrays, ``--stream`` prints the
  deltas as they arrive);
* ``dataset create|delete|list``, ``function create|delete|get|list``;
* ``task list|stop|preempt|prune``, ``jobs``, ``decisions <id>``;
* ``history get|delete|list|prune``;
* ``checkpoint list|export|quantize|delete``;
* ``logs [--id ID] [--follow]``: a standalone job's own log
  (``<data root>/logs/job-<id>.log``, its runner writes it), else the
  cluster's ``logs/kubeml.log`` (``start`` writes it) filtered by the id.

``dataset create-text``, ``generate --text``, ``trace``, ``slo``, ``top``
and ``profile`` exit with code 2 and name the module they wait for (not
ported).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .api.config import get_config
from .api.errors import KubeMLError
from .api.types import TrainOptions, TrainRequest


def _client(args):
    from .controller.client import KubemlClient

    return KubemlClient(args.url)


def _print(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


def _print_table(cols, rows) -> None:
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    print("  ".join(c.ljust(widths[i]) for i, c in enumerate(cols)))
    for r in rows:
        print("  ".join(v.ljust(widths[i]) for i, v in enumerate(r)))


def _parse_mesh(spec: str) -> dict:
    """``ax=n[,ax=n...]`` as {axis: n}."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        axis, _, n = part.partition("=")
        if not axis or not n.isdigit() or int(n) < 1:
            raise ValueError(f"bad axis {part!r} (want name=positive int)")
        out[axis] = int(n)
    return out


def cmd_train(args) -> int:
    if not (0 < args.batch <= 1024):
        print("error: batch size must be in (0, 1024]", file=sys.stderr)
        return 1
    if args.resume and not args.id:
        print("error: --resume requires --id (the job id whose checkpoints "
              "to continue)", file=sys.stderr)
        return 1
    if args.goal_loss < 0:
        print("error: --goal-loss must be >= 0 (0 = off)", file=sys.stderr)
        return 1
    if args.goal_loss and args.engine != "spmd":
        print("error: --goal-loss is an SPMD-engine goal (eval loss); "
              "use --goal-accuracy for K-AVG jobs or add --engine spmd",
              file=sys.stderr)
        return 1
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = _parse_mesh(args.mesh) or None
        except ValueError as e:
            print(f"error: --mesh {e}", file=sys.stderr)
            return 1
    req = TrainRequest(
        job_id=args.id or "", model_type=args.function,
        batch_size=args.batch, epochs=args.epochs, dataset=args.dataset,
        lr=args.lr, function_name=args.function,
        options=TrainOptions(
            default_parallelism=args.parallelism,
            static_parallelism=args.static,
            k=-1 if args.sparse_avg else args.k,
            validate_every=args.validate_every,
            goal_accuracy=args.goal_accuracy, goal_loss=args.goal_loss,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            save_model=not args.no_save_model, chaos_prob=args.chaos_prob,
            engine=args.engine, mesh_shape=mesh_shape,
            priority=args.priority, tenant=args.tenant))
    print(_client(args).networks().train(req))
    return 0


def cmd_infer(args) -> int:
    import numpy as np

    data = np.load(args.datafile, allow_pickle=False)
    _print(_client(args).networks().infer(args.network, data))
    return 0


def cmd_generate(args) -> int:
    import numpy as np

    if args.text is not None:
        return _not_ported("generate --text", "data/text.py, data/bpe.py")
    prompts = np.load(args.datafile, allow_pickle=False)
    kw = dict(max_new_tokens=args.max_new_tokens,
              temperature=args.temperature, top_k=args.top_k,
              eos_id=args.eos_id, seed=args.seed)
    net = _client(args).networks()
    if args.stream:
        for rec in net.generate(args.network, prompts, stream=True, **kw):
            if "error" in rec:
                print(f"error: {rec['error']}", file=sys.stderr)
                return 1
            _print(rec)
        return 0
    out = net.generate(args.network, prompts, **kw)
    if args.output:
        np.save(args.output, np.asarray(out["tokens"], np.int32))
        print(f"{args.output}: {np.asarray(out['tokens']).shape} tokens, "
              f"lengths {out['lengths']}")
    else:
        _print(out)
    return 0


def cmd_dataset(args) -> int:
    c = _client(args).datasets()
    if args.action == "create":
        _print(c.create(args.name, args.traindata, args.trainlabels,
                        args.testdata, args.testlabels).to_dict())
    elif args.action == "delete":
        c.delete(args.name)
        print(f"deleted {args.name}")
    else:
        _print([d.to_dict() for d in c.list()])
    return 0


def cmd_function(args) -> int:
    c = _client(args).functions()
    if args.action == "create":
        _print(c.create(args.name, args.code))
    elif args.action == "delete":
        c.delete(args.name)
        print(f"deleted {args.name}")
    elif args.action == "get":
        _print(c.get(args.name))
    else:
        _print(c.list())
    return 0


def cmd_task(args) -> int:
    c = _client(args).tasks()
    if args.action == "list":
        tasks = c.list()
        if args.short:
            for t in tasks:
                print(t.job_id)
        else:
            _print([t.to_dict() for t in tasks])
    elif args.action == "stop":
        c.stop(args.id)
        print(f"stopped {args.id}")
    elif args.action == "preempt":
        c.preempt(args.id, reason=args.reason, grace=args.grace)
        print(f"preempting {args.id} (checkpoint-and-yield)")
    elif args.action == "prune":
        print(f"pruned {c.prune()} tasks")
    return 0


def cmd_jobs(args) -> int:
    """Queued (pop order), running and preempted jobs with their priority,
    tenant and, for a preempted job, the epoch a resume restarts at."""
    jobs = _client(args).tasks().jobs()
    if args.json:
        _print(jobs)
        return 0
    if not jobs:
        print("no jobs")
        return 0
    cols = ("JOB", "STATUS", "PRIO", "TENANT", "FUNCTION", "RESUME@")
    rows = [(j.get("job_id", ""), j.get("status", ""),
             str(j.get("priority", 0)), j.get("tenant", "") or "-",
             j.get("function", "") or "-",
             str(j["resume_epoch"]) if "resume_epoch" in j else "-")
            for j in jobs]
    _print_table(cols, rows)
    return 0


def cmd_decisions(args) -> int:
    """A job's scale decisions: the transition, its reason and the policy
    inputs behind it."""
    data = _client(args).tasks().decisions(args.id)
    if args.json:
        _print(data)
        return 0
    decisions = data.get("decisions", [])
    if not decisions:
        print(f"no scale decisions recorded for job {args.id}")
        return 0

    def num(v, nd=2):
        return "-" if v is None else f"{v:.{nd}f}"

    cols = ("TIME", "SEQ", "FROM", "TO", "DIR", "REASON", "ELAPSED",
            "CACHED", "CAP")
    rows = []
    for d in decisions:
        inputs = d.get("inputs", {})
        rows.append((time.strftime("%H:%M:%S", time.localtime(d.get("t", 0))),
                     str(d.get("seq", "")), str(d.get("from", "")),
                     str(d.get("to", "")), d.get("direction", "?"),
                     d.get("reason", "?"), num(inputs.get("elapsed")),
                     num(inputs.get("cached")), str(inputs.get("cap", "-"))))
    _print_table(cols, rows)
    dropped = data.get("total", len(decisions)) - len(decisions)
    if dropped > 0:
        print(f"({dropped} older decision(s) beyond the retention window; "
              f"raise KUBEML_DECISION_LOG_SIZE to keep more)")
    return 0


def cmd_history(args) -> int:
    c = _client(args).histories()
    if args.action == "get":
        _print(c.get(args.id).to_dict())
    elif args.action == "delete":
        c.delete(args.id)
        print(f"deleted {args.id}")
    elif args.action == "prune":
        print(f"pruned {c.prune()} histories")
    else:
        _print([h.to_dict() for h in c.list()])
    return 0


def cmd_checkpoint(args) -> int:
    c = _client(args).checkpoints()
    if args.action == "list":
        if args.id:
            _print({"job": args.id, "checkpoints": c.list(args.id)})
        else:
            _print(c.list_jobs())
    elif args.action == "export":
        dest = c.export(args.id, args.out, epoch=args.epoch)
        print(f"exported {args.id} -> {dest}")
    elif args.action == "quantize":
        out = c.quantize(args.id)
        print(f"quantized {args.id} -> tag {out['tag']} ({out['form']})")
    elif args.action == "delete":
        c.delete(args.id)
        print(f"deleted checkpoints of {args.id}")
    return 0


def _not_ported(command: str, module: str) -> int:
    print(f"error: {command} needs {module}, which is not ported to "
          f"kubeml_tpu_torch yet", file=sys.stderr)
    return 2


# commands whose modules wait for a later port
_UNPORTED = {
    "trace": "utils/tracing.py, ps/traces.py",
    "slo": "ps/slo.py",
    "top": "utils/timeseries.py",
    "profile": "utils/profiler.py",
}


def cmd_logs(args) -> int:
    """The job's runner log first (``logs/job-<id>.log``), else the
    cluster log filtered by the id (JAX cli.py:387-420)."""
    cfg = get_config()
    per_job = args.id is not None and cfg.logs_dir / f"job-{args.id}.log"
    if per_job and per_job.exists():
        log_file = per_job
    else:
        log_file = cfg.logs_dir / "kubeml.log"
    if not log_file.exists():
        print(f"no log file at {log_file}", file=sys.stderr)
        return 1
    filter_id = None if log_file == per_job else args.id
    with open(log_file) as f:
        for line in f:
            if filter_id is None or filter_id in line:
                print(line.rstrip())
    if args.follow:
        with open(log_file) as f:
            f.seek(0, 2)
            try:
                while True:
                    line = f.readline()
                    if not line:
                        time.sleep(0.5)
                        continue
                    if filter_id is None or filter_id in line:
                        print(line.rstrip(), flush=True)
            except KeyboardInterrupt:
                pass
    return 0


def cmd_start(args) -> int:
    import logging
    import signal
    import threading

    from .cluster import LocalCluster
    from .parallel.distributed import (init_distributed, process_count,
                                       process_index)

    cfg = get_config()
    cfg.ensure_dirs()
    cfg.logs_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(cfg.logs_dir / "kubeml.log")])
    # a cluster over ranks: rank 0 boots the control plane, every other
    # rank follows its job announcements (JAX cli.py:805-825)
    if init_distributed(backend=args.backend, device=args.device) and \
            process_index() > 0:
        from .engine.follower import run_follower

        print(f"kubeml-tpu-torch follower {process_index()}/"
              f"{process_count()}", flush=True)
        run_follower(config=cfg)
        return 0
    stop = threading.Event()
    # SIGTERM: the PS drains its decoders first (PSAPI.start chains to
    # this handler), then the cluster shuts down and the process exits 0
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    with LocalCluster(config=cfg, device=args.device) as cluster:
        print(f"kubeml-torch cluster running on {cluster.ps.device}; "
              f"controller at {cluster.controller_url}; ps at "
              f"{cluster.ps_api.url}", flush=True)
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        print("shutting down", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeml",
                                description="kubeml CLI (PyTorch port)")
    p.add_argument("--url", default=None,
                   help="controller URL (default from config)")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="submit a train job")
    t.add_argument("--function", "-f", required=True)
    t.add_argument("--dataset", "-d", required=True)
    t.add_argument("--epochs", "-e", type=int, default=1)
    t.add_argument("--batch", "-b", type=int, default=64)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--parallelism", "-p", type=int, default=4)
    t.add_argument("--static", action="store_true", help="freeze parallelism")
    t.add_argument("--k", "-K", type=int, default=16,
                   help="K-AVG sync period")
    t.add_argument("--sparse-avg", action="store_true",
                   help="one sync per epoch (K=-1)")
    t.add_argument("--validate-every", type=int, default=1)
    t.add_argument("--goal-accuracy", type=float, default=100.0)
    t.add_argument("--goal-loss", type=float, default=0.0,
                   help="SPMD: early-stop when eval loss <= this "
                        "(perplexity target P -> ln P); 0 = off")
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a checkpoint every N epochs (0 = off)")
    t.add_argument("--id", default=None,
                   help="explicit job id (required for --resume)")
    t.add_argument("--resume", action="store_true",
                   help="resume from --id's latest checkpoint")
    t.add_argument("--no-save-model", action="store_true",
                   help="skip the final model export")
    t.add_argument("--chaos-prob", type=float, default=0.0,
                   help="per-worker per-round failure probability")
    t.add_argument("--engine", choices=["kavg", "spmd"], default="kavg",
                   help="kavg = elastic local SGD; spmd = mesh training "
                        "(LLMs; one card or the cluster's ranks)")
    t.add_argument("--priority", type=int, default=0,
                   help="priority class 0-1000 (higher pops first)")
    t.add_argument("--tenant", default="",
                   help="fair-share tenant")
    t.add_argument("--mesh", default=None,
                   help="kavg: the worker axis, e.g. worker=2; spmd: mesh "
                        "axes over the cluster's ranks, e.g. tp=2 or "
                        "ep=2,tp=2 (dp fills the rest)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="run inference against a trained job")
    i.add_argument("--network", "-n", required=True,
                   help="job id of the model")
    i.add_argument("--datafile", required=True, help=".npy file of inputs")
    i.set_defaults(fn=cmd_infer)

    g = sub.add_parser("generate",
                       help="sample continuations from a trained causal LM")
    g.add_argument("--network", "-n", required=True,
                   help="job id of the model")
    gsrc = g.add_mutually_exclusive_group(required=True)
    gsrc.add_argument("--datafile", default=None,
                      help=".npy int array [batch, prompt_len] of token ids")
    gsrc.add_argument("--text", default=None,
                      help="prompt as text (not ported)")
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples (seeded by --seed)")
    g.add_argument("--top-k", type=int, default=None)
    g.add_argument("--eos-id", type=int, default=None)
    g.add_argument("--seed", type=int, default=None,
                   help="sampling seed (required when --temperature > 0)")
    g.add_argument("--output", "-o", default=None,
                   help="write tokens to this .npy instead of stdout")
    g.add_argument("--stream", action="store_true",
                   help="print token deltas as they are generated")
    g.set_defaults(fn=cmd_generate)

    d = sub.add_parser("dataset", help="manage datasets")
    dsub = d.add_subparsers(dest="action", required=True)
    dc = dsub.add_parser("create")
    dc.add_argument("--name", "-n", required=True)
    dc.add_argument("--traindata", required=True)
    dc.add_argument("--trainlabels", required=True)
    dc.add_argument("--testdata", required=True)
    dc.add_argument("--testlabels", required=True)
    dt = dsub.add_parser("create-text", help="text corpora (not ported)")
    dt.set_defaults(fn=lambda a: _not_ported("dataset create-text",
                                             "data/text.py"), unported=True)
    dd = dsub.add_parser("delete")
    dd.add_argument("--name", "-n", required=True)
    dsub.add_parser("list")
    d.set_defaults(fn=cmd_dataset)

    f = sub.add_parser("function", aliases=["fn"], help="manage functions")
    fsub = f.add_subparsers(dest="action", required=True)
    fc = fsub.add_parser("create")
    fc.add_argument("--name", "-n", required=True)
    fc.add_argument("--code", required=True,
                    help="path to the .py source file")
    fd = fsub.add_parser("delete")
    fd.add_argument("--name", "-n", required=True)
    fg = fsub.add_parser("get")
    fg.add_argument("--name", "-n", required=True)
    fsub.add_parser("list")
    f.set_defaults(fn=cmd_function)

    k = sub.add_parser("task", help="manage running tasks")
    ksub = k.add_subparsers(dest="action", required=True)
    kl = ksub.add_parser("list")
    kl.add_argument("--short", action="store_true")
    ks = ksub.add_parser("stop")
    ks.add_argument("--id", required=True)
    kp = ksub.add_parser("preempt",
                         help="checkpoint-and-yield a running job (it is "
                              "requeued with resume=True)")
    kp.add_argument("--id", required=True)
    kp.add_argument("--reason", default="operator")
    kp.add_argument("--grace", type=float, default=None,
                    help="seconds before the job is abandoned (default: "
                         "KUBEML_PREEMPT_GRACE)")
    ksub.add_parser("prune")
    k.set_defaults(fn=cmd_task)

    j = sub.add_parser("jobs", help="queued/running/preempted jobs")
    j.add_argument("--json", action="store_true", help="raw JSON output")
    j.set_defaults(fn=cmd_jobs)

    dec = sub.add_parser("decisions",
                         help="a job's elastic scale-decision audit trail")
    dec.add_argument("id", help="job id")
    dec.add_argument("--json", action="store_true", help="raw JSON payload")
    dec.set_defaults(fn=cmd_decisions)

    h = sub.add_parser("history", help="training histories")
    hsub = h.add_subparsers(dest="action", required=True)
    hg = hsub.add_parser("get")
    hg.add_argument("--id", required=True)
    hd = hsub.add_parser("delete")
    hd.add_argument("--id", required=True)
    hsub.add_parser("list")
    hsub.add_parser("prune")
    h.set_defaults(fn=cmd_history)

    c = sub.add_parser("checkpoint", help="manage saved models")
    csub = c.add_subparsers(dest="action", required=True)
    cl = csub.add_parser("list")
    cl.add_argument("--id", default=None, help="job id (default: all jobs)")
    ce = csub.add_parser("export")
    ce.add_argument("--id", required=True)
    ce.add_argument("--out", required=True, help="destination .npz path")
    ce.add_argument("--epoch", type=int, default=None)
    cq = csub.add_parser("quantize", help="write the final-int8 export")
    cq.add_argument("--id", required=True)
    cd = csub.add_parser("delete")
    cd.add_argument("--id", required=True)
    c.set_defaults(fn=cmd_checkpoint)

    lg = sub.add_parser("logs", help="show cluster logs")
    lg.add_argument("--id", default=None, help="filter by job id")
    lg.add_argument("--follow", "-f", action="store_true")
    lg.set_defaults(fn=cmd_logs)

    for name, module in _UNPORTED.items():
        u = sub.add_parser(name, help=f"not ported ({module})")
        u.set_defaults(fn=lambda a, n=name, m=module: _not_ported(n, m),
                       unported=True)

    s = sub.add_parser("start", help="boot the all-in-one local cluster")
    s.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the card)")
    s.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend over ranks (default: "
                        "nccl for CUDA ranks, gloo for CPU ranks; gloo lets "
                        "ranks share a card)")
    s.set_defaults(fn=cmd_start)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    # the commands that are not ported take any arguments and refuse
    args, extra = parser.parse_known_args(argv)
    if extra and not getattr(args, "unported", False):
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return args.fn(args)
    except KubeMLError as e:
        print(f"error: {e.message}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
