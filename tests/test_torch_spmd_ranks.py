"""The port's SPMD job over ranks (``engine/follower.py``, ``engine/
spmd_job.py`` over a ``DistContext``, the sharded store written by every
rank, ``ps/parameter_server.py``'s job announcement, ``cluster.py`` on
rank 0) against the JAX package's ``SPMDJob`` on as many host devices.

Rank ``r`` of the port stands for JAX device ``r`` (``parallel/mesh.py``):
a job over a world of N gloo ranks on the CPU is held against JAX's job
over ``jax.devices()[:N]`` in this process (conftest's 8 host devices).
The model is JAX ``tests/test_spmd_job.py``'s (vocab 64, max_len 16, E 32,
depth 2, 4 heads, f32); both jobs resume from one flat checkpoint that
JAX wrote of its initial weights, so they start equal. The ranks run in
``tests/torch_job_ranks.py``, which imports no JAX.

Tolerances (as ``tests/test_torch_spmd_job.py``'s one-card parity):
per-epoch train and eval losses within rel 1e-4 (f32; over ranks the
cross-entropy and the gradients are summed in other orders), next-token
accuracy within 0.5 points (two of the test split's 480 predictions, the
room near ties leave); checkpoints crossing between the packages
bit-equal.
"""

import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_job_ranks as J
from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.api.types import TrainOptions as JOptions
from kubeml_tpu.api.types import TrainRequest as JRequest
from kubeml_tpu.engine.spmd_job import SPMDJob as JSPMDJob
from kubeml_tpu.functions.registry import FunctionRegistry as JRegistry
from kubeml_tpu.storage import CheckpointStore as JCheckpointStore
from kubeml_tpu.storage import HistoryStore as JHistoryStore
from kubeml_tpu.storage import ShardStore as JShardStore
from kubeml_tpu.storage.sharded_checkpoint import \
    ShardedCheckpointStore as JShardedStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import TrainOptions
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax, leaf_block
from kubeml_tpu_torch.storage import ShardStore
from kubeml_tpu_torch.storage.sharded_checkpoint import ShardedCheckpointStore
from torch_port_helpers import numpy_tree

JAX_LM_FN = """
import optax
from kubeml_tpu.runtime.model import KubeModel
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.gpt import CausalTransformer

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return CausalTransformer(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=2, num_heads=4, mesh=self.mesh)
    def configure_optimizers(self):
        return optax.adamw(self.lr)
"""

TP2 = dict(mesh_shape={"tp": 2}, static_parallelism=True)
# the elastic job: tp=2 over 4, the scheduler answers 2, then 4 (and 4
# after the last epoch, which changes nothing)
LEVELS = [2, 4, 4]
# the sharded job: 2 epochs under tp=2, resumed under sp=2 for a third
SHARDED = dict(static_parallelism=True, sharded_checkpoints=True,
               checkpoint_every=1)
ATTOL = 0.5


def _data(root_cfg, store, registry, src):
    xtr, xte = J.token_data(128, 1), J.token_data(32, 2)
    root_cfg.ensure_dirs()
    store(config=root_cfg).create("tokens", xtr, np.zeros(128, np.int64),
                                  xte, np.zeros(32, np.int64))
    registry(config=root_cfg).create("lmfn", src)


def _jax_request(epochs, **opts):
    opts.setdefault("engine", "spmd")
    opts.setdefault("precision", "f32")
    opts.setdefault("validate_every", 1)
    return JRequest(batch_size=16, epochs=epochs, dataset="tokens", lr=1e-3,
                    function_name="lmfn", options=JOptions(**opts))


def _jax_job(jcfg, jid, req, n, on_epoch_end=None):
    model = JRegistry(config=jcfg).load("lmfn")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    return JSPMDJob(jid, req, model, store=JShardStore(config=jcfg),
                    history_store=JHistoryStore(config=jcfg),
                    checkpoint_store=JCheckpointStore(config=jcfg),
                    devices=jax.devices()[:n], on_epoch_end=on_epoch_end)


def _history(h):
    return dict(train_loss=list(h.train_loss),
                validation_loss=list(h.validation_loss),
                accuracy=list(h.accuracy), parallelism=list(h.parallelism))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The JAX and the port data roots (the token set and an ``lmfn`` of
    each package), the JAX initial weights as a flat ``final`` at epoch 0
    under every job id both packages resume, and the JAX package's own
    runs: tp=2 on 2 and on 4 devices, and the elastic run on 4."""
    tmp = tmp_path_factory.mktemp("spmd_ranks")
    jcfg = JConfig(data_root=tmp / "jax")
    pcfg = Config(data_root=tmp / "port")
    _data(jcfg, JShardStore, JRegistry, JAX_LM_FN)
    _data(pcfg, ShardStore, FunctionRegistry, J.LM_FN)
    init = _jax_job(jcfg, "init", _jax_request(1), 1)
    init.trainer.init(jax.random.PRNGKey(0),
                      next(init._token_batches("train", 16)))
    weights = numpy_tree(init.trainer.params)
    for jid in ("tp2w2", "tp2w4", "elastic"):
        path = JCheckpointStore(config=jcfg).save(
            jid, weights, epoch=0, tag="final", meta={})
        dst = pcfg.checkpoints_dir / jid
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dst / path.name)
    runs = {}
    for jid, n in (("tp2w2", 2), ("tp2w4", 4)):
        runs[jid] = _history(_jax_job(
            jcfg, jid, _jax_request(2, resume=True, **TP2), n).train())
    levels = list(LEVELS)
    runs["elastic"] = _history(_jax_job(
        jcfg, "elastic", _jax_request(3, resume=True, mesh_shape={"tp": 2}),
        4, on_epoch_end=lambda state: levels.pop(0)).train())
    # a sharded checkpoint JAX writes from 4 devices under tp=2 (dp=2):
    # one shard file, a slice a tp half
    from kubeml_tpu.models.gpt import CausalTransformer as JaxLM
    from kubeml_tpu.parallel.mesh import make_mesh as jax_mesh
    from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer
    import flax.linen as nn

    mesh = jax_mesh(devices=jax.devices()[:4], dp=2, tp=2)
    tr = JaxTrainer(JaxLM(vocab_size=64, max_len=16, embed_dim=32, depth=2,
                          num_heads=4, mesh=mesh), mesh, precision="f32")
    tr.init(jax.random.PRNGKey(1), J.token_data(16, 3))
    JShardedStore(root=pcfg.checkpoints_dir).save(
        "jaxck", nn.meta.unbox(tr.params), epoch=0, tag="ep00000")
    runs["jaxck"] = {k: np.asarray(v) for k, v in from_flax(
        numpy_tree(tr.params)).items()}
    return dict(tmp=tmp, jcfg=jcfg, pcfg=pcfg, jax=runs)


@pytest.fixture(scope="module")
def world2(roots):
    return R.run(J.cluster_rank, 2, dict(
        root=str(roots["pcfg"].data_root),
        jobs=[dict(id="tp2w2", epochs=2, opts=dict(resume=True, **TP2),
                   probe=True)]))


@pytest.fixture(scope="module")
def world4(roots):
    sharded = [dict(id="sck", epochs=2,
                    opts=dict(mesh_shape={"tp": 2}, **SHARDED)),
               dict(id="sck", key="sck-resumed", epochs=3,
                    opts=dict(mesh_shape={"sp": 2}, resume=True, **SHARDED))]
    return R.run(J.cluster_rank, 4, dict(
        root=str(roots["pcfg"].data_root),
        jobs=[dict(id="tp2w4", epochs=2, opts=dict(resume=True, **TP2)),
              dict(id="elastic", epochs=3,
                   opts=dict(resume=True, mesh_shape={"tp": 2}),
                   levels=LEVELS)] + sharded,
        restore=("jaxck", "ep00000", {"dp": 2, "tp": 2})))


def _held(got, want):
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["validation_loss"],
                               want["validation_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=ATTOL)
    assert got["parallelism"] == want["parallelism"]


@pytest.mark.parametrize("world", [2, 4])
def test_tp2_job_through_the_ps_equals_jax_on_as_many_devices(
        roots, world2, world4, world):
    ranks = world2 if world == 2 else world4
    jid = f"tp2w{world}"
    got = ranks[0]["jobs"][jid]
    assert got["status"] == "finished" and got["error"] is None, got
    assert got["parallelism"] == [world, world]
    _held(got, roots["jax"][jid])
    assert got["train_loss"][-1] < got["train_loss"][0]
    # every follower ran every job, and none may boot the control plane
    for res in ranks[1:]:
        assert res["jobs_followed"] == len(ranks[0]["jobs"])
        assert "runs on rank 0" in res["cluster_refused"]


def test_remesh_4_2_4_equals_jax(roots, world4):
    got = world4[0]["jobs"]["elastic"]
    assert got["error"] is None, got
    assert got["parallelism"] == [4, 2, 4]
    assert got["asked"] == [4, 2, 4]
    _held(got, roots["jax"]["elastic"])


def test_live_inference_over_ranks_answers_409(world2):
    got = world2[0]["jobs"]["tp2w2"]
    for what in ("infer", "generate"):
        code, msg = got[what]
        assert code == 409 and "training over 2 ranks" in msg, got[what]


def test_sharded_save_over_4_ranks_writes_each_slice_once(roots, world4):
    store = ShardedCheckpointStore(root=roots["pcfg"].checkpoints_dir)
    first, again = world4[0]["jobs"]["sck"], world4[0]["jobs"]["sck-resumed"]
    assert first["error"] is None and again["error"] is None, (first, again)
    assert store.tags("sck") == ["ep00000", "ep00001", "ep00002", "final"]
    for tag in ("ep00001", "final"):
        man = store.read_manifest("sck", tag)
        assert man["processes"] == 4
        d = roots["pcfg"].checkpoints_dir / "sck" / f"{tag}.shards"
        assert sorted(p.name for p in d.glob("shard-*.npz")) == [
            f"shard-{r}.npz" for r in range(4)]
        written = {}
        for r in range(4):
            with np.load(d / f"shard-{r}.npz") as z:
                for key in z.files:
                    assert key not in written, key  # written once
                    written[key] = r
        want = {f"{path}@{','.join(map(str, sl['start']))}": sl["shard"]
                for path, leaf in man["leaves"].items()
                for sl in leaf["slices"]}
        assert written == want
    # the ep00001 slices are tp=2's: a tp half each on ranks 0 and 1,
    # every replicated leaf on rank 0, nothing on the dp replicas 2 and 3
    man = store.read_manifest("sck", "ep00001")
    q = man["leaves"]["params/block_0/attn/query/kernel"]["slices"]
    assert [(s["start"], s["shard"]) for s in q] == [([0, 0], 0),
                                                    ([0, 16], 1)]
    ln = man["leaves"]["params/block_0/ln1/scale"]["slices"]
    assert [(s["start"], s["shard"]) for s in ln] == [([0], 0)]
    # the resume (under sp=2) spliced the checkpoint's history exactly
    hist = store.read_manifest("sck", "ep00001")["meta"]["history"]
    assert again["train_loss"][:2] == hist["train_loss"] == first[
        "train_loss"]
    assert len(again["train_loss"]) == 3 and again["parallelism"] == [4] * 3
    # rank 0's own numbers: under tp=2 it wrote its half of the tp-split
    # leaves and every whole one; under sp=2 it read every leaf whole
    total = sum(np.prod(leaf["shape"]) * 4
                for leaf in store.read_manifest("sck", "final")[
                    "leaves"].values())
    assert 0 < first["last_save"]["bytes"] < total
    assert again["restore_bytes"] == total


def test_port_sharded_checkpoint_restores_in_jax_bit_equal(roots, world4):
    """Written by 4 ranks under tp=2, restored in JAX onto 4 host devices
    under dp=4."""
    import flax.linen as nn
    from kubeml_tpu.models.gpt import CausalTransformer as JaxLM
    from kubeml_tpu.parallel.mesh import make_mesh as jax_mesh
    from kubeml_tpu.parallel.trainer import SPMDTrainer as JaxTrainer

    mesh = jax_mesh(devices=jax.devices()[:4])  # dp=4
    tr = JaxTrainer(JaxLM(vocab_size=64, max_len=16, embed_dim=32, depth=2,
                          num_heads=4, mesh=mesh), mesh, precision="f32")
    tr.init(jax.random.PRNGKey(0), J.token_data(16, 3))
    shardings = jax.tree.map(lambda x: x.sharding, nn.meta.unbox(tr.params))
    root = roots["pcfg"].checkpoints_dir
    theirs = JShardedStore(root=root).restore("sck", "ep00001",
                                              shardings=shardings)
    mine = ShardedCheckpointStore(root=root).restore("sck", "ep00001")
    a = from_flax(mine.variables)
    b = from_flax(numpy_tree(theirs.variables))
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name].numpy(), b[name].numpy(), name)
    assert theirs.epoch == mine.epoch == 1


def test_jax_sharded_checkpoint_restores_over_4_ranks_bit_equal(roots,
                                                               world4):
    """Written by JAX from 4 devices under tp=2 (one shard file), restored
    over 4 ranks under dp=2, tp=2: each rank reads the slices of its own
    blocks only."""
    full = roots["jax"]["jaxck"]
    d = roots["pcfg"].checkpoints_dir / "jaxck" / "ep00000.shards"
    assert [p.name for p in d.glob("shard-*.npz")] == ["shard-0.npz"]
    size = sum(v.nbytes for v in full.values())
    for res in world4:
        got = res["restore"]
        coord = got["coord"]

        rank = SimpleNamespace(shape={"dp": 2, "tp": 2}, coord=coord)
        assert set(got["blocks"]) == set(full)
        for name, block in got["blocks"].items():
            start, shape = leaf_block(name, full[name].shape, rank)
            want = full[name][tuple(slice(a, a + n)
                                    for a, n in zip(start, shape))]
            np.testing.assert_array_equal(block, want, name)
        assert 0 < got["bytes_read"] < size


def test_follower_start_failure_fails_the_job_cleanly(tmp_path):
    """The follower's data root lacks the function: the start handshake
    fails the job on the leader with "could not start", before any
    collective, and the follower goes on to the shutdown."""
    roots = [tmp_path / "leader", tmp_path / "empty"]
    _data(Config(data_root=roots[0]), ShardStore, FunctionRegistry, J.LM_FN)
    ranks = R.run(J.cluster_rank, 2, dict(
        roots=[str(r) for r in roots],
        jobs=[dict(id="split", epochs=1, opts=dict(TP2))]))
    got = ranks[0]["jobs"]["split"]
    assert got["status"] == "failed"
    assert "could not start" in got["error"] and "rank 1" in got["error"]
    assert got["train_loss"] == []
    assert ranks[1]["jobs_followed"] == 0


def test_stalled_step_ends_every_rank(tmp_path):
    """A step that never returns: the stall watchdog ends both ranks'
    processes (exit 74) instead of leaving them in a half-joined
    collective; the leader writes the failure history first and the
    journal keeps the job for a resume."""
    from kubeml_tpu_torch.ps.journal import JobJournal
    from kubeml_tpu_torch.storage import HistoryStore
    from kubeml_tpu_torch.utils.watchdog import STALL_EXIT_CODE

    cfg = Config(data_root=tmp_path)
    _data(cfg, ShardStore, FunctionRegistry, J.LM_FN)
    FunctionRegistry(config=cfg).create("hangfn", J.HANG_FN)
    codes, results = J.exit_codes(J.stall_rank, 2, dict(root=str(tmp_path)),
                                  timeout_s=90)
    assert codes == [STALL_EXIT_CODE, STALL_EXIT_CODE], (codes, results)
    err = HistoryStore(config=cfg).get("stall001").task.get("error") or ""
    assert "no progress" in err and "KUBEML_FUNCTION_TIMEOUT" in err, err
    assert "stall001" in [j["job_id"] for j in JobJournal(
        config=cfg).pending(quarantine=False)]


def test_follower_ends_when_the_leader_dies(tmp_path):
    """Over a TCPStore on rank 0: the leader's process dies while the
    follower waits for its next command, and the wait raises."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    codes, results = J.exit_codes(
        J.dead_leader_rank, 2,
        dict(root=str(tmp_path), coordinator=f"127.0.0.1:{port}"),
        timeout_s=90)
    assert codes == [0, 0], (codes, results)
    assert results[1]["error"].startswith("ConnectionError"), results[1]
    assert "store is gone" in results[1]["error"]


def test_check_ported_takes_the_cluster_world():
    """The boundary: a mesh that divides the world runs; pp, ep, and a
    K-AVG job over ranks are refused, each naming its item."""
    TrainOptions(engine="spmd", mesh_shape={"tp": 2}).check_ported(2)
    TrainOptions(engine="spmd", mesh_shape={"sp": 2, "tp": 2}).check_ported(8)
    TrainOptions(engine="spmd").check_ported(4)
    TrainOptions(k=4).check_ported(1)
    cases = [(TrainOptions(engine="spmd", mesh_shape={"tp": 2}), 3,
              "does not fit a cluster of 3"),
             (TrainOptions(engine="spmd", mesh_shape={"pp": 2}), 2,
              "item 1.2"),
             (TrainOptions(engine="spmd", mesh_shape={"ep": 2}), 2,
              "item 1.3"),
             (TrainOptions(k=4), 2, "item 1.5"),
             (TrainOptions(mesh_shape={"dp": 2}), 1, "item 1.5")]
    for opts, world, words in cases:
        with pytest.raises(KubeMLError, match=words) as e:
            opts.check_ported(world)
        assert e.value.status_code == 400


def test_one_sided_faults_end_the_follower():
    """The follower ends its process on a fault of the card's, which may
    strike one rank alone, and carries on after a deterministic one."""
    import torch

    from kubeml_tpu_torch.engine.failures import is_one_sided_fault

    def wrapped(cause):
        try:
            try:
                raise cause
            except Exception as e:
                raise KubeMLError(f"job j failed: {e}") from e
        except KubeMLError as e:
            return e

    assert is_one_sided_fault(wrapped(torch.OutOfMemoryError("out")))
    assert is_one_sided_fault(wrapped(RuntimeError("CUDA error: an illegal "
                                                   "memory access")))
    assert not is_one_sided_fault(wrapped(ValueError("bad shape")))
    assert not is_one_sided_fault(KubeMLError("dataset has no batch"))


def test_cli_start_over_two_ranks_trains_and_releases_the_follower(
        tmp_path):
    """``kubeml start`` on two ranks (the launch variables set, gloo CPU
    ranks): rank 1 prints it follows and runs the follower loop, rank 0
    boots the control plane; an ``--engine spmd --mesh tp=2`` job submitted
    with ``kubeml train`` trains over both, and SIGTERM to rank 0 shuts the
    cluster down and releases the follower, both exiting 0."""
    import os
    import re
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    from kubeml_tpu_torch.controller import KubemlClient

    repo = Path(__file__).resolve().parent.parent
    root = tmp_path / "data"
    _data(Config(data_root=root), ShardStore, FunctionRegistry, J.LM_FN)
    procs = []
    for rank in range(2):
        env = dict(os.environ, KUBEML_DATA_ROOT=str(root),
                   KUBEML_CONTROLLER_PORT="0", KUBEML_SCHEDULER_PORT="0",
                   KUBEML_PS_PORT="0", KUBEML_STORAGE_PORT="0",
                   KUBEML_COORDINATOR=f"file://{tmp_path}/store",
                   KUBEML_NUM_PROCESSES="2", KUBEML_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(filter(
                       None, (str(repo), os.environ.get("PYTHONPATH")))))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "start",
             "--device", "cpu"], cwd=str(repo), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
    try:
        lines = [p.stdout.readline() for p in procs]
        assert lines[1].strip() == "kubeml-tpu-torch follower 1/2", lines
        url = re.search(r"controller at (\S+);", lines[0]).group(1)
        rc = subprocess.run(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "--url", url,
             "train", "-f", "lmfn", "-d", "tokens", "-e", "1", "-b", "16",
             "--lr", "1e-3", "--engine", "spmd", "--mesh", "tp=2",
             "--static"], cwd=str(repo), capture_output=True, text=True,
            timeout=60, env=dict(os.environ, PYTHONPATH=str(repo)))
        assert rc.returncode == 0, rc.stderr
        job = rc.stdout.split()[-1].strip('"')
        client = KubemlClient(url)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                hist = client.histories().get(job)
                break
            except KubeMLError:
                time.sleep(0.2)
        else:
            raise AssertionError(f"job {job} did not finish")
        assert hist.parallelism == [2] and not hist.task.get("error"), hist
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(60) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
