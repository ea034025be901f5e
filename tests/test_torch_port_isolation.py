"""The PyTorch port stands alone: ``kubeml_tpu_torch`` and ``chip_smoke.py``
import neither JAX (nor Flax/optax/ml_dtypes) nor anything of
``kubeml_tpu``, nor ``requests`` or ``flask`` (the machine with the card
has neither: the port's HTTP is the standard library's), and an entry
point never carries on on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "kubeml_tpu",
             "requests", "flask")


def _port_sources():
    files = sorted((REPO / "kubeml_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _offenders(path):
    """The forbidden absolute imports of one source file."""
    out = []
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        out += [f"{path.relative_to(REPO)}: {n}" for n in names
                if _forbidden(n)]
    return out


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    offenders = [o for path in _port_sources() for o in _offenders(path)]
    assert len(_port_sources()) > 10
    assert not offenders, offenders


@pytest.mark.parametrize("module", ["serving/stats.py", "serving/kvsnap.py",
                                    "benchmarks/recovery.py",
                                    "utils/resilience.py"])
def test_resilience_modules_keep_their_own_copies(module):
    """The serving-resilience modules copy what they need of the JAX
    package's JAX-free modules (``ps/metrics``, ``utils/timeseries``,
    ``engine/dataplane``, ``utils/resilience``) instead of importing it."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


@pytest.mark.parametrize("module", [
    "storage/checkpoint.py", "functions/registry.py", "ps/metrics.py",
    "ps/parameter_server.py", "engine/resume.py", "utils/watchdog.py",
    "serving/quant.py", "interop/from_flax.py"])
def test_checkpoint_and_serving_modules_keep_their_own_copies(module):
    """The checkpoint and parameter-server modules copy what they need of
    the JAX package's (the store's format, the registry's rules, the
    metric names) and do not import it, nor ``ml_dtypes`` for bfloat16."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


@pytest.mark.parametrize("module", [
    "utils/httpd.py", "utils/http_client.py", "utils/resilience.py",
    "scheduler/__init__.py", "scheduler/decisions.py", "scheduler/policy.py",
    "scheduler/queue.py", "scheduler/scheduler.py", "scheduler/transport.py",
    "ps/journal.py", "ps/transport.py", "storage/service.py",
    "controller/controller.py", "controller/client.py", "cluster.py",
    "cli.py"])
def test_control_plane_modules_keep_their_own_copies(module):
    """The control-plane modules copy what they need of the JAX package's
    JAX-free modules (``utils/httpd``, ``scheduler/*``, ``ps/journal``,
    ``storage/service``) and speak HTTP through the standard library."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


@pytest.mark.parametrize("module", [
    "data/text.py", "data/bpe.py", "storage/service.py",
    "utils/resilience.py", "utils/http_client.py", "utils/httpd.py",
    "controller/client.py", "cli.py", "ps/metrics.py"])
def test_text_and_resilience_modules_keep_their_own_copies(module):
    """The text data path (the byte tokenizer, ``pack_corpus``, the BPE
    trainer) and the retrying HTTP layer copy what they need of the JAX
    package's JAX-free ``data/text``, ``data/bpe`` and
    ``utils/resilience`` and speak HTTP through the standard library."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file() and path in _port_sources()
    assert not _offenders(path)


@pytest.mark.parametrize("module", [
    "utils/tracing.py", "utils/errorhook.py", "ps/traces.py",
    "utils/profiler.py", "utils/http_client.py", "utils/httpd.py",
    "utils/watchdog.py", "serving/batcher.py", "engine/follower.py",
    "engine/job_runner.py", "cli.py"])
def test_tracing_modules_keep_their_own_copies(module):
    """Tracing and profiling (the tracer, the flight recorder, the error
    hook, the span collector, and the call sites that open spans) copy
    what they need of the JAX package's JAX-free ``utils/tracing``,
    ``utils/profiler``, ``utils/errorhook`` and ``ps/traces``."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file() and path in _port_sources()
    assert not _offenders(path)


def test_trace_and_profile_commands_import_no_torch():
    """``kubeml trace`` and ``kubeml profile`` run in a client process:
    the tracer, the profiler's reports and the error hook import no
    torch."""
    code = ("import sys\n"
            "import kubeml_tpu_torch.utils.tracing, "
            "kubeml_tpu_torch.utils.profiler, "
            "kubeml_tpu_torch.utils.errorhook\n"
            "from kubeml_tpu_torch.utils.profiler import attribution_report\n"
            "from kubeml_tpu_torch.utils.tracing import merge_chrome_trace\n"
            "merge_chrome_trace([]); attribution_report([])\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_cli_client_path_imports_no_torch():
    """The CLI's client commands (and the text path they read) start
    without torch: the package's ``resolve_device``, ``data``'s names and
    ``controller.Controller`` are imported on first use, and
    ``data.text.PAD_ID`` is the models' pad id."""
    code = ("import sys\n"
            "import kubeml_tpu_torch.cli, kubeml_tpu_torch.data.bpe, "
            "kubeml_tpu_torch.controller.client\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from kubeml_tpu_torch import resolve_device
    from kubeml_tpu_torch.controller import Controller
    from kubeml_tpu_torch.data import KubeDataset, plan_epoch
    from kubeml_tpu_torch.data.text import PAD_ID
    from kubeml_tpu_torch.models.gpt import PAD_ID as MODEL_PAD_ID

    assert callable(resolve_device) and callable(plan_epoch)
    assert Controller.__name__ == "Controller" and KubeDataset
    assert PAD_ID == MODEL_PAD_ID == 0


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import kubeml_tpu_torch, kubeml_tpu_torch.api, "
        "kubeml_tpu_torch.serving, kubeml_tpu_torch.models.generation, "
        "kubeml_tpu_torch.interop.from_flax, kubeml_tpu_torch.ops.kernels, "
        "kubeml_tpu_torch.ops.flash_attention, kubeml_tpu_torch.parallel, "
        "kubeml_tpu_torch.benchmarks.longcontext, "
        "kubeml_tpu_torch.benchmarks.harness, kubeml_tpu_torch.engine, "
        "kubeml_tpu_torch.engine.job, kubeml_tpu_torch.data, "
        "kubeml_tpu_torch.storage, kubeml_tpu_torch.runtime, "
        "kubeml_tpu_torch.models.resnet, kubeml_tpu_torch.models.lenet, "
        "kubeml_tpu_torch.api.config, kubeml_tpu_torch.serving.spec, "
        "kubeml_tpu_torch.benchmarks.spec_decode, "
        "kubeml_tpu_torch.serving.stats, kubeml_tpu_torch.serving.kvsnap, "
        "kubeml_tpu_torch.benchmarks.recovery, "
        "kubeml_tpu_torch.utils.resilience, "
        "kubeml_tpu_torch.storage.checkpoint, kubeml_tpu_torch.functions, "
        "kubeml_tpu_torch.ps, kubeml_tpu_torch.engine.resume, "
        "kubeml_tpu_torch.utils.watchdog, kubeml_tpu_torch.cluster, "
        "kubeml_tpu_torch.cli, kubeml_tpu_torch.controller, "
        "kubeml_tpu_torch.scheduler.transport, "
        "kubeml_tpu_torch.ps.transport, kubeml_tpu_torch.storage.service, "
        "kubeml_tpu_torch.storage.sharded_checkpoint, "
        "kubeml_tpu_torch.engine.spmd_job, kubeml_tpu_torch.engine.follower, "
        "kubeml_tpu_torch.engine.failures, kubeml_tpu_torch.data.text, "
        "kubeml_tpu_torch.data.bpe, kubeml_tpu_torch.utils.http_client\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_device_on_a_cpu_only_host(monkeypatch,
                                                             tmp_path):
    from kubeml_tpu_torch import resolve_device
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.models import CausalTransformer, GPTSmall
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTSmall()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    m = CausalTransformer(vocab_size=11, max_len=8, embed_dim=8, depth=1,
                          num_heads=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedBatchingDecoder(m, page_tokens=4)
    from kubeml_tpu_torch.benchmarks.spec_decode import run_rows
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rows(0, 1, 2, 2, 2, 4, 1)
    from kubeml_tpu_torch.benchmarks.recovery import main as recovery
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recovery([])
    from kubeml_tpu_torch.ps import ParameterServer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParameterServer(config=Config(data_root=tmp_path))
    from kubeml_tpu_torch.cluster import LocalCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster(config=Config(data_root=tmp_path))
    # asked for explicitly, the CPU runs
    assert resolve_device("cpu") == torch.device("cpu")
    PagedBatchingDecoder(m, page_tokens=4, device="cpu").close()


@pytest.mark.parametrize("module", [
    "parallel/mesh.py", "parallel/moe.py", "parallel/trainer.py",
    "models/generation.py", "serving/batcher.py",
    "benchmarks/paged_serving.py", "benchmarks/transformers.py"])
def test_moe_and_dense_engine_modules_keep_their_own_copies(module):
    """The MoE layer, the mesh helpers, the dense cache and slot engine
    and their benchmarks copy what they need of the JAX package's."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


def test_moe_and_dense_entry_points_raise_without_device(monkeypatch):
    """``make_mesh``, the MoE LM, ``BatchingDecoder``, ``bench_moe`` and
    the slot-against-paged A/B run on the card unless asked for the CPU."""
    from kubeml_tpu_torch.benchmarks.paged_serving import run_demo
    from kubeml_tpu_torch.benchmarks.transformers import MoEBench
    from kubeml_tpu_torch.models import CausalTransformer
    from kubeml_tpu_torch.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.moe import MoETiny
    from kubeml_tpu_torch.serving import BatchingDecoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh, MoETiny, lambda: MoEBench(2, 8),
                 lambda: run_demo(n_requests=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    m = CausalTransformer(vocab_size=11, max_len=8, embed_dim=8, depth=1,
                          num_heads=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingDecoder(m)
    assert make_mesh(devices=["cpu"]).devices == [torch.device("cpu")]
    BatchingDecoder(m, device="cpu").close()


@pytest.mark.parametrize("module", [
    "storage/sharded_checkpoint.py", "engine/spmd_job.py",
    "engine/__init__.py", "models/generation.py", "runtime/model.py",
    "api/types.py"])
def test_spmd_and_spec_oneshot_modules_keep_their_own_copies(module):
    """The sharded store (its format, bf16 without ``ml_dtypes``), the SPMD
    job, the engine dispatch and the one-shot speculative path copy what
    they need of the JAX package's and do not import it."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


def test_spmd_job_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """``SPMDJob`` without ``device`` on a host without CUDA raises; with
    ``device="cpu"`` it builds its one-device mesh on the CPU."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.data.dataset import KubeDataset
    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.models import CausalTransformer
    from kubeml_tpu_torch.runtime.model import KubeModel
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    class LM(KubeModel):
        def __init__(self):
            super().__init__(KubeDataset("tokens"))

        def build(self):
            return CausalTransformer(vocab_size=11, max_len=8, embed_dim=8,
                                     depth=1, num_heads=2, mesh=self.mesh)

    req = TrainRequest(function_name="f", dataset="tokens",
                       options=TrainOptions(engine="spmd"))
    kw = dict(store=ShardStore(root=tmp_path / "d"),
              history_store=HistoryStore(root=tmp_path / "h"),
              checkpoint_store=CheckpointStore(root=tmp_path / "c"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPMDJob("j", req, LM(), **kw)
    job = SPMDJob("j", req, LM(), device="cpu", **kw)
    assert job.mesh.devices == [torch.device("cpu")]
    assert job.model.module.device == torch.device("cpu")


@pytest.mark.parametrize("module", [
    "parallel/distributed.py", "parallel/collectives.py", "parallel/ring.py",
    "parallel/ulysses.py", "parallel/mesh.py", "parallel/trainer.py",
    "models/gpt.py", "interop/from_flax.py"])
def test_multi_rank_modules_keep_their_own_copies(module):
    """The process group, the mesh over ranks, the collectives, ring and
    Ulysses attention and the sharded model and trainer copy what they
    need of the JAX package's (its layout functions, its partition specs)
    and do not import it."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


def test_multi_rank_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Ranks are CUDA ranks unless asked for the CPU: without a card the
    process group refuses to start before its rendezvous, and the
    long-context benchmark over ``make_mesh(dp=world)`` raises alone."""
    from kubeml_tpu_torch.benchmarks.longcontext import make_trainer
    from kubeml_tpu_torch.parallel.distributed import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trainer(16, 32, depth=1, embed_dim=8, num_heads=1, vocab=11)


@pytest.mark.parametrize("module", [
    "engine/follower.py", "engine/spmd_job.py", "engine/failures.py",
    "engine/job.py", "storage/sharded_checkpoint.py", "utils/watchdog.py",
    "ps/parameter_server.py", "cluster.py", "cli.py", "api/types.py",
    "api/config.py", "parallel/distributed.py", "parallel/mesh.py",
    "interop/from_flax.py", "runtime/model.py", "scheduler/scheduler.py"])
def test_spmd_job_over_ranks_modules_keep_their_own_copies(module):
    """The follower loop, the SPMD job over ranks, the stall watchdog, the
    sharded store written by every rank and the control plane over ranks
    copy what they need of the JAX package's and do not import it."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file()
    assert not _offenders(path)


def test_follower_entry_point_runs_on_the_card_unless_asked(monkeypatch):
    """``python -m kubeml_tpu_torch.engine.follower`` needs the launch
    variables, and its ranks are CUDA ranks unless asked for the CPU:
    without a card it refuses before the rendezvous."""
    from kubeml_tpu_torch.engine.follower import main

    for var in ("KUBEML_COORDINATOR", "KUBEML_NUM_PROCESSES",
                "KUBEML_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="KUBEML_COORDINATOR"):
        main([])
    monkeypatch.setenv("KUBEML_COORDINATOR", "localhost:1")
    monkeypatch.setenv("KUBEML_NUM_PROCESSES", "2")
    monkeypatch.setenv("KUBEML_PROCESS_ID", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


@pytest.mark.parametrize("module", [
    "parallel/pipeline.py", "models/gpt_pipeline.py", "parallel/__init__.py",
    "models/gpt.py", "interop/from_flax.py", "parallel/mesh.py"])
def test_pipeline_modules_keep_their_own_copies(module):
    """The GPipe schedule, ``PipelinedLM``, ``PipelineTrainer`` and the
    pipelined causal LM (with ``flat_serving_remap``) are among the
    scanned sources and import nothing of JAX or the JAX package."""
    path = REPO / "kubeml_tpu_torch" / module
    assert path.is_file() and path in _port_sources()
    assert not _offenders(path)


def test_pipeline_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """``PipelinedLM`` and ``PipelinedCausalLM`` are built on the card
    unless asked for the CPU; importing them loads no JAX module."""
    from kubeml_tpu_torch.models.gpt_pipeline import PipelinedCausalLM
    from kubeml_tpu_torch.parallel.pipeline import PipelinedLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PipelinedLM(None, vocab_size=11, max_len=8,
                                     embed_dim=8, depth=1, num_heads=2),
                 lambda: PipelinedCausalLM(vocab_size=11, max_len=8,
                                           embed_dim=8, depth=2,
                                           num_heads=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    PipelinedCausalLM(vocab_size=11, max_len=8, embed_dim=8, depth=2,
                      num_heads=2, device="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\n"
         "import kubeml_tpu_torch.models.gpt_pipeline, "
         "kubeml_tpu_torch.parallel.pipeline\n"
         f"sys.exit(any(m.split('.')[0] in {FORBIDDEN!r} "
         "for m in sys.modules))\n"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
