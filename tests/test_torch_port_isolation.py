"""The PyTorch port stands alone: ``kubeml_tpu_torch`` and ``chip_smoke.py``
import neither JAX (nor Flax/optax) nor anything of ``kubeml_tpu``, and an
entry point never carries on on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubeml_tpu")


def _port_sources():
    files = sorted((REPO / "kubeml_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                          if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import kubeml_tpu_torch, kubeml_tpu_torch.api, "
        "kubeml_tpu_torch.serving, kubeml_tpu_torch.models.generation, "
        "kubeml_tpu_torch.interop.from_flax, kubeml_tpu_torch.ops.kernels, "
        "kubeml_tpu_torch.ops.flash_attention, kubeml_tpu_torch.parallel, "
        "kubeml_tpu_torch.benchmarks.longcontext\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_device_on_a_cpu_only_host(monkeypatch):
    from kubeml_tpu_torch import resolve_device
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
    # asked for explicitly, the CPU runs
    assert resolve_device("cpu") == torch.device("cpu")
    PagedBatchingDecoder(m, page_tokens=4, device="cpu").close()
