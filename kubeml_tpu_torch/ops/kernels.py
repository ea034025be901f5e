"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build runs at first use, into ``csrc/build/<hash of sources and flags>/``
(listed in ``.gitignore``), one ``nvcc`` per source started together and
then one link, so a fresh checkout builds everything the first time a
kernel is launched. The build holds the directory's cross-process lock
(``utils.buildlock``): processes that reach it at once (a parameter
server and its job runners, the ranks of a group) build once. Nothing here runs at import time: this module imports
on a host without ``nvcc`` or a card, where only the plain PyTorch versions
run.

Each C entry point takes its tensors as ``c_void_p`` device pointers, its
sizes as ``c_int`` and PyTorch's current stream as a ``c_void_p``, launches
on that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..utils.buildlock import build_lock

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
SOURCES = ("paged_attention.cu", "int8_matmul.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with the C entry points
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k_pages, v_pages, k_scale, v_scale, pages, positions, out, B, L,
    # H, D, N, pt, P, plan, q_dtype, kv_dtype, stream
    "kubeml_paged_attention": [_P] * 8 + [_I] * 7 + [_P] + [_I] * 2 + [_P],
    # out: maps encoded, table cleared, maps held
    "kubeml_paged_attention_map_stats": [_P],
    # x, q, s, y, M, K, N, m_tile, cluster, k_per_rank, x_dtype, y_dtype,
    # stream
    "kubeml_int8_matmul": [_P] * 4 + [_I] * 8 + [_P],
    # q, k, v, valid, out, lse, B, Lq, Lk, H, D, causal, dtype, stream
    "kubeml_flash_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # q, k, v, valid, lse, dout, dsum, dq, B, Lq, Lk, H, D, causal, dtype,
    # stream
    "kubeml_flash_dq": [_P] * 8 + [_I] * 7 + [_P],
    # q, k, v, valid, lse, dout, dsum, dk, dv, B, Lq, Lk, H, D, causal,
    # dtype, stream
    "kubeml_flash_dkv": [_P] * 9 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did, for the caller to report: wall seconds (0.0 when
# an earlier process had already built this exact source set) and the
# compiler's output, which includes ptxas's register/shared-memory report
build_seconds: float = 0.0
build_log: str = ""


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.glob("*.cu*")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    global build_seconds, build_log
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs: List[tuple] = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    so = out_dir / "libkubeml_kernels.so"
    tmp = out_dir / f".libkubeml_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    build_seconds = time.monotonic() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call by the first
    process to get here; the others load what it built."""
    global _lib
    with _lock:
        if _lib is None:
            so = BUILD_ROOT / _digest() / "libkubeml_kernels.so"
            if not so.exists():
                # one nvcc over the .o files at a time: a process that
                # waited here loads what the holder built
                with build_lock(so.parent):
                    if not so.exists():
                        _build(so.parent)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card (the wrappers size their grids
    by it)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
