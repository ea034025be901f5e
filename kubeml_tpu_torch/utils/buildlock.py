"""A cross-process lock on a build directory.

The port builds two libraries at first use, the CUDA kernels
(``ops/kernels.py``, ``nvcc``) and the host data plane
(``native/build.py``, the C++ compiler), each into
``csrc/build/<digest>/``. A parameter server and the job runners it
spawns, or the ranks of a process group, may reach that first use at
once: :func:`build_lock` holds an exclusive ``fcntl`` lock on
``<directory>/.lock`` for the build, so one process compiles while the
others wait and then load what it wrote. The lock is released when the
holder exits, however it exits.
"""

from __future__ import annotations

import fcntl
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator


@contextmanager
def build_lock(directory: Path) -> Iterator[None]:
    """Hold the exclusive lock of ``directory`` (created if missing)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    fd = os.open(directory / ".lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
