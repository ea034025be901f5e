"""Build the host data-plane library at first use: the port of
``kubeml_tpu/native/build.py``.

``csrc/kubeml_native.cpp`` is compiled with the host C++ compiler
(``$CXX``, else ``g++``, ``clang++`` or ``c++``; ``-O3 -std=c++17
-pthread -shared -fPIC``) into ``csrc/build/<digest>/libkubeml_native.so``
(listed in ``.gitignore``), the digest over the source and the flags. The
build writes a temporary file and ``os.replace``-s it, under the
directory's cross-process lock (``utils.buildlock``), so a parameter
server and its runners never compile at once. A missing compiler or a
failed build leaves the callers on their Python fallbacks
(``native.bindings``), which count and log their use.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..utils.buildlock import build_lock

log = logging.getLogger("kubeml.native")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "kubeml_native.cpp"
BUILD_ROOT = CSRC / "build"
LIB_NAME = "libkubeml_native.so"
FLAGS = ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC")

_lock = threading.Lock()
_cached: Optional[Path] = None
_failed = False
_bg_thread: Optional[threading.Thread] = None


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CXX"), "g++", "clang++", "c++"):
        if cc and shutil.which(cc):
            return cc
    return None


def digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build_locked(compile: bool = True) -> Optional[Path]:
    """The built library (compiled when ``compile``); the caller holds
    ``_lock``."""
    global _cached, _failed
    if _cached is not None:
        return _cached
    if _failed or os.environ.get("KUBEML_NO_NATIVE"):
        return None
    if not SOURCE.exists():
        _failed = True
        return None
    out_dir = BUILD_ROOT / digest()
    out = out_dir / LIB_NAME
    if out.exists():
        _cached = out
        return out
    if not compile:
        return None
    cc = _compiler()
    if cc is None:
        log.warning("no C++ compiler found; the native data plane is off")
        _failed = True
        return None
    with build_lock(out_dir):
        if not out.exists():  # another process may have built it meanwhile
            tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
            try:
                subprocess.run([cc, *FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, out)
            except (subprocess.SubprocessError, OSError) as e:
                stderr = getattr(e, "stderr", b"") or b""
                log.warning("native build failed (%s): %s", e,
                            stderr.decode(errors="replace")[-2000:])
                tmp.unlink(missing_ok=True)
                _failed = True
                return None
    _cached = out
    return out


def library_path(block: bool = True) -> Optional[Path]:
    """The built library, compiling it if necessary; None when it cannot
    be built. ``block=False`` never compiles on the calling thread: it
    returns a library already built, or starts the build on a background
    thread and returns None (the data path packs through the fallback
    meanwhile instead of waiting for the compiler)."""
    global _bg_thread
    if block:
        with _lock:
            return _build_locked()
    if not _lock.acquire(blocking=False):
        return None  # a build is in flight
    try:
        found = _build_locked(compile=False)
        if found is not None or _failed:
            return found
        if _bg_thread is None or not _bg_thread.is_alive():
            _bg_thread = threading.Thread(
                target=lambda: library_path(block=True),
                name="kml-native-build", daemon=True)
            _bg_thread.start()
        return None
    finally:
        _lock.release()
