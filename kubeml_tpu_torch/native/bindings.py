"""ctypes bindings and Python fallbacks of the host data plane: the port of
``kubeml_tpu/native/bindings.py``.

* :func:`pack_rounds` — parallel gather and pad of the workers' sample
  slices into the uniform round slab (native ``kml_pack``; numpy
  otherwise);
* :func:`f32_to_bf16` — the round-to-nearest-even f32 -> bf16 host cast
  (native ``kml_f32_to_bf16``; torch otherwise). numpy has no bfloat16, so
  it returns the 16-bit patterns as ``uint16``;
* :class:`TensorStore` — an in-process tensor KV with the reference's
  RedisAI key semantics (ml/pkg/model/utils.go:140-158, prefix delete
  ml/pkg/train/util.go:211-244), native or a locked dict with the same
  behaviour;
* :class:`TensorServer` / :class:`TensorClient` — the store over a unix
  socket, in the framing of ``csrc/kubeml_native.cpp`` (the JAX package's
  framing, so either package's client reads the other's server).

Stored values are numpy arrays or torch tensors (copied to the host). A
bfloat16 value moves as its uint16 bit patterns under the dtype string
``"bfloat16"`` and comes back as a CPU ``torch.bfloat16`` tensor, as
``storage/checkpoint.py`` stores it; every other dtype comes back as
numpy.

The fallbacks stay where JAX has them (a store without the library,
``pack_rounds(native=False)``, a cast before the library is built). Each
use logs a WARNING (once per kind and process) and adds one to
:data:`fallbacks`, which :func:`fallback_counts` reads.
"""

from __future__ import annotations

import ctypes
import logging
import os
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .build import library_path

log = logging.getLogger("kubeml.native")

_MAX_NDIM = 8
_DTYPE_BUF = 17
_BF16 = "bfloat16"

# uses of each Python fallback in this process
fallbacks: Dict[str, int] = {"pack_rounds": 0, "f32_to_bf16": 0,
                             "tensor_store": 0}
_fallback_lock = threading.Lock()


def _fallback(kind: str, why: str) -> None:
    with _fallback_lock:
        first = fallbacks[kind] == 0
        fallbacks[kind] += 1
    if first:
        log.warning("native %s fallback: %s", kind, why)


def fallback_counts() -> Dict[str, int]:
    """{kind: uses} of the Python fallbacks in this process."""
    with _fallback_lock:
        return dict(fallbacks)


def reset_fallback_counts() -> None:
    with _fallback_lock:
        for k in fallbacks:
            fallbacks[k] = 0


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.kml_pack.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.kml_pack.restype = None
    lib.kml_f32_to_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.kml_f32_to_bf16.restype = None
    lib.kml_store_new.restype = ctypes.c_int64
    lib.kml_store_free.argtypes = [ctypes.c_int64]
    lib.kml_store_set.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.kml_store_set.restype = ctypes.c_int32
    lib.kml_store_meta.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.kml_store_meta.restype = ctypes.c_int32
    lib.kml_store_get.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.kml_store_get.restype = ctypes.c_int64
    lib.kml_store_del.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.kml_store_del.restype = ctypes.c_int32
    lib.kml_store_del_prefix.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.kml_store_del_prefix.restype = ctypes.c_int64
    lib.kml_store_keys.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.kml_store_keys.restype = ctypes.c_int64
    lib.kml_store_count.argtypes = [ctypes.c_int64]
    lib.kml_store_count.restype = ctypes.c_int64
    lib.kml_store_bytes.argtypes = [ctypes.c_int64]
    lib.kml_store_bytes.restype = ctypes.c_int64
    lib.kml_server_start.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.kml_server_start.restype = ctypes.c_int64
    lib.kml_server_stop.argtypes = [ctypes.c_int64]
    return lib


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def get_lib(block: bool = True) -> Optional[ctypes.CDLL]:
    """The bound library, or None. ``block=False`` (the data path) never
    waits for a compile: it returns None while the background build runs
    and picks the library up once it is built."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        path = library_path(block=block)
        if path is None:
            if block:
                _lib_failed = True  # no compiler, or the build failed
            return None
        try:
            _lib = _bind(path)
        except OSError:
            _lib_failed = True
        return _lib


def native_available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return get_lib() is not None


# --- leaves on the wire ---


def to_wire(value) -> Tuple[np.ndarray, str]:
    """(C-contiguous numpy array, dtype string) of a numpy array or torch
    tensor; bfloat16 as its uint16 bit patterns."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
        return np.ascontiguousarray(a), str(a.dtype)
    a = np.ascontiguousarray(value)
    dt = str(a.dtype)
    if dt == _BF16:  # an ml_dtypes array handed in by a caller
        return a.view(np.uint16), dt
    return a, dt


def wire_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def from_wire(arr: np.ndarray, name: str):
    """A leaf from its wire bytes: bfloat16 as a CPU ``torch.bfloat16``
    tensor, anything else the numpy array itself."""
    if name == _BF16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


# ---------------------------------------------------------------------------
# pack_rounds and the bf16 cast
# ---------------------------------------------------------------------------


def pack_rounds(dst: np.ndarray, srcs: Sequence[Optional[np.ndarray]],
                counts: Sequence[int], n_threads: int = 0,
                native: bool = True) -> None:
    """Fill ``dst [N, per_round, ...]``: worker w gets
    ``srcs[w][:counts[w]]``, then zeros (``srcs[w]`` None: all zeros). The
    native parallel copy when built and ``native``; numpy otherwise."""
    n, per_round = dst.shape[0], dst.shape[1]
    if len(srcs) != n or len(counts) != n:
        raise ValueError("srcs/counts length must equal dst.shape[0]")
    lib = get_lib(block=False) if native else None
    item_bytes = int(np.prod(dst.shape[2:], dtype=np.int64)) * \
        dst.dtype.itemsize
    why = "native=False" if not native else "library not built"
    if lib is not None and dst.flags["C_CONTIGUOUS"]:
        held: List[np.ndarray] = []  # contiguous copies alive over the call
        ptrs = (ctypes.c_void_p * n)()
        cts = (ctypes.c_int64 * n)()
        ok = True
        for w, (s, c) in enumerate(zip(srcs, counts)):
            if s is None or c <= 0:
                ptrs[w] = None
                cts[w] = 0
                continue
            s = np.ascontiguousarray(s)
            if s.dtype != dst.dtype or s.shape[1:] != dst.shape[2:]:
                ok = False
                break
            held.append(s)
            ptrs[w] = s.ctypes.data_as(ctypes.c_void_p)
            # an oversized count must never become an out-of-bounds read
            cts[w] = min(int(c), per_round, len(s))
        if ok:
            if n_threads <= 0:
                n_threads = min(n, os.cpu_count() or 1)
            lib.kml_pack(
                dst.ctypes.data_as(ctypes.c_void_p), ptrs, cts,
                ctypes.c_int64(per_round), ctypes.c_int64(item_bytes),
                ctypes.c_int32(n), ctypes.c_int32(n_threads))
            return
        why = "a source whose dtype or sample shape differs from dst's"
    elif lib is not None:
        why = "a non-contiguous destination"
    _fallback("pack_rounds", why)
    for w, (s, c) in enumerate(zip(srcs, counts)):
        c = min(int(c), per_round) if s is not None else 0
        if c > 0:
            dst[w, :c] = s[:c]
        if c < per_round:
            dst[w, c:] = 0


def f32_to_bf16(x, n_threads: int = 0) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 on the host (halves the bytes
    that cross to the card), as uint16 bit patterns: the native
    multithreaded pass when built, torch's cast otherwise."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = get_lib(block=False)
    if lib is None:
        _fallback("f32_to_bf16", "library not built")
        return (torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
                .numpy().view(np.uint16))
    out = np.empty(x.shape, dtype=np.uint16)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.kml_f32_to_bf16(
        x.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(x.size), ctypes.c_int32(n_threads))
    return out


# ---------------------------------------------------------------------------
# TensorStore
# ---------------------------------------------------------------------------


class TensorStore:
    """Named-tensor KV with the reference's RedisAI semantics: the native
    store when the library is built, else a locked dict that behaves the
    same (a counted fallback)."""

    def __init__(self):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.kml_store_new()
        else:
            _fallback("tensor_store", "library not built")
            self._h = None
            self._map: Dict[str, Tuple[np.ndarray, str]] = {}
            self._mu = threading.Lock()

    @property
    def native(self) -> bool:
        return self._h is not None

    def close(self) -> None:
        if self._h is not None:
            self._lib.kml_store_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set(self, key: str, value) -> None:
        arr, dt = to_wire(value)
        if self._h is None:
            with self._mu:
                self._map[key] = (arr.copy(), dt)
            return
        shape = (ctypes.c_int64 * _MAX_NDIM)(*arr.shape)
        rc = self._lib.kml_store_set(
            self._h, key.encode(), dt.encode(), shape, ctypes.c_int32(arr.ndim),
            arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(arr.nbytes))
        if rc != 0:
            raise RuntimeError(f"tensorstore set({key!r}) failed: {rc}")

    def get(self, key: str):
        if self._h is None:
            with self._mu:
                v = self._map.get(key)
            return from_wire(v[0].copy(), v[1]) if v is not None else None
        dtype_buf = ctypes.create_string_buffer(_DTYPE_BUF)
        shape = (ctypes.c_int64 * _MAX_NDIM)()
        ndim = ctypes.c_int32()
        nbytes = ctypes.c_int64()
        rc = self._lib.kml_store_meta(
            self._h, key.encode(), dtype_buf, shape, ctypes.byref(ndim),
            ctypes.byref(nbytes))
        if rc == -1:
            return None
        if rc != 0:
            raise RuntimeError(f"tensorstore meta({key!r}) failed: {rc}")
        name = dtype_buf.value.decode()
        out = np.empty(tuple(shape[i] for i in range(ndim.value)),
                       dtype=wire_dtype(name))
        got = self._lib.kml_store_get(
            self._h, key.encode(), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(out.nbytes))
        if got == -1:
            return None  # deleted between meta and get
        if got < 0:
            raise RuntimeError(f"tensorstore get({key!r}) failed: {got}")
        return from_wire(out, name)

    def delete(self, key: str) -> bool:
        if self._h is None:
            with self._mu:
                return self._map.pop(key, None) is not None
        return self._lib.kml_store_del(self._h, key.encode()) == 0

    def delete_prefix(self, prefix: str) -> int:
        """The reference's clearTensors: DEL jobId* (train/util.go:211-244)."""
        if self._h is None:
            with self._mu:
                keys = [k for k in self._map if k.startswith(prefix)]
                for k in keys:
                    del self._map[k]
                return len(keys)
        return int(self._lib.kml_store_del_prefix(self._h, prefix.encode()))

    def keys(self, prefix: str = "") -> List[str]:
        if self._h is None:
            with self._mu:
                return sorted(k for k in self._map if k.startswith(prefix))
        # the size query and the fill are two calls and the store can
        # change between them: retry until the fill fits the buffer
        need = self._lib.kml_store_keys(self._h, prefix.encode(), None, 0)
        for _ in range(8):
            if need <= 0:
                return []
            buf = ctypes.create_string_buffer(int(need))
            got = self._lib.kml_store_keys(self._h, prefix.encode(), buf,
                                           ctypes.c_int64(need))
            if got <= need:
                return (buf.raw[: max(got, 0)].decode().split("\n")
                        if got > 0 else [])
            need = got
        raise RuntimeError("tensorstore keys() kept changing size; giving up")

    def count(self) -> int:
        if self._h is None:
            with self._mu:
                return len(self._map)
        return int(self._lib.kml_store_count(self._h))

    def nbytes(self) -> int:
        if self._h is None:
            with self._mu:
                return sum(a.nbytes for a, _ in self._map.values())
        return int(self._lib.kml_store_bytes(self._h))


# ---------------------------------------------------------------------------
# Socket server / client
# ---------------------------------------------------------------------------

_OP_SET, _OP_GET, _OP_DEL, _OP_DELP, _OP_KEYS, _OP_COUNT, _OP_PING = \
    range(1, 8)


class TensorServer:
    """A native :class:`TensorStore` served over a unix socket (the stand-in
    for the reference's RedisAI service). Needs the native store."""

    def __init__(self, store: TensorStore, socket_path: str):
        if not store.native:
            raise RuntimeError("TensorServer requires the native tensor store")
        self.store = store
        self.socket_path = socket_path
        self._srv = store._lib.kml_server_start(store._h, socket_path.encode())
        if self._srv < 0:
            raise RuntimeError(f"failed to start tensor server on "
                               f"{socket_path}")

    def stop(self) -> None:
        if self._srv is not None and self._srv >= 0:
            self.store._lib.kml_server_stop(self._srv)
            self._srv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class TensorClient:
    """A blocking client of :class:`TensorServer`, from any process."""

    def __init__(self, socket_path: str, timeout: float = 30.0):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._mu = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            b = self._sock.recv(min(n, 1 << 20))
            if not b:
                raise ConnectionError("tensor server closed the connection")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _status(self) -> int:
        return struct.unpack("<q", self._recv_exact(8))[0]

    def _req(self, op: int, key: bytes, payload: bytes = b"") -> None:
        self._sock.sendall(struct.pack("<BI", op, len(key)) + key + payload)

    def ping(self) -> bool:
        with self._mu:
            self._req(_OP_PING, b"")
            return self._status() == 0

    def set(self, key: str, value) -> None:
        arr, name = to_wire(value)
        dt = name.encode()
        hdr = struct.pack(f"<B{len(dt)}sB", len(dt), dt, arr.ndim)
        hdr += struct.pack(f"<{arr.ndim}q", *arr.shape) if arr.ndim else b""
        hdr += struct.pack("<Q", arr.nbytes)
        with self._mu:
            self._req(_OP_SET, key.encode(), hdr + arr.tobytes())
            if self._status() != 0:
                raise RuntimeError(f"tensor server rejected set({key!r})")

    def get(self, key: str):
        with self._mu:
            self._req(_OP_GET, key.encode())
            st = self._status()
            if st == -1:
                return None
            if st != 0:
                raise RuntimeError(f"tensor server get({key!r}) failed: {st}")
            dlen = self._recv_exact(1)[0]
            name = self._recv_exact(dlen).decode()
            ndim = self._recv_exact(1)[0]
            shape: Tuple[int, ...] = ()
            if ndim:
                shape = struct.unpack(f"<{ndim}q", self._recv_exact(8 * ndim))
            nbytes = struct.unpack("<Q", self._recv_exact(8))[0]
            data = self._recv_exact(nbytes)
        arr = np.frombuffer(data, dtype=wire_dtype(name)).reshape(shape).copy()
        return from_wire(arr, name)

    def delete(self, key: str) -> bool:
        with self._mu:
            self._req(_OP_DEL, key.encode())
            return self._status() == 0

    def delete_prefix(self, prefix: str) -> int:
        with self._mu:
            self._req(_OP_DELP, prefix.encode())
            return self._status()

    def keys(self, prefix: str = "") -> List[str]:
        with self._mu:
            self._req(_OP_KEYS, prefix.encode())
            if self._status() != 0:
                raise RuntimeError("tensor server keys() failed")
            ln = struct.unpack("<Q", self._recv_exact(8))[0]
            raw = self._recv_exact(ln).decode() if ln else ""
        return raw.split("\n") if raw else []

    def count(self) -> int:
        with self._mu:
            self._req(_OP_COUNT, b"")
            return self._status()
