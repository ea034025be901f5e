"""Weight-movement data plane: delta-encoded, compressed weight updates on
the KMW1 wire. The port of ``kubeml_tpu/engine/dataplane.py``, byte for
byte: a payload either package encodes, the other decodes.

Three codecs behind one wire format (``KUBEML_DATAPLANE_CODEC``):

* ``raw`` — the full tree as binary chunks;
* ``delta`` — lossless: only leaves whose bytes changed since the
  receiver's last synced version ship (raw); unchanged leaves ship as
  ``skip`` markers, so frozen leaves cost nothing;
* ``delta-int8`` — each changed float leaf of at least
  :data:`MIN_Q8_SIZE` elements ships ``round((leaf - synced) / scale)`` as
  int8 with a symmetric per-output-channel scale over the last axis
  (per-tensor for vectors). The delta is taken against the
  receiver-SYNCED state, which equals the true update plus every past
  round's quantization error: error feedback carried by the base, so the
  reconstruction error stays bounded instead of accumulating.

Wire format (``application/x-kubeml-weights``)::

    b"KMW1" | u8 codec | u32le header_len | header JSON | chunks...

    header = {"codec", "version", "base_version",
              "leaves": [{"path", "dtype", "shape", "enc", "nbytes",
                          "snbytes"?, "sshape"?}, ...]}

``enc`` is ``raw`` (nbytes of little-endian array data), ``skip`` (no
bytes; the receiver keeps its copy) or ``q8`` (snbytes of f32 scales, then
nbytes of int8 deltas). ``base_version`` names the version the encoder
assumed the receiver holds; a receiver at any other version refuses
(:class:`BaseVersionMismatch`) and pulls a full snapshot.

Encoder and decoder are stateful mirrors: after each encode/decode pair
both hold the same reconstructed tree. :class:`WeightsWire` is the
runner's side of ``GET /weights?since=N``: the delta when the client is
one version behind, a full snapshot otherwise, ``"current"`` (a 204) when
it is up to date.

Leaves are numpy arrays or torch tensors and move as numpy; bfloat16 moves
as its 16-bit patterns under the dtype name ``"bfloat16"``
(``native.bindings.to_wire``), its delta arithmetic runs in f32 and rounds
back to bfloat16 to nearest even, as the JAX package's ``ml_dtypes`` cast
does. A decoded tree holds numpy arrays, bfloat16 leaves as CPU
``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..native.bindings import from_wire, to_wire, wire_dtype
from ..storage.checkpoint import _flatten, _unflatten

MAGIC = b"KMW1"
CODECS = ("raw", "delta", "delta-int8")
_CODEC_ID = {c: i for i, c in enumerate(CODECS)}

# leaves smaller than this ship raw even under delta-int8: the scale
# vector and header eat the win, and small leaves (biases, norm scales)
# are the most sensitive to quantization
MIN_Q8_SIZE = 1024

CONTENT_TYPE = "application/x-kubeml-weights"
VERSION_HEADER = "X-KubeML-Weights-Version"

_BF16 = "bfloat16"

# a leaf as it moves: (numpy array of its bytes, dtype name)
Leaf = Tuple[np.ndarray, str]


class DataPlaneError(ValueError):
    """Malformed payload or codec misuse."""


class BaseVersionMismatch(DataPlaneError):
    """The payload's delta base is not the version this decoder holds: the
    caller must pull a full snapshot (``since`` unset)."""


def codec_from_env() -> str:
    from ..api.config import get_config

    codec = get_config().dataplane_codec
    if codec not in CODECS:
        logging.getLogger("kubeml.dataplane").warning(
            "KUBEML_DATAPLANE_CODEC=%r not in %s; using 'delta'", codec,
            CODECS)
        return "delta"
    return codec


def _is_float(name: str) -> bool:
    return name == _BF16 or np.issubdtype(np.dtype(name), np.floating)


def _as_f32(arr: np.ndarray, name: str) -> np.ndarray:
    """A leaf's values in f32 (bfloat16 bits widened exactly)."""
    if name == _BF16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32)


def _cast(values: np.ndarray, name: str) -> np.ndarray:
    """f32 ``values`` as the bytes of dtype ``name`` (bfloat16 rounded to
    nearest even)."""
    if name == _BF16:
        return (torch.from_numpy(np.ascontiguousarray(values, np.float32))
                .to(torch.bfloat16).view(torch.int16).numpy()
                .view(np.uint16))
    return values.astype(np.dtype(name))


def _equal(a: Leaf, b: Leaf) -> bool:
    """Equal values (as ``np.array_equal`` compares them)."""
    if a[1] == _BF16:
        return np.array_equal(_as_f32(*a), _as_f32(*b))
    return np.array_equal(a[0], b[0])


def _flatten_pairs(variables: dict) -> List[Tuple[str, Leaf]]:
    return [(k, to_wire(a)) for k, a in _flatten(variables)]


def _tree(leaves: Dict[str, Leaf]) -> dict:
    return _unflatten({k: from_wire(a, n) for k, (a, n) in leaves.items()})


def _q8_scale(d: np.ndarray) -> np.ndarray:
    """Per-output-channel symmetric scale over the LAST axis for matrices
    (the int8 matmul's channel convention), per-tensor for vectors."""
    if d.ndim >= 2:
        absmax = np.max(np.abs(d), axis=tuple(range(d.ndim - 1)),
                        keepdims=True)
    else:
        absmax = np.max(np.abs(d), keepdims=True).reshape(
            (1,) * max(d.ndim, 1))
    return np.maximum(absmax, 1e-12).astype(np.float32) / 127.0


def _account(phase: str, nbytes: int, seconds: Optional[float],
             **attrs: Any) -> None:
    try:
        from ..utils import profiler

        if seconds is None:
            profiler.account(phase, nbytes)
        else:
            profiler.record_io(phase, nbytes, seconds, **attrs)
    except Exception:
        pass  # accounting never fails the data path


class DeltaEncoder:
    """Stateful encoder of one receiver chain.

    ``synced`` is the receiver's reconstructed flat tree after its last
    decode (quantization error included): the error-feedback carry of
    delta-int8 is implicit in it. The first encode (no base) ships a full
    raw snapshot."""

    def __init__(self, codec: str = "raw"):
        if codec not in CODECS:
            raise DataPlaneError(f"unknown codec {codec!r} (valid: {CODECS})")
        self.codec = codec
        self.version: Optional[int] = None
        self.synced: Dict[str, Leaf] = {}

    def encode(self, variables: dict, version: int) -> bytes:
        """One update payload: ``variables`` at ``version`` against the
        synced state (a full snapshot when there is none)."""
        t0 = time.perf_counter()
        pairs = _flatten_pairs(variables)
        base = self.version if self.synced else None
        fresh = base is None
        leaves: List[dict] = []
        chunks: List[bytes] = []
        dense = 0
        new_synced: Dict[str, Leaf] = {}
        for path, leaf in pairs:
            arr, name = leaf
            dense += arr.nbytes
            entry: Dict[str, Any] = {
                "path": path, "dtype": name, "shape": list(arr.shape),
            }
            prev = None if fresh else self.synced.get(path)
            if fresh or self.codec == "raw" or prev is None \
                    or prev[1] != name or prev[0].shape != arr.shape:
                self._emit_raw(entry, chunks, arr)
            elif self.codec == "delta":
                if _equal(prev, leaf):
                    entry["enc"], entry["nbytes"] = "skip", 0
                    new_synced[path] = prev
                else:
                    self._emit_raw(entry, chunks, arr)
            else:  # delta-int8
                self._emit_q8(entry, chunks, path, prev, leaf, new_synced)
            if entry["enc"] != "skip" and entry["enc"] != "q8":
                new_synced[path] = leaf
            leaves.append(entry)
        header = json.dumps({
            "codec": self.codec, "version": int(version),
            "base_version": base, "leaves": leaves,
        }).encode()
        payload = b"".join(
            [MAGIC, bytes([_CODEC_ID[self.codec]]),
             struct.pack("<I", len(header)), header] + chunks)
        # the chain continues from what the receiver reconstructs
        self.synced = new_synced
        self.version = int(version)
        _account(f"weights.encode.{self.codec}", len(payload),
                 time.perf_counter() - t0, dense_bytes=dense, version=version)
        _account("weights.encode.dense", dense, None)
        return payload

    @staticmethod
    def _emit_raw(entry: dict, chunks: List[bytes], arr: np.ndarray) -> None:
        data = arr.tobytes()
        entry["enc"], entry["nbytes"] = "raw", len(data)
        chunks.append(data)

    def _emit_q8(self, entry: dict, chunks: List[bytes], path: str,
                 prev: Leaf, leaf: Leaf,
                 new_synced: Dict[str, Leaf]) -> None:
        arr, name = leaf
        if _equal(prev, leaf):
            # held bit-exactly by the receiver (a frozen leaf): a skip, not
            # an all-zero q8 payload every round
            entry["enc"], entry["nbytes"] = "skip", 0
            new_synced[path] = prev
            return
        if not (_is_float(name) and arr.size >= MIN_Q8_SIZE):
            self._emit_raw(entry, chunks, arr)
            new_synced[path] = leaf
            return
        # against the receiver-synced state: the true update plus the
        # error-feedback residual of every earlier round
        base = _as_f32(*prev)
        d = _as_f32(arr, name) - base
        scale = _q8_scale(d)
        q = np.clip(np.round(d / scale), -127, 127).astype(np.int8)
        new_synced[path] = (_cast(base + q.astype(np.float32) * scale, name),
                            name)
        sdata = scale.tobytes()
        qdata = q.tobytes()
        entry.update(enc="q8", nbytes=len(qdata), snbytes=len(sdata),
                     sshape=list(scale.shape))
        chunks.append(sdata)
        chunks.append(qdata)


class DeltaDecoder:
    """The receiving mirror: the reconstructed flat tree and its version;
    ``decode`` applies raw, skip and q8 chunks and returns the nested tree
    (fresh leaves each update: earlier trees stay valid)."""

    def __init__(self):
        self.version: Optional[int] = None
        self.tree: Dict[str, Leaf] = {}

    def decode(self, payload: bytes) -> Tuple[dict, int]:
        t0 = time.perf_counter()
        if len(payload) < 9 or payload[:4] != MAGIC:
            raise DataPlaneError("not a kubeml weights payload (bad magic)")
        (hlen,) = struct.unpack("<I", payload[5:9])
        try:
            header = json.loads(payload[9:9 + hlen])
        except ValueError as e:
            raise DataPlaneError(f"malformed payload header: {e}")
        codec = header.get("codec")
        base = header.get("base_version")
        version = int(header["version"])
        if base is not None and base != self.version:
            raise BaseVersionMismatch(
                f"payload delta base is v{base} but this decoder holds "
                f"{'nothing' if self.version is None else f'v{self.version}'}")
        off = 9 + hlen
        tree: Dict[str, Leaf] = {}
        for leaf in header["leaves"]:
            path, enc, name = leaf["path"], leaf["enc"], leaf["dtype"]
            dtype = wire_dtype(name)
            shape = tuple(leaf["shape"])
            if enc == "skip":
                if path not in self.tree:
                    raise DataPlaneError(
                        f"skip chunk for {path!r} but no synced copy held")
                tree[path] = self.tree[path]
                continue
            if enc == "raw":
                n = leaf["nbytes"]
                # a copy: a view would pin the whole payload for as long as
                # the leaf is skip-forwarded
                tree[path] = (np.frombuffer(
                    payload, dtype=dtype,
                    count=int(np.prod(shape, dtype=np.int64)),
                    offset=off).reshape(shape).copy(), name)
                off += n
                continue
            if enc != "q8":
                raise DataPlaneError(f"unknown leaf encoding {enc!r}")
            prev = self.tree.get(path)
            if prev is None:
                raise DataPlaneError(
                    f"q8 delta for {path!r} but no synced copy held")
            sn, n = leaf["snbytes"], leaf["nbytes"]
            scale = np.frombuffer(payload, np.float32, count=sn // 4,
                                  offset=off).reshape(tuple(leaf["sshape"]))
            off += sn
            q = np.frombuffer(payload, np.int8, count=n,
                              offset=off).reshape(shape)
            off += n
            tree[path] = (_cast(_as_f32(*prev) + q.astype(np.float32) * scale,
                                name), name)
        self.tree = tree
        self.version = version
        _account(f"weights.decode.{codec}", len(payload),
                 time.perf_counter() - t0, version=version)
        return _tree(tree), version


def encode_tree(variables: dict, version: int = 1,
                codec: str = "raw") -> bytes:
    """One-shot full-snapshot encode (no delta chain)."""
    return DeltaEncoder(codec).encode(variables, version)


def decode_tree(payload: bytes) -> Tuple[dict, int]:
    """One-shot decode of a full-snapshot payload."""
    return DeltaDecoder().decode(payload)


class WeightsWire:
    """The runner's side of the HTTP weight seam.

    One delta chain serves every client: publish N encodes the delta
    ``N-1 -> N`` once; a client at ``since == N-1`` gets that delta, a
    client further behind (or new) a full raw snapshot of the
    RECONSTRUCTED tree (so its next deltas chain bit-identically), and a
    current client ``("current", N)``."""

    def __init__(self, codec: Optional[str] = None):
        self.codec = codec or codec_from_env()
        self._encoder = DeltaEncoder(self.codec)
        self._lock = threading.Lock()
        self._delta: Optional[bytes] = None  # prev_version -> version
        self._prev_version: Optional[int] = None
        self._full: Optional[bytes] = None  # lazy snapshot cache
        self.version: Optional[int] = None

    def publish(self, variables: dict, version: int) -> None:
        with self._lock:
            prev = self._encoder.version if self._encoder.synced else None
            payload = self._encoder.encode(variables, version)
            if prev is None:
                # the first encode IS the full snapshot
                self._delta, self._prev_version, self._full = (None, None,
                                                               payload)
            else:
                self._delta, self._prev_version, self._full = (payload, prev,
                                                               None)
            self.version = int(version)

    def get(self, since: Optional[int] = None):
        """None before the first publish; ``("current", version)`` when
        ``since`` is up to date; else ``(payload, version)``."""
        with self._lock:
            if self.version is None:
                return None
            if since is not None and since == self.version:
                return ("current", self.version)
            if (since is not None and self._delta is not None
                    and since == self._prev_version):
                return (self._delta, self.version)
            if self._full is None:
                self._full = DeltaEncoder("raw").encode(
                    _tree(dict(self._encoder.synced)), self.version)
            return (self._full, self.version)
