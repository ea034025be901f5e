"""Portable per-request KV snapshots: the ``KMS1`` frame, port of
``kubeml_tpu/serving/kvsnap.py``, byte-compatible with it.

A live row's serving state is a page table (the ``kvpool`` lease), the
page contents in the arena (``models.generation.PagedCache``) and a few
host scalars (prompt, emitted tokens, sampler state). This module
serializes that state into one versioned frame, so a generation can move
across an engine fault (snapshot before the arena is zeroed, replay after),
across a restart (drain, restore on the next boot) and across engines: a
frame the JAX engine wrote restores here and one written here restores
there. Frame layout (``application/x-kubeml-kvsnap``)::

    b"KMS1" | u8 version | u32le header_len | header JSON | chunks...

    header = {"format": "KMS1", "version": 1, "model", "request_id",
              "page_tokens", "kv_quant", "spec", "prompt_len", "out_len",
              "max_new", "temp", "topk", "eos", "key": [u32, u32],
              "npages", "compress": "raw"|"q8",
              "layers": [{"name", "dtype", "page_shape": [pt, H, D],
                          "enc": "raw"|"q8", "scales": bool}, ...],
              "torch_sampler": {...}}   # written by this port only

Chunks follow in a fixed order: prompt tokens (i32 LE), emitted tokens
(i32 LE), then per layer ``block_<i>``: ``k_scale`` f32 ``[npages, H]``
(int8 arenas only), K page data, ``v_scale``, V page data. ``q8`` ships a
float K/V tensor as a per-head-dim-channel f32 scale and int8 data (lossy,
off by default); int8 arenas always ship their raw bytes and scale rows.

Only pages holding written positions travel: a row that emitted ``m``
tokens has K/V through position ``prompt_len + m - 2`` (the step that
produced emission ``m`` wrote its input there), so ``npages =
ceil((prompt_len + m - 1) / page_tokens)``. The last page travels whole,
its tail included, so an int8 page's scale (which every write into the
page moved by scatter-max) comes back exactly as it was.

The sampler: the JAX engine rebuilds a row's key as its root ``key`` plus
one split per emission, which needs JAX. This port draws from one
``torch.Generator`` per row instead, and a spec step draws a number of
values that emissions do not determine, so its frames carry the
generator's state as it stood after the last consumed step, under the
``torch_sampler`` header field (``{"device", "seed", "state"}``, the
state base64), which the JAX decoder ignores. Greedy rows need none.
"""

from __future__ import annotations

import base64
import json
import math
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"KMS1"
VERSION = 1

# the extension of the frames a parameter server drains into its snapshot
# directory
SNAP_SUFFIX = ".kms"

# bfloat16 pages travel as their raw 16-bit patterns (numpy has no
# bfloat16); the wire dtype name stays "bfloat16", as the JAX frame's
_BF16 = "bfloat16"


class DataPlaneError(ValueError):
    """Malformed payload or codec misuse."""


class SnapshotError(DataPlaneError):
    """Malformed KMS1 payload or snapshot/engine geometry mismatch."""


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a wire dtype name is held in (bfloat16: its raw
    16-bit patterns)."""
    if name == _BF16:
        return np.dtype(np.uint16)
    return np.dtype(name)


def _q8_scale(d: np.ndarray) -> np.ndarray:
    """Symmetric int8 scale per channel of the last axis (per tensor for a
    vector): absmax / 127, floored at 1e-12 / 127."""
    if d.ndim >= 2:
        absmax = np.max(np.abs(d), axis=tuple(range(d.ndim - 1)),
                        keepdims=True)
    else:
        absmax = np.max(np.abs(d), keepdims=True).reshape((1,) * max(d.ndim, 1))
    return np.maximum(absmax, 1e-12).astype(np.float32) / 127.0


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to nearest even, as ``astype(bfloat16)`` does."""
    return (torch.from_numpy(np.ascontiguousarray(x, np.float32))
            .to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))


@dataclass
class LayerSnapshot:
    """One layer's gathered K/V pages: ``k``/``v`` ``[npages, page_tokens,
    heads, head_dim]`` in the arena's storage dtype (``dtype`` names it on
    the wire; bfloat16 pages are held as uint16 bit patterns), and for int8
    arenas the per-(page, head) f32 scale rows ``[npages, heads]``."""

    name: str
    k: np.ndarray
    v: np.ndarray
    k_scale: Optional[np.ndarray] = None
    v_scale: Optional[np.ndarray] = None
    dtype: str = ""

    @property
    def wire_dtype(self) -> str:
        return self.dtype or str(self.k.dtype)


@dataclass
class RequestSnapshot:
    """Everything needed to rebuild one live row in a compatible arena."""

    model: str
    request_id: str
    page_tokens: int
    kv_quant: str           # arena storage: "none" | "int8"
    spec: str               # the engine's spec mode at snapshot time
    prompt: List[int]
    out: List[int]          # emitted tokens (m = len(out))
    max_new: int
    temp: float
    topk: int
    eos: int
    key: Tuple[int, int]    # the JAX engine's root sampler key
    layers: List[LayerSnapshot] = field(default_factory=list)
    # this port's sampler: {"device", "seed", "state"}
    sampler: Optional[dict] = None

    @property
    def npages(self) -> int:
        return snapshot_pages_needed(len(self.prompt), len(self.out),
                                     self.page_tokens)


def snapshot_pages_needed(prompt_len: int, out_len: int,
                          page_tokens: int) -> int:
    """Pages holding written history for a row that emitted ``out_len``
    tokens: positions ``0 .. prompt_len + out_len - 2``. Zero emissions
    ship no page (the row prefills again from its prompt)."""
    if out_len <= 0:
        return 0
    return int(math.ceil((prompt_len + out_len - 1) / page_tokens))


def sampler_state(state: torch.Tensor) -> str:
    """A generator state (``Generator.get_state()``) as the frame's base64
    text."""
    return base64.b64encode(state.numpy().tobytes()).decode()


def sampler_generator(sampler: dict, device) -> torch.Generator:
    """A generator on ``device`` in the state a frame recorded."""
    gen = torch.Generator(device=device)
    state = np.frombuffer(base64.b64decode(sampler["state"]), np.uint8)
    gen.set_state(torch.from_numpy(state.copy()))
    return gen


# --- arena access (models.generation.PagedCache) ---

def _layer_name(i: int) -> str:
    return f"block_{i}"


def gather_pages(cache, pages: Sequence[int]) -> List[LayerSnapshot]:
    """Copy physical ``pages`` of every layer's arena to the host (the
    copy waits for every forward already queued on the arena's stream)."""
    if not pages:
        return []
    out: List[LayerSnapshot] = []
    for i, arena in enumerate(cache.layers):
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=arena["k_pages"].device)
        k, v = arena["k_pages"][idx].cpu(), arena["v_pages"][idx].cpu()
        dtype = ""
        if k.dtype == torch.bfloat16:
            k, v = k.view(torch.int16), v.view(torch.int16)
            dtype = _BF16
        k = k.numpy()
        v = v.numpy()
        if dtype:
            k, v = k.view(np.uint16), v.view(np.uint16)
        ks = vs = None
        if "k_scale" in arena:
            ks = arena["k_scale"][idx].cpu().numpy()
            vs = arena["v_scale"][idx].cpu().numpy()
        out.append(LayerSnapshot(name=_layer_name(i), k=k, v=v, k_scale=ks,
                                 v_scale=vs, dtype=dtype))
    return out


def _to_arena(data: np.ndarray, wire: str, like: torch.Tensor):
    """``data`` (held in wire dtype ``wire``) as a tensor of ``like``'s
    dtype on its device: bit-exact where the dtypes agree, else rounded
    through f32."""
    if like.dtype == torch.bfloat16:
        if wire != _BF16:
            data = _f32_to_bf16(data.astype(np.float32))
        t = torch.from_numpy(np.ascontiguousarray(data).view(np.int16))
        return t.view(torch.bfloat16).to(like.device)
    if wire == _BF16:
        data = _bf16_to_f32(data)
    return torch.from_numpy(np.ascontiguousarray(data)).to(like.device,
                                                           like.dtype)


def scatter_pages(cache, pages: Sequence[int],
                  layers: List[LayerSnapshot]) -> None:
    """Write snapshot pages into physical ``pages`` of ``cache``, in
    place."""
    if len(cache.layers) != len(layers):
        raise SnapshotError(f"snapshot has {len(layers)} layers but the "
                            f"arena has {len(cache.layers)}")
    for i, (arena, layer) in enumerate(zip(cache.layers, layers)):
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=arena["k_pages"].device)
        if "k_scale" in arena and (layer.k_scale is None
                                   or layer.v_scale is None):
            raise SnapshotError(
                f"arena layer {_layer_name(i)!r} stores int8 pages but the "
                "snapshot carries no scale rows")
        wire = layer.wire_dtype
        arena["k_pages"][idx] = _to_arena(layer.k, wire, arena["k_pages"])
        arena["v_pages"][idx] = _to_arena(layer.v, wire, arena["v_pages"])
        if "k_scale" in arena:
            arena["k_scale"][idx] = _to_arena(layer.k_scale, "float32",
                                              arena["k_scale"])
            arena["v_scale"][idx] = _to_arena(layer.v_scale, "float32",
                                              arena["v_scale"])


# --- wire codec ---

def snapshot_nbytes(snap: RequestSnapshot) -> int:
    """Payload bytes of the tokens and page data."""
    n = 4 * (len(snap.prompt) + len(snap.out))
    for layer in snap.layers:
        n += layer.k.nbytes + layer.v.nbytes
        if layer.k_scale is not None:
            n += layer.k_scale.nbytes + layer.v_scale.nbytes
    return n


def _emit_tensor(chunks: List[bytes], arr: np.ndarray, wire: str,
                 compress: bool) -> str:
    """Append one K or V tensor; returns its encoding. ``q8`` ships the
    channel scale then int8 data (float tensors only)."""
    if compress and wire != "int8" and arr.size:
        d = _bf16_to_f32(arr) if wire == _BF16 else arr.astype(np.float32)
        scale = _q8_scale(d)
        q = np.clip(np.round(d / scale), -127, 127).astype(np.int8)
        chunks.append(scale.tobytes())
        chunks.append(q.tobytes())
        return "q8"
    chunks.append(np.ascontiguousarray(arr).tobytes())
    return "raw"


def encode_snapshot(snap: RequestSnapshot, compress: bool = False) -> bytes:
    """One KMS1 frame. ``compress=True`` int8-quantizes float pages (lossy:
    restored greedy tokens may then differ; int8 arenas always ship
    raw)."""
    chunks: List[bytes] = [
        np.asarray(snap.prompt, dtype=np.int32).tobytes(),
        np.asarray(snap.out, dtype=np.int32).tobytes(),
    ]
    layers_meta: List[dict] = []
    for layer in snap.layers:
        if layer.k.shape != layer.v.shape:
            raise SnapshotError(f"layer {layer.name!r} K/V shape mismatch: "
                                f"{layer.k.shape} vs {layer.v.shape}")
        wire = layer.wire_dtype
        enc = None
        for tensor, scale in ((layer.k, layer.k_scale),
                              (layer.v, layer.v_scale)):
            if scale is not None:
                chunks.append(np.ascontiguousarray(
                    scale.astype(np.float32)).tobytes())
            enc = _emit_tensor(chunks, tensor, wire, compress)
        layers_meta.append({
            "name": layer.name,
            "dtype": wire,
            "page_shape": list(layer.k.shape[1:]),
            "enc": enc,
            "scales": layer.k_scale is not None,
        })
    header = {
        "format": "KMS1", "version": VERSION,
        "model": snap.model, "request_id": snap.request_id,
        "page_tokens": int(snap.page_tokens),
        "kv_quant": snap.kv_quant, "spec": snap.spec,
        "prompt_len": len(snap.prompt), "out_len": len(snap.out),
        "max_new": int(snap.max_new), "temp": float(snap.temp),
        "topk": int(snap.topk), "eos": int(snap.eos),
        "key": [int(snap.key[0]), int(snap.key[1])],
        "npages": int(snap.npages),
        "compress": "q8" if compress else "raw",
        "layers": layers_meta,
    }
    if snap.sampler is not None:
        header["torch_sampler"] = snap.sampler
    head = json.dumps(header).encode()
    return b"".join([MAGIC, bytes([VERSION]),
                     struct.pack("<I", len(head)), head] + chunks)


def peek_header(payload: bytes) -> dict:
    """Parse and validate the frame header only (no page decode)."""
    if len(payload) < 9 or payload[:4] != MAGIC:
        raise SnapshotError("not a KMS1 snapshot frame (bad magic)")
    ver = payload[4]
    if ver != VERSION:
        raise SnapshotError(f"KMS1 frame version {ver} unsupported "
                            f"(this build speaks v{VERSION})")
    (hlen,) = struct.unpack("<I", payload[5:9])
    try:
        header = json.loads(payload[9:9 + hlen])
    except ValueError as e:
        raise SnapshotError(f"malformed KMS1 header: {e}")
    if not isinstance(header, dict) or header.get("format") != "KMS1":
        raise SnapshotError("KMS1 header missing format tag")
    return header


def _read(payload: bytes, off: int, dtype: np.dtype,
          shape: Tuple[int, ...]) -> Tuple[np.ndarray, int]:
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * dtype.itemsize
    if count < 0 or off + nbytes > len(payload):
        raise SnapshotError("KMS1 frame truncated (chunk overruns payload)")
    arr = np.frombuffer(payload, dtype=dtype, count=count,
                        offset=off).reshape(shape).copy()
    return arr, off + nbytes


def decode_snapshot(payload: bytes) -> RequestSnapshot:
    """Parse one KMS1 frame. Checks the magic, the version, and that the
    chunks consume the payload exactly."""
    header = peek_header(payload)
    (hlen,) = struct.unpack("<I", payload[5:9])
    off = 9 + hlen
    try:
        plen = int(header["prompt_len"])
        olen = int(header["out_len"])
        npages = int(header["npages"])
        metas = list(header["layers"])
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotError(f"KMS1 header field missing or malformed: {e}")
    prompt, off = _read(payload, off, np.dtype(np.int32), (plen,))
    out, off = _read(payload, off, np.dtype(np.int32), (olen,))
    layers: List[LayerSnapshot] = []
    for meta in metas:
        wire = str(meta["dtype"])
        try:
            dtype = _np_dtype(wire)
        except TypeError as e:
            raise SnapshotError(f"layer {meta['name']!r}: dtype {wire!r}: "
                                f"{e}")
        page_shape = tuple(int(x) for x in meta["page_shape"])
        if len(page_shape) != 3:
            raise SnapshotError(f"layer {meta['name']!r} page_shape must be "
                                f"[page_tokens, heads, head_dim], got "
                                f"{list(page_shape)}")
        shape = (npages,) + page_shape
        tensors: List[np.ndarray] = []
        scales: List[Optional[np.ndarray]] = []
        for _ in ("k", "v"):
            s = None
            if meta.get("scales"):
                s, off = _read(payload, off, np.dtype(np.float32),
                               (npages, page_shape[1]))
            if meta["enc"] == "q8":
                qs, off = _read(payload, off, np.dtype(np.float32),
                                (1,) * (len(shape) - 1) + (page_shape[-1],))
                q, off = _read(payload, off, np.dtype(np.int8), shape)
                t = q.astype(np.float32) * qs
                t = _f32_to_bf16(t) if wire == _BF16 else t.astype(dtype)
            elif meta["enc"] == "raw":
                t, off = _read(payload, off, dtype, shape)
            else:
                raise SnapshotError(f"unknown layer encoding {meta['enc']!r}")
            tensors.append(t)
            scales.append(s)
        layers.append(LayerSnapshot(
            name=meta["name"], k=tensors[0], v=tensors[1],
            k_scale=scales[0], v_scale=scales[1],
            dtype=_BF16 if wire == _BF16 else ""))
    if off != len(payload):
        raise SnapshotError(f"KMS1 frame has {len(payload) - off} trailing "
                            "bytes after the last chunk")
    return RequestSnapshot(
        model=header["model"], request_id=header["request_id"],
        page_tokens=int(header["page_tokens"]),
        kv_quant=header.get("kv_quant", "none"),
        spec=header.get("spec", "off"),
        prompt=[int(t) for t in prompt],
        out=[int(t) for t in out],
        max_new=int(header["max_new"]), temp=float(header["temp"]),
        topk=int(header["topk"]), eos=int(header["eos"]),
        key=(int(header["key"][0]), int(header["key"][1])),
        layers=layers, sampler=header.get("torch_sampler"))
