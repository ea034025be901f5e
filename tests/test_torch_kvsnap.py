"""The port's KMS1 codec (``serving/kvsnap.py``) against the JAX package's,
on the CPU: frames round-trip for every arena storage and compression,
are byte-identical to the JAX encoder's (so either side decodes the
other's), corrupt frames are refused, the page math is JAX's, and pages
gathered from the port's in-place arena scatter back bit for bit under the
JAX frame's layer names."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubeml_tpu.serving import kvsnap as jax_kvsnap
from kubeml_tpu_torch.models.generation import init_paged_cache
from kubeml_tpu_torch.serving import kvsnap


def synth(mod, out=(7, 8, 9), kv_quant="none", dtype="float32", layers=2,
          page_tokens=4, key=(1, 2)):
    """A snapshot of ``mod``'s classes (``kvsnap`` of either package) with
    seeded pages: int8 pages and scale rows, or float pages."""
    rng = np.random.default_rng(0)
    prompt = list(range(1, 12))
    n = mod.snapshot_pages_needed(len(prompt), len(out), page_tokens)
    ls = []
    for i in range(layers):
        shape = (n, page_tokens, 4, 16)
        if kv_quant == "int8":
            ls.append(mod.LayerSnapshot(
                name=f"block_{i}",
                k=rng.integers(-128, 128, shape).astype(np.int8),
                v=rng.integers(-128, 128, shape).astype(np.int8),
                k_scale=rng.random((n, 4)).astype(np.float32),
                v_scale=rng.random((n, 4)).astype(np.float32)))
        else:
            k, v = (rng.random(shape).astype(np.float32) for _ in "kv")
            if dtype == "bfloat16":
                k, v = (torch.from_numpy(t).to(torch.bfloat16)
                        .view(torch.int16).numpy().view(np.uint16)
                        for t in (k, v))
                ls.append(mod.LayerSnapshot(name=f"block_{i}", k=k, v=v,
                                            dtype="bfloat16")
                          if mod is kvsnap else
                          mod.LayerSnapshot(name=f"block_{i}",
                                            k=k.view(_ml_bf16()),
                                            v=v.view(_ml_bf16())))
            else:
                ls.append(mod.LayerSnapshot(name=f"block_{i}", k=k, v=v))
    return mod.RequestSnapshot(
        model="tinymodel", request_id="req-1", page_tokens=page_tokens,
        kv_quant=kv_quant, spec="off", prompt=prompt, out=list(out),
        max_new=8, temp=0.0, topk=0, eos=-1, key=key, layers=ls)


def _ml_bf16():
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def bits(a):
    """A page tensor's raw bytes (bf16 held as uint16 or ml_dtypes)."""
    return np.ascontiguousarray(a).view(np.uint8)


STORAGE = [("none", "float32"), ("none", "bfloat16"), ("int8", "int8")]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kv_quant,dtype", STORAGE)
def test_kms1_roundtrip_and_byte_identical_to_jax(kv_quant, dtype, compress):
    """Port encode -> port decode keeps every field (q8 float pages within
    one int8 step, raw and int8 pages bit-exact); the port's frame is the
    JAX encoder's frame byte for byte, and each side decodes the other's
    to the same pages."""
    snap = synth(kvsnap, kv_quant=kv_quant, dtype=dtype)
    payload = kvsnap.encode_snapshot(snap, compress=compress)
    assert payload == jax_kvsnap.encode_snapshot(
        synth(jax_kvsnap, kv_quant=kv_quant, dtype=dtype), compress=compress)
    assert kvsnap.peek_header(payload) == jax_kvsnap.peek_header(payload)
    back = kvsnap.decode_snapshot(payload)
    theirs = jax_kvsnap.decode_snapshot(payload)
    assert (back.prompt, back.out, back.max_new, back.key) == (
        snap.prompt, snap.out, snap.max_new, tuple(snap.key))
    assert back.kv_quant == kv_quant and back.npages == snap.npages
    for a, b, j in zip(snap.layers, back.layers, theirs.layers):
        assert a.name == b.name == j.name
        assert b.wire_dtype == dtype
        for t in ("k", "v"):
            assert bits(getattr(b, t)).tobytes() == bits(
                getattr(j, t)).tobytes()
            if compress and kv_quant == "none":
                ref = getattr(a, t)
                if dtype == "bfloat16":
                    ref = kvsnap._bf16_to_f32(ref)
                    got = kvsnap._bf16_to_f32(getattr(b, t))
                else:
                    got = getattr(b, t)
                np.testing.assert_allclose(got, ref, atol=0.02)
            else:
                assert bits(getattr(b, t)).tobytes() == bits(
                    getattr(a, t)).tobytes()
        if kv_quant == "int8":
            np.testing.assert_array_equal(b.k_scale, a.k_scale)
            np.testing.assert_array_equal(b.v_scale, j.v_scale)


def test_port_sampler_field_is_ignored_by_the_jax_decoder():
    snap = synth(kvsnap)
    snap.temp = 0.8
    snap.sampler = {"device": "cpu", "seed": 5, "state": "AAEC"}
    payload = kvsnap.encode_snapshot(snap)
    assert kvsnap.decode_snapshot(payload).sampler == snap.sampler
    theirs = jax_kvsnap.decode_snapshot(payload)
    assert theirs.out == snap.out and theirs.temp == 0.8


@pytest.mark.parametrize("corrupt", ["magic", "version", "truncated",
                                     "trailing", "short", "header"])
def test_kms1_rejects_corrupt_frames(corrupt):
    payload = kvsnap.encode_snapshot(synth(kvsnap))
    bad = {"magic": b"XXXX" + payload[4:],
           "version": payload[:4] + b"\x63" + payload[5:],
           "truncated": payload[:-3],
           "trailing": payload + b"\x00",
           "short": b"KM",
           "header": payload[:9] + b"!" + payload[10:]}[corrupt]
    with pytest.raises(kvsnap.SnapshotError):
        kvsnap.decode_snapshot(bad)
    with pytest.raises(jax_kvsnap.SnapshotError):
        jax_kvsnap.decode_snapshot(bad)


@pytest.mark.parametrize("plen,out,pt", [(11, 0, 4), (11, 1, 4), (11, 2, 4),
                                         (11, 3, 4), (1, 1, 4), (16, 1, 16),
                                         (16, 2, 16), (300, 40, 16)])
def test_snapshot_page_math_matches_jax(plen, out, pt):
    """A row with m consumed emissions wrote positions 0..plen+m-2."""
    assert (kvsnap.snapshot_pages_needed(plen, out, pt)
            == jax_kvsnap.snapshot_pages_needed(plen, out, pt))


@pytest.mark.parametrize("kv_quant,dtype", [("off", torch.float32),
                                            ("off", torch.bfloat16),
                                            ("int8", torch.float32)])
def test_gather_scatter_round_trip_on_the_port_arena(kv_quant, dtype):
    """Pages gathered from one arena (named ``block_<i>``, the JAX
    frame's names) scatter into other pages of a fresh arena bit for bit,
    scale rows included; the frame between them changes nothing."""
    tm = SimpleNamespace(depth=2, num_heads=4, embed_dim=64, dtype=dtype,
                         device=torch.device("cpu"))
    src = init_paged_cache(tm, 9, 4, kv_quant, "gather")
    g = torch.Generator().manual_seed(0)
    for arena in src.layers:
        for name, t in arena.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.rand(t.shape, generator=g))
    layers = kvsnap.gather_pages(src, [3, 5, 2])
    assert [l.name for l in layers] == ["block_0", "block_1"]
    snap = synth(kvsnap)
    snap.layers, snap.page_tokens = layers, 4
    snap.prompt, snap.out = list(range(1, 11)), [4, 4]  # 11 written: 3 pages
    back = kvsnap.decode_snapshot(kvsnap.encode_snapshot(snap))
    dst = init_paged_cache(tm, 9, 4, kv_quant, "gather")
    kvsnap.scatter_pages(dst, [7, 1, 4], back.layers)
    for a, b in zip(src.layers, dst.layers):
        for name in a:
            assert torch.equal(a[name][[3, 5, 2]], b[name][[7, 1, 4]]), name
            assert not b[name][[2, 3, 5, 6, 8]].any()
    with pytest.raises(kvsnap.SnapshotError):
        kvsnap.scatter_pages(dst, [1], back.layers[:1])
