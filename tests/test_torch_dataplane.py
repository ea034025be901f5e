"""The port's KMW1 weight wire (``kubeml_tpu_torch/engine/dataplane.py``)
and data-plane counters (``utils/profiler.py``) against the JAX
package's: the same numpy inputs through both.

* the payloads of a five-version chain are BYTE-equal between the
  packages under ``raw``, ``delta`` and ``delta-int8``; the chain holds a
  bfloat16 leaf (ml_dtypes in JAX, a torch tensor in the port), integer
  leaves, a leaf under ``MIN_Q8_SIZE`` and frozen leaves;
* each package decodes the other's payloads into the same tree;
* ``BaseVersionMismatch`` and malformed payloads raise in both;
* ``WeightsWire`` answers delta, full, current and nothing as JAX's does;
* ``render_metrics`` gives JAX's lines after the same accounting calls.

Tolerance: none, every comparison is exact.
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeml_tpu.engine import dataplane as jdp
from kubeml_tpu.utils import profiler as jprof
from kubeml_tpu_torch.engine import dataplane as tdp
from kubeml_tpu_torch.utils import profiler as tprof

CODECS = ("raw", "delta", "delta-int8")


def chain(n=5, seed=0):
    """n versions of one tree as numpy (bfloat16 leaf as f32 values)."""
    rng = np.random.default_rng(seed)
    frozen = rng.standard_normal((48, 32)).astype(np.float32)
    kernel = rng.standard_normal((64, 32)).astype(np.float32)
    emb = rng.standard_normal((40, 32)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    out = []
    for v in range(n):
        kernel = kernel + 0.01 * rng.standard_normal(kernel.shape).astype(
            np.float32)
        emb = emb + 0.02 * rng.standard_normal(emb.shape).astype(np.float32)
        bias = bias + np.float32(0.001 * (v + 1))
        out.append({"params": {"dense": {"kernel": kernel.copy(),
                                         "bias": bias.copy()},
                               "emb": emb.copy(), "frozen": frozen},
                    "stats": {"step": np.array([v], np.int64),
                              "mask": np.ones(16, np.uint8)}})
    return out


def as_jax(tree):
    t = {**tree, "params": dict(tree["params"])}
    t["params"]["emb"] = tree["params"]["emb"].astype(ml_dtypes.bfloat16)
    return t


def as_port(tree):
    t = {**tree, "params": dict(tree["params"])}
    t["params"]["emb"] = torch.from_numpy(tree["params"]["emb"]).to(
        torch.bfloat16)
    return t


def flat(tree, prefix=""):
    """{path: (bytes, dtype name, shape)} of a tree from either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = (v.view(torch.int16).numpy().tobytes(),
                               "bfloat16", tuple(v.shape))
        else:
            a = np.asarray(v)
            out[prefix + k] = (a.tobytes(), str(a.dtype), a.shape)
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_payloads_byte_equal_and_cross_decode(codec):
    je, te = jdp.DeltaEncoder(codec), tdp.DeltaEncoder(codec)
    jd_of_t, td_of_j = jdp.DeltaDecoder(), tdp.DeltaDecoder()
    encs = []
    for v, tree in enumerate(chain(), start=1):
        jp = je.encode(as_jax(tree), v)
        tp = te.encode(as_port(tree), v)
        assert tp == jp, (codec, v)
        encs.append(jp)
        # each package decodes the other's payload into the same tree
        jt, jv = jd_of_t.decode(tp)
        tt, tv = td_of_j.decode(jp)
        assert jv == tv == v and flat(jt) == flat(tt)
    # the last payload's leaf encodings
    (hlen,) = struct.unpack("<I", encs[-1][5:9])
    encs_by_path = {leaf["path"]: leaf["enc"] for leaf in
                    json.loads(encs[-1][9:9 + hlen])["leaves"]}
    want = {"raw": dict.fromkeys(encs_by_path, "raw"),
            "delta": {"params/dense/bias": "raw",
                      "params/dense/kernel": "raw", "params/emb": "raw",
                      "params/frozen": "skip", "stats/mask": "skip",
                      "stats/step": "raw"},
            "delta-int8": {"params/dense/bias": "raw",
                           "params/dense/kernel": "q8", "params/emb": "q8",
                           "params/frozen": "skip", "stats/mask": "skip",
                           "stats/step": "raw"}}[codec]
    assert encs_by_path == want


def test_delta_int8_reconstruction_stays_bounded():
    """Error feedback: the decoded chain tracks the truth (the int8 step
    bounds each round's error; it does not accumulate)."""
    enc, dec = tdp.DeltaEncoder("delta-int8"), tdp.DeltaDecoder()
    for v, tree in enumerate(chain(), start=1):
        got, _ = dec.decode(enc.encode(as_port(tree), v))
        k = tree["params"]["dense"]["kernel"]
        err = np.abs(got["params"]["dense"]["kernel"] - k).max()
        assert err <= np.abs(k).max() / 127.0


def test_mismatch_and_malformed_raise_in_both():
    trees = chain(3)
    for dp, conv in ((jdp, as_jax), (tdp, as_port)):
        enc = dp.DeltaEncoder("delta")
        full = enc.encode(conv(trees[0]), 1)
        enc.encode(conv(trees[1]), 2)
        delta3 = enc.encode(conv(trees[2]), 3)
        dec = dp.DeltaDecoder()
        dec.decode(full)
        with pytest.raises(dp.BaseVersionMismatch, match="base is v2"):
            dec.decode(delta3)
        with pytest.raises(dp.BaseVersionMismatch, match="holds nothing"):
            dp.DeltaDecoder().decode(delta3)
        for bad in (b"", b"KMW", b"XXXX" + full[4:], full[:9] + b"{nope"):
            with pytest.raises(dp.DataPlaneError):
                dp.DeltaDecoder().decode(bad)
        with pytest.raises(dp.DataPlaneError, match="unknown codec"):
            dp.DeltaEncoder("zip")


@pytest.mark.parametrize("codec", CODECS)
def test_weights_wire_answers_as_jax(codec):
    jw, tw = jdp.WeightsWire(codec), tdp.WeightsWire(codec)
    assert jw.get() is None and tw.get(3) is None
    for v, tree in enumerate(chain(3), start=1):
        jw.publish(as_jax(tree), v)
        tw.publish(as_port(tree), v)
    for since in (None, 1, 2, 3, 7):
        jg, tg = jw.get(since), tw.get(since)
        assert tg == jg, (codec, since)
    assert tw.get(3) == ("current", 3)
    # a fresh client's full snapshot and the delta chain reconstruct the
    # same tree
    dec = tdp.DeltaDecoder()
    dec.decode(tw.get(None)[0])
    assert dec.version == 3


def test_render_metrics_equal_jax():
    for prof in (jprof, tprof):
        prof.reset_accounting()
        prof.account("stage_round", 4096)
        prof.account("dataset.read", 100.5, 0.0)
        prof.record_io("weights.publish", 2.5e6, 0.01, version=1)
        prof.record_io("weights.fetch", 1024, 2e-4, version=1)
        prof.record_retry("weights.fetch")
        prof.merge_counters({"weights.encode.delta": {
            "bytes": 300, "seconds": 0.25, "events": 2}, "bad": 7})
    assert tprof.render_metrics() == jprof.render_metrics()
    assert tprof.counters_snapshot()["dataplane"] == \
        jprof.counters_snapshot()["dataplane"]
    for prof in (jprof, tprof):
        prof.reset_accounting()
