"""The port's serving telemetry against the JAX package, on the CPU:
``serving/stats.py::DecoderStats`` event by event, the per-request result
keys, and the paged engine's ``telemetry()`` counter by counter under the
JAX names, on ``tests/test_torch_serving.py``'s workload.

Host-side accounting must be EQUAL: request outcomes, tokens, admission
waves, chunks, device steps, the live/dead/idle slot-step partition,
prefill and prefix tokens, chunked-prefill counters and page gauges. What
is left out, and why:

* timings (latency, TTFT and ITL quantiles, rates, HOL stall seconds,
  histograms): host clocks of two engines;
* ``prefill_pad_tokens`` and ``kv_read_bytes``: the JAX engine pads every
  prefill to ``slots`` rows and a power-of-two length and ships
  power-of-two table widths; the eager engine pads a group to its longest
  suffix and reads each row's own table, so both compute, and count, less;
* ``fetches``/``fetch_busy_seconds``/``fetchers_total`` and
  ``compiled_programs``/``compiles``/``compiles_per_minute``: the JAX
  engine's result-fetch pool and XLA compile tracker (the port reports 0).
"""

import numpy as np
import pytest
import torch

from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.serving.batcher import PagedBatchingDecoder as JaxDecoder
from kubeml_tpu.serving.stats import DecoderStats as JaxStats
from kubeml_tpu_torch.api import GenerateRequest
from kubeml_tpu_torch.serving import PagedBatchingDecoder
from kubeml_tpu_torch.serving.stats import DecoderStats
from test_torch_serving import MAX_NEWS, workload
from torch_port_helpers import jax_init, jax_tiny, torch_twin

TIMING = ("seconds", "per_second", "per_minute")
BY_DESIGN = {"prefill_pad_tokens", "kv_read_bytes", "fetches",
             "fetch_busy_seconds", "fetchers_total", "fetcher_utilization",
             "compiled_programs", "compiles", "compile_storm", "hist"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    jm = jax_tiny(max_len=48)
    variables = jax_init(jm)
    return jm, variables, torch_twin(jm, variables)


def counters(snap):
    return {k: v for k, v in snap.items()
            if k not in BY_DESIGN and not any(t in k for t in TIMING)}


# --- DecoderStats, event by event ---


EVENTS = {
    "requests": [("submitted", (1,)), ("submitted", (2,)), ("rejected", ()),
                 ("timed_out", ()), ("canceled", ()), ("overloaded", ()),
                 ("shed", ()), ("deadline_expired", ()), ("failed", (2,)),
                 ("completed", (0.5,)), ("emitted", (3,)),
                 ("emitted", (2, True))],
    "steps": [("admitted_wave", ()), ("admit_tokens", (12, 4)),
              ("chunk", ()), ("chunk_occupancy", (4, 6, 2, 0, 2)),
              ("chunk_occupancy", (1, 5, 3, 4, 12)),
              ("spec_step", (8, 5, 12)), ("spec_step", (0, 0, 0)),
              ("prefix_hit", (8,)), ("kv_read", (4096, 0.01)),
              ("prefill_chunk", (2, 32)), ("hol_stall", (0.25, 3))],
    "recovery": [("snapshot_save", (2048, 0.001)),
                 ("snapshot_restore", (2048, 0.002)),
                 ("snapshot_replay", (3,)), ("snapshot_replay", (0,)),
                 ("snapshot_fail", ()), ("pool_audit", (True,)),
                 ("pool_audit", (False,))],
}


@pytest.mark.parametrize("events", sorted(EVENTS))
def test_decoder_stats_snapshot_matches_jax(events):
    """The same events through both classes give the same counters and the
    same histogram bucket counts; the recovery, audit and spec series
    appear only once their events ran, in both."""
    port, ref = DecoderStats(2), JaxStats(2)
    for name, args in EVENTS[events]:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
    a, b = port.snapshot(), ref.snapshot()
    assert counters(a) == counters(b)
    assert a["hol_stall_seconds"] == b["hol_stall_seconds"]
    for key, h in b.get("hist", {}).items():
        if key in a.get("hist", {}):
            assert a["hist"][key] == h, key
    assert set(a.get("hist", {})) == {
        k for k in b.get("hist", {}) if k != "cold_start"}


def test_stats_quantiles_and_rates_match_jax():
    """Nearest-rank quantiles over the rings, and a burst's windowed rate
    (the same events at the same instants)."""
    port, ref = DecoderStats(4), JaxStats(4)
    for i, lat in enumerate((0.3, 0.1, 0.7, 0.2, 0.9)):
        for s in (port, ref):
            s.completed(lat)
            s.first_token(lat / 10)
            s.inter_token(lat / 100 * i)
    a, b = port.snapshot(), ref.snapshot()
    for key in b:
        if key.startswith(("latency_", "first_token_", "itl_")):
            assert a[key] == b[key], key
    port.emitted(10)
    assert port.tokens_per_second() > 0
    port.overloaded()
    assert port.overload_per_second() == pytest.approx(0.1)


# --- the engine ---


def serve(dec, request_cls, prompts, news):
    """All requests submitted under the engine lock (so admission does not
    depend on submit timing); the results and the telemetry."""
    try:
        with dec._cond:
            entries = [dec.submit(request_cls(prompts=p.tolist(),
                                              max_new_tokens=n))
                       for p, n in zip(prompts, news)]
        res = [dec.wait(e, timeout=600) for e in entries]
        return res, dec.telemetry()
    finally:
        dec.close()


def test_result_keys_match_jax_and_unstalled_rows_charge_no_stall(served):
    """``_Entry.result`` carries JAX's keys (``itl_p99``, ``itl_max`` and
    ``hol_stall_seconds`` included); a request no prefill forward delayed
    is charged 0.0 stall in both engines, and its ITL quantiles are its
    gaps."""
    jm, variables, tm = served
    kw = dict(slots=2, chunk_steps=4, page_tokens=4)
    p = [np.asarray([[3, 4, 5]], np.int32)]
    jres, _ = serve(JaxDecoder(jm, variables, paged_attn="gather", **kw),
                    JaxRequest, p, [12])
    tres, _ = serve(PagedBatchingDecoder(tm, device="cpu", **kw),
                    GenerateRequest, p, [12])
    assert sorted(tres[0]) == sorted(jres[0])
    assert tres[0]["hol_stall_seconds"] == jres[0]["hol_stall_seconds"] == 0.0
    assert tres[0]["tokens"] == jres[0]["tokens"]
    # 12 tokens: a prefill, then chunks of 4, 4, 2, 1 - four gaps
    assert 0.0 < tres[0]["itl_p99"] <= tres[0]["itl_max"]


@pytest.mark.parametrize("chunk", [0, 4])
def test_telemetry_counters_match_jax(served, chunk):
    """``telemetry()`` under the JAX names, plain and with chunked
    prefill: the same key set, and every counter equal but for the
    timings and the by-design differences named in the module
    docstring."""
    jm, variables, tm = served
    kw = dict(slots=2, chunk_steps=4, page_tokens=4,
              prefill_chunk_tokens=chunk)
    # a pipeline deeper than this workload's dispatches: the JAX engine
    # then never has room for one dispatch only, where it alternates a
    # prefill chunk with a decode chunk by turns and its schedule (and
    # step counts) would follow result-fetch timing; the eager engine
    # runs both each turn
    _, jt = serve(JaxDecoder(jm, variables, paged_attn="gather",
                             pipeline_depth=64, **kw),
                  JaxRequest, workload(), MAX_NEWS)
    _, tt = serve(PagedBatchingDecoder(tm, device="cpu", **kw),
                  GenerateRequest, workload(), MAX_NEWS)
    assert set(tt) - BY_DESIGN == set(jt) - BY_DESIGN
    assert counters(tt) == counters(jt)
    assert tt["weight_bytes"] == jt["weight_bytes"]
    # the values the Queue 3 entry recorded
    assert (tt["admission_waves"], tt["device_steps"], tt["chunks"]) == (
        (3, 9, 4) if chunk == 0 else (4, 17, 8))
    assert tt["live_slot_steps"] + tt["dead_slot_steps"] \
        + tt["idle_slot_steps"] == tt["slot_steps"]
    assert tt["kv_read_bytes"] > 0
