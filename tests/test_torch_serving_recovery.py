"""Mid-stream serving recovery in the port against the JAX package, on the
CPU (``tests/test_serving_recovery.py``'s bars): KMS1 frames move requests
between the two engines, an engine fault replays resident rows exactly,
the pool audit turns broken accounting into a rebuild, and the admission
controls (drain, shed-oldest, deadlines) answer with JAX's status codes
and counters. Same weights in both engines (``interop.from_flax``); JAX
``paged_attn="gather"``, port ``device="cpu"``.

Greedy tokens must be EQUAL to the uninterrupted run: a restore scatters
the saved pages bit for bit and resumes at the saved cursor. Sampled
streams are compared inside the port only (a JAX key chain and a
``torch.Generator`` draw differently): a port frame carries its
generator's state, and a sampled JAX frame is refused with 409.
"""

import threading
import time

import numpy as np
import pytest
import torch

from kubeml_tpu.api.errors import EngineFaultError as JaxFault
from kubeml_tpu.api.errors import error_from_envelope as jax_envelope
from kubeml_tpu.api.types import GenerateRequest as JaxRequest
from kubeml_tpu.serving import kvsnap as jax_kvsnap
from kubeml_tpu.serving.batcher import PagedBatchingDecoder as JaxDecoder
from kubeml_tpu.utils import resilience as jax_resilience
from kubeml_tpu_torch.api import (EngineFaultError, GenerateRequest,
                                  KubeMLError, OverloadedError,
                                  error_from_envelope)
from kubeml_tpu_torch.benchmarks import recovery
from kubeml_tpu_torch.serving import PagedBatchingDecoder, kvsnap
from kubeml_tpu_torch.serving.kvpool import PageAllocError
from kubeml_tpu_torch.utils import resilience
from torch_port_helpers import VOCAB, jax_init, jax_tiny, torch_twin

P = np.arange(1, 12, dtype=np.int32)[None]
N = 40  # long enough that a drain right after the first token is mid-stream
MODES = {"f32": {}, "int8": {"kv_quant": "int8"},
         "spec_self": {"spec": "self", "spec_exit_layer": 1, "spec_k": 2}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    jm = jax_tiny(max_len=64)
    variables = jax_init(jm)
    return jm, variables, torch_twin(jm, variables)


def jax_dec(served, **kw):
    jm, variables, _ = served
    kw.setdefault("slots", 2)
    kw.setdefault("chunk_steps", 1)
    kw.setdefault("page_tokens", 4)
    return JaxDecoder(jm, variables, paged_attn="gather", name="tinymodel",
                      **kw)


def port_dec(served, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("chunk_steps", 1)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("name", "tinymodel")
    return PagedBatchingDecoder(served[2], device="cpu", **kw)


def run(dec, request_cls, n=N, **req):
    try:
        out = dec.wait(dec.submit(request_cls(prompts=P.tolist(),
                                              max_new_tokens=n, **req)),
                       timeout=600)
        return out["tokens"][0][:out["lengths"][0]]
    finally:
        dec.close()


def hold_steps(dec, until):
    """Once a resident row of ``dec`` (either engine) has a token, hold the
    next decode or spec step until ``until()`` holds (60 s at most), once,
    so the test's own thread acts mid-stream however loaded the host."""
    names = (("_dispatch_chunk_paged", "_dispatch_spec_chunk")
             if isinstance(dec, JaxDecoder) else
             ("_decode_chunk", "_spec_step"))
    held = threading.Event()

    def gate(fn):
        def step(*a, **kw):
            if not held.is_set() and any(r is not None and r.out
                                         for r in dec._slot_rows):
                deadline = time.monotonic() + 60
                while not until() and time.monotonic() < deadline:
                    time.sleep(0.001)
                held.set()
            return fn(*a, **kw)
        return step

    for name in names:
        setattr(dec, name, gate(getattr(dec, name)))


def drain_midstream(dec, request_cls, fault_cls, **req):
    """One streamed request, drained right after its first token: its
    waiter fails retryably with a prefix of its tokens; the frame."""
    hold_steps(dec, lambda: dec._drain_req is not None)
    try:
        entry = dec.submit(request_cls(prompts=P.tolist(), max_new_tokens=N,
                                       stream=True, **req))
        gen = dec.stream(entry)
        next(gen)
        frames = dec.drain(grace=0.0)
        assert len(frames) == 1
        with pytest.raises(fault_cls) as err:
            list(gen)
        assert err.value.retryable and err.value.status_code == 503
        assert 0 < len(err.value.partial_tokens[0]) < N
        with pytest.raises(OverloadedError if request_cls is GenerateRequest
                           else Exception) as over:
            dec.submit(request_cls(prompts=P.tolist(), max_new_tokens=2))
        assert over.value.status_code == 429
        assert over.value.retry_after >= 1.0
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
        tele = dec.telemetry()
        assert tele["snapshot_saved"] == 1.0 and tele["draining"] == 1.0
        assert tele["requests_overload"] == 1.0
        return frames[0], err.value.partial_tokens[0]
    finally:
        dec.close()


# --- KMS1 frames across the two engines ---


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frame_restores_across_engines(served, direction, mode):
    """A frame drained mid-stream by one engine restores in a fresh
    decoder of the other, and the greedy continuation equals the
    uninterrupted run (f32, int8 KV pages, self-drafting)."""
    kw = MODES[mode]
    ref = run(jax_dec(served, **kw), JaxRequest)
    assert run(port_dec(served, **kw), GenerateRequest) == ref
    if direction == "jax_to_port":
        frame, partial = drain_midstream(jax_dec(served, **kw), JaxRequest,
                                         JaxFault)
        dec, request_cls = port_dec(served, **kw), GenerateRequest
    else:
        frame, partial = drain_midstream(port_dec(served, **kw),
                                         GenerateRequest, EngineFaultError)
        dec, request_cls = jax_dec(served, **kw), JaxRequest
    hdr = jax_kvsnap.peek_header(frame)
    assert hdr["out_len"] == len(partial) and hdr["spec"] == (
        kw.get("spec") or "off")
    assert ref[:len(partial)] == partial
    try:
        out = dec.wait(dec.submit_snapshot(frame), timeout=600)
        assert out["tokens"][0][:out["lengths"][0]] == ref
        s = dec.telemetry()
        assert s["snapshot_restored"] == 1.0
        assert s["snapshot_failed"] == 0.0
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
    finally:
        dec.close()


def test_port_sampled_frame_restores_bit_identical(served):
    """A sampled row's frame carries its generator's state after the last
    consumed step: the restored stream equals the uninterrupted one. (With
    self-drafting, k is fixed: how many values a step draws follows k, and
    a fresh decoder's adaptive controller starts from its own history.)"""
    knobs = dict(temperature=0.9, top_k=20, seed=11)
    for kw in ({}, dict(MODES["spec_self"], spec_adaptive=False)):
        ref = run(port_dec(served, **kw), GenerateRequest, **knobs)
        frame, partial = drain_midstream(port_dec(served, **kw),
                                         GenerateRequest, EngineFaultError,
                                         **knobs)
        assert kvsnap.decode_snapshot(frame).sampler["state"]
        assert ref[:len(partial)] == partial
        dec = port_dec(served, **kw)
        try:
            out = dec.wait(dec.submit_snapshot(frame), timeout=600)
            assert out["tokens"][0][:out["lengths"][0]] == ref
        finally:
            dec.close()


def test_stateless_and_completed_frames(served):
    """A frame with no emission prefills from its prompt (the tokens of a
    fresh submit, its request id kept); a finished one resolves at once."""
    ref = run(port_dec(served), GenerateRequest, n=6)
    snap = kvsnap.RequestSnapshot(
        model="", request_id="r-stateless", page_tokens=4, kv_quant="none",
        spec="off", prompt=P[0].tolist(), out=[], max_new=6, temp=0.0,
        topk=0, eos=-1, key=(0, 0), layers=[])
    done = kvsnap.RequestSnapshot(
        model="", request_id="r-done", page_tokens=4, kv_quant="none",
        spec="off", prompt=[1, 2, 3], out=[9, 8], max_new=2, temp=0.0,
        topk=0, eos=-1, key=(0, 0), layers=[])
    dec = port_dec(served)
    try:
        out = dec.wait(dec.submit_snapshot(kvsnap.encode_snapshot(snap)),
                       timeout=600)
        assert out["tokens"][0] == ref and out["request_id"] == "r-stateless"
        entry = dec.submit_snapshot(done)
        assert entry.done_evt.is_set()
        out = dec.wait(entry, timeout=5)
        assert out["tokens"][0][:2] == [9, 8] and out["lengths"] == [2]
    finally:
        dec.close()


@pytest.fixture(scope="module")
def frames(served):
    """Mid-stream frames of the JAX engine: f32 greedy, f32 sampled."""
    return {name: drain_midstream(jax_dec(served), JaxRequest, JaxFault,
                                  **req)[0]
            for name, req in (("greedy", {}),
                              ("sampled", dict(temperature=0.9, seed=3)))}


@pytest.mark.parametrize("case,code,words", [
    ("page_tokens", 409, "page_tokens"), ("kv_quant", 409, "KV_QUANT"),
    ("model", 409, "othermodel"), ("spec_draft", 409, "draft"),
    ("sampled_jax", 409, "torch_sampler"), ("empty_prompt", 400, "empty"),
    ("too_long", 400, "max_len")])
def test_snapshot_mismatches_rejected(served, frames, case, code, words):
    """A frame restores only into a byte-compatible arena with a sampler
    this engine can rebuild; everything else is refused up front."""
    frame = frames["sampled" if case == "sampled_jax" else "greedy"]
    kw = {"page_tokens": {"page_tokens": 8}, "kv_quant": {"kv_quant": "int8"},
          "model": {"name": "othermodel"}}.get(case, {})
    if case == "spec_draft":
        kw = dict(spec="draft", draft_module=torch_twin(
            jax_tiny(max_len=64), jax_init(jax_tiny(max_len=64), seed=1)))
    if case in ("empty_prompt", "too_long"):
        snap = kvsnap.decode_snapshot(frame)
        snap.prompt = [] if case == "empty_prompt" else list(range(1, 60))
        frame = snap
    dec = port_dec(served, **kw)
    try:
        with pytest.raises(KubeMLError) as err:
            dec.submit_snapshot(frame)
        assert err.value.status_code == code and words in str(err.value)
    finally:
        dec.close()


def test_restore_waits_for_the_page_budget(served):
    """A restore the page budget refuses stays queued at the head and
    dispatches once the occupant's pages free."""
    ref = run(port_dec(served), GenerateRequest, n=20)
    dec = port_dec(served)
    hold_steps(dec, lambda: dec._drain_req is not None)
    try:
        entry = dec.submit(GenerateRequest(prompts=P.tolist(),
                                           max_new_tokens=20, stream=True))
        next(dec.stream(entry))
        frame = dec.drain(grace=0.0)[0]
    finally:
        dec.close()
    # 8 usable pages; the occupant's 11 + 16 - 1 positions hold 7, so the
    # restore (8 pages for 11 + 20 - 1) waits
    dec = port_dec(served, pages=9, prefix_cache=False)
    try:
        occupant = dec.submit(GenerateRequest(prompts=P.tolist(),
                                              max_new_tokens=16))
        restored = dec.submit_snapshot(frame)
        out = dec.wait(restored, timeout=600)
        assert out["tokens"][0][:out["lengths"][0]] == ref
        dec.wait(occupant, timeout=600)
        assert dec._pool.check()["held"] == 0
    finally:
        dec.close()


# --- fault recovery ---


def test_fault_replays_midstream_and_queued_work_survives(served):
    rng = np.random.default_rng(7)
    p2 = rng.integers(1, VOCAB, size=(1, 7)).astype(np.int32)
    ref1 = run(port_dec(served), GenerateRequest, n=20)
    dec = port_dec(served)
    try:
        ref2 = dec.wait(dec.submit(GenerateRequest(
            prompts=p2.tolist(), max_new_tokens=10)), timeout=600)
    finally:
        dec.close()
    dec = port_dec(served, slots=1)
    try:
        state = recovery.arm_fault(dec)
        e1 = dec.submit(GenerateRequest(prompts=P.tolist(),
                                        max_new_tokens=20))
        e2 = dec.submit(GenerateRequest(prompts=p2.tolist(),
                                        max_new_tokens=10))
        out1, out2 = dec.wait(e1, timeout=600), dec.wait(e2, timeout=600)
        assert not state["armed"]
        assert out1["tokens"][0] == ref1
        assert out2["tokens"] == ref2["tokens"]
        s = dec.telemetry()
        assert (s["snapshot_saved"], s["snapshot_restored"],
                s["snapshot_replayed"]) == (1.0, 1.0, 1.0)
        chk = dec._pool.check()
        assert chk["held"] == chk["trie_pages"]
    finally:
        dec.close()


def test_replayed_rows_share_their_prompt_blocks_again(served):
    """A replayed row's pages are this arena's own history, so its prompt
    blocks go back into the rebuilt prefix trie: a request queued behind it
    with the same system prompt hits them as it does without the fault
    (a KMS1 admission from elsewhere does not share its pages)."""
    sysp = np.random.default_rng(3).integers(1, VOCAB, size=12)
    prompts = [np.concatenate([sysp, tail]).astype(np.int32)[None]
               for tail in ([5, 6], [7, 8, 9])]
    runs = []
    for fault in (False, True):
        dec = port_dec(served, slots=1)
        try:
            state = recovery.arm_fault(dec) if fault else {"armed": False}
            entries = [dec.submit(GenerateRequest(prompts=p.tolist(),
                                                  max_new_tokens=n))
                       for p, n in zip(prompts, (10, 6))]
            runs.append([dec.wait(e, timeout=600) for e in entries])
            assert not state["armed"]
        finally:
            dec.close()
    clean, replayed = runs
    assert [r["tokens"] for r in replayed] == [r["tokens"] for r in clean]
    assert (replayed[1]["prefix_cached_tokens"]
            == clean[1]["prefix_cached_tokens"] == 12)


@pytest.mark.parametrize("why", ["unreadable", "spec_draft"])
def test_unsalvageable_fault_fails_fast_and_retryable(served, why):
    """A row that cannot cross the rebuild (its pages cannot be read, or
    the draft backend's arena is not covered) fails at once with a
    retryable 503 carrying its partial tokens; the rebuilt engine serves
    fresh work."""
    kw = ({"spec": "draft", "draft_module": torch_twin(
        jax_tiny(max_len=64), jax_init(jax_tiny(max_len=64), seed=1))}
        if why == "spec_draft" else {})
    ref = run(port_dec(served), GenerateRequest, n=4)
    dec = port_dec(served, **kw)
    try:
        if why == "unreadable":
            dec._snapshot_row = lambda row, ahead=0: None
        recovery.arm_fault(dec)
        entry = dec.submit(GenerateRequest(prompts=P.tolist(),
                                           max_new_tokens=20))
        with pytest.raises(EngineFaultError) as err:
            dec.wait(entry, timeout=120)
        assert err.value.retryable and err.value.status_code == 503
        assert err.value.partial_tokens and err.value.partial_tokens[0]
        assert dec.telemetry()["requests_failed"] == 1.0
        out = dec.wait(dec.submit(GenerateRequest(
            prompts=P.tolist(), max_new_tokens=4)), timeout=600)
        assert out["tokens"][0] == ref
    finally:
        dec.close()


def test_error_envelope_round_trips_across_packages():
    e = EngineFaultError("decode engine fault: boom",
                         partial_tokens=[[1, 2, 3]])
    for back in (error_from_envelope(e.to_json(), 503),
                 jax_envelope(e.to_json(), 503)):
        assert back.retryable and back.status_code == 503
        assert back.partial_tokens == [[1, 2, 3]]
    back = error_from_envelope(JaxFault("x", partial_tokens=[[4]]).to_json())
    assert isinstance(back, EngineFaultError) and back.partial_tokens == [[4]]
    over = error_from_envelope(OverloadedError("busy", 7.5).to_json())
    assert isinstance(over, OverloadedError) and over.retry_after == 7.5


def test_pool_audit_runs_and_a_failure_rebuilds(served):
    """The audit ticks while the engine works; a tripped invariant goes
    through fault recovery: counted, the arena rebuilt, the stream
    replayed, and fresh work serves on the new pool."""
    ref = run(port_dec(served), GenerateRequest)
    dec = port_dec(served, pool_audit_interval=0.001)

    def tripped():
        raise PageAllocError("injected invariant break")

    hold_steps(dec, lambda: dec._pool.check is tripped)
    try:
        entry = dec.submit(GenerateRequest(prompts=P.tolist(),
                                           max_new_tokens=N, stream=True))
        next(dec.stream(entry))
        dec._pool.check = tripped
        out = dec.wait(entry, timeout=600)
        assert out["tokens"][0] == ref
        s = dec.telemetry()
        assert s["pool_audit_failures"] == 1.0
        assert s["pool_audit_runs"] > s["pool_audit_failures"]
        assert s["snapshot_replayed"] == 1.0
        out = dec.wait(dec.submit(GenerateRequest(
            prompts=P.tolist(), max_new_tokens=N)), timeout=600)
        assert out["tokens"][0] == ref
    finally:
        dec.close()


def jax_storm(served, specs, kw):
    """The storm through the JAX engine, one dispatch in flight, with its
    fault at the entry of the first chunk dispatched once a token landed;
    the snapshot counters."""
    jm, variables, _ = served
    dec = JaxDecoder(jm, variables, paged_attn="gather", pipeline_depth=1,
                     **kw)
    state = {"armed": True}

    def poison(fn):
        def step(*a, **k):
            if state["armed"] and any(r is not None and r.out
                                      for r in dec._slot_rows):
                state["armed"] = False
                raise RuntimeError("injected device fault")
            return fn(*a, **k)
        return step

    dec._dispatch_chunk_paged = poison(dec._dispatch_chunk_paged)
    dec._dispatch_spec_chunk = poison(dec._dispatch_spec_chunk)
    try:
        with dec._cond:
            entries = [dec.submit(JaxRequest(
                prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"],
                temperature=s["temp"], top_k=s["top_k"] if s["temp"] else None,
                seed=s["seed"] if s["temp"] else None)) for s in specs]
        for e in entries:
            dec.wait(e, timeout=600)
        assert not state["armed"]
        return dec.stats.snapshot()
    finally:
        dec.close()


@pytest.mark.parametrize("after", [1, 6])
def test_chaos_storm_is_exact_and_counts_as_jax(served, after):
    """The storm of ``benchmarks.recovery`` (a prefix-shared pair, sampled
    rows, int8 weights and KV pages, self-drafting, a 50 ms pool audit),
    its fault at a step's entry once a row has emitted 1 token (the first
    step) or 6 (spec steps and their rejected drafts behind it): every
    stream equals the fault-free run, the pool checks clean and holds
    nothing after a trie flush, the audit never failed; at the first step
    the snapshot counters are the JAX engine's on the same storm."""
    jm, variables, _ = served
    specs = recovery.storm_workload(11, VOCAB)
    kw = recovery.decoder_kwargs(4, 3, 4, 2, 1)
    # a twin of its own: the storm's int8 decoders quantize it in place
    row = recovery.run_chaos(torch_twin(jm, variables), specs, device="cpu",
                             fault_after=after, **kw)
    assert row["pass"] and row["sampled_streams"] == 2
    if after == 1:
        jt = jax_storm(served, specs, kw)
        for key in ("snapshot_saved", "snapshot_restored",
                    "snapshot_replayed", "snapshot_failed"):
            assert row[key] == jt[key], key


def test_fault_replay_carries_the_lookahead_pages(served):
    """A verify writes k positions past a row's cursor before the host
    knows they are rejected, and in an int8 arena those writes raise the
    scale of the page past the cursor, which the uninterrupted run keeps.
    A fault replay carries that page too, and the restore writes it back
    (a drained frame holds the written history only, as JAX's does)."""
    jm, variables, _ = served
    dec = PagedBatchingDecoder(torch_twin(jm, variables), device="cpu",
                               **recovery.decoder_kwargs(4, 3, 4, 3, 1))
    snaps, restored = [], []
    snapshot_row, restore = dec._snapshot_row, dec._restore

    def spy_snapshot(row, ahead=0):
        snaps.append(snapshot_row(row, ahead))
        return snaps[-1]

    def spy_restore(row):
        snap = row.snapshot
        restore(row)
        n = len(snap.layers[0].k)
        restored.append(all(
            torch.equal(a["k_scale"][row.lease.pages[:n]],
                        torch.from_numpy(layer.k_scale))
            for a, layer in zip(dec.cache.layers, snap.layers)))

    dec._snapshot_row, dec._restore = spy_snapshot, spy_restore
    try:
        _, state = recovery.serve_storm(
            dec, recovery.storm_workload(0, VOCAB), fault_after=5)
    finally:
        dec.close()
    assert not state["armed"] and restored and all(restored)
    past = [layer.k_scale[s.npages:] for s in snaps for layer in s.layers]
    assert any(p.size and p.max() > 0 for p in past)


# --- admission controls ---


def idle(served, engine, **kw):
    """A decoder whose engine loop never starts: queue semantics alone."""
    dec = (jax_dec if engine == "jax" else port_dec)(served, slots=1, **kw)
    dec._thread = threading.Thread(target=lambda: None)
    return dec, (JaxRequest if engine == "jax" else GenerateRequest)


def req(cls, **kw):
    return cls(prompts=[[1, 2, 3]], max_new_tokens=4, **kw)


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_shed_oldest_and_reject_match_jax(served, engine):
    """At the queue limit ``reject`` refuses the new request (429 with a
    load-derived Retry-After); ``oldest`` sheds the longest-queued request
    instead and admits the new one."""
    dec, cls = idle(served, engine, queue_limit=2, shed_policy="reject")
    dec.submit(req(cls))
    dec.submit(req(cls))
    with pytest.raises(Exception) as err:
        dec.submit(req(cls))
    assert err.value.status_code == 429 and err.value.retry_after >= 1.0
    t = dec.telemetry()
    assert (t["requests_overload"], t["requests_submitted"],
            t["queue_limit"]) == (1.0, 2.0, 2.0)
    dec, cls = idle(served, engine, queue_limit=2, shed_policy="oldest")
    e1, e2, e3 = (dec.submit(req(cls)) for _ in range(3))
    assert e1.done_evt.is_set() and e1.error.status_code == 429
    assert not e2.done_evt.is_set() and not e3.done_evt.is_set()
    with pytest.raises(Exception) as err:
        dec.wait(e1, timeout=1)
    assert err.value.status_code == 429
    t = dec.telemetry()
    assert (t["requests_shed"], t["requests_submitted"],
            t["queue_depth"]) == (1.0, 3.0, 2.0)


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_queued_rows_expire_on_deadline(served, engine):
    dec, cls = idle(served, engine, queue_limit=0)
    dec._warmed = True  # no cold-start allowance
    bind = (jax_resilience if engine == "jax" else resilience).bind_deadline
    with bind(time.time() - 1):
        expired = dec.submit(req(cls))
    with bind(time.time() + 60):
        alive = dec.submit(req(cls))
    dec._sweep_expired()
    assert expired.done_evt.is_set() and expired.error.status_code == 504
    assert not alive.done_evt.is_set()
    t = dec.telemetry()
    assert (t["requests_deadline_expired"], t["queue_depth"]) == (1.0, 1.0)


def test_retire_finishes_inflight_and_refuses_new(served):
    ref = run(port_dec(served), GenerateRequest, n=8)
    dec = port_dec(served)
    entry = dec.submit(GenerateRequest(prompts=P.tolist(), max_new_tokens=8))
    dec.retire()
    with pytest.raises(KubeMLError) as err:
        dec.submit(GenerateRequest(prompts=P.tolist(), max_new_tokens=2))
    assert err.value.status_code == 503
    assert dec.wait(entry, timeout=300)["tokens"][0] == ref
    dec._thread.join(60)
    assert not dec._thread.is_alive() and dec.cache is None
    dec.close()
