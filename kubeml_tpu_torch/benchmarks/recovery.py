"""Serving recovery through an engine fault: the in-process checks of
``kubeml_tpu/benchmarks/scenarios.py::run_serving_recovery`` (its chaos
half; the cross-process drain hop over the PS waits for the port's PS).

A storm of mixed-length streams, greedy and sampled, with a prefix-shared
pair, goes through ``PagedBatchingDecoder`` twice: once fault-free, once
with one fault injected at the entry of a decode chunk or spec step as
soon as a token has landed. The engine snapshots its resident rows into
KMS1 frames, zeroes the arena, rebuilds the page pool and replays them.
Gates (the exit status): every stream's tokens equal the fault-free run's;
the pool checks clean and holds no page once the prefix trie is flushed;
the snapshot counters saw a save, a restore and a replay, and no failure;
the pool audit ran and never failed.

    python -m kubeml_tpu_torch.benchmarks.recovery          # the card
    python -m kubeml_tpu_torch.benchmarks.recovery --device cpu

``--model gpt2-small`` (the default on the card) runs GPT-2-small's width,
``--model tiny`` (the default on the CPU) the JAX scenario's model; both
with int8 weights through the int8 matmul, int8 KV pages and
``spec="self"``, weights random from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np

from .spec_decode import MODELS, coherent_tail


def arm_fault(dec, after: int = 1) -> Dict[str, float]:
    """Make the entry of ``dec``'s next decode chunk or spec step raise,
    once, as soon as a resident row has emitted ``after`` tokens. Returns
    the state: ``armed`` until it fired, then the monotonic time it fired
    at (``at``) and of the first emission after it (``first_emit``)."""
    state = {"armed": True, "at": 0.0, "first_emit": 0.0}

    def poison(fn):
        def step(*a, **kw):
            if state["armed"] and any(r is not None and len(r.out) >= after
                                      for r in dec._slot_rows):
                state["armed"] = False
                state["at"] = time.monotonic()
                raise RuntimeError("injected device fault")
            return fn(*a, **kw)
        return step

    emit = dec._emit_delta

    def emit_delta(r, tokens):
        if state["at"] and not state["first_emit"]:
            state["first_emit"] = time.monotonic()
        return emit(r, tokens)

    dec._decode_chunk = poison(dec._decode_chunk)
    dec._spec_step = poison(dec._spec_step)
    dec._emit_delta = emit_delta
    return state


def storm_workload(seed: int, vocab: int, streams: int = 8,
                   scale: int = 1) -> List[dict]:
    """The JAX scenario's storm: a prefix-shared pair (a 12-token system
    prompt), mixed lengths, every third stream sampled (temperature 0.8,
    top-k 20). ``scale`` multiplies prompt and output lengths."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, size=12 * scale)
    prompts = [np.concatenate([sysp, rng.integers(1, vocab,
                                                  size=(3 + i) * scale)])
               for i in range(2)]
    prompts += [rng.integers(1, vocab, size=n * scale)
                for n in (3, 9, 5, 12, 7, 16, 4, 10, 6, 14)[:streams - 2]]
    news = ([14, 9, 6, 17, 8, 11, 12, 16] * 2)[:streams]
    return [{"prompt": p.astype(np.int32), "max_new": n * scale,
             "temp": 0.8 if i % 3 == 2 else 0.0, "top_k": 20,
             "seed": 700 + i}
            for i, (p, n) in enumerate(zip(prompts, news))]


def serve_storm(dec, specs: List[dict], fault_after: int = 0
                ) -> Tuple[List[List[int]], Dict[str, float]]:
    """Submit every stream at once (under the engine's lock, so admission
    does not depend on submit timing), with the fault armed to fire once a
    row has ``fault_after`` tokens (0: no fault); returns each stream's
    tokens and the fault's state."""
    from ..api.types import GenerateRequest

    state = arm_fault(dec, fault_after) if fault_after else {}
    with dec._cond:
        entries = [dec.submit(GenerateRequest(
            prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"],
            temperature=s["temp"], top_k=s["top_k"] if s["temp"] else None,
            seed=s["seed"] if s["temp"] else None)) for s in specs]
    outs = [dec.wait(e, timeout=900) for e in entries]
    return [o["tokens"][0][:o["lengths"][0]] for o in outs], state


def decoder_kwargs(page_tokens: int, slots: int, chunk_steps: int,
                   spec_k: int, exit_layer: int) -> dict:
    """The chaos configuration: int8 weights through the int8 matmul,
    int8 KV pages, self-drafting, the prefix cache and a 50 ms pool
    audit."""
    return dict(slots=slots, chunk_steps=chunk_steps, page_tokens=page_tokens,
                quantize="int8", int8_matmul=True, kv_quant="int8",
                spec="self", spec_k=spec_k, spec_exit_layer=exit_layer,
                spec_adaptive=False, pool_audit_interval=0.05)


def run_chaos(module, specs: List[dict], device=None, fault_after: int = 1,
              **kw) -> dict:
    """The storm fault-free, then with the fault (once a row has
    ``fault_after`` tokens), on ``module`` (its weights quantized in place
    by the first decoder); the checks of the module docstring. Returns the
    row; raises AssertionError on a failed gate."""
    from ..serving import PagedBatchingDecoder

    ref_dec = PagedBatchingDecoder(module, device=device, **kw)
    try:
        ref, _ = serve_storm(ref_dec, specs)
    finally:
        ref_dec.close()
    dec = PagedBatchingDecoder(module, device=device, **kw)
    try:
        got, state = serve_storm(dec, specs, fault_after)
        tele = dec.telemetry()
        chk = dec._pool.check()
        if dec._pool.trie is not None:
            dec._pool.trie.flush()
        flushed = dec._pool.check()
    finally:
        dec.close()
    row = {"metric": "serving-recovery", "streams": len(specs),
           "sampled_streams": sum(1 for s in specs if s["temp"] > 0),
           "tokens": sum(map(len, got)),
           "mismatched_streams": [i for i, (a, b) in enumerate(zip(got, ref))
                                  if a != b],
           "fault_fired": not state["armed"],
           "fault_to_first_emit_ms": (
               1e3 * (state["first_emit"] - state["at"])
               if state["first_emit"] else None),
           "pool_check": chk, "held_after_flush": flushed["held"]}
    for key in ("snapshot_saved", "snapshot_restored", "snapshot_replayed",
                "snapshot_failed", "pool_audit_runs", "pool_audit_failures",
                "requests_failed", "spec_steps"):
        row[key] = tele.get(key, 0.0)
    failed = [name for name, ok in (
        ("the injected fault fired", row["fault_fired"]),
        ("every stream equals the fault-free run",
         not row["mismatched_streams"]),
        ("no page held past the trie", chk["held"] == chk["trie_pages"]),
        ("no page held after the trie flush", flushed["held"] == 0),
        ("a snapshot was saved, restored and replayed",
         min(row["snapshot_saved"], row["snapshot_restored"],
             row["snapshot_replayed"]) > 0),
        ("no snapshot failed", row["snapshot_failed"] == 0),
        ("the pool audit ran", row["pool_audit_runs"] >= 1),
        ("the pool audit never failed", row["pool_audit_failures"] == 0),
        ("no request failed", row["requests_failed"] == 0))
        if not ok]
    row["pass"] = not failed
    if failed:
        raise AssertionError(f"serving recovery failed: {failed}; {row}")
    return row


def main(argv=None) -> int:
    from ..models.gpt import CausalTransformer

    p = argparse.ArgumentParser(
        description="serving recovery through an injected engine fault")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--model", choices=sorted(MODELS), default=None,
                   help="default: gpt2-small on a card, tiny on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--chunk-steps", type=int, default=4)
    p.add_argument("--page-tokens", type=int, default=None,
                   help="default: 16 for gpt2-small, 4 for tiny")
    p.add_argument("--spec-k", type=int, default=2)
    args = p.parse_args(argv)
    model = args.model or ("tiny" if args.device == "cpu" else "gpt2-small")
    tkw, _, exit_layer = MODELS[model]
    big = model != "tiny"
    module = coherent_tail(CausalTransformer(**tkw, seed=args.seed,
                                             device=args.device), exit_layer)
    specs = storm_workload(args.seed, tkw["vocab_size"], args.streams,
                           scale=8 if big else 1)
    row = run_chaos(module, specs, device=args.device, **decoder_kwargs(
        args.page_tokens or (16 if big else 4), args.slots,
        args.chunk_steps, args.spec_k, exit_layer))
    row.update(model=model, device=str(module.device))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
