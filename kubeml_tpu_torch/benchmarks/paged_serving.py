"""Paged against slot serving, the port of
``kubeml_tpu/benchmarks/paged_serving.py``.

One mixed-length, chat-shaped workload (short and long prompts and
generations, a shared system prompt on a third of the requests, a quarter
of the requests sampled at a fixed seed, a few requests abandoned
mid-decode) is driven the same way through:

* ``slot`` - the dense :class:`~kubeml_tpu_torch.serving.BatchingDecoder`
  (per-row ``[max_len]`` cache stripes, chunks of ``chunk_steps`` or the
  tail length, sized to the longest row);
* ``paged`` - :class:`~kubeml_tpu_torch.serving.PagedBatchingDecoder` at
  the same slot count, its pages sized to the slot engine's worst case,
  so the contrast isolates the engine (chunks that end at the earliest
  completion, page-budget admission, prefix reuse);
* ``paged-2x`` - the paged engine with twice the slots on the same page
  budget: rows hold pages in proportion to their length, so twice the
  rows fit in the memory the slot engine spends on stripes.

What the rows show: (a) the paged engine's higher occupancy and fewer
dead slot-steps on the same traffic, and no more wasted tokens at twice
the rows; (b) prefix-cache hits on the shared system prompt; (c) token
parity: every surviving request's tokens, greedy and seeded-sampled,
are the same slot against paged (both engines draw a row's samples from
one generator seeded by ``batcher._seed_for``).

    python -m kubeml_tpu_torch.benchmarks.paged_serving --device cpu

prints one JSON row per engine, the parity row and the gate row, and
exits non-zero when the gate fails. :func:`run_demo` takes any causal LM
module and workload (``chip_smoke.py`` drives GPT-2-small through it);
the default is the JAX benchmark's tiny model (vocab 101, L 96, E 64,
depth 2, 4 heads, f32) on the current CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np

VOCAB = 101
SYS_PROMPT_LEN = 16
# an abandoned request's waiter gives up once it holds this many of its 40
# tokens: halfway through its decode
ABANDON_AFTER = 20


def _model(device=None):
    from ..models.gpt import CausalTransformer

    return CausalTransformer(vocab_size=VOCAB, max_len=96, embed_dim=64,
                             depth=2, num_heads=4, device=device)


def _workload(seed: int, n: int, vocab: int = VOCAB) -> List[dict]:
    """Mixed-length request specs: about a third share a 16-token system
    prompt, a quarter sample (temperature 0.7, seed 1000 + i), and five
    long greedy requests are abandoned mid-decode."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, size=SYS_PROMPT_LEN).astype(np.int32)
    specs = []
    for i in range(n):
        plen = int(rng.integers(4, 28))
        max_new = int(rng.integers(4, 40))
        if i % 3 == 0:
            tail = rng.integers(1, vocab, size=max(plen - SYS_PROMPT_LEN, 2))
            prompt = np.concatenate([sysp, tail.astype(np.int32)])
        else:
            prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        specs.append({
            "prompt": prompt,
            "max_new": max_new,
            "temp": 0.7 if i % 4 == 3 else 0.0,
            "seed": 1000 + i,
            "abandon": i in (5, 11, 14, 17, 22),
        })
    for s in specs:
        if s["abandon"]:
            s["max_new"] = 40  # giving up then leaves work in flight
            s["temp"] = 0.0
    return specs


def _idle(decoder) -> bool:
    with decoder._cond:
        return not decoder._pending and not decoder._busy()


def drive(decoder, specs: List[dict], stagger: float = 0.004,
          abandon_after: int = ABANDON_AFTER) -> dict:
    """Submit the workload FIFO (``stagger`` seconds apart), wait for every
    result, let the engine settle, and return ``{"row": telemetry row,
    "outs": [result or None]}``. An abandoned request's waiter gives up
    once it holds ``abandon_after`` tokens: the engine cancels the request
    itself at that point (the entry's ``cancel_after``, set under the
    decoder's lock before the engine can admit the row), so no host
    scheduling sits between the token and the cancel, and the tokens it
    computed for the row past that point count as wasted."""
    from ..api.types import GenerateRequest

    entries = []
    t0 = time.perf_counter()
    for s in specs:
        req = GenerateRequest(
            prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"],
            temperature=s["temp"],
            seed=s["seed"] if s["temp"] > 0 else None)
        with decoder._cond:
            entry = decoder.submit(req)
            if s["abandon"]:
                entry.cancel_after = abandon_after
        entries.append(entry)
        time.sleep(stagger)
    outs: List[Optional[dict]] = [
        None if s["abandon"] else decoder.wait(e, timeout=600)
        for s, e in zip(specs, entries)]
    deadline = time.time() + 60
    while time.time() < deadline and not _idle(decoder):
        time.sleep(0.02)
    elapsed = time.perf_counter() - t0
    t = decoder.telemetry()
    row = {"elapsed_s": elapsed,
           **telemetry_row(t, t["tokens_emitted"] / elapsed)}
    return {"row": row, "outs": outs}


def telemetry_row(t: dict, tokens_per_sec: float) -> dict:
    """An engine's row from its ``telemetry()`` and the measured
    tokens/s."""
    step = t.get("hist", {}).get("decode_step")
    row = {
        "tokens_emitted": t["tokens_emitted"],
        "tokens_per_sec": tokens_per_sec,
        "batch_occupancy_ratio": (t["live_slot_steps"] / t["slot_steps"]
                                  if t["slot_steps"] else 0.0),
        "live_steps": t["live_slot_steps"],
        "dead_steps": t["dead_slot_steps"],
        "idle_steps": t["idle_slot_steps"],
        "slot_steps": t["slot_steps"],
        "goodput_tokens": t["goodput_tokens"],
        "wasted_tokens": t["wasted_tokens"],
        "prefill_tokens": t["prefill_tokens"],
        "prefill_pad_tokens": t["prefill_pad_tokens"],
        "prefix_hits": t.get("prefix_hits", 0.0),
        "prefix_tokens_saved": t.get("prefix_tokens_saved", 0.0),
        "chunks": t["chunks"],
        "ttft_p50_seconds": t.get("first_token_p50_seconds"),
        # the mean over chunks of a chunk's wall over its steps
        "decode_step_ms": (1e3 * step["sum"] / step["count"]
                           if step and step["count"] else None),
    }
    for k in ("pages_total", "pages_free", "page_occupancy"):
        if k in t:
            row[k] = t[k]
    return row


def parity(specs: List[dict], a: List[Optional[dict]],
           b: List[Optional[dict]]) -> dict:
    """Token parity of two runs of ``specs`` over the requests both
    finished."""
    compared = mismatches = 0
    for x, y in zip(a, b):
        if x is None or y is None:
            continue
        compared += 1
        mismatches += x["tokens"] != y["tokens"]
    return {"metric": "paged-serving-parity", "compared_requests": compared,
            "mismatches": mismatches, "match": mismatches == 0,
            "note": "same sampled tokens at fixed seed, slot vs paged "
                    "(greedy and temperature rows)"}


def run_demo(seed: int = 7, n_requests: int = 24, slots: int = 4,
             chunk_steps: int = 16, page_tokens: int = 8, device=None,
             build_module=None, specs: Optional[List[dict]] = None,
             engine_kw: Optional[dict] = None) -> List[dict]:
    """The three engines over one workload. ``build_module`` (default
    :func:`_model` on ``device``) makes each engine a module of its own
    (an engine quantizes its module in place); ``specs`` defaults to
    :func:`_workload`; ``engine_kw`` goes to every engine (e.g.
    ``quantize``)."""
    from ..serving.batcher import BatchingDecoder, PagedBatchingDecoder

    build_module = build_module or (lambda: _model(device))
    module = build_module()
    dev = module.device
    specs = specs if specs is not None else _workload(seed, n_requests)
    table_pages = -(-int(module.max_len) // page_tokens)
    # the slot engine's KV memory in page units: slots full stripes
    slot_budget_pages = slots * table_pages + 1
    kw = dict(chunk_steps=chunk_steps, device=dev, **(engine_kw or {}))

    def warm_prefix(decoder):
        # one system-prompt request ahead of the storm, so the trie is warm
        from ..api.types import GenerateRequest

        decoder.wait(decoder.submit(GenerateRequest(
            prompts=[specs[0]["prompt"].tolist()], max_new_tokens=2)),
            timeout=600)

    results: Dict[str, dict] = {}
    for name, build in (
        ("slot", lambda: BatchingDecoder(module, slots=slots, **kw)),
        ("paged", lambda: PagedBatchingDecoder(
            build_module(), slots=slots, page_tokens=page_tokens,
            pages=slot_budget_pages, **kw)),
        ("paged-2x", lambda: PagedBatchingDecoder(
            build_module(), slots=slots * 2, page_tokens=page_tokens,
            pages=slot_budget_pages, **kw)),
    ):
        dec = build()
        try:
            if name != "slot":
                warm_prefix(dec)
            results[name] = drive(dec, specs)
            if name != "slot":
                results[name]["row"]["pool_check"] = dec._pool.check()
        finally:
            dec.close()
    rows = []
    for name in ("slot", "paged", "paged-2x"):
        rows.append({"metric": "paged-serving-demo", "engine": name,
                     "seed": seed, "requests": len(specs),
                     "slots": slots if name != "paged-2x" else slots * 2,
                     "chunk_steps": chunk_steps,
                     "page_tokens": page_tokens if name != "slot" else None,
                     **results[name]["row"]})
    rows.append(parity(specs, results["slot"]["outs"],
                       results["paged"]["outs"]))
    return rows


def gate(rows: List[dict]) -> bool:
    """(a) same-width paged beats slot on occupancy and dead slot-steps,
    and paged at the slot engine's memory (twice the rows) wastes no more
    tokens; (b) prefix hits; (c) token parity."""
    by_engine = {r.get("engine"): r for r in rows if "engine" in r}
    par = next(r for r in rows if r["metric"] == "paged-serving-parity")
    return bool(par["match"]
                and by_engine["paged"]["batch_occupancy_ratio"]
                > by_engine["slot"]["batch_occupancy_ratio"]
                and by_engine["paged"]["dead_steps"]
                < by_engine["slot"]["dead_steps"]
                and by_engine["paged-2x"]["wasted_tokens"]
                <= by_engine["slot"]["wasted_tokens"]
                and by_engine["paged"]["prefix_hits"] > 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="paged vs slot serving A/B")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--chunk-steps", type=int, default=16)
    p.add_argument("--page-tokens", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--out", default=None,
                   help="append JSONL rows here as well as stdout")
    args = p.parse_args(argv)
    rows = run_demo(seed=args.seed, n_requests=args.requests,
                    slots=args.slots, chunk_steps=args.chunk_steps,
                    page_tokens=args.page_tokens, device=args.device)
    rows.append({"metric": "paged-serving-gate", "pass": gate(rows)})
    text = "\n".join(json.dumps(r) for r in rows)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0 if rows[-1]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
