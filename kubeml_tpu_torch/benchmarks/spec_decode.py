"""Speculative-decoding rows of the paged serving engine; port of the rows
part of ``kubeml_tpu/benchmarks/spec_decode.py`` (``coherent_tail``,
``run_rows``).

One mixed-length workload (prompts of 4-23 tokens) goes through
``PagedBatchingDecoder`` with speculation off, with a separate random
draft model, and with early-exit self-drafting, at batch 1 (requests one
at a time) and batch 8 (all at once), greedy and sampled; then an int8
row (int8 weights through the int8 matmul, self-drafting). Each row
records served tokens/s, ``spec_tokens_per_step`` (tokens emitted a
device step: above 1 means each weight read served several tokens) and
``spec_accept_ratio``.

Acceptance on random weights means little (a random model's late layers
dominate its logits), so the self-drafting rows run against a
``coherent_tail`` target: the blocks past the exit layer have their
residual-branch output projections scaled toward zero, so the truncated
stack agrees with the full one - the regime trained models approach as
late layers saturate. The draft rows keep an honest random drafter (low
acceptance: the adaptive controller's retreat is part of the run).

Gate (the exit status): greedy tokens in every mode equal the spec-off
engine's on the same weights, and self-drafting at batch 1 emits more
than one token a device step.

    python -m kubeml_tpu_torch.benchmarks.spec_decode           # the card
    python -m kubeml_tpu_torch.benchmarks.spec_decode --device cpu

``--model gpt2-small`` (the default on the card) is GPT-2-small's width
(E 768, 12 layers, vocab 50257; drafter E 256, depth 2; exit layer 6),
``--model tiny`` (the default on the CPU) the JAX benchmark's model
(vocab 101, E 64, depth 4; drafter E 32, depth 2; exit layer 2). Weights
are random from ``--seed``. The PS ``/metrics`` scrape of the JAX
benchmark waits for the port's PS route.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

# (target kwargs, drafter kwargs, exit layer) per --model
MODELS = {
    "tiny": (dict(vocab_size=101, max_len=96, embed_dim=64, depth=4,
                  num_heads=4),
             dict(vocab_size=101, max_len=96, embed_dim=32, depth=2,
                  num_heads=4), 2),
    "gpt2-small": (dict(vocab_size=50257, max_len=1024, embed_dim=768,
                        depth=12, num_heads=12, attn_bias=True, ln_eps=1e-5),
                   dict(vocab_size=50257, max_len=1024, embed_dim=256,
                        depth=2, num_heads=4, attn_bias=True, ln_eps=1e-5),
                   6),
}


def coherent_tail(module, exit_layer: int, eps: float = 0.02):
    """Scale the residual-branch OUTPUT projections (``attn.proj`` and
    ``mlp_out``, kernel and bias) of every block from ``exit_layer`` on by
    ``eps``, in place: those blocks become near-identity, so the early-exit
    stack agrees with the full forward. Returns the module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            parts = name.split(".")
            if (parts[0].startswith("block_")
                    and int(parts[0].split("_")[1]) >= exit_layer
                    and ("proj" in parts or "mlp_out" in parts)):
                p.mul_(eps)
    return module


def _workload(seed: int, n: int, max_new: int, sampled: bool,
              vocab: int) -> List[dict]:
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, vocab, size=int(rng.integers(4, 24))
                                    ).astype(np.int32),
             "max_new": max_new, "temp": 0.8 if sampled else 0.0,
             "seed": 500 + i} for i in range(n)]


def _drive(decoder, specs: List[dict], serial: bool) -> dict:
    """Serve ``specs`` (``serial``: one request at a time, else all at
    once); the wall, the outputs and the engine's telemetry."""
    from ..api.types import GenerateRequest

    def req(s):
        return GenerateRequest(
            prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"],
            temperature=s["temp"], seed=s["seed"] if s["temp"] > 0 else None)

    t0 = time.perf_counter()
    if serial:
        outs = [decoder.wait(decoder.submit(req(s)), timeout=600)
                for s in specs]
    else:
        entries = [decoder.submit(req(s)) for s in specs]
        outs = [decoder.wait(e, timeout=600) for e in entries]
    wall = time.perf_counter() - t0
    chk = decoder._pool.check()  # raises on any allocator invariant break
    if chk["held"] != chk["trie_pages"]:
        raise AssertionError("pages leaked past the trie")
    return {"outs": outs, "wall": wall, "telemetry": decoder.telemetry()}


def _tokens(res: dict) -> List[List[int]]:
    return [o["tokens"][0][:o["lengths"][0]] for o in res["outs"]]


def run_rows(seed: int, requests_n: int, max_new: int, slots: int,
             chunk_steps: int, page_tokens: int, spec_k: int,
             model: str = "tiny", device=None) -> Tuple[List[dict], bool]:
    """The rows (modes off / draft / self x batch 1 / 8 x greedy /
    sampled, then the int8 self row) and whether every greedy row matched
    the spec-off engine's tokens."""
    from ..models.gpt import CausalTransformer
    from ..serving.batcher import PagedBatchingDecoder
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    tkw, dkw, exit_layer = MODELS[model]
    target = CausalTransformer(**tkw, seed=seed, device=dev)
    coherent = coherent_tail(copy.deepcopy(target), exit_layer)
    drafter = CausalTransformer(**dkw, seed=seed + 1, device=dev)
    vocab = tkw["vocab_size"]
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    modes = [("off", target, {}),
             ("draft", target, dict(spec="draft", draft_module=drafter)),
             ("self", coherent, dict(spec="self",
                                     spec_exit_layer=exit_layer))]
    refs: Dict[Tuple[int, int], List[List[int]]] = {}

    def engine(module, **kw):
        return PagedBatchingDecoder(module, slots=slots,
                                    chunk_steps=chunk_steps,
                                    page_tokens=page_tokens, spec_k=spec_k,
                                    device=dev, **kw)

    rows, ok = [], True
    for batch in (1, 8):
        for sampled in (False, True):
            specs = _workload(seed, requests_n, max_new, sampled, vocab)
            for mode, module, kw in modes:
                dec = engine(module, spec_adaptive=mode == "draft", **kw)
                try:
                    res = _drive(dec, specs, serial=batch == 1)
                finally:
                    dec.close()
                parity = None
                if not sampled:
                    key = (id(module), batch)
                    if mode == "off":
                        refs[key] = _tokens(res)
                    elif key not in refs:
                        ref = engine(module)
                        try:
                            refs[key] = _tokens(_drive(ref, specs, False))
                        finally:
                            ref.close()
                    parity = _tokens(res) == refs[key]
                    ok = ok and parity
                rows.append(_row(res, mode, batch, sampled, spec_k, specs,
                                 max_new, model, name, parity))
    # int8: int8 weights through the int8 matmul, self-drafting, against
    # the spec-off int8 engine on the same quantized weights
    specs = _workload(seed, min(requests_n, 4), max_new, False, vocab)
    int8 = copy.deepcopy(coherent)
    base = engine(int8, quantize="int8", int8_matmul=True)
    try:
        want = _tokens(_drive(base, specs, False))
    finally:
        base.close()
    dec = engine(int8, quantize="int8", int8_matmul=True, spec="self",
                 spec_exit_layer=exit_layer, spec_adaptive=False)
    try:
        res = _drive(dec, specs, serial=True)
    finally:
        dec.close()
    parity = _tokens(res) == want
    ok = ok and parity
    rows.append(_row(res, "self-int8", 1, False, spec_k, specs, max_new,
                     model, name, parity))
    return rows, ok


def _row(res, mode, batch, sampled, spec_k, specs, max_new, model, device,
         parity) -> dict:
    t = res["telemetry"]
    return {
        "metric": "spec-decode-serving", "mode": mode, "batch": batch,
        "sampling": "sampled" if sampled else "greedy",
        "spec_k": spec_k if mode != "off" else 0, "model": model,
        "requests": len(specs), "max_new": max_new,
        "value": t["tokens_emitted"] / res["wall"], "unit": "tokens/sec",
        "spec_tokens_per_step": (t["tokens_emitted"] / t["device_steps"]
                                 if t["device_steps"] else None),
        "spec_accept_ratio": t.get("spec_accept_rate"),
        "adaptive_k": t.get("spec_k"),
        "spec_disabled": t.get("spec_disabled"),
        "greedy_parity": parity, "device": device,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="speculative-decoding rows of the paged serving engine")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--model", choices=sorted(MODELS), default=None,
                   help="default: gpt2-small on a card, tiny on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk-steps", type=int, default=8)
    p.add_argument("--page-tokens", type=int, default=16)
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--out", default=None, help="append the JSON rows here")
    args = p.parse_args(argv)
    model = args.model or ("tiny" if args.device == "cpu" else "gpt2-small")

    rows, parity_ok = run_rows(args.seed, args.requests, args.max_new,
                               args.slots, args.chunk_steps,
                               args.page_tokens, args.spec_k, model,
                               args.device)
    self_b1 = next(r for r in rows if r["mode"] == "self"
                   and r["batch"] == 1 and r["sampling"] == "greedy")
    gate = {"metric": "spec-decode-gate", "greedy_parity": parity_ok,
            "self_batch1_tokens_per_step": self_b1["spec_tokens_per_step"],
            "tokens_per_step_gt_1": self_b1["spec_tokens_per_step"] > 1.0}
    gate["pass"] = bool(parity_ok and gate["tokens_per_step_gt_1"])
    rows.append(gate)
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0 if gate["pass"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
