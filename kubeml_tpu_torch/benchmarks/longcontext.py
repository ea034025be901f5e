"""Long-context LM training benchmark: tokens/s against sequence length.

Port of ``kubeml_tpu/benchmarks/longcontext.py`` with the same config and
defaults: the causal transformer (E 512, depth 8, 8 heads, vocab 32000)
with rematerialised blocks under ``SPMDTrainer`` (AdamW 3e-4), bf16
compute, a fixed budget of 16,384 tokens per step so throughput compares
across lengths. Attention takes the flash kernels on the card
(``ops.attention.FLASH_MIN_KV_LEN``).

    python -m kubeml_tpu_torch.benchmarks.longcontext             # 1k..16k
    python -m kubeml_tpu_torch.benchmarks.longcontext --seq-lens 4096 --steps 10

Prints one JSON line per sequence length: tokens/s plus the config and
the card's name. Runs on one CUDA card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch


def make_trainer(seq_len: int, tokens_per_step: int = 16384,
                 dtype: str = "bf16", depth: int = 8, embed_dim: int = 512,
                 num_heads: int = 8, vocab: int = 32000,
                 logits_chunk: Optional[int] = None,
                 device=None) -> Tuple[object, np.ndarray]:
    """The benchmark's trainer (initialised, weights from seed 0) and its
    one batch of ``tokens_per_step // seq_len`` random sequences (seed 0)."""
    from ..models.gpt import CausalTransformer
    from ..parallel.trainer import SPMDTrainer

    batch = max(1, tokens_per_step // seq_len)
    module = CausalTransformer(
        vocab_size=vocab, max_len=seq_len, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, remat=True,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
        seed=0, device=device)
    if logits_chunk is None and seq_len > 32768:
        # past 32k the [B, L, vocab] logits dominate memory; stream the
        # lm_head + loss instead (parallel.trainer.chunked_lm_loss)
        logits_chunk = 8192
    trainer = SPMDTrainer(module, precision="bf16", logits_chunk=logits_chunk)
    r = np.random.default_rng(0)
    tokens = r.integers(1, vocab, size=(batch, seq_len)).astype(np.int32)
    trainer.init(tokens)
    return trainer, tokens


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_point(seq_len: int, tokens_per_step: int = 16384, steps: int = 5,
              dtype: str = "bf16", depth: int = 8, embed_dim: int = 512,
              num_heads: int = 8, vocab: int = 32000,
              logits_chunk: Optional[int] = None, repeats: int = 3,
              device=None) -> dict:
    """One warm-up step, then ``repeats`` timed runs of ``steps`` steps on
    the same batch; the row reports the best run's tokens/s. ``loss`` is
    the last step's loss, ``first_loss`` the warm-up step's (step 1)."""
    trainer, tokens = make_trainer(seq_len, tokens_per_step, dtype, depth,
                                   embed_dim, num_heads, vocab, logits_chunk,
                                   device)
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = float(trainer.train_step(tokens))
    best_dt = math.inf
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = trainer.train_step(tokens)
        _sync(dev)
        best_dt = min(best_dt, time.perf_counter() - t0)
    global_batch = tokens.shape[0]
    row = {
        "metric": "gpt-longcontext-train-throughput",
        "seq_len": seq_len,
        "global_batch": global_batch,
        "depth": depth,
        "embed_dim": embed_dim,
        "dtype": dtype,
        "value": steps * global_batch * seq_len / best_dt,
        "unit": "tokens/sec",
        "step_ms": 1e3 * best_dt / steps,
        "loss": float(loss),
        "first_loss": first,
        "steps_run": 1 + repeats * steps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    if dev.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if trainer.logits_chunk is not None:  # provenance: the loss path differs
        row["logits_chunk"] = trainer.logits_chunk
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="long-context LM training "
                                "benchmark (PyTorch + CUDA)")
    p.add_argument("--seq-lens", type=int, nargs="*",
                   default=[1024, 2048, 4096, 8192, 16384])
    p.add_argument("--tokens-per-step", type=int, default=16384,
                   help="fixed token budget per step (batch = budget // "
                   "seq_len)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="model computation dtype (bf16 = mixed precision)")
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    args = p.parse_args(argv)

    for L in args.seq_lens:
        res = run_point(L, args.tokens_per_step, args.steps, args.dtype,
                        depth=args.depth, embed_dim=args.embed_dim,
                        device=args.device)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
