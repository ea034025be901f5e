"""Transformer training benchmark: samples/s of the encoder targets on one
card, the port of ``kubeml_tpu/benchmarks/transformers.py``'s
``bench_vit`` and ``bench_bert``.

Both train through ``KAvgTrainer`` (the engine the platform trains them
with) at the JAX configurations, N 1 worker, bf16, SGD with momentum 0.9
at lr 1e-3, one seeded batch repeated over the K steps of a round:

* ViT-Tiny on CIFAR-100 shapes (32x32x3, 100 classes, L 65): B 256, K 8;
* BERT-base on SST-2 shapes (L 128, 2 classes): B 32, K 4, dropout 0.1.
  The rows end in seeded trailing padding (0-120 PAD tokens; row 1 keeps
  only ``[CLS]``), as short SST-2 sentences padded to 128 do, so the
  attention's ``kv_valid`` is exercised; the JAX benchmark's rows are
  unpadded.

Attention runs through the flash kernels on the card
(``ops.attention.FLASH_MIN_KV_LEN``).

    python -m kubeml_tpu_torch.benchmarks.transformers            # both
    python -m kubeml_tpu_torch.benchmarks.transformers --model bert-base

prints one JSON row per model: ``value`` samples/s (best of 3 runs of
``--steps`` rounds), ``round_ms``, peak memory, ``train_flops_per_sample``
(``harness.train_flops_per_sample``) and the share of the card's bf16
peak it reaches, and the flash launches of one round. ``--model gpt-moe``
(the JAX ``bench_moe``) needs MoE and the mesh, ROADMAP Queue 1 item 6,
and exits non-zero. Runs on the current CUDA card and raises without one
unless given ``--device cpu`` (tiny sizes only).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.layers import fold_in
from .harness import SEED, _sync, make_synthetic_model, train_flops_per_sample

LR = 1e-3
# published H100 SXM dense bf16 peak (NVIDIA data sheet), 700 W
PEAK_BF16_FLOPS = 989e12


def flash_counts() -> dict:
    from ..ops.flash_attention import flash_attention as f

    return {"fwd": f.fwd_launches, "dq": f.dq_launches,
            "dkv": f.dkv_launches}


class EncoderBench:
    """One K-AVG worker training ``module`` on one seeded batch (``sample``,
    ``labels``) repeated over ``k`` steps a round: weights from ``SEED``,
    round r's dropout seed ``fold_in(SEED, r)``."""

    def __init__(self, name: str, module: nn.Module, sample: np.ndarray,
                 labels: np.ndarray, k: int, device=None):
        from ..engine.kavg import KAvgTrainer

        self.name = name
        self.model = make_synthetic_model(module, f"bench-{name}")
        self.trainer = KAvgTrainer(self.model, precision="bf16",
                                   device=device)
        self.device = self.trainer.device
        self.batch, self.k = sample.shape[0], k
        x = np.broadcast_to(sample, (1, k, *sample.shape)).copy()
        y = np.broadcast_to(labels, (1, k, *labels.shape)).copy()
        mask = np.ones((1, k, self.batch), np.float32)
        self.variables = self.trainer.init_variables(SEED, sample, 1)
        self.staged = self.trainer.stage_round(x, y, mask, 1)
        self.flops = train_flops_per_sample(
            self.trainer.module, sample.shape[1:],
            torch.long if sample.dtype.kind in "iu" else torch.float32)
        self.rounds_run = 0

    def round(self) -> torch.Tensor:
        """One sync round; returns the loss, still on the device."""
        self.variables, loss = self.trainer.sync_round(
            self.variables, *self.staged, lr=LR,
            rng=fold_in(SEED, self.rounds_run))
        self.rounds_run += 1
        return loss

    def measure(self, rounds: int, reps: int = 3) -> dict:
        """One warm-up round (its flash launches counted), then ``reps``
        runs of ``rounds`` rounds; samples/s of the best run."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        before = flash_counts()
        first_loss = float(self.round())
        launches = {n: c - before[n] for n, c in flash_counts().items()}
        dts = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(rounds):
                loss = self.round()
            float(loss)
            dts.append(time.perf_counter() - t0)
        best = min(dts)
        samples = rounds * self.k * self.batch
        row = {
            "metric": f"{self.name}-train-throughput",
            "value": samples / best,
            "unit": "samples/sec",
            "round_ms": 1e3 * best / rounds,
            "batch": self.batch, "k": self.k, "rounds": rounds, "reps": reps,
            "train_flops_per_sample": self.flops,
            "flash_launches_per_round": launches,
            "first_loss": first_loss,
            "loss": float(loss),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
        }
        if dev.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            # what was allocated when the measurement began (the weights,
            # and whatever else the process holds)
            row["memory_allocated_at_start"] = held
            row["bf16_peak_fraction"] = (self.flops * row["value"]
                                         / PEAK_BF16_FLOPS)
        if not math.isfinite(row["loss"]):
            raise RuntimeError(f"{self.name}: the loss is {row['loss']}")
        return row


def vit_bench(batch: int = 256, device=None,
              module: Optional[nn.Module] = None) -> EncoderBench:
    """ViT-Tiny (bf16) on seeded CIFAR-100-shaped inputs, K 8."""
    from ..models.vit import ViTTiny

    r = np.random.default_rng(0)
    sample = r.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    labels = r.integers(0, 100, size=(batch,)).astype(np.int64)
    module = module or ViTTiny(num_classes=100, dtype=torch.bfloat16)
    return EncoderBench("vit-tiny-cifar100", module, sample, labels, k=8,
                        device=device)


def bert_tokens(batch: int, seq: int, vocab: int = 30000):
    """Seeded SST-2-shaped token ids and labels: ids in [1, vocab), each
    row ending in 0-120 PAD tokens (row 0 none, row 1 all but ``[CLS]``)."""
    r = np.random.default_rng(0)
    ids = r.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    labels = r.integers(0, 2, size=(batch,)).astype(np.int64)
    pads = r.integers(0, min(121, seq), size=batch)
    pads[0] = 0
    if batch > 1:
        pads[1] = seq - 1
    for i, p in enumerate(pads):
        ids[i, seq - p:] = 0
    return ids, labels


def bert_bench(batch: int = 32, seq: int = 128, device=None,
               module: Optional[nn.Module] = None) -> EncoderBench:
    """BERT-base (bf16, dropout 0.1) on seeded SST-2-shaped ids, K 4."""
    from ..models.bert import BertBase

    sample, labels = bert_tokens(batch, seq)
    module = module or BertBase(num_classes=2, dtype=torch.bfloat16)
    return EncoderBench("bert-base-sst2", module, sample, labels, k=4,
                        device=device)


def bench_vit(steps: int = 10, batch: int = 256, device=None) -> dict:
    return vit_bench(batch, device).measure(steps)


def bench_bert(steps: int = 5, batch: int = 32, seq: int = 128,
               device=None) -> dict:
    return bert_bench(batch, seq, device).measure(steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="encoder training throughput "
                                "(ViT-Tiny, BERT-base; PyTorch + CUDA)")
    p.add_argument("--model", choices=["vit-tiny", "bert-base", "gpt-moe",
                                       "all"], default="all")
    p.add_argument("--steps", type=int, default=None,
                   help="rounds a timed run")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    args = p.parse_args(argv)
    if args.model == "gpt-moe":
        print("gpt-moe trains MoE blocks over a mesh, which the port does "
              "not have yet (ROADMAP Queue 1 item 6)", file=sys.stderr)
        return 2
    if args.model in ("vit-tiny", "all"):
        print(json.dumps(bench_vit(args.steps or 10, args.batch or 256,
                                   args.device)), flush=True)
    if args.model in ("bert-base", "all"):
        print(json.dumps(bench_bert(args.steps or 5, args.batch or 32,
                                    device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
