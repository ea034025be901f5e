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
peak it reaches, and the flash launches of one round.

``--model gpt-moe`` is the JAX ``bench_moe``: the GPT-2-small skeleton
(vocab 32000, E 768, depth 12, 12 heads, L 512) with 8 experts, top-2
routing and an MoE block every other block, bf16, trained by
``SPMDTrainer`` (AdamW 3e-4) over a one-device mesh at B 16, the loss
including the router's aux losses. Its row keeps the JAX keys (``value``
tokens/s, ``flops_per_step``, ``mfu``, ``moe_overflow``, ``loss``); the
FLOPs of a step are counted analytically term by term (:func:`moe_flops`:
attention, dense MLPs, router, expert FFNs at capacity, the one-hot
dispatch and combine products, lm_head; training = 3 x forward, no remat),
since eager PyTorch has no compiled cost analysis, so the JAX row's
``roofline_mfu_ceiling`` is null here. Beside them stand the useful FLOPs
(the top-2 expert FFNs of the assignments the capacity kept) and the
ratio of the dispatch and combine FLOPs to the expert FFNs' at capacity:
at B 16 x L 512 the one-hot products cost more than the experts they feed.

Runs on the current CUDA card and raises without one unless given
``--device cpu`` (tiny sizes only).
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
from ..utils.profiler import H100_PEAK_BF16_FLOPS as PEAK_BF16_FLOPS
from .harness import SEED, _sync, make_synthetic_model, train_flops_per_sample

LR = 1e-3


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


# bench_moe's configuration (JAX benchmarks/transformers.py:107-158)
MOE_WIDTHS = dict(vocab_size=32000, embed_dim=768, depth=12, num_heads=12)
MOE_ROUTING = dict(moe_every=2, num_experts=8, top_k=2, moe_capacity=1.25)


def moe_flops(batch: int, seq: int, vocab_size: int, embed_dim: int,
              depth: int, moe_every: int, num_experts: int, top_k: int,
              moe_capacity: float, overflow: Optional[float] = None,
              **_) -> dict:
    """Analytic FLOPs of one training step of the MoE LM (a multiply-add
    is 2 FLOPs; training = 3 x the forward, no remat). Attention counts
    the causal half of the score and value products (what the flash
    kernels compute). The expert FFNs run at capacity (``E x cap`` rows a
    MoE layer, whether routed or empty); ``useful`` counts the top-k
    assignments the capacity kept (``overflow`` the measured dropped
    share; all of them when None)."""
    S, E, D = batch * seq, num_experts, embed_dim
    cap = max(1, int((S / E) * moe_capacity))
    n_moe = sum(1 for i in range(depth)
                if moe_every > 0 and (i + 1) % moe_every == 0)
    n_dense = depth - n_moe
    fwd = {
        "attention_proj": depth * 8 * S * D * D,
        "attention_core": depth * 2 * batch * seq * seq * D,  # causal half
        "dense_mlp": n_dense * 16 * S * D * D,
        "router": n_moe * 2 * S * D * E,
        "expert_ffn_at_capacity": n_moe * 16 * E * cap * D * D,
        "dispatch_combine": n_moe * 4 * S * E * cap * D,
        "lm_head": 2 * S * D * vocab_size,
    }
    kept = 1.0 if overflow is None else 1.0 - float(overflow)
    return {
        "capacity": cap,
        "forward_terms": fwd,
        "flops_per_step": 3 * sum(fwd.values()),
        "useful_expert_ffn_flops_per_step":
            3 * n_moe * 16 * S * top_k * kept * D * D,
        "dispatch_combine_over_expert_ffn":
            fwd["dispatch_combine"] / fwd["expert_ffn_at_capacity"],
    }


class MoEBench:
    """``bench_moe``'s trainer on one card: the MoE LM (weights from
    ``SEED``) trained by ``SPMDTrainer`` over a one-device mesh on one
    seeded token batch ``[batch, seq]`` in [1, vocab), step s's router
    noise from ``fold_in(SEED, s)``. ``widths`` overrides
    :data:`MOE_WIDTHS` (tiny sizes on the CPU)."""

    def __init__(self, batch: int = 16, seq: int = 512, device=None,
                 **widths):
        from ..models.gpt import CausalTransformer
        from ..parallel.mesh import make_mesh
        from ..parallel.trainer import SPMDTrainer
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.widths = {**MOE_WIDTHS, **widths}
        self.batch, self.seq = batch, seq
        mesh = make_mesh(devices=[self.device])
        self.module = CausalTransformer(max_len=seq, **self.widths,
                                        **MOE_ROUTING, mesh=mesh,
                                        dtype=torch.bfloat16, seed=SEED,
                                        device=self.device)
        self.trainer = SPMDTrainer(self.module, mesh, precision="bf16",
                                   batch_spec=("dp",))
        r = np.random.default_rng(0)
        self.tokens = r.integers(1, self.widths["vocab_size"],
                                 size=(batch, seq)).astype(np.int32)
        self.trainer.init(self.tokens)
        self.steps_run = 0

    def step(self) -> torch.Tensor:
        """One optimizer step; returns the loss, still on the device."""
        loss = self.trainer.train_step(self.tokens,
                                       rng=fold_in(SEED, self.steps_run))
        self.steps_run += 1
        return loss

    def measure(self, steps: int = 8, reps: int = 3) -> dict:
        """One warm-up step (its flash launches counted), then ``reps``
        runs of ``steps`` steps; tokens/s of the best run, and the loss of
        every step."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        before = flash_counts()
        losses = [self.step()]
        _sync(dev)
        launches = {n: c - before[n] for n, c in flash_counts().items()}
        dts = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(self.step())
            _sync(dev)
            dts.append(time.perf_counter() - t0)
        best = min(dts)
        losses = [float(v) for v in losses]
        overflow = float(self.trainer.last_moe_overflow)
        fl = moe_flops(self.batch, self.seq, **self.widths, **MOE_ROUTING,
                       overflow=overflow)
        tok_s = steps * self.batch * self.seq / best
        steps_s = steps / best
        mfu = fl["flops_per_step"] * steps_s / PEAK_BF16_FLOPS
        row = {
            "metric": "gpt-moe-train-throughput",
            "value": tok_s,
            "unit": "tokens/sec",
            "batch": self.batch,
            "seq": self.seq,
            "num_experts": MOE_ROUTING["num_experts"],
            "top_k": MOE_ROUTING["top_k"],
            "moe_every": MOE_ROUTING["moe_every"],
            "flops_per_step": fl["flops_per_step"],
            "peak_flops": PEAK_BF16_FLOPS,
            "mfu": mfu,
            "roofline_mfu_ceiling": None,
            "moe_overflow": overflow,
            "loss": losses[-1],
            "steps_per_sec": steps_s,
            "step_ms": 1e3 * best / steps,
            "steps": steps, "reps": reps,
            "capacity": fl["capacity"],
            "flops_forward_terms": fl["forward_terms"],
            "useful_expert_ffn_flops_per_step":
                fl["useful_expert_ffn_flops_per_step"],
            "useful_expert_ffn_peak_fraction":
                fl["useful_expert_ffn_flops_per_step"] * steps_s
                / PEAK_BF16_FLOPS,
            "dispatch_combine_over_expert_ffn":
                fl["dispatch_combine_over_expert_ffn"],
            "flash_launches_per_step": launches,
            "losses": losses,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
        }
        if dev.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            row["memory_allocated_at_start"] = held
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"gpt-moe: a loss is not finite: {losses}")
        return row


def bench_moe(steps: int = 8, batch: int = 16, seq: int = 512,
              device=None, **widths) -> dict:
    return MoEBench(batch, seq, device, **widths).measure(steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="transformer training "
                                "throughput (ViT-Tiny, BERT-base, the "
                                "GPT-2-small MoE; PyTorch + CUDA)")
    p.add_argument("--model", choices=["vit-tiny", "bert-base", "gpt-moe",
                                       "all"], default="all")
    p.add_argument("--steps", type=int, default=None,
                   help="rounds a timed run")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    args = p.parse_args(argv)
    if args.model in ("vit-tiny", "all"):
        print(json.dumps(bench_vit(args.steps or 10, args.batch or 256,
                                   args.device)), flush=True)
    if args.model in ("bert-base", "all"):
        print(json.dumps(bench_bert(args.steps or 5, args.batch or 32,
                                    device=args.device)), flush=True)
    if args.model in ("gpt-moe", "all"):
        print(json.dumps(bench_moe(args.steps or 8, args.batch or 16,
                                   device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
