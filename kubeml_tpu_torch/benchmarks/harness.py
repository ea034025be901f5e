"""The K-AVG flagship and its throughput benchmark: the port of
``kubeml_tpu/benchmarks/harness.py``'s ``flagship`` and
``make_synthetic_model``, and of ``bench.py``'s measurement.

The flagship is ResNet-18 on CIFAR-10 shapes (32x32x3, 10 classes) in
bf16, trained by ``KAvgTrainer`` on uint8 slabs dequantised on the device
(``x / 127.5 - 1`` in bf16), SGD with momentum 0.9 at lr 0.1, B 128, K 8.

    python -m kubeml_tpu_torch.benchmarks.harness            # one card
    python -m kubeml_tpu_torch.benchmarks.harness --workers 4

prints one JSON row keyed ``resnet18-cifar10-kavg-train-throughput``:
``value`` is device samples/s with the round's slabs resident on the card
(best of ``--reps`` runs of ``--rounds`` rounds), ``end_to_end`` the same
with every round staged from the host through ``RoundPrefetcher``, and
``plain_loop_samples_per_sec`` a plain PyTorch loop of as many SGD steps
of one model with no averaging (the engine's overhead yardstick). It runs
on the current CUDA card and raises without one unless given
``--device cpu`` (for tiny sizes only).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

METRIC = "resnet18-cifar10-kavg-train-throughput"
# bench.py's learning rate, and the seed of the slabs and the weights
LR, SEED = 0.1, 0


@dataclass(frozen=True)
class Flagship:
    module: nn.Module
    sample_shape: Tuple[int, ...]
    name: str
    num_classes: int


def flagship(dtype: Optional[torch.dtype] = None) -> Flagship:
    """The headline model: ResNet-18 for CIFAR-10. ``dtype`` is the
    compute dtype (None = f32)."""
    from ..models.resnet import ResNet18

    kw = {} if dtype is None else {"dtype": dtype}
    return Flagship(module=ResNet18(num_classes=10, **kw),
                    sample_shape=(32, 32, 3), name="resnet18-cifar10",
                    num_classes=10)


def make_synthetic_model(module: nn.Module, dataset_name: str = "synthetic",
                         uint8_inputs: bool = False):
    """Wrap ``module`` in a KubeModel over a placeholder dataset (the
    benchmark feeds slabs directly), with SGD(lr, momentum 0.9).
    ``uint8_inputs=True`` installs the device-side dequantisation (uint8
    [0, 255] -> bf16 [-1, 1]), so the host stages a quarter of f32's
    bytes."""
    from ..data.dataset import KubeDataset
    from ..runtime.model import KubeModel

    class _SyntheticModel(KubeModel):
        def __init__(self):
            super().__init__(KubeDataset(dataset_name))

        def build(self):
            return module

        def configure_optimizers(self, params):
            return torch.optim.SGD(params, lr=self.lr, momentum=0.9)

        if uint8_inputs:
            def preprocess(self, x):
                return x.to(torch.bfloat16) / 127.5 - 1.0

    return _SyntheticModel()


def train_flops_per_sample(module: nn.Module, sample_shape,
                           sample_dtype: torch.dtype = torch.float32
                           ) -> float:
    """Operations of one training sample counted from the layers' shapes:
    2 x in x out per output position of every conv, dense
    (``QuantizableDense``) and ``DenseGeneral`` layer (in = the product of
    its contracted axes), plus attention's two products (Q.K^T and P.V) in
    each ViT or BERT attention layer, 4 x L^2 x D x H (padded keys
    included), for the forward; three times that for forward plus backward
    (BatchNorm, LayerNorm, softmax and elementwise work not counted). The
    probe is one sample of zeros of ``sample_dtype`` (token ids for BERT);
    on a CUDA module it runs the forward there, launching its kernels."""
    from ..models.bert import BertSelfAttention
    from ..models.layers import Conv, DenseGeneral, QuantizableDense
    from ..models.vit import MHSA

    total = [0.0]

    def dense(m, inp, out):
        fan_in = (m.kernel[0].numel() if isinstance(m, Conv)
                  else math.prod(m.in_shape) if isinstance(m, DenseGeneral)
                  else m.kernel.shape[0])
        total[0] += 2.0 * fan_in * out.numel()  # batch 1: one sample

    def attention(m, inp, out):
        L, E = out.shape[1], out.shape[2]  # [1, L, E], E = H x D
        total[0] += 4.0 * L * L * E

    hooks = [m.register_forward_hook(dense) for m in module.modules()
             if isinstance(m, (Conv, QuantizableDense, DenseGeneral))]
    hooks += [m.register_forward_hook(attention) for m in module.modules()
              if isinstance(m, (MHSA, BertSelfAttention))]
    try:
        probe = torch.zeros((1, *sample_shape), dtype=sample_dtype,
                            device=next(module.parameters()).device)
        with torch.no_grad():
            module(probe, train=False)
    finally:
        for h in hooks:
            h.remove()
    return 3.0 * total[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class FlagshipBench:
    """``bench.py``'s measurement of the flagship on the port, for
    ``n_workers`` K-AVG workers packed on one device: slabs ``[n_workers,
    k, batch, 32, 32, 3]`` of uint8 from ``np.random.default_rng(SEED)``,
    weights from ``SEED``, SGD(LR, momentum 0.9). With ``dist`` (a
    ``DistContext`` of several ranks) the workers split over the ranks:
    this rank holds and measures its rows of the same global slabs, and
    ``samples_per_round`` counts its own."""

    def __init__(self, n_workers: int = 1, batch: int = 128, k: int = 8,
                 device=None, dist=None):
        from ..engine.kavg import KAvgTrainer

        self.fs = flagship(dtype=torch.bfloat16)
        self.model = make_synthetic_model(self.fs.module, "bench-synthetic",
                                          uint8_inputs=True)
        self.trainer = KAvgTrainer(self.model, precision="bf16",
                                   device=device, dist=dist)
        self.device = self.trainer.device
        self.n_workers, self.batch, self.k = n_workers, batch, k
        r = np.random.default_rng(SEED)
        a, b = self.trainer.local_rows(n_workers)
        self.x = r.integers(0, 256, size=(n_workers, k, batch,
                                          *self.fs.sample_shape)
                            ).astype(np.uint8)[a:b]
        self.y = r.integers(0, self.fs.num_classes,
                            size=(n_workers, k, batch)).astype(np.int64)[a:b]
        self.mask = np.ones((b - a, k, batch), np.float32)
        self.variables = self.trainer.init_variables(SEED, self.x[0, 0],
                                                     n_workers)
        # the round's slabs, resident on the device after the first round
        self.staged = self.trainer.stage_round(self.x, self.y, self.mask,
                                               n_workers)
        self.samples_per_round = (b - a) * k * batch

    def round(self, staged=None) -> torch.Tensor:
        """One sync round (on the resident slabs unless given others);
        returns the loss, still on the device."""
        self.variables, loss = self.trainer.sync_round(
            self.variables, *(staged or self.staged), lr=LR)
        return loss

    def measure(self, rounds: int = 20, reps: int = 3) -> dict:
        """One warm-up round, then ``reps`` runs of ``rounds`` rounds with
        the slabs resident (device samples/s, best run) and ``reps`` runs
        with every round staged from the host through
        ``RoundPrefetcher`` (end-to-end samples/s, best run)."""
        from ..engine.kavg import RoundPrefetcher

        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        first_loss = float(self.round())
        device_dts = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(rounds):
                loss = self.round()
            float(loss)
            device_dts.append(time.perf_counter() - t0)
        rb = SimpleNamespace(x=self.x, y=self.y, mask=self.mask)
        e2e_dts = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            for _, cur in RoundPrefetcher(self.trainer,
                                          (rb for _ in range(rounds)),
                                          self.n_workers):
                loss = self.round(cur)
            float(loss)
            e2e_dts.append(time.perf_counter() - t0)
        best = min(device_dts)
        row = {
            "metric": METRIC,
            "value": rounds * self.samples_per_round / best,
            "unit": "samples/sec",
            "end_to_end": rounds * self.samples_per_round / min(e2e_dts),
            "round_ms": 1e3 * best / rounds,
            "config": {"batch": self.batch, "k": self.k, "rounds": rounds,
                       "reps": reps, "n_workers": self.n_workers,
                       "lr": LR, "dtype": "bf16", "inputs": "uint8"},
            "train_flops_per_sample": train_flops_per_sample(
                self.trainer.module, self.fs.sample_shape),
            "first_loss": first_loss,
            "loss": float(loss),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
        }
        if dev.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        if not math.isfinite(row["loss"]):
            raise RuntimeError(f"the flagship's loss is {row['loss']}")
        return row

    def plain_loop(self, steps: int) -> float:
        """The yardstick of the engine's overhead: samples/s of a plain
        PyTorch loop of ``steps`` SGD steps (momentum 0.9, LR) of a fresh
        flagship module over worker 0's resident batches, with no replicas,
        no averaging and no optimizer reset."""
        module = flagship(dtype=torch.bfloat16).module.to(self.device)
        opt = torch.optim.SGD(module.parameters(), lr=LR, momentum=0.9)
        x = self.model.preprocess(self.staged[0][0])
        y = self.staged[1][0].to(self.device)

        def step(s):
            loss = F.cross_entropy(module(x[s % self.k], train=True),
                                   y[s % self.k])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        step(0)  # warm-up
        _sync(self.device)
        t0 = time.perf_counter()
        for s in range(steps):
            loss = step(s)
        float(loss)
        return steps * self.batch / (time.perf_counter() - t0)


def measure(n_workers: int = 1, batch: int = 128, k: int = 8,
            rounds: int = 20, reps: int = 3, device=None) -> dict:
    """The benchmark row of :class:`FlagshipBench`, with the plain loop's
    samples/s over the same number of SGD steps beside it."""
    bench = FlagshipBench(n_workers, batch, k, device)
    row = bench.measure(rounds, reps)
    row["plain_loop_samples_per_sec"] = bench.plain_loop(rounds * k)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="K-AVG flagship throughput "
                                "(ResNet-18/CIFAR-10, PyTorch + CUDA)")
    p.add_argument("--workers", type=int, default=1,
                   help="K-AVG workers, packed on the one card")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--k", type=int, default=8, help="local steps a round")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    args = p.parse_args(argv)
    row = measure(args.workers, args.batch, args.k, args.rounds, args.reps,
                  device=args.device)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
