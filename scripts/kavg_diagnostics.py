#!/usr/bin/env python3
"""Diagnostics of the PyTorch port's K-AVG round on one CUDA card.

    python3 scripts/kavg_diagnostics.py spread    # f32 round: card vs CPU
    python3 scripts/kavg_diagnostics.py workers   # host ms a worker, N 1 / 4

``spread`` runs ``chip_smoke.py``'s phase-9b round (ResNet-18, f32, N 4,
K 2, B 16, TF32 off) on the card with deterministic cuDNN and without, and
on the CPU with all threads and with one, and prints for each pair the L2
difference of the merged weights over the round's L2 change, the loss's
relative difference and the worst leaf by its own scale: the CPU's own
spread is the yardstick of the card-vs-CPU tolerance.

``workers`` runs the flagship (``benchmarks.harness.FlagshipBench``, bf16,
B 128, K 8) at N 1 and N 4 packed on the card, in turns, and prints the
round's wall ms with the card synchronised before each worker (the ms of
each worker), then the round's ms with nothing synchronised.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def spread() -> None:
    import chip_smoke as cs
    from kubeml_tpu_torch.benchmarks.harness import LR, make_synthetic_model
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.models.resnet import ResNet18

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, k, batch = 4, 2, 16
    r = np.random.default_rng(1)
    x = r.normal(size=(n, k, batch, 32, 32, 3)).astype(np.float32)
    y = r.integers(0, 10, size=(n, k, batch)).astype(np.int64)
    m = np.ones((n, k, batch), np.float32)

    def trainer(dev):
        return KAvgTrainer(make_synthetic_model(ResNet18(num_classes=10)),
                           precision="f32", device=dev)

    t = trainer("cpu")
    ref = t.reference_variables(t.init_variables(0, x[0, 0], 1))

    def run(dev, threads=None, deterministic=False):
        nt = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        torch.backends.cudnn.deterministic = deterministic
        try:
            tr = trainer(dev)
            v = tr.place_reference(ref, n)
            v, loss = tr.sync_round(v, x, y, m, lr=LR)
            return cs._flat(tr.reference_variables(v)), float(loss)
        finally:
            torch.set_num_threads(nt)
            torch.backends.cudnn.deterministic = False

    runs = {"cpu": run("cpu"), "cpu 1 thread": run("cpu", threads=1),
            "cuda deterministic": run("cuda", deterministic=True),
            "cuda": run("cuda")}
    base = cs._flat(ref)
    print(f"{cs.nvidia_smi()}; cpu threads {torch.get_num_threads()}")
    for a, b in (("cpu", "cpu 1 thread"), ("cuda deterministic", "cpu"),
                 ("cuda deterministic", "cuda")):
        (p, lp), (q, lq) = runs[a], runs[b]
        leaf = max((float(np.abs(p[k_] - q[k_]).max())
                    / max(float(np.abs(q[k_]).max()), 1e-30), k_) for k_ in q)
        print(f"{a} vs {b}: |diff| / |change| "
              f"{cs._l2(p, q) / cs._l2(q, base):.3e}, loss rel "
              f"{abs(lp - lq) / abs(lq):.3e}, worst leaf {leaf[1]} at "
              f"{leaf[0]:.3e} of its largest entry")


def workers() -> None:
    import chip_smoke as cs
    from kubeml_tpu_torch.benchmarks.harness import FlagshipBench
    from kubeml_tpu_torch.engine import kavg

    bind = kavg.bind
    stamps = []

    def synced_bind(module, variables):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        bind(module, variables)

    print(cs.nvidia_smi())
    for n in (1, 4, 1, 4):
        bench = FlagshipBench(n, cs.KAVG_B, cs.KAVG_K, device="cuda")
        float(bench.round())
        kavg.bind = synced_bind
        try:
            for _ in range(3):
                stamps.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bench.round()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                per = np.round(np.diff(stamps + [t1]) * 1e3, 2).tolist()
                print(f"N {n}: synced round {1e3 * (t1 - t0):.2f} ms, a "
                      f"worker (bind to the next bind or the end) {per}")
        finally:
            kavg.bind = bind
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            loss = bench.round()
        float(loss)
        print(f"N {n}: round {1e3 * (time.perf_counter() - t0) / 5:.2f} ms "
              f"(5 rounds, nothing synchronised)")
        del bench
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=["spread", "workers"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    {"spread": spread, "workers": workers}[args.what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
