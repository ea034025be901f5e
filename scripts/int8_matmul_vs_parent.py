#!/usr/bin/env python3
"""The port's int8 weight matmul in two checkouts, timed in turns on one
card: an earlier tree (``--parent``) and the tree that holds this script.

Each run is a process of its own that imports ``kubeml_tpu_torch`` from its
tree (which builds that tree's kernels at first use) and calls its
``int8_matmul(x, q, s)``, so each tree runs with its own wrapper and launch
plan. At chip_smoke's phase-3 shapes (M 1, 8, 256, 2048 over the four
GPT-2-small (K, N), f32 and bf16 x, made from one seed) a run prints, one
JSON row a shape:

* ``write_ms``: the mean device time of one call on a cold L2 made by
  rewriting a 256 MB buffer, as ``chip_smoke.py``'s ``Timer`` makes it;
* ``read_ms``: the same with the buffer read instead (the L2 then holds no
  dirty lines whose write-back the call pays for);
* ``host_us`` (M <= 8): the host time of one call, 200 calls enqueued back
  to back;
* ``rel_err``: the largest difference from the tree's ``int8_dot``,
  relative to its largest |output|.

The runs go parent, change, change, parent. Run from the repo root on a
machine with the card and ``nvcc``, with the earlier tree unpacked inside
the checkout, under the gitignored ``scratch/``::

    mkdir -p scratch/parent && git archive <commit> | tar -x -C scratch/parent
    python3 scripts/int8_matmul_vs_parent.py --parent scratch/parent
"""

import argparse
import json
import os
import subprocess
import sys
import time

VOCAB = 50257
SHAPES = [(M, K, N) for M in (1, 8, 256, 2048)
          for K, N in ((768, 768), (768, 3072), (3072, 768), (768, VOCAB))]


def run_tree(tree: str, iters: int) -> int:
    """Time ``tree``'s ``int8_matmul`` at every shape; one JSON row each."""
    sys.path.insert(0, tree)
    import torch

    from kubeml_tpu_torch.ops.int8_matmul import int8_dot, int8_matmul

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def device_ms(fn, cold) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            cold()
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def host_us(fn, calls: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / calls

    g = torch.Generator().manual_seed(0)
    for M, K, N in SHAPES:
        q = torch.randint(-127, 128, (K, N), generator=g,
                          dtype=torch.int8).cuda()
        s = (torch.rand(1, N, generator=g) * 0.02).cuda()
        for xd in (torch.float32, torch.bfloat16):
            x = torch.randn(M, K, generator=g).to(xd).cuda()
            call = lambda: int8_matmul(x, q, s)  # noqa: E731
            ref = int8_dot(x, q, s).float()
            row = dict(M=M, K=K, N=N, x=str(xd).split(".")[-1],
                       rel_err=((call().float() - ref).abs().max()
                                / ref.abs().max()).item(),
                       write_ms=device_ms(call, flush.zero_),
                       read_ms=device_ms(
                           call, lambda: torch.sum(flush, dim=0, out=sink)))
            if M <= 8:
                row["host_us"] = host_us(call)
            print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the earlier tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one run, internal
    args = ap.parse_args()
    if args.tree:
        return run_tree(os.path.abspath(args.tree), args.iters)
    if not args.parent:
        ap.error("--parent is required")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for i, name in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", trees[name],
             "--iters", str(args.iters)], cwd=trees[name],
            capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            row = json.loads(line)
            print(json.dumps({"run": i, "tree": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
