#!/usr/bin/env python3
"""Time the port's serving kernels on one card, with ``chip_smoke.py``'s
shapes, inputs and timer (imported from the ``chip_smoke.py`` beside this
script). Two modes, each printing the card's name and power limit, then one
JSON row a measurement:

``vs-parent --op paged_attention|int8_matmul --parent DIR``
    The op of an earlier tree (``DIR``) against this tree's, in turns:
    parent, change, change, parent. Each run is a process of its own that
    imports ``kubeml_tpu_torch`` from its tree (which builds that tree's
    kernels at first use), so each tree runs with its own wrapper and
    launch plan on the same inputs: paged attention at ``PA_CASES`` in f32,
    bf16 and int8 arenas, the int8 matmul at ``MM_SHAPES`` with f32 and
    bf16 x. A row holds ``ms`` (the ``Timer``: mean device time of one
    call on an L2 cold from rewriting 256 MB), ``host_us`` at decode
    shapes (one call, 200 enqueued back to back) and the error against the
    tree's plain version.

``paged-mapping``
    Paged attention at 8 rows of the decode positions for L 4-128, each L
    through both of the kernel's mappings (decode: a warp per (head,
    query); tile: lanes over queries), forced by the threshold
    ``_DECODE_MAX_L`` of the arena's dtype: ``ms`` (the ``Timer``) and
    ``kernel_ms`` (the profiler's kernel time after the same flush). The
    readings choose the threshold per arena dtype.

Run from the repo root on a machine with the card and ``nvcc``; an earlier
tree goes under the gitignored ``scratch/``::

    mkdir -p scratch/parent && git archive <commit> | tar -x -C scratch/parent
    python3 scripts/kernel_timing.py vs-parent --op paged_attention \\
        --parent scratch/parent
    python3 scripts/kernel_timing.py paged-mapping
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float32", "bfloat16", "int8")


def smoke():
    """This tree's ``chip_smoke`` module: shapes, inputs, timer."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paged_rows(cs, iters):
    import torch

    from kubeml_tpu_torch.ops.paged_attention import (paged_attention,
                                                      paged_attention_ref)

    timer, g = cs.Timer(), torch.Generator().manual_seed(cs.SEED)
    for kv in DTYPES:
        for tag, L, positions in cs.PA_CASES:
            q, kp, vp, pages, pos, sc = cs.paged_inputs(
                g, L, positions, getattr(torch, kv))
            call = lambda: paged_attention(q, kp, vp, pages, pos, **sc)  # noqa
            ref = paged_attention_ref(q, kp, vp, pages, pos, **sc).float()
            row = dict(kv=kv, case=tag, L=L,
                       max_abs_err=(call().float() - ref).abs().max().item(),
                       ms=timer.ms(call, iters))
            if L == 1:
                row["host_us"] = cs.host_us(call)
            yield row


def int8_rows(cs, iters):
    import torch

    from kubeml_tpu_torch.ops.int8_matmul import int8_dot, int8_matmul

    timer, g = cs.Timer(), torch.Generator().manual_seed(cs.SEED)
    for M, K, N in cs.MM_SHAPES:
        q, s = cs.mm_weights(g, K, N)
        for xd in ("float32", "bfloat16"):
            x = torch.randn(M, K, generator=g).to(getattr(torch, xd)).cuda()
            ref = int8_dot(x, q, s).float()
            err = (int8_matmul(x, q, s).float() - ref).abs().max().item()
            row = dict(M=M, K=K, N=N, x=xd,
                       rel_err=err / ref.abs().max().item(),
                       ms=timer.ms(lambda: int8_matmul(x, q, s), iters))
            if M <= 8:
                row["host_us"] = cs.host_us(lambda: int8_matmul(x, q, s))
            yield row


def mapping_rows(cs, iters):
    import torch

    from kubeml_tpu_torch.ops import paged_attention as pa

    timer, g = cs.Timer(), torch.Generator().manual_seed(cs.SEED)
    positions = cs.PA_CASES[0][2]
    for kv in DTYPES:
        dtype = getattr(torch, kv)
        es = torch.empty((), dtype=dtype).element_size()
        keep = pa._DECODE_MAX_L[es]
        for L in (4, 8, 12, 16, 24, 32, 33, 40, 48, 64, 96, 128):
            q, kp, vp, pages, pos, sc = cs.paged_inputs(g, L, positions,
                                                        dtype)
            call = lambda: pa.paged_attention(q, kp, vp, pages, pos,  # noqa
                                              **sc)
            for mapping, limit in (("decode", L), ("tile", L - 1)):
                pa._DECODE_MAX_L[es] = limit
                pa._plan.cache_clear()
                yield dict(kv=kv, L=L, mapping=mapping,
                           ms=timer.ms(call, iters),
                           kernel_ms=cs.profiler_ms(timer, call, cs.PA_KERNEL,
                                                    iters))
        pa._DECODE_MAX_L[es] = keep
        pa._plan.cache_clear()


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("vs-parent", "paged-mapping"))
    ap.add_argument("--op", choices=("paged_attention", "int8_matmul"),
                    default="paged_attention")
    ap.add_argument("--parent", help="root of the earlier tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one run, internal
    args = ap.parse_args()
    rows = dict(paged_attention=paged_rows, int8_matmul=int8_rows)
    if args.tree:  # one tree's run: its package first on the path
        sys.path.insert(0, os.path.abspath(args.tree))
        for row in rows[args.op](smoke(), args.iters):
            print(json.dumps(row), flush=True)
        return 0
    print(nvidia_smi(), flush=True)
    if args.mode == "paged-mapping":
        sys.path.insert(0, ROOT)
        for row in mapping_rows(smoke(), args.iters):
            print(json.dumps(row), flush=True)
        return 0
    if not args.parent:
        ap.error("vs-parent needs --parent")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    for i, name in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.mode, "--op",
             args.op, "--tree", trees[name], "--iters", str(args.iters)],
            cwd=trees[name], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            print(json.dumps({"run": i, "tree": name, **json.loads(line)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
