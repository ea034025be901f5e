#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA H100): the paged
serving path and the GPT training path. Run from the repo root::

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device - the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  - every CUDA kernel from ``kubeml_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source), with the build seconds; the two
   Hopper flash kernels (bf16 forward and dK/dV) must hold warpgroup
   products (HGMMA) and TMA loads (UTMALDG) in their SASS
   (``cuobjdump -sass``), must not spill, and ptxas must not have
   serialized their wgmma;
3. serving kernels against their plain PyTorch versions at the serving
   path's shapes (GPT-2-small width: H 12, D 64, page_tokens 16, 64-page
   tables, 8 rows), with max abs error, kernel / plain / library times on
   the card and the bound from bytes and operations;
4. serve f32 - 16 requests from threads through ``PagedBatchingDecoder`` at
   GPT-2-small width (seeded random weights), greedy tokens held identical
   to the same engine reading the arena through the plain gather path, the
   paged-attention launch counter held to the engine's forward count, and
   three shared-prefix requests held to 64 cached tokens;
5. serve int8 - the same requests with int8 weights through the int8
   matmul kernel and int8 KV pages; both launch counters must move, and
   teacher-forced logits (prefill + 4 steps) must match the plain-path
   engine;
6. flash kernels - forward (out, lse), dQ and dK/dV against their plain
   versions in bf16 and f32 at the training shape (B 8, L 2048, H 8, D 64,
   causal), a ragged causal shape with 37 padded keys, cross attention
   (Lq 300, Lk 1000), D 128, D 128 cross attention with padded keys
   inside tiles (every 7th key of one row), and causal Lq != Lk at full
   (384 x 1024) and ragged (1000 x 640) tiles, each 64-row tile held to a
   relative error (``FLASH_TILE_RTOL``); repeated backwards bit-identical,
   padded keys' dK/dV exactly 0; then kernel / plain / SDPA / bound times
   over L 128-4096 at 16,384 tokens, with kernel / SDPA ratios;
7. train bf16 - ``benchmarks.longcontext.run_point`` at the long-context
   flagship's full width (E 512, depth 8, vocab 32000, remat, AdamW),
   L 2048: one warm-up and 10 timed steps through the kernels (launches
   per step held to fwd 2 x depth, dq and dkv depth; the loss must fall),
   a profiler window over 3 steps, then the same run on the plain path;
8. train f32 - one step through the kernels against the plain path from
   the same weights and batch: loss and every parameter's gradient;
9. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Any failure raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# --- GPT-2-small serving configuration ---------------------------------
VOCAB, MAX_LEN, SEED = 50257, 1024, 0
SLOTS, PAGE_TOKENS, CHUNK = 8, 16, 16
# kernel-phase shapes: the engine's default arena for 8 slots of 1024
# positions (8 x 64 pages + the trash page)
H, D, P, B, N_PAGES = 12, 64, 64, 8, 513
# --- training: the long-context flagship (kubeml_tpu/benchmarks/
# longcontext.py) at full width, 16,384 tokens a step; flash-phase heads and
# head dim of its attention
FLASH_H, FLASH_D, TRAIN_TOKENS, DEPTH = 8, 64, 16384, 8

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# tolerances of the on-card comparisons, kernel vs plain version:
# f32 1e-5 - both sum in f32, in other orders (observed ~1e-6);
# bf16 0.05 - the plain path rounds scores and p to bf16, the kernel
#   keeps f32 (the JAX suite's bound);
# int8 arenas 1e-5 - the same int8 values, the scale folded after the
#   product instead of before.
PA_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05, torch.int8: 1e-5}
# int8 matmul, relative to the largest |output|: f32 1e-5 (f32 sums over
# K in another order); bf16 1e-2 (one rounding of the output to bf16)
MM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# teacher-forced logits, int8 engine vs its plain twin: 5e-2 absolute.
# Both hold the same int8 weights, but a K/V value at a rounding tie may
# quantize one step (1/127 of its page's absmax) apart when the two
# matmul paths differ in the last bit.
TF_ATOL = 5e-2


def log(*parts) -> None:
    print(*parts, flush=True)


# the Hopper kernels of the flash path: their SASS must hold warpgroup
# products (HGMMA) and TMA loads (UTMALDG), ptxas must not have serialized
# their wgmma, and they must not spill
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_dkv_wgmma_kernel")


def check_compiled(so_path: str, build_log: str) -> None:
    """Phase 2's check of the compiled wgmma kernels: HGMMA and UTMALDG in
    the SASS of every instantiation (``cuobjdump -sass`` on the built
    library), registers and spills from ptxas -v, no "wgmma ...
    serialized" warning. Raises on any miss."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: the compiled wgmma kernels "
                           "cannot be checked")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    # ptxas -v: "Function properties for NAME", then "N bytes stack frame,
    # N bytes spill stores, N bytes spill loads", then "Used N registers"
    props, name = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            props[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            props[name]["spill"] = int(st) + int(ld)
        elif name and "Used" in ln and "registers" in ln:
            props[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    serialized = [ln.strip() for ln in build_log.splitlines()
                  if "wgmma" in ln and "serializ" in ln]
    for kname in WGMMA_KERNELS:
        bodies = [f for f in funcs if kname in f.split("\n", 1)[0]]
        info = [p for n, p in props.items() if kname in n]
        hgmma = [f.count("HGMMA") for f in bodies]
        utma = [f.count("UTMALDG") for f in bodies]
        log(f"  {kname}: {len(bodies)} instantiations, HGMMA per "
            f"instantiation {hgmma}, UTMALDG {utma}, registers "
            f"{[p.get('registers') for p in info]}, spill bytes "
            f"{[p.get('spill') for p in info]}")
        if not bodies or min(hgmma) == 0:
            raise AssertionError(f"{kname}: no HGMMA in its SASS")
        if min(utma) == 0:
            raise AssertionError(f"{kname}: no UTMALDG in its SASS")
        if len(info) != len(bodies) or any(p.get("spill", 1) for p in info):
            raise AssertionError(f"{kname}: spills (or no ptxas report)")
    log(f"  ptxas wgmma serialization warnings: {len(serialized)}")
    for ln in serialized:
        log(f"    {ln[:200]}")
    if serialized:
        raise AssertionError("ptxas serialized wgmma in a kernel")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of one call, each launch on a cold L2 (a 256 MB
    buffer is rewritten between launches: on the serving path each layer's
    weights and pages are read once per step, so they come from HBM)."""

    def __init__(self):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def ms(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            total += self.start.elapsed_time(self.end)
        return total / iters


# --- phase 3: kernels against their plain versions ----------------------

def paged_inputs(g, L, positions, kv_dtype):
    """q, arenas (+ scales), a table of distinct pages per row."""
    q_dtype = torch.float32 if kv_dtype == torch.int8 else kv_dtype
    q = torch.randn(B, L, H, D, generator=g).to(q_dtype).cuda()
    kf = torch.randn(N_PAGES, PAGE_TOKENS, H, D, generator=g)
    vf = torch.randn(N_PAGES, PAGE_TOKENS, H, D, generator=g)
    pages = (torch.randperm(N_PAGES - 1, generator=g)[:B * P] + 1
             ).reshape(B, P).to(torch.int32).cuda()
    pos = torch.tensor(positions, dtype=torch.int32).cuda()
    scales = {}
    if kv_dtype == torch.int8:
        ks, vs = kf.abs().amax(dim=(1, 3)), vf.abs().amax(dim=(1, 3))
        kf = torch.round(kf * 127 / ks[:, None, :, None]).clamp(-127, 127)
        vf = torch.round(vf * 127 / vs[:, None, :, None]).clamp(-127, 127)
        scales = dict(k_scale=ks.cuda(), v_scale=vs.cuda())
    return q, kf.to(kv_dtype).cuda(), vf.to(kv_dtype).cuda(), pages, pos, \
        scales


def paged_bound_ms(q, kp, pages, pos, scales):
    """Bytes: q and out once, each row's LIVE K and V pages once (and
    their scales), the table and positions. Operations: 4*D per (query,
    head, attended key) - QK^T and PV."""
    L = q.shape[1]
    live = ((pos.long() + L + PAGE_TOKENS - 1) // PAGE_TOKENS).clamp(1, P)
    page_bytes = PAGE_TOKENS * H * D * kp.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * int(live.sum()) * page_bytes
              + (2 * int(live.sum()) * H * 4 if scales else 0)
              + pages.numel() * 4 + pos.numel() * 4)
    keys = sum(min(int(p) + l + 1, P * PAGE_TOKENS)
               for p in pos.tolist() for l in range(L))
    ops = 4 * D * H * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_paged_attention(timer, g):
    import torch.nn.functional as F

    from kubeml_tpu_torch.ops.paged_attention import (paged_attention,
                                                      paged_attention_ref)

    cases = [(1, [0, 15, 16, 100, 333, 511, 777, 1023]),
             (5, [0, 3, 60, 200, 500, 800, 1010, 1018]),
             (128, [0, 16, 128, 256, 384, 512, 640, 896])]
    rows = []
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        for L, positions in cases:
            q, kp, vp, pages, pos, scales = paged_inputs(g, L, positions,
                                                         kv_dtype)
            out = paged_attention(q, kp, vp, pages, pos, **scales)
            ref = paged_attention_ref(q, kp, vp, pages, pos, **scales)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= PA_TOL[kv_dtype]:
                raise AssertionError(f"paged_attention {kv_dtype} L={L}: "
                                     f"max abs err {err} > "
                                     f"{PA_TOL[kv_dtype]}")
            # yardstick: SDPA over the pre-gathered K/V (gather not timed)
            idx = pages.long()
            if scales:
                kgat = (kp[idx].float() * (scales["k_scale"][idx] / 127.0)
                        [:, :, None, :, None]).to(q.dtype)
                vgat = (vp[idx].float() * (scales["v_scale"][idx] / 127.0)
                        [:, :, None, :, None]).to(q.dtype)
            else:
                kgat, vgat = kp[idx], vp[idx]
            kgat = kgat.reshape(B, P * PAGE_TOKENS, H, D).transpose(1, 2) \
                .contiguous()
            vgat = vgat.reshape(B, P * PAGE_TOKENS, H, D).transpose(1, 2) \
                .contiguous()
            qt = q.transpose(1, 2).contiguous()
            k_pos = torch.arange(P * PAGE_TOKENS, device="cuda")
            q_pos = pos.long()[:, None] + torch.arange(L, device="cuda")
            mask = (k_pos[None, None, None, :] <= q_pos[:, None, :, None])
            row = dict(
                kv=str(kv_dtype).split(".")[-1], L=L, max_abs_err=err,
                ms=timer.ms(lambda: paged_attention(q, kp, vp, pages, pos,
                                                    **scales)),
                plain_ms=timer.ms(lambda: paged_attention_ref(
                    q, kp, vp, pages, pos, **scales)),
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kgat, vgat, attn_mask=mask)))
            row["bound_ms"], row["bound_by"] = paged_bound_ms(q, kp, pages,
                                                              pos, scales)
            log("  paged_attention", json.dumps(row))
            rows.append(row)
    # poisoned arenas: every position no live row wrote (trash page 0,
    # unallocated pages, slots past each row's cursor) poisoned; the output
    # must be bit-identical
    for kv_dtype in (torch.float32, torch.int8):
        L, positions = cases[0]
        q, kp, vp, pages, pos, scales = paged_inputs(g, L, positions,
                                                     kv_dtype)
        written = torch.zeros(N_PAGES, PAGE_TOKENS, dtype=torch.bool)
        live_pages = set()
        for b, p0 in enumerate(positions):
            for lp in range(p0 + L):
                phys = int(pages[b, lp // PAGE_TOKENS])
                written[phys, lp % PAGE_TOKENS] = True
                live_pages.add(phys)
        w = written.cuda()[:, :, None, None]
        bad = 127 if kv_dtype == torch.int8 else 1e9
        clean = [torch.where(w, a, torch.zeros_like(a)) for a in (kp, vp)]
        poison = [torch.where(w, a, torch.full_like(a, bad))
                  for a in (kp, vp)]
        pscales = dict(scales)
        if scales:
            dead = torch.ones(N_PAGES, dtype=torch.bool)
            dead[sorted(live_pages)] = False
            pscales = {k: torch.where(dead.cuda()[:, None],
                                      torch.full_like(s, 1e9), s)
                       for k, s in scales.items()}
        a = paged_attention(q, *clean, pages, pos, **scales)
        b = paged_attention(q, *poison, pages, pos, **pscales)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"paged_attention {kv_dtype}: poisoned "
                                 f"arena changed the output")
        log(f"  paged_attention poisoned {str(kv_dtype).split('.')[-1]} "
            f"arena: bit-identical")
    return rows


def check_int8_matmul(timer, g):
    from kubeml_tpu_torch.ops.int8_matmul import int8_dot, int8_matmul

    rows = []
    for M in (8, 256):
        for K, N in ((768, 768), (768, 3072), (3072, 768), (768, VOCAB)):
            q = torch.randint(-127, 128, (K, N), generator=g,
                              dtype=torch.int8).cuda()
            s = (torch.rand(1, N, generator=g) * 0.02).cuda()
            for xd in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, generator=g).to(xd).cuda()
                y = int8_matmul(x, q, s)
                ref = int8_dot(x, q, s)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                if not err <= MM_RTOL[xd] * scale:
                    raise AssertionError(
                        f"int8_matmul M={M} K={K} N={N} {xd}: max abs err "
                        f"{err} > {MM_RTOL[xd]} x {scale}")
                nbytes = (x.numel() * x.element_size() + q.numel()
                          + s.numel() * 4 + M * N * x.element_size())
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = 2 * M * N * K / PEAK_OPS[xd]
                row = dict(
                    M=M, K=K, N=N, x=str(xd).split(".")[-1],
                    max_abs_err=err,
                    ms=timer.ms(lambda: int8_matmul(x, q, s)),
                    plain_ms=timer.ms(lambda: int8_dot(x, q, s)),
                    library_ms=timer.ms(
                        lambda: torch.matmul(x, q.to(x.dtype)) * s),
                    bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
                log("  int8_matmul", json.dumps(row))
                rows.append(row)
    return rows


# --- phases 4-5: serving ------------------------------------------------

def workload(rng):
    """16 requests: prompts of 16-512 tokens, 32-128 new tokens; requests
    0, 4, 8, 12 share a 64-token system prefix; request 5 stops at an eos
    id (chosen by a calibration run, see serve())."""
    sysp = rng.integers(1, VOCAB, size=64)
    reqs = []
    for i in range(16):
        plen = int(rng.integers(16, 513))
        prompt = rng.integers(1, VOCAB, size=plen)
        if i % 4 == 0:
            prompt = np.concatenate([sysp, prompt[:max(1, plen - 64)]])
        reqs.append(dict(prompt=prompt.astype(np.int32),
                         max_new=int(rng.integers(32, 129))))
    return reqs


def serve(dec, reqs):
    """Drive ``dec`` through the workload. First a calibration request (the
    eos request's prompt, 16 greedy tokens) picks the eos id as its 10th
    token; then every request is submitted from its own thread, except that
    sharers 2-4 wait for sharer 1's first token (its prefill registers the
    shared pages). Returns per-request results and timings."""
    from kubeml_tpu_torch.api import GenerateRequest

    calib = dec.wait(dec.submit(GenerateRequest(
        prompts=[reqs[5]["prompt"].tolist()], max_new_tokens=16)),
        timeout=600)
    eos = calib["tokens"][0][9]
    results, entries, errors = [None] * 16, [None] * 16, []
    first_sharer = threading.Event()

    def client(i):
        try:
            if i in (4, 8, 12):
                first_sharer.wait(600)
            r = reqs[i]
            entries[i] = dec.submit(GenerateRequest(
                prompts=[r["prompt"].tolist()], max_new_tokens=r["max_new"],
                eos_id=eos if i == 5 else None))
            if i == 0:
                while entries[0].first_token_at == 0.0:
                    time.sleep(0.001)
                first_sharer.set()
            results[i] = dec.wait(entries[i], timeout=600)
        except Exception as e:  # surfaced below, after the join
            errors.append(e)
            first_sharer.set()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving clients did not finish")
    tele = dec.telemetry()
    ttft = sorted(e.first_token_at - e.submitted_at for e in entries)
    tokens = sum(r["lengths"][0] for r in results)
    return dict(calib=calib["tokens"][0], eos=eos, results=results,
                tokens=tokens, wall=wall, tokens_per_s=tokens / wall,
                ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
                decode_step_ms=1e3 * tele["decode_seconds"]
                / max(tele["decode_steps"], 1),
                tele=tele)


def token_lists(run):
    return [run["calib"]] + [r["tokens"][0][:r["lengths"][0]]
                             for r in run["results"]]


def report_serve(tag, run) -> None:
    t = run["tele"]
    log(f"  {tag}: {run['tokens']} tokens in {run['wall']:.3f} s = "
        f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50_ms']:.1f} ms, decode step "
        f"{run['decode_step_ms']:.3f} ms ({int(t['decode_steps'])} steps, "
        f"{int(t['prefill_waves'])} prefill waves)")


def device_profile(run, also: str = "") -> float:
    """Where the time goes: a torch.profiler window around ``run()``.
    Prints the window's wall, the device-busy time (the sum of kernel
    times: one stream, so kernels do not overlap; user annotations such as
    ``Optimizer.step`` span kernels already counted and are left out), the
    idle share, and the five kernels with the most device time, then any
    other kernel whose name holds ``also``. Returns the busy ms (0.0 when
    the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    kernels = []
    for evt in prof.key_averages():
        if (str(getattr(evt, "device_type", "")).endswith("CUDA")
                and not getattr(evt, "is_user_annotation", False)):
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            kernels.append((t / 1e3, evt.count, evt.key))
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms <= 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return 0.0
    log(f"  profile: window {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(kernels, reverse=True)
    for i, (ms, count, name) in enumerate(ranked):
        if i < 5 or (also and also in name):
            log(f"    {100 * ms / busy_ms:5.1f}% {ms:8.2f} ms x{count:<6} "
                f"{name[:90]}")
    return busy_ms


def profile_window(dec, reqs) -> None:
    """A profiler window over 8 concurrent requests (32 new tokens each)
    on the serving engine ``dec``."""
    from kubeml_tpu_torch.api import GenerateRequest

    def run():
        entries = [dec.submit(GenerateRequest(
            prompts=[r["prompt"].tolist()], max_new_tokens=32))
            for r in reqs[:8]]
        for e in entries:
            dec.wait(e, timeout=600)

    device_profile(run)


def gpt2_small():
    from kubeml_tpu_torch.models import GPTSmall

    return GPTSmall(vocab_size=VOCAB, max_len=MAX_LEN, attn_bias=True,
                    ln_eps=1e-5, seed=SEED, device="cuda")


def teacher_forced_logits(dec, prompt, forced):
    """Prefill ``prompt`` and feed ``forced`` one token at a time through
    ``dec``'s module on a fresh arena with ``dec``'s read path and storage;
    returns the logits [1 + len(forced), vocab] at each step."""
    from kubeml_tpu_torch.models.generation import init_paged_cache

    dev = dec.device
    n = -(-(len(prompt) + len(forced)) // PAGE_TOKENS)
    cache = init_paged_cache(dec.module, n + 1, PAGE_TOKENS, dec.kv_quant,
                             dec.paged_attn)
    table = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None]
    out = []
    with torch.inference_mode():
        lg = dec.module(torch.tensor(prompt, device=dev)[None], decode=True,
                        positions=torch.zeros(1, dtype=torch.int32,
                                              device=dev),
                        pages=table, cache=cache)
        out.append(lg[0, -1])
        for i, tok in enumerate(forced):
            lg = dec.module(torch.tensor([[tok]], device=dev), decode=True,
                            positions=torch.tensor([len(prompt) + i],
                                                   dtype=torch.int32,
                                                   device=dev),
                            pages=table, cache=cache)
            out.append(lg[0, -1])
    return torch.stack(out)


# --- phase 6: flash kernels against their plain versions -----------------


# kernel vs plain version, flash kernels: the relative Frobenius error
# ||a - b|| / ||b|| of every 64-row tile of each (batch, head) - rows are
# queries for out, lse and dQ, keys for dK and dV - so that a fault confined
# to late tiles (a dropped K/V tile, a shifted lse, a wrong causal skip) is
# held to the size of those tiles' own values, not to the largest value of
# the tensor (which sits in the first rows, where out and dV average over
# few positions). f32 1e-5: both sum in f32, in other orders (observed
# below 1e-6). bf16 2^-7: both round each value to bf16 once, one ulp (at
# most 2^-7 of the value) apart where their f32 sums differ in the last
# bits, and the kernel rounds P against the running row max where the
# plain version uses the final max (observed below 3e-3 for out, lower for
# the gradients). An error of 2% in one tile gives 2e-2. lse is f32 in
# both dtypes.
FLASH_TILE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def flash_tile_err(a, b) -> float:
    """Largest relative Frobenius error over the 64-row tiles of each
    (batch, head): ``[B, L, H, D]`` tensors tile along L, lse ``[B, H, L]``
    along its last dim."""
    import torch.nn.functional as F

    e, r = (a.float() - b.float()).square(), b.float().square()
    if a.dim() == 4:
        e, r = (t.sum(-1).transpose(1, 2) for t in (e, r))
    pad = -e.shape[-1] % 64
    e, r = (F.pad(t, (0, pad)).unflatten(-1, (-1, 64)).sum(-1)
            for t in (e, r))
    return (e / r.clamp_min(1e-30)).sqrt().max().item()


def attended_pairs(Lq, valid, causal) -> int:
    """(query, key) pairs the mask lets through, summed over rows (per
    head): the work the kernels must do on this data."""
    cum = torch.cumsum(valid.double(), dim=1)  # [B, Lk]
    if not causal:
        return int(cum[:, -1].sum().item()) * Lq
    idx = torch.arange(Lq, device=valid.device).clamp(max=valid.shape[1] - 1)
    return int(cum[:, idx].sum().item())


def flash_bounds(q, k, valid, causal):
    """Bound ms and what sets it for (fwd, dq, dkv): bytes each function
    must move (inputs once, outputs once) over 3.35 TB/s, and its products
    (2, 3 and 4 of them, 2 x D operations per attended pair each) over the
    peak for the input type."""
    B, Lq, H, D = q.shape
    el = q.element_size()
    qb = q.numel() * el
    kb = k.numel() * el
    rows = B * H * Lq * 4  # one f32 per (row, head): lse, dsum
    vb = valid.numel() * 4
    pairs = attended_pairs(Lq, valid, causal) * H
    work = {"fwd": (qb + 2 * kb + vb + qb + rows, 2),
            "dq": (2 * qb + 2 * kb + 2 * rows + vb + qb, 3),
            "dkv": (2 * qb + 2 * kb + 2 * rows + vb + 2 * kb, 4)}
    out = {}
    for name, (nbytes, products) in work.items():
        t_b = nbytes / HBM_BYTES_PER_S
        t_o = products * 2 * D * pairs / PEAK_OPS[q.dtype]
        out[name] = (1e3 * max(t_b, t_o),
                     "bytes" if t_b >= t_o else "operations")
    return out


def flash_inputs(g, B, Lq, Lk, D, dtype, pad_rows=0, pad=0, holes=False):
    """Seeded q, k, v, dO and kv_valid: the last ``pad_rows`` rows end in
    ``pad`` padded keys; ``holes`` pads every 7th key of row 0 (from key
    3), so padded keys sit inside tiles."""
    mk = lambda L: torch.randn(B, L, FLASH_H, D, generator=g).to(dtype).cuda()
    q, k, v, do = mk(Lq), mk(Lk), mk(Lk), mk(Lq)
    valid = torch.ones(B, Lk)
    if pad:
        valid[B - pad_rows:, Lk - pad:] = 0
    if holes:
        valid[0, 3::7] = 0
    return q, k, v, do, valid.cuda()


def check_flash(timer, g):
    """The three flash kernels against the plain versions at the listed
    shapes, repeated backwards bit-identical, padded keys' dK/dV zero; then
    times at the training shape over L 128-4096 (B = 16384 / L)."""
    import torch.nn.functional as F

    from kubeml_tpu_torch.ops import flash_attention as fa

    shapes = [  # (tag, B, Lq, Lk, D, causal, rows padded, pad keys, holes)
        ("a train", 8, 2048, 2048, 64, True, 0, 0, False),
        ("b ragged", 2, 2000, 2000, 64, True, 1, 37, False),
        ("c cross", 2, 300, 1000, 64, False, 1, 50, False),
        ("d D128", 4, 1024, 1024, 128, True, 0, 0, False),
        ("e holes D128", 2, 1000, 1100, 128, False, 1, 13, True),
        ("f causal 384x1024", 2, 384, 1024, 64, True, 0, 0, False),
        ("g causal 1000x640", 2, 1000, 640, 64, True, 0, 0, False)]
    errs = {}
    for tag, B, Lq, Lk, D, causal, prow, pad, holes in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, valid = flash_inputs(g, B, Lq, Lk, D, dtype, prow,
                                              pad, holes)
            out, lse = fa._flash_fwd_cuda(q, k, v, valid, causal)
            ro, rl = fa.flash_attention_fwd_ref(q, k, v, valid, causal)
            dsum = fa._dsum(do, ro)
            bwd = lambda: (fa._flash_dq_cuda(q, k, v, valid, rl, do, dsum,
                                             causal),
                           *fa._flash_dkv_cuda(q, k, v, valid, rl, do, dsum,
                                               causal))
            grads, again = bwd(), bwd()
            refs = fa.flash_attention_bwd_ref(q, k, v, valid, ro, rl, do,
                                              causal)
            torch.cuda.synchronize()
            row, tiles = {}, {}
            for name, a, b in [("out", out, ro), ("lse", lse, rl)] + list(
                    zip(("dq", "dk", "dv"), grads, refs)):
                # lse is f32 whatever the input type (no row here is fully
                # masked, so no lse sits at -1e30)
                tol = FLASH_TILE_RTOL[torch.float32 if name == "lse"
                                      else dtype]
                tiles[name] = flash_tile_err(a, b)
                if not tiles[name] <= tol:
                    raise AssertionError(
                        f"flash {tag} {dtype} {name}: relative error "
                        f"{tiles[name]} of a 64-row tile > {tol}")
                row[name] = (a.float() - b.float()).abs().max().item()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"flash {tag} {dtype}: two backward "
                                     f"runs differ")
            dead = valid == 0
            if dead.any() and max(t[dead].abs().max().item()
                                  for t in grads[1:]) != 0.0:
                raise AssertionError(f"flash {tag} {dtype}: padded keys got "
                                     f"non-zero dK/dV")
            errs[(tag, dtype)] = row
            log(f"  flash {tag} B{B} Lq{Lq} Lk{Lk} D{D} "
                f"{'causal' if causal else 'full'} pad {pad}"
                f"{' + holes' if holes else ''} "
                f"{str(dtype).split('.')[-1]}: max abs err "
                + " ".join(f"{n} {e:.2e}" for n, e in row.items())
                + "; worst 64-row tile's relative error "
                + " ".join(f"{n} {e:.2e}" for n, e in tiles.items())
                + f" (tolerance {FLASH_TILE_RTOL[dtype]:.2e}, lse "
                f"{FLASH_TILE_RTOL[torch.float32]:.0e})"
                + "; backward bit-identical on repeat"
                + (f"; {int(dead.sum())} padded keys' dK/dV exactly 0"
                   if dead.any() else ""))
            del q, k, v, do, out, lse, ro, rl, grads, again, refs, dead
    sweep = {}
    # 512-4096 around the training shape; 128 and 256 for the length at
    # which the kernels stop beating the plain path (the dispatch threshold)
    for L in (128, 256, 512, 1024, 2048, 4096):
        B = TRAIN_TOKENS // L
        q, k, v, do, valid = flash_inputs(g, B, L, L, FLASH_D, torch.bfloat16)
        out, lse = fa._flash_fwd_cuda(q, k, v, valid, True)
        dsum = fa._dsum(do, out)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sd_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot_ = do.transpose(1, 2).contiguous()
        row = dict(
            L=L, B=B,
            fwd_ms=timer.ms(lambda: fa._flash_fwd_cuda(q, k, v, valid, True)),
            fwd_plain_ms=timer.ms(lambda: fa.flash_attention_fwd_ref(
                q, k, v, valid, True)),
            fwd_library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            dq_ms=timer.ms(lambda: fa._flash_dq_cuda(q, k, v, valid, lse, do,
                                                     dsum, True)),
            dkv_ms=timer.ms(lambda: fa._flash_dkv_cuda(q, k, v, valid, lse,
                                                       do, dsum, True)),
            bwd_plain_ms=timer.ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, valid, out, lse, do, True)),
            bwd_library_ms=timer.ms(lambda: torch.autograd.grad(
                sd_out, (qt, kt, vt), dot_, retain_graph=True)))
        for name, (ms, by) in flash_bounds(q, k, valid, True).items():
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = ms, by
        # within-call ratios to the library calls (SDPA forward; SDPA's
        # whole backward, dQ + dK + dV, for dK/dV)
        row["fwd_over_library"] = row["fwd_ms"] / row["fwd_library_ms"]
        row["dkv_over_library"] = row["dkv_ms"] / row["bwd_library_ms"]
        log("  flash sweep", json.dumps(row))
        sweep[L] = row
        del q, k, v, do, out, lse, qt, kt, vt, sd_out, dot_
    torch.cuda.empty_cache()
    return errs, sweep


# --- phases 7-8: training -------------------------------------------------

def flash_counts():
    from kubeml_tpu_torch.ops.flash_attention import flash_attention as f

    return f.fwd_launches, f.dq_launches, f.dkv_launches


def reset_flash_counts() -> None:
    from kubeml_tpu_torch.ops.flash_attention import flash_attention as f

    f.fwd_launches = f.dq_launches = f.dkv_launches = 0


def train_run(tag, flash: bool):
    """``run_point`` at the long-context flagship's full width (E 512,
    depth 8, 8 heads, vocab 32000, remat, bf16, AdamW 3e-4), L 2048,
    16,384 tokens a step: one warm-up step and 10 timed steps on one
    batch. Returns the row and the flash launch counts of the run."""
    from kubeml_tpu_torch.benchmarks.longcontext import run_point
    from kubeml_tpu_torch.ops import attention

    attention.FLASH_MIN_KV_LEN = 0 if flash else None
    reset_flash_counts()
    row = run_point(seq_len=2048, tokens_per_step=TRAIN_TOKENS, steps=10,
                    dtype="bf16", repeats=1, device="cuda")
    counts = flash_counts()
    attention.FLASH_MIN_KV_LEN = 0
    torch.cuda.empty_cache()
    log(f"  {tag}: {row['value']:.1f} tokens/s, step {row['step_ms']:.2f} ms"
        f", max memory allocated {row['max_memory_allocated'] / 2**30:.2f} "
        f"GiB, loss step 1 {row['first_loss']:.4f} -> step "
        f"{row['steps_run']} {row['loss']:.4f}; flash launches fwd/dq/dkv "
        f"{counts}")
    if not (np.isfinite(row["loss"]) and row["loss"] < row["first_loss"]):
        raise AssertionError(f"{tag}: loss {row['first_loss']} -> "
                             f"{row['loss']} (must be finite and fall)")
    return row, counts


def train_profile() -> float:
    """A profiler window over 3 kernel-path training steps (after one
    warm-up step); returns the device-busy ms per step."""
    from kubeml_tpu_torch.benchmarks.longcontext import make_trainer

    trainer, tokens = make_trainer(2048, TRAIN_TOKENS, "bf16", device="cuda")
    trainer.train_step(tokens)

    def run():
        for _ in range(3):
            trainer.train_step(tokens)

    busy_ms = device_profile(run, also="flash_") / 3
    del trainer
    torch.cuda.empty_cache()
    return busy_ms


# kernel vs plain f32 training step: the loss within 1e-5 relative (f32
# throughout; the kernels' online softmax and tile order round differently
# from the plain one-pass softmax at ~1e-7 relative); each parameter's
# gradient within 1e-3 of its largest |entry| (those ~1e-7 differences
# pass back through 8 layers and sums over 16,384 positions, and the
# bound is relative to a tensor's largest entry because its small entries
# carry the absolute error of the large ones)
F32_LOSS_RTOL, F32_GRAD_RTOL = 1e-5, 1e-3


def f32_step(flash: bool):
    from kubeml_tpu_torch.benchmarks.longcontext import make_trainer
    from kubeml_tpu_torch.ops import attention

    attention.FLASH_MIN_KV_LEN = 0 if flash else None
    trainer, tokens = make_trainer(2048, TRAIN_TOKENS, "f32", device="cuda")
    loss = float(trainer.train_step(tokens))
    grads = {n: p.grad.detach().clone()
             for n, p in trainer.module.named_parameters()}
    attention.FLASH_MIN_KV_LEN = 0
    del trainer
    torch.cuda.empty_cache()
    return loss, grads


def check_f32_step() -> None:
    reset_flash_counts()
    kl, kg = f32_step(True)
    counts = flash_counts()
    pl_, pg = f32_step(False)
    if counts != (2 * DEPTH, DEPTH, DEPTH):
        raise AssertionError(f"f32 kernel step launched {counts}")
    rel = abs(kl - pl_) / abs(pl_)
    worst = max(((kg[n] - pg[n]).abs().max().item()
                 / max(pg[n].abs().max().item(), 1e-30), n) for n in pg)
    log(f"  f32 step, kernel vs plain: loss {kl:.7f} vs {pl_:.7f} (rel "
        f"{rel:.2e}, tolerance {F32_LOSS_RTOL}); worst gradient "
        f"{worst[1]} at {worst[0]:.2e} of its largest entry (tolerance "
        f"{F32_GRAD_RTOL}); launches fwd/dq/dkv {counts}")
    if not rel <= F32_LOSS_RTOL:
        raise AssertionError(f"f32 loss differs: {kl} vs {pl_}")
    if not worst[0] <= F32_GRAD_RTOL:
        raise AssertionError(f"f32 gradient {worst[1]} differs by "
                             f"{worst[0]} of its scale")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from kubeml_tpu_torch.ops import kernels
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    # 1. device
    smi = nvidia_smi()
    log("[1/9 device]")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.monotonic()
    kernels.library()
    # ptxas -v: "N bytes stack frame, N bytes spill stores, N bytes spill
    # loads" per kernel; report the kernels that do not fit in registers
    lines = kernels.build_log.splitlines()
    spills = [f"{lines[i - 1].split('for ')[-1][:70]}: {ln.strip()}"
              for i, ln in enumerate(lines)
              if re.search(r"[1-9]\d* bytes (stack frame|spill)", ln)]
    log(f"[2/9 build] {time.monotonic() - t0:.2f} s (nvcc "
        f"{kernels.build_seconds:.2f} s), kernels with a stack frame or "
        f"spills: {len(spills)}")
    for ln in spills:
        log(f"  {ln}")
    build_log = kernels.build_log
    if not build_log:  # the library came from an earlier run's build
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            build_log = subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-c",
                 str(kernels.CSRC / "flash_attention.cu"), "-o",
                 f"{tmp}/flash_attention.o"], capture_output=True, text=True,
                check=True).stdout
    check_compiled(kernels.library()._name, build_log)

    # 3. kernels against their plain versions
    log("[3/9 kernels]")
    timer = Timer()
    g = torch.Generator().manual_seed(SEED)
    pa_rows = check_paged_attention(timer, g)
    mm_rows = check_int8_matmul(timer, g)
    del timer

    # 4. serve f32: kernel engine, then the plain (gather) twin
    log("[4/9 serve f32]")
    reqs = workload(np.random.default_rng(SEED))
    model = gpt2_small()
    common = dict(slots=SLOTS, page_tokens=PAGE_TOKENS, chunk_steps=CHUNK,
                  device="cuda")
    dec = PagedBatchingDecoder(model, **common)
    if dec.telemetry()["paged_attn_kernel"] != 1.0:
        raise AssertionError("the f32 engine does not read through the kernel")
    paged_attention.launches = int8_matmul.launches = 0
    run = serve(dec, reqs)
    f32_launches = paged_attention.launches
    report_serve("kernel engine", run)
    profile_window(dec, reqs)
    dec.close()
    steps = run["tele"]["prefill_waves"] + run["tele"]["decode_steps"]
    if f32_launches < model.depth * steps:
        raise AssertionError(f"paged_attention launched {f32_launches} times "
                             f"< depth {model.depth} x {int(steps)} steps")
    log(f"  paged_attention launches {f32_launches} "
        f"(depth {model.depth} x {int(steps)} engine steps)")
    shared = [run["results"][i]["prefix_cached_tokens"] for i in (4, 8, 12)]
    if shared != [64, 64, 64]:
        raise AssertionError(f"shared-prefix requests cached {shared}, "
                             f"expected 64 each")
    plain = PagedBatchingDecoder(model, paged_attn="gather", **common)
    prun = serve(plain, reqs)
    plain.close()
    report_serve("plain (gather) engine", prun)
    got, want = token_lists(run), token_lists(prun)
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"f32 greedy tokens differ from the plain path "
                             f"(request {bad - 1}): {got[bad][:20]} vs "
                             f"{want[bad][:20]}")
    log(f"  greedy tokens identical to the plain path ({run['tokens']} "
        f"tokens, 17 requests incl. calibration)")
    del model

    # 5. serve int8: int8 weights through the kernel, int8 KV pages
    log("[5/9 serve int8]")
    q_kw = dict(quantize="int8", int8_matmul=True, kv_quant="int8", **common)
    qdec = PagedBatchingDecoder(gpt2_small(), **q_kw)
    tele = qdec.telemetry()
    if tele["int8_matmul_kernel"] != 1.0 or tele["paged_attn_kernel"] != 1.0:
        raise AssertionError("the int8 engine does not run both kernels")
    paged_attention.launches = int8_matmul.launches = 0
    qrun = serve(qdec, reqs)
    q_launches = (paged_attention.launches, int8_matmul.launches)
    report_serve("kernel engine", qrun)
    profile_window(qdec, reqs)
    if min(q_launches) <= 0:
        raise AssertionError(f"int8 serving launches {q_launches}")
    log(f"  launches: paged_attention {q_launches[0]}, int8_matmul "
        f"{q_launches[1]}")
    qplain = PagedBatchingDecoder(gpt2_small(), paged_attn="gather",
                                  int8_matmul_impl="dot", **q_kw)
    qprun = serve(qplain, reqs)
    report_serve("plain (gather + dot) engine", qprun)
    got, want = token_lists(qrun), token_lists(qprun)
    same = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
    total = sum(min(len(x), len(y)) for x, y in zip(got, want))
    firsts = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
              for x, y in zip(got, want)]
    diverged = [f for f in firsts if f is not None]
    log(f"  greedy token agreement with the plain path: {same}/{total} = "
        f"{same / total:.4f}; first divergent step: "
        f"{min(diverged) if diverged else 'none'}")
    prompt = reqs[1]["prompt"].tolist()
    forced = qrun["results"][1]["tokens"][0][:4]
    a = teacher_forced_logits(qdec, prompt, forced)
    b = teacher_forced_logits(qplain, prompt, forced)
    tf_err = (a - b).abs().max().item()
    log(f"  teacher-forced logits (prefill + 4 steps): max abs diff "
        f"{tf_err:.3e} (tolerance {TF_ATOL}, logit scale "
        f"{b.abs().max().item():.2f})")
    if not tf_err <= TF_ATOL:
        raise AssertionError(f"int8 teacher-forced logits differ by {tf_err}")
    qdec.close()
    qplain.close()
    del qdec, qplain
    torch.cuda.empty_cache()

    # 6. flash kernels against their plain versions, and the L sweep
    log("[6/9 flash kernels]")
    timer = Timer()
    flash_errs, sweep = check_flash(timer, g)
    del timer

    # 7. train: the kernel path, its profile, then the plain path
    log("[7/9 train bf16]")
    krow, kcounts = train_run("kernel path", flash=True)
    want = (2 * DEPTH * krow["steps_run"], DEPTH * krow["steps_run"],
            DEPTH * krow["steps_run"])
    if kcounts != want:
        raise AssertionError(f"flash launches fwd/dq/dkv {kcounts} != "
                             f"{want} (2 x depth, depth, depth per step)")
    log(f"  launches per step: fwd {kcounts[0] // krow['steps_run']}, dq "
        f"{kcounts[1] // krow['steps_run']}, dkv "
        f"{kcounts[2] // krow['steps_run']} (depth {DEPTH}, remat)")
    busy = train_profile()
    # the profiler slows the host; against the unprofiled step the idle
    # share is the time the card waited on the host in a normal step
    log(f"  device busy {busy:.2f} ms per step, unprofiled step "
        f"{krow['step_ms']:.2f} ms: idle share "
        f"{1 - busy / krow['step_ms']:.3f} of the unprofiled step")
    prow, pcounts = train_run("plain path (FLASH_MIN_KV_LEN = None)",
                              flash=False)
    if pcounts != (0, 0, 0):
        raise AssertionError(f"the plain path launched flash kernels "
                             f"{pcounts}")

    # 8. f32: one step through the kernels against the plain path
    log("[8/9 train f32 parity]")
    check_f32_step()

    # 9. results
    log("[9/9 results]")
    pa = pa_rows[0]   # the decode step: L = 1, f32 arena
    mm = next(r for r in mm_rows if r["M"] == 8 and r["N"] == VOCAB
              and r["x"] == "float32")  # the lm_head at decode
    line = {"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "kubeml_tpu_torch/csrc/paged_attention.cu",
         "replaces": "kubeml_tpu/ops/paged_attention.py:113",
         "launches": f32_launches + q_launches[0],
         "max_abs_err": pa["max_abs_err"], "ms": pa["ms"],
         "plain_ms": pa["plain_ms"], "bound_ms": pa["bound_ms"],
         "bound_by": pa["bound_by"], "library_ms": pa["library_ms"]},
        {"name": "int8_matmul", "route": "cuda",
         "source": "kubeml_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "kubeml_tpu/ops/int8_matmul.py:55",
         "launches": q_launches[1],
         "max_abs_err": mm["max_abs_err"], "ms": mm["ms"],
         "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
         "bound_by": mm["bound_by"], "library_ms": mm["library_ms"]},
    ]}
    # the flash kernels at the training shape (B 8, L 2048, bf16, causal)
    tr = sweep[2048]
    err_a = flash_errs[("a train", torch.bfloat16)]
    for name, line_no, count, err, ms, plain, lib in (
            ("flash_fwd", 120, kcounts[0], err_a["out"], tr["fwd_ms"],
             tr["fwd_plain_ms"], tr["fwd_library_ms"]),
            ("flash_dq", 227, kcounts[1], err_a["dq"], tr["dq_ms"],
             tr["bwd_plain_ms"], tr["bwd_library_ms"]),
            ("flash_dkv", 269, kcounts[2], max(err_a["dk"], err_a["dv"]),
             tr["dkv_ms"], tr["bwd_plain_ms"], tr["bwd_library_ms"])):
        short = name.split("_")[1]
        line["kernels"].append(
            {"name": name, "route": "cuda",
             "source": "kubeml_tpu_torch/csrc/flash_attention.cu",
             "replaces": f"kubeml_tpu/ops/flash_attention.py:{line_no}",
             "launches": count, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": tr[f"{short}_bound_ms"],
             "bound_by": tr[f"{short}_bound_by"], "library_ms": lib})
    log(f"  train bf16 tokens/s: kernel {krow['value']:.1f}, plain "
        f"{prow['value']:.1f}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
