#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA H100): the paged
serving path, the GPT training path, K-AVG training, checkpoints served
through the parameter server, the control plane, the encoders, MoE
with the dense slot engine, the one-shot speculative ``generate`` and the
SPMD job with sharded checkpoints, multi-rank SPMD (two ranks on the
card over gloo), the SPMD job over ranks through the control plane, the
pipeline over ``pp`` ranks, MoE expert parallelism over ``ep`` ranks,
meshed serving over two ranks, K-AVG over two ranks, and standalone job
runners with the preemption monitor.
Run from the repo root::

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device - the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  - every CUDA kernel from ``kubeml_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source), with the build seconds; the four
   Hopper kernels (the bf16 flash forward, dQ and dK/dV, and the int8
   weight matmul) must hold warpgroup products (HGMMA) and TMA loads
   (UTMALDG) in the SASS of every instantiation (``cuobjdump -sass``),
   must not spill, and ptxas must not have serialized their wgmma; the
   paged-attention kernel must hold bulk copies (UBLKCP) or TMA loads in
   every instantiation and must not spill;
3. serving kernels against their plain PyTorch versions at the serving
   path's shapes (GPT-2-small width: H 12, D 64, page_tokens 16, 64-page
   tables, 8 rows; paged attention also at the spec verify's L 2 and 5,
   L 256 at whole-page cursors 256-768 (a prefill chunk), one row at
   position 1023, L 16 and 17, and depths ending mid-page; two launches
   bit-identical; the host time of a decode call; and, error only, at
   other models' head dims (16-128) and pages of 128 and 256 tokens), with
   max abs error, kernel / plain / library times on the card and the bound
   from bytes and operations; the int8 matmul at M 1, 8, 16, 24, 40, 256
   and 2048 over the four GPT-2-small (K, N) in f32 and bf16, with its
   kernel / library ratio and the host time of one call;
4. serve f32 - GPTTiny (head dim 16) through the kernel and the gather
   path, greedy tokens identical; then 16 requests from threads through
   ``PagedBatchingDecoder`` at GPT-2-small width (seeded random weights),
   greedy tokens held identical
   to the same engine reading the arena through the plain gather path, the
   paged-attention launch counter held to the engine's forward count,
   three shared-prefix requests held to 64 cached tokens, and a profile
   window with one paged-attention kernel record per call and no combine
   kernel (in phase 5's window too; a window whose records fall short of
   the calls, as the profiler can drop a record, is run again, at most
   five in all); the tensor maps encoded in the run and in the window, and
   a table that never fills (in phase 5 too);
5. serve int8 - the same requests with int8 weights through the int8
   matmul kernel and int8 KV pages; both launch counters must move, and
   teacher-forced logits (prefill + 4 steps) must match the plain-path
   engine; the profile window prints the int8 matmul's device time per
   forward and must show no split-K reduce kernel and exactly one kernel
   launch per ``int8_matmul`` call (in a window with every record);
6. spec + chunked - the same mix on a coherent-tail GPT-2-small target
   (``benchmarks.spec_decode.coherent_tail``, exit layer 6) through the
   kernel engine: (a) ``spec="self"``, k 4; (b) the same with int8 weights
   through the int8 matmul and int8 KV pages; (c) ``spec="draft"`` with a
   random drafter (E 256, depth 2, 4 heads), adaptive k; (d)
   ``prefill_chunk_tokens=128``, alone and with (a); (e) sampled (a) and
   (d) on the mix's first ``SPEC_E_N`` requests, each run twice. Greedy tokens of a, c and d must equal the spec-off
   monolithic engine's, except where the spec-off path's two largest
   logits at the first differing position lie within ``NEAR_TIE``; (a)
   must emit more than one token a row-step; (c) must floor k at 1 or trip
   ``spec_disabled``; (d) must prefill in chunks; the repeats of (e) must
   be identical; (b)'s teacher-forced spec path (drafter + verify windows)
   must match the int8 spec-off path within ``TF_ATOL``, and a profiled
   window of int8 spec steps must hold one kernel record per call and the
   calls the path implies (12 and 73 a prefill forward, k x 6 + 12 and
   k x 37 + 73 a spec step). Each mode prints tokens/s, TTFT p50, device
   step ms, tokens a row-step, acceptance, prefill chunks and launches;
   then a 896-token prompt arrives while 4 rows decode one token a step,
   monolithic and in 128-token chunks: the rows' longest inter-token gap
   (reported, not gated);
7. flash kernels - forward (out, lse), dQ and dK/dV against their plain
   versions in bf16 and f32 at the training shape (B 8, L 2048, H 8, D 64,
   causal), a ragged causal shape with 37 padded keys, cross attention
   (Lq 300, Lk 1000), D 128, D 128 cross attention with padded keys
   inside tiles (every 7th key of one row), and causal Lq != Lk at full
   (384 x 1024) and ragged (1000 x 640) tiles, and causal 130 x 130 (the
   last 128-query block holds 2 real rows: one consumer warpgroup's rows
   all lie past Lq), each 64-row tile held to a
   relative error (``FLASH_TILE_RTOL``); repeated backwards bit-identical,
   padded keys' dK/dV exactly 0; then kernel / plain / SDPA / bound times
   over L 128-4096 at 16,384 tokens, with kernel / SDPA ratios;
8. train bf16 - ``benchmarks.longcontext.run_point`` at the long-context
   flagship's full width (E 512, depth 8, vocab 32000, remat, AdamW),
   L 2048: one warm-up and 10 timed steps through the kernels (launches
   per step held to fwd 2 x depth, dq and dkv depth; the loss must fall),
   a profiler window over 3 steps, then the same run on the plain path;
9. train f32 - one step through the kernels against the plain path from
   the same weights and batch: loss and every parameter's gradient;
10. K-AVG - (a) the flagship at ``bench.py``'s configuration (ResNet-18,
   CIFAR-10 shapes, bf16, uint8 inputs, B 128, K 8, lr 0.1, SGD momentum
   0.9) through ``benchmarks.harness.FlagshipBench`` at N 1 and N 4 packed
   on the card: round ms, device samples/s (slabs resident, best of 3 x 20
   rounds at N 1, 1 x 10 at N 4), end-to-end samples/s (staged through
   ``RoundPrefetcher``),
   peak memory, a profiler window of 2 rounds (idle share, top kernels),
   FLOPs a sample against the bf16 peak, and a plain PyTorch loop of the
   same 160 SGD steps as the yardstick; (b) f32 with TF32 off and
   deterministic cuDNN, N 4, K 2: the merged weights equal the mean of four
   one-worker rounds, a worker mask averages the other three, and the
   card's round matches the CPU's; (c) ``TrainJob`` (the model a
   registered function) on a banded CIFAR-shaped set in a temporary data
   root, 3 epochs, parallelism 4 -> 2 by ``on_epoch_end``, a checkpoint
   every epoch and the final export: trace [4, 2, 2], falling loss,
   validation accuracy at least ``KAVG_JOB_MIN_ACC``, checkpoints
   ep00000-ep00002 and final; none of the five hand-written kernels may
   launch in this phase;
11. resilience - the phase-6 coherent-tail target, 8 slots, 16-token
   pages, the 16-request mix (``benchmarks.recovery``): (a) int8 weights
   through the int8 matmul, int8 KV pages, ``spec="self"`` (k 4, exit 6),
   every fourth request sampled, a 50 ms pool audit: one fault injected at
   a step's entry once the first token lands; every stream must equal a
   fault-free run of the same configuration, the pool must check clean and
   hold no page after a trie flush, snapshots saved, restored and replayed
   (none failed), no audit failure, and both kernels must launch; (b) f32,
   spec off: drain with grace 0 once a row has 8 tokens, restore every
   KMS1 frame into a fresh decoder: the greedy streams must equal the
   uninterrupted run (``NEAR_TIE`` as in phase 6), paged attention must
   launch; the frame bytes a row, and gather / scatter ms a row of both
   arena storages (CUDA events); (c) a forced pool-audit failure must
   rebuild (one failure, rows replayed) and every stream complete; the
   audit's host time a tick; the wall from the fault to the first
   post-fault emission in (a);
12. checkpoint serving - phase 4's GPT-2-small weights saved as a
   ``final`` checkpoint (Flax layout) in a temporary data root with a
   registered function, then quantized offline into ``final-int8``
   (``quantize_final_checkpoint``); printed: the files' bytes and save
   ms; (a) the 16-request mix from threads through
   ``ParameterServer.generate`` on the card: greedy tokens identical to
   phase 4's hand-built engine (near ties as in phase 6), paged attention
   launches, the request-0 prompt again takes at least its 64-token
   shared prefix from the trie; (c, on a's server) the mix again, drained
   with grace 0 once a row has 8 tokens into the snapshot directory, the
   frames restored by a fresh server (``restore_serving``): every stream
   equals a's (near ties as above); (b) a server with
   ``serving_quantize=int8``, ``kv_quant=int8`` serves ``final-int8``
   through both kernels: its module bit-identical to a hand-built
   ``quantize="int8"`` engine's (q, s and every other tensor, and
   teacher-forced logits on fresh arenas), greedy tokens identical to
   phase 5's hand-built int8 engine but for near ties within
   ``INT8_NEAR_TIE`` (int8 KV page scales follow the page allocation
   history, which the threads' timing decides); (d) 10c's final export through ``ParameterServer.infer``
   equals the job's in-memory ``infer``. Each server prints its cold
   ``_load_serving`` and decoder-build ms, the TTFT of the first request
   on the cold decoder and of a warm one, and the phase's launches;
13. control plane - (a) ``LocalCluster`` on the card, HTTP on port 0,
   driven through ``KubemlClient``: a CIFAR-10-shaped upload (seeded
   random uint8, ``CP_TRAIN`` train and ``CP_TEST`` test samples), a
   ResNet-18 function, and ``/train`` at the flagship's hyperparameters
   (B 128, K 8, lr 0.1, SGD momentum 0.9, bf16), elastic from parallelism
   4, 3 epochs; waits on the job's state (``ParameterServer.wait``), then
   holds one finite train loss an epoch, a trace of legal levels that
   ``/jobs/{id}/decisions`` agrees with, ``/infer`` on the running job
   (paused mid-round, worker 0 already stepped) equal to the merged
   weights of the last round and not to the live replica 0, ``/infer``
   after the finish equal to the job's own ``infer``, and ``/metrics``
   with ``kubeml_job_running_total`` and the training series; (b) phase
   12's ``final`` and ``final-int8`` served through the controller's
   ``/generate`` from threads (half streamed): f32 tokens equal to phase
   12a's (near ties as there), int8 weights bit-identical to 12b's engine
   and tokens equal to 12b's but for near ties within ``INT8_NEAR_TIE``,
   both kernels launching; tokens/s and TTFT p50 over HTTP beside phase
   12's in-process numbers, and the HTTP cost a request; (c) ``python -m
   kubeml_tpu_torch.cli start`` in a subprocess, the mix streamed into
   it, SIGTERM once a row has 8 tokens: exit 0 within the drain grace
   with KMS1 frames left, which a second ``cli start`` restores at boot;
   ``/serving/restored`` lists the rows, whose tokens equal phase 12a's
   uninterrupted run; SIGTERM to exit, boot to the first restored
   emission and a cold ``cli start`` boot;
14. encoders - (a) the flash kernels at the encoders' shapes, ViT-Tiny
   (B 256, L 65, 3 heads) and BERT-base (B 32, L 128, 12 heads, 0-120
   trailing padded keys a row, one row all padding but [CLS]), held as in
   phase 7 in bf16 and f32, with kernel / plain / SDPA / bound ms; (b)
   BERT-base at ``benchmarks.transformers.bench_bert``'s configuration
   but 4 layers deep (``ENC_DEPTH``; bf16, K 4, dropout 0.1) through
   ``KAvgTrainer``: each flash kernel launches depth x K = 16 times a
   round, the loss falls over the ~20
   rounds, samples/s, round ms, peak memory, the idle share of a
   profiled window of 2 rounds, FLOPs a sample against the bf16 peak, and
   the round through the plain path (``FLASH_MIN_KV_LEN = None``) beside
   the kernels'; a round repeated from the same weights and rng is
   bit-identical and another rng moves the weights; [CLS] logits through
   the kernels invariant to the pad length (f32, ``ENC_PAD_ATOL``); one
   f32 round (dropout off) through the kernels against the plain path
   (``ENC_F32_W_RTOL``); (c) ViT-Tiny at ``bench_vit``'s configuration
   but 4 layers deep (B 256, K 8): 32 launches a kernel a round, the loss
   falls, the same
   report; (d) VGG-11, CIFAR-100 shapes, bf16, B 128, K 8, dropout 0.5:
   the loss falls, none of the five kernels launches; (e) ``TrainJob``
   with a registered ViT-Tiny function whose dataset applies
   ``data.transforms``' CIFAR recipes, on a seeded CIFAR-100-shaped set
   (8192 + 1024), 2 epochs at parallelism 2, a checkpoint every epoch:
   the loss falls, the checkpoints exist, the flash kernels launch;
15. MoE and the dense slot engine - (a) the flash kernels at
   ``bench_moe``'s shape (B 16, L 512, 12 heads of 64, causal) held as in
   phase 7 in bf16 and f32, with kernel / plain / SDPA / bound ms; then
   ``bench_moe``'s configuration cut to 4 blocks (``MOE_DEPTH``; the
   GPT-2-small width, vocab 32000, 8 experts, top-2, an MoE block every
   other block, bf16, AdamW 3e-4) trained by ``SPMDTrainer`` over a
   one-device mesh at B 16 x L 512 (``benchmarks.transformers.
   MoEBench``): each flash kernel launches exactly 4 times a step (4
   blocks, no remat), the loss falls, the
   overflow lies in [0, 1]; tokens/s and step ms (best of 3 x 8 steps),
   peak memory, analytic FLOPs a step against the bf16 peak beside the
   useful expert FFNs and the dispatch/combine share, a profiled window
   of 2 steps (idle share, top kernels); (b) those weights' f32 copy
   saved as ``final`` and quantized into ``final-int8``, each served by
   ``ParameterServer.generate`` through the dense ``BatchingDecoder`` (8
   slots; 16 requests from threads, prompts 16-400 tokens, 32-96 new):
   greedy tokens equal to the one-shot dense ``generate`` per request
   but where its two largest logits at the first difference lie within
   ``NEAR_TIE``, and none of the five kernels launches (MoE decode
   attends over a dense cache on the plain path, int8 dequantized in each
   step); (c) phase 4's GPT-2-small weights served with
   ``serving_paged=False`` (the dense engine) through the parameter
   server, on the mix's first ``DENSE_N`` requests: f32 greedy tokens equal to phase 4's paged engine and int8
   (``serving_quantize=int8``, the int8 matmul) tokens equal to a paged
   engine with the same int8 weights and f32 pages, near ties as in
   phase 6; under int8, ``int8_matmul`` launches 73 times a forward and
   paged attention never; seeded sampling (``SAMPLE``) gives the same
   tokens dense and paged; tokens/s, TTFT p50 and decode-step ms of each
   engine in ``benchmarks/paged_serving.py``'s row form;
16. the one-shot speculative ``generate`` and the SPMD job - (a)
   ``make_speculative_generate_fn`` on phase 6's coherent-tail
   GPT-2-small target, ``spec="self"`` at exit 6 and ``spec="draft"``
   with phase 6's drafter, k 4, at B 1 and B 8 (prompts of 64, 64 new
   tokens) with f32 and with int8 weights (the int8 matmul): greedy tokens
   equal to the spec-off ``generate`` but for near ties (``NEAR_TIE``,
   logged with their margin), the acceptance accounting and tokens/s
   against spec-off; paged attention launches exactly depth a prefill
   plus, a step, k drafter forwards at L 1 (``EXIT_LAYER`` blocks, or the
   drafter's depth k + 1 times) and one L 5 verify of depth launches, and
   under int8 the int8 matmul 73 a target forward and 37 a self-drafting
   forward; (b) the long-context flagship (E 512, depth 8, 8 heads, vocab
   32000, L 2048, remat, bf16 compute, AdamW 3e-4) trained through
   ``LocalCluster``'s ``/train`` with ``engine="spmd"``,
   ``sharded_checkpoints`` and ``checkpoint_every=1`` on an uploaded
   seeded ``[40, 2048]`` token set: 2 epochs of 4 steps at B 8, the loss
   falling, each flash kernel as many launches a step as phase 8 (the
   validation forwards counted apart), the step ms beside phase 8's;
   resumed from its sharded checkpoint for a third epoch; its sharded
   final served by ``/generate`` in f32 and, quantized from it into a
   sharded ``final-int8``, in int8, each with greedy tokens equal to an
   in-process ``generate`` on the restored weights (its int8 projections
   through the plain ``int8_dot``) but for near ties, and both serving
   kernels launched; the int8 matmul held against ``int8_dot`` at every
   (K, N) of the flagship's int8 projections and the served M;
17. multi-rank SPMD - two ranks on the one card over gloo (passed
   explicitly; NCCL refuses two ranks on one device), started by
   ``parallel.distributed.spawn`` after the parent built the kernels (the
   ranks load the library and never build it); a failed rank fails the
   script. (a) the flagship's attention (B 8, L 2048, H 8, D 64, causal,
   the last row's last 300 keys padded) in bf16 and f32 through Ulysses
   and the ring over ``sp=2``: the output and dQ/dK/dV gathered over the
   ranks against the one-rank path (the flash kernels; Ulysses equal to it
   within ``MR_SAME_TOL``) and the plain version on the card
   (``MR_ATTN_TOL``), each flash kernel launching once a rank a call
   under Ulysses and never under the ring; (b) the
   long-context flagship (phase 8's configuration at full width cut to 2
   blocks, B 8 x L 2048, bf16, remat, AdamW 3e-4) trained 3 steps over
   ``sp=2`` (Ulysses),
   ``sp=2`` (ring), ``tp=2`` and ``dp=2`` from the weights (seed 0) and
   batch of a one-rank ``SPMDTrainer``: every step's loss within
   ``MR_LOSS_ATOL`` of the one-rank trainer's and equal on both ranks, the
   first step's gradient norm of every parameter within ``MR_GRAD_RTOL``
   of the one-rank trainer's, the parameters each rank holds whole
   bit-equal on both ranks after the last step, flash launches a rank a
   step of 2 x depth, depth and depth (4/2/2) but none under the ring,
   the step's host ms on each rank and the collectives' share of a
   profiled step (``kubeml::`` spans; gloo over host memory, not NVLink).
   No card run covers NCCL, a world above 2 or several cards;
18. the SPMD job over ranks - two ranks share the card over gloo and
   start as ``kubeml start`` starts them: rank 0 runs ``LocalCluster``
   (HTTP on port 0), rank 1 ``engine.follower.run_follower``; the parent
   first runs the one-rank ``SPMDJob`` references from the same seed and
   batches. The model is 16b's flagship at full width cut to
   ``JR_DEPTH`` (2) blocks (Ulysses under sp) on 16b's token set (B 8, 4
   steps an epoch, one eval batch). (a) ``/train`` with
   ``engine="spmd"``, ``tp=2``, 2 epochs, ``sharded_checkpoints``,
   ``checkpoint_every=1``: each epoch's train and eval loss within
   ``MR_LOSS_ATOL`` of the one-rank job's, flash launches a rank a step
   of 2 x depth, depth and depth (4/2/2) with one eval forward an epoch, the sharded final a file a rank (each tp-split leaf a half on
   each rank, every other leaf whole on rank 0, each slice in its owner's
   file only) under a manifest of ``processes`` 2, and the save's bytes
   and ms a rank; (b) the same job id resumed under ``sp=2`` for a third
   epoch: the history spliced exactly, the third loss held against the
   one-rank continuation, the bytes each rank's restore read against the
   checkpoint's size; (c) a ``dp=2`` job whose ``on_epoch_end`` answers
   1, then 2: parallelism ``[2, 1, 2]``, rank 1 launching no flash
   kernel in the ``dp=1`` epoch, the ranks' parameters bit-equal after the
   return, the losses held against a one-rank job whose optimizer restarts
   at the same epochs, each remesh's seconds; (d) rank 0's parameter
   server serves (a)'s 2-shard final through ``/generate`` in f32 and, as
   a sharded ``final-int8``, in int8 (paged attention and the int8
   matmul), with tokens equal to an in-process ``generate`` on the
   assembled weights, as 16b; (e) a live ``/infer`` during (a) answers
   409, a job whose function rank 1 cannot load fails with "could not
   start" without a hang, and the shutdown releases the follower, whose
   process exits 0;
19. the pipeline over ranks - two ranks share the card over gloo, rank 0
   the control plane and rank 1 a follower, as in phase 18; the parent
   first checks the kernels and runs the one-rank reference. (a) the
   three flash kernels on one microbatch of the flagship's attention
   (B 2, L 2048, H 8, D 64, causal) with no valid key, the pipeline's
   fill bubbles, in bf16 and f32: out, dQ, dK and dV exactly 0 like their
   plain versions, lse at most -1e29, no NaN; then ``PipelinedLM`` over
   ``pp=2`` at the flagship's width (E 512, depth 8, vocab 32000, B 8 x L
   2048, 4 microbatches, f32) against its ``reference_apply`` on one
   rank (``PP_LM_TOL``), T x depth / 2 forward launches a rank; (b) the
   flagship (E 512, depth 8, 8 heads, vocab 32000, L 2048, B 8, bf16,
   remat, AdamW 3e-4) as ``PipelinedCausalLM(stages=2, microbatches=4)``
   trained through ``/train`` with ``engine="spmd"``, ``mesh_shape={"pp":
   2}``, ``sharded_checkpoints``, ``checkpoint_every=1`` on 16b's token
   set for 2 epochs: each epoch's train and eval loss within
   ``MR_LOSS_ATOL`` of the one-rank job's (every stage on the card, the
   same seeded weights), the first step's gradient norm of every leaf
   within ``MR_GRAD_RTOL`` of the one-rank job's, flash launches a rank
   exactly as the schedule gives them (T = 5 ticks: 40/20/20 a step
   under remat, 20 an eval batch), the step's host ms a rank and the
   collectives' share of a profiled step; (c) resumed from ``ep00001``
   for a third epoch (held against the one-rank continuation, the
   history spliced exactly), the leaves every rank holds bit-equal on
   both ranks, its 2-file stage-sharded final (each stage's slice in its
   own rank's file) restored through ``flat_serving_remap(2, 4)`` into
   the flat model and served through ``/generate`` in f32 and as a
   sharded ``final-int8``, with tokens equal to an in-process
   ``generate`` on the remapped weights, both serving kernels launched;
20. MoE over ranks - two ranks share the card over gloo, as in phases
   17-19; the parent first checks the kernels and runs the one-rank
   references. (a) the three flash kernels at this phase's attention shape
   (B 16, L 512, 6 heads of 64, causal: a tp=2 rank's heads, and a
   Ulysses rank's) held as in phase 7 in bf16 and f32, with kernel /
   plain / SDPA / bound ms; then ``bench_moe`` at full width cut to
   ``MOE_EP_DEPTH`` (4) blocks (E 768, 12 heads, vocab 32000, 8 experts,
   top-2, capacity 1.25, an MoE block every other block, B 16 x L 512,
   bf16, AdamW 3e-4) trained 3 steps by ``SPMDTrainer`` over ``ep=2``
   (each rank 4 experts),
   and at ``MOE_DEPTH`` over ``dp=2``, ``tp=2`` and ``sp=2`` (Ulysses),
   from the weights, batch and step seeds of a one-rank trainer
   (``MoEBench``): every loss within ``MR_LOSS_ATOL`` of the one-rank
   trainer's and equal on both ranks, the overflow equal on both ranks
   and reported beside the one-rank trainer's, over dp (the card's check
   that capacity and queues read the global batch) the first step's
   within ``MOE_EP_OVER_ATOL0`` of it and every step's within
   ``MOE_EP_OVER_ATOL``, the first step's gradient norm
   of every leaf within ``MR_GRAD_RTOL``, the leaves each rank holds whole
   bit-equal on both ranks after the last step, flash launches exactly
   depth/depth/depth a rank a step (4/4/4), the step's host ms
   a rank and the collectives' share of a profiled step (``kubeml::``
   spans); (b) ``MOE_EP_FN``'s model (``bench_moe`` at ``MOE_DEPTH``)
   through ``/train`` with ``engine="spmd"``, ``mesh_shape={"ep": 2}``,
   ``sharded_checkpoints``, ``checkpoint_every=1`` on a seeded uploaded
   token set at L 512, 2 epochs of 4 steps at B 16 (rank 0 the control
   plane, rank 1 a follower): each epoch's train and eval loss within
   ``MR_LOSS_ATOL`` of the one-rank job's, the ``moe_overflow`` rank 0
   pushes each epoch (reported beside the one-rank job's) on
   ``/metrics``, flash launches a rank as the steps and eval batches
   give them, the 2-file final with each expert stack a half (4 of the 8
   experts) in its owner's file and every other leaf whole in rank 0's,
   the save's bytes and ms a rank; resumed under ``dp=2`` for a third
   epoch, held against the one-rank continuation; the ep-sharded final
   assembled by rank 0's parameter server and served through
   ``/generate`` by the dense engine in f32, with tokens equal to an
   in-process ``generate`` on the assembled weights but for near ties;
21. meshed serving - (a) the int8 matmul at GPT-2-small's tp=2 shard
   shapes (query/key/value (768, 384), proj (384, 768), mlp_in (768,
   1536), mlp_out (1536, 768), the whole lm_head (768, 50257)) at M 1, 8
   and 40 in f32 against ``int8_dot`` (``MM_RTOL``), with kernel (and
   CUPTI) / plain / library / bound ms, measured in phase 3's window and
   reported here; (b) two ranks share the card over gloo: rank 0
   runs the dense ``BatchingDecoder`` over ``serving_mesh({"tp": 2})``
   with GPT-2-small at full width and depth (seeded weights) and phase
   3's 16-request mix (``SM_SAMPLED``'s requests of it sampled with
   ``SAMPLE``, the others greedy; the f32 mix its first ``SM_F32_N``
   requests), rank 1 follows it (``serve_follower``), in f32 and in int8
   through the int8 matmul: greedy tokens equal to one
   rank's dense decoder but for near ties (``NEAR_TIE``), sampled tokens
   equal,
   each rank's launches
   (paged_attention, int8_matmul, flash) exactly (0, 73 x forwards, 0)
   under int8 and none in f32, tokens/s and decode ms a step beside one
   rank's, the collectives' share of the f32 mix's decode steps (host
   clock around the ``kubeml::`` spans); (c) rank 0
   the control plane, rank 1 a follower: phase 18's tp-sharded flagship
   final on ``serving_mesh="tp=2"``, phase 20's ep-sharded MoE final on
   ``tp=2`` and ``ep=2`` through ``/generate``, each with one rank's
   tokens (a parameter server without a mesh) but for near ties and the
   decoder reporting its mesh; ``serving_mesh="tp=4"`` logs and serves on
   one rank;
22. K-AVG over ranks - two ranks share the card over gloo, as in phases
   17-21, each holding its block of the global worker axis
   (``KAvgTrainer(dist=)``: every merge one all-reduce); the parent first
   runs the one-rank references. (a) the flagship at ``bench.py``'s
   configuration (ResNet-18, bf16, uint8 inputs, B 128, K 8, lr 0.1), N 4
   over the ranks (2 workers a rank) through ``FlagshipBench(dist=)``:
   each rank's round ms, device and end-to-end samples/s summed over the
   ranks beside phase 10a's one-rank N 4, and a profiled window of 2
   rounds a rank: the merge all-reduce's ms (``kubeml::kavg_merge``) and
   its share of the round, the device-busy ms and idle share; then 10b's
   f32 round over the ranks (TF32 off, deterministic cuDNN, N 4, K 2, B 16,
   worker 2 masked): the merged weights within ``KR_F32_RTOL`` of each
   leaf's largest entry of one rank's, bit-equal on the ranks and on every
   row; no hand-written kernel launches; (c) ViT-Tiny at phase 14c's
   configuration (depth 4, B 256, K 8, bf16), N 2 over the ranks: each
   flash kernel launches ``ENC_DEPTH x VIT_K`` = 32 times a rank a round
   (one rank's N 2: 64), losses within ``MR_LOSS_ATOL`` and weights within
   ``KR_VIT_W_RTOL`` of each leaf's largest entry of one rank's, bit-equal
   on the ranks; (b) 10c's ResNet-18 function as a K-AVG job through
   ``/train`` (rank 0 ``LocalCluster`` over HTTP, rank 1 the follower
   loop, as ``kubeml start`` runs them), 3 epochs at a requested
   parallelism of 3: rounded to 2 with the history's note, the stubbed
   scheduler's answers 4, 3 (rounded to 2, noted) and 2 give the trace
   [2, 4, 2]; ``/infer`` at each epoch's end answers 409 before the first
   checkpoint and then serves it; each epoch's loss within
   ``MR_LOSS_ATOL`` of a one-rank job fed the same trace; checkpoints
   ep00000-ep00002 and final; the final served by the parameter server
   equals the job's own ``infer``; no hand-written kernel launches;
23. standalone runners and preemption - one ``LocalCluster`` with
   ``standalone_jobs`` and the preemption monitor (JAX's burst thresholds:
   interval 0.2 s, queue depth 3, 429/s 1.0, sustain 2, resume sustain 5,
   cooldown 10 s; 2 serving slots, queue limit 6). (a) phase 22b's
   ResNet-18 function on the banded set, 3 epochs at parallelism 2,
   first threaded in this process (the native library built and every
   round packed by ``kml_pack``: no fallback counted; each epoch's weights
   through the three KMW1 codecs: payload bytes and encode ms, raw and
   delta decoded bit-equal, delta-int8 within the int8 step's half), then
   through ``/train`` in a runner process on the card, held at its second
   epoch's first step (``SA_HOLD``): a live ``/infer`` of the first
   epoch's publish through the PS's tensor socket and its KMW1 wire
   (``tensor_sockets`` off; its tree bit-equal to the socket's), one
   answer a route, and the runner's own JSON ``/infer``, equal
   predictions; its first epoch's losses within ``SA_SAME_RTOL`` of the
   threaded job's, no fallback in the runner's log, non-zero
   ``kubeml_dataplane_bytes_total`` on ``/metrics``; spawn to
   ``LISTENING`` (the PS's record) and ``/train`` to the first epoch; (c)
   phase 12's ``final-int8`` GPT-2-small served by the same parameter
   server (int8 weights through the int8 matmul, int8 KV pages) while the
   held runner waits: phase 3's 16 requests at once (429s retried) preempt
   it exactly once in its second epoch, it parks with 2 epochs in its
   history, is requeued with ``resume=True`` once calm, and a new runner
   restores ``ep00001`` and trains epoch 3, ending with the JAX package's
   ``loss_parity`` against the threaded job; the burst's tokens equal
   phase 12b's but for near ties (``INT8_NEAR_TIE``), both kernels
   launch; overload to the preempt request, the yield histogram from
   ``/metrics``, the time parked (the controller's parked ids polled) and
   the burst's TTFT p50 before and after the reclaim; (b) phase 16b's
   SPMD job at depth ``JR_DEPTH``, threaded and then inside a
   ``JobRunner`` of this process through ``/start``: losses within
   ``MR_SAME_TOL``, flash launches 4/2/2 (fwd/dQ/dK-dV) a step and 2 a
   validation forward, the threaded job's counts, a ``/generate``
   answered while steps remain (its launches those of the same request
   on the threaded job's model); a second job
   preempted through ``/preempt`` after its first epoch ends
   ``preempted`` with a resume checkpoint;
24. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Any failure raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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


# the Hopper kernels: their SASS must hold warpgroup products (HGMMA) and
# TMA loads (UTMALDG), ptxas must not have serialized their wgmma, and they
# must not spill
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                 "flash_dkv_wgmma_kernel", "int8_mm_wgmma_kernel")
# the Hopper kernels on the CUDA cores: their SASS must hold bulk copies
# (UBLKCP) or TMA loads (UTMALDG) in every instantiation, and they must not
# spill
BULK_KERNELS = ("paged_attention_ring_kernel",)
# the paged-attention kernel's name in profiler records, and its launches in
# one GPT-2-small forward (one a layer); the int8 matmul kernel's name
PA_KERNEL, PA_PER_FORWARD = "paged_attention_ring_kernel", 12
MM_KERNEL = "int8_mm_wgmma_kernel"
# launches of int8_matmul in one GPT-2-small forward: 6 projections in each
# of 12 layers and the lm_head
INT8_PER_FORWARD = 73


def check_compiled(so_path: str, build_log: str) -> None:
    """Phase 2's check of the compiled Hopper kernels: HGMMA and UTMALDG in
    the SASS of every instantiation of the wgmma kernels, UBLKCP or UTMALDG
    in every instantiation of the bulk-copy kernels (``cuobjdump -sass`` on
    the built library), registers and spills from ptxas -v, no "wgmma ...
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
    for kname in WGMMA_KERNELS + BULK_KERNELS:
        bodies = [f for f in funcs if kname in f.split("\n", 1)[0]]
        info = [p for n, p in props.items() if kname in n]
        hgmma = [f.count("HGMMA") for f in bodies]
        utma = [f.count("UTMALDG") for f in bodies]
        ublk = [f.count("UBLKCP") for f in bodies]
        log(f"  {kname}: {len(bodies)} instantiations, HGMMA per "
            f"instantiation {hgmma}, UTMALDG {utma}, UBLKCP {ublk}, "
            f"registers {[p.get('registers') for p in info]}, spill bytes "
            f"{[p.get('spill') for p in info]}")
        if not bodies:
            raise AssertionError(f"{kname}: not in the SASS")
        if kname in WGMMA_KERNELS:
            if min(hgmma) == 0:
                raise AssertionError(f"{kname}: no HGMMA in its SASS")
            if min(utma) == 0:
                raise AssertionError(f"{kname}: no UTMALDG in its SASS")
        elif min(t + u for t, u in zip(utma, ublk)) == 0:
            raise AssertionError(f"{kname}: an instantiation without TMA "
                                 f"or bulk copies")
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

# paged attention at the main path's shapes (tag, L, positions): the decode
# step at mixed depths, spec-verify at k 4 and k 1 (L 5 and 2), prefill, a
# 256-token prefill chunk at whole-page cursors; one row at the last position
# (the cluster's ranks split all 64 pages); L 16 and 17 (the decode
# mapping's 7-query tiles, then one query more); L 3 at depths that end
# mid-page
PA_CASES = [("decode", 1, [0, 15, 16, 100, 333, 511, 777, 1023]),
            ("verify", 5, [0, 3, 60, 200, 500, 800, 1010, 1018]),
            ("verify k1", 2, [0, 14, 15, 130, 407, 640, 999, 1021]),
            ("chunk", 256, [256, 512, 768]),
            ("prefill", 128, [0, 16, 128, 256, 384, 512, 640, 896]),
            ("B1 pos 1023", 1, [1023]),
            ("L16", 16, [0, 5, 31, 100, 250, 600, 900, 1000]),
            ("L17", 17, [0, 6, 32, 99, 251, 601, 899, 1001]),
            ("mid-page", 3, [4, 37, 70, 103, 136, 401, 700, 1009])]
# paged attention at the head dims and page sizes of other models (D, page
# tokens, arena dtype): GPTTiny's D 16 (padded to 64), D 32, 80 and 96
# (padded to 128), D 20 (40- and 20-byte rows, which TMA cannot address,
# copied value by value), pages of 128 and 256 tokens (slabs of a page)
PA_SHAPES = [(16, 16, torch.float32), (16, 16, torch.int8),
             (32, 16, torch.bfloat16), (80, 32, torch.bfloat16),
             (96, 16, torch.float32), (20, 16, torch.bfloat16),
             (20, 16, torch.int8), (128, 128, torch.float32),
             (128, 256, torch.float32)]
# int8 matmul (M, K, N): decode M 1 and 8, the spec verify of 8 rows at
# k 1, 2 and 4 (M 16, 24, 40), prefill 256 and 2048, over the four
# GPT-2-small projections (K, N)
MM_SHAPES = [(M, K, N) for M in (1, 8, 16, 24, 40, 256, 2048)
             for K, N in ((768, 768), (768, 3072), (3072, 768), (768, VOCAB))]


def paged_inputs(g, L, positions, kv_dtype, heads=H, dim=D, pt=PAGE_TOKENS,
                 table=P, n_pages=N_PAGES):
    """q, arenas (+ scales), a table of distinct pages per row; one row per
    position. GPT-2-small's serving shapes unless given."""
    B = len(positions)
    q_dtype = torch.float32 if kv_dtype == torch.int8 else kv_dtype
    q = torch.randn(B, L, heads, dim, generator=g).to(q_dtype).cuda()
    kf = torch.randn(n_pages, pt, heads, dim, generator=g)
    vf = torch.randn(n_pages, pt, heads, dim, generator=g)
    pages = (torch.randperm(n_pages - 1, generator=g)[:B * table] + 1
             ).reshape(B, table).to(torch.int32).cuda()
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

    rows = []
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        for tag, L, positions in PA_CASES:
            Bc = len(positions)
            q, kp, vp, pages, pos, scales = paged_inputs(g, L, positions,
                                                         kv_dtype)
            out = paged_attention(q, kp, vp, pages, pos, **scales)
            again = paged_attention(q, kp, vp, pages, pos, **scales)
            ref = paged_attention_ref(q, kp, vp, pages, pos, **scales)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= PA_TOL[kv_dtype]:
                raise AssertionError(f"paged_attention {kv_dtype} {tag} "
                                     f"L={L}: max abs err {err} > "
                                     f"{PA_TOL[kv_dtype]}")
            if not torch.equal(out, again):
                raise AssertionError(f"paged_attention {kv_dtype} {tag}: "
                                     f"two launches differ")
            # yardstick: SDPA over the pre-gathered K/V (gather not timed)
            idx = pages.long()
            if scales:
                kgat = (kp[idx].float() * (scales["k_scale"][idx] / 127.0)
                        [:, :, None, :, None]).to(q.dtype)
                vgat = (vp[idx].float() * (scales["v_scale"][idx] / 127.0)
                        [:, :, None, :, None]).to(q.dtype)
            else:
                kgat, vgat = kp[idx], vp[idx]
            kgat = kgat.reshape(Bc, P * PAGE_TOKENS, H, D).transpose(1, 2) \
                .contiguous()
            vgat = vgat.reshape(Bc, P * PAGE_TOKENS, H, D).transpose(1, 2) \
                .contiguous()
            qt = q.transpose(1, 2).contiguous()
            k_pos = torch.arange(P * PAGE_TOKENS, device="cuda")
            q_pos = pos.long()[:, None] + torch.arange(L, device="cuda")
            mask = (k_pos[None, None, None, :] <= q_pos[:, None, :, None])
            call = lambda: paged_attention(q, kp, vp, pages, pos,  # noqa
                                           **scales)
            row = dict(
                kv=str(kv_dtype).split(".")[-1], case=tag, B=Bc, L=L,
                max_abs_err=err, ms=timer.ms(call),
                plain_ms=timer.ms(lambda: paged_attention_ref(
                    q, kp, vp, pages, pos, **scales)),
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kgat, vgat, attn_mask=mask)))
            row["bound_ms"], row["bound_by"] = paged_bound_ms(q, kp, pages,
                                                              pos, scales)
            row["profiler_ms"] = profiler_ms(timer, call, PA_KERNEL)
            if tag == "decode" and kv_dtype == torch.float32:
                row["host_us"] = host_us(call)
            log("  paged_attention", json.dumps(row))
            rows.append(row)
    # poisoned arenas: every position no live row wrote (trash page 0,
    # unallocated pages, slots past each row's cursor) poisoned; the output
    # must be bit-identical
    for kv_dtype in (torch.float32, torch.int8):
        _, L, positions = PA_CASES[0]
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
    # other head dims and page sizes: 3 rows (one past its table), 4 heads,
    # 384 positions a row, decode and tile-mapping L
    for dim, pt, kv_dtype in PA_SHAPES:
        table = 384 // pt
        errs = []
        for L in (1, 40):
            positions = [0, 384 - L - 5, 384 + 3]
            q, kp, vp, pages, pos, scales = paged_inputs(
                g, L, positions, kv_dtype, heads=4, dim=dim, pt=pt,
                table=table, n_pages=3 * table + 1)
            out = paged_attention(q, kp, vp, pages, pos, **scales)
            ref = paged_attention_ref(q, kp, vp, pages, pos, **scales)
            torch.cuda.synchronize()
            errs.append((out.float() - ref.float()).abs().max().item())
        log(f"  paged_attention D {dim}, {pt}-token pages, "
            f"{str(kv_dtype).split('.')[-1]}: max abs err L 1 / 40 "
            f"{errs[0]:.2e} / {errs[1]:.2e}")
        if not max(errs) <= PA_TOL[kv_dtype]:
            raise AssertionError(f"paged_attention D {dim} pt {pt} "
                                 f"{kv_dtype}: max abs err {max(errs)}")
    return rows


def profiler_ms(timer, fn, kernel: str, iters: int = 10):
    """Mean device time of ``fn``'s kernel (records whose name holds
    ``kernel``) from the profiler, each launch after the Timer's L2 flush:
    the kernel alone, without the launch gap and any host work that the
    Timer's events can enclose. The mean is over the records the profiler
    kept; None when it kept none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in recs)
    return sum(e.self_device_time_total for e in recs) / 1e3 / n if n else None


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call: ``calls`` calls enqueued back to back (the
    launch queue does not fill), then one synchronize outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def mm_weights(g, K, N):
    """int8 weights [K, N] and f32 column scales [1, N]."""
    q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).cuda()
    return q, (torch.rand(1, N, generator=g) * 0.02).cuda()


def check_int8_matmul(timer, g, shapes=MM_SHAPES,
                      dtypes=(torch.float32, torch.bfloat16), tag="",
                      profiled: bool = False):
    """The int8 matmul at the serving path's shapes (default MM_SHAPES: M
    1 and 8 (decode), 256 and 2048 (prefill) over the four GPT-2-small
    (K, N)), f32 and bf16 x, against int8_dot within MM_RTOL, repeated
    calls bit-identical; kernel, plain, library and bound ms a shape
    (with ``profiled``, the kernel's CUPTI time too: ``profiler_ms``)."""
    from kubeml_tpu_torch.ops.int8_matmul import int8_dot, int8_matmul

    rows = []
    for M, K, N in shapes:
        q, s = mm_weights(g, K, N)
        for xd in dtypes:
            x = torch.randn(M, K, generator=g).to(xd).cuda()
            y = int8_matmul(x, q, s)
            again = int8_matmul(x, q, s)
            ref = int8_dot(x, q, s)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= MM_RTOL[xd] * scale:
                raise AssertionError(
                    f"int8_matmul M={M} K={K} N={N} {xd}: max abs err "
                    f"{err} > {MM_RTOL[xd]} x {scale}")
            if not torch.equal(y, again):
                raise AssertionError(f"int8_matmul M={M} K={K} N={N} "
                                     f"{xd}: two calls differ")
            del y, again, ref
            nbytes = (x.numel() * x.element_size() + q.numel()
                      + s.numel() * 4 + M * N * x.element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S
            # the kernel's route: products on the bf16 tensor cores,
            # f32 x as three bf16 terms
            terms = 3 if xd == torch.float32 else 1
            t_ops = terms * 2 * M * N * K / PEAK_OPS[torch.bfloat16]
            row = dict(
                M=M, K=K, N=N, x=str(xd).split(".")[-1],
                max_abs_err=err,
                ms=timer.ms(lambda: int8_matmul(x, q, s)),
                plain_ms=timer.ms(lambda: int8_dot(x, q, s)),
                library_ms=timer.ms(
                    lambda: torch.matmul(x, q.to(x.dtype)) * s),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["over_library"] = row["ms"] / row["library_ms"]
            if profiled:
                row["profiler_ms"] = profiler_ms(
                    timer, lambda: int8_matmul(x, q, s), MM_KERNEL)
            if M == 8 and N == VOCAB:
                row["host_us"] = host_us(lambda: int8_matmul(x, q, s))
            log(f"  {tag}int8_matmul", json.dumps(row))
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


def serve(dec, reqs, sample=False, n=16):
    """Drive ``dec`` through the workload (its first ``n`` requests). First
    a calibration request (the eos request's prompt, 16 tokens) picks the
    eos id as its 10th token; then every request is submitted from its own
    thread, except that
    sharers 2-4 wait for sharer 1's first token (its prefill registers the
    shared pages). Greedy, or ``sample``d with ``SAMPLE``'s knobs and
    request i seeded 1000 + i (the calibration 1016): every request, or
    those whose index ``sample`` holds when it is a tuple. Returns
    per-request results and timings."""
    from kubeml_tpu_torch.api import GenerateRequest

    def knobs(i):
        sampled = sample is True or (isinstance(sample, tuple)
                                     and i in sample)
        return dict(SAMPLE, seed=1000 + i) if sampled else {}

    calib = dec.wait(dec.submit(GenerateRequest(
        prompts=[reqs[5]["prompt"].tolist()], max_new_tokens=16,
        **knobs(16))), timeout=600)
    eos = calib["tokens"][0][9]
    results, entries, errors = [None] * n, [None] * n, []
    first_sharer = threading.Event()

    def client(i):
        try:
            if i in (4, 8, 12):
                first_sharer.wait(600)
            r = reqs[i]
            entries[i] = dec.submit(GenerateRequest(
                prompts=[r["prompt"].tolist()], max_new_tokens=r["max_new"],
                eos_id=eos if i == 5 else None, **knobs(i)))
            if i == 0:
                while entries[0].first_token_at == 0.0:
                    time.sleep(0.001)
                first_sharer.set()
            results[i] = dec.wait(entries[i], timeout=600)
        except Exception as e:  # surfaced below, after the join
            errors.append(e)
            first_sharer.set()

    steps = time_steps(dec)
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    del dec._decode_chunk, dec._spec_step
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
                decode_step_ms=1e3 * steps["seconds"]
                / max(steps["steps"], 1),
                steps=steps, tele=tele)


def time_steps(dec):
    """Time ``dec``'s decode chunks and spec steps from here on: the wall
    of each call (it ends in the tokens' copy to the host), the device
    steps (a chunk's size, one a spec step) and the row-steps (steps x
    decoding rows). Returns the dict the wrappers fill; ``del
    dec._decode_chunk, dec._spec_step`` removes them."""
    acc = {"seconds": 0.0, "steps": 0, "row_steps": 0}
    if not hasattr(dec, "_spec_step"):  # the dense engine
        dec._spec_step = None

    def timed(fn, steps_of):
        def call(arg):
            rows = len(dec._decode_rows())
            t0 = time.monotonic()
            fn(arg)
            acc["seconds"] += time.monotonic() - t0
            acc["steps"] += steps_of(arg)
            acc["row_steps"] += steps_of(arg) * rows
        return call

    dec._decode_chunk = timed(dec._decode_chunk, lambda size: size)
    if dec._spec_step is not None:
        dec._spec_step = timed(dec._spec_step, lambda k: 1)
    return acc


def token_lists(run):
    return [run["calib"]] + [r["tokens"][0][:r["lengths"][0]]
                             for r in run["results"]]


def report_serve(tag, run) -> None:
    t = run["tele"]
    log(f"  {tag}: {run['tokens']} tokens in {run['wall']:.3f} s = "
        f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50_ms']:.1f} ms, decode step "
        f"{run['decode_step_ms']:.3f} ms ({run['steps']['steps']} steps, "
        f"{int(t['admission_waves'])} prefill waves)")


def device_profile(run, also: str = ""):
    """Where the time goes: a torch.profiler window around ``run()``.
    Prints the window's wall, the device-busy time (the sum of kernel
    times: one stream, so kernels do not overlap; user annotations such as
    ``Optimizer.step`` span kernels already counted and are left out), the
    idle share, and the five kernels with the most device time, then any
    other kernel whose name holds ``also``. Returns the busy ms (0.0 when
    the profiler saw no device time) and the (ms, launches, name) of every
    kernel."""
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
        return 0.0, kernels
    log(f"  profile: window {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(kernels, reverse=True)
    for i, (ms, count, name) in enumerate(ranked):
        if i < 5 or (also and also in name):
            log(f"    {100 * ms / busy_ms:5.1f}% {ms:8.2f} ms x{count:<6} "
                f"{name[:90]}")
    return busy_ms, kernels


def profile_window(dec, reqs, also: str = ""):
    """A profiler window over 8 concurrent requests (32 new tokens each)
    on the serving engine ``dec``; returns ``device_profile``'s result."""
    from kubeml_tpu_torch.api import GenerateRequest

    def run():
        entries = [dec.submit(GenerateRequest(
            prompts=[r["prompt"].tolist()], max_new_tokens=32))
            for r in reqs[:8]]
        for e in entries:
            dec.wait(e, timeout=600)

    return device_profile(run, also)


def int8_profile(busy_ms, kernels, launches) -> None:
    """The int8 engine's profile window (one with every record, see
    ``paged_window``): the int8 matmul's device time per forward, no split-K
    reduce kernel, and exactly one kernel launch per ``int8_matmul`` call
    (``launches`` calls counted in the window)."""
    mm = [(ms, n) for ms, n, name in kernels if MM_KERNEL in name]
    split = [name for _, _, name in kernels if "splitk_reduce_kernel" in name]
    mm_ms, mm_count = sum(m for m, _ in mm), sum(n for _, n in mm)
    log(f"  int8 window: device busy {busy_ms:.2f} ms; {MM_KERNEL} "
        f"{mm_ms:.2f} ms over {mm_count} recorded launches for {launches} "
        f"int8_matmul calls ({launches / INT8_PER_FORWARD:.1f} forwards): "
        f"{mm_ms / max(mm_count, 1) * INT8_PER_FORWARD:.4f} ms per forward; "
        f"split-K reduce kernels: {len(split)}")
    if busy_ms <= 0:
        return
    if split or mm_count != launches:
        raise AssertionError(f"int8 window: {mm_count} kernel launches for "
                             f"{launches} calls, reduce kernels {split}")


def paged_window(dec, reqs, tag, also=""):
    """A serving window (``profile_window``) in which the profiler kept a
    record of every kernel the gates count: one paged-attention kernel
    record per ``paged_attention`` call and one int8 matmul record per
    ``int8_matmul`` call, and no combine kernel. The profiler can drop a
    few records of a long window (a drop in one kernel says nothing of the
    other's), so a window whose records fall short of the calls is run
    again, at most five windows in all; more records than calls, or a
    combine kernel, fails at once. Returns the window's busy ms, kernels,
    (paged_attention, int8_matmul) calls and the window's change of the
    engine's step counters (prefill waves, decode and spec steps, prefill
    chunks)."""
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    for attempt in range(5):
        before = dec.telemetry()
        paged_attention.launches = int8_matmul.launches = 0
        busy_ms, kernels = profile_window(dec, reqs, also)
        calls = (paged_attention.launches, int8_matmul.launches)
        after = dec.telemetry()
        pa = sum(n for _, n, name in kernels if PA_KERNEL in name)
        mm = sum(n for _, n, name in kernels if MM_KERNEL in name)
        pa_ms = sum(ms for ms, _, name in kernels if PA_KERNEL in name)
        combine = [name for _, _, name in kernels if "combine" in name]
        log(f"  {tag} window {attempt + 1}: {PA_KERNEL} {pa} records for "
            f"{calls[0]} paged_attention calls, {pa_ms:.3f} ms, "
            f"{pa_ms / max(pa, 1) * PA_PER_FORWARD:.4f} ms per forward "
            f"({100 * pa_ms / max(busy_ms, 1e-9):.1f} % of busy); "
            f"{MM_KERNEL} {mm} records for {calls[1]} int8_matmul calls; "
            f"combine kernels {len(combine)}")
        if combine or pa > calls[0] or mm > calls[1]:
            raise AssertionError(f"{tag} window: {pa} paged-attention and "
                                 f"{mm} int8 kernel records for {calls} "
                                 f"calls, combine kernels {combine}")
        if busy_ms <= 0 or (pa, mm) == calls:
            delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
                     for k in ("admission_waves", "device_steps",
                               "spec_steps", "prefill_chunks")}
            return busy_ms, kernels, calls, delta
    raise AssertionError(f"{tag} window: kernel records fell short of the "
                         f"calls in five windows")


def serve_tiny() -> None:
    """GPTTiny (embed 64, 4 heads: D 16, which the kernel pads to 64)
    through the kernel engine and the gather engine: greedy tokens
    identical."""
    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.models import GPTTiny
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    model = GPTTiny(vocab_size=1000, max_len=128, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, 1000, size=n).tolist() for n in (3, 17, 40, 9)]
    runs = {}
    for impl in ("cuda", "gather"):
        dec = PagedBatchingDecoder(model, slots=4, chunk_steps=4,
                                   page_tokens=PAGE_TOKENS, paged_attn=impl,
                                   device="cuda")
        entries = [dec.submit(GenerateRequest(prompts=[p], max_new_tokens=12))
                   for p in prompts]
        runs[impl] = [dec.wait(e, timeout=300)["tokens"][0][:12]
                      for e in entries]
        dec.close()
    if runs["cuda"] != runs["gather"]:
        raise AssertionError(f"GPTTiny greedy tokens differ from the plain "
                             f"path: {runs}")
    log(f"  GPTTiny (D 16): greedy tokens identical to the plain path "
        f"({4 * 12} tokens)")


def map_report(tag, before, after, window) -> None:
    """The kernel's tensor-map table over a serving phase (``map_stats``
    before the run, after it, after the profile window): no call may find
    the table full (a churning table encodes on the host-bound step)."""
    log(f"  {tag} tensor maps: {after['encoded'] - before['encoded']} "
        f"encoded in the run, {window['encoded'] - after['encoded']} in the "
        f"profile window; {window['held']} held; table emptied "
        f"{window['cleared'] - before['cleared']} times")
    if window["cleared"] != before["cleared"]:
        raise AssertionError(f"{tag}: the tensor-map table filled up")


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


# --- phase 6: speculative decoding and chunked prefill -------------------

# self-drafting at GPT-2-small width: k 4 drafts a step from the first 6 of
# the 12 blocks, against a coherent-tail target (benchmarks.spec_decode:
# the blocks past the exit scaled toward identity, so the drafter agrees
# with the target as a trained model's would); the draft backend's random
# drafter (E 256, depth 2, 4 heads: D 64) on the same vocabulary; prefill
# chunks of 128 tokens (8 pages)
SPEC_K, EXIT_LAYER, PREFILL_CHUNK = 4, 6, 128
DRAFT = dict(embed_dim=256, depth=2, num_heads=4)
# the sampled modes: temperature 0.8, top-k 50 (request i seeded 1000 + i)
SAMPLE = dict(temperature=0.8, top_k=50)
# greedy tokens of a spec or chunked engine against the spec-off monolithic
# engine: a divergence passes only where the spec-off path's two largest
# logits at the first differing position lie within NEAR_TIE (the verify
# scores k+1 positions in one forward and a chunk attends in query tiles:
# the same f32 sums in other orders, ~1e-6 apart)
NEAR_TIE = 1e-5
# 6e's sampled repeats run the mix's first SPEC_E_N requests (cut from 16
# to make room for phase 23)
SPEC_E_N = 8
# the long-prompt probe: 4 rows of 32-token prompts decode one token a step
# while a 896-token prompt prefills, monolithic or in chunks
ITL_SHORT, ITL_LONG, ITL_NEW = 32, 896, 160


def spec_step_launches(k: int):
    """(paged_attention, int8_matmul) launches of one self-drafting spec
    step at k drafts: k drafter forwards through EXIT_LAYER blocks (6
    projections a block and the lm_head), then the verify forward."""
    return (k * EXIT_LAYER + PA_PER_FORWARD,
            k * (6 * EXIT_LAYER + 1) + INT8_PER_FORWARD)


def tokens_a_row_step(run) -> float:
    """Decode tokens a row emitted per device step (each of the 17 rows
    emits its first token at prefill; a spec step emits 1 to k+1)."""
    t = run["tele"]
    rows = len(run["results"]) + 1
    return (t["tokens_emitted"] - rows) / max(run["steps"]["row_steps"], 1)


def report_mode(tag, run, smi, launches) -> None:
    t = run["tele"]
    log(f"  {tag} [{smi}]: {run['tokens']} tokens, "
        f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50_ms']:.1f} ms, device step "
        f"{run['decode_step_ms']:.3f} ms ({run['steps']['steps']} steps), "
        f"{tokens_a_row_step(run):.3f} tokens a row-step, acceptance "
        f"{t.get('spec_accept_rate', 'n/a')}, spec_k {t.get('spec_k', '-')}"
        f", spec_disabled {t.get('spec_disabled', '-')}, prefill chunks "
        f"{int(t['prefill_chunks'])}; launches paged_attention "
        f"{launches[0]}, int8_matmul {launches[1]}")


def check_tokens(tag, run, ref, ref_dec, reqs) -> None:
    """Greedy tokens of ``run`` against the spec-off monolithic ``ref``:
    identical, but for a divergence where ``ref_dec``'s path, teacher-forced
    to the first differing position, has its two largest logits within
    NEAR_TIE (logged with its request and position)."""
    want = token_lists(ref)
    ties = check_greedy(tag, token_lists(run), want,
                        [reqs[5]["prompt"]] + [r["prompt"] for r in reqs],
                        ref_dec, first=-1)
    log(f"  {tag}: greedy tokens identical to the spec-off monolithic "
        f"engine ({sum(map(len, want))} tokens; near ties {ties or 'none'})")


def check_greedy(tag, got, want, prompts, ref_dec, first=0,
                 against="the spec-off engine", tie=NEAR_TIE):
    """Greedy token lists ``got`` against ``want``, request by request
    (numbered from ``first``): identical, or diverging only where
    ``ref_dec``'s path teacher-forced to the first differing position has
    its two largest logits within ``tie``. Returns the near ties."""
    ties = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((n for n, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            raise AssertionError(f"{tag}: request {i + first} emitted "
                                 f"{len(g)} tokens, {against} {len(w)}")
        top = teacher_forced_logits(ref_dec, prompts[i].tolist(),
                                    w[:j])[-1].topk(2).values
        gap = (top[0] - top[1]).item()
        log(f"  {tag}: request {i + first} differs at token {j} ({g[j]} vs "
            f"{w[j]}); reference top-two logit gap {gap:.3e}")
        if not gap <= tie:
            raise AssertionError(f"{tag}: greedy tokens differ from "
                                 f"{against} (request {i + first}, token "
                                 f"{j}, logit gap {gap:.3e} > {tie})")
        ties.append((i + first, j))
    return ties


def teacher_forced_spec_logits(dec, prompt, forced):
    """The spec path teacher-forced on ``dec``'s module, arena storage and
    read path: prefill ``prompt``, then windows of SPEC_K + 1 forced tokens
    - the self-drafter feeds the window's first SPEC_K tokens one at a time
    (writing layers < EXIT_LAYER), then the verify scores all SPEC_K + 1 in
    one forward. Logits [1 + windows x (SPEC_K + 1), vocab], the rows of
    ``teacher_forced_logits`` they stand for."""
    from kubeml_tpu_torch.models.generation import init_paged_cache

    dev = dec.device
    n = -(-(len(prompt) + len(forced)) // PAGE_TOKENS)
    cache = init_paged_cache(dec.module, n + 1, PAGE_TOKENS, dec.kv_quant,
                             dec.paged_attn)
    table = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None]

    def at(p):
        return torch.tensor([p], dtype=torch.int32, device=dev)

    with torch.inference_mode():
        out = [dec.module(torch.tensor(prompt, device=dev)[None],
                          decode=True, positions=at(0), pages=table,
                          cache=cache)[0, -1]]
        p = 0
        while p + SPEC_K + 1 <= len(forced):
            win = forced[p:p + SPEC_K + 1]
            base = len(prompt) + p
            for i in range(SPEC_K):
                dec.module(torch.tensor([[win[i]]], device=dev), decode=True,
                           positions=at(base + i), pages=table, cache=cache,
                           exit_layer=EXIT_LAYER)
            out.extend(dec.module(torch.tensor([win], device=dev),
                                  decode=True, positions=at(base),
                                  pages=table, cache=cache)[0])
            p += SPEC_K + 1
    return torch.stack(out)


def itl_probe(model, chunk: int):
    """Four rows decode one token a step (chunk_steps 1, streamed) while a
    896-token prompt arrives: the longest gap between two tokens of those
    rows while it prefills (from its submit to its first token) against
    their median gap before it; the head-of-line stall the engine charged
    them; the prefill chunks."""
    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    dec = PagedBatchingDecoder(model, slots=SLOTS, page_tokens=PAGE_TOKENS,
                               chunk_steps=1, prefill_chunk_tokens=chunk,
                               device="cuda")
    rng = np.random.default_rng(SEED + 7)
    entries = [dec.submit(GenerateRequest(
        prompts=[rng.integers(1, VOCAB, size=ITL_SHORT).tolist()],
        max_new_tokens=ITL_NEW, stream=True)) for _ in range(4)]
    stamps = [[] for _ in entries]

    def reader(i):
        for item in dec.stream(entries[i]):
            if "tokens" in item:
                stamps[i].append(time.monotonic())

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    while any(e.first_token_at == 0.0 for e in entries):
        time.sleep(0.001)
    time.sleep(0.1)
    t0 = time.monotonic()
    long_e = dec.submit(GenerateRequest(
        prompts=[rng.integers(1, VOCAB, size=ITL_LONG).tolist()],
        max_new_tokens=4))
    dec.wait(long_e, timeout=600)
    t1 = long_e.first_token_at
    for t in threads:
        t.join(600)
    tele = dec.telemetry()
    dec.close()
    gaps = [(a, b - a) for st in stamps for a, b in zip(st, st[1:])]
    during = [g for a, g in gaps if a + g >= t0 and a <= t1]
    before = sorted(g for a, g in gaps if a + g < t0)
    return (1e3 * max(during), 1e3 * before[len(before) // 2],
            tele["hol_stall_seconds"], int(tele["prefill_chunks"]))


def spec_phase(smi):
    """Phase 6: the 16-request mix at GPT-2-small width through the kernel
    engine with speculative decoding and chunked prefill (modes a-e, see
    the module docstring). Returns the (paged_attention, int8_matmul)
    launches of its serving runs."""
    from kubeml_tpu_torch.benchmarks.spec_decode import coherent_tail
    from kubeml_tpu_torch.models import CausalTransformer
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    reqs = workload(np.random.default_rng(SEED))
    target = coherent_tail(gpt2_small(), EXIT_LAYER)
    common = dict(slots=SLOTS, page_tokens=PAGE_TOKENS, chunk_steps=CHUNK,
                  device="cuda")
    selfspec = dict(spec="self", spec_k=SPEC_K, spec_exit_layer=EXIT_LAYER,
                    spec_adaptive=False)
    total = [0, 0]

    def mode(tag, model, sample=False, n=16, **kw):
        dec = PagedBatchingDecoder(model, **common, **kw)
        if dec.telemetry()["paged_attn_kernel"] != 1.0:
            raise AssertionError(f"{tag}: the engine does not read through "
                                 f"the kernel")
        paged_attention.launches = int8_matmul.launches = 0
        run = serve(dec, reqs, sample, n=n)
        launches = (paged_attention.launches, int8_matmul.launches)
        dec.close()
        total[0] += launches[0]
        total[1] += launches[1]
        report_mode(tag, run, smi, launches)
        if launches[0] <= 0:
            raise AssertionError(f"{tag}: paged attention never launched")
        return run, dec

    log(f"  coherent-tail GPT-2-small target (blocks {EXIT_LAYER}-11 "
        f"scaled by 0.02), k {SPEC_K}, exit layer {EXIT_LAYER}, prefill "
        f"chunk {PREFILL_CHUNK}")
    ref, ref_dec = mode("spec off, monolithic", target)
    a, _ = mode("a spec=self", target, **selfspec)
    check_tokens("a", a, ref, ref_dec, reqs)
    if not tokens_a_row_step(a) > 1.0:
        raise AssertionError(f"a: {tokens_a_row_step(a):.3f} tokens a "
                             f"row-step, not above 1.0")
    drafter = CausalTransformer(vocab_size=VOCAB, max_len=MAX_LEN,
                                attn_bias=True, ln_eps=1e-5, seed=SEED + 1,
                                device="cuda", **DRAFT)
    c, _ = mode("c spec=draft", target, spec="draft", spec_k=SPEC_K,
                draft_module=drafter)
    check_tokens("c", c, ref, ref_dec, reqs)
    ct = c["tele"]
    if not (ct.get("spec_k") == 1.0 or ct.get("spec_disabled") == 1.0):
        raise AssertionError(f"c: the random drafter neither floored k at 1 "
                             f"nor tripped spec_disabled: {ct.get('spec_k')}"
                             f", {ct.get('spec_disabled')}")
    d1, _ = mode("d chunked", target, prefill_chunk_tokens=PREFILL_CHUNK)
    check_tokens("d chunked", d1, ref, ref_dec, reqs)
    d2, _ = mode("d chunked + spec=self", target,
                 prefill_chunk_tokens=PREFILL_CHUNK, **selfspec)
    check_tokens("d chunked + spec=self", d2, ref, ref_dec, reqs)
    for tag, run in (("d chunked", d1), ("d chunked + spec=self", d2)):
        if run["tele"]["prefill_chunks"] <= 0:
            raise AssertionError(f"{tag}: no prompt prefilled in chunks")
    for tag, kw in (("a", selfspec),
                    ("d", dict(prefill_chunk_tokens=PREFILL_CHUNK))):
        e1, _ = mode(f"e sampled {tag}", target, sample=True, n=SPEC_E_N,
                     **kw)
        e2, _ = mode(f"e sampled {tag}, again", target, sample=True,
                     n=SPEC_E_N, **kw)
        if token_lists(e1) != token_lists(e2):
            raise AssertionError(f"e: sampled {tag} did not reproduce")
        log(f"  e sampled {tag}: the repeat is token-identical "
            f"({e1['tokens']} tokens)")

    # b: int8 weights through the int8 matmul and int8 KV pages, the
    # spec-off engine first (it quantizes the copy; the spec engine reuses
    # its int8 weights)
    q_kw = dict(quantize="int8", int8_matmul=True, kv_quant="int8")
    qmodel = copy.deepcopy(target)
    qref, qref_dec = mode("b int8, spec off", qmodel, **q_kw)
    b, b_dec = mode("b int8 spec=self", qmodel, **q_kw, **selfspec)
    if min(b["tele"]["spec_steps"], int8_matmul.launches) <= 0:
        raise AssertionError("b: no spec step or no int8 matmul launch")
    got, want = token_lists(b), token_lists(qref)
    same = sum(x == y for g, w in zip(got, want) for x, y in zip(g, w))
    log(f"  b: greedy token agreement with the int8 spec-off engine "
        f"{same}/{sum(map(len, want))}")
    prompt = reqs[1]["prompt"].tolist()
    forced = b["results"][1]["tokens"][0][:2 * (SPEC_K + 1)]
    sl = teacher_forced_spec_logits(b_dec, prompt, forced)
    pl = teacher_forced_logits(qref_dec, prompt, forced)[:len(sl)]
    err = (sl - pl).abs().max().item()
    log(f"  b: teacher-forced logits, spec path (drafter + verify windows) "
        f"vs the int8 spec-off path: max abs diff {err:.3e} over "
        f"{len(sl)} positions (tolerance {TF_ATOL})")
    if not err <= TF_ATOL:
        raise AssertionError(f"b: teacher-forced logits differ by {err}")
    # one kernel record per call in a profiled window of spec steps, and
    # the calls the path implies: 12 and 73 a prefill forward, §3's count
    # a spec step
    qdec = PagedBatchingDecoder(qmodel, **common, **q_kw, **selfspec)
    _, kernels, calls, delta = paged_window(qdec, reqs, "int8 spec",
                                            also="int8")
    qdec.close()
    per_step = spec_step_launches(SPEC_K)
    want_calls = tuple(int(f * delta["admission_waves"]
                           + s * delta["spec_steps"])
                       for f, s in zip((PA_PER_FORWARD, INT8_PER_FORWARD),
                                       per_step))
    log(f"  int8 spec window: {int(delta['spec_steps'])} spec steps, "
        f"{int(delta['admission_waves'])} prefill forwards; calls {calls}, "
        f"by the path's count {want_calls} ({per_step} a spec step)")
    if delta["device_steps"] != delta["spec_steps"] or calls != want_calls:
        raise AssertionError(f"int8 spec window: calls {calls} != "
                             f"{want_calls}")
    del qmodel, b_dec, qref_dec
    torch.cuda.empty_cache()

    mono = itl_probe(target, 0)
    chunked = itl_probe(target, PREFILL_CHUNK)
    for tag, (gap, base, hol, chunks) in (("monolithic", mono),
                                          ("chunked", chunked)):
        log(f"  long prompt ({ITL_LONG} tokens) while 4 rows decode, {tag} "
            f"[{smi}]: longest inter-token gap {gap:.2f} ms (median before "
            f"it {base:.2f} ms), head-of-line stall charged "
            f"{hol:.4f} row-s, prefill chunks {chunks}")
    return tuple(total)


# --- phase 7: flash kernels against their plain versions -----------------


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


def _tile_sq(t):
    """Squared Frobenius norms of the 64-row tiles of each (batch, head):
    ``[B, L, H, D]`` tensors tile along L, lse ``[B, H, L]`` along its
    last dim."""
    import torch.nn.functional as F

    t = t.float().square()
    if t.dim() == 4:
        t = t.sum(-1).transpose(1, 2)
    return F.pad(t, (0, -t.shape[-1] % 64)).unflatten(-1, (-1, 64)).sum(-1)


def flash_tile_err(a, b, floor=None):
    """Largest relative Frobenius error ||a - b|| / ||b|| over the 64-row
    tiles, and the number of tiles held instead to ``floor`` (a bound of
    the rounding error, in ``a``'s shape): a tile whose reference lies
    within its floor is exactly 0 but for rounding, and passes when the
    kernel's tile lies within the floor too."""
    e, r = _tile_sq(a - b.float()), _tile_sq(b)
    rel = (e / r.clamp_min(1e-30)).sqrt()
    if floor is None:
        return rel.max().item(), 0
    f = _tile_sq(floor)
    zero = (r <= f) & (_tile_sq(a) <= f)
    return rel.where(~zero, torch.zeros_like(rel)).max().item(), int(
        zero.sum())


# dQ and dK where dS cancels: dS = P (dP - dsum) scale is 0 in exact
# arithmetic for a query that attends one key (its softmax has no
# gradient; BERT's rows padded to [CLS] alone, a causal row 0), so both
# versions return the rounding of dP - dsum, O(1) apart relatively. Each
# dP and dsum is a D-term f32 sum of exact bf16 products: its error is at
# most gamma_D = D u / (1 - D u) times the sum of |terms|, with u = 2^-23
# (twice f32's unit roundoff, a margin for the tensor cores' accumulation
# order), and twice that covers both sums. The floor of dQ is then
# 2 gamma_D scale sum_k P |dO|.(|V_k| + |O|) |K_k|; of dK the same with
# |Q_q|. A tile is held to it only where the relative check fails.
def cancellation_floors(q, k, v, do, out, lse, valid, causal):
    from kubeml_tpu_torch.ops import flash_attention as fa

    D = q.shape[-1]
    u = 2.0 ** -23
    gamma = 2 * D * u / (1 - D * u)
    p = fa._probs(fa._masked_scores(q, k, valid, causal), lse[..., None])
    ado, av, aq, ak = (t.float().abs() for t in (do, v, q, k))
    terms = (torch.einsum("bqhd,bkhd->bhqk", ado, av)
             + (ado * out.float().abs()).sum(-1).transpose(1, 2)[..., None])
    ds = gamma * fa._scale(D) * p * terms
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, ak),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds, aq)}


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


def flash_inputs(g, B, Lq, Lk, D, dtype, pad_rows=0, pad=0, holes=False,
                 heads=FLASH_H):
    """Seeded q, k, v, dO and kv_valid: the last ``pad_rows`` rows end in
    ``pad`` padded keys; ``holes`` pads every 7th key of row 0 (from key
    3), so padded keys sit inside tiles."""
    mk = lambda L: torch.randn(B, L, heads, D, generator=g).to(dtype).cuda()
    q, k, v, do = mk(Lq), mk(Lk), mk(Lk), mk(Lq)
    valid = torch.ones(B, Lk)
    if pad:
        valid[B - pad_rows:, Lk - pad:] = 0
    if holes:
        valid[0, 3::7] = 0
    return q, k, v, do, valid.cuda()


def check_flash_case(tag, q, k, v, do, valid, causal):
    """The three flash kernels against their plain versions on one input:
    each 64-row tile within ``FLASH_TILE_RTOL``, repeated backwards
    bit-identical, padded keys' dK/dV exactly 0. Returns the max abs
    error of out, lse, dq, dk and dv."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    dtype = q.dtype
    out, lse = fa._flash_fwd_cuda(q, k, v, valid, causal)
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, valid, causal)
    dsum = fa._dsum(do, ro)
    bwd = lambda: (fa._flash_dq_cuda(q, k, v, valid, rl, do, dsum, causal),
                   *fa._flash_dkv_cuda(q, k, v, valid, rl, do, dsum, causal))
    grads, again = bwd(), bwd()
    refs = fa.flash_attention_bwd_ref(q, k, v, valid, ro, rl, do, causal)
    torch.cuda.synchronize()
    row, tiles, zero, floors = {}, {}, 0, None
    for name, a, b in [("out", out, ro), ("lse", lse, rl)] + list(
            zip(("dq", "dk", "dv"), grads, refs)):
        # lse is f32 whatever the input type (no row here is fully masked,
        # so no lse sits at -1e30)
        tol = FLASH_TILE_RTOL[torch.float32 if name == "lse" else dtype]
        tiles[name], _ = flash_tile_err(a, b)
        if not tiles[name] <= tol and name in ("dq", "dk"):
            if floors is None:
                floors = cancellation_floors(q, k, v, do, ro, rl, valid,
                                             causal)
            tiles[name], n = flash_tile_err(a, b, floors[name])
            zero += n
        if not tiles[name] <= tol:
            raise AssertionError(
                f"flash {tag} {dtype} {name}: relative error "
                f"{tiles[name]} of a 64-row tile > {tol}")
        row[name] = (a.float() - b.float()).abs().max().item()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"flash {tag} {dtype}: two backward runs "
                             f"differ")
    dead = valid == 0
    if dead.any() and max(t[dead].abs().max().item()
                          for t in grads[1:]) != 0.0:
        raise AssertionError(f"flash {tag} {dtype}: padded keys got "
                             f"non-zero dK/dV")
    B, Lq, H, D = q.shape
    log(f"  flash {tag} B{B} Lq{Lq} Lk{k.shape[1]} H{H} D{D} "
        f"{'causal' if causal else 'full'} "
        f"{str(dtype).split('.')[-1]}: max abs err "
        + " ".join(f"{n} {e:.2e}" for n, e in row.items())
        + "; worst 64-row tile's relative error "
        + " ".join(f"{n} {e:.2e}" for n, e in tiles.items())
        + f" (tolerance {FLASH_TILE_RTOL[dtype]:.2e}, lse "
        f"{FLASH_TILE_RTOL[torch.float32]:.0e})"
        + "; backward bit-identical on repeat"
        + (f"; {int(dead.sum())} padded keys' dK/dV exactly 0"
           if dead.any() else "")
        + (f"; {zero} dQ/dK tiles 0 but for rounding, within their floor"
           if zero else ""))
    return row


def flash_times(timer, q, k, v, do, valid, causal) -> dict:
    """Kernel, plain and library (SDPA) ms of the forward, dQ and dK/dV on
    one input, with each function's bound and what sets it, and the
    kernel / library ratios (SDPA's forward; SDPA's whole backward, dQ + dK
    + dV, for dQ and for dK/dV). SDPA takes the padding as a boolean mask
    where a key is padded."""
    import torch.nn.functional as F

    from kubeml_tpu_torch.ops import flash_attention as fa

    out, lse = fa._flash_fwd_cuda(q, k, v, valid, causal)
    dsum = fa._dsum(do, out)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = (None if bool(valid.all()) else
            valid[:, None, None, :].bool().expand(-1, 1, q.shape[1], -1))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal)
    sd_out = sdpa()
    dot_ = do.transpose(1, 2).contiguous()
    row = dict(
        fwd_ms=timer.ms(lambda: fa._flash_fwd_cuda(q, k, v, valid, causal)),
        fwd_plain_ms=timer.ms(lambda: fa.flash_attention_fwd_ref(
            q, k, v, valid, causal)),
        fwd_library_ms=timer.ms(sdpa),
        dq_ms=timer.ms(lambda: fa._flash_dq_cuda(q, k, v, valid, lse, do,
                                                 dsum, causal)),
        dkv_ms=timer.ms(lambda: fa._flash_dkv_cuda(q, k, v, valid, lse, do,
                                                   dsum, causal)),
        bwd_plain_ms=timer.ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, valid, out, lse, do, causal)),
        bwd_library_ms=timer.ms(lambda: torch.autograd.grad(
            sd_out, (qt, kt, vt), dot_, retain_graph=True)))
    for name, (ms, by) in flash_bounds(q, k, valid, causal).items():
        row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = ms, by
    row["fwd_over_library"] = row["fwd_ms"] / row["fwd_library_ms"]
    row["dq_over_library"] = row["dq_ms"] / row["bwd_library_ms"]
    row["dkv_over_library"] = row["dkv_ms"] / row["bwd_library_ms"]
    return row


def check_flash(timer, g):
    """The three flash kernels against the plain versions at the listed
    shapes, repeated backwards bit-identical, padded keys' dK/dV zero; then
    times at the training shape over L 128-4096 (B = 16384 / L)."""
    shapes = [  # (tag, B, Lq, Lk, D, causal, rows padded, pad keys, holes)
        ("a train", 8, 2048, 2048, 64, True, 0, 0, False),
        ("b ragged", 2, 2000, 2000, 64, True, 1, 37, False),
        ("c cross", 2, 300, 1000, 64, False, 1, 50, False),
        ("d D128", 4, 1024, 1024, 128, True, 0, 0, False),
        ("e holes D128", 2, 1000, 1100, 128, False, 1, 13, True),
        ("f causal 384x1024", 2, 384, 1024, 64, True, 0, 0, False),
        ("g causal 1000x640", 2, 1000, 640, 64, True, 0, 0, False),
        ("h causal 130x130", 2, 130, 130, 64, True, 1, 13, False)]
    errs = {}
    for tag, B, Lq, Lk, D, causal, prow, pad, holes in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, valid = flash_inputs(g, B, Lq, Lk, D, dtype, prow,
                                              pad, holes)
            errs[(tag, dtype)] = check_flash_case(tag, q, k, v, do, valid,
                                                  causal)
            del q, k, v, do, valid
    sweep = {}
    # 512-4096 around the training shape; 128 and 256 for the length at
    # which the kernels stop beating the plain path (the dispatch threshold)
    for L in (128, 256, 512, 1024, 2048, 4096):
        B = TRAIN_TOKENS // L
        q, k, v, do, valid = flash_inputs(g, B, L, L, FLASH_D, torch.bfloat16)
        row = dict(L=L, B=B, **flash_times(timer, q, k, v, do, valid, True))
        log("  flash sweep", json.dumps(row))
        sweep[L] = row
        del q, k, v, do, valid
    torch.cuda.empty_cache()
    return errs, sweep


# --- phases 8-9: training -------------------------------------------------

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

    busy_ms = device_profile(run, also="flash_")[0] / 3
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


# --- phase 10: K-AVG -------------------------------------------------------

# bench.py's flagship configuration (kubeml_tpu/benchmarks/harness.py
# flagship, bench.py main): ResNet-18 for CIFAR-10, bf16, uint8 inputs,
# B 128, K 8, lr 0.1, SGD with momentum 0.9; 20 rounds x 3 reps
# (the learning rate is benchmarks.harness.LR)
KAVG_B, KAVG_K, KAVG_ROUNDS, KAVG_REPS = 128, 8, 20, 3
# 10b: four workers in one round against four one-worker rounds on the same
# slabs (the same code under deterministic cuDNN, so each worker's weights
# are the same bits; the mean of each set is then formed in the same
# order): 1e-6 absolute. The card's f32 round against the CPU's: the loss
# within 1e-3 relative (observed 7.5e-6), and the weights' difference (L2
# over the whole tree) within 5e-2 of the round's change of the weights
# (L2). The round is ill-conditioned in its BatchNorm biases (a bias
# followed by another BatchNorm gets a gradient that nearly cancels): the
# CPU alone, one thread against eight, moves it by 1.8e-2 of its change
# and one bias by 13 % of its value; the card against the CPU, 1.1e-2 (H100
# 80GB HBM3 at 700 W and its host's CPU)
KAVG_MERGE_ATOL, KAVG_CPU_LOSS_RTOL, KAVG_CPU_W_RTOL = 1e-6, 1e-3, 5e-2
# 10c: validation accuracy after 3 epochs on the banded set, in % (chance
# is 10 %)
KAVG_JOB_MIN_ACC = 50.0
BAND_COLOURS = ((255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
                (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255),
                (255, 255, 255), (0, 0, 0))


def kernel_counts():
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    return (paged_attention.launches, int8_matmul.launches) + flash_counts()


def reset_kernel_counts() -> None:
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    paged_attention.launches = int8_matmul.launches = 0
    reset_flash_counts()


def kavg_flagship(n_workers: int, smi: str, plain_sps=None,
                  reps: int = KAVG_REPS, rounds: int = KAVG_ROUNDS):
    """10a: the flagship at bench.py's configuration with ``n_workers``
    packed on the card (best of ``reps`` runs of ``rounds`` rounds, device
    and end to end): round ms, device and end-to-end samples/s, peak
    memory, a profiler window of 2 rounds, the FLOPs per sample against the
    bf16 peak; the plain loop's samples/s (measured at N 1, passed in
    after). Returns the row and the plain loop's samples/s."""
    from kubeml_tpu_torch.benchmarks.harness import FlagshipBench

    bench = FlagshipBench(n_workers, KAVG_B, KAVG_K, device="cuda")
    row = bench.measure(rounds, reps)
    steps = KAVG_ROUNDS * KAVG_K
    if plain_sps is None:
        plain_sps = bench.plain_loop(steps)
    tag = f"N {n_workers}"
    log(f"  {tag}: round {row['round_ms']:.3f} ms ({n_workers} x {KAVG_K} "
        f"steps of B {KAVG_B}); device {row['value']:.1f} samples/s (slabs "
        f"resident, best of {reps} x {rounds} rounds); end-to-end "
        f"{row['end_to_end']:.1f} samples/s (staged through "
        f"RoundPrefetcher); max memory allocated "
        f"{row['max_memory_allocated'] / 2**30:.3f} GiB; loss "
        f"{row['first_loss']:.4f} -> {row['loss']:.4f} [{smi}]")
    log(f"  {tag}: plain PyTorch loop of {steps} SGD steps of one model "
        f"(no averaging): {plain_sps:.1f} samples/s; K-AVG device / plain "
        f"{row['value'] / plain_sps:.3f} [{smi}]")
    flops = row["train_flops_per_sample"]
    achieved = flops * row["value"]
    log(f"  {tag}: {flops / 1e9:.4f} GFLOP a training sample (convs and "
        f"dense layers, from their shapes; forward x 3): "
        f"{achieved / 1e12:.2f} TFLOP/s = "
        f"{achieved / PEAK_OPS[torch.bfloat16]:.4f} of the bf16 dense peak "
        f"(989 TFLOP/s) [{smi}]")
    busy = device_profile(lambda: [bench.round() for _ in range(2)])[0]
    if busy > 0:
        log(f"  {tag}: device busy {busy / 2:.3f} ms a round, unprofiled "
            f"round {row['round_ms']:.3f} ms: idle share "
            f"{1 - busy / (2 * row['round_ms']):.3f} of the unprofiled round")
    if not (np.isfinite(row["first_loss"]) and np.isfinite(row["loss"])):
        raise AssertionError(f"{tag}: flagship losses {row['first_loss']} "
                             f"-> {row['loss']}")
    del bench
    torch.cuda.empty_cache()
    return row, plain_sps


def _flat(tree):
    return {f"{c}/{k}": a for c, d in tree.items() for k, a in d.items()}


def _mean_of(flat):
    """The leafwise mean of flat numpy trees, summed in list order."""
    out = {}
    for name in flat[0]:
        acc = flat[0][name].astype(np.float32)
        for f in flat[1:]:
            acc = acc + f[name]
        out[name] = acc / np.float32(len(flat))
    return out


def _worst_abs(a, b):
    return max((float(np.abs(a[k] - b[k]).max()), k) for k in b)


def _l2(a, b=None):
    return float(np.sqrt(sum(float(np.sum(np.square(
        a[k].astype(np.float64) - (0.0 if b is None else b[k]))))
        for k in a)))


def kavg_correctness(device: str = "cuda", batch: int = 16, n: int = 4,
                     k: int = 2) -> None:
    """10b: ResNet-18 in f32 (TF32 off, deterministic cuDNN), N 4, K 2: the
    merged weights against the mean of four one-worker rounds on the same
    slabs, a worker mask dropping one worker against the mean of the other
    three, and the card's round against the CPU's."""
    from kubeml_tpu_torch.benchmarks.harness import LR, make_synthetic_model
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.models.resnet import ResNet18

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        r = np.random.default_rng(1)
        x = r.normal(size=(n, k, batch, 32, 32, 3)).astype(np.float32)
        y = r.integers(0, 10, size=(n, k, batch)).astype(np.int64)
        m = np.ones((n, k, batch), np.float32)

        def trainer(dev):
            return KAvgTrainer(make_synthetic_model(ResNet18(num_classes=10)),
                               precision="f32", device=dev)

        t = trainer(device)
        ref = t.reference_variables(t.init_variables(0, x[0, 0], 1))

        def run(tr, rows, worker_mask=None):
            v = tr.place_reference(ref, len(rows))
            v, loss = tr.sync_round(v, x[rows], y[rows], m[rows], lr=LR,
                                    worker_mask=worker_mask)
            return _flat(tr.reference_variables(v)), float(loss)

        merged, loss4 = run(t, list(range(n)))
        solos = [run(t, [w])[0] for w in range(n)]
        err = _worst_abs(merged, _mean_of(solos))
        dropped, _ = run(t, list(range(n)),
                         np.array([1, 1, 0, 1], np.float32))
        err_drop = _worst_abs(dropped, _mean_of([solos[0], solos[1],
                                                 solos[3]]))
        cpu, loss_cpu = run(trainer("cpu"), list(range(n)))
        w_rel = _l2(merged, cpu) / _l2(cpu, _flat(ref))
        loss_rel = abs(loss4 - loss_cpu) / abs(loss_cpu)
        leaf = max((float(np.abs(merged[k_] - cpu[k_]).max())
                    / max(float(np.abs(cpu[k_]).max()), 1e-30), k_)
                   for k_ in cpu)
        log(f"  f32 N {n} K {k} B {batch}: merged vs mean of {n} one-worker "
            f"rounds: max abs {err[0]:.2e} ({err[1]}; tolerance "
            f"{KAVG_MERGE_ATOL}); worker 2 masked vs mean of workers 0, 1, "
            f"3: {err_drop[0]:.2e} ({err_drop[1]})")
        log(f"  f32 round, {device} vs cpu: |weights difference| / |round's "
            f"change| {w_rel:.2e}, loss {loss4:.6f} vs {loss_cpu:.6f} (rel "
            f"{loss_rel:.2e}; tolerances {KAVG_CPU_W_RTOL}, "
            f"{KAVG_CPU_LOSS_RTOL}); worst leaf "
            f"by its own scale: {leaf[1]} at {leaf[0]:.2e} of its largest "
            f"entry")
        if not err[0] <= KAVG_MERGE_ATOL:
            raise AssertionError(f"merged weights differ from the mean of "
                                 f"the workers by {err}")
        if not err_drop[0] <= KAVG_MERGE_ATOL:
            raise AssertionError(f"the worker mask's average differs by "
                                 f"{err_drop}")
        if not (w_rel <= KAVG_CPU_W_RTOL and loss_rel <= KAVG_CPU_LOSS_RTOL):
            raise AssertionError(f"card vs cpu round: weights {w_rel}, loss "
                                 f"{loss_rel}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def banded_images(n: int, seed: int):
    """A learnable CIFAR-shaped set: uint8 noise in [0, 128) with a band of
    three rows in the class's colour at the class's place."""
    r = np.random.default_rng(seed)
    y = r.integers(0, 10, size=n).astype(np.int64)
    x = r.integers(0, 128, size=(n, 32, 32, 3)).astype(np.uint8)
    for c, colour in enumerate(BAND_COLOURS):
        x[y == c, 3 * c:3 * c + 3] = colour
    return x, y


# 10c's model as a registered function (phase 12d serves its final export
# through the parameter server, which loads the model by name)
BANDS_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.resnet import BasicBlock, ResNet
from kubeml_tpu_torch.runtime.model import KubeModel


class Bands(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("bands"))

    def build(self):
        return ResNet([2, 2, 2, 2], BasicBlock, num_classes=10,
                      num_filters=%d, dtype=torch.bfloat16)

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)

    def preprocess(self, x):
        return x.to(torch.bfloat16) / 127.5 - 1.0
"""
KAVG_JOB = "kavg-smoke"


def kavg_job(root, device: str = "cuda", num_filters: int = 64,
             n_train: int = 4096, n_test: int = 1024, epochs: int = 3):
    """10c: ``TrainJob`` end to end: ResNet-18 (bf16, uint8 inputs; the
    registered function ``bands``) on the banded set from a ``ShardStore``
    under the data root ``root``, 3 epochs at ``default_parallelism`` 4, an
    ``on_epoch_end`` policy moving it to 2, a checkpoint every epoch and the
    final export. Returns the history and the job."""
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = Config(data_root=root)
    cfg.ensure_dirs()
    registry = FunctionRegistry(config=cfg)
    registry.create("bands", BANDS_FN % num_filters)
    store = ShardStore(root=cfg.datasets_dir)
    store.create("bands", *banded_images(n_train, 2),
                 *banded_images(n_test, 3))
    req = TrainRequest(
        model_type="resnet18", batch_size=64, epochs=epochs,
        dataset="bands", lr=0.05, function_name="bands",
        # the set is easy: no goal-accuracy stop before the 3 epochs
        options=TrainOptions(default_parallelism=4, k=4, precision="bf16",
                             goal_accuracy=101.0, checkpoint_every=1,
                             save_model=True))
    ckpts = CheckpointStore(config=cfg)
    job = TrainJob(KAVG_JOB, req, registry.load("bands"), store=store,
                   history_store=HistoryStore(root=cfg.history_path),
                   checkpoint_store=ckpts,
                   on_epoch_end=lambda s: 2 if s.parallelism == 4
                   else s.parallelism, device=device)
    hist = job.train()
    log(f"  TrainJob: parallelism {hist.parallelism}, train loss "
        f"{[round(v, 4) for v in hist.train_loss]}, validation accuracy "
        f"{[round(v, 2) for v in hist.accuracy]} %, epoch s "
        f"{[round(v, 3) for v in hist.epoch_duration]}; checkpoints "
        f"{ckpts.tags(KAVG_JOB)}")
    if hist.parallelism != [4, 2, 2][:epochs]:
        raise AssertionError(f"parallelism trace {hist.parallelism}")
    if not hist.train_loss[-1] < hist.train_loss[0]:
        raise AssertionError(f"train loss did not fall: {hist.train_loss}")
    if not hist.accuracy[-1] >= KAVG_JOB_MIN_ACC:
        raise AssertionError(f"validation accuracy {hist.accuracy[-1]} % < "
                             f"{KAVG_JOB_MIN_ACC} %")
    if ckpts.tags(KAVG_JOB) != [f"ep{e:05d}" for e in range(epochs)] + [
            "final"]:
        raise AssertionError(f"checkpoints {ckpts.tags(KAVG_JOB)}")
    return hist, job


# --- phase 11: serving resilience ------------------------------------------

# fault recovery runs every fourth request sampled (SAMPLE's knobs, request
# i seeded 1000 + i); drain snapshots once a row has emitted DRAIN_AFTER
# tokens; the forced audit failure serves the first AUDIT_REQUESTS requests
# with the audit every AUDIT_INTERVAL seconds
DRAIN_AFTER, AUDIT_REQUESTS, AUDIT_INTERVAL = 8, 8, 0.01


def storm_specs(reqs, sampled: bool):
    """The 16-request mix as ``benchmarks.recovery`` storm specs (no eos)."""
    return [{"prompt": r["prompt"], "max_new": r["max_new"],
             "temp": (SAMPLE["temperature"] if sampled and i % 4 == 2
                      else 0.0),
             "top_k": SAMPLE["top_k"], "seed": 1000 + i}
            for i, r in enumerate(reqs)]


def wait_for_tokens(dec, n: int) -> None:
    """Block until a resident row of ``dec`` has emitted ``n`` tokens."""
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline:
        if any(r is not None and len(r.out) >= n for r in dec._slot_rows):
            return
        time.sleep(0.002)
    raise AssertionError(f"no row emitted {n} tokens within 600 s")


def snapshot_copy_ms(module, kv_quant: str, npages: int):
    """CUDA-event ms of gathering one row's ``npages`` pages of every layer
    to the host and of scattering them back (``kvsnap``), in an arena of
    ``module``'s geometry stored at ``kv_quant``; median of 10, after a
    warm-up; and the row's payload bytes."""
    from kubeml_tpu_torch.models.generation import init_paged_cache
    from kubeml_tpu_torch.serving import kvsnap

    cache = init_paged_cache(module, npages + 1, PAGE_TOKENS, kv_quant,
                             "cuda")
    pages = list(range(1, npages + 1))
    times = {"gather": [], "scatter": []}
    layers = kvsnap.gather_pages(cache, pages)
    for rep in range(11):
        for name, fn in (("gather", lambda: kvsnap.gather_pages(cache,
                                                                 pages)),
                         ("scatter", lambda: kvsnap.scatter_pages(
                             cache, pages, layers))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if rep:
                times[name].append(start.elapsed_time(end))
    return (float(np.median(times["gather"])),
            float(np.median(times["scatter"])),
            kvsnap.snapshot_nbytes(kvsnap.RequestSnapshot(
                model="", request_id="", page_tokens=PAGE_TOKENS,
                kv_quant=kv_quant, spec="off", prompt=[], out=[], max_new=1,
                temp=0.0, topk=0, eos=-1, key=(0, 0), layers=layers)))


def resilience_phase(smi):
    """Phase 11 (see the module docstring): (a) fault recovery, (b) drain
    and restore into a fresh decoder, (c) a forced pool-audit failure.
    Returns the (paged_attention, int8_matmul) launches of its runs."""
    from kubeml_tpu_torch.api import EngineFaultError, GenerateRequest
    from kubeml_tpu_torch.benchmarks.recovery import (decoder_kwargs,
                                                      run_chaos, serve_storm)
    from kubeml_tpu_torch.benchmarks.spec_decode import coherent_tail
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serving import PagedBatchingDecoder, kvsnap
    from kubeml_tpu_torch.serving.kvpool import PageAllocError

    reqs = workload(np.random.default_rng(SEED))
    target = coherent_tail(gpt2_small(), EXIT_LAYER)
    common = dict(slots=SLOTS, page_tokens=PAGE_TOKENS, chunk_steps=CHUNK,
                  device="cuda")
    log(f"  [{smi}]")

    # (a) a fault at a step's entry once the first token lands; the host
    # wall of recovery's parts: the snapshots, the rebuild, the restores
    qmodel = copy.deepcopy(target)  # the int8 decoders quantize it in place
    spans = {"_recover_rows": 0.0, "_reset_engine_state": 0.0,
             "_restore": 0.0}
    methods = {n: getattr(PagedBatchingDecoder, n) for n in spans}

    def timed(name, fn):
        def call(self, *a, **kw):
            t0 = time.monotonic()
            try:
                return fn(self, *a, **kw)
            finally:
                spans[name] += time.monotonic() - t0
        return call

    for name, fn in methods.items():
        setattr(PagedBatchingDecoder, name, timed(name, fn))
    paged_attention.launches = int8_matmul.launches = 0
    try:
        row = run_chaos(qmodel, storm_specs(reqs, sampled=True),
                        device="cuda", **decoder_kwargs(
                            PAGE_TOKENS, SLOTS, CHUNK, SPEC_K, EXIT_LAYER))
    finally:
        for name, fn in methods.items():
            setattr(PagedBatchingDecoder, name, fn)
    a_launches = (paged_attention.launches, int8_matmul.launches)
    log(f"  a fault recovery (int8 weights + KV, spec=self k {SPEC_K}): "
        f"{row['streams']} streams ({row['sampled_streams']} sampled), "
        f"{row['tokens']} tokens equal to the fault-free run; snapshots "
        f"saved {int(row['snapshot_saved'])}, restored "
        f"{int(row['snapshot_restored'])}, replayed "
        f"{int(row['snapshot_replayed'])}, failed "
        f"{int(row['snapshot_failed'])}; pool audits "
        f"{int(row['pool_audit_runs'])}, failures "
        f"{int(row['pool_audit_failures'])}; pages held after the trie "
        f"flush {row['held_after_flush']}; fault to the first post-fault "
        f"emission {row['fault_to_first_emit_ms']:.2f} ms (host ms: "
        f"snapshots {1e3 * spans['_recover_rows']:.2f}, rebuild "
        f"{1e3 * spans['_reset_engine_state']:.2f}, restores "
        f"{1e3 * spans['_restore']:.2f}); launches paged_attention "
        f"{a_launches[0]}, int8_matmul {a_launches[1]}")
    if min(a_launches) <= 0:
        raise AssertionError(f"a: kernel launches {a_launches}")
    del qmodel

    # (b) drain mid-decode, restore every frame into a fresh decoder
    specs = storm_specs(reqs, sampled=False)
    ref_dec = PagedBatchingDecoder(target, **common)
    want, _ = serve_storm(ref_dec, specs)
    ref_dec.close()
    dec = PagedBatchingDecoder(target, **common)
    with dec._cond:
        entries = [dec.submit(GenerateRequest(
            prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"]))
            for s in specs]
    wait_for_tokens(dec, DRAIN_AFTER)
    frames = dec.drain(grace=0.0)
    got, drained = [None] * len(specs), 0
    for i, e in enumerate(entries):
        try:
            out = dec.wait(e, timeout=600)
            got[i] = out["tokens"][0][:out["lengths"][0]]
        except EngineFaultError as err:
            drained += 1
            if want[i][:len(err.partial_tokens[0])] != err.partial_tokens[0]:
                raise AssertionError(f"b: request {i}'s partial tokens are "
                                     f"not a prefix of its stream")
    chk = dec._pool.check()
    dec.close()
    if len(frames) != drained or chk["held"] != chk["trie_pages"]:
        raise AssertionError(f"b: {len(frames)} frames for {drained} drained "
                             f"requests, pool {chk}")
    index = {e.request_id: i for i, e in enumerate(entries)}
    headers = [kvsnap.peek_header(f) for f in frames]
    mid = [len(f) for f, h in zip(frames, headers) if h["out_len"]]
    dec = PagedBatchingDecoder(target, **common)
    paged_attention.launches = int8_matmul.launches = 0
    with dec._cond:
        restored = [dec.submit_snapshot(f) for f in frames]
    for e in restored:
        out = dec.wait(e, timeout=600)
        got[index[out["request_id"]]] = out["tokens"][0][:out["lengths"][0]]
    b_launches = (paged_attention.launches, int8_matmul.launches)
    tele = dec.telemetry()
    chk = dec._pool.check()
    dec.close()
    ties = check_greedy("b", got, want, [s["prompt"] for s in specs], ref_dec,
                        against="the uninterrupted run")
    log(f"  b drain (f32, spec off) after {DRAIN_AFTER} tokens: "
        f"{drained} requests drained into {len(frames)} frames ({len(mid)} "
        f"mid-stream, {len(frames) - len(mid)} without pages), restored in "
        f"a fresh decoder: {sum(map(len, got))} tokens equal to the "
        f"uninterrupted run (near ties {ties or 'none'}); frame bytes a "
        f"mid-stream row: mean {np.mean(mid):.0f}, min {min(mid)}, max "
        f"{max(mid)}; restore launches paged_attention {b_launches[0]}")
    if (tele["snapshot_restored"] != len(mid) or b_launches[0] <= 0
            or chk["held"] != chk["trie_pages"]):
        raise AssertionError(f"b: restored {tele['snapshot_restored']} of "
                             f"{len(mid)}, launches {b_launches}, pool {chk}")
    npages = int(np.median([h["npages"] for h in headers if h["out_len"]]))
    for kvq in ("off", "int8"):
        g_ms, s_ms, nbytes = snapshot_copy_ms(target, kvq, npages)
        log(f"  snapshot copies, {'int8' if kvq == 'int8' else 'f32'} "
            f"arena, {npages} pages a row ({nbytes} bytes) [{smi}]: gather "
            f"{g_ms:.4f} ms, scatter {s_ms:.4f} ms a row (CUDA events, "
            f"median of 10)")

    # (c) a forced pool-audit failure rebuilds, and the streams complete
    dec = PagedBatchingDecoder(target, pool_audit_interval=AUDIT_INTERVAL,
                               **common)
    ticks = []
    audit = dec._audit_pool

    def timed_audit():
        t0 = time.perf_counter()
        try:
            audit()
        finally:
            ticks.append(time.perf_counter() - t0)

    dec._audit_pool = timed_audit
    with dec._cond:
        entries = [dec.submit(GenerateRequest(
            prompts=[s["prompt"].tolist()], max_new_tokens=s["max_new"]))
            for s in specs[:AUDIT_REQUESTS]]
    wait_for_tokens(dec, DRAIN_AFTER)

    def tripped():
        raise PageAllocError("forced invariant break")

    with dec._cond:
        dec._pool.check = tripped
    outs = [dec.wait(e, timeout=600) for e in entries]
    tele = {k: dec.telemetry().get(k, 0.0) for k in (
        "pool_audit_runs", "pool_audit_failures", "snapshot_replayed")}
    dec.close()
    same = sum(o["tokens"][0][:o["lengths"][0]] == w
               for o, w in zip(outs, want))
    log(f"  c forced audit failure: audits {int(tele['pool_audit_runs'])}, "
        f"failures {int(tele['pool_audit_failures'])}, rows replayed "
        f"{int(tele['snapshot_replayed'])}; {len(outs)} streams complete "
        f"({same} token-identical to b's uninterrupted run); audit host "
        f"time {1e6 * float(np.median(ticks)):.1f} us a tick (median of "
        f"{len(ticks)})")
    if (tele["pool_audit_failures"] != 1 or tele["snapshot_replayed"] < 1
            or any(o["lengths"][0] != s["max_new"]
                   for o, s in zip(outs, specs))):
        raise AssertionError(f"c: audit failures "
                             f"{tele['pool_audit_failures']}, replayed "
                             f"{tele['snapshot_replayed']}")
    return (a_launches[0] + b_launches[0], a_launches[1] + b_launches[1])


# --- phase 12: checkpoint serving ------------------------------------------

# phase 4's GPT-2-small as a registered function: the parameter server
# builds the module from it and loads the checkpoint into it
GPT2_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models import GPTSmall
from kubeml_tpu_torch.runtime.model import KubeModel


class GPT2(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("tokens"))

    def build(self):
        return GPTSmall(vocab_size=%d, max_len=%d, attn_bias=True,
                        ln_eps=1e-5, seed=%d, device="cpu")
"""
GPT2_JOB = "gpt2-small"
# int8 KV pages: a released page keeps its scale rows as its next owner's
# floor (ROADMAP Queue 3, in both engines), and which pages a request gets
# follows the threads' timing, so two int8-KV runs of the mix may round a
# row's K/V apart. 12b holds the weights bit for bit (q, s and every other
# tensor, and teacher-forced logits on fresh arenas) and the mix's greedy
# tokens with near ties at the int8 path's teacher-forced tolerance
INT8_NEAR_TIE = TF_ATOL


def streamed(ps, job, req):
    """One streamed request through ``ps``: its result in ``wait``'s shape
    and the seconds from the call to the first token."""
    t0 = time.monotonic()
    toks, first = [], None
    for part in ps.generate(job, req):
        if "tokens" in part:
            first = first if first is not None else time.monotonic() - t0
            toks += part["tokens"]
    return {"tokens": [toks], "lengths": [len(toks)]}, first


def serve_ps(ps, job, reqs, eos, n=16):
    """``serve``'s workload through ``ps.generate`` from threads, with the
    hand-built engine's eos id: the calibration request, streamed (its
    first token is the fresh decoder's first), then the first ``n``
    requests,
    request 0 streamed so that sharers 2-4 start once its first token
    landed. Returns ``serve``'s dict (timings from the decoder's
    telemetry) with the calibration's TTFT."""
    from kubeml_tpu_torch.api import GenerateRequest

    calib, calib_ttft = streamed(ps, job, GenerateRequest(
        prompts=[reqs[5]["prompt"].tolist()], max_new_tokens=16,
        stream=True))
    results, errors = [None] * n, []
    first_sharer = threading.Event()

    def client(i):
        try:
            if i in (4, 8, 12):
                first_sharer.wait(600)
            r = reqs[i]
            req = GenerateRequest(prompts=[r["prompt"].tolist()],
                                  max_new_tokens=r["max_new"],
                                  eos_id=eos if i == 5 else None,
                                  stream=i == 0)
            if i == 0:
                toks = []
                for part in ps.generate(job, req):
                    toks += part.get("tokens", [])
                    first_sharer.set()
                results[0] = {"tokens": [toks], "lengths": [len(toks)],
                              "prefix_cached_tokens": 0}
            else:
                results[i] = ps.generate(job, req)
        except Exception as e:  # surfaced below, after the join
            errors.append(e)
            first_sharer.set()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving clients did not finish")
    tokens = sum(r["lengths"][0] for r in results)
    tele = ps._decoders[job][0].telemetry()
    return dict(calib=calib["tokens"][0], calib_ttft=calib_ttft,
                results=results, tokens=tokens, wall=wall,
                tokens_per_s=tokens / wall, tele=tele)


def cold_serving(ps, job):
    """Milliseconds of a cold ``_load_serving`` (the file read, the
    function's load) and of the decoder's build (the module built, loaded,
    moved to the card; the arena allocated)."""
    t0 = time.monotonic()
    model, tree, mtime = ps._load_serving(job)
    t1 = time.monotonic()
    dec = ps._get_decoder(job, model, tree, mtime)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    return dec, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def report_ps(tag, run, load_ms, build_ms, warm_ttft, launches, smi):
    t = run["tele"]
    log(f"  {tag} [{smi}]: {run['tokens']} tokens in {run['wall']:.3f} s = "
        f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{1e3 * t['first_token_p50_seconds']:.1f} ms; cold _load_serving "
        f"{load_ms:.1f} ms + decoder build {build_ms:.1f} ms; TTFT of the "
        f"first request on the cold decoder {1e3 * run['calib_ttft']:.1f} "
        f"ms, of a warm one {1e3 * warm_ttft:.1f} ms; launches "
        f"paged_attention {launches[0]}, int8_matmul {launches[1]}")


def warm_request(ps, job, reqs):
    """TTFT of a warm request: the calibration prompt's length, new
    tokens (no shared prefix), streamed."""
    from kubeml_tpu_torch.api import GenerateRequest

    prompt = np.random.default_rng(SEED + 1).integers(
        1, VOCAB, size=len(reqs[5]["prompt"]))
    return streamed(ps, job, GenerateRequest(
        prompts=[prompt.tolist()], max_new_tokens=16, stream=True))[1]


def checkpoint_phase(smi, root, run, qrun, kavg):
    """Phase 12 (see the module docstring): (a) a dense GPT-2-small final
    served by ``ParameterServer.generate``, (b) its ``final-int8``, (c)
    drain and restore across two servers, (d) the K-AVG job's final
    through ``ParameterServer.infer``. ``run``/``qrun`` are phases 4-5's
    hand-built f32 and int8 engines' runs, ``kavg`` phase 10c's (history,
    job). Returns the (paged_attention, int8_matmul) launches of its
    serving runs."""
    from kubeml_tpu_torch.api import EngineFaultError, GenerateRequest
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.interop.from_flax import to_flax
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.ps import ParameterServer
    from kubeml_tpu_torch.serving import PagedBatchingDecoder, kvsnap
    from kubeml_tpu_torch.serving.quant import (INT8_TAG,
                                                quantize_final_checkpoint)
    from kubeml_tpu_torch.storage import FINAL_TAG, CheckpointStore

    reqs = workload(np.random.default_rng(SEED))
    prompts = [reqs[5]["prompt"]] + [r["prompt"] for r in reqs]
    snaps = str(Path(root) / "snaps")
    serve_kw = dict(data_root=Path(root), serving_slots=SLOTS,
                    serving_chunk_steps=CHUNK,
                    serving_page_tokens=PAGE_TOKENS, snap_dir=snaps)
    cfg = Config(**serve_kw)
    cfg.ensure_dirs()
    FunctionRegistry(config=cfg).create("gpt2", GPT2_FN % (VOCAB, MAX_LEN,
                                                            SEED))
    store = CheckpointStore(config=cfg)
    model = gpt2_small()
    t0 = time.monotonic()
    path = store.save(GPT2_JOB, to_flax(model.state_dict()), epoch=1,
                      tag=FINAL_TAG, meta={"request": {
                          "function_name": "gpt2"}})
    save_ms = 1e3 * (time.monotonic() - t0)
    del model
    t0 = time.monotonic()
    quantize_final_checkpoint(GPT2_JOB, store)
    q_ms = 1e3 * (time.monotonic() - t0)
    qpath = store.export_path(GPT2_JOB, tag=INT8_TAG)
    log(f"  checkpoints [{smi}]: final {path.stat().st_size} bytes, "
        f"to_flax + save {save_ms:.1f} ms; final-int8 "
        f"{qpath.stat().st_size} bytes, quantize_final_checkpoint (read, "
        f"quantize on the host, save) {q_ms:.1f} ms")
    launches = [0, 0]

    # (a) the dense final through generate
    ps = ParameterServer(config=cfg)
    dec, load_ms, build_ms = cold_serving(ps, GPT2_JOB)
    if dec.paged_attn != "cuda" or dec.quantize:
        raise AssertionError("a: the served engine is not the f32 kernel "
                             "engine")
    paged_attention.launches = int8_matmul.launches = 0
    prun = serve_ps(ps, GPT2_JOB, reqs, run["eos"])
    again = ps.generate(GPT2_JOB, GenerateRequest(
        prompts=[reqs[0]["prompt"].tolist()], max_new_tokens=4))
    warm_ttft = warm_request(ps, GPT2_JOB, reqs)
    a_launches = (paged_attention.launches, int8_matmul.launches)
    report_ps("a dense final", prun, load_ms, build_ms, warm_ttft,
              a_launches, smi)
    ties = check_greedy("a", token_lists(prun), token_lists(run), prompts,
                        dec, first=-1, against="the hand-built engine")
    log(f"  a: greedy tokens identical to phase 4's hand-built engine "
        f"({prun['tokens']} tokens; near ties {ties or 'none'}); the "
        f"request-0 prompt again: {again['prefix_cached_tokens']} tokens "
        f"from the prefix trie")
    if a_launches[0] <= 0 or again["prefix_cached_tokens"] < 64:
        raise AssertionError(f"a: launches {a_launches}, prefix cached "
                             f"{again['prefix_cached_tokens']}")
    launches[0] += a_launches[0]

    # (c) drain mid-stream into snap_dir, restore in a fresh server
    want = token_lists(prun)[1:]
    got, partial, errors = [None] * 16, {}, []

    def client(i):
        r = reqs[i]
        try:
            out = ps.generate(GPT2_JOB, GenerateRequest(
                prompts=[r["prompt"].tolist()], max_new_tokens=r["max_new"],
                eos_id=run["eos"] if i == 5 else None))
            got[i] = out["tokens"][0][:out["lengths"][0]]
        except EngineFaultError as e:
            partial[i] = e.partial_tokens[0]
        except Exception as e:  # surfaced below, after the join
            errors.append(e)

    paged_attention.launches = int8_matmul.launches = 0
    base = dec.telemetry()["requests_submitted"]
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 600
    while dec.telemetry()["requests_submitted"] < base + 16:
        if time.monotonic() > deadline:
            raise AssertionError("c: the requests were not all submitted")
        time.sleep(0.001)
    wait_for_tokens(dec, DRAIN_AFTER)
    drained = ps.drain_serving(grace=0.0)
    for t in threads:
        t.join(600)
    ps.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"c: clients failed or hung: {errors}")
    if (len(drained["written"]) != len(partial)
            or any(want[i][:len(p)] != p for i, p in partial.items())):
        raise AssertionError(f"c: {len(drained['written'])} frames for "
                             f"{len(partial)} drained requests, or a partial "
                             f"stream is not a prefix of its run")
    index = {}
    for f in drained["written"]:
        with open(f, "rb") as fh:
            snap = kvsnap.decode_snapshot(fh.read())
        index[snap.request_id] = next(
            i for i, r in enumerate(reqs)
            if r["prompt"].tolist() == list(snap.prompt))
    fresh = ParameterServer(config=Config(**serve_kw))
    t0 = time.monotonic()
    out = fresh.restore_serving()
    if out["failed"] or len(out["restored"]) != len(partial):
        raise AssertionError(f"c: restore {out}")
    deadline = time.monotonic() + 600
    rows = fresh.restored_snapshot()
    while not all(r["done"] or r["error"] for r in rows):
        if time.monotonic() > deadline:
            raise AssertionError("c: restored requests did not finish")
        time.sleep(0.01)
        rows = fresh.restored_snapshot()
    restore_s = time.monotonic() - t0
    for r in rows:
        if r["error"]:
            raise AssertionError(f"c: restored request failed: {r['error']}")
        got[index[r["request_id"]]] = r["tokens"][0]
    c_launches = (paged_attention.launches, int8_matmul.launches)
    rdec = fresh._decoders[GPT2_JOB][0]
    restored = rdec.telemetry()["snapshot_restored"]
    ties = check_greedy("c", got, want, prompts[1:], rdec,
                        against="the uninterrupted run")
    fresh.close()
    log(f"  c drain after {DRAIN_AFTER} tokens: {len(partial)} requests "
        f"drained into {snaps} ({int(restored)} mid-stream frames), "
        f"restored by a fresh ParameterServer in {restore_s:.3f} s (load, "
        f"decoder build, replay to the end): {sum(map(len, got))} tokens "
        f"equal to the uninterrupted run (near ties {ties or 'none'}); "
        f"launches paged_attention {c_launches[0]}")
    if c_launches[0] <= 0 or not partial:
        raise AssertionError(f"c: launches {c_launches}, drained "
                             f"{len(partial)}")
    launches[0] += c_launches[0]

    # (b) the final-int8 export: int8 weights through the int8 matmul,
    # int8 KV pages
    qps = ParameterServer(config=Config(serving_quantize="int8",
                                        kv_quant="int8", int8_matmul=True,
                                        **serve_kw))
    if qps._serving_source(GPT2_JOB)[1] != INT8_TAG:
        raise AssertionError("b: the server does not pick final-int8")
    qdec, load_ms, build_ms = cold_serving(qps, GPT2_JOB)
    if (not qdec.int8_matmul or qdec.int8_matmul_impl != "cuda"
            or qdec.kv_quant != "int8" or qdec.paged_attn != "cuda"):
        raise AssertionError("b: the int8 engine does not run both kernels")
    paged_attention.launches = int8_matmul.launches = 0
    qprun = serve_ps(qps, GPT2_JOB, reqs, qrun["eos"])
    warm_ttft = warm_request(qps, GPT2_JOB, reqs)
    b_launches = (paged_attention.launches, int8_matmul.launches)
    report_ps("b final-int8", qprun, load_ms, build_ms, warm_ttft,
              b_launches, smi)
    hand = PagedBatchingDecoder(gpt2_small(), quantize="int8",
                                int8_matmul=True, kv_quant="int8",
                                slots=SLOTS, page_tokens=PAGE_TOKENS,
                                chunk_steps=CHUNK, device="cuda")
    mine, theirs = qdec.module.state_dict(), hand.module.state_dict()
    same = mine.keys() == theirs.keys() and all(
        torch.equal(mine[k], theirs[k]) for k in mine)
    nq = sum(k.endswith("kernel_q") for k in mine)
    prompt = reqs[1]["prompt"].tolist()
    forced = qprun["results"][1]["tokens"][0][:4]
    tf_same = torch.equal(teacher_forced_logits(qdec, prompt, forced),
                          teacher_forced_logits(hand, prompt, forced))
    hand.close()
    log(f"  b: the served module against a hand-built quantize='int8' "
        f"engine's: every tensor bit-identical: {same} ({nq} int8 "
        f"kernels); teacher-forced logits (prefill + 4 steps) "
        f"bit-identical: {tf_same}")
    if not (same and nq == INT8_PER_FORWARD and tf_same):
        raise AssertionError("b: the final-int8 weights differ from the "
                             "hand-built int8 engine's")
    ties = check_greedy("b", token_lists(qprun), token_lists(qrun), prompts,
                        qdec, first=-1, against="the hand-built int8 engine",
                        tie=INT8_NEAR_TIE)
    qps.close()
    log(f"  b: greedy tokens identical to phase 5's hand-built "
        f"quantize='int8' engine ({qprun['tokens']} tokens; near ties "
        f"within {INT8_NEAR_TIE} {ties or 'none'})")
    if min(b_launches) <= 0:
        raise AssertionError(f"b: launches {b_launches}")
    launches[0] += b_launches[0]
    launches[1] += b_launches[1]
    int8_digest = state_digest(qdec.module)

    # (d) the K-AVG job's final export through infer
    hist, job = kavg
    kps = ParameterServer(config=Config(data_root=Path(root) / "kavg"))
    x = banded_images(256, 4)[0]
    t0 = time.monotonic()
    served = kps.infer(KAVG_JOB, x)
    infer_ms = 1e3 * (time.monotonic() - t0)
    own = job.infer(x).tolist()
    log(f"  d K-AVG final through infer: {len(served)} predictions equal "
        f"to the job's own: {served == own} (cold infer {infer_ms:.1f} ms, "
        f"the final's epoch {len(hist.train_loss)})")
    if served != own:
        raise AssertionError("d: infer from the final export differs from "
                             "the job's in-memory infer")
    return dict(launches=tuple(launches), prun=prun, qprun=qprun,
                int8_digest=int8_digest, serve_kw=serve_kw)


# --- phase 13: the control plane over HTTP ---------------------------------

# 13a: the CIFAR-10-shaped upload (seeded random uint8), the flagship's
# hyperparameters through /train, elastic from 4 workers
CP_TRAIN, CP_TEST, CP_EPOCHS, CP_SEED = 16384, 2048, 3, 7
CP_JOB_DEADLINE = 600.0
# the pause of 13a's live /infer: the job thread blocks in its
# per-sample loss at this call (round 2, worker 0, step 4 at 4 workers of
# K 8: three local steps applied, the round not merged)
CP_PAUSE_AT = 4 * KAVG_K + 4
# 13c: the drain grace of the SIGTERM'd server (its stragglers become
# frames at once), and the seconds its exit may take past the signal
CP_DRAIN_GRACE, CP_EXIT_S = 0.0, 60.0
LEGAL_LEVELS = (1, 2, 4, 8)

FLAGSHIP_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.resnet import ResNet18
from kubeml_tpu_torch.runtime.model import KubeModel


class Flagship(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("cifar10"))

    def build(self):
        return ResNet18(num_classes=10, dtype=torch.bfloat16)

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)

    def preprocess(self, x):
        return x.to(torch.bfloat16) / 127.5 - 1.0
"""


def state_digest(module):
    """{name: (dtype, shape, sha1 of the bytes)} of a module's tensors."""
    import hashlib

    return {k: (str(v.dtype), tuple(v.shape), hashlib.sha1(
        v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    ).hexdigest()) for k, v in module.state_dict().items()}


def cp_config(root, **kw):
    """A Config under ``root`` with every service on port 0."""
    from kubeml_tpu_torch.api.config import Config

    return Config(data_root=Path(root), controller_port=0, scheduler_port=0,
                  ps_port=0, storage_port=0, **kw)


def http_text(url: str) -> str:
    from kubeml_tpu_torch.utils import http_client as http

    r = http.get(url, timeout=(5.0, 60.0))
    if r.status_code != 200:
        raise AssertionError(f"{url}: {r.status_code} {r.text[:200]}")
    return r.text


def cp_wait_job(cluster, jid: str):
    """Wait on the job's own state: its record in the PS, then its thread;
    returns the history once the thread has ended."""
    deadline = time.monotonic() + CP_JOB_DEADLINE
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            known = jid in cluster.ps._jobs
        if known and cluster.ps.wait(jid, timeout=1.0):
            break
        if not known:
            try:
                return cluster.history_store.get(jid)
            except Exception:
                time.sleep(0.05)
    else:
        raise AssertionError(f"13a: job {jid} did not end within "
                             f"{CP_JOB_DEADLINE} s")
    return cluster.history_store.get(jid)


def cp_train(smi, root):
    """13a (see the module docstring). Returns the epoch seconds."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient

    cfg = cp_config(Path(root) / "cp-train")
    r = np.random.default_rng(CP_SEED)
    x = r.integers(0, 256, size=(CP_TRAIN + CP_TEST, 32, 32, 3),
                   dtype=np.uint8)
    y = r.integers(0, 10, size=CP_TRAIN + CP_TEST).astype(np.int64)
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        t0 = time.monotonic()
        client.datasets().create("cifar10", x[:CP_TRAIN], y[:CP_TRAIN],
                                 x[CP_TRAIN:], y[CP_TRAIN:])
        upload_s = time.monotonic() - t0
        client.functions().create("flagship", FLAGSHIP_FN)
        paused, release = threading.Event(), threading.Event()
        t_train = time.monotonic()
        jid = client.networks().train(TrainRequest(
            model_type="resnet18", batch_size=KAVG_B, epochs=CP_EPOCHS,
            dataset="cifar10", lr=0.1, function_name="flagship",
            options=TrainOptions(default_parallelism=4,
                                 static_parallelism=False, k=KAVG_K,
                                 precision="bf16")))
        # the job's model: pause its thread mid-round at CP_PAUSE_AT
        deadline = time.monotonic() + 120
        while True:
            with cluster.ps._lock:
                rec = cluster.ps._jobs.get(jid)
            if rec is not None and rec.job is not None:
                break
            if time.monotonic() > deadline:
                raise AssertionError("13a: the job did not start")
            time.sleep(0.01)
        job = rec.job
        # the first epoch's end: the job's first metrics push
        first_push = []
        base_push = job.on_metrics

        def on_metrics(update):
            first_push.append(time.monotonic())
            base_push(update)

        job.on_metrics = on_metrics
        calls = [0]
        base_loss = job.model.per_sample_loss

        pause_s = [0.0]

        def pausing_loss(logits, labels):
            calls[0] += 1
            if calls[0] == CP_PAUSE_AT:
                t_pause = time.monotonic()
                paused.set()
                release.wait(120)
                pause_s[0] = time.monotonic() - t_pause
            return base_loss(logits, labels)

        job.model.per_sample_loss = pausing_loss
        if not paused.wait(300):
            raise AssertionError("13a: the job never reached the pause")
        probe = x[CP_TRAIN:CP_TRAIN + 32]
        try:
            t_inf = time.monotonic()
            live = client.networks().infer(jid, probe)
            live_ms = 1e3 * (time.monotonic() - t_inf)
            merged = job.trainer.infer_replica(job._published,
                                               probe).tolist()
            moving = job.trainer.infer(job._stacked_vars, probe).tolist()
            running = http_text(f"{cluster.ps_api.url}/metrics")
        finally:
            job.model.per_sample_loss = base_loss
            release.set()
        log(f"  a: /infer on the running job (paused mid-round, worker 0 "
            f"three steps in) in {live_ms:.1f} ms: equal to the last "
            f"round's merged weights {live == merged}; to the live replica "
            f"0 {live == moving}")
        if live != merged:
            raise AssertionError("13a: /infer on a live job did not answer "
                                 "from the merged weights")
        if 'kubeml_job_running_total{type="train"} 1' not in running:
            raise AssertionError("13a: /metrics lacks the running job")
        hist = cp_wait_job(cluster, jid)
        wall = time.monotonic() - t_train - pause_s[0]
        to_first = first_push[0] - t_train - pause_s[0]
        # the pause fell inside the first epoch
        epochs = [hist.epoch_duration[0] - pause_s[0]] + \
            hist.epoch_duration[1:]
        decisions = client.tasks().decisions(jid)["decisions"]
        h = client.histories().get(jid)
        trace = h.parallelism
        steps = [d["to"] for d in decisions[:len(trace)]]
        froms = [d["from"] for d in decisions[1:len(trace) + 1]]
        log(f"  a [{smi}]: upload of {CP_TRAIN}+{CP_TEST} samples "
            f"{upload_s:.2f} s; /train to the first epoch's end "
            f"{to_first:.2f} s, to the job's end {wall:.2f} s (the "
            f"{pause_s[0]:.2f} s pause taken out); parallelism "
            f"{trace}; train loss {[round(v, 4) for v in h.train_loss]}; "
            f"epoch s {[round(v, 3) for v in epochs]} (the first without "
            f"the pause) = {[round(CP_TRAIN / v) for v in epochs]} "
            f"samples/s; "
            f"decisions {[(d['from'], d['to'], d['reason']) for d in decisions]}")
        if (h.task or {}).get("error") or hist.to_dict() != h.to_dict():
            raise AssertionError(f"13a: the job failed or its history "
                                 f"differs over HTTP: {(h.task or {})}")
        if (len(h.train_loss) != CP_EPOCHS
                or not all(np.isfinite(h.train_loss))):
            raise AssertionError(f"13a: train loss {h.train_loss}")
        if (any(p not in LEGAL_LEVELS for p in trace) or trace != steps
                or trace != froms or decisions[0]["reason"] != "new-task"):
            raise AssertionError(f"13a: trace {trace} against decisions "
                                 f"{decisions}")
        after = client.networks().infer(jid, probe)
        own = job.infer(probe).tolist()
        log(f"  a: /infer after the finish (the final export) equal to the "
            f"job's own infer: {after == own}")
        if after != own:
            raise AssertionError("13a: /infer of the final export differs "
                                 "from the job's")
        text = http_text(f"{cluster.ps_api.url}/metrics")
        want = [f'kubeml_job_epoch_seconds_count{{jobid="{jid}"}} '
                f'{CP_EPOCHS}', 'kubeml_job_running_total{type="train"} 0',
                f'kubeml_job_round_seconds_bucket{{jobid="{jid}"',
                'kubeml_scale_decisions_total{direction="new",'
                'reason="new-task"} 1']
        missing = [w for w in want if w not in text]
        if missing:
            raise AssertionError(f"13a: /metrics lacks {missing}")
    return epochs


def cp_generate(client, reqs, eos, job=None):
    """The 16 requests through ``client``'s ``/generate`` from threads:
    odd requests streamed, even ones one-shot; request 0 streamed first
    and the sharers 4, 8, 12 sent once its first token landed. Returns
    token lists, the wall, the tokens and the streamed requests' TTFTs."""
    job = job or GPT2_JOB
    results, ttfts, errors = [None] * 16, {}, []
    first_sharer = threading.Event()

    def client_thread(i):
        try:
            if i in (4, 8, 12):
                first_sharer.wait(600)
            r = reqs[i]
            kw = dict(max_new_tokens=r["max_new"],
                      eos_id=eos if i == 5 else None)
            prompt = [r["prompt"].tolist()]
            if i % 2 == 1 or i == 0:
                t0 = time.monotonic()
                toks = []
                for part in client.networks().generate(job, prompt,
                                                       stream=True, **kw):
                    if "error" in part:
                        raise AssertionError(f"request {i}: {part}")
                    if part.get("tokens"):
                        ttfts.setdefault(i, time.monotonic() - t0)
                        toks += part["tokens"]
                        first_sharer.set()
                results[i] = toks
            else:
                out = client.networks().generate(job, prompt, **kw)
                results[i] = out["tokens"][0][:out["lengths"][0]]
        except Exception as e:  # surfaced below, after the join
            errors.append(e)
            first_sharer.set()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client_thread, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("HTTP clients did not finish")
    return results, wall, sum(map(len, results)), ttfts


def http_overhead_ms(cluster, client, reqs, n: int = 10):
    """Median ms of a one-token one-shot request through the controller's
    /generate minus the same request through ``ParameterServer.generate``
    in process, alternating, on the warm decoder."""
    from kubeml_tpu_torch.api import GenerateRequest

    prompt = reqs[1]["prompt"].tolist()
    inproc, wire = [], []
    for _ in range(n):
        t0 = time.monotonic()
        cluster.ps.generate(GPT2_JOB, GenerateRequest(prompts=[prompt],
                                                      max_new_tokens=1))
        inproc.append(time.monotonic() - t0)
        t0 = time.monotonic()
        client.networks().generate(GPT2_JOB, [prompt], max_new_tokens=1)
        wire.append(time.monotonic() - t0)
    return (1e3 * float(np.median(wire)), 1e3 * float(np.median(inproc)))


def cp_serve(smi, root, ckpt, eos, qeos):
    """13b (see the module docstring). Returns the (paged_attention,
    int8_matmul) launches."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    reqs = workload(np.random.default_rng(SEED))
    prompts = [r["prompt"] for r in reqs]
    serve_kw = {k: v for k, v in ckpt["serve_kw"].items()
                if k not in ("data_root", "snap_dir")}
    launches = [0, 0]
    for tag, kw, ref, tie in (
            ("f32", {}, ckpt["prun"], NEAR_TIE),
            ("int8", dict(serving_quantize="int8", kv_quant="int8",
                          int8_matmul=True), ckpt["qprun"], INT8_NEAR_TIE)):
        cfg = cp_config(root, **serve_kw, **kw)
        with LocalCluster(config=cfg) as cluster:
            client = KubemlClient(cluster.controller_url, timeout=600)
            # the decoder built before the timed mix, as phase 12's
            warm = client.networks().generate(
                GPT2_JOB, [reqs[5]["prompt"].tolist()], max_new_tokens=16)
            dec = cluster.ps._decoders[GPT2_JOB][0]
            paged_attention.launches = int8_matmul.launches = 0
            got, wall, tokens, ttfts = cp_generate(
                client, reqs, eos if tag == "f32" else qeos)
            got_launches = (paged_attention.launches, int8_matmul.launches)
            tele = dec.telemetry()
            wire_ms, inproc_ms = http_overhead_ms(cluster, client, reqs)
            ties = check_greedy(f"13b {tag}", got, token_lists(ref)[1:],
                                prompts, dec, against="phase 12's server",
                                tie=tie)
            same_calib = warm["tokens"][0][:warm["lengths"][0]] == \
                token_lists(ref)[0]
            digest_same = None
            if tag == "int8":
                digest_same = state_digest(dec.module) == ckpt["int8_digest"]
            p12 = ref["tele"]
            log(f"  b {tag} [{smi}]: {tokens} tokens over HTTP in "
                f"{wall:.3f} s = {tokens / wall:.1f} tokens/s, TTFT p50 "
                f"{1e3 * tele['first_token_p50_seconds']:.1f} ms (engine), "
                f"{1e3 * float(np.median(list(ttfts.values()))):.1f} ms "
                f"(streamed clients); phase 12 in process "
                f"{ref['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                f"{1e3 * p12['first_token_p50_seconds']:.1f} ms; a one-token "
                f"request {wire_ms:.2f} ms over HTTP against {inproc_ms:.2f} "
                f"in process (HTTP cost {wire_ms - inproc_ms:.2f} ms); "
                f"tokens equal to phase 12's (near ties {ties or 'none'}); "
                f"calibration request equal {same_calib}; launches "
                f"paged_attention {got_launches[0]}, int8_matmul "
                f"{got_launches[1]}"
                + ("" if digest_same is None else
                   f"; weights bit-identical to 12b's engine {digest_same}"))
            if got_launches[0] <= 0 or (tag == "int8"
                                        and got_launches[1] <= 0):
                raise AssertionError(f"13b {tag}: launches {got_launches}")
            if digest_same is False:
                raise AssertionError("13b: the served int8 weights differ "
                                     "from phase 12b's")
            launches[0] += got_launches[0]
            launches[1] += got_launches[1]
    return tuple(launches)


def cp_start(root, snaps, log_path):
    """``python -m kubeml_tpu_torch.cli start`` on the card in a child
    process (spawned: a fresh interpreter), its services on port 0; returns
    (process, controller URL, PS URL, seconds to the URLs)."""
    import os

    env = dict(os.environ, KUBEML_DATA_ROOT=str(root),
               KUBEML_CONTROLLER_PORT="0", KUBEML_SCHEDULER_PORT="0",
               KUBEML_PS_PORT="0", KUBEML_STORAGE_PORT="0",
               KUBEML_SNAP_DIR=str(snaps),
               KUBEML_DRAIN_GRACE=str(CP_DRAIN_GRACE),
               KUBEML_SERVING_SLOTS=str(SLOTS),
               KUBEML_SERVING_CHUNK=str(CHUNK),
               KUBEML_SERVING_PAGE_TOKENS=str(PAGE_TOKENS),
               PYTHONPATH=os.pathsep.join(filter(None, (
                   str(Path(__file__).resolve().parent),
                   os.environ.get("PYTHONPATH")))))
    t0 = time.monotonic()
    errf = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeml_tpu_torch.cli", "start"],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=errf, text=True)
    errf.close()
    line = proc.stdout.readline()
    m = re.search(r"controller at (\S+); ps at (\S+)", line)
    if not m:
        proc.kill()
        proc.wait(30)
        raise AssertionError(f"13c: cli start printed {line!r} (log "
                             f"{Path(log_path).read_text()[-2000:]})")
    return proc, m.group(1), m.group(2), time.monotonic() - t0


def cp_sigterm(smi, root, ckpt, eos):
    """13c (see the module docstring)."""
    import signal

    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.ps import ParameterServer
    from kubeml_tpu_torch.serving import kvsnap
    from kubeml_tpu_torch.utils import http_client as http

    reqs = workload(np.random.default_rng(SEED))
    want = token_lists(ckpt["prun"])[1:]
    snaps = Path(root) / "snaps13"
    log_path = Path(root) / "cli-start.log"
    proc, url, ps_url, boot_s = cp_start(root, snaps, log_path)
    procs = [proc]
    try:
        client = KubemlClient(url, timeout=600)
        client.networks().generate(GPT2_JOB, [reqs[5]["prompt"].tolist()],
                                   max_new_tokens=4)  # the decoder built
        partial, done, cut, admitted = {}, {}, [], []
        eight, all_in = threading.Event(), threading.Event()

        def stream(i):
            r = reqs[i]
            try:
                toks = []
                # the stream opens once the server has admitted the request
                parts = client.networks().generate(
                    GPT2_JOB, [r["prompt"].tolist()],
                    max_new_tokens=r["max_new"],
                    eos_id=eos if i == 5 else None, stream=True)
                admitted.append(i)
                if len(admitted) == 16:
                    all_in.set()
                for part in parts:
                    if "error" in part:
                        partial[i] = part.get("partial_tokens", [[]])[0]
                        return
                    toks += part.get("tokens", [])
                    if len(toks) >= DRAIN_AFTER:
                        eight.set()
                done[i] = toks
            except http.TransportError:
                cut.append(i)  # the server went before the stream's end

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        # SIGTERM once every request is in and a row has 8 tokens: a
        # request submitted after the drain began is refused (429), and
        # its row would be neither finished nor snapshotted
        if not (eight.wait(600) and all_in.wait(600)):
            raise AssertionError(f"13c: {len(admitted)} of 16 requests "
                                 f"admitted; a row at 8 tokens: "
                                 f"{eight.is_set()}")
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(CP_EXIT_S)
        exit_s = time.monotonic() - t_term
        for t in threads:
            t.join(120)
        frames = sorted(snaps.glob("*" + kvsnap.SNAP_SUFFIX))
        log(f"  c [{smi}]: cli start cold boot {boot_s:.2f} s; SIGTERM once "
            f"a row had {DRAIN_AFTER} tokens: exit code {rc} after "
            f"{exit_s:.2f} s (drain grace {CP_DRAIN_GRACE} s), {len(frames)} "
            f"KMS1 frames of {sum(f.stat().st_size for f in frames)} bytes "
            f"written; streams: {len(done)} done, {len(partial)} cut "
            f"by the drain's 503, {len(cut)} by the connection")
        if rc != 0 or not frames:
            raise AssertionError(f"13c: exit {rc}, frames {len(frames)}; "
                                 f"log {log_path.read_text()[-3000:]}")
        index = {}
        for f in frames:
            snap = kvsnap.decode_snapshot(f.read_bytes())
            index[snap.request_id] = next(
                i for i, r in enumerate(reqs)
                if r["prompt"].tolist() == list(snap.prompt))
        proc2, url2, ps_url2, boot2_s = cp_start(root, snaps, log_path)
        procs.append(proc2)
        t_boot = time.monotonic() - boot2_s
        first_emit = None
        deadline = time.monotonic() + 600
        base = None
        while True:
            rows = http.check(http.get(f"{ps_url2}/serving/restored",
                                       timeout=(5.0, 60.0)))
            lengths = sum(sum(r["lengths"]) for r in rows)
            if base is None:
                base = lengths
            if first_emit is None and (lengths > base or any(
                    r["done"] for r in rows)):
                first_emit = time.monotonic() - t_boot
            if rows and all(r["done"] or r["error"] for r in rows):
                break
            if time.monotonic() > deadline:
                raise AssertionError("13c: restored rows did not finish")
            time.sleep(0.005)
        got = dict(done)
        for r in rows:
            if r["error"]:
                raise AssertionError(f"13c: restored row failed: {r}")
            got[index[r["request_id"]]] = r["tokens"][0]
        if sorted(got) != list(range(16)):
            raise AssertionError(f"13c: rows {sorted(got)} of 16 accounted")
        tie_ps = []

        def tie_dec():
            ps = ParameterServer(config=Config(data_root=Path(root),
                                               **{k: v for k, v in
                                                  ckpt["serve_kw"].items()
                                                  if k != "data_root"}))
            tie_ps.append(ps)
            model, tree, mtime = ps._load_serving(GPT2_JOB)
            return ps._get_decoder(GPT2_JOB, model, tree, mtime)

        mismatched = [i for i in range(16) if got[i] != want[i]]
        ties = []
        if mismatched:
            ties = check_greedy("13c", [got[i] for i in range(16)], want,
                                [r["prompt"] for r in reqs], tie_dec(),
                                against="the uninterrupted run")
        for ps in tie_ps:
            ps.close()
        proc2.send_signal(signal.SIGTERM)
        rc2 = proc2.wait(CP_EXIT_S)
        log(f"  c [{smi}]: a second cli start restored {len(rows)} rows at "
            f"boot ({boot2_s:.2f} s to its URLs; boot to the first restored "
            f"emission {first_emit:.2f} s); every stream equal to phase "
            f"12a's uninterrupted run (near ties {ties or 'none'}); its exit "
            f"code {rc2}")
        if rc2 != 0 or len(rows) != len(frames):
            raise AssertionError(f"13c: second server exit {rc2}, rows "
                                 f"{len(rows)} of {len(frames)} frames")
        return boot_s, exit_s, first_emit
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)


def control_plane_phase(smi, root, run, qrun, ckpt, kavg):
    """Phase 13 (see the module docstring): 13a, 13b, 13c. Returns the
    (paged_attention, int8_matmul) launches of 13b."""
    t0 = time.monotonic()
    epochs = cp_train(smi, root)
    hist, _ = kavg
    log(f"  a: epoch s through the control plane "
        f"{[round(v, 3) for v in epochs]} ({CP_TRAIN} samples, B {KAVG_B}, "
        f"K {KAVG_K}) beside phase 10c's TrainJob "
        f"{[round(v, 3) for v in hist.epoch_duration]} (4096 samples, B 64, "
        f"K 4); 13a {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = cp_serve(smi, root, ckpt, run["eos"], qrun["eos"])
    log(f"  13b {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    cp_sigterm(smi, root, ckpt, run["eos"])
    log(f"  13c {time.monotonic() - t0:.1f} s")
    return launches


# --- phase 14: the encoders ----------------------------------------------

# 14a's shapes: ViT-Tiny (CIFAR-100, patch 4: L 65, 3 heads) and BERT-base
# (L 128, 12 heads, trailing padding); both D 64, non-causal
ENC_VIT = dict(B=256, L=65, H=3)
ENC_BERT = dict(B=32, L=128, H=12)
# bench_bert / bench_vit rounds: ENC_DEPTH layers x K steps, one worker.
# Depth cut from 12 to 6 (width, heads, B, L and K as bench_bert and
# bench_vit) to keep the script within its time with phase 17, and to 4
# with phase 18
BERT_K, VIT_K, ENC_DEPTH = 4, 8, 4
# 14b: the f32 round through the kernels against the plain path, from the
# same weights and batch (dropout off, TF32 off): the merged weights' change
# (L2 over the tree) within 1e-3 of the round's change, the loss within
# 1e-5 relative. Both paths sum in f32; the kernels' online softmax and
# tile order round differently (~1e-7 relative an attention output, phase
# 7), and those differences pass through ENC_DEPTH layers and 4 SGD steps
# with momentum; phase 9 holds one GPT step's gradients to 1e-3 of each
# tensor's largest entry for the same reason. lr 0.01, so that the
# change, not one f32 ulp of the weights, sets the ratio's scale
ENC_F32_W_RTOL, ENC_F32_LOSS_RTOL, ENC_F32_LR = 1e-3, 1e-5, 0.01
# 14b: [CLS] logits with 64 real tokens padded to 64 and to 128 (f32)
ENC_PAD_ATOL = 1e-5
# 14e: the registered ViT-Tiny function, its data and its job
ENC_JOB = "vit-smoke"
ENC_TRAIN, ENC_TEST = 8192, 1024
VIT_FN = """
import numpy as np
import torch
from kubeml_tpu_torch.data import transforms as T
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.vit import ViTTiny
from kubeml_tpu_torch.runtime.model import KubeModel


class Cifar100(KubeDataset):
    def __init__(self):
        super().__init__("cifar100")
        self.rng = np.random.default_rng(0)

    def transform(self, x, y):
        if self.is_training():
            x = T.cifar_train_transform(T.CIFAR100_MEAN, T.CIFAR100_STD,
                                        rng=self.rng)(x)
        else:
            x = T.cifar_eval_transform(T.CIFAR100_MEAN, T.CIFAR100_STD)(x)
        return x.astype(np.float32), y


class Vit(KubeModel):
    def __init__(self):
        super().__init__(Cifar100())

    def build(self):
        return ViTTiny(num_classes=100, dtype=torch.bfloat16)

    def configure_optimizers(self, params):
        return torch.optim.AdamW(params, lr=self.lr)
"""


def encoder_valid(B, L, seed: int = 1):
    """BERT's trailing padding: 0-120 PAD keys a row (seeded), row 1
    keeping only [CLS]."""
    gen = torch.Generator().manual_seed(seed)
    pads = torch.randint(0, 121, (B,), generator=gen)
    pads[0], pads[1] = 0, L - 1
    return (torch.arange(L)[None, :] < (L - pads)[:, None]).float()


def encoder_kernels(smi):
    """14a: the flash kernels at the encoders' shapes against their plain
    versions (bf16 and f32), then kernel / plain / SDPA / bound ms in
    bf16. Returns {tag: (bf16 errors, times)}."""
    timer = Timer()
    g = torch.Generator().manual_seed(SEED + 14)
    out = {}
    for tag, shape in (("i vit 65x65", ENC_VIT),
                       ("j bert 128 padded", ENC_BERT)):
        B, L, H = shape["B"], shape["L"], shape["H"]
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, valid = flash_inputs(g, B, L, L, 64, dtype,
                                              heads=H)
            if tag.startswith("j"):
                valid = encoder_valid(B, L).cuda()
            errs[dtype] = check_flash_case(tag, q, k, v, do, valid, False)
            if dtype == torch.bfloat16:
                times = flash_times(timer, q, k, v, do, valid, False)
        log(f"  flash {tag} bf16 times [{smi}]: " + json.dumps(times))
        out[tag] = (errs[torch.bfloat16], times)
    del timer
    torch.cuda.empty_cache()
    return out


def enc_round_ms(bench, rounds: int, reps: int = 3) -> float:
    """Best of ``reps`` runs of ``rounds`` rounds, ms a round."""
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            loss = bench.round()
        float(loss)
        best = min(best, (time.perf_counter() - t0) / rounds)
    return 1e3 * best


def enc_train(tag, bench, smi, rounds: int, per_round: int):
    """The encoder's bench configuration on the card (its main path, the
    flash counts zeroed before and read after): one warm-up and
    3 x ``rounds`` timed rounds, every round launching each flash kernel
    ``per_round`` times; a profiler window of 2 rounds; the loss falls;
    then the round through the plain path (``FLASH_MIN_KV_LEN = None``)
    and through the kernels again. Returns the row and the launches."""
    from kubeml_tpu_torch.ops import attention

    reset_flash_counts()
    row = bench.measure(rounds, reps=3)
    busy = device_profile(lambda: [bench.round() for _ in range(2)])[0]
    last = float(bench.round())
    counts = flash_counts()
    n_rounds = bench.rounds_run
    want = (per_round * n_rounds,) * 3
    if counts != want or tuple(row["flash_launches_per_round"].values()) \
            != (per_round,) * 3:
        raise AssertionError(f"{tag}: flash launches {counts} (one round "
                             f"{row['flash_launches_per_round']}), want "
                             f"{per_round} each a round x {n_rounds} "
                             f"rounds")
    if not (math.isfinite(last) and last < row["first_loss"]):
        raise AssertionError(f"{tag}: loss {row['first_loss']} -> {last} "
                             f"over {n_rounds} rounds")
    attention.FLASH_MIN_KV_LEN = None
    try:
        reset_flash_counts()
        plain_ms = enc_round_ms(bench, rounds)
        if flash_counts() != (0, 0, 0):
            raise AssertionError(f"{tag}: the plain path launched "
                                 f"{flash_counts()}")
    finally:
        attention.FLASH_MIN_KV_LEN = 0
    kernel_again = enc_round_ms(bench, rounds)
    flops = row["train_flops_per_sample"]
    log(f"  {tag}: {row['value']:.1f} samples/s, round {row['round_ms']:.3f}"
        f" ms (B {bench.batch}, K {bench.k}; best of 3 x {rounds} rounds), "
        f"max memory allocated {row['max_memory_allocated'] / 2**30:.3f} "
        f"GiB ({row['memory_allocated_at_start'] / 2**30:.3f} at the start, "
        f"earlier phases' tensors included); {flops / 1e9:.3f} GFLOP a "
        f"training sample (from the shapes: "
        f"dense layers and attention's two products, x 3): "
        f"{row['bf16_peak_fraction']:.4f} of the bf16 dense peak; loss "
        f"{row['first_loss']:.4f} -> {last:.4f} over {n_rounds} rounds; "
        f"flash launches a round {row['flash_launches_per_round']} "
        f"[{smi}]")
    if busy > 0:
        log(f"  {tag}: device busy {busy / 2:.3f} ms a round, unprofiled "
            f"round {row['round_ms']:.3f} ms: idle share "
            f"{1 - busy / (2 * row['round_ms']):.3f}")
    log(f"  {tag}: round through the kernels {row['round_ms']:.3f} ms, "
        f"through the plain path (FLASH_MIN_KV_LEN = None) {plain_ms:.3f} "
        f"ms, through the kernels again {kernel_again:.3f} ms [{smi}]")
    row.update(plain_round_ms=plain_ms, kernel_round_ms_again=kernel_again,
               last_loss=last)
    return row, counts


def enc_bert_gates(bench):
    """14b's other gates on bench_bert's weights: a round repeated from the
    same weights and rng is bit-identical, another rng moves the weights;
    [CLS] logits invariant to the pad length through the kernels (f32);
    one f32 round (dropout off) through the kernels against the plain
    path."""
    from kubeml_tpu_torch.benchmarks.transformers import bert_tokens
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.models.bert import BertBase
    from kubeml_tpu_torch.ops import attention

    tr = bench.trainer
    start = tr.snapshot(bench.variables)

    def round_from(rng):
        v = tr.place_reference(start, 1)
        v, loss = tr.sync_round(v, *bench.staged, lr=1e-3, rng=rng)
        return _flat(tr.reference_variables(v)), float(loss)

    a, la = round_from(101)
    b, lb = round_from(101)
    c, _ = round_from(102)
    same = all(np.array_equal(a[n], b[n]) for n in a) and la == lb
    moved = sum(not np.array_equal(a[n], c[n]) for n in a)
    log(f"  repeat: a round from the same weights and rng bit-identical: "
        f"{same}; another rng changes {moved}/{len(a)} leaves")
    if not same or moved == 0:
        raise AssertionError("bert rounds are not repeatable or ignore rng")

    # padding invariance through the kernels, f32 eval
    model = BertBase(num_classes=2, depth=ENC_DEPTH).cuda().eval()
    model.load_state_dict({k.split("/", 1)[1]: torch.from_numpy(v)
                           for k, v in a.items()})
    ids, _ = bert_tokens(4, 128)
    ids[:, 64:] = 0
    ids = torch.from_numpy(ids).cuda()
    reset_flash_counts()
    with torch.no_grad():
        short, long = model(ids[:, :64]), model(ids)
    if flash_counts()[0] != 2 * ENC_DEPTH:
        raise AssertionError(f"padding check launched {flash_counts()}")
    err = (short - long).abs().max().item()
    log(f"  padding invariance (f32, through the kernels): [CLS] logits of "
        f"4 rows, 64 positions vs the same padded to 128: max abs diff "
        f"{err:.2e} (tolerance {ENC_PAD_ATOL})")
    if not err <= ENC_PAD_ATOL:
        raise AssertionError(f"bert logits move with the pad length: {err}")
    del model

    # one f32 round, kernels vs plain, from the same weights and batch
    def f32_round(flash: bool):
        from kubeml_tpu_torch.benchmarks.harness import make_synthetic_model

        attention.FLASH_MIN_KV_LEN = 0 if flash else None
        try:
            t = KAvgTrainer(make_synthetic_model(
                BertBase(num_classes=2, dropout=0.0, depth=ENC_DEPTH)),
                precision="f32",
                device="cuda")
            v = t.place_reference(start, 1)
            sx, sy, sm = bench.staged
            reset_flash_counts()
            v, loss = t.sync_round(v, sx, sy, sm, lr=ENC_F32_LR)
            out = _flat(t.reference_variables(v)), float(loss), flash_counts()
            del t, v
            return out
        finally:
            attention.FLASH_MIN_KV_LEN = 0

    (kw, kl, kc), (pw, pl_, pc) = f32_round(True), f32_round(False)
    ref = {n: x.astype(np.float32) for n, x in _flat(
        {c: {k: t.cpu().numpy() for k, t in d.items()}
         for c, d in start.items()}).items()}
    w_rel = _l2(kw, pw) / _l2(pw, ref)
    loss_rel = abs(kl - pl_) / abs(pl_)
    log(f"  f32 round (dropout off, lr {ENC_F32_LR}), kernels vs plain: "
        f"|weights difference| / |round's change| {w_rel:.2e} (tolerance "
        f"{ENC_F32_W_RTOL}), loss {kl:.7f} vs {pl_:.7f} (rel "
        f"{loss_rel:.2e}, tolerance {ENC_F32_LOSS_RTOL}); launches "
        f"{kc} vs {pc}")
    if kc != (ENC_DEPTH * BERT_K,) * 3 or pc != (0, 0, 0):
        raise AssertionError(f"f32 rounds launched {kc} and {pc}")
    if not (w_rel <= ENC_F32_W_RTOL and loss_rel <= ENC_F32_LOSS_RTOL):
        raise AssertionError(f"f32 kernel round differs: weights {w_rel}, "
                             f"loss {loss_rel}")
    torch.cuda.empty_cache()


def cifar100_bands(n: int, seed: int):
    """A learnable CIFAR-100-shaped set: uint8 noise in [0, 128) with a
    band of three rows at one of 10 places in one of 10 colours, the pair
    giving the class."""
    r = np.random.default_rng(seed)
    y = r.integers(0, 100, size=n).astype(np.int64)
    x = r.integers(0, 128, size=(n, 32, 32, 3)).astype(np.uint8)
    for c in range(100):
        x[y == c, 3 * (c % 10):3 * (c % 10) + 3] = BAND_COLOURS[c // 10]
    return x, y


def enc_job(root):
    """14e: ``TrainJob`` with the registered ViT-Tiny function, its dataset
    transformed by ``data.transforms`` (train: crop + flip + normalise;
    validation: normalise), 2 epochs at parallelism 2, a checkpoint every
    epoch. Returns the flash launches of the job."""
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = Config(data_root=root)
    cfg.ensure_dirs()
    registry = FunctionRegistry(config=cfg)
    registry.create("vit", VIT_FN)
    store = ShardStore(root=cfg.datasets_dir)
    store.create("cifar100", *cifar100_bands(ENC_TRAIN, 4),
                 *cifar100_bands(ENC_TEST, 5))
    req = TrainRequest(
        model_type="vit", batch_size=128, epochs=2, dataset="cifar100",
        lr=1e-3, function_name="vit",
        options=TrainOptions(default_parallelism=2, static_parallelism=True,
                             k=4, precision="bf16", goal_accuracy=101.0,
                             checkpoint_every=1, save_model=True))
    ckpts = CheckpointStore(config=cfg)
    reset_flash_counts()
    job = TrainJob(ENC_JOB, req, registry.load("vit"), store=store,
                   history_store=HistoryStore(root=cfg.history_path),
                   checkpoint_store=ckpts, device="cuda")
    hist = job.train()
    counts = flash_counts()
    log(f"  TrainJob (ViT-Tiny, transforms): parallelism {hist.parallelism}"
        f", train loss {[round(v, 4) for v in hist.train_loss]}, validation "
        f"accuracy {[round(v, 2) for v in hist.accuracy]} %, epoch s "
        f"{[round(v, 3) for v in hist.epoch_duration]}; checkpoints "
        f"{ckpts.tags(ENC_JOB)}; flash launches {counts}")
    if not hist.train_loss[-1] < hist.train_loss[0]:
        raise AssertionError(f"train loss did not fall: {hist.train_loss}")
    if ckpts.tags(ENC_JOB) != ["ep00000", "ep00001", "final"]:
        raise AssertionError(f"checkpoints {ckpts.tags(ENC_JOB)}")
    if min(counts) <= 0 or counts[1] != counts[2]:
        raise AssertionError(f"the job's flash launches {counts}")
    return counts


def encoder_phase(smi, root):
    """14: the encoders' kernels at their shapes, BERT-base and ViT-Tiny
    trained by K-AVG at bench_bert's and bench_vit's configurations,
    VGG-11 (no kernel), and a ViT TrainJob. Returns the kernel rows and
    the flash launches of the phase's main paths."""
    from kubeml_tpu_torch.benchmarks.transformers import (EncoderBench,
                                                          bert_bench,
                                                          vit_bench)
    from kubeml_tpu_torch.models.bert import BertBase
    from kubeml_tpu_torch.models.vgg import VGG11
    from kubeml_tpu_torch.models.vit import ViT

    t0 = time.monotonic()
    log("  14a kernels at the encoder shapes")
    rows = encoder_kernels(smi)
    log(f"  14a {time.monotonic() - t0:.1f} s")
    total = np.zeros(3, np.int64)

    t0 = time.monotonic()
    log(f"  14b BERT-base at depth {ENC_DEPTH}: B {ENC_BERT['B']}, L "
        f"{ENC_BERT['L']}, K {BERT_K}, bf16, dropout 0.1, trailing padding, "
        f"N 1")
    bench = bert_bench(device="cuda", module=BertBase(
        num_classes=2, dtype=torch.bfloat16, depth=ENC_DEPTH))
    bert_row, counts = enc_train("bert-base", bench, smi, rounds=6,
                                 per_round=ENC_DEPTH * BERT_K)
    total += counts
    enc_bert_gates(bench)
    del bench
    torch.cuda.empty_cache()
    log(f"  14b {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    log(f"  14c ViT-Tiny at depth {ENC_DEPTH}: B {ENC_VIT['B']}, L "
        f"{ENC_VIT['L']}, K {VIT_K}, bf16, N 1")
    bench = vit_bench(device="cuda", module=ViT(
        num_classes=100, patch_size=4, embed_dim=192, depth=ENC_DEPTH,
        num_heads=3, dtype=torch.bfloat16))
    vit_row, counts = enc_train("vit-tiny", bench, smi, rounds=6,
                                per_round=ENC_DEPTH * VIT_K)
    total += counts
    del bench
    torch.cuda.empty_cache()
    log(f"  14c {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    log("  14d VGG-11: CIFAR-100 shapes, bf16, B 128, K 8, dropout 0.5, N 1")
    r = np.random.default_rng(SEED)
    sample = r.normal(size=(128, 32, 32, 3)).astype(np.float32)
    labels = r.integers(0, 100, size=(128,)).astype(np.int64)
    bench = EncoderBench("vgg11-cifar100", VGG11(num_classes=100,
                                                 dtype=torch.bfloat16),
                         sample, labels, k=8, device="cuda")
    reset_kernel_counts()
    vrow = bench.measure(5, reps=3)
    last = float(bench.round())
    kc = kernel_counts()
    log(f"  vgg11: {vrow['value']:.1f} samples/s, round "
        f"{vrow['round_ms']:.3f} ms, loss {vrow['first_loss']:.4f} -> "
        f"{last:.4f} over {bench.rounds_run} rounds; hand-written kernel "
        f"launches {kc} [{smi}]")
    if any(kc):
        raise AssertionError(f"VGG-11 launched {kc}")
    if not (math.isfinite(last) and last < vrow["first_loss"]):
        raise AssertionError(f"vgg11 loss {vrow['first_loss']} -> {last}")
    del bench
    torch.cuda.empty_cache()
    log(f"  14d {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    log("  14e TrainJob")
    total += enc_job(Path(root) / "encoders")
    log(f"  14e {time.monotonic() - t0:.1f} s")
    return rows, tuple(int(c) for c in total), bert_row, vit_row


# --- phase 15: MoE and the dense slot engine -------------------------------

# bench_moe (kubeml_tpu/benchmarks/transformers.py:107-158) at full width:
# the GPT-2-small skeleton, vocab 32000, L 512, 12 heads of 64, 12 blocks
# (an MoE block every other one: 8 experts, top-2), B 16, bf16; no remat;
# depth cut from 12 to 6 blocks to keep the script within its time with
# phase 17, and to 4 (2 of them MoE; width, experts, routing, B and L as
# bench_moe) with phase 18
MOE_B, MOE_L, MOE_H, MOE_DEPTH, MOE_VOCAB = 16, 512, 12, 4, 32000
MOE_STEPS = 8
MOE_JOB, DENSE_JOB = "gpt-moe", "gpt2-dense"
# bench_moe's model in f32 as a registered function: the parameter server
# builds it and loads the trained weights' f32 copy into it
MOE_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.runtime.model import KubeModel


class MoE(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("tokens"))

    def build(self):
        return CausalTransformer(vocab_size=%d, max_len=%d, embed_dim=768,
                                 depth=%d, num_heads=12, moe_every=2,
                                 num_experts=8, top_k=2, seed=%d,
                                 device="cpu")
"""


def moe_f32():
    """bench_moe's model in f32 on the card (MOE_FN's module)."""
    from kubeml_tpu_torch.models.gpt import CausalTransformer

    return CausalTransformer(vocab_size=MOE_VOCAB, max_len=MOE_L,
                             embed_dim=768, depth=MOE_DEPTH, num_heads=12,
                             moe_every=2, num_experts=8, top_k=2, seed=SEED,
                             device="cuda").eval()


def moe_workload(rng):
    """16 requests: prompts of 16-400 tokens, 32-96 new tokens."""
    return [dict(prompt=rng.integers(1, MOE_VOCAB,
                                     size=int(rng.integers(16, 401))
                                     ).astype(np.int32),
                 max_new=int(rng.integers(32, 97))) for _ in range(16)]


def serve_mix_ps(ps, job, reqs, sample: bool = False):
    """The requests from threads through ``ps.generate`` (sampled with
    ``SAMPLE``'s knobs, request i seeded 1000 + i, when ``sample``).
    Returns the token lists, tokens/s and the decoder's telemetry."""
    from kubeml_tpu_torch.api import GenerateRequest

    results, errors = [None] * len(reqs), []

    def client(i):
        r = reqs[i]
        knobs = dict(SAMPLE, seed=1000 + i) if sample else {}
        try:
            results[i] = ps.generate(job, GenerateRequest(
                prompts=[r["prompt"].tolist()], max_new_tokens=r["max_new"],
                **knobs))
        except Exception as e:  # surfaced below, after the join
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    toks = [r["tokens"][0][:r["lengths"][0]] for r in results]
    n = sum(map(len, toks))
    return dict(tokens=toks, n=n, wall=wall, tokens_per_s=n / wall,
                tele=ps._decoders[job][0].telemetry())


def report_dense(tag, run, smi, launches) -> None:
    from kubeml_tpu_torch.benchmarks.paged_serving import telemetry_row

    r = telemetry_row(run["tele"], run["tokens_per_s"])
    log(f"  {tag} [{smi}]: {run['n']} tokens in {run['wall']:.3f} s = "
        f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{1e3 * r['ttft_p50_seconds']:.1f} ms, decode step "
        f"{r['decode_step_ms']:.3f} ms ({int(run['tele']['device_steps'])} "
        f"steps, {int(run['tele']['admission_waves'])} prefill waves, "
        f"occupancy {r['batch_occupancy_ratio']:.3f}); launches "
        f"paged_attention {launches[0]}, int8_matmul {launches[1]}, flash "
        f"{sum(launches[2:])}")


def dense_logits(module, prompt, forced):
    """The next-token logits after ``prompt + forced`` through ``module``'s
    dense decode path (one prefill: the decode path is causally
    consistent, MoE routing uncapped)."""
    from kubeml_tpu_torch.models.generation import init_cache

    ids = torch.tensor([list(prompt) + list(forced)], device="cuda")
    with torch.inference_mode():
        return module(ids, decode=True,
                      cache=init_cache(module, 1))[0, -1].float()


def check_one_shot(tag, got, module, reqs, tie=NEAR_TIE):
    """Greedy serving tokens against the one-shot dense ``generate`` per
    request on ``module``: identical, or diverging only where the one-shot
    path's two largest logits at the first differing position lie within
    ``tie`` (logged). Returns (the one-shot token lists, the near ties)."""
    from kubeml_tpu_torch.models.generation import generate

    want, ties = [], []
    for i, r in enumerate(reqs):
        out = generate(module, r["prompt"][None], max_new_tokens=r["max_new"])
        w = out.tokens[0, :int(out.lengths[0])].tolist()
        want.append(w)
        if got[i] == w:
            continue
        j = next((n for n, (a, b) in enumerate(zip(got[i], w)) if a != b),
                 None)
        if j is None:
            raise AssertionError(f"{tag}: request {i} emitted "
                                 f"{len(got[i])} tokens, one-shot {len(w)}")
        top = dense_logits(module, r["prompt"], w[:j]).topk(2).values
        gap = (top[0] - top[1]).item()
        log(f"  {tag}: request {i} differs at token {j} ({got[i][j]} vs "
            f"{w[j]}); one-shot top-two logit gap {gap:.3e}")
        if not gap <= tie:
            raise AssertionError(f"{tag}: greedy tokens differ from the "
                                 f"one-shot generate (request {i}, token "
                                 f"{j}, gap {gap:.3e} > {tie})")
        ties.append((i, j))
    return want, ties


def moe_train(smi):
    """15a: the flash kernels at bench_moe's shape against their plain
    versions (bf16 and f32) with kernel / plain / SDPA / bound ms, then
    bench_moe's configuration trained by SPMDTrainer (the flash counts
    zeroed before and read after): one warm-up and 3 x MOE_STEPS timed
    steps, each flash kernel MOE_DEPTH launches a step, the loss falling, the
    overflow in [0, 1]; a profiler window of 2 steps. Returns the bench,
    its row, the bf16 errors, the times and the launches."""
    from kubeml_tpu_torch.benchmarks.transformers import MoEBench

    timer = Timer()
    g = torch.Generator().manual_seed(SEED + 15)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, valid = flash_inputs(g, MOE_B, MOE_L, MOE_L, 64, dtype,
                                          heads=MOE_H)
        errs[dtype] = check_flash_case("k moe 512 causal", q, k, v, do,
                                       valid, True)
        if dtype == torch.bfloat16:
            times = flash_times(timer, q, k, v, do, valid, True)
        del q, k, v, do, valid
    log(f"  flash k moe 512 causal bf16 times [{smi}]: " + json.dumps(times))
    del timer
    torch.cuda.empty_cache()

    bench = MoEBench(MOE_B, MOE_L, device="cuda", depth=MOE_DEPTH)
    reset_flash_counts()
    row = bench.measure(MOE_STEPS, reps=3)
    busy = device_profile(lambda: [bench.step() for _ in range(2)])[0]
    counts = flash_counts()
    n = bench.steps_run
    per_step = tuple(row["flash_launches_per_step"].values())
    if counts != (MOE_DEPTH * n,) * 3 or per_step != (MOE_DEPTH,) * 3:
        raise AssertionError(f"15a: flash launches {counts} over {n} steps "
                             f"(one step {per_step}), want {MOE_DEPTH} each "
                             f"a step")
    losses = row["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"15a: loss {losses[0]} -> {losses[-1]}")
    if not 0.0 <= row["moe_overflow"] <= 1.0:
        raise AssertionError(f"15a: overflow {row['moe_overflow']}")
    terms = row["flops_forward_terms"]
    log(f"  15a gpt-moe [{smi}]: {row['value']:.1f} tokens/s, "
        f"{row['steps_per_sec']:.3f} steps/s, step {row['step_ms']:.3f} ms "
        f"(B {MOE_B}, L {MOE_L}; best of 3 x {MOE_STEPS} steps), max memory "
        f"allocated {row['max_memory_allocated'] / 2**30:.3f} GiB "
        f"({row['memory_allocated_at_start'] / 2**30:.3f} at the start, "
        f"earlier phases' tensors included); moe_overflow "
        f"{row['moe_overflow']:.4f} (capacity {row['capacity']}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
        f"flash launches a step {row['flash_launches_per_step']}")
    log(f"  15a FLOPs a step (analytic, 3 x forward): "
        f"{row['flops_per_step'] / 1e12:.3f} TFLOP = {row['mfu']:.4f} of the "
        f"bf16 dense peak; useful expert FFNs (top-2, kept) "
        f"{row['useful_expert_ffn_flops_per_step'] / 1e12:.3f} TFLOP = "
        f"{row['useful_expert_ffn_peak_fraction']:.4f}; forward terms "
        + ", ".join(f"{k} {v / 1e9:.1f} GF" for k, v in terms.items())
        + f"; the one-hot dispatch and combine cost "
        f"{row['dispatch_combine_over_expert_ffn']:.2f} x the expert FFNs "
        f"at capacity")
    if busy > 0:
        log(f"  15a: device busy {busy / 2:.3f} ms a step, unprofiled step "
            f"{row['step_ms']:.3f} ms: idle share "
            f"{1 - busy / (2 * row['step_ms']):.3f}")
    return bench, row, errs[torch.bfloat16], times, counts


def moe_serve(smi, root, bench):
    """15b: 15a's weights (an f32 copy) saved as ``final`` and quantized
    into ``final-int8``, each served from threads through
    ``ParameterServer.generate`` by the dense engine (8 slots): greedy
    tokens equal to the one-shot dense ``generate`` per request but for
    near ties; no hand-written kernel launches (MoE decode attends over a
    dense cache on the plain path and dequantizes int8 in each step)."""
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.interop.from_flax import from_flax, to_flax
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.ps import ParameterServer
    from kubeml_tpu_torch.serving import BatchingDecoder
    from kubeml_tpu_torch.serving.quant import (INT8_TAG, dequantize_tree,
                                                from_storage_tree,
                                                quantize_final_checkpoint)
    from kubeml_tpu_torch.storage import FINAL_TAG, CheckpointStore

    kw = dict(data_root=Path(root), serving_slots=SLOTS,
              serving_chunk_steps=CHUNK)
    cfg = Config(**kw)
    cfg.ensure_dirs()
    FunctionRegistry(config=cfg).create("moe", MOE_FN % (
        MOE_VOCAB, MOE_L, MOE_DEPTH, SEED))
    store = CheckpointStore(config=cfg)
    tree = to_flax({k: v.float() for k, v in
                    bench.module.state_dict().items()})
    store.save(MOE_JOB, tree, epoch=1, tag=FINAL_TAG,
               meta={"request": {"function_name": "moe"}})
    quantize_final_checkpoint(MOE_JOB, store)
    reqs = moe_workload(np.random.default_rng(SEED + 15))
    ref = moe_f32()
    out = {}
    for tag, extra in (("f32", {}),
                       ("int8", dict(serving_quantize="int8",
                                     int8_matmul=True))):
        ps = ParameterServer(config=Config(**kw, **extra))
        reset_kernel_counts()
        dec, load_ms, build_ms = cold_serving(ps, MOE_JOB)
        run = serve_mix_ps(ps, MOE_JOB, reqs)
        launches = kernel_counts()
        log(f"  15b {tag}: cold _load_serving {load_ms:.1f} ms, decoder "
            f"build {build_ms:.1f} ms")
        if not isinstance(dec, BatchingDecoder) or (
                tag == "int8" and (dec.quantize != "int8"
                                   or dec.int8_matmul)):
            raise AssertionError(f"15b {tag}: served by {type(dec).__name__}"
                                 f" (quantize {dec.quantize!r}, int8_matmul "
                                 f"{dec.int8_matmul})")
        report_dense(f"15b MoE {tag} (dense engine, PS)", run, smi, launches)
        if any(launches):
            raise AssertionError(f"15b {tag}: kernels launched {launches}")
        # the one-shot reference: the same weights, dense (int8: the
        # final-int8 tree dequantized, the values each step computes)
        src = (from_storage_tree(store.restore(MOE_JOB, tag=INT8_TAG)
                                 .variables) if tag == "int8" else tree)
        load_tree(ref, dequantize_tree(from_flax(src), torch.float32))
        want, ties = check_one_shot(f"15b {tag}", run["tokens"], ref, reqs)
        log(f"  15b {tag}: greedy tokens equal to the one-shot dense "
            f"generate ({run['n']} tokens; near ties {ties or 'none'})")
        out[tag] = run
        ps.close()
        del ps, dec
        torch.cuda.empty_cache()
    return out


def ab_row(engine, weights, tele, tokens_per_s):
    """One engine's row in ``benchmarks/paged_serving.py``'s form."""
    from kubeml_tpu_torch.benchmarks.paged_serving import telemetry_row

    return {"metric": "paged-serving-demo", "engine": engine,
            "weights": weights, **telemetry_row(tele, tokens_per_s)}


# 15c serves the mix's first DENSE_N requests (cut from 16 to make room
# for phase 23)
DENSE_N = 8


def dense_serve(smi, root, run):
    """15c: phase 4's GPT-2-small weights saved as ``final`` (and
    ``final-int8``) and served through ``ParameterServer.generate`` with
    ``serving_paged=False`` (the dense engine): (f32) greedy tokens equal
    to phase 4's paged engine (``run``) but for near ties; (int8) with
    ``serving_quantize=int8`` and the int8 matmul: 73 ``int8_matmul``
    launches a forward, no paged attention, greedy tokens equal to a
    paged engine with the same int8 weights and f32 pages but for near
    ties; (sampled) a hand-built dense and paged engine, seeded: the same
    tokens. Returns the (paged_attention, int8_matmul) launches."""
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.interop.from_flax import to_flax
    from kubeml_tpu_torch.ps import ParameterServer
    from kubeml_tpu_torch.serving import (BatchingDecoder,
                                          PagedBatchingDecoder)
    from kubeml_tpu_torch.serving.quant import quantize_final_checkpoint
    from kubeml_tpu_torch.storage import FINAL_TAG, CheckpointStore

    kw = dict(data_root=Path(root), serving_slots=SLOTS,
              serving_chunk_steps=CHUNK, serving_paged=False)
    cfg = Config(**kw)
    cfg.ensure_dirs()
    FunctionRegistry(config=cfg).create("gpt2", GPT2_FN % (VOCAB, MAX_LEN,
                                                            SEED))
    store = CheckpointStore(config=cfg)
    model = gpt2_small()
    store.save(DENSE_JOB, to_flax(model.state_dict()), epoch=1,
               tag=FINAL_TAG, meta={"request": {"function_name": "gpt2"}})
    quantize_final_checkpoint(DENSE_JOB, store)
    reqs = workload(np.random.default_rng(SEED))
    prompts = [reqs[5]["prompt"]] + [r["prompt"] for r in reqs]
    common = dict(slots=SLOTS, page_tokens=PAGE_TOKENS, chunk_steps=CHUNK,
                  device="cuda")
    rows, launches = [ab_row("paged", "f32", run["tele"],
                             run["tokens_per_s"])], [0, 0]

    # f32 through the parameter server
    ps = ParameterServer(config=cfg)
    reset_kernel_counts()
    cold_serving(ps, DENSE_JOB)
    drun = serve_ps(ps, DENSE_JOB, reqs, run["eos"], n=DENSE_N)
    f_launches = kernel_counts()
    if not isinstance(ps._decoders[DENSE_JOB][0], BatchingDecoder):
        raise AssertionError("15c f32: not served by the dense engine")
    ps.close()
    drun["n"] = drun["tokens"]
    report_dense("15c GPT-2-small f32 (dense engine, PS)", drun, smi,
                 f_launches)
    ref_dec = PagedBatchingDecoder(model, **common)
    ties = check_greedy("15c f32", token_lists(drun), token_lists(run),
                        prompts, ref_dec, first=-1,
                        against="phase 4's paged engine")
    log(f"  15c f32: greedy tokens equal to phase 4's paged engine "
        f"({drun['tokens']} tokens; near ties {ties or 'none'})")
    if any(f_launches):
        raise AssertionError(f"15c f32: kernels launched {f_launches}")
    rows.append(ab_row("slot", "f32", drun["tele"], drun["tokens_per_s"]))
    ref_dec.close()
    del ref_dec, model

    # int8 weights: the paged engine with f32 pages, then the dense one
    qref = PagedBatchingDecoder(gpt2_small(), quantize="int8",
                                int8_matmul=True, **common)
    reset_kernel_counts()
    qprun = serve(qref, reqs, n=DENSE_N)
    report_serve("15c paged int8 weights, f32 pages", qprun)
    rows.append(ab_row("paged", "int8", qprun["tele"],
                       qprun["tokens_per_s"]))
    ps = ParameterServer(config=Config(**kw, serving_quantize="int8",
                                       int8_matmul=True))
    reset_kernel_counts()
    cold_serving(ps, DENSE_JOB)
    qrun = serve_ps(ps, DENSE_JOB, reqs, qprun["eos"], n=DENSE_N)
    q_launches = kernel_counts()
    qdec = ps._decoders[DENSE_JOB][0]
    forwards = int(qrun["tele"]["admission_waves"]
                   + qrun["tele"]["device_steps"])
    ps.close()
    qrun["n"] = qrun["tokens"]
    report_dense("15c GPT-2-small int8 (dense engine, PS)", qrun, smi,
                 q_launches)
    if (not isinstance(qdec, BatchingDecoder) or not qdec.int8_matmul
            or qdec.int8_matmul_impl != "cuda"):
        raise AssertionError("15c int8: not the dense engine on the int8 "
                             "matmul kernel")
    if q_launches != (0, INT8_PER_FORWARD * forwards, 0, 0, 0):
        raise AssertionError(f"15c int8: launches {q_launches}, want (0, "
                             f"{INT8_PER_FORWARD} x {forwards} forwards, 0)")
    log(f"  15c int8: int8_matmul {q_launches[1]} launches = "
        f"{INT8_PER_FORWARD} x {forwards} forwards, paged_attention 0")
    ties = check_greedy("15c int8", token_lists(qrun), token_lists(qprun),
                        prompts, qref, first=-1,
                        against="the paged int8 engine")
    log(f"  15c int8: greedy tokens equal to the paged engine with the same"
        f" int8 weights ({qrun['tokens']} tokens; near ties "
        f"{ties or 'none'})")
    rows.append(ab_row("slot", "int8", qrun["tele"], qrun["tokens_per_s"]))
    qref.close()
    launches[1] += q_launches[1]
    del qref

    # seeded sampling, slot against paged
    sampled = {}
    for name, build in (("slot", lambda: BatchingDecoder(
            gpt2_small(), slots=SLOTS, chunk_steps=CHUNK, device="cuda")),
            ("paged", lambda: PagedBatchingDecoder(gpt2_small(),
                                                   **common))):
        dec = build()
        sampled[name] = serve(dec, reqs, sample=True, n=DENSE_N)
        dec.close()
    a, b = token_lists(sampled["slot"]), token_lists(sampled["paged"])
    if a != b:
        bad = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        raise AssertionError(f"15c: seeded sampling differs slot vs paged "
                             f"(request {bad - 1}): {a[bad][:12]} vs "
                             f"{b[bad][:12]}")
    log(f"  15c sampled ({SAMPLE}, seeds 1000 + i): the same "
        f"{sum(map(len, a))} tokens slot and paged")
    for r in rows:
        log("  " + json.dumps({**r, "card": smi}))
    torch.cuda.empty_cache()
    return tuple(launches)


def moe_phase(smi, root, run):
    """Phase 15 (see the module docstring). Returns 15a's row, its flash
    errors, times and launches, and 15c's (paged_attention, int8_matmul)
    launches."""
    t0 = time.monotonic()
    log(f"  15a gpt-moe training: B {MOE_B}, L {MOE_L}, E 768, depth "
        f"{MOE_DEPTH}, 8 experts, top-2, bf16, AdamW 3e-4, SPMDTrainer")
    bench, row, errs, times, counts = moe_train(smi)
    log(f"  15a {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    moe_serve(smi, Path(root) / "moe", bench)
    del bench
    torch.cuda.empty_cache()
    log(f"  15b {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = dense_serve(smi, Path(root) / "dense", run)
    log(f"  15c {time.monotonic() - t0:.1f} s")
    return row, errs, times, counts, launches


# --- phase 16: the one-shot speculative generate and the SPMD job -------

# 16a: prompts of ONESHOT_LP tokens, ONESHOT_NEW new tokens, at B 1 and 8
ONESHOT_LP, ONESHOT_NEW, ONESHOT_BATCHES = 64, 64, (1, 8)
# int8 matmul launches of one self-drafting forward (EXIT_LAYER blocks of
# 6 projections and the lm_head)
INT8_PER_DRAFT = 6 * EXIT_LAYER + 1
# 16b: the long-context flagship's SPMD job: B 8 x L 2048, 4 steps an
# epoch (32 training rows), one validation batch (8 rows)
LC_JOB, LC_L, LC_B, LC_TRAIN, LC_TEST = "lc-spmd", 2048, 8, 32, 8
LC_VOCAB, LC_EPOCHS, LC_SEED = 32000, 2, 16
LC_MODEL = dict(vocab_size=LC_VOCAB, max_len=LC_L, embed_dim=512,
                depth=DEPTH, num_heads=8, remat=True)
LC_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel


class LongContext(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("lc-tokens"))

    def build(self):
        # bf16 compute to train, f32 to serve
        dtype = torch.bfloat16 if self.task == "train" else torch.float32
        return CausalTransformer(vocab_size=32000, max_len=2048,
                                 embed_dim=512, depth=8, num_heads=8,
                                 remat=True, dtype=dtype, mesh=self.mesh)

    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""
# 16b's served requests: (rows, prompt tokens, new tokens)
LC_SERVE = ((4, 48, 32), (1, 200, 48))
# the M of the served int8 projections: decode at 1 and 4 rows, the
# prefills of a 48-token prompt (alone and 4 rows) and a 200-token one
LC_MM_M = (1, 4, 48, 192, 200)


def oneshot_expected(spec, model_depth, draft_depth, quantized, steps):
    """(paged_attention, int8_matmul) launches of one one-shot spec call:
    the target's prefill (depth launches, L 64), then a step's k drafter
    forwards at L 1 (EXIT_LAYER blocks; the draft backend's drafter k + 1
    times over its own depth, the last write-only, after its own prefill)
    and one L k+1 verify over the target's depth. int8 weights: 73 a
    target forward, INT8_PER_DRAFT a self-drafting one (the drafter of the
    draft backend stays f32)."""
    if spec == "self":
        pa = model_depth + steps * (SPEC_K * EXIT_LAYER + model_depth)
        mm = INT8_PER_FORWARD * (1 + steps) + steps * SPEC_K * INT8_PER_DRAFT
    else:
        pa = (model_depth + draft_depth
              + steps * ((SPEC_K + 1) * draft_depth + model_depth))
        mm = INT8_PER_FORWARD * (1 + steps)
    return pa, (mm if quantized else 0)


def check_rows(tag, got, want, module, prompts):
    """Greedy token rows against reference rows: identical, or diverging
    only where ``module``'s dense path at the first difference has its
    two largest logits within NEAR_TIE (logged with the margin). Returns
    the near ties."""
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((n for n, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            raise AssertionError(f"{tag}: row {b} emitted {len(g)} tokens, "
                                 f"the reference {len(w)}")
        top = dense_logits(module, list(prompts[b]), w[:j]).topk(2).values
        gap = (top[0] - top[1]).item()
        log(f"  {tag}: row {b} differs at token {j} ({g[j]} vs {w[j]}); "
            f"reference top-two logit gap {gap:.3e}")
        if not gap <= NEAR_TIE:
            raise AssertionError(f"{tag}: greedy tokens differ (row {b}, "
                                 f"token {j}, gap {gap:.3e} > {NEAR_TIE})")
        ties.append((b, j))
    return ties


def rows_of(out):
    return [out.tokens[b, :int(out.lengths[b])].tolist()
            for b in range(out.tokens.shape[0])]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def oneshot_spec(smi):
    """16a (see the module docstring). Returns its (paged_attention,
    int8_matmul) launches."""
    from kubeml_tpu_torch.benchmarks.spec_decode import coherent_tail
    from kubeml_tpu_torch.models import CausalTransformer
    from kubeml_tpu_torch.models.generation import (
        generate, make_speculative_generate_fn)
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serving.quant import quantize_tree

    target = coherent_tail(gpt2_small(), EXIT_LAYER)
    qtarget = copy.deepcopy(target)
    load_tree(qtarget, quantize_tree(qtarget.state_dict()))
    drafter = CausalTransformer(vocab_size=VOCAB, max_len=MAX_LEN,
                                attn_bias=True, ln_eps=1e-5, seed=SEED + 1,
                                device="cuda", **DRAFT)
    rng = np.random.default_rng(SEED + 16)
    total = [0, 0]
    for weights, model in (("f32", target), ("int8", qtarget)):
        for B in ONESHOT_BATCHES:
            prompt = rng.integers(1, VOCAB, size=(B, ONESHOT_LP))
            ref, off_s = timed(lambda: generate(
                model, prompt, max_new_tokens=ONESHOT_NEW))
            want = rows_of(ref)
            for spec in ("self", "draft"):
                fn = make_speculative_generate_fn(
                    model, max_new_tokens=ONESHOT_NEW, spec=spec,
                    spec_k=SPEC_K, exit_layer=EXIT_LAYER,
                    draft_module=drafter if spec == "draft" else None)
                paged_attention.launches = int8_matmul.launches = 0
                out, spec_s = timed(lambda: fn(prompt))
                launches = (paged_attention.launches, int8_matmul.launches)
                tag = f"16a {weights} B {B} spec={spec}"
                ties = check_rows(tag, rows_of(out), want, model, prompt)
                expect = oneshot_expected(spec, model.depth, DRAFT["depth"],
                                          weights == "int8", out.steps)
                n = int(out.lengths.sum())
                log(f"  {tag} [{smi}]: proposed/accepted/drafted/steps "
                    f"{out.proposed}/{out.accepted}/{out.drafted}/"
                    f"{out.steps}, {n / spec_s:.1f} tokens/s against "
                    f"spec-off {int(ref.lengths.sum()) / off_s:.1f} "
                    f"({off_s / spec_s:.3f}x); launches paged_attention "
                    f"{launches[0]} ({out.steps * model.depth} at L "
                    f"{SPEC_K + 1}), int8_matmul {launches[1]}; greedy "
                    f"tokens equal to spec-off but near ties "
                    f"{ties or 'none'}")
                if launches != expect or min(launches[0], out.steps) <= 0:
                    raise AssertionError(f"{tag}: launches {launches}, the "
                                         f"path's count {expect}")
                if weights == "int8" and launches[1] <= 0:
                    raise AssertionError(f"{tag}: no int8 matmul launch")
                total[0] += launches[0]
                total[1] += launches[1]
    del target, qtarget, drafter
    torch.cuda.empty_cache()
    return tuple(total)


def lc_module(tree):
    """The flagship's f32 module on the card holding a restored tree (its
    depth the tree's); int8 projections take the plain ``int8_dot``, so
    the served tokens are held against a path without the int8 kernel."""
    from kubeml_tpu_torch.interop.from_flax import from_flax
    from kubeml_tpu_torch.models import CausalTransformer
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.serving.quant import (from_storage_tree,
                                                is_quantized_storage)

    if is_quantized_storage(tree):
        tree = from_storage_tree(tree)
    flat = from_flax(tree)
    depth = sum(name.endswith(".ln1.scale") for name in flat)
    module = CausalTransformer(**dict(LC_MODEL, depth=depth), device="cuda")
    return load_tree(module, flat, int8_impl="dot").eval()


def lc_int8_check(smi, module, phase="16b"):
    """The int8 matmul on the flagship's int8 projections (every distinct
    (K, N), the restored weights) at LC_MM_M, f32 x, against int8_dot
    within MM_RTOL."""
    from kubeml_tpu_torch.models.layers import QuantizableDense
    from kubeml_tpu_torch.ops.int8_matmul import int8_dot, int8_matmul

    g = torch.Generator().manual_seed(LC_SEED)
    layers = {}
    for m in module.modules():
        if isinstance(m, QuantizableDense) and m.quantized:
            layers.setdefault(tuple(m.kernel_q.shape), m)
    worst = 0.0
    for (K, N), m in sorted(layers.items()):
        for M in LC_MM_M:
            x = torch.randn(M, K, generator=g).cuda()
            y = int8_matmul(x, m.kernel_q, m.kernel_s)
            ref = int8_dot(x, m.kernel_q, m.kernel_s)
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not err <= MM_RTOL[torch.float32] * scale:
                raise AssertionError(
                    f"{phase} int8_matmul M={M} K={K} N={N}: max abs err "
                    f"{err} > {MM_RTOL[torch.float32]} x {scale}")
            worst = max(worst, err / scale)
    log(f"  {phase} int8_matmul against int8_dot [{smi}]: (K, N) "
        f"{sorted(layers)} x M {LC_MM_M}, f32, worst max abs err / "
        f"max |ref| {worst:.3g} (limit {MM_RTOL[torch.float32]})")


def lc_serve(smi, tag, client, tree, rng, job=LC_JOB, phase="16b"):
    """LC_SERVE through ``/generate`` from ``job``'s export, then the
    in-process ``generate`` on the restored weights; returns the served
    (paged_attention, int8_matmul) launches."""
    from kubeml_tpu_torch.models.generation import generate
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    module = lc_module(tree)
    total, served = [0, 0], []
    for rows, plen, new in LC_SERVE:
        prompt = rng.integers(1, LC_VOCAB, size=(rows, plen))
        paged_attention.launches = int8_matmul.launches = 0
        out, wall = timed(lambda: client.networks().generate(
            job, prompt, max_new_tokens=new))
        total[0] += paged_attention.launches
        total[1] += int8_matmul.launches
        got = [t[:n] for t, n in zip(out["tokens"], out["lengths"])]
        served.append((prompt, got, wall))
    log(f"  {phase} {tag} served [{smi}]: "
        + ", ".join(f"{len(g)} x {p.shape[1]}-token prompts, "
                    f"{sum(map(len, g))} tokens in {w * 1e3:.1f} ms"
                    for p, g, w in served)
        + f"; launches paged_attention {total[0]}, int8_matmul {total[1]}")
    for prompt, got, _ in served:
        ref = generate(module, prompt, max_new_tokens=len(got[0]))
        ties = check_rows(f"{phase} {tag}", got, rows_of(ref), module,
                          prompt)
        log(f"  {phase} {tag}: tokens equal to the in-process generate on "
            f"the restored weights (int8 through int8_dot), near ties "
            f"{ties or 'none'}")
    if total[1]:
        lc_int8_check(smi, module, phase)
    del module
    torch.cuda.empty_cache()
    return tuple(total)


def spmd_job(smi, root, bare_step_ms):
    """16b (see the module docstring). Returns the flash counts of the
    job's training steps and the served (paged_attention, int8_matmul)
    launches."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.storage.sharded_checkpoint import \
        ShardedCheckpointStore

    cfg = cp_config(Path(root) / "spmd")
    rng = np.random.default_rng(LC_SEED)
    x = rng.integers(1, LC_VOCAB, size=(LC_TRAIN + LC_TEST, LC_L)
                     ).astype(np.int32)
    y = np.zeros(len(x), np.int64)

    def train(client, epochs, **opts):
        return client.networks().train(TrainRequest(
            model_type="gpt", batch_size=LC_B, epochs=epochs,
            dataset="lc-tokens", lr=3e-4, function_name="longctx",
            job_id=LC_JOB, options=TrainOptions(
                engine="spmd", precision="bf16", sharded_checkpoints=True,
                checkpoint_every=1, static_parallelism=True, **opts)))

    steps = LC_EPOCHS * (LC_TRAIN // LC_B)
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        client.datasets().create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                 x[LC_TRAIN:], y[LC_TRAIN:])
        client.functions().create("longctx", LC_FN)
        reset_flash_counts()
        t0 = time.monotonic()
        train(client, LC_EPOCHS)
        hist = cp_wait_job(cluster, LC_JOB)
        wall = time.monotonic() - t0
        counts = flash_counts()
        if hist.task.get("error") or len(hist.train_loss) != LC_EPOCHS:
            raise AssertionError(f"16b: the job ended with {hist.train_loss}"
                                 f", error {hist.task.get('error')}")
        # validation forwards: one batch an epoch, depth forward launches
        evals = LC_EPOCHS * (LC_TEST // LC_B)
        per_step = ((counts[0] - DEPTH * evals) / steps, counts[1] / steps,
                    counts[2] / steps)
        step_ms = 1e3 * hist.epoch_duration[-1] / (LC_TRAIN // LC_B)
        log(f"  16b {LC_JOB} [{smi}]: /train engine=spmd, sharded "
            f"checkpoints, {LC_EPOCHS} epochs x {LC_TRAIN // LC_B} steps of "
            f"B {LC_B} x L {LC_L}: train loss {hist.train_loss}, eval loss "
            f"{hist.validation_loss}, next-token accuracy {hist.accuracy} "
            f"%, {wall:.1f} s from /train to the history; epoch 2 step "
            f"{step_ms:.2f} ms (the epoch's host wall over its steps, its "
            f"checkpoint write excluded) against phase 8's bare "
            f"SPMDTrainer step {bare_step_ms:.2f} ms; flash launches "
            f"fwd/dq/dkv {counts}, a step {per_step} (phase 8: "
            f"{2 * DEPTH}/{DEPTH}/{DEPTH}, remat; {evals} validation "
            f"forwards of {DEPTH} fwd apart)")
        if not hist.train_loss[-1] < hist.train_loss[0]:
            raise AssertionError(f"16b: the loss did not fall: "
                                 f"{hist.train_loss}")
        if per_step != (2 * DEPTH, DEPTH, DEPTH):
            raise AssertionError(f"16b: flash launches a step {per_step}")
        shards = ShardedCheckpointStore(root=cfg.checkpoints_dir)
        tags = client.checkpoints().list(LC_JOB)
        if tags != ["ep00000", "ep00001", "final"] or shards.tags(
                LC_JOB) != tags:
            raise AssertionError(f"16b: checkpoints {tags}")
        man = shards.read_manifest(LC_JOB, "final")
        size = sum(p.stat().st_size for p in
                   (cfg.checkpoints_dir / LC_JOB / "final.shards").iterdir())
        log(f"  16b sharded final: {len(man['leaves'])} leaves, {size} "
            f"bytes, epoch {man['epoch']}")
        # without the final, the resume reads the newest epoch checkpoint
        client.checkpoints().delete(LC_JOB, tag="final")
        t0 = time.monotonic()
        train(client, LC_EPOCHS + 1, resume=True)
        again = cp_wait_job(cluster, LC_JOB)
        if (again.task.get("error")
                or again.train_loss[:LC_EPOCHS] != hist.train_loss
                or len(again.train_loss) != LC_EPOCHS + 1):
            raise AssertionError(f"16b resume: {again.train_loss}, error "
                                 f"{again.task.get('error')}")
        log(f"  16b resumed from the sharded checkpoint ep"
            f"{LC_EPOCHS - 1:05d} at epoch {LC_EPOCHS}: train loss "
            f"{again.train_loss[-1]:.4f} ({time.monotonic() - t0:.1f} s)")
        if cluster.ps._serving_source(LC_JOB)[0] != "sharded":
            raise AssertionError("16b: the served final is not the sharded "
                                 "export")
        serve_rng = np.random.default_rng(LC_SEED + 1)
        f32_launches = lc_serve(
            smi, "f32", client,
            shards.restore(LC_JOB, "final").variables, serve_rng)
        client.checkpoints().quantize(LC_JOB)
    if f32_launches[0] <= 0:
        raise AssertionError(f"16b f32: paged attention launches "
                             f"{f32_launches}")
    from kubeml_tpu_torch.serving.quant import INT8_TAG

    qcfg = cp_config(Path(root) / "spmd", serving_quantize="int8",
                     int8_matmul=True)
    with LocalCluster(config=qcfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        if cluster.ps._serving_source(LC_JOB)[:2] != ("sharded", INT8_TAG):
            raise AssertionError("16b: final-int8 is not the sharded export")
        q_launches = lc_serve(
            smi, "int8", client,
            shards.restore(LC_JOB, INT8_TAG).variables, serve_rng)
    if min(q_launches) <= 0:
        raise AssertionError(f"16b int8: launches {q_launches}")
    return counts, tuple(a + b for a, b in zip(f32_launches, q_launches))


def spec_spmd_phase(smi, root, bare_step_ms):
    """Phase 16 (see the module docstring)."""
    t0 = time.monotonic()
    oneshot = oneshot_spec(smi)
    log(f"  16a {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    counts, served = spmd_job(smi, root, bare_step_ms)
    log(f"  16b {time.monotonic() - t0:.1f} s")
    return oneshot, counts, served


# --- phase 17: multi-rank SPMD ---------------------------------------------

# The ranks: two processes share the one H100 over gloo, passed explicitly
# (NCCL refuses two ranks on one device); every collective goes through
# host memory (parallel/collectives.py). Nothing here runs NCCL, a world
# above 2 or several cards.
MR = dict(
    world=2, timeout_s=600.0,
    # (a) the flagship's attention: B 8, L 2048, H 8, D 64, causal, the
    # last row's last `pad` keys padded; bf16 and f32
    attn=dict(B=8, L=2048, H=FLASH_H, D=FLASH_D, pad=300,
              dtypes=(torch.bfloat16, torch.float32)),
    # (b) the long-context flagship at full width (phase 8's trainer:
    # benchmarks.longcontext.make_trainer), MR_STEPS steps on each mesh,
    # the last under a profiler window; depth cut from 8 to 4 blocks
    # (width, heads, B and L kept) to keep the script within its time with
    # phase 19, and to 2 with phase 22
    model=dict(vocab_size=32000, max_len=2048, embed_dim=512, depth=2,
               num_heads=FLASH_H, remat=True, dtype=torch.bfloat16),
    tokens=TRAIN_TOKENS, L=2048,
    meshes=(("sp=2 ulysses", dict(sp=2), "ulysses"),
            ("sp=2 ring", dict(sp=2), "ring"),
            ("tp=2", dict(tp=2), "ring"),
            ("dp=2", dict(dp=2), "ring")))
MR_STEPS = 3
# (a) over ranks against the plain version on the card, and the ring
# against the one-rank path (the flash kernels), for out, dQ, dK and dV:
# the largest abs error over max(1, the largest |reference|); bf16
# PA_TOL's 0.05 (the plain path rounds scores and p to bf16), f32 1e-5
# (both f32, summed in other orders; phase 7's f32 bound)
MR_ATTN_TOL = {torch.bfloat16: PA_TOL[torch.bfloat16],
               torch.float32: 1e-5}
# Ulysses against the one-rank path: the same kernels on the same (row,
# head) tiles, equal in both dtypes (0 in every card run); 1e-6 of max(1,
# max |ref|) lies below one bf16 rounding of any output
MR_SAME_TOL = 1e-6
# (b) each step's loss over ranks against the one-rank trainer's from the
# same weights and batch: 2e-2 absolute. Forward and gradients run in
# bf16: tp sums its partial products in bf16 across ranks, the ring
# attends in f32 where the kernels round p to bf16, and cuBLAS picks other
# kernels at other shapes; the loss (~10.4, a mean over 16,380 targets)
# moves by ~1e-4 from such roundings (1.23e-4 the most on the card)
MR_LOSS_ATOL = 2e-2
# (b) the first step's gradient norm of every parameter (a tp-sharded
# leaf's whole norm) against the one-rank trainer's, relative. AdamW's
# first steps barely see a gradient's scale, so the losses hide a
# gradient summed twice over tp (x2: 1.0 on every tp-replicated leaf),
# and they are summed over dp x sp, so a missing dp/sp all-reduce (each
# rank's half of the batch) shows in them only as drift; this shows both
# (tests/test_torch_spmd_mesh.py plants them at a tiny width), and the
# ranks' whole parameters after the last step must be bit-equal. Sound
# readings on the H100: 3.94e-3 at most (tp=2)
MR_GRAD_RTOL = 2e-2


def mr_attention(rank, cfg):
    """17a on one rank: Ulysses and the ring over ``sp=2``, outputs and
    dQ/dK/dV gathered over the ranks; rank 0 holds them against the
    one-rank path and the plain version. Returns each case's flash
    launches of the call over ranks, its host ms, and (rank 0) errors."""
    from kubeml_tpu_torch.ops.attention import dot_product_attention
    from kubeml_tpu_torch.parallel.collectives import all_gather
    from kubeml_tpu_torch.parallel.mesh import local_block, make_mesh
    from kubeml_tpu_torch.parallel.ring import ring_attention
    from kubeml_tpu_torch.parallel.ulysses import ulysses_attention

    a = cfg["attn"]
    mesh = make_mesh(sp=cfg["world"])
    out = {}
    for dtype in a["dtypes"]:
        g = torch.Generator().manual_seed(SEED)
        mk = lambda: torch.randn(a["B"], a["L"], a["H"], a["D"],
                                 generator=g).to(dtype).to("cuda")
        q, k, v, do = mk(), mk(), mk(), mk()
        valid = torch.ones(a["B"], a["L"], device="cuda")
        valid[-1, a["L"] - a["pad"]:] = 0
        refs = None
        for impl, fn in (("ulysses", ulysses_attention),
                         ("ring", ring_attention)):
            ql, kl, vl = (local_block(mesh, t).clone().requires_grad_()
                          for t in (q, k, v))
            reset_flash_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = fn(ql, kl, vl, mesh, "sp", causal=True,
                   kv_valid=local_block(mesh, valid))
            o.backward(local_block(mesh, do))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = flash_counts()
            got = [all_gather(t.detach(), mesh, "sp", 1)
                   for t in (o, ql.grad, kl.grad, vl.grad)]
            row = dict(launches=counts, ms=ms)
            if rank == 0:
                if refs is None:
                    refs = {}
                    for path in ("cuda", "plain"):
                        qr, kr, vr = (t.clone().requires_grad_()
                                      for t in (q, k, v))
                        r = dot_product_attention(qr, kr, vr, causal=True,
                                                  kv_valid=valid, impl=path)
                        r.backward(do)
                        refs[path] = [x.detach() for x in
                                      (r, qr.grad, kr.grad, vr.grad)]
                for path, want in refs.items():
                    row[path] = max(
                        ((x.float() - w.float()).abs().max().item()
                         / max(1.0, w.float().abs().max().item()))
                        for x, w in zip(got, want))
            out[(impl, str(dtype).split(".")[-1])] = row
        del q, k, v, do, refs
        torch.cuda.empty_cache()
    return out


def grad_norms(trainer):
    """``{parameter name: its gradient's norm}`` after a step, over the
    whole leaf: a leaf sharded over tp (a stage stack over pp, an expert
    stack over ep) has its squares summed over that axis."""
    from kubeml_tpu_torch.parallel.collectives import all_reduce_

    specs = trainer.module.partition_specs()
    names, params = zip(*trainer.module.named_parameters())
    sq = torch.stack([p.grad.double().square().sum() for p in params])
    if trainer.ranks is not None:
        for ax in ("tp", "pp", "ep"):
            split = torch.tensor([ax in specs[n] for n in names],
                                 device=sq.device)
            sq = torch.where(split, all_reduce_(sq * split, trainer.ranks,
                                                ax), sq)
    return dict(zip(names, sq.sqrt().tolist()))


def grad_errors(norms, ref):
    """``{parameter name: |norm - ref| / ref}``: each leaf's gradient
    norm against the one-rank trainer's (``grad_norms`` of each)."""
    return {n: abs(g - ref[n]) / max(ref[n], 1e-30) for n, g in norms.items()}


def whole_digest(trainer):
    """(sha256 over the bytes of the parameters this rank holds whole, in
    name order; their count): the leaves no mesh axis of size above 1
    splits (under pp, the leaves every stage's rank holds)."""
    shape = trainer.ranks.shape
    specs = trainer.module.partition_specs()
    h, n = hashlib.sha256(), 0
    for name, p in trainer.module.named_parameters():
        if not any(shape.get(ax, 1) > 1 for ax in specs[name] if ax):
            h.update(p.detach().reshape(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
            n += 1
    return h.hexdigest(), n


def mr_train(rank, cfg):
    """17b on one rank: the flagship trained over each mesh from the
    one-rank trainer's weights (seed 0) and batch; returns per mesh the
    losses, the first step's gradient norms, the digest of the whole
    parameters after the last step, the flash launches, the host ms of
    each step and the collectives' share of the profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    tokens = np.random.default_rng(0).integers(
        1, cfg["model"]["vocab_size"],
        size=(cfg["tokens"] // cfg["L"], cfg["L"])).astype(np.int32)
    out = {}
    for tag, axes, impl in cfg["meshes"]:
        mesh = make_mesh(**axes)
        trainer = SPMDTrainer(CausalTransformer(mesh=mesh, sp_impl=impl,
                                                seed=0, **cfg["model"]),
                              mesh, precision="bf16")
        trainer.init(tokens)
        reset_flash_counts()
        losses, ms = [], []
        for step in range(MR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step < MR_STEPS - 1:
                losses.append(float(trainer.train_step(tokens)))
            else:  # the profiler window: the last step
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    losses.append(float(trainer.train_step(tokens)))
            ms.append(1e3 * (time.perf_counter() - t0))
            if step == 0:
                norms = grad_norms(trainer)
        comm = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                if e.key.startswith("kubeml::")}
        out[tag] = dict(losses=losses, launches=flash_counts(), ms=ms,
                        grad_norms=norms, digest=whole_digest(trainer),
                        comm_ms=comm, comm_share=sum(comm.values()) / ms[-1],
                        shard=tuple(trainer.module.block_0.mlp_in.kernel
                                    .shape))
        del trainer
        torch.cuda.empty_cache()
    return out


def mr_rank(rank, out_dir, cfg):
    """One rank of phase 17 (started by ``parallel.distributed.spawn``):
    joins the process group over gloo, loads the kernels the parent built,
    runs 17a and 17b and writes what it measured for the parent."""
    from kubeml_tpu_torch.parallel.distributed import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    res = dict(attn=mr_attention(rank, cfg), train=mr_train(rank, cfg))
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def multirank_phase(smi, cfg=MR):
    """Phase 17 (see the module docstring). Returns the flash launches
    (fwd, dq, dkv) of the phase's runs over ranks, summed over the
    ranks."""
    from kubeml_tpu_torch.benchmarks.longcontext import make_trainer
    from kubeml_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    trainer, tokens = make_trainer(cfg["L"], cfg["tokens"], "bf16",
                                   depth=cfg["model"]["depth"],
                                   embed_dim=cfg["model"]["embed_dim"],
                                   num_heads=cfg["model"]["num_heads"],
                                   vocab=cfg["model"]["vocab_size"],
                                   device="cuda")
    ref = [float(trainer.train_step(tokens))]
    ref_norms = grad_norms(trainer)
    ref += [float(trainer.train_step(tokens)) for _ in range(MR_STEPS - 1)]
    del trainer
    torch.cuda.empty_cache()
    log(f"  one-rank SPMDTrainer, B {tokens.shape[0]} x L {cfg['L']}: "
        f"losses {ref} ({time.monotonic() - t0:.1f} s)")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        spawn(mr_rank, cfg["world"], args=(tmp, cfg),
              timeout_s=cfg["timeout_s"])
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(cfg["world"])]
    log(f"  {cfg['world']} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included")
    total = [0, 0, 0]
    bad = []  # every failure is logged first, then the phase raises
    a = cfg["attn"]
    for key, row in ranks[0]["attn"].items():
        impl, dt = key
        tol = MR_ATTN_TOL[getattr(torch, dt)]
        same = MR_SAME_TOL if impl == "ulysses" else tol
        launches = [r["attn"][key]["launches"] for r in ranks]
        want = (1, 1, 1) if impl == "ulysses" else (0, 0, 0)
        log(f"  17a {impl} sp={cfg['world']} B {a['B']} L {a['L']} H "
            f"{a['H']} D {a['D']} causal, {a['pad']} padded keys, {dt}: "
            f"out/dQ/dK/dV gathered vs the one-rank kernels "
            f"{row['cuda']:.2e} (tolerance {same}), vs the plain version "
            f"{row['plain']:.2e} (tolerance {tol}) of max(1, max |ref|); "
            f"flash launches a rank {launches}; fwd+bwd host ms a rank "
            f"{[round(r['attn'][key]['ms'], 2) for r in ranks]} (gloo over "
            f"host memory, not NVLink)")
        if not (row["cuda"] <= same and row["plain"] <= tol):
            bad.append(f"17a {key}: error {row}")
        if any(c != want for c in launches):
            bad.append(f"17a {key}: flash launches {launches}, want {want} "
                       f"a rank")
        for c in launches:
            total = [t + n for t, n in zip(total, c)]
    per_step = (2 * cfg["model"]["depth"], cfg["model"]["depth"],
                cfg["model"]["depth"])
    for tag, row in ranks[0]["train"].items():
        ring = tag.endswith("ring")
        losses = [r["train"][tag]["losses"] for r in ranks]
        err = max(abs(x - y) for x, y in zip(losses[0], ref))
        grad = grad_errors(row["grad_norms"], ref_norms)
        worst = sorted(grad, key=grad.get, reverse=True)[:3]
        digests = [r["train"][tag]["digest"] for r in ranks]
        launches = [r["train"][tag]["launches"] for r in ranks]
        want = (0, 0, 0) if ring else tuple(MR_STEPS * n for n in per_step)
        log(f"  17b {tag}: losses {losses[0]} (one rank {ref}; largest "
            f"difference {err:.2e}, tolerance {MR_LOSS_ATOL}); first "
            f"step's gradient norms by leaf against one rank's, relative: "
            f"largest {', '.join(f'{n} {grad[n]:.2e}' for n in worst)} "
            f"(tolerance {MR_GRAD_RTOL}, {len(grad)} leaves); whole "
            f"parameters after step {MR_STEPS}: {digests[0][1]} leaves, "
            f"{'bit-equal' if len(set(digests)) == 1 else 'DIFFERENT'} on "
            f"the ranks; mlp_in shard {row['shard']}; flash launches a "
            f"rank {launches} over {MR_STEPS} steps; step host ms a rank "
            + "; ".join(f"rank {i}: " + ", ".join(f"{m:.1f}" for m in
                                                  r["train"][tag]["ms"])
                        for i, r in enumerate(ranks))
            + " (the last profiled); collectives' share of the profiled "
            f"step {[round(r['train'][tag]['comm_share'], 3) for r in ranks]}"
            f" (ms by op, rank 0: "
            f"{ {k: round(v, 1) for k, v in row['comm_ms'].items()} }; gloo "
            f"over host memory, not NVLink)")
        if any(x != losses[0] for x in losses[1:]):
            bad.append(f"17b {tag}: the ranks report other losses {losses}")
        if not (all(np.isfinite(losses[0])) and err <= MR_LOSS_ATOL):
            bad.append(f"17b {tag}: losses {losses[0]} against the "
                       f"one-rank {ref}")
        if set(grad) != set(ref_norms) or not all(
                e <= MR_GRAD_RTOL for e in grad.values()):
            bad.append(f"17b {tag}: gradient norms off one rank's: "
                       f"{ {n: grad[n] for n in worst} }")
        if len(set(digests)) != 1:
            bad.append(f"17b {tag}: the ranks' whole parameters differ "
                       f"after {MR_STEPS} steps")
        if any(c != want for c in launches):
            bad.append(f"17b {tag}: flash launches {launches}, want {want} "
                       f"a rank")
        for c in launches:
            total = [t + n for t, n in zip(total, c)]
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))
    return tuple(total)


# --- phase 18: the SPMD job over ranks ----------------------------------------

# Two ranks share the H100 over gloo, as in phase 17, and start as ``kubeml
# start`` starts them: rank 0 runs LocalCluster (HTTP on port 0), rank 1
# the follower loop (engine.follower.run_follower). The model is phase 16b's
# flagship at full width, its sequence parallelism by Ulysses, cut from 8
# to JR_DEPTH blocks (width, heads, B and L kept) to keep the script
# within its time with phase 19 (4 blocks) and phase 22 (2), on 16b's
# token set (LC_TRAIN rows to
# train, 4 steps an epoch at B 8, LC_TEST to validate, one eval batch an
# epoch).
JR_JOB, JR_ELASTIC, JR_BROKEN = "lc-ranks", "lc-elastic", "lc-nofn"
JR_WORLD, JR_TIMEOUT_S, JR_SEED, JR_DEPTH = 2, 900.0, 18, 2
JR_FN = LC_FN.replace("remat=True, dtype=dtype, mesh=self.mesh)",
                      "remat=True, dtype=dtype, mesh=self.mesh,\n"
                      "                                 sp_impl=\"ulysses\")"
                      ).replace("depth=8,", f"depth={JR_DEPTH},")
assert "ulysses" in JR_FN and f"depth={JR_DEPTH}," in JR_FN
# 18e: a function rank 1 cannot load, as if its data root lacked it
JR_BROKEN_FN = ("import os\n"
                "if os.environ.get('KUBEML_PROCESS_ID', '0') != '0':\n"
                "    raise ImportError('this function is not installed on "
                "this rank')\n" + JR_FN)
# 18c: the scheduler's answers after each epoch (the last changes nothing)
JR_LEVELS = (1, 2, 2)
# Each epoch's mean train loss (4 steps) and eval loss over ranks against
# the one-rank job's from the same seed and batches: phase 17's
# MR_LOSS_ATOL, whose bf16 reasons hold here over 8-12 steps.


def jr_request(job, epochs, fn="lcranks", **opts):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    opts.setdefault("static_parallelism", True)
    return TrainRequest(
        model_type="gpt", batch_size=LC_B, epochs=epochs,
        dataset="lc-tokens", lr=3e-4, function_name=fn, job_id=job,
        options=TrainOptions(engine="spmd", precision="bf16",
                             validate_every=1, **opts))


def jr_tokens():
    rng = np.random.default_rng(JR_SEED)
    x = rng.integers(1, LC_VOCAB, size=(LC_TRAIN + LC_TEST, LC_L)
                     ).astype(np.int32)
    return x, np.zeros(len(x), np.int64)


def jr_reference(root):
    """The one-rank SPMDJob's histories from the same seed and batches on
    the card: 2 epochs with sharded checkpoints, resumed for a third (its
    optimizer restarts, as 18b's), and 3 epochs whose optimizer restarts
    after epochs 1 and 2 (18c's remeshes)."""
    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = cp_config(root)
    cfg.ensure_dirs()
    x, y = jr_tokens()
    ShardStore(config=cfg).create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                  x[LC_TRAIN:], y[LC_TRAIN:])
    FunctionRegistry(config=cfg).create("lcranks", JR_FN)

    def job(req, **kw):
        model = FunctionRegistry(config=cfg).load("lcranks")
        model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                          k=1, task="train")
        return SPMDJob(req.job_id, req, model, store=ShardStore(config=cfg),
                       history_store=HistoryStore(config=cfg),
                       checkpoint_store=CheckpointStore(config=cfg),
                       device="cuda", **kw)

    sharded = dict(sharded_checkpoints=True, checkpoint_every=1,
                   save_model=False)
    out = {}
    for key, epochs, opts in (("a", 2, {}), ("b", 3, dict(resume=True))):
        h = job(jr_request("ref", epochs, **sharded, **opts)).train()
        out[key] = (list(h.train_loss), list(h.validation_loss))
    ref = job(jr_request("ref-elastic", 3, static_parallelism=False,
                         save_model=False),
              on_epoch_end=lambda state: ref.trainer.init())
    h = ref.train()
    out["c"] = (list(h.train_loss), list(h.validation_loss))
    del ref
    torch.cuda.empty_cache()
    return out


# the step job_instrument profiles (a job's second)
PROFILED_STEP = 1


def job_instrument(records, profiled: bool = False):
    """Record each SPMD job this rank runs: its flash launches (the
    counters set to 0 at the job's start, read at its end), its last
    sharded save and restore, its remeshes' seconds, the digest of the
    leaves every rank holds whole, the first step's gradient norms by
    leaf, each step's host ms and, with ``profiled``, the collectives' ms
    in the first job's PROFILED_STEP (``kubeml::`` spans of a CPU
    profiler window). Returns a function that undoes the
    instrumentation."""
    from torch.profiler import ProfilerActivity, profile

    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    train, step = SPMDJob.train, SPMDTrainer.train_step
    state = {}

    def counted(job):
        state.clear()
        state.update(n=0, ms=[], profile=profiled and not records)
        reset_flash_counts()
        try:
            return train(job)
        finally:
            t = job.trainer
            records.append(dict(
                job=job.job_id, flash=flash_counts(), save=job.last_save,
                restore_bytes=job.last_restore_bytes,
                remesh_s=list(job.remesh_seconds),
                digest=(whole_digest(t) if t is not None
                        and t.ranks is not None else None),
                norms=state.get("norms"), ms=list(state["ms"]),
                comm=state.get("comm")))

    def stepped(trainer, batch, rng=None):
        i = state.get("n", 0)
        state["n"] = i + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == PROFILED_STEP and state.get("profile"):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss = step(trainer, batch, rng)
                torch.cuda.synchronize()
            state["comm"] = {e.key: e.cpu_time_total / 1e3
                             for e in prof.key_averages()
                             if e.key.startswith("kubeml::")}
        else:
            loss = step(trainer, batch, rng)
            torch.cuda.synchronize()
        state.setdefault("ms", []).append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            state["norms"] = grad_norms(trainer)
        return loss

    SPMDJob.train, SPMDTrainer.train_step = counted, stepped
    return lambda: (setattr(SPMDJob, "train", train),
                    setattr(SPMDTrainer, "train_step", step))


def jr_wait_started(cluster, jid):
    """Wait until the parameter server holds the job's object."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            rec = cluster.ps._jobs.get(jid)
        if rec is not None and rec.job is not None:
            return
        time.sleep(0.01)
    raise AssertionError(f"18: job {jid} did not start")


def jr_leader(root, smi):
    """Rank 0: the control plane and every job of 18a-e through HTTP."""
    from kubeml_tpu_torch.api.errors import KubeMLError
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention
    from kubeml_tpu_torch.serving.quant import INT8_TAG
    from kubeml_tpu_torch.storage.sharded_checkpoint import \
        ShardedCheckpointStore

    out = {"wall": {}}
    cfg = cp_config(root)
    x, y = jr_tokens()
    sharded = dict(sharded_checkpoints=True, checkpoint_every=1)
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        client.datasets().create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                 x[LC_TRAIN:], y[LC_TRAIN:])
        client.functions().create("lcranks", JR_FN)
        client.functions().create("lcbroken", JR_BROKEN_FN)
        # 18a, and 18e's live inference while it trains over ranks
        t0 = time.monotonic()
        client.networks().train(jr_request(
            JR_JOB, 2, mesh_shape={"tp": 2}, **sharded))
        jr_wait_started(cluster, JR_JOB)
        try:
            client.networks().infer(JR_JOB, x[:1, :16])
            out["live_infer"] = None
        except KubeMLError as e:
            out["live_infer"] = (e.status_code, e.message)
        h = cp_wait_job(cluster, JR_JOB)
        out["wall"]["a"] = time.monotonic() - t0
        out["a"] = dict(train=list(h.train_loss), val=list(h.validation_loss),
                        par=list(h.parallelism), error=h.task.get("error"))
        shards = ShardedCheckpointStore(root=cfg.checkpoints_dir)
        d = cfg.checkpoints_dir / JR_JOB / "final.shards"
        man = shards.read_manifest(JR_JOB, "final")
        files = {}
        for p in sorted(d.glob("shard-*.npz")):
            with np.load(p) as z:
                files[p.name] = {k: z[k].shape for k in z.files}
        out["a"].update(manifest=dict(processes=man["processes"],
                                      leaves=man["leaves"]), files=files,
                        size=sum(p.stat().st_size for p in d.iterdir()))
        # 18b: resumed under sp=2 (Ulysses) from 18a's checkpoint; the
        # final export stays 18a's, written over tp=2, for 18d
        t0 = time.monotonic()
        client.networks().train(jr_request(
            JR_JOB, 3, mesh_shape={"sp": 2}, resume=True, save_model=False,
            **sharded))
        h = cp_wait_job(cluster, JR_JOB)
        out["wall"]["b"] = time.monotonic() - t0
        out["b"] = dict(train=list(h.train_loss), val=list(h.validation_loss),
                        par=list(h.parallelism), error=h.task.get("error"))
        # the bytes of the resumed checkpoint's slices
        leaves = shards.read_manifest(JR_JOB, "final")["leaves"].values()
        out["b"]["size"] = int(sum(
            np.prod(leaf["shape"]) * (2 if leaf["dtype"] == "bfloat16"
                                      else np.dtype(leaf["dtype"]).itemsize)
            for leaf in leaves))
        # 18c: dp=2, the scheduler's answers 1, then 2
        levels, asked = list(JR_LEVELS), []

        def answer(job_id, state):
            asked.append(state.parallelism)
            return levels.pop(0)

        cluster.ps._epoch_end = answer
        t0 = time.monotonic()
        client.networks().train(jr_request(
            JR_ELASTIC, 3, static_parallelism=False, save_model=False))
        h = cp_wait_job(cluster, JR_ELASTIC)
        out["wall"]["c"] = time.monotonic() - t0
        out["c"] = dict(train=list(h.train_loss), val=list(h.validation_loss),
                        par=list(h.parallelism), asked=asked,
                        error=h.task.get("error"))
        # 18e: a follower that cannot load the function
        t0 = time.monotonic()
        client.networks().train(jr_request(JR_BROKEN, 1, fn="lcbroken",
                                           mesh_shape={"tp": 2}))
        h = cp_wait_job(cluster, JR_BROKEN)
        out["e"] = dict(error=h.task.get("error"), train=list(h.train_loss),
                        seconds=time.monotonic() - t0)
        # 18d: the sharded final 18a's two ranks wrote, served in f32 and
        # quantized into a sharded final-int8
        if cluster.ps._serving_source(JR_JOB)[0] != "sharded":
            raise AssertionError("18d: the served final is not the sharded "
                                 "export")
        serve_rng = np.random.default_rng(JR_SEED + 1)
        t0 = time.monotonic()
        f32 = lc_serve(smi, "f32", client,
                       shards.restore(JR_JOB, "final").variables, serve_rng,
                       job=JR_JOB, phase="18d")
        client.checkpoints().quantize(JR_JOB)
    qcfg = cp_config(root, serving_quantize="int8", int8_matmul=True)
    with LocalCluster(config=qcfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        if cluster.ps._serving_source(JR_JOB)[:2] != ("sharded", INT8_TAG):
            raise AssertionError("18d: final-int8 is not the sharded export")
        q = lc_serve(smi, "int8", client,
                     shards.restore(JR_JOB, INT8_TAG).variables, serve_rng,
                     job=JR_JOB, phase="18d")
    out["wall"]["d"] = time.monotonic() - t0
    out["d"] = dict(f32=f32, int8=q)
    return out


def jr_rank(rank, out_dir, root, smi):
    """One rank of phase 18 (started by ``parallel.distributed.spawn``),
    as ``kubeml start`` starts a rank: the process group over gloo, the
    kernels the parent built, then the control plane on rank 0 and the
    follower loop on rank 1 (once a cluster: 18d's int8 serving boots a
    second one)."""
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.parallel.distributed import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    records = []
    job_instrument(records)
    if rank == 0:
        res = jr_leader(root, smi)
    else:
        res = dict(followed=[run_follower(config=cp_config(root))
                             for _ in range(2)])
    res["jobs"] = records
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def check_shards(final, shape):
    """A final export written over the mesh ``shape`` (one rank a mesh
    slot): a file a rank, the manifest's processes the world, each leaf's
    slices the distinct ``leaf_block`` s of the ranks, each owned by the
    lowest rank holding it and in its owner's file only. Returns (the
    leaves split over an axis, the faults)."""
    from kubeml_tpu_torch.interop.from_flax import leaf_block

    man, files = final["manifest"], final["files"]
    world = math.prod(shape.values())
    mesh = type("Slots", (), dict(shape=shape))
    coords = [dict(zip(shape, map(int, np.unravel_index(
        r, tuple(shape.values()))))) for r in range(world)]
    bad = []
    if sorted(files) != [f"shard-{r}.npz" for r in range(world)]:
        bad.append(f"shard files {sorted(files)}")
    if man["processes"] != world:
        bad.append(f"manifest processes {man['processes']}")
    split = 0
    for path, leaf in man["leaves"].items():
        name = ".".join(path.split("/")[1:])
        owners = {}
        for r, coord in enumerate(coords):  # ascending: the lowest owns
            start = leaf_block(name, leaf["shape"], mesh, coord=coord)[0]
            owners.setdefault(tuple(start), r)
        want = [(list(start), r) for start, r in owners.items()]
        split += len(want) > 1
        got = [(sl["start"], sl["shard"]) for sl in leaf["slices"]]
        if got != want:
            bad.append(f"{path}: slices {got}, want {want}")
        for sl in leaf["slices"]:
            key = f"{path}@{','.join(map(str, sl['start']))}"
            holders = [f for f, keys in files.items() if key in keys]
            if holders != [f"shard-{sl['shard']}.npz"] or tuple(
                    files[holders[0]][key]) != tuple(sl["shape"]):
                bad.append(f"{key} in {holders}")
    return split, bad


def ranks_phase(smi, root):
    """Phase 18 (see the module docstring). Returns the flash launches
    (fwd, dq, dkv) of its jobs over ranks, summed over the ranks, and the
    served (paged_attention, int8_matmul) launches."""
    from kubeml_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    ref = jr_reference(Path(root) / "ranks-ref")
    log(f"  18 one-rank SPMDJob [{smi}] ({time.monotonic() - t0:.1f} s): "
        f"train/eval losses 18a {ref['a']}, resumed 18b {ref['b']}, "
        f"optimizer restarted after epochs 1 and 2 (18c) {ref['c']}")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jr_") as tmp:
        spawn(jr_rank, JR_WORLD, args=(tmp, str(Path(root) / "ranks"), smi),
              timeout_s=JR_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(JR_WORLD)]
    lead = ranks[0]
    log(f"  18 {JR_WORLD} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included; walls (s) "
        f"{ {k: round(v, 1) for k, v in lead['wall'].items()} }")
    bad = []
    steps = LC_TRAIN // LC_B
    per_step = (2 * JR_DEPTH, JR_DEPTH, JR_DEPTH)

    def job_counts(jid):
        """Per rank, the records of ``jid``'s runs, in order."""
        return [[j for j in r["jobs"] if j["job"] == jid] for r in ranks]

    def want_flash(epochs):
        # each step's forward twice (remat), dQ and dK/dV once a block; one
        # validation forward an epoch
        return (epochs * (steps * per_step[0] + JR_DEPTH),
                epochs * steps * JR_DEPTH, epochs * steps * JR_DEPTH)

    def held(tag, got, want):
        err = max(abs(a - b) for a, b in zip(got, want))
        if len(got) != len(want) or not (all(np.isfinite(got))
                                         and err <= MR_LOSS_ATOL):
            bad.append(f"{tag}: {got} against the one rank's {want}")
        return err

    total = [0, 0, 0]
    runs = job_counts(JR_JOB)
    # 18a
    a = lead["a"]
    ea = held("18a train", a["train"], ref["a"][0])
    ev = held("18a eval", a["val"], ref["a"][1])
    flash = [r[0]["flash"] for r in runs]
    saves = [r[0]["save"] for r in runs]
    split, shard_bad = check_shards(a, {"tp": JR_WORLD})
    bad += [f"18a {b}" for b in shard_bad]
    log(f"  18a {JR_JOB} tp=2 [{smi}]: /train engine=spmd, 2 epochs x "
        f"{steps} steps of B {LC_B} x L {LC_L} over {JR_WORLD} ranks: train "
        f"loss {a['train']} (one rank {ref['a'][0]}; largest difference "
        f"{ea:.2e}), eval loss {a['val']} (difference {ev:.2e}; tolerance "
        f"{MR_LOSS_ATOL}), parallelism {a['par']}; flash launches a rank "
        f"{flash} (a step {per_step}, one eval forward an epoch of {JR_DEPTH} "
        f"fwd); sharded final: {sorted(a['files'])}, processes "
        f"{a['manifest']['processes']}, {split} tp-split leaves a half on "
        f"each rank, {a['size']} bytes; its save a rank "
        + "; ".join(f"rank {i}: {s['bytes']} bytes in "
                    f"{1e3 * s['seconds']:.1f} ms" for i, s in enumerate(saves))
        + f" ({lead['wall']['a']:.1f} s from /train to the history)")
    if a["error"] or a["par"] != [JR_WORLD] * 2:
        bad.append(f"18a: error {a['error']}, parallelism {a['par']}")
    if any(f != want_flash(2) for f in flash):
        bad.append(f"18a: flash launches {flash}, want {want_flash(2)} a rank")
    # 18e: live inference while 18a trained over ranks
    if not (lead["live_infer"] and lead["live_infer"][0] == 409):
        bad.append(f"18e: live /infer over ranks {lead['live_infer']}")
    # 18b
    b = lead["b"]
    flash_b = [r[1]["flash"] for r in runs]
    read = [r[1]["restore_bytes"] for r in runs]
    eb = held("18b train", b["train"][2:], ref["b"][0][2:])
    log(f"  18b {JR_JOB} resumed under sp=2 (Ulysses) [{smi}]: train loss "
        f"{b['train']}, epoch 3 {b['train'][2]:.4f} against the one-rank "
        f"continuation {ref['b'][0][2]:.4f} (difference {eb:.2e}); history "
        f"spliced {'exactly' if b['train'][:2] == a['train'] else 'NOT'}; "
        f"sharded restore read a rank {read} bytes of the checkpoint's "
        f"{b['size']} bytes of slices (sp replicates every leaf: each rank "
        f"reads it whole); "
        f"flash launches a rank {flash_b} ({lead['wall']['b']:.1f} s)")
    if b["error"] or b["train"][:2] != a["train"] or len(b["train"]) != 3:
        bad.append(f"18b: {b}")
    if any(f != want_flash(1) for f in flash_b):
        bad.append(f"18b: flash launches {flash_b}, want {want_flash(1)}")
    if any(not n or n > b["size"] for n in read):
        bad.append(f"18b: restore bytes {read}")
    # 18c
    c = lead["c"]
    ec = held("18c train", c["train"], ref["c"][0])
    el = job_counts(JR_ELASTIC)
    flash_c = [r[0]["flash"] for r in el]
    digests = [r[0]["digest"] for r in el]
    remesh = el[0][0]["remesh_s"]
    want_c = [want_flash(3), want_flash(2)]
    log(f"  18c {JR_ELASTIC} dp=2, on_epoch_end answers {list(JR_LEVELS)} "
        f"[{smi}]: parallelism {c['par']} (asked at {c['asked']}), train "
        f"loss {c['train']} against the one rank's with its optimizer "
        f"restarted at the same epochs {ref['c'][0]} (largest difference "
        f"{ec:.2e}); flash launches a rank {flash_c} (rank 1 none in the "
        f"dp=1 epoch: {want_c}); remesh s on rank 0 "
        f"{[round(s, 3) for s in remesh]}; whole parameters after the "
        f"return to dp=2: {digests[0][1]} leaves, "
        f"{'bit-equal' if len(set(digests)) == 1 else 'DIFFERENT'} on the "
        f"ranks ({lead['wall']['c']:.1f} s)")
    if c["error"] or c["par"] != [2, 1, 2]:
        bad.append(f"18c: error {c['error']}, parallelism {c['par']}")
    if flash_c != want_c:
        bad.append(f"18c: flash launches {flash_c}, want {want_c}")
    if len(set(digests)) != 1 or digests[0] is None:
        bad.append(f"18c: the ranks' parameters differ after the remesh")
    # 18e: the follower that could not load the function
    e = lead["e"]
    log(f"  18e {JR_BROKEN}: the job failed in {e['seconds']:.1f} s with "
        f"{e['error']!r}; live /infer while 18a trained: "
        f"{lead['live_infer']}; the follower ran "
        f"{ranks[1]['followed']} jobs over the two clusters and exited 0")
    if not e["error"] or "could not start" not in e["error"] or e["train"]:
        bad.append(f"18e: {e}")
    if ranks[1]["followed"] != [3, 0]:
        bad.append(f"18e: the follower ran {ranks[1]['followed']} jobs")
    # 18d
    d = lead["d"]
    log(f"  18d the 2-shard final served from rank 0's PS: launches "
        f"(paged_attention, int8_matmul) f32 {d['f32']}, int8 {d['int8']} "
        f"({lead['wall']['d']:.1f} s)")
    if d["f32"][0] <= 0 or min(d["int8"]) <= 0:
        bad.append(f"18d: launches {d}")
    for c_ in flash + flash_b + flash_c:
        total = [t + n for t, n in zip(total, c_)]
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    served = tuple(x + y for x, y in zip(d["f32"], d["int8"]))
    return tuple(total), served


# --- phase 19: the pipeline over ranks ----------------------------------------

# Two ranks share the H100 over gloo, as in phases 17-18: rank 0 runs
# LocalCluster (HTTP on port 0), rank 1 the follower loop. The model is
# phase 16b's flagship at full width as PipelinedCausalLM in PP_STAGES
# stages of DEPTH / PP_STAGES blocks and PP_MICRO microbatches, trained on
# 16b's token set (B 8, 4 steps an epoch, one eval batch); served flat.
PP_JOB, PP_WORLD, PP_TIMEOUT_S, PP_SEED = "lc-pipe", 2, 900.0, 19
PP_STAGES, PP_MICRO = 2, 4
PP_TICKS = PP_MICRO + PP_STAGES - 1  # T = M + S - 1
PP_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.models.gpt_pipeline import (PipelinedCausalLM,
                                                  flat_serving_remap)
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel

DIMS = dict(vocab_size=32000, max_len=2048, embed_dim=512, depth=8,
            num_heads=8, remat=True)


class LongContextPipe(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("lc-tokens"))

    def build(self):
        # trained in 2 stages with bf16 compute, served flat in f32
        if self.task == "train":
            return PipelinedCausalLM(**DIMS, stages=2, microbatches=4,
                                     dtype=torch.bfloat16, mesh=self.mesh)
        return CausalTransformer(**DIMS, mesh=self.mesh)

    def serving_remap(self):
        return flat_serving_remap(2, 4)

    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""
# 19a: one microbatch of the flagship's attention with no valid key (the
# fill's bubbles): B 2, L 2048, H 8, D 64, causal, bf16 and f32
PP_MASKED = dict(B=LC_B // PP_MICRO, L=LC_L, H=FLASH_H, D=FLASH_D)
# 19a: PipelinedLM at the flagship's width, f32, B 8 x L 2048, its logits
# and final hidden states over pp=2 against its reference_apply on one
# rank: both through the f32 flash kernels, the matmuls at other shapes
# (microbatches of 2 rows against 8), so f32 sums in other orders: 1e-4 of
# max(1, max |reference|)
PP_LM = dict(vocab_size=LC_VOCAB, max_len=LC_L, embed_dim=512, depth=DEPTH,
             num_heads=FLASH_H, microbatches=PP_MICRO)
PP_LM_TOL = 1e-4


def pp_masked_check(smi):
    """19a: the three flash kernels on a batch whose keys are all padding,
    against their plain versions: out, dQ, dK and dV exactly 0, lse at
    most -1e29, nothing NaN. Returns the largest |kernel - plain|."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    a = PP_MASKED
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(PP_SEED)
        mk = lambda: torch.randn(a["B"], a["L"], a["H"], a["D"],
                                 generator=g).to(dtype).cuda()
        q, k, v, do = mk(), mk(), mk(), mk()
        valid = torch.zeros(a["B"], a["L"], device="cuda")
        out, lse = fa._flash_fwd_cuda(q, k, v, valid, True)
        ro, rl = fa.flash_attention_fwd_ref(q, k, v, valid, True)
        dsum = fa._dsum(do, ro)
        dq = fa._flash_dq_cuda(q, k, v, valid, rl, do, dsum, True)
        dk, dv = fa._flash_dkv_cuda(q, k, v, valid, rl, do, dsum, True)
        refs = fa.flash_attention_bwd_ref(q, k, v, valid, ro, rl, do, True)
        torch.cuda.synchronize()
        got = (out, dq, dk, dv)
        err = max((x.float() - r.float()).abs().max().item()
                  for x, r in zip(got, (ro,) + refs))
        zero = all(torch.equal(x, torch.zeros_like(x))
                   for x in got + (ro,) + refs)
        finite = all(bool(torch.isfinite(x).all()) for x in got + (lse,))
        low = bool((lse <= -1e29).all() and (rl <= -1e29).all())
        log(f"  19a flash kernels on a batch with no valid key, B {a['B']} "
            f"L {a['L']} H {a['H']} D {a['D']} causal, "
            f"{str(dtype).split('.')[-1]} [{smi}]: out, dQ, dK, dV "
            f"{'exactly 0' if zero else 'NOT 0'} (kernel and plain), lse "
            f"max {lse.max().item():.3g} (plain {rl.max().item():.3g}), "
            f"{'no NaN' if finite else 'NaN'}; max |kernel - plain| {err}")
        if not (zero and finite and low and err == 0.0):
            raise AssertionError(f"19a: fully masked rows through the "
                                 f"{dtype} kernels: zero {zero}, finite "
                                 f"{finite}, lse <= -1e29 {low}, error {err}")
        worst = max(worst, err)
        del q, k, v, do, out, lse, ro, rl, dq, dk, dv, refs
    torch.cuda.empty_cache()
    return worst


def restack(tree, stages: int, layers: int):
    """A one-stage ``PipelinedLM`` tree (``stages.layer_{i}.* [1, ...]``,
    ``stages * layers`` blocks) as a ``stages``-stage model's
    (``stages.layer_{j}.* [stages, ...]``: stage s holds blocks ``s *
    layers`` to ``(s + 1) * layers - 1``)."""
    out = {k: v for k, v in tree.items() if not k.startswith("stages.")}
    for j in range(layers):
        for name in [k for k in tree if k.startswith(f"stages.layer_{j}.")]:
            leaf = name.split(".", 2)[2]
            out[name] = torch.cat([tree[f"stages.layer_{s * layers + j}."
                                        f"{leaf}"] for s in range(stages)])
    return out


def pp_lm_check(rank):
    """19a on one rank: ``PipelinedLM`` over pp=2 from the weights of a
    one-stage model drawn from PP_SEED (each rank draws them on the CPU
    and keeps its stage), against that model's ``reference_apply`` on
    this rank; the logits' largest error relative to max(1, max
    |reference|), and the pipelined forward's flash launches."""
    from kubeml_tpu_torch.interop.from_flax import shard_tree
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.parallel import pipeline as P
    from kubeml_tpu_torch.parallel.mesh import make_mesh

    one = P.PipelinedLM(None, seed=PP_SEED, device="cpu", **PP_LM)
    tree = restack({n: p.detach() for n, p in one.named_parameters()},
                   PP_STAGES, DEPTH // PP_STAGES)
    mesh = make_mesh(pp=PP_STAGES)
    m = P.PipelinedLM(mesh, device="cuda", **PP_LM)
    load_tree(m, shard_tree(tree, mesh, spec_of=P.partition_spec))
    ids = torch.from_numpy(np.random.default_rng(PP_SEED).integers(
        1, LC_VOCAB, size=(LC_B, LC_L))).cuda()
    ids[-1, -100:] = 0  # a padded tail
    reset_flash_counts()
    with torch.no_grad():
        hidden = m(ids, return_hidden=True)
        logits = m.lm_head(hidden)
        torch.cuda.synchronize()
        launches = flash_counts()
        want = one.cuda().reference_apply(None, ids)
    err = ((logits - want).abs().max() / want.abs().max().clamp_min(1.0)
           ).item()
    del one, m, want, logits, hidden
    torch.cuda.empty_cache()
    return dict(err=err, launches=launches)


def pp_tokens():
    """Phase 16b's token set."""
    rng = np.random.default_rng(LC_SEED)
    x = rng.integers(1, LC_VOCAB, size=(LC_TRAIN + LC_TEST, LC_L)
                     ).astype(np.int32)
    return x, np.zeros(len(x), np.int64)


PP_OPTS = dict(sharded_checkpoints=True, checkpoint_every=1,
               mesh_shape={"pp": PP_STAGES})


def pp_reference(root):
    """The one-rank SPMDJob of PP_FN (every stage on the card, the same
    seeded weights and batches): 2 epochs with sharded checkpoints, then
    resumed from ep00001 for a third; the first step's gradient norms by
    leaf and each job's flash launches."""
    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = cp_config(root)
    cfg.ensure_dirs()
    x, y = pp_tokens()
    ShardStore(config=cfg).create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                  x[LC_TRAIN:], y[LC_TRAIN:])
    FunctionRegistry(config=cfg).create("lcpipe", PP_FN)
    records = []
    undo = job_instrument(records)
    out = {}
    try:
        opts = dict(PP_OPTS, mesh_shape=None)
        for key, epochs, more in (("a", 2, dict(save_model=False)),
                                  ("c", 3, dict(resume=True,
                                                save_model=False))):
            req = jr_request("ref", epochs, fn="lcpipe", **opts, **more)
            model = FunctionRegistry(config=cfg).load("lcpipe")
            model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                              k=1, task="train")
            h = SPMDJob("ref", req, model, store=ShardStore(config=cfg),
                        history_store=HistoryStore(config=cfg),
                        checkpoint_store=CheckpointStore(config=cfg),
                        device="cuda").train()
            out[key] = (list(h.train_loss), list(h.validation_loss))
            del model
            torch.cuda.empty_cache()
    finally:
        undo()
    out["norms"] = records[0]["norms"]
    out["flash"] = [r["flash"] for r in records]
    out["ms"] = [r["ms"] for r in records]
    return out


def pp_leader(root, smi):
    """Rank 0: the control plane; 19b's job and 19c's resume and serving
    through HTTP."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.models.gpt_pipeline import flat_serving_remap
    from kubeml_tpu_torch.serving.quant import INT8_TAG
    from kubeml_tpu_torch.storage.sharded_checkpoint import (
        ShardedCheckpointStore, apply_remap_host)

    out = {"wall": {}}
    cfg = cp_config(root)
    x, y = pp_tokens()
    remap = flat_serving_remap(PP_STAGES, DEPTH // PP_STAGES)
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        client.datasets().create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                 x[LC_TRAIN:], y[LC_TRAIN:])
        client.functions().create("lcpipe", PP_FN)
        shards = ShardedCheckpointStore(root=cfg.checkpoints_dir)
        for key, epochs, more in (("b", 2, dict(save_model=False)),
                                  ("c", 3, dict(resume=True))):
            t0 = time.monotonic()
            client.networks().train(jr_request(PP_JOB, epochs, fn="lcpipe",
                                               **PP_OPTS, **more))
            h = cp_wait_job(cluster, PP_JOB)
            out["wall"][key] = time.monotonic() - t0
            out[key] = dict(train=list(h.train_loss),
                            val=list(h.validation_loss),
                            par=list(h.parallelism),
                            epoch_s=list(h.epoch_duration),
                            error=h.task.get("error"),
                            tags=shards.tags(PP_JOB))
        d = cfg.checkpoints_dir / PP_JOB / "final.shards"
        man = shards.read_manifest(PP_JOB, "final")
        files = {}
        for p in sorted(d.glob("shard-*.npz")):
            with np.load(p) as z:
                files[p.name] = {k: z[k].shape for k in z.files}
        out["c"].update(manifest=dict(processes=man["processes"],
                                      leaves=man["leaves"]), files=files,
                        size=sum(p.stat().st_size for p in d.iterdir()))
        if cluster.ps._serving_source(PP_JOB)[0] != "sharded":
            raise AssertionError("19c: the served final is not the sharded "
                                 "export")
        serve_rng = np.random.default_rng(PP_SEED + 1)
        t0 = time.monotonic()
        f32 = lc_serve(smi, "f32", client, apply_remap_host(
            shards.restore(PP_JOB, "final").variables, remap), serve_rng,
            job=PP_JOB, phase="19c")
        client.checkpoints().quantize(PP_JOB)
    qcfg = cp_config(root, serving_quantize="int8", int8_matmul=True)
    with LocalCluster(config=qcfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        if cluster.ps._serving_source(PP_JOB)[:2] != ("sharded", INT8_TAG):
            raise AssertionError("19c: final-int8 is not the sharded export")
        q = lc_serve(smi, "int8", client,
                     shards.restore(PP_JOB, INT8_TAG).variables, serve_rng,
                     job=PP_JOB, phase="19c")
    out["wall"]["serve"] = time.monotonic() - t0
    out["served"] = dict(f32=f32, int8=q)
    return out


def pp_rank(rank, out_dir, root, smi):
    """One rank of phase 19 (started by ``parallel.distributed.spawn``),
    as ``kubeml start`` starts a rank: the process group over gloo, the
    kernels the parent built, 19a's PipelinedLM check, then the control
    plane on rank 0 and the follower loop on rank 1 (two clusters: the
    int8 serving boots a second one)."""
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.parallel.distributed import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    res = dict(lm=pp_lm_check(rank))
    records = []
    job_instrument(records, profiled=True)
    if rank == 0:
        res.update(pp_leader(root, smi))
    else:
        res["followed"] = [run_follower(config=cp_config(root))
                           for _ in range(2)]
    res["jobs"] = records
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def pipeline_phase(smi, root):
    """Phase 19 (see the module docstring). Returns the flash launches
    (fwd, dq, dkv) of its path over ranks, summed over the ranks, and the
    served (paged_attention, int8_matmul) launches."""
    from kubeml_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    masked_err = pp_masked_check(smi)
    log(f"  19a {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ref = pp_reference(Path(root) / "pipe-ref")
    log(f"  19 one-rank SPMDJob of PipelinedCausalLM(stages={PP_STAGES}, "
        f"microbatches={PP_MICRO}) [{smi}] ({time.monotonic() - t0:.1f} "
        f"s): train/eval losses {ref['a']}, resumed {ref['c']}; flash "
        f"launches {ref['flash']}; step ms "
        f"{[[round(m, 1) for m in ms] for ms in ref['ms']]}")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        spawn(pp_rank, PP_WORLD, args=(tmp, str(Path(root) / "pipe"), smi),
              timeout_s=PP_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(PP_WORLD)]
    lead = ranks[0]
    log(f"  19 {PP_WORLD} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included; walls (s) "
        f"{ {k: round(v, 1) for k, v in lead['wall'].items()} }")
    bad = []
    local = DEPTH // PP_STAGES
    steps = LC_TRAIN // LC_B
    # a step: every tick's forward twice (remat), dQ and dK/dV once, on
    # this rank's blocks; an eval batch: every tick's forward once
    per_step = (2 * PP_TICKS * local, PP_TICKS * local, PP_TICKS * local)

    def want_flash(epochs):
        return (epochs * (steps * per_step[0] + PP_TICKS * local),
                epochs * steps * per_step[1], epochs * steps * per_step[2])

    # 19a: PipelinedLM over pp=2
    lm = [r["lm"] for r in ranks]
    errs = ", ".join("%.2e" % x["err"] for x in lm)
    log(f"  19a PipelinedLM over pp={PP_STAGES} at the flagship's width "
        f"(E {PP_LM['embed_dim']}, depth {DEPTH}, vocab {LC_VOCAB}, B "
        f"{LC_B} x L {LC_L}, "
        f"{PP_MICRO} microbatches, f32) against its reference_apply: logits "
        f"error a rank {errs} of max(1, max |ref|) (tolerance "
        f"{PP_LM_TOL}); flash launches a rank "
        f"{[x['launches'] for x in lm]} (T {PP_TICKS} ticks x {local} "
        f"blocks)")
    for x in lm:
        if not x["err"] <= PP_LM_TOL:
            bad.append(f"19a PipelinedLM: error {x['err']}")
        if x["launches"] != (PP_TICKS * local, 0, 0):
            bad.append(f"19a PipelinedLM: flash launches {x['launches']}")
    # 19b
    runs = [[j for j in r["jobs"] if j["job"] == PP_JOB] for r in ranks]
    b = lead["b"]
    err_b = max(abs(p - q) for p, q in zip(b["train"] + b["val"],
                                           ref["a"][0] + ref["a"][1]))
    grads = [grad_errors(r[0]["norms"], ref["norms"]) for r in runs]
    worst = sorted(grads[0], key=grads[0].get, reverse=True)[:3]
    flash_b = [r[0]["flash"] for r in runs]
    digests = [r[1]["digest"] for r in runs]
    ms = [r[0]["ms"] for r in runs]
    comm = [r[0]["comm"] or {} for r in runs]
    plain = [[round(x, 1) for i, x in enumerate(m) if i != PROFILED_STEP]
             for m in ms]
    # the spans' ms over the median unprofiled step's (the profiler
    # lengthens the step it watches on the host)
    med = [float(np.median(p[1:])) for p in plain]
    share = [sum(c.values()) / m for c, m in zip(comm, med)]
    pshare = [c.get("kubeml::ppermute", 0.0) / m for c, m in zip(comm, med)]
    log(f"  19b {PP_JOB} pp={PP_STAGES} [{smi}]: /train engine=spmd, 2 "
        f"epochs x {steps} steps of B {LC_B} x L {LC_L} over {PP_WORLD} "
        f"ranks, {PP_MICRO} microbatches (T {PP_TICKS}, bubble share "
        f"{(PP_STAGES - 1) / PP_TICKS:.2f}): train loss {b['train']} (one "
        f"rank {ref['a'][0]}), eval loss {b['val']} (one rank "
        f"{ref['a'][1]}); largest difference {err_b:.2e} (tolerance "
        f"{MR_LOSS_ATOL}); parallelism {b['par']}; first step's gradient "
        f"norms by leaf against one rank's, relative, largest "
        f"{', '.join(f'{n} {grads[0][n]:.2e}' for n in worst)} (tolerance "
        f"{MR_GRAD_RTOL}, {len(grads[0])} leaves); flash launches a rank "
        f"{flash_b} (a step {per_step}, an eval batch "
        f"{(PP_TICKS * local, 0, 0)}); step host ms a rank {plain} "
        f"(unprofiled; median past the first {med}), epoch s "
        f"{b['epoch_s']}; the collectives of the profiled step "
        f"{[round(x, 3) for x in share]} of a median step, ppermute "
        f"{[round(x, 3) for x in pshare]} (ms by op, rank 0: "
        f"{ {k: round(v, 1) for k, v in comm[0].items()} }; gloo over host "
        f"memory, the card's queue drained before each span); checkpoints "
        f"{b['tags']}")
    if b["error"] or b["par"] != [PP_WORLD] * 2 or b["tags"] != [
            "ep00000", "ep00001"]:
        bad.append(f"19b: error {b['error']}, parallelism {b['par']}, "
                   f"checkpoints {b['tags']}")
    if not (all(np.isfinite(b["train"] + b["val"]))
            and err_b <= MR_LOSS_ATOL):
        bad.append(f"19b: losses {b['train']} {b['val']} against the one "
                   f"rank's {ref['a']}")
    for g in grads:
        if set(g) != set(ref["norms"]) or not all(
                e <= MR_GRAD_RTOL for e in g.values()):
            bad.append(f"19b: gradient norms off one rank's: "
                       f"{ {n: g[n] for n in worst} }")
    if any(f != want_flash(2) for f in flash_b):
        bad.append(f"19b: flash launches {flash_b}, want {want_flash(2)} "
                   f"a rank")
    # 19c
    c = lead["c"]
    flash_c = [r[1]["flash"] for r in runs]
    read = [r[1]["restore_bytes"] for r in runs]
    saves = [r[1]["save"] for r in runs]
    err_c = abs(c["train"][2] - ref["c"][0][2])
    staged, shard_bad = check_shards(c, {"pp": PP_STAGES})
    bad += [f"19c {x}" for x in shard_bad]
    log(f"  19c {PP_JOB} resumed from ep00001 [{smi}]: train loss "
        f"{c['train']}, epoch 3 {c['train'][2]:.4f} against the one-rank "
        f"continuation {ref['c'][0][2]:.4f} (difference {err_c:.2e}); "
        f"history spliced "
        f"{'exactly' if c['train'][:2] == b['train'] else 'NOT'}; each rank's restore read {read} bytes; flash launches a rank "
        f"{flash_c}; the leaves every rank holds after it "
        f"{'bit-equal' if len(set(digests)) == 1 else 'DIFFERENT'} on the "
        f"ranks ({digests[0][1] if digests[0] else 0} leaves); sharded "
        f"final {sorted(c['files'])}, processes "
        f"{c['manifest']['processes']}, {staged} stage-stacked leaves a "
        f"stage on each rank, {c['size']} bytes; its save a rank "
        + "; ".join(f"rank {i}: {s['bytes']} bytes in "
                    f"{1e3 * s['seconds']:.1f} ms" for i, s in enumerate(saves)
                    if s))
    if c["error"] or c["train"][:2] != b["train"] or len(c["train"]) != 3:
        bad.append(f"19c: {c['error']}, {c['train']}")
    if not err_c <= MR_LOSS_ATOL:
        bad.append(f"19c: epoch 3 loss {c['train'][2]} against "
                   f"{ref['c'][0][2]}")
    if any(f != want_flash(1) for f in flash_c):
        bad.append(f"19c: flash launches {flash_c}, want {want_flash(1)}")
    if len(set(digests)) != 1 or digests[0] is None:
        bad.append("19c: the ranks' replicated leaves differ")
    if any(not n for n in read):
        bad.append(f"19c: restore bytes {read}")
    served = lead["served"]
    log(f"  19c the 2-shard final through flat_serving_remap("
        f"{PP_STAGES}, {local}), served from rank 0's PS: launches "
        f"(paged_attention, int8_matmul) f32 {served['f32']}, int8 "
        f"{served['int8']}; the follower ran {ranks[1]['followed']} jobs")
    if served["f32"][0] <= 0 or min(served["int8"]) <= 0:
        bad.append(f"19c: served launches {served}")
    if ranks[1]["followed"] != [2, 0]:
        bad.append(f"19: the follower ran {ranks[1]['followed']} jobs")
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))
    total = [0, 0, 0]
    for cnt in flash_b + flash_c + [x["launches"] for x in lm]:
        total = [t + n for t, n in zip(total, cnt)]
    log(f"  19a kernels on fully masked rows: max |kernel - plain| "
        f"{masked_err}")
    return tuple(total), tuple(x + y for x, y in zip(served["f32"],
                                                     served["int8"]))


# --- phase 20: MoE over ranks ------------------------------------------------

# Two ranks share the H100 over gloo, as in phases 17-19; the parent checks
# the kernels and runs the one-rank references first. (a) bench_moe
# (kubeml_tpu/benchmarks/transformers.py:107-125: the GPT-2-small skeleton,
# vocab 32000, L 512, 12 heads of 64, 8 experts, top-2, capacity 1.25, an
# MoE block every other block, B 16, bf16, AdamW 3e-4) at full width,
# depth cut from 12 to MOE_EP_DEPTH (MOE_DEPTH, 4) blocks to make room for
# phase 22, trained over ep=2, then at MOE_DEPTH over
# dp=2, tp=2 and sp=2 (Ulysses), each from the weights (seed 0), batch and
# step seeds of a one-rank trainer (benchmarks.transformers.MoEBench);
# (b) MOE_FN's model at MOE_DEPTH as an SPMD job through /train over ep=2
# with ep-sharded checkpoints, resumed under dp=2, its final served.
MOE_EP_WORLD, MOE_EP_TIMEOUT_S, MOE_EP_SEED = 2, 900.0, 20
MOE_EP_DEPTH = MOE_DEPTH
MOE_EP_MESHES = (("ep=2", dict(ep=2), "ring", MOE_EP_DEPTH),
                 ("dp=2", dict(dp=2), "ring", MOE_DEPTH),
                 ("tp=2", dict(tp=2), "ring", MOE_DEPTH),
                 ("sp=2 ulysses", dict(sp=2), "ulysses", MOE_DEPTH))
# (a) the flash kernels at this phase's attention shape: a tp=2 rank's 6
# heads, and a Ulysses rank's after the all-to-all (B 16, L 512, D 64)
MOE_EP_HEADS = MOE_H // 2
# (a) dp=2 is the card's check of the global capacity: each rank computes
# its 8 rows as one rank computes them (the first step's losses were
# bit-equal on the card), so the first step's overflow must equal the
# one-rank trainer's (1e-4: below 2 of the 16,384 top-2 assignments of a
# layer), and every step's within 2e-3 (33 assignments: after a step the
# bf16 weights differ by roundings and argmax near ties may flip). A
# rank-local capacity routes each half against 640 slots of its own
# instead of the global queue. Over ep, tp and sp the overflow is
# reported beside the one-rank trainer's: their bf16 sums over ranks flip
# near ties from the first step on.
MOE_EP_OVER_ATOL0, MOE_EP_OVER_ATOL = 1e-4, 2e-3
# (b) the job: 4 steps an epoch at B MOE_B, one eval batch, L MOE_L
MOE_EP_JOB, MOE_EP_TRAIN, MOE_EP_TEST, MOE_EP_EPOCHS = "moe-ep", 64, 16, 2
MOE_EP_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel


class MoEEp(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("moe-tokens"))

    def build(self):
        # bf16 compute to train, f32 to serve
        dtype = torch.bfloat16 if self.task == "train" else torch.float32
        return CausalTransformer(vocab_size=%d, max_len=%d, embed_dim=768,
                                 depth=%d, num_heads=12, moe_every=2,
                                 num_experts=8, top_k=2, dtype=dtype,
                                 seed=%d, mesh=self.mesh)

    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
""" % (MOE_VOCAB, MOE_L, MOE_DEPTH, SEED)
# (b) the served requests: (rows, prompt tokens, new tokens)
MOE_EP_SERVE = ((2, 32, 24), (1, 100, 32))


def moe_ep_module(depth, mesh=None, impl="ring"):
    """bench_moe's model at ``depth`` (MoEBench's seed, bf16), over
    ``mesh`` or on the card."""
    from kubeml_tpu_torch.benchmarks.harness import SEED as BENCH_SEED
    from kubeml_tpu_torch.benchmarks.transformers import (MOE_ROUTING,
                                                          MOE_WIDTHS)
    from kubeml_tpu_torch.models.gpt import CausalTransformer

    return CausalTransformer(max_len=MOE_L, **dict(MOE_WIDTHS, depth=depth),
                             **MOE_ROUTING, mesh=mesh, sp_impl=impl,
                             dtype=torch.bfloat16, seed=BENCH_SEED,
                             device=None if mesh is not None else "cuda")


def moe_ep_tokens():
    """MoEBench's batch: [MOE_B, MOE_L] in [1, vocab), numpy seed 0."""
    return np.random.default_rng(0).integers(
        1, MOE_VOCAB, size=(MOE_B, MOE_L)).astype(np.int32)


def moe_ep_steps(trainer, tokens, profiled: bool = False):
    """MR_STEPS steps of ``trainer`` on ``tokens``, step s's router noise
    from MoEBench's ``fold_in(SEED, s)``: the losses, each step's overflow
    and host ms, the first step's gradient norms by leaf and, with
    ``profiled``, the collectives' ms of the last step (``kubeml::``
    spans of a CPU profiler window)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeml_tpu_torch.benchmarks.harness import SEED as BENCH_SEED
    from kubeml_tpu_torch.models.layers import fold_in

    out = dict(losses=[], overflow=[], ms=[], comm={})
    for step in range(MR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rng = fold_in(BENCH_SEED, step)
        if profiled and step == MR_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss = float(trainer.train_step(tokens, rng=rng))
            out["comm"] = {e.key: e.cpu_time_total / 1e3
                           for e in prof.key_averages()
                           if e.key.startswith("kubeml::")}
        else:
            loss = float(trainer.train_step(tokens, rng=rng))
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(loss)
        out["overflow"].append(float(trainer.last_moe_overflow))
        if step == 0:
            out["norms"] = grad_norms(trainer)
    return out


def moe_ep_kernels(smi):
    """20a's kernels: the three flash kernels at [MOE_B, MOE_L,
    MOE_EP_HEADS, 64] causal against their plain versions in bf16 and f32,
    kernel / plain / SDPA / bound ms in bf16. Returns the bf16 errors and
    times."""
    timer = Timer()
    g = torch.Generator().manual_seed(SEED + 20)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, valid = flash_inputs(g, MOE_B, MOE_L, MOE_L, 64, dtype,
                                          heads=MOE_EP_HEADS)
        errs[dtype] = check_flash_case(f"k moe-ep {MOE_EP_HEADS} heads", q,
                                       k, v, do, valid, True)
        if dtype == torch.bfloat16:
            times = flash_times(timer, q, k, v, do, valid, True)
        del q, k, v, do, valid
    log(f"  20a flash [{MOE_B}, {MOE_L}, {MOE_EP_HEADS}, 64] causal bf16 "
        f"times [{smi}]: " + json.dumps(times))
    del timer
    torch.cuda.empty_cache()
    return errs[torch.bfloat16], times


def moe_ep_reference():
    """The one-rank trainer at each depth of MOE_EP_MESHES (MoEBench's
    weights, batch and step seeds), as ``moe_ep_steps`` reports it."""
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    tokens = moe_ep_tokens()
    out = {}
    for depth in sorted({m[3] for m in MOE_EP_MESHES}, reverse=True):
        trainer = SPMDTrainer(moe_ep_module(depth), precision="bf16")
        trainer.init(tokens)
        out[depth] = moe_ep_steps(trainer, tokens)
        del trainer
        torch.cuda.empty_cache()
    return out


def moe_ep_train(rank):
    """20a on one rank: each mesh of MOE_EP_MESHES trained from the
    one-rank trainer's weights, batch and seeds; per mesh what
    ``moe_ep_steps`` reports, the flash launches, the digest of the whole
    parameters after the last step and this rank's expert stack."""
    from kubeml_tpu_torch.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.trainer import SPMDTrainer

    tokens = moe_ep_tokens()
    out = {}
    for tag, axes, impl, depth in MOE_EP_MESHES:
        mesh = make_mesh(**axes)
        trainer = SPMDTrainer(moe_ep_module(depth, mesh, impl), mesh,
                              precision="bf16")
        trainer.init(tokens)
        reset_flash_counts()
        row = moe_ep_steps(trainer, tokens, profiled=True)
        row.update(launches=flash_counts(), digest=whole_digest(trainer),
                   experts=tuple(trainer.module.block_1.moe.w_in.shape))
        out[tag] = row
        del trainer
        torch.cuda.empty_cache()
    return out


def moe_ep_data():
    rng = np.random.default_rng(MOE_EP_SEED)
    x = rng.integers(1, MOE_VOCAB, size=(MOE_EP_TRAIN + MOE_EP_TEST, MOE_L)
                     ).astype(np.int32)
    return x, np.zeros(len(x), np.int64)


def moe_ep_request(job, epochs, **opts):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(
        model_type="gpt", batch_size=MOE_B, epochs=epochs,
        dataset="moe-tokens", lr=3e-4, function_name="moeep", job_id=job,
        options=TrainOptions(engine="spmd", precision="bf16",
                             validate_every=1, static_parallelism=True,
                             sharded_checkpoints=True, checkpoint_every=1,
                             **opts))


def moe_ep_job_reference(root):
    """The one-rank SPMDJob of MOE_EP_FN on the card from the same seed
    and batches: 2 epochs with sharded checkpoints, resumed for a third;
    each epoch's (train, eval) loss and MetricUpdate overflow."""
    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = cp_config(root)
    cfg.ensure_dirs()
    x, y = moe_ep_data()
    n = MOE_EP_TRAIN
    ShardStore(config=cfg).create("moe-tokens", x[:n], y[:n], x[n:], y[n:])
    FunctionRegistry(config=cfg).create("moeep", MOE_EP_FN)
    out = {}
    for key, epochs, opts in (("a", MOE_EP_EPOCHS, {}),
                              ("b", MOE_EP_EPOCHS + 1,
                               dict(resume=True, save_model=False))):
        req = moe_ep_request("ref", epochs, **opts)
        model = FunctionRegistry(config=cfg).load("moeep")
        model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                          k=1, task="train")
        updates = []
        h = SPMDJob("ref", req, model, store=ShardStore(config=cfg),
                    history_store=HistoryStore(config=cfg),
                    checkpoint_store=CheckpointStore(config=cfg),
                    device="cuda", on_metrics=updates.append).train()
        out[key] = dict(train=list(h.train_loss),
                        val=list(h.validation_loss),
                        overflow=[u.moe_overflow for u in updates])
        del model
        torch.cuda.empty_cache()
    return out


def moe_ep_leader(root, smi):
    """Rank 0: the control plane; 20b's ep=2 job, its resume under dp=2
    and its final served, through HTTP. Each epoch's MetricUpdate and the
    ``kubeml_job_moe_overflow`` line ``/metrics`` shows right after it."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.interop.from_flax import from_flax
    from kubeml_tpu_torch.models.generation import generate
    from kubeml_tpu_torch.models.layers import load_tree
    from kubeml_tpu_torch.storage.sharded_checkpoint import \
        ShardedCheckpointStore

    out = {"wall": {}}
    cfg = cp_config(root)
    x, y = moe_ep_data()
    n = MOE_EP_TRAIN
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        client.datasets().create("moe-tokens", x[:n], y[:n], x[n:], y[n:])
        client.functions().create("moeep", MOE_EP_FN)
        metrics = cluster.ps.metrics
        take = type(metrics).update.__get__(metrics)
        updates = []

        def update(u):
            take(u)
            text = http_text(f"{cluster.ps_api.url}/metrics")
            updates.append(dict(
                epoch=u.epoch, overflow=u.moe_overflow,
                gauge=[ln for ln in text.splitlines() if ln.startswith(
                    f'kubeml_job_moe_overflow{{jobid="{MOE_EP_JOB}"}}')]))

        metrics.update = update
        shards = ShardedCheckpointStore(root=cfg.checkpoints_dir)
        for key, epochs, opts in (
                ("b", MOE_EP_EPOCHS, dict(mesh_shape={"ep": 2})),
                ("c", MOE_EP_EPOCHS + 1, dict(mesh_shape={"dp": 2},
                                              resume=True,
                                              save_model=False))):
            t0 = time.monotonic()
            client.networks().train(moe_ep_request(MOE_EP_JOB, epochs,
                                                   **opts))
            h = cp_wait_job(cluster, MOE_EP_JOB)
            out["wall"][key] = time.monotonic() - t0
            out[key] = dict(train=list(h.train_loss),
                            val=list(h.validation_loss),
                            par=list(h.parallelism),
                            error=h.task.get("error"),
                            tags=shards.tags(MOE_EP_JOB),
                            metrics=list(updates))
            updates.clear()
        del metrics.update
        d = cfg.checkpoints_dir / MOE_EP_JOB / "final.shards"
        man = shards.read_manifest(MOE_EP_JOB, "final")
        files = {}
        for p in sorted(d.glob("shard-*.npz")):
            with np.load(p) as z:
                files[p.name] = {k: z[k].shape for k in z.files}
        out["b"].update(manifest=dict(processes=man["processes"],
                                      leaves=man["leaves"]), files=files,
                        size=sum(p.stat().st_size for p in d.iterdir()))
        # the ep-sharded final, assembled on this rank, served by the
        # dense engine in f32; held against an in-process generate
        if cluster.ps._serving_source(MOE_EP_JOB)[0] != "sharded":
            raise AssertionError("20b: the served final is not the sharded "
                                 "export")
        t0 = time.monotonic()
        module = load_tree(moe_f32(), from_flax(shards.restore(
            MOE_EP_JOB, "final").variables)).eval()
        rng = np.random.default_rng(MOE_EP_SEED + 1)
        served = []
        for rows, plen, new in MOE_EP_SERVE:
            prompt = rng.integers(1, MOE_VOCAB, size=(rows, plen))
            reply, wall = timed(lambda: client.networks().generate(
                MOE_EP_JOB, prompt, max_new_tokens=new))
            got = [t[:m] for t, m in zip(reply["tokens"], reply["lengths"])]
            want = rows_of(generate(module, prompt, max_new_tokens=new))
            ties = check_rows("20b f32", got, want, module, prompt)
            served.append(dict(rows=rows, plen=plen, tokens=sum(map(
                len, got)), ms=1e3 * wall, ties=ties))
        with cluster.ps._lock:
            engine = type(cluster.ps._decoders[MOE_EP_JOB][0]).__name__
        out["served"] = dict(rows=served, engine=engine,
                             s=time.monotonic() - t0)
        del module
        torch.cuda.empty_cache()
    return out


def moe_ep_rank(rank, out_dir, root, smi):
    """One rank of phase 20 (started by ``parallel.distributed.spawn``):
    the process group over gloo, the kernels the parent built, 20a's
    meshes, then 20b as ``kubeml start`` runs a rank: the control plane
    on rank 0 and the follower loop on rank 1."""
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.parallel.distributed import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    res = dict(train=moe_ep_train(rank))
    records = []
    job_instrument(records)
    if rank == 0:
        res.update(moe_ep_leader(root, smi))
    else:
        res["followed"] = run_follower(config=cp_config(root))
    res["jobs"] = records
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def moe_ep_phase(smi, root):
    """Phase 20 (see the module docstring). Returns the flash launches
    (fwd, dq, dkv) of its runs over ranks, summed over the ranks."""
    from kubeml_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    kerr, ktimes = moe_ep_kernels(smi)
    ref = moe_ep_reference()
    for depth, r in ref.items():
        log(f"  20a one-rank bench_moe at depth {depth} [{smi}]: losses "
            f"{r['losses']}, overflow {[round(o, 5) for o in r['overflow']]}"
            f", step ms {[round(m, 1) for m in r['ms']]}")
    jref = moe_ep_job_reference(Path(root) / "moe-ep-ref")
    log(f"  20b one-rank SPMDJob: train/eval {jref['a']['train']} "
        f"{jref['a']['val']}, resumed {jref['b']['train']}; overflow "
        f"{jref['a']['overflow']} ({time.monotonic() - t0:.1f} s with 20a's "
        f"kernels and references)")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_ep_") as tmp:
        spawn(moe_ep_rank, MOE_EP_WORLD,
              args=(tmp, str(Path(root) / "moe-ep"), smi),
              timeout_s=MOE_EP_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(MOE_EP_WORLD)]
    lead = ranks[0]
    log(f"  20 {MOE_EP_WORLD} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included; walls (s) "
        f"{ {k: round(v, 1) for k, v in lead['wall'].items()} }")
    bad = []
    total = [0, 0, 0]
    # 20a
    for tag, axes, impl, depth in MOE_EP_MESHES:
        want = ref[depth]
        rows = [r["train"][tag] for r in ranks]
        losses = [r["losses"] for r in rows]
        err = max(abs(a - b) for a, b in zip(losses[0], want["losses"]))
        over = max(abs(a - b) for a, b in zip(rows[0]["overflow"],
                                              want["overflow"]))
        over0 = abs(rows[0]["overflow"][0] - want["overflow"][0])
        grad = grad_errors(rows[0]["norms"], want["norms"])
        worst = sorted(grad, key=grad.get, reverse=True)[:3]
        digests = [r["digest"] for r in rows]
        launches = [r["launches"] for r in rows]
        per_step = (MR_STEPS * depth,) * 3
        share = [sum(r["comm"].values()) / r["ms"][-1] for r in rows]
        # the profiler lengthens the step it watches on the host: the
        # spans' ms over the unprofiled second step's too
        steady = [sum(r["comm"].values()) / r["ms"][1] for r in rows]
        log(f"  20a bench_moe depth {depth} {tag} [{smi}]: losses "
            f"{losses[0]} (one rank {want['losses']}; largest difference "
            f"{err:.2e}, tolerance {MR_LOSS_ATOL}); overflow "
            f"{[round(o, 5) for o in rows[0]['overflow']]} (one rank "
            f"{[round(o, 5) for o in want['overflow']]}; difference at the "
            f"first step {over0:.2e}, largest {over:.2e}"
            + (f"; tolerances {MOE_EP_OVER_ATOL0}, {MOE_EP_OVER_ATOL}"
               if tag == "dp=2" else "")
            + f"); first step's "
            f"gradient norms by leaf against one rank's, relative: largest "
            f"{', '.join(f'{n} {grad[n]:.2e}' for n in worst)} (tolerance "
            f"{MR_GRAD_RTOL}, {len(grad)} leaves); whole parameters after "
            f"step {MR_STEPS}: {digests[0][1]} leaves, "
            f"{'bit-equal' if len(set(digests)) == 1 else 'DIFFERENT'} on "
            f"the ranks; block_1 experts {rows[0]['experts']}; flash "
            f"launches a rank {launches} over {MR_STEPS} steps; step host ms "
            f"a rank " + "; ".join(
                f"rank {i}: " + ", ".join(f"{m:.1f}" for m in r["ms"])
                for i, r in enumerate(rows))
            + f" (the last profiled); collectives' share of the profiled "
            f"step {[round(s, 3) for s in share]}, their ms over the "
            f"unprofiled second step's {[round(s, 3) for s in steady]} (ms "
            f"by op, rank 0: "
            f"{ {k: round(v, 1) for k, v in rows[0]['comm'].items()} }; "
            f"gloo over host memory, not NVLink)")
        if any(x != losses[0] for x in losses[1:]):
            bad.append(f"20a {tag}: the ranks report other losses {losses}")
        if not (all(np.isfinite(losses[0])) and err <= MR_LOSS_ATOL):
            bad.append(f"20a {tag}: losses {losses[0]} against the one-rank "
                       f"{want['losses']}")
        if any(r["overflow"] != rows[0]["overflow"] for r in rows[1:]) or (
                tag == "dp=2" and not (over0 <= MOE_EP_OVER_ATOL0
                                       and over <= MOE_EP_OVER_ATOL)):
            bad.append(f"20a {tag}: overflow {[r['overflow'] for r in rows]}"
                       f" against the one-rank {want['overflow']}")
        if set(grad) != set(want["norms"]) or not all(
                e <= MR_GRAD_RTOL for e in grad.values()):
            bad.append(f"20a {tag}: gradient norms off one rank's: "
                       f"{ {n: grad[n] for n in worst} }")
        if len(set(digests)) != 1:
            bad.append(f"20a {tag}: the ranks' whole parameters differ")
        if any(c != per_step for c in launches):
            bad.append(f"20a {tag}: flash launches {launches}, want "
                       f"{per_step} a rank")
        for c in launches:
            total = [t + n for t, n in zip(total, c)]
    # 20b
    runs = [[j for j in r["jobs"] if j["job"] == MOE_EP_JOB] for r in ranks]
    b, c = lead["b"], lead["c"]
    err_b = max(abs(p - q) for p, q in zip(
        b["train"] + b["val"], jref["a"]["train"] + jref["a"]["val"]))
    over_b = [m["overflow"] for m in b["metrics"]]
    gauges = [m["gauge"] for m in b["metrics"]]
    steps = MOE_EP_TRAIN // MOE_B
    # a step: fwd, dq and dkv once a block (no remat); an eval batch: fwd
    want_b = ((steps + 1) * MOE_DEPTH * MOE_EP_EPOCHS,
              steps * MOE_DEPTH * MOE_EP_EPOCHS,
              steps * MOE_DEPTH * MOE_EP_EPOCHS)
    want_c = tuple(n // MOE_EP_EPOCHS for n in want_b)
    flash_b = [r[0]["flash"] for r in runs]
    flash_c = [r[1]["flash"] for r in runs]
    saves = [r[0]["save"] for r in runs]
    experts, shard_bad = check_shards(b, {"ep": MOE_EP_WORLD})
    log(f"  20b {MOE_EP_JOB} ep={MOE_EP_WORLD} [{smi}]: /train engine=spmd, "
        f"{MOE_EP_EPOCHS} epochs x {steps} steps of B {MOE_B} x L {MOE_L} "
        f"at depth {MOE_DEPTH}: train loss {b['train']} (one rank "
        f"{jref['a']['train']}), eval loss {b['val']} (one rank "
        f"{jref['a']['val']}); largest difference {err_b:.2e} (tolerance "
        f"{MR_LOSS_ATOL}); parallelism {b['par']}; moe_overflow pushed by "
        f"rank 0 {over_b} (one rank {jref['a']['overflow']}), /metrics "
        f"{gauges}; flash launches a rank {flash_b}; sharded final "
        f"{sorted(b['files'])}, processes {b['manifest']['processes']}, "
        f"{experts} leaves split (the expert stacks, a half of the experts "
        f"a rank), {b['size']} bytes; its save a rank " + "; ".join(
            f"rank {i}: {s['bytes']} bytes in {1e3 * s['seconds']:.1f} ms"
            for i, s in enumerate(saves) if s) + f"; checkpoints {b['tags']}")
    bad += [f"20b {x}" for x in shard_bad]
    if b["error"] or b["par"] != [MOE_EP_WORLD] * MOE_EP_EPOCHS:
        bad.append(f"20b: error {b['error']}, parallelism {b['par']}")
    if not (all(np.isfinite(b["train"] + b["val"]))
            and err_b <= MR_LOSS_ATOL):
        bad.append(f"20b: losses {b['train']} {b['val']} against the one "
                   f"rank's {jref['a']}")
    if len(over_b) != MOE_EP_EPOCHS or not all(
            0.0 <= o <= 1.0 for o in over_b):
        bad.append(f"20b: moe_overflow {over_b}, one rank "
                   f"{jref['a']['overflow']}")
    if any(g != [f'kubeml_job_moe_overflow{{jobid="{MOE_EP_JOB}"}} {o}']
           for g, o in zip(gauges, over_b)):
        bad.append(f"20b: /metrics overflow lines {gauges}")
    if experts != 2 * (MOE_DEPTH // 2):
        bad.append(f"20b: {experts} split leaves, want the {MOE_DEPTH // 2} "
                   f"MoE blocks' w_in and w_out")
    if any(f != want_b for f in flash_b):
        bad.append(f"20b: flash launches {flash_b}, want {want_b} a rank")
    err_c = abs(c["train"][-1] - jref["b"]["train"][-1])
    read = [r[1]["restore_bytes"] for r in runs]
    log(f"  20b resumed from its ep-sharded checkpoint under dp="
        f"{MOE_EP_WORLD} [{smi}]: train loss {c['train']}, epoch "
        f"{MOE_EP_EPOCHS + 1} {c['train'][-1]:.4f} against the one-rank "
        f"continuation {jref['b']['train'][-1]:.4f} (difference "
        f"{err_c:.2e}); history spliced "
        f"{'exactly' if c['train'][:-1] == b['train'] else 'NOT'}; each "
        f"rank's restore read {read} bytes; flash launches a rank {flash_c}")
    if c["error"] or c["train"][:-1] != b["train"] or not (
            err_c <= MR_LOSS_ATOL):
        bad.append(f"20b resume: {c['error']}, {c['train']} against "
                   f"{jref['b']['train']}")
    if any(f != want_c for f in flash_c) or any(not n for n in read):
        bad.append(f"20b resume: flash launches {flash_c} (want {want_c}), "
                   f"restore bytes {read}")
    served = lead["served"]
    log(f"  20b the ep-sharded final served from rank 0's PS by "
        f"{served['engine']} in f32: " + ", ".join(
            f"{s['rows']} x {s['plen']}-token prompts, {s['tokens']} tokens "
            f"in {s['ms']:.1f} ms (near ties {s['ties'] or 'none'})"
            for s in served["rows"])
        + f"; tokens equal to the in-process generate on the assembled "
        f"weights; {served['s']:.1f} s; the follower ran "
        f"{ranks[1]['followed']} jobs")
    if served["engine"] != "BatchingDecoder":
        bad.append(f"20b: served by {served['engine']}")
    if ranks[1]["followed"] != 2:
        bad.append(f"20b: the follower ran {ranks[1]['followed']} jobs")
    for cnt in flash_b + flash_c:
        total = [t + n for t, n in zip(total, cnt)]
    log(f"  20a flash kernels at [{MOE_B}, {MOE_L}, {MOE_EP_HEADS}, 64] "
        f"causal: max abs err (bf16) "
        + " ".join(f"{n} {e:.2e}" for n, e in kerr.items()))
    if bad:
        raise AssertionError("phase 20: " + "; ".join(bad))
    return tuple(total), ktimes


# --- phase 21: meshed serving over two gloo ranks -----------------------

SM_WORLD, SM_TIMEOUT_S, SM_SEED = 2, 600.0, 21
# 21a: the int8 matmul at GPT-2-small's tp=2 shard shapes (K, N): query,
# key and value (768, 384), proj (384, 768), mlp_in (768, 1536), mlp_out
# (1536, 768), and the lm_head whole (50257 does not divide over tp=2:
# the fit rule keeps it whole), at decode M 1 and 8 and the verify's M 40
SM_MM_SHAPES = [(M, K, N) for M in (1, 8, 40)
                for K, N in ((768, 384), (384, 768), (768, 1536),
                             (1536, 768), (768, VOCAB))]
# 21b's sampled requests of the mix (SAMPLE's knobs, request i seeded
# 1000 + i): 3 in the first wave of 8 slots, 12 a sharer admitted after
# request 0's first token, 9 and 15 queued until a slot frees mid-stream
SM_SAMPLED = (3, 9, 12, 15)
# 21b's f32 mix runs the mix's first SM_F32_N requests (the int8 mix all
# 16): cut from 16 to make room for phase 23
SM_F32_N = 8
# 21c: the served requests a final, (rows, prompt tokens, new tokens), and
# the serving meshes, each with the finals it serves (tp=4 needs more ranks
# than the world holds: logged, served on one rank)
SM_SERVE = ((2, 32, 16), (1, 100, 24))
SM_MESHES = (("tp=2", (JR_JOB, MOE_EP_JOB)), ("ep=2", (MOE_EP_JOB,)),
             ("tp=4", (JR_JOB,)))


def sm_comm(shard, acc):
    """Time ``shard``'s decode chunks while ``acc["on"]``: their ms and
    steps, the ms inside the collectives' ``kubeml::`` spans (the host
    copies and the gloo op) and the ms of the card drains that open each
    span under gloo (``parallel.collectives._span``), on the host clock,
    without a profiler's overhead."""
    from kubeml_tpu_torch.parallel import collectives

    real_span, decode = collectives._span, shard.decode

    class Timed:
        def __init__(self, cm):
            self.cm = cm

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self.cm.__enter__()

        def __exit__(self, *exc):
            out = self.cm.__exit__(*exc)
            acc["comm_ms"] += 1e3 * (time.perf_counter() - self.t0)
            return out

    def span(name, t):
        t0 = time.perf_counter()
        cm = real_span(name, t)
        if not acc["on"]:
            return cm
        acc["drain_ms"] += 1e3 * (time.perf_counter() - t0)
        return Timed(cm)

    def timed(op):
        if not acc["on"]:
            return decode(op)
        t0 = time.perf_counter()
        out = decode(op)
        acc["ms"] += 1e3 * (time.perf_counter() - t0)
        acc["steps"] += int(op["size"])
        return out

    acc.update(on=False, ms=0.0, steps=0, comm_ms=0.0, drain_ms=0.0)
    collectives._span, shard.decode = span, timed


def sm_summary(run) -> dict:
    t = run["tele"]
    return dict(tokens=token_lists(run), n=run["tokens"], wall=run["wall"],
                tokens_per_s=run["tokens_per_s"],
                decode_step_ms=run["decode_step_ms"],
                forwards=int(t["admission_waves"] + t["device_steps"]))


def sm_requests(vocab):
    rng = np.random.default_rng(SM_SEED)
    return [(rng.integers(1, vocab, size=(rows, plen)), new)
            for rows, plen, new in SM_SERVE]


def sm_cluster(rank, root):
    """21c on one rank: the control plane on rank 0 (each serving mesh of
    SM_MESHES a cluster in turn; /generate over HTTP) and the follower
    loop on rank 1. Rank 0 first serves each final on itself alone (a
    parameter server without a mesh: the dense engine), and holds every
    meshed reply to that one but for near ties."""
    import logging

    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.ps import ParameterServer

    if rank != 0:
        return dict(followed=[run_follower(config=cp_config(root))
                              for _ in SM_MESHES])
    reqs = {JR_JOB: sm_requests(LC_VOCAB), MOE_EP_JOB: sm_requests(MOE_VOCAB)}
    ref = ParameterServer(config=cp_config(root, serving_paged=False))
    one = {}
    for job, rs in reqs.items():
        one[job] = []
        for prompt, new in rs:
            reply = ref.generate(job, GenerateRequest(
                prompts=prompt.tolist(), max_new_tokens=new))
            one[job].append([t[:m] for t, m in zip(reply["tokens"],
                                                   reply["lengths"])])
    warned = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("kubeml.ps").addHandler(handler)
    out = dict(served=[])
    try:
        for spec, jobs in SM_MESHES:
            with LocalCluster(config=cp_config(root, serving_mesh=spec)) \
                    as cluster:
                client = KubemlClient(cluster.controller_url, timeout=600)
                for job in jobs:
                    t0, ties, n = time.monotonic(), [], 0
                    for i, (prompt, new) in enumerate(reqs[job]):
                        reply = client.networks().generate(
                            job, prompt, max_new_tokens=new)
                        got = [t[:m] for t, m in zip(reply["tokens"],
                                                     reply["lengths"])]
                        n += sum(map(len, got))
                        module = ref._decoders[job][0].module
                        ties += check_rows(f"21c {job} {spec}", got,
                                           one[job][i], module, prompt)
                    with cluster.ps._lock:
                        dec = cluster.ps._decoders[job][0]
                    out["served"].append(dict(
                        spec=spec, job=job, tokens=n, ties=ties,
                        s=time.monotonic() - t0,
                        mesh=None if getattr(dec, "mesh", None) is None
                        else dict(dec.mesh.shape),
                        engine=type(dec).__name__))
    finally:
        logging.getLogger("kubeml.ps").removeHandler(handler)
        ref.close()
    out["warned"] = [w for w in warned if "serving mesh" in w]
    return out


def sm_rank(rank, out_dir, root, smi):
    """One rank of phase 21 (started by ``parallel.distributed.spawn``):
    the process group over gloo, the kernels the parent built; 21b (rank 0
    runs the meshed decoder and phase 3's mix, rank 1 follows it), then
    21c."""
    from kubeml_tpu_torch.parallel.distributed import init_distributed
    from kubeml_tpu_torch.parallel.mesh import serving_mesh
    from kubeml_tpu_torch.serving import BatchingDecoder
    from kubeml_tpu_torch.serving.batcher import serve_follower

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    mesh = serving_mesh({"tp": 2})
    reqs = workload(np.random.default_rng(SEED))
    res = {}
    t0 = time.monotonic()
    for tag, knobs in (("f32", {}),
                       ("int8", dict(quantize="int8", int8_matmul=True))):
        reset_kernel_counts()
        if rank == 0:
            dec = BatchingDecoder(gpt2_small(), mesh=mesh, slots=SLOTS,
                                  chunk_steps=CHUNK, device="cuda", **knobs)
            comm = {}
            sm_comm(dec._shard, comm)
            comm["on"] = tag == "f32"
            run = sm_summary(serve(dec, reqs, sample=SM_SAMPLED,
                                   n=SM_F32_N if tag == "f32" else 16))
            comm["on"] = False
            res[tag] = dict(run=run, comm=comm, mesh=dict(dec.mesh.shape),
                            impl=dec.int8_matmul_impl if dec.int8_matmul
                            else None)
            dec.close()
        else:
            res[tag] = dict(ops=serve_follower(gpt2_small(), mesh))
        res[tag]["launches"] = kernel_counts()
        torch.cuda.empty_cache()
    res["b_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    res["c"] = sm_cluster(rank, root)
    res["c_s"] = time.monotonic() - t0
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def sm_root(root):
    """21c's data root: phase 18's and phase 20's finals (their job
    directories linked, not copied) and their functions."""
    from kubeml_tpu_torch.functions.registry import FunctionRegistry

    cfg = cp_config(Path(root) / "serving-mesh")
    cfg.ensure_dirs()
    for src, job in (("ranks", JR_JOB), ("moe-ep", MOE_EP_JOB)):
        (cfg.checkpoints_dir / job).symlink_to(
            Path(root) / src / "checkpoints" / job)
    reg = FunctionRegistry(config=cfg)
    reg.create("lcranks", JR_FN)
    reg.create("moeep", MOE_EP_FN)
    return cfg.data_root


def serving_mesh_phase(smi, root, mm_rows):
    """Phase 21 (see the module docstring; 21a's ``mm_rows`` come from
    phase 3). Returns the int8 matmul's launches of 21b's int8 mix,
    summed over the ranks."""
    from kubeml_tpu_torch.parallel.distributed import spawn
    from kubeml_tpu_torch.serving import BatchingDecoder

    for r in mm_rows:
        log(f"  21a int8_matmul at the tp=2 shard shape M {r['M']} K "
            f"{r['K']} N {r['N']} (f32 x) [{smi}]: max abs err "
            f"{r['max_abs_err']:.2e}, {r['ms']:.4f} ms (CUPTI "
            f"{r['profiler_ms'] or float('nan'):.4f}; plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f} by {r['bound_by']})")
    # 21b's one-rank references: the dense engine alone on the card
    t0 = time.monotonic()
    reqs = workload(np.random.default_rng(SEED))
    prompts = [reqs[5]["prompt"]] + [r["prompt"] for r in reqs]
    one, modules = {}, {}
    for tag, knobs in (("f32", {}),
                       ("int8", dict(quantize="int8", int8_matmul=True))):
        dec = BatchingDecoder(gpt2_small(), slots=SLOTS, chunk_steps=CHUNK,
                              device="cuda", **knobs)
        one[tag] = dict(run=sm_summary(serve(
            dec, reqs, sample=SM_SAMPLED,
            n=SM_F32_N if tag == "f32" else 16)))
        modules[tag] = dec.module
        dec.close()
    log(f"  21b one-rank references {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    data_root = sm_root(root)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sm_") as tmp:
        spawn(sm_rank, SM_WORLD, args=(tmp, str(data_root), smi),
              timeout_s=SM_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(SM_WORLD)]
    lead, follow = ranks
    log(f"  21 {SM_WORLD} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included (21b "
        f"{lead['b_s']:.1f} s, 21c {lead['c_s']:.1f} s)")
    bad = []
    for tag in ("f32", "int8"):
        g, w = lead[tag]["run"], one[tag]["run"]
        log(f"  21b {tag} [{smi}]: tp=2 {g['n']} tokens, "
            f"{g['tokens_per_s']:.1f} tokens/s, decode step "
            f"{g['decode_step_ms']:.3f} ms; one rank {w['n']} tokens, "
            f"{w['tokens_per_s']:.1f} tokens/s, decode step "
            f"{w['decode_step_ms']:.3f} ms")
        # rows of token_lists: the calibration first, then request i at
        # i + 1; the sampled rows are held exactly, the greedy ones by
        # check_rows (the sampled ones given the reference's rows there)
        rows = [i + 1 for i in SM_SAMPLED if i + 1 < len(w["tokens"])]
        differ = [b - 1 for b in rows if g["tokens"][b] != w["tokens"][b]]
        if differ:
            bad.append(f"21b {tag}: sampled requests {differ} differ from "
                       f"one rank's")
        else:
            log(f"  21b {tag} sampled ({SAMPLE}, requests "
                f"{[b - 1 for b in rows]} of the mix seeded 1000 + i): the "
                f"same "
                f"{sum(len(g['tokens'][b]) for b in rows)} tokens as one "
                f"rank")
        got = [w["tokens"][b] if b in rows else t
               for b, t in enumerate(g["tokens"])]
        ties = check_rows(f"21b {tag}", got, w["tokens"], modules[tag],
                          prompts)
        log(f"  21b {tag}: greedy tokens equal to one rank's dense "
            f"decoder (near ties {ties or 'none'})")
        forwards = g["forwards"]
        per = INT8_PER_FORWARD * forwards if tag == "int8" else 0
        for r, res in enumerate(ranks):
            log(f"  21b {tag} rank {r} launches (paged_attention, "
                f"int8_matmul, flash fwd/dq/dkv): {res[tag]['launches']}")
            if res[tag]["launches"] != (0, per, 0, 0, 0):
                bad.append(f"21b {tag} rank {r}: launches "
                           f"{res[tag]['launches']}, want (0, {per}, 0, 0, "
                           f"0): {INT8_PER_FORWARD} x {forwards} forwards")
        if lead[tag]["mesh"] != {"tp": 2}:
            bad.append(f"21b {tag}: decoder mesh {lead[tag]['mesh']}")
    if lead["int8"]["impl"] != "cuda":
        bad.append(f"21b int8: impl {lead['int8']['impl']}")
    p = lead["f32"]["comm"]
    if not p["steps"]:
        bad.append("21b: no timed decode chunk")
    else:
        log(f"  21b f32 greedy decode chunks over tp=2 [{smi}]: "
            f"{p['steps']} steps, {p['ms'] / p['steps']:.2f} ms a step, of "
            f"which the collectives (kubeml:: spans: host copies and the "
            f"gloo op) {p['comm_ms'] / p['steps']:.2f} ms = "
            f"{p['comm_ms'] / p['ms']:.3f} and the card drains before them "
            f"{p['drain_ms'] / p['steps']:.2f} ms = "
            f"{p['drain_ms'] / p['ms']:.3f}")
    c = lead["c"]
    want_mesh = {"tp=2": {"tp": 2}, "ep=2": {"ep": 2}, "tp=4": None}
    for row in c["served"]:
        log(f"  21c {row['job']} on serving_mesh={row['spec']!r} [{smi}]: "
            f"{row['tokens']} tokens in {row['s']:.2f} s through /generate, "
            f"{row['engine']} on mesh {row['mesh']}, tokens equal to one "
            f"rank's (near ties {row['ties'] or 'none'})")
        if row["mesh"] != want_mesh[row["spec"]]:
            bad.append(f"21c {row['job']} {row['spec']}: mesh {row['mesh']}")
    if len(c["served"]) != sum(len(jobs) for _, jobs in SM_MESHES):
        bad.append(f"21c served {len(c['served'])} finals")
    if not any("tp=4" in w for w in c["warned"]):
        bad.append(f"21c: no warning for tp=4: {c['warned']}")
    log(f"  21c tp=4: {c['warned']}")
    if follow["c"]["followed"] != [0] * len(SM_MESHES):
        bad.append(f"21c follower ran jobs {follow['c']['followed']}")
    if bad:
        raise AssertionError("21: " + "; ".join(bad))
    return sum(r["int8"]["launches"][1] for r in ranks)


# --- phase 22: K-AVG over ranks ------------------------------------------------

# Two ranks share the H100 over gloo, as in phases 17-21, each holding its
# block of the global worker axis (KAvgTrainer(dist=)); the parent runs the
# one-rank references first. (a) the flagship at bench.py's configuration,
# N KR_N over the ranks (2 workers a rank), against phase 10a's one-rank
# N 4 (KR_ROUNDS rounds, one run), then 10b's f32 round over the ranks;
# (c) ViT-Tiny at phase 14c's configuration, N KR_VIT_N (one worker a
# rank), against one rank's N 2; (b) 10c's ResNet-18 function as a K-AVG
# job through /train, rank 0 the control plane and rank 1 a follower.
KR_WORLD, KR_TIMEOUT_S = 2, 900.0
KR_N, KR_ROUNDS = 4, 3
# (a) f32 over the ranks: worker 2 (rank 1's first) masked
KR_F32_MASK = (1.0, 1.0, 0.0, 1.0)
# (b) the job: requested parallelism 3 (rounded to 2 over two ranks), the
# scheduler's answers after each epoch (3 rounded to 2): trace [2, 4, 2];
# the one-rank reference is fed the rounded answers
KR_JOB, KR_ASK, KR_LEVELS, KR_REF_LEVELS = "kavg-ranks", 3, (4, 3, 2), (4, 2, 2)
KR_TRACE = [2, 4, 2]
# (b) the banded set at half 10c's size
KR_TRAIN, KR_TEST = 2048, 512
# (c) ViT-Tiny's rounds over the ranks: one warm-up and KR_VIT_ROUNDS more,
# all counted; the flash kernels launch ENC_DEPTH x VIT_K times a local
# worker a round
KR_VIT_N, KR_VIT_ROUNDS = 2, 3
# (a) f32: a rank's merged weights against one rank's, each leaf's largest
# difference against its largest entry (the workers run the same kernels;
# only the order of the merge's sums may differ)
KR_F32_RTOL = 1e-6
# (c) bf16: each leaf's largest difference within 4 bf16 ulps of its
# largest entry after the rounds (a 1-ulp difference in the merge's cast
# feeds the next rounds' steps), the losses within MR_LOSS_ATOL
KR_VIT_W_RTOL = 2.0 ** -5


def kr_profile(bench, rounds: int = 2) -> dict:
    """A profiler window (CPU and CUDA) over ``rounds`` of ``bench``'s
    rounds on this rank: the wall, the device-busy ms (0.0 when the
    profiler saw no device time) and each ``kubeml::`` span's ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            loss = bench.round()
        float(loss)
        wall = 1e3 * (time.perf_counter() - t0)
    busy, spans = 0.0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("kubeml::"):
            spans[evt.key] = evt.cpu_time_total / 1e3
        elif (str(getattr(evt, "device_type", "")).endswith("CUDA")
              and not getattr(evt, "is_user_annotation", False)):
            t = getattr(evt, "self_device_time_total", None)
            busy += (t if t is not None else evt.self_cuda_time_total) / 1e3
    return dict(wall_ms=wall, busy_ms=busy, spans=spans, rounds=rounds)


def kr_f32_round(dist=None):
    """22a's f32 round (TF32 off, deterministic cuDNN): ResNet-18, N KR_N,
    K 2, B 16, worker 2 masked, from the seed-0 weights, on this rank's rows
    (all of them without ``dist``). Returns replica 0 (flat, on the host),
    the loss, and whether every local row holds the same bits."""
    from kubeml_tpu_torch.benchmarks.harness import LR, make_synthetic_model
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.models.resnet import ResNet18

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        r = np.random.default_rng(1)
        x = r.normal(size=(KR_N, 2, 16, 32, 32, 3)).astype(np.float32)
        y = r.integers(0, 10, size=(KR_N, 2, 16)).astype(np.int64)
        m = np.ones((KR_N, 2, 16), np.float32)
        t = KAvgTrainer(make_synthetic_model(ResNet18(num_classes=10)),
                        precision="f32", device="cuda" if dist is None
                        else None, dist=dist)
        a, b = t.local_rows(KR_N)
        v = t.init_variables(0, x[0, 0], KR_N)
        v, loss = t.sync_round(v, x[a:b], y[a:b], m[a:b], lr=LR,
                               worker_mask=np.array(KR_F32_MASK, np.float32))
        same = all(torch.equal(leaf, leaf[:1].expand_as(leaf))
                   for c in v.values() for leaf in c.values())
        return dict(merged=_flat(t.reference_variables(v)),
                    loss=float(loss), rows_same=same)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def kr_vit(dist=None) -> dict:
    """22c: ViT-Tiny at phase 14c's configuration (depth ENC_DEPTH, B
    256, K VIT_K, bf16), N KR_VIT_N over the ranks (all of them without
    ``dist``), each worker its own seeded batch: a warm-up round and
    KR_VIT_ROUNDS more, the flash counters set to 0 before the first and
    read after the last; each round's loss and ms, and replica 0."""
    from kubeml_tpu_torch.benchmarks.harness import make_synthetic_model
    from kubeml_tpu_torch.benchmarks.transformers import LR
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer
    from kubeml_tpu_torch.models.layers import fold_in
    from kubeml_tpu_torch.models.vit import ViT

    module = ViT(num_classes=100, patch_size=4, embed_dim=192,
                 depth=ENC_DEPTH, num_heads=3, dtype=torch.bfloat16)
    t = KAvgTrainer(make_synthetic_model(module, "vit-ranks"),
                    precision="bf16",
                    device="cuda" if dist is None else None, dist=dist)
    r = np.random.default_rng(SEED + 22)
    B = ENC_VIT["B"]
    x = r.normal(size=(KR_VIT_N, VIT_K, B, 32, 32, 3)).astype(np.float32)
    y = r.integers(0, 100, size=(KR_VIT_N, VIT_K, B)).astype(np.int64)
    m = np.ones((KR_VIT_N, VIT_K, B), np.float32)
    a, b = t.local_rows(KR_VIT_N)
    v = t.init_variables(SEED, x[0, 0], KR_VIT_N)
    staged = t.stage_round(x[a:b], y[a:b], m[a:b], KR_VIT_N)
    losses, ms = [], []
    reset_flash_counts()
    for i in range(1 + KR_VIT_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, loss = t.sync_round(v, *staged, lr=LR, rng=fold_in(SEED, i))
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = flash_counts()
    return dict(losses=losses, ms=ms, launches=counts,
                rounds=1 + KR_VIT_ROUNDS, local=b - a,
                weights=_flat(t.reference_variables(v)))


def kr_request(default_parallelism: int):
    """22b's request: phase 10c's job (B 64, K 4, lr 0.05, bf16, 3 epochs,
    a checkpoint every epoch, no goal-accuracy stop)."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(
        model_type="resnet18", batch_size=64, epochs=3, dataset="bands",
        lr=0.05, function_name="bands", job_id=KR_JOB,
        options=TrainOptions(default_parallelism=default_parallelism, k=4,
                             precision="bf16", goal_accuracy=101.0,
                             checkpoint_every=1, save_model=True))


def kr_reference_job(root):
    """22b's one-rank TrainJob: the same function, data and request at
    parallelism 2, fed the rounded answers (trace [2, 4, 2])."""
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = cp_config(root)
    cfg.ensure_dirs()
    FunctionRegistry(config=cfg).create("bands", BANDS_FN % 64)
    ShardStore(config=cfg).create("bands", *banded_images(KR_TRAIN, 2),
                                  *banded_images(KR_TEST, 3))
    levels = list(KR_REF_LEVELS)
    job = TrainJob(KR_JOB, kr_request(2),
                   FunctionRegistry(config=cfg).load("bands"),
                   store=ShardStore(config=cfg),
                   history_store=HistoryStore(config=cfg),
                   checkpoint_store=CheckpointStore(config=cfg),
                   on_epoch_end=lambda state: levels.pop(0), device="cuda")
    h = job.train()
    return dict(train=list(h.train_loss), val=list(h.validation_loss),
                acc=list(h.accuracy), par=list(h.parallelism))


def kr_leader(root):
    """22b on rank 0: the control plane over HTTP, the banded set and the
    ResNet-18 function uploaded, the job trained through /train, /infer
    asked at every epoch's end (inside the stubbed scheduler's answer) and
    after the finish, beside the job's own in-memory ``infer``."""
    from kubeml_tpu_torch.api.errors import KubeMLError
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.controller import KubemlClient

    cfg = cp_config(root)
    probe = banded_images(16, 4)[0]
    out = {}
    with LocalCluster(config=cfg) as cluster:
        client = KubemlClient(cluster.controller_url, timeout=600)
        client.datasets().create("bands", *banded_images(KR_TRAIN, 2),
                                 *banded_images(KR_TEST, 3))
        client.functions().create("bands", BANDS_FN % 64)
        levels, asked, probes = list(KR_LEVELS), [], []

        def answer(job_id, state):
            asked.append(state.parallelism)
            try:
                probes.append(("served", np.asarray(
                    client.networks().infer(KR_JOB, probe)).tolist()))
            except KubeMLError as e:
                probes.append((e.status_code, e.message))
            return levels.pop(0)

        cluster.ps._epoch_end = answer
        t0 = time.monotonic()
        reset_kernel_counts()
        client.networks().train(kr_request(KR_ASK))
        jr_wait_started(cluster, KR_JOB)
        with cluster.ps._lock:
            job = cluster.ps._jobs[KR_JOB].job
        h = cp_wait_job(cluster, KR_JOB)
        out.update(wall=time.monotonic() - t0, launches=kernel_counts())
        out.update(train=list(h.train_loss), val=list(h.validation_loss),
                   acc=list(h.accuracy), par=list(h.parallelism),
                   notes=list(h.notes), error=h.task.get("error"),
                   epoch_s=list(h.epoch_duration), asked=asked, probes=probes,
                   tags=cluster.ps._ckpt_store.tags(KR_JOB))
        out["served"] = np.asarray(client.networks().infer(KR_JOB, probe))
        out["own"] = np.asarray(job.infer(probe))
    return out


def kr_rank(rank, out_dir, root):
    """One rank of phase 22 (started by ``parallel.distributed.spawn``):
    the process group over gloo, the kernels the parent built, then 22a,
    22a's f32 round and 22c on both ranks, and 22b with the control plane
    on rank 0 and the follower loop on rank 1, as ``kubeml start`` runs
    them."""
    from kubeml_tpu_torch.benchmarks.harness import FlagshipBench
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.parallel.distributed import (get_dist_context,
                                                       init_distributed)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda")
    from kubeml_tpu_torch.ops import kernels

    kernels.library()
    dist = get_dist_context()
    res = {}
    t0 = time.monotonic()
    reset_kernel_counts()
    bench = FlagshipBench(KR_N, KAVG_B, KAVG_K, dist=dist)
    row = bench.measure(KR_ROUNDS, reps=1)
    res["a"] = dict(row=row, profile=kr_profile(bench),
                    samples_per_round=bench.samples_per_round,
                    launches=kernel_counts(), seconds=time.monotonic() - t0)
    del bench
    torch.cuda.empty_cache()
    res["a_f32"] = kr_f32_round(dist)
    t0 = time.monotonic()
    res["c"] = kr_vit(dist)
    res["c"]["seconds"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    if rank == 0:
        res["b"] = kr_leader(root)
    else:
        reset_kernel_counts()
        res["b"] = dict(followed=run_follower(config=cp_config(root)),
                        launches=kernel_counts())
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def kr_leaf_errors(got, want):
    """Each leaf's largest |got - want| against its largest |want|: the
    worst (ratio, leaf)."""
    return max((float(np.abs(got[k].astype(np.float64) - want[k]).max())
                / max(float(np.abs(want[k]).max()), 1e-30), k) for k in want)


def kavg_ranks_phase(smi, root, row4):
    """Phase 22 (see the module docstring). ``row4`` is phase 10a's
    one-rank N 4 row. Returns the flash launches (fwd, dq, dkv) of 22c,
    summed over the ranks."""
    from kubeml_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    ref_f32 = kr_f32_round()
    ref_vit = kr_vit()
    ref_job = kr_reference_job(Path(root) / "kavg-ranks-ref")
    torch.cuda.empty_cache()
    log(f"  22 one-rank references [{smi}] ({time.monotonic() - t0:.1f} s): "
        f"f32 N {KR_N} round loss {ref_f32['loss']:.6f}; ViT-Tiny N "
        f"{KR_VIT_N} losses {[round(v, 5) for v in ref_vit['losses']]}, "
        f"flash launches {ref_vit['launches']} over {ref_vit['rounds']} "
        f"rounds; TrainJob parallelism {ref_job['par']}, train loss "
        f"{ref_job['train']}, validation accuracy {ref_job['acc']} %")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kr_") as tmp:
        spawn(kr_rank, KR_WORLD, args=(tmp, str(Path(root) / "kavg-ranks")),
              timeout_s=KR_TIMEOUT_S)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(KR_WORLD)]
    log(f"  22 {KR_WORLD} ranks over gloo on {smi}: "
        f"{time.monotonic() - t0:.1f} s, spawn included (22a "
        f"{ranks[0]['a']['seconds']:.1f} s, 22c "
        f"{ranks[0]['c']['seconds']:.1f} s, 22b "
        f"{ranks[0]['b']['wall']:.1f} s)")
    bad = []
    # 22a: the flagship
    rows = [r["a"]["row"] for r in ranks]
    # the merge's buffer: every leaf of one replica in f32, and N losses
    mbytes = 4 * (sum(v.size for v in ranks[0]["a_f32"]["merged"].values())
                  + KR_N)
    dev = sum(r["value"] for r in rows)
    e2e = sum(r["end_to_end"] for r in rows)
    for i, r in enumerate(ranks):
        a, p = r["a"], r["a"]["profile"]
        per = p["wall_ms"] / p["rounds"]
        merge = p["spans"].get("kubeml::kavg_merge", 0.0) / p["rounds"]
        stats = p["spans"].get("kubeml::kavg_stats", 0.0) / p["rounds"]
        idle = (f"{1 - p['busy_ms'] / p['wall_ms']:.3f}" if p["busy_ms"] > 0
                else "not measured (no device time recorded)")
        log(f"  22a rank {i} [{smi}]: round {a['row']['round_ms']:.3f} ms "
            f"({KR_N // KR_WORLD} x {KAVG_K} steps of B {KAVG_B}; "
            f"{KR_ROUNDS} rounds, resident slabs); device "
            f"{a['row']['value']:.1f} samples/s, end to end "
            f"{a['row']['end_to_end']:.1f} (staged through RoundPrefetcher); "
            f"profiled window {per:.3f} ms a round, of which the merge "
            f"all-reduce (kubeml::kavg_merge: host copies and the gloo op "
            f"over {mbytes / 1e6:.1f} MB of f32 sums) {merge:.3f} ms = "
            f"{merge / per:.3f} ({merge / a['row']['round_ms']:.3f} of the "
            f"unprofiled round) and "
            f"the statistics' (kubeml::kavg_stats) {stats:.3f} ms; device "
            f"busy {p['busy_ms'] / p['rounds']:.3f} ms a round, idle share "
            f"{idle}; loss {a['row']['first_loss']:.4f} -> "
            f"{a['row']['loss']:.4f}")
        if r["a"]["launches"] != (0,) * 5 or not np.isfinite(
                a["row"]["loss"]):
            bad.append(f"22a rank {i}: launches {r['a']['launches']}, loss "
                       f"{a['row']['loss']}")
        if p["spans"].get("kubeml::kavg_merge", 0.0) <= 0:
            bad.append(f"22a rank {i}: no merge span in the window")
    log(f"  22a over {KR_WORLD} ranks, N {KR_N} [{smi}]: device "
        f"{dev:.1f} samples/s, end to end {e2e:.1f} samples/s (summed over "
        f"the ranks); one rank's N 4 (phase 10a): round "
        f"{row4['round_ms']:.3f} ms, device {row4['value']:.1f}, end to end "
        f"{row4['end_to_end']:.1f} samples/s")
    # 22a f32
    f32 = [r["a_f32"] for r in ranks]
    err = kr_leaf_errors(f32[0]["merged"], ref_f32["merged"])
    same = all(np.array_equal(f32[0]["merged"][k], f32[1]["merged"][k])
               for k in f32[0]["merged"])
    log(f"  22a f32 N {KR_N} K 2 B 16, worker mask {list(KR_F32_MASK)} "
        f"[{smi}]: rank 0's merged weights against one rank's: worst leaf "
        f"{err[1]} at {err[0]:.2e} of its largest entry (tolerance "
        f"{KR_F32_RTOL}); ranks bit-equal: {same}; rows of each rank "
        f"bit-equal: {[x['rows_same'] for x in f32]}; loss "
        f"{f32[0]['loss']:.6f} (one rank {ref_f32['loss']:.6f})")
    if not (err[0] <= KR_F32_RTOL and same
            and all(x["rows_same"] for x in f32)
            and f32[0]["loss"] == f32[1]["loss"]):
        bad.append(f"22a f32: worst leaf {err}, ranks bit-equal {same}, "
                   f"losses {[x['loss'] for x in f32]}")
    # 22c: ViT-Tiny
    per_round = ENC_DEPTH * VIT_K
    vit = [r["c"] for r in ranks]
    loss_err = max(abs(a - b) for a, b in zip(vit[0]["losses"],
                                               ref_vit["losses"]))
    werr = kr_leaf_errors(vit[0]["weights"], ref_vit["weights"])
    vsame = all(np.array_equal(vit[0]["weights"][k], vit[1]["weights"][k])
                for k in vit[0]["weights"])
    want_rank = (per_round * (KR_VIT_N // KR_WORLD) * vit[0]["rounds"],) * 3
    want_one = (per_round * KR_VIT_N * ref_vit["rounds"],) * 3
    log(f"  22c ViT-Tiny depth {ENC_DEPTH}, B {ENC_VIT['B']}, K {VIT_K}, "
        f"N {KR_VIT_N} over {KR_WORLD} ranks [{smi}]: flash launches a rank "
        f"{[v['launches'] for v in vit]} over {vit[0]['rounds']} rounds = "
        f"{[tuple(c // v['rounds'] for c in v['launches']) for v in vit]} a "
        f"round (one rank's N {KR_VIT_N}: "
        f"{tuple(c // ref_vit['rounds'] for c in ref_vit['launches'])}); "
        f"losses {[round(v, 5) for v in vit[0]['losses']]} (one rank "
        f"{[round(v, 5) for v in ref_vit['losses']]}; largest difference "
        f"{loss_err:.2e}, tolerance {MR_LOSS_ATOL}); weights' worst leaf "
        f"{werr[1]} at {werr[0]:.2e} of its largest entry (tolerance "
        f"{KR_VIT_W_RTOL}); ranks bit-equal: {vsame}; round ms a rank "
        f"{[round(x, 1) for x in vit[0]['ms'][1:]]}, one rank "
        f"{[round(x, 1) for x in ref_vit['ms'][1:]]}")
    if any(v["launches"] != want_rank for v in vit) or \
            ref_vit["launches"] != want_one:
        bad.append(f"22c: flash launches {[v['launches'] for v in vit]} "
                   f"(want {want_rank} a rank), one rank "
                   f"{ref_vit['launches']} (want {want_one})")
    if not (loss_err <= MR_LOSS_ATOL and werr[0] <= KR_VIT_W_RTOL and vsame):
        bad.append(f"22c: losses {loss_err}, weights {werr}, ranks "
                   f"bit-equal {vsame}")
    # 22b: the job through /train
    b = ranks[0]["b"]
    held = max(abs(x - y) for x, y in zip(b["train"], ref_job["train"]))
    log(f"  22b {KR_JOB} through /train over {KR_WORLD} ranks [{smi}]: "
        f"requested parallelism {KR_ASK}, the scheduler's answers "
        f"{list(KR_LEVELS)}: parallelism {b['par']} (asked at {b['asked']}), "
        f"notes {b['notes']}; train loss {[round(v, 5) for v in b['train']]} "
        f"against the one-rank job's {[round(v, 5) for v in ref_job['train']]}"
        f" (largest difference {held:.2e}, tolerance {MR_LOSS_ATOL}); "
        f"validation accuracy {b['acc']} % (one rank {ref_job['acc']}); "
        f"epoch s {[round(v, 3) for v in b['epoch_s']]}; checkpoints "
        f"{b['tags']}; /infer at each epoch's end "
        f"{[p[0] for p in b['probes']]}; the final served by the parameter "
        f"server {'equals' if np.array_equal(b['served'], b['own']) else 'DIFFERS FROM'}"
        f" the job's own infer; the follower ran {ranks[1]['b']['followed']} "
        f"job(s); hand-written kernel launches {b['launches']}, "
        f"{ranks[1]['b']['launches']}")
    if b["error"] or b["par"] != KR_TRACE or held > MR_LOSS_ATOL or len(
            b["train"]) != len(ref_job["train"]):
        bad.append(f"22b: error {b['error']}, parallelism {b['par']}, losses "
                   f"{b['train']} against {ref_job['train']}")
    if ref_job["par"] != KR_TRACE:
        bad.append(f"22b: the one-rank job's parallelism {ref_job['par']}")
    notes = [f"requested parallelism {KR_ASK} rounded to 2 (must be a "
             f"multiple of the {KR_WORLD} host processes)",
             f"epoch 2: scheduler parallelism 3 rounded to 2 (multiple of "
             f"{KR_WORLD} host processes)"]
    if b["notes"] != notes:
        bad.append(f"22b: notes {b['notes']}, want {notes}")
    probes = [p[0] for p in b["probes"]]
    if probes[:2] != [409, "served"]:
        bad.append(f"22b: /infer during training {b['probes']}")
    if not np.array_equal(b["served"], b["own"]):
        bad.append("22b: the served final differs from the job's infer")
    if b["tags"] != ["ep00000", "ep00001", "ep00002", "final"]:
        bad.append(f"22b: checkpoints {b['tags']}")
    if ranks[1]["b"]["followed"] != 1 or any(b["launches"]) or any(
            ranks[1]["b"]["launches"]):
        bad.append(f"22b: follower {ranks[1]['b']}")
    if bad:
        raise AssertionError("phase 22: " + "; ".join(bad))
    return tuple(sum(v["launches"][i] for v in vit) for i in range(3))


# --- phase 23: standalone runners and preemption ---------------------------

# 23a/23c: phase 22b's ResNet-18 function on the banded set (KR_TRAIN +
# KR_TEST), 3 epochs at parallelism 2, in a runner process on the card;
# the job holds its epoch SA_HOLD + 1's first step while the gate file
# exists: the live /infer checks read epoch SA_HOLD's publish through every
# route, and 23c's burst finds the job training (the gate opens once it is
# preempted). The yield lands in epoch SA_HOLD + 1, so the resumed runner
# trains the epochs after it
SA_JOB, SA_EPOCHS, SA_HOLD = "kavg-standalone", 3, 1
# the runner's epochs 1..SA_HOLD against the threaded job's, relative (the
# same function, data, seed and card: tests/test_torch_standalone.py's 1e-6)
SA_SAME_RTOL = 1e-6
SA_PROBE = 64  # images a live /infer
SA_FN = BANDS_FN + """

import os
import time


class HeldBands(Bands):
    def per_sample_loss(self, logits, y):
        # hold the epoch's first step while the gate file exists
        gate = os.environ.get("KUBEML_SMOKE_GATE", "")
        while gate and self.epoch >= %d and os.path.exists(gate):
            time.sleep(0.01)
        return super().per_sample_loss(logits, y)


def main():
    return HeldBands()
"""
# 23c: the burst thresholds of the JAX package's colocation test
# (tests/test_preemption.py:731-738)
SA_PREEMPT = dict(preempt_monitor=True, preempt_interval=0.2,
                  preempt_queue_depth=3, preempt_overload_rate=1.0,
                  preempt_sustain=2, preempt_resume_sustain=5,
                  preempt_cooldown=10.0, serving_slots=2,
                  serving_queue_limit=6)
# 23b: the flagship's SPMD job at depth JR_DEPTH inside a JobRunner of this
# process; its losses against the same job run threaded, within MR_SAME_TOL
RUNNER_LC_JOB, RUNNER_LC_PREEMPT = "lc-runner", "lc-runner-preempt"


def sa_request(job, fn="bands"):
    """23a/23c's request: phase 22b's (B 64, K 4, lr 0.05, bf16), 3 epochs
    at a static parallelism of 2."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(
        model_type="resnet18", batch_size=64, epochs=SA_EPOCHS,
        dataset="bands", lr=0.05, function_name=fn, job_id=job,
        options=TrainOptions(default_parallelism=2, k=4, precision="bf16",
                             goal_accuracy=101.0, static_parallelism=True))


def loss_parity(base_losses, losses) -> tuple:
    """The JAX package's rule (benchmarks/scenarios.py:758-770): the final
    loss within the baseline's late wobble, floored at 0.05. Returns
    (holds, delta, tolerance)."""
    tol = (max(0.05, 3 * float(np.mean(np.abs(np.diff(base_losses[-5:])))))
           if len(base_losses) >= 5 else 0.05)
    delta = abs(float(losses[-1]) - float(base_losses[-1]))
    return delta <= tol, delta, tol


def flat_bits(tree, prefix=""):
    """{path: (dtype, shape, bytes)} of a host tree (numpy leaves, bf16 as
    torch tensors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_bits(v, f"{prefix}{k}/"))
        else:
            a = (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            out[prefix + k] = (str(v.dtype), tuple(a.shape), a.tobytes())
    return out


def sa_codecs(trees):
    """Each KMW1 codec over the threaded job's epoch weights: every
    payload's bytes and encode ms, the decoded chain bit-equal to the
    weights (raw, delta) or each leaf within the int8 step's half plus f32
    rounding (delta-int8)."""
    from kubeml_tpu_torch.engine.dataplane import (CODECS, DeltaDecoder,
                                                   DeltaEncoder)

    rows = {}
    for codec in CODECS:
        enc, dec, prev = DeltaEncoder(codec), DeltaDecoder(), None
        sizes, ms, worst = [], [], 0.0
        for e, tree in enumerate(trees, start=1):
            t0 = time.perf_counter()
            payload = enc.encode(tree, e)
            ms.append(1e3 * (time.perf_counter() - t0))
            sizes.append(len(payload))
            got, _ = dec.decode(payload)
            want, have = _flat(tree), _flat(got)
            if codec != "delta-int8":
                if flat_bits(got) != flat_bits(tree):
                    raise AssertionError(f"23a {codec}: epoch {e} decodes "
                                         f"to other weights")
                continue
            for k, w in want.items():
                err = float(np.abs(have[k].astype(np.float64) - w).max())
                step = (float(np.abs(w - prev[k]).max()) if prev is not None
                        else 0.0)
                bound = step / 254.0 * (1 + 1e-3) + 1e-6 * float(
                    np.abs(w).max())
                if not err <= bound:
                    raise AssertionError(f"23a delta-int8: epoch {e} leaf "
                                         f"{k} error {err:.3e} > {bound:.3e}")
                worst = max(worst, err)
            prev = have
        rows[codec] = dict(bytes=sizes, ms=ms, worst=worst)
    return rows


def sa_root(root):
    """Phase 23's data root: the banded set, the ResNet-18 functions (plain
    and held), GPT-2-small's function and phase 12's finals (linked)."""
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import ShardStore

    cfg = cp_config(Path(root) / "standalone")
    cfg.ensure_dirs()
    src = Path(root) / "checkpoints" / GPT2_JOB
    if not src.is_dir():
        raise AssertionError(f"23: phase 12's finals are gone ({src})")
    (cfg.checkpoints_dir / GPT2_JOB).symlink_to(src)
    reg = FunctionRegistry(config=cfg)
    reg.create("bands", BANDS_FN % 64)
    reg.create("bands-held", SA_FN % (64, SA_HOLD))
    reg.create("gpt2", GPT2_FN % (VOCAB, MAX_LEN, SEED))
    ShardStore(config=cfg).create("bands", *banded_images(KR_TRAIN, 2),
                                  *banded_images(KR_TEST, 3))
    return cfg.data_root


def sa_threaded(data_root):
    """23a's reference: the same request run threaded in this process, each
    epoch's reference weights kept. Returns (history, weights by epoch)."""
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    cfg = cp_config(data_root)
    trees = []
    req = sa_request("sa-threaded")
    model = FunctionRegistry(config=cfg).load("bands")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                      k=req.options.k, task="train")
    job = TrainJob(req.job_id, req, model, store=ShardStore(config=cfg),
                   history_store=HistoryStore(config=cfg),
                   checkpoint_store=CheckpointStore(config=cfg),
                   on_epoch_weights=lambda v, e: trees.append(v),
                   device="cuda")
    return job.train(), trees


def runner_state(url):
    from kubeml_tpu_torch.utils import http_client as http

    return http.check(http.get(f"{url}/state", timeout=(5.0, 30.0)))


def sa_wait(cond, what, limit=600.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"23: no {what} within {limit} s")


def sa_record(cluster, jid):
    """The job's PS record once its runner took the task."""
    def rec():
        with cluster.ps._lock:
            r = cluster.ps._jobs.get(jid)
        return r if r is not None and r.url is not None and \
            r.task.status == "running" else None

    return sa_wait(rec, f"runner for {jid}")


def sa_done(cluster, jid, epochs):
    """The history of ``jid`` once it holds ``epochs`` epochs and no record,
    queue entry or park holds the job."""
    def done():
        with cluster.ps._lock:
            if jid in cluster.ps._jobs:
                return None
        if jid in cluster.scheduler.queue.job_ids() or (
                cluster.preemption is not None
                and jid in cluster.preemption.parked_ids()):
            return None
        try:
            h = cluster.history_store.get(jid)
        except Exception:
            return None
        return h if len(h.train_loss) >= epochs else None

    return sa_wait(done, f"end of {jid}")


def standalone_kavg(smi, cluster):
    """23a: the held job through /train in a runner on the card and, while
    it is held, its live /infer through the PS's socket and wire routes and
    the runner's own JSON ``/infer``. Returns the report's numbers; the job
    stays held."""
    from kubeml_tpu_torch.controller import KubemlClient
    from kubeml_tpu_torch.native.bindings import TensorClient
    from kubeml_tpu_torch.native.weights import read_version
    from kubeml_tpu_torch.utils import http_client as http

    ps, cfg = cluster.ps, cluster.cfg
    client = KubemlClient(cluster.controller_url, timeout=600)
    t0 = time.monotonic()
    client.networks().train(sa_request(SA_JOB, fn="bands-held"))
    rec = sa_record(cluster, SA_JOB)
    sa_wait(lambda: runner_state(rec.url)["epochs"] >= 1, "first epoch")
    first_epoch_s = time.monotonic() - t0
    sock = cfg.job_socket_path(SA_JOB)

    def held():
        if runner_state(rec.url)["epochs"] < SA_HOLD or not sock.exists():
            return False
        with TensorClient(str(sock)) as c:
            return read_version(c) == SA_HOLD

    sa_wait(held, "the held epoch's publish")
    probe = banded_images(SA_PROBE, 4)[0]
    routes0 = dict(ps.infer_routes)
    out = dict(listening_s=rec.listening_s, first_epoch_s=first_epoch_s)
    t1 = time.perf_counter()
    ps._socket_weights(SA_JOB, rec)
    out["socket_ms"] = 1e3 * (time.perf_counter() - t1)
    got_socket = ps.infer(SA_JOB, probe)
    tree_socket = ps._socket_cache[SA_JOB][1]
    cfg.tensor_sockets = False
    try:
        t1 = time.perf_counter()
        ps._wire_weights(SA_JOB, rec)
        out["wire_ms"] = 1e3 * (time.perf_counter() - t1)
        got_wire = ps.infer(SA_JOB, probe)
        tree_wire = ps._wire_cache[SA_JOB][1]
    finally:
        cfg.tensor_sockets = True
    # the runner's own JSON /infer, the PS's last route
    got_json = http.check(http.post(f"{rec.url}/infer", json={
        "data": probe.tolist()}, timeout=(5.0, 120.0)))["predictions"]
    routes = {k: ps.infer_routes[k] - routes0[k] for k in routes0}
    if routes != {"socket": 1, "wire": 1, "json": 0}:
        raise AssertionError(f"23a: /infer routes {routes}")
    if flat_bits(tree_wire) != flat_bits(tree_socket):
        raise AssertionError(f"23a: the wire's weights ({cfg.dataplane_codec}"
                             f") differ from the socket's")
    if not got_socket == got_wire == got_json:
        raise AssertionError("23a: the routes' predictions differ")
    out.update(routes=routes, predictions=len(got_json))
    return out


def runner_spmd(smi, root):
    """23b: phase 16b's job at depth JR_DEPTH, threaded, then inside a
    ``JobRunner`` of this process through ``/start`` with a ``/generate``
    between its steps, then a second job preempted through ``/preempt``.
    The generate's own launches are those of the same request on the
    threaded job's model. Returns the flash launches (fwd, dq, dkv) of the
    runner's jobs."""
    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.engine.job_runner import JobRunner
    from kubeml_tpu_torch.engine.spmd_job import SPMDJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)
    from kubeml_tpu_torch.utils import http_client as http

    cfg = cp_config(Path(root) / "runner-spmd")
    cfg.ensure_dirs()
    x, y = jr_tokens()
    ShardStore(config=cfg).create("lc-tokens", x[:LC_TRAIN], y[:LC_TRAIN],
                                  x[LC_TRAIN:], y[LC_TRAIN:])
    FunctionRegistry(config=cfg).create("lcranks", JR_FN)
    req = jr_request(RUNNER_LC_JOB, LC_EPOCHS, save_model=False)
    model = FunctionRegistry(config=cfg).load("lcranks")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0, k=1,
                      task="train")
    reset_flash_counts()
    threaded = SPMDJob(req.job_id, req, model, store=ShardStore(config=cfg),
                       history_store=HistoryStore(config=cfg),
                       checkpoint_store=CheckpointStore(config=cfg),
                       device="cuda")
    want = threaded.train()
    threaded_counts = flash_counts()
    body = {"prompts": [[int(t) for t in x[0, :16]]], "max_new_tokens": 8}
    reset_flash_counts()
    threaded.generate(GenerateRequest.parse_request(body))
    gen = flash_counts()
    runner = JobRunner(RUNNER_LC_JOB, config=cfg, device="cuda").start()
    reset_flash_counts()
    t0 = time.monotonic()
    http.check(http.post(f"{runner.url}/start", json={
        "job_id": RUNNER_LC_JOB, "parameters": req.to_dict()},
        timeout=(5.0, 120.0)))
    sa_wait(lambda: runner.job is not None
            and not runner.job.heartbeat_cold, "23b first step", 300)
    reply = http.check(http.post(f"{runner.url}/generate", json=body,
                                 timeout=(5.0, 120.0)))
    # the job's dK/dV launches so far: a step's JR_DEPTH each; fewer than
    # the job's total once it ends means steps ran after the generate
    at_reply = flash_counts()[2] - gen[2]
    sa_wait(runner.done.is_set, "23b job", 600)
    wall = time.monotonic() - t0
    counts = tuple(a - b for a, b in zip(flash_counts(), gen))
    got = runner.job.history
    state = runner_state(runner.url)
    runner.stop()
    # a second job, preempted through the runner's route once its first
    # epoch is in (the resume checkpoint is the epoch's)
    preq = jr_request(RUNNER_LC_PREEMPT, LC_EPOCHS + 1, save_model=False)
    prunner = JobRunner(RUNNER_LC_PREEMPT, config=cfg, device="cuda").start()
    before = flash_counts()
    http.check(http.post(f"{prunner.url}/start", json={
        "job_id": RUNNER_LC_PREEMPT, "parameters": preq.to_dict()},
        timeout=(5.0, 120.0)))
    sa_wait(lambda: prunner.job is not None
            and len(prunner.job.history.train_loss) >= 1,
            "23b preempted job's first epoch", 300)
    ans = http.check(http.post(f"{prunner.url}/preempt",
                               timeout=(5.0, 60.0)))
    sa_wait(prunner.done.is_set, "23b yield", 300)
    pstate = runner_state(prunner.url)
    pcounts = tuple(a - b for a, b in zip(flash_counts(), before))
    prunner.stop()
    tags = CheckpointStore(config=cfg).tags(RUNNER_LC_PREEMPT)
    steps = LC_EPOCHS * (LC_TRAIN // LC_B)
    evals = LC_EPOCHS * (LC_TEST // LC_B)
    per_step = ((counts[0] - JR_DEPTH * evals) / steps, counts[1] / steps,
                counts[2] / steps)
    diff = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(
        got.train_loss + got.validation_loss,
        want.train_loss + want.validation_loss))
    log(f"  23b {RUNNER_LC_JOB} in a JobRunner of this process [{smi}]: "
        f"/start to the end {wall:.1f} s, status {state['status']}, train "
        f"loss {got.train_loss}, eval loss {got.validation_loss} (the "
        f"threaded job's {want.train_loss}, {want.validation_loss}; largest "
        f"relative difference {diff:.2e}); flash launches {counts}, a step "
        f"{per_step} with {evals} validation forwards of {JR_DEPTH} fwd "
        f"(threaded {threaded_counts}); /generate between steps (dK/dV "
        f"launches at its answer {at_reply} of {counts[2]}): "
        f"{reply['lengths']} tokens, its flash launches {gen} (the same "
        f"request on the threaded job's model)")
    log(f"  23b {RUNNER_LC_PREEMPT}: /preempt answered {ans}, status "
        f"{pstate['status']} after {pstate['epochs']} epochs, checkpoints "
        f"{tags}, flash launches {pcounts}")
    if state["status"] != "finished" or not diff <= MR_SAME_TOL:
        raise AssertionError(f"23b: status {state['status']}, losses "
                             f"{diff:.2e} apart")
    if per_step != (2 * JR_DEPTH, JR_DEPTH, JR_DEPTH) or \
            counts != threaded_counts:
        raise AssertionError(f"23b: flash launches {counts}, a step "
                             f"{per_step}, threaded {threaded_counts}")
    if not JR_DEPTH <= at_reply < counts[2] or reply["lengths"] != [8]:
        raise AssertionError(f"23b: /generate not between steps (dK/dV "
                             f"launches at its answer {at_reply} of "
                             f"{counts[2]}), {reply['lengths']}")
    if ans != {"status": "preempting"} or pstate["status"] != "preempted" \
            or not tags:
        raise AssertionError(f"23b: preempt {ans}, {pstate}, {tags}")
    return tuple(a + b + c for a, b, c in zip(counts, gen, pcounts))


def sa_burst(ps, reqs, eos):
    """23c's burst: the 16 requests of phase 3's mix at once from threads,
    streamed through ``ps.generate``, each retried after a 429 until
    admitted. Returns the tokens, (admitted at, TTFT) of each and the
    429s."""
    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.api.errors import KubeMLError

    tokens, timing, errors, refused = [None] * 16, [None] * 16, [], [0]

    def client(i):
        r = reqs[i]
        req = GenerateRequest(prompts=[r["prompt"].tolist()],
                              max_new_tokens=r["max_new"],
                              eos_id=eos if i == 5 else None, stream=True)
        try:
            while True:
                t0 = time.monotonic()
                try:
                    parts = ps.generate(GPT2_JOB, req)
                    break
                except KubeMLError as e:
                    if e.status_code != 429:
                        raise
                    refused[0] += 1
                    time.sleep(0.05)
            toks, first = [], None
            for part in parts:
                if "tokens" in part:
                    first = first if first is not None else time.monotonic()
                    toks += part["tokens"]
            tokens[i], timing[i] = toks, (t0, first - t0)
        except Exception as e:  # surfaced below, after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"23c: burst clients failed or hung: {errors}")
    return tokens, timing, refused[0]


def colocation(smi, cluster, dec, gate, qrun, qprun):
    """23c: a serving burst through ``dec`` (the int8 engine) preempts 23a's
    held job: the gate opens once the PS counts the preemption, the job
    yields at its round's edge, parks, is requeued with resume=True once
    serving is calm and finishes in a new runner. The preempt, the park
    and the requeue are stamped by polling the PS's preemption counter and
    the controller's parked ids every 5 ms. Returns the report's
    numbers."""
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    ps, ctl = cluster.ps, cluster.preemption
    reqs = workload(np.random.default_rng(SEED))
    stamps = {}
    burst_done, job_done = threading.Event(), threading.Event()

    def watch():
        while not job_done.is_set():
            now = time.monotonic()
            if "preempt" not in stamps and (
                    ps.metrics.preemptions_snapshot() or burst_done.is_set()):
                if not burst_done.is_set():
                    stamps["preempt"] = now
                # the held job yields once it can reach its round's edge
                gate.unlink(missing_ok=True)
            parked = SA_JOB in ctl.parked_ids()
            if parked and "park" not in stamps:
                stamps["park"] = now
                # the history the preempted runner left
                try:
                    stamps["epochs_parked"] = len(
                        cluster.history_store.get(SA_JOB).train_loss)
                except Exception as e:  # reported by the gate
                    stamps["epochs_parked"] = repr(e)
            elif not parked and "park" in stamps:
                stamps.setdefault("requeue", now)
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    try:
        paged_attention.launches = int8_matmul.launches = 0
        watcher.start()
        t_burst = time.monotonic()
        tokens, timing, refused = sa_burst(ps, reqs, qrun["eos"])
        burst_s = time.monotonic() - t_burst
        burst_done.set()
        launches = (paged_attention.launches, int8_matmul.launches)
        h = sa_done(cluster, SA_JOB, SA_EPOCHS)
    finally:
        burst_done.set()
        job_done.set()
        watcher.join()
    ties = check_greedy("23c", tokens, token_lists(qprun)[1:],
                        [r["prompt"] for r in reqs], dec,
                        against="phase 12b's final-int8 serving",
                        tie=INT8_NEAR_TIE)
    park_t = stamps.get("park", float("inf"))
    before = sorted(t for t0, t in timing if t0 < park_t)
    after = sorted(t for t0, t in timing if t0 >= park_t)
    return dict(history=h, launches=launches, tokens=sum(map(len, tokens)),
                ties=ties, burst_s=burst_s, refused=refused, stamps=stamps,
                t_burst=t_burst, before=before, after=after,
                preemptions=ps.metrics.preemptions_snapshot())


def standalone_phase(smi, root, qrun, qprun):
    """Phase 23 (see the module docstring). Returns the flash launches of
    23b and the (paged_attention, int8_matmul) launches of 23c."""
    import os

    from kubeml_tpu_torch.api import GenerateRequest
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.native import fallback_counts, native_available
    from kubeml_tpu_torch.native.bindings import reset_fallback_counts

    if not native_available():
        raise AssertionError("23: the native library did not build")
    reset_fallback_counts()
    t0 = time.monotonic()
    data_root = sa_root(root)
    threaded, trees = sa_threaded(data_root)
    if any(fallback_counts().values()):
        raise AssertionError(f"23a: native fallbacks {fallback_counts()}")
    codecs = sa_codecs(trees)
    log(f"  23a threaded reference [{smi}]: train loss "
        f"{[round(v, 4) for v in threaded.train_loss]}, epoch s "
        f"{[round(v, 3) for v in threaded.epoch_duration]} "
        f"({time.monotonic() - t0:.1f} s); packed by kml_pack (fallbacks "
        f"{fallback_counts()})")
    for codec, r in codecs.items():
        log(f"  23a KMW1 {codec} over its epoch weights: payload bytes "
            f"{r['bytes']} (the first a full snapshot), encode ms "
            f"{[round(v, 1) for v in r['ms']]}"
            + (f", worst leaf error {r['worst']:.3e}"
               if codec == "delta-int8" else ", decoded bit-equal"))
    gate = Path(data_root) / "hold.gate"
    gate.touch()
    os.environ["KUBEML_SMOKE_GATE"] = str(gate)
    cfg = cp_config(data_root, standalone_jobs=True, serving_quantize="int8",
                    kv_quant="int8", int8_matmul=True,
                    serving_chunk_steps=CHUNK,
                    serving_page_tokens=PAGE_TOKENS, **SA_PREEMPT)
    try:
        with LocalCluster(config=cfg) as cluster:
            ps = cluster.ps
            dec, load_ms, build_ms = cold_serving(ps, GPT2_JOB)
            if (not dec.int8_matmul or dec.int8_matmul_impl != "cuda"
                    or dec.kv_quant != "int8" or dec.paged_attn != "cuda"):
                raise AssertionError("23c: the served engine does not run "
                                     "both kernels")
            ps.generate(GPT2_JOB, GenerateRequest(prompts=[[1, 2, 3]],
                                                  max_new_tokens=2))
            t0 = time.monotonic()
            a = standalone_kavg(smi, cluster)
            log(f"  23a {SA_JOB} in a runner [{smi}]: spawn to LISTENING "
                f"{a['listening_s']:.2f} s, /train to the first epoch "
                f"{a['first_epoch_s']:.2f} s; held at epoch {SA_HOLD + 1}'s "
                f"first step: live /infer of {a['predictions']} images "
                f"equal through the socket ({a['socket_ms']:.1f} ms cold "
                f"fetch), the {cfg.dataplane_codec} wire "
                f"({a['wire_ms']:.1f} ms, tree bit-equal to the socket's) "
                f"and the runner's JSON ({time.monotonic() - t0:.1f} s)")
            t0 = time.monotonic()
            c = colocation(smi, cluster, dec, gate, qrun, qprun)
            log_text = (cfg.logs_dir / f"job-{SA_JOB}.log").read_text()
            metrics = http_text(f"{cluster.ps_api.url}/metrics")
    finally:
        os.environ.pop("KUBEML_SMOKE_GATE", None)
    h = c["history"]
    holds, delta, tol = loss_parity(threaded.train_loss, h.train_loss)
    diffs = [max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(
        getattr(h, k)[:SA_HOLD], getattr(threaded, k)[:SA_HOLD]))
        for k in ("train_loss", "validation_loss")]
    st = c["stamps"]
    snap = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^kubeml_preempt_yield_seconds_(sum|count) (\S+)$", metrics, re.M)}
    # the requeued runner's part of the log: its restore, then its epochs
    resumed = log_text.partition(": resumed from checkpoint ")[2]
    resumed_epochs = re.findall(r": epoch (\d+)/%d " % SA_EPOCHS, resumed)
    parked = st.get("epochs_parked")

    def p50(v):
        return f"{1e3 * v[len(v) // 2]:.1f} ms ({len(v)})" if v else "n/a"

    dp = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^kubeml_dataplane_bytes_total\{phase="([^"]+)"\} (\S+)$', metrics,
        re.M)}
    log(f"  23c colocation [{smi}]: decoder cold load {load_ms:.1f} ms + "
        f"build {build_ms:.1f} ms; the burst (16 requests, 2 slots, queue "
        f"limit 6) {c['burst_s']:.2f} s, {c['refused']} answers 429 "
        f"retried, {c['tokens']} tokens equal to phase 12b's (near ties "
        f"within {INT8_NEAR_TIE} {c['ties'] or 'none'}); preemptions "
        f"{c['preemptions']}; overload to the preempt request "
        f"{st.get('preempt', float('nan')) - c['t_burst']:.3f} s; "
        f"kubeml_preempt_yield_seconds sum {snap.get('sum', 0.0):.3f} over "
        f"{snap.get('count', 0.0):.0f}; parked "
        f"{st.get('requeue', float('nan')) - st.get('park', float('nan')):.3f}"
        f" s; TTFT p50 before the reclaim {p50(c['before'])}, after "
        f"{p50(c['after'])}; launches paged_attention {c['launches'][0]}, "
        f"int8_matmul {c['launches'][1]} ({time.monotonic() - t0:.1f} s)")
    log(f"  23a/c {SA_JOB}: parallelism {h.parallelism}, train loss "
        f"{[round(v, 4) for v in h.train_loss]}, epoch s "
        f"{[round(v, 3) for v in h.epoch_duration]} (the preempted "
        f"runner's {parked} epochs, its last cut short by the yield, then "
        f"the requeued runner's epochs {resumed_epochs} after its restore "
        f"from {resumed.split(' ', 1)[0] or 'nothing'}) beside the threaded "
        f"job's {[round(v, 4) for v in threaded.train_loss]}, "
        f"{[round(v, 3) for v in threaded.epoch_duration]}: epochs 1-"
        f"{SA_HOLD} train/eval loss relative differences {diffs[0]:.2e}/"
        f"{diffs[1]:.2e} (tolerance {SA_SAME_RTOL}), final delta "
        f"{delta:.4f}, loss_parity (tolerance {tol:.4f}) {holds}; /metrics "
        f"data-plane bytes {dp}")
    if c["preemptions"] != {"serving-overload": 1} or \
            snap.get("count") != 1.0:
        raise AssertionError(f"23c: preemptions {c['preemptions']}, yields "
                             f"{snap}")
    if not holds or len(h.train_loss) != SA_EPOCHS or h.task.get("error") \
            or h.parallelism != threaded.parallelism:
        raise AssertionError(f"23c: the resumed job {h.train_loss}, "
                             f"{h.parallelism}, {h.task.get('error')}, "
                             f"parity {delta} > {tol}")
    # the yield lands in epoch SA_HOLD + 1; the requeued runner trains the
    # epochs after it, and appends them to the history it restored
    want_resumed = [str(e) for e in range(SA_HOLD + 2, SA_EPOCHS + 1)]
    if parked != SA_HOLD + 1 or resumed_epochs != want_resumed:
        raise AssertionError(f"23c: {parked} epochs at the park (want "
                             f"{SA_HOLD + 1}); the requeued runner trained "
                             f"epochs {resumed_epochs} (want {want_resumed})")
    if not max(diffs) <= SA_SAME_RTOL:
        raise AssertionError(f"23a: epochs 1-{SA_HOLD} differ from the "
                             f"threaded job's by {diffs} (relative)")
    if "requeue" not in st or min(c["launches"]) <= 0:
        raise AssertionError(f"23c: requeue {st}, launches {c['launches']}")
    if "fallback" in log_text:
        raise AssertionError("23a: the runners' log holds a native fallback")
    for phase in ("weights.publish", f"weights.encode.{cfg.dataplane_codec}",
                  "weights.fetch", "stage_round"):
        if not dp.get(phase, 0.0) > 0:
            raise AssertionError(f"23a: /metrics shows no {phase} bytes: "
                                 f"{dp}")
    t0 = time.monotonic()
    flash_b = runner_spmd(smi, root)
    log(f"  23b {time.monotonic() - t0:.1f} s")
    return flash_b, c["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 1
    # the data root of phases 10c and 12 (datasets, functions, checkpoints)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return phases(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phases(root: str) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from kubeml_tpu_torch.ops import kernels
    from kubeml_tpu_torch.ops.int8_matmul import int8_matmul
    from kubeml_tpu_torch.ops.paged_attention import (map_stats,
                                                      paged_attention)
    from kubeml_tpu_torch.serving import PagedBatchingDecoder

    # 1. device
    smi = nvidia_smi()
    log("[1/24 device]")
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
    log(f"[2/24 build] {time.monotonic() - t0:.2f} s (nvcc "
        f"{kernels.build_seconds:.2f} s), kernels with a stack frame or "
        f"spills: {len(spills)}")
    for ln in spills:
        log(f"  {ln}")
    build_log = kernels.build_log
    if not build_log:  # the library came from an earlier run's build
        with tempfile.TemporaryDirectory() as tmp:
            build_log = "".join(subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-c",
                 str(kernels.CSRC / src), "-o", f"{tmp}/{src}.o"],
                capture_output=True, text=True, check=True).stdout
                for src in kernels.SOURCES)
    check_compiled(kernels.library()._name, build_log)

    # 3. kernels against their plain versions
    log("[3/24 kernels]")
    timer = Timer()
    g = torch.Generator().manual_seed(SEED)
    pa_rows = check_paged_attention(timer, g)
    mm_rows = check_int8_matmul(timer, g)
    # 21a's rows: measured here, where the profiler still records kernels
    # (in this process it records none after phases 17-20 spawn ranks)
    sm_rows = check_int8_matmul(timer, torch.Generator().manual_seed(SM_SEED),
                                SM_MM_SHAPES, (torch.float32,), tag="21a ",
                                profiled=True)
    del timer

    # 4. serve f32: kernel engine, then the plain (gather) twin
    log("[4/24 serve f32]")
    serve_tiny()
    reqs = workload(np.random.default_rng(SEED))
    model = gpt2_small()
    common = dict(slots=SLOTS, page_tokens=PAGE_TOKENS, chunk_steps=CHUNK,
                  device="cuda")
    dec = PagedBatchingDecoder(model, **common)
    if dec.telemetry()["paged_attn_kernel"] != 1.0:
        raise AssertionError("the f32 engine does not read through the kernel")
    maps0 = map_stats()
    paged_attention.launches = int8_matmul.launches = 0
    run = serve(dec, reqs)
    f32_launches = paged_attention.launches
    report_serve("kernel engine", run)
    maps1 = map_stats()
    paged_window(dec, reqs, "f32", also="paged")
    map_report("f32", maps0, maps1, map_stats())
    dec.close()
    steps = run["tele"]["admission_waves"] + run["tele"]["device_steps"]
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
    log("[5/24 serve int8]")
    q_kw = dict(quantize="int8", int8_matmul=True, kv_quant="int8", **common)
    qdec = PagedBatchingDecoder(gpt2_small(), **q_kw)
    if (not qdec.int8_matmul or qdec.int8_matmul_impl != "cuda"
            or qdec.telemetry()["paged_attn_kernel"] != 1.0):
        raise AssertionError("the int8 engine does not run both kernels")
    maps0 = map_stats()
    paged_attention.launches = int8_matmul.launches = 0
    qrun = serve(qdec, reqs)
    q_launches = (paged_attention.launches, int8_matmul.launches)
    report_serve("kernel engine", qrun)
    maps1 = map_stats()
    qbusy, qkernels, (_, mm_calls), _ = paged_window(qdec, reqs, "int8",
                                                     also="int8")
    map_report("int8", maps0, maps1, map_stats())
    int8_profile(qbusy, qkernels, mm_calls)
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

    # 6. speculative decoding and chunked prefill through both kernels
    log("[6/24 spec + chunked]")
    t0 = time.monotonic()
    spec_launches = spec_phase(smi)
    log(f"  phase 6: {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 7. flash kernels against their plain versions, and the L sweep
    log("[7/24 flash kernels]")
    timer = Timer()
    flash_errs, sweep = check_flash(timer, g)
    del timer

    # 8. train: the kernel path, its profile, then the plain path
    log("[8/24 train bf16]")
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

    # 9. f32: one step through the kernels against the plain path
    log("[9/24 train f32 parity]")
    check_f32_step()

    # 10. K-AVG: the flagship at bench.py's configuration, the merge's
    # correctness, and TrainJob end to end; none of the five hand-written
    # kernels is on this path (convs, BatchNorm and dense layers run in
    # cuDNN and cuBLAS, as the JAX path runs them in XLA)
    log("[10/24 k-avg]")
    reset_kernel_counts()
    log("  10a flagship: ResNet-18, CIFAR-10 shapes, bf16, uint8 inputs, "
        f"B {KAVG_B}, K {KAVG_K}, lr 0.1, SGD momentum 0.9")
    row1, plain_sps = kavg_flagship(1, smi)
    row4, _ = kavg_flagship(4, smi, plain_sps, reps=1,
                            rounds=KAVG_ROUNDS // 2)
    log("  10b correctness")
    kavg_correctness()
    log("  10c TrainJob")
    kavg = kavg_job(Path(root) / "kavg")
    counts = kernel_counts()
    log(f"  hand-written kernel launches in phase 10 (paged_attention, "
        f"int8_matmul, flash fwd/dq/dkv): {counts}")
    if any(counts):
        raise AssertionError(f"the K-AVG path launched {counts}")

    # 11. serving resilience through both serving kernels
    log("[11/24 resilience]")
    t0 = time.monotonic()
    res_launches = resilience_phase(smi)
    log(f"  phase 11: {time.monotonic() - t0:.1f} s")

    # 12. checkpoints served through the parameter server
    log("[12/24 checkpoint serving]")
    t0 = time.monotonic()
    ckpt = checkpoint_phase(smi, root, run, qrun, kavg)
    ckpt_launches = ckpt["launches"]
    log(f"  phase 12: {time.monotonic() - t0:.1f} s")

    # 13. the control plane over HTTP: training, serving, SIGTERM
    log("[13/24 control plane]")
    t0 = time.monotonic()
    cp_launches = control_plane_phase(smi, root, run, qrun, ckpt, kavg)
    log(f"  phase 13: {time.monotonic() - t0:.1f} s")

    # 14. the encoders: the flash kernels at their shapes, BERT-base and
    # ViT-Tiny trained by K-AVG, VGG-11, a ViT TrainJob with transforms
    log("[14/24 encoders]")
    t0 = time.monotonic()
    enc_rows, enc_launches, bert_row, vit_row = encoder_phase(smi, root)
    log(f"  phase 14: {time.monotonic() - t0:.1f} s")

    # 15. MoE trained at bench_moe's width through the flash kernels and
    # served by the dense slot engine; GPT-2-small through the dense engine
    log("[15/24 moe + dense engine]")
    t0 = time.monotonic()
    moe_row, moe_errs, moe_times, moe_counts, dense_launches = moe_phase(
        smi, root, run)
    log(f"  phase 15: {time.monotonic() - t0:.1f} s")

    # 16. the one-shot speculative generate through paged attention, and
    # the long-context flagship's SPMD job with sharded checkpoints
    log("[16/24 one-shot spec + spmd job]")
    t0 = time.monotonic()
    spec16, flash16, served16 = spec_spmd_phase(smi, root, krow["step_ms"])
    log(f"  phase 16: {time.monotonic() - t0:.1f} s")

    # 17. multi-rank SPMD: two gloo ranks on the card, attention and the
    # flagship's training over sp (Ulysses, ring), tp and dp
    log("[17/24 multi-rank spmd]")
    t0 = time.monotonic()
    flash17 = multirank_phase(smi)
    log(f"  phase 17: {time.monotonic() - t0:.1f} s")

    # 18. the SPMD job over ranks: two gloo ranks on the card, the
    # flagship trained through /train over tp=2, resumed over sp=2,
    # remeshed dp 2 -> 1 -> 2, its 2-shard final served
    log("[18/24 spmd job over ranks]")
    t0 = time.monotonic()
    flash18, served18 = ranks_phase(smi, root)
    log(f"  phase 18: {time.monotonic() - t0:.1f} s")

    # 19. the pipeline over ranks: two gloo ranks on the card, the fully
    # masked flash check, PipelinedLM over pp=2, the flagship as
    # PipelinedCausalLM trained through /train over pp=2, resumed, its
    # stage-sharded final served flat
    log("[19/24 pipeline over ranks]")
    t0 = time.monotonic()
    flash19, served19 = pipeline_phase(smi, root)
    log(f"  phase 19: {time.monotonic() - t0:.1f} s")

    # 20. MoE over ranks: two gloo ranks on the card, bench_moe at full
    # depth over ep=2 and at MOE_DEPTH over dp, tp and sp; a MoE job
    # through /train over ep=2, resumed under dp=2, its final served
    log("[20/24 moe over ranks]")
    t0 = time.monotonic()
    flash20, moe_ep_times = moe_ep_phase(smi, root)
    log(f"  phase 20: {time.monotonic() - t0:.1f} s")

    # 21. meshed serving: two gloo ranks on the card, the int8 matmul at
    # the tp=2 shard shapes, GPT-2-small served over tp=2 in f32 and int8,
    # phases 18's and 20's sharded finals served on serving meshes
    log("[21/24 meshed serving]")
    t0 = time.monotonic()
    served21 = serving_mesh_phase(smi, root, sm_rows)
    log(f"  phase 21: {time.monotonic() - t0:.1f} s")

    # 22. K-AVG over ranks: two gloo ranks on the card, the flagship's
    # rounds and the merge over the ranks, a K-AVG job through /train,
    # ViT-Tiny through the flash kernels
    log("[22/24 k-avg over ranks]")
    t0 = time.monotonic()
    flash22 = kavg_ranks_phase(smi, root, row4)
    log(f"  phase 22: {time.monotonic() - t0:.1f} s")

    # 23. standalone runners and preemption: a K-AVG job in a runner
    # process, the SPMD job inside a JobRunner, a serving burst preempting
    # a runner's job, which resumes
    log("[23/24 standalone runners + preemption]")
    t0 = time.monotonic()
    flash23, served23 = standalone_phase(smi, root, qrun, ckpt["qprun"])
    log(f"  phase 23: {time.monotonic() - t0:.1f} s")

    # 24. results
    log("[24/24 results]")
    pa = pa_rows[0]   # the decode step: L = 1, f32 arena
    mm = next(r for r in mm_rows if r["M"] == 8 and r["N"] == VOCAB
              and r["x"] == "float32")  # the lm_head at decode
    line = {"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "kubeml_tpu_torch/csrc/paged_attention.cu",
         "replaces": "kubeml_tpu/ops/paged_attention.py:113",
         "launches": (f32_launches + q_launches[0] + spec_launches[0]
                      + res_launches[0] + ckpt_launches[0]
                      + cp_launches[0] + spec16[0] + served16[0]
                      + served18[0] + served19[0] + served23[0]),
         "max_abs_err": pa["max_abs_err"], "ms": pa["ms"],
         "plain_ms": pa["plain_ms"], "bound_ms": pa["bound_ms"],
         "bound_by": pa["bound_by"], "library_ms": pa["library_ms"]},
        {"name": "int8_matmul", "route": "cuda",
         "source": "kubeml_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "kubeml_tpu/ops/int8_matmul.py:55",
         "launches": (q_launches[1] + spec_launches[1] + res_launches[1]
                      + ckpt_launches[1] + cp_launches[1]
                      + dense_launches[1] + spec16[1] + served16[1]
                      + served18[1] + served19[1] + served21
                      + served23[1]),
         "max_abs_err": mm["max_abs_err"], "ms": mm["ms"],
         "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
         "bound_by": mm["bound_by"], "library_ms": mm["library_ms"]},
    ]}
    # the flash kernels at the training shape (B 8, L 2048, bf16, causal)
    tr = sweep[2048]
    err_a = flash_errs[("a train", torch.bfloat16)]
    # launches: the training path of phase 8, the encoders' of phase 14,
    # the MoE LM's of phase 15, the SPMD job's of phase 16, the ranks' of
    # phases 17, 18, 19, 20 and 22 and the runner's SPMD jobs of phase 23
    fwd_n, dq_n, dkv_n = (sum(c) for c in zip(
        kcounts, enc_launches, moe_counts, flash16, flash17, flash18,
        flash19, flash20, flash22, flash23))
    for name, line_no, count, err, ms, plain, lib in (
            ("flash_fwd", 120, fwd_n, err_a["out"], tr["fwd_ms"],
             tr["fwd_plain_ms"], tr["fwd_library_ms"]),
            ("flash_dq", 227, dq_n, err_a["dq"], tr["dq_ms"],
             tr["bwd_plain_ms"], tr["bwd_library_ms"]),
            ("flash_dkv", 269, dkv_n, max(err_a["dk"], err_a["dv"]),
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
    log(f"  flash launches: phase 8 {kcounts}, phase 14 {enc_launches}, "
        f"phase 15 {moe_counts}, phase 16 {flash16}, phase 17 {flash17}, "
        f"phase 18 {flash18}, phase 19 {flash19}, phase 20 {flash20}, "
        f"phase 22 {flash22}, phase 23 {flash23}; "
        f"serving launches "
        f"(paged_attention, int8_matmul) of phase 16: one-shot spec {spec16}"
        f", the SPMD final served {served16}; of phase 18 {served18}; of "
        f"phase 19 {served19}; int8_matmul of phase 21 (both ranks) "
        f"{served21}; of phase 23's burst {served23}")
    t = moe_times
    log(f"  flash at the MoE shape B {MOE_B} L {MOE_L} H {MOE_H} causal "
        f"(bf16): fwd {t['fwd_ms']:.4f} ms (plain {t['fwd_plain_ms']:.4f}, "
        f"SDPA {t['fwd_library_ms']:.4f}, bound {t['fwd_bound_ms']:.4f} by "
        f"{t['fwd_bound_by']}), dq {t['dq_ms']:.4f} (bound "
        f"{t['dq_bound_ms']:.4f}), dkv {t['dkv_ms']:.4f} (bound "
        f"{t['dkv_bound_ms']:.4f}), plain bwd {t['bwd_plain_ms']:.4f}, SDPA "
        f"bwd {t['bwd_library_ms']:.4f}; max abs err "
        + " ".join(f"{n} {e:.2e}" for n, e in moe_errs.items()))
    t = moe_ep_times
    log(f"  flash at the MoE-over-ranks shape B {MOE_B} L {MOE_L} H "
        f"{MOE_EP_HEADS} causal (bf16): fwd {t['fwd_ms']:.4f} ms (plain "
        f"{t['fwd_plain_ms']:.4f}, SDPA {t['fwd_library_ms']:.4f}, bound "
        f"{t['fwd_bound_ms']:.4f} by {t['fwd_bound_by']}), dq "
        f"{t['dq_ms']:.4f} (bound {t['dq_bound_ms']:.4f}), dkv "
        f"{t['dkv_ms']:.4f} (bound {t['dkv_bound_ms']:.4f}), plain bwd "
        f"{t['bwd_plain_ms']:.4f}, SDPA bwd {t['bwd_library_ms']:.4f}")
    log(f"  gpt-moe: {moe_row['value']:.1f} tokens/s, step "
        f"{moe_row['step_ms']:.3f} ms, {moe_row['mfu']:.4f} of the bf16 "
        f"peak; int8_matmul launches of phase 15 {dense_launches[1]}")
    for tag, (err, t) in enc_rows.items():
        log(f"  flash at {tag} (bf16): fwd {t['fwd_ms']:.4f} ms (plain "
            f"{t['fwd_plain_ms']:.4f}, SDPA {t['fwd_library_ms']:.4f}, "
            f"bound {t['fwd_bound_ms']:.4f} by {t['fwd_bound_by']}), dq "
            f"{t['dq_ms']:.4f} (bound {t['dq_bound_ms']:.4f} by "
            f"{t['dq_bound_by']}), dkv {t['dkv_ms']:.4f} (bound "
            f"{t['dkv_bound_ms']:.4f} by {t['dkv_bound_by']}), plain bwd "
            f"{t['bwd_plain_ms']:.4f}, SDPA bwd {t['bwd_library_ms']:.4f}")
    for tag, r in (("bert-base", bert_row), ("vit-tiny", vit_row)):
        log(f"  {tag} round ms: kernels {r['round_ms']:.3f} / "
            f"{r['kernel_round_ms_again']:.3f}, plain {r['plain_round_ms']:.3f};"
            f" {r['value']:.1f} samples/s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
