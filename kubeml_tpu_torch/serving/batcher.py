"""The paged continuous-batching serving engine, port of
``kubeml_tpu/serving/batcher.py::PagedBatchingDecoder``.

One engine thread owns the device state: per-layer K/V page arenas
(``models.generation.PagedCache``) shared by up to ``slots`` decode rows,
each addressing its own pages through a page table leased from a
:class:`~.kvpool.KVPool`. Requests become rows; rows are admitted FIFO
while a slot is free and the page budget covers their worst case (the head
of the line blocks the tail until pages free), reuse full prompt blocks a
previous request already wrote through the prefix trie, and prefill only
their unshared suffix, batched per suffix-length bucket in one forward.
Live rows then advance together in decode chunks whose length walks down
a power-of-two ladder to end exactly at the earliest completion, so a
finished row's slot and pages free at the next chunk edge.

Speculative decoding (``spec="self"|"draft"``): each step a drafter
proposes k tokens per live row - the model's own first
``spec_exit_layer`` blocks writing the shared arena, or a separate small
``draft_module`` with its own arena over the same page ids - and one
(k+1)-wide verify forward through the paged path scores them all;
``models.generation.spec_accept`` keeps the leading run the target agrees
with plus one correction token. Rollback is positional: a rejected
draft's K/V lies past the row's cursor and the next step overwrites it.
Pages cover the k-position lookahead from admission on
(``KVPool.admit(lookahead=)``), and :class:`~.spec.AdaptiveK` walks k with
the measured acceptance.

Chunked prefill (``prefill_chunk_tokens``): a row whose unshared suffix is
longer than the chunk cap (a power of two of at least one page, so chunk
edges are page edges) takes its slot and pages at admission, then
prefills one chunk per engine-loop turn between decode chunks (Sarathi's
interleaving); its last chunk is a normal admission that samples the
first token.

Sampling is per row with runtime knobs (temperature, top-k, eos): greedy
rows take the argmax; sampled rows draw from their own
``torch.Generator``, created when the row samples its first token and
seeded from the request's ``seed`` and the row index, so a request's
stream does not depend on what it was batched with, nor on chunking.

Differences from the JAX engine, by design of eager PyTorch: there are no
compiled shape buckets, so rows are not padded to ``slots`` and each chunk
or spec step runs only the resident rows; one chunk is in flight at a time
(the engine reads a chunk's tokens back with one copy at its end), so no
fetch pool or pre-freeing is needed. Left for later (ROADMAP): the dense
``BatchingDecoder``, KMS1 snapshots, drain and fault replay, the pool
audit, the PS route with ``serving/stats.py``, and meshes.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.errors import EngineFaultError, KubeMLError, OverloadedError
from ..models.generation import (GenerationInputError, PAD_ID,
                                 draft_sample, init_paged_cache, spec_accept,
                                 spec_mask_emissions, supports_paged_decode)
from ..models.layers import QuantizableDense, load_tree
from ..ops.int8_matmul import resolve_int8_matmul
from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from ..utils.device import resolve_device
from .kvpool import KVPool
from .quant import dequantize_tree, quantize_tree
from .spec import AdaptiveK

log = logging.getLogger("kubeml.serving")

# width of the top-k threshold scratch; requests cap top_k at this bound
# (api.types.GENERATE_MAX_TOP_K mirrors it on the wire)
TOP_K_MAX = 128

DEFAULT_SLOTS = 8

# floor of the suffix-length buckets admissions are grouped by: one
# prefill forward per bucket keeps a short prompt from computing a long
# one's padding
_BUCKET_MIN = 16


class DecoderClosed(KubeMLError):
    def __init__(self):
        super().__init__("decoder is shut down", 503)


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _kv_page_bytes(module, page_tokens: int, kv_quant: str) -> int:
    """Device bytes ONE physical page occupies across every layer's K and V
    arenas - the unit of the arena byte budget (int8 pages add their
    per-head f32 scales)."""
    depth, heads, embed = module.depth, module.num_heads, module.embed_dim
    if kv_quant == "int8":
        return depth * 2 * (page_tokens * embed + heads * 4)
    itemsize = torch.empty((), dtype=module.dtype).element_size()
    return depth * 2 * page_tokens * embed * itemsize


def _is_quantized(module) -> bool:
    return any(isinstance(m, QuantizableDense) and m.quantized
               for m in module.modules())


def _seed_for(seed: int, index: int) -> int:
    """A distinct generator seed per (request seed, row index)."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63)


def _chunk_cap(tokens: int, page_tokens: int) -> int:
    """The prefill-chunk cap of ``prefill_chunk_tokens``: the largest power
    of two at most ``tokens``, floored at one page. A power of two of at
    least ``page_tokens`` (itself one) is a whole number of pages, so
    every chunk edge is a page edge - which keeps each int8 page's scale
    derived from one forward's tokens, as in monolithic prefill. 0 (no
    chunking) for a knob of 0 or anything below one page."""
    if tokens < page_tokens:
        return 0
    cap = page_tokens
    while cap * 2 <= tokens:
        cap *= 2
    return cap


@dataclass
class _Row:
    """One decode row (a request of batch B becomes B rows)."""

    entry: "_Entry"
    index: int
    prompt: np.ndarray  # [plen] int32, dense
    max_new: int
    temp: float
    topk: int   # 0 = off
    eos: int    # -1 = off
    seed: int = 0
    gen: Optional[torch.Generator] = None  # sampled rows, from admission
    out: List[int] = field(default_factory=list)
    done: bool = False
    canceled: bool = False
    lease: Optional[object] = None  # kvpool.PageLease while pages are held
    prefix_cached: int = 0          # prompt tokens served from the trie
    slot: int = -1
    prefilling: bool = False        # mid chunked prefill: no decode work
    prefill_chunks: int = 0         # prefill forwards past a monolithic one
    spec_proposed: int = 0          # candidates verified (drafts + bonus)
    spec_accepted: int = 0          # drafts the acceptance rule kept


@dataclass
class _Entry:
    """One submitted request: rows + completion/stream plumbing."""

    rows: List[_Row]
    max_new: int
    stream_q: Optional[queue.Queue] = None
    done_evt: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None
    submitted_at: float = 0.0    # monotonic
    first_token_at: float = 0.0  # 0 until the first token lands
    aborted: bool = False        # timeout/cancel already counted
    request_id: str = ""

    def finished(self) -> bool:
        return all(r.done for r in self.rows)

    def result(self) -> dict:
        tokens = [r.out + [PAD_ID] * (self.max_new - len(r.out))
                  for r in self.rows]
        return {"tokens": tokens, "lengths": [len(r.out) for r in self.rows],
                "request_id": self.request_id,
                # prompt tokens whose K/V came from the shared-prefix cache
                "prefix_cached_tokens": sum(r.prefix_cached
                                            for r in self.rows),
                # speculative decoding (0 with spec off): candidates
                # verified for the rows, and drafts the rule kept
                "spec_proposed_tokens": sum(r.spec_proposed
                                            for r in self.rows),
                "spec_accepted_tokens": sum(r.spec_accepted
                                            for r in self.rows),
                # prefill forwards of the rows' prompts (0: monolithic)
                "prefill_chunks": sum(r.prefill_chunks for r in self.rows)}


class PagedBatchingDecoder:
    """Paged continuous batching over one causal-LM module.

    ``submit`` is thread-safe and returns immediately; ``wait`` blocks for
    the full result; ``stream`` yields per-chunk token deltas. One
    background thread owns the device loop.

    ``quantize="int8"`` quantizes the module's weights IN PLACE (per
    output channel, serving.quant): with ``int8_matmul`` every quantized
    projection runs on the int8 values through ``int8_matmul_impl``
    (``auto``: the CUDA kernel on CUDA); without it the weights are
    replaced by their dequantized values. ``paged_attn`` picks the arena
    read (``auto``: the CUDA kernel on CUDA, ``gather``: the plain
    version), ``kv_quant="int8"`` stores pages int8, re-deriving the page
    count from the unquantized arena's byte budget.

    ``spec`` (``""``/``"off"``, ``"self"``, ``"draft"``) turns on
    speculative decoding with at most ``spec_k`` drafts a step:
    ``"self"`` drafts with the first ``spec_exit_layer`` blocks (0:
    depth // 2), ``"draft"`` with ``draft_module`` (same vocabulary,
    ``max_len`` at least the target's, on the same device; quantized like
    the target). ``spec_adaptive`` lets k follow the acceptance;
    ``spec_min_accept`` is the draft backend's acceptance floor (0: off).
    ``prefill_chunk_tokens`` > 0 prefills long suffixes in chunks of
    ``_chunk_cap`` tokens interleaved with decode (0: monolithic).
    """

    def __init__(self, module, *, slots: int = DEFAULT_SLOTS,
                 chunk_steps: int = 16, page_tokens: int = 16,
                 pages: int = 0, prefix_cache: bool = True,
                 paged_attn: str = "auto", kv_quant: str = "off",
                 quantize: str = "", int8_matmul: bool = False,
                 int8_matmul_impl: str = "auto", queue_limit: int = 256,
                 spec: str = "", spec_k: int = 4, spec_adaptive: bool = True,
                 draft_module=None, spec_exit_layer: int = 0,
                 spec_min_accept: float = 0.10,
                 prefill_chunk_tokens: int = 0,
                 name: str = "decoder", device=None):
        self.device = resolve_device(device)
        if not supports_paged_decode(module):
            raise GenerationInputError(
                "module has no paged decode path (positions/pages/seq_lens/"
                "cache forward kwargs)")
        if getattr(module, "max_len", None) is None:
            raise GenerationInputError(
                "model exposes no max_len attribute; batched decode requires "
                "a declared KV-cache capacity")
        if module.device != self.device:
            raise ValueError(f"module lives on {module.device}, the decoder "
                             f"on {self.device}; move it first")
        if quantize not in ("", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(valid: '', 'int8')")
        pre_quantized = _is_quantized(module)
        if pre_quantized and quantize != "int8":
            raise ValueError("module carries int8 kernels but quantize is "
                             "not 'int8'")
        self.module = module.eval()
        self.max_len = int(module.max_len)
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.queue_limit = int(queue_limit)
        self.name = name
        self._init_spec(spec, spec_k, spec_adaptive, draft_module,
                        spec_exit_layer, spec_min_accept, quantize)
        # a module that already holds int8 kernels runs them natively
        self.quantize = quantize
        self.int8_matmul = quantize == "int8" and (bool(int8_matmul)
                                                   or pre_quantized)
        self.int8_matmul_impl = resolve_int8_matmul(int8_matmul_impl,
                                                    self.device)
        self._load_int8(module)
        if self.draft_module is not None:
            # the drafter rides the target's int8 path
            self._load_int8(self.draft_module)

        pt = int(page_tokens)
        self.page_tokens = pt
        self.table_pages = -(-self.max_len // pt)
        npages = int(pages)
        if npages <= 0:
            # every slot at full depth, plus the reserved trash page
            npages = self.slots * self.table_pages + 1
        self.kv_quant = resolve_kv_quant(kv_quant)
        if self.kv_quant == "int8":
            budget = (npages - 1) * _kv_page_bytes(module, pt, "off")
            npages = max(npages,
                         budget // _kv_page_bytes(module, pt, "int8") + 1)
        self._pool = KVPool(npages, pt, prefix_cache=bool(prefix_cache))
        self.paged_attn = resolve_paged_attn(paged_attn, self.device)
        self.cache = init_paged_cache(module, npages, pt, self.kv_quant,
                                      self.paged_attn)
        # the drafter's own arena: the same page ids (so shared-prefix pages
        # hold valid draft K/V too), its own depth and heads, the same read
        # path and storage
        self.draft_cache = (init_paged_cache(self.draft_module, npages, pt,
                                             self.kv_quant, self.paged_attn)
                            if self.draft_module is not None else None)
        # chunk ladder: every power of two below chunk_steps, and
        # chunk_steps itself, so a chunk can end at any completion
        ladder = {self.chunk_steps}
        t = 1
        while t < self.chunk_steps:
            ladder.add(t)
            t *= 2
        self._chunk_sizes = sorted(ladder)
        self.prefill_chunk = _chunk_cap(int(prefill_chunk_tokens), pt)
        # rows mid chunked prefill, in admission order
        self._prefill_pending: List[_Row] = []

        self._pending: deque = deque()
        self._slot_rows: List[Optional[_Row]] = [None] * self.slots
        self._free = list(range(self.slots))
        self._cond = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._req_prefix = f"{name}-{uuid.uuid4().hex[:6]}"
        self._req_seq = itertools.count(1)
        self._stats: Dict[str, float] = dict.fromkeys(
            ("requests_submitted", "requests_completed", "requests_failed",
             "requests_canceled", "requests_overloaded", "requests_rejected",
             "tokens_emitted", "prefill_waves", "prefill_tokens",
             "prefill_seconds", "decode_chunks", "decode_steps",
             "decode_row_steps", "decode_seconds", "prefix_hits",
             "prefix_tokens_saved", "prefill_chunks", "prefill_chunk_tokens",
             "hol_stall_seconds", "spec_steps", "spec_drafted_tokens",
             "spec_proposed_tokens", "spec_accepted_tokens"), 0.0)

    def _init_spec(self, spec, spec_k, spec_adaptive, draft_module,
                   spec_exit_layer, spec_min_accept, quantize) -> None:
        """Validate the speculative-decoding configuration (the JAX
        engine's rules; nothing is quantized or allocated before it
        passes) and build the adaptive-k controller."""
        if spec in ("off", None):
            spec = ""
        if spec not in ("", "draft", "self"):
            raise ValueError(f"unknown spec mode {spec!r} "
                             f"(valid: 'off', 'draft', 'self')")
        self.spec = spec
        self.spec_exit_layer = 0
        self.draft_module = None
        if spec == "draft":
            if draft_module is None:
                raise GenerationInputError("spec='draft' needs a draft module")
            if not supports_paged_decode(draft_module):
                raise GenerationInputError(
                    "draft module has no paged decode path")
            if (getattr(draft_module, "vocab_size", None)
                    != getattr(self.module, "vocab_size", None)):
                raise GenerationInputError(
                    "draft and target models must share one vocabulary")
            if int(getattr(draft_module, "max_len", 0)) < self.max_len:
                raise GenerationInputError(
                    f"draft model max_len "
                    f"({getattr(draft_module, 'max_len', None)}) must cover "
                    f"the target's ({self.max_len})")
            if draft_module.device != self.device:
                raise ValueError(f"draft module lives on "
                                 f"{draft_module.device}, the decoder on "
                                 f"{self.device}; move it first")
            if _is_quantized(draft_module) and quantize != "int8":
                raise ValueError("draft module carries int8 kernels but "
                                 "quantize is not 'int8'")
            self.draft_module = draft_module.eval()
        elif spec == "self":
            depth = self.module.depth
            e = int(spec_exit_layer or max(1, depth // 2))
            if not 1 <= e <= depth:
                raise GenerationInputError(
                    f"spec_exit_layer must be in [1, depth={depth}], got {e}")
            self.spec_exit_layer = e
        # the draft backend never suspends (its arena is coherent only
        # while the drafter sees every token) and retreats through the
        # min_accept floor instead; self-drafting suspends and re-probes
        self._spec_ctl = (AdaptiveK(
            int(spec_k), adaptive=bool(spec_adaptive),
            allow_off=spec == "self",
            min_accept=float(spec_min_accept) if spec == "draft" else 0.0)
            if spec else None)
        self._spec_disabled_logged = False
        # a verify writes up to k positions past a row's final token before
        # the host learns they were rejected: admission reserves them
        self._spec_lookahead = int(spec_k) if spec else 0

    def _load_int8(self, module) -> None:
        """Install the int8 weights of ``quantize="int8"`` into ``module``
        in place: int8 kernels for the int8 matmul, else their dequantized
        values; a module that already holds int8 kernels keeps them."""
        if self.quantize != "int8":
            return
        if _is_quantized(module):
            for m in module.modules():
                if isinstance(m, QuantizableDense):
                    m.int8_impl = self.int8_matmul_impl
            return
        tree = quantize_tree(module.state_dict())
        if self.int8_matmul:
            load_tree(module, tree, int8_impl=self.int8_matmul_impl)
        else:
            # the dequantize path: dense weights holding q * s
            load_tree(module, dequantize_tree(tree, torch.float32))

    # --- public API ---

    def submit(self, req) -> _Entry:
        """Validate and enqueue a GenerateRequest; returns its entry."""
        try:
            return self._submit(req)
        except KubeMLError as e:
            if e.status_code == 400:
                self._count("requests_rejected")
            raise

    def _submit(self, req) -> _Entry:
        prompts = np.asarray(req.prompts)
        if prompts.ndim != 2 or not np.issubdtype(prompts.dtype, np.integer):
            raise KubeMLError(
                "prompts must be a [batch, prompt_len] integer token array", 400)
        B, width = prompts.shape
        lens = ([int(v) for v in req.prompt_lengths]
                if req.prompt_lengths is not None else [width] * B)
        if req.top_k is not None and req.top_k > TOP_K_MAX:
            raise KubeMLError(
                f"top_k exceeds the serving bound ({TOP_K_MAX})", 400)
        for plen in lens:
            if plen + req.max_new_tokens - 1 > self.max_len:
                raise KubeMLError(
                    f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens})"
                    f" - 1 exceeds the model's max_len ({self.max_len})", 400)
            self._check_capacity(plen, req.max_new_tokens)
        entry = _Entry(rows=[], max_new=req.max_new_tokens,
                       stream_q=queue.Queue() if req.stream else None,
                       submitted_at=time.monotonic(),
                       request_id=f"{self._req_prefix}-r{next(self._req_seq)}")
        for i in range(B):
            entry.rows.append(_Row(
                entry=entry, index=i,
                prompt=prompts[i, :lens[i]].astype(np.int32),
                max_new=req.max_new_tokens, temp=float(req.temperature),
                topk=int(req.top_k or 0),
                eos=int(req.eos_id) if req.eos_id is not None else -1,
                seed=int(req.seed or 0)))
        with self._cond:
            if self._closed:
                raise DecoderClosed()
            # the limit gates on QUEUE pressure: a batch wider than the
            # limit still admits into an empty queue
            if (self.queue_limit > 0 and self._pending
                    and len(self._pending) + B > self.queue_limit):
                self._stats["requests_overloaded"] += 1
                raise OverloadedError(
                    f"decode queue at its admission limit "
                    f"({len(self._pending)}/{self.queue_limit} rows queued)")
            self._pending.extend(entry.rows)
            self._stats["requests_submitted"] += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name=f"decode-{self.name}",
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return entry

    def _check_capacity(self, plen: int, max_new: int) -> None:
        """400 for a row no amount of queueing could ever admit."""
        if not self._pool.can_admit(plen, max_new,
                                    lookahead=self._spec_lookahead,
                                    max_positions=self.max_len):
            need = self._pool.pages_for(self._pool.total_positions(
                plen, max_new, self._spec_lookahead, self.max_len))
            raise KubeMLError(
                f"request needs {need} KV pages but the arena holds "
                f"{self._pool.capacity}", 400)

    def wait(self, entry: _Entry, timeout: Optional[float] = None) -> dict:
        if not entry.done_evt.wait(timeout):
            self.cancel(entry)
            raise KubeMLError("generation timed out", 504)
        if entry.error is not None:
            raise entry.error
        return entry.result()

    def cancel(self, entry: _Entry) -> None:
        """Abandon a request: queued rows leave the queue now, admitted rows
        free their slot and pages at the next chunk edge."""
        if self._claim_outcome(entry):
            self._count("requests_canceled")
        with self._cond:
            for row in entry.rows:
                row.canceled = True
            self._pending = deque(r for r in self._pending if not r.canceled)
            self._cond.notify_all()

    def stream(self, entry: _Entry):
        """Yield ``{"row": i, "tokens": [...]}`` deltas, then a final
        ``{"done": true, "lengths": [...]}``; raises the entry's error.
        Needs a request submitted with ``stream=True``."""
        while True:
            item = entry.stream_q.get()
            if item is None:
                if entry.error is not None:
                    raise entry.error
                yield {"done": True,
                       "lengths": [len(r.out) for r in entry.rows],
                       "request_id": entry.request_id}
                return
            yield item

    def close(self) -> None:
        """Hard shutdown: fails everything queued or in flight and stops the
        engine thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=60)
        self._fail_all(DecoderClosed())

    @property
    def closed(self) -> bool:
        return self._closed

    def telemetry(self) -> dict:
        """Counters plus live gauges: queue depth, slot and page occupancy,
        and which read and matmul paths this engine runs (1 = the CUDA
        kernel, 0 = the plain version)."""
        with self._cond:
            snap = dict(self._stats)
            snap["queue_depth"] = float(len(self._pending))
            busy = sum(1 for r in self._slot_rows if r is not None)
        snap["slots_busy"] = float(busy)
        snap["slots_total"] = float(self.slots)
        snap.update(self._pool.telemetry())
        snap["paged_attn_kernel"] = 1.0 if self.paged_attn == "cuda" else 0.0
        snap["int8_matmul_kernel"] = (
            1.0 if self.int8_matmul and self.int8_matmul_impl == "cuda"
            else 0.0)
        snap["kv_quant"] = 1.0 if self.kv_quant == "int8" else 0.0
        # rows holding a slot and pages mid chunked prefill
        snap["prefills_in_progress"] = float(len(self._prefill_pending))
        # the speculative-decoding series exist once a spec step ran
        if not snap["spec_steps"]:
            for key in ("spec_steps", "spec_drafted_tokens",
                        "spec_proposed_tokens", "spec_accepted_tokens"):
                del snap[key]
        else:
            snap["spec_accept_rate"] = (snap["spec_accepted_tokens"]
                                        / snap["spec_drafted_tokens"])
        if self._spec_ctl is not None:
            # the adaptive k (0: speculation suspended or disabled), its
            # EWMA acceptance once sampled, and the draft floor's trip
            snap["spec_k"] = float(self._spec_ctl.current())
            if self._spec_ctl.ratio >= 0:
                snap["spec_accept_ewma"] = float(self._spec_ctl.ratio)
            snap["spec_disabled"] = 1.0 if self._spec_ctl.disabled else 0.0
        return snap

    # --- engine loop (one thread owns the device state) ---

    def _count(self, key: str, n: float = 1.0) -> None:
        with self._cond:
            self._stats[key] += n

    def _busy(self) -> bool:
        return any(r is not None for r in self._slot_rows)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._closed and not self._pending
                       and not self._busy()):
                    self._cond.wait()
                if self._closed:
                    return
                admits = self._take_admissions_locked()
            try:
                with torch.inference_mode():
                    whole = []
                    for row in admits:
                        if (self.prefill_chunk and len(row.prompt)
                                - row.lease.prefill_pos > self.prefill_chunk):
                            # a long cold suffix prefills in page-aligned
                            # chunks interleaved with decode
                            row.prefilling = True
                            self._prefill_pending.append(row)
                        else:
                            whole.append(row)
                    for group in self._group_admits(whole):
                        self._prefill(group)
                    self._evict_canceled()
                    advanced = self._advance_prefills()
                    size = self._chunk_size()
                    if size:
                        k = (self._spec_ctl.current()
                             if self._spec_ctl is not None else 0)
                        if k:
                            self._spec_step(k)
                        else:
                            self._decode_chunk(size)
                            if self._spec_ctl is not None:
                                self._spec_ctl.on_plain_chunk()
                if not admits and not advanced and not size:
                    # only the queue head is waiting (for pages): yield
                    with self._cond:
                        self._cond.wait(0.01)
            except Exception as e:
                log.exception("%s: paged decode loop failed", self.name)
                self._fail_all(e, wrap=True)
                # a fresh, zeroed arena: every cached page is invalid now
                self._pool = KVPool(self._pool.num_pages, self.page_tokens,
                                    prefix_cache=self._pool.trie is not None)
                self.cache.zero_()
                if self.draft_cache is not None:
                    self.draft_cache.zero_()

    def _take_admissions_locked(self) -> List[_Row]:
        """Admit queued rows FIFO while a slot is free AND the page budget
        covers them (worst case: prompt + max_new - 1 positions and the
        speculative lookahead, minus what the prefix trie already holds).
        The head of the line blocks the tail."""
        admits = []
        while self._pending and self._free:
            row = self._pending[0]
            if row.canceled:
                self._pending.popleft()
                continue
            lease = self._pool.admit(row.prompt, row.max_new,
                                     lookahead=self._spec_lookahead,
                                     max_positions=self.max_len)
            if lease is None:
                break
            self._pending.popleft()
            row.slot = self._free.pop(0)
            row.lease = lease
            row.prefix_cached = lease.prefix_tokens
            if lease.shared:
                self._stats["prefix_hits"] += 1
                self._stats["prefix_tokens_saved"] += lease.prefix_tokens
            self._slot_rows[row.slot] = row
            admits.append(row)
        return admits

    def _group_admits(self, admits: List[_Row]) -> List[List[_Row]]:
        """Group by the length bucket of the suffix still to prefill (past
        the shared prefix, or past a chunked row's earlier chunks): one
        prefill forward per bucket."""
        groups: Dict[int, List[_Row]] = {}
        for row in admits:
            sfx = max(len(row.prompt) - row.lease.prefill_pos, 1)
            groups.setdefault(_pow2_bucket(sfx, _BUCKET_MIN, self.max_len),
                              []).append(row)
        return list(groups.values())

    def _knobs(self, rows: List[_Row]):
        """Per-row temperature and top-k tensors, and each row's generator
        (None for greedy rows)."""
        dev = self.device
        temp = torch.tensor([r.temp for r in rows], dtype=torch.float32,
                            device=dev)
        topk = torch.tensor([r.topk for r in rows], dtype=torch.int64,
                            device=dev)
        return temp, topk, [r.gen for r in rows]

    def _stalled_rows(self) -> List[_Row]:
        """The rows a prefill forward delays: resident rows that decode and
        have tokens left to emit. Rows mid chunked prefill are not decoding
        yet (their own wait is their time to first token)."""
        return [r for r in self._slot_rows
                if r is not None and not r.done and not r.canceled
                and not r.prefilling and r.out
                and r.max_new - len(r.out) > 0]

    def _prefill_forward(self, rows, tokens, base, seq_lens, width):
        """One suffix-prefill forward of ``rows`` straight into the arena
        (and the drafter's, in draft mode): ``tokens [n, L]`` from logical
        positions ``base``, through tables ``width`` pages wide. Returns
        the target's final hidden states."""
        dev = self.device
        table = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            pgs = r.lease.pages[:width]
            table[i, :len(pgs)] = pgs
        kw = dict(decode=True, return_hidden=True,
                  positions=torch.tensor(base, dtype=torch.int32, device=dev),
                  pages=torch.from_numpy(table).to(dev),
                  seq_lens=(torch.tensor(seq_lens, dtype=torch.int64,
                                         device=dev)
                            if seq_lens is not None else None))
        ids = torch.from_numpy(tokens).to(dev)
        hidden = self.module(ids, cache=self.cache, **kw)
        if self.draft_module is not None:
            self.draft_module(ids, cache=self.draft_cache, **kw)
        return hidden

    def _charge_stall(self, stalled: List[_Row], seconds: float) -> None:
        with self._cond:
            self._stats["prefill_seconds"] += seconds
            self._stats["hol_stall_seconds"] += seconds * len(stalled)

    def _prefill(self, group: List[_Row]) -> None:
        """Prefill the group's remaining suffixes in one forward straight
        into the arena, sample each row's first token, and register the
        full prompt blocks in the prefix trie for later sharers."""
        t0 = time.monotonic()
        stalled = self._stalled_rows()
        pt = self.page_tokens
        k = len(group)
        suffixes = [r.prompt[r.lease.prefill_pos:] for r in group]
        width = max(len(s) for s in suffixes)
        tw = min(self.table_pages,
                 max(-(-len(r.prompt) // pt) for r in group))
        tokens = np.zeros((k, width), np.int64)
        for i, sfx in enumerate(suffixes):
            tokens[i, :len(sfx)] = sfx
        slens = [len(s) for s in suffixes]
        hidden = self._prefill_forward(
            group, tokens, [r.lease.prefill_pos for r in group], slens, tw)
        # logits only at each row's last real prompt token
        dev = self.device
        last = hidden[torch.arange(k, device=dev),
                      torch.tensor(slens, device=dev) - 1]
        logits = self.module.lm_head(last).float()
        for r in group:
            # the generator starts at the first sample, as the JAX key
            # does, so chunking leaves the sampled stream as it was
            if r.temp > 0 and r.gen is None:
                r.gen = torch.Generator(device=dev)
                r.gen.manual_seed(_seed_for(r.seed, r.index))
        firsts = draft_sample(logits, *self._knobs(group), TOP_K_MAX,
                              with_probs=False)[0].tolist()
        for r in group:
            self._pool.register_prefix(r.prompt, r.lease)
        self._charge_stall(stalled, time.monotonic() - t0)
        with self._cond:
            self._stats["prefill_waves"] += 1
            self._stats["prefill_tokens"] += float(sum(slens))
        for r, tok in zip(group, firsts):
            if r.canceled:
                continue
            r.out.append(int(tok))
            self._emit_delta(r, [int(tok)])
            if (r.eos >= 0 and tok == r.eos) or r.max_new <= 1:
                self._complete_row(r)

    def _advance_prefills(self) -> bool:
        """One engine-loop turn of chunked prefill: every pending row
        advances at most one chunk. Rows whose remaining suffix fits a
        chunk run a real admission (first token, generator, prefix
        registration - what a monolithic admission at that cursor does);
        the rest advance one intermediate chunk together. Returns whether
        anything ran."""
        if not self._prefill_pending:
            return False
        cap = self.prefill_chunk
        finals, chunkable = [], []
        for row in self._prefill_pending:
            if row.done or row.canceled:
                continue  # _evict_canceled released its slot and pages
            (finals if len(row.prompt) - row.lease.prefill_pos <= cap
             else chunkable).append(row)
        self._prefill_pending = chunkable
        for group in self._group_admits(finals):
            n_tok = sum(len(r.prompt) - r.lease.prefill_pos for r in group)
            # the rows stay ``prefilling`` through their own forward, so
            # they are not counted among the rows it stalls
            self._prefill(group)
            for r in group:
                r.prefilling = False
                r.prefill_chunks += 1
            with self._cond:
                self._stats["prefill_chunks"] += len(group)
                self._stats["prefill_chunk_tokens"] += n_tok
        if chunkable:
            self._prefill_chunk(chunkable)
        return bool(finals or chunkable)

    def _prefill_chunk(self, rows: List[_Row]) -> None:
        """One page-aligned intermediate chunk of ``prefill_chunk`` tokens
        for every row mid prefill, in one forward: K/V into the rows' own
        pages, nothing sampled. Each chunk is whole pages, so each arena
        page - and each int8 page's scatter-max scale - comes from one
        forward's tokens, chunked or monolithic."""
        t0 = time.monotonic()
        stalled = self._stalled_rows()
        cap = self.prefill_chunk
        pt = self.page_tokens
        tokens = np.stack([r.prompt[r.lease.prefill_pos:
                                    r.lease.prefill_pos + cap]
                           for r in rows]).astype(np.int64)
        tw = min(self.table_pages,
                 max(-(-(r.lease.prefill_pos + cap) // pt) for r in rows))
        self._prefill_forward(rows, tokens,
                              [r.lease.prefill_pos for r in rows], None, tw)
        if self.device.type == "cuda":
            # the chunk's device time is the stall it charges
            torch.cuda.synchronize(self.device)
        for r in rows:
            r.lease.prefill_pos += cap
            r.prefill_chunks += 1
        self._charge_stall(stalled, time.monotonic() - t0)
        with self._cond:
            self._stats["prefill_chunks"] += len(rows)
            self._stats["prefill_chunk_tokens"] += cap * len(rows)
            self._stats["prefill_tokens"] += cap * len(rows)

    def _decode_rows(self) -> List[_Row]:
        """The resident rows with decode work (not finished, canceled, or
        mid chunked prefill)."""
        return [r for r in self._slot_rows
                if r is not None and not r.done and not r.canceled
                and not r.prefilling]

    def _chunk_size(self) -> int:
        """The largest ladder chunk that ends at or before the earliest
        completion of a decoding row (0 = no row needs a step)."""
        rem = [r.max_new - len(r.out) for r in self._decode_rows()]
        rem = [n for n in rem if n > 0]
        if not rem:
            return 0
        soonest = min(rem)
        return max(t for t in self._chunk_sizes if t <= soonest)

    def _step_inputs(self, rows: List[_Row], ahead: int):
        """Page tables and cursors of a decode chunk or spec step that
        writes ``ahead`` positions per row: the table covers them, capped
        at each row's lease (positions past it were trash-bound anyway).
        Returns (table, tok, pos, remaining, eos)."""
        pt = self.page_tokens
        dev = self.device
        pos0 = [len(r.prompt) + len(r.out) - 1 for r in rows]
        tw = max(min(-(-(p + ahead) // pt), len(r.lease.pages))
                 for p, r in zip(pos0, rows))
        table = np.zeros((len(rows), tw), np.int32)
        for i, r in enumerate(rows):
            pgs = r.lease.pages[:tw]
            table[i, :len(pgs)] = pgs
        return (torch.from_numpy(table).to(dev),
                torch.tensor([r.out[-1] for r in rows], dtype=torch.int64,
                             device=dev),
                torch.tensor(pos0, dtype=torch.int32, device=dev),
                torch.tensor([r.max_new - len(r.out) for r in rows],
                             dtype=torch.int32, device=dev),
                torch.tensor([r.eos for r in rows], dtype=torch.int64,
                             device=dev))

    def _decode_chunk(self, size: int) -> None:
        """Advance every decoding row ``size`` tokens; rows that hit their
        eos mid-chunk freeze (feed their last token at their last position,
        rewriting identical K/V) and emit nothing more."""
        t0 = time.monotonic()
        rows = self._decode_rows()
        dev = self.device
        table, tok, pos, remaining, eos = self._step_inputs(rows, size)
        live = torch.ones(len(rows), dtype=torch.bool, device=dev)
        knobs = self._knobs(rows)
        out = torch.empty((size, len(rows)), dtype=torch.int64, device=dev)
        for t in range(size):
            logits = self.module(tok[:, None], decode=True, positions=pos,
                                 pages=table, cache=self.cache)[:, -1]
            nxt = draft_sample(logits, *knobs, TOP_K_MAX,
                               with_probs=False)[0]
            was_live = live
            remaining = remaining - was_live.int()
            live = was_live & ~((eos >= 0) & (nxt == eos)) & (remaining > 0)
            out[t] = torch.where(was_live, nxt, torch.full_like(nxt, -1))
            tok = torch.where(live, nxt, tok)
            pos = torch.where(live, pos + 1, pos)
        packed = out.T.cpu().numpy()  # the chunk's one device->host copy
        with self._cond:
            self._stats["decode_chunks"] += 1
            self._stats["decode_steps"] += size
            self._stats["decode_row_steps"] += size * len(rows)
            self._stats["decode_seconds"] += time.monotonic() - t0
        self._route(rows, packed)

    def _spec_step(self, k: int) -> None:
        """One speculative step over every decoding row: the drafter
        proposes k tokens a row (k forwards of L 1; the draft backend runs
        one more, write-only, so the last draft's K/V lands in its arena
        too), the target scores all k+1 positions in one verify forward,
        ``spec_accept`` emits the accepted run plus one correction, and
        ``spec_mask_emissions`` clips it at eos and ``max_new``. Rollback
        is positional: the next step starts at each row's emitted length
        and overwrites the rejected positions. Tokens and accepted counts
        come back in one copy."""
        t0 = time.monotonic()
        rows = self._decode_rows()
        S = len(rows)
        dev = self.device
        table, tok, pos, remaining, eos = self._step_inputs(rows, k + 1)
        temp, topk, gens = self._knobs(rows)
        sampled = any(g is not None for g in gens)
        if self.spec == "self":
            dmod, dcache = self.module, self.cache
            dkw = {"exit_layer": self.spec_exit_layer}
        else:
            dmod, dcache, dkw = self.draft_module, self.draft_cache, {}
        drafts = torch.empty((S, k), dtype=torch.int64, device=dev)
        # the drafter's q, read by the acceptance test of sampled rows
        q = (torch.empty((S, k, self.module.vocab_size), device=dev)
             if sampled else None)
        d_tok, d_pos = tok, pos
        for i in range(k):
            lg = dmod(d_tok[:, None], decode=True, positions=d_pos,
                      pages=table, cache=dcache, **dkw)[:, -1]
            d_tok, probs = draft_sample(lg, temp, topk, gens, TOP_K_MAX,
                                        with_probs=sampled)
            if q is not None:
                q[:, i] = probs
            drafts[:, i] = d_tok
            d_pos = d_pos + 1
        if self.spec == "draft":
            dmod(d_tok[:, None], decode=True, return_hidden=True,
                 positions=d_pos, pages=table, cache=dcache)
        logits = self.module(torch.cat([tok[:, None], drafts], dim=1),
                             decode=True, positions=pos, pages=table,
                             cache=self.cache)
        emit, n_acc = spec_accept(logits, drafts, q, temp, topk, gens,
                                  TOP_K_MAX)
        out, _, _, _, _ = spec_mask_emissions(
            emit, n_acc, torch.ones(S, dtype=torch.bool, device=dev),
            remaining, eos, tok)
        packed = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
        accepted = int(packed[:, -1].sum())
        with self._cond:
            self._stats["decode_chunks"] += 1
            self._stats["decode_steps"] += 1  # one device step
            self._stats["decode_row_steps"] += S
            self._stats["decode_seconds"] += time.monotonic() - t0
            self._stats["spec_steps"] += 1
            self._stats["spec_drafted_tokens"] += k * S
            self._stats["spec_proposed_tokens"] += (k + 1) * S
            self._stats["spec_accepted_tokens"] += accepted
        ctl = self._spec_ctl
        ctl.on_step(k * S, accepted)
        if ctl.disabled and not self._spec_disabled_logged:
            self._spec_disabled_logged = True
            log.warning("%s: draft speculation disabled - sustained "
                        "acceptance %.3f below spec_min_accept=%.3f; "
                        "decoding continues plain", self.name, ctl.ratio,
                        ctl.min_accept)
        for r, n in zip(rows, packed[:, -1]):
            r.spec_proposed += k + 1
            r.spec_accepted += int(n)
        self._route(rows, packed[:, :-1])

    def _route(self, rows: List[_Row], packed: np.ndarray) -> None:
        """Append each row's emitted tokens (``packed [rows, T]``, -1 past
        them), stream them, and complete the rows that finished."""
        for r, toks in zip(rows, packed):
            fresh = []
            for tok_i in toks.tolist():
                if tok_i < 0:
                    break
                fresh.append(tok_i)
                r.out.append(tok_i)
                if (r.eos >= 0 and tok_i == r.eos) or len(r.out) >= r.max_new:
                    break
            if fresh and not r.canceled:
                self._emit_delta(r, fresh)
            if ((r.eos >= 0 and r.out[-1] == r.eos)
                    or len(r.out) >= r.max_new):
                self._complete_row(r)

    def _evict_canceled(self) -> None:
        """Free the slot and pages of every canceled resident row, mid
        chunked prefill too (its lease returns exactly once; the prefill
        ledger drops it)."""
        for r in self._slot_rows:
            if r is not None and r.canceled and not r.done:
                r.done = True
                self._release_row(r)
        self._prefill_pending = [r for r in self._prefill_pending
                                 if not r.done]

    def _release_row(self, r: _Row) -> None:
        self._pool.release(r.lease)
        with self._cond:
            self._slot_rows[r.slot] = None
            self._free.append(r.slot)

    def _complete_row(self, r: _Row) -> None:
        r.done = True
        self._release_row(r)
        entry = r.entry
        if entry.finished():
            if self._claim_outcome(entry):
                self._count("requests_completed")
            entry.done_evt.set()
            if entry.stream_q is not None:
                entry.stream_q.put(None)

    def _claim_outcome(self, entry: _Entry) -> bool:
        """Each request counts exactly one outcome (completed, canceled or
        failed), whichever side claims it first."""
        with self._cond:
            if entry.aborted:
                return False
            entry.aborted = True
            return True

    def _emit_delta(self, r: _Row, tokens: List[int]) -> None:
        entry = r.entry
        if entry.first_token_at == 0.0:
            entry.first_token_at = time.monotonic()
        self._count("tokens_emitted", len(tokens))
        if entry.stream_q is not None:
            entry.stream_q.put({"row": r.index, "tokens": tokens})

    def _fail_all(self, error: Exception, wrap: bool = False) -> None:
        """Fail every queued and resident row. A loop fault (``wrap``)
        reaches waiters as a retryable 503 carrying the tokens emitted so
        far; close() passes its own error through."""
        with self._cond:
            rows = list(self._pending) + [r for r in self._slot_rows if r]
            self._pending.clear()
            self._slot_rows = [None] * self.slots
            self._free = list(range(self.slots))
            self._prefill_pending = []
        for r in rows:
            if r.lease is not None:
                self._pool.release(r.lease)
        entries = {id(r.entry): r.entry for r in rows}
        for entry in entries.values():
            for r in entry.rows:
                r.done = True
            if entry.error is None:
                entry.error = (error if not wrap
                               or isinstance(error, KubeMLError)
                               else EngineFaultError(
                                   f"decode engine fault: {error}",
                                   partial_tokens=[list(r.out)
                                                   for r in entry.rows]))
            if self._claim_outcome(entry):
                self._count("requests_failed")
            entry.done_evt.set()
            if entry.stream_q is not None:
                entry.stream_q.put(None)
