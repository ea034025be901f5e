"""The continuous-batching serving engines, port of
``kubeml_tpu/serving/batcher.py``: ``PagedBatchingDecoder`` (below) and
the dense slot engine ``BatchingDecoder`` (per-row ``[max_len]`` cache
stripes; see its docstring), which serves MoE models and
``serving_paged=False``. ``_SlotEngine`` holds what the two share: the
queue, its overload policy, the request API and the host side of a row's
life.

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
fetch pool or pre-freeing is needed.

Resilience, as in the JAX engine: counters live in one
:class:`~.stats.DecoderStats` under the JAX names; admission refuses with
429 past the queue limit (or sheds the oldest queued request,
``shed_policy="oldest"``) and while draining, with a Retry-After from the
load; a queued request past its deadline fails with 504. A fault in the
engine loop snapshots every resident row into a KMS1 frame
(``kvsnap``) before the arena is zeroed and the pool rebuilt, then replays
the rows through admission, so their streams go on unchanged; a row that
cannot be snapshotted (the draft backend's, or one whose pages cannot be
read) fails with a retryable 503 carrying its tokens. ``drain()`` stops
admission, waits out a grace period and returns the stragglers as KMS1
frames, which ``submit_snapshot`` (here or in the JAX engine) admits
again; a periodic ``KVPool.check()`` audit turns broken page accounting
into that same rebuild. A fault is injected, and holds this guarantee,
at a step's entry.

Meshed serving (JAX ``BatchingDecoder(mesh=)``) runs on the dense engine
only: ``BatchingDecoder(mesh=)`` on rank 0 of a serving mesh, the other
ranks following its ops in lockstep (:class:`DenseShard`,
:func:`serve_follower`, :class:`ServingFollower`); the paged engine
refuses a mesh, as JAX's does.
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

from ..api.config import get_config
from ..api.errors import EngineFaultError, KubeMLError, OverloadedError
from ..models.generation import (GenerationInputError, PAD_ID,
                                 draft_sample, init_cache, init_paged_cache,
                                 spec_accept, spec_mask_emissions,
                                 supports_paged_decode)
from ..models.layers import QuantizableDense, load_tree
from ..ops.int8_matmul import resolve_int8_matmul
from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from ..utils import tracing
from ..utils.device import resolve_device
from ..utils.errorhook import report_error
from ..utils.resilience import current_deadline
from . import kvsnap
from .kvpool import KVPool
from .quant import dequantize_tree, quantize_tree, quantized_bytes
from .spec import AdaptiveK
from .stats import DecoderStats

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


def _kv_token_bytes(module, kv_quant: str,
                    layers: Optional[int] = None) -> int:
    """Bytes one forward reads a cached token: ``layers`` (all) layers' K
    and V rows in storage dtype (int8 arenas one byte an element; their
    scale rows are left out, as in the JAX model)."""
    itemsize = (1 if kv_quant == "int8"
                else torch.empty((), dtype=module.dtype).element_size())
    depth = module.depth if layers is None else layers
    return depth * 2 * module.embed_dim * itemsize


def _is_quantized(module) -> bool:
    """Whether a projection (``QuantizableDense``) or a MoE weight of
    ``module`` holds int8 values."""
    return any(getattr(m, "quantized", False) for m in module.modules())


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
    gen_seed: int = 0  # the generator's seed (``_seed_for``)
    gen: Optional[torch.Generator] = None  # sampled rows, from admission
    # the generator's state after the row's last consumed step: what a
    # KMS1 frame carries, so a restore draws on exactly where it stopped
    gen_state: Optional[torch.Tensor] = None
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
    # lifecycle (monotonic; 0 = not reached): slot assignment, first and
    # last emission on the host
    slot_at: float = 0.0
    first_emit_at: float = 0.0
    last_emit_at: float = 0.0
    # host-visible gaps between the row's emissions (one a delta after the
    # first), and the wall seconds it stalled behind prefill forwards
    itl: List[float] = field(default_factory=list)
    hol_stall: float = 0.0
    # a kvsnap.RequestSnapshot whose pages scatter into fresh pages before
    # the row decodes (KMS1 admission or fault replay); ``out`` already
    # holds its emissions
    snapshot: Optional[object] = None
    # replayed after a fault rebuild: the pages are this arena's own
    # history, so its prompt blocks go back into the prefix trie
    replayed: bool = False


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
    # absolute deadline (unix seconds, ``utils.resilience``): a request
    # still queued past it fails with 504
    deadline: Optional[float] = None
    # the request's id (in its result: `kubeml trace <request-id>` finds
    # its serving spans), the wall clock at submit (the spans' anchor)
    # and the submitter's trace context (the serving spans' parent)
    request_id: str = ""
    wall0: float = 0.0
    trace_ctx: Optional[object] = None
    # a waiter that gives up once a row holds this many tokens (0 = never),
    # set by a benchmark on the entry under the decoder's lock before the
    # row is admitted: the engine cancels the request itself at that
    # point, and the tokens of the same delta past it are waste
    cancel_after: int = 0

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
                # quantiles of the rows' host-visible inter-emission gaps
                # (0.0 with none), and the seconds the rows stalled behind
                # prefill forwards
                "itl_p99": _itl_quantile(self.rows, 0.99),
                "itl_max": _itl_quantile(self.rows, 1.0),
                "hol_stall_seconds": sum(r.hol_stall for r in self.rows),
                # prefill forwards of the rows' prompts (0: monolithic)
                "prefill_chunks": sum(r.prefill_chunks for r in self.rows)}


def _itl_quantile(rows: List[_Row], q: float) -> float:
    """Nearest-rank quantile over every inter-emission gap of a request's
    rows; 0.0 with no gaps."""
    gaps = sorted(g for r in rows for g in r.itl)
    if not gaps:
        return 0.0
    return gaps[min(len(gaps) - 1, max(0, int(round(q * (len(gaps) - 1)))))]


class _DrainReq:
    """Rendezvous of ``drain()`` and the engine loop: the loop snapshots the
    stragglers and posts their KMS1 frames back before setting ``evt``."""

    def __init__(self):
        self.evt = threading.Event()
        self.frames: List[bytes] = []


class _SlotEngine:
    """What both continuous-batching engines share: the request queue and
    its overload policy (queue limit, shedding, Retry-After, deadlines),
    ``submit``/``wait``/``stream``/``cancel``, ``close``/``retire``, the
    telemetry gauges, and the host side of a decode row's life (slot
    bookkeeping, emission routing, completion, the single outcome each
    request counts). A subclass owns the device state and the loop."""

    # the first forwards on a card build the CUDA kernels (tens of
    # seconds): until one has run, waits and deadlines get this allowance
    COLD_COMPILE_ALLOWANCE = 900.0

    def _init_queue_state(self, name: str) -> None:
        """The queue, the slot table and the engine flags, all empty."""
        self.name = name
        self._pending: deque = deque()
        self._slot_rows: List[Optional[_Row]] = [None] * self.slots
        self._free = list(range(self.slots))
        # rows mid chunked prefill, in admission order (paged engine)
        self._prefill_pending: List[_Row] = []
        self._cond = threading.Condition()
        self._closed = False
        self._retired = False
        # drain: while True, submit answers 429 but live rows decode on;
        # the paged engine's drain() posts a _DrainReq once its grace
        # window closes
        self._drain_mode = False
        self._drain_deadline = 0.0
        self._drain_req: Optional[_DrainReq] = None
        self._warmed = False  # flips once a forward's tokens came back
        self._thread: Optional[threading.Thread] = None
        self._req_prefix = f"{name}-{uuid.uuid4().hex[:6]}"
        self._req_seq = itertools.count(1)

    def _check_capacity(self, plen: int, max_new: int) -> None:
        """400 for a row no amount of queueing could ever admit (the paged
        engine's page budget; the slot engine has only ``max_len``)."""

    def submit(self, req) -> _Entry:
        """Validate and enqueue a GenerateRequest; returns its entry."""
        try:
            return self._submit(req)
        except KubeMLError as e:
            if e.status_code == 400:
                self.stats.rejected()
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
                       deadline=current_deadline(),
                       request_id=self._next_request_id(),
                       wall0=time.time(),
                       trace_ctx=tracing.current_context())
        for i in range(B):
            entry.rows.append(_Row(
                entry=entry, index=i,
                prompt=prompts[i, :lens[i]].astype(np.int32),
                max_new=req.max_new_tokens, temp=float(req.temperature),
                topk=int(req.top_k or 0),
                eos=int(req.eos_id) if req.eos_id is not None else -1,
                gen_seed=_seed_for(req.seed or 0, i)))
        with self._cond:
            if self._closed or self._retired:
                raise DecoderClosed()
            if self._drain_mode:
                self.stats.overloaded()
                hint = max(1.0, self._drain_deadline - time.monotonic())
                raise OverloadedError(
                    "decoder is draining for shutdown; resubmit to another "
                    "replica or after restart", retry_after=min(hint, 30.0))
            # the limit gates on QUEUE pressure: a batch wider than the
            # limit still admits into an empty queue
            if (self.queue_limit > 0 and self._pending
                    and len(self._pending) + B > self.queue_limit):
                if self.shed_policy == "oldest":
                    self._shed_oldest_locked(
                        len(self._pending) + B - self.queue_limit)
                if (self._pending
                        and len(self._pending) + B > self.queue_limit):
                    self.stats.overloaded()
                    raise OverloadedError(
                        f"decode queue at its admission limit "
                        f"({len(self._pending)}/{self.queue_limit} rows "
                        f"queued)", retry_after=self._retry_after_hint())
            self._enqueue_locked(entry.rows)
        return entry

    def _enqueue_locked(self, rows: List[_Row]) -> None:
        self._pending.extend(rows)
        self.stats.submitted(1)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"decode-{self.name}", daemon=True)
            self._thread.start()
        self._cond.notify_all()

    def _next_request_id(self) -> str:
        return f"{self._req_prefix}-r{next(self._req_seq)}"

    def wait(self, entry: _Entry, timeout: Optional[float] = None) -> dict:
        if timeout is not None and not self._warmed:
            timeout += self.COLD_COMPILE_ALLOWANCE
        if not entry.done_evt.wait(timeout):
            # nobody reads the result: free the rows' slots and pages
            if self._claim_outcome(entry):
                self.stats.timed_out()
                self._finish_timeline(entry, "timeout")
            self.cancel(entry)
            raise KubeMLError("generation timed out", 504)
        if entry.error is not None:
            raise entry.error
        return entry.result()

    def cancel(self, entry: _Entry) -> None:
        """Abandon a request: queued rows leave the queue now, admitted rows
        free their slot and pages at the next chunk edge."""
        if self._claim_outcome(entry):
            self.stats.canceled()
            self._finish_timeline(entry, "canceled")
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

    def retire(self) -> None:
        """Graceful shutdown: new submissions are refused, requests in
        flight finish, then the engine thread exits and frees the arena."""
        with self._cond:
            self._retired = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def telemetry(self) -> dict:
        """``DecoderStats.snapshot()`` plus the live gauges of the JAX
        engines: queue depth, slot occupancy, the weight bytes, the queue
        limit and the drain flag."""
        snap = self.stats.snapshot()
        with self._cond:
            snap["queue_depth"] = float(len(self._pending))
            busy = sum(1 for r in self._slot_rows if r is not None)
        snap["slots_busy"] = float(busy)
        snap["slots_total"] = float(self.slots)
        snap["slot_occupancy"] = busy / max(self.slots, 1)
        snap["weight_bytes"] = float(self.weight_bytes)
        snap["queue_limit"] = float(self.queue_limit)
        snap["draining"] = 1.0 if self._drain_mode else 0.0
        return snap

    def _fail_entry(self, entry: _Entry, error: Exception, counter,
                    outcome: str = "failed") -> None:
        """Fail one entry's waiters: rows done, the error set, the single
        outcome claimed through ``counter`` (and its spans emitted as
        ``outcome``), waiter and stream released."""
        for row in entry.rows:
            row.done = True
        if entry.error is None:
            entry.error = error
        if self._claim_outcome(entry):
            counter()
            self._finish_timeline(entry, outcome)
        entry.done_evt.set()
        if entry.stream_q is not None:
            entry.stream_q.put(None)

    def _shed_oldest_locked(self, need: int) -> int:
        """Shed the longest-queued entries until ``need`` queued rows are
        free (caller holds ``_cond``). Only an entry whose rows are all
        still queued is shed. Returns the rows freed."""
        by_entry: Dict[int, List[_Row]] = {}
        order: List[_Entry] = []
        for r in self._pending:
            if id(r.entry) not in by_entry:
                order.append(r.entry)
            by_entry.setdefault(id(r.entry), []).append(r)
        doomed: List[_Entry] = []
        freed = 0
        for entry in order:
            if freed >= need:
                break
            queued = by_entry[id(entry)]
            if len(queued) != len(entry.rows):
                continue
            doomed.append(entry)
            freed += len(queued)
        if not doomed:
            return 0
        doomed_ids = {id(e) for e in doomed}
        self._pending = deque(r for r in self._pending
                              if id(r.entry) not in doomed_ids)
        hint = self._retry_after_hint()
        for entry in doomed:
            self._fail_entry(entry, OverloadedError(
                "request shed from the decode queue under sustained "
                "overload (oldest-first)", retry_after=hint),
                self.stats.shed, outcome="shed")
        return freed

    def _retry_after_hint(self) -> float:
        """Retry-After seconds of a 429: about how long the queue takes to
        drain (depth / slots turns at the recent p50 request latency),
        clamped to [1, 30]."""
        with self._cond:
            depth = len(self._pending)
        p50 = self.stats.snapshot().get("latency_p50_seconds", 1.0)
        turns = depth / max(self.slots, 1)
        return float(min(max(1.0, turns * max(p50, 0.1)), 30.0))

    def _sweep_expired(self) -> None:
        """Fail (504) every fully queued entry whose deadline has passed,
        instead of letting it take a slot for tokens nobody will read."""
        now = time.time()
        doomed: List[_Entry] = []
        with self._cond:
            if not self._pending:
                return
            allowance = 0.0 if self._warmed else self.COLD_COMPILE_ALLOWANCE
            by_entry: Dict[int, List[_Row]] = {}
            for r in self._pending:
                by_entry.setdefault(id(r.entry), []).append(r)
            seen = set()
            for r in list(self._pending):
                e = r.entry
                if id(e) in seen:
                    continue
                seen.add(id(e))
                if (e.deadline is not None
                        and now > e.deadline + allowance
                        and len(by_entry[id(e)]) == len(e.rows)):
                    doomed.append(e)
            if doomed:
                doomed_ids = {id(e) for e in doomed}
                self._pending = deque(r for r in self._pending
                                      if id(r.entry) not in doomed_ids)
            for entry in doomed:
                self._fail_entry(entry, KubeMLError(
                    "request deadline expired while queued for a decode "
                    "slot", 504), self.stats.deadline_expired,
                    outcome="expired")

    def _busy(self) -> bool:
        return any(r is not None for r in self._slot_rows)

    def _mark_slotted(self, row: _Row) -> None:
        """Lifecycle: queued -> holding a slot (once a row)."""
        if not row.slot_at:
            row.slot_at = time.monotonic()
            self.stats.phase("queue_wait",
                             row.slot_at - row.entry.submitted_at)

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

    def _charge_stall(self, stalled: List[_Row], seconds: float) -> None:
        """A prefill forward's wall, charged to each row it delayed and to
        the engine counter (seconds x rows)."""
        self.stats.hol_stall(seconds, len(stalled))
        for r in stalled:
            r.hol_stall += seconds

    def _decode_rows(self) -> List[_Row]:
        """The resident rows with decode work (not finished, canceled, or
        mid chunked prefill)."""
        return [r for r in self._slot_rows
                if r is not None and not r.done and not r.canceled
                and not r.prefilling]

    def _occupancy(self, steps: int, width: int, emitted: int) -> None:
        """Slot accounting of one chunk or spec step (``width`` token slots
        a row each step): live = tokens emitted, dead = the rest of the
        resident rows' slots (rows mid chunked prefill included), idle =
        the slots no row holds."""
        resident = sum(1 for r in self._slot_rows if r is not None)
        dead = steps * width * resident - emitted
        self.stats.chunk_occupancy(
            steps, emitted, dead,
            steps * width * self.slots - emitted - dead,
            capacity=width * self.slots)

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
            self._consumed(r)
            if fresh:
                self._emit_delta(r, fresh)
            if ((r.eos >= 0 and r.out[-1] == r.eos)
                    or len(r.out) >= r.max_new):
                self._complete_row(r)

    @staticmethod
    def _consumed(r: _Row) -> None:
        """Record a sampled row's generator state after a consumed step."""
        if r.gen is not None:
            r.gen_state = r.gen.get_state()

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
        if r.lease is not None:
            self._pool.release(r.lease)
        with self._cond:
            self._slot_rows[r.slot] = None
            self._free.append(r.slot)

    def _complete_row(self, r: _Row) -> None:
        r.done = True
        if r.first_emit_at:
            self.stats.phase("decode_active",
                             r.last_emit_at - r.first_emit_at)
        self.stats.phase("slot_idle", time.monotonic() - r.last_emit_at
                         if r.last_emit_at else 0.0)
        self._release_row(r)
        entry = r.entry
        if entry.finished():
            if self._claim_outcome(entry):
                self.stats.completed(time.monotonic() - entry.submitted_at)
                self._finish_timeline(entry, "completed")
            entry.done_evt.set()
            if entry.stream_q is not None:
                entry.stream_q.put(None)

    def _finish_timeline(self, entry: _Entry, outcome: str) -> None:
        """The request's span tree, when tracing is on (JAX :1034-1082):
        ``serving.request`` tagged ``job=<request_id>`` under the
        submitter's context, with ``serving.queue_wait``,
        ``serving.prefill`` and ``serving.decode`` children built from the
        rows' timeline. Called once an entry, by whichever site claimed
        its outcome; never fails the serving path."""
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            return
        try:
            now = time.monotonic()
            sub = entry.submitted_at
            slot_at = min((r.slot_at for r in entry.rows if r.slot_at),
                          default=0.0)
            first = min((r.first_emit_at for r in entry.rows
                         if r.first_emit_at), default=0.0)
            last = max((r.last_emit_at for r in entry.rows), default=0.0)
            wall = entry.wall0 - sub  # monotonic -> wall clock
            ctx = entry.trace_ctx
            req = tracer.add_span(
                "serving.request", entry.wall0, (last or now) - sub,
                trace_id=ctx.trace_id if ctx is not None else None,
                parent_id=ctx.span_id if ctx is not None else None,
                job=entry.request_id, model=self.name,
                rows=len(entry.rows),
                tokens=sum(len(r.out) for r in entry.rows),
                outcome=outcome,
                itl_p99=_itl_quantile(entry.rows, 0.99),
                hol_stall_seconds=sum(r.hol_stall for r in entry.rows))
            if req is None:
                return
            kw = dict(trace_id=req.trace_id, parent_id=req.span_id,
                      job=entry.request_id)
            if slot_at:
                tracer.add_span("serving.queue_wait", entry.wall0,
                                slot_at - sub, **kw)
                if first:
                    tracer.add_span("serving.prefill", wall + slot_at,
                                    first - slot_at, **kw)
            if first and last > first:
                tracer.add_span("serving.decode", wall + first,
                                last - first, **kw)
        except Exception:
            log.debug("serving timeline emission failed", exc_info=True)

    def _claim_outcome(self, entry: _Entry) -> bool:
        """Each request counts exactly one outcome (completed, timed out,
        canceled, shed, expired or failed), whichever side claims it
        first."""
        with self._cond:
            if entry.aborted:
                return False
            entry.aborted = True
            return True

    def _emit_delta(self, r: _Row, tokens: List[int]) -> None:
        entry = r.entry
        now = time.monotonic()
        if entry.first_token_at == 0.0:
            entry.first_token_at = now
            self.stats.first_token(now - entry.submitted_at)
        if r.first_emit_at == 0.0:
            r.first_emit_at = now
        else:
            # one gap an arrival: a multi-token delta is one arrival
            gap = now - r.last_emit_at
            r.itl.append(gap)
            self.stats.inter_token(gap)
        r.last_emit_at = now
        # tokens routed to a waiter that already gave up are waste, and so
        # are the tokens of this delta past a ``cancel_after`` point
        past = (len(r.out) - entry.cancel_after
                if entry.cancel_after and not entry.aborted else -1)
        over = max(past, 0)
        self.stats.emitted(len(tokens) - over, wasted=entry.aborted)
        if over:
            self.stats.emitted(over, wasted=True)
        if entry.stream_q is not None:
            entry.stream_q.put({"row": r.index, "tokens": tokens})
        if past >= 0:
            self.cancel(entry)

    def _fail_all(self, error: Exception, wrap: bool = False) -> None:
        """Fail every queued and resident row. ``wrap`` reaches waiters as
        a retryable 503 carrying the tokens emitted so far; close() passes
        its own error through."""
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
            self._fail_entry(entry, (
                error if not wrap or isinstance(error, KubeMLError)
                else EngineFaultError(
                    f"decode engine fault: {error}",
                    partial_tokens=[list(r.out) for r in entry.rows])),
                self.stats.failed)


class PagedBatchingDecoder(_SlotEngine):
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

    ``queue_limit`` (0: unbounded), ``shed_policy`` (``"reject"`` or
    ``"oldest"``) and ``pool_audit_interval`` (seconds, 0: off) default
    to ``api.config``'s ``KUBEML_SERVING_QUEUE_LIMIT``,
    ``KUBEML_SERVING_SHED`` and ``KUBEML_POOL_AUDIT_INTERVAL``.
    """

    def __init__(self, module, *, slots: int = DEFAULT_SLOTS,
                 chunk_steps: int = 16, page_tokens: int = 16,
                 pages: int = 0, prefix_cache: bool = True,
                 paged_attn: str = "auto", kv_quant: str = "off",
                 quantize: str = "", int8_matmul: bool = False,
                 int8_matmul_impl: str = "auto",
                 queue_limit: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 spec: str = "", spec_k: int = 4, spec_adaptive: bool = True,
                 draft_module=None, spec_exit_layer: int = 0,
                 spec_min_accept: float = 0.10,
                 prefill_chunk_tokens: int = 0,
                 pool_audit_interval: Optional[float] = None,
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
        cfg = get_config()
        self.module = module.eval()
        self.max_len = int(module.max_len)
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else cfg.serving_queue_limit)
        self.shed_policy = str(shed_policy if shed_policy is not None
                               else cfg.serving_shed_policy)
        self.pool_audit_interval = float(
            pool_audit_interval if pool_audit_interval is not None
            else cfg.pool_audit_interval)
        self.name = name
        self.stats = DecoderStats(self.slots)
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
        # the KV-read model's unit: bytes one forward reads a cached token
        self._kv_token_bytes = _kv_token_bytes(module, self.kv_quant)
        self._kv_draft_token_bytes = (
            _kv_token_bytes(module, self.kv_quant, self.spec_exit_layer)
            if self.spec == "self" else
            _kv_token_bytes(self.draft_module, self.kv_quant)
            if self.draft_module is not None else 0)
        self.weight_bytes = quantized_bytes(module)
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
        self._init_queue_state(name)
        self._next_audit = 0.0

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

    def telemetry(self) -> dict:
        """The shared gauges plus page occupancy, which arena read this
        engine runs (1 = the CUDA kernel, 0 = the plain version), the
        arena storage, and the speculative controller's state."""
        snap = super().telemetry()
        snap.update(self._pool.telemetry())
        snap["paged_attn_kernel"] = 1.0 if self.paged_attn == "cuda" else 0.0
        snap["kv_quant"] = 1.0 if self.kv_quant == "int8" else 0.0
        # rows holding a slot and pages mid chunked prefill
        snap["prefills_in_progress"] = float(len(self._prefill_pending))
        if self._spec_ctl is not None:
            # the adaptive k (0: speculation suspended or disabled), its
            # EWMA acceptance once sampled, and the draft floor's trip
            snap["spec_k"] = float(self._spec_ctl.current())
            if self._spec_ctl.ratio >= 0:
                snap["spec_accept_ewma"] = float(self._spec_ctl.ratio)
            snap["spec_disabled"] = 1.0 if self._spec_ctl.disabled else 0.0
        return snap

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

    # --- overload: shedding, Retry-After, deadlines ---

    # --- KMS1 snapshots: restore, capture, recovery, drain ---

    def submit_snapshot(self, frame, stream: bool = False) -> _Entry:
        """Admit a KMS1 frame (bytes or a ``kvsnap.RequestSnapshot``) as a
        request: the row queues with its emitted tokens and, once the page
        budget covers it, its pages scatter into fresh pages and it decodes
        on from its saved position. A frame with no emissions prefills from
        its prompt; a finished one resolves at once. A geometry, storage
        or sampler mismatch is a 409, a frame no arena this size could
        hold a 400."""
        snap = (frame if isinstance(frame, kvsnap.RequestSnapshot)
                else kvsnap.decode_snapshot(frame))
        if snap.model and snap.model != self.name:
            raise KubeMLError(
                f"snapshot was taken from model {snap.model!r}, this "
                f"decoder serves {self.name!r}", 409)
        if not snap.prompt:
            raise KubeMLError("snapshot carries an empty prompt", 400)
        plen = len(snap.prompt)
        if plen + snap.max_new - 1 > self.max_len:
            raise KubeMLError(
                f"snapshot prompt ({plen}) + max_new ({snap.max_new}) - 1 "
                f"exceeds the model's max_len ({self.max_len})", 400)
        self._check_capacity(plen, snap.max_new)
        done = bool(snap.out) and (
            len(snap.out) >= snap.max_new
            or (snap.eos >= 0 and snap.out[-1] == snap.eos))
        sampler = snap.sampler if snap.temp > 0 else None
        if snap.temp > 0 and not done and sampler is None:
            raise KubeMLError(
                "sampled snapshot carries no torch_sampler state (the JAX "
                "engine's key chain cannot be rebuilt here); resubmit the "
                "prompt", 409)
        if snap.out and not done:
            self._check_restorable(snap)
        rows: List[_Row] = []
        entry = _Entry(rows=rows, max_new=int(snap.max_new),
                       stream_q=queue.Queue() if stream else None,
                       submitted_at=time.monotonic(),
                       deadline=current_deadline(),
                       request_id=snap.request_id or self._next_request_id(),
                       wall0=time.time(),
                       trace_ctx=tracing.current_context())
        rows.append(_Row(entry=entry, index=0,
                         prompt=np.asarray(snap.prompt, np.int32),
                         max_new=int(snap.max_new), temp=float(snap.temp),
                         topk=int(snap.topk), eos=int(snap.eos),
                         gen_seed=int(sampler.get("seed", 0)) if sampler else 0,
                         out=list(snap.out),
                         snapshot=snap if snap.out and not done else None))
        with self._cond:
            if self._closed or self._retired:
                raise DecoderClosed()
            if self._drain_mode and not done:
                self.stats.overloaded()
                raise OverloadedError(
                    "decoder is draining for shutdown; replay the snapshot "
                    "elsewhere", retry_after=max(
                        1.0, self._drain_deadline - time.monotonic()))
            if done:
                self.stats.submitted(1)
                rows[0].done = True
            else:
                # restores bypass the queue limit: they replay work a
                # server already accepted once
                self._enqueue_locked(rows)
        if stream and snap.out:
            # the pre-snapshot emissions as one delta, so the stream
            # concatenates to the uninterrupted one
            entry.stream_q.put({"row": 0, "tokens": list(snap.out)})
        if done:
            if self._claim_outcome(entry):
                self.stats.completed(0.0)
                self._finish_timeline(entry, "completed")
            entry.done_evt.set()
            if entry.stream_q is not None:
                entry.stream_q.put(None)
        return entry

    def _check_restorable(self, snap) -> None:
        """409 unless a mid-stream frame fits this arena byte for byte and
        its sampler can be rebuilt on this device."""
        if int(snap.page_tokens) != self.page_tokens:
            raise KubeMLError(
                f"snapshot page_tokens ({snap.page_tokens}) != engine "
                f"page_tokens ({self.page_tokens})", 409)
        mine = "int8" if self.kv_quant == "int8" else "none"
        theirs = "int8" if snap.kv_quant == "int8" else "none"
        if mine != theirs:
            raise KubeMLError(
                f"snapshot arena storage is {theirs!r}, engine stores "
                f"{mine!r} (KUBEML_KV_QUANT mismatch)", 409)
        if self.spec == "draft":
            raise KubeMLError(
                "mid-stream restore is unsupported under spec='draft' (the "
                "drafter's separate arena is not captured); resubmit the "
                "prompt", 409)
        if len(snap.layers) != self.module.depth:
            raise KubeMLError(f"snapshot has {len(snap.layers)} layers, "
                              f"model has {self.module.depth}", 409)
        heads = self.module.num_heads
        want = (self.page_tokens, heads, self.module.embed_dim // heads)
        for layer in snap.layers:
            got = tuple(int(x) for x in layer.k.shape[1:])
            if got != want:
                raise KubeMLError(
                    f"snapshot layer {layer.name!r} page shape {got} != "
                    f"engine page shape {want}", 409)
        if snap.temp > 0 and (snap.sampler.get("state") is None
                              or snap.sampler.get("device")
                              != self.device.type):
            raise KubeMLError(
                f"snapshot sampler state is for "
                f"{snap.sampler.get('device')!r}, this engine samples on "
                f"{self.device.type!r}", 409)

    def _sampler_field(self, row: _Row) -> Optional[dict]:
        """A sampled row's ``torch_sampler`` frame field: the generator's
        seed, and its state after the last consumed step (None before the
        first token: the restore seeds a fresh generator)."""
        if row.temp <= 0:
            return None
        return {"device": self.device.type, "seed": int(row.gen_seed),
                "state": (kvsnap.sampler_state(row.gen_state)
                          if row.gen_state is not None else None)}

    def _frame_of(self, row: _Row, layers) -> "kvsnap.RequestSnapshot":
        return kvsnap.RequestSnapshot(
            model=self.name, request_id=row.entry.request_id,
            page_tokens=self.page_tokens,
            kv_quant="int8" if self.kv_quant == "int8" else "none",
            spec=self.spec or "off",
            prompt=[int(t) for t in row.prompt], out=list(row.out),
            max_new=row.max_new, temp=row.temp, topk=row.topk, eos=row.eos,
            key=(0, 0), layers=layers, sampler=self._sampler_field(row))

    def _snapshot_row(self, row: _Row, ahead: int = 0
                      ) -> Optional["kvsnap.RequestSnapshot"]:
        """One resident row's portable state: tokens, knobs, sampler and
        the written pages gathered through its page table, plus the pages
        of the next ``ahead`` positions (an in-process replay takes the
        speculative lookahead too: a rejected draft there raised an int8
        page's scale, which the uninterrupted run keeps). None, after
        counting a failure, when it cannot be captured: the draft
        backend's rows (its arena is not covered) and rows whose pages
        cannot be read."""
        if self.spec == "draft":
            self.stats.snapshot_fail()
            return None
        t0 = time.monotonic()
        try:
            npg = kvsnap.snapshot_pages_needed(len(row.prompt), len(row.out),
                                               self.page_tokens)
            if row.lease is None or len(row.lease.pages) < npg:
                raise kvsnap.SnapshotError("row holds no page lease")
            if ahead:
                npg = min(len(row.lease.pages), self._pool.pages_for(
                    len(row.prompt) + len(row.out) - 1 + ahead))
            snap = self._frame_of(row, kvsnap.gather_pages(
                self.cache, list(row.lease.pages[:npg])))
            self.stats.snapshot_save(kvsnap.snapshot_nbytes(snap),
                                     time.monotonic() - t0)
            return snap
        except Exception:
            log.exception("%s: row snapshot failed (request %s)", self.name,
                          row.entry.request_id)
            self.stats.snapshot_fail()
            return None

    def _restore(self, row: _Row) -> None:
        """Scatter a snapshot row's pages into its fresh lease and rebuild
        its sampler: the state its prefill and ``len(out) - 1`` steps had
        left. Its cursor is ``prompt_len + len(out) - 1`` from ``out``."""
        snap = row.snapshot
        t0 = time.monotonic()
        try:
            npg = len(snap.layers[0].k) if snap.layers else 0
            if len(row.lease.pages) < npg:
                raise kvsnap.SnapshotError(
                    f"lease holds {len(row.lease.pages)} pages, snapshot "
                    f"needs {npg}")
            kvsnap.scatter_pages(self.cache, list(row.lease.pages[:npg]),
                                 snap.layers)
            if row.temp > 0:
                row.gen = kvsnap.sampler_generator(snap.sampler, self.device)
                row.gen_state = row.gen.get_state()
        except Exception as e:
            log.exception("%s: snapshot restore failed (slot %d)", self.name,
                          row.slot)
            self.stats.snapshot_fail()
            self._release_row(row)
            row.snapshot = None
            self._fail_entry(row.entry, EngineFaultError(
                f"snapshot restore failed: {e}",
                partial_tokens=[list(row.out)]), self.stats.failed)
            return
        if row.replayed:
            # this arena's own bytes: later sharers may reuse them
            self._pool.register_prefix(row.prompt, row.lease)
        row.snapshot = None
        row.replayed = False
        now = time.monotonic()
        if not row.slot_at:
            row.slot_at = now
            self.stats.phase("queue_wait", now - row.entry.submitted_at)
        self.stats.snapshot_restore(kvsnap.snapshot_nbytes(snap), now - t0)

    def _recover_rows(self, error: Exception) -> List[_Row]:
        """Fault recovery's salvage half, run before the arena is zeroed:
        resident rows with emissions snapshot, rows with none prefill
        again; an entry with a row that cannot be snapshotted fails now,
        retryably, with its partial tokens. Queued rows of healthy entries
        stay queued. Returns the salvaged rows in slot order."""
        with self._cond:
            resident = [r for r in self._slot_rows if r is not None]
        doomed: Dict[int, _Entry] = {}
        salvaged: List[_Row] = []
        for row in resident:
            if row.done or row.canceled:
                continue
            snap = None
            if row.out:
                snap = self._snapshot_row(row, ahead=self._spec_lookahead)
                if snap is None:
                    doomed.setdefault(id(row.entry), row.entry)
                    continue
            row.snapshot = snap
            row.replayed = snap is not None
            row.lease = None  # the pool is rebuilt; old leases are void
            row.slot = -1
            row.prefilling = False
            row.prefix_cached = 0
            salvaged.append(row)
        salvaged = [r for r in salvaged if id(r.entry) not in doomed]
        if doomed:
            with self._cond:
                self._pending = deque(r for r in self._pending
                                      if id(r.entry) not in doomed)
            for entry in doomed.values():
                self._fail_entry(entry, EngineFaultError(
                    f"decode engine fault: {error}; request state could "
                    "not be snapshotted across the rebuild - retry",
                    partial_tokens=[list(r.out) for r in entry.rows]),
                    self.stats.failed)
        return salvaged

    def _reset_engine_state(self) -> None:
        """A fresh pool and zeroed arenas: every cached page is void."""
        self._pool = KVPool(self._pool.num_pages, self.page_tokens,
                            prefix_cache=self._pool.trie is not None)
        self.cache.zero_()
        if self.draft_cache is not None:
            self.draft_cache.zero_()

    def _audit_pool(self) -> None:
        """One KVPool invariant audit: a broken invariant raises into the
        loop's fault recovery (snapshot, rebuild, replay) instead of
        decoding through aliased pages."""
        try:
            with self._cond:
                self._pool.check()
        except Exception as e:
            self.stats.pool_audit(False)
            log.error("%s: KVPool invariant audit FAILED: %s", self.name, e)
            report_error("serving.pool_audit", f"{self.name}: {e}")
            raise
        self.stats.pool_audit(True)

    def drain(self, grace: Optional[float] = None) -> List[bytes]:
        """Graceful shutdown: stop admitting (submit answers 429 with
        Retry-After), give live rows ``grace`` seconds
        (``KUBEML_DRAIN_GRACE``) to finish, then snapshot every straggler
        into a KMS1 frame (its waiter gets a retryable 503 with its partial
        tokens) and return the frames; [] when all finished in time."""
        if grace is None:
            grace = float(get_config().drain_grace)
        deadline = time.monotonic() + max(0.0, grace)
        with self._cond:
            self._drain_mode = True
            self._drain_deadline = deadline
            active = self._thread is not None and not self._closed
            self._cond.notify_all()
        if not active:
            return []
        while time.monotonic() < deadline:
            with self._cond:
                if not self._pending and not self._busy():
                    return []
            time.sleep(0.05)
        req = _DrainReq()
        with self._cond:
            if self._closed:
                return []
            self._drain_req = req
            self._cond.notify_all()
        if not req.evt.wait(timeout=max(30.0, grace) + 120.0):
            log.warning("%s: drain quiesce timed out", self.name)
            return []
        return list(req.frames)

    def _drain_quiesce(self, req: _DrainReq) -> None:
        """The engine-thread half of :meth:`drain`: one KMS1 frame per
        single-row straggler (a row with no emission yet gets a frame
        without pages, which prefills on replay), the drained waiters
        failed retryably, every lease released, the frames handed back."""
        with self._cond:
            resident = [r for r in self._slot_rows if r is not None]
            queued = list(self._pending)
            self._pending.clear()
        entries: Dict[int, _Entry] = {}
        for r in resident + queued:
            if not r.done and not r.canceled:
                entries.setdefault(id(r.entry), r.entry)
        frames: List[bytes] = []
        for entry in entries.values():
            snap = None
            if len(entry.rows) == 1:
                r = entry.rows[0]
                if r.out:
                    snap = self._snapshot_row(r)
                else:
                    t0 = time.monotonic()
                    snap = self._frame_of(r, [])
                    self.stats.snapshot_save(kvsnap.snapshot_nbytes(snap),
                                             time.monotonic() - t0)
            if snap is not None:
                try:
                    frames.append(kvsnap.encode_snapshot(snap))
                except Exception:
                    log.exception("%s: drain frame encode failed (%s)",
                                  self.name, entry.request_id)
                    self.stats.snapshot_fail()
            self._fail_entry(entry, EngineFaultError(
                "decoder drained for shutdown"
                + ("; request snapshotted for replay" if snap is not None
                   else ""),
                partial_tokens=[list(r.out) for r in entry.rows]),
                self.stats.failed)
        with self._cond:
            for r in resident:
                if r.lease is not None:
                    self._pool.release(r.lease)
                    r.lease = None
            self._slot_rows = [None] * self.slots
            self._free = list(range(self.slots))
            self._prefill_pending = []
            self._drain_req = None
            self._cond.notify_all()
        req.frames = frames
        req.evt.set()

    # --- engine loop (one thread owns the device state) ---

    def _loop(self) -> None:
        while True:
            self._sweep_expired()
            with self._cond:
                while (not self._closed and not self._pending
                       and not self._busy() and self._drain_req is None):
                    if self._retired:
                        self.cache = self.draft_cache = None  # free the arena
                        return
                    self._cond.wait()
                if self._closed:
                    return
                admits = (self._take_admissions_locked()
                          if self._drain_req is None else [])
            try:
                req = self._drain_req
                if req is not None and not admits:
                    self._drain_quiesce(req)
                    continue
                if (self.pool_audit_interval > 0
                        and time.monotonic() >= self._next_audit):
                    self._next_audit = (time.monotonic()
                                        + self.pool_audit_interval)
                    self._audit_pool()
                with torch.inference_mode():
                    advanced, size = self._turn(admits)
                if not admits and not advanced and not size:
                    # only the queue head is waiting (for pages): yield
                    with self._cond:
                        self._cond.wait(0.01)
            except Exception as e:
                log.exception("%s: paged decode loop failed", self.name)
                # snapshot what can be saved BEFORE the arena is zeroed
                salvaged = self._recover_rows(e)
                with self._cond:
                    if self._closed:
                        return
                    self._slot_rows = [None] * self.slots
                    self._free = list(range(self.slots))
                    self._prefill_pending = []
                try:
                    self._reset_engine_state()
                except Exception:
                    # the engine is down for good: the salvaged rows live
                    # nowhere _fail_all can see, so fail them here first
                    with self._cond:
                        self._closed = True
                    for entry in {id(r.entry): r.entry
                                  for r in salvaged}.values():
                        self._fail_entry(entry, EngineFaultError(
                            f"decode engine fault: {e}; rebuild failed",
                            partial_tokens=[list(r.out)
                                            for r in entry.rows]),
                            self.stats.failed)
                    self._fail_all(e, wrap=True)
                    return
                if salvaged:
                    # replay: the rows were admitted before anything queued
                    with self._cond:
                        for row in reversed(salvaged):
                            self._pending.appendleft(row)
                        self._cond.notify_all()
                    self.stats.snapshot_replay(len(salvaged))

    def _turn(self, admits: List[_Row]):
        """One engine-loop turn: restore, prefill or start chunking the
        admitted rows, advance chunked prefills, then one decode chunk or
        spec step. Returns (prefill advanced, chunk size run)."""
        whole = []
        for row in admits:
            if row.snapshot is not None:
                self._restore(row)
            elif (self.prefill_chunk and len(row.prompt)
                    - row.lease.prefill_pos > self.prefill_chunk):
                # a long cold suffix prefills in page-aligned chunks
                # interleaved with decode
                row.prefilling = True
                self._mark_slotted(row)
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
        return advanced, size

    def _take_admissions_locked(self) -> List[_Row]:
        """Admit queued rows FIFO while a slot is free AND the page budget
        covers them (worst case: prompt + max_new - 1 positions and the
        speculative lookahead, minus what the prefix trie already holds;
        a snapshot row reserves private pages). The head of the line
        blocks the tail."""
        admits = []
        while self._pending and self._free:
            row = self._pending[0]
            if row.canceled:
                self._pending.popleft()
                continue
            if row.snapshot is not None:
                lease = self._pool.reserve(self._pool.total_positions(
                    len(row.prompt), row.max_new, self._spec_lookahead,
                    self.max_len))
            else:
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
                self.stats.prefix_hit(lease.prefix_tokens)
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

    def _kv_tokens(self, depths: List[int], width: int) -> int:
        """Cached tokens one forward reads through ``width``-page tables
        at these query depths: the kernel stops at each row's live pages,
        the gather path reads every row's whole table."""
        pt = self.page_tokens
        if self.paged_attn == "cuda":
            return sum(min(-(-d // pt), width) * pt for d in depths)
        return len(depths) * width * pt

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
        depths = [b + n for b, n in zip(
            base, seq_lens or [tokens.shape[1]] * len(base))]
        self.stats.kv_read(self._kv_tokens(depths, width)
                           * (self._kv_token_bytes
                              + (self._kv_draft_token_bytes
                                 if self.draft_module is not None else 0)))
        return hidden

    def _prefill(self, group: List[_Row]) -> None:
        """Prefill the group's remaining suffixes in one forward straight
        into the arena, sample each row's first token, and register the
        full prompt blocks in the prefix trie for later sharers."""
        t0 = time.monotonic()
        stalled = self._stalled_rows()
        for r in group:
            self._mark_slotted(r)
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
                r.gen.manual_seed(r.gen_seed)
        firsts = draft_sample(logits, *self._knobs(group), TOP_K_MAX,
                              with_probs=False)[0].tolist()
        for r in group:
            self._pool.register_prefix(r.prompt, r.lease)
        self._charge_stall(stalled, time.monotonic() - t0)
        self._warmed = True
        self.stats.admitted_wave()
        self.stats.admit_tokens(sum(slens), k * width - sum(slens))
        now = time.monotonic()
        for r, tok in zip(group, firsts):
            if r.canceled:
                continue
            self.stats.phase("prefill", now - r.slot_at)
            r.out.append(int(tok))
            self._consumed(r)
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
            self.stats.prefill_chunk(len(group), n_tok)
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
        self.stats.admit_tokens(cap * len(rows), 0)
        self.stats.prefill_chunk(len(rows), cap * len(rows))

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
        pos0 = pos.tolist()
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
        wall = time.monotonic() - t0
        self._warmed = True
        self.stats.chunk()
        self.stats.chunk_fetched(wall, size)
        self.stats.kv_read(sum(self._kv_tokens([p + s for p in pos0],
                                               table.shape[1])
                               for s in range(1, size + 1))
                           * self._kv_token_bytes, wall)
        self._occupancy(size, 1, int((packed >= 0).sum()))
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
        pos0 = pos.tolist()
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
        self._warmed = True
        self.stats.chunk()
        tw = table.shape[1]
        iters = k + 1 if self.spec == "draft" else k
        self.stats.kv_read(
            self._kv_tokens([p + k + 1 for p in pos0], tw)
            * self._kv_token_bytes
            + sum(self._kv_tokens([p + i for p in pos0], tw)
                  for i in range(1, iters + 1)) * self._kv_draft_token_bytes,
            time.monotonic() - t0)
        self._occupancy(1, k + 1, int((packed[:, :-1] >= 0).sum()))
        self.stats.spec_step(k * S, accepted, (k + 1) * S)
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


class DenseShard:
    """The device half of the dense slot engine on one rank: the module
    (this rank's block of it over a serving mesh), its KV cache of
    ``slots`` stripes, and the generators of the sampled slots, each with
    its seed and the draws it made. :class:`BatchingDecoder` drives one
    in its own process; over a mesh every other rank of the mesh drives
    its own from the leader's ops (:meth:`run`, :func:`serve_follower`),
    so every rank runs the same forwards, collectives and draws, and
    samples the same tokens from the same whole logits.

    An op is a JSON-ready dict: ``{"op": "prefill", "tokens" [k, bucket],
    "plens", "slots", "temp", "topk", "seeds"}`` (a seed a sampled row,
    None for a greedy one) or ``{"op": "decode", "size", "tok", "pos",
    "rem", "eos", "temp", "topk", "gens"}`` (a value a slot; ``gens`` the
    ``[seed, draws]`` of each generator the chunk draws from, which a
    follower checks against its own).

    ``quantize="int8"`` as :class:`BatchingDecoder` describes; a dense
    module on a mesh quantizes its blocks with the whole leaves' scales
    (``serving.quant.quantize_tree``, collective over the mesh)."""

    def __init__(self, module, *, slots: int, quantize: str = "",
                 int8_matmul: bool = False, int8_matmul_impl: str = "auto",
                 mesh=None, name: str = "decoder", device=None):
        from ..models.gpt import place_on_mesh

        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.device = resolve_device(
            device if device is not None or self.mesh is None
            else self.mesh.device)
        if getattr(module, "max_len", None) is None:
            raise GenerationInputError(
                "model exposes no max_len attribute; batched decode requires "
                "a declared KV-cache capacity")
        if quantize not in ("", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(valid: '', 'int8')")
        if self.mesh is not None and getattr(module, "mesh", None) is None:
            place_on_mesh(module, self.mesh)
        elif getattr(module, "mesh", None) is not self.mesh:
            raise ValueError(f"the module lies on mesh "
                             f"{getattr(module.mesh, 'shape', None)}, the "
                             f"decoder serves on "
                             f"{getattr(self.mesh, 'shape', None)}")
        if module.device != self.device:
            raise ValueError(f"module lives on {module.device}, the decoder "
                             f"on {self.device}; move it first")
        pre_quantized = _is_quantized(module)
        if pre_quantized and quantize != "int8":
            raise ValueError("module carries int8 weights but quantize is "
                             "not 'int8'")
        self.module = module.eval()
        self.slots = int(slots)
        self.quantize = quantize
        self.int8_matmul = quantize == "int8" and (bool(int8_matmul)
                                                   or pre_quantized)
        if self.int8_matmul and getattr(module, "moe_every", 0):
            log.warning("%s: the int8 matmul does not cover MoE expert "
                        "weights; falling back to in-step dequantize", name)
            self.int8_matmul = False
        self.int8_matmul_impl = resolve_int8_matmul(int8_matmul_impl,
                                                    self.device)
        self._load_int8(module)
        self.reset()

    def _load_int8(self, module) -> None:
        """Install ``quantize="int8"`` weights in place: int8 kernels for
        the int8 matmul, else int8 values that each forward dequantizes
        (projections with ``int8_impl="dequant"``, MoE weights through
        ``MoEMlp``)."""
        if self.quantize != "int8":
            return
        impl = self.int8_matmul_impl if self.int8_matmul else "dequant"
        if not _is_quantized(module):
            load_tree(module, quantize_tree(
                module.state_dict(), self.mesh,
                getattr(module, "mesh_specs", None)), int8_impl=impl)
        for m in module.modules():
            if isinstance(m, QuantizableDense):
                m.int8_impl = impl

    def reset(self) -> None:
        """Zeroed stripes and no generators (a new engine, or after a
        fault)."""
        self.cache = init_cache(self.module, self.slots)
        # per slot: [seed, draws, generator] of a sampled row, else None
        self.gens: List[Optional[list]] = [None] * self.slots

    def generator(self, slot: int) -> Optional[torch.Generator]:
        g = self.gens[slot]
        return None if g is None else g[2]

    def gen_keys(self, slots: List[int]) -> List[Optional[list]]:
        """``[seed, draws]`` of each slot's generator (None: none)."""
        return [None if self.gens[s] is None else self.gens[s][:2]
                for s in slots]

    @torch.inference_mode()
    def run(self, op: dict):
        """Execute one op; the prefill's first tokens (a list) or the
        decode chunk's ``[slots, size]`` tokens (-1 past a row's end)."""
        if op["op"] == "prefill":
            return self.prefill(op)
        if op["op"] == "decode":
            return self.decode(op)
        raise ValueError(f"unknown serving op {op['op']!r}")

    def _draw(self, logits, temp, topk, gens: List[Optional[list]]):
        toks = draft_sample(
            logits, torch.tensor(temp, dtype=torch.float32,
                                 device=self.device),
            torch.tensor(topk, dtype=torch.int64, device=self.device),
            [None if g is None else g[2] for g in gens], TOP_K_MAX,
            with_probs=False)[0]
        for g in gens:
            if g is not None:
                g[1] += 1
        return toks

    def prefill(self, op: dict) -> List[int]:
        """One forward over the group's padded prompts into a scratch cache
        of the bucket's length, its stripes copied into the rows' slots
        (``valid`` trimmed to each prompt), each row's first token
        sampled (a sampled row's generator seeded here)."""
        dev = self.device
        tokens = torch.as_tensor(np.asarray(op["tokens"], np.int64),
                                 device=dev)
        k, bucket = tokens.shape
        plens = torch.tensor(op["plens"], device=dev)
        slots = list(op["slots"])
        scratch = init_cache(self.module, k, cache_len=bucket)
        hidden = self.module(tokens, decode=True, cache=scratch,
                             return_hidden=True)
        # next-token logits at each row's last real prompt token
        logits = self.module.logits(hidden[torch.arange(k, device=dev),
                                           plens - 1])
        at = torch.tensor(slots, device=dev)
        trim = (torch.arange(self.module.max_len, device=dev)[None, :]
                < plens[:, None])
        for stripe, rows in zip(self.cache.layers, scratch.layers):
            stripe["k"][at, :bucket] = rows["k"]
            stripe["v"][at, :bucket] = rows["v"]
            stripe["valid"][at] = trim
        for s, seed in zip(slots, op["seeds"]):
            self.gens[s] = (None if seed is None else
                            [int(seed), 0,
                             torch.Generator(device=dev).manual_seed(
                                 int(seed))])
        return self._draw(logits, op["temp"], op["topk"],
                          [self.gens[s] for s in slots]).tolist()

    def decode(self, op: dict) -> np.ndarray:
        """Advance every slot ``size`` tokens at its own position; rows
        that hit eos or their budget freeze and emit nothing more."""
        dev = self.device
        as_t = lambda key, dt: torch.tensor(op[key], dtype=dt, device=dev)
        tok, pos = as_t("tok", torch.int64), as_t("pos", torch.int64)
        remaining, eos = as_t("rem", torch.int32), as_t("eos", torch.int64)
        live = remaining > 0
        size = int(op["size"])
        for s, want in enumerate(op["gens"]):
            if want is None:
                self.gens[s] = None
            elif self.gens[s] is None or self.gens[s][:2] != list(want):
                raise RuntimeError(
                    f"slot {s}: the leader's generator is {want}, this "
                    f"rank's {self.gen_keys([s])[0]}: the ranks are out of "
                    f"lockstep")
        out = torch.empty((size, self.slots), dtype=torch.int64, device=dev)
        for t in range(size):
            logits = self.module(tok[:, None], decode=True, positions=pos,
                                 cache=self.cache)[:, -1]
            nxt = self._draw(logits, op["temp"], op["topk"], self.gens)
            was_live = live
            remaining = remaining - was_live.int()
            live = was_live & ~((eos >= 0) & (nxt == eos)) & (remaining > 0)
            out[t] = torch.where(was_live, nxt, torch.full_like(nxt, -1))
            tok = torch.where(live, nxt, tok)
            pos = torch.where(live, pos + 1, pos)
        return out.T.cpu().numpy()  # the chunk's one device->host copy


class BatchingDecoder(_SlotEngine):
    """Dense slot engine: continuous batching over per-row cache stripes
    (JAX ``BatchingDecoder``, :479-1795).

    Each of ``slots`` slots owns a ``[max_len]`` stripe of every layer's
    dense K/V cache (``models.generation.DenseCache``). Rows are admitted
    FIFO into free slots; an admission wave prefills in one forward per
    prompt-length bucket (a power of two from 16) into a
    scratch cache, whose stripes are copied into the rows' slots with
    ``valid`` trimmed to each prompt's length. All slots then advance
    together through decode chunks of ``chunk_steps`` or the shorter
    ``tail`` steps (the JAX ladder), each step one forward of every slot at
    its own position; the per-slot slab - token, position, liveness,
    remaining budget, temperature, top-k and eos - is built from the rows
    at each chunk's start, and rows that finish inside a chunk freeze
    (they feed their last token at their last position and emit nothing).
    A chunk is sized to the longest row's remaining work, or, with rows
    queued, to the earliest completion (the JAX engine's default
    pressure sizing). The device work runs in a :class:`DenseShard`.

    This engine serves what the paged engine cannot: MoE-interleaved
    models (no paged decode path), ``serving_paged=False`` and a serving
    mesh. Attention runs over the whole stripe under a dense mask, so it
    takes the plain path, as the JAX engine's XLA path does.

    ``quantize="int8"`` holds int8 weights: with ``int8_matmul`` every
    quantized projection runs through ``int8_matmul_impl`` (``auto``: the
    CUDA kernel on CUDA); without it - and always for MoE models, whose
    expert stacks the int8 matmul does not cover (JAX :590-596) - the int8
    values stay on the device and each forward dequantizes them.

    ``mesh`` (a serving mesh of several ranks, ``parallel.mesh.
    serving_mesh``; JAX ``BatchingDecoder(mesh=)``, :490-690): the model
    is placed on it (``models.gpt.place_on_mesh``, a model built whole;
    or one already there, restored block by block) and the KV stripes
    hold this rank's ``H / tp`` heads. JAX drives the mesh from one
    process; here the ranks are processes, so the decoder runs on rank 0,
    the leader, and every other rank follows (:func:`serve_follower`, or
    ``engine.follower.run_follower``'s serving commands): the decoder
    announces itself (``serve_init``, its knobs) and, before each prefill
    group and each decode chunk, sends the followers the op its own shard
    runs (``serve_op``) over the process-wide ``DistContext``, holding
    ``dist_lock`` around the send and the forwards (the parameter
    server's, so a job over the ranks and serving never interleave
    collectives); it ends with ``serve_close``, sent later by the next
    holder of the lock when a long holder keeps it
    (:func:`send_pending_closes`).
    Rank 0 alone decides admissions and chunk sizes. Every rank samples
    the same whole logits from generators seeded alike, so no token
    crosses ranks inside a chunk. A fault in the loop under a mesh fails
    the rows with a retryable 503 and closes the decoder (a follower that
    faulted has ended its process).

    Sampled rows draw from a generator seeded as the paged engine's
    (``_seed_for``), first at the prefill, then once a decode step, so at
    a fixed seed the two engines draw the same tokens. Counters live in a
    ``DecoderStats`` under the JAX names; the queue limit, shed policy
    and deadlines are the shared ones. A fault in the loop fails the
    resident and queued requests with a retryable 503 carrying their
    tokens and rebuilds the cache, as the JAX engine does; there is no
    snapshot recovery or drain (a paged-engine feature)."""

    def __init__(self, module, *, slots: int = DEFAULT_SLOTS,
                 chunk_steps: int = 8, quantize: str = "",
                 int8_matmul: bool = False, int8_matmul_impl: str = "auto",
                 queue_limit: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 name: str = "decoder", device=None, mesh=None,
                 dist_lock=None):
        cfg = get_config()
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        knobs = dict(slots=int(slots), quantize=quantize,
                     int8_matmul=bool(int8_matmul),
                     int8_matmul_impl=int8_matmul_impl)
        if self.mesh is not None:
            from ..parallel.distributed import get_dist_context

            self._channel = get_dist_context()
            if not self._channel.is_leader or self.mesh.rank != 0:
                raise ValueError("a meshed decoder runs on rank 0; the other "
                                 "ranks follow it (serve_follower)")
            self._dist_lock = dist_lock or threading.Lock()
            self._key = f"{name}-{uuid.uuid4().hex[:8]}"
            with self._dist_lock:
                send_pending_closes()
                self._channel.broadcast_obj({"cmd": "serve_init",
                                             "key": self._key,
                                             "knobs": knobs})
                self._shard = DenseShard(module, mesh=self.mesh, name=name,
                                         device=device, **knobs)
        else:
            self._shard = DenseShard(module, name=name, device=device,
                                     **knobs)
        self._mesh_open = self.mesh is not None
        shard = self._shard
        self.device = shard.device
        self.module = shard.module
        self.max_len = int(module.max_len)
        self.slots = shard.slots
        self.chunk_steps = int(chunk_steps)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else cfg.serving_queue_limit)
        self.shed_policy = str(shed_policy if shed_policy is not None
                               else cfg.serving_shed_policy)
        self.stats = DecoderStats(self.slots)
        self.quantize = shard.quantize
        self.int8_matmul = shard.int8_matmul
        self.int8_matmul_impl = shard.int8_matmul_impl
        self.weight_bytes = quantized_bytes(module)
        # the full stripes are read every forward (the JAX accounting)
        self._kv_token_bytes = _kv_token_bytes(module, "off")
        # two chunk lengths: the big one amortizes a chunk's overhead, the
        # small one finishes request tails
        tail = min(self.chunk_steps,
                   max(8, (self.chunk_steps // 3 + 7) // 8 * 8))
        self._chunk_sizes = sorted({self.chunk_steps, tail})
        self._init_queue_state(name)

    @property
    def cache(self):
        return self._shard.cache

    def _run(self, op: dict):
        """Run one op on this rank's shard, sent to the followers first
        under a mesh."""
        if self.mesh is None:
            return self._shard.run(op)
        with self._dist_lock:
            send_pending_closes()
            self._channel.broadcast_obj({"cmd": "serve_op", "key": self._key,
                                         "op": op})
            return self._shard.run(op)

    def _close_mesh(self) -> None:
        """Release the followers' shards (once): the ``serve_close`` is
        queued, then sent if the ranks' lock frees within
        ``CLOSE_WAIT_S``. A longer holder (a job over the ranks, a model
        loading onto the mesh) sends it before it lets the lock go."""
        with self._cond:
            if not self._mesh_open:
                return
            self._mesh_open = False
        with _closes_lock:
            _pending_closes.append(self._key)
        if not self._dist_lock.acquire(timeout=CLOSE_WAIT_S):
            log.info("%s: the ranks are busy; the followers release the "
                     "shard when the ranks' lock is let go", self.name)
            return
        try:
            send_pending_closes()
        except Exception:
            log.exception("%s: releasing the followers failed", self.name)
        finally:
            self._dist_lock.release()

    def close(self) -> None:
        super().close()
        self._close_mesh()

    def retire(self) -> None:
        super().retire()
        with self._cond:
            idle = self._thread is None
        if idle:  # no engine thread will exit to release the followers
            self._close_mesh()

    # --- engine loop ---

    def _loop(self) -> None:
        try:
            self._serve()
        finally:
            self._close_mesh()

    def _serve(self) -> None:
        while True:
            self._sweep_expired()
            with self._cond:
                while (not self._closed and not self._pending
                       and not self._busy()):
                    if self._retired:
                        self._shard.cache = None  # free the stripes
                        return
                    self._cond.wait()
                if self._closed:
                    return
                admits = []
                while self._free and self._pending:
                    row = self._pending.popleft()
                    if row.canceled:
                        continue
                    row.slot = self._free.pop(0)
                    self._slot_rows[row.slot] = row
                    admits.append(row)
            try:
                with torch.inference_mode():
                    for group in self._group_admits(admits):
                        self._prefill(group)
                    self._evict_canceled()
                    size = self._chunk_size()
                    if size:
                        self._decode_chunk(size)
            except Exception as e:
                log.exception("%s: decode loop failed", self.name)
                self._fail_all(e, wrap=True)
                with self._cond:
                    if self._closed or self.mesh is not None:
                        # over a mesh the ranks may be out of step: close,
                        # the parameter server builds a new decoder
                        self._closed = True
                        return
                try:
                    self._shard.reset()
                except Exception:
                    with self._cond:
                        self._closed = True
                    return

    def _group_admits(self, admits: List[_Row]) -> List[List[_Row]]:
        """One prefill forward per prompt-length bucket."""
        groups: Dict[int, List[_Row]] = {}
        for row in admits:
            groups.setdefault(_pow2_bucket(max(len(row.prompt), 1),
                                           _BUCKET_MIN, self.max_len),
                              []).append(row)
        return list(groups.values())

    def _prefill(self, group: List[_Row]) -> None:
        """Prefill the group's prompts in one forward (see
        :meth:`DenseShard.prefill`), emit each row's first token."""
        t0 = time.monotonic()
        stalled = self._stalled_rows()
        for r in group:
            self._mark_slotted(r)
        k = len(group)
        plens = [len(r.prompt) for r in group]
        bucket = _pow2_bucket(max(plens), _BUCKET_MIN, self.max_len)
        tokens = np.zeros((k, bucket), np.int64)
        for i, r in enumerate(group):
            tokens[i, :plens[i]] = r.prompt
        firsts = self._run(dict(
            op="prefill", tokens=tokens.tolist(), plens=plens,
            slots=[r.slot for r in group], temp=[r.temp for r in group],
            topk=[r.topk for r in group],
            seeds=[r.gen_seed if r.temp > 0 else None for r in group]))
        for r in group:
            r.gen = self._shard.generator(r.slot)
        self._charge_stall(stalled, time.monotonic() - t0)
        self._warmed = True
        self.stats.admitted_wave()
        self.stats.admit_tokens(sum(plens), k * bucket - sum(plens))
        self.stats.kv_read(k * bucket * self._kv_token_bytes)
        now = time.monotonic()
        for r, tok in zip(group, firsts):
            if r.canceled:
                continue
            self.stats.phase("prefill", now - r.slot_at)
            r.out.append(int(tok))
            self._consumed(r)
            self._emit_delta(r, [int(tok)])
            if (r.eos >= 0 and tok == r.eos) or r.max_new <= 1:
                self._complete_row(r)

    def _chunk_size(self) -> int:
        """The longest chunk that the longest row's remaining work fills
        (else the shortest); under queue pressure the shortest chunk that
        covers the earliest completion, so its slot frees at the next
        chunk edge (JAX ``_dispatch_chunk``). 0 = no row needs a step."""
        rem = [r.max_new - len(r.out) for r in self._decode_rows()]
        rem = [n for n in rem if n > 0]
        if not rem:
            return 0
        size = self._chunk_sizes[0]
        for t in self._chunk_sizes:
            if t <= max(rem):
                size = t
        with self._cond:
            pressure = bool(self._pending)
        if pressure and len(self._chunk_sizes) > 1:
            soonest = min(rem)
            size = min([size] + [t for t in self._chunk_sizes
                                 if t >= soonest][:1])
        return size

    def _decode_chunk(self, size: int) -> None:
        """Advance every slot ``size`` tokens (see
        :meth:`DenseShard.decode`); the per-slot slab comes from the rows
        at the chunk's start, empty slots dead and greedy."""
        t0 = time.monotonic()
        rows = [r if r is not None and not r.done and not r.canceled
                else None for r in self._slot_rows]
        keys = self._shard.gen_keys(list(range(self.slots)))
        packed = self._run(dict(
            op="decode", size=size,
            tok=[r.out[-1] if r else 0 for r in rows],
            pos=[len(r.prompt) + len(r.out) - 1 if r else 0 for r in rows],
            rem=[r.max_new - len(r.out) if r else 0 for r in rows],
            eos=[r.eos if r else -1 for r in rows],
            temp=[r.temp if r else 0.0 for r in rows],
            topk=[r.topk if r else 0 for r in rows],
            gens=[key if r else None for r, key in zip(rows, keys)]))
        wall = time.monotonic() - t0
        self._warmed = True
        self.stats.chunk()
        self.stats.chunk_fetched(wall, size)
        self.stats.kv_read(size * self.slots * self.max_len
                           * self._kv_token_bytes, wall)
        self._occupancy(size, 1, int((packed >= 0).sum()))
        resident = [(r, p) for r, p in zip(rows, packed) if r is not None]
        self._route([r for r, _ in resident],
                    np.stack([p for _, p in resident]))


# the serve_close keys of meshed decoders closed while the ranks' lock was
# held (see BatchingDecoder._close_mesh), sent by the next holder
_pending_closes: List[str] = []
_closes_lock = threading.Lock()

# how long a close waits for the ranks' lock before it leaves its
# serve_close to the holder
CLOSE_WAIT_S = 5.0


def send_pending_closes() -> None:
    """Send the followers the ``serve_close`` of every meshed decoder
    whose close found the ranks' lock held. The caller holds that lock;
    a holder that may keep it longer than ``CLOSE_WAIT_S`` calls this
    before it lets go, so no close is lost."""
    with _closes_lock:
        keys = list(_pending_closes)
        _pending_closes.clear()
    if not keys:
        return
    from ..parallel.distributed import get_dist_context

    channel = get_dist_context()
    for key in keys:
        channel.broadcast_obj({"cmd": "serve_close", "key": key})


class ServingFollower:
    """A follower rank's side of meshed serving: the module the leader
    announced last (``pending``: a module and its mesh) and the shards of
    the leader's decoders, keyed by decoder. :meth:`handle` runs the
    leader's ``serve_init`` (a :class:`DenseShard` over the pending
    module, with the decoder's knobs), ``serve_op`` and ``serve_close``;
    a rank outside the mesh holds nothing and skips them. A fault while
    handling an op is one-sided (the leader waits in a collective): the
    caller ends the process."""

    def __init__(self):
        self.pending = None
        self.shards: Dict[str, DenseShard] = {}

    def handle(self, cmd: dict) -> None:
        what, key = cmd.get("cmd"), cmd.get("key")
        if what == "serve_init":
            if self.pending is None:
                return  # not a rank of the mesh
            module, mesh = self.pending
            self.pending = None
            self.shards[key] = DenseShard(module, mesh=mesh,
                                          **cmd["knobs"])
        elif what == "serve_op":
            shard = self.shards.get(key)
            if shard is not None:
                shard.run(cmd["op"])
        elif what == "serve_close":
            self.shards.pop(key, None)
        else:
            raise ValueError(f"not a serving command: {what!r}")


def serve_follower(module, mesh) -> int:
    """Follow rank 0's ``BatchingDecoder(module, mesh=mesh)`` on a rank of
    the mesh: the same model (built whole, or placed on ``mesh``), its
    ``serve_init``, then every op until its ``serve_close``. Returns the
    ops run. Every rank of the process group calls it (a rank outside the
    mesh reads the commands and runs none)."""
    from ..parallel.distributed import get_dist_context

    channel = get_dist_context()
    follower = ServingFollower()
    follower.pending = (module, mesh) if mesh.member else None
    ops, key = 0, None
    while True:
        cmd = channel.broadcast_obj(None)
        if key is None and cmd.get("cmd") == "serve_init":
            key = cmd["key"]
        follower.handle(cmd)
        if cmd.get("key") != key:
            continue
        if cmd.get("cmd") == "serve_op":
            ops += 1
        elif cmd.get("cmd") == "serve_close":
            return ops
