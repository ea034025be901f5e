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

Sampling is per row with runtime knobs (temperature, top-k, eos): greedy
rows take the argmax; sampled rows draw from their own
``torch.Generator``, seeded from the request's ``seed`` and the row index,
so a request's stream does not depend on what it was batched with.

Differences from the JAX engine, by design of eager PyTorch: there are no
compiled shape buckets, so rows are not padded to ``slots`` and each chunk
runs only the resident rows; one chunk is in flight at a time (the engine
reads a chunk's tokens back with one copy at its end), so no fetch pool or
pre-freeing is needed. Left for later (ROADMAP): the dense
``BatchingDecoder``, speculative decoding, chunked prefill, KMS1
snapshots, drain and fault replay, the pool audit, and meshes.
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
                                 _masked_scaled, init_paged_cache,
                                 supports_paged_decode)
from ..models.layers import QuantizableDense, load_tree
from ..ops.int8_matmul import resolve_int8_matmul
from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from ..utils.device import resolve_device
from .kvpool import KVPool
from .quant import dequantize_tree, quantize_tree

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


def _seed_for(seed: int, index: int) -> int:
    """A distinct generator seed per (request seed, row index)."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63)


def _sample_rows(logits, temp, topk, gens, hot):
    """One next-token draw per row with per-row knobs. logits ``[S, V]`` f32,
    temp ``[S]`` f32, topk ``[S]`` int (0 = off); ``hot`` lists the rows
    that sample (temperature > 0), each drawing from its own generator in
    ``gens``; every other row takes the argmax."""
    out = torch.argmax(logits, dim=-1)
    if hot:
        idx = torch.tensor(hot, device=logits.device)
        probs = torch.softmax(
            _masked_scaled(logits[idx], temp[idx], topk[idx], TOP_K_MAX),
            dim=-1)
        drawn = [torch.multinomial(probs[i], 1, generator=gens[r])
                 for i, r in enumerate(hot)]
        out[idx] = torch.cat(drawn)
    return out


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
    gen: Optional[torch.Generator] = None  # sampled rows only
    out: List[int] = field(default_factory=list)
    done: bool = False
    canceled: bool = False
    lease: Optional[object] = None  # kvpool.PageLease while pages are held
    prefix_cached: int = 0          # prompt tokens served from the trie
    slot: int = -1


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
                                            for r in self.rows)}


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
    """

    def __init__(self, module, *, slots: int = DEFAULT_SLOTS,
                 chunk_steps: int = 16, page_tokens: int = 16,
                 pages: int = 0, prefix_cache: bool = True,
                 paged_attn: str = "auto", kv_quant: str = "off",
                 quantize: str = "", int8_matmul: bool = False,
                 int8_matmul_impl: str = "auto", queue_limit: int = 256,
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
        pre_quantized = any(isinstance(m, QuantizableDense) and m.quantized
                            for m in module.modules())
        if pre_quantized and quantize != "int8":
            raise ValueError("module carries int8 kernels but quantize is "
                             "not 'int8'")
        self.module = module.eval()
        self.max_len = int(module.max_len)
        self.slots = int(slots)
        self.chunk_steps = int(chunk_steps)
        self.queue_limit = int(queue_limit)
        self.name = name
        # a module that already holds int8 kernels runs them natively
        self.int8_matmul = quantize == "int8" and (bool(int8_matmul)
                                                   or pre_quantized)
        self.int8_matmul_impl = resolve_int8_matmul(int8_matmul_impl,
                                                    self.device)
        if quantize == "int8" and not pre_quantized:
            tree = quantize_tree(module.state_dict())
            if self.int8_matmul:
                load_tree(module, tree, int8_impl=self.int8_matmul_impl)
            else:
                # the dequantize path: dense weights holding q * s
                load_tree(module, dequantize_tree(tree, torch.float32))
        elif pre_quantized:
            for m in module.modules():
                if isinstance(m, QuantizableDense):
                    m.int8_impl = self.int8_matmul_impl

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
        # chunk ladder: every power of two below chunk_steps, and
        # chunk_steps itself, so a chunk can end at any completion
        ladder = {self.chunk_steps}
        t = 1
        while t < self.chunk_steps:
            ladder.add(t)
            t *= 2
        self._chunk_sizes = sorted(ladder)

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
             "prefix_tokens_saved"), 0.0)

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
            gen = None
            if req.temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(_seed_for(req.seed, i))
            entry.rows.append(_Row(
                entry=entry, index=i,
                prompt=prompts[i, :lens[i]].astype(np.int32),
                max_new=req.max_new_tokens, temp=float(req.temperature),
                topk=int(req.top_k or 0),
                eos=int(req.eos_id) if req.eos_id is not None else -1,
                gen=gen))
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
                                    max_positions=self.max_len):
            need = self._pool.pages_for(self._pool.total_positions(
                plen, max_new, self.max_len))
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
                    for group in self._group_admits(admits):
                        self._prefill(group)
                    self._evict_canceled()
                    size = self._chunk_size()
                    if size:
                        self._decode_chunk(size)
                if not admits and not size:
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

    def _take_admissions_locked(self) -> List[_Row]:
        """Admit queued rows FIFO while a slot is free AND the page budget
        covers them (worst case: prompt + max_new - 1 positions, minus what
        the prefix trie already holds). The head of the line blocks the
        tail."""
        admits = []
        while self._pending and self._free:
            row = self._pending[0]
            if row.canceled:
                self._pending.popleft()
                continue
            lease = self._pool.admit(row.prompt, row.max_new,
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
        """Group by unshared-suffix length bucket: one prefill forward per
        bucket."""
        groups: Dict[int, List[_Row]] = {}
        for row in admits:
            sfx = max(len(row.prompt) - row.lease.prefix_tokens, 1)
            groups.setdefault(_pow2_bucket(sfx, _BUCKET_MIN, self.max_len),
                              []).append(row)
        return list(groups.values())

    def _knobs(self, rows: List[_Row]):
        dev = self.device
        temp = torch.tensor([r.temp for r in rows], dtype=torch.float32,
                            device=dev)
        topk = torch.tensor([r.topk for r in rows], dtype=torch.int64,
                            device=dev)
        hot = [i for i, r in enumerate(rows) if r.temp > 0]
        return temp, topk, [r.gen for r in rows], hot

    def _prefill(self, group: List[_Row]) -> None:
        """Prefill the group's unshared suffixes in one forward straight
        into the arena, sample each row's first token, and register the
        full prompt blocks in the prefix trie for later sharers."""
        t0 = time.monotonic()
        pt = self.page_tokens
        k = len(group)
        suffixes = [r.prompt[r.lease.prefix_tokens:] for r in group]
        width = max(len(s) for s in suffixes)
        tw = min(self.table_pages,
                 max(-(-len(r.prompt) // pt) for r in group))
        tokens = np.zeros((k, width), np.int64)
        table = np.zeros((k, tw), np.int32)
        for i, (r, sfx) in enumerate(zip(group, suffixes)):
            tokens[i, :len(sfx)] = sfx
            pgs = r.lease.pages[:tw]
            table[i, :len(pgs)] = pgs
        dev = self.device
        base = torch.tensor([r.lease.prefix_tokens for r in group],
                            dtype=torch.int32, device=dev)
        slens = torch.tensor([len(s) for s in suffixes], dtype=torch.int64,
                             device=dev)
        hidden = self.module(torch.from_numpy(tokens).to(dev), decode=True,
                             return_hidden=True, positions=base,
                             pages=torch.from_numpy(table).to(dev),
                             seq_lens=slens, cache=self.cache)
        # logits only at each row's last real prompt token
        last = hidden[torch.arange(k, device=dev), slens - 1]
        logits = self.module.lm_head(last).float()
        firsts = _sample_rows(logits, *self._knobs(group)).tolist()
        for r in group:
            self._pool.register_prefix(r.prompt, r.lease)
        with self._cond:
            self._stats["prefill_waves"] += 1
            self._stats["prefill_tokens"] += float(sum(map(len, suffixes)))
            self._stats["prefill_seconds"] += time.monotonic() - t0
        for r, tok in zip(group, firsts):
            if r.canceled:
                continue
            r.out.append(int(tok))
            self._emit_delta(r, [int(tok)])
            if (r.eos >= 0 and tok == r.eos) or r.max_new <= 1:
                self._complete_row(r)

    def _chunk_size(self) -> int:
        """The largest ladder chunk that ends at or before the earliest
        completion of a resident row (0 = no row needs a step)."""
        rem = [r.max_new - len(r.out) for r in self._slot_rows
               if r is not None and not r.done and not r.canceled]
        rem = [n for n in rem if n > 0]
        if not rem:
            return 0
        soonest = min(rem)
        return max(t for t in self._chunk_sizes if t <= soonest)

    def _decode_chunk(self, size: int) -> None:
        """Advance every resident row ``size`` tokens; rows that hit their
        eos mid-chunk freeze (feed their last token at their last position,
        rewriting identical K/V) and emit nothing more."""
        t0 = time.monotonic()
        rows = [r for r in self._slot_rows
                if r is not None and not r.done and not r.canceled]
        pt = self.page_tokens
        dev = self.device
        pos0 = [len(r.prompt) + len(r.out) - 1 for r in rows]
        # the table covers every position the chunk writes, capped at each
        # row's lease (positions past it were trash-bound anyway)
        tw = max(min(-(-(p + size) // pt), len(r.lease.pages))
                 for p, r in zip(pos0, rows))
        table = np.zeros((len(rows), tw), np.int32)
        for i, r in enumerate(rows):
            pgs = r.lease.pages[:tw]
            table[i, :len(pgs)] = pgs
        table = torch.from_numpy(table).to(dev)
        tok = torch.tensor([r.out[-1] for r in rows], dtype=torch.int64,
                           device=dev)
        pos = torch.tensor(pos0, dtype=torch.int32, device=dev)
        remaining = torch.tensor([r.max_new - len(r.out) for r in rows],
                                 dtype=torch.int32, device=dev)
        eos = torch.tensor([r.eos for r in rows], dtype=torch.int64,
                           device=dev)
        live = torch.ones(len(rows), dtype=torch.bool, device=dev)
        knobs = self._knobs(rows)
        out = torch.empty((size, len(rows)), dtype=torch.int64, device=dev)
        for t in range(size):
            logits = self.module(tok[:, None], decode=True, positions=pos,
                                 pages=table, cache=self.cache)[:, -1]
            nxt = _sample_rows(logits, *knobs)
            was_live = live
            remaining = remaining - was_live.int()
            live = was_live & ~((eos >= 0) & (nxt == eos)) & (remaining > 0)
            out[t] = torch.where(was_live, nxt, torch.full_like(nxt, -1))
            tok = torch.where(live, nxt, tok)
            pos = torch.where(live, pos + 1, pos)
        packed = out.cpu().numpy()  # the chunk's one device->host copy
        with self._cond:
            self._stats["decode_chunks"] += 1
            self._stats["decode_steps"] += size
            self._stats["decode_row_steps"] += size * len(rows)
            self._stats["decode_seconds"] += time.monotonic() - t0
        for i, r in enumerate(rows):
            fresh = []
            for t in range(size):
                tok_i = int(packed[t, i])
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
        for r in self._slot_rows:
            if r is not None and r.canceled and not r.done:
                r.done = True
                self._release_row(r)

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
