"""Serving telemetry of one paged decoder, port of
``kubeml_tpu/serving/stats.py::DecoderStats``.

One ``DecoderStats`` per decoder: counters bumped on the engine and submit
threads (lock-guarded, O(1) an event) under the JAX engine's names, so the
two engines' host-side accounting compares key by key. Beyond the request
outcome and token counters it keeps:

* request lifecycle phases (queue wait, prefill, decode, slot idle), one
  histogram observation per row;
* batch occupancy per device step: live (a token emitted), dead (a
  resident row that emitted nothing) and idle (no row) slot-steps, whose
  sum is steps x capacity for every chunk;
* head-of-line stall, chunked prefill, speculative decoding, KMS1
  snapshot and pool-audit counters.

Latency quantiles come from bounded rings of recent requests; the windowed
tokens/s and 429 rates from cumulative-sample rings. The port's own copies
of ``ps/metrics.Histogram`` (with its bucket edges) and
``utils/timeseries.Series`` are private to this module. The JAX engine's
fetch-pool and compile-tracker series are reported under their names as
0: the eager engine has no fetch pool and compiles no programs.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# ring sizes: enough for a stable p95 under load, bounded for a resident
# server
LATENCY_RING = 512
RATE_WINDOW_S = 10.0
# samples the windowed-rate rings keep (one a token emission or 429)
RATE_RING = 4096

# histogram bucket edges (``kubeml_tpu/ps/metrics.py``)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     0.9375, 1.0)
BANDWIDTH_BUCKETS = (1e6, 3e6, 1e7, 3e7, 1e8, 3e8, 1e9, 3e9, 1e10, 3e10,
                     1e11, 3e11, 1e12)
SNAPSHOT_BYTES_BUCKETS = (1e3, 1e4, 1e5, 3e5, 1e6, 3e6, 1e7, 3e7, 1e8,
                          3e8, 1e9)


class Histogram:
    """Fixed-edge cumulative histogram (the Prometheus convention); the
    owner's lock guards it."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * len(self.buckets)  # per edge, not cumulative
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        idx = bisect_left(self.buckets, v)
        if idx < len(self.counts):
            self.counts[idx] += 1

    def snapshot(self) -> dict:
        """``{"buckets": [[le, cumulative count], ...], "sum", "count"}``;
        +Inf is ``count``."""
        out, total = [], 0
        for edge, c in zip(self.buckets, self.counts):
            total += c
            out.append([edge, total])
        return {"buckets": out, "sum": self.sum, "count": self.count}


class Series:
    """A bounded ring of ``(t, cumulative value)`` samples of one counter,
    queried for its increase and rate over a trailing window."""

    __slots__ = ("_samples", "_lock")

    def __init__(self, capacity: int = RATE_RING):
        self._samples: "deque[Tuple[float, float]]" = deque(
            maxlen=max(2, int(capacity)))
        self._lock = threading.Lock()

    def observe(self, value: float, t: float) -> None:
        with self._lock:
            self._samples.append((float(t), float(value)))

    def _snap(self) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._samples)

    def increase(self, window: float, now: float) -> float:
        """The sum of positive steps in ``[now - window, now]``, anchored at
        the last sample at or before the window start (a negative step is
        a reset, and its new value counts)."""
        cut = now - float(window)
        base, inc, prev = None, 0.0, None
        for t, v in self._snap():
            if t <= cut:
                base = v
                continue
            if prev is None:
                prev = base if base is not None else v
            d = v - prev
            inc += d if d >= 0 else v
            prev = v
        return inc

    def rate(self, window: float, now: float,
             span: Optional[str] = None) -> float:
        """``increase / window``; ``span="elapsed"`` divides by the time
        the window's samples actually cover (a fresh burst reads as its
        burst rate)."""
        inc = self.increase(window, now)
        if span == "elapsed":
            inside = [s for s in self._snap() if s[0] >= now - window]
            if not inside:
                return 0.0
            denom = max(now - inside[0][0], 1e-3)
        else:
            denom = max(float(window), 1e-3)
        return inc / denom


class DecoderStats:
    """Thread-safe counters and gauges for one resident decoder."""

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._lock = threading.Lock()
        self.requests_submitted = 0   # requests accepted into the queue
        self.requests_completed = 0   # requests that returned a full result
        self.requests_rejected = 0    # validation 400s (never enqueued)
        self.requests_timeout = 0     # waiter gave up (504); rows canceled
        self.requests_canceled = 0    # abandoned by explicit cancel
        self.requests_failed = 0      # engine-side failure surfaced
        # overload protection (admission limit, shed, deadlines)
        self.requests_overload = 0    # 429-refused at admission
        self.requests_shed = 0        # shed oldest-first after queueing
        self.requests_deadline_expired = 0  # expired while queued (504)
        self.tokens_emitted = 0
        self.admission_waves = 0      # prefill forwards that admit rows
        self.chunks = 0               # decode chunks and spec steps
        # occupancy and goodput, per device step
        self.device_steps = 0         # decode steps run (a spec step is 1)
        self.slot_steps = 0           # steps x capacity: raw device room
        self.live_slot_steps = 0      # slot-steps that emitted a token
        self.dead_slot_steps = 0      # resident row, no emission (waste)
        self.idle_slot_steps = 0      # no resident row (free capacity)
        self.prefill_tokens = 0       # real prompt tokens prefilled
        self.prefill_pad_tokens = 0   # padding tokens the prefills computed
        self.goodput_tokens = 0       # tokens delivered to a live waiter
        self.wasted_tokens = 0        # tokens routed to an aborted request
        # shared-prefix reuse: admissions whose leading prompt blocks came
        # from the prefix trie, and the prompt tokens those pages covered
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # modeled bytes the attention forwards read from the KV arena
        self.kv_read_bytes = 0
        # speculative decoding: drafted = tokens the drafter sampled,
        # proposed = candidates verified (drafts + one bonus a live row),
        # accepted = drafts the acceptance rule kept
        self.spec_steps = 0
        self.spec_drafted_tokens = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        # head-of-line stall: wall seconds x decoding rows that waited
        # behind a prefill forward
        self.hol_stall_seconds = 0.0
        # chunked prefill: prefill forwards that were chunks of a long
        # prompt (the final admission chunk too), and their prompt tokens
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        # KMS1 snapshots: saved (fault or drain capture), restored
        # (scattered into fresh pages and resumed), replayed (re-admitted
        # after a fault rebuild), failed (either direction)
        self.snapshot_saved = 0
        self.snapshot_restored = 0
        self.snapshot_replayed = 0
        self.snapshot_failed = 0
        # KVPool invariant watchdog
        self.pool_audit_runs = 0
        self.pool_audit_failures = 0
        self._lat: deque = deque(maxlen=LATENCY_RING)
        self._first: deque = deque(maxlen=LATENCY_RING)
        self._itl: deque = deque(maxlen=LATENCY_RING)
        # cumulative samples seeded at 0: a counter's value before its
        # first event is known, so the first event counts toward the rate
        t0 = time.monotonic()
        self._emit_series = Series()
        self._overload_series = Series()
        self._emit_series.observe(0.0, t=t0)
        self._overload_series.observe(0.0, t=t0)
        self._hist_first = Histogram()
        self._hist_request = Histogram()
        self._hist_decode_step = Histogram()
        self._hist_itl = Histogram()
        # lifecycle phases: one observation a row
        self._hist_queue_wait = Histogram()
        self._hist_prefill = Histogram()
        self._hist_decode_active = Histogram()
        self._hist_slot_idle = Histogram()
        self._hist_occupancy = Histogram(OCCUPANCY_BUCKETS)
        self._hist_kv_bw = Histogram(BANDWIDTH_BUCKETS)
        self._hist_spec_accept = Histogram(OCCUPANCY_BUCKETS)
        self._hist_snap_bytes = Histogram(SNAPSHOT_BYTES_BUCKETS)
        self._hist_snap_seconds = Histogram()

    # --- event hooks (engine and submit threads) ---

    def submitted(self, rows: int) -> None:
        with self._lock:
            self.requests_submitted += rows

    def admitted_wave(self) -> None:
        with self._lock:
            self.admission_waves += 1

    def chunk(self) -> None:
        with self._lock:
            self.chunks += 1

    def chunk_occupancy(self, steps: int, live: int, dead: int,
                        idle: int, capacity: Optional[int] = None) -> None:
        """Slot accounting for one chunk: ``steps`` device steps over
        ``capacity`` rows (None: the constructor's slots), split into
        live, dead and idle slot-steps (their sum is steps x capacity)."""
        if steps <= 0:
            return
        total = steps * (capacity if capacity is not None else self.slots)
        with self._lock:
            self.device_steps += int(steps)
            self.slot_steps += total
            self.live_slot_steps += int(live)
            self.dead_slot_steps += int(dead)
            self.idle_slot_steps += int(idle)
            self._hist_occupancy.observe(live / total if total else 0.0)

    def spec_step(self, drafted: int, accepted: int, proposed: int) -> None:
        """One verified speculative step over its live rows."""
        if drafted <= 0:
            return
        with self._lock:
            self.spec_steps += 1
            self.spec_drafted_tokens += int(drafted)
            self.spec_accepted_tokens += int(accepted)
            self.spec_proposed_tokens += int(proposed)
            self._hist_spec_accept.observe(
                min(1.0, int(accepted) / int(drafted)))

    def kv_read(self, nbytes: int, seconds: float = 0.0) -> None:
        """One forward group's modeled KV-arena read bytes; with
        ``seconds`` (a decode chunk's wall) one bandwidth observation."""
        if nbytes <= 0:
            return
        with self._lock:
            self.kv_read_bytes += int(nbytes)
            if seconds > 0:
                self._hist_kv_bw.observe(nbytes / seconds)

    def prefix_hit(self, tokens_saved: int) -> None:
        with self._lock:
            self.prefix_hits += 1
            self.prefix_tokens_saved += int(tokens_saved)

    def admit_tokens(self, real: int, padding: int) -> None:
        """One prefill forward's ``real`` prompt tokens and the ``padding``
        tokens it computed beside them."""
        with self._lock:
            self.prefill_tokens += int(real)
            self.prefill_pad_tokens += int(padding)

    def chunk_fetched(self, seconds: float, steps: int) -> None:
        """A decode chunk's tokens reached the host ``seconds`` after it
        started, for ``steps`` steps: one per-step observation. (The JAX
        engine also files chunks that shared the device with a prefill
        and first-call compiles apart; the eager engine runs one forward
        at a time and compiles nothing.)"""
        if steps <= 0:
            return
        with self._lock:
            self._hist_decode_step.observe(float(seconds) / steps)

    def inter_token(self, gap_s: float) -> None:
        """The host-visible gap between two emissions of one row."""
        with self._lock:
            g = max(0.0, float(gap_s))
            self._itl.append(g)
            self._hist_itl.observe(g)

    def hol_stall(self, seconds: float, rows: int) -> None:
        """Charge a prefill forward's wall to the ``rows`` decoding rows
        it delayed: seconds x rows."""
        if rows <= 0 or seconds <= 0:
            return
        with self._lock:
            self.hol_stall_seconds += float(seconds) * int(rows)

    def prefill_chunk(self, rows: int, tokens: int) -> None:
        """One chunked-prefill forward advanced ``rows`` rows by ``tokens``
        prompt tokens in all."""
        if rows <= 0:
            return
        with self._lock:
            self.prefill_chunks += int(rows)
            self.prefill_chunk_tokens += int(tokens)

    def snapshot_save(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.snapshot_saved += 1
            self._hist_snap_bytes.observe(float(nbytes))
            self._hist_snap_seconds.observe(max(0.0, float(seconds)))

    def snapshot_restore(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.snapshot_restored += 1
            self._hist_snap_bytes.observe(float(nbytes))
            self._hist_snap_seconds.observe(max(0.0, float(seconds)))

    def snapshot_replay(self, rows: int) -> None:
        if rows <= 0:
            return
        with self._lock:
            self.snapshot_replayed += int(rows)

    def snapshot_fail(self, rows: int = 1) -> None:
        with self._lock:
            self.snapshot_failed += int(rows)

    def pool_audit(self, ok: bool) -> None:
        with self._lock:
            self.pool_audit_runs += 1
            if not ok:
                self.pool_audit_failures += 1

    def emitted(self, n: int, wasted: bool = False) -> None:
        """``n`` tokens routed to a request; ``wasted`` when its waiter
        already gave up."""
        now = time.monotonic()
        with self._lock:
            self.tokens_emitted += n
            if wasted:
                self.wasted_tokens += n
            else:
                self.goodput_tokens += n
            total = self.tokens_emitted
        self._emit_series.observe(total, t=now)

    def phase(self, name: str, seconds: float) -> None:
        """One lifecycle phase of a row: ``queue_wait``, ``prefill``,
        ``decode_active`` or ``slot_idle``."""
        h = {"queue_wait": self._hist_queue_wait,
             "prefill": self._hist_prefill,
             "decode_active": self._hist_decode_active,
             "slot_idle": self._hist_slot_idle}.get(name)
        if h is None:
            return
        with self._lock:
            h.observe(max(0.0, float(seconds)))

    def first_token(self, seconds: float) -> None:
        """Time to first token of one request."""
        with self._lock:
            self._first.append(float(seconds))
            self._hist_first.observe(float(seconds))

    def completed(self, latency_s: float) -> None:
        with self._lock:
            self.requests_completed += 1
            self._lat.append(float(latency_s))
            self._hist_request.observe(float(latency_s))

    def rejected(self) -> None:
        with self._lock:
            self.requests_rejected += 1

    def timed_out(self) -> None:
        with self._lock:
            self.requests_timeout += 1

    def canceled(self) -> None:
        with self._lock:
            self.requests_canceled += 1

    def overloaded(self) -> None:
        now = time.monotonic()
        with self._lock:
            self.requests_overload += 1
            total = self.requests_overload
        self._overload_series.observe(total, t=now)

    def shed(self) -> None:
        with self._lock:
            self.requests_shed += 1

    def deadline_expired(self) -> None:
        with self._lock:
            self.requests_deadline_expired += 1

    def failed(self, rows: int = 1) -> None:
        with self._lock:
            self.requests_failed += rows

    # --- reads ---

    def overload_per_second(self) -> float:
        """The 429 rate over the trailing window."""
        return self._overload_series.rate(RATE_WINDOW_S, time.monotonic())

    def tokens_per_second(self) -> float:
        """Tokens over the trailing window, divided by the span the
        window's samples cover."""
        return self._emit_series.rate(RATE_WINDOW_S, time.monotonic(),
                                      span="elapsed")

    @staticmethod
    def _quantile(values: List[float], q: float) -> Optional[float]:
        """Nearest-rank quantile; None for no values."""
        if not values:
            return None
        vs = sorted(values)
        return vs[min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))]

    def snapshot(self) -> Dict[str, float]:
        """One consistent read of every counter and gauge, the quantiles,
        and the histograms that saw an observation under ``"hist"``."""
        now = time.monotonic()
        with self._lock:
            lat, first, itl = list(self._lat), list(self._first), \
                list(self._itl)
            out = {
                "requests_submitted": float(self.requests_submitted),
                "requests_completed": float(self.requests_completed),
                "requests_rejected": float(self.requests_rejected),
                "requests_timeout": float(self.requests_timeout),
                "requests_canceled": float(self.requests_canceled),
                "requests_failed": float(self.requests_failed),
                "requests_overload": float(self.requests_overload),
                "requests_shed": float(self.requests_shed),
                "requests_deadline_expired": float(
                    self.requests_deadline_expired),
                "tokens_emitted": float(self.tokens_emitted),
                "admission_waves": float(self.admission_waves),
                "chunks": float(self.chunks),
                "device_steps": float(self.device_steps),
                "slot_steps": float(self.slot_steps),
                "live_slot_steps": float(self.live_slot_steps),
                "dead_slot_steps": float(self.dead_slot_steps),
                "idle_slot_steps": float(self.idle_slot_steps),
                "prefill_tokens": float(self.prefill_tokens),
                "prefill_pad_tokens": float(self.prefill_pad_tokens),
                "goodput_tokens": float(self.goodput_tokens),
                "wasted_tokens": float(self.wasted_tokens),
                "prefix_hits": float(self.prefix_hits),
                "prefix_tokens_saved": float(self.prefix_tokens_saved),
                "kv_read_bytes": float(self.kv_read_bytes),
                "goodput_ratio": (self.live_slot_steps / self.slot_steps
                                  if self.slot_steps else 0.0),
                # the JAX engine's result-fetch pool and XLA compile
                # tracker: the eager engine has neither
                "fetches": 0.0,
                "fetch_busy_seconds": 0.0,
                "fetchers_inflight": 0.0,
                "fetchers_total": 0.0,
                "fetcher_utilization": 0.0,
                "hol_stall_seconds": float(self.hol_stall_seconds),
                "prefill_chunks": float(self.prefill_chunks),
                "prefill_chunk_tokens": float(self.prefill_chunk_tokens),
                "compiled_programs": 0.0,
                "compiles_per_minute": 0.0,
                "compile_storm": 0.0,
            }
            # the recovery, audit and spec series exist once one of their
            # events ran (absence reads as "never happened")
            if (self.snapshot_saved or self.snapshot_restored
                    or self.snapshot_replayed or self.snapshot_failed):
                out["snapshot_saved"] = float(self.snapshot_saved)
                out["snapshot_restored"] = float(self.snapshot_restored)
                out["snapshot_replayed"] = float(self.snapshot_replayed)
                out["snapshot_failed"] = float(self.snapshot_failed)
            if self.pool_audit_runs:
                out["pool_audit_runs"] = float(self.pool_audit_runs)
                out["pool_audit_failures"] = float(self.pool_audit_failures)
            if self.spec_steps:
                out["spec_steps"] = float(self.spec_steps)
                out["spec_drafted_tokens"] = float(self.spec_drafted_tokens)
                out["spec_proposed_tokens"] = float(self.spec_proposed_tokens)
                out["spec_accepted_tokens"] = float(self.spec_accepted_tokens)
                out["spec_accept_rate"] = (
                    self.spec_accepted_tokens / self.spec_drafted_tokens
                    if self.spec_drafted_tokens else 0.0)
            hist = {}
            for key, h in (("first_token", self._hist_first),
                           ("request", self._hist_request),
                           ("decode_step", self._hist_decode_step),
                           ("inter_token", self._hist_itl),
                           ("queue_wait", self._hist_queue_wait),
                           ("prefill", self._hist_prefill),
                           ("decode_active", self._hist_decode_active),
                           ("slot_idle", self._hist_slot_idle),
                           ("occupancy_ratio", self._hist_occupancy),
                           ("kv_bandwidth", self._hist_kv_bw),
                           ("spec_accept_ratio", self._hist_spec_accept),
                           ("snapshot_bytes", self._hist_snap_bytes),
                           ("snapshot_seconds", self._hist_snap_seconds)):
                if h.count:
                    hist[key] = h.snapshot()
        if hist:
            out["hist"] = hist
        out["tokens_per_second"] = self.tokens_per_second()
        out["overload_per_second"] = self.overload_per_second()
        for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"),
                        (1.0, "max")):
            for key, values in (("latency", lat), ("first_token", first),
                                ("itl", itl)):
                v = self._quantile(values, q)
                if v is not None:
                    out[f"{key}_{name}_seconds"] = v
        return out
