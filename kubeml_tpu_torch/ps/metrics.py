"""Prometheus exposition of the parameter server: the port of
``kubeml_tpu/ps/metrics.py``'s ``MetricsRegistry``.

* the training series: per-job gauges labeled ``jobid`` (losses,
  accuracy, parallelism, epoch, epoch seconds), updated by each epoch's
  :class:`~kubeml_tpu_torch.api.types.MetricUpdate` and cleared when the
  job finishes, and per-job histograms (epoch, round and merge seconds,
  worker divergence, loss spread, round skew), which outlive the job up
  to ``MAX_HISTOGRAM_JOBS`` jobs a metric;
* the running-task gauge ``kubeml_job_running_total{type}``, the
  preemption counter and yield-latency histogram, the scheduler's queue
  depth per priority and its scale-decision counters (read from sources
  the scheduler binds);
* the per-model serving counters, gauges and histograms, rendered from
  the resident decoders' ``telemetry()`` snapshots
  (``serving.stats.DecoderStats``).

Every series goes by the JAX package's name and labels. HELP/TYPE
headers render even with no series, so the exported metric set does not
depend on traffic. The data-plane counters (``utils.profiler``) render
last; a standalone runner's counter deltas arrive as sequenced batches in
its ``MetricUpdate.dataplane`` and are folded in at most once each (the
job's sequence high-water mark, JAX :532-625). Not ported: the SLO series
and the resilience counters.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.types import MetricUpdate

GAUGES = {
    "kubeml_job_validation_loss": "Validation loss of a train job",
    "kubeml_job_validation_accuracy": "Validation accuracy of a train job",
    "kubeml_job_train_loss": "Train loss of a train job",
    "kubeml_job_parallelism": "Parallelism of a train job",
    "kubeml_job_epoch_duration_seconds": "Duration of the last epoch",
    "kubeml_job_epoch": "Epochs reported by a train job since it started",
    "kubeml_job_moe_overflow": "MoE expert-capacity overflow rate",
}
RUNNING = "kubeml_job_running_total"
SCALE_DECISIONS = "kubeml_scale_decisions_total"
PREEMPTIONS = "kubeml_preemptions_total"
YIELD_SECONDS = "kubeml_preempt_yield_seconds"
QUEUE_DEPTH = "kubeml_scheduler_queue_depth"
# distinct preemption reasons kept (more fold into "other")
MAX_PREEMPT_REASONS = 16

# bucket edges in seconds; +Inf is implicit
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
RATIO_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001, 0.0025,
                 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
SKEW_BUCKETS = (1.0, 1.1, 1.25, 1.5, 2.0, 3.0, 5.0, 10.0, 25.0, 100.0)

# per-job histograms, fed from MetricUpdate
HISTOGRAMS = {
    "kubeml_job_epoch_seconds": "Epoch wall-time distribution of a train job",
    "kubeml_job_round_seconds": (
        "Per-sync-round wall time (the function/update latency)"),
    "kubeml_job_merge_seconds": (
        "Epoch-end merge/loss sync wall time (the on-chip K-AVG merge is "
        "awaited here)"),
    "kubeml_job_worker_divergence": (
        "Pre-merge worker weight divergence per K-AVG round (norm of the "
        "stacked worker vars minus their mean, over the mean's norm)"),
    "kubeml_job_loss_spread": (
        "Worker-loss spread per K-AVG round (max - min over effective "
        "participants)"),
    "kubeml_job_round_skew_ratio": (
        "Per-epoch round-time skew (max/median over the epoch's rounds — "
        "the straggler signal)"),
}
HISTOGRAM_BUCKETS = {
    "kubeml_job_worker_divergence": RATIO_BUCKETS,
    "kubeml_job_loss_spread": RATIO_BUCKETS,
    "kubeml_job_round_skew_ratio": SKEW_BUCKETS,
}
MAX_HISTOGRAM_JOBS = 32

# metric -> (telemetry key, help); counters end in _total
SERVING_COUNTERS = {
    "kubeml_serving_tokens_total": (
        "tokens_emitted", "Tokens emitted by the decode engine"),
    "kubeml_serving_requests_submitted_total": (
        "requests_submitted", "Generate requests accepted into the queue"),
    "kubeml_serving_requests_completed_total": (
        "requests_completed", "Generate requests fully served"),
    "kubeml_serving_requests_rejected_total": (
        "requests_rejected", "Generate requests rejected at validation"),
    "kubeml_serving_requests_timeout_total": (
        "requests_timeout", "Generate requests abandoned on waiter timeout"),
    "kubeml_serving_requests_canceled_total": (
        "requests_canceled", "Generate requests explicitly canceled"),
    "kubeml_serving_requests_failed_total": (
        "requests_failed", "Generate requests failed by an engine fault"),
    "kubeml_serving_requests_overload_total": (
        "requests_overload",
        "Generate requests refused 429 at the queue limit"),
    "kubeml_serving_requests_shed_total": (
        "requests_shed", "Queued generate requests shed oldest-first"),
    "kubeml_serving_deadline_expired_total": (
        "requests_deadline_expired",
        "Queued generate requests failed on an expired deadline"),
    "kubeml_serving_admission_waves_total": (
        "admission_waves", "Batched prefill+admit forwards"),
    "kubeml_serving_chunks_total": ("chunks", "Decode chunks run"),
    "kubeml_serving_fetches_total": (
        "fetches",
        "Device result fetches of the fetch pool (0: the eager engine has "
        "none)"),
    "kubeml_serving_fetch_busy_seconds_total": (
        "fetch_busy_seconds",
        "Seconds fetch threads spent blocked on results"),
    "kubeml_serving_device_steps_total": (
        "device_steps", "Decode steps run on the device"),
    "kubeml_serving_occupancy_slot_steps_total": (
        "slot_steps", "Slot-step capacity spent (steps x slots a chunk)"),
    "kubeml_serving_occupancy_live_steps_total": (
        "live_slot_steps", "Slot-steps that emitted a token"),
    "kubeml_serving_occupancy_dead_steps_total": (
        "dead_slot_steps",
        "Slot-steps of a resident row that emitted nothing"),
    "kubeml_serving_occupancy_idle_steps_total": (
        "idle_slot_steps", "Slot-steps with no resident row"),
    "kubeml_serving_prefill_tokens_total": (
        "prefill_tokens", "Real prompt tokens prefilled at admission"),
    "kubeml_serving_prefill_pad_tokens_total": (
        "prefill_pad_tokens", "Padding tokens computed at admission"),
    "kubeml_serving_goodput_tokens_total": (
        "goodput_tokens", "Tokens delivered to a live waiter"),
    "kubeml_serving_wasted_tokens_total": (
        "wasted_tokens", "Tokens routed to a request whose waiter gave up"),
    "kubeml_serving_kv_read_bytes_total": (
        "kv_read_bytes",
        "KV-cache bytes the decode attention read (host-modeled)"),
    "kubeml_serving_prefix_hits_total": (
        "prefix_hits",
        "Admissions served leading blocks from the prefix cache"),
    "kubeml_serving_prefix_tokens_saved_total": (
        "prefix_tokens_saved",
        "Prompt tokens whose prefill the prefix cache saved"),
    "kubeml_serving_spec_drafted_tokens_total": (
        "spec_drafted_tokens", "Tokens the speculative drafter sampled"),
    "kubeml_serving_spec_proposed_tokens_total": (
        "spec_proposed_tokens",
        "Candidate emissions submitted to verification"),
    "kubeml_serving_spec_accepted_tokens_total": (
        "spec_accepted_tokens", "Drafted tokens the acceptance rule kept"),
    "kubeml_serving_spec_steps_total": (
        "spec_steps", "Speculative verify steps"),
    "kubeml_serving_hol_stall_seconds_total": (
        "hol_stall_seconds",
        "Decode-seconds live rows lost behind prefill work"),
    "kubeml_serving_prefill_chunks_total": (
        "prefill_chunks", "Per-row chunked-prefill dispatches"),
    "kubeml_serving_prefill_chunk_tokens_total": (
        "prefill_chunk_tokens", "Prompt tokens prefilled in chunks"),
    "kubeml_serving_snapshot_saved_total": (
        "snapshot_saved", "Live-request KV snapshots captured"),
    "kubeml_serving_snapshot_restored_total": (
        "snapshot_restored", "KV snapshots restored mid-stream"),
    "kubeml_serving_snapshot_replayed_total": (
        "snapshot_replayed", "Rows re-admitted after a fault rebuild"),
    "kubeml_serving_snapshot_failed_total": (
        "snapshot_failed", "Snapshot or restore attempts that failed"),
    "kubeml_serving_pool_audit_runs_total": (
        "pool_audit_runs", "Periodic page-pool audits run"),
    "kubeml_serving_pool_audit_failures_total": (
        "pool_audit_failures",
        "Page-pool audits that found a broken invariant"),
}
SERVING_COMPILES = "kubeml_serving_compiles_total"
SERVING_COMPILES_HELP = "Programs compiled by the serving engine, by program"

SERVING_GAUGES = {
    "kubeml_serving_tokens_per_second": (
        "tokens_per_second", "Sustained decode rate (10s window)"),
    "kubeml_serving_queue_depth": (
        "queue_depth", "Rows waiting for a decode slot"),
    "kubeml_serving_overload_per_second": (
        "overload_per_second", "429 admission-refusal rate (10s window)"),
    "kubeml_serving_queue_limit": (
        "queue_limit", "Admission limit on queued rows (0 = unbounded)"),
    "kubeml_serving_slots_busy": ("slots_busy", "Occupied decode slots"),
    "kubeml_serving_slots_total": ("slots_total", "Configured decode slots"),
    "kubeml_serving_weight_bytes": (
        "weight_bytes", "Weight bytes read per decode step"),
    "kubeml_serving_slot_occupancy": (
        "slot_occupancy", "Busy fraction of decode slots"),
    "kubeml_serving_latency_p50_seconds": (
        "latency_p50_seconds", "Median request latency (recent window)"),
    "kubeml_serving_latency_p95_seconds": (
        "latency_p95_seconds", "p95 request latency (recent window)"),
    "kubeml_serving_latency_p99_seconds": (
        "latency_p99_seconds", "p99 request latency (recent window)"),
    "kubeml_serving_latency_max_seconds": (
        "latency_max_seconds", "Max request latency (recent window)"),
    "kubeml_serving_first_token_p50_seconds": (
        "first_token_p50_seconds", "Median time to first token"),
    "kubeml_serving_first_token_p95_seconds": (
        "first_token_p95_seconds", "p95 time to first token"),
    "kubeml_serving_first_token_p99_seconds": (
        "first_token_p99_seconds", "p99 time to first token"),
    "kubeml_serving_first_token_max_seconds": (
        "first_token_max_seconds", "Max time to first token (recent window)"),
    "kubeml_serving_fetchers_inflight": (
        "fetchers_inflight", "Fetch threads blocked on a result"),
    "kubeml_serving_fetcher_pool_size": (
        "fetchers_total", "Configured result-fetch pool size"),
    "kubeml_serving_fetcher_utilization": (
        "fetcher_utilization", "Busy fraction of the fetch pool"),
    "kubeml_serving_goodput_ratio": (
        "goodput_ratio", "Live fraction of slot-step capacity"),
    "kubeml_serving_pages_total": (
        "pages_total", "Allocatable KV pages in the arena"),
    "kubeml_serving_pages_free": ("pages_free", "KV pages on the free list"),
    "kubeml_serving_page_occupancy": (
        "page_occupancy", "Allocated fraction of the KV arena"),
    "kubeml_serving_page_tokens": ("page_tokens", "Tokens per KV page"),
    "kubeml_serving_prefix_cache_pages": (
        "prefix_cache_pages", "Pages held by the prefix trie"),
    "kubeml_serving_paged_attn_pallas": (
        "paged_attn_kernel",
        "1 when the engine reads the arena through the paged-attention "
        "kernel"),
    "kubeml_serving_kv_quant": ("kv_quant", "1 when KV pages are stored int8"),
    "kubeml_serving_prefills_in_progress": (
        "prefills_in_progress", "Rows mid chunked prefill"),
    "kubeml_serving_spec_accept_rate": (
        "spec_accept_rate", "Lifetime speculative acceptance rate"),
    "kubeml_serving_spec_k": ("spec_k", "Current adaptive speculation depth"),
    "kubeml_serving_spec_disabled": (
        "spec_disabled",
        "1 once the draft backend's acceptance floor disabled drafting"),
    "kubeml_serving_itl_p50_seconds": (
        "itl_p50_seconds", "Median inter-token gap (recent window)"),
    "kubeml_serving_itl_p95_seconds": (
        "itl_p95_seconds", "p95 inter-token gap (recent window)"),
    "kubeml_serving_itl_p99_seconds": (
        "itl_p99_seconds", "p99 inter-token gap (recent window)"),
    "kubeml_serving_itl_max_seconds": (
        "itl_max_seconds", "Max inter-token gap (recent window)"),
    "kubeml_serving_compiled_programs": (
        "compiled_programs",
        "Distinct compiled programs (0: the eager engine compiles none)"),
    "kubeml_serving_compiles_per_minute": (
        "compiles_per_minute", "Compile rate over the last 60s"),
    "kubeml_serving_compile_storm": (
        "compile_storm", "1 while the compile rate is past its threshold"),
    "kubeml_serving_draining": (
        "draining", "1 while the decoder drains for shutdown"),
}

SERVING_HISTOGRAMS = {
    "kubeml_serving_first_token_seconds": (
        "first_token", "Time-to-first-token distribution"),
    "kubeml_serving_request_seconds": (
        "request", "Full request latency distribution"),
    "kubeml_serving_decode_step_seconds": (
        "decode_step", "Per-decode-step time"),
    "kubeml_serving_queue_wait_seconds": (
        "queue_wait", "Submission to decode-slot assignment"),
    "kubeml_serving_prefill_seconds": (
        "prefill", "Slot assignment to the first token on the host"),
    "kubeml_serving_decode_active_seconds": (
        "decode_active", "First token to the row's last token"),
    "kubeml_serving_slot_idle_seconds": (
        "slot_idle", "Slot held after the row's last token"),
    "kubeml_serving_batch_occupancy_ratio": (
        "occupancy_ratio", "Per-chunk live fraction of slot-steps"),
    "kubeml_serving_kv_bandwidth_bytes_per_sec": (
        "kv_bandwidth", "Achieved KV-read bandwidth per chunk"),
    "kubeml_serving_spec_accept_ratio": (
        "spec_accept_ratio", "Per-verify-step acceptance ratio"),
    "kubeml_serving_inter_token_seconds": (
        "inter_token", "Gap between consecutive emissions of a row"),
    "kubeml_serving_cold_start_seconds": (
        "cold_start", "First-call walls kept out of the steady-state series"),
    "kubeml_serving_compile_seconds": ("compile", "Per-compile wall time"),
    "kubeml_serving_snapshot_bytes": (
        "snapshot_bytes", "KMS1 snapshot frame size"),
    "kubeml_serving_snapshot_seconds": (
        "snapshot_seconds", "Wall time per snapshot capture or restore"),
}
# the decode-step distribution splits into clean chunks and chunks run
# while prefill work was in flight, under one metric name
SERVING_HISTOGRAM_VARIANTS = {
    "kubeml_serving_decode_step_seconds": (
        ("decode_step", {"cause": "clean"}),
        ("decode_step_colocated", {"cause": "prefill_colocated"}),
    ),
}


def escape_label_value(v) -> str:
    """A label value escaped for the text exposition format."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(v) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def render_histogram(name: str, snap: dict, label: str = "",
                     value: str = "",
                     extra: Optional[Dict[str, str]] = None) -> List[str]:
    """Exposition lines of one histogram from its snapshot
    (``{"buckets": [[le, cumulative]], "sum", "count"}``), labeled
    ``label="value"`` (none when ``label`` is empty) and ``extra``."""
    sel = f'{label}="{escape_label_value(value)}",' if label else ""
    for k, v in (extra or {}).items():
        sel += f'{k}="{escape_label_value(v)}",'
    bare = f"{{{sel[:-1]}}}" if sel else ""
    lines = [f'{name}_bucket{{{sel}le="{float(edge):g}"}} {int(c)}'
             for edge, c in snap.get("buckets", ())]
    count = int(snap.get("count", 0))
    lines.append(f'{name}_bucket{{{sel}le="+Inf"}} {count}')
    lines.append(f'{name}_sum{bare} {snap.get("sum", 0.0)}')
    lines.append(f'{name}_count{bare} {count}')
    return lines


class Histogram:
    """A Prometheus histogram with fixed bucket edges; the caller holds
    the lock."""

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
        out, total = [], 0
        for edge, c in zip(self.buckets, self.counts):
            total += c
            out.append([edge, total])
        return {"buckets": out, "sum": self.sum, "count": self.count}

    def render(self, name: str, label: str = "", value: str = ""
               ) -> List[str]:
        return render_histogram(name, self.snapshot(), label, value)


class MetricsRegistry:
    """Per-job training series, running-task counts, preemptions, the
    scheduler's sources and the serving exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        # {(metric, jobid): value}
        self._values: Dict[Tuple[str, str], float] = {}
        # {(metric, jobid): Histogram}, insertion-ordered for eviction
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        self._running: Dict[str, int] = {"train": 0, "inference": 0}
        self._preemptions: Dict[str, int] = {}
        self._yield_hist = Histogram()
        # sources read at render time, outside the registry's lock:
        # () -> {priority: queued}, () -> {(direction, reason): n},
        # () -> {model_id: telemetry dict}
        self._queue_source: Optional[Callable[[], dict]] = None
        self._decision_source: Optional[Callable[[], dict]] = None
        self._serving_source: Optional[Callable[[], dict]] = None
        # {job_id: highest applied dataplane batch seq}, oldest first: a
        # runner re-sends a batch until a push is acknowledged, and a
        # redelivered batch must not count twice
        self._dp_applied: Dict[str, int] = {}

    def set_serving_source(self, source: Callable[[], dict]) -> None:
        self._serving_source = source

    def set_queue_source(self, source: Callable[[], dict]) -> None:
        self._queue_source = source

    def set_decision_source(self, source: Callable[[], dict]) -> None:
        self._decision_source = source

    @staticmethod
    def _read(source) -> dict:
        if source is None:
            return {}
        try:
            return dict(source() or {})
        except Exception:
            return {}

    def decisions_snapshot(self) -> Dict[tuple, int]:
        """{(direction, reason): cumulative count} of the decision source."""
        return self._read(self._decision_source)

    def queue_depths(self) -> Dict[object, int]:
        """{priority: queued count} of the queue source."""
        return self._read(self._queue_source)

    def job_gauges_snapshot(self) -> Dict[Tuple[str, str], float]:
        """{(metric, jobid): latest value} of every per-job scalar."""
        with self._lock:
            return dict(self._values)

    def preemption(self, reason: str) -> None:
        """Count one preemption (``kubeml_preemptions_total{reason}``)."""
        with self._lock:
            if reason not in self._preemptions:
                limit = (MAX_PREEMPT_REASONS if "other" in self._preemptions
                         else MAX_PREEMPT_REASONS - 1)
                if len(self._preemptions) >= limit:
                    reason = "other"
            self._preemptions[reason] = self._preemptions.get(reason, 0) + 1

    def preemptions_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._preemptions)

    def observe_yield(self, seconds: float) -> None:
        """Yield latency: the preempt request until the job's slot freed."""
        with self._lock:
            self._yield_hist.observe(seconds)

    def update(self, u: MetricUpdate) -> None:
        """A job's per-epoch push."""
        if u.dataplane:
            from ..utils import profiler

            with self._lock:
                applied = self._dp_applied.get(u.job_id, 0)
                fresh = [b for b in u.dataplane if isinstance(b, dict)
                         and int(b.get("seq", 0)) > applied]
                if fresh:
                    self._dp_applied.pop(u.job_id, None)  # newest last
                    self._dp_applied[u.job_id] = max(
                        int(b["seq"]) for b in fresh)
                    # a backstop only: clear() drops a finished job's mark
                    while len(self._dp_applied) > 4096:
                        self._dp_applied.pop(next(iter(self._dp_applied)))
            for b in fresh:
                profiler.merge_counters(b.get("phases") or {})
        with self._lock:
            jid = u.job_id
            self._values[("kubeml_job_validation_loss", jid)] = \
                u.validation_loss
            self._values[("kubeml_job_validation_accuracy", jid)] = u.accuracy
            self._values[("kubeml_job_train_loss", jid)] = u.train_loss
            self._values[("kubeml_job_parallelism", jid)] = float(
                u.parallelism)
            self._values[("kubeml_job_epoch_duration_seconds", jid)] = \
                u.epoch_duration
            # the job's own (resume-correct) epoch count; without it, count
            # the pushes (one an epoch)
            if u.epoch >= 0:
                self._values[("kubeml_job_epoch", jid)] = float(u.epoch)
            else:
                self._values[("kubeml_job_epoch", jid)] = (
                    self._values.get(("kubeml_job_epoch", jid), 0.0) + 1.0)
            if u.moe_overflow >= 0.0:
                self._values[("kubeml_job_moe_overflow", jid)] = \
                    u.moe_overflow
            self._observe("kubeml_job_epoch_seconds", jid,
                          (u.epoch_duration,))
            self._observe("kubeml_job_round_seconds", jid,
                          u.round_seconds or ())
            if u.merge_seconds >= 0.0:
                self._observe("kubeml_job_merge_seconds", jid,
                              (u.merge_seconds,))
            # per-round signals into the histograms; the epoch means kept
            # under the same names for the per-job snapshot
            if u.round_divergence:
                self._observe("kubeml_job_worker_divergence", jid,
                              u.round_divergence)
                self._values[("kubeml_job_worker_divergence", jid)] = (
                    sum(u.round_divergence) / len(u.round_divergence))
            if u.round_loss_spread:
                self._observe("kubeml_job_loss_spread", jid,
                              u.round_loss_spread)
                self._values[("kubeml_job_loss_spread", jid)] = (
                    sum(u.round_loss_spread) / len(u.round_loss_spread))
            if u.round_skew_ratio >= 0.0:
                self._observe("kubeml_job_round_skew_ratio", jid,
                              (u.round_skew_ratio,))
                self._values[("kubeml_job_round_skew_ratio", jid)] = (
                    u.round_skew_ratio)

    def _observe(self, metric: str, job_id: str, values) -> None:
        """Observe into the (metric, jobid) histogram; the caller holds the
        lock. Past ``MAX_HISTOGRAM_JOBS`` jobs a metric, the oldest job's
        series goes."""
        if not values:
            return
        h = self._hists.get((metric, job_id))
        if h is None:
            h = self._hists[(metric, job_id)] = Histogram(
                HISTOGRAM_BUCKETS.get(metric, LATENCY_BUCKETS))
            jobs = [j for m, j in self._hists if m == metric]
            while len(jobs) > MAX_HISTOGRAM_JOBS:
                self._hists.pop((metric, jobs.pop(0)), None)
        for v in values:
            h.observe(v)

    def observe(self, metric: str, job_id: str, value: float) -> None:
        with self._lock:
            self._observe(metric, job_id, (value,))

    def clear(self, job_id: str) -> None:
        """Drop a finished job's gauges (its histograms stay)."""
        with self._lock:
            for key in [k for k in self._values if k[1] == job_id]:
                del self._values[key]
            # the runner ends with its job: no more redeliveries
            self._dp_applied.pop(job_id, None)

    def get(self, metric: str, job_id: str) -> float:
        with self._lock:
            return self._values[(metric, job_id)]

    def task_started(self, kind: str = "train") -> None:
        with self._lock:
            self._running[kind] = self._running.get(kind, 0) + 1

    def task_finished(self, kind: str = "train") -> None:
        with self._lock:
            self._running[kind] = max(0, self._running.get(kind, 0) - 1)

    def running_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._running)

    def render(self) -> str:
        """The Prometheus text exposition format."""
        with self._lock:
            lines = []
            for metric, help_text in GAUGES.items():
                lines += [f"# HELP {metric} {escape_help(help_text)}",
                          f"# TYPE {metric} gauge"]
                series = sorted((jid, v) for (m, jid), v
                                in self._values.items() if m == metric)
                lines += [f'{metric}{{jobid="{escape_label_value(jid)}"}} {v}'
                          for jid, v in series]
            for metric, help_text in HISTOGRAMS.items():
                lines += [f"# HELP {metric} {escape_help(help_text)}",
                          f"# TYPE {metric} histogram"]
                for (m, jid), h in sorted(self._hists.items(),
                                          key=lambda kv: kv[0]):
                    if m == metric:
                        lines += h.render(metric, "jobid", jid)
            lines += [f"# HELP {RUNNING} Number of running tasks",
                      f"# TYPE {RUNNING} gauge"]
            lines += [f'{RUNNING}{{type="{escape_label_value(k)}"}} {n}'
                      for k, n in sorted(self._running.items())]
            lines += [f"# HELP {PREEMPTIONS} Training jobs preempted "
                      f"(checkpoint-and-yield), by reason",
                      f"# TYPE {PREEMPTIONS} counter"]
            lines += [f'{PREEMPTIONS}{{reason="{escape_label_value(r)}"}} {n}'
                      for r, n in sorted(self._preemptions.items())]
            lines += [f"# HELP {YIELD_SECONDS} Preemption yield latency "
                      f"(preempt request until the job's slot freed)",
                      f"# TYPE {YIELD_SECONDS} histogram"]
            lines += self._yield_hist.render(YIELD_SECONDS)
        # the sources take their own locks: read them outside ours
        lines += [f"# HELP {QUEUE_DEPTH} Queued train tasks per priority "
                  f"class", f"# TYPE {QUEUE_DEPTH} gauge"]
        lines += [f'{QUEUE_DEPTH}{{priority="{escape_label_value(p)}"}} {n}'
                  for p, n in sorted(self.queue_depths().items())]
        lines += [f"# HELP {SCALE_DECISIONS} Elastic scale decisions by "
                  f"transition direction and enumerated reason",
                  f"# TYPE {SCALE_DECISIONS} counter"]
        lines += [f'{SCALE_DECISIONS}{{direction='
                  f'"{escape_label_value(d)}",reason='
                  f'"{escape_label_value(r)}"}} {int(n)}'
                  for (d, r), n in sorted(self.decisions_snapshot().items())]
        per_model = {}
        if self._serving_source is not None:
            try:
                per_model = self._serving_source()
            except Exception:
                per_model = {}
        models = sorted(per_model.items())
        for metric, (key, help_text) in SERVING_COUNTERS.items():
            lines += [f"# HELP {metric} {escape_help(help_text)}",
                      f"# TYPE {metric} counter"]
            lines += [f'{metric}{{model="{escape_label_value(m)}"}} {s[key]}'
                      for m, s in models if key in s]
        lines += [f"# HELP {SERVING_COMPILES} "
                  f"{escape_help(SERVING_COMPILES_HELP)}",
                  f"# TYPE {SERVING_COMPILES} counter"]
        for m, s in models:
            for program, n in sorted((s.get("compiles") or {}).items()):
                lines.append(
                    f'{SERVING_COMPILES}{{model="{escape_label_value(m)}",'
                    f'program="{escape_label_value(program)}"}} {int(n)}')
        for metric, (key, help_text) in SERVING_GAUGES.items():
            lines += [f"# HELP {metric} {escape_help(help_text)}",
                      f"# TYPE {metric} gauge"]
            lines += [f'{metric}{{model="{escape_label_value(m)}"}} {s[key]}'
                      for m, s in models if key in s]
        for metric, (key, help_text) in SERVING_HISTOGRAMS.items():
            lines += [f"# HELP {metric} {escape_help(help_text)}",
                      f"# TYPE {metric} histogram"]
            variants = SERVING_HISTOGRAM_VARIANTS.get(metric, ((key, None),))
            for m, s in models:
                for vkey, extra in variants:
                    snap = (s.get("hist") or {}).get(vkey)
                    if snap:
                        lines += render_histogram(metric, snap, "model", m,
                                                  extra)
        from ..utils import profiler

        lines += profiler.render_metrics()
        return "\n".join(lines) + "\n"
