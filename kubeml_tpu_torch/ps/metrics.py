"""Prometheus exposition of the serving series: the part of
``kubeml_tpu/ps/metrics.py``'s ``MetricsRegistry`` that the port's
parameter server needs.

The running-task gauge ``kubeml_job_running_total{type}`` (fed by
:meth:`MetricsRegistry.task_started`/``task_finished``) and the per-model
serving counters, gauges and histograms, rendered from the resident
decoders' ``telemetry()`` snapshots (``serving.stats.DecoderStats``)
under the JAX package's metric names and ``model`` label. HELP/TYPE
headers render even with no decoder, so the exported metric set does not
depend on traffic. The training gauges and histograms are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

RUNNING = "kubeml_job_running_total"

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


def render_histogram(name: str, snap: dict, label: str, value: str,
                     extra: Optional[Dict[str, str]] = None) -> List[str]:
    """Exposition lines of one labeled histogram from its snapshot
    (``{"buckets": [[le, cumulative]], "sum", "count"}``)."""
    sel = f'{label}="{escape_label_value(value)}",'
    for k, v in (extra or {}).items():
        sel += f'{k}="{escape_label_value(v)}",'
    lines = [f'{name}_bucket{{{sel}le="{float(edge):g}"}} {int(c)}'
             for edge, c in snap.get("buckets", ())]
    count = int(snap.get("count", 0))
    lines.append(f'{name}_bucket{{{sel}le="+Inf"}} {count}')
    lines.append(f'{name}_sum{{{sel[:-1]}}} {snap.get("sum", 0.0)}')
    lines.append(f'{name}_count{{{sel[:-1]}}} {count}')
    return lines


class MetricsRegistry:
    """Running-task counts and the serving exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._running: Dict[str, int] = {"train": 0, "inference": 0}
        # () -> {model_id: telemetry dict}, read at render time
        self._serving_source: Optional[Callable[[], dict]] = None

    def set_serving_source(self, source: Callable[[], dict]) -> None:
        self._serving_source = source

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
        lines = [f"# HELP {RUNNING} Number of running tasks",
                 f"# TYPE {RUNNING} gauge"]
        for kind, n in sorted(self.running_snapshot().items()):
            lines.append(f'{RUNNING}{{type="{escape_label_value(kind)}"}} {n}')
        # the source snapshots each decoder under its own lock: read it
        # outside ours
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
        return "\n".join(lines) + "\n"
