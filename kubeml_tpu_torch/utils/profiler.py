"""Performance attribution, where the bytes and the seconds go: the port
of ``kubeml_tpu/utils/profiler.py``.

* Data-plane accounting: every seam (dataset reads, host -> device
  staging, the tensor-store publish and fetch, the KMW1 wire's encode and
  decode, sharded checkpoint saves and restores) calls :func:`account` or
  :func:`record_io` with its byte count and, where the call blocks, its
  wall time. The totals render on the parameter server's ``/metrics`` as
  ``kubeml_dataplane_{bytes,seconds,events}_total{phase}``, the retried
  transfers as ``kubeml_dataplane_retries_total{phase}``, and the achieved
  bandwidth of blocking transfers as the histogram
  ``kubeml_staging_bandwidth_bytes_per_sec{phase}``, under the JAX
  package's names. A standalone runner pushes its counters' deltas to the
  parameter server with each epoch's metrics (:func:`merge_counters`).
  :func:`record_io` also records a span with the bytes when tracing is
  on, and every event enters the flight recorder.
* :class:`ProfileSession`: named phases with their bytes and FLOPs, a
  report of achieved bandwidth and FLOP rate, and a roofline verdict per
  phase (:func:`classify`, from the peaks of the card the process runs on:
  :func:`device_peaks`). With ``device_trace_dir`` the session also
  takes a ``torch.profiler`` device trace (``utils.tracing.
  device_profile``); a failure to take it is kept as
  ``device_trace_error`` in the report.
* :class:`FlightRecorder`: an always-on bounded ring of recent spans and
  data-plane events. ``dump()`` writes it, with the counters, as a
  postmortem JSON when the error hook or the stall watchdog trips
  (``KUBEML_FLIGHT_DIR`` gates the disk write; the error hook's payload
  carries the tail either way).
* :func:`attribution_report` folds a task's collected span dicts into a
  per-phase byte/FLOP table, and :func:`perfetto_with_counters` exports
  the merged trace with Perfetto counter tracks (cumulative data-plane
  bytes, per-span bandwidth): the ``kubeml profile <task-id>`` report.

This module imports no torch at module level (the CLI's ``kubeml
profile`` uses it); :func:`device_peaks` reads the card only where torch
is already loaded.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .tracing import (add_span_sink, current_context, current_task,
                      device_profile, get_tracer, merge_chrome_trace)

# achieved-bandwidth histogram edges (bytes/s); +Inf implicit
BANDWIDTH_BUCKETS = (1e4, 1e5, 1e6, 4e6, 1.6e7, 6.4e7, 2.56e8, 1e9,
                     4e9, 1.6e10, 6.4e10, 2.56e11)

# phase-label cardinality bound (a guard against ids in phase names)
MAX_PHASES = 64

_lock = threading.Lock()
# {phase: {"bytes": float, "seconds": float, "events": int}}
_phases: Dict[str, Dict[str, float]] = {}
# {phase: Histogram of achieved bytes/s of blocking transfers}
_bw_hists: Dict[str, Any] = {}
# {phase: re-attempted transfers} (a torn seqlock fetch, say)
_retries: Dict[str, int] = {}


def _agg(phase: str) -> Dict[str, float]:
    """The phase's totals; the caller holds the lock."""
    agg = _phases.get(phase)
    if agg is None:
        if len(_phases) >= MAX_PHASES:
            _phases.pop(next(iter(_phases)))
        agg = _phases[phase] = {"bytes": 0.0, "seconds": 0.0, "events": 0}
    return agg


def account(phase: str, nbytes: float, seconds: Optional[float] = None
            ) -> None:
    """One data-plane event: ``nbytes`` moved in ``seconds`` (None: the
    call did not block, so no bandwidth observation)."""
    from ..ps.metrics import Histogram

    nbytes = float(nbytes)
    with _lock:
        agg = _agg(phase)
        agg["bytes"] += nbytes
        agg["events"] += 1
        if seconds is not None and seconds > 0:
            agg["seconds"] += float(seconds)
            if nbytes > 0:
                h = _bw_hists.get(phase)
                if h is None:
                    if len(_bw_hists) >= MAX_PHASES:
                        _bw_hists.pop(next(iter(_bw_hists)))
                    h = _bw_hists[phase] = Histogram(BANDWIDTH_BUCKETS)
                h.observe(nbytes / seconds)
    get_recorder().note({"kind": "dataplane", "phase": phase,
                         "bytes": nbytes, "seconds": seconds})


def record_io(phase: str, nbytes: float, seconds: float,
              flops: Optional[float] = None, **attrs: Any) -> None:
    """:func:`account`, plus a span named ``phase`` carrying ``bytes``
    (and ``flops``, ``bandwidth_bps`` and ``attrs``) when tracing is on:
    the one call a blocking seam makes so its bytes show in the counters
    and in the span tree."""
    account(phase, nbytes, seconds)
    tracer = get_tracer()
    if tracer.enabled:
        span_attrs = dict(attrs)
        span_attrs["bytes"] = int(nbytes)
        if flops:
            span_attrs["flops"] = float(flops)
        if seconds and seconds > 0 and nbytes > 0:
            span_attrs["bandwidth_bps"] = nbytes / seconds
        tracer.record(phase, max(float(seconds or 0.0), 0.0), **span_attrs)


def tree_nbytes(tree) -> int:
    """The bytes of a tree's array leaves (numpy arrays or tensors in
    nested dicts, lists and tuples)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    n = getattr(tree, "nbytes", 0)
    return int(n() if callable(n) else n)


def record_retry(phase: str) -> None:
    """Count one retried transfer on ``phase``."""
    with _lock:
        if phase not in _retries and len(_retries) >= MAX_PHASES:
            _retries.pop(next(iter(_retries)))
        _retries[phase] = _retries.get(phase, 0) + 1


def counters_snapshot() -> Dict[str, Any]:
    """The accounting as plain data: per-phase totals, bandwidth histogram
    snapshots and retries, over the process's lifetime."""
    with _lock:
        return {
            "scope": "process-lifetime",
            "pid": os.getpid(),
            "dataplane": {p: dict(agg) for p, agg in _phases.items()},
            "bandwidth": {p: h.snapshot() for p, h in _bw_hists.items()},
            "retries": dict(_retries),
        }


def merge_counters(phases: Dict[str, Dict[str, float]]) -> None:
    """Fold another process's per-phase counter deltas into this
    registry (a standalone runner's, pushed with its epoch metrics: it
    has no scraped ``/metrics`` of its own). Bandwidth histograms stay
    per process."""
    for phase, d in phases.items():
        if not isinstance(d, dict):
            continue
        with _lock:
            agg = _agg(phase)
            agg["bytes"] += max(float(d.get("bytes", 0.0)), 0.0)
            agg["seconds"] += max(float(d.get("seconds", 0.0)), 0.0)
            agg["events"] += max(int(d.get("events", 0)), 0)


def reset_accounting() -> None:
    """Clear the process-wide accounting (a test hook)."""
    with _lock:
        _phases.clear()
        _bw_hists.clear()
        _retries.clear()


def render_metrics() -> List[str]:
    """The exposition lines of the data-plane series."""
    from ..ps.metrics import escape_label_value, render_histogram

    with _lock:
        phases = {p: dict(agg) for p, agg in _phases.items()}
        hists = {p: h.snapshot() for p, h in _bw_hists.items()}
        retries = dict(_retries)
    lines = [
        "# HELP kubeml_dataplane_bytes_total Bytes moved per data-plane phase",
        "# TYPE kubeml_dataplane_bytes_total counter",
    ]
    for p, agg in sorted(phases.items()):
        lines.append(f'kubeml_dataplane_bytes_total{{phase="'
                     f'{escape_label_value(p)}"}} {agg["bytes"]:g}')
    lines.append("# HELP kubeml_dataplane_seconds_total Blocking wall seconds "
                 "per data-plane phase")
    lines.append("# TYPE kubeml_dataplane_seconds_total counter")
    for p, agg in sorted(phases.items()):
        lines.append(f'kubeml_dataplane_seconds_total{{phase="'
                     f'{escape_label_value(p)}"}} {agg["seconds"]:g}')
    lines.append("# HELP kubeml_dataplane_events_total Data-plane transfer "
                 "events per phase")
    lines.append("# TYPE kubeml_dataplane_events_total counter")
    for p, agg in sorted(phases.items()):
        lines.append(f'kubeml_dataplane_events_total{{phase="'
                     f'{escape_label_value(p)}"}} {agg["events"]:d}')
    if retries:
        lines.append("# HELP kubeml_dataplane_retries_total Re-attempted "
                     "data-plane transfers per phase (e.g. torn weight "
                     "fetches)")
        lines.append("# TYPE kubeml_dataplane_retries_total counter")
        for p, n in sorted(retries.items()):
            lines.append(f'kubeml_dataplane_retries_total{{phase="'
                         f'{escape_label_value(p)}"}} {n:d}')
    lines.append("# HELP kubeml_staging_bandwidth_bytes_per_sec Achieved "
                 "bandwidth of blocking data-plane transfers")
    lines.append("# TYPE kubeml_staging_bandwidth_bytes_per_sec histogram")
    for p, snap in sorted(hists.items()):
        lines.extend(render_histogram(
            "kubeml_staging_bandwidth_bytes_per_sec", snap, "phase", p))
    return lines


# --- roofline classification ---

# the peaks of the cards the port knows, by a marker of the device name:
# (dense bf16 FLOP/s, memory bytes/s); the H100 SXM's from NVIDIA's data
# sheet (700 W), the numbers the kernel bounds use
CARD_PEAKS = {"h100": (989e12, 3.35e12)}
H100_PEAK_BF16_FLOPS = CARD_PEAKS["h100"][0]


def _card_name() -> str:
    """The first card's name, lower case; "" without a card or where torch
    is not loaded (a client process has no card to ask)."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_available():
            return torch.cuda.get_device_name(0).lower()
    except Exception:
        pass
    return ""


def device_peaks() -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s, memory bytes/s) of the card this process runs on;
    ``KUBEML_PEAK_FLOPS`` (TFLOP/s) and ``KUBEML_HBM_BW`` (GB/s) override
    each; None where unknown (the CPU)."""
    name = _card_name()
    peak, bw = next((v for marker, v in CARD_PEAKS.items()
                     if marker in name), (None, None))
    env_peak = os.environ.get("KUBEML_PEAK_FLOPS")
    env_bw = os.environ.get("KUBEML_HBM_BW")
    if env_peak:
        peak = float(env_peak) * 1e12
    if env_bw:
        bw = float(env_bw) * 1e9
    return peak, bw


def classify(nbytes: float, flops: float) -> str:
    """Which roofline term dominates a phase: ``compute-bound`` when its
    FLOPs at the card's peak take longer than its bytes at the memory
    rate, ``transfer-bound`` when the bytes do, ``host`` when it moved no
    bytes and ran no FLOPs. On an unknown device (the CPU) it compares
    the arithmetic intensity with 100 FLOP a byte, as JAX does."""
    if not nbytes and not flops:
        return "host"
    if not flops:
        return "transfer-bound"
    if not nbytes:
        return "compute-bound"
    peak, bw = device_peaks()
    if not peak or not bw:
        return ("compute-bound" if flops / nbytes >= 100.0
                else "transfer-bound")
    return ("compute-bound" if flops / peak >= nbytes / bw
            else "transfer-bound")


# --- the flight recorder ---


class FlightRecorder:
    """A bounded ring of recent spans and data-plane events for
    postmortems.

    Always on (capacity ``KUBEML_FLIGHT_RECORDER``, default 256; 0 turns
    it off), fed by the tracer's span sink and :func:`account`. ``dump()``
    writes the ring with a counter snapshot into ``KUBEML_FLIGHT_DIR`` (no
    disk write when unset; :meth:`tail` serves the error hook either
    way)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("KUBEML_FLIGHT_RECORDER", "256"))
            except ValueError:
                capacity = 256
        self.capacity = max(0, int(capacity))
        self._ring: "deque[dict]" = deque(maxlen=self.capacity or 1)
        self._lock = threading.Lock()

    def note(self, event: dict) -> None:
        if self.capacity <= 0:
            return
        e = dict(event)
        e.setdefault("t", time.time())
        ctx = current_context()
        if ctx is not None:
            e.setdefault("trace_id", ctx.trace_id)
        task = current_task()
        if task is not None:
            e.setdefault("task_id", task)
        with self._lock:
            self._ring.append(e)

    def record_span(self, span) -> None:
        """The tracer's sink: a finished span as a compact record."""
        if self.capacity <= 0:
            return
        e = {"kind": "span", "t": span.start, "name": span.name,
             "duration": span.duration, "trace_id": span.trace_id,
             "service": span.service}
        for k in ("job", "bytes", "flops", "epoch", "round"):
            if k in span.attrs:
                e[k] = span.attrs[k]
        with self._lock:
            self._ring.append(e)

    def tail(self, n: int = 64) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        return items[-n:]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, reason: str,
             out_dir: Optional[Path] = None) -> Optional[Path]:
        """Write the postmortem record into ``out_dir`` (by default
        ``KUBEML_FLIGHT_DIR``; None when neither is set). Never raises:
        it runs on failure paths."""
        if out_dir is None:
            env = os.environ.get("KUBEML_FLIGHT_DIR", "")
            if not env:
                return None
            out_dir = Path(env)
        try:
            from . import resilience

            record = {
                "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "pid": os.getpid(),
                "reason": str(reason),
                "task_id": current_task(),
                "events": self.tail(self.capacity or 1),
                "counters": counters_snapshot(),
                "http_counters": {
                    f"{m}{{{lv}}}": v for (m, lv), v in
                    resilience.counters_snapshot().items()},
            }
            ctx = current_context()
            if ctx is not None:
                record["trace_id"] = ctx.trace_id
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"flight-{os.getpid()}-{int(time.time())}.json"
            path.write_text(json.dumps(record, default=str))
            return path
        except Exception:
            return None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
                add_span_sink(_recorder.record_span)
    return _recorder


# --- phase-scoped profiling sessions ---


class _Phase:
    """The handle :meth:`ProfileSession.phase` yields: a seam can add the
    bytes and FLOPs it learns mid-phase (``ph.bytes += n``)."""

    __slots__ = ("name", "bytes", "flops", "attrs", "seconds")

    def __init__(self, name: str, nbytes: float, flops: float, attrs: dict):
        self.name = name
        self.bytes = float(nbytes)
        self.flops = float(flops)
        self.attrs = attrs
        self.seconds = 0.0


class ProfileSession:
    """One profiled run: named phases with their bytes and FLOPs.

    With ``device_trace_dir`` the session takes a ``torch.profiler``
    trace of everything inside it (CUDA kernels by name where a card is
    present) through ``utils.tracing.device_profile``; a failure to take
    it is kept in ``device_trace_error`` and the report, and the phase
    timeline is recorded either way."""

    def __init__(self, name: str, device_trace_dir: Optional[Path] = None):
        self.name = name
        self.device_trace_dir = (Path(device_trace_dir)
                                 if device_trace_dir else None)
        self._phases: List[_Phase] = []
        self._lock = threading.Lock()
        self._device_trace = None
        self.device_trace_error: Optional[str] = None

    # -- the session's scope (the device trace) --

    def __enter__(self) -> "ProfileSession":
        if self.device_trace_dir is not None:
            try:
                self._device_trace = device_profile(self.device_trace_dir)
                self._device_trace.__enter__()
            except Exception as e:  # no profiler backend
                self._device_trace = None
                self.device_trace_error = str(e)
        return self

    def __exit__(self, *exc) -> None:
        if self._device_trace is not None:
            try:
                self._device_trace.__exit__(*exc)
            except Exception as e:
                self.device_trace_error = str(e)
            self._device_trace = None

    # -- phases --

    @contextmanager
    def phase(self, name: str, nbytes: float = 0.0, flops: float = 0.0,
              **attrs: Any) -> Iterator[_Phase]:
        # bytes= and flops= are the positional parameters' other spelling,
        # never span attributes
        nbytes = float(attrs.pop("bytes", nbytes))
        flops = float(attrs.pop("flops", flops))
        ph = _Phase(name, nbytes, flops, attrs)
        tracer = get_tracer()
        t0 = time.perf_counter()
        try:
            if tracer.enabled:
                with tracer.span(f"{self.name}.{name}", **attrs) as span:
                    try:
                        yield ph
                    finally:
                        # the phase's final totals go on the span before
                        # the tracer records it
                        if span is not None:
                            if ph.bytes:
                                span.attrs["bytes"] = ph.bytes
                            if ph.flops:
                                span.attrs["flops"] = ph.flops
            else:
                yield ph
        finally:
            ph.seconds = time.perf_counter() - t0
            with self._lock:
                self._phases.append(ph)

    def note_phase(self, name: str, seconds: float, nbytes: float = 0.0,
                   flops: float = 0.0, **attrs: Any) -> None:
        """A phase timed elsewhere."""
        ph = _Phase(name, nbytes, flops, attrs)
        ph.seconds = float(seconds)
        with self._lock:
            self._phases.append(ph)

    # -- reporting --

    def report(self) -> Dict[str, Any]:
        """Per phase: wall seconds, bytes, FLOPs, achieved bandwidth and
        FLOP rate, share of the session's time, and the roofline verdict."""
        with self._lock:
            phases = list(self._phases)
        agg: Dict[str, Dict[str, float]] = {}
        for ph in phases:
            a = agg.setdefault(ph.name, {"seconds": 0.0, "bytes": 0.0,
                                         "flops": 0.0, "count": 0})
            a["seconds"] += ph.seconds
            a["bytes"] += ph.bytes
            a["flops"] += ph.flops
            a["count"] += 1
        total_s = sum(a["seconds"] for a in agg.values()) or 1.0
        out = {"session": self.name, "total_seconds": total_s,
               "phases": _phase_rows(agg, total_s=total_s)}
        if self.device_trace_dir is not None:
            out["device_trace_dir"] = str(self.device_trace_dir)
            if self.device_trace_error:
                out["device_trace_error"] = self.device_trace_error
        return out

    def dump(self, path: Path, **extra: Any) -> Path:
        """Append the report, with ``extra`` merged in, as one JSON line."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        row = self.report()
        row.update(extra)
        row["ts"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        with path.open("a") as f:
            f.write(json.dumps(row) + "\n")
        return path


def gap_attribution(device_sps: float, e2e_sps: float,
                    samples_per_round: float, bytes_per_round: float,
                    flops_per_round: Optional[float] = None
                    ) -> Dict[str, Any]:
    """The gap between device-only and end-to-end throughput as a byte
    budget a round: the extra wall time of an end-to-end round is the
    staging share, and the staged bytes over it the staging bandwidth."""
    out: Dict[str, Any] = {
        "device_samples_per_sec": device_sps,
        "end_to_end_samples_per_sec": e2e_sps,
        "bytes_per_round": bytes_per_round,
    }
    if flops_per_round:
        out["flops_per_round"] = flops_per_round
    if device_sps <= 0 or e2e_sps <= 0 or samples_per_round <= 0:
        return out
    t_device = samples_per_round / device_sps
    t_e2e = samples_per_round / e2e_sps
    staging_s = max(t_e2e - t_device, 0.0)
    out.update({
        "device_round_seconds": t_device,
        "end_to_end_round_seconds": t_e2e,
        "staging_seconds_per_round": staging_s,
        "staging_share": staging_s / t_e2e if t_e2e > 0 else 0.0,
    })
    if staging_s > 0 and bytes_per_round > 0:
        out["staging_bandwidth_bps"] = bytes_per_round / staging_s
    return out


# --- span-tree attribution (the `kubeml profile` report) ---


def _phase_rows(agg: Dict[str, Dict[str, float]],
                total_s: Optional[float] = None) -> List[dict]:
    """Rows of {phase: {seconds, bytes, flops, count}}, slowest first:
    the row of both ProfileSession.report and attribution_report."""
    rows = []
    for name, a in agg.items():
        row = {
            "phase": name,
            "count": int(a["count"]),
            "seconds": a["seconds"],
            "bytes": a["bytes"],
            "flops": a["flops"],
            "bound": classify(a["bytes"], a["flops"]),
        }
        if total_s:
            row["share"] = a["seconds"] / total_s
        if a["seconds"] > 0:
            if a["bytes"]:
                row["bandwidth_bps"] = a["bytes"] / a["seconds"]
            if a["flops"]:
                row["flops_per_sec"] = a["flops"] / a["seconds"]
        rows.append(row)
    rows.sort(key=lambda r: -r["seconds"])
    return rows


def attribution_report(span_dicts: List[dict],
                       counters: Optional[dict] = None) -> Dict[str, Any]:
    """A task's span dicts (``ps/traces.py``'s collection) folded into a
    per-phase table: spans by name, their ``bytes`` and ``flops``
    attributes summed, each phase classified. ``counters`` (each process's
    snapshot, over its lifetime, so context rather than a task's budget)
    rides along."""
    agg: Dict[str, Dict[str, float]] = {}
    for d in span_dicts:
        if not isinstance(d, dict):
            continue
        attrs = d.get("attrs") or {}
        a = agg.setdefault(d.get("name") or "?",
                           {"seconds": 0.0, "bytes": 0.0, "flops": 0.0,
                            "count": 0})
        a["seconds"] += float(d.get("duration") or 0.0)
        a["count"] += 1
        for key in ("bytes", "flops"):
            try:
                a[key] += float(attrs.get(key) or 0.0)
            except (TypeError, ValueError):
                pass
    rows = _phase_rows(agg)
    out: Dict[str, Any] = {
        "phases": rows,
        "total_bytes": sum(r["bytes"] for r in rows),
        "total_flops": sum(r["flops"] for r in rows),
        "span_count": len(span_dicts),
    }
    if counters:
        out["counters"] = counters
    return out


def perfetto_with_counters(span_dicts: List[dict]) -> Dict[str, Any]:
    """The merged Chrome/Perfetto trace (``tracing.merge_chrome_trace``)
    with counter tracks under a ``dataplane`` process row: cumulative
    data-plane bytes over time and each service's transfer bandwidth."""
    trace = merge_chrome_trace(span_dicts)
    events = trace["traceEvents"]
    counter_pid = max((e.get("pid", 0) for e in events
                       if isinstance(e.get("pid"), int)), default=0) + 1
    byte_spans = []
    for d in span_dicts:
        if not isinstance(d, dict):
            continue
        attrs = d.get("attrs") or {}
        try:
            nbytes = float(attrs.get("bytes") or 0.0)
        except (TypeError, ValueError):
            continue
        if nbytes <= 0:
            continue
        byte_spans.append((float(d.get("start") or 0.0),
                           float(d.get("duration") or 0.0), nbytes,
                           d.get("service") or "?"))
    if not byte_spans:
        return trace
    events.append({"ph": "M", "name": "process_name", "pid": counter_pid,
                   "args": {"name": "dataplane"}})
    # a transfer's bytes land when it ends: ordered by end time, the
    # cumulative track never falls where byte spans overlap
    cumulative = 0.0
    for start, dur, nbytes, _svc in sorted(byte_spans,
                                           key=lambda b: b[0] + b[1]):
        cumulative += nbytes
        events.append({"ph": "C", "name": "dataplane_bytes_total",
                       "pid": counter_pid, "ts": (start + dur) * 1e6,
                       "args": {"bytes": cumulative}})
    # one bandwidth track a service: a transfer ending in one process
    # never zeroes the rate of another still running
    for start, dur, nbytes, svc in byte_spans:
        if dur <= 0:
            continue
        name = f"transfer_bandwidth_MBps/{svc}"
        mbps = nbytes / dur / 1e6
        events.append({"ph": "C", "name": name, "pid": counter_pid,
                       "ts": start * 1e6, "args": {"MBps": mbps}})
        events.append({"ph": "C", "name": name, "pid": counter_pid,
                       "ts": (start + dur) * 1e6, "args": {"MBps": 0.0}})
    return trace
