"""Data-plane accounting: the bytes and seconds each weight-movement seam
moves. The port of the counters of ``kubeml_tpu/utils/profiler.py``
(:1-222); its flight recorder, ``ProfileSession`` and span attribution
belong to the tracing slice and are not ported.

Every seam (host -> device staging, the tensor-store publish and fetch,
the KMW1 wire's encode and decode) calls :func:`account` or
:func:`record_io` with its byte count and, where the call blocks, its
wall time. The totals render on the parameter server's ``/metrics`` as
``kubeml_dataplane_{bytes,seconds,events}_total{phase}``, the retried
transfers as ``kubeml_dataplane_retries_total{phase}``, and the achieved
bandwidth of blocking transfers as the histogram
``kubeml_staging_bandwidth_bytes_per_sec{phase}``, under the JAX
package's names. A standalone runner pushes its counters' deltas to the
parameter server with each epoch's metrics (:func:`merge_counters`).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

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


def record_io(phase: str, nbytes: float, seconds: float,
              flops: Optional[float] = None, **attrs: Any) -> None:
    """A blocking transfer's :func:`account`. JAX also records a span
    with ``attrs`` here; the port has no tracing yet, so they are
    dropped."""
    account(phase, nbytes, seconds)


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
