"""Exporters for the obs registry: phase rollups + Chrome/Perfetto trace.

Counterpart of ``qfedx_tpu/obs/export.py``, with the same schema:

1. ``phase_rollup()`` — per-phase {count, total_s, p50_s, p95_s,
   compile_s}: merged into ``metrics.jsonl`` rows by the trainer and
   into ``summary.json`` by ``run.metrics.ExperimentRun.finish``.
2. ``write_chrome_trace(path)`` — Chrome trace-event JSON ("X" complete
   events, µs timestamps) loadable in Perfetto / chrome://tracing; the
   ``--trace`` CLI flag writes one per run.
3. ``snapshot()`` / ``phase_totals()`` — the raw and compact views.
"""

from __future__ import annotations

import json
from pathlib import Path

from qfedx_tpu_torch.obs.histo import Histogram
from qfedx_tpu_torch.obs.trace import Span, registry


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list — the ONE
    quantile DEFINITION. The production reporters (phase rollup, the
    serve CLI summary) read quantiles from
    bounded ``obs.Histogram``s, whose ``percentile`` applies THIS rank
    rule to bucket counts — so histogram quantiles land within one
    bucket-width of this function's exact answer (pinned in
    tests/test_torch_obs.py), and exact/approx can never drift on index
    math."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def phase_rollup(spans: list[Span] | None = None) -> dict[str, dict]:
    """Aggregate spans by name → {count, total_s, p50_s, p95_s,
    compile_s}, ordered by total_s descending (the expensive phase reads
    first in summary.json).

    With no argument this reads the registry's per-span-name duration
    HISTOGRAMS (bounded memory, maintained as spans close), not
    the span list: quantiles are bucket-resolution (within one
    bucket-width of exact, always <= exact — lower-edge nearest-rank,
    obs/histo.py) while count/total/compile stay exact sums. An
    explicit span list takes the same path through ephemeral
    histograms, so the two calls cannot disagree on definitions.

    When a parsed profiler capture has attached per-span device
    attribution (obs/profile.attach_span_device), registry rows
    additionally carry ``device_busy_s`` (clamped to the span wall) and
    ``utilization`` in (0, 1]."""
    device_by_name: dict = {}
    if spans is None:
        histos, compile_by_name = registry().span_rollup_source()
        device_by_name = registry().span_device_view()
    else:
        histos = {}
        compile_by_name = {}
        for sp in spans:
            h = histos.get(sp.name)
            if h is None:
                h = histos[sp.name] = Histogram()
            h.record(sp.duration)
            if sp.compile_s > 0:
                compile_by_name[sp.name] = (
                    compile_by_name.get(sp.name, 0.0) + sp.compile_s
                )
    rows = {}
    for name, h in histos.items():
        rows[name] = {
            "count": h.count,
            "total_s": round(h.sum, 6),
            "p50_s": round(h.percentile(0.50), 6),
            "p95_s": round(h.percentile(0.95), 6),
        }
        if compile_by_name.get(name, 0.0) > 0:
            rows[name]["compile_s"] = round(compile_by_name[name], 6)
        if name in device_by_name:
            busy_s, _util = device_by_name[name]
            total_s = rows[name]["total_s"]
            busy_s = round(min(busy_s, total_s), 6)
            # A clamp that zeroes the column (a µs-wall span whose
            # annotation window caught unrelated async device work) is
            # noise, not attribution — leave the row without columns.
            # utilization is recomputed over THIS row's wall so the two
            # columns can never contradict each other (the summary's
            # spans table keeps the annotation-wall ratio).
            if busy_s > 0 and total_s > 0:
                rows[name]["device_busy_s"] = busy_s
                rows[name]["utilization"] = round(
                    min(1.0, busy_s / total_s), 4
                )
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]["total_s"]))


def phase_totals(spans: list[Span] | None = None) -> dict[str, float]:
    """Compact {phase: total_s} view, small enough for a one-line JSON
    report."""
    return {
        name: row["total_s"] for name, row in phase_rollup(spans).items()
    }


def snapshot() -> dict:
    """Raw registry contents as plain JSON-able data."""
    reg = registry()
    return {
        "spans": [
            {
                "name": sp.name,
                "t0": sp.t0 - reg.origin,
                "dur_s": sp.duration,
                "depth": sp.depth,
                "compile_s": sp.compile_s,
                "meta": sp.meta,
            }
            for sp in reg.spans
        ],
        "counters": dict(reg.counters),
        "gauges": dict(reg.gauges),
        "histograms": {
            name: h.snapshot() for name, h in reg.histos.items()
        },
    }


def chrome_trace_events(spans: list[Span] | None = None) -> list[dict]:
    """Spans → Chrome trace-event list ("X" complete events). Timestamps
    are µs since the registry origin (monotonic clock), one pid, tid per
    originating thread — Perfetto renders the nesting from ts/dur."""
    reg = registry()
    spans = reg.spans if spans is None else spans
    tids: dict[int, int] = {}
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": "qfedx_tpu_torch"},
        }
    ]
    for sp in spans:
        if sp.tid not in tids:
            tids[sp.tid] = len(tids)
            # Name the track after the originating thread — the
            # async checkpoint writer puts spans on a second thread, and
            # an anonymous numeric track defeats the point of the trace.
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tids[sp.tid],
                    "args": {"name": sp.tname or "thread"},
                }
            )
        tid = tids[sp.tid]
        args = {k: _jsonable_meta(v) for k, v in sp.meta.items()}
        if sp.compile_s > 0:
            args["compile_ms"] = round(sp.compile_s * 1e3, 3)
        events.append(
            {
                "name": sp.name,
                "ph": "X",
                "ts": round((sp.t0 - reg.origin) * 1e6, 3),
                "dur": round(sp.duration * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": args,
            }
        )
    # Counters as one instant summary event at the end of the window.
    if reg.counters or reg.gauges:
        last = max(
            (e["ts"] + e["dur"] for e in events if e["ph"] == "X"), default=0.0
        )
        events.append(
            {
                "name": "counters",
                "ph": "i",
                "s": "g",
                "ts": last,
                "pid": 1,
                "tid": 0,
                "args": {**reg.counters, **reg.gauges},
            }
        )
    return events


def _jsonable_meta(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_chrome_trace(path: str | Path, spans: list[Span] | None = None) -> Path:
    """Write the registry (or ``spans``) as a Chrome/Perfetto
    ``trace.json``. Plain ``{"traceEvents": [...]}`` array-of-events
    format — both viewers accept it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(
            {
                "traceEvents": chrome_trace_events(spans),
                "displayTimeUnit": "ms",
            }
        )
    )
    return path
