"""Observability: spans, counters, histograms, exporters, live endpoints.

Counterpart of ``qfedx_tpu/obs``, with the reference's names:

- host spans and instruments (``obs.span``, ``obs.counter``,
  ``obs.gauge``, ``obs.histogram``, ``obs.trace_context``; gated on
  ``QFEDX_TRACE``), rolled up into ``metrics.jsonl`` rows and
  ``summary.json`` and written as Perfetto-loadable ``trace.json``;
- the live half: bounded log-bucketed histograms (``obs.Histogram``),
  the /metrics + /healthz endpoint (``QFEDX_METRICS_PORT``;
  obs/server.py) and trace shards with their merge;
- the device half: crash-safe ``torch.profiler`` captures and a parsed
  device-timeline census (``obs.profile``; ``QFEDX_PROFILE``), and the
  executed-op census (``obs.census``, the counterpart of the reference's
  HLO census);
- the detection half: the SLO watchdog (``obs.watch``; ``QFEDX_WATCH``)
  and the flight recorder (``obs.flight``; ``QFEDX_FLIGHT``).

Usage::

    from qfedx_tpu_torch import obs

    with obs.span("round.dispatch", round=rnd) as sp:
        params, stats = round_fn(...)
    obs.counter("fuse.ops_in", len(ops))
    obs.histogram("serve.latency_ms", lat_ms)
    obs.write_chrome_trace(run_dir / "trace.json")
"""

from qfedx_tpu_torch.obs import census, flight, profile, watch
from qfedx_tpu_torch.obs.export import (
    chrome_trace_events,
    percentile,
    phase_rollup,
    phase_totals,
    snapshot,
    write_chrome_trace,
)
from qfedx_tpu_torch.obs.histo import Histogram
from qfedx_tpu_torch.obs.merge import (
    add_device_lane,
    find_shards,
    merge_trace_shards,
    shard_path,
    write_trace_shard,
)
from qfedx_tpu_torch.obs.trace import (
    Span,
    counter,
    enabled,
    gauge,
    histogram,
    metrics_enabled,
    record_device_memory,
    registry,
    reset,
    span,
    trace_context,
    xla_annotations_enabled,
)

__all__ = [
    "Histogram",
    "Span",
    "add_device_lane",
    "census",
    "chrome_trace_events",
    "counter",
    "enabled",
    "find_shards",
    "flight",
    "gauge",
    "histogram",
    "merge_trace_shards",
    "metrics_enabled",
    "percentile",
    "phase_rollup",
    "phase_totals",
    "profile",
    "record_device_memory",
    "registry",
    "reset",
    "shard_path",
    "snapshot",
    "span",
    "trace_context",
    "watch",
    "write_chrome_trace",
    "write_trace_shard",
    "xla_annotations_enabled",
]
