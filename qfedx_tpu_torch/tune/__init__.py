"""qfedx_tpu_torch.tune — the closed loop: telemetry-driven auto-tuning.

Counterpart of ``qfedx_tpu/tune``: two halves over one decision
vocabulary.

- **offline** (``tune.offline``, the ``tune`` subcommand): sweep a
  serving-cell lattice, write a ``best_config.json`` sidecar that
  ``serve --tuned`` / ``train --tuned`` restore through utils/pins.
- **online** (``tune.controller``): an adaptive controller attached at
  ``ServeEngine.warmup`` that re-picks the active flush deadline and
  bucket cap from windowed telemetry — never outside the warmed bucket
  set, never while a watchdog alert is firing, and every decision is
  itself telemetry (``{"event": "tune"}`` rows, ``tune.*`` counters,
  ``qfedx_tune_*`` gauges, ``tune.decide`` spans, flight-ring entries).

This module stays import-light: no torch and no serve imports at module
scope. ``tune.offline`` is imported lazily by its callers (run/cli.py).
"""

from qfedx_tpu_torch.tune.controller import (  # noqa: F401
    DECISION_IDS,
    DECISIONS,
    MIN_WINDOW_COUNT,
    TuneController,
    clear_event_sink,
    decision_taxonomy,
    enabled,
    interval_s,
    maybe_controller,
    set_event_sink,
)
