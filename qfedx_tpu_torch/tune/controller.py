"""The online half of the tuning loop: an adaptive serving controller.

Counterpart of ``qfedx_tpu/tune/controller.py`` (a copy over the port's
``obs``). The watchdog (obs/watch.py) DETECTS a breached SLO; this
controller acts on it. It re-picks the micro-batcher's two cheap knobs
(the active flush deadline and the active bucket cap) from the live
telemetry, under three constraints:

1. **Adaptation never builds.** The controller only selects values
   inside the warmed bucket set (``ServeConfig.buckets``, every one run
   by ``ServeEngine.warmup`` before traffic) and a deadline, which is
   host-side timing. The scan-body kernel's ``build_count`` does not
   rise after warmup with the controller on.
2. **Every decision is telemetry.** A committed decision bumps the
   ``tune.decisions`` counter (reverts also ``tune.reverts``), updates
   the ``tune.active_*`` gauges (``qfedx_tune_*`` on /metrics), opens a
   ``tune.decide`` span, records a flight-ring entry and emits a
   schema-1 ``{"event": "tune", ...}`` row through the event sink
   (``set_event_sink``, identity-matched as in obs/watch.py): one
   decision = one counter bump = one event row.
3. **Detection outranks adaptation.** While any watchdog alert is
   firing the controller reverts to the baseline config (the
   ``revert.alert`` decision) and makes no further move until the alert
   clears.

Signals (windowed): ``Histogram.snapshot_delta`` over the
``serve.latency_ms`` instrument gives the p95 of the last tick, and the
``serve.requests_served`` / ``serve.batches`` counter deltas give the
mean batch occupancy the bucket-cap rules read.

Cost model: everything gates on the ``QFEDX_TUNE`` pin (default off: no
controller object, no thread, ``maybe_controller`` returns None and the
batcher reads its static config). The pin carries the decision period
in the QFEDX_WATCH grammar: ``0``/``off`` → disabled, ``1``/``on`` → a
1 s tick, a bare number → that many seconds. While the controller is
enabled the bounded instruments record without QFEDX_TRACE
(``trace.metrics_enabled``); spans stay gated on QFEDX_TRACE alone.

Decision IDs are append-only, like the watchdog's rule IDs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from qfedx_tpu_torch.obs import flight, trace, watch
from qfedx_tpu_torch.utils import pins

# Stable decision identifiers — APPEND-ONLY, like watch.RULE_IDS: the
# metrics.jsonl ledger and dashboards key on these.
DECISION_IDS = (
    "deadline.tighten",
    "deadline.relax",
    "buckets.shrink",
    "buckets.grow",
    "revert.alert",
)

# A decision needs a minimally meaningful window population — a 3-sample
# window p95 is noise, not drift (the watchdog's P95_MIN_COUNT logic).
MIN_WINDOW_COUNT = 16

# The tighten rule halves the active deadline per decision; this floor
# keeps it from collapsing to a busy-poll (baseline / 8 = three halvings).
DEADLINE_FLOOR_DIV = 8


def interval_s() -> float:
    """The QFEDX_TUNE pin: '0'/'off'/unset → 0.0 (controller off, the
    default), '1'/'on' → 1.0 s decision tick, a bare number → that
    period in seconds. Loud on anything else (pins.interval_pin). Read
    per call, toggleable mid-process."""
    return pins.interval_pin("QFEDX_TUNE", on_value=1.0)


def enabled() -> bool:
    return interval_s() > 0


class TuneDecision:
    """One declarative decision kind: a stable id, the signal it reads
    and the pin holding its threshold. The decision logic lives in
    TuneController.decide_once; this class is the documented surface,
    mirroring watch.WatchRule."""

    __slots__ = ("decision_id", "signal", "threshold_pin")

    def __init__(self, decision_id: str, signal: str, threshold_pin: str):
        if decision_id not in DECISION_IDS:
            raise ValueError(f"unknown tune decision id {decision_id!r}")
        self.decision_id = decision_id
        self.signal = signal
        self.threshold_pin = threshold_pin


DECISIONS = (
    TuneDecision(
        "deadline.tighten",
        "serve.latency_ms window p95 vs SLO fraction",
        "QFEDX_TUNE_HI",
    ),
    TuneDecision(
        "deadline.relax",
        "serve.latency_ms window p95 vs SLO fraction",
        "QFEDX_TUNE_LO",
    ),
    TuneDecision(
        "buckets.shrink",
        "serve.requests_served / serve.batches window mean occupancy",
        "QFEDX_TUNE_SHRINK",
    ),
    TuneDecision(
        "buckets.grow",
        "serve.requests_served / serve.batches window mean occupancy",
        "QFEDX_TUNE_GROW",
    ),
    TuneDecision(
        "revert.alert",
        "obs.watch active_alerts() non-empty (backoff)",
        "QFEDX_WATCH",
    ),
)


def decision_taxonomy() -> dict[str, dict]:
    """{decision_id: {signal, threshold_pin}}: the taxonomy table."""
    return {
        d.decision_id: {"signal": d.signal, "threshold_pin": d.threshold_pin}
        for d in DECISIONS
    }


# -- the event sink (mirrors obs/watch.py) -------------------------------------

_sink_lock = threading.Lock()
_sink: Callable[[dict], None] | None = None


def set_event_sink(fn: Callable[[dict], None]) -> None:
    """Register the structured-event consumer (ExperimentRun points this
    at its metrics.jsonl logger, next to the alert sink). Latest wins;
    unregister with ``clear_event_sink(only_if=fn)`` — identity-matched
    so a closing run never evicts a newer one."""
    global _sink
    with _sink_lock:
        _sink = fn


def clear_event_sink(only_if: Callable | None = None) -> None:
    global _sink
    with _sink_lock:
        if only_if is None or _sink is only_if:
            _sink = None


def _emit(event: dict) -> None:
    with _sink_lock:
        sink = _sink
    if sink is None:
        return
    try:
        sink(event)
    except Exception:  # noqa: BLE001 — a dying sink must not kill the ticker
        pass


# -- the controller ------------------------------------------------------------


class TuneController:
    """Adaptive deadline + bucket-cap controller for one ServeEngine.

    Attached by ``ServeEngine.warmup`` (``maybe_controller`` — None when
    QFEDX_TUNE is off) and consulted by ``MicroBatcher._take_locked``
    once per flush: ``deadline_ms`` / ``max_bucket`` are the ACTIVE
    values, initialized to the engine's (baseline) config and only ever
    moved inside the warmed lattice. Each is one attribute, so the
    batcher's read of it is a single read. ``decide_once`` is the
    testable core (what the ticker calls per tick)."""

    def __init__(self, engine, clock=time.monotonic):
        self.engine = engine
        self.baseline = engine.config          # frozen ServeConfig
        self.warmed = tuple(engine.config.buckets)
        self.deadline_ms = float(engine.config.deadline_ms)
        self.max_bucket = int(engine.config.buckets[-1])
        self._clock = clock
        self._lock = threading.Lock()
        self._state: dict = {}                 # counter baselines across ticks
        self.totals = {"decisions": 0, "reverts": 0}
        self._ticker: threading.Thread | None = None
        self._ticker_stop: threading.Event | None = None

    # -- decision core -------------------------------------------------------

    def decide_once(self) -> list[dict]:
        """Evaluate the decision rules against the current window and
        commit at most one deadline move + one bucket move (or one
        alert-backoff revert). Returns the committed decision records.
        No-op returning [] when QFEDX_TUNE is off."""
        if not enabled():
            return []
        # Detection outranks adaptation: while ANY alert is firing, the
        # only legal move is back to baseline — then hold still.
        alerts = watch.active_alerts() if watch.enabled() else []
        trace.gauge("tune.alert_backoff", 1.0 if alerts else 0.0)
        if alerts:
            return self._revert_for_alerts(alerts)

        counters, _gauges, histos, _span_h = trace.registry().instruments()
        out: list[dict] = []

        h = histos.get("serve.latency_ms")
        win = h.snapshot_delta() if h is not None else {"count": 0}
        if win["count"] >= MIN_WINDOW_COUNT:
            out.extend(self._decide_deadline(win))

        out.extend(self._decide_buckets(counters))
        self._publish_gauges()
        return out

    def _decide_deadline(self, win: dict) -> list[dict]:
        slo = self.baseline.slo_ms
        hi = pins.float_pin("QFEDX_TUNE_HI", 0.8)
        lo = pins.float_pin("QFEDX_TUNE_LO", 0.3)
        p95 = win["p95"]
        floor = self.baseline.deadline_ms / DEADLINE_FLOOR_DIV
        with self._lock:
            active = self.deadline_ms
        if p95 >= hi * slo and active > floor:
            new = max(floor, active / 2.0)
            return [self._commit(
                "deadline.tighten", "deadline_ms", active, new,
                value=p95, threshold=hi * slo,
                detail=f"window p95 {p95:.3f}ms >= {hi:g}*SLO "
                       f"({slo:g}ms): deadline {active:g} -> {new:g}ms",
            )]
        if p95 <= lo * slo and active < self.baseline.deadline_ms:
            new = min(self.baseline.deadline_ms, active * 2.0)
            return [self._commit(
                "deadline.relax", "deadline_ms", active, new,
                value=p95, threshold=lo * slo,
                detail=f"window p95 {p95:.3f}ms <= {lo:g}*SLO "
                       f"({slo:g}ms): deadline {active:g} -> {new:g}ms",
            )]
        return []

    def _decide_buckets(self, counters: dict) -> list[dict]:
        served = counters.get("serve.requests_served", 0.0)
        batches = counters.get("serve.batches", 0.0)
        prev = self._state.get("prev_counts")
        self._state["prev_counts"] = (served, batches)
        if prev is None:  # first tick: a baseline, not a window
            return []
        served_d, batches_d = served - prev[0], batches - prev[1]
        if batches_d <= 0:
            return []
        occupancy = served_d / batches_d
        shrink = pins.float_pin("QFEDX_TUNE_SHRINK", 0.25)
        grow = pins.float_pin("QFEDX_TUNE_GROW", 0.9)
        with self._lock:
            cap = self.max_bucket
        idx = self.warmed.index(cap)
        if occupancy <= shrink * cap and idx > 0:
            new = self.warmed[idx - 1]
            return [self._commit(
                "buckets.shrink", "max_bucket", cap, new,
                value=occupancy, threshold=shrink * cap,
                detail=f"mean batch {occupancy:.2f} <= {shrink:g}*cap "
                       f"({cap}): bucket cap {cap} -> {new}",
            )]
        if occupancy >= grow * cap and idx < len(self.warmed) - 1:
            new = self.warmed[idx + 1]
            return [self._commit(
                "buckets.grow", "max_bucket", cap, new,
                value=occupancy, threshold=grow * cap,
                detail=f"mean batch {occupancy:.2f} >= {grow:g}*cap "
                       f"({cap}): bucket cap {cap} -> {new}",
            )]
        return []

    def _revert_for_alerts(self, alerts: list[dict]) -> list[dict]:
        with self._lock:
            at_baseline = (
                self.deadline_ms == self.baseline.deadline_ms
                and self.max_bucket == self.warmed[-1]
            )
            old = (self.deadline_ms, self.max_bucket)
        if at_baseline:
            return []
        rules = ",".join(a["rule"] for a in alerts)
        rec = self._commit(
            "revert.alert", "deadline_ms,max_bucket",
            f"{old[0]:g},{old[1]}",
            f"{self.baseline.deadline_ms:g},{self.warmed[-1]}",
            value=float(len(alerts)), threshold=1.0,
            detail=f"alert(s) firing [{rules}]: revert to baseline",
            revert=True,
        )
        self._publish_gauges()
        return [rec]

    def _commit(
        self, decision_id, field, old, new, *,
        value, threshold, detail, revert=False,
    ) -> dict:
        with trace.span("tune.decide", decision=decision_id):
            with self._lock:
                if revert:
                    self.deadline_ms = float(self.baseline.deadline_ms)
                    self.max_bucket = int(self.warmed[-1])
                elif field == "deadline_ms":
                    self.deadline_ms = float(new)
                else:
                    self.max_bucket = int(new)
                self.totals["decisions"] += 1
                if revert:
                    self.totals["reverts"] += 1
        trace.counter("tune.decisions")
        if revert:
            trace.counter("tune.reverts")
        self._publish_gauges()
        flight.record(
            "tune", decision_id, field=field, old=str(old), new=str(new),
            value=value, threshold=threshold, detail=detail,
        )
        rec = {
            "event": "tune",
            "decision": decision_id,
            "field": field,
            "from": old,
            "to": new,
            "value": value,
            "threshold": threshold,
            "detail": detail,
            "revert": revert,
        }
        _emit(rec)
        return rec

    def _publish_gauges(self) -> None:
        with self._lock:
            dl, cap = self.deadline_ms, self.max_bucket
        trace.gauge("tune.active_deadline_ms", dl)
        trace.gauge("tune.active_max_bucket", float(cap))

    # -- the ticker ----------------------------------------------------------

    def maybe_start(self) -> bool:
        """Start the daemon decision ticker iff QFEDX_TUNE says so
        (default off — returns False, starts no thread). Idempotent;
        called from ServeEngine.warmup."""
        period = interval_s()
        if period <= 0:
            return False
        with self._lock:
            if self._ticker is not None and self._ticker.is_alive():
                return True
            stop_ev = threading.Event()

            def _loop():
                while not stop_ev.wait(interval_s() or period):
                    if stop_ev.is_set():
                        return
                    try:
                        self.decide_once()
                    except Exception:  # noqa: BLE001 — a sick tick must not
                        trace.counter("tune.tick_error")  # kill the ticker
            t = threading.Thread(
                target=_loop, name="qfedx-tune-controller", daemon=True
            )
            self._ticker, self._ticker_stop = t, stop_ev
        t.start()
        return True

    def stop(self) -> None:
        with self._lock:
            t, s = self._ticker, self._ticker_stop
            self._ticker, self._ticker_stop = None, None
        if s is not None:
            s.set()
        if t is not None:
            t.join(timeout=5.0)


def maybe_controller(engine) -> TuneController | None:
    """The engine-warmup attach seam: a controller when QFEDX_TUNE is on,
    None otherwise (the default — the batcher then reads its static
    config exactly as before)."""
    if not enabled():
        return None
    return TuneController(engine)
