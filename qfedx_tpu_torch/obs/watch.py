"""The SLO watchdog: declarative alert rules evaluated on a ticker.

Counterpart of ``qfedx_tpu/obs/watch.py``, with the same stable rule IDs
(``RULE_IDS``), the same rules and thresholds (``QFEDX_SERVE_SLO_MS``,
``QFEDX_WATCH_SHED``, ``QFEDX_WATCH_QUEUE``, ``QFEDX_WATCH_STALL_S``,
``QFEDX_WATCH_LOSS_MAX``, ``QFEDX_WATCH_EPS``), evaluated against the
live obs registry and the ``/healthz`` component sources on a daemon
ticker (``maybe_start``) or explicitly (``evaluate_once``).

A rule transitioning to FIRING sets the ``alert.<rule_id>`` gauge, bumps
``alert.fired.<rule_id>``, joins the ``alerts`` section of ``/healthz``
(which then answers 503 and names the rule), emits an ``{"event":
"alert", ...}`` row through the event sink (``ExperimentRun`` points it
at its ``metrics.jsonl``), records into the flight ring and dumps the
black box. Clearing reverses the gauge and emits a ``cleared`` row.

Everything gates on the ``QFEDX_WATCH`` pin (default off — no thread, no
state; ``evaluate_once`` returns []): ``1``/``on`` → a 1 s tick, a bare
number → that period. While it is on, the bounded instruments record
even without QFEDX_TRACE (``trace.metrics_enabled``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable

from qfedx_tpu_torch.obs import flight, trace
from qfedx_tpu_torch.utils import pins

# Stable rule identifiers — APPEND-ONLY, like faults.SITES: alert
# consumers (dashboards, the metrics.jsonl ledger, the taxonomy table)
# key on these strings.
RULE_IDS = (
    "serve.p95_slo",
    "serve.shed_rate",
    "serve.queue_sat",
    "trainer.stall",
    "trainer.loss",
    "trainer.eps_burn",
)

# serve.p95_slo holds fire until the latency histogram has a minimally
# meaningful population — a 2-sample p95 is noise, not an SLO breach.
P95_MIN_COUNT = 20


def interval_s() -> float:
    """The QFEDX_WATCH pin: '0'/'off'/unset → 0.0 (watchdog off, the
    default), '1'/'on' → 1.0 s tick, a bare number → that tick period in
    seconds. Loud on anything else (the family grammar). Read per call —
    host-side guard, toggleable mid-process like QFEDX_TRACE."""
    env = pins.str_pin("QFEDX_WATCH")
    if env is None:
        return 0.0
    as_bool = pins.parse_onoff(env)
    if as_bool is not None:
        return 1.0 if as_bool else 0.0
    try:
        period = float(env)
    except ValueError:
        raise ValueError(
            f"QFEDX_WATCH={env!r}: expected '0'/'off', '1'/'on' or a tick "
            "period in seconds"
        ) from None
    if not period > 0:
        raise ValueError(f"QFEDX_WATCH={env!r}: tick period must be > 0")
    return period


def enabled() -> bool:
    return interval_s() > 0


class Snapshot:
    """One tick's consistent view of the world: registry instruments +
    /healthz component sources + the elapsed time since the previous
    tick (what the delta rules normalize against)."""

    __slots__ = ("counters", "gauges", "histos", "components", "elapsed_s")

    def __init__(self, counters, gauges, histos, components, elapsed_s):
        self.counters = counters
        self.gauges = gauges
        self.histos = histos
        self.components = components
        self.elapsed_s = elapsed_s


class WatchRule:
    """One declarative rule: a stable id, the signal it reads, the pin
    holding its threshold, and a pure check over a Snapshot returning
    ``None`` (quiet) or ``(value, threshold, detail)`` (firing).
    ``state`` is the rule's private scratch dict across ticks (previous
    counter values for the delta rules)."""

    __slots__ = ("rule_id", "signal", "threshold_pin", "_check")

    def __init__(self, rule_id: str, signal: str, threshold_pin: str, check):
        if rule_id not in RULE_IDS:
            raise ValueError(f"unknown watch rule id {rule_id!r}")
        self.rule_id = rule_id
        self.signal = signal
        self.threshold_pin = threshold_pin
        self._check = check

    def check(self, snap: Snapshot, state: dict):
        return self._check(snap, state)


# -- the rules -----------------------------------------------------------------


def _check_p95_slo(snap: Snapshot, state: dict):
    h = snap.histos.get("serve.latency_ms")
    if h is None or h.count < P95_MIN_COUNT:
        return None
    slo = pins.float_pin("QFEDX_SERVE_SLO_MS", 50.0)
    p95 = h.percentile(0.95)
    if p95 > slo:
        return (p95, slo, f"serve p95 {p95:.3f}ms > SLO {slo:.3f}ms")
    return None


def _check_shed_rate(snap: Snapshot, state: dict):
    now = snap.counters.get("serve.requests_shed", 0.0) + snap.counters.get(
        "serve.requests_rejected", 0.0
    )
    prev = state.get("prev")
    state["prev"] = now
    if prev is None:  # first tick: a baseline, not a window
        return None
    delta = now - prev
    threshold = pins.float_pin("QFEDX_WATCH_SHED", 1.0)
    if delta >= threshold:
        return (
            delta,
            threshold,
            f"{delta:g} requests shed/rejected since last tick",
        )
    return None


def _check_queue_sat(snap: Snapshot, state: dict):
    comp = snap.components.get("serve")
    if not isinstance(comp, dict) or "queue_depth" not in comp:
        return None
    max_queue = comp.get("max_queue", 0)
    if not max_queue:
        return None
    frac = float(comp["queue_depth"]) / float(max_queue)
    threshold = pins.float_pin("QFEDX_WATCH_QUEUE", 0.9)
    if frac >= threshold:
        return (
            frac,
            threshold,
            f"queue {comp['queue_depth']}/{max_queue} "
            f"({frac:.0%} of max_queue)",
        )
    return None


def _check_trainer_stall(snap: Snapshot, state: dict):
    comp = snap.components.get("trainer")
    if not isinstance(comp, dict) or "last_flush_age_s" not in comp:
        return None
    age = float(comp["last_flush_age_s"])
    threshold = pins.float_pin("QFEDX_WATCH_STALL_S", 120.0)
    if age > threshold:
        return (age, threshold, f"no metrics flush for {age:.1f}s")
    return None


def _check_loss(snap: Snapshot, state: dict):
    loss = snap.gauges.get("fed.loss")
    if loss is None:
        return None
    limit = pins.float_pin("QFEDX_WATCH_LOSS_MAX", math.inf)
    if not math.isfinite(loss):
        return (loss, limit, f"loss is non-finite ({loss})")
    if loss > limit:
        return (loss, limit, f"loss {loss:.6g} > QFEDX_WATCH_LOSS_MAX {limit:g}")
    return None


def _check_eps_burn(snap: Snapshot, state: dict):
    eps = snap.gauges.get("fed.epsilon")
    if eps is None:
        return None
    budget = pins.float_pin("QFEDX_WATCH_EPS", math.inf)
    if eps > budget:
        return (eps, budget, f"DP epsilon {eps:.4f} > budget {budget:g}")
    return None


RULES = (
    WatchRule(
        "serve.p95_slo",
        "serve.latency_ms histogram p95",
        "QFEDX_SERVE_SLO_MS",
        _check_p95_slo,
    ),
    WatchRule(
        "serve.shed_rate",
        "serve.requests_shed + serve.requests_rejected counter delta",
        "QFEDX_WATCH_SHED",
        _check_shed_rate,
    ),
    WatchRule(
        "serve.queue_sat",
        "serve health source queue_depth / max_queue",
        "QFEDX_WATCH_QUEUE",
        _check_queue_sat,
    ),
    WatchRule(
        "trainer.stall",
        "trainer health source last_flush_age_s",
        "QFEDX_WATCH_STALL_S",
        _check_trainer_stall,
    ),
    WatchRule(
        "trainer.loss",
        "fed.loss gauge (non-finite always fires)",
        "QFEDX_WATCH_LOSS_MAX",
        _check_loss,
    ),
    WatchRule(
        "trainer.eps_burn",
        "fed.epsilon gauge",
        "QFEDX_WATCH_EPS",
        _check_eps_burn,
    ),
)


def rule_taxonomy() -> dict[str, dict]:
    """{rule_id: {signal, threshold_pin}}, the rule table operators
    read."""
    return {
        r.rule_id: {"signal": r.signal, "threshold_pin": r.threshold_pin}
        for r in RULES
    }


# -- evaluation state ----------------------------------------------------------

_lock = threading.Lock()
_rule_state: dict[str, dict] = {}      # per-rule scratch across ticks
_active: dict[str, dict] = {}          # rule_id -> firing alert record
_fired_total: dict[str, int] = {}      # rule_id -> lifetime firing count
_last_tick: float | None = None
_sink: Callable[[dict], None] | None = None
_ticker: "threading.Thread | None" = None
_ticker_stop: "threading.Event | None" = None


def set_event_sink(fn: Callable[[dict], None]) -> None:
    """Register the structured-event consumer (ExperimentRun points this
    at its metrics.jsonl logger). Latest wins; unregister with
    ``clear_event_sink(only_if=fn)`` — identity-matched like the
    /healthz sources, so a closing run never evicts a newer one."""
    global _sink
    with _lock:
        _sink = fn


def clear_event_sink(only_if: Callable | None = None) -> None:
    global _sink
    with _lock:
        if only_if is None or _sink is only_if:
            _sink = None


def _emit(event: dict) -> None:
    with _lock:
        sink = _sink
    if sink is None:
        return
    try:
        sink(event)
    except Exception:  # noqa: BLE001 — a dying sink must not kill the ticker
        pass


def evaluate_once() -> list[dict]:
    """Run every rule against a fresh snapshot; fire/clear transitions;
    return the currently active alerts (what the ticker calls per tick
    and tests call directly — same code path, no thread required).
    No-op returning [] when QFEDX_WATCH is off."""
    if not enabled():
        return []
    from qfedx_tpu_torch.obs import server

    counters, gauges, histos, _span_histos = trace.registry().instruments()
    components = server.health_components()
    now = time.monotonic()
    global _last_tick
    with _lock:
        elapsed = (now - _last_tick) if _last_tick is not None else 0.0
        _last_tick = now
    snap = Snapshot(counters, gauges, histos, components, elapsed)
    fired: list[tuple[str, dict]] = []
    cleared: list[str] = []
    for rule in RULES:
        with _lock:
            state = _rule_state.setdefault(rule.rule_id, {})
        try:
            hit = rule.check(snap, state)
        except Exception:  # noqa: BLE001 — one sick rule must not blind the rest
            hit = None
            trace.counter(f"alert.check_error.{rule.rule_id}")
        with _lock:
            was_active = rule.rule_id in _active
            if hit is not None:
                value, threshold, detail = hit
                rec = {
                    "rule": rule.rule_id,
                    "value": value,
                    "threshold": threshold,
                    "detail": detail,
                    "since": _active[rule.rule_id]["since"]
                    if was_active
                    else round(time.time(), 3),
                }
                _active[rule.rule_id] = rec
                if not was_active:
                    _fired_total[rule.rule_id] = (
                        _fired_total.get(rule.rule_id, 0) + 1
                    )
                    fired.append((rule.rule_id, rec))
            elif was_active:
                _active.pop(rule.rule_id, None)
                cleared.append(rule.rule_id)
        trace.gauge(f"alert.{rule.rule_id}", 1.0 if hit is not None else 0.0)
    for rid, rec in fired:
        trace.counter(f"alert.fired.{rid}")
        flight.record(
            "alert", rid, state="firing",
            value=rec["value"], threshold=rec["threshold"],
            detail=rec["detail"],
        )
        _emit({
            "event": "alert",
            "state": "firing",
            "rule": rid,
            "value": rec["value"],
            "threshold": rec["threshold"],
            "detail": rec["detail"],
        })
        # The black box dumps the moment detection trips — the process
        # may not live to a clean unwind.
        flight.maybe_dump(reason=f"alert.{rid}")
    for rid in cleared:
        flight.record("alert", rid, state="cleared")
        _emit({"event": "alert", "state": "cleared", "rule": rid})
    return active_alerts()


def active_alerts() -> list[dict]:
    """The currently firing alerts, sorted by rule id — what /healthz
    renders under ``alerts.active``."""
    with _lock:
        return [dict(_active[rid]) for rid in sorted(_active)]


def fired_totals() -> dict[str, int]:
    """Lifetime {rule_id: firing count} (transitions, not ticks) — the
    /healthz ``fired_total``."""
    with _lock:
        return dict(_fired_total)


# -- the ticker ----------------------------------------------------------------


def maybe_start() -> bool:
    """Start the daemon ticker iff QFEDX_WATCH says so (default off —
    returns False, starts no thread). Idempotent; called from the same
    startup seams as obs_server.maybe_start (batcher.start,
    engine.warmup, the streamed trainer)."""
    period = interval_s()
    if period <= 0:
        return False
    global _ticker, _ticker_stop
    with _lock:
        if _ticker is not None and _ticker.is_alive():
            return True
        stop = threading.Event()

        def _loop():
            while not stop.wait(interval_s() or period):
                if stop.is_set():
                    return
                evaluate_once()

        t = threading.Thread(target=_loop, name="qfedx-watchdog", daemon=True)
        _ticker, _ticker_stop = t, stop
    t.start()
    return True


def stop() -> None:
    """Stop the ticker thread (tests / embedders); rule state survives —
    use ``reset`` for full isolation."""
    global _ticker, _ticker_stop
    with _lock:
        t, s = _ticker, _ticker_stop
        _ticker, _ticker_stop = None, None
    if s is not None:
        s.set()
    if t is not None:
        t.join(timeout=5.0)


def reset() -> None:
    """Stop the ticker and drop all alert/rule state (test isolation,
    like obs.reset / flight.reset)."""
    stop()
    global _last_tick, _sink
    with _lock:
        _rule_state.clear()
        _active.clear()
        _fired_total.clear()
        _last_tick = None
        _sink = None
