"""The flight recorder: a bounded ring of recent events, dumped on death.

Counterpart of ``qfedx_tpu/obs/flight.py``. A fixed-size ring of recent
events (span closures, counter/gauge deltas, health transitions,
watchdog alert firings, lifecycle edges) that records at bounded memory
even with tracing off, dumped as one ``flight.json`` when the process
dies badly:

- on SIGTERM, riding the ``utils/host`` translation (SIGTERM →
  ``KeyboardInterrupt("SIGTERM")`` → ``ExperimentRun.__exit__``, or the
  serve loop's drain);
- on any exception unwinding ``ExperimentRun.__exit__``;
- on a watchdog alert firing (obs/watch.py).

Gated on the ``QFEDX_FLIGHT`` pin through the depth grammar
(``pins.depth_pin``): ``0``/``off``/unset → disabled (one env read and
one branch per tap), ``1``/``on`` → 256 events, a bare integer → that
many. Strings are cut at record time; the dump sheds its oldest events
until it fits ``byte_bound()``. The port runs in one process, so the
process that records is the one that dumps (the reference gates the
dump on ``is_primary``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from qfedx_tpu_torch.utils import pins

DEFAULT_CAPACITY = 256
FLIGHT_SCHEMA_VERSION = 1

# Per-event string budget: every str field is cut here at RECORD time,
# so a single event can never blow the dump envelope.
_MAX_STR = 160
# Dump envelope allowance + per-event budget behind byte_bound(): a
# truncated event serializes well under this (fields are capped above).
_ENVELOPE_BYTES = 4096
_PER_EVENT_BYTES = 512

_lock = threading.Lock()
_ring: deque | None = None
_dropped = 0
_dump_path: Path | None = None
_last_dump: dict | None = None


def capacity() -> int:
    """The QFEDX_FLIGHT pin through the shared depth grammar
    (pins.depth_pin): 0/'off'/unset → 0 (recorder off, the default),
    '1'/'on' → DEFAULT_CAPACITY events, a bare integer → that capacity.
    Read per call — the recorder can be toggled mid-process, same as
    QFEDX_TRACE."""
    return pins.depth_pin("QFEDX_FLIGHT", 0, on_value=DEFAULT_CAPACITY)


def enabled() -> bool:
    return capacity() > 0


def byte_bound() -> int:
    """The configured dump-size bound ``dump`` enforces: envelope
    allowance + a fixed per-event budget × the pinned capacity. A
    function of the pin, so operators size the black box with ONE knob."""
    return _ENVELOPE_BYTES + _PER_EVENT_BYTES * capacity()


def _ring_for(cap: int) -> deque:
    """The module ring, (re)built when the pinned capacity changes.
    Callers hold ``_lock``."""
    global _ring
    if _ring is None or _ring.maxlen != cap:
        old = list(_ring) if _ring is not None else []
        _ring = deque(old[-cap:], maxlen=cap)
    return _ring


def _clip(v):
    if v is None or isinstance(v, bool):
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return round(v, 6)
    return str(v)[:_MAX_STR]


def record(kind: str, name: str, **fields) -> None:
    """Append one event to the ring (no-op when QFEDX_FLIGHT is off).
    ``kind`` is the event class (``span``/``counter``/``gauge``/
    ``health``/``alert``/``lifecycle``/...), ``name`` the instrument or
    phase, ``fields`` small scalars — every string is truncated at
    record time so ring memory is a hard function of capacity."""
    cap = capacity()
    if cap <= 0:
        return
    ts = round(time.time(), 3)
    ev = {"t": ts, "kind": str(kind)[:40], "name": str(name)[:_MAX_STR]}
    for k, v in fields.items():
        ev[str(k)[:40]] = _clip(v)
    global _dropped
    with _lock:
        ring = _ring_for(cap)
        if len(ring) == cap:
            _dropped += 1
        ring.append(ev)


# -- taps (called from obs/trace.py and obs/server.py) -------------------------


def on_span(name: str, duration_s: float) -> None:
    record("span", name, ms=duration_s * 1e3)


def on_counter(name: str, inc: float) -> None:
    record("counter", name, inc=inc)


def on_gauge(name: str, value: float) -> None:
    record("gauge", name, value=value)


def on_histogram(name: str, value: float) -> None:
    record("histo", name, value=value)


def on_health(status: str, prev: str) -> None:
    record("health", "status", to=status, was=prev)


# -- the dump ------------------------------------------------------------------


def set_dump_path(path: str | Path | None) -> None:
    """Configure where ``maybe_dump`` writes. ExperimentRun points this
    at ``<run_dir>/flight.json``; the serve CLI at the served run dir.
    Latest caller wins — one process, one black box."""
    global _dump_path
    with _lock:
        _dump_path = Path(path) if path is not None else None


def dump_path() -> Path | None:
    with _lock:
        return _dump_path


def events() -> list[dict]:
    """Snapshot of the ring, oldest first (tests and ad-hoc dumps)."""
    with _lock:
        return list(_ring) if _ring is not None else []


def dropped() -> int:
    with _lock:
        return _dropped


def dump(path: str | Path | None = None, reason: str = "") -> Path | None:
    """Write the black box as ``flight.json``: valid JSON, at most
    ``byte_bound()`` bytes (oldest events are shed until it fits — the
    newest moments are the ones a post-mortem needs). Returns the path,
    or None when the recorder is off or no path is configured. Raises on I/O errors — use ``maybe_dump``
    from crash paths."""
    if not enabled():
        return None
    target = Path(path) if path is not None else dump_path()
    if target is None:
        return None
    with _lock:
        evs = list(_ring) if _ring is not None else []
        dropped_n = _dropped
    bound = byte_bound()
    shed = 0
    while True:
        doc = {
            "schema": FLIGHT_SCHEMA_VERSION,
            "reason": str(reason)[:_MAX_STR],
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "capacity": capacity(),
            "dropped": dropped_n,
            "shed_for_bound": shed,
            "events": evs,
        }
        blob = json.dumps(doc)
        if len(blob) + 1 <= bound or not evs:
            break
        cut = max(1, len(evs) // 8)
        evs = evs[cut:]
        shed += cut
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(blob + "\n")
    global _last_dump
    info = {
        "path": str(target),
        "bytes": len(blob) + 1,
        "reason": doc["reason"],
        "events": len(evs),
        "ts": doc["ts"],
    }
    with _lock:
        _last_dump = info
    return target


def maybe_dump(reason: str = "", path: str | Path | None = None) -> Path | None:
    """``dump`` that never raises — the crash-path wrapper (a failing
    black-box write must not mask the actual crash, the same contract
    as ExperimentRun.flush_partial_observability)."""
    try:
        return dump(path, reason)
    except Exception:  # noqa: BLE001 — dumping must not mask the crash
        return None


def last_dump() -> dict | None:
    """{path, bytes, reason, events, ts} of the most recent dump this
    process wrote (None before the first)."""
    with _lock:
        return dict(_last_dump) if _last_dump else None


def reset() -> None:
    """Drop the ring, the configured path and the last-dump record
    (tests isolate themselves with this, like obs.reset)."""
    global _ring, _dropped, _dump_path, _last_dump
    with _lock:
        _ring = None
        _dropped = 0
        _dump_path = None
        _last_dump = None
