"""Experiment tracking: JSONL metrics + run directories.

Counterpart of ``qfedx_tpu/run/metrics.py``: every run gets a directory
with ``config.json``, an append-only ``metrics.jsonl`` (one JSON object
per round, flushed and fsynced per record) and a ``summary.json``
written at the end — the same files, the same schema (version 1) and
the same field names as the reference's, so either package's readers
take either package's runs.

Under a ``torch.distributed`` process group only the primary process
(``utils/host.is_primary``, rank 0) writes: the others get the same
directory name (rank 0 decides it) and a no-op logger, as in the
reference. A run translates SIGTERM into ``KeyboardInterrupt`` while it is
open (``utils/host``), so an orchestrator's TERM unwinds it like a
Ctrl-C. A run wires the observability layer in as the reference does:
the flight recorder dumps ``flight.json`` into the run directory
(``QFEDX_FLIGHT``) on any unwinding exception, watchdog alerts land in
``metrics.jsonl`` as ``{"event": "alert"}`` rows (``QFEDX_WATCH``), and
with ``QFEDX_TRACE`` the summary carries ``phase_breakdown`` and
``obs_counters`` — and a crash still leaves ``trace.json`` and a partial
summary (``flush_partial_observability``). The tune controller's
decisions (``QFEDX_TUNE``) land in the same ``metrics.jsonl`` as
``{"event": "tune"}`` rows, through the same identity-matched sink.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Mapping

from qfedx_tpu_torch.utils.host import (
    install_sigterm_interrupt,
    is_primary,
    restore_sigterm,
)

# Every row carries ``"schema": METRICS_SCHEMA_VERSION``; bump it when a
# REQUIRED field is renamed or retyped.
METRICS_SCHEMA_VERSION = 1

# Required fields (name -> type predicate) of a round row at schema 1.
_REQUIRED_FIELDS: dict[str, Any] = {
    "schema": lambda v: v == METRICS_SCHEMA_VERSION,
    "round": lambda v: isinstance(v, int) and v >= 1,
    "ts": lambda v: isinstance(v, (int, float)),
}

# Event rows (alerts, tune decisions) are keyed by "event", not "round".
_EVENT_REQUIRED_FIELDS: dict[str, Any] = {
    "schema": lambda v: v == METRICS_SCHEMA_VERSION,
    "event": lambda v: isinstance(v, str) and bool(v),
    "ts": lambda v: isinstance(v, (int, float)),
}


def validate_metrics_record(rec: Mapping[str, Any]) -> dict:
    """Validate one parsed metrics.jsonl record against the schema;
    returns the record, raises ``ValueError`` naming the offending
    field. Rows with an ``"event"`` field validate as event rows,
    everything else as round rows."""
    required = _EVENT_REQUIRED_FIELDS if "event" in rec else _REQUIRED_FIELDS
    for name, ok in required.items():
        if name not in rec:
            raise ValueError(
                f"metrics record missing required field {name!r} "
                f"(schema {METRICS_SCHEMA_VERSION}): {dict(rec)!r}"
            )
        if not ok(rec[name]):
            raise ValueError(
                f"metrics record field {name!r} = {rec[name]!r} invalid "
                f"at schema {METRICS_SCHEMA_VERSION}"
            )
    return dict(rec)


def _jsonable(x: Any) -> Any:
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, Mapping):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def _agreed_run_dir_name(root: Path, name: str, resume: bool) -> str:
    """The run directory's name: ``name``, or ``name`` plus a timestamp
    when that directory exists and this is not a resume. The primary
    decides and a process group takes its decision: each process
    deciding alone would race the primary's mkdir and could resume from
    another directory than the primary's."""
    import torch.distributed as dist

    stamp = ""
    if is_primary() and (root / name).exists() and not resume:
        stamp = time.strftime("%Y%m%d-%H%M%S")
    if dist.is_available() and dist.is_initialized():
        box = [stamp]
        dist.broadcast_object_list(box, src=0)
        stamp = box[0]
    return f"{name}-{stamp}" if stamp else name


class MetricsLogger:
    """Append-only JSONL metrics stream; flushed AND fsynced per record,
    so a process or host killed between rounds leaves only whole JSON
    lines behind. Appends from several threads stay whole lines. Only
    the primary process writes; the others log into a no-op."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._write_lock = threading.Lock()
        self._fh = None
        if is_primary():
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, record: Mapping[str, Any]) -> None:
        rec = dict(_jsonable(record))
        rec.setdefault("ts", time.time())
        rec.setdefault("schema", METRICS_SCHEMA_VERSION)
        line = json.dumps(rec) + "\n"
        with self._write_lock:
            if self._fh is None or self._fh.closed:
                return
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._write_lock:
            if self._fh is not None:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ExperimentRun:
    """One tracked run: directory + config snapshot + metrics + summary.

    Usage::

        with ExperimentRun("runs", name="vqc12q", config=cfg) as run:
            res = train_federated(..., on_round_end=run.on_round_end,
                                  checkpointer=run.checkpointer(every=5))
            run.finish(final_accuracy=res.final_accuracy)
    """

    def __init__(
        self, root: str | Path, name: str, config: Any = None, resume: bool = False
    ):
        self.dir = Path(root) / _agreed_run_dir_name(Path(root), name, resume)
        if is_primary():
            self.dir.mkdir(parents=True, exist_ok=True)
            if config is not None:
                (self.dir / "config.json").write_text(
                    json.dumps(_jsonable(config), indent=2)
                )
        self.metrics = MetricsLogger(self.dir / "metrics.jsonl")
        self._t0 = time.time()
        # The black box lands in THIS run's directory and the watchdog's
        # alerts in THIS run's metrics.jsonl (both no-ops with their pins
        # off); the sink is identity-matched on __exit__.
        from qfedx_tpu_torch import tune
        from qfedx_tpu_torch.obs import flight, watch

        flight.set_dump_path(self.dir / "flight.json")
        self._alert_sink = self.metrics.log
        watch.set_event_sink(self._alert_sink)
        # The tune controller's decision rows ride the same sink.
        tune.set_event_sink(self._alert_sink)

    def on_round_end(self, round_idx: int, metrics: Mapping[str, Any]) -> None:
        self.metrics.log({"round": round_idx + 1, **metrics})
        # The round edge in the flight ring (bounded; off by default).
        from qfedx_tpu_torch.obs import flight

        flight.record("round", f"r{round_idx + 1}",
                      loss=metrics.get("loss"),
                      accuracy=metrics.get("accuracy"))

    def checkpointer(self, every: int = 5, keep: int = 3):
        from qfedx_tpu_torch.run.checkpoint import Checkpointer

        return Checkpointer(self.dir / "checkpoints", every=every, keep=keep)

    def finish(self, **summary: Any) -> None:
        if not is_primary():
            return
        from qfedx_tpu_torch import obs

        summary = dict(summary)
        summary["wall_time_s"] = time.time() - self._t0
        if obs.enabled():
            # The per-phase rollup of every span the run recorded.
            summary["phase_breakdown"] = obs.phase_rollup()
            counters = obs.registry().counters
            if counters:
                summary["obs_counters"] = {
                    k: round(v, 6) for k, v in counters.items()
                }
        (self.dir / "summary.json").write_text(
            json.dumps(_jsonable(summary), indent=2))

    def flush_partial_observability(self, reason: str) -> None:
        """Crash-flush: write the COMPLETED spans as a valid trace.json
        and, when no summary exists yet, a partial summary with the
        phase rollup. Spans still open at the crash never reached the
        registry, so the trace parses. Never raises."""
        from qfedx_tpu_torch import obs

        if not is_primary() or not obs.enabled():
            return
        try:
            obs.write_chrome_trace(self.dir / "trace.json")
            if not (self.dir / "summary.json").exists():
                partial = {
                    "partial": True,
                    "crashed": reason,
                    "wall_time_s": time.time() - self._t0,
                    "phase_breakdown": obs.phase_rollup(),
                }
                counters = obs.registry().counters
                if counters:
                    partial["obs_counters"] = {
                        k: round(v, 6) for k, v in counters.items()
                    }
                (self.dir / "summary.json").write_text(
                    json.dumps(_jsonable(partial), indent=2)
                )
        except Exception:  # noqa: BLE001 — flushing must not mask the crash
            pass

    def __enter__(self):
        # The streamed trainer and serve install their own translation
        # on top; each restores what it found.
        from qfedx_tpu_torch.obs import flight

        self._sigterm_token = install_sigterm_interrupt()
        flight.record("lifecycle", "run.start", dir=str(self.dir))
        return self

    def __exit__(self, exc_type, exc, tb):
        from qfedx_tpu_torch import tune
        from qfedx_tpu_torch.obs import flight, watch

        restore_sigterm(getattr(self, "_sigterm_token", None))
        watch.clear_event_sink(only_if=self._alert_sink)
        tune.clear_event_sink(only_if=self._alert_sink)
        if exc_type is not None:
            # The black box dumps on ANY unwinding exception, SIGTERM's
            # KeyboardInterrupt included, and needs no QFEDX_TRACE.
            flight.maybe_dump(
                reason=getattr(exc_type, "__name__", str(exc_type)))
        self.metrics.close()
        if exc_type is not None:
            self.flush_partial_observability(
                getattr(exc_type, "__name__", str(exc_type)))
