"""Experiment tracking: JSONL metrics + run directories.

Counterpart of ``qfedx_tpu/run/metrics.py``: every run gets a directory
with ``config.json``, an append-only ``metrics.jsonl`` (one JSON object
per round, flushed and fsynced per record) and a ``summary.json``
written at the end — the same files, the same schema (version 1) and
the same field names as the reference's, so either package's readers
take either package's runs.

The port runs in one process, so the run directory's name is decided
locally. The flight recorder, the watchdog and the tune controller that
the reference wires into a run (their event rows, the black box, the
SIGTERM drain) and the phase spans of QFEDX_TRACE are not ported yet
(ROADMAP Queue 1 item 14): with their pins off they do nothing in the
reference either, and with a pin on the port raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Mapping

from qfedx_tpu_torch.utils import pins

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

# Pins of the reference's run-level telemetry (ROADMAP Queue 1 item 14).
OBS_PINS = ("QFEDX_TRACE", "QFEDX_FLIGHT", "QFEDX_WATCH", "QFEDX_TUNE",
            "QFEDX_PROFILE", "QFEDX_METRICS_PORT")


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
    when that directory exists and this is not a resume. (The reference
    broadcasts process 0's decision to every process; the port runs in
    one.)"""
    if (root / name).exists() and not resume:
        return f"{name}-{time.strftime('%Y%m%d-%H%M%S')}"
    return name


class MetricsLogger:
    """Append-only JSONL metrics stream; flushed AND fsynced per record,
    so a process or host killed between rounds leaves only whole JSON
    lines behind. Appends from several threads stay whole lines."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._write_lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, record: Mapping[str, Any]) -> None:
        rec = dict(_jsonable(record))
        rec.setdefault("ts", time.time())
        rec.setdefault("schema", METRICS_SCHEMA_VERSION)
        line = json.dumps(rec) + "\n"
        with self._write_lock:
            if self._fh.closed:
                return
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._write_lock:
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
        pins.refuse_unported("Queue 1 item 14", *OBS_PINS)
        self.dir = Path(root) / _agreed_run_dir_name(Path(root), name, resume)
        self.dir.mkdir(parents=True, exist_ok=True)
        if config is not None:
            (self.dir / "config.json").write_text(
                json.dumps(_jsonable(config), indent=2)
            )
        self.metrics = MetricsLogger(self.dir / "metrics.jsonl")
        self._t0 = time.time()

    def on_round_end(self, round_idx: int, metrics: Mapping[str, Any]) -> None:
        self.metrics.log({"round": round_idx + 1, **metrics})

    def checkpointer(self, every: int = 5, keep: int = 3):
        from qfedx_tpu_torch.run.checkpoint import Checkpointer

        return Checkpointer(self.dir / "checkpoints", every=every, keep=keep)

    def finish(self, **summary: Any) -> None:
        summary = dict(summary)
        summary["wall_time_s"] = time.time() - self._t0
        (self.dir / "summary.json").write_text(
            json.dumps(_jsonable(summary), indent=2))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.metrics.close()
