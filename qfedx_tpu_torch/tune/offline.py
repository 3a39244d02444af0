"""The offline half of the tuning loop: ``tune`` lattice sweeps.

Counterpart of ``qfedx_tpu/tune/offline.py``. Sweeps a small lattice of
serving cells — bucket sets × deadlines × route-pin overlays — through
the real serving stack (``ServeEngine`` warmup + ``MicroBatcher``
offered load), scores each cell by the bounded-histogram quantile rule
(obs/histo.py — ``throughput_at_slo``: the best completed throughput
whose p95 meets the SLO with nothing shed, ties broken by the lower
p95), and writes the winner as a ``best_config.json`` sidecar that
``serve --tuned`` and ``train --tuned`` restore.

Every cell shares one restored model. ``_measure_cell`` times
``engine.infer`` with ``time.perf_counter``; ``infer`` returns after the
device→host copy, so each timed window holds the device's work.

Pin discipline: route overlays apply through ``pins.set_pin`` /
``clear_pin`` and restore the prior value afterwards (``_pin_overlay``),
and ``apply_best_config`` never clobbers a pin the operator set
(``pins.pin_is_set``), so a sidecar is a default overlay, not an
override. The record's ``key.backend`` is the torch device type the
cells ran on (``"cuda"`` or ``"cpu"``).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from qfedx_tpu_torch import obs
from qfedx_tpu_torch.utils import pins

BEST_CONFIG_FILENAME = "best_config.json"
BEST_CONFIG_SCHEMA = 1


@contextmanager
def _pin_overlay(values: dict[str, str]):
    """Apply a route-pin overlay for one sweep cell and restore the
    previous environment on exit, through utils/pins."""
    saved = {name: pins.str_pin(name) for name in values}
    try:
        for name, value in values.items():
            pins.set_pin(name, str(value))
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                pins.clear_pin(name)
            else:
                pins.set_pin(name, old)


def _measure_cell(engine, requests: int, rate_fracs, seed: int) -> dict:
    """Offered-load score for one warmed cell: capacity from the warm
    max-bucket batch, then uniform arrivals at each fraction of it;
    throughput_at_slo is the best completed rps whose p95 meets the
    config's SLO, shed-free."""
    from qfedx_tpu_torch.serve.batcher import MicroBatcher, Overloaded

    cfg = engine.config
    n_cap = cfg.buckets[-1]
    rng = np.random.default_rng(seed)
    x_cap = rng.uniform(
        0, 1, (n_cap,) + engine.feature_shape
    ).astype(np.float32)
    engine.infer(x_cap)  # warm the timing path
    batch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.infer(x_cap)
        batch_s.append(time.perf_counter() - t0)
    capacity = n_cap / max(sorted(batch_s)[1], 1e-6)

    reqs = rng.uniform(
        0, 1, (requests,) + engine.feature_shape
    ).astype(np.float32)
    rates = {}
    for frac in rate_fracs:
        rate = frac * capacity
        gap = 1.0 / rate
        futs, shed = [], 0
        with MicroBatcher(engine) as b:
            t_next = time.monotonic()
            for i in range(requests):
                now = time.monotonic()
                if now < t_next:
                    time.sleep(t_next - now)
                t_next += gap
                try:
                    futs.append(b.submit(reqs[i]))
                except Overloaded:
                    shed += 1
            for f in futs:
                f.result(timeout=60.0)
        if not futs:
            rates[f"load_{frac:g}"] = {"offered_rps": round(rate, 1),
                                       "shed": shed}
            continue
        hist = obs.Histogram()
        for f in futs:
            hist.record((f.done_t - f.submit_t) * 1e3)
        wall = max(f.done_t for f in futs) - futs[0].submit_t
        rates[f"load_{frac:g}"] = {
            "offered_rps": round(rate, 1),
            "completed_rps": round(len(futs) / max(wall, 1e-9), 1),
            "p50_ms": round(hist.percentile(0.50), 3),
            "p95_ms": round(hist.percentile(0.95), 3),
            "shed": shed,
        }
    ok = [
        r for r in rates.values()
        if r.get("p95_ms") is not None
        and r["p95_ms"] <= cfg.slo_ms and r["shed"] == 0
    ]
    best = max(ok, key=lambda r: r["completed_rps"]) if ok else None
    return {
        "throughput_at_slo": best["completed_rps"] if best else 0.0,
        "p50_ms": best["p50_ms"] if best else None,
        "p95_ms": best["p95_ms"] if best else None,
        "capacity_rps": round(capacity, 1),
        "rates": rates,
    }


def sweep_serve(
    model,
    params,
    feature_shape: tuple[int, ...],
    *,
    slo_ms: float = 50.0,
    bucket_sets: tuple[tuple[int, ...], ...] = ((1, 8, 32),),
    deadlines_ms: tuple[float, ...] = (5.0,),
    route_cells: tuple[dict, ...] = ({},),
    requests: int = 96,
    rate_fracs: tuple[float, ...] = (0.5, 0.8),
    max_queue: int = 256,
    seed: int = 0,
    device=None,
) -> dict:
    """Sweep the (bucket set × deadline × route overlay) lattice on
    ``device`` (None = the card) and return ``{"cells": [...], "best":
    {...}, "key": {...}}``. One model is shared by every cell."""
    from qfedx_tpu_torch.serve.engine import ServeConfig, ServeEngine

    device = pins.resolve_device(device)
    cells = []
    for route in route_cells:
        with _pin_overlay(route):
            for bs in bucket_sets:
                for dl in deadlines_ms:
                    cfg = ServeConfig(
                        buckets=tuple(bs), deadline_ms=float(dl),
                        max_queue=max_queue, slo_ms=float(slo_ms),
                    )
                    engine = ServeEngine(
                        model, params, feature_shape, config=cfg,
                        device=device,
                    )
                    warm = engine.warmup()
                    score = _measure_cell(engine, requests, rate_fracs, seed)
                    cells.append({
                        "buckets": list(bs),
                        "deadline_ms": float(dl),
                        "route": dict(route),
                        "route_resolved": warm.get("route_resolved"),
                        **score,
                    })
    best = max(
        cells,
        key=lambda c: (c["throughput_at_slo"], -(c["p95_ms"] or 1e18)),
    )
    key = {
        "model": getattr(model, "name", "unknown"),
        "feature_shape": list(feature_shape),
        "backend": device.type,
        "slo_ms": float(slo_ms),
    }
    return {"cells": cells, "best": best, "key": key}


def best_config_record(sweep: dict, *, requests: int, source: str) -> dict:
    """The sidecar payload: the winning cell expressed as pins (what
    ``serve --tuned`` replays through utils/pins), plus its score and
    every cell's record, so ``inspect`` can show the lattice."""
    best = sweep["best"]
    pin_values = {
        "QFEDX_SERVE_BUCKETS": ",".join(str(b) for b in best["buckets"]),
        "QFEDX_SERVE_DEADLINE_MS": f"{best['deadline_ms']:g}",
    }
    pin_values.update({k: str(v) for k, v in best["route"].items()})
    return {
        "schema": BEST_CONFIG_SCHEMA,
        "key": sweep["key"],
        "pins": pin_values,
        "score": {
            "metric": "throughput_at_slo",
            "throughput_at_slo": best["throughput_at_slo"],
            "p50_ms": best["p50_ms"],
            "p95_ms": best["p95_ms"],
        },
        "cells": sweep["cells"],
        "provenance": {
            "source": source,
            "requests": requests,
            "ts": round(time.time(), 3),
        },
    }


def write_best_config(path: str | os.PathLike, record: dict) -> Path:
    """Atomic sidecar write: tmp + rename with a trailing newline, so a
    reader never sees a torn JSON document."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(record, indent=1) + "\n")
    os.replace(tmp, path)
    return path


def load_best_config(path: str | os.PathLike) -> dict:
    """Read a sidecar (a file, or a directory containing
    ``best_config.json``); loud on a schema mismatch."""
    path = Path(path)
    if path.is_dir():
        path = path / BEST_CONFIG_FILENAME
    record = json.loads(path.read_text())
    if record.get("schema") != BEST_CONFIG_SCHEMA:
        raise ValueError(
            f"{path}: best_config schema {record.get('schema')!r} != "
            f"{BEST_CONFIG_SCHEMA} — re-run `tune`"
        )
    if not isinstance(record.get("pins"), dict):
        raise ValueError(f"{path}: best_config has no 'pins' mapping")
    return record


def apply_best_config(path: str | os.PathLike) -> dict:
    """Restore a sidecar's pins for this process through utils/pins,
    skipping any pin the operator already set (a tuned default must not
    override an explicit decision). Returns ``{"record", "applied",
    "skipped"}``."""
    record = load_best_config(path)
    applied, skipped = {}, {}
    for name, value in record["pins"].items():
        if pins.pin_is_set(name):
            skipped[name] = pins.str_pin(name)
        else:
            pins.set_pin(name, value)
            applied[name] = value
    return {"record": record, "applied": applied, "skipped": skipped}


def tune_run_dir(
    run_dir: str | os.PathLike,
    *,
    round_idx: int | None = None,
    slo_ms: float | None = None,
    bucket_sets: tuple[tuple[int, ...], ...] | None = None,
    deadlines_ms: tuple[float, ...] | None = None,
    route_cells: tuple[dict, ...] = ({},),
    requests: int = 96,
    rate_fracs: tuple[float, ...] = (0.5, 0.8),
    out_path: str | os.PathLike | None = None,
    device=None,
) -> dict:
    """The ``tune`` subcommand's engine: restore the run's model once on
    ``device`` (None = the card), sweep the lattice, write
    ``<run_dir>/best_config.json`` (or ``out_path``) atomically. Returns
    the sidecar record."""
    from qfedx_tpu_torch.serve.engine import ServeConfig, engine_from_run_dir

    run_dir = Path(run_dir)
    engine, _info = engine_from_run_dir(run_dir, round_idx=round_idx,
                                        device=device)
    base = ServeConfig.resolve()
    sweep = sweep_serve(
        engine.model, engine.params, engine.feature_shape,
        slo_ms=slo_ms if slo_ms is not None else base.slo_ms,
        bucket_sets=bucket_sets or (base.buckets,),
        deadlines_ms=deadlines_ms or (base.deadline_ms,),
        route_cells=route_cells,
        requests=requests,
        rate_fracs=rate_fracs,
        max_queue=base.max_queue,
        device=engine.device,
    )
    record = best_config_record(
        sweep, requests=requests, source="qfedx tune"
    )
    out = Path(out_path) if out_path else run_dir / BEST_CONFIG_FILENAME
    write_best_config(out, record)
    record["path"] = str(out)
    return record
