"""Multi-process trace shards + merger — one timeline for several processes.

Counterpart of ``qfedx_tpu/obs/merge.py``. The registry is process-local
(obs/trace.py); each process writes its registry as
``trace.<process_index>.json`` (``write_trace_shard``: a Chrome trace
plus a ``qfedx_shard`` stanza with the process index and
``origin_unix``, the wall-clock instant of the registry origin), and
``merge_trace_shards`` aligns the shards into one Chrome/Perfetto file,
each process in its own lane. The process index is
``torch.distributed.get_rank()`` while a process group is up, else 0
(a multi-process round, ``fed/round.py``, writes one shard per rank).
``add_device_lane`` appends a parsed profile's device-op intervals as a
lane of their own (obs/profile.py).

Alignment rides ``time.time()``: exact on one machine, NTP-accurate
across hosts.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from qfedx_tpu_torch.obs.export import chrome_trace_events
from qfedx_tpu_torch.obs.trace import registry

_SHARD_RE = re.compile(r"^trace\.(\d+)\.json$")

# The device-op lane: parsed profiler captures land in their own
# Perfetto process lane, past any plausible process index so host
# lanes and the device lane can never collide in a merged file.
DEVICE_LANE_PID = 1000


def add_device_lane(
    trace_obj: dict,
    device_events: list[dict],
    offset_us: float = 0.0,
    label: str = "qfedx device",
) -> dict:
    """Append a parsed capture's device-op intervals (obs/profile.py
    ``device_events``: {name, ts, dur, lane}) as their own process lane
    in ``trace_obj`` (a chrome-trace dict), shifted by ``offset_us``
    onto the host spans' clock (obs/profile.align_offset_us) — one
    Perfetto file then shows host spans, request-id meta and device ops
    on aligned tracks. Mutates and returns ``trace_obj``."""
    events = trace_obj.setdefault("traceEvents", [])
    events.append(
        {
            "name": "process_name",
            "ph": "M",
            "pid": DEVICE_LANE_PID,
            "tid": 0,
            "args": {"name": label},
        }
    )
    seen_lanes: set[int] = set()
    for e in device_events:
        lane = int(e.get("lane", 0))
        if lane not in seen_lanes:
            seen_lanes.add(lane)
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": DEVICE_LANE_PID,
                    "tid": lane,
                    "args": {"name": f"device lane {lane}"},
                }
            )
        events.append(
            {
                "name": e["name"],
                "ph": "X",
                "ts": round(e["ts"] + offset_us, 3),
                "dur": round(e["dur"], 3),
                "pid": DEVICE_LANE_PID,
                "tid": lane,
                "args": {},
            }
        )
    return trace_obj


def _process_index() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — shard writing must not need a group
        pass
    return 0


def shard_path(trace_dir: str | Path, process_index: int | None = None) -> Path:
    idx = _process_index() if process_index is None else int(process_index)
    return Path(trace_dir) / f"trace.{idx}.json"


def write_trace_shard(
    trace_dir: str | Path, process_index: int | None = None
) -> Path:
    """Write THIS process's registry as its trace shard. Unlike every
    other ``run/`` artifact this is NOT primary-gated — a shard per
    process is the point; the merger reunites them."""
    reg = registry()
    path = shard_path(trace_dir, process_index)
    path.parent.mkdir(parents=True, exist_ok=True)
    idx = _process_index() if process_index is None else int(process_index)
    path.write_text(
        json.dumps(
            {
                "traceEvents": chrome_trace_events(),
                "displayTimeUnit": "ms",
                "qfedx_shard": {
                    "process_index": idx,
                    "origin_unix": reg.origin_unix,
                },
            }
        )
    )
    return path


def find_shards(trace_dir: str | Path) -> list[Path]:
    """The ``trace.<i>.json`` shards under ``trace_dir``, ordered by
    process index."""
    out = []
    for p in Path(trace_dir).iterdir():
        m = _SHARD_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _i, p in sorted(out)]


def merge_trace_shards(
    trace_dir: str | Path, out_path: str | Path | None = None
) -> dict:
    """Merge every shard under ``trace_dir`` into one Chrome trace dict
    (written to ``out_path`` when given). Raises FileNotFoundError when
    no shard exists — a silent empty merge would read as a healthy but
    idle run."""
    shards = []
    for path in find_shards(trace_dir):
        obj = json.loads(path.read_text())
        meta = obj.get("qfedx_shard") or {}
        shards.append(
            (
                int(meta.get("process_index", len(shards))),
                float(meta.get("origin_unix", 0.0)),
                obj.get("traceEvents", []),
            )
        )
    if not shards:
        raise FileNotFoundError(
            f"no trace.<i>.json shards under {trace_dir} — did each "
            "process call obs.write_trace_shard?"
        )
    t0 = min(origin for _i, origin, _e in shards)
    merged: list[dict] = []
    for idx, origin, events in shards:
        offset_us = (origin - t0) * 1e6
        for e in events:
            e = dict(e)
            e["pid"] = idx
            if e.get("name") == "process_name" and e.get("ph") == "M":
                e["args"] = {"name": f"qfedx process {idx}"}
            if "ts" in e:
                e["ts"] = round(e["ts"] + offset_us, 3)
            merged.append(e)
    out = {"traceEvents": merged, "displayTimeUnit": "ms"}
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out))
    return out
