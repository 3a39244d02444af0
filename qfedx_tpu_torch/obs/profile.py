"""Device-timeline profiling: crash-safe captures + a parsed op census.

Counterpart of ``qfedx_tpu/obs/profile.py`` over ``torch.profiler``:

- ``capture(log_dir)`` — a crash-safe ``torch.profiler.profile`` context
  (CPU and CUDA activities on the card, CPU only without one): SIGTERM
  rides the ``utils/host`` translation into KeyboardInterrupt so the
  unwind stops the profiler, and the stop and the Chrome-trace export
  (``export_chrome_trace`` into ``log_dir``) run on ANY exception — a
  killed run still leaves a parseable capture. ``capture_meta.json``
  holds the registry-clock anchor of the start.
- ``parse_capture`` / ``parse_events`` — the measured census of one
  capture, in the reference's schema: the device's executed ops are
  torch's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events on their
  device/stream lanes (a CPU capture has no device lane; then the
  top-level ``cpu_op`` events stand in, as the reference falls back to
  device-named pids); per-op total and self time; an inter-op gap
  histogram (``obs.Histogram``, µs); busy vs window time; and per-span
  device time from the ranges that ``record_function`` (the
  ``QFEDX_TRACE_XLA`` span bridge) opens: the device time of the ops
  whose launch call (matched through the op's correlation id) ran while
  the span's host range was open, on any of the process's threads,
  nested spans' included. Without launch
  calls (a CPU capture) the reference's rule applies: the device ops
  overlapping the span's range.
- ``summarize`` / ``write_profile_summary`` — ``profile_summary.json``
  (``SUMMARY_FIELDS``) and ``attach_span_device``, which feeds
  ``device_busy_s``/``utilization`` into ``obs.phase_rollup`` rows.
- ``write_merged_trace`` — host spans plus the device-op lane on one
  aligned Perfetto timeline (obs/merge.add_device_lane).
- ``kernel_launches`` — the scan-body kernel's events in a capture by
  launch kind (A ``fwd``, B ``fwd_bnd``, C ``adj``): the wrapper names
  each launch with a ``record_function`` range while a profiler runs,
  and the kernel event is matched to its range through the launch's
  correlation id (or the device-lane annotation holding it).

- ``floor_attribution`` — the compact floor-evidence row (static
  census beside the measured ops, gaps and busy fraction) that
  ``inspect`` prints for a profiled run directory; a copy of the
  reference's plain dict builder, tolerant of partial summaries.

``QFEDX_PROFILE`` (the pin twin of ``--profile``): unset / ``0`` /
``off`` → no capture; ``1`` / ``on`` → the caller's default dir (the CLI
uses ``<run-dir>/profile``); a path → there.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import time
from pathlib import Path

from qfedx_tpu_torch.obs.histo import Histogram
from qfedx_tpu_torch.obs.trace import registry
from qfedx_tpu_torch.utils import pins

PROFILE_SUMMARY_SCHEMA_VERSION = 1

# The profile_summary.json field contract (the reference's keys).
SUMMARY_FIELDS: dict[str, str] = {
    "schema": "profile_summary schema version (this table is version 1)",
    "capture": "file name of the parsed trace capture",
    "ops_executed": "executed top-level device-op slots (nested "
                    "sub-ops fold into their parent) — the same slots "
                    "the gap histogram and busy time are defined over",
    "ops_distinct": "distinct op names among those slots",
    "ops_per_step": "ops_executed / steps (null when steps unknown)",
    "static_state_ops": "state-sized-op census of the same program "
                        "(obs/census.py; null when not supplied)",
    "measured_vs_static": "ops_executed (per step) / static_state_ops",
    "device_busy_s": "summed top-level device-op time (all lanes)",
    "device_window_s": "first-op-start to last-op-end window",
    "device_busy_fraction": "fraction of the window where ANY device "
                            "lane ran an op (interval union / window)",
    "device_lanes": "device lanes (streams) carrying op events",
    "gap_count": "inter-op gaps measured (consecutive ops per lane)",
    "gap_p50_us": "median inter-op idle gap (bounded-histogram quantile)",
    "gap_p95_us": "p95 inter-op idle gap",
    "gap_mean_us": "mean inter-op idle gap",
    "top_ops": "top ops by total device time ({op, count, total_ms, "
               "self_ms} rows)",
    "spans": "per-span device attribution ({wall_s, device_busy_s, "
             "utilization} by span name; QFEDX_TRACE_XLA captures only)",
}

_TOP_K = 15
_META_NAME = "capture_meta.json"
_TRACE_NAME = "capture.pt.trace.json"
_OP_ID_RE = re.compile(r"\.\d+$")

# The reference's control-flow containers; torch captures have none,
# the filter is kept so both parsers define the same slots.
_TRANSPARENT_OPS = {"while", "conditional", "call"}

# torch.profiler categories of executed device work.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The scan-body kernel instances (ops/csrc) and the range names the
# wrapper opens around a launch while a profiler runs (ops/scan_body).
SCAN_KERNELS = ("scan_body_kernel", "scan_body_cluster_kernel")
LAUNCH_RANGE_PREFIX = "scan_body."
LAUNCH_KINDS = ("fwd", "fwd_bnd", "adj")


def profile_dir(default: str | None = None) -> str | None:
    """Resolve QFEDX_PROFILE to a capture directory, or None when the
    pin is off/unset (loud on typos like every QFEDX_* pin)."""
    env = pins.str_pin("QFEDX_PROFILE")
    if env is None:
        return None
    as_bool = pins.parse_onoff(env)
    if as_bool is False:
        return None
    if as_bool is True:
        return default
    if os.sep in env or env.startswith(("~", ".")):
        return os.path.expanduser(env)
    raise ValueError(
        f"QFEDX_PROFILE={env!r}: expected '0'/'off', '1'/'on' or a "
        "directory path (with a path separator or ~/. prefix)"
    )


def _all_threads() -> dict:
    """The profiler's option to record the host ops of every thread, the
    ones started after the capture too (the batcher's dispatcher, the
    uploader), where this torch has it: by default it records only the
    threads it knew at the start."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class capture:
    """Crash-safe profiler capture into ``log_dir``.

    ``with capture(dir):`` starts a ``torch.profiler.profile`` (CUDA
    activity when ``cuda`` — default: a card is present) and ALWAYS
    stops it and exports the Chrome trace — on clean exit, on any
    exception and on SIGTERM (translated into KeyboardInterrupt on the
    main thread). A stop or export failure never masks the in-flight
    exception."""

    def __init__(self, log_dir: str | Path, cuda: bool | None = None):
        self.log_dir = Path(log_dir)
        self.cuda = cuda
        self._token = None
        self._prof = None

    def __enter__(self):
        from qfedx_tpu_torch.utils import host

        self._token = host.install_sigterm_interrupt()
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            self.log_dir.mkdir(parents=True, exist_ok=True)
            cuda = (torch.cuda.is_available() if self.cuda is None
                    else self.cuda)
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []), **_all_threads())
            prof.__enter__()  # qfedx: ignore[QFX003] the paired exit is in capture.__exit__; a failed enter restores SIGTERM and re-raises below
        except BaseException:
            # __exit__ never runs after a failed __enter__.
            host.restore_sigterm(self._token)
            raise
        self._prof = prof
        reg = registry()
        meta = {
            "start_rel_origin_us": (time.perf_counter() - reg.origin) * 1e6,
            "origin_unix": reg.origin_unix,
            "unix_start": time.time(),
        }
        try:
            (self.log_dir / _META_NAME).write_text(json.dumps(meta))
        except OSError:  # the anchor is an alignment aid, not the capture
            pass
        return self

    def __exit__(self, exc_type, exc, tb):
        from qfedx_tpu_torch.utils import host

        try:
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                self._prof.export_chrome_trace(
                    str(self.log_dir / _TRACE_NAME))
        except Exception:  # noqa: BLE001 — a stop failure must not mask
            if exc_type is None:  # the unwind that got us here
                raise
        finally:
            self._prof = None
            host.restore_sigterm(self._token)
        return False


def find_capture(log_dir: str | Path) -> Path | None:
    """Newest ``*.trace.json(.gz)`` under ``log_dir``."""
    paths = [
        p
        for pattern in ("*.trace.json.gz", "*.trace.json")
        for p in Path(log_dir).rglob(pattern)
    ]
    return max(paths, key=lambda p: p.stat().st_mtime) if paths else None


def load_capture(path: str | Path) -> list[dict]:
    """The traceEvents list of one capture file (.gz or plain JSON)."""
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(path, "rt") as f:
            return json.load(f).get("traceEvents", [])
    return json.loads(path.read_text()).get("traceEvents", [])


def _complete(events, cats) -> list[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _op_events(events) -> list[dict]:
    """The executed-op events: the device's kernels, copies and sets;
    on a capture without a device lane, the top-level ``cpu_op`` events
    of each thread."""
    ops = _complete(events, _DEVICE_CATS)
    if ops:
        return ops
    lanes: dict[tuple, list] = {}
    for e in _complete(events, ("cpu_op",)):
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    top = []
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = -1.0
        for e in evs:
            if e["ts"] >= end - 1e-9:
                top.append(e)
                end = e["ts"] + e["dur"]
    return top


def _toplevel_by_lane(ops) -> dict[tuple, list[tuple[float, float, str]]]:
    """Per (pid, tid) lane: the TOP-LEVEL op intervals (ts, dur, name),
    ts-sorted. Nested events fold into their parent — gaps and busy time
    are defined over scheduling slots."""
    lanes: dict[tuple, list] = {}
    for e in ops:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = {}
    for key, evs in lanes.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        top: list[tuple[float, float, str]] = []
        end = -1.0
        for e in evs:
            if e["ts"] >= end - 1e-9:  # not inside the previous top op
                top.append((e["ts"], e["dur"], e.get("name", "?")))
                end = e["ts"] + e["dur"]
        out[key] = top
    return out


def _self_times(ops) -> dict[str, float]:
    """Per-op-name SELF µs: duration minus directly-nested children on
    the same lane."""
    lanes: dict[tuple, list] = {}
    for e in ops:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    self_us: dict[str, float] = {}
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[list] = []  # [end, child_us, name, dur]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0] - 1e-9:
                end, child, name, dur = stack.pop()
                self_us[name] = self_us.get(name, 0.0) + max(0.0, dur - child)
            if stack:
                stack[-1][1] += e["dur"]
            stack.append([e["ts"] + e["dur"], 0.0, e.get("name", "?"), e["dur"]])
        while stack:
            end, child, name, dur = stack.pop()
            self_us[name] = self_us.get(name, 0.0) + max(0.0, dur - child)
    return self_us


def _lane_key(key: tuple) -> tuple:
    """Sort key of a (pid, tid) lane: numbers in order, names after."""
    return tuple((0, v, "") if isinstance(v, (int, float)) else (1, 0, str(v))
                 for v in key)


def op_base_name(name: str) -> str:
    """``fusion.123`` → ``fusion``: the reference's instance-id strip
    (a no-op on torch's op and kernel names)."""
    return _OP_ID_RE.sub("", name)


def parse_events(events: list[dict], span_names=()) -> dict:
    """Pure parse of one capture's traceEvents (fixture-testable), in
    the reference's output schema: op census (base name → count / total
    / self µs), per-lane top-level intervals, the inter-op gap
    ``obs.Histogram`` (µs), busy/window totals and the annotation ranges
    whose names appear in ``span_names``."""
    ops = [
        e
        for e in _op_events(events)
        if op_base_name(e.get("name", "?")) not in _TRANSPARENT_OPS
    ]
    lanes = _toplevel_by_lane(ops)
    self_us = _self_times(ops)

    census: dict[str, dict] = {}
    for e in ops:
        name = e.get("name", "?")
        row = census.setdefault(
            op_base_name(name), {"count": 0, "total_us": 0.0, "self_us": 0.0}
        )
        row["count"] += 1
        row["total_us"] += e["dur"]
    for name, s in self_us.items():
        census[op_base_name(name)]["self_us"] += s

    gap_hist = Histogram()  # recorded in MICROSECONDS
    gap_sum = 0.0
    busy_us = 0.0
    t_lo, t_hi = None, None
    device_events = []
    intervals: list[tuple[float, float]] = []
    for lane_idx, (key, top) in enumerate(
        sorted(lanes.items(), key=lambda kv: _lane_key(kv[0]))
    ):
        prev_end = None
        for ts, dur, name in top:
            busy_us += dur
            intervals.append((ts, ts + dur))
            t_lo = ts if t_lo is None else min(t_lo, ts)
            t_hi = ts + dur if t_hi is None else max(t_hi, ts + dur)
            if prev_end is not None:
                gap = max(0.0, ts - prev_end)
                gap_hist.record(gap)
                gap_sum += gap
            prev_end = ts + dur
            device_events.append(
                {"name": name, "ts": ts, "dur": dur, "lane": lane_idx}
            )
    # Busy fraction over the UNION of op intervals across lanes.
    union_us = 0.0
    cur_lo, cur_hi = None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                union_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        union_us += cur_hi - cur_lo

    # Overlap of an annotation with a lane's sorted disjoint top-level
    # intervals: bisect + a duration prefix sum.
    lane_index = []
    for top in lanes.values():
        starts = [ts for ts, _d, _n in top]
        ends = [ts + d for ts, d, _n in top]
        prefix = [0.0]
        for _ts, d, _n in top:
            prefix.append(prefix[-1] + d)
        lane_index.append((starts, ends, prefix))

    def _lane_overlap(starts, ends, prefix, a0, a1):
        i0 = bisect.bisect_right(ends, a0)  # first interval ending past a0
        i1 = bisect.bisect_left(starts, a1)  # first interval starting at/after a1
        if i0 >= i1:
            return 0.0
        total = prefix[i1] - prefix[i0]
        total -= max(0.0, a0 - starts[i0])  # clip the boundary intervals
        total -= max(0.0, ends[i1 - 1] - a1)
        return max(0.0, total)

    # Span ranges: record_function puts a user_annotation on the host
    # thread (the registry clock) and a gpu_user_annotation on the device
    # lane. A span's device time is that of the ops LAUNCHED while it was
    # open, nested spans' included: each op's launch call (the runtime or
    # driver event of its correlation id) falls inside the span's host
    # range, on any thread of its process (autograd launches the
    # backward's ops from its own thread). Without launch calls, the
    # reference's rule: device ops overlapping the span's range, the
    # device-lane one where there is one (kineto gives it only the ops of
    # its innermost span), else the host one.
    names = set(span_names)
    op_ids = {id(e) for e in ops}
    named = [e for e in events
             if e.get("ph") == "X" and e.get("name") in names
             and id(e) not in op_ids]
    dev_ranges = [e for e in named if e.get("cat") == "gpu_user_annotation"]
    host_ranges = [e for e in named if e.get("cat") != "gpu_user_annotation"]
    launched = _launched_ops(events, ops)
    annotations: dict[str, dict] = {}
    for e in (host_ranges if launched else dev_ranges or host_ranges):
        a0, a1 = e["ts"], e["ts"] + e["dur"]
        if launched:
            calls = launched.get(e.get("pid"))
            busy = 0.0
            if calls is not None:
                ts, prefix = calls
                busy = prefix[bisect.bisect_right(ts, a1)] - prefix[
                    bisect.bisect_left(ts, a0)]
        else:
            busy = sum(
                _lane_overlap(starts, ends, prefix, a0, a1)
                for starts, ends, prefix in lane_index
            )
        # Clamped per occurrence so that busy <= wall holds.
        busy = min(busy, e["dur"])
        row = annotations.setdefault(
            e["name"], {"count": 0, "wall_us": 0.0, "busy_us": 0.0}
        )
        row["count"] += 1
        row["wall_us"] += e["dur"]
        row["busy_us"] += busy
    ann_occurrences: dict[str, list] = {}
    for e in host_ranges or dev_ranges:
        ann_occurrences.setdefault(e["name"], []).append(e["ts"])

    return {
        "census": census,
        # Executed SLOTS: top-level intervals only, the universe the gap
        # histogram, busy time and the device lane are defined over.
        "ops_executed": len(device_events),
        "ops_distinct": len({e["name"] for e in device_events}),
        "device_lanes": len(lanes),
        "device_events": device_events,
        "busy_us": busy_us,
        "union_busy_us": union_us,
        "window_us": 0.0 if t_lo is None else t_hi - t_lo,
        "gap_hist": gap_hist,
        "gap_sum_us": gap_sum,
        "annotations": annotations,
        "annotation_ts": {k: sorted(v) for k, v in ann_occurrences.items()},
        "t_min_us": min(
            (e["ts"] for e in events if e.get("ph") == "X"), default=0.0
        ),
    }


def _launched_ops(events, ops) -> dict:
    """Per host process: the launch calls' timestamps of the device ops
    that have one (matched through ``correlation``), sorted, with a
    prefix sum of those ops' durations. Empty when no op does."""
    api: dict = {}
    for e in _complete(events, ("cuda_runtime", "cuda_driver")):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            api.setdefault(corr, e)
    by_lane: dict[tuple, list] = {}
    for op in ops:
        call = api.get((op.get("args") or {}).get("correlation"))
        if call is not None:
            by_lane.setdefault(call.get("pid"), []).append(
                (call["ts"], op["dur"]))
    out = {}
    for lane, rows in by_lane.items():
        rows.sort()
        prefix = [0.0]
        for _t, d in rows:
            prefix.append(prefix[-1] + d)
        out[lane] = ([t for t, _d in rows], prefix)
    return out


def kernel_launches(events: list[dict]) -> dict[str, int]:
    """The scan-body kernel's events in one capture by launch kind:
    ``{"fwd", "fwd_bnd", "adj", "unattributed", "total"}``. A kernel
    event's kind is the ``scan_body.<kind>`` range open in its process
    when its launch call (the runtime or driver event with the same
    ``correlation``) ran — the ranges never overlap, one launch each, and
    the profiler may name a thread differently in its host ranges and in
    its launch calls — else the device-lane ``gpu_user_annotation`` of
    that name holding the kernel."""
    kernels = [e for e in _complete(events, ("kernel",))
               if any(k in e.get("name", "") for k in SCAN_KERNELS)]
    api: dict = {}
    for e in _complete(events, ("cuda_runtime", "cuda_driver")):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            api.setdefault(corr, e)

    def ranges(cat, lane):
        by_lane: dict = {}
        for e in _complete(events, (cat,)):
            name = e.get("name", "")
            if name.startswith(LAUNCH_RANGE_PREFIX):
                kind = name[len(LAUNCH_RANGE_PREFIX):]
                if kind in LAUNCH_KINDS:
                    by_lane.setdefault(lane(e), []).append(
                        (e["ts"], e["dur"], kind))
        for v in by_lane.values():
            v.sort()
        return by_lane

    host = ranges("user_annotation", lambda e: e.get("pid"))
    dev = ranges("gpu_user_annotation",
                 lambda e: (e.get("pid"), e.get("tid")))

    def holding(by_lane, lane, t):
        # Launch ranges never nest: the last one starting at or before t
        # is the only candidate.
        rows = by_lane.get(lane, ())
        i = bisect.bisect_right(rows, (t, float("inf"), "~")) - 1
        if i >= 0 and rows[i][0] <= t <= rows[i][0] + rows[i][1]:
            return rows[i][2]
        return None

    out = {k: 0 for k in LAUNCH_KINDS}
    out["unattributed"] = 0
    for k in kernels:
        kind = None
        call = api.get((k.get("args") or {}).get("correlation"))
        if call is not None:
            kind = holding(host, call.get("pid"), call["ts"])
        if kind is None:
            kind = holding(dev, (k.get("pid"), k.get("tid")), k["ts"])
        out[kind or "unattributed"] += 1
    out["total"] = len(kernels)
    return out


def parse_capture(log_dir: str | Path, span_names=None) -> dict:
    """Parse the newest capture under ``log_dir``. Loud when none
    exists. ``span_names`` defaults to every span name the registry has
    recorded."""
    path = find_capture(log_dir)
    if path is None:
        raise FileNotFoundError(
            f"no *.trace.json(.gz) capture under {log_dir} — did the "
            "profiled region run inside obs.profile.capture()?"
        )
    if span_names is None:
        histos, _ = registry().span_rollup_source()
        span_names = set(histos)
    parsed = parse_events(load_capture(path), span_names)
    parsed["capture_path"] = path
    meta_path = Path(log_dir) / _META_NAME
    if meta_path.exists():
        try:
            parsed["capture_meta"] = json.loads(meta_path.read_text())
        except (OSError, ValueError):
            pass
    return parsed


def summarize(
    parsed: dict,
    static_state_ops: int | None = None,
    steps: int | None = None,
) -> dict:
    """The ``profile_summary.json`` dict — exactly the SUMMARY_FIELDS
    keys. Gap quantiles come from the bounded histogram."""
    h: Histogram = parsed["gap_hist"]
    ops = parsed["ops_executed"]
    per_step = None if not steps else ops / steps
    vs_static = None
    if static_state_ops:
        vs_static = round((per_step or ops) / static_state_ops, 3)
    window = parsed["window_us"]
    top = sorted(
        parsed["census"].items(), key=lambda kv: -kv[1]["total_us"]
    )[:_TOP_K]
    spans = {}
    for name, row in parsed["annotations"].items():
        # Sub-µs overlap is dispatch skew, and a utilization that rounds
        # to 0 would break the (0, 1] contract: attribution noise.
        if row["wall_us"] <= 0 or row["busy_us"] < 1.0:
            continue
        util = round(min(1.0, row["busy_us"] / row["wall_us"]), 4)
        if util <= 0:
            continue
        spans[name] = {
            "wall_s": round(row["wall_us"] / 1e6, 6),
            "device_busy_s": round(row["busy_us"] / 1e6, 6),
            "utilization": util,
        }
    cap = parsed.get("capture_path")
    return {
        "schema": PROFILE_SUMMARY_SCHEMA_VERSION,
        "capture": None if cap is None else Path(cap).name,
        "ops_executed": ops,
        "ops_distinct": parsed["ops_distinct"],
        "ops_per_step": None if per_step is None else round(per_step, 1),
        "static_state_ops": static_state_ops,
        "measured_vs_static": vs_static,
        "device_busy_s": round(parsed["busy_us"] / 1e6, 6),
        "device_window_s": round(window / 1e6, 6),
        "device_busy_fraction": (
            None if window <= 0
            else round(min(1.0, parsed["union_busy_us"] / window), 4)
        ),
        "device_lanes": parsed["device_lanes"],
        "gap_count": h.count,
        "gap_p50_us": round(h.percentile(0.50), 3),
        "gap_p95_us": round(h.percentile(0.95), 3),
        "gap_mean_us": (
            0.0 if h.count == 0 else round(parsed["gap_sum_us"] / h.count, 3)
        ),
        "top_ops": [
            {
                "op": name,
                "count": row["count"],
                "total_ms": round(row["total_us"] / 1e3, 3),
                "self_ms": round(row["self_us"] / 1e3, 3),
            }
            for name, row in top
        ],
        "spans": spans,
    }


def attach_span_device(summary: dict) -> None:
    """Feed the summary's per-span device attribution into the registry
    so ``obs.phase_rollup`` rows carry ``device_busy_s``/
    ``utilization``."""
    reg = registry()
    for name, row in (summary.get("spans") or {}).items():
        reg.set_span_device(
            name, row["device_busy_s"], row["utilization"]
        )


def floor_attribution(static_state_ops: int | None, summary: dict) -> dict:
    """The floor-evidence row: the static census next to the measured
    per-op gap and busy fraction. Tolerant of partial summaries
    (``inspect`` reads whatever a run directory holds): absent fields
    are None."""
    return {
        "static_state_ops": static_state_ops,
        "ops_executed": summary.get("ops_executed"),
        "ops_per_step": summary.get("ops_per_step"),
        "measured_vs_static": summary.get("measured_vs_static"),
        "gap_us_per_op": summary.get("gap_p50_us"),
        "gap_p95_us": summary.get("gap_p95_us"),
        "device_busy_fraction": summary.get("device_busy_fraction"),
        "device_lanes": summary.get("device_lanes"),
    }


def align_offset_us(parsed: dict) -> float | None:
    """Offset (µs) that rebases the capture's clock onto the registry
    span timeline: exact from the span ranges in the capture (k-th range
    of a name matches the k-th registry span of that name), else from
    the capture_meta.json start anchor (~ms); None when neither
    exists."""
    reg = registry()
    spans_by_name: dict[str, list[float]] = {}
    for sp in list(reg.spans):
        spans_by_name.setdefault(sp.name, []).append(sp.t0)
    offsets = []
    for name, ann_ts in parsed.get("annotation_ts", {}).items():
        reg_ts = sorted(spans_by_name.get(name, []))
        for a, t0 in zip(ann_ts, reg_ts):
            offsets.append((t0 - reg.origin) * 1e6 - a)
    if offsets:
        offsets.sort()
        return offsets[len(offsets) // 2]
    meta = parsed.get("capture_meta")
    if meta and "start_rel_origin_us" in meta:
        return meta["start_rel_origin_us"] - parsed.get("t_min_us", 0.0)
    return None


def write_merged_trace(path: str | Path, parsed: dict) -> Path:
    """One Perfetto file: the registry's host spans plus the capture's
    device-op lane on a shared time origin (``align_offset_us``)."""
    from qfedx_tpu_torch.obs.export import chrome_trace_events
    from qfedx_tpu_torch.obs.merge import add_device_lane

    trace = {
        "traceEvents": chrome_trace_events(),
        "displayTimeUnit": "ms",
    }
    offset = align_offset_us(parsed)
    add_device_lane(
        trace, parsed["device_events"], 0.0 if offset is None else offset
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace))
    return path


def write_profile_summary(
    run_dir: str | Path,
    capture_dir: str | Path | None = None,
    static_state_ops: int | None = None,
    steps: int | None = None,
) -> dict:
    """Parse ``capture_dir`` (default ``<run_dir>/profile``), attach
    span device columns to the registry, and write
    ``<run_dir>/profile_summary.json``. Returns the summary."""
    run_dir = Path(run_dir)
    parsed = parse_capture(capture_dir or run_dir / "profile")
    summary = summarize(parsed, static_state_ops, steps)
    attach_span_device(summary)
    (run_dir / "profile_summary.json").write_text(
        json.dumps(summary, indent=2)
    )
    return summary
