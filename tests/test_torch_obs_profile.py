"""Port vs reference: the device-timeline parser, captures and the census.

- One synthetic device timeline, written once as XLA-style events for
  the reference's ``parse_events`` and once as torch-profiler events
  (``kernel``/``gpu_memcpy`` on device lanes, ``gpu_user_annotation``
  and ``user_annotation`` span ranges) for the port's, gives the same
  summary: ops, total and self time, gap p50/p95, busy fraction,
  per-span device time, and the same alignment offset.
- ``kernel_launches`` tells the scan-body kernel's launches A/B/C apart
  through the launch's correlation id or the device-lane range, and a
  span's device time is that of the ops launched inside it.
- A real CPU capture of the n = 4 VQC's steps parses end to end (the
  CPU fallback: top-level ``cpu_op`` events, host span ranges), and a
  capture cut by an exception or a SIGTERM still parses.
- ``obs.census``: the fused program's state-sized op count is below the
  unfused one at n = 10 and 12 (the reference's HLO-census invariant).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from qfedx_tpu.obs import phase_rollup as rphase_rollup
from qfedx_tpu.obs import profile as rprofile
from qfedx_tpu.obs import trace as rtrace
from qfedx_tpu_torch import obs as pobs
from qfedx_tpu_torch.obs import census
from qfedx_tpu_torch.obs import profile as pprofile
from qfedx_tpu_torch.obs import trace as ptrace


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for pin in ("QFEDX_TRACE", "QFEDX_TRACE_XLA", "QFEDX_PROFILE",
                "QFEDX_FUSE", "QFEDX_SCAN_LAYERS"):
        monkeypatch.delenv(pin, raising=False)
    pobs.reset()
    rtrace.reset()
    yield
    pobs.reset()
    rtrace.reset()


# (lane, name, ts µs, dur µs) of executed device ops, two lanes, and
# (span name, ts, dur) of the span ranges.
_OPS = [
    (0, "fusion.1", 100.0, 20.0), (0, "fusion.2", 125.0, 5.0),
    (0, "copy.3", 131.0, 9.0), (0, "fusion.1", 190.0, 30.0),
    (0, "fusion.4", 221.5, 3.5), (0, "fusion.2", 400.0, 10.0),
    (1, "fusion.4", 105.0, 10.0), (1, "copy.3", 300.0, 2.0),
    (1, "fusion.5", 303.0, 40.0), (1, "fusion.5", 350.0, 4.0),
]
_SPANS = [("round.dispatch", 90.0, 80.0), ("round.fetch", 180.0, 60.0),
          ("round.dispatch", 295.0, 120.0), ("round.eval", 500.0, 10.0)]


def _xla_events():
    ev = [{"ph": "M", "name": "process_name", "pid": 7,
           "args": {"name": "/device:TPU:0"}}]
    for lane, name, ts, dur in _OPS:
        ev.append({"ph": "X", "name": name, "pid": 7, "tid": lane,
                   "ts": ts, "dur": dur, "args": {"hlo_op": name}})
    for name, ts, dur in _SPANS:
        ev.append({"ph": "X", "name": name, "pid": 1, "tid": 1, "ts": ts,
                   "dur": dur, "args": {}})
    return ev


def _torch_events():
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "python"}}]
    for lane, name, ts, dur in _OPS:
        cat = "gpu_memcpy" if name.startswith("copy") else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                   "tid": 7 + lane, "ts": ts, "dur": dur,
                   "args": {"correlation": int(ts)}})
    for name, ts, dur in _SPANS:
        # record_function's two ranges: the host thread's (the registry
        # clock) and the device lane's (the device work it launched).
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "pid": 4242, "tid": 4242, "ts": ts, "dur": dur,
                   "args": {}})
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": name,
                   "pid": 0, "tid": 7, "ts": ts, "dur": dur, "args": {}})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                   "pid": 4242, "tid": 4242, "ts": ts + 1.0, "dur": 2.0,
                   "args": {}})
    return ev


def test_synthetic_timeline_summary_equals_reference():
    names = {"round.dispatch", "round.fetch", "round.eval"}
    ref = rprofile.parse_events(_xla_events(), names)
    got = pprofile.parse_events(_torch_events(), names)
    for key in ("census", "ops_executed", "ops_distinct", "device_lanes",
                "device_events", "busy_us", "union_busy_us", "window_us",
                "gap_sum_us", "annotations", "annotation_ts"):
        assert got[key] == ref[key], key
    assert got["gap_hist"]._counts == ref["gap_hist"]._counts
    rs, ps = rprofile.summarize(ref, 10, 2), pprofile.summarize(got, 10, 2)
    assert ps == rs
    assert set(ps) == set(pprofile.SUMMARY_FIELDS) == set(
        rprofile.SUMMARY_FIELDS)
    assert ps["device_lanes"] == 2 and ps["gap_count"] == 8
    assert 0 < ps["device_busy_fraction"] < 1


def test_synthetic_alignment_and_device_lane_equal_reference(monkeypatch,
                                                             tmp_path):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    names = {"round.dispatch", "round.fetch", "round.eval"}
    for tr in (rtrace, ptrace):
        reg = tr.registry()
        for i, (name, ts, dur) in enumerate(_SPANS):
            sp = tr.Span(name, {})
            sp.t0 = reg.origin + 0.5 + ts * 1e-6
            sp.t1 = sp.t0 + dur * 1e-6
            sp.tid, sp.tname = 1, "MainThread"
            reg.add_span(sp)
    ref = rprofile.parse_events(_xla_events(), names)
    got = pprofile.parse_events(_torch_events(), names)
    assert pprofile.align_offset_us(got) == rprofile.align_offset_us(ref)
    pprofile.attach_span_device(pprofile.summarize(got))
    rprofile.attach_span_device(rprofile.summarize(ref))
    prow, rrow = pobs.phase_rollup(), rphase_rollup()
    assert {k: (v.get("device_busy_s"), v.get("utilization"))
            for k, v in prow.items()} == {
        k: (v.get("device_busy_s"), v.get("utilization"))
        for k, v in rrow.items()}
    pt = json.loads(pprofile.write_merged_trace(tmp_path / "p.json",
                                                got).read_text())
    rt = json.loads(rprofile.write_merged_trace(tmp_path / "r.json",
                                                ref).read_text())
    lane = [e for e in pt["traceEvents"] if e["pid"] == 1000]
    assert lane == [e for e in rt["traceEvents"] if e["pid"] == 1000]
    assert sum(e["ph"] == "X" for e in lane) == len(_OPS)


def test_kernel_launches_by_kind():
    names = ("void (anonymous namespace)::scan_body_cluster_kernel"
             "<float, true, false>(float const*)",
             "void (anonymous namespace)::scan_body_kernel<float, false>"
             "(float const*)")
    ev = []
    kinds = ["fwd_bnd", "adj", "fwd_bnd", "adj", "fwd"]
    for i, kind in enumerate(kinds):
        t = 100.0 * i
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"scan_body.{kind}", "pid": 1, "tid": 1,
                   "ts": t, "dur": 20.0, "args": {}})
        # The profiler may name the launching thread differently in its
        # host ranges and its launch calls.
        ev.append({"ph": "X", "cat": "cuda_driver",
                   "name": "cuLaunchKernelEx", "pid": 1, "tid": 1 + i % 2,
                   "ts": t + 5.0, "dur": 3.0, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel", "name": names[i % 2],
                   "pid": 0, "tid": 7, "ts": t + 30.0, "dur": 50.0,
                   "args": {"correlation": i}})
    # A launch whose call event is missing: the device-lane range names it.
    ev.append({"ph": "X", "cat": "gpu_user_annotation",
               "name": "scan_body.fwd", "pid": 0, "tid": 7, "ts": 990.0,
               "dur": 40.0, "args": {}})
    ev.append({"ph": "X", "cat": "kernel", "name": names[1], "pid": 0,
               "tid": 7, "ts": 1000.0, "dur": 20.0,
               "args": {"correlation": 99}})
    # One with neither, and a kernel that is not the scan body.
    ev.append({"ph": "X", "cat": "kernel", "name": names[0], "pid": 0,
               "tid": 7, "ts": 2000.0, "dur": 5.0, "args": {}})
    ev.append({"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
               "pid": 0, "tid": 7, "ts": 2100.0, "dur": 5.0, "args": {}})
    assert pprofile.kernel_launches(ev) == {
        "fwd": 2, "fwd_bnd": 2, "adj": 2, "unattributed": 1, "total": 7}


def test_span_device_time_follows_launches():
    """On a card the ops launched while a span was open count toward it,
    nested spans' and other threads' too, wherever the device ran them;
    kineto's device-lane range holds only the ops of the innermost
    span."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "round.dispatch",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0, "args": {}},
        {"ph": "X", "cat": "user_annotation", "name": "engine.trace",
         "pid": 1, "tid": 1, "ts": 10.0, "dur": 20.0, "args": {}},
        {"ph": "X", "cat": "user_annotation", "name": "round.fetch",
         "pid": 1, "tid": 1, "ts": 150.0, "dur": 300.0, "args": {}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "round.dispatch",
         "pid": 0, "tid": 7, "ts": 400.0, "dur": 5.0, "args": {}},
    ]
    # (launch time, device start, duration): two launched by engine.trace,
    # one by round.dispatch itself from another thread (autograd's), one
    # by round.fetch (the copy).
    for i, (t, start, dur) in enumerate(((12.0, 200.0, 30.0),
                                         (20.0, 240.0, 50.0),
                                         (60.0, 400.0, 5.0),
                                         (160.0, 420.0, 4.0))):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 1,
                   "tid": 2 if i == 2 else 1, "ts": t, "dur": 2.0,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel" if i < 3 else "gpu_memcpy",
                   "name": f"k{i}", "pid": 0, "tid": 7, "ts": start,
                   "dur": dur, "args": {"correlation": i}})
    got = pprofile.parse_events(ev, {"round.dispatch", "engine.trace",
                                     "round.fetch"})["annotations"]
    assert got == {
        "round.dispatch": {"count": 1, "wall_us": 100.0, "busy_us": 85.0},
        "engine.trace": {"count": 1, "wall_us": 20.0, "busy_us": 20.0},
        "round.fetch": {"count": 1, "wall_us": 300.0, "busy_us": 4.0}}


def _vqc_steps(n: int, steps: int, seed: int = 0):
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    model = make_vqc_classifier(n, 1, 2, device="cpu")
    params = model.init(seed)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (8, n)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 2, 8))
    for _ in range(steps):
        with pobs.span("round.dispatch"):
            leaves = {k: {kk: v.detach().requires_grad_(True)
                          for kk, v in d.items()} for k, d in params.items()}
            loss = torch.nn.functional.cross_entropy(
                model.apply(leaves, x), y)
            loss.backward()
        with pobs.span("round.fetch"):
            float(loss.detach())


def test_cpu_capture_of_vqc_steps_parses_end_to_end(monkeypatch, tmp_path):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    monkeypatch.setenv("QFEDX_TRACE_XLA", "1")
    with pprofile.capture(tmp_path / "prof", cuda=False):
        _vqc_steps(4, 3)
    summary = pprofile.write_profile_summary(tmp_path, tmp_path / "prof",
                                             steps=3)
    assert set(summary) == set(pprofile.SUMMARY_FIELDS)
    assert json.loads((tmp_path / "profile_summary.json").read_text()) == (
        summary)
    assert summary["ops_executed"] > 10 and summary["gap_count"] > 0
    assert summary["device_lanes"] >= 1 and summary["top_ops"]
    assert set(summary["spans"]) >= {"round.dispatch"}
    for row in summary["spans"].values():
        assert 0 < row["utilization"] <= 1
        assert row["device_busy_s"] <= row["wall_s"]
    parsed = pprofile.parse_capture(tmp_path / "prof")
    assert parsed["capture_meta"]["origin_unix"] == (
        ptrace.registry().origin_unix)
    assert pprofile.align_offset_us(parsed) is not None
    rows = pobs.phase_rollup()
    assert 0 < rows["round.dispatch"]["utilization"] <= 1
    merged = json.loads(pprofile.write_merged_trace(
        tmp_path / "trace.json", parsed).read_text())
    assert any(e["pid"] == 1000 and e["ph"] == "X"
               for e in merged["traceEvents"])
    assert pprofile.kernel_launches(pprofile.load_capture(
        parsed["capture_path"]))["total"] == 0


@pytest.mark.parametrize("how", ["exception", "sigterm"])
def test_cut_capture_still_parses(tmp_path, how):
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises((RuntimeError, KeyboardInterrupt)):
        with pprofile.capture(tmp_path, cuda=False):
            _vqc_steps(4, 1)
            if how == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
                _vqc_steps(4, 100)  # interrupted long before it ends
            raise RuntimeError("boom")
    assert signal.getsignal(signal.SIGTERM) is before
    parsed = pprofile.parse_capture(tmp_path, span_names=())
    assert parsed["ops_executed"] > 0
    with pytest.raises(FileNotFoundError):
        pprofile.parse_capture(tmp_path / "nothing")


@pytest.mark.parametrize("n", [10, 12])
def test_census_fused_fewer_state_ops_than_unfused(monkeypatch, n):
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.uniform(0, 1, (4, n)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 2, 4))
    monkeypatch.setenv("QFEDX_SCAN_LAYERS", "off")
    counts = {}
    for fuse in ("1", "off"):
        monkeypatch.setenv("QFEDX_FUSE", fuse)
        model = make_vqc_classifier(n, 2, 2, device="cpu")
        params = model.init(0)

        def step(p):
            leaves = {k: {kk: v.detach().requires_grad_(True)
                          for kk, v in d.items()} for k, d in p.items()}
            torch.nn.functional.cross_entropy(
                model.apply(leaves, x), y).backward()

        counts[fuse] = census.module_counts(step, params, n)
    fused, unfused = counts["1"], counts["off"]
    assert 0 < fused["lowered_state_ops"] < unfused["lowered_state_ops"]
    assert fused["lowered_ops"] > fused["lowered_state_ops"]
    assert set(fused) == {"lowered_ops", "lowered_state_ops",
                          "compiled_instructions", "compiled_fusions"}
    assert fused["compiled_fusions"] == 0  # no launches on the CPU
