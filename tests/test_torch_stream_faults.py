"""Port vs reference: the fault plan's seams in the wave uploader
(qfedx_tpu_torch/data/stream.py ``WaveStream(fault_plan=, round_idx=)``).

At depth 0 and at depth 1, each against the reference's ``WaveStream``
on the same registry and plan:

- ``registry.fetch`` and ``ingest.h2d`` with ``times: 1`` recover in
  place: every wave arrives, equal to the clean fetch;
- a persistent ``registry.fetch`` fault is a ``StreamError`` naming its
  wave under ``"raise"`` and a ``DroppedWave`` in its slot under
  ``"drop"`` (the other waves intact);
- ``nan``/``inf`` poison and ``label_flip`` give the reference's fetched
  arrays exactly (NaN positions included; labels keep their dtype);
- under ``"buffer"`` a wave whose planned delay exceeds the deadline is
  declared late up front: the ``LateWave`` lands in its slot, the prompt
  waves follow without waiting for it, and ``poll_late`` hands over its
  deferred upload — the same sequence as the reference's.

Lateness comes from a declared delay far above the deadline, never from
a race against the clock: the declaration is decided from the plan.
"""

import time

import numpy as np
import pytest
import torch

from qfedx_tpu.data import stream as rstream
from qfedx_tpu.fed.round import client_mesh
from qfedx_tpu.utils.faults import FaultPlan as RFaultPlan
from qfedx_tpu_torch.data.stream import (
    ArrayRegistry,
    DroppedWave,
    LateWave,
    StreamError,
    WaveStream,
)
from qfedx_tpu_torch.utils.faults import FaultPlan

C, S, N_F, W = 16, 4, 3, 4
DEADLINE_S = 2.0  # prompt waves arrive far inside it
DELAY_S = 3.0  # the declared straggler's planned delay: > DEADLINE_S


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N_F)).astype(np.float32)
    cx[2, 1, 0] = 0.0  # 0·inf is NaN, not inf
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((C, S), dtype=np.float32)
    return cx, cy, cm


def _both(spec, depth, round_idx=0, ids=None, **kw):
    """Drain the port's and the reference's streams of one round; each
    item as ("wave", lo, arrays) / ("dropped", wave) / ("late", wave)."""
    data = _data()
    ids = np.arange(C) if ids is None else ids
    out = []
    for port in (True, False):
        plan = (FaultPlan if port else RFaultPlan).from_spec(spec)
        if port:
            s = WaveStream(ArrayRegistry(*data), "cpu", ids, W, depth=depth,
                           fault_plan=plan, round_idx=round_idx, **kw)
        else:
            s = rstream.WaveStream(rstream.ArrayRegistry(*data),
                                   client_mesh(num_devices=1), ids, W,
                                   depth=depth, fault_plan=plan,
                                   round_idx=round_idx, **kw)
        try:
            items = [_item(i) for i in s]
            late = []
            if kw.get("on_wave_error") == "buffer":
                got, failed = s.poll_late(timeout_s=30.0)
                late = [_item(i) for i in got] + [("failed", f)
                                                  for f in failed]
        finally:
            s.close()
        out.append((items, late))
    return out


def _item(i):
    if isinstance(i, DroppedWave) or isinstance(i, rstream.DroppedWave):
        return ("dropped", i.wave)
    if isinstance(i, LateWave) or isinstance(i, rstream.LateWave):
        return ("late", i.wave)
    lo, arrays = i
    return ("wave", int(lo), tuple(np.asarray(a) for a in arrays))


def _equal(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        if g[0] != "wave":
            continue
        for a, b in zip(g[2], w[2]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b, equal_nan=True)


def _clean(lo, data=None):
    cx, cy, cm = data or _data()
    return cx[lo:lo + W], cy[lo:lo + W], cm[lo:lo + W]


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("site", ["registry.fetch", "ingest.h2d"])
def test_transient_fault_recovers(depth, site):
    spec = {"seed": 0, "rules": [{"site": site, "waves": [1, 3],
                                  "times": 1}]}
    (got, _), (want, _) = _both(spec, depth)
    _equal(got, want)
    assert [g[1] for g in got] == [0, 4, 8, 12]
    for _, lo, arrays in got:
        for a, b in zip(arrays, _clean(lo)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [0, 1])
def test_persistent_fetch_fault_raises(depth):
    spec = {"seed": 0, "rules": [{"site": "registry.fetch", "waves": [2]}]}
    for port in (True, False):
        plan = (FaultPlan if port else RFaultPlan).from_spec(spec)
        data = _data()
        s = (WaveStream(ArrayRegistry(*data), "cpu", np.arange(C), W,
                        depth=depth, fault_plan=plan) if port else
             rstream.WaveStream(rstream.ArrayRegistry(*data),
                                client_mesh(num_devices=1), np.arange(C), W,
                                depth=depth, fault_plan=plan))
        got = []
        with pytest.raises((StreamError, rstream.StreamError)) as ei:
            for item in s:
                got.append(_item(item)[:2])
        s.close()
        assert got == [("wave", 0), ("wave", 4)]
        assert ei.value.wave == 2
        assert type(ei.value.original).__name__ == "FaultInjected"


@pytest.mark.parametrize("depth", [0, 1])
def test_persistent_fetch_fault_drops_its_wave(depth):
    spec = {"seed": 0, "rules": [{"site": "registry.fetch", "waves": [1]}]}
    (got, _), (want, _) = _both(spec, depth, on_wave_error="drop")
    _equal(got, want)
    assert [g[:2] for g in got] == [("wave", 0), ("dropped", 1),
                                    ("wave", 8), ("wave", 12)]


@pytest.mark.parametrize("depth", [0, 1])
def test_poison_and_label_flips_equal_reference(depth):
    spec = {"seed": 3, "rules": [
        {"site": "client.compute", "kind": "nan", "clients": [5]},
        {"site": "client.compute", "kind": "inf", "clients": [2, 13]},
        {"site": "client.compute", "kind": "nan", "rate": 0.2},
        {"site": "client.byzantine", "kind": "label_flip",
         "clients": [1, 5, 10]},
        {"site": "client.byzantine", "kind": "label_flip", "rate": 0.25},
    ]}
    ids = np.arange(C)[::-1].copy()  # ids are keyed, not positions
    for r in (0, 1):
        (got, _), (want, _) = _both(spec, depth, round_idx=r, ids=ids)
        _equal(got, want)
        plan = FaultPlan.from_spec(spec)
        cx, cy, _ = _data()
        pois = plan.poison(r, ids)
        flips = plan.label_flips(r, ids)
        assert np.isnan(pois).sum() >= 1 and np.isinf(pois).sum() == 2
        for _, lo, (wx, wy, _) in got:
            wid = ids[lo:lo + W]
            assert np.array_equal(wx, cx[wid] * pois[lo:lo + W, None, None],
                                  equal_nan=True)
            assert wy.dtype == np.int32
            np.testing.assert_array_equal(
                wy, np.where(flips[lo:lo + W, None], 1 - cy[wid], cy[wid]))
        # client 2's zero feature went NaN (0·inf), the rest inf
        pos = int(np.flatnonzero(ids == 2)[0])
        w2 = got[pos // W][2][0][pos % W]
        assert np.isnan(w2[1, 0]) and np.isinf(w2[0]).all()


@pytest.mark.parametrize("depth", [0, 1])
def test_declared_straggler_is_late_up_front(depth):
    spec = {"seed": 0, "rules": [
        {"site": "wave.delay", "kind": f"delay:{DELAY_S}", "waves": [1]},
    ]}
    t0 = time.monotonic()
    (got, late), (want, rlate) = _both(
        spec, depth, on_wave_error="buffer", wave_deadline_s=DEADLINE_S)
    _equal(got, want)
    _equal(late, rlate)
    assert [g[:2] for g in got] == [("wave", 0), ("late", 1), ("wave", 8),
                                    ("wave", 12)]
    assert [g[:2] for g in late] == [("wave", 4)]
    for a, b in zip(late[0][2], _clean(4)):
        np.testing.assert_array_equal(a, b)
    # Each package slept the delay once (not per retry, not per wave).
    assert time.monotonic() - t0 < 4 * DELAY_S


def test_slow_client_delays_only_its_wave():
    """client.slow's seconds become its wave's delay: past the deadline
    that wave alone is declared late, the others arrive."""
    spec = {"seed": 0, "rules": [
        {"site": "client.slow", "kind": f"slow:{DELAY_S}", "clients": [9]},
    ]}
    plan = FaultPlan.from_spec(spec)
    np.testing.assert_array_equal(plan.wave_delays(0, np.arange(C), W),
                                  np.array([0, 0, DELAY_S, 0], np.float32))
    (got, late), (want, rlate) = _both(
        spec, 1, on_wave_error="buffer", wave_deadline_s=DEADLINE_S)
    _equal(got, want)
    _equal(late, rlate)
    assert [g[:2] for g in got] == [("wave", 0), ("wave", 4), ("late", 2),
                                    ("wave", 12)]
    assert [g[:2] for g in late] == [("wave", 8)]
