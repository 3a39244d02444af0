"""Port vs reference: streamed ingestion (qfedx_tpu_torch/data/stream.py)
and the cohort sampler (fed/sampling.py ``CohortSampler``).

- ``CohortSampler``: the port's ids equal the reference's bit for bit,
  round by round and on a fresh sampler asked out of order (a resumed
  run), at cohorts below and equal to the registry;
- ``SyntheticRegistry.batch`` equal to the reference's bit for bit,
  ids near 2^20 included; ``ArrayRegistry`` slices as the reference's;
- ``WaveStream`` (port only, mirroring ``tests/test_stream.py``): order
  and content at depths 0, 1 and 2; close mid-stream with no hang and no
  live thread; divisibility; a worker error arriving promptly as a typed
  ``StreamError``; transient failures retried in place; retries
  exhausted → ``DroppedWave``; a fetch hung past ``wave_deadline_s`` →
  ``DroppedWave`` ("drop"), a prompt ``StreamError`` ("raise"), or a
  ``LateWave`` then ``poll_late`` ("buffer"); an uploader that dies
  without a word;
- the ``QFEDX_STREAM`` pin parsed as the reference parses it;
- where a fault plan is still refused (the unguarded round, a plan that
  does not validate); the plan's seams: ``tests/test_torch_stream_faults.py``.

Lateness comes from registries gated by a ``threading.Event`` that the
test opens when the stream has yielded its marker, never from sleeps
racing a clock. Timing bounds (``HANG_S``) only catch a stream that
hangs; the tensors compare exactly.
"""

import threading
import time

import numpy as np
import pytest
import torch

from qfedx_tpu.data import stream as rstream
from qfedx_tpu.fed.sampling import CohortSampler as RefSampler
from qfedx_tpu_torch.data.stream import (
    ArrayRegistry,
    DroppedWave,
    LateWave,
    StreamError,
    SyntheticRegistry,
    WaveStream,
    resolve_stream_depth,
)
from qfedx_tpu_torch.fed.sampling import CohortSampler

N_F = 3
HANG_S = 5.0  # a stream call that takes longer than this has hung


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(C=16, S=4, seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N_F)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((C, S), dtype=np.float32)
    return cx, cy, cm


class Gated:
    """An ArrayRegistry whose fetch of the wave starting at client
    ``gated`` blocks until ``release`` is set, then raises when
    ``fail`` is set."""

    def __init__(self, data, gated: int, fail: bool = False):
        self.cx, self.cy, self.cm = data
        self.num_clients = len(self.cx)
        self.gated, self.fail = gated, fail
        self.release = threading.Event()

    def batch(self, ids):
        if ids[0] == self.gated:
            assert self.release.wait(HANG_S * 4), "the test never released"
            if self.fail:
                raise RuntimeError("gated wave failed")
        return self.cx[ids], self.cy[ids], self.cm[ids]


def _wave_equal(item, data, width=4):
    lo, (wx, wy, wm) = item
    cx, cy, cm = data
    np.testing.assert_array_equal(wx.numpy(), cx[lo:lo + width])
    np.testing.assert_array_equal(wy.numpy(), cy[lo:lo + width])
    np.testing.assert_array_equal(wm.numpy(), cm[lo:lo + width])
    return lo


# --- CohortSampler ------------------------------------------------------------


@pytest.mark.parametrize("registry_size,cohort_size",
                         [(64, 16), (1000, 64), (1 << 20, 256), (32, 32)])
def test_sampler_matches_reference(registry_size, cohort_size):
    port = CohortSampler(registry_size, cohort_size, seed=7)
    ref = RefSampler(registry_size, cohort_size, seed=7)
    draws = [port.round_ids(r) for r in range(6)]
    for r, ids in enumerate(draws):
        want = ref.round_ids(r)
        assert ids.dtype == want.dtype
        np.testing.assert_array_equal(ids, want)
        assert len(np.unique(ids)) == cohort_size and np.all(np.diff(ids) > 0)
    fresh = CohortSampler(registry_size, cohort_size, seed=7)
    for r in (5, 3, 0):  # a resumed run asks out of order
        np.testing.assert_array_equal(fresh.round_ids(r), draws[r])
    if cohort_size < registry_size:
        assert not np.array_equal(draws[0], draws[1])
    else:
        np.testing.assert_array_equal(draws[0], np.arange(registry_size))


def test_sampler_rejects_bad_shapes():
    for sampler in (CohortSampler, RefSampler):
        with pytest.raises(ValueError):
            sampler(8, 16)
        with pytest.raises(ValueError):
            sampler(8, 0)
        with pytest.raises(ValueError):
            sampler(8, 4).round_ids(-1)


# --- registries -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_registry_matches_reference(seed):
    size = 1 << 20
    port = SyntheticRegistry(size, samples=4, n_features=8, seed=seed)
    ref = rstream.SyntheticRegistry(size, samples=4, n_features=8, seed=seed)
    ids = np.array([5, 0, size - 1, 999_999, size - 2, 12, size - 3])
    for got, want in zip(port.batch(ids), ref.batch(ids)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # a client's data is the same whichever batch fetches it
    np.testing.assert_array_equal(port.batch(ids[2:3])[0][0],
                                  port.batch(ids)[0][2])
    for reg in (port, ref):
        with pytest.raises(ValueError):
            reg.batch(np.array([size]))
        with pytest.raises(ValueError):
            type(reg)(0)


def test_array_registry_slices_as_reference():
    data = _data()
    port, ref = ArrayRegistry(*data), rstream.ArrayRegistry(*data)
    assert port.num_clients == ref.num_clients == 16
    ids = np.array([3, 0, 15, 3])
    for got, want in zip(port.batch(ids), ref.batch(ids)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ArrayRegistry(data[0], data[1][:3], data[2])


# --- WaveStream -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_wave_stream_order_and_content(depth):
    data = _data()
    ids = np.arange(16)[::-1].copy()  # cohort order, not id order
    stream = WaveStream(ArrayRegistry(*data), "cpu", ids, wave_size=4,
                        depth=depth)
    assert (stream._thread is None) == (depth == 0)
    seen = []
    for lo, (wx, wy, wm) in stream:
        seen.append(lo)
        np.testing.assert_array_equal(wx.numpy(), data[0][ids[lo:lo + 4]])
        np.testing.assert_array_equal(wy.numpy(), data[1][ids[lo:lo + 4]])
        assert wx.dtype == torch.float32 and wm.dtype == torch.float32
    assert seen == [0, 4, 8, 12]
    stream.close()  # idempotent on a consumed stream
    stream.close()


def test_close_midstream_neither_stalls_nor_leaks_thread():
    stream = WaveStream(ArrayRegistry(*_data()), "cpu", np.arange(16),
                        wave_size=4, depth=1)
    next(stream)  # the uploader now races ahead
    t0 = time.perf_counter()
    stream.close()
    assert time.perf_counter() - t0 < HANG_S
    assert not stream._thread.is_alive()
    with pytest.raises(StopIteration):
        next(stream)


def test_wave_stream_validates_divisibility():
    reg = ArrayRegistry(*_data())
    for wave in (5, 0):
        with pytest.raises(ValueError, match="divisible"):
            WaveStream(reg, "cpu", np.arange(16), wave_size=wave)
    with pytest.raises(ValueError, match="on_wave_error"):
        WaveStream(reg, "cpu", np.arange(16), wave_size=4,
                   on_wave_error="retry")
    with pytest.raises(ValueError, match="wave_deadline_s"):
        WaveStream(reg, "cpu", np.arange(16), wave_size=4,
                   wave_deadline_s=0.0)


class Exploding:
    num_clients = 16

    def __init__(self, from_id=8):
        self.data, self.from_id = _data(), from_id
        self.calls = 0

    def batch(self, ids):
        self.calls += 1
        if ids[0] >= self.from_id:
            raise RuntimeError("registry fetch failed")
        return tuple(a[ids] for a in self.data)


def test_worker_errors_arrive_promptly_as_stream_error():
    reg = Exploding()
    stream = WaveStream(reg, "cpu", np.arange(16), wave_size=4, depth=1)
    assert [next(stream)[0], next(stream)[0]] == [0, 4]
    t0 = time.perf_counter()
    with pytest.raises(StreamError, match="registry fetch failed") as ei:
        next(stream)
    assert time.perf_counter() - t0 < HANG_S
    assert ei.value.wave == 2
    assert isinstance(ei.value.original, RuntimeError)
    stream.close()
    # synchronous path: the same typed error, raised in the loop
    sync = WaveStream(Exploding(), "cpu", np.arange(16), wave_size=4,
                      depth=0)
    assert next(sync)[0] == 0 and next(sync)[0] == 4
    with pytest.raises(StreamError, match="wave 2"):
        next(sync)


def test_transient_failures_retried_in_place():
    """Each wave's first fetch fails: the retry recovers it, every wave
    arrives in order with its bytes, and the consumer never hears."""
    data = _data()
    tries: dict = {}

    class Flaky:
        num_clients = 16

        def batch(self, ids):
            tries[int(ids[0])] = tries.get(int(ids[0]), 0) + 1
            if tries[int(ids[0])] == 1:
                raise ConnectionError("transient")
            return tuple(a[ids] for a in data)

    for depth in (0, 1):
        tries.clear()
        stream = WaveStream(Flaky(), "cpu", np.arange(16), wave_size=4,
                            depth=depth)
        assert [_wave_equal(it, data) for it in stream] == [0, 4, 8, 12]
        assert tries == {0: 2, 4: 2, 8: 2, 12: 2}
        stream.close()


@pytest.mark.parametrize("depth", [0, 1])
def test_retry_exhaustion_converts_wave_to_dropped_marker(depth):
    data = _data()

    class DeadWave1:
        num_clients = 16

        def batch(self, ids):
            if ids[0] == 4:
                raise RuntimeError("shard down")
            return tuple(a[ids] for a in data)

    for mode in ("drop", "buffer") if depth else ("drop",):
        stream = WaveStream(DeadWave1(), "cpu", np.arange(16), wave_size=4,
                            depth=depth, on_wave_error=mode)
        got = list(stream)
        stream.close()
        assert len(got) == 4
        assert isinstance(got[1], DroppedWave)
        assert (got[1].wave, got[1].wave_base) == (1, 4)
        assert isinstance(got[1].error, StreamError)
        assert [_wave_equal(g, data) for g in (got[0], got[2], got[3])] == [
            0, 8, 12]


def test_hung_fetch_past_the_deadline():
    """"drop": the hung wave 1 becomes a DroppedWave; once released, its
    late delivery is discarded and waves 2 and 3 flow. "raise": a prompt
    typed error."""
    data = _data()
    reg = Gated(data, gated=4)
    stream = WaveStream(reg, "cpu", np.arange(16), wave_size=4, depth=1,
                        on_wave_error="drop", wave_deadline_s=0.5)
    got = []
    t0 = time.perf_counter()
    for item in stream:
        got.append(item)
        if isinstance(item, DroppedWave):
            reg.release.set()
    stream.close()
    assert time.perf_counter() - t0 < HANG_S
    dropped = [g for g in got if isinstance(g, DroppedWave)]
    assert [d.wave for d in dropped] == [1]
    assert "deadline" in str(dropped[0].error)
    served = [g for g in got if not isinstance(g, DroppedWave)]
    assert [_wave_equal(g, data) for g in served] == [0, 8, 12]

    reg2 = Gated(data, gated=4)
    stream2 = WaveStream(reg2, "cpu", np.arange(16), wave_size=4, depth=1,
                         wave_deadline_s=0.4)
    assert next(stream2)[0] == 0
    t0 = time.perf_counter()
    with pytest.raises(StreamError, match="deadline"):
        next(stream2)
    assert time.perf_counter() - t0 < HANG_S
    reg2.release.set()
    stream2.close()


@pytest.mark.parametrize("gated", [4, 12], ids=["mid", "last"])
def test_buffer_mode_late_wave_then_poll_late(gated):
    """"buffer": the hung wave is yielded as a LateWave in its slot, the
    stream goes on once it is released, and ``poll_late`` hands the
    finished upload over with its bytes, exactly once."""
    data = _data()
    reg = Gated(data, gated=gated)
    stream = WaveStream(reg, "cpu", np.arange(16), wave_size=4, depth=1,
                        on_wave_error="buffer", wave_deadline_s=0.5)
    got = []
    for item in stream:
        got.append(item)
        if isinstance(item, LateWave):
            reg.release.set()
    late = [g for g in got if isinstance(g, LateWave)]
    assert [(lw.wave, lw.wave_base) for lw in late] == [(gated // 4, gated)]
    assert sorted(g[0] for g in got if not isinstance(g, LateWave)) == [
        lo for lo in (0, 4, 8, 12) if lo != gated]
    assert stream.late_pending()
    items, failed = stream.poll_late(timeout_s=HANG_S)
    assert failed == [] and [_wave_equal(it, data) for it in items] == [gated]
    assert not stream.late_pending()
    assert stream.poll_late() == ([], [])
    stream.close()
    with pytest.raises(RuntimeError, match="buffer"):
        WaveStream(reg, "cpu", np.arange(16), wave_size=4).poll_late()


def test_buffer_mode_failed_straggler_and_abandon():
    """A straggler whose fetch then fails for good comes back in
    ``poll_late``'s failed list; one never released is given up by
    ``abandon_late``."""
    data = _data()
    reg = Gated(data, gated=12, fail=True)
    stream = WaveStream(reg, "cpu", np.arange(16), wave_size=4, depth=1,
                        on_wave_error="buffer", wave_deadline_s=0.5)
    got = list(stream)
    assert isinstance(got[3], LateWave)
    reg.release.set()
    items, failed = stream.poll_late(timeout_s=HANG_S)
    assert items == [] and failed == [3]
    assert not stream.late_pending()
    stream.close()

    reg2 = Gated(data, gated=8)
    stream2 = WaveStream(reg2, "cpu", np.arange(16), wave_size=4, depth=1,
                         on_wave_error="buffer", wave_deadline_s=0.5)
    got2 = []
    for item in stream2:
        got2.append(item)
        if isinstance(item, LateWave):
            break  # a consumer that moves on: waves 2 and 3 stay queued
    assert stream2.poll_late(timeout_s=0.1) == ([], [])
    assert stream2.late_pending() and stream2.abandon_late() == [2]
    assert not stream2.late_pending()
    reg2.release.set()
    t0 = time.perf_counter()
    stream2.close()
    assert time.perf_counter() - t0 < HANG_S


def test_uploader_death_without_sentinel_raises_promptly(monkeypatch):
    monkeypatch.setattr(WaveStream, "_uploader", lambda self: None)
    stream = WaveStream(ArrayRegistry(*_data()), "cpu", np.arange(16),
                        wave_size=4, depth=1)
    t0 = time.perf_counter()
    with pytest.raises(StreamError, match="uploader thread died"):
        next(stream)
    assert time.perf_counter() - t0 < HANG_S
    stream.close()


@pytest.mark.parametrize("value", [None, "off", "on", "0", "1", "3", "fast",
                                   "-1"])
def test_stream_depth_pin_parses_as_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("QFEDX_STREAM", raising=False)
    else:
        monkeypatch.setenv("QFEDX_STREAM", value)
    outs = []
    for resolve in (resolve_stream_depth, rstream.resolve_stream_depth):
        try:
            outs.append(resolve())
        except ValueError:
            outs.append("ValueError")
    assert outs[0] == outs[1]
    for explicit in (0, 2):
        assert resolve_stream_depth(explicit) == explicit
    with pytest.raises(ValueError):
        resolve_stream_depth(-1)


def test_fault_plans_are_refused(monkeypatch):
    """Where a plan is still refused: the unguarded round
    (QFEDX_GUARDS=off) and a QFEDX_FAULTS that does not validate. The
    stream reads no pin: its plan comes from its caller (the seams
    themselves: tests/test_torch_stream_faults.py)."""
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.run.trainer import train_federated_streamed
    from qfedx_tpu_torch.utils.faults import FaultPlan

    reg = ArrayRegistry(*_data())
    monkeypatch.setenv("QFEDX_GUARDS", "off")
    with pytest.raises(ValueError, match="QFEDX_GUARDS"):
        train_federated_streamed(None, FedConfig(), reg, None, None,
                                 cohort_size=16, fault_plan=FaultPlan())
    monkeypatch.delenv("QFEDX_GUARDS")
    monkeypatch.setenv("QFEDX_FAULTS", '{"rules": [{"site": "typo"}]}')
    with pytest.raises(ValueError, match="typo"):
        train_federated_streamed(None, FedConfig(), reg, None, None,
                                 cohort_size=16)
    s = WaveStream(reg, "cpu", np.arange(16), wave_size=4)
    assert [item[0] for item in s] == [0, 4, 8, 12]
    s.close()
    monkeypatch.setenv("QFEDX_FAULTS", "off")
    WaveStream(reg, "cpu", np.arange(16), wave_size=4,
               fault_plan=FaultPlan()).close()
