"""Streamed client ingestion: registry → per-round cohort → waves on the
device.

Counterpart of ``qfedx_tpu/data/stream.py``. A round's cohort is sampled
from a REGISTRY of possibly millions of clients
(``fed.sampling.CohortSampler``), split into fixed-size waves, and each
wave's client data is uploaded by ``WaveStream`` while the previous wave
computes its ``fed.round.RoundPartial``, so a round holds only
``depth + 1`` waves on the device.

Registries (duck-typed: a ``num_clients`` attribute and ``batch(ids) ->
(cx, cy, cmask)`` numpy arrays), copied from the reference bit for bit:

- ``SyntheticRegistry``: every client's data is a counter hash
  (SplitMix64) of (seed, client, sample, feature), so ``batch``
  materialises only the requested ids and a client's data is the same
  whenever it is fetched;
- ``ArrayRegistry``: packed ``pack_clients`` arrays, so the streamed
  trainer can be held against the resident one on the same bytes.

``QFEDX_STREAM`` pins the prefetch depth (``0``/``off``: synchronous
uploads in the consumer loop, no thread; ``1``/``on``, the default:
double buffering; an integer: deeper). Depth never changes results.

On the card the uploader thread copies each wave into pinned host
memory and then to the device on a side ``torch.cuda.Stream``,
recording an event; the consumer makes its own stream wait on that
event and marks every tensor with ``record_stream`` before using it, so
the copy overlaps the previous wave's compute and the caching allocator
cannot hand a wave's memory out while the consumer still reads it.

A ``fault_plan`` (``utils.faults.FaultPlan``; the trainer passes the
one ``QFEDX_FAULTS`` pins) injects the reference's faults at the same
seams: a planned straggle (``client.slow``/``wave.delay``) sleeps once
per wave before its retries; inside each retried attempt the
``registry.fetch`` check, the fetch, the ``client.compute`` poison
(features × NaN/Inf), the ``label_flip`` attack (y → 1 − y) and the
``ingest.h2d`` check run in that order, so nothing reaches the device
before the last check passes. Under ``"buffer"`` a wave whose planned
delay exceeds ``wave_deadline_s`` is declared late up front and its
upload deferred behind every prompt wave.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from qfedx_tpu_torch.utils import pins
from qfedx_tpu_torch.utils.retry import RetryExhausted, retry_with_deadline


class StreamError(RuntimeError):
    """A wave upload failed for good (retries exhausted) or the uploader
    thread died, delivered promptly on the consumer queue. Carries the
    ``wave`` index and the ``original`` exception (also chained as
    ``__cause__`` when the consumer raises it)."""

    def __init__(self, message: str, wave: int | None = None,
                 original: BaseException | None = None):
        super().__init__(message)
        self.wave = wave
        self.original = original


class DroppedWave:
    """A wave the stream gave up on: its fetch failed past the retry
    deadline, or it missed the consumer's ``wave_deadline_s``. With
    ``on_wave_error="drop"`` the stream yields this marker in the wave's
    cohort position and moves on; the trainer turns it into casualties
    and the secure-agg mask correction."""

    def __init__(self, wave: int, wave_base: int,
                 error: BaseException | None = None):
        self.wave = wave
        self.wave_base = wave_base
        self.error = error

    def __repr__(self):
        return f"DroppedWave(wave={self.wave}, base={self.wave_base})"


class LateWave:
    """A straggler marker: the wave missed ``wave_deadline_s`` but its
    upload keeps running in the background. With
    ``on_wave_error="buffer"`` the finished upload comes later through
    ``poll_late``, and the trainer folds its partial into a later round
    at a staleness discount."""

    def __init__(self, wave: int, wave_base: int):
        self.wave = wave
        self.wave_base = wave_base

    def __repr__(self):
        return f"LateWave(wave={self.wave}, base={self.wave_base})"


def resolve_stream_depth(depth: int | None = None) -> int:
    """Prefetch depth of the wave uploader: an explicit ``depth`` wins;
    otherwise the ``QFEDX_STREAM`` pin ('0'/'off' → 0, '1'/'on' → 1, or
    an integer), default 1."""
    if depth is not None:
        depth = int(depth)
        if depth < 0:
            raise ValueError(f"stream depth must be >= 0, got {depth}")
        return depth
    return pins.depth_pin("QFEDX_STREAM", 1)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised SplitMix64 finalizer: uint64 → well-mixed uint64."""
    with np.errstate(over="ignore"):  # mod-2^64 wraparound IS the mixer
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _uniform01(bits: np.ndarray) -> np.ndarray:
    """uint64 hash words → float32 uniforms in [0, 1)."""
    return ((bits >> np.uint64(40)) / np.float32(1 << 24)).astype(np.float32)


class SyntheticRegistry:
    """A simulated registry of ``num_clients`` clients whose data is
    generated on demand: ``samples`` feature vectors of width
    ``n_features`` in [0, 1) per client, label = mean feature > 0.5, each
    a counter hash of (seed, client, sample, feature)."""

    def __init__(self, num_clients: int, samples: int = 8,
                 n_features: int = 8, seed: int = 0):
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self.num_clients = int(num_clients)
        self.samples = int(samples)
        self.n_features = int(n_features)
        self.seed = int(seed)

    def batch(self, ids: np.ndarray):
        """The clients ``ids`` as packed ``(cx, cy, cmask)`` arrays of
        shape [len(ids), samples, n_features] / [., samples]."""
        ids = np.asarray(ids, dtype=np.uint64)
        if ids.size and (int(ids.max()) >= self.num_clients):
            raise ValueError("client id outside the registry")
        s, f = self.samples, self.n_features
        counters = (
            (ids[:, None, None] * np.uint64(s)
             + np.arange(s, dtype=np.uint64)[None, :, None]) * np.uint64(f)
            + np.arange(f, dtype=np.uint64)[None, None, :]
        )
        cx = _uniform01(
            _splitmix64(counters ^ _splitmix64(np.uint64(self.seed)))
        )
        cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
        cmask = np.ones((len(ids), s), dtype=np.float32)
        return cx, cy, cmask


class ArrayRegistry:
    """Registry view over pre-packed client arrays (``pack_clients``
    layout): the streamed and the resident trainer read the same bytes."""

    def __init__(self, cx: np.ndarray, cy: np.ndarray, cmask: np.ndarray):
        if not (len(cx) == len(cy) == len(cmask)):
            raise ValueError("cx/cy/cmask disagree on client count")
        self.num_clients = len(cx)
        self._cx, self._cy, self._cmask = cx, cy, cmask

    def batch(self, ids: np.ndarray):
        ids = np.asarray(ids, dtype=np.int64)
        return self._cx[ids], self._cy[ids], self._cmask[ids]


class _Staged:
    """One uploaded wave: its cohort offset, its three device tensors
    and, on the card, the event its side-stream copy recorded."""

    __slots__ = ("lo", "tensors", "event")

    def __init__(self, lo: int, tensors: tuple, event):
        self.lo = lo
        self.tensors = tensors
        self.event = event


class WaveStream:
    """Iterator of one round's waves on ``device``.

    ``for wave_base, (cx, cy, cmask) in WaveStream(...)`` yields each
    wave's client tensors in cohort order; ``wave_base`` is the wave's
    offset into the round's cohort. At depth ≥ 1 a daemon thread runs
    ``registry.batch`` and the upload up to ``depth`` waves ahead; depth
    0 uploads in the consumer loop. Each wave's fetch and upload run
    under the shared retry policy (``utils/retry``); a persistent
    failure, or the uploader dying, reaches the consumer promptly as a
    typed ``StreamError``, and ``close()`` never hangs.

    ``on_wave_error``: ``"raise"`` (a failed wave raises), ``"drop"``
    (it is yielded as a ``DroppedWave``, and so is a wave that hangs past
    ``wave_deadline_s``) or ``"buffer"`` (a failed wave drops, a
    deadline-missed one is yielded as a ``LateWave`` and its upload
    finishes in the background for ``poll_late``; buffer mode always
    runs the uploader thread). ``fault_plan``/``round_idx``: the plan
    consulted at round ``round_idx``'s seams (module docstring)."""

    _DONE = object()

    def __init__(
        self,
        registry,
        device,
        cohort_ids: np.ndarray,
        wave_size: int,
        depth: int | None = None,
        fault_plan=None,
        round_idx: int = 0,
        on_wave_error: str = "raise",
        wave_deadline_s: float | None = None,
    ):
        cohort_ids = np.asarray(cohort_ids)
        if wave_size < 1 or len(cohort_ids) % wave_size != 0:
            raise ValueError(
                f"cohort of {len(cohort_ids)} not divisible by "
                f"wave_size={wave_size}"
            )
        self._registry = registry
        self._device = torch.device(device)
        self._ids = cohort_ids
        self._wave_size = int(wave_size)
        self.num_waves = len(cohort_ids) // int(wave_size)
        self._plan = fault_plan
        self._round_idx = int(round_idx)
        if on_wave_error not in ("raise", "drop", "buffer"):
            raise ValueError(
                f"on_wave_error={on_wave_error!r}: expected 'raise', "
                "'drop' or 'buffer'"
            )
        self._on_wave_error = on_wave_error
        self._wave_deadline_s = (
            None if wave_deadline_s is None else float(wave_deadline_s)
        )
        if self._wave_deadline_s is not None and self._wave_deadline_s <= 0:
            raise ValueError("wave_deadline_s must be > 0 (None disables)")
        self._abandoned: set[int] = set()
        # Buffer mode: completed uploads of abandoned waves wait in
        # _late_items for poll_late; waves that will never complete land
        # in _late_failed; _late_done records waves already handed over.
        self._late_items: dict[int, _Staged] = {}
        self._late_failed: set[int] = set()
        self._late_done: set[int] = set()
        # Planned straggle (client.slow / wave.delay): seconds the
        # uploader sleeps before fetching each wave.
        self._delays = None
        if fault_plan is not None:
            d = fault_plan.wave_delays(int(round_idx), cohort_ids,
                                       int(wave_size))
            if np.any(d > 0):
                self._delays = d
        self._cuda = self._device.type == "cuda"
        self._side = torch.cuda.Stream(self._device) if self._cuda else None
        self.depth = resolve_stream_depth(depth)
        self._next_wave = 0
        self._closed = False
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        if (self.depth > 0 and self.num_waves > 1) or (
            self._on_wave_error == "buffer"
        ):
            self._queue = queue.Queue(maxsize=max(self.depth, 1))
            self._thread = threading.Thread(
                target=self._uploader, name="qfedx-ingest", daemon=True
            )
            self._thread.start()

    def _to_device(self, arrays) -> tuple:
        """Host arrays → device tensors. On the card: pinned host copies,
        then non-blocking copies on the side stream, and an event."""
        host = [torch.from_numpy(a) for a in arrays]
        if not self._cuda:
            return tuple(h.clone() for h in host), None
        with torch.cuda.stream(self._side):
            out = tuple(h.pin_memory().to(self._device, non_blocking=True)
                        for h in host)
            event = torch.cuda.Event()
            event.record(self._side)
        return out, event

    def _upload(self, wave: int) -> _Staged:
        """Fetch and upload one wave under the shared retry policy; a
        persistent failure raises a typed ``StreamError``."""
        lo = wave * self._wave_size
        ids = self._ids[lo:lo + self._wave_size]
        plan = self._plan
        # A straggler is slow, not flaky: one sleep per wave, before the
        # retries, so they do not compound it.
        if self._delays is not None and float(self._delays[wave]) > 0:
            time.sleep(float(self._delays[wave]))

        def attempt(k: int):
            if plan is not None:
                plan.check("registry.fetch", self._round_idx, wave,
                           attempt=k)
            cx, cy, cmask = self._registry.batch(ids)
            if plan is not None:
                pois = plan.poison(self._round_idx, ids)
                if not np.all(pois == 1.0):
                    with np.errstate(invalid="ignore"):  # 0·inf is NaN
                        cx = np.asarray(cx) * pois.reshape(
                            (len(ids),) + (1,) * (np.ndim(cx) - 1))
                # label_flip trains on y → 1 − y, so the attack flows
                # through real local gradients.
                flips = plan.label_flips(self._round_idx, ids)
                if flips.any():
                    cy = np.where(
                        flips.reshape((len(ids),) + (1,) * (np.ndim(cy) - 1)),
                        1 - np.asarray(cy), cy)
                plan.check("ingest.h2d", self._round_idx, wave, attempt=k)
            return self._to_device((
                np.ascontiguousarray(cx), np.ascontiguousarray(cy),
                np.asarray(cmask, dtype=np.float32)))

        try:
            tensors, event = retry_with_deadline(
                attempt, attempts=3, base_delay_s=0.05, max_delay_s=0.5,
                deadline_s=30.0, describe=f"wave {wave} upload",
                jitter_site=f"ingest/{self._round_idx}/{wave}",
            )
        except RetryExhausted as exc:
            raise StreamError(
                f"wave {wave} upload failed: {exc}", wave=wave,
                original=exc.last,
            ) from exc.last
        return _Staged(lo, tensors, event)

    def _deliver(self, staged: _Staged) -> tuple:
        """The consumer's side of an upload: its stream waits for the
        copy, and every tensor is marked as used on that stream."""
        if staged.event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(staged.event)
            for t in staged.tensors:
                t.record_stream(current)
        return staged.lo, staged.tensors

    def _put(self, item) -> bool:
        """Queue an item without deadlocking against ``close()``: block
        only while the stream is open; once closed, drop the item."""
        while not self._closed:
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _uploader(self) -> None:
        wave = 0
        try:
            deferred: list[int] = []
            for wave in range(self.num_waves):
                if self._closed:
                    break
                if (
                    self._on_wave_error == "buffer"
                    and self._wave_deadline_s is not None
                    and self._delays is not None
                    and float(self._delays[wave]) > self._wave_deadline_s
                ):
                    # A planned straggler past the deadline is declared
                    # late at once and uploaded after every prompt wave,
                    # so it never holds the in-order uploader up.
                    if not self._put(LateWave(wave, wave * self._wave_size)):
                        return
                    deferred.append(wave)
                    continue
                try:
                    item = self._upload(wave)
                except StreamError as exc:
                    if self._on_wave_error not in ("drop", "buffer"):
                        raise
                    # Counted at delivery: the consumer may already have
                    # deadline-dropped this wave.
                    item = DroppedWave(
                        wave, wave * self._wave_size, error=exc
                    )
                if not self._put(item):
                    return
            for wave in deferred:
                if self._closed:
                    break
                # The declared stragglers' sleeps and uploads run here;
                # poll_late collects them.
                try:
                    item = self._upload(wave)
                except StreamError as exc:
                    item = DroppedWave(wave, wave * self._wave_size,
                                       error=exc)
                if not self._put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised by consumer
            if not isinstance(exc, StreamError):
                exc = StreamError(
                    f"wave {wave} upload failed: {exc!r}", wave=wave,
                    original=exc,
                )
            self._put(exc)
        else:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_wave >= self.num_waves or self._closed:
            raise StopIteration
        if self._queue is None:
            # Synchronous path: only the retry deadline bounds a hang;
            # "drop" still converts an exhausted retry into a marker.
            try:
                item = self._upload(self._next_wave)
            except StreamError as exc:
                if self._on_wave_error != "drop":
                    raise
                item = DroppedWave(
                    self._next_wave,
                    self._next_wave * self._wave_size,
                    error=exc,
                )
        else:
            # Bounded get + liveness check: a dead uploader must not
            # strand the consumer; wave_deadline_s bounds the wait for
            # THIS wave.
            t0 = time.monotonic()
            while True:
                try:
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    if self._thread is not None and not self._thread.is_alive():
                        try:  # a final racing put may have landed
                            item = self._queue.get_nowait()
                        except queue.Empty:
                            self._closed = True
                            raise StreamError(
                                "uploader thread died without delivering "
                                f"wave {self._next_wave}",
                                wave=self._next_wave,
                            ) from None
                    elif (
                        self._wave_deadline_s is not None
                        and time.monotonic() - t0 > self._wave_deadline_s
                    ):
                        wave = self._next_wave
                        if self._on_wave_error == "buffer":
                            # Abandon waiting, not the wave: poll_late
                            # collects the finished upload.
                            self._abandoned.add(wave)
                            item = LateWave(wave, wave * self._wave_size)
                        elif self._on_wave_error == "drop":
                            # Discard the late delivery later, so the
                            # wave is never both dropped and computed.
                            self._abandoned.add(wave)
                            item = DroppedWave(
                                wave, wave * self._wave_size,
                                error=StreamError(
                                    f"wave {wave} missed the "
                                    f"{self._wave_deadline_s}s deadline",
                                    wave=wave,
                                ),
                            )
                        else:
                            self._closed = True
                            raise StreamError(
                                f"wave {wave} missed the "
                                f"{self._wave_deadline_s}s deadline",
                                wave=wave,
                            ) from None
                    else:
                        continue
                # Stale deliveries of waves the deadline already
                # declared late or dead: "buffer" banks them for
                # poll_late, "drop" discards them.
                if isinstance(item, LateWave):
                    if item.wave < self._next_wave:
                        # The consumer's deadline already declared it:
                        # yielding it again would shift later slots.
                        continue
                    # Declared by the uploader (planned delay past the
                    # deadline): its deferred upload goes to poll_late.
                    self._abandoned.add(item.wave)
                elif isinstance(item, DroppedWave):
                    if item.wave in self._abandoned and (
                        item.wave < self._next_wave
                    ):
                        if self._on_wave_error == "buffer":
                            self._late_failed.add(item.wave)
                        continue
                elif isinstance(item, _Staged):
                    if item.lo // self._wave_size in self._abandoned:
                        if self._on_wave_error == "buffer":
                            self._late_items[
                                item.lo // self._wave_size] = item
                        continue
                break
            if item is self._DONE:
                raise StopIteration
            if isinstance(item, BaseException):
                self._closed = True
                raise item
        self._next_wave += 1
        if isinstance(item, _Staged):
            return self._deliver(item)
        return item

    # -- straggler salvage (buffer mode) --------------------------------------

    def _late_outstanding_set(self) -> set[int]:
        """Abandoned waves whose fate is still unknown."""
        return (
            self._abandoned
            - set(self._late_items)
            - self._late_failed
            - self._late_done
        )

    def late_pending(self) -> bool:
        """Anything for ``poll_late`` to return, now or later? False
        means the stream is resolved and safe to close."""
        return bool(
            self._late_items
            or self._late_failed
            or self._late_outstanding_set()
        )

    def poll_late(self, timeout_s: float = 0.0):
        """Collect straggler waves the deadline abandoned (buffer mode).

        Returns ``(items, failed)``: the completed uploads as
        ``(wave_base, (cx, cy, cmask))`` in cohort order, and the wave
        indices that will never complete. Waits up to ``timeout_s`` for
        outstanding waves; each wave is returned exactly once."""
        if self._on_wave_error != "buffer":
            raise RuntimeError(
                "poll_late requires on_wave_error='buffer'"
            )
        deadline = time.monotonic() + float(timeout_s)
        while self._queue is not None and self._late_outstanding_set():
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if (
                    self._thread is not None
                    and not self._thread.is_alive()
                ):
                    try:  # a final racing put may have landed
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        # Nothing else is coming: the rest are dead.
                        self._late_failed.update(
                            self._late_outstanding_set()
                        )
                        break
                elif time.monotonic() >= deadline:
                    break
                else:
                    continue
            if item is self._DONE:
                continue
            if isinstance(item, BaseException):
                # The uploader died: every outstanding straggler with it.
                self._late_failed.update(self._late_outstanding_set())
                continue
            if isinstance(item, LateWave):
                # A declaration the consumer's own deadline already
                # covered: its data comes on the deferred pass.
                self._abandoned.add(item.wave)
                continue
            if isinstance(item, DroppedWave):
                if item.wave in self._abandoned:
                    self._late_failed.add(item.wave)
                continue
            wave = item.lo // self._wave_size
            if wave in self._abandoned and wave not in self._late_done:
                self._late_items[wave] = item
        items = [
            self._deliver(self._late_items.pop(w))
            for w in sorted(self._late_items)
        ]
        failed = sorted(self._late_failed)
        self._late_done.update(lo // self._wave_size for lo, _ in items)
        self._late_done.update(failed)
        self._late_failed.clear()
        return items, failed

    def abandon_late(self) -> list[int]:
        """Give up on every unresolved straggler (over age, or shutdown):
        returns their wave indices and marks them done, so
        ``late_pending`` goes False."""
        waves = sorted(
            self._late_outstanding_set()
            | set(self._late_items)
            | self._late_failed
        )
        self._late_done.update(waves)
        self._late_items.clear()
        self._late_failed.clear()
        return waves

    def close(self) -> None:
        """Stop the uploader and release staged waves (safe on a consumed
        stream; the trainer calls it on every exit path)."""
        self._closed = True
        if self._queue is not None:

            def drain():
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass

            # Unblock a put-blocked uploader (its _put re-checks _closed
            # within its timeout), join, then drain what it staged
            # between the two steps.
            drain()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            drain()
