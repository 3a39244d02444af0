"""The request micro-batcher: latency-budgeted batching + load shedding.

Counterpart of ``qfedx_tpu/serve/batcher.py`` (``MicroBatcher``,
``Future``, ``Overloaded``, ``RequestError``, ``ShuttingDown``):

- **Two flush triggers.** A batch dispatches when the queue can fill the
  LARGEST bucket (bucket-full flush) or when the OLDEST queued request
  has waited ``deadline_ms`` (deadline flush, clock started at submit).
  Bucket-full wins when both hold.
- **Bounded admission.** Past ``max_queue`` pending requests ``submit``
  raises ``Overloaded`` (shed, counted) instead of growing the tail.
- **Per-request rejection.** A malformed or non-finite request fails
  ITS OWN submit with ``RequestError`` before a batch is formed.
- **Graceful drain.** ``close(drain=True)`` stops admission and answers
  every queued request; ``close(drain=False)`` fails them with
  ``ShuttingDown``.

The ``serve.request`` fault site (``utils/faults``: the engine's
``fault_plan`` or the plan ``QFEDX_FAULTS`` pins) mutates request #seq
before validation — ``nan`` features, or ``malformed``: each dimension
+ 1 — so the planned request is rejected on its own and never joins a
batch.

Telemetry (``obs``, the reference's names): ``start`` brings up the
/metrics endpoint and the watchdog, registers the ``serve`` health
source (cleared on ``close``) and records flight lifecycle edges; the
counters ``serve.requests_rejected`` and ``serve.requests_shed``, the
gauge ``serve.queue_depth``, a ``serve.queue`` span per flush (its size,
trigger and, when tracing, the request ids), a ``trace_context(reqs=)``
around the engine call so its spans carry those ids, and the
``serve.latency_ms`` histogram (submit → answer). When the engine has a
tune controller (``QFEDX_TUNE``), each flush reads the active deadline
and bucket cap from it, one attribute read each; without one the
batcher reads its static config.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np

from qfedx_tpu_torch import obs
from qfedx_tpu_torch.obs import flight, watch
from qfedx_tpu_torch.obs import server as obs_server
from qfedx_tpu_torch.utils import faults


class RequestError(ValueError):
    """Client error — malformed shape or non-finite features (4xx)."""


class Overloaded(RuntimeError):
    """The bounded admission queue is full; this request was shed (503)."""


class ShuttingDown(RuntimeError):
    """The batcher is closed (or closing without drain)."""


class Future:
    """Single-assignment result slot for one request; ``submit_t`` /
    ``done_t`` bracket its queue+batch+compute+fetch latency on the
    batcher's one clock."""

    __slots__ = (
        "_event", "_value", "_error", "_clock", "submit_t", "done_t", "seq",
    )

    def __init__(self, seq: int, clock):
        self._event = threading.Event()
        self._value: Any = None
        self._error: BaseException | None = None
        self._clock = clock
        self.submit_t = clock()
        self.done_t: float | None = None
        self.seq = seq

    def _set(self, value: Any = None, error: BaseException | None = None):
        self._value, self._error = value, error
        self.done_t = self._clock()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.seq} unresolved after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._value


class MicroBatcher:
    """Admission queue + dispatcher thread in front of a ServeEngine.
    The ``serve.request`` site reads the engine's ``fault_plan`` (None:
    the one ``QFEDX_FAULTS`` pins)."""

    def __init__(self, engine, clock=time.monotonic):
        self.engine = engine
        self.config = engine.config
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: deque[tuple[float, np.ndarray, Future]] = deque()
        self._closed = False
        self._drain = True
        self._thread: threading.Thread | None = None
        self._seq = 0
        self._batch_seq = 0
        self.stats = {
            "served": 0, "rejected": 0, "shed": 0, "batches": 0,
            "deadline_flushes": 0, "full_flushes": 0,
        }
        self._health_fn = None  # registered by start(); identity-matched on close

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        obs_server.maybe_start()
        watch.maybe_start()
        flight.record("lifecycle", "batcher.start",
                      max_queue=self.config.max_queue)
        # One stable callable: close()'s only_if match is by identity.
        self._health_fn = self._health
        obs_server.set_health_source("serve", self._health_fn)
        self._thread = threading.Thread(
            target=self._loop, name="qfedx-serve-batcher", daemon=True
        )
        self._thread.start()
        return self

    def _health(self) -> dict:
        with self._cond:
            return {
                "queue_depth": len(self._pending),
                # The ceiling, so the watchdog's serve.queue_sat rule can
                # read queue_depth as a saturation fraction.
                "max_queue": self.config.max_queue,
                "closed": self._closed,
                "engine_warm": bool(getattr(self.engine, "_warm", False)),
                "buckets": list(self.config.buckets),
                **dict(self.stats),
            }

    def close(self, drain: bool = True, timeout: float | None = None):
        """Stop admission; drain (answer) or fail the queued requests;
        join the dispatcher."""
        with self._cond:
            self._closed = True
            self._drain = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("dispatcher did not drain in time")
            self._thread = None
        # Unregister after the drain, and only a registration of ours.
        if self._health_fn is not None:
            obs_server.clear_health_source("serve", only_if=self._health_fn)
        flight.record("lifecycle", "batcher.close", drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close(drain=True)

    # -- admission -----------------------------------------------------------

    def _validate(self, features) -> np.ndarray:
        want = self.engine.feature_shape
        try:
            x = np.asarray(features, dtype=np.float32)
        except (TypeError, ValueError) as exc:
            raise RequestError(f"features not numeric: {exc}") from None
        if x.shape != want:
            raise RequestError(
                f"features shape {x.shape} != model feature shape {want}"
            )
        if not np.all(np.isfinite(x)):
            raise RequestError("features contain NaN/Inf")
        return x

    def submit(self, features) -> Future:
        """Admit one request; returns its Future. Raises RequestError
        (bad request), Overloaded (shed) or ShuttingDown."""
        with self._cond:
            seq = self._seq
            self._seq += 1
        plan = faults.resolve_plan(self.engine.fault_plan)
        if plan is not None:
            kind = plan.request_mutation(seq)
            if kind == "nan":
                features = np.full(self.engine.feature_shape, np.nan,
                                   dtype=np.float32)
            elif kind == "malformed":
                features = np.zeros(
                    tuple(s + 1 for s in self.engine.feature_shape),
                    dtype=np.float32)
        try:
            x = self._validate(features)
        except RequestError:
            with self._cond:
                self.stats["rejected"] += 1
            obs.counter("serve.requests_rejected")
            raise
        with self._cond:
            if self._closed:
                raise ShuttingDown("batcher is closed")
            if len(self._pending) >= self.config.max_queue:
                self.stats["shed"] += 1
                obs.counter("serve.requests_shed")
                raise Overloaded(
                    f"queue depth {len(self._pending)} at max_queue="
                    f"{self.config.max_queue}"
                )
            fut = Future(seq, self._clock)
            self._pending.append((fut.submit_t, x, fut))
            obs.gauge("serve.queue_depth", len(self._pending))
            self._cond.notify_all()
        return fut

    # -- dispatcher ----------------------------------------------------------

    def _pop_locked(self, cap: int) -> list:
        return [self._pending.popleft()
                for _ in range(min(cap, len(self._pending)))]

    def _take_locked(self) -> tuple[list, str] | None:
        """Under the lock: wait for a flush trigger; pop up to one
        max-bucket of requests. None = closed and empty."""
        # The adaptation seam: with a tune controller attached, the
        # ACTIVE deadline and cap come from it, read once per flush, so a
        # decision takes effect on the next batch (the cap only names a
        # warmed bucket). tuner=None reads the static config.
        tuner = getattr(self.engine, "tuner", None)
        if tuner is not None:
            deadline_s = tuner.deadline_ms / 1e3
            cap = tuner.max_bucket
        else:
            deadline_s = self.config.deadline_ms / 1e3
            cap = self.engine.max_bucket
        while True:
            if self._pending and (self._closed or len(self._pending) >= cap):
                # Bucket-full flush (or the drain's final sweeps).
                kind = "full" if len(self._pending) >= cap else "drain"
                return self._pop_locked(cap), kind
            if self._pending:
                wait = self._pending[0][0] + deadline_s - self._clock()
                if wait <= 0:
                    return self._pop_locked(cap), "deadline"
                self._cond.wait(timeout=min(wait, 0.05))
            elif self._closed:
                return None
            else:
                self._cond.wait(timeout=0.05)

    def _loop(self):
        while True:
            with self._cond:
                # The idle wait stays outside any span: an idle traced
                # server must not record a span per poll tick.
                while not self._pending and not self._closed:
                    self._cond.wait(timeout=0.05)
                if not self._pending and self._closed:
                    return
            trace_ids = None
            with obs.span("serve.queue") as sp:
                with self._cond:
                    taken = self._take_locked()
                if taken is not None:
                    meta = {"size": len(taken[0]), "flush": taken[1]}
                    if obs.enabled():
                        # The ids this flush serves, the string the
                        # engine's spans carry through trace_context.
                        trace_ids = ",".join(
                            str(f.seq) for _t, _x, f in taken[0])
                        meta["reqs"] = trace_ids
                    sp.set(**meta)
            if taken is None:
                return
            reqs, kind = taken
            with self._cond:
                if kind == "deadline":
                    self.stats["deadline_flushes"] += 1
                elif kind == "full":
                    self.stats["full_flushes"] += 1
                self._batch_seq += 1
                batch_seq = self._batch_seq
                drain_mode = self._closed and not self._drain
            if drain_mode:
                err = ShuttingDown("batcher closed without drain")
                for _, _, fut in reqs:
                    fut._set(error=err)
                continue
            x = np.stack([r[1] for r in reqs])
            try:
                if trace_ids is not None:
                    with obs.trace_context(reqs=trace_ids):
                        logits = self.engine.infer(x, seq=batch_seq)
                else:
                    logits = self.engine.infer(x, seq=batch_seq)
            except BaseException as exc:  # noqa: BLE001 — per-request surfacing
                for _, _, fut in reqs:
                    fut._set(error=exc)
                continue
            post = self.engine.postprocess(logits)
            for i, (_, _, fut) in enumerate(reqs):
                fut._set(value={
                    "logits": logits[i],
                    "probs": post["probs"][i],
                    "pred": int(post["pred"][i]),
                })
                obs.histogram(
                    "serve.latency_ms", (fut.done_t - fut.submit_t) * 1e3
                )
            with self._cond:
                self.stats["served"] += len(reqs)
                self.stats["batches"] += 1
