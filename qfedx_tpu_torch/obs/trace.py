"""Process-local spans, counters, gauges and histograms — the tracing core.

Counterpart of ``qfedx_tpu/obs/trace.py``:

- ``span("phase")``: context manager timing a host-side phase. Spans
  nest (a thread-local stack tracks the parent), carry arbitrary
  ``**meta`` and accumulate the kernel build time that fires while they
  are open (``Span.compile_s``).
- ``counter(name, inc)`` / ``gauge(name, value)`` / ``histogram(name,
  value)``: process totals, last-value samples and bounded value
  distributions (obs/histo.py).
- ``trace_context(**meta)``: metadata every span opened inside it on
  this thread carries (the batcher stamps the request ids of a flush).

What eager PyTorch changes. In the reference a span inside a jitted
function times the TRACE of that region and fires once per compile;
here the code runs at every call, so ``fed.trace.*``, ``engine.trace``
and the ``fuse.*`` counters fire on every round, step and served batch.
The names are kept; their totals count calls, not compiles.

Compile attribution. The reference listens to ``jax.monitoring``'s
compile events. The port compiles one thing: the scan-body kernel
library (``ops/scan_body.load_kernel``, nvcc and the load), which calls
``attribute_compile`` with the seconds it took — added to the innermost
open span's ``compile_s`` and the ``compile.kernel_build_s`` counter,
or to ``compile.unattributed_s`` when no span is open.

Cost model: spans gate on the ``QFEDX_TRACE`` pin (default off), read
per call, so the disabled path is one env read and one branch and
returns one shared null span. The bounded instruments also record while
a live /metrics endpoint, the watchdog or the tune controller is up
(``metrics_enabled``).
``QFEDX_TRACE_XLA=1`` (the reference's pin name) additionally opens a
``torch.profiler.record_function`` range per span, so a profile
attributes device time to the span (obs/profile.py).

No span synchronizes the device: a host span around an asynchronous
launch times the launch, not the kernel; device time comes only from a
profile.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from qfedx_tpu_torch.obs import flight
from qfedx_tpu_torch.obs.histo import Histogram
from qfedx_tpu_torch.utils import pins


def enabled() -> bool:
    """Is tracing on? QFEDX_TRACE pin: '1'/'on' or '0'/'off', default
    off; read per call, a typo raises."""
    return pins.bool_pin("QFEDX_TRACE", False)


# While a /metrics endpoint runs, the BOUNDED instruments record even
# with QFEDX_TRACE off; spans (unbounded) stay gated on the pin alone.
_live_metrics = False


def set_live_metrics(on: bool) -> None:
    """Flipped by obs.server start/stop — not a user API."""
    global _live_metrics
    _live_metrics = bool(on)


def metrics_enabled() -> bool:
    """Should counters/gauges/histograms record? True when QFEDX_TRACE
    is on, a live /metrics endpoint is serving, the watchdog is enabled
    or the tune controller is (a watchdog or a controller over an empty
    registry would be blind)."""
    if _live_metrics or enabled():
        return True
    from qfedx_tpu_torch.obs import watch

    if watch.enabled():
        return True
    from qfedx_tpu_torch.tune import controller as _tune

    return _tune.enabled()


def xla_annotations_enabled() -> bool:
    """QFEDX_TRACE_XLA: mirror each span as a
    ``torch.profiler.record_function`` range, so profiles carry the
    phase names. Off by default (a range costs a dispatcher call)."""
    return pins.bool_pin("QFEDX_TRACE_XLA", False)


class Span:
    """One finished (or open) phase interval. Times are
    ``time.perf_counter()`` seconds; exporters rebase onto the registry
    origin."""

    __slots__ = (
        "name", "t0", "t1", "depth", "parent", "tid", "tname", "meta",
        "compile_s",
    )

    def __init__(self, name: str, meta: dict | None = None):
        self.name = name
        self.t0 = 0.0
        self.t1 = 0.0
        self.depth = 0
        self.parent: "Span | None" = None
        self.tid = 0
        # The originating thread's name: the Chrome trace names its
        # tracks from it (the checkpoint writer, the uploader).
        self.tname = ""
        self.meta = meta or {}
        self.compile_s = 0.0

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def set(self, **meta: Any) -> None:
        self.meta.update(meta)

    def __repr__(self) -> str:  # debugging aid only
        return f"Span({self.name!r}, {self.duration * 1e3:.2f}ms, depth={self.depth})"


class _NullSpan:
    """Returned by ``span()`` when tracing is off: same surface, no
    state, one shared instance."""

    __slots__ = ()
    name = ""
    duration = 0.0
    compile_s = 0.0
    meta: dict = {}

    def set(self, **meta: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Registry:
    """Process-local store of finished spans, counters, gauges and
    histograms. Every mutation happens under ONE lock: the uploader, the
    batcher's dispatcher, the watchdog and the server bump the same
    counters concurrently."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        # Value histograms (serve.latency_ms) and per-span-name duration
        # histograms in SECONDS, recorded as spans close.
        self.histos: dict[str, Histogram] = {}
        self.span_histos: dict[str, Histogram] = {}
        self.span_compile: dict[str, float] = {}
        # Per-span-name device attribution from a parsed profile
        # (obs/profile.attach_span_device).
        self.span_device: dict[str, tuple[float, float]] = {}
        self.origin = time.perf_counter()
        # Wall-clock instant of ``origin``: the anchor trace shards carry.
        self.origin_unix = time.time()
        self._local = threading.local()
        self._lock = threading.Lock()

    def stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def context(self) -> list[dict]:
        ctx = getattr(self._local, "ctx", None)
        if ctx is None:
            ctx = self._local.ctx = []
        return ctx

    def add_span(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)
            h = self.span_histos.get(sp.name)
            if h is None:
                h = self.span_histos[sp.name] = Histogram()
            h.record(sp.duration)
            if sp.compile_s > 0:
                self.span_compile[sp.name] = (
                    self.span_compile.get(sp.name, 0.0) + sp.compile_s
                )

    def add_counter(self, name: str, inc: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + inc

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def record_histogram(self, name: str, value: float) -> None:
        with self._lock:
            h = self.histos.get(name)
            if h is None:
                h = self.histos[name] = Histogram()
        # Histogram.record takes its own lock.
        h.record(value)

    def instruments(self) -> tuple[dict, dict, dict, dict]:
        """Consistent shallow copies of (counters, gauges, histos,
        span_histos) for renderers."""
        with self._lock:
            return (
                dict(self.counters),
                dict(self.gauges),
                dict(self.histos),
                dict(self.span_histos),
            )

    def span_rollup_source(self) -> tuple[dict, dict]:
        """Consistent shallow copies of (span_histos, span_compile)."""
        with self._lock:
            return dict(self.span_histos), dict(self.span_compile)

    def set_span_device(
        self, name: str, busy_s: float, utilization: float
    ) -> None:
        with self._lock:
            self.span_device[name] = (float(busy_s), float(utilization))

    def span_device_view(self) -> dict[str, tuple[float, float]]:
        with self._lock:
            return dict(self.span_device)


_REGISTRY = _Registry()


def registry() -> _Registry:
    return _REGISTRY


def reset() -> None:
    """Drop all recorded spans/counters/gauges and rebase the time
    origin."""
    global _REGISTRY
    _REGISTRY = _Registry()


def attribute_compile(kind: str, duration: float) -> None:
    """Attribute ``duration`` seconds of a build (``kind``:
    ``kernel_build``) to the innermost open span of this thread and to
    the ``compile.<kind>_s`` counter, or to ``compile.unattributed_s``
    when no span is open. No-op when tracing is off."""
    if not enabled():
        return
    reg = _REGISTRY
    reg.add_counter(f"compile.{kind}_s", duration)
    stack = reg.stack()
    if stack:
        stack[-1].compile_s += duration
    else:
        reg.add_counter("compile.unattributed_s", duration)


# --- public API ---------------------------------------------------------------


class span:
    """``with obs.span("round.dispatch", round=3) as sp:`` — times the
    block and records it in the process registry. No-op (shared null
    span) when QFEDX_TRACE is off."""

    __slots__ = ("_name", "_meta", "_sp", "_annot")

    def __init__(self, name: str, **meta: Any):
        self._name = name
        self._meta = meta
        self._sp: Span | None = None
        self._annot = None

    def __enter__(self):
        if not enabled():
            return _NULL_SPAN
        reg = _REGISTRY
        meta = dict(self._meta)
        # Merge the thread's open trace contexts (innermost wins, below
        # explicit span meta).
        ctx = reg.context()
        if ctx:
            merged: dict = {}
            for d in ctx:
                merged.update(d)
            merged.update(meta)
            meta = merged
        sp = Span(self._name, meta)
        stack = reg.stack()
        sp.depth = len(stack)
        sp.parent = stack[-1] if stack else None
        sp.tid = threading.get_ident()
        sp.tname = threading.current_thread().name
        if xla_annotations_enabled():
            try:
                from torch.profiler import record_function

                self._annot = record_function(self._name)
                self._annot.__enter__()  # qfedx: ignore[QFX003] the paired exit is in span.__exit__ — the range brackets this span's own enter/exit by construction
            except Exception:  # noqa: BLE001 — the range is an optional bridge
                self._annot = None
        stack.append(sp)
        sp.t0 = time.perf_counter()
        self._sp = sp
        return sp

    def __exit__(self, *exc):
        sp = self._sp
        if sp is None:
            return False
        sp.t1 = time.perf_counter()
        reg = _REGISTRY
        stack = reg.stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # unbalanced exit (exception skipped children)
            del stack[stack.index(sp):]
        if self._annot is not None:
            try:
                self._annot.__exit__(*exc)
            except Exception:  # noqa: BLE001
                pass
        reg.add_span(sp)
        flight.on_span(sp.name, sp.duration)
        return False


class trace_context:
    """``with obs.trace_context(reqs="3,4,5"):`` — attach metadata to
    every span opened on this thread inside the block. Explicit span
    meta wins on a key collision; contexts nest (the innermost wins).
    No-op when tracing is off."""

    __slots__ = ("_meta", "_pushed")

    def __init__(self, **meta: Any):
        self._meta = meta
        self._pushed = False

    def __enter__(self):
        if enabled():
            _REGISTRY.context().append(self._meta)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            ctx = _REGISTRY.context()
            if ctx and ctx[-1] is self._meta:
                ctx.pop()
            elif self._meta in ctx:
                ctx.remove(self._meta)
        return False


def counter(name: str, inc: float = 1.0) -> None:
    """Accumulate a process-total counter (no-op unless
    ``metrics_enabled``); mirrored into the flight ring when
    QFEDX_FLIGHT is on."""
    if metrics_enabled():
        _REGISTRY.add_counter(name, float(inc))
    flight.on_counter(name, inc)


def gauge(name: str, value: float) -> None:
    """Record the latest value of a quantity (no-op unless
    ``metrics_enabled``); mirrored into the flight ring."""
    if metrics_enabled():
        _REGISTRY.set_gauge(name, float(value))
    flight.on_gauge(name, value)


def histogram(name: str, value: float) -> None:
    """Record one observation into the named bounded histogram (no-op
    unless ``metrics_enabled``); mirrored into the flight ring."""
    if metrics_enabled():
        _REGISTRY.record_histogram(name, float(value))
    flight.on_histogram(name, value)


_BYTES_LIMIT: dict[int, int] = {}


def record_device_memory(prefix: str = "mem") -> dict | None:
    """Sample the current CUDA device's allocator into the gauges
    ``{prefix}.bytes_in_use`` (``allocated_bytes.all.current``),
    ``{prefix}.peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
    ``{prefix}.bytes_limit`` (the device's total memory from
    ``torch.cuda.mem_get_info``, read once per device). Returns the dict,
    or None when tracing is off or there is no card (the reference's CPU
    has no memory stats either). Reads host-side allocator bookkeeping:
    nothing synchronizes the device."""
    if not enabled():
        return None
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        dev = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(dev)
        if dev not in _BYTES_LIMIT:
            _BYTES_LIMIT[dev] = int(torch.cuda.mem_get_info(dev)[1])
    except Exception:  # noqa: BLE001 — stats are best-effort by contract
        return None
    out = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": _BYTES_LIMIT[dev],
    }
    for key, val in out.items():
        _REGISTRY.set_gauge(f"{prefix}.{key}", float(val))
    return out
