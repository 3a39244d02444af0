"""Bounded log-bucketed histograms — the fixed-memory quantile instrument.

Counterpart of ``qfedx_tpu/obs/histo.py``, a copy that is equal bit for
bit (the port imports nothing of the JAX package): the same bucket grid
(``LO``, ``BUCKETS_PER_DECADE``, ``DECADES``, ``bucket_edge``), the same
nearest-rank lower-edge quantile rule (``_rank_percentile``), so a
quantile the port reports equals the reference's on the same values.

- **Fixed memory.** Values land in logarithmically spaced buckets —
  ``BUCKETS_PER_DECADE`` per power of ten from ``LO`` across
  ``DECADES`` decades (~2.3 KB of counts), plus an underflow and an
  overflow bucket. Recording is O(1).
- **Bounded quantile error.** ``percentile(q)`` applies the nearest-rank
  definition of ``obs.percentile`` (export.py) to the bucket counts and
  returns the LOWER edge of the bucket holding that rank: within one
  bucket-width of the exact quantile, and never above it.
- **Merge-able.** ``merge`` adds bucket counts, so per-thread or
  per-process histograms combine exactly.
- **Thread-safe.** ``record`` / ``percentile`` / ``merge`` take an
  internal lock.

Units are the caller's: the registry's span histograms record seconds,
``serve.latency_ms`` milliseconds.
"""

from __future__ import annotations

import math
import threading

# Bucket grid: 24 buckets per decade => bucket edges grow by 10^(1/24)
# (~10% per bucket), i.e. a quantile is reported with <= ~10% relative
# error. 12 decades from 1e-6 cover 1 µs..1e6 s in seconds or 1 ns..1e3 s
# in milliseconds — every latency this repo measures, with headroom.
LO = 1e-6
BUCKETS_PER_DECADE = 24
DECADES = 12
NUM_BUCKETS = BUCKETS_PER_DECADE * DECADES


def bucket_edge(i: int) -> float:
    """Upper edge of bucket ``i`` (lower edge of bucket ``i + 1``)."""
    return LO * 10.0 ** (i / BUCKETS_PER_DECADE)


class Histogram:
    """Fixed-memory log-bucketed value distribution.

    ``counts[0]`` is the underflow bucket (values < LO, lower edge 0);
    ``counts[1 + i]`` holds values in [edge(i), edge(i + 1)) for
    i < NUM_BUCKETS; ``counts[-1]`` is the overflow bucket (values >=
    edge(NUM_BUCKETS), lower edge = that edge).
    """

    __slots__ = (
        "_counts", "count", "sum", "_lock",
        "_base_counts", "_base_count", "_base_sum",
    )

    def __init__(self):
        self._counts = [0] * (NUM_BUCKETS + 2)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()
        # snapshot_delta baseline — allocated lazily on the first call so
        # histograms that never use windows stay at the stated ~2.3 KB.
        self._base_counts: list[int] | None = None
        self._base_count = 0
        self._base_sum = 0.0

    @staticmethod
    def _index(value: float) -> int:
        if not value >= LO:  # also catches NaN: land it in underflow
            return 0
        i = int(math.log10(value / LO) * BUCKETS_PER_DECADE)
        return min(i, NUM_BUCKETS) + 1

    @staticmethod
    def bucket_bounds(value: float) -> tuple[float, float]:
        """[lower, upper) edges of the bucket ``value`` lands in — the
        "one bucket-width" the quantile-error pin is stated against."""
        idx = Histogram._index(value)
        if idx == 0:
            return (0.0, LO)
        if idx == NUM_BUCKETS + 1:
            return (bucket_edge(NUM_BUCKETS), math.inf)
        return (bucket_edge(idx - 1), bucket_edge(idx))

    def record(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._counts[self._index(value)] += 1
            self.count += 1
            self.sum += value

    def percentile(self, q: float) -> float:
        """Nearest-rank quantile (the obs.percentile definition applied
        to bucket counts): lower edge of the bucket holding rank
        ``round(q * (count - 1))``. 0.0 when empty."""
        with self._lock:
            return self.percentile_unlocked(q)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s counts into this histogram (exact — bucket
        grids are module constants, so two histograms always align)."""
        with other._lock:
            counts = list(other._counts)
            cnt, s = other.count, other.sum
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += cnt
            self.sum += s
        return self

    def nonzero_buckets(self) -> list[tuple[float, int]]:
        """``[(upper_edge, cumulative_count), ...]`` over buckets with
        occupants — the Prometheus ``le`` rendering (obs/server.py).
        The overflow bucket is omitted; its mass shows in ``+Inf``
        (== ``count``)."""
        out: list[tuple[float, int]] = []
        with self._lock:
            cum = 0
            for idx in range(NUM_BUCKETS + 1):
                c = self._counts[idx]
                if c:
                    cum += c
                    out.append((bucket_edge(idx) if idx else LO, cum))
        return out

    def snapshot(self) -> dict:
        """Plain-data view for exporters (obs.snapshot)."""
        with self._lock:
            return {
                "count": self.count,
                "sum": round(self.sum, 9),
                "p50": self.percentile_unlocked(0.50),
                "p95": self.percentile_unlocked(0.95),
            }

    def snapshot_delta(self) -> dict:
        """Window view: counts/sum/quantiles over everything recorded
        SINCE the previous ``snapshot_delta`` call (or construction), then
        rebase the window. Same nearest-rank lower-edge quantile rule as
        ``percentile``, applied to the window's bucket counts only — a
        controller polling this sees "the last tick's p95", not the
        lifetime p95 a long-lived server's history would freeze.

        One consumer owns the window: two pollers calling this on the
        same instrument split the stream between them (each rebase
        consumes the delta). Concurrent ``record`` calls are safe — the
        whole read-and-rebase happens under the instrument lock.
        """
        with self._lock:
            if self._base_counts is None:
                delta = list(self._counts)
                count = self.count
                s = self.sum
            else:
                delta = [
                    c - b for c, b in zip(self._counts, self._base_counts)
                ]
                count = self.count - self._base_count
                s = self.sum - self._base_sum
            self._base_counts = list(self._counts)
            self._base_count = self.count
            self._base_sum = self.sum
            return {
                "count": count,
                "sum": round(s, 9),
                "p50": _rank_percentile(delta, count, 0.50),
                "p95": _rank_percentile(delta, count, 0.95),
            }

    # percentile() takes the lock; snapshot() already holds it. The lock
    # is not reentrant (plain Lock — cheaper on the record hot path), so
    # snapshot uses this unlocked twin.
    def percentile_unlocked(self, q: float) -> float:
        return _rank_percentile(self._counts, self.count, q)

    def __repr__(self) -> str:  # debugging aid only
        return f"Histogram(count={self.count}, sum={self.sum:.6g})"


def _rank_percentile(counts: list[int], count: int, q: float) -> float:
    """THE nearest-rank lower-edge rule over a bucket-count vector —
    shared by lifetime (``percentile``) and window (``snapshot_delta``)
    views so the two can never disagree on the definition."""
    if count <= 0:
        return 0.0
    rank = min(count - 1, max(0, int(round(q * (count - 1)))))
    seen = 0
    for idx, c in enumerate(counts):
        seen += c
        if seen > rank:
            if idx == 0:
                return 0.0
            return bucket_edge(idx - 1) if idx <= NUM_BUCKETS else (
                bucket_edge(NUM_BUCKETS)
            )
    return 0.0
