"""Exponential backoff with a deadline — the one retry policy.

Counterpart of ``qfedx_tpu/utils/retry.py`` (a copy). ``retry_with_deadline(fn)``
calls ``fn(attempt)`` up to ``attempts`` times, sleeping ``base_delay · 2^k``
(capped at ``max_delay``) between tries, never past ``deadline_s`` total.
Jitter is seeded, never random: with ``jitter_site`` each sleep is scaled
by a factor in [0.5, 1.0) hashed from (site, attempt), so schedules
de-correlate across call sites yet stay reproducible. On exhaustion a
typed ``RetryExhausted`` raises, chaining the last error.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Iterable


def jitter_factor(site: str, attempt: int) -> float:
    """Deterministic backoff jitter in [0.5, 1.0): a pure hash of
    (site, attempt) — blake2b, so PYTHONHASHSEED cannot change it."""
    digest = hashlib.blake2b(
        f"{site}#{attempt}".encode(), digest_size=8
    ).digest()
    return 0.5 + 0.5 * (int.from_bytes(digest, "little") / 2.0**64)


class RetryExhausted(RuntimeError):
    """All attempts failed (or the deadline expired); ``.last`` is the
    final error, also chained as ``__cause__``."""

    def __init__(self, describe: str, attempts: int, elapsed_s: float,
                 last: BaseException):
        super().__init__(
            f"{describe} failed after {attempts} attempt(s) in "
            f"{elapsed_s:.2f}s: {type(last).__name__}: {last}"
        )
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last = last


def retry_with_deadline(
    fn: Callable[[int], Any],
    *,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 1.0,
    deadline_s: float = 30.0,
    retry_on: Iterable[type[BaseException]] = (Exception,),
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    jitter_site: str | None = None,
) -> Any:
    """Run ``fn(attempt)``, retrying failed attempts with exponential
    backoff until success, ``attempts`` tries, or ``deadline_s`` wall —
    whichever first. Non-``retry_on`` exceptions propagate immediately."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    retry_on = tuple(retry_on)
    t0 = time.monotonic()
    for k in range(attempts):
        try:
            return fn(k)
        except retry_on as exc:  # noqa: PERF203 — the loop IS the policy
            elapsed = time.monotonic() - t0
            if k == attempts - 1 or elapsed >= deadline_s:
                raise RetryExhausted(describe, k + 1, elapsed, exc) from exc
            delay = min(base_delay_s * (2.0 ** k), max_delay_s)
            if jitter_site is not None:
                delay *= jitter_factor(jitter_site, k)
            # Never sleep past the deadline.
            delay = min(delay, max(0.0, deadline_s - elapsed))
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
