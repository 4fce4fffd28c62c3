"""Retry with exponential backoff and deterministic jitter (PyTorch port
of ``robustness/retry.py``).

A transient failure (a flaky filesystem, a device error raised as
``RuntimeError``) is recovered by re-running the same call: a retried
round chunk re-launches the same kernels from the same carried state, so
a retry never reaches a different code path.  Every retry logs its error
text and is counted (:func:`retry_count`), so recovery is visible, never
silent.

Jitter is a pure function of the operation name and the attempt number
(crc32), not ``random.random()``: backoff schedules reproduce exactly
under the chaos harness, and concurrent member fits (Stacking's thread
pool) still decorrelate because their op names differ.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("spark_ensemble_tpu_torch")

_count_lock = threading.Lock()
_retries = []  # (op, error type, error text), in retry order


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: delay ``base_delay * 2**(attempt-1)``
    capped at ``max_delay``, plus up to ``jitter`` fraction of itself.

    ``max_retries`` counts re-attempts: 2 means up to 3 calls; 0 disables
    retry.  Only ``retry_on`` types are retried; anything else (a chaos
    preemption, ``KeyboardInterrupt``) propagates at once."""

    max_retries: int = 2
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.25
    retry_on: Tuple[Type[BaseException], ...] = (RuntimeError, OSError)

    def delay(self, op: str, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (1-based), deterministic
        in ``(op, attempt)``."""
        raw = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        h = zlib.crc32(f"{op}:{attempt}".encode()) & 0xFFFFFFFF
        return raw * (1.0 + self.jitter * (h / 2**32))


def retry_log() -> list:
    """Every retry this process made: ``(op, error type, error text)``."""
    with _count_lock:
        return list(_retries)


def retry_count() -> int:
    """How many retries this process made."""
    with _count_lock:
        return len(_retries)


def reset_retry_log() -> None:
    with _count_lock:
        _retries.clear()


def retry_call(fn: Callable, policy: Optional[RetryPolicy] = None,
               op: str = "", sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` under ``policy`` and return its result; re-raise once
    ``max_retries`` is spent."""
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on as e:
            attempt += 1
            if attempt > policy.max_retries:
                raise
            delay = policy.delay(op, attempt)
            with _count_lock:
                _retries.append((op, type(e).__name__, str(e)[:500]))
            logger.warning(
                "retrying %s after %s (attempt %d/%d, backoff %.3fs): %s",
                op or "operation", type(e).__name__, attempt,
                policy.max_retries, delay, e,
            )
            sleep(delay)
