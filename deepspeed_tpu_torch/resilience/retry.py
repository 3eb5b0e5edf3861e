"""Bounded exponential backoff with deterministic jitter (a copy of
``deepspeed_tpu/resilience/retry.py``, which imports no jax).

The training engine wraps synchronous checkpoint saves in ``retry_call``
when ``resilience.enabled`` is set: the ``io_flaky`` fault site exists to
prove a transient write error is survived without tearing a checkpoint,
and a permanent one (``PermanentIOError``) still surfaces.

Jitter is *deterministic* — a crc32 hash of ``(seed, attempt)``, the same
construction the fault injector uses — so a retried run under fault
injection replays the exact same delays.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass
class RetryPolicy:
    """``resilience.retry`` config shape (runtime/config.py RetryConfig
    mirrors these fields; either is accepted by ``retry_call``)."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    jitter: float = 0.25  # +/- fraction of the capped exponential delay


def _as_policy(policy) -> RetryPolicy:
    if isinstance(policy, RetryPolicy):
        return policy
    return RetryPolicy(
        max_attempts=int(getattr(policy, "max_attempts", 3)),
        base_delay_s=float(getattr(policy, "base_delay_s", 0.5)),
        max_delay_s=float(getattr(policy, "max_delay_s", 8.0)),
        jitter=float(getattr(policy, "jitter", 0.25)),
    )


def backoff_delay(attempt: int, policy: RetryPolicy | object, seed: int = 0) -> float:
    """Delay before retrying after failed attempt ``attempt`` (1-based):
    ``min(max_delay, base * 2**(attempt-1))`` spread by +/- ``jitter`` with a
    deterministic per-(seed, attempt) draw."""
    p = _as_policy(policy)
    d = min(p.max_delay_s, p.base_delay_s * (2.0 ** (attempt - 1)))
    if p.jitter > 0.0:
        h = zlib.crc32(f"{seed}:retry:{attempt}".encode()) & 0xFFFFFFFF
        frac = h / float(0x100000000)  # [0, 1)
        d *= 1.0 + p.jitter * (2.0 * frac - 1.0)
    return max(0.0, d)


def retry_call(
    fn: Callable,
    policy: RetryPolicy | object = RetryPolicy(),
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    no_retry_on: Tuple[Type[BaseException], ...] = (),
    seed: int = 0,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` with up to ``max_attempts`` tries. Only ``retry_on``
    exceptions are retried, and ``no_retry_on`` carves *known-permanent*
    subclasses out of that set (the engine excludes the injector's typed
    ``PermanentIOError`` — its write clock advances across attempts, so a
    blanket retry would mask the 'permanent' site). The last failure
    propagates unchanged, so a real permanent fault (read-only filesystem)
    still surfaces after the budget — retries mask transience, never
    persistence. ``on_retry(attempt, exc, delay_s)`` fires before each
    backoff sleep (telemetry counters hook in here)."""
    p = _as_policy(policy)
    attempts = max(1, p.max_attempts)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if (no_retry_on and isinstance(e, no_retry_on)) or attempt >= attempts:
                raise
            delay = backoff_delay(attempt, p, seed=seed)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0.0:
                sleep(delay)
