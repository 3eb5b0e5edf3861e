"""Metrics registry: counters, gauges, log-bucketed histograms (a copy of
``deepspeed_tpu/telemetry/registry.py``, which imports no jax).

The reference framework scatters its numbers across subsystems (MonitorMaster
events, CommsLogger dicts, EngineTimers); this registry is the single spine
they all land in. Design constraints, in order:

  * cheap enough to update per decode step — ``observe()`` is one ``math.log``
    plus two dict operations, no locks on the hot path. Updates are
    single-writer by design (each engine owns its registry); concurrent
    writers can drop increments (``+=`` is not atomic) but never corrupt
    structure — metric creation and ``snapshot()`` hold the lock;
  * quantiles without storing samples — histograms are log-bucketed
    (geometric buckets, base ``2**0.25`` ≈ 19% wide), so p50/p90/p99 come
    back with ≤ ~9% relative error at O(#buckets) memory;
  * one naming scheme — ``subsystem/name`` (e.g. ``serving/ttft_sec``,
    ``train/step_time_sec``, ``comm/all_reduce@data/bytes``), stable across
    exporters (docs/observability.md catalogs them).

``get_registry()`` returns the process-global default registry (the comms
logger routes into it); engines own a private registry per instance so
concurrent engines don't mix their serving metrics.
"""

from __future__ import annotations

import math
import threading

# Geometric bucket base. 2**0.25 keeps quantile estimates within ~9% of the
# exact value (half a bucket) while a 1e-6s..1e4s latency range still fits in
# ~133 buckets — and sparse storage means only touched buckets exist.
_BASE = 2.0**0.25
_LOG_BASE = math.log(_BASE)


class Counter:
    """Monotonic accumulator (events, bytes, tokens)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, memory in use)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed distribution with quantile estimates.

    Positive values land in geometric buckets ``[base^i, base^(i+1))``;
    zero/negative values are counted in a dedicated underflow bucket and
    estimate as the observed minimum. Exact count/sum/min/max are tracked
    alongside, and quantile estimates are clamped to [min, max] so the tails
    can never leave the observed range.
    """

    __slots__ = ("name", "buckets", "zeros", "count", "sum", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.buckets: dict[int, int] = {}
        self.zeros = 0  # v <= 0 observations
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # guards bucket-dict RESIZES only: updating an existing bucket's
        # count never resizes the dict, so the hot path stays lock-free
        # after the first observation lands in each bucket; readers take the
        # lock so a concurrent first-touch insert can't resize mid-iteration
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v > 0.0:
            idx = int(math.floor(math.log(v) / _LOG_BASE))
            if idx in self.buckets:
                self.buckets[idx] += 1  # value update: no resize, no lock
            else:
                with self._lock:
                    self.buckets[idx] = self.buckets.get(idx, 0) + 1
        else:
            self.zeros += 1

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) from the buckets."""
        if self.count == 0:
            return 0.0
        target = q * (self.count - 1) + 1  # 1-based rank, numpy-lower-ish
        seen = self.zeros
        if seen >= target:
            return self.min
        with self._lock:
            items = sorted(self.buckets.items())
        for idx, n in items:
            seen += n
            if seen >= target:
                # geometric midpoint of the bucket, clamped to observed range
                mid = _BASE ** (idx + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Create-on-first-use store of named metrics.

    A name is permanently one kind: asking for ``counter(n)`` after
    ``gauge(n)`` raises — a telemetry name that silently changes type would
    corrupt every exporter downstream.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name))
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested as {cls.__name__}")
        return m

    def get(self, name: str):
        """Existing metric by name, or None — NEVER creates (the
        create-on-first-use accessors below would materialize an empty
        metric just for being asked about)."""
        return self._metrics.get(name)

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """Point-in-time dump: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,mean,p50,p90,p99}}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            # a helper thread closing a first-of-its-path span mid-snapshot
            # would otherwise grow the dict during iteration
            items = list(self._metrics.items())
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (comm volumes land here)."""
    return _global_registry
