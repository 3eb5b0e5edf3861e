"""Bounded-memory downsampling time-series rings: the fleet flight recorder
(a copy of ``deepspeed_tpu/telemetry/timeseries.py``, stdlib only).

The registry (telemetry/registry.py) answers "what is the value NOW"; this
module answers "what was it over the last minute/hour" without ever growing.
Each named series is a set of fixed-interval tiers (raw -> 1s -> 10s -> 60s
by default), each tier a fixed-size ``collections.deque`` of aggregate cells
``[t_start, min, max, sum, count]`` — O(tiers x capacity) memory per series
regardless of run length. Samples land in every tier at once (a handful of
list updates — cheap enough for the serve loop at the configured interval),
and a closed RAW cell is additionally appended to a bounded flush journal
with a monotone sequence number, the same seq-cursor discipline as
``RequestTracer.events_since``: a serving worker piggybacks
``cells_since()`` output on its step reply (zero extra RPCs) and the Router
``ingest()``s the cells into a per-replica mirror store, rebuilding the
coarser tiers router-side. A replica SIGKILL'd mid-run has therefore
already shipped its recent history — the incident recorder
(telemetry/incident.py) and the SLO tracker (telemetry/slo.py) read these
rings, never the dead process.

Locking follows MetricsRegistry: one lock guards structure (series-dict
creation, deque mutation vs. snapshot iteration — deques raise if mutated
mid-iteration from another thread). Writers are single-threaded by design
(the owning step/serve loop); readers (gateway handler threads, the report
CLI) take the same lock for a consistent copy. Nothing blocking ever runs
under the lock. Stdlib-only: importable by the autopsy CLI without a device runtime.
"""

from __future__ import annotations

import math
import threading
from collections import deque

# cell layout (a plain list — JSON-portable across the step-reply wire and
# into incident bundles): [t_start, min, max, sum, count]
_T, _MIN, _MAX, _SUM, _COUNT = range(5)

SCHEMA = "dstpu-rings/1"


def merge_cell(cell: list, v: float) -> None:
    """Fold one sample into an aggregate cell in place."""
    if v < cell[_MIN]:
        cell[_MIN] = v
    if v > cell[_MAX]:
        cell[_MAX] = v
    cell[_SUM] += v
    cell[_COUNT] += 1


def _fold(cell: list, other: list) -> None:
    """Fold a finished cell into a coarser cell in place (mirror rebuild)."""
    if other[_MIN] < cell[_MIN]:
        cell[_MIN] = other[_MIN]
    if other[_MAX] > cell[_MAX]:
        cell[_MAX] = other[_MAX]
    cell[_SUM] += other[_SUM]
    cell[_COUNT] += other[_COUNT]


class _Series:
    """One metric's tier set. All mutation happens under the store lock."""

    __slots__ = ("tiers",)

    def __init__(self, intervals: tuple, capacity: int):
        # tiers[0] is the raw tier; each entry is (interval_s, deque-of-cells)
        self.tiers = [(float(iv), deque(maxlen=capacity)) for iv in intervals]

    def observe(self, t: float, v: float) -> list | None:
        """Add one sample at time ``t``; returns the RAW cell this sample
        CLOSED (a fresh raw bucket started), else None."""
        closed = None
        for i, (interval, cells) in enumerate(self.tiers):
            start = math.floor(t / interval) * interval
            if cells and cells[-1][_T] == start:
                merge_cell(cells[-1], v)
            else:
                if i == 0 and cells:
                    closed = cells[-1]
                cells.append([start, v, v, v, 1])
        return closed

    def ingest(self, cell: list) -> None:
        """Merge a CLOSED raw cell shipped from another store (the Router's
        per-replica mirror path) into every tier."""
        t = float(cell[_T])
        for interval, cells in self.tiers:
            start = math.floor(t / interval) * interval
            if cells and cells[-1][_T] == start:
                _fold(cells[-1], cell)
            elif not cells or start > cells[-1][_T]:
                cells.append([start, cell[_MIN], cell[_MAX],
                              cell[_SUM], cell[_COUNT]])
            # a cell older than the tier's newest bucket is late (re-ordered
            # flush after a replica respawn): dropped — tiers stay monotone

    def window(self, t0: float, t1: float) -> list[list]:
        """Cells overlapping ``[t0, t1]`` from the FINEST tier whose ring
        still reaches back to ``t0`` (the raw tier forgets first)."""
        interval, chosen = self.tiers[-1]
        for iv, cells in self.tiers:
            if cells and cells[0][_T] <= t0:
                interval, chosen = iv, cells
                break
        return [list(c) for c in chosen
                if c[_T] + interval > t0 and c[_T] <= t1]

    def dump(self) -> dict:
        return {f"{iv:g}s": [list(c) for c in cells]
                for iv, cells in self.tiers}


class TimeSeriesStore:
    """Named series -> tiered rings, with a seq-cursor flush journal.

    ``sample()`` is the producer API (one call per interval from the owning
    loop): ``gauges`` are recorded as-is, ``counters`` are CUMULATIVE values
    whose per-interval delta is recorded (so a ring cell's ``sum`` reads as
    "events in this bucket" — burn rates and shed/failover spikes fall out
    of window sums). ``ingest()`` is the consumer API for cells flushed from
    another store.
    """

    def __init__(self, raw_interval_s: float = 0.25,
                 tiers: tuple = (1.0, 10.0, 60.0), capacity: int = 240,
                 flush_capacity: int = 4096):
        if raw_interval_s <= 0:
            raise ValueError(
                f"raw_interval_s must be > 0, got {raw_interval_s}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        coarse = sorted(float(t) for t in tiers if float(t) > raw_interval_s)
        self.raw_interval_s = float(raw_interval_s)
        self.intervals = (self.raw_interval_s, *coarse)
        self.capacity = int(capacity)
        self._series: dict[str, _Series] = {}
        self._last_counters: dict[str, float] = {}
        self._journal: deque = deque(maxlen=int(flush_capacity))
        self._seq = 0  # cells ever journaled (ring evicts, seq doesn't)
        self._lock = threading.Lock()

    # -- producer side ---------------------------------------------------

    def sample(self, now: float, gauges: dict | None = None,
               counters: dict | None = None) -> None:
        if not math.isfinite(now):
            return  # drain-mode now=inf must not poison bucket starts
        deltas = {}
        for name, v in (counters or {}).items():
            v = float(v)
            prev = self._last_counters.get(name)
            self._last_counters[name] = v
            if prev is None:
                continue  # first observation defines the baseline
            deltas[name] = max(0.0, v - prev)  # counter resets clamp to 0
        with self._lock:
            for name, v in (gauges or {}).items():
                self._observe(name, now, float(v))
            for name, d in deltas.items():
                self._observe(name, now, d)

    def _observe(self, name: str, t: float, v: float) -> None:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = _Series(self.intervals, self.capacity)
        closed = s.observe(t, v)
        if closed is not None:
            self._journal.append({"s": name, "c": list(closed)})
            self._seq += 1

    # -- flush / mirror side ---------------------------------------------

    def cells_since(self, cursor: int, limit: int = 256) -> tuple[list, int]:
        """Closed raw cells journaled after ``cursor`` (0 = from the start),
        oldest first, at most ``limit`` — ``(cells, new_cursor)``, the
        ``RequestTracer.events_since`` contract. Cells evicted before being
        read are lost (bounded, not guaranteed)."""
        with self._lock:
            buf = self._journal
            skip = max(0, len(buf) - max(0, self._seq - int(cursor)))
            out = [dict(item) for i, item in enumerate(buf)
                   if skip <= i < skip + max(0, int(limit))]
            return out, self._seq - max(0, len(buf) - skip - len(out))

    def ingest(self, name: str, cell: list) -> None:
        """Merge one flushed raw cell into this store (Router mirror)."""
        if not isinstance(cell, (list, tuple)) or len(cell) != 5:
            return  # wire garbage must not corrupt the ring
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series(self.intervals,
                                                 self.capacity)
            s.ingest([float(x) for x in cell])

    # -- reader side -----------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def window(self, name: str, t0: float, t1: float) -> list[list]:
        with self._lock:
            s = self._series.get(name)
            return s.window(t0, t1) if s is not None else []

    def window_sum(self, name: str, t0: float, t1: float) -> tuple[float, int]:
        """(sum, count) over cells in ``[t0, t1]`` — the SLO tracker's
        window primitive (counter series: sum == events in window)."""
        total = 0.0
        n = 0
        for c in self.window(name, t0, t1):
            total += c[_SUM]
            n += int(c[_COUNT])
        return total, n

    def last(self, name: str) -> list | None:
        """Newest raw cell for ``name`` (None when never sampled)."""
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.tiers[0][1]:
                return None
            return list(s.tiers[0][1][-1])

    def window_snapshot(self, t0: float, t1: float) -> dict:
        """Every series' cells overlapping ``[t0, t1]`` — the incident
        bundle's ring-window block."""
        with self._lock:
            names = list(self._series)
        return {"schema": SCHEMA, "t0": t0, "t1": t1,
                "series": {n: self.window(n, t0, t1) for n in names}}

    def snapshot(self) -> dict:
        """Full dump: {schema, intervals, series: {name: {tier: cells}}}."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "intervals": list(self.intervals),
                "series": {n: s.dump() for n, s in self._series.items()},
            }


__all__ = ["TimeSeriesStore", "merge_cell", "SCHEMA"]
