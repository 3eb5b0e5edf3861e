"""Telemetry exporters: the JSONL event log, the Prometheus text dump and
the monitor bridge (``deepspeed_tpu/telemetry/exporters.py``, which imports
no jax).

  * ``JsonlExporter`` — append-only event stream (spans, compiles, requests,
    registry snapshots) for offline triage, with size-bounded rotation.
  * ``prometheus_text`` — point-in-time scrape body in the Prometheus text
    exposition format (counters as ``_total``, histogram quantiles as
    ``{quantile="0.5"}`` labels); ``prometheus_fleet_text`` the same over a
    fleet snapshot, each replica under a ``replica`` label. Metric names
    keep the ``dstpu_`` prefix, so one scrape config serves both packages.
  * ``MonitorBridge`` — registry snapshots as ``MonitorMaster`` events (the
    training engine pushes at print boundaries).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from ..utils.durability import fsync_dir
from .registry import MetricsRegistry


class JsonlExporter:
    """Append telemetry events to a JSONL file, one object per line.

    Every event gets an absolute wall-clock ``"t"`` stamp at emit time.
    Writes are locked (spans may close from helper threads) and flushed per
    emit — event rates here are per-step/per-request, not per-token, so
    durability beats batching.

    ``max_bytes > 0`` bounds the file on long-running fleets: when an
    append would grow past it, the live file rename-rotates to ``.1``
    (existing rotations shift up, ``keep`` retained, oldest deleted) and a
    fresh file opens — ``os.replace`` + directory fsync, so a crash
    mid-rotation never loses the renamed history.
    """

    def __init__(self, path: str, max_bytes: int = 0, keep: int = 3):
        import weakref

        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = max(1, int(keep))
        self._f = open(path, "a")
        self._bytes = os.fstat(self._f.fileno()).st_size
        self._lock = threading.Lock()
        # engines have no destroy() hook; a weakref finalizer closes the fd
        # at GC or interpreter exit WITHOUT pinning the exporter alive the
        # way atexit.register(bound method) would
        self._finalizer = weakref.finalize(self, JsonlExporter._close_file, self._f)

    @staticmethod
    def _close_file(f) -> None:
        if not f.closed:
            f.close()

    def _rotate(self) -> None:
        """Shift ``path.(keep-1)`` .. ``path.1`` up one, move the live file
        to ``.1``, reopen fresh. Caller holds the lock; pure renames —
        nothing here blocks on more than directory metadata."""
        self._f.close()
        try:
            oldest = f"{self.path}.{self.keep}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
            fsync_dir(self.path)
        except OSError:
            pass  # a failed rotation degrades to an unbounded file, not a crash
        self._finalizer.detach()
        self._f = open(self.path, "a")
        self._bytes = os.fstat(self._f.fileno()).st_size
        import weakref

        self._finalizer = weakref.finalize(
            self, JsonlExporter._close_file, self._f)

    def emit(self, event: dict) -> None:
        # dstpu: allow[wall-clock-verdict] -- JSONL event timestamps are wall-clock on purpose: logs from different processes and hosts are correlated by them; nothing subtracts them for a deadline or a staleness bound
        line = json.dumps({"t": time.time(), **event}, separators=(",", ":"),
                          default=str)
        data = line + "\n"
        with self._lock:
            if self._f.closed:
                return
            if (self.max_bytes > 0 and self._bytes > 0
                    and self._bytes + len(data) > self.max_bytes):
                self._rotate()
            self._f.write(data)
            self._f.flush()
            self._bytes += len(data)

    def close(self) -> None:
        with self._lock:
            JsonlExporter._close_file(self._f)


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "dstpu_" + "".join(out)


def _prom_lines(snap: dict, labels: str = "",
                seen: Optional[set] = None) -> list:
    """Exposition lines for one registry snapshot. ``labels`` is a
    pre-rendered label body (e.g. ``replica="0"``); ``seen`` dedupes the
    ``# HELP``/``# TYPE`` headers across the fleet's nested snapshots —
    Prometheus drops an exposition that repeats metadata for a family."""
    seen = set() if seen is None else seen
    lab = "{" + labels + "}" if labels else ""
    lines = []

    def head(pn: str, kind: str, src: str) -> None:
        if pn in seen:
            return
        seen.add(pn)
        lines.append(f"# HELP {pn} deepspeed_tpu metric {src}")
        lines.append(f"# TYPE {pn} {kind}")

    for name, v in snap["counters"].items():
        pn = _prom_name(name)
        head(f"{pn}_total", "counter", name)
        lines.append(f"{pn}_total{lab} {v}")
    for name, v in snap["gauges"].items():
        pn = _prom_name(name)
        head(pn, "gauge", name)
        lines.append(f"{pn}{lab} {v}")
    for name, h in snap["histograms"].items():
        pn = _prom_name(name)
        head(pn, "summary", name)
        for q in ("p50", "p90", "p99"):
            qlab = "{" + (labels + "," if labels else "") \
                + f'quantile="0.{q[1:]}"' + "}"
            lines.append(f"{pn}{qlab} {h[q]}")
        lines.append(f"{pn}_sum{lab} {h['sum']}")
        lines.append(f"{pn}_count{lab} {h['count']}")
    return lines


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition of a registry snapshot (with ``# HELP``/
    ``# TYPE`` metadata per family)."""
    return "\n".join(_prom_lines(registry.snapshot())) + "\n"


def prometheus_fleet_text(snapshot: dict) -> str:
    """Exposition of a ``Router.telemetry_snapshot()``: the router's own
    registry unlabeled, each replica's registry under a
    ``replica="<rid>"`` label — same metric family, distinct series, so a
    scrape of the fleet neither collides nor drops replicas. Replica
    blocks that carry no metrics (an unreachable replica's stub) are
    skipped."""
    seen: set = set()
    lines = _prom_lines(snapshot.get("router", {}).get("metrics")
                        or {"counters": {}, "gauges": {}, "histograms": {}},
                        seen=seen)
    for rid in sorted(snapshot.get("replicas") or {}):
        metrics = (snapshot["replicas"][rid] or {}).get("metrics")
        if not metrics:
            continue
        lines.extend(_prom_lines(metrics, labels=f'replica="{rid}"',
                                 seen=seen))
    return "\n".join(lines) + "\n"


class MonitorBridge:
    """Forward registry snapshots into ``MonitorMaster`` backends.

    Counters and gauges become one event each; histograms fan out to
    ``<tag>/p50|p90|p99``. Tags are ``<prefix>/<metric name>``.
    """

    def __init__(self, monitor, prefix: str = "Telemetry"):
        self.monitor = monitor
        self.prefix = prefix

    def push(self, registry: MetricsRegistry, step: int) -> list:
        """Build and deliver the event batch; returns it."""
        snap = registry.snapshot()
        events = []
        for name, v in snap["counters"].items():
            events.append((f"{self.prefix}/{name}", v, step))
        for name, v in snap["gauges"].items():
            events.append((f"{self.prefix}/{name}", v, step))
        for name, h in snap["histograms"].items():
            for q in ("p50", "p90", "p99"):
                events.append((f"{self.prefix}/{name}/{q}", h[q], step))
        if events and getattr(self.monitor, "enabled", False):
            self.monitor.write_events(events)
        return events
