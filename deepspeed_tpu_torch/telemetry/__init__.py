"""Unified telemetry (the port of ``deepspeed_tpu/telemetry``'s core):
metrics registry + span tracer + recompile watchdog + JSONL sink, and the
request tracer.

  * ``MetricsRegistry`` — counters, gauges, log-bucketed histograms with
    p50/p90/p99 estimates, cheap enough for per-decode-step updates.
  * ``SpanTracer`` — nested host spans that also open
    ``torch.profiler.record_function`` ranges.
  * ``RecompileWatchdog`` — wraps the serving programs; every first call at
    a new signature is an event, and paths declared stable (decode) warn or
    raise on a second one.
  * ``RequestTracer`` — bounded per-request lifecycle timeline with a
    Perfetto export.
  * exporters — JSONL event log, Prometheus text, the bridge into the
    monitor backends.
  * the flight recorder — ``TimeSeriesStore`` (bounded downsampling
    rings, ``timeseries.py``), ``SLOTracker`` and ``classify_terminal``
    (``slo.py``), ``IncidentRecorder`` (durable incident bundles,
    ``incident.py``) and the ``autopsy`` CLI that reads them back; copies
    of the JAX package's stdlib modules.

``Telemetry`` bundles them; engines hold one each. Metric names follow
``subsystem/name``, as in the JAX package. Not ported yet: the program and
collective ledgers and the report CLI.
"""

from __future__ import annotations

import torch

from .exporters import JsonlExporter, MonitorBridge, prometheus_fleet_text, prometheus_text
from .incident import IncidentRecorder
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .request_trace import RequestTracer, request_timeline, to_perfetto
from .slo import SLOTracker, classify_terminal
from .timeseries import TimeSeriesStore
from .tracing import Span, SpanTracer
from .watchdog import RecompileError, RecompileWatchdog, abstract_signature

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "Span", "SpanTracer", "RecompileError", "RecompileWatchdog",
    "abstract_signature", "JsonlExporter", "MonitorBridge", "prometheus_text",
    "prometheus_fleet_text", "RequestTracer", "request_timeline",
    "to_perfetto", "Telemetry", "tree_bytes", "hbm_snapshot",
    "TimeSeriesStore", "SLOTracker", "classify_terminal", "IncidentRecorder",
]


def tree_bytes(tree) -> int:
    """Total bytes of the tensors in a dict/list/tuple nesting (metadata
    only, no device sync)."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def hbm_snapshot(pools: dict[str, int], device, warn_fraction: float = 0.9) -> dict:
    """Device memory attributed to named pools, beside the CUDA caching
    allocator's own counts for ``device`` (none on the CPU). ``warn`` trips
    when the allocator's reserved bytes exceed ``warn_fraction`` of the
    card's memory."""
    pools = {k: int(v) for k, v in pools.items() if v}
    out: dict = {
        "pools": pools,
        "pool_total_bytes": sum(pools.values()),
        "warn_fraction": float(warn_fraction),
        "warn": False,
    }
    device = torch.device(device)
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        out["device"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": reserved,
            "bytes_limit": int(limit),
        }
        out["warn"] = reserved > warn_fraction * limit
    return out


class Telemetry:
    """One registry + span tracer + recompile watchdog + optional JSONL
    sink. ``registry=None`` creates a private registry (engine-scoped
    metrics should not mix across engine instances)."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 jsonl_path: str = "", watchdog_mode: str = "warn",
                 device_sync_spans: bool = False,
                 jsonl_max_bytes: int = 0, jsonl_keep: int = 3):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sink = JsonlExporter(jsonl_path, max_bytes=jsonl_max_bytes,
                                  keep=jsonl_keep) if jsonl_path else None
        self.tracer = SpanTracer(self.registry, self.sink,
                                 device_sync=device_sync_spans)
        self.watchdog = RecompileWatchdog(self.registry, self.sink,
                                          mode=watchdog_mode)

    # convenience passthroughs — instrumented code holds one handle
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    def span(self, name: str, sync=None, **attrs):
        return self.tracer.span(name, sync=sync, **attrs)

    def watch(self, fn, name: str, stable: bool = False):
        return self.watchdog.watch(fn, name, stable=stable)

    def emit(self, event: dict) -> None:
        if self.sink is not None:
            self.sink.emit(event)

    def snapshot(self, **extra) -> dict:
        """Registry snapshot + recompile table (+ caller extras): the one
        call that reports everything."""
        out: dict = {"metrics": self.registry.snapshot(),
                     "recompile_table": self.watchdog.compile_table()}
        out.update(extra)
        return out

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
