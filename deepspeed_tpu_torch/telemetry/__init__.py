"""Unified telemetry (the port of ``deepspeed_tpu/telemetry``'s core):
metrics registry + span tracer + recompile watchdog + JSONL sink, and the
request tracer.

  * ``MetricsRegistry`` — counters, gauges, log-bucketed histograms with
    p50/p90/p99 estimates, cheap enough for per-decode-step updates.
  * ``SpanTracer`` — nested host spans that also open
    ``torch.profiler.record_function`` ranges.
  * ``RecompileWatchdog`` — wraps the training step and the serving
    programs; every first call at a new signature is an event, and paths
    declared stable (decode) warn or raise on a second one.
  * ``ProgramLedger`` — FLOPs, bytes and device memory per watched program,
    counted on its first call (``cost.py``), joined with the wall-time
    histograms into MFU and roofline rows (``program_ledger.py``), and the
    step anatomy (``collective_ledger.py``); ``python -m
    deepspeed_tpu_torch.telemetry.report`` renders them.
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
``subsystem/name``, as in the JAX package. The collective ledger
(``collective_ledger.py``) holds the collectives each watched program's
measured call issued, and ``snapshot()`` carries its ``comm_reconcile``
view beside the comms logger's.
"""

from __future__ import annotations

from .collective_ledger import CollectiveLedger, pipeline_bubble_fraction, step_anatomy
from .exporters import JsonlExporter, MonitorBridge, prometheus_fleet_text, prometheus_text
from .incident import IncidentRecorder
from .program_ledger import ProgramLedger, hbm_snapshot, platform_peaks, tree_bytes
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
    "prometheus_fleet_text", "ProgramLedger", "hbm_snapshot", "platform_peaks",
    "tree_bytes", "RequestTracer", "request_timeline", "to_perfetto",
    "step_anatomy", "pipeline_bubble_fraction", "Telemetry", "CollectiveLedger",
    "TimeSeriesStore", "SLOTracker", "classify_terminal", "IncidentRecorder",
]


class Telemetry:
    """One registry + span tracer + recompile watchdog + program ledger +
    optional JSONL sink. ``registry=None`` creates a private registry
    (engine-scoped metrics should not mix across engine instances).
    ``ledger=False`` turns the cost counting off
    (``telemetry.ledger.enabled`` in config); ``device`` is what the
    ledger counts on and rates against (the engine sets it)."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 jsonl_path: str = "", watchdog_mode: str = "warn",
                 device_sync_spans: bool = False, ledger: bool = True,
                 jsonl_max_bytes: int = 0, jsonl_keep: int = 3, device=None,
                 ledger_collectives: bool = True, ici_gbps: float = 0.0):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sink = JsonlExporter(jsonl_path, max_bytes=jsonl_max_bytes,
                                  keep=jsonl_keep) if jsonl_path else None
        self.tracer = SpanTracer(self.registry, self.sink,
                                 device_sync=device_sync_spans)
        self.ledger = ProgramLedger(self.registry, enabled=ledger, device=device,
                                    collectives=ledger_collectives, ici_gbps=ici_gbps)
        self.watchdog = RecompileWatchdog(self.registry, self.sink,
                                          mode=watchdog_mode, ledger=self.ledger)

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
        """Registry snapshot + recompile table + program ledger + step
        anatomy (+ caller extras): the one call that reports everything.
        The ledger table and anatomy are computed FIRST so the MFU and
        intensity gauges they publish land in the same metrics snapshot."""
        out: dict = {}
        if self.ledger.enabled and self.ledger.entries:
            out["program_ledger"] = self.ledger.table(self.registry)
            out["step_anatomy"] = self.ledger.anatomy(self.registry)
            out["platform"] = dict(self.ledger.platform)
            rec = self._comm_reconcile()
            if rec:
                out["comm_reconcile"] = rec
        out["metrics"] = self.registry.snapshot()
        out["recompile_table"] = self.watchdog.compile_table()
        out.update(extra)
        return out

    def _comm_reconcile(self):
        """The comms logger's per-axis totals (every call) beside the
        collective ledger's (the watched programs' measured calls): an axis
        one side never saw is a labeled row, never averaged away."""
        coll = self.ledger.collectives
        if not coll.programs:
            return None
        from ..comm.logger import comms_logger

        if not comms_logger.enabled and not comms_logger.axis_totals():
            return None  # no host accounting to reconcile against
        return comms_logger.reconcile(coll.bytes_by_axis(), mesh_shape=coll.mesh_shape)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
