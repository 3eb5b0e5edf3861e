"""Host-side span tracer (the port of ``deepspeed_tpu/telemetry/tracing.py``).

A span is a named wall-clock region. Each span:

  * opens a ``torch.profiler.record_function`` range, so the same region
    appears in a ``torch.profiler`` trace when one is recording (the JAX
    version opens a ``jax.profiler.TraceAnnotation``);
  * feeds its duration into the registry histogram ``span/<path>`` where
    ``path`` is the slash-joined nesting (``serve/step/decode``);
  * optionally emits a JSONL event ``{"type": "span", "name", "path",
    "depth", "start_s", "dur_s"}`` (``start_s`` relative to the tracer's
    epoch, ``t`` absolute wall time added by the exporter).

Device-accurate mode: CUDA launches return before the device finishes, so a
span that merely brackets them times the enqueue. Instrumented code attaches
the step's output via ``span.set_sync(x)`` (or the ``sync=`` argument); a
tracer built with ``device_sync=True`` then waits at exit for the work that
produced it: for every CUDA tensor in ``x`` it records an event on its
device's current stream and synchronises that event. CPU tensors are
already computed. With ``device_sync=False`` (default) the attached value is
ignored, so instrumentation never costs a sync unless asked to.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .registry import MetricsRegistry, get_registry


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def wait_for(value) -> None:
    """Block until the device work producing every CUDA tensor in ``value``
    (a tensor or a dict/list/tuple nesting of them) has finished."""
    devices = {t.device for t in _tensors(value) if t.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class Span:
    """One open region. Use via ``SpanTracer.span`` (context manager)."""

    __slots__ = ("name", "path", "depth", "start_s", "dur_s", "attrs", "_sync", "_ann")

    def __init__(self, name: str, path: str, depth: int):
        self.name = name
        self.path = path
        self.depth = depth
        self.start_s = 0.0
        self.dur_s = 0.0
        self.attrs: dict = {}
        self._sync = None
        self._ann = None

    def set_sync(self, value) -> None:
        """Arrange for the span to wait at exit for the device work that
        produced ``value`` (tensors, or a nesting of them)."""
        self._sync = value

    def annotate(self, **attrs) -> None:
        """Attach extra key/values to the span's JSONL event."""
        self.attrs.update(attrs)


class SpanTracer:
    def __init__(self, registry: Optional[MetricsRegistry] = None, sink=None,
                 device_sync: bool = False):
        self.registry = registry if registry is not None else get_registry()
        self.sink = sink
        self.device_sync = device_sync
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, sync=None, **attrs) -> "_SpanCtx":
        """Open a nested span: ``with tracer.span("decode") as sp: ...``.

        ``sync``: optional value to wait for at exit, only when the tracer
        was built with ``device_sync=True``."""
        return _SpanCtx(self, name, sync, attrs)

    def _emit(self, span: Span) -> None:
        self.registry.histogram(f"span/{span.path}").observe(span.dur_s)
        if self.sink is not None:
            ev = {
                "type": "span",
                "name": span.name,
                "path": span.path,
                "depth": span.depth,
                "start_s": round(span.start_s, 6),
                "dur_s": span.dur_s,
            }
            if span.attrs:
                ev.update(span.attrs)
            self.sink.emit(ev)


class _SpanCtx:
    __slots__ = ("tracer", "name", "sync", "attrs", "span")

    def __init__(self, tracer: SpanTracer, name: str, sync, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.sync = sync
        self.attrs = attrs

    def __enter__(self) -> Span:
        stack = self.tracer._stack()
        parent = stack[-1] if stack else None
        path = f"{parent.path}/{self.name}" if parent else self.name
        sp = Span(self.name, path, len(stack))
        if self.attrs:
            sp.attrs.update(self.attrs)
        if self.sync is not None:
            sp._sync = self.sync
        sp._ann = torch.profiler.record_function(sp.path)
        sp._ann.__enter__()
        stack.append(sp)
        sp.start_s = time.perf_counter() - self.tracer._epoch
        self.span = sp
        return sp

    def __exit__(self, exc_type, exc, tb) -> None:
        sp = self.span
        try:
            # a device fault surfaces HERE in device_sync mode; the range and
            # the nesting stack below must still be closed
            if exc_type is None and sp._sync is not None and self.tracer.device_sync:
                wait_for(sp._sync)
        finally:
            sp.dur_s = (time.perf_counter() - self.tracer._epoch) - sp.start_s
            sp._ann.__exit__(exc_type, exc, tb)
            stack = self.tracer._stack()
            if stack and stack[-1] is sp:
                stack.pop()
        if exc_type is None:
            self.tracer._emit(sp)
