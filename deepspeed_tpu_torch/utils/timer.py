"""Wall-clock and throughput timers (the port of
``deepspeed_tpu/utils/timer.py``, DeepSpeed's ``utils/timer.py``).

A timed region on the card is bracketed by a synchronisation: ``start`` and
``stop`` take an optional ``barrier``, a tensor (or device) whose CUDA
stream is synchronised before the clock is read, so the interval covers
the device's work and not only its dispatch; DeepSpeed's ``CudaEventTimer``
does the same with events, the JAX package with ``block_until_ready``. A
barrier on the CPU synchronises nothing.

Built with ``registry=`` (a telemetry ``MetricsRegistry``), every
``stop()`` interval mirrors into the ``timer/<name>_sec`` histogram, so the
report CLI's percentiles cover the timers too. The registry-less form
still works for scripts and warns once per process; the engines always
pass their registry.
"""

import time

import torch

from .logging import logger
from .memory import device_memory_stats

_standalone_warned = False


def _warn_standalone(cls_name: str) -> None:
    global _standalone_warned
    if _standalone_warned:
        return
    _standalone_warned = True
    logger.warning(
        "%s built without registry= — the standalone timer path is "
        "deprecated; pass a telemetry MetricsRegistry so timings mirror "
        "into the timer/<name>_sec histograms", cls_name)


def _sync(barrier) -> None:
    """Wait for the CUDA stream that ``barrier`` (a tensor or a device)
    lives on; nothing for the CPU or None."""
    if barrier is None:
        return
    device = barrier.device if torch.is_tensor(barrier) else torch.device(barrier)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class _Timer:
    def __init__(self, name: str, registry=None):
        self.name = name
        self.registry = registry
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0
        self.count = 0

    def start(self, barrier=None):
        assert not self.started_, f"timer {self.name} already started"
        _sync(barrier)
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, barrier=None):
        assert self.started_, f"timer {self.name} not started"
        _sync(barrier)
        dt = time.perf_counter() - self.start_time
        self.elapsed_ += dt
        self.count += 1
        self.started_ = False
        if self.registry is not None:
            self.registry.histogram(f"timer/{self.name}_sec").observe(dt)

    def reset(self):
        self.elapsed_ = 0.0
        self.count = 0
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        val = self.elapsed_
        if reset:
            self.reset()
        return val

    def mean(self) -> float:
        return self.elapsed_ / max(self.count, 1)


class SynchronizedWallClockTimer:
    """Named timers (DeepSpeed ``utils/timer.py:31``). Pass ``registry=`` to
    mirror every timer into telemetry histograms; ``device`` is whose
    memory ``log(memory_breakdown=True)`` reports."""

    def __init__(self, registry=None, device=None):
        self.registry = registry
        self.device = device
        self.timers: dict[str, _Timer] = {}
        if registry is None:
            _warn_standalone(type(self).__name__)

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, registry=self.registry)
        return self.timers[name]

    def memory_usage(self) -> str:
        stats = device_memory_stats(self.device)
        if not stats:
            return "device mem stats unavailable"
        return (f"device mem in-use {stats['bytes_in_use'] / 1024**3:.2f} GB | "
                f"peak {stats['peak_bytes_in_use'] / 1024**3:.2f} GB")

    def log(self, names, normalizer: float = 1.0, reset: bool = True, memory_breakdown=False) -> str:
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        logger.info(string)
        return string


class ThroughputTimer:
    """Samples/sec (DeepSpeed ``utils/timer.py:135``). With ``registry=``
    the rolling samples/sec lands in the ``train/samples_per_sec`` gauge at
    each report boundary."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, registry=None):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.registry = registry
        self.epoch_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.started = False
        self.start_time = 0.0

    def start(self):
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self, global_step: bool = True, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        if global_step:
            self.global_step_count += 1
        duration = time.perf_counter() - self.start_time
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                logger.info(
                    f"step={self.global_step_count}, "
                    f"samples/sec={self.avg_samples_per_sec():.2f}, "
                    f"curr samples/sec={self.batch_size * self.steps_per_output / max(self.step_elapsed_time, 1e-9):.2f}"
                )
                if self.registry is not None:
                    self.registry.gauge("train/samples_per_sec").set(self.avg_samples_per_sec())
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step:
            steps = self.global_step_count - self.start_step
            return self.batch_size / (self.total_elapsed_time / max(steps, 1))
        return -1.0
