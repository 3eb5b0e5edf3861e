"""Profiling: the FLOPs / params / latency profiler (``flops_profiler``)."""
