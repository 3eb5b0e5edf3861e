"""Memory usage reporting (the port of ``deepspeed_tpu/utils/memory.py``,
DeepSpeed's ``see_memory_usage``).

On the card the numbers are the CUDA caching allocator's
(``torch.cuda.memory_stats``): the bytes in use by tensors, their peak,
the bytes the allocator holds from the driver, and the card's memory; the
host's resident set comes from ``/proc``. On the CPU there are no device
numbers.
"""

from __future__ import annotations

import torch

from .logging import logger


def _host_rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024**2
    except OSError:
        pass
    return 0.0


def device_memory_stats(device=None) -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_reserved, bytes_limit} of a
    CUDA device (the current one when ``device`` is None), in the JAX
    package's key names; an empty dict on the CPU or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


def see_memory_usage(message: str, force: bool = False, device=None) -> dict:
    """Log the device memory in use, its peak and the card's memory beside
    the host's RSS; returns the numbers. As in DeepSpeed, nothing is
    measured or logged unless ``force``: callers thread a config bit
    through it."""
    if not force:
        return {}
    stats = device_memory_stats(device)
    used = stats.get("bytes_in_use", 0) / 1024**3
    peak = stats.get("peak_bytes_in_use", 0) / 1024**3
    limit = stats.get("bytes_limit", 0) / 1024**3
    rss = _host_rss_gb()
    if stats:
        logger.info("%s | device mem: %.2f GB used, %.2f GB peak, %.2f GB limit | host RSS %.2f GB",
                    message, used, peak, limit, rss)
    else:
        logger.info("%s | host RSS %.2f GB (no device memory stats on the CPU)", message, rss)
    return {"used_gb": used, "peak_gb": peak, "limit_gb": limit, "host_rss_gb": rss}
