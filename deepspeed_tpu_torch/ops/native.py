"""Native-op availability probes (the reference's op_builder compatibility
report, op_builder/__init__.py ALL_OPS + builder.is_compatible), ported from
``deepspeed_tpu/ops/native.py``."""

from __future__ import annotations


def aio_available() -> bool:
    """``csrc/aio/dstpu_aio.cpp`` builds and loads (the NVMe tier)."""
    from .aio import aio_available as available

    return available()


def cpu_adam_available() -> bool:
    """The host tier's optimizer update (the reference's
    ``csrc/adam/cpu_adam.cpp``) is PyTorch on the CPU, in place on the
    tier's buffers (``runtime/zero/host_optimizer.py``): always there."""
    return True
