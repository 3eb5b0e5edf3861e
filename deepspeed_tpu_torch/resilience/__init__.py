"""The fault-tolerance layer: typed failures (``errors.py``, a copy of the
JAX package's) and the serving engine's fault injector (``faults.py``)."""

from .errors import CheckpointCorruptError, CheckpointError, CheckpointNotFoundError, RequestRejected, ResilienceError  # noqa: F401
from .faults import FaultInjector  # noqa: F401
