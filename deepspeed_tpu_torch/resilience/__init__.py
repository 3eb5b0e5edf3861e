"""Typed failures of the fault-tolerance layer (``errors.py``, a copy of the
JAX package's); the port raises the checkpoint ones so far."""

from .errors import CheckpointCorruptError, CheckpointError, CheckpointNotFoundError, ResilienceError  # noqa: F401
