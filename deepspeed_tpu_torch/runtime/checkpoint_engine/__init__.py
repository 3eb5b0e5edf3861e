from .checkpoint_engine import NativeCheckpointEngine, get_checkpoint_engine  # noqa: F401
