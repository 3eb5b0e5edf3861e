"""Distributed-aware logging: a module logger plus ``log_dist(ranks=...)``,
which only emits on the named ranks (the port of
``deepspeed_tpu/utils/logging.py``; the rank is ``torch.distributed``'s when
a process group is up, else 0)."""

import logging
import os
import sys

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        lg.setLevel(level)
        lg.propagate = False
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        lg.addHandler(handler)
    env_level = os.environ.get("DSTPU_LOG_LEVEL")
    if env_level:
        lg.setLevel(getattr(logging, env_level.upper(), level))
    return lg


logger = create_logger()


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (-1 or None = all)."""
    my_rank = _rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
