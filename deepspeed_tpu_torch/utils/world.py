"""The launcher's world, as a process finds it in its environment.

``launcher/launch.py`` (and any DeepSpeed-style launcher) sets
``WORLD_SIZE`` and ``DSTPU_NUM_PROCESSES`` for every process it starts.
The port runs one process on one GPU, so an entry point that finds a world
above 1 refuses it by name instead of silently training or serving as a
world of one.
"""

from __future__ import annotations

import os

WORLD_ENV = ("WORLD_SIZE", "DSTPU_NUM_PROCESSES")


def launcher_world_size() -> tuple[int, str]:
    """(the largest world any of ``WORLD_ENV`` names, the variable that
    named it); (1, "") when none is set."""
    world, key = 1, ""
    for name in WORLD_ENV:
        raw = os.environ.get(name, "").strip()
        if raw and int(raw) > world:
            world, key = int(raw), name
    return world, key


def refuse_multi_process_world(what: str) -> int:
    """Raise ``NotImplementedError`` when the launcher's world is above 1,
    else return 1 (the data-parallel world the caller runs)."""
    world, key = launcher_world_size()
    if world > 1:
        raise NotImplementedError(
            f"{what}: the launcher's world is {world} processes ({key}={world}); data parallelism over "
            "torch.distributed is not ported to deepspeed_tpu_torch yet, so each process would train or "
            "serve as a world of 1. Launch one process (WORLD_SIZE=1).")
    return 1
