"""The launcher's world, as a process finds it in its environment.

``launcher/launch.py`` (and any DeepSpeed-style launcher) sets
``WORLD_SIZE`` and ``DSTPU_NUM_PROCESSES`` for every process it starts.
Training takes such a world (``comm.init_distributed`` joins it and the
engine shards over it). Serving at a world above 1 is tensor-parallel
serving (``tp_size > 1``), which comes with the tensor-parallel slice, so
``init_inference`` refuses such a world by name instead of silently
serving as a world of one.
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
    else return 1 (the world the caller serves)."""
    world, key = launcher_world_size()
    if world > 1:
        raise NotImplementedError(
            f"{what}: the launcher's world is {world} processes ({key}={world}); serving over several "
            "processes is tensor-parallel serving (tp_size > 1), which is not ported to deepspeed_tpu_torch "
            "yet (it comes with the tensor-parallel slice). Launch one process (WORLD_SIZE=1).")
    return 1
