"""The launcher's world, as a process finds it in its environment.

``launcher/launch.py`` (and any DeepSpeed-style launcher) sets
``WORLD_SIZE`` and ``DSTPU_NUM_PROCESSES`` for every process it starts.
Training takes such a world (``comm.init_distributed`` joins it and the
engine shards over it). Serving takes a world of exactly ``tp_size``
processes: tensor-parallel serving, one rank a device, over the mesh
``MeshConfig(data=-1, model=tp_size)``. Any other world would put a
``data`` axis above 1 under the server (data-parallel serving, where the
JAX engine spreads the batch's rows), which is not ported, so
``init_inference`` refuses it by name instead of silently serving as a
world of ``tp_size``.
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


def refuse_multi_process_world(what: str, tp_size: int = 1) -> int:
    """Raise ``NotImplementedError`` when the launcher's world is above 1
    and is not ``tp_size``, else return the world (1, or ``tp_size``)."""
    world, key = launcher_world_size()
    if world > 1 and world != tp_size:
        raise NotImplementedError(
            f"{what}: the launcher's world is {world} processes ({key}={world}) but tp_size is {tp_size}: "
            f"serving over a world other than tp_size would give the mesh a data axis of {world / tp_size:g} "
            "(data-parallel serving), which is not ported to deepspeed_tpu_torch yet; tensor-parallel serving "
            f"takes a world of exactly tp_size processes (launch {key}=tp_size), or launch one process.")
    return world
