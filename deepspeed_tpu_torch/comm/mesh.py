"""The process mesh: the port of ``deepspeed_tpu/comm/mesh.py``.

The JAX package lays its devices out over one named ``jax.sharding.Mesh``
and a collective names an axis where the reference named a process group.
Here the world's processes (one rank per device) are laid out the same way,
row-major over ``AXIS_ORDER`` as JAX reshapes its device list, and every
axis and axis tuple the engine reduces over gets its ``torch.distributed``
process groups, built in the same order on every rank. A ``Mesh`` is the
port's "process group by axis name": ``comm.get_world_size(group="fsdp")``
reads it as JAX reads its mesh.

Axis naming (outer to inner), as in JAX:

    pipe    pipeline stages
    data    pure data parallel (replicated params)
    fsdp    ZeRO-3 parameter/grad/optimizer sharding axis
    context sequence/context parallelism
    model   tensor parallelism
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional, Sequence, Union

import numpy as np

from ..utils.logging import logger

AXIS_ORDER = ("pipe", "data", "fsdp", "context", "model")

# the data-parallel axes: gradients are averaged over their product
DP_AXES = ("data", "fsdp")

# the axes (and tuples of axes) the data-parallel engine reduces over; each
# gets its process groups when a mesh is built
ENGINE_AXES = ("data", "fsdp", DP_AXES)

# the axes tensor-parallel serving adds: the ``model`` axis's groups
SERVING_AXES = ENGINE_AXES + ("model",)

# the axes a tensor-parallel training world adds: the ``model`` axis's
# groups, and the whole data x model plane, over which the gradient norm and
# LAMB's whole-leaf sums add each piece once
TP_TRAIN_AXES = SERVING_AXES + (DP_AXES + ("model",),)

# the axes a pipelined training world adds: the ``pipe`` axis's groups (the
# stages' sends, the sum of the gradients of the leaves every stage holds)
# and the planes over which the gradient norm adds each piece once
PIPE_TRAIN_AXES = TP_TRAIN_AXES + ("pipe", ("pipe",) + DP_AXES, ("pipe",) + DP_AXES + ("model",))


def train_axes(sizes: dict) -> tuple:
    """The axes (and planes) a training engine's mesh of axis ``sizes``
    builds process groups for."""
    if sizes.get("pipe", 1) > 1:
        return PIPE_TRAIN_AXES
    return TP_TRAIN_AXES if sizes.get("model", 1) > 1 else ENGINE_AXES


def world_plane(sizes: dict) -> tuple:
    """The axes a training world spans (the data axes, then ``model`` and
    ``pipe`` where above 1): the plane over which a reduction meets every
    rank once."""
    return (("pipe",) if sizes.get("pipe", 1) > 1 else ()) + DP_AXES + (
        ("model",) if sizes.get("model", 1) > 1 else ())


Axes = Union[str, Sequence[str]]

# the most recently built mesh: the "default process group" analogue
_CURRENT_MESH: list = [None]


def current_mesh() -> Optional["Mesh"]:
    return _CURRENT_MESH[0]


def set_current_mesh(mesh: Optional["Mesh"]) -> None:
    _CURRENT_MESH[0] = mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Requested size per logical axis; -1 on at most one axis = use remainder."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    context: int = 1
    model: int = 1

    def sizes(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[unknown[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
        return sizes


def _as_axes(axes: Axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """The world's ranks over named axes. ``ranks`` is the rank array, one
    dimension per axis of ``AXIS_ORDER``; ``shape`` maps each axis to its
    size (in that order). ``group(axes)`` is the process group of this
    rank's line (or plane) along ``axes``; ``members(axes)`` lists its ranks
    in the axes' order, the order in which ``lax.all_gather`` tiles over an
    axis tuple (the first axis major)."""

    def __init__(self, ranks: np.ndarray, rank: int):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = AXIS_ORDER
        self.shape = {a: int(s) for a, s in zip(AXIS_ORDER, self.ranks.shape)}
        self.rank = int(rank)
        self.world = int(self.ranks.size)
        self._groups: dict[tuple, object] = {}

    def coords(self, rank: Optional[int] = None) -> dict[str, int]:
        """``rank``'s index along every axis (default: this rank)."""
        r = self.rank if rank is None else int(rank)
        where = np.argwhere(self.ranks == r)
        if not len(where):
            raise ValueError(f"rank {r} is not in the mesh {self.shape}")
        return dict(zip(AXIS_ORDER, (int(i) for i in where[0])))

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in _as_axes(axes))

    def axis_index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """``rank``'s linear index along ``axes`` (the first axis major), as
        ``lax.axis_index`` over an axis tuple."""
        c = self.coords(rank)
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def members(self, axes: Axes, rank: Optional[int] = None) -> list[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, ordered
        by their index along ``axes``."""
        axes = _as_axes(axes)
        c = self.coords(rank)
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            cc = dict(c, **dict(zip(axes, combo)))
            out.append(int(self.ranks[tuple(cc[a] for a in AXIS_ORDER)]))
        return out

    def partition(self, axes: Axes) -> list[list[int]]:
        """Every group of ``axes`` (each in the axes' order), in the order of
        its first rank: the groups every rank creates, in the same order."""
        seen, out = set(), []
        for r in sorted(int(x) for x in self.ranks.ravel()):
            if r in seen:
                continue
            m = self.members(axes, r)
            seen.update(m)
            out.append(m)
        return out

    def _key(self, axes: Axes) -> tuple:
        return tuple(sorted(_as_axes(axes), key=AXIS_ORDER.index))

    def group(self, axes: Axes):
        """The process group of this rank along ``axes`` (None when no
        process group is up: a world of 1 without ``init_distributed``)."""
        key = self._key(axes)
        if key not in self._groups:
            raise KeyError(f"no process groups for axes {key}; build_mesh makes {ENGINE_AXES}")
        return self._groups[key]

    def make_groups(self, axes_list=ENGINE_AXES) -> None:
        """Create the process groups of each entry of ``axes_list`` with
        ``dist.new_group``. Collective: every rank calls it with the same
        list, so every rank creates every group in the same order."""
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        for axes in axes_list:
            key = self._key(axes)
            if key in self._groups:
                continue
            mine = None
            for block in self.partition(key):
                pg = dist.new_group(sorted(block)) if up else None
                if self.rank in block:
                    mine = pg
            self._groups[key] = mine

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _world_and_rank(world: Optional[int], rank: Optional[int]) -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        w, r = dist.get_world_size(), dist.get_rank()
        if (world is not None and world != w) or (rank is not None and rank != r):
            raise ValueError(f"build_mesh(world={world}, rank={rank}) disagrees with the process group "
                             f"(world {w}, rank {r})")
        return w, r
    return (1 if world is None else int(world)), (0 if rank is None else int(rank))


def build_mesh(config: Optional[MeshConfig] = None, world: Optional[int] = None,
               rank: Optional[int] = None, axes_list=ENGINE_AXES) -> Mesh:
    """The world's ranks laid out row-major over ``AXIS_ORDER`` (JAX
    reshapes ``jax.devices()`` the same way), with the process groups of
    ``axes_list`` built. ``world``/``rank`` default to the process group's
    (a world of 1 without one). Collective when a process group is up."""
    config = config or MeshConfig()
    world, rank = _world_and_rank(world, rank)
    sizes = config.sizes(world)
    mesh = Mesh(np.arange(world).reshape(tuple(sizes[a] for a in AXIS_ORDER)), rank)
    mesh.make_groups(axes_list)
    logger.info(f"built mesh {mesh.shape} over {world} ranks")
    set_current_mesh(mesh)
    return mesh


def _hybrid_rank_array(sizes: dict, n_nodes: int, dcn_axes) -> np.ndarray:
    """JAX's ``create_hybrid_device_mesh`` over ranks grouped by node (node
    = rank // ranks per node): each DCN axis splits into a cross-node part
    (its gcd with the nodes left to cover) and a within-node remainder; each
    node's ranks fill an ICI block of the within-node shape, and the blocks
    tile the cross-node shape."""
    rem = n_nodes
    dcn_shape, ici_shape = [], []
    for a in AXIS_ORDER:
        if a in dcn_axes and sizes[a] > 1:
            cross = math.gcd(sizes[a], rem)
            rem //= cross
            dcn_shape.append(cross)
            ici_shape.append(sizes[a] // cross)
        else:
            dcn_shape.append(1)
            ici_shape.append(sizes[a])
    if rem != 1:
        raise ValueError(
            f"dcn axes {tuple(dcn_axes)} sizes cannot cover {n_nodes} slices "
            f"(mesh {sizes}); enlarge a dcn axis or pass different dcn_axes")
    per_node = math.prod(ici_shape)
    out = np.empty(tuple(d * i for d, i in zip(dcn_shape, ici_shape)), dtype=np.int64)
    for node, dcn_idx in enumerate(itertools.product(*(range(d) for d in dcn_shape))):
        block = np.arange(node * per_node, (node + 1) * per_node).reshape(ici_shape)
        sel = tuple(slice(d * i, (d + 1) * i) for d, i in zip(dcn_idx, ici_shape))
        out[sel] = block
    return out


def ranks_per_node(world: int) -> int:
    """How many ranks share a node: ``LOCAL_WORLD_SIZE`` (torchrun), else the
    launcher's world info (``DSTPU_WORLD_INFO``, {host: [slots]}, the first
    host's slot count), else all of them."""
    raw = os.environ.get("LOCAL_WORLD_SIZE", "").strip()
    if raw:
        return int(raw)
    info = os.environ.get("DSTPU_WORLD_INFO", "").strip()
    if info:
        from ..launcher.runner import decode_world_info

        slots = [len(v) if isinstance(v, (list, tuple)) else int(v) for v in decode_world_info(info).values()]
        if slots and sum(slots) == world:
            return slots[0]
    return world


def build_hybrid_mesh(config: Optional[MeshConfig] = None, dcn_axes: Sequence[str] = ("pipe", "data"),
                      world: Optional[int] = None, rank: Optional[int] = None,
                      local_world_size: Optional[int] = None, axes_list=ENGINE_AXES) -> Mesh:
    """Multi-node mesh: ``dcn_axes`` span nodes, every other axis stays
    inside a node, as JAX's ``build_hybrid_mesh`` lays devices out by slice.
    Ranks are grouped by node, ``local_world_size`` (default
    ``ranks_per_node``) to a node. One node is ``build_mesh``."""
    config = config or MeshConfig()
    world, rank = _world_and_rank(world, rank)
    local = int(local_world_size or ranks_per_node(world))
    n_nodes = world // local if local and world % local == 0 else 1
    if n_nodes <= 1:
        return build_mesh(config, world, rank, axes_list)
    sizes = config.sizes(world)
    mesh = Mesh(_hybrid_rank_array(sizes, n_nodes, dcn_axes), rank)
    mesh.make_groups(axes_list)
    logger.info(f"built hybrid mesh {mesh.shape} over {n_nodes} nodes of {local} ranks")
    set_current_mesh(mesh)
    return mesh


def single_device_mesh() -> Mesh:
    """A world of 1 (no process groups: its collectives are identities)."""
    mesh = Mesh(np.zeros((1,) * len(AXIS_ORDER), dtype=np.int64), 0)
    mesh._groups = {mesh._key(a): None for a in ENGINE_AXES}
    return mesh


def axis_size(mesh: Mesh, *axes: str) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def data_parallel_size(mesh: Mesh) -> int:
    """World size of the gradient-averaging group = data × fsdp."""
    return axis_size(mesh, *DP_AXES)


# JAX's sharding helpers: the port's sharding of a tensor is its spec, one
# entry per dimension (parallel/sharding.py)
def replicated(mesh: Mesh) -> tuple:
    return ()


def named_sharding(mesh: Mesh, *spec) -> tuple:
    return tuple(spec)


def batch_sharding(mesh: Mesh) -> tuple:
    """The input batch's spec: rows over (data, fsdp), sequence over context."""
    return (DP_AXES, "context")
