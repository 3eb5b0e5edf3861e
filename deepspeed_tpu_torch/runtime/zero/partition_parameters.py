"""``zero.Init`` / ``GatheredParameters``: ZeRO-3's construction-time
sharding API, ported from ``deepspeed_tpu/runtime/zero/partition_parameters.py``
(reference ``runtime/zero/partition_parameters.py:537`` and ``:1512``).

    with zero.Init(mesh=mesh) as zinit:
        params = zinit.materialize(model.init, generator, model.logical_axes())

    with zero.GatheredParameters(params) as full:
        inspect(full)            # whole copies, freed on exit

``materialize`` makes the leaves one at a time from the seeded generator
(an ``init_fn`` that takes ``place``, as ``Model.init`` does, hands each
leaf over as it is made) and keeps only this rank's shard of each, on the
dimension the stage-3 rules pick (``parallel/sharding.py``), so no rank
holds more than one whole leaf at a time. Each shard carries its layout as
``ds_layout`` (DeepSpeed's ZeRO-3 parameters carry ``ds_*`` attributes),
which ``GatheredParameters`` reads to all-gather it; with
``modifier_rank`` set, the edits that rank made to the gathered copies are
broadcast and sharded back into the tree on exit.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch

from ... import comm
from ...comm.mesh import DP_AXES, current_mesh
from ...parallel import sharding as shd
from .stage_1_and_2 import ZERO_FALLBACK, layout_tree


def _lookup(tree, path):
    for p in path:
        if tree is None:
            return None
        tree = tree.get(p) if isinstance(tree, dict) else None
    return tree


class Init:
    """Materialize parameters directly into their ZeRO-3 shards."""

    def __init__(self, mesh=None, config_dict_or_path=None, dtype=None, enabled: bool = True, device=None,
                 **_compat):
        self.mesh = mesh if mesh is not None else current_mesh()
        self.dtype = dtype
        self.enabled = enabled
        self.device = device
        stage = 3
        if isinstance(config_dict_or_path, dict):
            stage = (config_dict_or_path.get("zero_optimization", {}) or {}).get("stage", 3)
        self.param_rules, _ = shd.zero_stage_rules(stage)
        self.layouts = None  # the last materialize's layout tree

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None and t.is_floating_point():
            t = t.to(self.dtype)
        return t if self.device is None else t.to(self.device)

    def materialize(self, init_fn: Callable, generator, logical_axes: Optional[dict] = None):
        """``init_fn(generator)`` with every leaf born sharded (a leaf
        without logical axes stays whole)."""
        if not self.enabled or self.mesh is None:
            out = init_fn(generator)
            return _map(self._cast, out)
        layouts: dict = {}

        def place(path, t):
            ax = _lookup(logical_axes, path) if logical_axes is not None else None
            lay = layout_tree(self.mesh, ax, t, self.param_rules, ZERO_FALLBACK)
            node = layouts
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = lay
            shard = self._cast(lay.shard(t) if lay.sharded else t)
            shard.ds_layout = lay
            return shard

        if "place" in inspect.signature(init_fn).parameters:
            params = init_fn(generator, place=place)
        else:  # an init_fn that makes the whole tree: sharded after it (peak: the model)
            params = _map_paths(place, init_fn(generator))
        self.layouts = layouts
        return params


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


class GatheredParameters:
    """Whole copies of ``Init``-sharded parameters for the body of the
    ``with`` (reference :1512). With ``modifier_rank`` (a global rank), the
    copies that rank holds at exit, edits included, are broadcast and
    sharded back into ``params`` (in place, as the JAX package does)."""

    def __init__(self, params, modifier_rank: Optional[int] = None, enabled: bool = True, **_compat):
        self.params = params
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self.gathered = None

    def __enter__(self):
        if not self.enabled:
            self.gathered = self.params
            return self.gathered

        def gather(t):
            lay = getattr(t, "ds_layout", None)
            if lay is None or not lay.sharded:
                return t
            return comm.all_gather(t, lay.axes, gather_dimension=lay.dim)

        self.gathered = _map(gather, self.params)
        return self.gathered

    def __exit__(self, *exc):
        if self.enabled and self.modifier_rank is not None and self.gathered is not None:
            _scatter_back(self.params, self.gathered, self.modifier_rank)
        self.gathered = None
        return False


def _scatter_back(params: dict, gathered: dict, modifier_rank: int) -> None:
    mesh = current_mesh()
    for k in list(params):
        old, new = params[k], gathered[k]
        if isinstance(old, dict):
            _scatter_back(old, new, modifier_rank)
            continue
        lay = getattr(old, "ds_layout", None)
        full = new
        if mesh is not None and mesh.world > 1:
            full = comm.broadcast_in_axis(new.contiguous(), DP_AXES,
                                          src_index=mesh.members(DP_AXES).index(modifier_rank))
        shard = lay.shard(full) if lay is not None and lay.sharded else full.clone()
        shard = shard.to(old.dtype)
        if lay is not None:
            shard.ds_layout = lay
        params[k] = shard
