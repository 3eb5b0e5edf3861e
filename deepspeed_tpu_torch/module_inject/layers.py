"""Tensor-parallel linear layers, the weight slicer and one rank's plan:
the port of ``deepspeed_tpu/module_inject/layers.py``.

The JAX package places each weight with a sharding and lets XLA derive the
collectives (GSPMD drives every device from one process). Here each
tensor-parallel rank is a process holding its own slice, and the
collectives are written out over the mesh's ``model`` process group
(``comm``), as the reference's Megatron-style layers write them:

  * ``LinearLayer`` (column-parallel): the weight's output dimension is
    split; the local product needs no collective and its output stays
    split (reference layers.py:44).
  * ``LinearAllreduce`` (row-parallel): the input dimension is split; the
    local products are partial sums, all-reduced over ``model``, and the
    bias is added ONCE, after the reduce (reference layers.py:17; JAX
    ``layers.py:77``). A bias added before the reduce would count ``tp``
    times.
  * ``ReplaceWithTensorSlicing``: cut a full host weight into one rank's
    slice, fused-QKV aware (reference replace_module.py:18).
  * ``TensorParallel``: one rank's plan for a model's parameter tree, each
    leaf's spec from ``spec_from_logical(logical_axes, shape,
    DEFAULT_TP_RULES, mesh)`` as the JAX engine computes it, so a leaf whose
    dimension ``model`` does not divide stays whole (and then no collective
    runs for it). The model (``models/transformer.py``) reads it from the
    parameter tree (``TPParams.tp``).

The all-reduces of partial sums run in fp32 whatever the compute dtype:
each rank's partial product is rounded to the compute dtype once, as a
dense product is, and the sum adds no further rounding before the result
is cast back.

Training differentiates through the collectives (``comm.copy_to_model``
and its conjugates): a column-parallel input enters through
``copy_to_model`` (its gradient all-reduced), a row-parallel epilogue and
the vocab-split embedding reduce through ``reduce_from_model`` (their
gradients pass as they are, so each rank's ``wte`` gradient lands on the
rows it owns), and the logits gather through ``gather_from_model``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import comm
from ..checkpoint.state_dict_factory import merge_query_key_value, split_query_key_value
from ..parallel import sharding as shd


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def row_epilogue(y: torch.Tensor, b: Optional[torch.Tensor], axis: str, split: bool) -> torch.Tensor:
    """A row-parallel product's epilogue: when the weight is ``split``, the
    local partial product ``y`` all-reduced over ``axis`` (in fp32, cast
    back); then the bias, added once."""
    if split:
        y = comm.reduce_from_model(y, axis)
    return y if b is None else y + b.to(y.dtype)


class LinearLayer:
    """Column-parallel linear: the weight [in, out] holds this rank's
    columns; the output stays split over ``axis`` (reference layers.py:44)."""

    def __init__(self, mesh=None, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis

    def _split(self) -> bool:
        return self.mesh is not None and self.mesh.shape.get(self.axis, 1) > 1

    def shard(self, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> dict:
        """This rank's columns of a full ``w`` (and of ``b``)."""
        params = {"w": w, "b": b} if b is not None else {"w": w}
        if self._split():
            n, i = self.mesh.axis_size(self.axis), self.mesh.axis_index(self.axis)
            params["w"] = w.chunk(n, dim=-1)[i].contiguous()
            if b is not None:
                params["b"] = b.chunk(n, dim=-1)[i].contiguous()
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self._split():
            x = comm.copy_to_model(x, self.axis)
        y = _matmul(x, params["w"])
        if params.get("b") is not None:
            y = y + params["b"].to(y.dtype)
        return y

    __call__ = apply


class LinearAllreduce:
    """Row-parallel linear: the weight [in, out] holds this rank's rows and
    ``x`` arrives split on its last dimension; the partial products are
    all-reduced over ``axis`` (in fp32), then the bias is added once
    (reference layers.py:9-20)."""

    def __init__(self, mesh=None, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis

    def _split(self) -> bool:
        return self.mesh is not None and self.mesh.shape.get(self.axis, 1) > 1

    def shard(self, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> dict:
        """This rank's rows of a full ``w``; the bias stays whole."""
        params = {"w": w, "b": b} if b is not None else {"w": w}
        if self._split():
            n, i = self.mesh.axis_size(self.axis), self.mesh.axis_index(self.axis)
            params["w"] = w.chunk(n, dim=0)[i].contiguous()
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return row_epilogue(_matmul(x, params["w"]), params.get("b"), self.axis, self._split())

    __call__ = apply


class ReplaceWithTensorSlicing:
    """Host-side weight slicer (reference replace_module.py:18): cut a full
    weight into rank ``mp_rank``'s slice of ``mp_size``, fused-QKV aware."""

    def __init__(self, mp_size: int = 1, mp_rank: int = 0, num_heads: int = 0, version: float = 2.0):
        self.mp_size = mp_size
        self.mp_rank = mp_rank
        self.num_heads = num_heads
        self.version = version

    def copy(self, full: np.ndarray, dim: int = -1, is_qkv: bool = False) -> np.ndarray:
        if self.mp_size == 1:
            return np.asarray(full)
        full = np.asarray(full)
        if is_qkv:
            return np.asarray(split_query_key_value(full, self.mp_size, self.mp_rank, num_heads=self.num_heads,
                                                    version=self.version))
        if full.shape[dim] % self.mp_size:
            raise ValueError(f"dimension {dim} of {full.shape} is not divisible by {self.mp_size}")
        return np.split(full, self.mp_size, axis=dim)[self.mp_rank]

    def merge(self, shards, is_qkv: bool = False, dim: int = -1) -> np.ndarray:
        if is_qkv:
            return np.asarray(merge_query_key_value(shards, num_heads=self.num_heads, version=self.version))
        return np.concatenate([np.asarray(s) for s in shards], axis=dim)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


class TensorParallel:
    """One rank's tensor-parallel plan over ``mesh``'s ``axis``: every
    parameter's spec (from the full shapes and the model's logical axes, by
    ``rules``), whether a leaf is split, its slice of a full tree, and the
    collectives the model's split layers need. Over a mesh with a ``pipe``
    axis above 1 a pipelined model's stage leaves are cut to the rank's
    stage too (``shard``/``gather``)."""

    def __init__(self, mesh, logical_axes: dict, full_shapes: dict, axis: str = "model",
                 rules=shd.DEFAULT_TP_RULES):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.specs = shd.make_param_specs(logical_axes, full_shapes, rules, mesh)
        self.full_shapes = shd.tree_map_axes(lambda ax, s: _shape(s), logical_axes, full_shapes)

    def spec(self, *path) -> tuple:
        node = self.specs
        for key in path:
            node = node[key]
        return node

    def split(self, *path) -> bool:
        """Whether the leaf at ``path`` is split over the plan's axis."""
        return any(self.axis in shd._entry_axes(e) for e in self.spec(*path))

    def slicer(self, num_heads: int = 0) -> ReplaceWithTensorSlicing:
        return ReplaceWithTensorSlicing(self.size, self.index, num_heads=num_heads)

    def _cuts(self, path) -> dict:
        """{dimension: its mesh axis} of the leaf at ``path``'s split
        dimensions: the plan's axis, and ``pipe`` for a pipelined model's
        stage dimension (the rank's stage's layers)."""
        spec = self.spec(*path)
        cuts = {}
        for d, e in enumerate(spec):
            axes = shd._entry_axes(e)
            if not axes:
                continue
            if axes not in ((self.axis,), ("pipe",)):
                raise NotImplementedError(f"leaf {'/'.join(path)} spec {spec}: only the {self.axis!r} and 'pipe' "
                                          "axes are ported")
            cuts[d] = axes[0]
        return cuts

    def shard_leaf(self, full, *path):
        """This rank's part of the full leaf at ``path`` (a tensor, cloned so
        the full one can go, or a numpy array)."""
        cuts = self._cuts(path)
        if not cuts:
            return full
        if isinstance(full, torch.Tensor):
            return full[shd.local_slices(tuple(full.shape), self.spec(*path), self.mesh)].clone()
        out = np.asarray(full)
        for d, axis in cuts.items():
            if axis == "pipe":
                out = np.split(out, self.mesh.axis_size("pipe"), axis=d)[self.mesh.axis_index("pipe")]
            else:
                out = self.slicer().copy(out, dim=d)
        return out

    def shard(self, tree: dict, path: tuple = ()) -> dict:
        """This rank's part of a full parameter tree (tensors or numpy)."""
        return {k: self.shard(v, path + (k,)) if isinstance(v, dict) else self.shard_leaf(v, *path, k)
                for k, v in tree.items()}

    def gather(self, tree: dict, path: tuple = ()) -> dict:
        """The full tree from every rank's part of it (the inverse of
        ``shard``; collective over the plan's axis and ``pipe``)."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self.gather(v, path + (k,))
                continue
            for d, axis in self._cuts(path + (k,)).items():
                v = comm.all_gather(v.contiguous(), axis, gather_dimension=d)
            out[k] = v
        return out

    # -- the model's split layers --------------------------------------------

    def heads(self, num_heads: int) -> int:
        """The attention heads this rank computes."""
        return num_heads // self.size if self.split("layers", "wq") else num_heads

    def head_slice(self, num_heads: int) -> slice:
        """This rank's heads in the model's head order (ALiBi slopes)."""
        n = self.heads(num_heads)
        return slice(self.index * n, (self.index + 1) * n) if n != num_heads else slice(None)

    def copy_in(self, x: torch.Tensor, *path) -> torch.Tensor:
        """The input of the column-parallel leaf at ``path``: through
        ``copy_to_model`` when the leaf is split (one copy per input, shared
        by every product that reads it), as it is otherwise."""
        return comm.copy_to_model(x, self.axis) if self.split(*path) else x

    def row(self, y: torch.Tensor, b: Optional[torch.Tensor], *path) -> torch.Tensor:
        """``row_epilogue`` of the leaf at ``path``'s local product ``y``."""
        return row_epilogue(y, b, self.axis, self.split(*path))

    def embed(self, wte: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of ``wte`` at ``tokens``: a vocab-split table looks up the
        ids in this rank's range, zeros elsewhere, and all-reduces, so every
        rank holds every row (exactly: one rank adds each value)."""
        if not self.split("wte"):
            return wte[tokens]
        n = wte.shape[0]
        local = tokens - self.index * n
        hit = (local >= 0) & (local < n)
        rows = wte[local.clamp(0, n - 1)] * hit[..., None].to(wte.dtype)
        return comm.reduce_from_model(rows, self.axis)

    def logits(self, logits: torch.Tensor, head_path: tuple) -> torch.Tensor:
        """This rank's vocab columns of the logits, all-gathered on the last
        dimension when the head is split: every rank holds the full [.., V]."""
        if self.split(*head_path):
            return comm.gather_from_model(logits, self.axis, dim=-1)
        return logits


class TPParams(dict):
    """A rank's parameter tree (a dict) carrying its ``TensorParallel``
    plan as ``.tp``: the model reads the plan where it reads the leaves."""

    def __init__(self, tree: dict, tp: TensorParallel):
        super().__init__(tree)
        self.tp = tp


def plan_of(params) -> Optional[TensorParallel]:
    """The plan a parameter tree carries (None: no tensor parallelism)."""
    return getattr(params, "tp", None)
