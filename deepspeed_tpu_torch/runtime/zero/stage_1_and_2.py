"""ZeRO stages 0-2 over the data-parallel ranks (and the layouts stage 3
shares), named after the reference's ``runtime/zero/stage_1_and_2.py``.

In the JAX package this work is pjit's: the engine gives every parameter
and optimizer-state leaf a ``PartitionSpec`` (``parallel/sharding.py``)
and XLA inserts the collectives (``deepspeed_tpu/runtime/engine.py``
:298-322, :1242). Here each leaf's spec picks the dimension it is split on
(``LeafLayout``), the same one JAX splits for the same mesh shape, and the
collectives are issued explicitly through ``comm/``:

  stage 0  the gradients are all-reduced; everything stays replicated;
  stage 1  the gradients are all-reduced, then each rank updates its shard
           of the parameters with its shard of the optimizer state;
  stage 2  the gradients are reduce-scattered onto those shards;
  1 and 2  the updated shards are all-gathered back into the replicated
           fp32 parameters;
  stage 3  (``stage3.py``) the parameters are sharded too: the update is
           local and the gather happens in the forward.

Leaves are packed into buckets of ``reduce_bucket_size`` (reductions) and
``allgather_bucket_size`` (gathers) bytes, one collective per bucket. A
sharded leaf enters a bucket as its ``[n, numel / n]`` row view (row j =
shard j, the shard index JAX's layout gives it), so one reduce-scatter or
all-gather moves every leaf of the bucket whatever dimension it is split
on. The global gradient norm and the non-finite count are reduced over the
ZeRO axes in one 2-element all-reduce (``reduce_stats``), so clipping, the
fp16 loss scaler and the NaN guardrail see the same numbers on every rank.

Under tensor parallelism (a ``model`` axis above 1) each rank holds its
tensor-parallel slice of a leaf (``module_inject.TensorParallel``), and
ZeRO splits that slice over ``data``/``fsdp`` on the ZeRO dimension of the
leaf's spec: ``LeafLayout`` carries both splits, its ``shape`` is the
slice's and ``bounds`` the shard's place in the full leaf on both
dimensions. The data-axis collectives run among the ranks of this rank's
``model`` index; the norm, the non-finite count and LAMB's whole-leaf sums
add each distinct piece once over the whole data x model plane.

Under pipeline parallelism (a ``pipe`` axis above 1) a pipelined model's
stage leaves ``[S, K, ...]`` are split on their ``stage`` dimension over
``pipe`` (each rank holds its stage's ``[1, K, ...]``), as the model axis
splits its leaves, and ZeRO splits that slice; the leaves every stage holds
(the embeddings, the tied head, the final LayerNorm) have their gradients
summed over ``pipe`` after the data-axis reduction (the reference's
``ReduceTiedGrads``), so every stage takes the same update of them, and the
norm's plane takes in ``pipe`` too.

``overlap_comm`` is parsed and ignored, as in JAX (where XLA schedules):
the collectives here run in program order between the backward and the
update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ... import comm
from ...comm.mesh import DP_AXES, Mesh, world_plane
from ...ops.optimizers import tree_leaves, tree_map
from ...parallel import sharding as shd

ZERO_FALLBACK = ("fsdp", "data")


@dataclasses.dataclass
class LeafLayout:
    """One leaf's split: ``dim`` (None: replicated) over the ZeRO ``axes``
    (first major) into ``n`` shards, of which this rank holds shard
    ``index``; ``writer`` is whether this rank is the first holder of its
    shard (the rank that writes it into a checkpoint). Under tensor
    parallelism ``shape`` is this rank's slice of the ``full_shape`` leaf,
    split on ``tp_dim`` into ``tp_n`` slices of which it holds ``tp_index``;
    ``table`` lists every distinct shard's bounds in the full leaf in the
    order of their first holders' ranks, as a JAX save lists them. Under
    pipeline parallelism the slice is also split on ``pp_dim`` (the stage
    dimension) into ``pp_n`` parts of which it holds ``pp_index``."""

    shape: tuple
    spec: tuple
    dim: Optional[int]
    axes: tuple
    n: int
    index: int
    writer: bool
    full_shape: Optional[tuple] = None
    tp_dim: Optional[int] = None
    tp_n: int = 1
    tp_index: int = 0
    table: tuple = ()
    pp_dim: Optional[int] = None
    pp_n: int = 1
    pp_index: int = 0

    def __post_init__(self):
        if self.full_shape is None:
            self.full_shape = self.shape

    @property
    def sharded(self) -> bool:
        """Whether ZeRO splits the leaf (its collectives run for it)."""
        return self.dim is not None and self.n > 1

    @property
    def partial(self) -> bool:
        """Whether this rank holds less than the whole leaf (ZeRO, tensor or
        pipeline parallelism): a checkpoint writes it as shards."""
        return self.sharded or self.tp_n > 1 or self.pp_n > 1

    @property
    def slot(self) -> int:
        """This rank's shard's entry in ``table``."""
        return self.table.index(self.bounds())

    @property
    def shard_shape(self) -> tuple:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.n
        return tuple(s)

    def bounds(self, index: Optional[int] = None) -> list[list[int]]:
        """[[lo, hi], ...] per dimension of ZeRO shard ``index`` (default:
        this rank's) of this rank's tensor-parallel slice, in the full
        leaf: the checkpoint's shard index."""
        out = [[0, d] for d in self.full_shape]
        for d, n_i in ((self.tp_dim, self.tp_index), (self.pp_dim, self.pp_index)):
            if d is not None:
                s = self.shape[d]
                out[d] = [n_i * s, (n_i + 1) * s]
        if self.dim is not None:
            i = self.index if index is None else index
            s = self.shape[self.dim] // self.n
            out[self.dim] = [i * s, (i + 1) * s]
        return out

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full leaf ``t`` (a fresh tensor)."""
        if self.dim is None:
            return t.clone()
        s = self.shape[self.dim] // self.n
        return t.narrow(self.dim, self.index * s, s).clone()

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The full leaf as ``[n, numel / n]``: row j is shard j flattened."""
        d = self.dim
        return t.unflatten(d, (self.n, self.shape[d] // self.n)).movedim(d, 0).reshape(self.n, -1)

    def from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Inverse of ``rows``: ``[n, numel / n]`` -> the full leaf."""
        d, sh = self.dim, self.shard_shape
        return rows.reshape(self.n, *sh).movedim(0, d).reshape(self.shape)


def layout_tree(mesh: Mesh, axes_tree, shapes, rules, zero_fallback=None):
    """A ``LeafLayout`` per leaf of ``shapes`` (a tree of tensors or the
    full leaves' shapes), from its logical axes under ``rules``. The tree
    has the key order of ``shapes``, so its leaves line up with the
    parameters' (``tree_leaves``)."""
    all_ranks = sorted(int(r) for r in mesh.ranks.ravel())

    def one(ax, t):
        full = tuple(t.shape if hasattr(t, "shape") else t)
        spec = shd.spec_from_logical(ax, full, rules, mesh, zero_fallback=zero_fallback)
        tp_dim, dim = shd.split_dims(spec)
        pp_dim = shd.pipe_dim(spec)
        axes = shd.zero_axes(spec)
        tp_n = mesh.axis_size("model") if tp_dim is not None else 1
        pp_n = mesh.axis_size("pipe") if pp_dim is not None else 1
        shape = list(full)
        if tp_n > 1:
            shape[tp_dim] //= tp_n
        else:
            tp_dim = None
        if pp_n > 1:
            shape[pp_dim] //= pp_n
        else:
            pp_dim = None
        shape = tuple(shape)
        n = mesh.axis_size(axes) if axes else 1
        if n == 1:
            dim, axes = None, ()

        def key(r):  # rank r's shard: (its stage slice, its tensor-parallel slice, its ZeRO shard)
            return (mesh.axis_index("pipe", r) if pp_dim is not None else 0,
                    mesh.axis_index("model", r) if tp_dim is not None else 0,
                    mesh.axis_index(axes, r) if dim is not None else 0)

        mine = key(mesh.rank)
        lay = LeafLayout(shape, spec, dim, axes, n, mine[2], False, full, tp_dim, tp_n, mine[1],
                         pp_dim=pp_dim, pp_n=pp_n, pp_index=mine[0])
        firsts: dict = {}
        for r in all_ranks:
            firsts.setdefault(key(r), r)
        lay.writer = firsts[mine] == mesh.rank
        lay.table = tuple(dataclasses.replace(lay, pp_index=ppi, tp_index=tpi).bounds(zi) for ppi, tpi, zi in firsts)
        return lay

    def walk(ax, t):
        if isinstance(t, dict):
            return {k: walk(ax.get(k) if isinstance(ax, dict) else None, v) for k, v in t.items()}
        return one(ax, t)

    return walk(axes_tree, shapes)


def _buckets(items: list, nbytes, limit: float) -> list[list]:
    """Consecutive ``items`` in groups of at most ``limit`` bytes (an item
    larger than the limit is a bucket of its own)."""
    out, cur, size = [], [], 0
    for it in items:
        b = nbytes(it)
        if cur and size + b > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(it)
        size += b
    if cur:
        out.append(cur)
    return out


def _flat_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_tree(tensors: list, axes, limit: float) -> list:
    """Sum each tensor over ``axes``, packed into flat buckets of at most
    ``limit`` bytes, one all-reduce per bucket (and dtype)."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        for bucket in _buckets(idx, lambda i: _flat_bytes(tensors[i]), limit):
            flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
            red = comm.all_reduce(flat, axes, "sum")
            for i, piece in zip(bucket, red.split([tensors[i].numel() for i in bucket])):
                out[i] = piece.view(tensors[i].shape)
    return out


def reduce_scatter_rows(tensors: list, layouts: list, limit: float) -> list:
    """Sum each sharded full tensor over its layout's axes and keep this
    rank's shard, one reduce-scatter per bucket of ``[n, ·]`` row views."""
    out = [None] * len(tensors)
    groups: dict = {}
    for i, lay in enumerate(layouts):
        groups.setdefault((lay.axes, tensors[i].dtype), []).append(i)
    for (axes, _), idx in groups.items():
        for bucket in _buckets(idx, lambda i: _flat_bytes(tensors[i]), limit):
            rows = torch.cat([layouts[i].rows(tensors[i]) for i in bucket], dim=1)
            mine = comm.reduce_scatter(rows, axes, scatter_dimension=0)[0]
            for i, piece in zip(bucket, mine.split([tensors[i].numel() // layouts[i].n for i in bucket])):
                out[i] = piece.view(layouts[i].shard_shape)
    return out


def all_gather_rows(shards: list, layouts: list, limit: float) -> list:
    """Every rank's shard of each leaf gathered into the full leaf, one
    all-gather per bucket of flattened shards."""
    out = [None] * len(shards)
    groups: dict = {}
    for i, lay in enumerate(layouts):
        groups.setdefault((lay.axes, shards[i].dtype), []).append(i)
    for (axes, _), idx in groups.items():
        for bucket in _buckets(idx, lambda i: _flat_bytes(shards[i]) * layouts[i].n, limit):
            flat = torch.cat([shards[i].reshape(-1) for i in bucket])
            rows = comm.all_gather(flat.unsqueeze(0), axes, gather_dimension=0)
            for i, piece in zip(bucket, rows.split([shards[i].numel() for i in bucket], dim=1)):
                out[i] = layouts[i].from_rows(piece)
    return out


class ZeroRuntime:
    """The data-parallel side of the engine's update for one ZeRO stage.
    ``param_layouts`` splits the parameters (stage 3) and
    ``opt_layouts`` the optimizer state (and, at stages 1-2, the part of
    the replicated parameters each rank updates). The engine holds
    ``state["params"]`` as ``shard_params`` makes it and calls
    ``reduce_grads`` -> ``reduce_stats`` -> the optimizer on ``owned`` ->
    ``assemble``."""

    def __init__(self, mesh: Mesh, stage: int, axes_tree, shapes, reduce_bucket_size: float,
                 allgather_bucket_size: float):
        """``shapes``: the full parameter tree (or its leaves' shapes)."""
        self.mesh = mesh
        self.tp = mesh.shape.get("model", 1)
        self.pp = mesh.shape.get("pipe", 1)
        self.plane = world_plane(mesh.shape)  # the axes the world spans
        self.stage = stage
        param_rules, opt_rules = shd.zero_stage_rules(stage)
        zfb = ZERO_FALLBACK if stage >= 1 else None
        self.param_layouts = layout_tree(mesh, axes_tree, shapes, param_rules, zfb if stage >= 3 else None)
        self.opt_layouts = layout_tree(mesh, axes_tree, shapes, opt_rules, zfb)
        dp = mesh.axis_size(DP_AXES)
        for lay in tree_leaves(self.param_layouts) + tree_leaves(self.opt_layouts):
            if lay.sharded and lay.n != dp:  # a split the norm's one all-reduce would count twice
                raise NotImplementedError(f"a ZeRO split over {lay.axes} ({lay.n} shards) that is not the whole "
                                          f"data-parallel group ({dp} ranks)")
        self.reduce_bucket = float(reduce_bucket_size)
        self.gather_bucket = float(allgather_bucket_size)

    # -- state ----------------------------------------------------------
    def shard_params(self, params):
        """The full parameter tree -> what this rank holds (its shards at
        stage 3, the whole tree before)."""
        if self.stage < 3:
            return params
        return tree_map(lambda lay, p: lay.shard(p), self.param_layouts, params)

    def owned(self, params):
        """The part of ``state["params"]`` this rank's optimizer updates."""
        if self.stage in (1, 2):
            return tree_map(lambda lay, p: lay.shard(p) if lay.sharded else p, self.opt_layouts, params)
        return params

    def assemble(self, new_owned, params):
        """The updated owned part -> the new ``state["params"]`` (stages
        1-2: the shards all-gathered into the replicated leaves)."""
        if self.stage not in (1, 2):
            return new_owned
        lays = tree_leaves(self.opt_layouts)
        news = tree_leaves(new_owned)
        idx = [i for i, lay in enumerate(lays) if lay.sharded]
        full = all_gather_rows([news[i] for i in idx], [lays[i] for i in idx], self.gather_bucket)
        out = list(news)
        for i, f in zip(idx, full):
            out[i] = f
        it = iter(out)
        return tree_map(lambda _: next(it), params)

    def opt_state_layouts(self, opt_state) -> dict:
        """A layout per optimizer-state leaf: each params-shaped subtree
        takes the optimizer layouts, any other leaf is replicated."""
        return {k: self.opt_layouts if isinstance(v, dict) else None for k, v in opt_state.items()}

    # -- gradients ------------------------------------------------------
    def reduce_grads(self, grads):
        """Full local gradients (summed over this rank's micro-batches) ->
        the owned gradients, summed over the data-parallel ranks: stage 0
        all-reduced; stage 1 all-reduced, then this rank's shards; stage 2
        reduce-scattered onto them (replicated leaves all-reduced)."""
        gl = tree_leaves(grads)
        lays = tree_leaves(self.opt_layouts)
        if self.stage == 2:
            rs = [i for i, lay in enumerate(lays) if lay.sharded]
            ar = [i for i, lay in enumerate(lays) if not lay.sharded]
            out = [None] * len(gl)
            for i, g in zip(rs, reduce_scatter_rows([gl[i] for i in rs], [lays[i] for i in rs],
                                                    self.reduce_bucket)):
                out[i] = g
            for i, g in zip(ar, all_reduce_tree([gl[i] for i in ar], DP_AXES, self.reduce_bucket)):
                out[i] = g
        else:
            out = all_reduce_tree(gl, DP_AXES, self.reduce_bucket)
            if self.stage == 1:
                out = [lay.shard(g) if lay.sharded else g for lay, g in zip(lays, out)]
        if self.pp > 1:  # the leaves every stage holds: their stages' parts summed
            tied = [i for i, lay in enumerate(lays) if lay.pp_n == 1]
            for i, g in zip(tied, all_reduce_tree([out[i] for i in tied], "pipe", self.reduce_bucket)):
                out[i] = g
        it = iter(out)
        return tree_map(lambda _: next(it), grads)

    def grad_layouts(self) -> list:
        """The layout of each owned gradient leaf (in ``tree_leaves`` order)."""
        return tree_leaves(self.param_layouts if self.stage == 3 else self.opt_layouts)

    def _distinct(self, lays: list) -> list[float]:
        """Per leaf, 1.0 on the one rank of each group holding the same
        piece of it (the first data index of a leaf ZeRO does not split,
        the first model index of a leaf tensor parallelism does not split,
        the first stage of a leaf every stage holds), 0.0 elsewhere: summed
        over the world's plane, each piece of each leaf counts once."""
        dp0 = self.mesh.axis_index(DP_AXES) == 0
        tp0 = self.mesh.axis_index("model") == 0
        pp0 = self.mesh.axis_index("pipe") == 0
        return [float((lay.sharded or dp0) and (lay.tp_n > 1 or tp0) and (lay.pp_n > 1 or pp0)) for lay in lays]

    def reduce_stats(self, sq: list, nonfinite: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Per owned-leaf sums of squares and non-finite counts -> their
        totals over the whole model: the sharded leaves' parts summed over
        the ZeRO axes in one all-reduce, the replicated leaves' (the same on
        every rank) added once. Under tensor parallelism every leaf's piece
        is weighted by ``_distinct`` and summed over the data x model plane
        in one all-reduce, so a leaf split over ``model`` adds its slices
        and a replicated one counts once, not ``tp`` times."""
        lays = self.grad_layouts()
        if self.tp > 1 or self.pp > 1:
            w = torch.tensor(self._distinct(lays), dtype=torch.float32, device=sq[0].device)
            red = comm.all_reduce(torch.stack([(torch.stack(sq) * w).sum(), (torch.stack(nonfinite) * w).sum()]),
                                  self.plane, "sum")
            return red[0], red[1]
        part = [i for i, lay in enumerate(lays) if lay.sharded]
        rep = sorted(set(range(len(sq))) - set(part))
        dev = sq[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        tot_sq = torch.stack([sq[i] for i in rep]).sum() if rep else zero
        tot_bad = torch.stack([nonfinite[i] for i in rep]).sum() if rep else zero
        if part:
            red = comm.all_reduce(torch.stack([torch.stack([sq[i] for i in part]).sum(),
                                               torch.stack([nonfinite[i] for i in part]).sum()]), DP_AXES, "sum")
            tot_sq, tot_bad = tot_sq + red[0], tot_bad + red[1]
        return tot_sq, tot_bad

    def reduce_leaf_sq(self, a: list, b: list) -> tuple[list, list]:
        """Two per-owned-leaf sums of squares (LAMB's weights and update)
        -> each whole leaf's: the sharded leaves' summed over the ZeRO axes
        in one all-reduce, the replicated leaves' kept (under tensor
        parallelism every leaf's distinct pieces summed over the data x
        model plane, as ``reduce_stats`` adds them)."""
        if self.tp > 1 or self.pp > 1:
            w = torch.tensor(self._distinct(self.grad_layouts()), dtype=torch.float32, device=a[0].device)
            red = comm.all_reduce(torch.stack([torch.stack(a) * w, torch.stack(b) * w]), self.plane, "sum")
            return list(red[0].unbind()), list(red[1].unbind())
        part = [i for i, lay in enumerate(self.grad_layouts()) if lay.sharded]
        if not part:
            return a, b
        red = comm.all_reduce(torch.stack([torch.stack([a[i] for i in part]), torch.stack([b[i] for i in part])]),
                              DP_AXES, "sum")
        a, b = list(a), list(b)
        for j, i in enumerate(part):
            a[i], b[i] = red[0, j], red[1, j]
        return a, b

    # -- bookkeeping ----------------------------------------------------
    def fraction_held(self) -> dict:
        """Bytes-weighted share of the parameters and the optimizer state
        one rank holds (1/N of each sharded leaf, of its tensor-parallel
        slice)."""
        def share(lays):
            tot = sum(math.prod(lay.full_shape) for lay in tree_leaves(lays))
            mine = sum(math.prod(lay.shard_shape) for lay in tree_leaves(lays))
            return mine / max(tot, 1)

        sliced = self.tp > 1 or self.pp > 1
        return {"params": share(self.param_layouts) if self.stage == 3 or sliced else 1.0,
                "opt_state": share(self.opt_layouts) if self.stage or sliced else 1.0}
