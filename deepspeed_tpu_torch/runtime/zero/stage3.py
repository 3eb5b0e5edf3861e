"""ZeRO stage 3: parameters sharded over the data-parallel ranks and
gathered a layer at a time, named after the reference's
``runtime/zero/stage3.py`` (+ ``partitioned_param_coordinator.py``).

In the JAX package the stage-3 specs make XLA all-gather each parameter at
its use and reduce-scatter its gradient. Here the mechanism is the memory tiers'
``ParamStreamer`` (``param_offload.py``) with its transport replaced:

* ``_copy_in`` all-gathers one layer's slices (or the top-level leaves,
  once per micro-batch, the tied ``wte`` once for both uses), cast to the
  compute dtype first so the gather moves 16-bit bytes, one collective per
  layer (all of the layer's sharded slices packed as ``[n, ·]`` rows);
* the streamer's saved-tensor hooks replace each saved gathered copy by a
  note and gather the layer again for the backward (and a remat
  recompute), prefetching the next layer in the phase's order, as they
  re-copied a host layer;
* ``_put_grads`` reduce-scatters each layer's gradient, in fp32, into this
  rank's fp32 gradient shard: copied by the step's first micro-batch,
  added by later ones.

Under ``offload_param`` (the cpu tier, ``offload.py``) the shards the
streamer reads are the tier's compute-dtype copies in host memory: each
gather first copies this rank's slices to the device, and the gradient
shards it fills are fp32 host buffers the tier's host update reads.

Under tensor parallelism the shards are of each rank's tensor-parallel
slices, and a gather rebuilds those slices, never the full leaf: the ZeRO
collectives run among the ranks of this rank's ``model`` index.

A stacked leaf whose spec splits the layer dimension itself (possible only
when that is its largest divisible dimension) has each layer on one rank:
that layer is broadcast from its owner, and its gradient all-reduced and
kept by the owner. A replicated leaf's gradient is all-reduced.
"""

from __future__ import annotations

import dataclasses
import torch

from ... import comm
from ...comm.mesh import DP_AXES
from ...ops.optimizers import tree_map
from .host_optimizer import host_empty
from .param_offload import LAYERS, ParamStreamer, StreamedParams
from .stage_1_and_2 import LeafLayout, all_gather_rows, all_reduce_tree, reduce_scatter_rows


def _slice_layout(lay: LeafLayout) -> LeafLayout:
    """The layout of one layer's slice of a stacked ``[L, ...]`` leaf (its
    ZeRO split; the tensor-parallel slice is what the gather rebuilds)."""
    base = dict(shape=lay.shape[1:], full_shape=lay.shape[1:], tp_dim=None, tp_n=1, tp_index=0, table=())
    if lay.dim is None or lay.dim == 0:
        return dataclasses.replace(lay, spec=(), dim=None, axes=(), n=1, index=0, **base)
    return dataclasses.replace(lay, spec=lay.spec[1:], dim=lay.dim - 1, **base)


class GatheredParamStreamer(ParamStreamer):
    """The stage-3 streamer over this rank's fp32 parameter shards
    (``params``) and fp32 gradient shards (``grads``), of the same tree,
    laid out by ``layouts`` (``ZeroRuntime.param_layouts``)."""

    def __init__(self, params: dict, grads: dict, device, layouts: dict, compute_dtype,
                 gather_bucket: float, reduce_bucket: float):
        super().__init__(params, grads, device)
        self.compute_dtype = compute_dtype
        self.top_layouts = {k: v for k, v in layouts.items() if k != LAYERS}
        self.stack_layouts = layouts.get(LAYERS, {})
        self.slice_layouts = {n: _slice_layout(lay) for n, lay in self.stack_layouts.items()}
        if self.stack_layouts:  # the stacks' full depth (a shard of one split on its layers is shorter)
            self.num_layers = next(iter(self.stack_layouts.values())).shape[0]
        self.gather_bucket, self.reduce_bucket = gather_bucket, reduce_bucket
        self.gathered_bytes = 0  # compute-dtype bytes the gathers produced
        self.reduced_bytes = 0  # fp32 gradient bytes reduce-scattered

    def _layouts(self, key) -> dict:
        return self.top_layouts if key is None else self.slice_layouts

    def _owner(self, name: str, layer: int) -> int:
        """The index (along the leaf's axes) of the rank holding ``layer`` of
        a stack split on its layer dimension."""
        lay = self.stack_layouts[name]
        return layer // (lay.shape[0] // lay.n)

    def _local_layer(self, name: str, layer: int) -> int:
        lay = self.stack_layouts[name]
        return layer % (lay.shape[0] // lay.n)

    def _split_on_layers(self, key, name) -> bool:
        return key is not None and self.stack_layouts[name].dim == 0 and self.stack_layouts[name].n > 1

    def _slices_of(self, tree, key):
        if key is None:
            return self._top_items(tree)
        out = []
        for n, s in tree[LAYERS].items():
            if self._split_on_layers(key, n):
                out.append((n, s[self._local_layer(n, key)] if self._owns(n, key) else None))
            else:
                out.append((n, s[key]))
        return out

    def _owns(self, name: str, layer: int) -> bool:
        return self._owner(name, layer) == self.stack_layouts[name].index

    # -- the transport ----------------------------------------------------
    def _copy_in(self, key):
        """All-gather ``key``'s slices in the compute dtype -> (names, device
        tensors, None). The fetch runs outside the active dispatch modes: a
        selective-remat region recomputes its layer's compute, and a layer
        prefetched from the region before it must not count among its ops."""
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            return self._gather(key)

    def _gather(self, key):
        lays = self._layouts(key)
        src = self._slices_of(self.params, key)
        names = [n for n, _ in src]
        outs: list = [None] * len(src)
        cdt = self.compute_dtype
        gather = [i for i, (n, t) in enumerate(src) if lays[n].sharded and not self._split_on_layers(key, n)]
        if gather:
            shards = [src[i][1].to(self.device, cdt) for i in gather]
            full = all_gather_rows(shards, [lays[names[i]] for i in gather], self.gather_bucket)
            seen: set = set()
            for i, f in zip(gather, full):
                if _storage(f) in seen:  # each leaf owns its storage: the hooks find saved copies by it
                    f = f.clone()
                seen.add(_storage(f))
                outs[i] = f
                self.gathered_bytes += f.numel() * f.element_size()
        for i, (n, t) in enumerate(src):
            if outs[i] is not None:
                continue
            if self._split_on_layers(key, n):
                lay = self.stack_layouts[n]
                buf = (t.to(self.device, cdt) if t is not None else
                       torch.empty(self.slice_layouts[n].shape, dtype=cdt, device=self.device))
                outs[i] = comm.broadcast_in_axis(buf, lay.axes, src_index=self._owner(n, key))
            else:
                outs[i] = t.to(self.device, cdt, copy=True)
        return names, outs, None

    def _put_grads(self, key, names, grads) -> None:
        """Reduce-scatter ``key``'s gradients (fp32) into this rank's
        gradient shards, copied on the step's first micro-batch and added
        after it."""
        lays = self._layouts(key)
        src = dict(self._slices_of(self.params, key))
        g32 = [torch.zeros(lays[n].shape if not self._split_on_layers(key, n) else self.slice_layouts[n].shape,
                           dtype=torch.float32, device=self.device) if g is None else g.float()
               for n, g in zip(names, grads)]
        red: list = [None] * len(names)
        rs = [i for i, n in enumerate(names) if lays[n].sharded and not self._split_on_layers(key, n)]
        ar = [i for i in range(len(names)) if i not in set(rs)]
        if rs:
            for i, g in zip(rs, reduce_scatter_rows([g32[i] for i in rs], [lays[names[i]] for i in rs],
                                                    self.reduce_bucket)):
                red[i] = g
                self.reduced_bytes += g32[i].numel() * 4
        if ar:
            for i, g in zip(ar, all_reduce_tree([g32[i] for i in ar], DP_AXES, self.reduce_bucket)):
                red[i] = g
        dst_of = dict(self._slices_of(self.grads, key))
        for i, name in enumerate(names):
            if key is not None and self._split_on_layers(key, name) and src[name] is None:
                continue  # another rank owns this layer of the stack
            dst = dst_of[name]
            first = (key, name) not in self._written
            self._written.add((key, name))
            dst.copy_(red[i]) if first else dst.add_(red[i].to(dst.device))

    def finish(self) -> dict:
        for key in [None, *range(self.num_layers)]:
            for name, dst in self._slices_of(self.grads, key):
                if dst is not None and (key, name) not in self._written:
                    dst.zero_()
        return self.grads


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Zero3Params:
    """The engine's side of stage 3: the fp32 gradient shards, and the
    streamer that hands the model its gathered layers."""

    def __init__(self, params: dict, device, layouts: dict, compute_dtype, gather_bucket: float,
                 reduce_bucket: float, host_grads: bool = False, tp=None):
        """``host_grads``: the gradient shards in host memory (pinned on a
        card), for the tier's host update under ``offload_param``; ``tp``:
        the tensor-parallel plan the model reads from its parameters."""
        self.device = device
        self.tp = tp
        if host_grads:
            pin = torch.device(device).type == "cuda"
            grads = tree_map(lambda p: host_empty(p.shape, torch.float32, pin).zero_(), params)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        self.streamer = GatheredParamStreamer(params, grads, device, layouts, compute_dtype, gather_bucket,
                                              reduce_bucket)

    def bind(self, params: dict) -> None:
        """Point the streamer at the current parameter shards (the update
        replaces ``state["params"]``)."""
        self.streamer.params = params

    def view(self, params: dict) -> StreamedParams:
        self.bind(params)
        view = self.streamer.view()
        if self.tp is not None:
            view.tp = self.tp
        return view

    def begin_step(self, params: dict) -> StreamedParams:
        self.streamer.begin_step()
        return self.view(params)

    def backward_micro(self, model, view, mb: dict, loss_scale, kw: dict) -> torch.Tensor:
        with self.streamer.micro_batch():
            loss = model.loss(view, mb, **kw)
            self.streamer.phase = "backward"
            (loss * loss_scale).backward()
        return loss.detach().float()

    def evaluate(self, fn, view):
        """``fn(view)`` without a gradient (the gathers still run)."""
        with torch.no_grad(), self.streamer.micro_batch():
            return fn(view)

    def gradients(self) -> dict:
        return self.streamer.finish()
