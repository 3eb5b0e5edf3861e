"""Logical-axis sharding rules: the ZeRO half of
``deepspeed_tpu/parallel/sharding.py``, numpy-only.

Every model parameter carries a tuple of logical axis names
(``Model.logical_axes()``); a rule table maps logical names to mesh axes;
``spec_from_logical`` turns one leaf's names and shape into a spec, a tuple
with one entry per dimension: None (replicated) or the mesh axis (or tuple
of axes, the first major) the dimension is split over. The port's ZeRO
runtime (``runtime/zero/``) shards each leaf on the dimension its spec
names, the dimension JAX's ``PartitionSpec`` names for the same mesh shape,
so the two packages' shard files line up.

Stage -> rules (as in JAX):
  stage 0: params/grads/opt replicated (grads all-reduced)
  stage 1: params replicated; optimizer state sharded over (fsdp, data)
  stage 2: + gradients reduce-scattered onto the same shards
  stage 3: params themselves sharded over (fsdp, data)

Tensor parallelism reads the same rules: ``heads``, ``mlp``, ``ffn_in``
and ``vocab`` go on ``model`` where it divides them (and a pipelined
model's ``stage`` on ``pipe``: each rank holds its stage's layers), and the serving
engine's KV caches take ``kv_slot_cache_spec`` / ``kv_prefix_pool_spec``
(heads over ``model``). Under ZeRO x TP a spec splits two dimensions: the
``model`` one and the ZeRO one (``split_dims`` names both); a rank holds
the ZeRO shard of its tensor-parallel slice. ``local_shape`` and
``local_slices`` give one rank's part of a tensor by its spec, and
``constrain`` (JAX's ``with_sharding_constraint`` over a tree) checks or
cuts a tree's leaves to those parts where the training engine places them.

A mesh here is anything with a ``shape`` mapping (a ``comm.Mesh``) or the
mapping itself; ``local_slices`` also needs a rank's coordinates, so a
``comm.Mesh``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

MeshAxes = Union[None, str, tuple[str, ...]]
Rules = Sequence[tuple[str, MeshAxes]]
Spec = tuple

# logical axis -> mesh axis, for transformer models ('model' = tensor
# parallel; 'fsdp' = the ZeRO-3 axis; None = replicated)
DEFAULT_TP_RULES: Rules = (
    ("stage", "pipe"),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv", None),
    ("mlp", "model"),
    ("ffn_in", "model"),
    ("embed", None),
    ("layers", None),
    # EP rides the DP ranks (reference: utils/groups.py:109)
    ("expert", ("data", "fsdp")),
    ("context", "context"),
    ("batch", ("data", "fsdp")),
)

ZERO_AXES = ("fsdp", "data")


def _shape_of(mesh) -> dict:
    return dict(getattr(mesh, "shape", mesh))


def spec_from_logical(logical_axes: Optional[tuple], shape: tuple, rules: Rules, mesh,
                      zero_fallback: MeshAxes = None) -> Spec:
    """One parameter's spec: each logical axis's rule, skipping a mesh axis
    that does not divide the dimension (it stays replicated).
    ``zero_fallback``: ZeRO axes that must land somewhere if possible (the
    reference's flat-buffer partition shards every tensor,
    stage_1_and_2.py:93): when none of them was placed by the rules, the
    largest still-unsharded divisible dimension takes them. Trailing Nones
    are dropped, as ``PartitionSpec`` prints them."""
    ms = _shape_of(mesh)
    if logical_axes is None:
        return ()
    assert len(logical_axes) == len(shape), f"{logical_axes} vs {shape}"
    table = dict(rules)
    used: set[str] = set()
    out: list = []
    for name, dim in zip(logical_axes, shape):
        axes = table.get(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in ms and a not in used)
        size = int(np.prod([ms[a] for a in axes])) if axes else 1
        if axes and size > 1 and dim % size == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    if zero_fallback is not None:
        fb = (zero_fallback,) if isinstance(zero_fallback, str) else tuple(zero_fallback)
        fb = tuple(a for a in fb if a in ms and a not in used)
        size = int(np.prod([ms[a] for a in fb])) if fb else 1
        if fb and size > 1:
            candidates = [(shape[i], i) for i in range(len(shape))
                          if out[i] is None and shape[i] % size == 0 and shape[i] >= size]
            if candidates:
                _, i = max(candidates)
                out[i] = fb if len(fb) > 1 else fb[0]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def zero_stage_rules(stage: int, base: Rules = DEFAULT_TP_RULES) -> tuple[Rules, Rules]:
    """(param_rules, optstate_rules) for a ZeRO stage: the optimizer state
    (fp32 masters, moments) puts the ZeRO axes on 'embed'; stage 3 puts the
    parameters there too."""
    base = tuple(base)
    if stage == 0:
        return base, base
    opt = tuple((k, ZERO_AXES) if k == "embed" else (k, v) for k, v in base)
    if stage < 3:
        return base, opt
    return opt, opt


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x))


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(logical_axes, *leaves)`` over a logical-axes tree (tuples and
    None are leaves) and trees of the same nesting."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees)) for k in axes_tree}


def make_param_specs(logical_axes_tree, shapes_tree, rules: Rules, mesh, zero_fallback: MeshAxes = None):
    """``spec_from_logical`` over a model's tree (shapes: tuples or tensors)."""
    return tree_map_axes(lambda ax, shp: spec_from_logical(ax, tuple(shp.shape if hasattr(shp, "shape") else shp),
                                                           rules, mesh, zero_fallback=zero_fallback),
                         logical_axes_tree, shapes_tree)


# the mesh axes a training spec may split over: tensor parallelism's,
# pipeline parallelism's (the ``stage`` dimension) and ZeRO's (``context``
# is not ported)
_PORTED_AXES = ("pipe", "model", "data", "fsdp")


def split_dims(spec: Spec) -> tuple[Optional[int], Optional[int]]:
    """(the dimension ``spec`` splits over ``model``, the dimension it splits
    over the ZeRO axes), each None when there is none; a ``pipe`` dimension
    (``pipe_dim``) is neither. Raises on an axis that is not ported
    (``context``), on ``model`` or ``pipe`` sharing a dimension with another
    axis and on two ZeRO dimensions."""
    model_dim = zero_dim = None
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        bad = [a for a in axes if a not in _PORTED_AXES]
        if bad:
            raise NotImplementedError(f"spec {spec} splits over {bad}: not ported to deepspeed_tpu_torch yet")
        for solo in ("model", "pipe"):
            if solo in axes and len(axes) > 1:
                raise NotImplementedError(f"spec {spec} splits one dimension over {solo} and {axes}")
        if axes == ("pipe",):
            continue
        if "model" in axes:
            model_dim = d
        elif zero_dim is not None:
            raise NotImplementedError(f"spec {spec} splits two dimensions over the ZeRO axes")
        else:
            zero_dim = d
    return model_dim, zero_dim


def pipe_dim(spec: Spec) -> Optional[int]:
    """The dimension ``spec`` splits over ``pipe`` (a pipelined model's
    ``stage`` dimension), or None."""
    return next((d for d, e in enumerate(spec) if _entry_axes(e) == ("pipe",)), None)


def zero_axes(spec: Spec) -> tuple:
    """The ZeRO axes a spec splits over, first major (() when none)."""
    d = split_dims(spec)[1]
    return () if d is None else _entry_axes(spec[d])


def constrain(tree, mesh, specs_tree):
    """Each leaf of ``tree`` as this rank's part under its entry of
    ``specs_tree`` (JAX ``sharding.py:185``, where XLA moves the data; here
    each rank holds its part). An entry is a spec, taken over the leaf as
    the global array, or a layout (anything with ``spec``, ``full_shape``
    and ``shard_shape``: the ZeRO runtime's ``LeafLayout``), which also
    knows the part's shape: a leaf that is already that part, or whose
    entry is replicated (None or ``()``), is returned as it is; a global
    leaf is cut to the part; any other shape raises."""
    if isinstance(tree, dict):
        return {k: constrain(v, mesh, specs_tree.get(k) if isinstance(specs_tree, dict) else specs_tree)
                for k, v in tree.items()}
    entry = specs_tree
    if entry is None or (isinstance(entry, tuple) and not any(e is not None for e in entry)):
        return tree
    if hasattr(entry, "full_shape"):
        spec, full, part = entry.spec, tuple(entry.full_shape), tuple(entry.shard_shape)
    else:
        spec, full = entry, tuple(tree.shape)
        part = local_shape(full, spec, mesh)
    shape = tuple(tree.shape)
    if shape == part:
        return tree
    if shape == full:
        return tree[local_slices(full, spec, mesh)]
    raise ValueError(f"constrain: a leaf of shape {shape} is neither the global {full} nor this rank's "
                     f"part {part} under {spec}")


def kv_slot_cache_spec(mesh, n_slots: int, num_heads: int) -> Spec:
    """The spec of the serving engine's slot KV cache [L, n_slots, Smax, H,
    Dh] (JAX ``sharding.py:154``): slots over the data axes when their
    product divides ``n_slots``, heads over ``model`` when it divides
    ``num_heads``; an axis that does not divide leaves its dimension whole.
    Five entries, as JAX's ``PartitionSpec`` holds them."""
    ms = _shape_of(mesh)
    batch_axes = tuple(a for a in ("data", "fsdp") if ms.get(a, 1) > 1)
    size = int(np.prod([ms[a] for a in batch_axes])) if batch_axes else 1
    slot_axes = batch_axes if (batch_axes and size > 1 and n_slots % size == 0) else ()
    model_size = ms.get("model", 1)
    head_ax = "model" if (model_size > 1 and num_heads % model_size == 0) else None
    slot = slot_axes if len(slot_axes) > 1 else (slot_axes[0] if slot_axes else None)
    return (None, slot, None, head_ax, None)


def kv_prefix_pool_spec(mesh, n_prefix_slots: int, num_heads: int) -> Spec:
    """The prefix pool [L, n_prefix_slots, Pmax, H, Dh] takes the slot
    cache's rule (JAX ``sharding.py:172``), so the copies between the two
    stay on each rank's own heads."""
    return kv_slot_cache_spec(mesh, n_prefix_slots, num_heads)


def _entry_axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """The shape of one rank's part of a tensor of ``shape`` under
    ``spec``: each split dimension divided by its axes' product."""
    ms = _shape_of(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = int(np.prod([ms[a] for a in _entry_axes(entry)])) if entry is not None else 1
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} is not divisible by {n} ({entry})")
        out[d] //= n
    return tuple(out)


def local_slices(shape: tuple, spec: Spec, mesh, rank=None) -> tuple:
    """The index (one slice a dimension) of ``rank``'s part (default: the
    mesh's own rank) of a tensor of ``shape`` under ``spec``; over an axis
    tuple the first axis is major, as JAX tiles it."""
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        axes = _entry_axes(entry)
        n = mesh.axis_size(axes)
        i = mesh.axis_index(axes, rank)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)
