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

Tensor-parallel serving reads the same rules: ``heads``, ``mlp``,
``ffn_in`` and ``vocab`` go on ``model`` where it divides them, and the
serving engine's KV caches take ``kv_slot_cache_spec`` /
``kv_prefix_pool_spec`` (heads over ``model``). ``local_shape`` and
``local_slices`` give one rank's part of a tensor by its spec.
``constrain`` (JAX's ``with_sharding_constraint`` over a tree) is called
only by the training engine and comes with tensor-parallel training.

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


def shard_dim(spec: Spec) -> Optional[int]:
    """The one dimension a ZeRO spec splits (None: replicated). A spec that
    splits two dimensions needs tensor parallelism, which is not ported."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    if len(dims) > 1:
        raise NotImplementedError(f"spec {spec} splits {len(dims)} dimensions (tensor parallelism)")
    return dims[0] if dims else None


def spec_axes(spec: Spec) -> tuple:
    """The mesh axes a spec splits over, first major (() when replicated)."""
    d = shard_dim(spec)
    if d is None:
        return ()
    a = spec[d]
    return (a,) if isinstance(a, str) else tuple(a)


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
