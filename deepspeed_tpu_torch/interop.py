"""Carry the JAX package's parameters and engine state into the port.

``params_from_jax`` takes the JAX ``models/transformer.init`` parameter tree
with its leaves already turned into numpy arrays (for example
``jax.tree.map(numpy.asarray, params)``) and returns the same tree of torch
tensors: ``wte``, ``wpe``, the stacked ``layers`` leaves
(``wq``/``wk``/``wv``/``wo``/``wi``/``wo_mlp``, biases, LayerNorms),
``lnf_*`` and the optional ``lm_head``. The layouts are the same in both
packages, so nothing is transposed.

``shard_state_from_jax`` gives one rank its part of a JAX engine's
``params`` and ``opt`` (the fp32 masters and the moments) by the port
engine's layouts: its tensor-parallel slice of each leaf, then its ZeRO
shard of that, under ZeRO x TP. ``tp_params_from_jax`` gives one tensor-
parallel rank its slices of the JAX parameters, and with ``opt=`` its
slices of the optimizer state too, by the JAX engine's specs (for a
pipelined model over a ``pipe`` axis also the rank's stage of each
``[S, K, ...]`` layer leaf, as the JAX ``PipelineEngine`` places it)
(``init_inference(..., params=)`` and ``initialize(..., model_parameters=)``
take either the full tree or these slices' ``TPParams``).
``state_from_jax`` converts any subtree of a JAX engine's state (numpy
leaves, bfloat16 ones included, their dtypes kept), and
``load_offload_state`` carries a JAX offload engine's ``params``,
``master`` and ``opt`` into the port engine's memory tier, in place in its
(pinned) buffers. The NVMe tier's masters and moments travel as files: the
JAX ``NvmeTieredOptimizer.save_state`` directory loads with the port's
``load_state``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    """A numpy leaf as a torch tensor of the same dtype (a writable copy);
    a bfloat16 array (``ml_dtypes``) keeps its bits."""
    a = np.array(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cpu", dtype=torch.float32):
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device``; floating leaves are cast to ``dtype``, integer leaves keep
    their type."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    t = _tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


def state_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device``, each in its own dtype."""
    if isinstance(tree, dict):
        return {k: state_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def load_offload_state(engine, jax_state: dict) -> None:
    """Copy a JAX offload engine's ``params``, ``master`` and ``opt`` (numpy
    trees, e.g. ``jax.tree.map(numpy.asarray, jax_engine.state)``) into
    ``engine``'s tier buffers in place."""
    if engine.tier is None:
        raise ValueError("the engine has no memory tier (zero_optimization.offload_optimizer is none)")
    loaded = {k: state_from_jax(jax_state[k]) for k in ("params", "master", "opt") if k in jax_state}
    engine.state = engine.tier.adopt({**engine.state, **loaded}, has_master="master" in loaded)


def shard_state_from_jax(engine, jax_state: dict) -> dict:
    """A JAX engine's ``params`` and ``opt`` (numpy trees, e.g.
    ``jax.tree.map(numpy.asarray, jax_engine.state)``) as ``engine``'s rank
    holds them under its ZeRO layouts (``engine.zero``): its shard of each
    sharded leaf, the rest whole, on the engine's device. Assign the result
    into ``engine.state`` to start both packages from one state."""
    from .ops.optimizers import tree_map

    z, tp = engine.zero, getattr(engine, "tp", None)
    out = {}
    if "params" in jax_state:
        full = params_from_jax(jax_state["params"], engine.device)
        if tp is not None:
            full = tp.shard(full)
        out["params"] = z.shard_params(full) if z is not None else full
    if "opt" in jax_state:
        opt = {}
        for k, sub in jax_state["opt"].items():
            t = state_from_jax(sub, engine.device)
            if tp is not None and isinstance(t, dict):
                t = tp.shard(t)
            if z is not None and isinstance(t, dict) and z.stage:
                t = tree_map(lambda lay, x: lay.shard(x) if lay.sharded else x, z.opt_layouts, t)
            opt[k] = t
        out["opt"] = opt
    return out


def tp_params_from_jax(tree, model, mesh, device="cpu", dtype=torch.float32, opt=None):
    """The JAX package's parameters (numpy leaves) as ``mesh``'s rank holds
    them under tensor (and pipeline) parallelism: each leaf's slice by its spec
    (``spec_from_logical`` over ``DEFAULT_TP_RULES``, as the JAX engine
    places it), cut by ``ReplaceWithTensorSlicing``, then as
    ``params_from_jax`` converts it. Returns a ``TPParams`` carrying the
    rank's plan (``model`` is the port's ``Model``). With ``opt`` (a JAX
    engine's ``opt`` tree: ``m``/``v`` or the masters, each params-shaped,
    beside scalar leaves) returns (params, opt) with each params-shaped
    subtree sliced the same way, its dtype kept; a ZeRO engine takes its
    shards of these slices (``shard_state_from_jax``)."""
    from .module_inject.layers import TensorParallel, TPParams

    tp = TensorParallel(mesh, model.logical_axes(), tree)
    params = TPParams(params_from_jax(tp.shard(tree), device, dtype), tp)
    if opt is None:
        return params
    return params, {k: state_from_jax(tp.shard(v) if isinstance(v, dict) else v, device) for k, v in opt.items()}
