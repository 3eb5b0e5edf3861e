"""Carry the JAX package's parameters and engine state into the port.

``params_from_jax`` takes the JAX ``models/transformer.init`` parameter tree
with its leaves already turned into numpy arrays (for example
``jax.tree.map(numpy.asarray, params)``) and returns the same tree of torch
tensors: ``wte``, ``wpe``, the stacked ``layers`` leaves
(``wq``/``wk``/``wv``/``wo``/``wi``/``wo_mlp``, biases, LayerNorms),
``lnf_*`` and the optional ``lm_head``. The layouts are the same in both
packages, so nothing is transposed.

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
