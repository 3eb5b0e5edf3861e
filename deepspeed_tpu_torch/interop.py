"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX ``models/transformer.init`` parameter tree
with its leaves already turned into numpy arrays (for example
``jax.tree.map(numpy.asarray, params)``) and returns the same tree of torch
tensors: ``wte``, ``wpe``, the stacked ``layers`` leaves
(``wq``/``wk``/``wv``/``wo``/``wi``/``wo_mlp``, biases, LayerNorms),
``lnf_*`` and the optional ``lm_head``. The layouts are the same in both
packages, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu", dtype=torch.float32):
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device``; floating leaves are cast to ``dtype``, integer leaves keep
    their type."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))  # a writable copy
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
