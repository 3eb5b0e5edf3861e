"""Optimizers over nested dicts of fp32 tensors, ported from
``deepspeed_tpu/ops/optimizers.py``.

Each factory returns ``(init_fn, update_fn)``:
    init_fn(params)                               -> opt_state dict
    update_fn(grads, opt_state, params, step, lr) -> (new_params, new_state)

``step`` is the 1-based global step and ``lr`` the learning rate, both 0-d
tensors on the parameters' device, so an update never reads the device on
the host. ``update_fn`` is functional, as in the JAX package: it returns new
tensors and leaves its inputs untouched, so the engine can keep or drop the
result on the device (the finite-gated update). Call it under
``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.logging import logger


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally nested dicts -> the same nesting."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _unzip(tree, n: int):
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in tree} for i in range(n))
    return tree


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _bias_correction(step, beta1, beta2):
    s = step.float()
    return 1.0 - beta1 ** s, 1.0 - beta2 ** s


def adam(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
         adamw_mode: bool = True, bias_correction: bool = True):
    """Adam/AdamW; ``adamw_mode`` selects decoupled weight decay."""
    beta1, beta2 = betas

    def init_fn(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update_fn(grads, state, params, step, lr):
        if bias_correction:
            bc1, bc2 = _bias_correction(step, beta1, beta2)
        else:
            bc1 = bc2 = 1.0

        def leaf(g, m, v, p):
            g = g.float()
            if weight_decay > 0.0 and not adamw_mode:
                g = g + weight_decay * p  # classic L2 folded into the gradient
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * (g * g)
            update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay > 0.0 and adamw_mode:
                update = update + weight_decay * p  # decoupled decay
            return p - lr * update, m, v

        new_p, m, v = _unzip(tree_map(leaf, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": m, "v": v}

    return init_fn, update_fn


def adagrad(eps: float = 1e-8, weight_decay: float = 0.0):
    def init_fn(params):
        return {"accum": _zeros(params)}

    def update_fn(grads, state, params, step, lr):
        def leaf(g, acc, p):
            g = g.float()
            if weight_decay > 0.0:
                g = g + weight_decay * p
            acc = acc + g * g
            return p - lr * g / (torch.sqrt(acc) + eps), acc

        new_p, acc = _unzip(tree_map(leaf, grads, state["accum"], params), 2)
        return new_p, {"accum": acc}

    return init_fn, update_fn


def lamb(betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0,
         max_coeff: float = 10.0, min_coeff: float = 0.01):
    """LAMB with a per-tensor trust ratio clamped to [min_coeff, max_coeff]."""
    beta1, beta2 = betas

    def init_fn(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update_fn(grads, state, params, step, lr):
        bc1, bc2 = _bias_correction(step, beta1, beta2)

        def leaf(g, m, v, p):
            g = g.float()
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * (g * g)
            update = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
            w_norm = torch.linalg.vector_norm(p)
            u_norm = torch.linalg.vector_norm(update)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                                torch.ones_like(w_norm))
            return p - lr * trust * update, m, v

        new_p, m, v = _unzip(tree_map(leaf, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": m, "v": v}

    return init_fn, update_fn


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False):
    def init_fn(params):
        return {} if momentum == 0.0 else {"mom": _zeros(params)}

    def update_fn(grads, state, params, step, lr):
        def leaf(g, p, buf):
            g = g.float()
            if weight_decay > 0.0:
                g = g + weight_decay * p
            if momentum != 0.0:
                buf = momentum * buf + g
                g = g + momentum * buf if nesterov else buf
            return p - lr * g, buf

        if momentum == 0.0:
            return tree_map(lambda g, p: leaf(g, p, None)[0], grads, params), {}
        new_p, mom = _unzip(tree_map(leaf, grads, params, state["mom"]), 2)
        return new_p, {"mom": mom}

    return init_fn, update_fn


OPTIMIZERS: dict[str, Callable] = {
    "adam": lambda **kw: adam(adamw_mode=False, **kw),
    "adamw": lambda **kw: adam(adamw_mode=True, **kw),
    "lamb": lamb,
    "sgd": sgd,
    "adagrad": adagrad,
}

ONEBIT = ("onebitadam", "onebitlamb", "zerooneadam")


def get_optimizer(name: str, params_cfg: dict):
    """Build from a DeepSpeed ``optimizer`` block -> (init_fn, update_fn, lr).
    The decay mode follows the optimizer's name: an ``adam_w_mode`` key that
    contradicts it is ignored with a warning, as in the JAX package."""
    name = name.lower()
    if name in ONEBIT:
        raise NotImplementedError(f"optimizer {name!r} (the 1-bit family) is not ported yet")
    aliases = {"fusedadam": "adam", "cpuadam": "adam", "fusedlamb": "lamb"}
    name = aliases.get(name, name)
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name}; have {list(OPTIMIZERS)}")
    kwargs = dict(params_cfg)
    lr = kwargs.pop("lr", 1e-3)
    kwargs.pop("torch_adam", None)
    awm = kwargs.pop("adam_w_mode", None)
    if awm is not None and bool(awm) != (name == "adamw"):
        logger.warning(
            "optimizer.params.adam_w_mode=%s contradicts type %r and is ignored "
            "(decay mode follows the optimizer name); use type 'adamw' for "
            "decoupled decay", awm, name)
    for key in ("freeze_step", "cuda_aware", "comm_backend_name"):
        kwargs.pop(key, None)
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    init_fn, update_fn = OPTIMIZERS[name](**kwargs)
    return init_fn, update_fn, float(lr)
