"""Port parity: ``TiledLinear`` (runtime/zero/tiling.py) against the JAX
package's, the single-device cases of ``tests/test_tiling.py``.

The same weights (the JAX init, carried over as numpy) and inputs go
through both: outputs and gradients agree within fp32 rounding (rtol 1e-5,
the JAX test's), and each equals the dense product it tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.zero import TiledLinear as JTiled
from deepspeed_tpu.runtime.zero import split_tensor_along_dim as jsplit
from deepspeed_tpu_torch.runtime.zero import TiledLinear, TiledLinearConfig, split_tensor_along_dim

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(in_f, out_f, in_splits=1, out_splits=1, use_bias=True):
    j = JTiled(in_f, out_f, in_splits=in_splits, out_splits=out_splits, use_bias=use_bias)
    jp = j.init(jax.random.PRNGKey(0))
    if use_bias:
        jp["b"] = jax.random.normal(jax.random.PRNGKey(2), (out_f,))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return j, jp, TiledLinear(in_f, out_f, in_splits=in_splits, out_splits=out_splits, use_bias=use_bias), tp


@pytest.mark.parametrize("in_splits,out_splits", [(1, 1), (4, 1), (1, 4), (4, 2)])
def test_tiled_matches_jax_and_dense(in_splits, out_splits):
    j, jp, t, tp = _pair(32, 48, in_splits, out_splits)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (5, 32)))
    y = t.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(j.apply(jp, jnp.asarray(x))), **TOL)
    w, b = t.to_dense(tp)
    np.testing.assert_allclose(y.numpy(), (torch.from_numpy(x) @ w + b).numpy(), **TOL)


def test_tiled_grads_match_jax_and_dense():
    j, jp, t, tp = _pair(16, 24, in_splits=4, out_splits=2)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 16)))
    gj = jax.grad(lambda p: jnp.sum(j.apply(p, jnp.asarray(x)) ** 2))(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    (t.apply(leaves, torch.from_numpy(x)) ** 2).sum().backward()
    dense = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ((torch.from_numpy(x) @ dense["w"].reshape(16, 24) + dense["b"]) ** 2).sum().backward()
    for k in ("w", "b"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(gj[k]), **TOL)
        np.testing.assert_allclose(leaves[k].grad.numpy(), dense[k].grad.numpy(), **TOL)


def test_from_dense_roundtrip():
    t = TiledLinear(8, 12, in_splits=2)
    w = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    b = torch.arange(12.0)
    p = t.from_dense(w, b)
    w2, b2 = t.to_dense(p)
    assert torch.equal(w, w2) and torch.equal(b, b2)
    assert tuple(p["w"].shape) == tuple(JTiled(8, 12, in_splits=2).from_dense(jnp.asarray(w.numpy()), None)["w"].shape)
    torch.testing.assert_close(t.apply(p, torch.ones(2, 8)), torch.ones(2, 8) @ w + b, rtol=1e-5, atol=1e-6)


def test_leading_batch_dims_and_dtype():
    t = TiledLinear(16, 16, in_splits=2, use_bias=False)
    p = t.init(torch.Generator().manual_seed(0))
    y = t.apply(p, torch.ones(2, 3, 16, dtype=torch.bfloat16))
    assert y.shape == (2, 3, 16) and y.dtype == torch.bfloat16
    assert t.logical_axes() == JTiled(16, 16, in_splits=2, use_bias=False).logical_axes()


def test_split_tensor_helper_matches_jax():
    t = torch.arange(24.0).reshape(4, 6)
    parts = split_tensor_along_dim(t, 3, dim=1)
    jparts = jsplit(jnp.arange(24.0).reshape(4, 6), 3, dim=1)
    assert len(parts) == 3 and parts[0].shape == (4, 2)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        split_tensor_along_dim(t, 4, dim=1)


@pytest.mark.parametrize("bad", [dict(in_splits=3), dict(out_splits=5), dict(in_splits=0)])
def test_config_refuses_splits_that_do_not_divide(bad):
    with pytest.raises(ValueError):
        TiledLinearConfig(in_features=32, out_features=48, **bad)
