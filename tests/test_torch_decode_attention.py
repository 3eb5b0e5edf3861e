"""Port parity: decode attention.

The port's plain ``decode_attention_reference`` (and its CPU dispatch
through ``decode_attention``) against the JAX package's Pallas
``decode_attention`` run in interpret mode on the CPU, on the same numpy
inputs. The CUDA kernel itself is held against the plain version in
``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode_attention
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference

# fp32 on both sides; the two differ only in summation order (online vs
# full softmax), which moves results by a few ulps
TOL_FP32 = 1e-5


def _inputs(B=2, H=4, D=32, Smax=256, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(dtype)
    k = rng.standard_normal((B, Smax, H, D)).astype(dtype)
    v = rng.standard_normal((B, Smax, H, D)).astype(dtype)
    return q, k, v


def _both(q, k, v, pos, slopes=None):
    ref = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes))
    pos_t = torch.as_tensor(np.asarray(pos, np.int32))
    slopes_t = None if slopes is None else torch.as_tensor(slopes)
    out = decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), pos_t, alibi_slopes=slopes_t)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("pos", [0, 3, 127, 128, 255])
def test_reference_matches_jax_scalar_pos(pos):
    ref, out = _both(*_inputs(), pos)
    np.testing.assert_allclose(out, ref, rtol=TOL_FP32, atol=TOL_FP32)


def test_reference_matches_jax_per_row_pos():
    ref, out = _both(*_inputs(B=3), np.array([0, 100, 255], np.int32))
    np.testing.assert_allclose(out, ref, rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("pos", [5, [0, 200]])
def test_reference_matches_jax_alibi(pos):
    slopes = alibi_slopes(4).numpy()
    ref, out = _both(*_inputs(), np.asarray(pos, np.int32), slopes)
    np.testing.assert_allclose(out, ref, rtol=TOL_FP32, atol=TOL_FP32)


def test_cpu_dispatch_is_the_reference_bf16():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(D=8, Smax=128))
    pos = torch.tensor([7, 127], dtype=torch.int32)
    out = decode_attention(q, k, v, pos)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out, decode_attention_reference(q, k, v, pos), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["q_rank", "kv_mismatch", "dtype_mix", "slopes_shape", "pos_shape"])
def test_bad_inputs_raise(case):
    q, k, v = (torch.from_numpy(a) for a in _inputs(D=8, Smax=16))
    pos, slopes = 3, None
    if case == "q_rank":
        q = q[:, None]
    elif case == "kv_mismatch":
        v = v[:, :8]
    elif case == "dtype_mix":
        k = k.bfloat16()
    elif case == "slopes_shape":
        slopes = torch.ones(3)
    else:
        pos = torch.tensor([1, 2, 3])
    with pytest.raises((ValueError, TypeError)):
        decode_attention(q, k, v, pos, alibi_slopes=slopes)
