"""Port parity: decode attention.

The port's plain ``decode_attention_reference`` (and its CPU dispatch
through ``decode_attention``) against the JAX package's Pallas
``decode_attention`` run in interpret mode on the CPU, on the same numpy
inputs. The CUDA kernel itself is held against the plain version in
``test_torch_cuda_kernels.py``.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode_attention
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import decode_attention as decode_module
from deepspeed_tpu_torch.ops.decode_attention import (SPLIT_KEYS, decode_attention, decode_attention_reference,
                                                      split_plan, vector_loads)

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


def test_split_plan_is_fixed_by_the_cache_shape():
    """The split-KV launch's split count and scratch shape come from
    (B, Smax, H, D) alone: no position enters the plan, so every decode step
    of a generate launches the same grid."""
    assert "pos" not in inspect.signature(split_plan).parameters
    assert split_plan(8, 1024, 12, 64) == (8, (8, 12, 8, 66))
    for Smax in (1, SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1, 8192):
        splits, scratch = split_plan(2, Smax, 3, 100)
        assert splits == -(-Smax // SPLIT_KEYS) and scratch == (2, 3, splits, 102)
        # the last live split of any position up to the clamp fits the plan
        assert (Smax - 1) // SPLIT_KEYS < splits


def test_split_constants_mirror_the_kernel_source():
    src = (Path(decode_module.__file__).resolve().parents[1] / "csrc" / "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int SPLIT_KEYS = (\d+);", src).group(1)) == SPLIT_KEYS
    assert int(re.search(r"constexpr int MAX_SPLITS = (\d+);", src).group(1)) == decode_module._MAX_SPLITS


def test_vector_loads_are_chosen_from_the_row_and_the_bases():
    """16-byte loads when a row of D elements is a multiple of 16 bytes and
    both caches start at 16 bytes; the per-element path otherwise (D = 100
    in bf16: 200-byte rows)."""
    def cache(D, dtype):
        return torch.zeros(2, 16, 3, D, dtype=dtype)

    for D, dtype, vec in ((64, torch.bfloat16, True), (8, torch.bfloat16, True), (100, torch.bfloat16, False),
                          (100, torch.float32, True), (6, torch.float32, False), (256, torch.float32, True)):
        assert vector_loads(cache(D, dtype), cache(D, dtype)) == vec, (D, dtype)
    flat = torch.zeros(2 * 16 * 3 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 16 * 3 * 64].view(2, 16, 3, 64)  # contiguous, base 2 bytes off
    assert shifted.is_contiguous() and not vector_loads(shifted, cache(64, torch.bfloat16))
