"""Port parity: flash attention, forward and gradients.

The same numpy inputs go through the JAX ``flash_attention`` (the Pallas
kernels in interpret mode, as ``tests/test_flash_attention.py`` runs them on
the CPU) and the port's ``flash_attention`` on CPU tensors, which takes the
plain versions the CUDA kernels are held against on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jflash
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides; the forward differs by summation order only (the JAX
# package's own flash-vs-xla tolerance, tests/test_flash_attention.py:33)
FWD_TOL = 2e-5
# gradients: the backward's dS = P∘(dP − Δ) cancels, so relative error grows;
# the JAX package's own flash-vs-xla gradient tolerance (:64)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _qkv(B=2, S=256, H=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal((B, S, H, D))).astype(np.float32) for _ in range(3))


def _jax_kw(kw):
    out = dict(kw)
    if "alibi_slopes" in out:
        out["alibi_slopes"] = jnp.asarray(out["alibi_slopes"])
    return out


def _torch_kw(kw):
    out = dict(kw)
    if "alibi_slopes" in out:
        out["alibi_slopes"] = torch.from_numpy(np.asarray(out["alibi_slopes"]))
    return out


CASES = {
    "causal": (256, {"causal": True}),
    "bidirectional": (256, {"causal": False}),
    "alibi": (256, {"causal": True, "alibi_slopes": np.asarray(ttfm.alibi_slopes(4))}),
    "window": (256, {"causal": True, "window": 48.0}),
    "window_off": (128, {"causal": True, "window": 0.0}),
    "unaligned_causal": (200, {"causal": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    S, kw = CASES[name]
    q, k, v = _qkv(S=S)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
                 **_jax_kw(kw))
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=128, block_k=128,
                              **_torch_kw(kw))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["causal", "bidirectional", "alibi", "window", "unaligned_causal"])
def test_gradients_match_jax(name):
    S, kw = CASES[name]
    q, k, v = _qkv(B=1, S=S, H=4, D=16, seed=1)

    def jloss(q, k, v):
        return jnp.sum(jnp.square(jflash(q, k, v, **_jax_kw(kw))))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    torch.sum(torch.square(tfa.flash_attention(tq, tk, tv, **_torch_kw(kw)))).backward()
    for port, ref, n in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 40.0},
                                {"causal": True, "alibi": True}])
def test_backward_reference_matches_autograd_of_plain_attention(kw):
    """``flash_attention_backward_reference`` against autograd through the
    plain masked softmax (fp32; summation order only, hence 1e-5)."""
    kw = dict(kw)
    slopes = ttfm.alibi_slopes(3) if kw.pop("alibi", False) else None
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(B=2, S=96, H=3, D=16, seed=2))
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 96, 3, 16)).astype(np.float32))
    scale = 1.0 / 4.0
    s = tfa._scores(q, k, kw["causal"], scale, slopes, kw.get("window"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        out_ref, lse = tfa.flash_attention_reference(q, k, v, sm_scale=scale, alibi_slopes=slopes, **kw)
        torch.testing.assert_close(out_ref, out, rtol=1e-5, atol=1e-5)
        mine = tfa.flash_attention_backward_reference(q, k, v, out_ref, lse, dout, sm_scale=scale,
                                                      alibi_slopes=slopes, **kw)
    for a, b in zip(mine, grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_argument_rules_match_jax():
    q, k, v = (torch.zeros(1, 200, 2, 16) for _ in range(3))
    jq = jnp.zeros((1, 200, 2, 16))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1, 2, 200, 200))
    for fn, args in ((tfa.flash_attention, (q, k, v)), (jflash, (jq, jq, jq))):
        with pytest.raises(ValueError):  # non-causal needs 128-aligned lengths
            fn(*args, causal=False)
    kq = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError):  # causal cross-attention, unaligned
        tfa.flash_attention(q, kq, kq)
    with pytest.raises(ValueError):
        jflash(jq, jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)))
    q256 = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError):  # 256 is not a multiple of block_q 96
        tfa.flash_attention(q256, q256, q256, block_q=96)
    with pytest.raises(ValueError):
        jflash(jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)),
               block_q=96)


def test_cpu_tensors_count_no_launch_and_kernel_entry_points_need_cuda():
    q, k, v = map(torch.from_numpy, _qkv(B=1, S=128, H=2, D=16))
    counters = (tfa.flash_forward, tfa.flash_backward_dkdv, tfa.flash_backward_dq)
    before = [f.launches for f in counters]
    q.requires_grad_(True)
    tfa.flash_attention(q, k, v).sum().backward()
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward(q.detach(), k, v)
