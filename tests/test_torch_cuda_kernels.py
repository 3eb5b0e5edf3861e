"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference

pytestmark = pytest.mark.cuda

# fp32: the kernel and the plain version differ in summation order only;
# bf16/fp16: both accumulate in fp32 and round the output once, so they
# differ by at most about one ulp (2^-8, 2^-11) of outputs below 2 in magnitude
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 plain versions
    return torch.device("cuda")


def _inputs(B, H, D, Smax, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
                 for s in ((B, H, D), (B, Smax, H, D), (B, Smax, H, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 64, 128, 256])
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_kernel_matches_reference(cuda_device, dtype, D, alibi):
    B, H, Smax = 4, 6, 384
    q, k, v = _inputs(B, H, D, Smax, cuda_device, dtype)
    pos = torch.tensor([0, 1, 200, 383], dtype=torch.int32, device=cuda_device)
    slopes = tfm.alibi_slopes(H, cuda_device) if alibi else None
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_reference(q, k, v, pos, alibi_slopes=slopes)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=_TOL[dtype])


def test_decode_kernel_scalar_pos_past_the_end(cuda_device):
    q, k, v = _inputs(2, 3, 64, 128, cuda_device, torch.float32)
    for pos in (0, 77, 127, 500):  # 500 > Smax - 1: every key is live
        out = decode_attention(q, k, v, pos)
        ref = decode_attention_reference(q, k, v, pos)
        torch.testing.assert_close(out, ref, rtol=0, atol=_TOL[torch.float32])


def test_decode_kernel_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _inputs(2, 3, 8, 16, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError):
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 3)
    with pytest.raises(ValueError):
        decode_attention(*_inputs(1, 1, 512, 4, cuda_device, torch.float32), 0)


# Flash kernels vs their plain versions. Forward output: as for decode. lse:
# fp32 in both. Gradients, as max abs error over the reference's max |value|:
# fp32 differs in summation order only; bf16 rounds P and dS to bf16 at the
# same points in both, but a value near a rounding boundary can land one ulp
# (2^-8 relative; fp16 2^-11) apart and the products then differ by a few
# such terms.
_FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}
_FLASH_CASES = {
    "causal": {"causal": True},
    "bidirectional": {"causal": False},
    "alibi": {"causal": True, "alibi": True},
    "window": {"causal": True, "window": 96.0},
    "window_off": {"causal": True, "window": 0.0},
}


def _flash_inputs(B, S, H, D, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(device, dtype)
                 for _ in range(4))


def _normalised_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case,S", [(case, S) for case in _FLASH_CASES for S in (128, 200, 384)
                                    if _FLASH_CASES[case]["causal"] or S % 128 == 0])
def test_flash_kernels_match_reference(cuda_device, dtype, D, S, case):
    # non-causal attention takes 128-aligned lengths only, as in the JAX package
    kw = dict(_FLASH_CASES[case])
    B, H = 2, 3
    slopes = tfm.alibi_slopes(H, cuda_device) if kw.pop("alibi", False) else None
    q, k, v, dout = _flash_inputs(B, S, H, D, cuda_device, dtype)
    kw.update(alibi_slopes=slopes)
    before = (fa.flash_forward.launches, fa.flash_backward_dkdv.launches, fa.flash_backward_dq.launches)
    out, lse = fa.flash_forward(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    delta = fa.flash_delta(ref_out, dout)
    dk, dv = fa.flash_backward_dkdv(q, k, v, dout, ref_lse, delta, **kw)
    dq = fa.flash_backward_dq(q, k, v, dout, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    after = (fa.flash_forward.launches, fa.flash_backward_dkdv.launches, fa.flash_backward_dq.launches)
    assert after == tuple(n + 1 for n in before)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    ref = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, dout, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        err = _normalised_err(got, want)
        assert err <= _FLASH_GRAD_TOL[dtype], f"{name}: {err:.3e}"


def test_flash_attention_autograd_launches_each_kernel_once(cuda_device):
    q, k, v, dout = _flash_inputs(2, 256, 2, 64, cuda_device, torch.bfloat16, seed=4)
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    counters = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
    before = [c.launches for c in counters]
    fa.flash_attention(q, k, v).backward(dout)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_flash_kernels_reject_what_they_cannot_take(cuda_device):
    q, k, v, _ = _flash_inputs(1, 128, 2, 64, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        fa.flash_forward(*_flash_inputs(1, 128, 1, 256, cuda_device, torch.float32)[:3])
    with pytest.raises(ValueError):
        fa.flash_forward(q[..., ::2], k[..., ::2], v[..., ::2])


# Fused-loss kernels vs their plain versions. nll and lse: the logits are
# exact fp32 products of the inputs' values in both, so they differ in
# summation order only. dH and dW, as max abs error over the reference's max
# |value|: ds is rounded to the input type at the same points in both, but a
# value near a rounding boundary can land one ulp apart.
_XENT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 1e-3}
_XENT_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}
_XENT_COUNTERS = (fx.fused_xent_forward, fx.fused_xent_backward_dh, fx.fused_xent_backward_dw)


def _xent_inputs(N, D, V, device, dtype, tied, seed=0):
    """hidden [N, D], head [D, V] (the transpose of a [V, D] buffer when
    tied), int32 labels with every seventh row ignored, and g = the masked
    mean's cotangent."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32) * 0.5).to(device, dtype)
    w = rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32) * 0.1
    head = torch.from_numpy(w).to(device, dtype)
    head = head.t() if tied else head
    y = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).to(device)
    y[::7] = -1
    mask = (y >= 0).float()
    return h, head, y, mask / mask.sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("V", [777, 50257])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("N,D", [(256, 128), (200, 70)])
def test_fused_xent_kernels_match_reference(cuda_device, dtype, V, tied, N, D):
    h, head, y, g = _xent_inputs(N, D, V, cuda_device, dtype, tied)
    before = [c.launches for c in _XENT_COUNTERS]
    nll, lse = fx.fused_xent_forward(h, head, y)
    ref_nll, ref_lse = fx.fused_linear_xent_reference(h, head, y)
    dh = fx.fused_xent_backward_dh(h, head, y, ref_lse, g)
    dw = fx.fused_xent_backward_dw(h, head, y, ref_lse, g)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(_XENT_COUNTERS, before)] == [1, 1, 1]
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=_XENT_TOL[dtype])
    torch.testing.assert_close(nll, ref_nll, rtol=0, atol=_XENT_TOL[dtype])
    ref_dh, ref_dw = fx.fused_linear_xent_backward_reference(h, head, y, ref_lse, g)
    assert dh.dtype == dw.dtype == dtype and dw.stride() == head.stride()
    for name, got, want in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        err = _normalised_err(got, want)
        assert err <= _XENT_GRAD_TOL[dtype], f"{name}: {err:.3e}"
    assert dh[::7].abs().max().item() == 0.0  # ignored rows


def test_fused_xent_autograd_launches_each_kernel_once(cuda_device):
    h, head, y, _ = _xent_inputs(384, 64, 1000, cuda_device, torch.bfloat16, tied=True, seed=5)
    wte = head.t().detach().requires_grad_(True)
    h.requires_grad_(True)
    before = [c.launches for c in _XENT_COUNTERS]
    nll = fx.fused_linear_xent(h, wte.t(), y)
    mask = (y >= 0).float()
    (torch.sum(nll * mask) / mask.sum()).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(_XENT_COUNTERS, before)] == [1, 1, 1]
    assert wte.grad.shape == wte.shape and wte.grad.is_contiguous()  # no transposed copy
    assert torch.isfinite(h.grad).all() and torch.isfinite(wte.grad).all()


def test_fused_xent_kernels_reject_what_they_cannot_take(cuda_device):
    h, head, y, g = _xent_inputs(64, 32, 300, cuda_device, torch.float32, tied=False)
    with pytest.raises(TypeError):
        fx.fused_xent_forward(h.double(), head.double(), y)
    with pytest.raises(ValueError):
        fx.fused_xent_forward(h, head, y.long())
    big = torch.zeros(8, 2048, device=cuda_device)
    with pytest.raises(ValueError):
        fx.fused_xent_forward(big, torch.zeros(2048, 16, device=cuda_device), y[:8])


def test_train_batch_runs_through_the_flash_kernels(cuda_device):
    """Three train_batch steps of a small bf16 model: every layer of every
    micro-batch launches each flash kernel once, and the loss falls."""
    cfg = tfm.TransformerConfig(vocab_size=97, max_seq_len=256, num_layers=3, num_heads=4, hidden_size=64,
                                dtype=torch.bfloat16, attn_impl="flash", loss_chunk_size=64)
    ds = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
          "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds)
    tokens = np.random.default_rng(0).integers(0, 97, size=(8, 257)).astype(np.int32)
    counters = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
    losses = []
    for _ in range(3):
        before = [c.launches for c in counters]
        m = engine.train_batch({"tokens": tokens})
        assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2] * 3
        losses.append(float(m["loss"]))
        assert not bool(m["overflow"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert engine.get_global_step() == 3


def test_train_batch_runs_through_the_fused_loss_under_remat(cuda_device):
    """Three train_batch steps of a small bf16 model with the fused loss and
    dots_and_flash remat: each micro-batch launches each fused-loss kernel
    once and each flash kernel once per layer (the saved flash outputs keep
    the forward out of the recompute), and the loss falls."""
    cfg = tfm.TransformerConfig(vocab_size=1000, max_seq_len=256, num_layers=3, num_heads=4, hidden_size=64,
                                dtype=torch.bfloat16, attn_impl="flash", loss_impl="fused_xent", remat=True,
                                remat_policy="dots_and_flash")
    ds = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
          "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(8, 257)).astype(np.int32)
    counters = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq) + _XENT_COUNTERS
    losses = []
    for _ in range(3):
        before = [c.launches for c in counters]
        m = engine.train_batch({"tokens": tokens})
        assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2] * 3 + [2] * 3
        losses.append(float(m["loss"]))
        assert not bool(m["overflow"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_decode_in_model_matches_plain_attention(cuda_device):
    cfg = tfm.TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4,
                                hidden_size=32, pos_emb="rotary")
    params = tfm.init(cfg, torch.Generator().manual_seed(0), cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 17))).to(cuda_device)
    logits = {}
    for mode in ("kernel", "xla"):
        c = cfg.replace(decode_attn=mode)
        cache = tfm.init_cache(c, 2, 128, device=cuda_device)
        lg, cache = tfm.apply_with_cache(c, params, prompt, cache, 0, last_only=True)
        tok = lg[:, -1].argmax(-1)[:, None]
        before = decode_attention.launches
        logits[mode], _ = tfm.apply_with_cache(c, params, tok, cache, 17)
        assert decode_attention.launches - before == (2 if mode == "kernel" else 0)
    torch.testing.assert_close(logits["kernel"], logits["xla"], rtol=1e-4, atol=1e-4)
