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
from deepspeed_tpu_torch.ops.decode_attention import SPLIT_KEYS, decode_attention, decode_attention_reference
from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk

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


# per-row positions (Smax = 384, three splits): the first key, a split's last
# key and the next split's first, the cache's end, and rows ending in
# different splits
_DECODE_POS = {
    "spread": [0, 1, 200, 383],
    "split_edges": [SPLIT_KEYS - 1, SPLIT_KEYS, 2 * SPLIT_KEYS - 1, 2 * SPLIT_KEYS],
    "mixed_splits": [3, SPLIT_KEYS + 17, 2 * SPLIT_KEYS + 100, SPLIT_KEYS - 2],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("rows", list(_DECODE_POS))
def test_decode_kernel_matches_reference(cuda_device, dtype, D, alibi, rows):
    """D = 100 in bf16 (200-byte rows) takes the per-element load path."""
    B, H, Smax = 4, 6, 384
    q, k, v = _inputs(B, H, D, Smax, cuda_device, dtype)
    pos = torch.tensor(_DECODE_POS[rows], dtype=torch.int32, device=cuda_device)
    slopes = tfm.alibi_slopes(H, cuda_device) if alibi else None
    before = (decode_attention.launches, decode_attention.combine_launches)
    out = decode_attention(q, k, v, pos, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention.combine_launches) == (before[0] + 1, before[1] + 1)
    ref = decode_attention_reference(q, k, v, pos, alibi_slopes=slopes)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_negative_pos_writes_zeros(cuda_device, dtype):
    """A negative position attends to nothing: zeros, in that row only (the
    Pallas kernel's behaviour; the plain versions average the masked keys)."""
    q, k, v = _inputs(3, 2, 64, 300, cuda_device, dtype)
    pos = torch.tensor([-1, 150, -5], dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, pos)
    assert torch.equal(out[0], torch.zeros_like(out[0])) and torch.equal(out[2], torch.zeros_like(out[2]))
    torch.testing.assert_close(out[1].float(), decode_attention_reference(q, k, v, pos)[1].float(), rtol=0,
                               atol=_TOL[dtype])
    assert torch.equal(decode_attention(q, k, v, -1), torch.zeros_like(q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 100])
def test_decode_kernel_is_deterministic(cuda_device, dtype, D):
    """Two launches over scratch left dirty in between give bitwise the same
    output: the combine merges the splits in order, and splits past pos are
    never read."""
    q, k, v = _inputs(4, 6, D, 1024, cuda_device, dtype, seed=9)
    pos = torch.tensor([1023, 0, 300, 700], dtype=torch.int32, device=cuda_device)
    outs = []
    for seed in range(2):
        junk = torch.randn(64 * 2**20, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(seed))
        junk.mul_(1e30)  # garbage where the next scratch will lie
        del junk
        outs.append(decode_attention(q, k, v, pos))
        torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[0]).all())


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
    "window_256": {"causal": True, "window": 256.0},
    "window_off": {"causal": True, "window": 0.0},
}
# the 16-bit kernels' tile edges: one row, a warpgroup's 64 rows either side,
# the 128-row CTA, a ragged edge inside the last tile
_FLASH_LENGTHS = (1, 63, 65, 128, 200, 384, 1000)


def _flash_inputs(B, S, H, D, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(device, dtype)
                 for _ in range(4))


def _normalised_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-6)).item()


def _flash_check(device, dtype, B, S, H, D, causal=True, alibi=False, window=None, inputs=None):
    """Each flash kernel against its plain version; the backward kernels get
    the plain forward's O and lse. Returns (out, lse, dq, dk, dv)."""
    slopes = tfm.alibi_slopes(H, device) if alibi else None
    q, k, v, dout = inputs if inputs is not None else _flash_inputs(B, S, H, D, device, dtype)
    kw = dict(causal=causal, alibi_slopes=slopes, window=window)
    before = (fa.flash_forward.launches, fa.flash_backward_dkdv.launches, fa.flash_backward_dq.launches)
    out, lse = fa.flash_forward(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    delta = fa.flash_delta(ref_out, dout)
    dk, dv = fa.flash_backward_dkdv(q, k, v, dout, ref_lse, delta, **kw)
    dq = fa.flash_backward_dq(q, k, v, dout, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    after = (fa.flash_forward.launches, fa.flash_backward_dkdv.launches, fa.flash_backward_dq.launches)
    assert after == tuple(n + 1 for n in before)
    assert out.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    ref = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, dout, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        if S == 1 and name != "dv":
            # one key: P = 1 and dS = dP − Δ cancels to rounding noise in both
            err = (got.float() - want.float()).abs().max().item()
            assert err <= _TOL[dtype], f"{name}: {err:.3e}"
            continue
        err = _normalised_err(got, want)
        assert err <= _FLASH_GRAD_TOL[dtype], f"{name}: {err:.3e}"
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("case,S", [(case, S) for case in _FLASH_CASES for S in _FLASH_LENGTHS
                                    if _FLASH_CASES[case]["causal"] or S % 128 == 0])
def test_flash_kernels_match_reference(cuda_device, dtype, D, S, case):
    # non-causal attention takes 128-aligned lengths only, as in the JAX package
    _flash_check(cuda_device, dtype, 2, S, 3, D, **_FLASH_CASES[case])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Sq,Sk,causal", [(128, 384, False), (384, 128, False), (256, 128, True),
                                          (128, 256, True)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_cross_attention(cuda_device, dtype, Sq, Sk, causal, D):
    """128-aligned query and key lengths that differ, as the wrapper allows:
    the forward's key loop and dK/dV's query loop run over the other
    tensor's length."""
    rng = np.random.default_rng(7)
    q, dout = (torch.from_numpy(rng.standard_normal((2, Sq, 3, D)).astype(np.float32)).to(cuda_device, dtype)
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, Sk, 3, D)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    _flash_check(cuda_device, dtype, 2, Sq, 3, D, causal=causal, inputs=(q, k, v, dout))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernels_at_the_training_shape(cuda_device, dtype):
    """The main path's shape: GPT-2-125M's heads at S = 1024, micro-batch 8."""
    _flash_check(cuda_device, dtype, 8, 1024, 12, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["D100", "unaligned_view"])
def test_flash_kernels_pad_what_tma_cannot_read(cuda_device, dtype, layout):
    """D = 100 (200-byte rows) and a view whose base and strides are off 16
    bytes: the 16-bit kernels (forward, dK/dV and dQ) take zero-padded
    copies chosen before the launch, and the results are sliced back to the
    caller's head dim."""
    if layout == "D100":
        inputs = _flash_inputs(2, 200, 3, 100, cuda_device, dtype, seed=3)
    else:
        wide = _flash_inputs(2, 200, 3, 68, cuda_device, dtype, seed=3)
        inputs = tuple(t[..., 2:66] for t in wide)
    q = inputs[0]
    assert fa.needs_padding(*inputs) == (dtype != torch.float32)
    out, _, dq, dk, dv = _flash_check(cuda_device, dtype, 2, 200, 3, q.shape[-1], inputs=inputs)
    assert out.shape == q.shape and dk.shape == q.shape and dq.shape == q.shape and dq.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_are_deterministic(cuda_device, dtype, D):
    """Forward, dK/dV and dQ give bitwise the same results from two launches
    into fresh buffers over memory left dirty in between: no atomics, no
    race."""
    q, k, v, dout = _flash_inputs(2, 1000, 3, D, cuda_device, dtype, seed=6)
    runs = []
    for seed in range(2):
        junk = torch.randn(64 * 2**20, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(seed))
        del junk  # the next allocations reuse its memory
        out, lse = fa.flash_forward(q, k, v)
        delta = fa.flash_delta(out, dout)
        dk, dv = fa.flash_backward_dkdv(q, k, v, dout, lse, delta)
        dq = fa.flash_backward_dq(q, k, v, dout, lse, delta)
        torch.cuda.synchronize()
        runs.append((out, lse, dk, dv, dq))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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
_XENT_COUNTERS = (fx.fused_xent_forward, fx.xent_ds_pass, fx.xent_dw_pass, fx.xent_dh_pass)


def _chunks(N, V, dtype):
    return len(fx.vocab_chunks(V, fx.backward_chunk(N, V, torch.empty((), dtype=dtype).element_size())))


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


def _check_xent(h, head, y, g, dtype):
    """Forward and backward (called twice) against the plain versions; the
    backward's two calls bitwise equal, ignored rows' dH exactly 0. Returns
    each counter's launches."""
    before = [c.launches for c in _XENT_COUNTERS]
    nll, lse = fx.fused_xent_forward(h, head, y)
    ref_nll, ref_lse = fx.fused_linear_xent_reference(h, head, y)
    dh, dw = fx.fused_xent_backward(h, head, y, ref_lse, g)
    dh2, dw2 = fx.fused_xent_backward(h, head, y, ref_lse, g)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(_XENT_COUNTERS, before)]
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=_XENT_TOL[dtype])
    torch.testing.assert_close(nll, ref_nll, rtol=0, atol=_XENT_TOL[dtype])
    ref_dh, ref_dw = fx.fused_linear_xent_backward_reference(h, head, y, ref_lse, g)
    assert dh.dtype == dw.dtype == dtype and dh.is_contiguous() and dw.stride() == head.stride()
    for name, got, want in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        err = _normalised_err(got, want)
        assert err <= _XENT_GRAD_TOL[dtype], f"{name}: {err:.3e}"
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)  # fixed chunk order, no atomics
    assert dh[::7].abs().max().item() == 0.0  # ignored rows
    return launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("V", [777, 50257])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("N,D", [(256, 128), (200, 70)])
def test_fused_xent_kernels_match_reference(cuda_device, dtype, V, tied, N, D):
    """D = 70 (140-byte rows) sends the 16-bit backward's operands to padded
    copies; V = 777 and 50257 leave a ragged last tile."""
    h, head, y, g = _xent_inputs(N, D, V, cuda_device, dtype, tied)
    chunks = _chunks(N, V, dtype)
    assert _check_xent(h, head, y, g, dtype) == [1] + [2 * chunks] * 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("V", [129, 383])  # one column past a chunk; one short of three
@pytest.mark.parametrize("tied", [True, False])
def test_fused_xent_backward_across_vocab_chunks(cuda_device, monkeypatch, dtype, V, tied):
    """A 128-column chunk (the scratch budget cut to one tile): the dH
    accumulator is written by the first chunk, added to by the middle one and
    rounded into dH by the last, and each chunk writes its own columns of dW."""
    N, D = 256, 64
    h, head, y, g = _xent_inputs(N, D, V, cuda_device, dtype, tied, seed=3)
    monkeypatch.setattr(fx, "SCRATCH_BYTES", N * h.element_size() * 128)
    chunks = fx.vocab_chunks(V, fx.backward_chunk(N, V, h.element_size()))
    assert [w for _, w in chunks] == ([128, 1] if V == 129 else [128, 128, 127])
    assert _check_xent(h, head, y, g, dtype) == [1] + [2 * len(chunks)] * 3


def test_fused_xent_autograd_launches_each_kernel_once(cuda_device):
    """One backward call over one vocab chunk (384 rows, V = 1000): each of
    the three backward kernels launches once."""
    h, head, y, _ = _xent_inputs(384, 64, 1000, cuda_device, torch.bfloat16, tied=True, seed=5)
    wte = head.t().detach().requires_grad_(True)
    h.requires_grad_(True)
    before = [c.launches for c in _XENT_COUNTERS]
    nll = fx.fused_linear_xent(h, wte.t(), y)
    mask = (y >= 0).float()
    (torch.sum(nll * mask) / mask.sum()).backward()
    torch.cuda.synchronize()
    chunks = _chunks(384, 1000, torch.bfloat16)
    assert [c.launches - b for c, b in zip(_XENT_COUNTERS, before)] == [1] + [chunks] * 3
    assert wte.grad.shape == wte.shape and wte.grad.is_contiguous()  # no transposed copy
    assert torch.isfinite(h.grad).all() and torch.isfinite(wte.grad).all()


def test_fused_xent_kernels_reject_what_they_cannot_take(cuda_device):
    h, head, y, g = _xent_inputs(64, 32, 300, cuda_device, torch.float32, tied=False)
    with pytest.raises(TypeError):
        fx.fused_xent_forward(h.double(), head.double(), y)
    with pytest.raises(ValueError):
        fx.fused_xent_forward(h, head, y.long())
    _, lse = fx.fused_xent_forward(h, head, y)
    with pytest.raises(ValueError):
        fx.fused_xent_backward(h, head, y, lse.double(), g)  # lse must be fp32
    with pytest.raises(ValueError):
        fx.fused_xent_backward(h, head, y, lse, g[::2])  # g must be [N]


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
        # 4 x 256 rows: the whole vocab is one backward chunk
        assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2] * 3 + [2] * 4
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


# Block-sparse kernels vs their plain versions, with the flash kernels'
# tolerances and for the same reasons: the plain versions take a softmax
# over each query block's whole gathered row where the kernels go online,
# and round P and dS at the same points.
_SPARSE_COUNTERS = (sk.sparse_forward, sk.sparse_backward_dq, sk.sparse_backward_dkdv)
_SPARSE_LAYOUTS = {
    "fixed": {"num_local_blocks": 4, "num_global_blocks": 1},
    "bigbird": {"num_random_blocks": 1, "num_sliding_window_blocks": 3, "num_global_blocks": 1},
    "bslongformer": {"num_sliding_window_blocks": 3},
    "variable": {"local_window_blocks": [1, 2], "global_block_indices": [0], "num_random_blocks": 1},
    "dense": {},
}


def _sparse_case(device, dtype, D, block, causal, layout, B=2, H=3, seed=0):
    """Each kernel against its plain version on one case; the backward
    kernels get the plain forward's O and lse. Returns the lists."""
    S = layout.shape[-1] * block
    q, k, v, dout = _flash_inputs(B, S, H, D, device, dtype, seed=seed)
    lists = sk.device_lists(layout, causal, S, device)
    kw = {"causal": causal}
    before = [c.launches for c in _SPARSE_COUNTERS]
    out, lse = sk.sparse_forward(q, k, v, lists, **kw)
    ref_out, ref_lse = sk.sparse_attention_reference(q, k, v, lists, **kw)
    delta = fa.flash_delta(ref_out, dout)
    dq = sk.sparse_backward_dq(q, k, v, dout, ref_lse, delta, lists, **kw)
    dk, dv = sk.sparse_backward_dkdv(q, k, v, dout, ref_lse, delta, lists, **kw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(_SPARSE_COUNTERS, before)] == [1, 1, 1]
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    ref = sk.sparse_attention_backward_reference(q, k, v, ref_out, ref_lse, dout, lists, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape
        err = _normalised_err(got, want)
        assert err <= _FLASH_GRAD_TOL[dtype], f"{name}: {err:.3e}"
    return dk, dv, lists


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", list(_SPARSE_LAYOUTS))
def test_sparse_kernels_match_reference(cuda_device, dtype, block, causal, mode):
    layout = SPARSITY_CONFIGS[mode](num_heads=3, block=block, **_SPARSE_LAYOUTS[mode]).make_layout(8 * block)
    _sparse_case(cuda_device, dtype, 64, block, causal, layout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 100, 128])
@pytest.mark.parametrize("block", [16, 64, 128])
def test_sparse_kernels_head_dims(cuda_device, dtype, D, block):
    layout = SPARSITY_CONFIGS["bigbird"](num_heads=2, block=block).make_layout(4 * block)
    _sparse_case(cuda_device, dtype, D, block, True, layout, H=2, seed=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_sparse_key_block_no_query_attends_gets_zero_gradients(cuda_device, dtype):
    layout = np.zeros((4, 4), np.int64)
    layout[np.arange(4), np.arange(4)] = 1
    layout[:, 0] = 1
    layout[2, 2] = 0  # with causal masking, no query block attends key block 2
    for seed in range(4):  # fresh buffers each time: the zeros must not depend on what memory held
        dk, dv, lists = _sparse_case(cuda_device, dtype, 64, 64, True, layout, seed=seed)
        assert int(lists.q_counts[2]) == 0
        assert dk[:, 128:192].abs().max().item() == 0.0 and dv[:, 128:192].abs().max().item() == 0.0


def test_sparse_attention_autograd_launches_each_kernel_once(cuda_device):
    q, k, v, dout = _flash_inputs(2, 512, 2, 64, cuda_device, torch.bfloat16, seed=4)
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    layout = SPARSITY_CONFIGS["fixed"](num_heads=2, block=64, attention="unidirectional").make_layout(512)
    before = [c.launches for c in _SPARSE_COUNTERS]
    flash_before = fa.flash_forward.launches
    sk.sparse_flash_attention(q, k, v, layout).backward(dout)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(_SPARSE_COUNTERS, before)] == [1, 1, 1]
    assert fa.flash_forward.launches == flash_before
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_sparse_kernels_reject_what_they_cannot_take(cuda_device):
    q, k, v, _ = _flash_inputs(1, 256, 2, 64, cuda_device, torch.float32)
    lists = sk.device_lists(np.ones((4, 4)), True, 256, cuda_device)
    with pytest.raises(TypeError):
        sk.sparse_forward(q.double(), k.double(), v.double(), lists)
    big = _flash_inputs(1, 256, 1, 256, cuda_device, torch.float32)[:3]
    with pytest.raises(ValueError):  # head dim above 128
        sk.sparse_forward(*big, lists)
    with pytest.raises(ValueError):  # no contiguous last dimension
        sk.sparse_forward(q[..., ::2], k[..., ::2], v[..., ::2], lists)
    odd = sk.device_lists(np.ones((8, 8)), True, 192, cuda_device)  # block 24
    q3, k3, v3, _ = _flash_inputs(1, 192, 2, 64, cuda_device, torch.float32)
    with pytest.raises(ValueError):
        sk.sparse_forward(q3, k3, v3, odd)
    with pytest.raises(ValueError):  # lists for another length
        sk.sparse_forward(q[:, :128], k[:, :128], v[:, :128], lists)
    with pytest.raises(ValueError):
        sk.sparse_flash_attention(q3, k3, v3, np.ones((8, 8)))


def test_train_batch_runs_through_the_sparse_kernels(cuda_device):
    """Three train_batch steps of a small bf16 model whose config block asks
    for block-sparse attention: every layer of every micro-batch launches
    each sparse kernel once and no flash kernel, and the loss falls."""
    cfg = tfm.TransformerConfig(vocab_size=97, max_seq_len=512, num_layers=3, num_heads=4, hidden_size=64,
                                dtype=torch.bfloat16, attn_impl="flash", loss_chunk_size=128)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "sparse_attention": {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
                               "attention": "unidirectional"}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds)
    assert engine.model.config.attn_impl == "sparse"
    tokens = np.random.default_rng(0).integers(0, 97, size=(4, 513)).astype(np.int32)
    counters = _SPARSE_COUNTERS + (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
    losses = []
    for _ in range(3):
        before = [c.launches for c in counters]
        m = engine.train_batch({"tokens": tokens})
        assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2] * 3 + [0] * 3
        losses.append(float(m["loss"]))
        assert not bool(m["overflow"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
