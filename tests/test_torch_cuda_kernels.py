"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)
"""

import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.ops.decode_attention import SPLIT_KEYS, decode_attention, decode_attention_reference
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
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


def _kernels_launched(fn):
    """The names of the CUDA kernels ``fn`` launches, from torch.profiler.
    A warm-up kernel goes first: the tracer can miss the first kernel of a
    profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


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
_XENT_COUNTERS = (fx.fused_xent_forward, fx.xent_fwd_combine, fx.xent_ds_pass, fx.xent_dw_pass,
                  fx.xent_dh_pass)


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
    assert _check_xent(h, head, y, g, dtype) == [1, int(dtype != torch.float32)] + [2 * chunks] * 3


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
    assert _check_xent(h, head, y, g, dtype) == [1, int(dtype != torch.float32)] + [2 * len(chunks)] * 3


def test_fused_xent_autograd_launches_each_kernel_once(cuda_device):
    """One forward and one backward call over one vocab chunk (384 rows,
    V = 1000): the forward launches its product (the Hopper mainloop with
    the logsumexp epilogue) and its combine once each, the backward each of
    its three kernels once; the old forward kernel (fp32 only now) does
    not run."""
    h, head, y, _ = _xent_inputs(384, 64, 1000, cuda_device, torch.bfloat16, tied=True, seed=5)
    wte = head.t().detach().requires_grad_(True)
    h.requires_grad_(True)
    before = [c.launches for c in _XENT_COUNTERS]

    def step():
        nll = fx.fused_linear_xent(h, wte.t(), y)
        mask = (y >= 0).float()
        (torch.sum(nll * mask) / mask.sum()).backward()

    names = _kernels_launched(step)
    chunks = _chunks(384, 1000, torch.bfloat16)
    assert [c.launches - b for c, b in zip(_XENT_COUNTERS, before)] == [1, 1] + [chunks] * 3
    assert any("xent_gemm_hopper" in n and "LseOut" in n for n in names), names
    assert any("xent_lse_combine" in n for n in names)
    assert not any("xent_fwd_kernel" in n for n in names)
    assert wte.grad.shape == wte.shape and wte.grad.is_contiguous()  # no transposed copy
    assert torch.isfinite(h.grad).all() and torch.isfinite(wte.grad).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("N,D,V", [(1000, 768, 50304), (1000, 768, 50257), (1000, 64, 777), (256, 770, 1000)])
@pytest.mark.parametrize("tied", [True, False])
def test_fused_xent_hopper_forward(cuda_device, dtype, N, D, V, tied):
    """The 16-bit forward (product with the logsumexp epilogue, then the
    combine) against its plain version: vocabs of whole tiles, a last tile
    of 1 (50257) and 9 (777) columns, D = 770 through the padded route, N
    not a multiple of the 128-row tile, the head as wte.t() or a contiguous
    [D, V], one row in seven ignored (nll = lse there). Two calls give the
    same bits."""
    h, head, y, _ = _xent_inputs(N, D, V, cuda_device, dtype, tied, seed=7)
    y[1], y[2] = V - 1, 0  # the last column and the first
    assert fx.tma_readable(head) == ((D if tied else V) % 8 == 0)  # the head's non-unit stride
    before = [c.launches for c in _XENT_COUNTERS]
    nll, lse = fx.fused_xent_forward(h, head, y)
    nll2, lse2 = fx.fused_xent_forward(h, head, y)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(_XENT_COUNTERS, before)] == [2, 2, 0, 0, 0]
    ref_nll, ref_lse = fx.fused_linear_xent_reference(h, head, y)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=_XENT_TOL[dtype])
    torch.testing.assert_close(nll, ref_nll, rtol=0, atol=_XENT_TOL[dtype])
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    assert torch.equal(nll[::7], lse[::7])  # ignored rows: no gold logit


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
        assert [c.launches - b for c, b in zip(counters, before)] == [3 * 2] * 3 + [2] * 5
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


def _sparse_case(device, dtype, D, block, causal, layout, B=2, H=3, seed=0, inputs=None):
    """Each kernel against its plain version on one case; the backward
    kernels get the plain forward's O and lse. Returns (dk, dv, lists)."""
    S = layout.shape[-1] * block
    q, k, v, dout = inputs if inputs is not None else _flash_inputs(B, S, H, D, device, dtype, seed=seed)
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


def _long_list_layout(block):
    """Long lists (37 query blocks at block 64, 19 at 128): key blocks 0
    and 1 attended by every query block, key block 3 by none."""
    n = 37 if block == 64 else 19
    layout = np.eye(n, dtype=np.int64)
    layout[:, :2] = 1
    layout[3, 3] = 0
    return layout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_hopper_backward_matches_reference(cuda_device, dtype, block, D, causal):
    """The Hopper dQ and dK/dV at both blocks and head dims, on a bigbird
    layout and on one with long lists, each walked whole by one CTA. A key
    block no query attends gets exact zeros."""
    layout = SPARSITY_CONFIGS["bigbird"](num_heads=3, block=block, **_SPARSE_LAYOUTS["bigbird"]).make_layout(
        8 * block)
    _sparse_case(cuda_device, dtype, D, block, causal, layout)
    assert sk.hopper_route(dtype, block)
    dk, dv, lists = _sparse_case(cuda_device, dtype, D, block, causal, _long_list_layout(block), H=2, seed=2)
    assert int(lists.q_counts[3]) == 0
    rows = slice(3 * block, 4 * block)
    assert dk[:, rows].abs().max().item() == 0.0 and dv[:, rows].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_hopper_forward_matches_reference(cuda_device, dtype, block, D, causal):
    """The Hopper forward at both blocks and head dims, on long lists (the
    dense layout: up to 24 key blocks at block 64, 12 at 128) walked whole
    by one CTA, and with causal masking lists of every length from 1: O
    against the plain version within _TOL, lse within 1e-4; two calls give
    the same bits."""
    n = 24 if block == 64 else 12
    S = n * block
    q, k, v, _ = _flash_inputs(2, S, 2, D, cuda_device, dtype, seed=9)
    lists = sk.device_lists(np.ones((n, n), np.int64), causal, S, cuda_device)
    assert sk.hopper_route(dtype, block) and int(lists.k_counts.max()) == n
    out, lse = sk.sparse_forward(q, k, v, lists, causal=causal)
    out2, lse2 = sk.sparse_forward(q, k, v, lists, causal=causal)
    ref_out, ref_lse = sk.sparse_attention_reference(q, k, v, lists, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_forward_empty_list_writes_zeros(cuda_device, dtype, block, causal):
    """A query block whose list is empty (lists built by hand: no layout
    gives one) walks no tile and writes O = 0 and lse = NEG_INF exactly, as
    the plain version and the Pallas kernel do, into fresh buffers over
    dirty memory; every other row matches the plain version."""
    n = 6
    S = n * block
    k_lists, k_counts, q_lists, q_counts = sk.layout_to_lists(np.ones((n, n), np.int64), causal)
    k_counts[4] = 0
    tables = [torch.from_numpy(a).to(cuda_device)
              for a in (k_lists, k_counts, q_lists, q_counts, *sk.grid_orders(k_counts, q_counts))]
    lists = sk.SparseLists(*tables[:4], block=block, dq_order=tables[4], dkdv_order=tables[5])
    q, k, v, _ = _flash_inputs(2, S, 3, 64, cuda_device, dtype, seed=10)
    ref_out, ref_lse = sk.sparse_attention_reference(q, k, v, lists, causal=causal)
    rows = slice(4 * block, 5 * block)
    for seed in range(2):
        torch.randn(64 * 2**20, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(seed))
        out, lse = sk.sparse_forward(q, k, v, lists, causal=causal)
        torch.cuda.synchronize()
        assert out[:, rows].abs().max().item() == 0.0 and (lse[:, :, rows] == sk.NEG_INF).all()
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=_TOL[dtype])
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("layout", ["D100", "unaligned_view"])
def test_sparse_hopper_backward_pads_what_tma_cannot_read(cuda_device, dtype, block, layout):
    """D = 100 (200-byte rows) and a view whose base and strides are off 16
    bytes reach the Hopper dQ and dK/dV as zero-padded copies chosen before
    the launch; the gradients come back at the caller's head dim."""
    lay = _long_list_layout(block)
    S = lay.shape[0] * block
    if layout == "D100":
        inputs = _flash_inputs(1, S, 2, 100, cuda_device, dtype, seed=3)
    else:
        inputs = tuple(t[..., 2:66] for t in _flash_inputs(1, S, 2, 68, cuda_device, dtype, seed=3))
    assert fa.needs_padding(*inputs)
    dk, dv, _ = _sparse_case(cuda_device, dtype, inputs[0].shape[-1], block, True, lay, inputs=inputs)
    assert dk.shape == inputs[1].shape and dv.shape == inputs[2].shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("block", [64, 128])
def test_sparse_hopper_backward_is_deterministic(cuda_device, dtype, block):
    """dQ and dK/dV give bitwise the same results from two calls into fresh
    buffers over memory left dirty in between: no atomics, fixed order."""
    lay = _long_list_layout(block)
    S = lay.shape[0] * block
    q, k, v, dout = _flash_inputs(2, S, 3, 64, cuda_device, dtype, seed=6)
    lists = sk.device_lists(lay, True, S, cuda_device)
    out, lse = sk.sparse_forward(q, k, v, lists)
    delta = fa.flash_delta(out, dout)
    runs = []
    for seed in range(2):
        junk = torch.randn(64 * 2**20, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(seed))
        del junk  # the next allocations reuse its memory
        dq = sk.sparse_backward_dq(q, k, v, dout, lse, delta, lists)
        dk, dv = sk.sparse_backward_dkdv(q, k, v, dout, lse, delta, lists)
        torch.cuda.synchronize()
        runs.append((dq, dk, dv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 16), (torch.bfloat16, 32), (torch.float16, 32),
                                         (torch.float32, 64), (torch.float32, 128), (torch.bfloat16, 64),
                                         (torch.float16, 128)])
def test_sparse_backward_keeps_the_old_kernels_off_the_hopper_route(cuda_device, dtype, block):
    """fp32 and blocks 16/32 stay on PR 4's kernels, which hold against
    the plain versions on long lists and give an unattended key block zeros;
    16-bit at blocks 64/128 launches the Hopper forward, dQ and dK/dV and
    none of the tiled kernels (the kernels' names from the profiler)."""
    hopper = sk.hopper_route(dtype, block)
    assert hopper == (dtype != torch.float32 and block >= 64)
    lay = _long_list_layout(64)
    result = []
    names = _kernels_launched(lambda: result.append(_sparse_case(cuda_device, dtype, 64, block, True, lay, H=2)))
    dk, dv, _ = result[0]
    assert dk[:, 3 * block:4 * block].abs().max().item() == 0.0 and dv[:, 3 * block:4 * block].abs().max().item() == 0.0
    for kind in ("fwd", "bwd_dq", "bwd_dkdv"):
        assert any(f"sparse_{kind}_hopper" in n for n in names) == hopper, (kind, names)
        assert any(f"sparse_{kind}_kernel" in n for n in names) == (not hopper), (kind, names)


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


# The serving engine's decode step as one CUDA graph (inference/serving.py).
_SERVE_TINY = dict(vocab_size=97, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=32)


def _serving(device, n_slots=4, seed=0, **config):
    from deepspeed_tpu_torch.inference import ServingEngine

    eng = deepspeed_tpu_torch.init_inference(tfm.Model(tfm.TransformerConfig(**_SERVE_TINY)),
                                             config={"dtype": "fp32"}, device=device)
    return ServingEngine(eng, config={"n_slots": n_slots, "seed": seed, **config})


def _serve_requests(n, seed=0, sampled=False):
    from deepspeed_tpu_torch.inference import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 97, size=int(rng.integers(5, 40))).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 24)),
                    temperature=0.9 if sampled and i % 2 else 0.0, top_k=7 if sampled else 0,
                    top_p=0.9 if sampled else 1.0) for i in range(n)]


def test_serving_decode_graph_replay_equals_eager_step(cuda_device):
    """One replay of the captured step against the same step function
    called eagerly on a copy of the same state (cache and generator): the
    packed output and the cache bit for bit, greedy and sampled rows."""
    from deepspeed_tpu_torch.inference.serving import pack_decode_inputs

    srv = _serving(cuda_device, n_slots=4)
    for r in _serve_requests(4, seed=1, sampled=True):
        srv.submit(r)
    for _ in range(3):
        srv.step(now=0.0)
    w = srv.worker
    assert w._graph is not None and srv.n_active == 4
    wpos = np.where(srv._active, srv._pos, w.Smax).astype(np.int32)
    packed = pack_decode_inputs(srv._last_tok, srv._pos, wpos, srv._active, srv._temp, srv._top_k, srv._top_p)
    cache0 = {kv: t.clone() for kv, t in w._cache.items()}
    gen0 = w._gen.get_state()
    out_graph = w._decode_program(packed)
    cache_graph = {kv: t.clone() for kv, t in w._cache.items()}
    for kv in cache0:
        w._cache[kv].copy_(cache0[kv])
    w._gen.set_state(gen0)
    out_eager = w.decode_step(torch.from_numpy(packed).to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(out_graph, out_eager)
    for kv in cache0:
        assert torch.equal(w._cache[kv], cache_graph[kv]), kv
        assert not torch.equal(cache_graph[kv], cache0[kv])  # the step wrote its tokens' KV


def test_serving_decode_graph_advances_the_generator_and_seeds_repeat(cuda_device):
    from deepspeed_tpu_torch.inference.serving import pack_decode_inputs

    srv = _serving(cuda_device, n_slots=8)
    w, n = srv.worker, 8
    # every row sampled at temperature 1, every write dropped: two replays
    # of the same inputs differ only by the generator's offset
    packed = pack_decode_inputs(np.arange(n), np.full(n, 3), np.full(n, w.Smax), np.ones(n, bool),
                                np.ones(n, np.float32), np.zeros(n, np.int32), np.ones(n, np.float32))
    a, b = w._decode_program(packed), w._decode_program(packed)
    assert w._graph is not None and not np.array_equal(a[:, 0], b[:, 0])
    runs = []
    for _ in range(2):
        srv = _serving(cuda_device, n_slots=4, seed=5)
        res = srv.serve(_serve_requests(10, seed=2, sampled=True))
        runs.append({u: r.tokens for u, r in res.items()})
        assert srv.compile_counts()["decode"] == 1
    for uid in runs[0]:
        np.testing.assert_array_equal(runs[0][uid], runs[1][uid])


@pytest.mark.parametrize("spec", [False, True])
def test_serving_greedy_tokens_equal_generate_on_the_card(cuda_device, spec):
    srv = _serving(cuda_device, n_slots=4, prefix_cache={"enabled": True, "n_slots": 4, "block": 8},
                   chunked_prefill={"enabled": True, "chunk_size": 16},
                   speculation={"enabled": spec, "depth": 4})
    reqs = _serve_requests(10, seed=3)
    res = srv.serve(reqs)
    for r in reqs:
        ref = srv.engine.generate(r.prompt[None], max_new_tokens=r.max_new_tokens)[0]
        np.testing.assert_array_equal(res[r.uid].tokens, ref)
    assert srv.compile_counts()["decode"] == 1


def test_serving_decode_graph_replay_launches_each_kernel_per_layer(cuda_device):
    """The profiler's kernel records over one replay: num_layers split and
    num_layers combine launches, as the counters recorded at capture."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.serving import pack_decode_inputs

    srv = _serving(cuda_device, n_slots=4)
    w, n, L = srv.worker, 4, _SERVE_TINY["num_layers"]
    packed = pack_decode_inputs(np.zeros(n), np.full(n, 9), np.full(n, w.Smax), np.ones(n, bool),
                                np.zeros(n, np.float32), np.zeros(n, np.int32), np.ones(n, np.float32))
    w._decode_program(packed)  # captures
    assert w.graph_launches == (L, L)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w._decode_program(packed)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("decode_split_kernel" in x for x in names) == L, names
    assert sum("decode_combine_kernel" in x for x in names) == L, names


def _two_replicas(device):
    from deepspeed_tpu_torch.inference import Router

    eng = deepspeed_tpu_torch.init_inference(tfm.Model(tfm.TransformerConfig(**_SERVE_TINY)),
                                             config={"dtype": "fp32"}, device=device)
    return Router(eng, config={"n_slots": 4, "router": {"replicas": 2, "health": {"timeout": 60.0}}})


def test_inprocess_replicas_capture_separate_graphs(cuda_device):
    """Two in-process replicas over one engine's parameters: each captures
    its own decode graph, in its own memory pool, over its own static
    input/output buffers and slot cache."""
    router = _two_replicas(cuda_device)
    for r in router._replicas:
        r.engine.warm_decode()
    a, b = (r.engine.worker for r in router._replicas)
    assert a._graph is not None and b._graph is not None and a._graph is not b._graph
    assert a._graph.pool() != b._graph.pool()
    for name in ("_static_in", "_static_out"):
        assert getattr(a, name).data_ptr() != getattr(b, name).data_ptr(), name
    assert a._cache["k"].data_ptr() != b._cache["k"].data_ptr()
    assert a.params is b.params  # the weights are shared, the state is not
    assert [r.engine.compile_counts()["decode"] for r in router._replicas] == [1, 1]


def test_worker_profiler_sees_each_replays_decode_kernels(cuda_device):
    """A WorkerHost's profiler window on the card: num_layers split and
    combine kernel records for each graph replay it saw; the boot warm-up
    (capture plus one replay) counts as no replay."""
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.inference.rpc import encode_request
    from deepspeed_tpu_torch.launcher.serving_worker import WorkerHost

    srv = _serving(cuda_device, n_slots=4)
    L = _SERVE_TINY["num_layers"]
    srv.warm_decode()
    assert srv.worker.graph_launches == (L, L) and srv.worker.decode_kernel_launches() == (0, 0)
    host = WorkerHost(srv)
    host.profile_decode_steps(3)
    for r in _serve_requests(4, seed=6):
        host.submit(encode_request(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=12)))
    for _ in range(6):
        host.step(now=0.0)
    rec = host.telemetry_snapshot()["decode_kernel_records"]
    assert rec is not None and rec["replays"] == 3, rec
    assert rec["split"] == rec["combine"] == L * rec["replays"], rec
    assert srv.worker.decode_kernel_launches() == (L * srv.worker.graph_replays,) * 2


def test_replay_of_one_replica_leaves_the_other_unchanged(cuda_device):
    """A replica's replays write only its own slot cache: the sibling's cache
    and graph output stay bitwise as they were; a replica the Router marks
    dead releases its cache and graph."""
    from deepspeed_tpu_torch.inference import Request

    router = _two_replicas(cuda_device)
    reqs = _serve_requests(8, seed=4)
    for r in reqs:
        router.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=24))
    for _ in range(4):
        router.step(now=0.0)
    a, b = (r.engine for r in router._replicas)
    assert a.n_active and b.n_active
    frozen = {kv: t.clone() for kv, t in b.worker._cache.items()}
    out_b = b.worker._static_out.clone()
    for _ in range(3):
        a.step(now=0.0)
    torch.cuda.synchronize()
    for kv in frozen:
        assert torch.equal(b.worker._cache[kv], frozen[kv]), kv
    assert torch.equal(b.worker._static_out, out_b)
    del frozen, out_b
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in b.worker._cache.values())
    router._fail(router._replicas[1], "dead", 0.0, [])
    torch.cuda.synchronize()
    assert b.worker._cache is None and b.worker._graph is None
    assert before - torch.cuda.memory_allocated() >= cache_bytes
    res = router.drain()
    assert all(r.ok for r in res.values()) and len(res) == 8


def _serve_via_gateway(gw, prompts, max_new, stream=True):
    """Greedy requests through the gateway; each reply's tokens (for SSE the
    token events, held against the done event's)."""
    import http.client
    import json

    out = []
    for p in prompts:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": [int(t) for t in p],
                                                              "max_new_tokens": max_new, "stream": stream}))
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        if not stream:
            out.append(json.loads(body)["tokens"])
            continue
        events = [b for b in body.split("\n\n") if b.strip()]
        toks = [json.loads(b.split("data: ", 1)[1])["token"] for b in events if "event: token" in b]
        done = [json.loads(b.split("data: ", 1)[1]) for b in events if "event: done" in b][0]
        assert done["status"] == "ok" and done["tokens"] == toks
        out.append(toks)
    return out


def test_sse_streams_while_an_inprocess_newcomer_captures(cuda_device):
    """A rolling upgrade started on the gateway's serve loop while SSE
    streams run: each newcomer builds and captures its decode graph on that
    loop (no broken capture), every stream equals the run without the
    upgrade, and the newcomers serve through their graphs."""
    import threading

    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway

    router = _two_replicas(cuda_device)
    for r in router._replicas:
        r.engine.warm_decode()
    prompts = [r.prompt for r in _serve_requests(6, seed=7)]
    go = threading.Event()

    def on_tick():
        if go.is_set() and router.upgrade_status() is None:
            router.rolling_upgrade()

    gw = HttpGateway(router, {"port": 0}, on_tick=on_tick)
    gw.start()
    try:
        base = _serve_via_gateway(gw, prompts, 20)
        results = {}
        worker = threading.Thread(target=lambda: results.update(out=_serve_via_gateway(gw, prompts, 20)))
        worker.start()
        go.set()
        worker.join(120)
        deadline = time.monotonic() + 120
        while router.upgrade_status() is None or router.upgrade_status()["state"] == "running":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        after = _serve_via_gateway(gw, prompts, 20, stream=False)
    finally:
        gw.stop()
        gw.close()
    assert results["out"] == base == after
    st = router.upgrade_status()
    assert st["state"] == "done" and all(w["outcome"] == "upgraded" for w in st["waves"])
    for w in st["waves"]:
        new = router._replicas[w["new_rid"]].engine
        assert new.worker._graph is not None and new.worker.graph_replays > 0
        assert new.compile_counts()["decode"] == 1


def test_retired_replica_frees_its_cache_pool_and_graph(cuda_device):
    """An in-process rolling upgrade: each old replica, drained and retired,
    releases its slot cache, prefix pool and graph, so device memory comes
    back to its level before the wave; a newcomer's greedy replays give the
    old generation's tokens bit for bit."""
    from deepspeed_tpu_torch.inference import Request, Router

    eng = deepspeed_tpu_torch.init_inference(tfm.Model(tfm.TransformerConfig(**_SERVE_TINY)),
                                             config={"dtype": "fp32"}, device=cuda_device)
    router = Router(eng, config={"n_slots": 4, "prefix_cache": {"enabled": True, "n_slots": 4, "block": 8},
                                 "router": {"replicas": 2, "health": {"timeout": 60.0}}})
    reqs = _serve_requests(8, seed=8)

    def serve(uid0):
        for r in reqs:
            router.submit(Request(uid=uid0 + r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        out = router.drain()
        return [out[uid0 + r.uid].tokens for r in reqs]

    old_tokens = serve(0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    router.rolling_upgrade()
    for k in range(400):
        router.step()
        st = router.upgrade_status()
        if st["state"] != "running" and "draining" not in router.replica_states().values():
            break
    assert st["state"] == "done", st
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    for rid in (0, 1):
        w = router._replicas[rid].engine.worker
        assert w._cache is None and w._pool is None and w._graph is None
    assert after <= before + (1 << 20), (before, after)
    new_tokens = serve(1000)
    for a, b in zip(old_tokens, new_tokens):
        np.testing.assert_array_equal(a, b)
    assert all(router._replicas[w["new_rid"]].engine.worker.graph_replays > 0 for w in st["waves"])


def test_dropout_masks_are_equal_on_the_cpu_and_the_card(cuda_device):
    """The counter-based hash gives the same keys and the same masks on
    both devices, from a step held on the device (no value fetched)."""
    step = torch.tensor(7, dtype=torch.int32, device=cuda_device)
    for micro in (0, 3):
        kc = tfm.dropout_key(1234, step + 1, micro)
        kh = tfm.dropout_key(1234, 8, micro)
        assert kc.device.type == "cuda" and int(kc) == int(kh)
        uc, uh = tfm._uniform(tfm._fold(kc, 2), (4, 33, 17)), tfm._uniform(tfm._fold(kh, 2), (4, 33, 17))
        assert torch.equal(uc.cpu(), uh)
        x = torch.ones(4, 33, 17)
        assert torch.equal(tfm._dropout(x.to(cuda_device), 0.25, kc).cpu(), tfm._dropout(x, 0.25, kh))


# ---------------------------------------------------------------------------
# Training resilience on the card: an injected NaN step through the kernels,
# and the async save's staging copy
# ---------------------------------------------------------------------------

_RESILIENCE_DS = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
                  "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 1000,
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _resilience_model():
    return tfm.Model(tfm.TransformerConfig(vocab_size=1000, max_seq_len=256, num_layers=3, num_heads=4,
                                           hidden_size=64, dtype=torch.bfloat16, attn_impl="flash",
                                           loss_impl="fused_xent"))


def test_kernels_keep_an_infinite_upstream_gradient_non_finite(cuda_device):
    """The NaN drill's +inf loss scale reaches the backward kernels as an
    infinite upstream gradient: neither the fused-loss ds/dW/dH passes nor
    the flash dK/dV and dQ may turn it into finite values (no clamped
    exponent, no saturating store)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    N, D, V = 256, 64, 1000
    h = torch.randn(N, D, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(D, V, generator=g, device=cuda_device) * 0.05).to(torch.bfloat16)
    y = torch.randint(0, V, (N,), generator=g, device=cuda_device, dtype=torch.int32)
    _, lse = fx.fused_xent_forward(h, w, y)
    dh, dw = fx.fused_xent_backward(h, w, y, lse, torch.full((N,), float("inf"), device=cuda_device))
    assert not torch.isfinite(dh.float()).any() and not torch.isfinite(dw.float()).any()
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, causal=True)
    dout = torch.full_like(out, float("inf"))
    delta = fa.flash_delta(out, dout)
    dk, dv = fa.flash_backward_dkdv(q, k, v, dout, lse, delta, causal=True)
    dq = fa.flash_backward_dq(q, k, v, dout, lse, delta, causal=True)
    for t in (dq, dk, dv):
        assert not torch.isfinite(t.float()).all()


def test_injected_nan_step_through_the_kernels_is_skipped(cuda_device):
    """nan_grad_steps [2] with the guardrail on: the step launches every
    flash and fused-loss kernel, comes out non-finite, and leaves the
    parameters and optimizer state bitwise as they were; the loss scale is
    restored and the next step trains."""
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=_resilience_model(), config={
        **_RESILIENCE_DS, "resilience": {"enabled": True, "fault_injection": {"enabled": True,
                                                                            "nan_grad_steps": [2]}}})
    tokens = np.random.default_rng(0).integers(0, 1000, size=(8, 257)).astype(np.int32)
    engine.train_batch({"tokens": tokens})
    before = [t.clone() for t in tree_leaves(engine.state["params"]) + tree_leaves(engine.state["opt"])]
    counters = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq) + _XENT_COUNTERS
    launched = [c.launches for c in counters]
    m = engine.train_batch({"tokens": tokens})
    assert [c.launches - b for c, b in zip(counters, launched)] == [3 * 2] * 3 + [2] * 5
    assert bool(m["overflow"]) and not np.isfinite(float(m["grad_norm"]))
    after = tree_leaves(engine.state["params"]) + tree_leaves(engine.state["opt"])
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert engine.skipped_steps == 1 and engine.get_global_step() == 1 and engine.loss_scale == 1.0
    m = engine.train_batch({"tokens": tokens})
    assert not bool(m["overflow"]) and engine.get_global_step() == 2


def test_async_save_snapshot_is_right_while_the_next_step_runs(cuda_device, tmp_path):
    """save_checkpoint returns after enqueueing the snapshot on a side stream;
    the next steps run at once and free the saved tensors, whose memory must
    not be reused before the copy ends. The committed checkpoint equals the
    state at the save, and the pinned buffer is allocated once."""
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=_resilience_model(), config={
        **_RESILIENCE_DS, "checkpoint": {"async_save": True}})
    tokens = np.random.default_rng(0).integers(0, 1000, size=(8, 257)).astype(np.int32)
    engine.train_batch({"tokens": tokens})
    want = [t.clone() for t in tree_leaves(engine.state)]
    engine.save_checkpoint(str(tmp_path))
    buf = engine.checkpoint_engine.staging._buf
    for _ in range(3):
        engine.train_batch({"tokens": tokens})
    engine.save_checkpoint(str(tmp_path))  # commits the first save, snapshots the second
    assert engine.checkpoint_engine.staging._buf is buf
    engine.checkpoint_engine.commit()
    fresh, _, _, _ = deepspeed_tpu_torch.initialize(model=_resilience_model(), config=_RESILIENCE_DS)
    fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    for a, b in zip(tree_leaves(fresh.state), want):
        assert torch.equal(a, b)
    fresh.load_checkpoint(str(tmp_path))
    for a, b in zip(tree_leaves(fresh.state), tree_leaves(engine.state)):
        assert torch.equal(a, b)


# Disaggregated serving on the card: the KV handoff into a captured graph.


def _disagg_router(device, prefill=1, decode=1, **config):
    from deepspeed_tpu_torch.inference import Router

    eng = deepspeed_tpu_torch.init_inference(tfm.Model(tfm.TransformerConfig(**_SERVE_TINY)),
                                             config={"dtype": "fp32"}, device=device)
    return eng, Router(eng, config={"n_slots": 4, **config, "router": {
        "health": {"timeout": 60.0},
        "disagg": {"enabled": True, "prefill_replicas": prefill, "decode_replicas": decode}}})


def test_kv_import_lands_in_the_captured_graphs_cache(cuda_device):
    """The decode replica captures its graph first; every handoff then
    copies into the cache tensors that graph captured (their addresses
    never move), and the replays decode from the imported KV: the greedy
    tokens equal a co-located engine's bit for bit (fp32)."""
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    eng, router = _disagg_router(cuda_device)
    pre, dec = (r.engine for r in router._replicas)
    dec.warm_decode()
    graph, ptrs = dec.worker._graph, {kv: t.data_ptr() for kv, t in dec.worker._cache.items()}
    reqs = _serve_requests(8, seed=7)
    for r in reqs:
        router.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    res = router.drain()
    assert dec.worker._graph is graph and {kv: t.data_ptr() for kv, t in dec.worker._cache.items()} == ptrs
    assert router.router_stats()["disagg"]["handoffs"] == 8 and dec.compile_counts()["decode"] == 1
    assert dec.worker.graph_replays > 0
    solo = ServingEngine(eng, config={"n_slots": 4})
    ref = solo.serve([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs])
    for r in reqs:
        np.testing.assert_array_equal(res[r.uid].tokens, ref[r.uid].tokens)


def test_prefill_replica_launches_no_decode_kernel(cuda_device):
    """The profiler over a disaggregated fleet's whole run: the decode
    kernels' records come only from the decode replica's replays (num_layers
    split + combine each), none from the prefill replica, which never
    captures a graph."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference import Request

    _, router = _disagg_router(cuda_device)
    pre, dec = (r.engine for r in router._replicas)
    dec.warm_decode()
    pre.warm_decode()
    L = _SERVE_TINY["num_layers"]
    for r in _serve_requests(6, seed=8):
        router.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        router.drain()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    replays = dec.worker.graph_replays
    assert pre.worker._graph is None and pre.worker.graph_replays == 0 and pre.compile_counts()["decode"] == 0
    assert replays > 0
    assert sum("decode_split_kernel" in x for x in names) == L * replays
    assert sum("decode_combine_kernel" in x for x in names) == L * replays


def test_bf16_windows_cross_a_tcp_worker(cuda_device, tmp_path):
    """A prefill-role and a decode-role worker process on the card over TCP
    (``--role``, one bf16 spec): the windows the prefill worker serves are
    bf16 tensors after the frame codec, every request is handed off, and
    the greedy streams equal an in-process co-located engine's."""
    import os
    import pathlib

    from deepspeed_tpu_torch.inference import Request, Router
    from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor, build_serving_engine
    from deepspeed_tpu_torch.runtime.config import RouterTransportConfig

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    spec = {"model": {**_SERVE_TINY, "dtype": "bfloat16"}, "engine_dtype": "bf16",
            "serving": {"n_slots": 4, "watchdog_mode": "raise"}}
    transport = RouterTransportConfig(call_timeout_s=120.0, boot_timeout_s=180.0, heartbeat_timeout_s=60.0,
                                      family="tcp", host="127.0.0.1", port_base=0)
    sup = WorkerSupervisor(spec, 2, transport=transport, roles={0: "prefill", 1: "decode"}, device="cuda",
                           workdir=str(tmp_path),
                           env={"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")})
    try:
        clients = sup.start()
        router = Router(config={"router": {"replicas": 2, "health": {"timeout": 120.0},
                                           "disagg": {"enabled": True}}}, replica_engines=clients)
        seen = []
        export = clients[0].kv_export_window

        def spy(*a, **kw):
            window = export(*a, **kw)
            seen.append(window["k"].dtype)
            return window

        clients[0].kv_export_window = spy
        reqs = _serve_requests(4, seed=9)
        for r in reqs:
            router.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        res = router.drain()
        assert seen and all(d == torch.bfloat16 for d in seen)
        assert router.router_stats()["disagg"]["handoffs"] == 4
        solo = build_serving_engine(spec, device="cuda")
        ref = solo.serve([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs])
        for r in reqs:
            np.testing.assert_array_equal(res[r.uid].tokens, ref[r.uid].tokens)
    finally:
        sup.shutdown()


_ELASTIC_WORKER = """
import json, os, signal, sys
import numpy as np
import torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
save, out, steps, crash = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
cfg = tfm.TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=64,
                            dtype=torch.bfloat16, attn_impl="flash", loss_impl="fused_xent")
ds = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 1000000,
      "elasticity": {"enabled": True, "max_train_batch_size": 8, "micro_batch_sizes": [2, 4], "max_gpus": 8,
                     "ignore_non_elastic_batch_info": True}}
eng = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds)[0]  # the card by default
assert eng.device.type == "cuda" and (eng.train_batch_size, eng.micro_batch_size) == (8, 4)
if save != "-" and os.path.exists(os.path.join(save, "latest")):
    eng.load_checkpoint(save)
gen = int(os.environ.get("DSTPU_ELASTIC_GENERATION", "0"))
hb = os.environ.get("DSTPU_ELASTIC_HEARTBEAT")
for step in range(eng.global_steps, steps):
    tokens = np.random.default_rng(100 + step).integers(0, 97, size=(8, 129)).astype(np.int32)
    loss = float(eng.train_batch({"tokens": tokens})["loss"])
    if hb:
        os.utime(hb)
    if save != "-":
        eng.save_checkpoint(save)
    with open(out, "a") as f:
        f.write(json.dumps({"gen": gen, "step": step + 1, "loss": loss}) + "\\n")
    if gen == 0 and step + 1 == crash:
        os.kill(os.getpid(), signal.SIGKILL)
"""


def test_elastic_agent_relaunch_resumes_bitwise_on_the_card(cuda_device, tmp_path):
    """A worker training a small bf16 model through the flash and fused-loss
    kernels saves after every step and SIGKILLs itself after step 3; the
    agent relaunches it, generation 1 loads 'latest' and trains to step 6,
    and steps 4-6 give the losses of an uninterrupted 6-step process."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from deepspeed_tpu_torch.elasticity import DSElasticAgent, WorkerSpec

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    straight = tmp_path / "straight.jsonl"
    subprocess.run([sys.executable, "-c", _ELASTIC_WORKER, "-", str(straight), "6", "0"], check=True,
                   env={**os.environ, **env}, timeout=600)
    resumed = tmp_path / "resumed.jsonl"
    ds = {"elasticity": {"enabled": True, "max_train_batch_size": 8, "micro_batch_sizes": [2, 4], "max_gpus": 8}}
    agent = DSElasticAgent(ds, WorkerSpec(command=[sys.executable, "-c", _ELASTIC_WORKER, str(tmp_path / "ckpt"),
                                                   str(resumed), "6", "3"], extra_env=env),
                           static_world_size=1, monitor_interval=0.1, max_restarts=2,
                           heartbeat_file=str(tmp_path / "hb"), heartbeat_timeout=300.0,
                           restart_backoff={"base_delay_s": 0.0, "max_delay_s": 0.0, "jitter": 0.0})
    assert agent.run() == 0 and agent.restart_count == 1
    want = [json.loads(line) for line in straight.read_text().splitlines()]
    got = [json.loads(line) for line in resumed.read_text().splitlines()]
    assert [(r["gen"], r["step"]) for r in got] == [(0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (1, 6)]
    assert [r["loss"] for r in got] == [r["loss"] for r in want]  # bitwise, across processes
