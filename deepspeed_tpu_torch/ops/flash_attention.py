"""Flash attention for training: forward and backward.

``flash_attention`` is the port of ``deepspeed_tpu/ops/pallas/flash_attention.py``
``flash_attention`` (same signature and contract; q/k/v and the output are
[B, S, H, D], in fp32, bf16 or fp16). Its forward is the ``torch.library``
custom op ``dstt::flash_attention_fwd`` -> (out, lse), whose autograd saves
``(q, k, v, out, lse)`` and recomputes the probabilities in the backward
(the FlashAttention-2 decomposition). Being an op of the dispatcher, it is
visible to ``torch.utils.checkpoint``'s selective policies, so a remat
policy can save its outputs (the JAX package's ``flash_out``/``flash_lse``
names) instead of running it again in the backward.

On CUDA tensors it launches the hand-written kernels of
``csrc/flash_attention.cu`` through three entry points, each with its own
``.launches`` counter: ``flash_forward`` (O and lse), ``flash_backward_dkdv``
and ``flash_backward_dq``. On CPU tensors it runs the plain versions
``flash_attention_reference`` and ``flash_attention_backward_reference``. A
CUDA tensor never takes the plain path: the kernels launch or the call
raises.

The 16-bit kernels (forward, dK/dV and dQ) load their tiles by TMA, which
needs 16-byte rows and strides: a head dim that is a multiple of 8, bases
at 16 bytes, batch/sequence/head strides that are positive multiples of 8
elements. For inputs that are not so (``needs_padding``), the wrapper
chooses before the launch to copy them into contiguous buffers zero-padded
along the head dim (``pad_head_dim``; zero columns change no product) and
slices the outputs back; the softmax scale stays that of the real head dim.

ALiBi slopes and a runtime local window are fused into the score
computation (no [S, S] bias tensor); a dense ``bias`` raises
``NotImplementedError``, as in the JAX package. The JAX wrapper's 128-padding
becomes a bounds check in the kernels, with the same ``ValueError``s where
JAX raises. ``block_q``/``block_k`` are validated as the JAX wrapper does but
do not choose the CUDA tiles (bf16/fp16: 128 query rows by 128 or 64 keys in
the forward, 128 keys by 64 query rows in dK/dV, 128 query rows by 64 keys
in dQ; fp32: 32x32).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..telemetry import cost
from . import op_builder

NEG_INF = -1e30  # the kernels' masked-score constant (Pallas: NEG_INF)
MAX_BLOCK_Q = 512
MAX_BLOCK_K = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128


def _auto_block(s: int, cap: int) -> int:
    b = cap
    while b > 128 and s % b:
        b //= 2
    return min(b, s)


def _check(q, k, v, causal, bias, block_q, block_k, alibi_slopes):
    """The JAX wrapper's argument rules (``flash_attention.py:522-561``)."""
    if bias is not None:
        raise NotImplementedError("flash_attention: dense additive bias not fused; use attn_impl='xla'")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be [B, S, H, D]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if alibi_slopes is not None and tuple(alibi_slopes.shape) != (H,):
        raise ValueError(f"alibi_slopes must be [H={H}], got {tuple(alibi_slopes.shape)}")
    pad_q, pad_k = (-Sq) % 128, (-Sk) % 128
    if pad_q or pad_k:
        if not causal:
            raise ValueError(f"non-causal flash_attention needs 128-aligned lengths, got ({Sq}, {Sk})")
        if Sq != Sk:
            raise ValueError(f"cross-attention lengths ({Sq}, {Sk}) must be 128-aligned")
    Sq_p, Sk_p = Sq + pad_q, Sk + pad_k
    bq = min(block_q, Sq_p) if block_q else _auto_block(Sq_p, MAX_BLOCK_Q)
    bk = min(block_k, Sk_p) if block_k else _auto_block(Sk_p, MAX_BLOCK_K)
    if Sq_p % bq or Sk_p % bk:
        raise ValueError(
            f"sequence lengths ({Sq_p}, {Sk_p}) must be divisible by blocks ({bq}, {bk})")


def _scores(q, k, causal, scale, alibi_slopes, window):
    """[B, H, Sq, Sk] fp32 scores with ALiBi, window and causal masks, in the
    Pallas ``_block_scores`` order."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    if alibi_slopes is not None:
        s = s + alibi_slopes.float()[None, :, None, None] * (k_pos - q_pos).float()
    if window is not None:
        w = torch.as_tensor(window, dtype=torch.float32, device=q.device)
        s = torch.where((w <= 0) | ((q_pos - k_pos).float() < w), s, NEG_INF)
    if causal:
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    return s


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def flash_attention_reference(q, k, v, causal=True, sm_scale=None, alibi_slopes=None, window=None):
    """The plain forward -> (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    fp32). P is rounded to the input dtype before the P·V product and the sum
    accumulates in fp32, as in the kernels."""
    scale = _default_scale(q, sm_scale)
    s = _scores(q, k, causal, scale, alibi_slopes, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal=True, sm_scale=None,
                                       alibi_slopes=None, window=None):
    """The plain FlashAttention-2 backward -> (dq, dk, dv) in q's dtype. P is
    recomputed from ``lse`` ([B, H, Sq] or [B·H, Sq]); Δ = rowsum(dO∘O) in fp32
    from the rounded O; P and dS are rounded to the input dtype before their
    products, as in the kernels."""
    B, Sq, H, _ = q.shape
    dt = q.dtype
    scale = _default_scale(q, sm_scale)
    s = _scores(q, k, causal, scale, alibi_slopes, window)
    p = torch.exp(s - lse.reshape(B, H, Sq)[..., None].float())
    do32 = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do32).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    delta = (do32 * out.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = (scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())).to(dt)
    dq = (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(dt)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA entry points
# ---------------------------------------------------------------------------

_PTRS = ("q", "k", "v", "dout", "out", "dq", "dk", "dv", "lse", "delta", "slopes", "window")
_STRIDES = ("q_str", "k_str", "v_str", "do_str", "out_str", "dq_str", "dk_str", "dv_str")


class _Params(ctypes.Structure):
    """Mirror of ``FlashParams`` in ``csrc/flash_attention.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong * 3) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in ("B", "Sq", "Sk", "H", "D", "causal", "dtype")]
                + [("scale", ctypes.c_float)])


def _bind(name: str):
    fn = getattr(op_builder.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _extras(q, alibi_slopes, window):
    """ALiBi slopes and the window as fp32 device tensors (or None). A
    Python window becomes a one-element device fill, so no host-to-device
    copy waits on the stream."""
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    w = None
    if window is not None:
        if torch.is_tensor(window):
            w = window.to(device=q.device, dtype=torch.float32).reshape(1)
        else:
            w = torch.full((1,), float(window), dtype=torch.float32, device=q.device)
    return slopes, w


def _params(q, k, v, causal, scale, slopes, window, **tensors):
    """Check what the kernels take and fill the parameter block."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, not {q.device}; "
                         "CPU tensors take flash_attention_reference")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32, bfloat16 or float16, not {q.dtype}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"the flash kernels take head dim 1..{_MAX_D}, got {D}")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and Sq >= 1 and Sk >= 1):
        raise ValueError(f"the flash kernels take 1 <= B, H <= 65535 and S >= 1; got {B}, {H}, {Sq}, {Sk}")
    p = _Params()
    named = dict(q=q, k=k, v=v, **tensors)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32 [B, H, Sq]")
        else:
            if t.dtype != q.dtype:
                raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name} needs a contiguous last dimension")
            stride_name = "do_str" if name == "dout" else f"{name}_str"
            setattr(p, stride_name, (ctypes.c_longlong * 3)(*t.stride()[:3]))
        setattr(p, name, t.data_ptr())
    p.slopes = slopes.data_ptr() if slopes is not None else None
    p.window = window.data_ptr() if window is not None else None
    p.B, p.Sq, p.Sk, p.H, p.D = B, Sq, Sk, H, D
    p.causal, p.dtype, p.scale = int(bool(causal)), _DTYPE_CODES[q.dtype], scale
    return p


def _launch(name: str, p: _Params, device):
    fn = _bind(name)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_ROW_ALIGN = 8  # elements of a 16-bit row or stride: TMA's 16 bytes


def needs_padding(*tensors) -> bool:
    """Whether the 16-bit Hopper kernels (forward, dK/dV, dQ) cannot read
    these [B, S, H, D] tensors where they lie: a head dim or a
    batch/sequence/head stride that is not a multiple of 8 elements, or a
    base not at 16 bytes. fp32 tensors take the scalar kernels, which read
    any of them."""
    return any(t.dtype != torch.float32 and (
        t.shape[-1] % _ROW_ALIGN or t.data_ptr() % 16
        or any(st <= 0 or st % _ROW_ALIGN for st in t.stride()[:3])) for t in tensors)


def pad_head_dim(*tensors):
    """Contiguous copies of [..., D] tensors zero-padded to a head dim that is
    a multiple of 8 (a fresh allocation is 16-byte aligned)."""
    pad = -tensors[0].shape[-1] % _ROW_ALIGN
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous() for t in tensors)


def flash_forward(q, k, v, *, causal=True, sm_scale=None, alibi_slopes=None, window=None):
    """Forward kernel -> (out [B, Sq, H, D], lse [B, H, Sq] fp32). CUDA only."""
    scale = _default_scale(q, sm_scale)
    slopes, w = _extras(q, alibi_slopes, window)
    D = q.shape[-1]
    padded = needs_padding(q, k, v)
    if padded:
        q, k, v = pad_head_dim(q, k, v)
    B, Sq, H, Dp = q.shape
    out = torch.empty((B, Sq, H, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, causal, scale, slopes, w, out=out, lse=lse)
    _launch("dstt_flash_fwd", p, q.device)
    flash_forward.launches += 1
    return (out[..., :D].contiguous() if padded else out), lse


def flash_backward_dkdv(q, k, v, dout, lse, delta, *, causal=True, sm_scale=None,
                        alibi_slopes=None, window=None):
    """dK/dV kernel -> (dk, dv) [B, Sk, H, D]. ``lse`` and ``delta`` are
    [B, H, Sq] fp32. CUDA only."""
    scale = _default_scale(q, sm_scale)
    slopes, w = _extras(q, alibi_slopes, window)
    D = q.shape[-1]
    padded = needs_padding(q, k, v, dout)
    if padded:
        q, k, v, dout = pad_head_dim(q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p = _params(q, k, v, causal, scale, slopes, w, dout=dout, lse=lse, delta=delta, dk=dk, dv=dv)
    _launch("dstt_flash_bwd_dkdv", p, q.device)
    flash_backward_dkdv.launches += 1
    if padded:
        return dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


def flash_backward_dq(q, k, v, dout, lse, delta, *, causal=True, sm_scale=None,
                      alibi_slopes=None, window=None):
    """dQ kernel -> dq [B, Sq, H, D]. CUDA only."""
    scale = _default_scale(q, sm_scale)
    slopes, w = _extras(q, alibi_slopes, window)
    D = q.shape[-1]
    padded = needs_padding(q, k, v, dout)
    if padded:
        q, k, v, dout = pad_head_dim(q, k, v, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p = _params(q, k, v, causal, scale, slopes, w, dout=dout, lse=lse, delta=delta, dq=dq)
    _launch("dstt_flash_bwd_dq", p, q.device)
    flash_backward_dq.launches += 1
    return dq[..., :D].contiguous() if padded else dq


flash_forward.launches = 0  # kernel launches since the last reset to 0
flash_backward_dkdv.launches = 0
flash_backward_dq.launches = 0


def flash_delta(out, dout):
    """Δ = rowsum(dO∘O) in fp32 -> [B, H, Sq] contiguous (plain PyTorch, as
    the JAX package leaves it to XLA)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def causal_pairs(Sq: int, Sk: int) -> int:
    """Live (query, key) pairs of one (b, h) under the causal mask (key k
    attends query q when k <= q)."""
    if Sq <= Sk:
        return Sq * (Sq + 1) // 2
    return Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk


def flash_cost(B: int, Sq: int, Sk: int, H: int, D: int, elt: int, causal: bool = True) -> dict:
    """{kernel: (flops, bytes)} of the three flash kernels at these shapes,
    the work behind each one's bound: every input read once and every
    output written once; 2 flops per multiply-add of each D-long product,
    over the live (q, k) pairs (a local window is counted as causal)."""
    tq, tk = B * Sq * H * D * elt, B * Sk * H * D * elt
    rows = B * H * Sq * 4
    pairs = B * H * (causal_pairs(Sq, Sk) if causal else Sq * Sk)
    return {"flash_forward": (2 * 2 * D * pairs, 2 * tq + 2 * tk + rows),             # q,k,v -> O, lse
            "flash_backward_dkdv": (4 * 2 * D * pairs, 2 * tq + 4 * tk + 2 * rows),   # q,k,v,dO,lse,Δ -> dK,dV
            "flash_backward_dq": (3 * 2 * D * pairs, 3 * tq + 2 * tk + 2 * rows)}     # q,k,v,dO,lse,Δ -> dQ


def _costs(q, k, causal, names):
    B, Sq, H, D = q.shape
    work = flash_cost(B, Sq, k.shape[1], H, D, q.element_size(), causal)
    return {n: work[n] for n in names}


@torch.library.custom_op("dstt::flash_attention_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: Optional[torch.Tensor],
                  window: Optional[torch.Tensor], causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward kernel on CUDA tensors, the plain version on CPU ones."""
    kw = dict(causal=causal, sm_scale=scale, alibi_slopes=slopes, window=window)
    with cost.kernel(q.device, lambda: _costs(q, k, causal, ("flash_forward",))):
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, **kw)
        return flash_forward(q, k, v, **kw)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, slopes, window, causal, scale = inputs
    out, lse = output
    # lse saved as [B, H, S] fp32, the Pallas residual without its 128-lane broadcast
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.kw = dict(causal=causal, sm_scale=scale, alibi_slopes=slopes, window=window)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    names = ("flash_backward_dkdv", "flash_backward_dq")
    with cost.kernel(q.device, lambda: _costs(q, k, ctx.kw["causal"], names)):
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_reference(q, k, v, out, lse, dout, **ctx.kw)
        else:
            if dout.stride(-1) != 1:
                dout = dout.contiguous()
            delta = flash_delta(out, dout)
            dk, dv = flash_backward_dkdv(q, k, v, dout, lse, delta, **ctx.kw)
            dq = flash_backward_dq(q, k, v, dout, lse, delta, **ctx.kw)
    return dq, dk, dv, None, None, None, None


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)
FLASH_FORWARD_OP = torch.ops.dstt.flash_attention_fwd.default


def flash_attention(q, k, v, causal: bool = True, bias=None, sm_scale=None, block_q=None,
                    block_k=None, alibi_slopes=None, window=None):
    """Fused attention over [B, S, H, D] -> [B, S, H, D], differentiable.

    ``alibi_slopes`` [H] adds ``slope_h·(k − q)``; ``window`` (a number or a
    0-d tensor, <= 0 means global) keeps keys with ``q − k < window``. Causal
    self-attention takes any length; non-causal or cross-attention lengths
    must be 128-aligned, as in the JAX package."""
    _check(q, k, v, causal, bias, block_q, block_k, alibi_slopes)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    if window is not None and not torch.is_tensor(window):
        window = torch.full((), float(window), device=q.device)  # a fill, not a host-to-device copy
    out, _ = _flash_fwd_op(q, k, v, alibi_slopes, window, bool(causal), _default_scale(q, sm_scale))
    return out
