"""Block-sparse flash attention over a static block layout: forward and
backward.

``sparse_flash_attention`` is the port of
``deepspeed_tpu/ops/sparse_attention/kernels.py`` ``sparse_flash_attention``
(same signature and argument rules, q/k/v and the output [B, S, H, D] in
fp32, bf16 or fp16). The [nq, nk] 0/1 layout of a ``SparsityConfig`` is
compressed by ``layout_to_lists`` into each query block's list of active
key blocks and each key block's list of query blocks; the four lists are
uploaded once per (sequence length, layout, causal, device) as int32 device
tensors (``device_lists``) and reused by every layer and micro-batch, so no
call waits on a host-to-device copy.

On CUDA tensors it launches the hand-written kernels of
``csrc/sparse_attention.cu`` through three entry points, each with its own
``.launches`` counter: ``sparse_forward`` (O and lse), ``sparse_backward_dq``
and ``sparse_backward_dkdv``; Δ = rowsum(dO∘O) is the flash port's plain
``flash_delta``. The 16-bit forward and backward at blocks 64 and 128
(``hopper_route``) run on the Hopper kernels, which read their tiles by TMA:
inputs TMA cannot read go to the flash port's padded copies
(``needs_padding`` → ``pad_head_dim``) before the launch and the outputs are
sliced back. Their grid orders come with the lists (``grid_orders``):
``dq_order`` runs the query blocks (forward and dQ) and ``dkdv_order`` the
key blocks longest list first, one CTA walking each whole list.

On CPU tensors it runs the plain versions ``sparse_attention_reference`` and
``sparse_attention_backward_reference``, which compute the same function
over the same lists by gathering each query block's active key blocks
(memory O(S · max_a · block), not S²). A CUDA tensor never takes the plain
path: the kernels launch or the call raises.

The forward is a ``torch.autograd.Function`` saving (q, k, v, out, lse); it
carries no checkpoint name, so every remat policy recomputes it, as every
JAX remat policy recomputes the Pallas sparse forward.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...telemetry import cost
from .. import op_builder
from ..flash_attention import flash_delta, needs_padding, pad_head_dim

NEG_INF = -1e30  # the kernels' masked-score constant (Pallas: NEG_INF)
BLOCKS = (16, 32, 64, 128)  # the block sizes the kernels take
HOPPER_BLOCKS = (64, 128)  # the blocks whose 16-bit kernels run on Hopper's wgmma and TMA
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128


def layout_to_lists(layout: np.ndarray, causal: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[nq, nk] 0/1 block layout -> (k_lists [nq, A], k_counts [nq],
    q_lists [nk, Aq], q_counts [nk]); lists padded with the row's last valid
    entry (so clamped re-fetches hit a hot block). Causal masks the upper
    block triangle first. (Copied from the JAX package.)"""
    layout = np.asarray(layout, dtype=bool)
    nq, nk = layout.shape
    if causal:
        layout = np.tril(layout)
    if not layout.any(axis=1).all():
        raise ValueError("sparsity layout leaves some query block with no keys")
    counts_k = layout.sum(axis=1)
    A = int(counts_k.max())
    k_lists = np.zeros((nq, A), np.int32)
    for q in range(nq):
        idx = np.nonzero(layout[q])[0]
        k_lists[q, : len(idx)] = idx
        k_lists[q, len(idx):] = idx[-1]
    counts_q = layout.sum(axis=0)
    Aq = int(max(1, counts_q.max()))
    q_lists = np.zeros((nk, Aq), np.int32)
    for k in range(nk):
        idx = np.nonzero(layout[:, k])[0]
        if len(idx) == 0:
            continue  # key block never attended; grid step masked out
        q_lists[k, : len(idx)] = idx
        q_lists[k, len(idx):] = idx[-1]
    return k_lists, counts_k.astype(np.int32), q_lists, counts_q.astype(np.int32)


def grid_orders(k_counts, q_counts):
    """The Hopper kernels' grid orders from a layout's list lengths ->
    (dq_order [nq], dkdv_order [nk]), int32: the query blocks and the key
    blocks, longest list first (ties in block order)."""
    return tuple(np.argsort(-np.asarray(c), kind="stable").astype(np.int32) for c in (k_counts, q_counts))


class SparseLists(NamedTuple):
    """One layout's lists as int32 tensors on one device, its block, and
    the Hopper kernels' grid orders (``grid_orders``)."""

    k_lists: torch.Tensor   # [nq, max_a]
    k_counts: torch.Tensor  # [nq]
    q_lists: torch.Tensor   # [nk, max_aq]
    q_counts: torch.Tensor  # [nk]
    block: int
    dq_order: torch.Tensor    # [nq]
    dkdv_order: torch.Tensor  # [nk]
    pairs: Optional[int] = None  # active (query block, key block) pairs, counted on the host


# (seq_len, causal, device, layout shape, layout bytes) -> SparseLists
LIST_CACHE: dict[tuple, SparseLists] = {}


def _shared_layout(layout) -> np.ndarray:
    """A [nq, nk] bool layout from a [nq, nk] or [H, nq, nk] one whose heads
    agree (the JAX wrapper's rule)."""
    layout = np.asarray(layout)
    if layout.ndim == 3:
        if layout.shape[0] != 1 and not (layout == layout[0]).all():
            raise NotImplementedError("per-head layouts not supported; use a shared layout")
        layout = layout[0]
    return layout.astype(bool)


def device_lists(layout, causal: bool, seq_len: int, device) -> SparseLists:
    """The lists of ``layout`` (shared across heads) for ``seq_len`` on
    ``device``, built on the host and uploaded once; later calls with the
    same length, layout, causality and device get the cached tensors."""
    layout = _shared_layout(layout)
    device = torch.device(device)
    key = (int(seq_len), bool(causal), str(device), layout.shape, layout.tobytes())
    hit = LIST_CACHE.get(key)
    if hit is None:
        arrays = layout_to_lists(layout, causal)
        arrays += grid_orders(arrays[1], arrays[3])
        lists = [torch.from_numpy(a).to(device) for a in arrays]
        hit = SparseLists(*lists[:4], block=seq_len // layout.shape[0], dq_order=lists[4], dkdv_order=lists[5],
                          pairs=int(arrays[1].sum()))
        LIST_CACHE[key] = hit
    return hit


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def _gathered_scores(q, k, lists: SparseLists, causal: bool, scale: float):
    """(scores [B, H, nq, blk, A, blk] fp32 with the causal and padding masks
    at NEG_INF, key-block index [nq, A] int64, the kernels' view of q as
    [B, nq, blk, H, D] fp32, and the padding mask [nq, 1, A, 1]: the list
    entries past k_counts, which the kernels never walk)."""
    B, S, H, D = q.shape
    blk = lists.block
    nq, A = lists.k_lists.shape
    kl = lists.k_lists.to(q.device).long()
    counts = lists.k_counts.to(q.device).long()
    qb = q.float().reshape(B, nq, blk, H, D)
    kg = k.reshape(B, S // blk, blk, H, D)[:, kl]  # [B, nq, A, blk, H, D]
    s = torch.einsum("bqihd,bqajhd->bhqiaj", qb, kg.float()) * scale
    pad = (torch.arange(A, device=q.device)[None, :] >= counts[:, None])[:, None, :, None]
    masked = pad
    if causal:
        q_pos = torch.arange(nq, device=q.device)[:, None] * blk + torch.arange(blk, device=q.device)[None, :]
        k_pos = kl[:, :, None] * blk + torch.arange(blk, device=q.device)[None, None, :]
        masked = masked | (q_pos[:, :, None, None] < k_pos[:, None, :, :])  # [nq, blk, A, blk]
    return torch.where(masked, NEG_INF, s), kl, qb, pad


def sparse_attention_reference(q, k, v, lists: SparseLists, causal: bool = True, sm_scale=None):
    """The plain forward over ``lists`` -> (out [B, S, H, D] in q's dtype,
    lse [B, H, S] fp32). P is rounded to the input dtype before the P·V
    product and the sum accumulates in fp32, as in the kernels. Padding
    entries add nothing, so a query block whose list is empty gets O = 0
    and lse = NEG_INF, as the Pallas kernel and the kernels give it."""
    B, S, H, D = q.shape
    blk = lists.block
    s, kl, _, pad = _gathered_scores(q, k, lists, causal, _default_scale(q, sm_scale))
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = torch.where(pad, 0.0, torch.exp(s - m))
    l = p.sum(dim=(-2, -1), keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    vg = v.reshape(B, S // blk, blk, H, D)[:, kl]
    acc = torch.einsum("bhqiaj,bqajhd->bqihd", p.to(q.dtype).float(), vg.float())
    out = acc / l_safe[..., 0, 0].permute(0, 2, 3, 1)[..., None]
    lse = (m + torch.log(l_safe))[..., 0, 0].reshape(B, H, S)
    return out.to(q.dtype).reshape(B, S, H, D), lse


def sparse_attention_backward_reference(q, k, v, out, lse, dout, lists: SparseLists, causal: bool = True,
                                        sm_scale=None):
    """The plain backward over ``lists`` -> (dq, dk, dv) in q's dtype. P is
    recomputed from ``lse`` [B, H, S]; Δ = rowsum(dO∘O) in fp32 from the
    rounded O; P and dS are rounded to the input dtype before their
    products, as in the kernels. dK and dV sum each query block's
    contributions into the key blocks of its list (``index_add_``); a key
    block no query attends gets exact zeros."""
    B, S, H, D = q.shape
    blk = lists.block
    dt = q.dtype
    scale = _default_scale(q, sm_scale)
    s, kl, qb, pad = _gathered_scores(q, k, lists, causal, scale)
    nq, A = kl.shape
    p = torch.where(pad, 0.0, torch.exp(s - lse.float().reshape(B, H, nq, blk)[..., None, None]))
    do32 = dout.float().reshape(B, nq, blk, H, D)
    kg = k.reshape(B, S // blk, blk, H, D)[:, kl].float()
    vg = v.reshape(B, S // blk, blk, H, D)[:, kl].float()
    dv_g = torch.einsum("bhqiaj,bqihd->bqajhd", p.to(dt).float(), do32)
    dp = torch.einsum("bqihd,bqajhd->bhqiaj", do32, vg)
    delta = (do32 * out.float().reshape(B, nq, blk, H, D)).sum(-1).permute(0, 3, 1, 2)  # [B, H, nq, blk]
    ds = (p * (dp - delta[..., None, None])).to(dt).float()
    dq = scale * torch.einsum("bhqiaj,bqajhd->bqihd", ds, kg)
    dk_g = scale * torch.einsum("bhqiaj,bqihd->bqajhd", ds, qb)
    dk = torch.zeros(B, S // blk, blk, H, D, device=q.device)
    dv = torch.zeros(B, S // blk, blk, H, D, device=q.device)
    idx = kl.reshape(-1)
    dk.index_add_(1, idx, dk_g.reshape(B, nq * A, blk, H, D))
    dv.index_add_(1, idx, dv_g.reshape(B, nq * A, blk, H, D))
    return tuple(t.reshape(B, S, H, D).to(dt) for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# CUDA entry points
# ---------------------------------------------------------------------------

_TABLES = ("k_lists", "k_counts", "q_lists", "q_counts", "dq_order", "dkdv_order")
_PTRS = ("q", "k", "v", "dout", "out", "dq", "dk", "dv", "lse", "delta") + _TABLES
_STRIDES = ("q_str", "k_str", "v_str", "do_str", "out_str", "dq_str", "dk_str", "dv_str")


class _Params(ctypes.Structure):
    """Mirror of ``SparseParams`` in ``csrc/sparse_attention.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong * 3) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "D", "block", "max_a", "max_aq", "causal", "dtype")]
                + [("scale", ctypes.c_float)])


def _bind(name: str):
    fn = getattr(op_builder.load("sparse_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _params(q, k, v, lists: SparseLists, causal, scale, **tensors):
    """Check what the kernels take and fill the parameter block."""
    if q.device.type != "cuda":
        raise ValueError(f"the sparse kernels run on CUDA tensors, not {q.device}; "
                         "CPU tensors take sparse_attention_reference")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the sparse kernels take float32, bfloat16 or float16, not {q.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be [B, S, H, D] of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    blk = lists.block
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"the sparse kernels take head dim 1..{_MAX_D}, got {D}")
    if blk not in BLOCKS:
        raise ValueError(f"the sparse kernels take block {BLOCKS}, got {blk}")
    if S % blk or not (1 <= B <= 65535 and 1 <= H <= 65535):
        raise ValueError(f"the sparse kernels take S a multiple of the block ({blk}) and 1 <= B, H <= 65535; "
                         f"got B={B}, S={S}, H={H}")
    nq, nk = lists.k_lists.shape[0], lists.q_lists.shape[0]
    if nq * blk != S or nk * blk != S or lists.k_counts.shape != (nq,) or lists.q_counts.shape != (nk,):
        raise ValueError(f"the lists ({nq} x {nk} blocks of {blk}) do not cover S={S}")
    p = _Params()
    for name in _TABLES:
        t = getattr(lists, name)
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {q.device} (see device_lists)")
        setattr(p, name, t.data_ptr())
    named = dict(q=q, k=k, v=v, **tensors)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (B, H, S):
                raise ValueError(f"{name} must be contiguous float32 [B, H, S]")
        else:
            if t.dtype != q.dtype:
                raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
            if t.shape != q.shape:
                raise ValueError(f"{name} is {tuple(t.shape)}, q is {tuple(q.shape)}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name} needs a contiguous last dimension")
            stride_name = "do_str" if name == "dout" else f"{name}_str"
            setattr(p, stride_name, (ctypes.c_longlong * 3)(*t.stride()[:3]))
        setattr(p, name, t.data_ptr())
    p.B, p.S, p.H, p.D, p.block = B, S, H, D, blk
    p.max_a, p.max_aq = lists.k_lists.shape[1], lists.q_lists.shape[1]
    p.causal, p.dtype, p.scale = int(bool(causal)), _DTYPE_CODES[q.dtype], scale
    return p


def _launch(name: str, p: _Params, device):
    fn = _bind(name)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def sparse_forward(q, k, v, lists: SparseLists, *, causal=True, sm_scale=None):
    """Forward kernel -> (out [B, S, H, D], lse [B, H, S] fp32). CUDA only."""
    scale = _default_scale(q, sm_scale)
    D = q.shape[-1]
    padded = hopper_route(q.dtype, lists.block) and needs_padding(q, k, v)
    if padded:
        q, k, v = pad_head_dim(q, k, v)
    B, S, H, Dp = q.shape
    out = torch.empty((B, S, H, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, lists, causal, scale, out=out, lse=lse)
    _launch("dstt_sparse_fwd", p, q.device)
    sparse_forward.launches += 1
    return (out[..., :D].contiguous() if padded else out), lse


def hopper_route(dtype, block: int) -> bool:
    """Whether the forward, dQ and dK/dV of these inputs run on the Hopper
    kernels, which read by TMA: 16-bit inputs at block 64 or 128. The C
    entry points choose by the same rule and refuse what TMA cannot read."""
    return dtype in (torch.bfloat16, torch.float16) and block in HOPPER_BLOCKS


def sparse_backward_dq(q, k, v, dout, lse, delta, lists: SparseLists, *, causal=True, sm_scale=None):
    """dQ kernel -> dq [B, S, H, D]. ``lse`` and ``delta`` are [B, H, S]
    fp32. CUDA only."""
    scale = _default_scale(q, sm_scale)
    D = q.shape[-1]
    padded = hopper_route(q.dtype, lists.block) and needs_padding(q, k, v, dout)
    if padded:
        q, k, v, dout = pad_head_dim(q, k, v, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p = _params(q, k, v, lists, causal, scale, dout=dout, lse=lse, delta=delta, dq=dq)
    _launch("dstt_sparse_bwd_dq", p, q.device)
    sparse_backward_dq.launches += 1
    return dq[..., :D].contiguous() if padded else dq


def sparse_backward_dkdv(q, k, v, dout, lse, delta, lists: SparseLists, *, causal=True, sm_scale=None):
    """dK/dV kernel -> (dk, dv) [B, S, H, D]. CUDA only."""
    scale = _default_scale(q, sm_scale)
    D = q.shape[-1]
    padded = hopper_route(q.dtype, lists.block) and needs_padding(q, k, v, dout)
    if padded:
        q, k, v, dout = pad_head_dim(q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p = _params(q, k, v, lists, causal, scale, dout=dout, lse=lse, delta=delta, dk=dk, dv=dv)
    _launch("dstt_sparse_bwd_dkdv", p, q.device)
    sparse_backward_dkdv.launches += 1
    if padded:
        return dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


sparse_forward.launches = 0  # kernel launches since the last reset to 0
sparse_backward_dq.launches = 0
sparse_backward_dkdv.launches = 0


def sparse_cost(B: int, S: int, H: int, D: int, elt: int, lists: SparseLists) -> dict:
    """{kernel: (flops, bytes)} of the three block-sparse kernels at these
    shapes, the work behind each bound: every input read once (the lists a
    kernel walks included) and every output written once; the layout's
    active block pairs, diagonal blocks counted whole, 4·block²·D flops a
    pair and (b, h) forward, 6 for dQ, 8 for dK/dV."""
    t = B * S * H * D * elt
    rows = B * H * S * 4
    active = lists.pairs if lists.pairs is not None else int(lists.k_counts.sum())
    pairs = active * B * H
    per = lists.block ** 2 * D
    kq = (lists.k_lists.numel() + lists.k_counts.numel()) * 4
    qk = (lists.q_lists.numel() + lists.q_counts.numel()) * 4
    return {"sparse_forward": (4 * per * pairs, 4 * t + rows + kq),              # q,k,v -> O, lse
            "sparse_backward_dq": (6 * per * pairs, 5 * t + 2 * rows + kq),      # q,k,v,dO,lse,Δ -> dQ
            "sparse_backward_dkdv": (8 * per * pairs, 6 * t + 2 * rows + qk)}    # q,k,v,dO,lse,Δ -> dK,dV


def _costs(q, lists, names):
    B, S, H, D = q.shape
    work = sparse_cost(B, S, H, D, q.element_size(), lists)
    return {n: work[n] for n in names}


class _SparseAttention(torch.autograd.Function):
    """out = sparse attention(q, k, v); saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, lists, causal, scale):
        kw = dict(causal=causal, sm_scale=scale)
        with cost.kernel(q.device, lambda: _costs(q, lists, ("sparse_forward",))):
            if q.device.type == "cpu":
                out, lse = sparse_attention_reference(q, k, v, lists, **kw)
            else:
                out, lse = sparse_forward(q, k, v, lists, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lists, ctx.kw = lists, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        names = ("sparse_backward_dq", "sparse_backward_dkdv")
        with cost.kernel(q.device, lambda: _costs(q, ctx.lists, names)):
            if q.device.type == "cpu":
                dq, dk, dv = sparse_attention_backward_reference(q, k, v, out, lse, dout, ctx.lists, **ctx.kw)
            else:
                if dout.stride(-1) != 1:
                    dout = dout.contiguous()
                delta = flash_delta(out, dout)
                dq = sparse_backward_dq(q, k, v, dout, lse, delta, ctx.lists, **ctx.kw)
                dk, dv = sparse_backward_dkdv(q, k, v, dout, lse, delta, ctx.lists, **ctx.kw)
        return dq, dk, dv, None, None, None


def sparse_flash_attention(q, k, v, layout: np.ndarray, causal: bool = True, sm_scale=None, block=None):
    """Block-sparse attention. q/k/v [B, S, H, D]; ``layout`` is a [nq, nk]
    (or [1, nq, nk], or [H, nq, nk] with identical heads) 0/1 block mask from
    a SparsityConfig with block size S // nq. Differentiable."""
    B, S, H, D = q.shape
    layout = _shared_layout(layout)
    nq, nk = layout.shape
    if S % nq or S % nk:
        raise ValueError(f"seq {S} not divisible by layout blocks {layout.shape}")
    blk = S // nq
    if block is not None and block != blk:
        raise ValueError(f"block {block} inconsistent with layout ({blk})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse_flash_attention runs on CUDA or CPU tensors, not {q.device}")
    lists = device_lists(layout, causal, S, q.device)
    return _SparseAttention.apply(q, k, v, lists, bool(causal), _default_scale(q, sm_scale))
