"""Fused vocab projection + cross-entropy for training: forward and backward.

``fused_linear_xent`` is the port of ``deepspeed_tpu/ops/pallas/fused_xent.py``
``fused_linear_xent`` (same signature and argument rules): per-row NLL
``logsumexp(hidden·head) − (hidden·head)[label]`` without the [N, V] logits
ever reaching memory. It is a ``torch.autograd.Function`` that saves
``(hidden, head, labels, lse)`` (the residual of the Pallas ``_fused_xent_fwd``
without its 128-lane broadcast) and recomputes the logits blockwise in the
backward.

On CUDA tensors it launches the hand-written kernels of ``csrc/fused_xent.cu``
through three entry points, each with its own ``.launches`` counter:
``fused_xent_forward`` (nll and lse), ``fused_xent_backward_dh`` and
``fused_xent_backward_dw``. On CPU tensors it runs the plain versions
``fused_linear_xent_reference`` and ``fused_linear_xent_backward_reference``.
A CUDA tensor never takes the plain path: the kernels launch or the call
raises.

A label below 0 marks an ignored row: its gold logit is never picked, and the
caller's mask zeroes its cotangent, so its dH row is exactly 0. The JAX
wrapper's zero-padding of the head to a multiple of ``block_v`` becomes a mask
in the kernels; ``block_rows``/``block_v`` are validated as the JAX wrapper
does but do not choose the CUDA tile.
"""

from __future__ import annotations

import ctypes

import torch

from . import op_builder

MAX_BLOCK_ROWS = 512
MAX_BLOCK_V = 512
LANES = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 1024  # the kernels' shared-memory accumulators (csrc/fused_xent.cu)
_REF_BLOCK_V = 8192  # vocab block of the plain versions (bounds their fp32 logits)


def _auto_block(n: int, cap: int) -> int:
    b = cap
    while b > 128 and n % b:
        b //= 2
    return min(b, n)


def _check(hidden, head, labels, block_rows, block_v):
    """The JAX wrapper's argument rules (``fused_xent.py:327-344``). These
    are the TPU's tiling rules, kept so both packages accept the same calls;
    they do not choose the CUDA tile."""
    if hidden.ndim != 2 or head.ndim != 2 or labels.ndim != 1:
        raise ValueError(f"hidden [N, D], head [D, V] and labels [N] expected; got {tuple(hidden.shape)}, "
                         f"{tuple(head.shape)}, {tuple(labels.shape)}")
    N, D = hidden.shape
    if head.shape[0] != D or labels.shape[0] != N:
        raise ValueError(f"shapes do not match: hidden {tuple(hidden.shape)}, head {tuple(head.shape)}, "
                         f"labels {tuple(labels.shape)}")
    block_rows = block_rows or _auto_block(N, MAX_BLOCK_ROWS)
    if N % block_rows:
        raise ValueError(f"rows ({N}) must be divisible by block_rows ({block_rows})")
    if block_rows % 8:
        raise ValueError(f"block_rows ({block_rows}) must be a multiple of 8 (the JAX package's TPU "
                         "sublane tile); pad rows to a multiple of 8 or pass an aligned block_rows")
    block_v = block_v or MAX_BLOCK_V
    if block_v % LANES:
        raise ValueError(f"block_v ({block_v}) must be a multiple of {LANES}")


def _vocab_blocks(head):
    V = head.shape[1]
    for v0 in range(0, V, _REF_BLOCK_V):
        yield v0, head[:, v0:v0 + _REF_BLOCK_V]


def fused_linear_xent_reference(hidden, head, labels):
    """The plain forward -> (nll [N] fp32, lse [N] fp32). Logits are the
    products in fp32 of the inputs' values (as the kernels' fp32
    accumulators hold them), a vocab block at a time."""
    h = hidden.float()
    lse_blocks, gold = [], torch.zeros(hidden.shape[0], dtype=torch.float32, device=hidden.device)
    for v0, w in _vocab_blocks(head):
        logits = h @ w.float()
        lse_blocks.append(torch.logsumexp(logits, dim=-1))
        hit = labels[:, None] == torch.arange(v0, v0 + w.shape[1], device=hidden.device)[None, :]
        gold = gold + torch.where(hit, logits, 0.0).sum(-1)
    lse = torch.logsumexp(torch.stack(lse_blocks, dim=-1), dim=-1)
    return lse - gold, lse


def fused_linear_xent_backward_reference(hidden, head, labels, lse, g):
    """The plain blockwise backward -> (dh in hidden's dtype, dw in head's
    dtype). Each vocab block recomputes its logits, forms
    ds = (softmax − onehot)·g in fp32, and rounds it to head's dtype before
    ds·Wᵀ and to hidden's dtype before hᵀ·ds, as the Pallas kernels do
    (``fused_xent.py:184``, ``:207``); both products accumulate in fp32."""
    h = hidden.float()
    g = g.float()[:, None]
    dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
    dws = []
    for v0, w in _vocab_blocks(head):
        w32 = w.float()
        p = torch.exp(h @ w32 - lse.float()[:, None])
        hit = labels[:, None] == torch.arange(v0, v0 + w.shape[1], device=hidden.device)[None, :]
        ds = (p - hit.float()) * g
        dh += ds.to(head.dtype).float() @ w32.t()
        dws.append(h.t() @ ds.to(hidden.dtype).float())
    return dh.to(hidden.dtype), torch.cat(dws, dim=1).to(head.dtype)


# ---------------------------------------------------------------------------
# CUDA entry points
# ---------------------------------------------------------------------------

_PTRS = ("h", "w", "y", "lse_in", "g", "lse", "nll", "dh", "dw")
_STRIDES = ("h_str", "w_str", "dh_str", "dw_str")


class _Params(ctypes.Structure):
    """Mirror of ``XentParams`` in ``csrc/fused_xent.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong * 2) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in ("N", "D", "V", "dtype")])


def _bind(name: str):
    fn = getattr(op_builder.load("fused_xent"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _params(hidden, head, labels, **tensors):
    """Check what the kernels take and fill the parameter block. ``labels``
    must be int32; ``lse_in``, ``g``, ``lse`` and ``nll`` contiguous fp32 [N]."""
    if hidden.device.type != "cuda":
        raise ValueError(f"the fused-xent kernels run on CUDA tensors, not {hidden.device}; "
                         "CPU tensors take fused_linear_xent_reference")
    if hidden.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused-xent kernels take float32, bfloat16 or float16, not {hidden.dtype}")
    N, D = hidden.shape
    V = head.shape[1]
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"the fused-xent kernels take hidden size 1..{_MAX_D}, got {D}")
    if not (1 <= N < 2**31 and 1 <= V < 2**31):
        raise ValueError(f"the fused-xent kernels take 1 <= N, V < 2^31; got {N}, {V}")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError("labels must be contiguous int32 [N]")
    p = _Params()
    named = dict(h=hidden, w=head, y=labels, **tensors)
    for name, t in named.items():
        if t.device != hidden.device:
            raise ValueError(f"{name} is on {t.device}, hidden on {hidden.device}")
        if name in ("lse_in", "g", "lse", "nll"):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (N,):
                raise ValueError(f"{name} must be contiguous float32 [N]")
        elif name in ("h", "w", "dh", "dw"):
            if t.dtype != hidden.dtype:
                raise TypeError(f"{name} is {t.dtype}, hidden is {hidden.dtype}")
            setattr(p, f"{name}_str", (ctypes.c_longlong * 2)(*t.stride()))
        setattr(p, name, t.data_ptr())
    p.N, p.D, p.V, p.dtype = N, D, V, _DTYPE_CODES[hidden.dtype]
    return p


def _launch(name: str, p: _Params, device):
    fn = _bind(name)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def fused_xent_forward(hidden, head, labels):
    """Forward kernel -> (nll [N], lse [N]) fp32. CUDA only; labels int32."""
    N = hidden.shape[0]
    nll = torch.empty(N, dtype=torch.float32, device=hidden.device)
    lse = torch.empty(N, dtype=torch.float32, device=hidden.device)
    _launch("dstt_xent_fwd", _params(hidden, head, labels, nll=nll, lse=lse), hidden.device)
    fused_xent_forward.launches += 1
    return nll, lse


def fused_xent_backward_dh(hidden, head, labels, lse, g):
    """dH kernel -> dh [N, D] contiguous, hidden's dtype. CUDA only."""
    dh = torch.empty(hidden.shape, dtype=hidden.dtype, device=hidden.device)
    _launch("dstt_xent_bwd_dh", _params(hidden, head, labels, lse_in=lse, g=g, dh=dh), hidden.device)
    fused_xent_backward_dh.launches += 1
    return dh


def fused_xent_backward_dw(hidden, head, labels, lse, g):
    """dW kernel -> dw [D, V] with head's strides (for the tied head wteᵀ,
    the transpose of a contiguous [V, D] buffer, as wte's gradient needs).
    CUDA only."""
    dw = torch.empty_like(head)
    _launch("dstt_xent_bwd_dw", _params(hidden, head, labels, lse_in=lse, g=g, dw=dw), hidden.device)
    fused_xent_backward_dw.launches += 1
    return dw


fused_xent_forward.launches = 0  # kernel launches since the last reset to 0
fused_xent_backward_dh.launches = 0
fused_xent_backward_dw.launches = 0


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, labels):
        if hidden.device.type == "cpu":
            nll, lse = fused_linear_xent_reference(hidden, head, labels)
        else:
            nll, lse = fused_xent_forward(hidden, head, labels)
        ctx.save_for_backward(hidden, head, labels, lse)
        ctx.mark_non_differentiable(lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if hidden.device.type == "cpu":
            dh, dw = fused_linear_xent_backward_reference(hidden, head, labels, lse, g)
        else:
            dh = fused_xent_backward_dh(hidden, head, labels, lse, g)
            dw = fused_xent_backward_dw(hidden, head, labels, lse, g)
        return dh, dw, None


def fused_linear_xent(hidden, head, labels, block_rows=None, block_v=None):
    """Per-row next-token NLL without materialising logits.

    hidden [N, D] and head [D, V] of one float dtype (the products run in it,
    the softmax in fp32), labels [N] integer (< 0 = ignored row) -> nll [N]
    fp32, differentiable in (hidden, head). The caller masks ignored rows out
    of its reduction, which also zeroes their cotangents."""
    _check(hidden, head, labels, block_rows, block_v)
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_linear_xent runs on CUDA or CPU tensors, not {hidden.device}")
    if head.dtype != hidden.dtype:
        raise TypeError(f"head is {head.dtype}, hidden is {hidden.dtype}: cast the head first")
    return _FusedXent.apply(hidden, head, labels.to(torch.int32).contiguous())
