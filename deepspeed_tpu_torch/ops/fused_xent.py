"""Fused vocab projection + cross-entropy for training: forward and backward.

``fused_linear_xent`` is the port of ``deepspeed_tpu/ops/pallas/fused_xent.py``
``fused_linear_xent`` (same signature and argument rules): per-row NLL
``logsumexp(hidden·head) − (hidden·head)[label]`` without the [N, V] logits
ever reaching memory. It is a ``torch.autograd.Function`` that saves
``(hidden, head, labels, lse)`` (the residual of the Pallas ``_fused_xent_fwd``
without its 128-lane broadcast) and recomputes the logits blockwise in the
backward.

On CUDA tensors it launches the hand-written kernels of ``csrc/fused_xent.cu``
through two entry points: ``fused_xent_forward`` (nll and lse) and
``fused_xent_backward`` (dh and dw). The 16-bit forward launches two kernels,
each counted by its own wrapper: ``fused_xent_forward`` (the logits product,
reduced per 128-column vocab tile into an fp32 scratch of partials) and
``xent_fwd_combine`` (the partials merged in a fixed order into lse and nll);
the fp32 forward is one kernel, counted by ``fused_xent_forward``. The
backward walks the vocab in chunks (``backward_chunk``, ``vocab_chunks``) and
launches three kernels per chunk, in order, each counted by its own wrapper:
``xent_ds_pass`` (ds of the chunk into a scratch), ``xent_dw_pass`` (the
chunk's columns of dW) and ``xent_dh_pass`` (dH accumulated in fp32). On CPU
tensors it runs the plain versions ``fused_linear_xent_reference`` and
``fused_linear_xent_backward_reference``. A CUDA tensor never takes the plain
path: the kernels launch or the call raises.

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
_REF_BLOCK_V = 8192  # vocab block of the plain forward (bounds its fp32 logits)
SCRATCH_BYTES = 256 * 2**20  # the backward's bound on one chunk of ds
TILE = 128  # the 16-bit kernels' output tile (csrc/fused_xent.cu G_BM, G_BN)


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


def backward_chunk(n_rows: int, vocab: int, itemsize: int) -> int:
    """Vocab columns per backward chunk: the most, in whole tiles, whose ds
    ([n_rows, chunk] in the input type) fits ``SCRATCH_BYTES``, and no more
    than the vocab rounded up to a tile (8192 at 16384 rows in bf16)."""
    fit = SCRATCH_BYTES // (n_rows * itemsize) // TILE * TILE
    return max(TILE, min(fit, -(-vocab // TILE) * TILE))


def vocab_tiles(vocab: int) -> int:
    """The 16-bit forward's vocab tiles, each of which leaves one partial
    (max, sum, gold) per row: ⌈vocab / TILE⌉."""
    return -(-vocab // TILE)


def vocab_chunks(vocab: int, chunk: int) -> list[tuple[int, int]]:
    """[(v0, width)] covering [0, vocab) in order; the last may be narrower."""
    return [(v0, min(chunk, vocab - v0)) for v0 in range(0, vocab, chunk)]


def _vocab_blocks(head, block=_REF_BLOCK_V):
    for v0, width in vocab_chunks(head.shape[1], block):
        yield v0, head[:, v0:v0 + width]


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


def fused_linear_xent_backward_reference(hidden, head, labels, lse, g, chunk=_REF_BLOCK_V):
    """The plain blockwise backward -> (dh in hidden's dtype, dw in head's
    dtype), over vocab blocks of ``chunk`` columns (its own, not the kernels'
    chunk rule). Each block recomputes its logits, forms
    ds = (softmax − onehot)·g in fp32, and rounds it to head's dtype before
    ds·Wᵀ and to hidden's dtype before hᵀ·ds, as the Pallas kernels do
    (``fused_xent.py:184``, ``:207``); both products accumulate in fp32."""
    h = hidden.float()
    g = g.float()[:, None]
    dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
    dws = []
    for v0, w in _vocab_blocks(head, chunk):
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

_PTRS = ("h", "w", "y", "lse_in", "g", "lse", "nll", "dh", "dw", "ds", "dh_acc", "part")
_STRIDES = ("h_str", "w_str", "dh_str", "dw_str")


class _Params(ctypes.Structure):
    """Mirror of ``XentParams`` in ``csrc/fused_xent.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong * 2) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in ("N", "D", "V", "dtype", "v0", "vc", "ds_ld")])


def _bind(name: str):
    fn = getattr(op_builder.load("fused_xent"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _params(hidden, head, labels, **tensors):
    """Check what the kernels take and fill the parameter block. ``labels``
    must be int32; ``lse_in``, ``g``, ``lse`` and ``nll`` contiguous fp32 [N];
    ``dh_acc`` contiguous fp32 [N, D]; ``part`` contiguous fp32
    [3, N, vocab_tiles(V)]; ``ds`` [N, width] in hidden's dtype with
    contiguous rows."""
    if hidden.device.type != "cuda":
        raise ValueError(f"the fused-xent kernels run on CUDA tensors, not {hidden.device}; CPU tensors take "
                         "fused_linear_xent_reference and fused_linear_xent_backward_reference")
    if hidden.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused-xent kernels take float32, bfloat16 or float16, not {hidden.dtype}")
    N, D = hidden.shape
    V = head.shape[1]
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
        elif name == "dh_acc":
            if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (N, D):
                raise ValueError("dh_acc must be contiguous float32 [N, D]")
        elif name == "part":
            if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (3, N, vocab_tiles(V)):
                raise ValueError("part must be contiguous float32 [3, N, vocab_tiles(V)]")
        elif name == "ds":
            if t.dtype != hidden.dtype or t.ndim != 2 or t.shape[0] != N or t.stride(1) != 1:
                raise ValueError(f"ds must be [N, width] {hidden.dtype} with contiguous rows")
            p.ds_ld = t.stride(0)
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
    """Forward kernels -> (nll [N], lse [N]) fp32. CUDA only; labels int32.
    16-bit: the logits product into a [3, N, vocab_tiles(V)] fp32 scratch
    of per-tile partials over the operands as ``tma_operands`` gives them,
    then ``xent_fwd_combine``; fp32: one kernel."""
    N = hidden.shape[0]
    nll = torch.empty(N, dtype=torch.float32, device=hidden.device)
    lse = torch.empty(N, dtype=torch.float32, device=hidden.device)
    if hidden.dtype == torch.float32:
        _launch("dstt_xent_fwd", _params(hidden, head, labels, nll=nll, lse=lse), hidden.device)
        fused_xent_forward.launches += 1
        return nll, lse
    h, w = tma_operands(hidden, head)
    part = torch.empty(3, N, vocab_tiles(head.shape[1]), dtype=torch.float32, device=hidden.device)
    p = _params(h, w, labels, nll=nll, lse=lse, part=part)  # h, w, part live past both launches
    _launch("dstt_xent_fwd", p, hidden.device)
    fused_xent_forward.launches += 1
    xent_fwd_combine(p, hidden.device)
    return nll, lse


def xent_fwd_combine(p: _Params, device):
    """The 16-bit forward's partials merged into lse and nll: one kernel."""
    _launch("dstt_xent_fwd_combine", p, device)
    xent_fwd_combine.launches += 1


def tma_readable(t) -> bool:
    """A 2-D 16-bit operand that the kernels' TMA loads read where it lies:
    a unit stride, a 16-byte base, the other stride a multiple of 8 elements."""
    s0, s1 = t.stride()
    other = s0 if s1 == 1 else s1 if s0 == 1 else 0
    return other > 0 and other % 8 == 0 and t.data_ptr() % 16 == 0


def _padded(t, contiguous_dim):
    """A copy of 2-D ``t``, contiguous along ``contiguous_dim`` with its rows
    along that dimension padded to a multiple of 8 elements, as a view of
    ``t``'s shape."""
    if contiguous_dim == 0:
        return _padded(t.t(), 1).t()
    rows, cols = t.shape
    buf = t.new_zeros(rows, -(-cols // 8) * 8)
    buf[:, :cols] = t
    return buf[:, :cols]


def tma_operands(hidden, head):
    """(hidden, head) as the 16-bit kernels read them: hidden
    d-contiguous, the head in its own layout where it has a unit stride. What
    TMA cannot read goes to a padded copy before the launch; the kernels read
    only the true N, D and V of it."""
    if hidden.stride(1) != 1 or not tma_readable(hidden):
        hidden = _padded(hidden, 1)
    if not tma_readable(head):
        head = _padded(head, 0 if head.stride(0) == 1 else 1)
    return hidden, head


def xent_ds_pass(p: _Params, device):
    """ds of the chunk [p.v0, p.v0 + p.vc) into the scratch: one kernel."""
    _launch("dstt_xent_bwd_ds", p, device)
    xent_ds_pass.launches += 1


def xent_dw_pass(p: _Params, device):
    """The chunk's columns of dW from the scratch: one kernel."""
    _launch("dstt_xent_bwd_dw", p, device)
    xent_dw_pass.launches += 1


def xent_dh_pass(p: _Params, device):
    """dH_acc += ds·W[:, chunk]ᵀ, dH itself on the last chunk: one kernel."""
    _launch("dstt_xent_bwd_dh", p, device)
    xent_dh_pass.launches += 1


BACKWARD_PASSES = (xent_ds_pass, xent_dw_pass, xent_dh_pass)


def fused_xent_backward(hidden, head, labels, lse, g, passes=BACKWARD_PASSES):
    """Backward kernels -> (dh [N, D] contiguous in hidden's dtype, dw [D, V]
    with head's strides: for the tied head wteᵀ, the transpose of a
    contiguous [V, D] buffer, as wte's gradient needs). For each vocab chunk,
    in order: the ds pass, the dW product, the dH product, on a [N, chunk]
    ds scratch and, with more than one chunk, an fp32 [N, D] dH accumulator.
    ``passes``, a subset of ``BACKWARD_PASSES``, runs only those kernels over
    every chunk, to time one alone; dh and dw then hold no result. CUDA only
    (``_params`` refuses CPU tensors)."""
    N, D = hidden.shape
    V = head.shape[1]
    dh = torch.empty(hidden.shape, dtype=hidden.dtype, device=hidden.device)
    dw = torch.empty_like(head)
    h, w = (hidden, head) if hidden.dtype == torch.float32 else tma_operands(hidden, head)
    chunk = backward_chunk(N, V, hidden.element_size())
    chunks = vocab_chunks(V, chunk)
    scratch = dict(ds=torch.empty(N, chunk, dtype=hidden.dtype, device=hidden.device))
    if len(chunks) > 1:
        scratch["dh_acc"] = torch.empty(N, D, dtype=torch.float32, device=hidden.device)
    p = _params(h, w, labels, lse_in=lse, g=g, dh=dh, dw=dw, **scratch)  # h, w, scratch live past the launches
    for v0, vc in chunks:
        p.v0, p.vc = v0, vc
        for launch in passes:
            launch(p, hidden.device)
    return dh, dw


fused_xent_forward.launches = 0  # kernel launches since the last reset to 0
xent_fwd_combine.launches = 0
xent_ds_pass.launches = 0
xent_dw_pass.launches = 0
xent_dh_pass.launches = 0


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
            dh, dw = fused_xent_backward(hidden, head, labels, lse, g)
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
