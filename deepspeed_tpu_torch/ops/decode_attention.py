"""Single-token decode attention over a KV cache.

``decode_attention`` launches the hand-written CUDA kernels
(``csrc/decode_attention.cu``, the port of the TPU kernel in
``deepspeed_tpu/ops/pallas/decode_attention.py``) on CUDA tensors, and runs
its plain PyTorch twin ``decode_attention_reference`` on CPU tensors. A CUDA
tensor never takes the plain path: the kernels launch or the call raises.

The CUDA path is split-KV: one kernel computes a partial softmax state per
``SPLIT_KEYS`` keys of each (b, h) into fp32 scratch, a second merges the
live splits in order. ``split_plan`` fixes the split count and the scratch
shape from the cache length alone, never from ``pos``, so a decode step's
launches do not depend on a position. ``decode_attention.launches`` counts
the first kernel's launches (one per call), ``.combine_launches`` the
second's.

Layout: q [B, H, D] (the new token, after rotary), k/v cache [B, Smax, H, D],
pos [B] int32 or a scalar = index of the newest valid cache entry, so keys
[0, pos] are attended. ``alibi_slopes`` [H] adds ``slope_h * (k - pos)``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..telemetry import cost
from . import op_builder

NEG_INF = -1e30  # the kernel's masked-score constant (TPU kernel: NEG_INF)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
SPLIT_KEYS = 128  # keys per split: SPLIT_KEYS in csrc/decode_attention.cu
_MAX_SPLITS = 4096  # MAX_SPLITS there


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    """pos (int, 0-d or [B] tensor) -> contiguous [B] int32 on ``device``,
    without reading a device value on the host."""
    if not torch.is_tensor(pos):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    if pos.ndim > 1 or (pos.ndim == 1 and pos.shape[0] != B):
        raise ValueError(f"pos must be a scalar or [B={B}], got shape {tuple(pos.shape)}")
    if pos.dtype.is_floating_point or pos.dtype == torch.bool:
        raise TypeError(f"pos must be an integer tensor, got {pos.dtype}")
    return pos.to(device=device, dtype=torch.int32).expand(B).contiguous()


def _check(q, k_cache, v_cache, alibi_slopes):
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B,H,D] and k/v [B,Smax,H,D]; got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, D = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != B or k_cache.shape[2:] != (H, D):
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if alibi_slopes is not None and tuple(alibi_slopes.shape) != (H,):
        raise ValueError(f"alibi_slopes must be [H={H}], got {tuple(alibi_slopes.shape)}")


def decode_attention_reference(q, k_cache, v_cache, pos, *, sm_scale=None, alibi_slopes=None):
    """The plain version: a masked softmax over the whole cache in fp32."""
    _check(q, k_cache, v_cache, alibi_slopes)
    B, H, D = q.shape
    Smax = k_cache.shape[1]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    pos_b = _pos_vector(pos, B, q.device).long()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k_cache.float()) * scale
    k_pos = torch.arange(Smax, device=q.device)
    if alibi_slopes is not None:
        dist = (k_pos[None, :] - pos_b[:, None]).float()  # [B, Smax]
        s = s + alibi_slopes.float()[None, :, None] * dist[:, None, :]
    s = torch.where(k_pos[None, None, :] <= pos_b[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v_cache.float()).to(q.dtype)


def decode_cost(B: int, Smax: int, H: int, D: int, elt: int) -> dict:
    """{"decode_attention": (flops, bytes)} at these shapes: the keys and
    values of every cached position read (the launch's grid is fixed by the
    cache's length, never by ``pos``, which lives on the device; at pos =
    Smax - 1 it is what the kernel reads), q, the output and pos once; a
    multiply and an add per element of q·k and of p·v."""
    keys = B * Smax
    return {"decode_attention": (4 * keys * H * D, 2 * keys * H * D * elt + 2 * B * H * D * elt + B * 4)}


def split_plan(B: int, Smax: int, H: int, D: int) -> tuple[int, tuple[int, int, int, int]]:
    """(splits, scratch shape) of the split-KV kernels: ceil(Smax /
    SPLIT_KEYS) splits, each leaving (m, l, acc[D]) in fp32. Fixed by the
    cache's shape; no position enters it."""
    splits = -(-Smax // SPLIT_KEYS)
    return splits, (B, H, splits, D + 2)


def vector_loads(k_cache, v_cache) -> bool:
    """Whether the kernel reads key and value rows as 16-byte loads: a row
    of D elements that is a multiple of 16 bytes and both caches' bases at
    16 bytes. Otherwise it loads one element a lane at a time."""
    row_bytes = k_cache.shape[-1] * k_cache.element_size()
    return row_bytes % 16 == 0 and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0


def _bind(lib: ctypes.CDLL):
    fn = lib.dstt_decode_attention
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, pos, *, sm_scale=None, alibi_slopes=None):
    """Attention of q [B,H,D] over keys [0, pos[b]] of the k/v cache
    [B,Smax,H,D] -> [B,H,D] in q's dtype (fp32 accumulation).

    CPU tensors take ``decode_attention_reference``. CUDA tensors launch the
    kernels, which take contiguous fp32 or bf16 tensors on one device and
    D <= 256; anything else raises."""
    _check(q, k_cache, v_cache, alibi_slopes)
    B, H, D = q.shape
    with cost.kernel(q.device, lambda: decode_cost(B, k_cache.shape[1], H, D, q.element_size())):
        return _decode_attention(q, k_cache, v_cache, pos, sm_scale, alibi_slopes)


def _decode_attention(q, k_cache, v_cache, pos, sm_scale, alibi_slopes):
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, pos, sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, not {q.device}")
    B, H, D = q.shape
    Smax = k_cache.shape[1]
    tensors = [q, k_cache, v_cache] + ([alibi_slopes] if alibi_slopes is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k_cache, v_cache and alibi_slopes must be on one device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the decode kernel takes float32 or bfloat16, not {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the decode kernel needs contiguous q, k_cache, v_cache and alibi_slopes")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"the decode kernel takes head dim 1..{_MAX_D}, got {D}")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and 1 <= Smax <= _MAX_SPLITS * SPLIT_KEYS):
        raise ValueError(f"the decode kernel takes 1 <= B, H <= 65535 and 1 <= Smax <= "
                         f"{_MAX_SPLITS * SPLIT_KEYS}; got {B}, {H}, {Smax}")
    if alibi_slopes is not None and alibi_slopes.dtype != torch.float32:
        raise TypeError(f"alibi_slopes must be float32, got {alibi_slopes.dtype}")
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    pos_b = _pos_vector(pos, B, q.device)
    splits, scratch = split_plan(B, Smax, H, D)
    partials = torch.empty(scratch, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = _bind(op_builder.load("decode_attention"))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_b.data_ptr(),
                 alibi_slopes.data_ptr() if alibi_slopes is not None else None, partials.data_ptr(),
                 out.data_ptr(), B, Smax, H, D, splits, int(vector_loads(k_cache, v_cache)),
                 _DTYPE_CODES[q.dtype], scale, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1  # the split kernel
    decode_attention.combine_launches += 1  # and the combine, launched in the same call
    return out


decode_attention.launches = 0  # split-kernel launches since the last reset to 0
decode_attention.combine_launches = 0  # combine-kernel launches since the last reset to 0
