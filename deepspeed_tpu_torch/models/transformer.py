"""Decoder-only transformer: GPT-2 (learned positions), GPT-NeoX/GPT-J
(rotary, parallel residual) and BLOOM-style (ALiBi) decoders, ported from
``deepspeed_tpu/models/transformer.py``: the training forward and loss
(``apply``, ``causal_lm_loss``, with plain, flash or block-sparse attention,
dropout, progressive layer drop, activation checkpointing (remat), and the
chunked or the fused vocab-projection + cross-entropy loss) and KV-cache
decoding for inference.

Parameters are a plain dict of tensors with the JAX package's layout: the
layer weights are stacked ``[L, ...]`` (``wq``/``wk``/``wv`` [L, d, H, Dh],
``wo`` [L, H, Dh, d], ``wi`` [L, d, f], ``wo_mlp`` [L, f, d], biases and
LayerNorm leaves), q/k/v are [B, S, H, Dh] and the KV cache is
{k, v} [L, B, Smax, H, Dh]. The bf16 rounding points follow the JAX code:
LayerNorm statistics in fp32, projections in the compute dtype, attention
scores and softmax in fp32 with probabilities cast back before the PV
product, logits computed in the compute dtype and then cast to fp32.

The KV cache is updated IN PLACE by ``apply_with_cache`` and
``update_cache_slot`` (the JAX versions return new arrays). Randomness
(dropout, layer drop) comes from a key, a 0-d int64 tensor
(``dropout_key(seed, step, micro)``), and a counter-based integer hash of it
and each element's index in plain torch ops: the same bits on the CPU and
the card, other bits than ``jax.random``. As the JAX package splits its key
per layer, each layer and each of its sites hashes a key of its own, so a
remat recompute replays the layer's masks, and a step tensor on the device
keys them without a fetch.

Tensor parallelism: a parameter tree that carries a
``module_inject.TensorParallel`` plan (``TPParams``, made by
``init_inference`` at ``tp_size > 1`` and by the training engine under a
``model`` axis) holds one rank's slices, each leaf split over the mesh's
``model`` axis where its spec says so. The forward then runs this rank's
heads and FFN columns (q/k/v and ``wi`` column-parallel, each input
entering once through ``copy_to_model``; ``wo`` and ``wo_mlp`` row-
parallel: reduced, then the bias added once), looks up a vocab-split
embedding by range and reduces it, gathers a vocab-split head's logits to
the full width, slices the ALiBi slopes to its heads, and keeps a KV cache
of its heads only (``init_cache(heads=)``). The collectives are autograd
functions (``comm.copy_to_model`` and its conjugates), so training
differentiates through them; every dropout site sits where the activations
are replicated, so the ranks of one data index draw the same masks. The
training loss over a vocab-split head is vocab-parallel (``_nll_sum_split``:
the [B, chunk, V] logits are never gathered), and under
``remat_partition_axis`` (partition_activations) each checkpointed region
keeps only this rank's rows of its saved boundary. A leaf ``model`` does
not divide stays whole and no collective runs for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..moe.layer import init_moe_params, moe_ffn_apply, moe_ffn_dense, moe_layers, moe_logical_axes
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_xent import fused_linear_xent
from .. import comm
from ..module_inject.layers import TPParams, plan_of
from ..ops.sparse_attention import SPARSITY_CONFIGS, sparse_flash_attention
from ..runtime.activation_checkpointing.checkpointing import REMAT_POLICIES, remat_context_fn
from ..runtime.zero import param_offload
from ..telemetry import cost

Params = dict


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # default 4*hidden
    pos_emb: str = "learned"  # learned | rotary | alibi | none
    rotary_pct: float = 1.0
    rotary_interleaved: bool = False  # GPT-J rotate-every-two convention
    parallel_residual: bool = False  # GPT-NeoX style
    causal: bool = True  # False = bidirectional (BERT-style encoders; apply only)
    norm_style: str = "pre"  # pre (GPT) | post (BERT) layernorm placement
    # GPT-Neo alternating local attention: window size + per-layer 0/1 flags
    # (1 = local); None = all-global
    local_attn_window: int = 0
    local_attn_layers: Optional[tuple] = None
    layernorm_epsilon: float = 1e-5
    tie_embeddings: bool = True
    use_bias: bool = True
    final_ln: bool = True
    activation: str = "gelu"  # gelu (tanh approximation) | gelu_exact | relu
    embed_ln: bool = False  # LayerNorm after embedding (BLOOM)
    # xla (plain attention) | flash (the CUDA flash kernels) | sparse (the
    # CUDA block-sparse kernels over ``sparsity``'s layout)
    attn_impl: str = "xla"
    # attn_impl="sparse": block-sparse attention config (reference
    # ops/sparse_attention/sparsity_config.py). {"mode": "fixed"|"bigbird"|
    # "bslongformer"|"variable"|"dense", **mode kwargs}; num_heads defaults
    # to the model's.
    sparsity: Optional[dict] = None
    flash_block_q: int = 0  # validated as in the JAX package; not the CUDA tile
    flash_block_k: int = 0
    decode_attn: str = "kernel"  # kernel (CUDA decode kernel) | xla (plain cached attention)
    dtype: torch.dtype = torch.float32  # compute dtype
    loss_chunk_size: int = 512  # chunk the vocab projection in the loss; 0 = off
    # "chunked": the vocab projection a sequence chunk at a time, each chunk
    # recomputed in the backward; "fused_xent": the fused projection +
    # cross-entropy kernels (ops/fused_xent.py), logits never in memory
    loss_impl: str = "chunked"
    loss_fused_block_rows: int = 0  # validated as in the JAX package; not the CUDA tile
    loss_fused_block_v: int = 0
    # Activation checkpointing over the layer stack: each layer (or each
    # group of ``remat_group`` layers) runs under torch.utils.checkpoint with
    # ``remat_policy`` (nothing_saveable | everything_saveable | dots_saveable
    # | save_flash | dots_and_flash). ``remat_offload`` (cpu_checkpointing):
    # the saved layer boundaries go to (pinned) host memory; it composes
    # with the named-residual policies (save_flash, nothing_saveable), as in
    # the JAX package. ``remat_partition_axis`` (partition_activations):
    # under tensor parallelism over that mesh axis, each region's saved
    # boundary [B, S, D] keeps only this rank's S / size rows (whole when
    # the axis does not divide S), gathered back for the recompute.
    remat: bool = False
    remat_policy: str = "save_flash"
    remat_offload: bool = False
    remat_partition_axis: str = ""
    remat_group: int = 0
    # The JAX package's lax.scan unroll; the port's layers are a Python loop,
    # so it has no effect here (it has none on the math in JAX either).
    scan_unroll: int = 1
    # Dropout on the attention output projection (attn) and on embeddings +
    # FFN output (hidden); active only when the caller passes a generator.
    hidden_dropout: float = 0.0
    attn_dropout: float = 0.0
    # Progressive layer drop: theta(t) = pld_theta + (1 - pld_theta) *
    # exp(-pld_gamma * t); layer i's residual branches are kept with
    # probability 1 - i/L * (1 - theta(t)).
    pld_enabled: bool = False
    pld_theta: float = 0.5
    pld_gamma: float = 0.001
    # Mixture of experts (moe/): every ``moe_every``-th layer's FFN is a
    # bank of ``num_experts`` experts behind a top-``moe_top_k`` GShard gate
    # with capacity factor ``moe_capacity_factor``; its load-balancing loss
    # enters the training loss times ``moe_aux_coeff``. 0 = dense.
    moe_every: int = 0
    num_experts: int = 1
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01
    # Not implemented in the port yet: any value but the default raises.
    weight_bits: int = 0
    act_quant_bits: int = 0
    # The ZeRO-Infinity parameter tier (the engine's offload_param,
    # runtime/zero/param_offload.py): the parameters live in host memory,
    # the top-level leaves are streamed to the device once at entry and each
    # layer's slices one layer at a time; gradients go back to the host.
    param_offload: bool = False

    def __post_init__(self):
        defaults = {"weight_bits": 0, "act_quant_bits": 0}
        for name, default in defaults.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={getattr(self, name)!r} is not implemented "
                    f"in deepspeed_tpu_torch yet (only {default!r})")
        if self.remat_partition_axis not in ("", "model"):
            raise NotImplementedError(
                f"TransformerConfig.remat_partition_axis={self.remat_partition_axis!r}: partition_activations "
                "over an axis other than 'model' is not implemented in deepspeed_tpu_torch yet")
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"TransformerConfig.attn_impl={self.attn_impl!r} is not implemented in "
                "deepspeed_tpu_torch yet (xla, flash or sparse)")
        if self.attn_impl not in ("xla", "flash", "sparse"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.loss_impl not in ("chunked", "fused_xent"):
            raise ValueError(f"unknown loss_impl {self.loss_impl!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not implemented in deepspeed_tpu_torch "
                f"(one of {', '.join(REMAT_POLICIES)})")
        if self.pos_emb not in ("learned", "rotary", "alibi", "none"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.activation not in ("gelu", "gelu_exact", "relu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.norm_style not in ("pre", "post"):
            raise ValueError(f"unknown norm_style {self.norm_style!r}")
        if self.decode_attn not in ("kernel", "xla"):
            raise ValueError(f"unknown decode_attn {self.decode_attn!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init(cfg: TransformerConfig, generator: torch.Generator, device="cpu", place=None) -> Params:
    """The JAX ``init`` parameter tree, fp32, drawn from ``generator`` (on the
    generator's device) and placed on ``device``. Same distributions as the
    JAX package; not the same numbers (use ``interop.params_from_jax`` for
    those). ``place(path, leaf)``, when given, takes each leaf as it is made
    and returns what the tree keeps (``zero.Init`` keeps a shard), so only
    one whole leaf exists at a time; the draws are the same either way."""
    d, f, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    H, Dh = cfg.num_heads, cfg.head_dim
    place = place or (lambda path, t: t)

    # each leaf is made when its path is known, in the order the entries
    # below are listed, which fixes the generator's draws
    def normal(shape, std):
        return lambda path: place(path, (torch.randn(shape, generator=generator, device=generator.device)
                                         * std).to(device))

    def zeros(*shape):
        return lambda path: place(path, torch.zeros(shape, device=device))

    def ones(*shape):
        return lambda path: place(path, torch.ones(shape, device=device))

    layers = {
        "ln1_scale": ones(L, d), "ln1_bias": zeros(L, d),
        "ln2_scale": ones(L, d), "ln2_bias": zeros(L, d),
        "wq": normal((L, d, H, Dh), 1 / math.sqrt(d)),
        "wk": normal((L, d, H, Dh), 1 / math.sqrt(d)),
        "wv": normal((L, d, H, Dh), 1 / math.sqrt(d)),
        "wo": normal((L, H, Dh, d), 1 / math.sqrt(d)),
        "wi": normal((L, d, f), 1 / math.sqrt(d)),
        "wo_mlp": normal((L, f, d), 1 / math.sqrt(f)),
    }
    if cfg.use_bias:
        layers.update({
            "bq": zeros(L, H, Dh), "bk": zeros(L, H, Dh), "bv": zeros(L, H, Dh),
            "bo": zeros(L, d), "bi": zeros(L, f), "bo_mlp": zeros(L, d),
        })
    layers = {k: make(("layers", k)) for k, make in layers.items()}
    params = {
        "wte": normal((cfg.vocab_size, d), 0.02),
        "layers": layers,
        "lnf_scale": ones(d),
        "lnf_bias": zeros(d),
    }
    if cfg.pos_emb == "learned":
        params["wpe"] = normal((cfg.max_seq_len, d), 0.01)
    if cfg.embed_ln:
        params["emb_ln_scale"] = ones(d)
        params["emb_ln_bias"] = zeros(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    out = {k: v if k == "layers" else v((k,)) for k, v in params.items()}
    if cfg.moe_every > 0:
        out["moe"] = init_moe_params(generator, L // cfg.moe_every, cfg.num_experts, d, f, device, place)
    return out


def logical_axes(cfg: TransformerConfig) -> dict:
    """The tree of logical-axis tuples matching ``init``'s output (JAX
    ``models/transformer.py:218-260``), read by
    ``parallel/sharding.spec_from_logical``."""
    layers = {
        "ln1_scale": ("layers", "embed"), "ln1_bias": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"), "ln2_bias": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "kv"), "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"), "wo": ("layers", "heads", "kv", "embed"),
        "wi": ("layers", "embed", "mlp"), "wo_mlp": ("layers", "mlp", "embed"),
    }
    if cfg.use_bias:
        layers.update({
            "bq": ("layers", "heads", "kv"), "bk": ("layers", "heads", "kv"), "bv": ("layers", "heads", "kv"),
            "bo": ("layers", "embed"), "bi": ("layers", "mlp"), "bo_mlp": ("layers", "embed"),
        })
    axes = {"wte": ("vocab", "embed"), "layers": layers, "lnf_scale": ("embed",), "lnf_bias": ("embed",)}
    if cfg.pos_emb == "learned":
        axes["wpe"] = (None, "embed")
    if cfg.embed_ln:
        axes["emb_ln_scale"] = ("embed",)
        axes["emb_ln_bias"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.moe_every > 0:
        axes["moe"] = moe_logical_axes()
    return axes


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def layer_norm(x, scale, bias, eps):
    """LayerNorm with fp32 statistics; the output has x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def rotary_embed(x, positions, rotary_dims, interleaved: bool = False):
    """Rotary position embedding on the first ``rotary_dims`` of x [B,S,H,Dh]
    at ``positions`` [B,S]. ``interleaved`` = GPT-J pairs (x0,x1),(x2,x3)...;
    otherwise the NeoX half split (x0,x_half),..."""
    rd = rotary_dims
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    half = rd // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)


@functools.lru_cache(maxsize=None)
def alibi_slopes(num_heads: int, device="cpu") -> torch.Tensor:
    """BLOOM ALiBi slopes [H] fp32, made once per (num_heads, device): the
    copy from the host happens on the first call, never inside a CUDA graph
    capture of a later one. Callers must not write to the result."""
    closest = 2 ** math.floor(math.log2(num_heads))
    vals = [2 ** (-8.0 * (i + 1) / closest) for i in range(closest)]
    vals += [2 ** (-4.0 * (i + 1) / closest) for i in range(num_heads - closest)]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _slopes(cfg: TransformerConfig, device, tp=None) -> torch.Tensor:
    """The ALiBi slopes of the heads this rank computes: its slice of the
    model's slopes under tp (never ``alibi_slopes(H / tp)``)."""
    slopes = alibi_slopes(cfg.num_heads, device)
    return slopes if tp is None else slopes[tp.head_slice(cfg.num_heads)]


def xla_attention(q, k, v, *, causal_offset=0, bias=None, causal=True):
    """Plain attention over [B,S,H,Dh] (the JAX package's ``xla_attention``).
    ``causal_offset`` is a scalar (int or 0-d tensor) or a per-row [B]
    tensor: query i of row b sits at absolute position offset[b] + i."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(Dh)
    if bias is not None:
        scores = scores + bias
    if causal:
        off = causal_offset if torch.is_tensor(causal_offset) else torch.tensor(causal_offset)
        off = off.to(q.device)
        q_pos = torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        if off.ndim == 0:
            mask = (q_pos[:, None] + off) >= k_pos[None, :]  # [Sq, Sk]
            mask = mask[None, None]
        else:
            mask = (off[:, None, None] + q_pos[None, :, None]) >= k_pos[None, None, :]  # [B,Sq,Sk]
            mask = mask[:, None]
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _linear(x, w, b):
    """x [..., d_in] @ w [d_in, ...] (+ b) in x's dtype; the bias is added
    after the product is rounded, as in the JAX einsum + add."""
    d_in = w.shape[0]
    out = (x @ w.reshape(d_in, -1).to(x.dtype)).reshape(*x.shape[:-1], *w.shape[1:])
    return out if b is None else out + b.to(x.dtype)


# The named scopes (``cost.scope``) are the JAX model's ``jax.named_scope``s,
# at the same places: the flops profiler's per-module rows.
def _ffn(cfg: TransformerConfig, lp, h, tp=None):
    with cost.scope("ffn"):
        if tp is not None:
            h = tp.copy_in(h, "layers", "wi")
        u = _linear(h, lp["wi"], lp.get("bi"))  # column-parallel under tp
        if cfg.activation == "relu":
            u = F.relu(u)
        elif cfg.activation == "gelu_exact":
            u = F.gelu(u)
        else:
            u = F.gelu(u, approximate="tanh")
        if tp is None:
            return _linear(u, lp["wo_mlp"], lp.get("bo_mlp"))
        return tp.row(_linear(u, lp["wo_mlp"], None), lp.get("bo_mlp"), "layers", "wo_mlp")


def _qkv_proj(cfg: TransformerConfig, lp, h, positions, tp=None):
    """LN'd hidden states [B,T,d] -> rotary-embedded q, k, v [B,T,H,Dh]
    (this rank's heads under ``tp``, the three products reading one copy of
    ``h``)."""
    with cost.scope("attn"):
        if tp is not None:
            h = tp.copy_in(h, "layers", "wq")
        q = _linear(h, lp["wq"], lp.get("bq"))
        k = _linear(h, lp["wk"], lp.get("bk"))
        v = _linear(h, lp["wv"], lp.get("bv"))
        if cfg.pos_emb == "rotary":
            rd = int(cfg.head_dim * cfg.rotary_pct)
            q = rotary_embed(q, positions, rd, interleaved=cfg.rotary_interleaved)
            k = rotary_embed(k, positions, rd, interleaved=cfg.rotary_interleaved)
        return q, k, v


def _attn_out_proj(cfg: TransformerConfig, lp, attn_out, tp=None):
    B, T, H, Dh = attn_out.shape  # H: this rank's heads under tp
    with cost.scope("attn"):
        x, w = attn_out.reshape(B, T, H * Dh), lp["wo"].reshape(H * Dh, -1)
        if tp is None:
            return _linear(x, w, lp.get("bo"))
        return tp.row(_linear(x, w, None), lp.get("bo"), "layers", "wo")


def _layers(params: Params) -> list[dict]:
    """The stacked ``[L, ...]`` layer leaves as one dict per layer, taken with
    one ``torch.unbind`` per leaf: its backward is a single stack, where
    indexing each leaf L times would build a full-size zero gradient per
    index."""
    stacked = params["layers"]
    names = list(stacked)
    return [dict(zip(names, leaves)) for leaves in zip(*(torch.unbind(stacked[n], 0) for n in names))]


NEG_BIAS = -1e30


_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of an int64 tensor
    holding values in [0, 2**32). Both multipliers are below 2**31, so no
    product overflows int64 and the CPU and the card give the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _fold(key: torch.Tensor, value) -> torch.Tensor:
    """The key of a sub-stream: ``key`` hashed with ``value`` (an int or an
    integer tensor on the key's device)."""
    v = torch.as_tensor(value, device=key.device).long() & _M32
    return _hash32(key ^ _hash32(v))


def dropout_key(seed: int, step, micro: int = 0, device=None) -> torch.Tensor:
    """The dropout and layer-drop key of one micro-batch: a 0-d int64 tensor
    hashed from (``seed``, ``step``, ``micro``). ``step`` may be a tensor on
    the device (the engine passes ``state["step"] + 1``): the key is computed
    there and nothing is read back, so the masks follow the device step
    through every skipped update, as the JAX engine's key does."""
    step = torch.as_tensor(step, device=device)
    seed = int(seed)
    key = _hash32(torch.tensor((seed ^ (seed >> 32)) & _M32, dtype=torch.int64, device=step.device))
    return _fold(_fold(key, step), int(micro))


def _uniform(key: torch.Tensor, shape, row_offset: int = 0) -> torch.Tensor:
    """Uniform fp32 in [0, 1) with 24 random bits, one per element of
    ``shape``: the hash of the element's index under ``key``. With
    ``row_offset`` the tensor is rows ``[row_offset, row_offset + shape[0])``
    of a larger one and hashes their indices there, so a data-parallel rank
    holding those rows of a micro-batch draws the masks a world of 1 draws."""
    n = math.prod(shape)
    start = row_offset * math.prod(shape[1:]) if row_offset else 0
    idx = torch.arange(start, start + n, dtype=torch.int64, device=key.device).view(shape)
    bits = _hash32(_hash32(idx ^ key) ^ key)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _dropout(x, rate: float, key, row_offset: int = 0):
    """Inverted dropout; identity when rate == 0 or no key (inference).
    ``row_offset``: ``x`` is those rows of the micro-batch (``_uniform``)."""
    if rate <= 0.0 or key is None:
        return x
    keep = _uniform(key, tuple(x.shape), row_offset) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _local_attn_bias(cfg: TransformerConfig, S: int, device="cpu"):
    """Additive [S, S] window mask for GPT-Neo-style local attention."""
    pos = torch.arange(S, device=device)
    dist = pos[:, None] - pos[None, :]
    keep = (dist >= 0) & (dist < cfg.local_attn_window)
    return torch.where(keep, 0.0, NEG_BIAS).float()


_LAYOUTS: dict[tuple, object] = {}  # (sparsity config repr, seq_len) -> numpy layout


def _sparsity_layout(cfg: TransformerConfig, seq_len: int):
    """The layout of ``cfg.sparsity`` at ``seq_len``, made once per length
    (the config's mode with ``num_heads`` defaulting to the model's)."""
    sp = dict(cfg.sparsity or {})
    mode = sp.pop("mode", "fixed")
    sp.setdefault("num_heads", cfg.num_heads)
    key = (mode, repr(sorted(sp.items())), seq_len)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = SPARSITY_CONFIGS[mode](**sp).make_layout(seq_len)
    return _LAYOUTS[key]


def _attention_dispatch(cfg: TransformerConfig, device="cpu", tp=None) -> Callable:
    """attn_fn(q, k, v, bias[, window]) for ``cfg.attn_impl``. The flash
    dispatch fuses ALiBi and local windows in the kernel
    (``handles_fused_bias``); a dense bias falls back to plain attention, in
    the sparse dispatch too (as in the JAX package)."""
    if cfg.attn_impl == "flash":
        bq = cfg.flash_block_q or None
        bk = cfg.flash_block_k or None
        slopes = _slopes(cfg, device, tp) if cfg.pos_emb == "alibi" else None

        def flash_fn(q, k, v, bias, window=None):
            if bias is not None:
                return xla_attention(q, k, v, bias=bias, causal=cfg.causal)
            return flash_attention(q, k, v, causal=cfg.causal, block_q=bq, block_k=bk,
                                   alibi_slopes=slopes, window=window)

        flash_fn.handles_fused_bias = True
        return flash_fn
    if cfg.attn_impl == "sparse":
        if tp is not None and tp.split("layers", "wq"):
            raise NotImplementedError(
                "attn_impl='sparse' under tensor parallelism (block-sparse attention on a rank's H/tp heads) "
                "is not ported to deepspeed_tpu_torch yet")

        def sparse_fn(q, k, v, bias):
            if bias is not None:
                return xla_attention(q, k, v, bias=bias, causal=cfg.causal)  # alibi unfused
            return sparse_flash_attention(q, k, v, _sparsity_layout(cfg, q.shape[1]), causal=cfg.causal)

        return sparse_fn
    return lambda q, k, v, bias: xla_attention(q, k, v, bias=bias, causal=cfg.causal)


def _attn_call(cfg: TransformerConfig, attn_fn, q, k, v, bias, is_local):
    """Attention with the layer's locality: fused dispatches get the raw
    window (0 = global); others get the dense-bias merge in ``bias``."""
    if getattr(attn_fn, "handles_fused_bias", False) and is_local is not None:
        return attn_fn(q, k, v, bias, window=float(cfg.local_attn_window) if is_local else 0.0)
    return attn_fn(q, k, v, bias)


def _layer_body(cfg: TransformerConfig, lp, x, bias, positions, attn_fn, is_local=None,
                local_bias=None, key=None, pld_keep=None, row_offset: int = 0, tp=None):
    """One layer of ``apply``: pre-LN, post-LN or parallel residual, with
    dropout and the progressive-layer-drop gate when ``key`` (the layer's
    key) is given: sites 0 (the gate), 1 (attention) and 2 (FFN) each fold
    a key of their own from it."""
    eps = cfg.layernorm_epsilon
    gate = None  # progressive layer drop: one coin per layer gates both branches
    if pld_keep is not None and key is not None:
        gate = (_uniform(_fold(key, 0), ()) < pld_keep).to(cfg.dtype)
    if is_local and local_bias is not None:
        lb = local_bias[None, None]
        bias = lb if bias is None else bias + lb

    def branch(y, rate, site):
        y = _dropout(y, rate, None if key is None else _fold(key, site), row_offset)
        return y if gate is None else gate * y

    def attn(h):
        q, k, v = _qkv_proj(cfg, lp, h, positions, tp)
        out = _attn_out_proj(cfg, lp, _attn_call(cfg, attn_fn, q, k, v, bias, is_local), tp)
        return branch(out, cfg.attn_dropout, 1)

    if cfg.norm_style == "post":
        x = layer_norm(x + attn(x), lp["ln1_scale"], lp["ln1_bias"], eps)
        f = branch(_ffn(cfg, lp, x, tp), cfg.hidden_dropout, 2)
        return layer_norm(x + f, lp["ln2_scale"], lp["ln2_bias"], eps)
    attn_out = attn(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps))
    if cfg.parallel_residual:
        h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
        return x + attn_out + branch(_ffn(cfg, lp, h2, tp), cfg.hidden_dropout, 2)
    x = x + attn_out
    h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    return x + branch(_ffn(cfg, lp, h2, tp), cfg.hidden_dropout, 2)


def _moe_layer(cfg: TransformerConfig, lp, moe_p, x, bias, positions, attn_fn, is_local=None, local_bias=None,
               key=None, pld_keep=None, row_offset: int = 0):
    """One MoE layer of ``apply`` (JAX ``transformer.py:909``) -> (x, aux):
    always pre-LN and sequential (LN1, attention, residual, LN2, the MoE
    FFN, residual), whatever ``norm_style`` and ``parallel_residual`` say,
    with the dropout sites and the layer-drop gate of ``_layer_body``."""
    eps = cfg.layernorm_epsilon
    gate = None
    if pld_keep is not None and key is not None:
        gate = (_uniform(_fold(key, 0), ()) < pld_keep).to(cfg.dtype)
    if is_local and local_bias is not None:
        lb = local_bias[None, None]
        bias = lb if bias is None else bias + lb

    def branch(y, rate, site):
        y = _dropout(y, rate, None if key is None else _fold(key, site), row_offset)
        return y if gate is None else gate * y

    q, k, v = _qkv_proj(cfg, lp, layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps), positions)
    x = x + branch(_attn_out_proj(cfg, lp, _attn_call(cfg, attn_fn, q, k, v, bias, is_local)), cfg.attn_dropout, 1)
    out, aux = moe_ffn_apply(cfg, moe_p, layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps))
    return x + branch(out, cfg.hidden_dropout, 2), aux


def _moe_stack(cfg: TransformerConfig, params: Params, what: str) -> Optional[list]:
    """The MoE layers' parameters, one dict each, or None for a dense
    model. Refused by name where the port does not run MoE yet: tensor
    parallelism and streamed parameters (ZeRO-3, offload_param)."""
    if cfg.moe_every <= 0:
        return None
    if plan_of(params) is not None:
        raise NotImplementedError(f"{what}: MoE under tensor parallelism (the experts split over the model axis) "
                                  "is not ported to deepspeed_tpu_torch yet")
    if _streamed(cfg, params):
        raise NotImplementedError(f"{what}: MoE with streamed parameters (ZeRO-3 or offload_param's per-layer "
                                  "streaming) is not ported to deepspeed_tpu_torch yet")
    if "moe" not in params:
        raise ValueError(f"{what}: moe_every={cfg.moe_every} but the parameters hold no 'moe' leaves")
    return moe_layers(params["moe"])


def embed(cfg: TransformerConfig, params: Params, tokens, positions=None, tp=None):
    """Token (+ learned position) embedding -> (x [B,S,d], positions [B,S]).
    Under ``tp`` a vocab-split table is looked up by range and all-reduced."""
    with cost.scope("embed"):
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        wte = params["wte"]
        x = (wte[tokens] if tp is None else tp.embed(wte, tokens)).to(cfg.dtype)
        if cfg.pos_emb == "learned":
            x = x + params["wpe"][positions].to(cfg.dtype)
        if cfg.embed_ln:
            x = layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"], cfg.layernorm_epsilon)
        return x, positions


def attn_bias(cfg: TransformerConfig, S: int, device="cpu", tp=None):
    """Additive attention bias [1,H,S,S] (ALiBi; this rank's heads under
    ``tp``) or None."""
    if cfg.pos_emb != "alibi":
        return None
    slopes = _slopes(cfg, device, tp)
    pos = torch.arange(S, device=device)
    dist = (pos[None, :] - pos[:, None]).float()
    return (slopes[:, None, None] * dist[None])[None]


def _final_ln(cfg: TransformerConfig, params: Params, x):
    if cfg.final_ln:
        x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layernorm_epsilon)
    return x


def _head(params: Params):
    head = params.get("lm_head")
    return params["wte"].t() if head is None else head


def _head_path(params: Params) -> tuple:
    return ("lm_head",) if "lm_head" in params else ("wte",)


def _project(params: Params, x, tp=None):
    """Vocab projection in x's dtype, then fp32 logits (under ``tp`` a
    vocab-split head's columns gathered to the full vocab)."""
    if tp is not None:
        x = tp.copy_in(x, *_head_path(params))
    logits = (x @ _head(params).to(x.dtype)).float()
    if tp is not None:
        logits = tp.logits(logits, _head_path(params))
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    return logits


def _lm_head(cfg: TransformerConfig, params: Params, x, tp=None):
    """Final LayerNorm + vocab projection."""
    return _project(params, _final_ln(cfg, params, x), tp)


def _remat_groups(cfg: TransformerConfig) -> list[range]:
    """The checkpointed regions: one per layer, or ``remat_group`` layers per
    region when it divides num_layers (the JAX number_checkpoints analogue);
    otherwise a warning and per-layer regions, as in the JAX package."""
    L, G = cfg.num_layers, cfg.remat_group
    if cfg.remat and G > 1 and L % G:
        warnings.warn(f"remat_group={G} does not divide num_layers={L}; "
                      "falling back to per-layer activation checkpointing")
    size = G if cfg.remat and G > 1 and L % G == 0 else 1
    return [range(i, i + size) for i in range(0, L, size)]


def _streamed(cfg: TransformerConfig, params: Params) -> bool:
    """Whether the parameters come through a streamer: host ones under
    ``param_offload``, or ZeRO-3 shards (``runtime/zero/stage3.py``), whose
    ``params`` carry the streamer that gathers them."""
    return cfg.param_offload or getattr(params, "streamer", None) is not None


def _stream_top_level(cfg: TransformerConfig, params: Params, device) -> Params:
    """Under ``param_offload`` or ZeRO-3: the non-stacked leaves
    (embeddings, final LayerNorm, head) on the device, once; ``layers``
    stays where it is for the loop to fetch a layer at a time. Identity
    otherwise. The tree keeps its tensor-parallel plan."""
    if not _streamed(cfg, params):
        return params
    tp = plan_of(params)
    out = param_offload.stream_top_level(params, device)
    if tp is None:
        return out
    if type(out) is dict:
        return TPParams(out, tp)
    out.tp = tp
    return out


def _layer_getter(cfg: TransformerConfig, params: Params, device) -> Callable[[int], dict]:
    """``get(i)`` -> layer i's leaves: sliced from the device stacks, or
    under ``param_offload`` streamed from the host ones, or under ZeRO-3
    gathered from the ranks' shards."""
    if _streamed(cfg, params):
        return param_offload.layer_getter(params, device)
    return _layers(params).__getitem__


# The remat policies whose saved residuals are named, the only ones the JAX
# package's cpu_checkpointing composes with (its _SAVED_NAMES)
OFFLOADABLE_POLICIES = ("save_flash", "nothing_saveable")


def _remat_region(cfg: TransformerConfig, device):
    """The context each checkpointed region runs in: under ``remat_offload``
    (cpu_checkpointing) the region's saved inputs, the layer boundaries, go
    to host memory (pinned on a card) and come back for the recompute."""
    if not cfg.remat_offload:
        return contextlib.nullcontext()
    if cfg.remat_policy not in OFFLOADABLE_POLICIES:
        raise ValueError(f"cpu_checkpointing composes with named-residual remat policies "
                         f"{sorted(OFFLOADABLE_POLICIES)}, not {cfg.remat_policy!r}")
    return torch.autograd.graph.save_on_cpu(pin_memory=torch.device(device).type == "cuda")


def _partition_axis(cfg: TransformerConfig, tp, seq_len: int) -> Optional[str]:
    """The mesh axis partition_activations splits the saved boundaries'
    sequence over: ``remat_partition_axis`` when the parameters carry a plan
    over a mesh where that axis is above 1 and divides ``seq_len`` (JAX
    ``transformer.py:462-467``); None keeps them whole."""
    axis = cfg.remat_partition_axis
    if not axis or tp is None:
        return None
    n = tp.mesh.shape.get(axis, 1)
    return axis if n > 1 and seq_len % n == 0 else None


def apply(cfg: TransformerConfig, params: Params, tokens, positions=None,
          return_hidden: bool = False, rng=None,
          step=None, _top_streamed: bool = False, row_offset: int = 0, with_aux: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] (fp32), or the final hidden
    states [B, S, d] (after the final LayerNorm) when ``return_hidden``.
    ``rng`` (a ``dropout_key`` on the tokens' device) enables dropout and
    progressive layer drop (training). It acts as a key, as the JAX rng
    does: layer i hashes the key folded with i and the embedding dropout the
    key folded with L, so one key gives one set of masks and a remat
    recompute replays them. ``step`` (int or 0-d tensor) drives the
    layer-drop schedule. ``row_offset``: ``tokens`` are those rows of the
    micro-batch (a data-parallel rank's), whose dropout masks they draw. With
    ``cfg.remat`` the layers run in checkpointed regions (``_remat_groups``)
    under ``cfg.remat_policy`` (and, with ``cfg.remat_offload``, their saved
    boundaries in host memory). Under ``cfg.param_offload`` the parameters
    are on the host and stream in (``_top_streamed``: the caller streamed
    the top-level leaves already, so the tied ``wte`` is streamed once).

    MoE (``moe_every`` > 0): layer i is an MoE layer (``_moe_layer``) when
    ``(i + 1) % moe_every == 0``. When ``moe_every`` divides the depth the
    checkpointed regions are the groups of ``moe_every`` layers ending in
    one (JAX's grouped scan under ``maybe_remat``); otherwise the layers
    run in one loop without remat (JAX's fallback). ``with_aux`` returns
    (output, the sum of the MoE layers' aux losses), 0 for a dense model."""
    B, S = tokens.shape
    L = cfg.num_layers
    device = tokens.device
    tp = plan_of(params)
    moe = _moe_stack(cfg, params, "apply")
    E = cfg.moe_every
    if not _top_streamed:
        params = _stream_top_level(cfg, params, device)
    x, positions = embed(cfg, params, tokens, positions, tp)
    keys = [None] * (L + 1) if rng is None else [_fold(rng, i) for i in range(L + 1)]
    x = _dropout(x, cfg.hidden_dropout, keys[L], row_offset)
    attn_fn = _attention_dispatch(cfg, device, tp)
    fused_bias = getattr(attn_fn, "handles_fused_bias", False)
    # the flash dispatch computes ALiBi and windows from positions in the
    # kernel: no [S, S] bias tensor is made
    bias = None if fused_bias else attn_bias(cfg, S, device, tp)
    has_local = cfg.local_attn_window > 0 and cfg.local_attn_layers is not None
    local_bias = _local_attn_bias(cfg, S, device) if has_local and not fused_bias else None
    pld_keep = [None] * L
    if rng is not None and cfg.pld_enabled:
        t = torch.as_tensor(0 if step is None else step, device=device).float()
        theta_t = cfg.pld_theta + (1.0 - cfg.pld_theta) * torch.exp(-cfg.pld_gamma * t)
        pld_keep = [1.0 - (i / max(1, L)) * (1.0 - theta_t) for i in range(L)]
    layer = _layer_getter(cfg, params, device)

    def run(x, idx):
        aux = None
        for i in idx:
            is_local = bool(cfg.local_attn_layers[i]) if has_local else None
            if moe is not None and (i + 1) % E == 0:
                x, a = _moe_layer(cfg, layer(i), moe[(i + 1) // E - 1], x, bias, positions, attn_fn, is_local,
                                  local_bias, keys[i], pld_keep[i], row_offset)
                aux = a if aux is None else aux + a
            else:
                x = _layer_body(cfg, layer(i), x, bias, positions, attn_fn, is_local, local_bias,
                                keys[i], pld_keep[i], row_offset, tp)
        return x, aux

    regions = _remat_groups(cfg) if moe is None else (
        [range(g, g + E) for g in range(0, L, E)] if L % E == 0 else [range(L)])
    remat = (cfg.remat and cfg.remat_policy != "everything_saveable" and torch.is_grad_enabled()
             and (moe is None or L % E == 0))
    kw = {}
    if remat and (context_fn := remat_context_fn(cfg.remat_policy)) is not None:
        kw["context_fn"] = context_fn
    region = _remat_region(cfg, device) if cfg.remat else contextlib.nullcontext()
    part = _partition_axis(cfg, tp, S) if remat else None
    if part is not None:
        # partition_activations: the region's input (what the checkpoint
        # keeps for its recompute) is this rank's rows of the boundary; the
        # region gathers them first, in the forward and in the recompute
        plain_run = run

        def run(xp, idx):
            return plain_run(comm.gather_from_model(xp, part, dim=1), idx)
    aux_total = None
    for idx in regions:
        if not remat:
            x, aux = run(x, idx)
        else:
            if part is not None:
                x = comm.scatter_to_model(x, part, dim=1)
            # preserve_rng_state=False: the masks are hashes of the layers'
            # keys, which the recompute hashes afresh
            with region:
                x, aux = checkpoint(run, x, idx, use_reentrant=False, preserve_rng_state=False, **kw)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    x = _final_ln(cfg, params, x)
    if not return_hidden:
        with cost.scope("lm_head"):
            x = _project(params, x, tp)
    if not with_aux:
        return x
    return x, torch.zeros((), device=device) if aux_total is None else aux_total


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device="cpu",
               heads: Optional[int] = None):
    """An empty KV cache for ``batch`` sequences of up to ``max_len``, of
    ``heads`` heads (default the model's; a tensor-parallel rank's own)."""
    shape = (cfg.num_layers, batch, max_len, heads or cfg.num_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _on_device(x, device) -> torch.Tensor:
    """``x`` (a host value or a tensor) as a tensor on ``device``. A host
    value is copied from pageable memory, which a CUDA graph cannot
    capture: under capture it raises, so the decode step's operands must
    already live on the device."""
    if torch.is_tensor(x) and x.device == torch.device(device):
        return x
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"under CUDA graph capture every position operand must already be a "
                           f"tensor on {device}; got {type(x).__name__}"
                           + (f" on {x.device}" if torch.is_tensor(x) else ""))
    return torch.as_tensor(x, device=device)


def _clamped(start, lo: int, hi: int, device) -> torch.Tensor:
    """``start`` (int or 0-d tensor) clamped to [lo, hi] as a device tensor,
    as ``lax.dynamic_slice``/``dynamic_update_slice`` clamp their starts.
    Eager paths only (prefill, chunks, prefix copies): a host ``start`` is
    copied to the device, which a graph capture refuses."""
    return _on_device(start, device).to(torch.long).clamp(lo, hi)


def slice_cache_slot(cache, slot, length: int, start=0):
    """Read row ``slot``'s KV window [start, start+length) out of a slot
    cache: {k,v} [L,B,Smax,H,Dh] -> [L,1,length,H,Dh] (a copy). ``slot`` and
    ``start`` are clamped into range as in the JAX version."""
    L, B, Smax, H, Dh = cache["k"].shape
    if length > Smax:
        raise ValueError(f"cache window ({length}) exceeds cache length {Smax}")
    dev = cache["k"].device
    rows = _clamped(slot, 0, B - 1, dev).reshape(1)
    idx = _clamped(start, 0, Smax - length, dev) + torch.arange(length, device=dev)
    return {kv: cache[kv].index_select(1, rows).index_select(2, idx) for kv in ("k", "v")}


def update_cache_slot(cache, window, slot, start=0):
    """Write a [L,1,W,H,Dh] KV window into row ``slot`` at [start, start+W),
    in place (starts clamped as in the JAX version); returns ``cache``."""
    L, B, Smax, H, Dh = cache["k"].shape
    W = window["k"].shape[2]
    dev = cache["k"].device
    row = _clamped(slot, 0, B - 1, dev)
    idx = _clamped(start, 0, Smax - W, dev) + torch.arange(W, device=dev)
    for kv in ("k", "v"):
        cache[kv][:, row, idx] = window[kv][:, 0].to(cache[kv].dtype)
    return cache


def cached_attention(q, k_cache, v_cache, pos, *, bias=None):
    """Attention of q [B,T,H,Dh] against a [B,Smax,H,Dh] cache whose valid
    keys are [0, pos+T); ``pos`` is a scalar or a per-row [B] tensor."""
    return xla_attention(q, k_cache, v_cache, causal_offset=pos, bias=bias)


def _cache_writer(pos, write_pos, B: int, T: int, Smax: int, device):
    """The in-place KV write for one layer's cache [B, Smax, H, Dh].

    Scalar ``pos``: the block lands at [pos, pos+T), its start clamped to
    [0, Smax-T] (``lax.dynamic_update_slice``). Per-row ``pos``: row b's
    block lands at [write_pos[b], +T) (``write_pos`` defaults to ``pos``),
    and its indices follow the JAX scatter with ``mode="drop"``: an index in
    [-Smax, -1] wraps to Smax + i, and one at or past Smax, or below -Smax,
    is dropped. The serving contract passes ``write_pos = Smax`` for idle
    rows so their write goes nowhere. The drop is one gather and one
    scatter per call with no host sync: every entry lands at its index
    modulo Smax, where a dropped entry writes back the value already there.
    A row's T <= Smax indices are consecutive, so their residues are
    distinct and a dropped entry never lands where its row writes: the
    write is exact for any ``write_pos``. Under CUDA graph capture
    ``write_pos`` must already be a device tensor."""
    if T > Smax:
        raise ValueError(f"{T} new tokens do not fit a cache of length {Smax}")
    if pos.ndim == 0:
        if write_pos is not None:
            raise ValueError("write_pos requires a per-row pos vector")
        idx = pos.long().clamp(0, Smax - T) + torch.arange(T, device=device)

        def write(c, new):
            c.index_copy_(1, idx, new.to(c.dtype))
        return write

    wp = pos if write_pos is None else _on_device(write_pos, device)
    idx = wp.long()[:, None] + torch.arange(T, device=device)[None, :]  # [B, T]
    valid = ((idx >= -Smax) & (idx < Smax))[:, :, None, None]
    target = torch.remainder(idx, Smax)
    rows = torch.arange(B, device=device)[:, None].expand(B, T)

    def write(c, new):
        c[rows, target] = torch.where(valid, new.to(c.dtype), c[rows, target])
    return write


def apply_with_cache(cfg: TransformerConfig, params: Params, tokens, cache, pos,
                     last_only: bool = False, last_index=None, write_pos=None):
    """tokens [B, T] entering at absolute position ``pos`` -> (logits fp32,
    cache). Serves prefill (T = prompt) and decode (T = 1). The cache is
    written in place and returned.

    ``pos`` is an int or 0-d tensor (all rows in lock-step) or a per-row [B]
    int tensor (each row at its own position). It may live on the device:
    nothing here reads it on the host. Under CUDA graph capture (the serving
    decode step) it and ``write_pos`` must already be device tensors.
    ``last_only`` projects only the last position to the vocab; ``last_index`` (int or 0-d tensor, clamped) only
    that position. ``write_pos`` (per-row ``pos`` only) moves where a row's
    KV is written; positions outside the cache are dropped.

    Single-token steps of non-ALiBi models with ``decode_attn="kernel"`` go
    through the decode-attention kernel; everything else through the plain
    masked attention over the whole cache.

    MoE layers (every ``moe_every``-th) route their FFN through the experts:
    capacity-free (``moe_ffn_dense``) at T == 1, on the capacity path with
    the capacity of these T x B tokens otherwise, in the layer's own
    residual form (JAX's ``layer_core``); ``moe_every`` must divide the
    depth, as in JAX."""
    if cfg.moe_every > 0 and cfg.num_layers % cfg.moe_every:
        raise NotImplementedError(
            "apply_with_cache with MoE needs num_layers divisible by moe_every "
            "and materialized expert params")
    if not cfg.causal:
        raise NotImplementedError("KV-cache decoding is causal-only (encoders use apply())")
    if cfg.norm_style != "pre":
        raise NotImplementedError("KV-cache decoding supports pre-LN models only")
    if cfg.attn_impl == "sparse":
        raise NotImplementedError(
            "block-sparse decode is not wired up — dense cache attention would "
            "silently change the attention pattern the model trained with"
        )
    B, T = tokens.shape
    device = tokens.device
    tp = plan_of(params)
    moe = _moe_stack(cfg, params, "apply_with_cache")
    params = _stream_top_level(cfg, params, device)
    Smax = cache["k"].shape[2]
    pos = _on_device(pos, device).to(torch.int32)
    vector_pos = pos.ndim >= 1
    arange_t = torch.arange(T, device=device, dtype=torch.int32)
    positions = (pos[:, None] if vector_pos else pos) + arange_t[None, :].expand(B, T)
    x, _ = embed(cfg, params, tokens, positions, tp)

    bias = None
    if cfg.pos_emb == "alibi":
        slopes = _slopes(cfg, device, tp)
        dist = (torch.arange(Smax, device=device)[None, None, :] - positions[:, :, None]).float()
        bias = slopes[None, :, None, None] * dist[:, None]  # [B, H, T, Smax]

    use_decode_kernel = T == 1 and cfg.decode_attn == "kernel" and cfg.pos_emb != "alibi"
    write = _cache_writer(pos, write_pos, B, T, Smax, device)
    eps = cfg.layernorm_epsilon
    layer = _layer_getter(cfg, params, device)
    for i in range(cfg.num_layers):
        lp = layer(i)
        ffn = functools.partial(_ffn, cfg, lp, tp=tp)
        if moe is not None and (i + 1) % cfg.moe_every == 0:
            moe_p = moe[(i + 1) // cfg.moe_every - 1]
            ffn = (functools.partial(moe_ffn_dense, cfg, moe_p) if T == 1
                   else lambda h2, moe_p=moe_p: moe_ffn_apply(cfg, moe_p, h2)[0])
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = _qkv_proj(cfg, lp, h, positions, tp)
        write(k_cache, k)  # before attention: the new token attends to itself
        write(v_cache, v)
        if use_decode_kernel:
            attn = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, pos)[:, None]
        else:
            attn = cached_attention(q, k_cache, v_cache, pos, bias=bias)
        attn_out = _attn_out_proj(cfg, lp, attn, tp)
        if cfg.parallel_residual:
            h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
            x = x + attn_out + ffn(h2)
        else:
            x = x + attn_out
            h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
            x = x + ffn(h2)
    if last_index is not None:
        x = x.index_select(1, _clamped(last_index, 0, T - 1, device).reshape(1))
    elif last_only:
        x = x[:, -1:]
    return _lm_head(cfg, params, x, tp), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def effective_loss_impl(cfg: TransformerConfig, n_rows: Optional[int] = None, mesh=None) -> tuple[str, str]:
    """(implementation, reason): the JAX predicate (``transformer.py:1193``).
    Over a ``mesh`` whose ``model`` axis is above 1 the head is vocab-split
    and the fused loss gives way to the chunked one, which runs vocab-
    parallel (JAX's tensor-parallel clause; the port passes the mesh, where
    JAX reads its active one). The fused loss takes row counts divisible by
    128 and by the row block, with 128-aligned blocks; ``n_rows=None`` gives
    the shape-free answer."""
    if cfg.loss_impl != "fused_xent":
        return "chunked", "configured"
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return "chunked", (
            "tensor-parallel mesh (model axis > 1) shards the vocab head; "
            "the fused_xent kernel cannot partition it — using the chunked "
            "loss, which runs vocab-parallel over the head's shards"
        )
    if n_rows is not None:
        br = cfg.loss_fused_block_rows or 128
        bv = cfg.loss_fused_block_v or 128
        if not (n_rows % 128 == 0 and n_rows % br == 0 and br % 128 == 0 and bv % 128 == 0):
            return "chunked", (
                f"rows (B*S={n_rows}) must be divisible by 128 and by "
                f"loss_fused_block_rows ({cfg.loss_fused_block_rows or 'auto'}), "
                f"with 128-aligned block_rows/block_v"
            )
    return "fused_xent", "configured"


def _nll_sum(h, labels, head):
    """(sum of next-token NLL over labelled rows, their count), fp32."""
    logits = (h @ head.to(h.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _nll_sum_split(h, labels, head, axis: str, start: int):
    """``_nll_sum`` over a vocab-split head: this rank's columns ``head``
    [d, V/tp] of the vocabulary from ``start``. The logits stay [.., V/tp];
    the max (no gradient), the sum of ``exp(logits - max)`` and the gold
    logit (from the rank whose range holds the label, 0 elsewhere) are
    reduced over ``axis``, the last two through ``reduce_from_model``, so
    each rank's logits get their part of the gradient."""
    logits = (h @ head.to(h.dtype)).float()
    m = comm.all_reduce(logits.detach().amax(dim=-1), axis, "max")
    z = comm.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), axis)
    n = logits.shape[-1]
    local = labels - start
    hit = (local >= 0) & (local < n)
    mine = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = comm.reduce_from_model(torch.where(hit, mine, torch.zeros_like(mine)), axis)
    mask = (labels >= 0).float()
    return torch.sum((torch.log(z) + m - gold) * mask), torch.sum(mask)


def lm_loss_from_hidden(cfg: TransformerConfig, params: Params, hidden, labels) -> torch.Tensor:
    """Token-mean next-token cross-entropy from final hidden states [B, S, d].

    ``loss_impl="fused_xent"``: the fused projection + cross-entropy
    (``ops/fused_xent.py``) over the B·S rows with the head cast to the
    hidden states' dtype, and the masked mean taken here; when
    ``effective_loss_impl`` refuses the shape it warns and takes the chunked
    loss, as the JAX package does. Chunked: the vocab projection a sequence
    chunk at a time, each chunk under ``torch.utils.checkpoint`` so its
    [B, chunk, V] logits are recomputed in the backward and never kept;
    unchunked when ``S % chunk or S <= chunk`` (or the chunk is 0). Under
    a vocab-split head (tensor parallelism) each chunk runs
    ``_nll_sum_split`` on this rank's columns, and ``hidden`` enters once
    through ``copy_to_model``."""
    head = _head(params)
    tp = plan_of(params)
    impl, reason = effective_loss_impl(cfg, n_rows=hidden.shape[0] * hidden.shape[1],
                                       mesh=None if tp is None else tp.mesh)
    if cfg.loss_impl == "fused_xent" and impl != "fused_xent":
        warnings.warn(f"loss_impl='fused_xent' falling back to the chunked loss ({reason}) — the fused "
                      "kernel's memory savings do NOT apply", stacklevel=2)
    if impl == "fused_xent":
        B, S, D = hidden.shape
        flat = labels.reshape(B * S)
        nll = fused_linear_xent(hidden.reshape(B * S, D), head.to(hidden.dtype), flat,
                                block_rows=cfg.loss_fused_block_rows or None,
                                block_v=cfg.loss_fused_block_v or None)
        mask = (flat >= 0).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    nll_sum = _nll_sum
    if tp is not None and tp.split(*_head_path(params)):
        hidden = tp.copy_in(hidden, *_head_path(params))
        nll_sum = functools.partial(_nll_sum_split, axis=tp.axis, start=tp.index * head.shape[-1])
    chunk = cfg.loss_chunk_size
    S = hidden.shape[1]
    if chunk <= 0 or S % chunk != 0 or S <= chunk:
        nll, count = nll_sum(hidden, labels, head)
        return nll / torch.clamp(count, min=1.0)
    nll = count = None
    for c0 in range(0, S, chunk):
        n, t = checkpoint(nll_sum, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head,
                          use_reentrant=False)
        nll, count = (n, t) if nll is None else (nll + n, count + t)
    return nll / torch.clamp(count, min=1.0)


def split_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize {'tokens'} / {'input_ids','labels'} batches to (inputs, labels)."""
    tokens = batch.get("tokens", batch.get("input_ids"))
    labels = batch.get("labels")
    if labels is None:
        return tokens[:, :-1], tokens[:, 1:]
    return tokens, labels


def causal_lm_loss(cfg: TransformerConfig, params: Params, batch: dict,
                   rng=None, step=None, row_offset: int = 0) -> torch.Tensor:
    """Next-token cross-entropy of batch {'tokens': [B, S+1]} (or
    {'input_ids', 'labels'}), plus ``moe_aux_coeff`` times the MoE layers'
    aux loss for an MoE model. ``rng`` (a ``dropout_key``) enables dropout
    for this step; ``row_offset`` places the rows in the micro-batch."""
    inputs, labels = split_batch(batch)
    # the top-level leaves streamed ONCE for the embedding and the tied head
    params = _stream_top_level(cfg, params, inputs.device)
    moe = cfg.moe_every > 0
    out = apply(cfg, params, inputs.long(), return_hidden=True, rng=rng, step=step, _top_streamed=True,
                row_offset=row_offset, with_aux=moe)
    hidden, aux = out if moe else (out, None)
    loss = lm_loss_from_hidden(cfg, params, hidden, labels.long())
    return loss if aux is None else loss + cfg.moe_aux_coeff * aux


class Model:
    """Bundle handed to ``initialize`` and ``init_inference``: the config plus
    init/apply/loss."""

    def __init__(self, cfg: TransformerConfig, loss_fn: Optional[Callable] = None):
        self.config = cfg
        self._loss = loss_fn or causal_lm_loss

    def init(self, generator: torch.Generator, device="cpu", place=None) -> Params:
        return init(self.config, generator, device, place)

    def apply(self, params: Params, tokens, positions=None, **kw):
        return apply(self.config, params, tokens, positions, **kw)

    def loss(self, params: Params, batch: dict, rng=None, step=None, row_offset: int = 0):
        kw = {}
        if rng is not None:
            kw["rng"] = rng
            if row_offset:
                kw["row_offset"] = row_offset
        if step is not None and self.config.pld_enabled:
            kw["step"] = step
        return self._loss(self.config, params, batch, **kw)

    def logical_axes(self) -> dict:
        return logical_axes(self.config)

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (forward + backward ≈ 6 × the
        matmul parameters, plus the attention term). The attention term is
        the JAX formula's dense one for every ``attn_impl``: for block-sparse
        attention it counts keys the kernels skip."""
        c = self.config
        n_params = (c.num_layers * (4 * c.hidden_size * c.hidden_size + 2 * c.hidden_size * c.ffn_size)
                    + c.vocab_size * c.hidden_size)
        attn = c.num_layers * 2 * c.max_seq_len * c.hidden_size  # per-token qk + av
        return 6.0 * (n_params + attn)
