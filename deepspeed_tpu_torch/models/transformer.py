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
(dropout, layer drop) comes from an explicit ``torch.Generator``; it gives
other bits than ``jax.random`` for the same seed. As the JAX package splits
its key per layer, each layer draws from a generator of its own, seeded from
the caller's generator's seed and the layer index, so a remat recompute
replays the layer's masks.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_xent import fused_linear_xent
from ..ops.sparse_attention import SPARSITY_CONFIGS, sparse_flash_attention
from ..runtime.activation_checkpointing.checkpointing import REMAT_POLICIES, remat_context_fn

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
    # | save_flash | dots_and_flash). ``remat_offload`` (cpu_checkpointing)
    # and ``remat_partition_axis`` (partition_activations) raise: they belong
    # to the memory tiers and to tensor parallelism.
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
    moe_aux_coeff: float = 0.01
    # Not implemented in the port yet: any value but the default raises.
    moe_every: int = 0
    weight_bits: int = 0
    act_quant_bits: int = 0
    param_offload: bool = False

    def __post_init__(self):
        defaults = {"moe_every": 0, "weight_bits": 0, "act_quant_bits": 0, "param_offload": False,
                    "remat_offload": False, "remat_partition_axis": ""}
        for name, default in defaults.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={getattr(self, name)!r} is not implemented "
                    f"in deepspeed_tpu_torch yet (only {default!r})")
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

def init(cfg: TransformerConfig, generator: torch.Generator, device="cpu") -> Params:
    """The JAX ``init`` parameter tree, fp32, drawn from ``generator`` (on the
    generator's device) and placed on ``device``. Same distributions as the
    JAX package; not the same numbers (use ``interop.params_from_jax`` for
    those)."""
    d, f, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    H, Dh = cfg.num_heads, cfg.head_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=generator.device) * std).to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

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
    return params


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


def alibi_slopes(num_heads: int, device="cpu") -> torch.Tensor:
    """BLOOM ALiBi slopes [H] fp32."""
    closest = 2 ** math.floor(math.log2(num_heads))
    vals = [2 ** (-8.0 * (i + 1) / closest) for i in range(closest)]
    vals += [2 ** (-4.0 * (i + 1) / closest) for i in range(num_heads - closest)]
    return torch.tensor(vals, dtype=torch.float32, device=device)


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


def _ffn(cfg: TransformerConfig, lp, h):
    u = _linear(h, lp["wi"], lp.get("bi"))
    if cfg.activation == "relu":
        u = F.relu(u)
    elif cfg.activation == "gelu_exact":
        u = F.gelu(u)
    else:
        u = F.gelu(u, approximate="tanh")
    return _linear(u, lp["wo_mlp"], lp.get("bo_mlp"))


def _qkv_proj(cfg: TransformerConfig, lp, h, positions):
    """LN'd hidden states [B,T,d] -> rotary-embedded q, k, v [B,T,H,Dh]."""
    q = _linear(h, lp["wq"], lp.get("bq"))
    k = _linear(h, lp["wk"], lp.get("bk"))
    v = _linear(h, lp["wv"], lp.get("bv"))
    if cfg.pos_emb == "rotary":
        rd = int(cfg.head_dim * cfg.rotary_pct)
        q = rotary_embed(q, positions, rd, interleaved=cfg.rotary_interleaved)
        k = rotary_embed(k, positions, rd, interleaved=cfg.rotary_interleaved)
    return q, k, v


def _attn_out_proj(cfg: TransformerConfig, lp, attn_out):
    B, T, H, Dh = attn_out.shape
    return _linear(attn_out.reshape(B, T, H * Dh), lp["wo"].reshape(H * Dh, -1), lp.get("bo"))


def _layers(params: Params) -> list[dict]:
    """The stacked ``[L, ...]`` layer leaves as one dict per layer, taken with
    one ``torch.unbind`` per leaf: its backward is a single stack, where
    indexing each leaf L times would build a full-size zero gradient per
    index."""
    stacked = params["layers"]
    names = list(stacked)
    return [dict(zip(names, leaves)) for leaves in zip(*(torch.unbind(stacked[n], 0) for n in names))]


NEG_BIAS = -1e30


def _dropout(x, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout; identity when rate == 0 or no generator (inference)."""
    if rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
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


def _attention_dispatch(cfg: TransformerConfig, device="cpu") -> Callable:
    """attn_fn(q, k, v, bias[, window]) for ``cfg.attn_impl``. The flash
    dispatch fuses ALiBi and local windows in the kernel
    (``handles_fused_bias``); a dense bias falls back to plain attention, in
    the sparse dispatch too (as in the JAX package)."""
    if cfg.attn_impl == "flash":
        bq = cfg.flash_block_q or None
        bk = cfg.flash_block_k or None
        slopes = alibi_slopes(cfg.num_heads, device) if cfg.pos_emb == "alibi" else None

        def flash_fn(q, k, v, bias, window=None):
            if bias is not None:
                return xla_attention(q, k, v, bias=bias, causal=cfg.causal)
            return flash_attention(q, k, v, causal=cfg.causal, block_q=bq, block_k=bk,
                                   alibi_slopes=slopes, window=window)

        flash_fn.handles_fused_bias = True
        return flash_fn
    if cfg.attn_impl == "sparse":
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
                local_bias=None, gen=None, pld_keep=None):
    """One layer of ``apply``: pre-LN, post-LN or parallel residual, with
    dropout and the progressive-layer-drop gate when ``gen`` is given."""
    eps = cfg.layernorm_epsilon
    gate = None  # progressive layer drop: one coin per layer gates both branches
    if pld_keep is not None and gen is not None:
        gate = (torch.rand((), generator=gen, device=x.device) < pld_keep).to(cfg.dtype)
    if is_local and local_bias is not None:
        lb = local_bias[None, None]
        bias = lb if bias is None else bias + lb

    def branch(y, rate):
        y = _dropout(y, rate, gen)
        return y if gate is None else gate * y

    def attn(h):
        q, k, v = _qkv_proj(cfg, lp, h, positions)
        out = _attn_out_proj(cfg, lp, _attn_call(cfg, attn_fn, q, k, v, bias, is_local))
        return branch(out, cfg.attn_dropout)

    if cfg.norm_style == "post":
        x = layer_norm(x + attn(x), lp["ln1_scale"], lp["ln1_bias"], eps)
        f = branch(_ffn(cfg, lp, x), cfg.hidden_dropout)
        return layer_norm(x + f, lp["ln2_scale"], lp["ln2_bias"], eps)
    attn_out = attn(layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps))
    if cfg.parallel_residual:
        h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
        return x + attn_out + branch(_ffn(cfg, lp, h2), cfg.hidden_dropout)
    x = x + attn_out
    h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    return x + branch(_ffn(cfg, lp, h2), cfg.hidden_dropout)


def embed(cfg: TransformerConfig, params: Params, tokens, positions=None):
    """Token (+ learned position) embedding -> (x [B,S,d], positions [B,S])."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = params["wte"][tokens].to(cfg.dtype)
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][positions].to(cfg.dtype)
    if cfg.embed_ln:
        x = layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"], cfg.layernorm_epsilon)
    return x, positions


def attn_bias(cfg: TransformerConfig, S: int, device="cpu"):
    """Additive attention bias [1,H,S,S] (ALiBi) or None."""
    if cfg.pos_emb != "alibi":
        return None
    slopes = alibi_slopes(cfg.num_heads, device)
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


def _project(params: Params, x):
    """Vocab projection in x's dtype, then fp32 logits."""
    logits = (x @ _head(params).to(x.dtype)).float()
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    return logits


def _lm_head(cfg: TransformerConfig, params: Params, x):
    """Final LayerNorm + vocab projection."""
    return _project(params, _final_ln(cfg, params, x))


def _mix64(a: int, b: int) -> int:
    """A 63-bit seed from two integers (the splitmix64 finaliser)."""
    z = (a * 0x9E3779B97F4A7C15 + b + 1) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) >> 1


def _layer_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


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


def apply(cfg: TransformerConfig, params: Params, tokens, positions=None,
          return_hidden: bool = False, rng: Optional[torch.Generator] = None,
          step=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (fp32), or the final hidden
    states [B, S, d] (after the final LayerNorm) when ``return_hidden``.
    ``rng`` (a generator on the tokens' device) enables dropout and
    progressive layer drop (training). It acts as a key, as the JAX rng
    does: layer i draws from a generator seeded by (``rng.initial_seed()``,
    i) and the embedding dropout from one seeded by (``rng.initial_seed()``,
    L), so one seed gives one set of masks and a remat recompute replays
    them. ``step`` (int or 0-d tensor) drives the layer-drop schedule. With
    ``cfg.remat`` the layers run in checkpointed regions (``_remat_groups``)
    under ``cfg.remat_policy``."""
    B, S = tokens.shape
    L = cfg.num_layers
    device = tokens.device
    x, positions = embed(cfg, params, tokens, positions)
    seeds = [None] * (L + 1) if rng is None else [_mix64(rng.initial_seed(), i) for i in range(L + 1)]
    x = _dropout(x, cfg.hidden_dropout, _layer_generator(seeds[L], device))
    attn_fn = _attention_dispatch(cfg, device)
    fused_bias = getattr(attn_fn, "handles_fused_bias", False)
    # the flash dispatch computes ALiBi and windows from positions in the
    # kernel: no [S, S] bias tensor is made
    bias = None if fused_bias else attn_bias(cfg, S, device)
    has_local = cfg.local_attn_window > 0 and cfg.local_attn_layers is not None
    local_bias = _local_attn_bias(cfg, S, device) if has_local and not fused_bias else None
    pld_keep = [None] * L
    if rng is not None and cfg.pld_enabled:
        t = torch.as_tensor(0 if step is None else step, device=device).float()
        theta_t = cfg.pld_theta + (1.0 - cfg.pld_theta) * torch.exp(-cfg.pld_gamma * t)
        pld_keep = [1.0 - (i / max(1, L)) * (1.0 - theta_t) for i in range(L)]
    layers = _layers(params)

    def run(x, idx):
        for i in idx:
            is_local = bool(cfg.local_attn_layers[i]) if has_local else None
            x = _layer_body(cfg, layers[i], x, bias, positions, attn_fn, is_local, local_bias,
                            _layer_generator(seeds[i], device), pld_keep[i])
        return x

    remat = cfg.remat and cfg.remat_policy != "everything_saveable" and torch.is_grad_enabled()
    kw = {}
    if remat and (context_fn := remat_context_fn(cfg.remat_policy)) is not None:
        kw["context_fn"] = context_fn
    for idx in _remat_groups(cfg):
        # preserve_rng_state=False: the layers draw only from their own
        # seeded generators, which the recompute makes afresh
        x = checkpoint(run, x, idx, use_reentrant=False, preserve_rng_state=False, **kw) if remat else run(x, idx)
    x = _final_ln(cfg, params, x)
    return x if return_hidden else _project(params, x)


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device="cpu"):
    """An empty KV cache for ``batch`` sequences of up to ``max_len``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _clamped(start, lo: int, hi: int, device) -> torch.Tensor:
    """``start`` (int or 0-d tensor) clamped to [lo, hi] as a device tensor,
    as ``lax.dynamic_slice``/``dynamic_update_slice`` clamp their starts."""
    t = start if torch.is_tensor(start) else torch.tensor(start)
    return t.to(device=device, dtype=torch.long).clamp(lo, hi)


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
    and entries outside [0, Smax) are dropped, as the JAX scatter with
    ``mode="drop"`` drops them: the serving contract passes
    ``write_pos = Smax`` for idle rows so their write goes nowhere. The drop
    is a masked write, one position per row at a time, so no index leaves
    the cache and no host sync is needed."""
    if T > Smax:
        raise ValueError(f"{T} new tokens do not fit a cache of length {Smax}")
    if pos.ndim == 0:
        if write_pos is not None:
            raise ValueError("write_pos requires a per-row pos vector")
        idx = pos.long().clamp(0, Smax - T) + torch.arange(T, device=device)

        def write(c, new):
            c.index_copy_(1, idx, new.to(c.dtype))
        return write

    wp = pos if write_pos is None else torch.as_tensor(write_pos, device=device)
    wpos = wp.long()[:, None] + torch.arange(T, device=device)[None, :]  # [B, T]
    valid = (wpos >= 0) & (wpos < Smax)
    safe = wpos.clamp(0, Smax - 1)
    rows = torch.arange(B, device=device)

    def write(c, new):
        new = new.to(c.dtype)
        for t in range(T):
            cur = c[rows, safe[:, t]]
            c[rows, safe[:, t]] = torch.where(valid[:, t, None, None], new[:, t], cur)
    return write


def apply_with_cache(cfg: TransformerConfig, params: Params, tokens, cache, pos,
                     last_only: bool = False, last_index=None, write_pos=None):
    """tokens [B, T] entering at absolute position ``pos`` -> (logits fp32,
    cache). Serves prefill (T = prompt) and decode (T = 1). The cache is
    written in place and returned.

    ``pos`` is an int or 0-d tensor (all rows in lock-step) or a per-row [B]
    int tensor (each row at its own position). It may live on the device:
    nothing here reads it on the host. ``last_only`` projects only the last
    position to the vocab; ``last_index`` (int or 0-d tensor, clamped) only
    that position. ``write_pos`` (per-row ``pos`` only) moves where a row's
    KV is written; positions outside the cache are dropped.

    Single-token steps of non-ALiBi models with ``decode_attn="kernel"`` go
    through the decode-attention kernel; everything else through the plain
    masked attention over the whole cache."""
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
    Smax = cache["k"].shape[2]
    pos = (pos if torch.is_tensor(pos) else torch.tensor(pos)).to(device=device, dtype=torch.int32)
    vector_pos = pos.ndim >= 1
    arange_t = torch.arange(T, device=device, dtype=torch.int32)
    positions = (pos[:, None] if vector_pos else pos) + arange_t[None, :].expand(B, T)
    x, _ = embed(cfg, params, tokens, positions)

    bias = None
    if cfg.pos_emb == "alibi":
        slopes = alibi_slopes(cfg.num_heads, device)
        dist = (torch.arange(Smax, device=device)[None, None, :] - positions[:, :, None]).float()
        bias = slopes[None, :, None, None] * dist[:, None]  # [B, H, T, Smax]

    use_decode_kernel = T == 1 and cfg.decode_attn == "kernel" and cfg.pos_emb != "alibi"
    write = _cache_writer(pos, write_pos, B, T, Smax, device)
    eps = cfg.layernorm_epsilon
    for i, lp in enumerate(_layers(params)):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        q, k, v = _qkv_proj(cfg, lp, h, positions)
        write(k_cache, k)  # before attention: the new token attends to itself
        write(v_cache, v)
        if use_decode_kernel:
            attn = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, pos)[:, None]
        else:
            attn = cached_attention(q, k_cache, v_cache, pos, bias=bias)
        attn_out = _attn_out_proj(cfg, lp, attn)
        if cfg.parallel_residual:
            h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
            x = x + attn_out + _ffn(cfg, lp, h2)
        else:
            x = x + attn_out
            h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
            x = x + _ffn(cfg, lp, h2)
    if last_index is not None:
        x = x.index_select(1, _clamped(last_index, 0, T - 1, device).reshape(1))
    elif last_only:
        x = x[:, -1:]
    return _lm_head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def effective_loss_impl(cfg: TransformerConfig, n_rows: Optional[int] = None) -> tuple[str, str]:
    """(implementation, reason): the JAX predicate (``transformer.py:1193``).
    The fused loss takes row counts divisible by 128 and by the row block,
    with 128-aligned blocks; ``n_rows=None`` gives the shape-free answer.
    The JAX clause for a tensor-parallel mesh does not apply: the port runs
    on one device."""
    if cfg.loss_impl != "fused_xent":
        return "chunked", "configured"
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


def lm_loss_from_hidden(cfg: TransformerConfig, params: Params, hidden, labels) -> torch.Tensor:
    """Token-mean next-token cross-entropy from final hidden states [B, S, d].

    ``loss_impl="fused_xent"``: the fused projection + cross-entropy
    (``ops/fused_xent.py``) over the B·S rows with the head cast to the
    hidden states' dtype, and the masked mean taken here; when
    ``effective_loss_impl`` refuses the shape it warns and takes the chunked
    loss, as the JAX package does. Chunked: the vocab projection a sequence
    chunk at a time, each chunk under ``torch.utils.checkpoint`` so its
    [B, chunk, V] logits are recomputed in the backward and never kept;
    unchunked when ``S % chunk or S <= chunk`` (or the chunk is 0)."""
    head = _head(params)
    impl, reason = effective_loss_impl(cfg, n_rows=hidden.shape[0] * hidden.shape[1])
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
    chunk = cfg.loss_chunk_size
    S = hidden.shape[1]
    if chunk <= 0 or S % chunk != 0 or S <= chunk:
        nll, count = _nll_sum(hidden, labels, head)
        return nll / torch.clamp(count, min=1.0)
    nll = count = None
    for c0 in range(0, S, chunk):
        n, t = checkpoint(_nll_sum, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head,
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
                   rng: Optional[torch.Generator] = None, step=None) -> torch.Tensor:
    """Next-token cross-entropy of batch {'tokens': [B, S+1]} (or
    {'input_ids', 'labels'}). ``rng`` enables dropout for this step."""
    inputs, labels = split_batch(batch)
    hidden = apply(cfg, params, inputs.long(), return_hidden=True, rng=rng, step=step)
    return lm_loss_from_hidden(cfg, params, hidden, labels.long())


class Model:
    """Bundle handed to ``initialize`` and ``init_inference``: the config plus
    init/apply/loss."""

    def __init__(self, cfg: TransformerConfig, loss_fn: Optional[Callable] = None):
        self.config = cfg
        self._loss = loss_fn or causal_lm_loss

    def init(self, generator: torch.Generator, device="cpu") -> Params:
        return init(self.config, generator, device)

    def apply(self, params: Params, tokens, positions=None, **kw):
        return apply(self.config, params, tokens, positions, **kw)

    def loss(self, params: Params, batch: dict, rng: Optional[torch.Generator] = None, step=None):
        kw = {}
        if rng is not None:
            kw["rng"] = rng
        if step is not None and self.config.pld_enabled:
            kw["step"] = step
        return self._loss(self.config, params, batch, **kw)

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
