"""Sparse self-attention module API and padding utilities, ported from
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.

Reference: ``ops/sparse_attention/sparse_self_attention.py`` —
``SparseSelfAttention`` (the module over the block-sparse kernels),
``bert_sparse_self_attention.py`` (drop-in BERT attention), and
``sparse_attention_utils.py`` ``SparseAttentionUtils`` (pad inputs to the
block size, extend position embeddings for longer sequences).

Without masks the compute goes through ``kernels.sparse_flash_attention``
(the CUDA kernels on CUDA tensors, their plain versions on CPU tensors).
With ``key_padding_mask`` or ``attn_mask`` it takes the dense masked path,
the model's plain ``xla_attention`` with the block layout materialized as an
additive bias, as the JAX package does: a mask makes the pattern
data-dependent, which the static block lists cannot express.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .kernels import sparse_flash_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class SparseSelfAttention:
    """Attention with a block-sparse pattern.

    ``apply(q, k, v, key_padding_mask=None, attn_mask=None)`` with q/k/v
    [B, S, H, D] (the model family's layout). Without masks the kernels run
    (only active blocks cost anything); with masks the layout is applied as
    an additive bias on the dense plain path."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 causal: bool = True, softmax_scale: Optional[float] = None,
                 max_seq_length: int = 2048):
        self.config = sparsity_config or FixedSparsityConfig(num_heads=1, block=64)
        self.causal = causal
        self.softmax_scale = softmax_scale
        self._layout_cache: dict[int, np.ndarray] = {}

    def layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = np.asarray(self.config.make_layout(seq_len))
        return self._layout_cache[seq_len]

    def _dense_mask(self, seq_len: int) -> np.ndarray:
        """[H or 1, S, S] additive mask materialized from the block layout
        (per-head layouts keep their per-head patterns)."""
        layout = self.layout(seq_len)
        if layout.ndim == 2:
            layout = layout[None]
        if (layout == layout[0]).all():
            layout = layout[:1]
        blk = seq_len // layout.shape[1]
        full = np.stack([np.kron(l, np.ones((blk, blk), np.float32)) for l in layout])
        return np.where(full > 0, 0.0, -1e9).astype(np.float32)

    def apply(self, q, k, v, key_padding_mask=None, attn_mask=None):
        B, S, H, D = q.shape
        if key_padding_mask is None and attn_mask is None:
            return sparse_flash_attention(q, k, v, self.layout(S), causal=self.causal,
                                          sm_scale=self.softmax_scale)
        if self.softmax_scale is not None:
            # the dense path (xla_attention) hard-codes 1/sqrt(D); fold the
            # configured scale into q so both paths see identical logits
            q = q * (self.softmax_scale * float(np.sqrt(D)))
        bias = torch.from_numpy(self._dense_mask(S)).to(q.device)[None]  # [1, H|1, S, S]
        if attn_mask is not None:
            am = torch.as_tensor(attn_mask, dtype=torch.float32, device=q.device)
            if am.ndim == 2:  # [B, S] 0/1 key mask (BERT spelling) -> additive
                am = torch.where(am > 0, 0.0, -1e9)[:, None, None, :]
            elif am.ndim == 3:  # [B, S, S] additive
                am = am[:, None]
            bias = bias + am
        if key_padding_mask is not None:
            kp = torch.as_tensor(key_padding_mask, dtype=torch.float32, device=q.device)  # [B, S]; 1 = keep
            bias = bias + torch.where(kp > 0, 0.0, -1e9)[:, None, None, :]
        from ...models.transformer import xla_attention

        return xla_attention(q, k, v, bias=bias, causal=self.causal)

    __call__ = apply


class BertSparseSelfAttention:
    """BERT-shaped attention block with sparse attention inside (reference
    bert_sparse_self_attention.py): owns q/k/v projections, consumes the
    [B, S, hidden] stream and the standard BERT additive attention mask."""

    def __init__(self, hidden_size: int, num_heads: int,
                 sparsity_config: Optional[SparsityConfig] = None):
        assert hidden_size % num_heads == 0
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.attn = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(num_heads=num_heads, block=64),
            causal=False)

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """{wq, wk, wv} [hidden, H, head_dim] ~ N(0, 1/hidden) drawn from
        ``generator``: the JAX distributions, not its numbers (carry JAX's
        weights across as numpy for those)."""
        scale = 1.0 / math.sqrt(self.hidden_size)
        shp = (self.hidden_size, self.num_heads, self.head_dim)
        return {name: (torch.randn(shp, generator=generator, device=generator.device) * scale).to(device)
                for name in ("wq", "wk", "wv")}

    def apply(self, params: dict, hidden_states, attention_mask=None):
        q = torch.einsum("bsd,dhk->bshk", hidden_states, params["wq"])
        k = torch.einsum("bsd,dhk->bshk", hidden_states, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", hidden_states, params["wv"])
        ctx = self.attn.apply(q, k, v, attn_mask=attention_mask)
        B, S = ctx.shape[:2]
        return ctx.reshape(B, S, self.hidden_size)

    __call__ = apply


class SparseAttentionUtils:
    """Reference sparse_attention_utils.py — sequence-length plumbing."""

    @staticmethod
    def pad_to_block_size(block: int, tokens=None, embeddings=None,
                          attention_mask=None, pad_token_id: int = 0):
        """Right-pad [B, S, ...] inputs so S is block-divisible; returns
        (pad_len, tokens, embeddings, attention_mask)."""
        ref = tokens if tokens is not None else embeddings
        assert ref is not None
        S = ref.shape[1]
        pad = (-S) % block
        if pad == 0:
            return 0, tokens, embeddings, attention_mask

        def padded(x, value):
            if x is None:
                return None
            x = torch.as_tensor(x)
            widths = [0, 0] * (x.ndim - 2) + [0, pad]  # F.pad order: last dim first; pad dim 1
            return torch.nn.functional.pad(x, widths, value=value)

        return (pad, padded(tokens, pad_token_id), padded(embeddings, 0),
                padded(attention_mask, 0))

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        return sequence_output if pad_len == 0 else sequence_output[:, :-pad_len]

    @staticmethod
    def extend_position_embedding(pos_emb, max_position: int):
        """Tile a [S, D] learned position table to ``max_position`` rows —
        the reference's recipe for running BERT beyond its trained length."""
        S, D = pos_emb.shape
        reps = -(-max_position // S)
        return torch.cat([pos_emb] * reps, dim=0)[:max_position]
