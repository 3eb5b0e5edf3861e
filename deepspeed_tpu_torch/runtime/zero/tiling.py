"""Tiled linear layers, bounded-memory matmuls for very large projections,
ported from ``deepspeed_tpu/runtime/zero/tiling.py``.

Reference: ``deepspeed.zero.TiledLinear`` (runtime/zero/tiling.py:1-296)
splits one huge ``nn.Linear`` into ``in_splits × out_splits`` sub-linears,
so only one tile's weights and one partial product are live at a time.

The weight keeps the JAX layout, the tiles a leading axis of one tensor,
``w[in_splits, in_tile, out_features]``. The forward adds the tiles'
partial products one input tile at a time, each step under
``torch.utils.checkpoint``, so the backward recomputes a tile's product
instead of keeping it (the JAX ``lax.scan`` over a ``jax.checkpoint``
body); ``out_splits`` further chunks the output dimension inside a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class TiledLinearConfig:
    in_features: int
    out_features: int
    in_splits: int = 1
    out_splits: int = 1
    use_bias: bool = True

    def __post_init__(self):
        if self.in_splits < 1 or self.out_splits < 1:
            raise ValueError(f"splits must be >= 1, got in {self.in_splits}, out {self.out_splits}")
        if self.in_features % self.in_splits:
            raise ValueError(f"in_splits {self.in_splits} must divide in_features {self.in_features}")
        if self.out_features % self.out_splits:
            raise ValueError(f"out_splits {self.out_splits} must divide out_features {self.out_features}")


def _tile_step(acc, x_i, w_i, out_splits: int):
    if out_splits > 1:  # one [N, out_tile] slab live at a time
        cols = w_i.reshape(w_i.shape[0], out_splits, -1)
        y = torch.cat([x_i @ cols[:, j] for j in range(out_splits)], dim=-1)
    else:
        y = x_i @ w_i
    return acc + y


class TiledLinear:
    """Functional tiled linear: ``init(generator) -> params``,
    ``apply(params, x)``, with the JAX weight layout."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1, out_splits: int = 1,
                 use_bias: bool = True):
        self.config = TiledLinearConfig(in_features, out_features, in_splits, out_splits, use_bias)

    # -- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator, scale: Optional[float] = None, device="cpu") -> dict:
        c = self.config
        scale = scale if scale is not None else 1.0 / math.sqrt(c.in_features)
        w = torch.randn((c.in_splits, c.in_features // c.in_splits, c.out_features), generator=generator,
                        device=generator.device) * scale
        params = {"w": w.to(device)}
        if c.use_bias:
            params["b"] = torch.zeros(c.out_features, device=device)
        return params

    def logical_axes(self) -> dict:
        axes = {"w": ("layers", "embed", "mlp")}
        if self.config.use_bias:
            axes["b"] = ("mlp",)
        return axes

    # -- conversion (reference TiledLinear.copy_params_from) ------------------
    def from_dense(self, w_dense: torch.Tensor, b: Optional[torch.Tensor] = None) -> dict:
        c = self.config
        if tuple(w_dense.shape) != (c.in_features, c.out_features):
            raise ValueError(f"dense weight {tuple(w_dense.shape)} is not ({c.in_features}, {c.out_features})")
        params = {"w": w_dense.reshape(c.in_splits, c.in_features // c.in_splits, c.out_features)}
        if c.use_bias:
            params["b"] = b if b is not None else torch.zeros(c.out_features, device=w_dense.device)
        return params

    def to_dense(self, params: dict) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        c = self.config
        return params["w"].reshape(c.in_features, c.out_features), params.get("b")

    # -- forward -------------------------------------------------------------
    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        lead = x.shape[:-1]
        xt = x.reshape(-1, c.in_splits, c.in_features // c.in_splits).movedim(1, 0)  # [in_splits, N, in_tile]
        w = params["w"].to(x.dtype)
        y = torch.zeros(xt.shape[1], c.out_features, dtype=x.dtype, device=x.device)
        for i in range(c.in_splits):
            if torch.is_grad_enabled():
                y = checkpoint(_tile_step, y, xt[i], w[i], c.out_splits, use_reentrant=False)
            else:
                y = _tile_step(y, xt[i], w[i], c.out_splits)
        if c.use_bias and "b" in params:
            y = y + params["b"].to(y.dtype)
        return y.reshape(*lead, c.out_features)

    __call__ = apply


def split_tensor_along_dim(t: torch.Tensor, splits: int, dim: int) -> list[torch.Tensor]:
    """Partition a tensor into ``splits`` equal parts along ``dim``."""
    if t.shape[dim] % splits:
        raise ValueError(f"{splits} splits do not divide dim {dim} of size {t.shape[dim]}")
    return list(torch.chunk(t, splits, dim=dim))
