"""The expert FFN bank, the port of ``deepspeed_tpu/moe/experts.py``: one
stacked ``[E, ...]`` parameter pair, so every expert's product is one
batched matmul."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_experts(generator: torch.Generator, num_experts: int, d_model: int, d_ff: int, device="cpu") -> dict:
    """``wi`` [E, M, F] and ``wo`` [E, F, M], fp32, drawn from ``generator``
    (on its device) with JAX's scales and placed on ``device``."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=generator.device) * std).to(device)

    return {"wi": normal((num_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
            "wo": normal((num_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff))}


def experts_logical_axes() -> dict:
    return {"wi": ("expert", "embed", "mlp"), "wo": ("expert", "mlp", "embed")}


def apply_experts(params: dict, expert_inputs: torch.Tensor) -> torch.Tensor:
    """[E, C, M] -> [E, C, M]: two batched products in the inputs' dtype.
    The activation is always tanh-GELU, whatever the model's, as in JAX."""
    h = torch.bmm(expert_inputs, params["wi"].to(expert_inputs.dtype))
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["wo"].to(expert_inputs.dtype))
