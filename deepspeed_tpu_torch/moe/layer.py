"""The MoE FFN of a transformer layer, the port of
``deepspeed_tpu/moe/layer.py``: the stacked parameters of a model's MoE
layers, the capacity path (``moe_ffn_apply``, training and prefill) and the
capacity-free dense path (``moe_ffn_dense``, single-token decode)."""

from __future__ import annotations

import math

import torch

from .experts import apply_experts, experts_logical_axes
from .sharded_moe import moe_dispatch_combine


def init_moe_params(generator: torch.Generator, num_moe_layers: int, num_experts: int, d_model: int,
                    d_ff: int, device="cpu", place=None) -> dict:
    """Stacked ``[n_moe, ...]`` leaves: ``gate`` [n_moe, M, E] and
    ``experts.wi`` / ``experts.wo`` [n_moe, E, M, F] / [n_moe, E, F, M],
    fp32, JAX's scales, drawn from ``generator`` in that order.
    ``place(path, leaf)`` as in ``models.transformer.init``."""
    place = place or (lambda path, t: t)

    def normal(path, shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return place(("moe",) + path, t.to(device))

    n, E, M, Fd = num_moe_layers, num_experts, d_model, d_ff
    return {"gate": normal(("gate",), (n, M, E), 1.0 / math.sqrt(M)),
            "experts": {"wi": normal(("experts", "wi"), (n, E, M, Fd), 1.0 / math.sqrt(M)),
                        "wo": normal(("experts", "wo"), (n, E, Fd, M), 1.0 / math.sqrt(Fd))}}


def moe_logical_axes() -> dict:
    return {"gate": (None, "embed", None),
            "experts": {k: (None,) + v for k, v in experts_logical_axes().items()}}


def moe_layers(moe_params: dict) -> list[dict]:
    """The stacked leaves as one dict per MoE layer, each leaf taken with
    one ``torch.unbind`` (whose backward is one stack)."""
    gates = torch.unbind(moe_params["gate"], 0)
    wi = torch.unbind(moe_params["experts"]["wi"], 0)
    wo = torch.unbind(moe_params["experts"]["wo"], 0)
    return [{"gate": g, "experts": {"wi": a, "wo": b}} for g, a, b in zip(gates, wi, wo)]


def moe_ffn_apply(cfg, moe_params: dict, h: torch.Tensor, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """h [B, S, M] -> (out [B, S, M], aux): one MoE FFN on the capacity path."""
    B, S, M = h.shape
    out, aux = moe_dispatch_combine(h.reshape(B * S, M), moe_params["gate"],
                                    lambda ei: apply_experts(moe_params["experts"], ei),
                                    capacity_factor=cfg.moe_capacity_factor, top_k=cfg.moe_top_k, mesh=mesh)
    return out.reshape(B, S, M), aux


def moe_ffn_dense(cfg, moe_params: dict, h: torch.Tensor) -> torch.Tensor:
    """Capacity-free MoE for decode: every expert on every token, each token
    mixing its top-k experts. The logits are in ``h``'s dtype, the softmax in
    fp32; top-k is a threshold (``probs >= k-th value``, so a tie keeps more
    than k experts) and only k >= 2 renormalises, as in JAX."""
    B, S, M = h.shape
    x = h.reshape(B * S, M)
    logits = x @ moe_params["gate"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    E = probs.shape[-1]
    if cfg.moe_top_k < E:
        thresh = torch.topk(probs, cfg.moe_top_k, dim=-1).values[..., -1:]
        probs = torch.where(probs >= thresh, probs, torch.zeros((), device=probs.device))
        if cfg.moe_top_k >= 2:
            probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
    ye = apply_experts(moe_params["experts"], x[None].expand(E, *x.shape))  # [E, T, M]
    return torch.einsum("te,etm->tm", probs.to(x.dtype), ye).reshape(B, S, M)
