"""Token sampling for generative inference: temperature, top-k, top-p
(nucleus) and CTRL-style repetition penalty, on [B, V] logits (the port of
``deepspeed_tpu/inference/sampling.py``).

Random draws come from a ``torch.Generator`` through the Gumbel-max trick,
as ``jax.random.categorical`` draws; the two frameworks' streams differ, so
only greedy decoding gives the same tokens in both. Nothing here reads a
device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class SamplerConfig(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    repetition_penalty: float = 1.0  # 1.0 = disabled


def update_seen(seen: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """seen [B, V] bool | tokens [B, T] -> seen with those tokens marked."""
    return seen.scatter(1, tokens.long(), True)


def apply_repetition_penalty(logits, seen, penalty: float):
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_top_k(logits, k: int):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, NEG_INF, logits)


def apply_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while the mass BEFORE them is < p; the first is always
    # kept (p <= 0 would otherwise mask every logit)
    keep = (cum - probs) < p
    keep[..., 0] = True
    thresh = torch.where(keep, sorted_logits, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, NEG_INF, logits)


def sample_logits(logits, generator: torch.Generator, cfg: SamplerConfig, seen=None):
    """logits [B, V] -> token ids [B] int32; temperature <= 0 is greedy
    (after the repetition penalty). ``generator`` must be on logits' device."""
    logits = logits.float()
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, cfg.repetition_penalty)
    if cfg.temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / max(cfg.temperature, 1e-6)
    scaled = apply_top_p(apply_top_k(scaled, cfg.top_k), cfg.top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u))
    return (scaled + gumbel).argmax(dim=-1).to(torch.int32)
