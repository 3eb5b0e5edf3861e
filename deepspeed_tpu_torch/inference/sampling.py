"""Token sampling for generative inference: temperature, top-k, top-p
(nucleus) and CTRL-style repetition penalty, on [B, V] logits (the port of
``deepspeed_tpu/inference/sampling.py``).

Random draws come from a ``torch.Generator`` through the Gumbel-max trick,
as ``jax.random.categorical`` draws; the two frameworks' streams differ, so
only greedy decoding gives the same tokens in both. Nothing here reads a
device value on the host.

The ``*_vector`` functions are the serving engine's: every sampler knob is
a per-row tensor (temperature, top-k, top-p [B]), so one decode program
serves any mix of requests, and they allocate and draw only on the
logits' device, so the CUDA-graph decode step can capture them (the
generator must then be registered with the graph).
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
    return (scaled + _gumbel(scaled.shape, generator, scaled.device)).argmax(dim=-1).to(torch.int32)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def _filter_logits_vector(logits, t, k, p):
    """The per-row filter core shared by the decode sampler and the
    speculative verifier: fp32 ``logits`` [B, V] scaled by temperature
    ``t`` [B], then masked below the top-k and nucleus thresholds (``k``,
    ``p`` [B]; k <= 0 or >= V and p >= 1 disable a row's filter). Returns
    the filtered scaled logits.

    One descending sort serves both filters: top-k masks a suffix of the
    sorted row to NEG_INF, which keeps it sorted, so the nucleus pass reuses
    it (the same as top-k then top-p applied in turn)."""
    scaled = logits / torch.clamp(t, min=1e-6)[:, None]
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k.long() - 1).clamp(0, V - 1)[:, None])
    k_on = ((k > 0) & (k < V))[:, None]
    scaled = torch.where(k_on & (scaled < kth), NEG_INF, scaled)
    sorted_desc = torch.where(k_on & (sorted_desc < kth), NEG_INF, sorted_desc)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # the first token is always kept: p <= 0 degenerates to top-1
    keep = (cum - probs) < p[:, None]
    keep[:, 0] = True
    pth = torch.where(keep, sorted_desc, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where((p < 1.0)[:, None] & (scaled < pth), NEG_INF, scaled)


def sample_logits_vector(logits, generator: torch.Generator, temperature, top_k, top_p):
    """Per-slot sampling: logits [B, V] with per-row sampler state
    (``temperature``/``top_k``/``top_p`` [B] tensors on logits' device) ->
    token ids [B] int32. Rows with temperature <= 0 take the argmax; the
    others a Gumbel-max draw from ``generator`` (on logits' device)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    scaled = _filter_logits_vector(logits, temperature, top_k, top_p)
    drawn = (scaled + _gumbel(scaled.shape, generator, scaled.device)).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


def verify_logits_vector(logits, draft, generator: torch.Generator, temperature, top_k, top_p):
    """Speculative verify of a whole draft block: logits [B, D+1, V]
    (position j predicts the token AFTER draft token j), draft [B, D] int
    proposals, per-row sampler state [B] ->

      accept   [B, D]   bool  — per-position accept verdicts
      resample [B, D+1] int32 — the token to emit AT a rejection, drawn from
                                the filtered distribution with the rejected
                                draft token masked out; the last column (no
                                draft to reject) is ``clean``'s
      clean    [B, D+1] int32 — an unconditional sample per position, the
                                bonus token when the draft ran out

    Greedy rows (temperature <= 0) accept exactly when the draft token IS
    the argmax, and both resample and clean ARE the argmax, so the emitted
    stream is what one-token decode gives. Sampled rows use the speculative
    acceptance rule against a deterministic drafter (q(d) = 1): accept with
    probability p(d) under the filtered distribution, else emit the
    residual sample; the output marginal stays the filtered distribution.
    The host applies the prefix rule (stop at the first rejection)."""
    logits = logits.float()
    B, D1, V = logits.shape
    D = D1 - 1

    def rep(a):
        return a[:, None].expand(B, D1).reshape(B * D1)

    filt = _filter_logits_vector(logits.reshape(B * D1, V), rep(temperature), rep(top_k),
                                 rep(top_p)).reshape(B, D1, V)
    greedy = logits.argmax(dim=-1)  # [B, D1]
    sampled = (temperature > 0.0)[:, None]
    draft = draft.long()
    probs = torch.softmax(filt, dim=-1)
    p_draft = torch.gather(probs[:, :D], -1, draft[..., None])[..., 0]  # [B, D]
    u = torch.rand((B, D), generator=generator, device=logits.device)
    accept = torch.where(sampled, u < p_draft, draft == greedy[:, :D])
    dev = logits.device
    clean_drawn = (filt + _gumbel(filt.shape, generator, dev)).argmax(dim=-1)  # [B, D1]
    clean = torch.where(sampled, clean_drawn, greedy).to(torch.int32)
    # the residual of a deterministic drafter: p with the draft token
    # removed and renormalised, i.e. that token masked out of the logits
    masked = filt[:, :D].scatter(-1, draft[..., None], NEG_INF)
    res_drawn = (masked + _gumbel(masked.shape, generator, dev)).argmax(dim=-1)  # [B, D]
    res = torch.where(sampled, res_drawn, greedy[:, :D])
    resample = torch.cat([res.to(torch.int32), clean[:, D:]], dim=1)
    return accept, resample, clean
