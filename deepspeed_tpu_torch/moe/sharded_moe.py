"""GShard top-1/top-2 gating and dispatch/combine, the port of
``deepspeed_tpu/moe/sharded_moe.py`` (reference ``moe/sharded_moe.py:177``
top1gating and ``:278`` top2gating): a softmax gate in fp32, the capacity
``max(int(tokens * factor / experts), min_capacity)``, the load-balancing
aux loss ``E * sum(mean gate prob * fraction routed)`` over the first
choice before any drop, each token's place in its expert's queue by an
exclusive cumsum over the tokens, and the tokens past capacity dropped.

``top1_gating`` and ``top2_gating`` return JAX's dense ``[T, E, C]``
combine and dispatch tensors. ``moe_dispatch_combine`` computes JAX's
function without them: the routing (``route``) gives each token's expert,
queue position, kept flag and weight per choice, a static-shape slot table
``[E * C]`` names the token that fills each (expert, slot) (or an empty
row of zeros), the expert inputs ``[E, C, M]`` are gathered through it and
each token gathers its ``top_k`` gated outputs back. Every shape depends on
``T``, ``E``, ``C`` and ``M`` only, never on the data. A slot is filled by
at most one token and a token reads at most ``top_k`` slots, so the
backward's accumulations add at most two terms to any row that is kept:
the step is bitwise reproducible.

The gating is a global-view program: capacity and queue positions are taken
over all ``T`` tokens given. Expert parallelism (ranks gating their own rows
and exchanging them with ``all_to_all``) computes another function unless
the queue positions are scanned over the ranks; it is not ported, and a
``mesh`` whose expert axes are above 1, or a process group above 1, raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import comm

EXPERT_AXES = ("data", "fsdp")  # EP rides the DP ranks (as in the JAX package)

_EXPERT_PARALLEL = ("expert parallelism (MoE over a data-parallel world above 1: the gating's capacity and "
                    "queue positions scanned over the ranks, the tokens exchanged with all_to_all) is not "
                    "ported to deepspeed_tpu_torch yet")


def refuse_expert_parallel(mesh=None) -> None:
    """Raise unless the experts run on this rank alone: a mesh whose
    ``EXPERT_AXES`` are above 1, or a process group of more than one rank."""
    shape = dict(getattr(mesh, "shape", mesh or {}))
    if any(shape.get(a, 1) > 1 for a in EXPERT_AXES) or (comm.is_initialized() and comm.get_world_size() > 1):
        raise NotImplementedError(_EXPERT_PARALLEL)


def _cumsum_exclusive(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


class Route(NamedTuple):
    """One token's routing per choice k (``[top_k, T]`` each): its expert,
    its position in that expert's queue (positions of dropped tokens are
    kept, as JAX computes them), whether it is kept under capacity, and its
    combine weight (0 when dropped)."""
    expert: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    weight: torch.Tensor


def _aux_loss(gates: torch.Tensor, mask1: torch.Tensor) -> torch.Tensor:
    """GShard's load-balancing loss over the first choice before any drop."""
    E = gates.shape[-1]
    return torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * E


def _position(mask: torch.Tensor) -> torch.Tensor:
    """Each token's place in its chosen expert's queue, [T] fp32."""
    return torch.sum(_cumsum_exclusive(mask, 0) * mask, dim=-1)


def _gumbel(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``logits``: -log of an Exp(1) draw."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device).exponential_(generator=generator)
    return -torch.log(e)


def route_top1(logits: torch.Tensor, capacity: int, rng: Optional[torch.Generator] = None,
               noisy: bool = False) -> tuple[Route, torch.Tensor]:
    """logits [T, E] -> (Route of one choice, aux loss). ``noisy`` adds
    Gumbel noise from ``rng`` to the logits the argmax reads (JAX's noisy
    top-1, reachable only by a direct call; another stream than
    ``jax.random``'s). The weight is the raw gate probability."""
    E = logits.shape[-1]
    choice = logits + _gumbel(logits, rng) if noisy and rng is not None else logits
    gates = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(choice, dim=-1)
    mask1 = F.one_hot(idx, E).float()
    aux = _aux_loss(gates, mask1)
    pos = _position(mask1)
    kept = pos < capacity
    weight = torch.gather(gates, 1, idx[:, None])[:, 0] * kept
    return Route(idx[None], pos[None], kept[None], weight[None]), aux


def route_top2(logits: torch.Tensor, capacity: int) -> tuple[Route, torch.Tensor]:
    """logits [T, E] -> (Route of two choices, aux loss): the second expert
    the best after masking the first; its queue positions start after every
    first-choice claim on that expert; the pair's kept gates renormalised
    with an ``eps`` floor."""
    E = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, E).float()
    idx2 = torch.argmax(gates * (1.0 - mask1), dim=-1)
    mask2 = F.one_hot(idx2, E).float()
    aux = _aux_loss(gates, mask1)
    pos1 = _position(mask1)
    pos2 = _position(mask2) + torch.sum(mask1.sum(dim=0) * mask2, dim=-1)
    kept1, kept2 = pos1 < capacity, pos2 < capacity
    gate1 = torch.gather(gates, 1, idx1[:, None])[:, 0] * kept1
    gate2 = torch.gather(gates, 1, idx2[:, None])[:, 0] * kept2
    denom = torch.clamp(gate1 + gate2, min=torch.finfo(torch.float32).eps)
    return Route(torch.stack([idx1, idx2]), torch.stack([pos1, pos2]), torch.stack([kept1, kept2]),
                 torch.stack([gate1 / denom, gate2 / denom])), aux


def _dense(route: Route, num_experts: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A Route as JAX's (combine [T, E, C] fp32, dispatch bool [T, E, C])."""
    combine = dispatch = None
    for e, p, kept, w in zip(*route):
        d = F.one_hot(e, num_experts).float()[:, :, None] * kept[:, None, None] \
            * (torch.arange(capacity, device=p.device) == p[:, None])[:, None, :]
        combine = w[:, None, None] * d if combine is None else combine + w[:, None, None] * d
        dispatch = d if dispatch is None else dispatch + d
    return combine, dispatch > 0


def top1_gating(logits: torch.Tensor, capacity: int, rng: Optional[torch.Generator] = None,
                noisy: bool = False):
    """logits [T, E] -> (combine [T, E, C], dispatch bool [T, E, C], aux)."""
    route, aux = route_top1(logits, capacity, rng, noisy)
    return (*_dense(route, logits.shape[-1], capacity), aux)


def top2_gating(logits: torch.Tensor, capacity: int, rng: Optional[torch.Generator] = None):
    """logits [T, E] -> (combine [T, E, C], dispatch bool [T, E, C], aux);
    ``rng`` is accepted and unused, as in JAX."""
    route, aux = route_top2(logits, capacity)
    return (*_dense(route, logits.shape[-1], capacity), aux)


def compute_capacity(tokens: int, num_experts: int, capacity_factor: float, min_capacity: int = 4) -> int:
    cap = int(tokens * capacity_factor / num_experts)
    return max(cap, min_capacity)


def route(x: torch.Tensor, gate_w: torch.Tensor, capacity_factor: float = 1.25, top_k: int = 1,
          rng: Optional[torch.Generator] = None) -> tuple[Route, torch.Tensor, int]:
    """x [T, M], gate_w [M, E] -> (Route, aux, capacity): the capacity
    path's gating, logits ``x.float() @ gate_w.float()``."""
    T = x.shape[0]
    E = gate_w.shape[1]
    C = compute_capacity(T * top_k, E, capacity_factor)
    logits = x.float() @ gate_w.float()
    r, aux = route_top1(logits, C, rng) if top_k == 1 else route_top2(logits, C)
    return r, aux, C


def slot_index(r: Route, num_experts: int, capacity: int) -> torch.Tensor:
    """[k, T] int64: the flat (expert, slot) each choice fills, ``E * C`` (a
    spare slot past the table) where it was dropped."""
    return torch.where(r.kept, r.expert * capacity + r.position.long(), num_experts * capacity)


def slot_table(slots: torch.Tensor, num_tokens: int, num_slots: int) -> torch.Tensor:
    """[num_slots] int64: the token that fills each slot of ``slot_index``'s
    ``slots``, or ``num_tokens`` (the empty row) where none does. Dropped
    choices write to the spare last entry, which is cut off."""
    tokens = torch.arange(num_tokens, device=slots.device).expand_as(slots)
    table = torch.full((num_slots + 1,), num_tokens, dtype=torch.long, device=slots.device)
    table.scatter_(0, slots.reshape(-1), tokens.reshape(-1))
    return table[:-1]


def moe_dispatch_combine(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         capacity_factor: float = 1.25, top_k: int = 1, mesh=None,
                         rng: Optional[torch.Generator] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, M] -> (out [T, M], aux): gate, gather the ``[E, C, M]`` expert
    inputs through the slot table, ``expert_fn``, then each token's kept
    choices' outputs times their weights (cast to ``x.dtype`` first, as
    JAX's combine einsum casts them), summed in fp32 and rounded once to
    ``x.dtype``. JAX's function without its ``[T, E, C]`` products."""
    refuse_expert_parallel(mesh)
    T, M = x.shape
    E = gate_w.shape[1]
    r, aux, C = route(x, gate_w, capacity_factor, top_k, rng)
    slots = slot_index(r, E, C)
    zero_row = x.new_zeros(1, M)
    expert_inputs = torch.cat([x, zero_row])[slot_table(slots, T, E * C)].view(E, C, M)
    y = torch.cat([expert_fn(expert_inputs).reshape(E * C, M), zero_row])  # the spare slot reads zeros
    out = None
    for k in range(slots.shape[0]):
        term = r.weight[k].to(x.dtype).float()[:, None] * y[slots[k]].float()
        out = term if out is None else out + term
    return out.to(x.dtype), aux
