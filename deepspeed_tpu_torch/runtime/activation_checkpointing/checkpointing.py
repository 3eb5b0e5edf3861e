"""Activation checkpointing: the ``deepspeed.checkpointing`` API on
``torch.utils.checkpoint``, ported from
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``.

``configure()`` sets the process-wide knobs from a config; the engine
installs its ``activation_checkpointing`` block with ``set_config`` and
turns it into model fields with ``model_overrides`` (remat, its policy and
the group size). ``checkpoint(fn, *args)`` runs one segment under
non-reentrant ``torch.utils.checkpoint`` with the configured policy.

Policies are the JAX package's names. nothing_saveable recomputes the whole
segment in the backward; everything_saveable saves every residual (the
segment runs as without checkpointing); dots_saveable saves the outputs of
the matrix products; save_flash the outputs of the flash-attention forward;
dots_and_flash both. The selective ones are ``torch.utils.checkpoint``
selective-checkpoint contexts, which decide per dispatched op, which is why
the flash forward is the custom op ``dstt::flash_attention_fwd``.

``cpu_checkpointing`` (the memory tier) moves a segment's saved inputs,
the layer boundaries, to host memory (pinned on a card) through
``torch.autograd.graph.save_on_cpu``, and they come back for the
recompute: in the model (``remat_offload``) around each checkpointed
region, and in ``checkpoint()`` with everything else recomputed, as the JAX
package's policy offloads the inputs and saves nothing else.
``partition_activations`` becomes the model's ``remat_partition_axis =
"model"`` (JAX ``checkpointing.py:113-114``): under tensor parallelism each
checkpointed region keeps only this rank's rows of its saved boundary and
gathers them for the recompute (``models/transformer.py``); it has no
effect on ``checkpoint()``, as in the JAX package.
``contiguous_memory_optimization`` and ``synchronize_checkpoint_boundary``
are accepted and recorded, as in the JAX package (the allocator owns the
buffers).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import asdict
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils.checkpoint import checkpoint as torch_checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from ...ops.flash_attention import FLASH_FORWARD_OP
from ...utils.logging import logger
from ..config import ActivationCheckpointingConfig

REMAT_POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable", "save_flash",
                  "dots_and_flash")

# Ops whose outputs the dots policies save: the matrix products the model's
# einsums and projections dispatch to (JAX's dot_general).
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})

_config: Optional[ActivationCheckpointingConfig] = None


def remat_context_fn(policy: str) -> Optional[Callable]:
    """``torch.utils.checkpoint`` ``context_fn`` for a selective policy, or
    None for nothing_saveable (recompute everything). everything_saveable
    needs no checkpoint at all; callers skip it."""
    if policy not in REMAT_POLICIES:
        raise NotImplementedError(f"remat policy {policy!r} is not implemented in deepspeed_tpu_torch "
                                  f"(one of {', '.join(REMAT_POLICIES)})")
    saved = set()
    if policy in ("dots_saveable", "dots_and_flash"):
        saved |= _DOT_OPS
    if policy in ("save_flash", "dots_and_flash"):
        saved.add(FLASH_FORWARD_OP)
    if not saved:
        return None

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def configure(
    mpu_=None,
    deepspeed_config: Optional[dict] = None,
    partition_activations: Optional[bool] = None,
    contiguous_checkpointing: Optional[bool] = None,
    num_checkpoints: Optional[int] = None,
    checkpoint_in_cpu: Optional[bool] = None,
    synchronize: Optional[bool] = None,
    profile: Optional[bool] = None,
) -> ActivationCheckpointingConfig:
    """Set the process-wide knobs (reference :825). Explicit arguments
    override ``deepspeed_config["activation_checkpointing"]``; ``mpu_`` is
    accepted for signature parity."""
    global _config
    base = {}
    if deepspeed_config:
        base = dict(deepspeed_config.get("activation_checkpointing", {}))
    overrides = {
        "partition_activations": partition_activations,
        "contiguous_memory_optimization": contiguous_checkpointing,
        "number_checkpoints": num_checkpoints,
        "cpu_checkpointing": checkpoint_in_cpu,
        "synchronize_checkpoint_boundary": synchronize,
        "profile": profile,
    }
    for k, v in overrides.items():
        if v is not None:
            base[k] = v
    base.setdefault("enabled", True)
    known = set(ActivationCheckpointingConfig.__dataclass_fields__)
    cfg = ActivationCheckpointingConfig(**{k: v for k, v in base.items() if k in known})
    _config = cfg
    if cfg.contiguous_memory_optimization or cfg.synchronize_checkpoint_boundary:
        logger.info("activation_checkpointing: contiguous_memory_optimization / "
                    "synchronize_checkpoint_boundary are left to the allocator and the stream; "
                    "accepted as no-ops")
    return cfg


def set_config(cfg: ActivationCheckpointingConfig) -> None:
    """Install an already-parsed config (the engine's path)."""
    global _config
    _config = cfg


def is_configured() -> bool:
    return _config is not None


def get_config() -> ActivationCheckpointingConfig:
    return _config if _config is not None else ActivationCheckpointingConfig()


def reset() -> None:
    global _config
    _config = None


def model_overrides(num_layers: int) -> dict[str, Any]:
    """The configured knobs as TransformerConfig fields (the engine applies
    them to its model)."""
    cfg = get_config()
    if not cfg.enabled:
        return {}
    out: dict[str, Any] = {"remat": True}
    if cfg.policy:  # empty = keep the model's own default (save_flash)
        out["remat_policy"] = cfg.policy
    if cfg.cpu_checkpointing:
        out["remat_offload"] = True
    if cfg.partition_activations:
        out["remat_partition_axis"] = "model"
    if cfg.number_checkpoints and 0 < cfg.number_checkpoints < num_layers:
        if num_layers % cfg.number_checkpoints == 0:
            out["remat_group"] = num_layers // cfg.number_checkpoints
        else:
            logger.warning("number_checkpoints=%d does not divide num_layers=%d; "
                           "using per-layer checkpointing", cfg.number_checkpoints, num_layers)
    return out


def checkpoint(function: Callable, *args):
    """Run ``function(*args)`` under checkpointing with the configured policy
    (reference :743); an empty policy means nothing_saveable. The global RNG
    state is stashed and restored around the recompute
    (``preserve_rng_state``), so a segment that draws from it replays its
    draws; the model's own layers draw from seeded generators instead.
    With ``cpu_checkpointing`` the segment's inputs are saved in host memory
    and everything else is recomputed."""
    cfg = get_config()
    policy = "nothing_saveable" if cfg.cpu_checkpointing else (cfg.policy or "nothing_saveable")
    if policy == "everything_saveable":
        return function(*args)
    kw = {}
    if (context_fn := remat_context_fn(policy)) is not None:
        kw["context_fn"] = context_fn
    scope = torch.profiler.record_function("act_checkpoint") if cfg.profile else contextlib.nullcontext()
    offload = contextlib.nullcontext()
    if cfg.cpu_checkpointing:
        cuda = any(torch.is_tensor(a) and a.is_cuda for a in args)
        offload = torch.autograd.graph.save_on_cpu(pin_memory=cuda)
    with scope, offload:
        return torch_checkpoint(function, *args, use_reentrant=False, **kw)


def checkpoint_wrapped(function: Callable) -> Callable:
    """Decorator form: ``layer = checkpoint_wrapped(layer)``."""
    def run(*args):
        return checkpoint(function, *args)
    return run


class _RngTracker:
    """API-compat shim for the reference's CudaRNGStatesTracker (:122). The
    port's layers draw dropout from generators seeded per layer, which a
    recompute makes afresh, and ``checkpoint`` restores the global RNG
    state; there are no named states to fork, so ``fork()`` is a no-op."""

    def fork(self):
        return contextlib.nullcontext()

    def get_states(self):
        return {}

    def add(self, name, seed):
        logger.info("RNG tracker.add(%s) ignored: the port's layers seed their own generators", name)


_rng_tracker = _RngTracker()


def get_rng_tracker() -> _RngTracker:
    return _rng_tracker


def summarize() -> dict:
    return asdict(get_config())
