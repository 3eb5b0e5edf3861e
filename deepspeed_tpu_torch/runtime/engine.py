"""``DeepSpeedEngine`` for one device, ported from
``deepspeed_tpu/runtime/engine.py``.

``train_batch`` runs one full step of ``gas`` micro-batches: fp32 gradients of
``loss × loss_scale`` accumulate over the micro-batches (autograd adds them
into the fp32 master parameters' ``.grad``), are unscaled by
``1/(loss_scale·gas)``, checked for finiteness, clipped by the global norm,
and applied by the optimizer at ``lr(step+1)``. On overflow the update is
dropped on the device: params and optimizer state are unchanged and ``step``
does not advance. fp16 runs the dynamic loss scale with hysteresis. The
metrics come back as device tensors; nothing is read on the host except at
``steps_per_print`` boundaries.

The state is the fp32 master parameters (cast to the compute dtype inside the
loss), the optimizer state, and the 0-d device tensors ``step``,
``loss_scale``, ``good_steps``, ``skipped`` and ``hysteresis``. ZeRO stages
0-3 are accepted: on one device they are the same arithmetic. The 3-call
``forward/backward/step`` loop, checkpoints and the dataloader are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..inference.engine import resolve_device
from ..ops.optimizers import get_optimizer, tree_leaves, tree_map
from ..utils.logging import log_dist
from .config import DeepSpeedConfig
from .lr_schedules import get_schedule


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]).sum())


def _dynamic_loss_scale(finite, loss_scale, good_steps, hysteresis, fp16):
    """DynamicLossScaler semantics with ``hysteresis``: the first
    ``hysteresis - 1`` overflows only burn the counter; the scale halves once
    it is exhausted. The counter refills when the scale grows after
    ``loss_scale_window`` clean steps. All arguments but ``fp16`` are 0-d
    device tensors; nothing is read on the host."""
    good = torch.where(finite, good_steps + 1, torch.zeros_like(good_steps))
    grow = good >= fp16.loss_scale_window
    halved = torch.clamp(loss_scale / 2.0, min=fp16.min_loss_scale)
    new_scale = torch.where(finite, torch.where(grow, loss_scale * 2.0, loss_scale),
                            torch.where(hysteresis <= 1, halved, loss_scale))
    new_hyst = torch.where(finite, torch.where(grow, torch.full_like(hysteresis, fp16.hysteresis), hysteresis),
                           torch.clamp(hysteresis - 1, min=1))
    good = torch.where(grow, torch.zeros_like(good), good)
    return new_scale, good, new_hyst


def _to_device(x, device):
    """A batch leaf on ``device``. A host leaf bound for CUDA is staged in
    pinned memory and copied asynchronously, so the host does not wait for
    the previous step's work before it enqueues this one."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeepSpeedEngine:
    def __init__(self, model, config, params: Optional[dict] = None, device=None):
        if isinstance(config, str):
            config = DeepSpeedConfig.from_file(config, world_size=1)
        elif isinstance(config, dict):
            config = DeepSpeedConfig.from_dict(config, world_size=1)
        self.config: DeepSpeedConfig = config
        self.device = resolve_device(device)
        self.model = model
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_batch_size = config.train_batch_size
        self.zero_stage = config.zero_optimization.stage
        self.global_steps = 0
        self.global_samples = 0

        pld = config.progressive_layer_drop
        if pld.enabled and not model.config.pld_enabled:
            model.config = model.config.replace(pld_enabled=True, pld_theta=pld.theta, pld_gamma=pld.gamma)

        self.opt_init, self.opt_update, base_lr = get_optimizer(config.optimizer.type, config.optimizer.params)
        self.lr_schedule = get_schedule(config.scheduler.type, config.scheduler.params, base_lr)

        if params is None:
            params = model.init(torch.Generator().manual_seed(0), self.device)
        params = tree_map(lambda t: t.to(device=self.device,
                                         dtype=torch.float32 if t.is_floating_point() else t.dtype), params)
        fp16 = config.fp16
        self.fp16_enabled = fp16.enabled
        scale0 = fp16.loss_scale if fp16.loss_scale > 0 else float(2 ** fp16.initial_scale_power)

        def scalar(value, dtype):
            return torch.full((), value, dtype=dtype, device=self.device)

        self.state = {
            "step": scalar(0, torch.int32),
            "params": params,
            "opt": self.opt_init(params),
            "loss_scale": scalar(scale0 if fp16.enabled else 1.0, torch.float32),
            "good_steps": scalar(0, torch.int32),
            "skipped": scalar(0, torch.int32),
            "hysteresis": scalar(fp16.hysteresis, torch.int32),
        }
        n_params = sum(t.numel() for t in tree_leaves(params))
        log_dist(f"engine ready: {n_params / 1e6:.1f}M params, zero_stage={self.zero_stage}, "
                 f"device={self.device}, micro_bs={self.micro_batch_size}, "
                 f"gas={self.gradient_accumulation_steps}, dtype={config.compute_dtype}", ranks=[0])

    @property
    def _dropout_enabled(self) -> bool:
        c = self.model.config
        return c.hidden_dropout > 0 or c.attn_dropout > 0 or c.pld_enabled

    def _cast(self, params):
        dt = self.config.compute_dtype
        return tree_map(lambda p: p.to(dt) if p.dtype == torch.float32 else p, params)

    def _generator(self, step1: int) -> torch.Generator:
        """Dropout/layer-drop randomness for one step, seeded by (seed, step)
        as the JAX engine folds the step into its key (other bits). The step
        is the host's count of ``train_batch`` calls, so no device value is
        read; it equals the device step while no step overflowed."""
        mixed = (int(self.config.seed) * 1_000_003 + step1) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(mixed)

    def train_batch(self, batch: dict) -> dict:
        """One full (micro × gas) step on a batch of [train_batch_size, ...]
        leaves (numpy or torch) -> metrics dict of 0-d device tensors
        {loss, grad_norm, lr, loss_scale, overflow}."""
        gas = self.gradient_accumulation_steps
        state = self.state
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        for k, v in batch.items():
            if v.shape[0] != self.train_batch_size:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, train_batch_size is "
                                 f"{self.train_batch_size}")
        micro = {k: v.reshape(gas, v.shape[0] // gas, *v.shape[1:]) for k, v in batch.items()}
        step1 = state["step"] + 1
        loss_scale = state["loss_scale"]
        gen = self._generator(self.global_steps + 1) if self._dropout_enabled else None

        leaves = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), state["params"])
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            mb = {k: v[i] for k, v in micro.items()}
            kw = {"rng": gen, "step": step1} if gen is not None else {}
            loss = self.model.loss(self._cast(leaves), mb, **kw)
            (loss * loss_scale).backward()
            loss_sum = loss_sum + loss.detach().float()

        with torch.no_grad():
            grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
            inv = 1.0 / (loss_scale * gas)
            for g in tree_leaves(grads):
                g.mul_(inv)
            finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(grads)]).all()
            gnorm = _global_norm(grads)
            clip = self.config.gradient_clipping
            if clip > 0:
                factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
                for g in tree_leaves(grads):
                    g.mul_(factor)
            lr = self.lr_schedule(step1)
            new_params, new_opt = self.opt_update(grads, state["opt"], state["params"], step1, lr)

            def keep(new, old):
                return torch.where(finite, new, old)

            fp16 = self.config.fp16
            if self.fp16_enabled and fp16.loss_scale == 0:
                new_scale, good, hyst = _dynamic_loss_scale(
                    finite, loss_scale, state["good_steps"], state["hysteresis"], fp16)
            else:
                new_scale, good, hyst = loss_scale, state["good_steps"], state["hysteresis"]
            self.state = {
                "step": torch.where(finite, step1, state["step"]),
                "params": tree_map(keep, new_params, state["params"]),
                "opt": tree_map(keep, new_opt, state["opt"]),
                "loss_scale": new_scale,
                "good_steps": good,
                "skipped": state["skipped"] + (~finite).int(),
                "hysteresis": hyst,
            }
        metrics = {"loss": loss_sum / gas, "grad_norm": gnorm, "lr": lr, "loss_scale": loss_scale,
                   "overflow": ~finite}
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        if self.global_steps % self.config.steps_per_print == 0:
            self._report_progress(metrics)
        return metrics

    def _report_progress(self, metrics):
        log_dist(
            f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
            f"lr={float(metrics['lr']):.3e} grad_norm={float(metrics['grad_norm']):.3f} "
            f"loss_scale={float(metrics['loss_scale']):.1f} skipped={self.skipped_steps}",
            ranks=[0])

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> float:
        """Loss of ``batch`` without dropout or an update, read on the host."""
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        return float(self.model.loss(self._cast(self.state["params"]), batch))

    @property
    def lr(self) -> float:
        return float(self.lr_schedule(self.state["step"] + 1))

    def get_global_step(self) -> int:
        return int(self.state["step"])

    @property
    def loss_scale(self) -> float:
        return float(self.state["loss_scale"])

    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped step count; reading it syncs with the device."""
        return int(self.state["skipped"])
