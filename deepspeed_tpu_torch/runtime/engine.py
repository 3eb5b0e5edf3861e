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
``loss_scale``, ``good_steps``, ``skipped`` and ``hysteresis``, the same tree
as the JAX engine's, so ``save_checkpoint``/``load_checkpoint`` (format 3,
``checkpoint/saver.py``) move a run between the two packages both ways.
ZeRO stages 0-3 are accepted: on one device they are the same arithmetic.
The ``activation_checkpointing`` block turns on the model's remat. The
3-call ``forward/backward/step`` loop and the dataloader are not ported yet.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import saver, zero_to_fp32
from ..inference.engine import resolve_device
from ..models.transformer import effective_loss_impl
from ..ops.optimizers import get_optimizer, tree_leaves, tree_map
from ..resilience.errors import CheckpointCorruptError, CheckpointNotFoundError
from ..utils.logging import log_dist, logger
from . import activation_checkpointing as act_ckpt
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
        self._seed = int(config.seed)  # dropout/layer-drop stream; restored by load_checkpoint

        pld = config.progressive_layer_drop
        if pld.enabled and not model.config.pld_enabled:
            model.config = model.config.replace(pld_enabled=True, pld_theta=pld.theta, pld_gamma=pld.gamma)
        ac = config.activation_checkpointing
        if ac.enabled:
            act_ckpt.set_config(ac)
            overrides = act_ckpt.model_overrides(model.config.num_layers)
            if overrides:
                model.config = model.config.replace(**overrides)
                logger.info("activation_checkpointing: %s", overrides)
        impl, reason = effective_loss_impl(model.config)
        note = "" if impl == model.config.loss_impl else f" (configured {model.config.loss_impl!r}: {reason})"
        log_dist(f"loss implementation: {impl}{note}", ranks=[0])

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

    def _generator(self, step1: int, micro: int) -> torch.Generator:
        """Dropout/layer-drop randomness for one micro-batch, seeded by
        (seed, step, micro-batch) as the JAX engine folds the step into its
        key and splits it over the micro-batches (other bits). The step is
        the host's count of ``train_batch`` calls, so no device value is
        read; it equals the device step while no step overflowed."""
        mixed = ((self._seed * 1_000_003 + step1) * 1_000_033 + micro) % (2 ** 63)
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
        leaves = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), state["params"])
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            mb = {k: v[i] for k, v in micro.items()}
            kw = {}
            if self._dropout_enabled:
                kw = {"rng": self._generator(self.global_steps + 1, i), "step": step1}
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

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None, client_state: Optional[dict] = None):
        """Save the engine state to ``save_dir/tag`` (default
        ``global_step<N>``), atomically, and point ``save_dir/latest`` at it
        once it is durable. The client state carries the host's trajectory
        (steps, samples, skipped steps, the dropout seed, the batch sizes),
        so train k + save + load + train n−k draws the masks of train n.
        ``zero_to_fp32.py`` is copied beside the checkpoint, and older tags
        are pruned to ``checkpoint.keep_last_k``."""
        tag = tag or f"global_step{self.global_steps}"
        extra = dict(client_state or {})
        extra.update(global_steps=self.global_steps, global_samples=self.global_samples,
                     skipped_steps=self.skipped_steps, rng_seed=self._seed,
                     micro_batch_size=self.micro_batch_size, train_batch_size=self.train_batch_size)
        os.makedirs(save_dir, exist_ok=True)
        saver.save_checkpoint(os.path.join(save_dir, tag), self.state, client_state=extra,
                              latest=(os.path.join(save_dir, "latest"), tag))
        try:
            shutil.copyfile(zero_to_fp32.__file__, os.path.join(save_dir, "zero_to_fp32.py"))
        except OSError as e:
            logger.warning(f"could not copy zero_to_fp32.py into {save_dir}: {e}")
        log_dist(f"saved checkpoint {save_dir}/{tag}", ranks=[0])
        self._prune_checkpoints(save_dir, current=tag)
        return True

    def _prune_checkpoints(self, save_dir: str, current: str) -> None:
        """keep_last_k retention: after a save, committed tags beyond the k
        newest are removed; the just-saved and the 'latest' tags stay."""
        k = self.config.checkpoint.keep_last_k
        if k <= 0:
            return
        keep = {current}
        latest = os.path.join(save_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                keep.add(f.read().strip())
        for i, tag in enumerate(saver.find_checkpoints(save_dir)):  # newest first
            if i >= k and tag not in keep:
                shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
                log_dist(f"pruned checkpoint {save_dir}/{tag} (keep_last_k={k})", ranks=[0])

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, fallback_to_intact: bool = True,
                        verify: Optional[bool] = None):
        """Restore the engine state from ``load_dir`` -> (tag, client_state),
        or (None, {}) when there is no 'latest' to follow. With ``tag=None``
        the 'latest' tag is followed; if that checkpoint is torn or corrupt
        and ``fallback_to_intact`` is set, the newest intact sibling is
        loaded instead and 'latest' repointed at it. An explicit ``tag``
        never falls back. ``verify`` (default ``checkpoint.verify_integrity``)
        digests every file before the state is touched; the fallback scan
        always verifies. The host's step count, sample count and dropout
        seed come back from the client state."""
        if verify is None:
            verify = self.config.checkpoint.verify_integrity
        t0 = time.perf_counter()
        explicit = tag is not None
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.exists(latest):
                logger.warning(f"no 'latest' file in {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        try:
            state, client_state = saver.load_checkpoint(os.path.join(load_dir, tag), self.state, verify=verify)
        except (CheckpointCorruptError, CheckpointNotFoundError) as err:
            if explicit or not fallback_to_intact:
                raise
            logger.error("checkpoint %s/%s failed to load (%s); scanning for the newest intact checkpoint",
                         load_dir, tag, err)
            state = None
            for cand in saver.find_checkpoints(load_dir):
                if cand == tag:
                    continue
                try:
                    state, client_state = saver.load_checkpoint(os.path.join(load_dir, cand), self.state,
                                                                verify=True)
                except CheckpointCorruptError as e2:
                    logger.warning("checkpoint %s/%s also corrupt (%s); continuing scan", load_dir, cand, e2)
                    continue
                logger.warning("fell back from torn checkpoint %r to intact %r", tag, cand)
                saver.write_latest(os.path.join(load_dir, "latest"), cand)
                tag = cand
                break
            if state is None:
                raise CheckpointCorruptError(f"no intact checkpoint under {load_dir} (latest {tag!r} and every "
                                             "fallback failed verification)", path=load_dir) from err
        self.state = state
        self.global_steps = int(client_state.get("global_steps", int(state["step"])))
        self.global_samples = int(client_state.get("global_samples", 0))
        self._seed = int(client_state.get("rng_seed", self._seed))
        log_dist(f"loaded checkpoint {load_dir}/{tag} in {time.perf_counter() - t0:.2f} s", ranks=[0])
        return tag, client_state
