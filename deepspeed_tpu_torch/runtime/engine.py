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
``steps_per_print`` boundaries (every step with a monitor or the guardrail
on). DeepSpeed's 3-call loop ``loss = engine(micro_batch)`` →
``engine.backward(loss)`` → ``engine.step()`` runs the same update
(``_apply_update``) at every ``gas``-th ``step()``; ``forward`` evaluates
without dropout and ``backward`` recomputes with it.

The state is the fp32 master parameters (cast to the compute dtype inside the
loss), the optimizer state, and the 0-d device tensors ``step``,
``loss_scale``, ``good_steps``, ``skipped`` and ``hysteresis``, the same tree
as the JAX engine's, so ``save_checkpoint``/``load_checkpoint`` (format 3,
``checkpoint/saver.py``) move a run between the two packages both ways.
ZeRO stages 0-3 are accepted: on one device they are the same arithmetic.
The ``activation_checkpointing`` block turns on the model's remat, and the
``sparse_attention`` block its block-sparse attention (``attn_impl="sparse"``
with the mode's ``sparsity`` fields). ``curriculum_learning`` truncates each
batch to the scheduled sequence length. ``deepspeed_io`` builds the
training dataloader, whose cursor at the last completed step rides the
checkpoint with the curriculum's state, in the JAX engine's client-state
keys.

Resilience (the ``resilience`` block, ``resilience/``): the NaN guardrail
(skip → rewind to the last good checkpoint → ``TrainingDivergedError``),
preemption by signal or injection (a just-in-time checkpoint, then
``PreemptionSignal``), retried synchronous saves, the training fault sites,
and ``checkpoint.async_save``. ``csv_monitor`` receives the loss and lr
each step and, with ``telemetry.enabled``, the registry at print
boundaries; ``telemetry_snapshot()`` reports the registry and the
device-memory pools.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import saver, zero_to_fp32
from ..inference.engine import resolve_device
from ..models import transformer as tfm
from ..models.transformer import effective_loss_impl
from ..monitor.monitor import MonitorMaster
from ..ops.optimizers import get_optimizer, tree_leaves, tree_map
from ..ops.sparse_attention import SPARSITY_CONFIGS
from ..resilience import (CheckpointCorruptError, CheckpointNotFoundError, FaultInjector, PermanentIOError,
                          PreemptionSignal, TrainingDivergedError, TrainingGuardrail, install_injector,
                          retry_call)
from ..resilience.preemption import PreemptionGuard, activate_guard, reap_orphaned_guard
from ..telemetry import MonitorBridge, Telemetry, hbm_snapshot, tree_bytes
from ..utils.logging import log_dist, logger
from . import activation_checkpointing as act_ckpt
from .checkpoint_engine.checkpoint_engine import get_checkpoint_engine
from .config import DeepSpeedConfig
from .data_pipeline.curriculum_scheduler import CurriculumScheduler
from .dataloader import DeepSpeedDataLoader
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

        self.training_dataloader = None  # set by deepspeed_io / set_dataloader
        self._dl_cursor = None  # the loader's cursor at the last COMPLETED step
        self._pending_dl_state = None  # a cursor loaded before any loader was attached

        # telemetry: the registry always runs (host-side dict updates); the
        # config gates the exporters, the JSONL sink and the monitor bridge
        self.monitor = MonitorMaster(config)
        tcfg = config.telemetry
        self.telemetry = Telemetry(jsonl_path=tcfg.jsonl_path if tcfg.enabled else "",
                                   watchdog_mode=tcfg.watchdog, device_sync_spans=tcfg.device_sync_spans,
                                   jsonl_max_bytes=tcfg.jsonl_max_bytes, jsonl_keep=tcfg.jsonl_keep)
        self._telemetry_bridge = (MonitorBridge(self.monitor)
                                  if tcfg.enabled and tcfg.monitor_bridge and self.monitor.enabled else None)
        self._last_seen_loss_scale = None  # boundary-sampled flip detection

        # resilience: the step always skips a non-finite update on the
        # device; the guardrail adds streak tracking and rewind at the cost
        # of one fetch of the overflow flag per step
        rcfg = config.resilience
        self.fault_injector = FaultInjector(rcfg.fault_injection) if rcfg.fault_injection.enabled else None
        if self.fault_injector is not None:
            log_dist(f"resilience: fault injection armed (seed {rcfg.fault_injection.seed}, "
                     f"rate {rcfg.fault_injection.rate})", ranks=[0])
        # the checkpoint writer consults the process-global slot: always
        # (re)install, so an earlier engine's injector cannot fail this
        # engine's writes
        install_injector(self.fault_injector)
        self._guardrail = (TrainingGuardrail(rcfg.max_consecutive_bad_steps, rcfg.rewind, self.telemetry)
                           if rcfg.enabled else None)
        if self._guardrail is not None:
            log_dist(f"resilience: NaN guardrail on (skip, rewind after {rcfg.max_consecutive_bad_steps} "
                     "consecutive bad steps; one overflow fetch per step)", ranks=[0])
        self._injected_scale = None  # the loss scale a nan_grads injection replaced
        self._preemption_guard = None
        if rcfg.preemption.enabled:
            self._preemption_guard = PreemptionGuard(rcfg.preemption.signals)
            # the process-global slot: claiming it evicts a discarded
            # predecessor's handlers, which would swallow the signals
            live = activate_guard(self._preemption_guard, owner=self)
            log_dist("resilience: preemption guard armed "
                     f"({'+'.join(rcfg.preemption.signals)}"
                     f"{'' if live else '; trigger()-only, handlers unavailable off the main thread'}"
                     + (f"; JIT checkpoint -> {rcfg.preemption.save_dir}" if rcfg.preemption.save_dir
                        else "; no save_dir: the caller saves") + ")", ranks=[0])
        else:
            reap_orphaned_guard()  # a live sibling's guard stays armed
        self._ckpt_engine = None
        self._ckpt_async = bool(config.checkpoint.async_save)
        # the 3-call loop's accumulation: the leaves whose .grad collect the
        # micro-batches, how many have been added, the last forward's batch
        self._accum = None
        self._micro_count = 0
        self._last_batch = None

        pld = config.progressive_layer_drop
        if pld.enabled and not model.config.pld_enabled:
            model.config = model.config.replace(pld_enabled=True, pld_theta=pld.theta, pld_gamma=pld.gamma)
        sa = config.sparse_attention
        if sa is not None and model.config.attn_impl != "sparse":
            # only the kwargs the mode's SparsityConfig takes (JAX engine.py:280-296)
            accepted = set(inspect.signature(SPARSITY_CONFIGS[sa.mode].__init__).parameters)
            sparsity = {"mode": sa.mode, **{k: v for k, v in dataclasses.asdict(sa).items() if k in accepted}}
            model.config = model.config.replace(attn_impl="sparse", sparsity=sparsity)
            logger.info("sparse_attention: %s", sparsity)
        self.curriculum_scheduler = None
        if config.curriculum_learning.enabled:
            self.curriculum_scheduler = CurriculumScheduler(config.curriculum_learning)
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

    def _dropout_key(self, micro: int) -> torch.Tensor:
        """Dropout/layer-drop key of one micro-batch, hashed on the device
        from (seed, ``state["step"] + 1``, micro-batch), as the JAX engine
        folds the device step into its key and splits it over the
        micro-batches (other bits). The step is the device's own, so no
        value is fetched and the masks follow it through every skipped
        update, a guarded one or not."""
        return tfm.dropout_key(self._seed, self.state["step"] + 1, micro)

    def train_batch(self, batch: dict) -> dict:
        """One full (micro × gas) step on a batch of [train_batch_size, ...]
        leaves (numpy or torch) -> metrics dict of 0-d device tensors
        {loss, grad_norm, lr, loss_scale, overflow}."""
        self._resilience_pre_step()
        gas = self.gradient_accumulation_steps
        if self.curriculum_scheduler is not None:
            batch = self._apply_curriculum(batch)
        with self.telemetry.span("train/train_batch") as sp:
            dev_batch = {k: _to_device(v, self.device) for k, v in batch.items()}
            for k, v in dev_batch.items():
                if v.shape[0] != self.train_batch_size:
                    raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, train_batch_size is "
                                     f"{self.train_batch_size}")
            micro = {k: v.reshape(gas, v.shape[0] // gas, *v.shape[1:]) for k, v in dev_batch.items()}
            leaves = self._grad_leaves()
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(gas):
                loss_sum = loss_sum + self._accumulate(leaves, {k: v[i] for k, v in micro.items()}, i)
            metrics = {"loss": loss_sum / gas, **self._apply_update(leaves, gas)}
            sp.set_sync(metrics["loss"])
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        need_host = self.global_steps % self.config.steps_per_print == 0 or self.monitor.enabled
        if self.global_steps % self.config.steps_per_print == 0:
            self._report_progress(metrics)
        if self.monitor.enabled:
            self.monitor.write_events([("Train/Samples/train_loss", float(metrics["loss"]), self.global_samples),
                                       ("Train/Samples/lr", float(metrics["lr"]), self.global_samples)])
        self._train_telemetry(batch, metrics if need_host else None, sp.dur_s)
        self._resilience_post_step(metrics)
        self._snapshot_dl_cursor()
        return metrics

    def _grad_leaves(self) -> dict:
        """The fp32 master parameters as fresh autograd leaves, whose
        ``.grad`` collects the micro-batches' gradients."""
        return tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), self.state["params"])

    def _accumulate(self, leaves, mb: dict, micro: int) -> torch.Tensor:
        """Forward and backward of one micro-batch (with dropout): the
        gradients of ``loss × loss_scale`` add into ``leaves``' ``.grad``.
        Returns the detached fp32 loss."""
        kw = {}
        if self._dropout_enabled:
            kw = {"rng": self._dropout_key(micro), "step": self.state["step"] + 1}
        loss = self.model.loss(self._cast(leaves), mb, **kw)
        (loss * self.state["loss_scale"]).backward()
        return loss.detach().float()

    @torch.no_grad()
    def _apply_update(self, leaves, n_micro: int) -> dict:
        """The step's update from the gradients in ``leaves``: unscale by
        ``1/(loss_scale·n_micro)``, check finiteness, clip, apply the
        optimizer at ``lr(step+1)`` and keep the old state where the
        gradients were not finite; the loss scale follows its rule.
        Replaces ``self.state``; returns {grad_norm, lr, loss_scale,
        overflow} as device tensors."""
        state = self.state
        step1 = state["step"] + 1
        loss_scale = state["loss_scale"]
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
        inv = 1.0 / (loss_scale * n_micro)
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
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": loss_scale, "overflow": ~finite}

    # ------------------------------------------------------------------
    # The 3-call loop: forward / backward / step (JAX engine.py:1965-2087)
    # ------------------------------------------------------------------

    def forward(self, batch: dict) -> torch.Tensor:
        """The loss of one micro-batch of [micro_batch_size, ...] leaves,
        without dropout or a gradient (a 0-d device tensor). The batch is
        kept for ``backward``."""
        self._last_batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        with torch.no_grad():
            return self.model.loss(self._cast(self.state["params"]), self._last_batch)

    __call__ = forward

    def backward(self, loss=None) -> None:
        """Accumulate fp32 gradients for the batch last passed to
        ``forward``: its loss is recomputed with dropout (``loss`` is not
        differentiated; it may be None)."""
        if self._last_batch is None:
            raise RuntimeError("backward() needs a forward() first")
        if self._accum is None:
            self._accum = self._grad_leaves()
        self._accumulate(self._accum, self._last_batch, self._micro_count)
        self._micro_count += 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_count >= self.gradient_accumulation_steps

    def step(self) -> None:
        """Apply the accumulated gradients once ``gas`` micro-batches went
        through ``backward``; before that a no-op, as DeepSpeed's GAS gate."""
        if self._micro_count < self.gradient_accumulation_steps:
            return
        self._apply_update(self._accum, self._micro_count)
        self._accum = None
        self._micro_count = 0
        self.global_steps += 1

    # ------------------------------------------------------------------
    # Resilience hooks (JAX engine.py:1606-1711)
    # ------------------------------------------------------------------

    def _resilience_pre_step(self) -> None:
        """Before a step: a pending real preemption signal, then the fault
        sites (simulated preemption, nan_grads). Both preemption sources go
        through ``_preempt``."""
        step1 = self.global_steps + 1
        guard = self._preemption_guard
        if guard is not None and guard.consume():
            self._preempt(source="signal")
        inj = self.fault_injector
        if inj is None:
            return
        if inj.preempt(step1):
            self._preempt(source="injected")
        if inj.nan_grads(step1):
            # a +inf loss scale for this one step: the loss and gradients
            # come out non-finite inside the step (through the kernels) and
            # the update is skipped on the device; restored after the step
            self._injected_scale = self.state["loss_scale"]
            self.state["loss_scale"] = torch.full((), float("inf"), dtype=torch.float32, device=self.device)
            self.telemetry.counter("resilience/injected_nan_steps").inc()

    def _preempt(self, source: str) -> None:
        """The preemption path, real signal and injected drill alike: at a
        step boundary the state is consistent, so take a just-in-time
        checkpoint under ``preemption.save_dir``/``tag`` (committed, async
        or not, with 'latest' repointed), then raise ``PreemptionSignal``.
        Without ``save_dir`` the signal still surfaces and the caller
        saves."""
        self.telemetry.counter("resilience/preemptions").inc()
        pcfg = self.config.resilience.preemption
        if pcfg.save_dir:
            t0 = time.perf_counter()
            self.save_checkpoint(pcfg.save_dir, tag=pcfg.tag)
            # the process is about to die: an async save is made durable
            # before the signal propagates
            self.checkpoint_engine.commit()
            dt = time.perf_counter() - t0
            self.telemetry.histogram("resilience/jit_ckpt_sec").observe(dt)
            self.telemetry.counter("resilience/jit_checkpoints").inc()
            log_dist(f"resilience: preemption ({source}) at step {self.global_steps}; JIT checkpoint "
                     f"{pcfg.save_dir}/{pcfg.tag} committed in {dt:.2f}s", ranks=[0])
        else:
            log_dist(f"resilience: preemption ({source}) at step {self.global_steps}; no "
                     "preemption.save_dir, the caller saves", ranks=[0])
        raise PreemptionSignal(step=self.global_steps)

    def _resilience_post_step(self, metrics) -> None:
        """Restore an injected loss scale; with the guardrail armed, fetch
        the overflow flag and escalate skip -> rewind -> diverged."""
        if self._injected_scale is not None:
            self.state["loss_scale"] = self._injected_scale
            self._injected_scale = None
        if self._guardrail is None:
            return
        overflow = bool(metrics["overflow"])
        action = self._guardrail.observe(overflow)
        if action == "rewind":
            d, t = self._guardrail.last_good
            logger.warning("resilience: %d consecutive non-finite steps; rewinding to checkpoint %s/%s",
                           self._guardrail.bad_streak, d, t)
            # the loader's cursor is not restored: data replay after a
            # rewind is the caller's part
            self.load_checkpoint(d, t, _restore_dataloader=False)
            self._guardrail.rewound()
        elif action == "diverged":
            self.telemetry.counter("resilience/diverged").inc()
            raise TrainingDivergedError(
                f"{self._guardrail.bad_streak} consecutive non-finite steps and no rewind target (save a "
                "checkpoint, or disable resilience.rewind to keep skipping)")

    def _train_telemetry(self, batch, metrics, step_dur: float) -> None:
        """Per-step registry updates; the scalar gauges and the memory
        watermarks only when the step's metrics were read anyway (print
        boundaries, or every step with a monitor), so loss-scale flips are
        boundary-sampled. The bridge pushes at print boundaries."""
        tm = self.telemetry
        tm.histogram("train/step_time_sec").observe(step_dur)
        tm.counter("train/steps").inc()
        tm.counter("train/samples").inc(self.train_batch_size)
        toks = batch.get("tokens") if isinstance(batch, dict) else None
        if toks is not None and getattr(toks, "ndim", 0) >= 2:
            tm.counter("train/tokens").inc(int(toks.shape[0]) * int(toks.shape[1]))
        if metrics is None:
            return
        tm.gauge("train/loss").set(float(metrics["loss"]))
        tm.gauge("train/lr").set(float(metrics["lr"]))
        tm.gauge("train/grad_norm").set(float(metrics["grad_norm"]))
        scale = float(metrics["loss_scale"])
        tm.gauge("train/loss_scale").set(scale)
        if self._last_seen_loss_scale is not None and scale != self._last_seen_loss_scale:
            tm.counter("train/loss_scale_flips").inc()
        self._last_seen_loss_scale = scale
        if bool(metrics["overflow"]):
            tm.counter("train/overflow_steps").inc()
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            tm.gauge("train/device_bytes_in_use").set(stats.get("allocated_bytes.all.current", 0))
            tm.gauge("train/device_peak_bytes").set(stats.get("allocated_bytes.all.peak", 0))
        if self._telemetry_bridge is not None and self.global_steps % self.config.steps_per_print == 0:
            self._telemetry_bridge.push(tm.registry, self.global_steps)

    def telemetry_snapshot(self) -> dict:
        """The registry (step-time histogram, counters, boundary gauges),
        the recompile table and the device-memory pools (params, optimizer
        state) beside the caching allocator's counts; appended to the JSONL
        log when a sink is configured. The JAX engine's program-ledger and
        collective sections are not ported."""
        pools = {"params": tree_bytes(self.state["params"]), "opt_state": tree_bytes(self.state["opt"])}
        snap = self.telemetry.snapshot(
            hbm=hbm_snapshot(pools, self.device, self.config.telemetry.ledger.hbm_warn_fraction))
        self.telemetry.emit({"type": "snapshot", **snap})
        return snap

    def _apply_curriculum(self, batch: dict) -> dict:
        """Seqlen curriculum: truncate every batch leaf of rank >= 2 to the
        scheduled difficulty + 1 tokens (the causal shift consumes one), on
        the host before the copy (JAX engine.py:1894-1905)."""
        seqlen = self.curriculum_scheduler.update_difficulty(self.global_steps)

        def trunc(x):
            if getattr(x, "ndim", 0) >= 2 and x.shape[1] > seqlen + 1:
                return x[:, : seqlen + 1]
            return x

        return {k: trunc(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # Data loading
    # ------------------------------------------------------------------

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None, **kw) -> DeepSpeedDataLoader:
        """A dataloader over ``dataset`` yielding ``train_batch_size`` samples
        per batch (one device, one replica; JAX engine.py:1907). The first
        loader built is attached as the training loader whose cursor rides
        checkpoints; later ones (eval) stay detached."""
        loader = DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_batch_size,
                                     drop_last=self.config.dataloader_drop_last, **kw)
        if self.training_dataloader is None:
            self.set_dataloader(loader)
        return loader

    def set_dataloader(self, loader) -> None:
        """Attach ``loader`` as the training loader. A cursor restored by a
        ``load_checkpoint`` that ran before any loader existed is applied
        now; the snapshot starts at the attach-time position."""
        self.training_dataloader = loader
        if self._pending_dl_state is not None and hasattr(loader, "load_state_dict"):
            loader.load_state_dict(self._pending_dl_state)
            self._pending_dl_state = None
        self._dl_cursor = loader.state_dict() if hasattr(loader, "state_dict") else None

    def _snapshot_dl_cursor(self) -> None:
        """Record the attached loader's cursor at the end of a completed
        step: in ``for b in loader: train_batch(b)`` a batch fetched but not
        yet trained when a checkpoint is taken is replayed on resume."""
        dl = self.training_dataloader
        if dl is not None and hasattr(dl, "state_dict"):
            self._dl_cursor = dl.state_dict()

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

    @property
    def checkpoint_engine(self):
        """The storage backend (``runtime/checkpoint_engine``; native only).
        With ``checkpoint.async_save`` the last save of a run is committed
        at interpreter exit too, if the caller never saves or loads again
        (the backend's own exit hook, held only while a save is pending)."""
        if self._ckpt_engine is None:
            self._ckpt_engine = get_checkpoint_engine(self.config.checkpoint.engine)
        return self._ckpt_engine

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None, client_state: Optional[dict] = None):
        """Save the engine state to ``save_dir/tag`` (default
        ``global_step<N>``), atomically, and point ``save_dir/latest`` at it
        once it is durable. The client state carries the host's trajectory
        (steps, samples, skipped steps, the dropout seed, the batch sizes,
        the guardrail's streak), so train k + save + load + train n−k draws
        the masks of train n (they follow the saved device step). With ``resilience.enabled`` a
        synchronous save is retried under ``resilience.retry`` (a
        ``PermanentIOError`` is not); an async save returns after its
        snapshot and is finished by the next save, a load or
        ``checkpoint_engine.commit()``, where its errors surface.
        ``zero_to_fp32.py`` is copied beside the checkpoint, and older tags
        are pruned to ``checkpoint.keep_last_k``."""
        tag = tag or f"global_step{self.global_steps}"
        extra = dict(client_state or {})
        extra.update(global_steps=self.global_steps, global_samples=self.global_samples,
                     skipped_steps=self.skipped_steps, rng_seed=self._seed,
                     micro_batch_size=self.micro_batch_size, train_batch_size=self.train_batch_size)
        if self.training_dataloader is not None and self._dl_cursor is not None:
            extra["dataloader"] = dict(self._dl_cursor)
        if self.curriculum_scheduler is not None:
            extra["curriculum"] = self.curriculum_scheduler.state_dict()
        if self._guardrail is not None:
            extra["guardrail"] = self._guardrail.state_dict()
        os.makedirs(save_dir, exist_ok=True)
        eng = self.checkpoint_engine
        rcfg = self.config.resilience

        def do_save():
            return eng.save(os.path.join(save_dir, tag), self.state, client_state=extra,
                            async_save=self._ckpt_async, latest=(os.path.join(save_dir, "latest"), tag))

        if rcfg.enabled and not self._ckpt_async:
            # a failed attempt's staging leftovers are reclaimed by the next
            # attempt, so a retried atomic save stays atomic; an async save
            # is not retried (its errors surface at commit, where a retry
            # would snapshot a later state)
            def note_retry(attempt, exc, delay):
                self.telemetry.counter("resilience/ckpt_retries").inc()
                logger.warning("checkpoint save %s/%s attempt %d failed (%s); retrying in %.2fs",
                               save_dir, tag, attempt, exc, delay)

            retry_call(do_save, policy=rcfg.retry, retry_on=(OSError,), no_retry_on=(PermanentIOError,),
                       seed=rcfg.fault_injection.seed, on_retry=note_retry)
        else:
            do_save()
        try:
            shutil.copyfile(zero_to_fp32.__file__, os.path.join(save_dir, "zero_to_fp32.py"))
        except OSError as e:
            logger.warning(f"could not copy zero_to_fp32.py into {save_dir}: {e}")
        log_dist(f"saved checkpoint {save_dir}/{tag}" + (" (async)" if self._ckpt_async else ""), ranks=[0])
        if self._guardrail is not None:
            self._guardrail.note_checkpoint(save_dir, tag)  # the rewind target, if saved outside a streak
        self._prune_checkpoints(save_dir, current=tag)
        return True

    def _prune_checkpoints(self, save_dir: str, current: str) -> None:
        """keep_last_k retention: after a save, the just-saved tag and the
        k - 1 newest other committed tags are kept and older ones removed;
        the 'latest' tag and the guardrail's rewind target always stay. The
        just-saved tag counts among the k while an async save of it is
        still in flight."""
        k = self.config.checkpoint.keep_last_k
        if k <= 0:
            return
        keep = {current}
        latest = os.path.join(save_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                keep.add(f.read().strip())
        if self._guardrail is not None and self._guardrail.last_good:
            gdir, gtag = self._guardrail.last_good
            if os.path.abspath(gdir) == os.path.abspath(save_dir):
                keep.add(gtag)
        tags = [current] + [t for t in saver.find_checkpoints(save_dir) if t != current]  # newest first
        for i, tag in enumerate(tags):
            if i >= k and tag not in keep:
                shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
                log_dist(f"pruned checkpoint {save_dir}/{tag} (keep_last_k={k})", ranks=[0])

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, fallback_to_intact: bool = True,
                        verify: Optional[bool] = None, _restore_dataloader: bool = True):
        """Restore the engine state from ``load_dir`` -> (tag, client_state),
        or (None, {}) when there is no 'latest' to follow. A pending async
        save is committed first. With ``tag=None`` the 'latest' tag is
        followed; if that checkpoint is torn or corrupt and
        ``fallback_to_intact`` is set, the newest intact sibling is loaded
        instead and 'latest' repointed at it. An explicit ``tag`` never
        falls back. ``verify`` (default ``checkpoint.verify_integrity``)
        digests every file before the state is touched; the fallback scan
        always verifies. The host's trajectory comes back from the client
        state (``_restore_training_state``)."""
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
        eng = self.checkpoint_engine
        eng.commit()  # do not read past an in-flight save
        try:
            state, client_state = eng.load(os.path.join(load_dir, tag), self.state, verify=verify)
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
                    state, client_state = eng.load(os.path.join(load_dir, cand), self.state, verify=True)
                except CheckpointCorruptError as e2:
                    logger.warning("checkpoint %s/%s also corrupt (%s); continuing scan", load_dir, cand, e2)
                    continue
                self.telemetry.counter("resilience/ckpt_fallbacks").inc()
                self.telemetry.counter("resilience/recovered").inc()
                logger.warning("resilience: fell back from torn checkpoint %r to intact %r", tag, cand)
                saver.write_latest(os.path.join(load_dir, "latest"), cand)
                tag = cand
                break
            if state is None:
                raise CheckpointCorruptError(f"no intact checkpoint under {load_dir} (latest {tag!r} and every "
                                             "fallback failed verification)", path=load_dir) from err
        self.state = state
        self._accum, self._micro_count = None, 0  # a half-accumulated 3-call step is dropped
        self.global_steps = int(client_state.get("global_steps", int(state["step"])))
        self.global_samples = int(client_state.get("global_samples", 0))
        self._restore_training_state(client_state, restore_dataloader=_restore_dataloader)
        self.telemetry.histogram("resilience/reshard_sec").observe(time.perf_counter() - t0)
        self.telemetry.counter("resilience/resumes").inc()
        log_dist(f"loaded checkpoint {load_dir}/{tag} in {time.perf_counter() - t0:.2f} s", ranks=[0])
        return tag, client_state

    def _restore_training_state(self, client_state: dict, restore_dataloader: bool = True) -> None:
        """The host-side trajectory the client state captured at save: the
        dropout seed, the loader's cursor (not on a guardrail rewind, where
        data replay is the caller's part), the curriculum's difficulty and
        the guardrail's streak. The masks are keyed on the loaded device
        step; an ``rng_step`` that older checkpoints of the port carry is
        ignored."""
        self._seed = int(client_state.get("rng_seed", self._seed))
        if restore_dataloader and "dataloader" in client_state:
            dl = self.training_dataloader
            if dl is not None and hasattr(dl, "load_state_dict"):
                dl.load_state_dict(client_state["dataloader"])
                self._dl_cursor = dl.state_dict()
            else:  # no loader yet (load before deepspeed_io): set_dataloader applies it
                self._pending_dl_state = dict(client_state["dataloader"])
        if self.curriculum_scheduler is not None and "curriculum" in client_state:
            self.curriculum_scheduler.load_state_dict(client_state["curriculum"])
        if self._guardrail is not None and "guardrail" in client_state:
            self._guardrail.load_state_dict(client_state["guardrail"])

    def load_universal_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        """Every format-3 checkpoint is universal (global shapes in the
        manifest, each leaf assembled whole on load, whatever the mesh that
        saved it), so this is ``load_checkpoint`` by another name, kept for
        API parity; ``checkpoint/universal.py`` reshapes files offline."""
        return self.load_checkpoint(load_dir, tag=tag)

    def _zero3_consolidated_16bit_state_dict(self) -> dict:
        """The weights in the compute dtype as a flat {"a/b": CPU tensor}
        dict in the JAX tree's order (on one device nothing is gathered)."""
        cdt = self.config.compute_dtype
        flat = saver._flatten_with_paths(self.state["params"])
        return {key.replace(saver._SEP, "/"): (t.detach().to(cdt) if t.is_floating_point() else t.detach()).cpu()
                for key, t in flat.items()}

    def save_16bit_model(self, save_dir: str, save_filename: str = "model_weights.pt") -> bool:
        """Write the weights in the compute dtype for deployment, as a torch
        state dict (``torch.save``), the file the JAX engine writes."""
        sd = self._zero3_consolidated_16bit_state_dict()
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        torch.save(sd, path)
        log_dist(f"saved 16bit model weights to {path}", ranks=[0])
        return True
