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

Data parallelism: in a world of N processes (``comm.init_distributed``
from the env:// variables, or a process group the caller started) the
engine lays the ranks over the ``mesh`` block's ``data`` and ``fsdp`` axes
(``comm/mesh.py``), each rank takes its rows of every global micro-batch
(``train_batch`` takes the global batch, or this rank's rows of it), and
the update goes through ``zero/stage_1_and_2.py`` (stages 0-2: gradients
all-reduced or reduce-scattered, optimizer state sharded, updated shards
all-gathered) or ``zero/stage3.py`` (parameters sharded too and gathered a
layer at a time in the forward and the backward), on each leaf's
dimension of the JAX engine's specs. The loss, the gradient norm and the
non-finite flag are reduced over the ranks, so every rank takes the same
step or skips it. Without a process group (a world of 1) the engine runs
the single-device arithmetic it always ran, at every stage.

Tensor parallelism: a ``mesh.model`` above 1 (``WORLD_SIZE = data x fsdp
x model``) splits every leaf's ``model`` dimension as the JAX engine's
specs do (``module_inject.TensorParallel``): the parameters are made once
at full shape and sliced, ZeRO shards each rank's slice over the data axes
(``zero/``), the model runs this rank's heads, FFN columns and vocabulary
columns with autograd through the ``model`` collectives, and the ranks of
one ``model`` line take the same rows of each micro-batch (``dp_world`` and
``dp_rank`` count ``data`` x ``fsdp`` only). Checkpoints write each
distinct shard once and load at any layout; ``full_params`` and
``save_16bit_model`` gather full leaves. The memory tiers and block-sparse
attention under tensor parallelism are refused by name. The memory tiers (``zero_optimization.offload_optimizer`` / ``offload_param``
on ``cpu`` or ``nvme``) keep the JAX engine's offload state tree
(compute-dtype ``params``, host ``master`` and ``opt``, or the masters and
moments on disk) and step through ``zero/offload.py`` (``OffloadTier``); at
a data-parallel world above 1 the cpu tier holds this rank's shards (with
``offload_param`` at stage 3: the parameter shards too), and the NVMe tier
and ``offload_param`` below stage 3 are refused by name.
The ``activation_checkpointing`` block turns on the model's remat, and the
``sparse_attention`` block its block-sparse attention (``attn_impl="sparse"``
with the mode's ``sparsity`` fields). ``curriculum_learning`` truncates each
batch to the scheduled sequence length. ``deepspeed_io`` builds the
training dataloader, whose cursor at the last completed step rides the
checkpoint with the curriculum's state, in the JAX engine's client-state
keys.

Pipeline parallelism (a ``pipe`` axis above 1) runs through the subclass
``pipe.PipelineEngine`` over a pipelined model, whose config may lay that
axis (``_PIPELINED``); a plain engine refuses it by name. The plan above
then also cuts each stage leaf to this rank's stage, ZeRO splits that
slice, and the leaves every stage holds have their gradients summed over
``pipe`` (``zero/stage_1_and_2.py``).

Resilience (the ``resilience`` block, ``resilience/``): the NaN guardrail
(skip → rewind to the last good checkpoint → ``TrainingDivergedError``),
preemption by signal or injection (a just-in-time checkpoint, then
``PreemptionSignal``), retried synchronous saves (at every world: the
save's meeting points agree each rank's outcome, so every rank fails and
retries an attempt together), the training fault sites, and
``checkpoint.async_save``. ``csv_monitor`` receives the loss and lr
each step and, with ``telemetry.enabled``, the registry at print
boundaries.

Telemetry: the step (``train_batch``'s device work) is the watched
program ``train/train_step``; with ``telemetry.ledger`` on (the default,
as in JAX) its first call at a batch shape runs under the FLOP and byte
counter, and ``telemetry_snapshot()`` reports the registry, the program
ledger's row joined with ``train/step_time_sec`` (achieved TFLOP/s, the
``train/mfu`` gauge, the roofline verdict), the step anatomy and the
device-memory pools. ``wall_clock_breakdown`` times each step
(``train_batch`` to the loss on the device, ``step_dispatch`` to the
host's return) into ``timer/<name>_sec`` and logs them at print
boundaries; ``memory_breakdown`` logs the device and host memory there;
``flops_profiler`` profiles one micro-batch's loss at ``profile_step``.
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

from .. import comm
from ..checkpoint import saver, zero_to_fp32
from ..comm.logger import comms_logger
from ..comm.mesh import (DP_AXES, MeshConfig, build_mesh, data_parallel_size, single_device_mesh, train_axes,
                         world_plane)
from ..inference.engine import resolve_device
from ..models import transformer as tfm
from ..models.transformer import effective_loss_impl
from ..module_inject.layers import TensorParallel, TPParams, plan_of
from ..moe.sharded_moe import refuse_expert_parallel
from ..monitor.monitor import MonitorMaster
from ..ops.optimizers import get_optimizer, tree_leaves, tree_map
from ..ops.sparse_attention import SPARSITY_CONFIGS
from ..parallel import sharding as shd
from ..resilience import (CheckpointCorruptError, CheckpointNotFoundError, FaultInjector, PermanentIOError,
                          PreemptionSignal, TrainingDivergedError, TrainingGuardrail, install_injector,
                          retry_call)
from ..resilience.preemption import PreemptionGuard, activate_guard, reap_orphaned_guard
from ..telemetry import MonitorBridge, Telemetry, cost, hbm_snapshot, tree_bytes
from ..utils.logging import log_dist, logger
from ..utils.memory import see_memory_usage
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import activation_checkpointing as act_ckpt
from .checkpoint_engine.checkpoint_engine import get_checkpoint_engine
from .config import DeepSpeedConfig
from .data_pipeline.curriculum_scheduler import CurriculumScheduler
from .dataloader import DeepSpeedDataLoader
from .lr_schedules import get_schedule
from .zero.offload import OffloadTier
from .zero.stage3 import Zero3Params
from .zero.stage_1_and_2 import ZeroRuntime


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
    # a pipelined engine's config may lay a ``pipe`` axis above 1
    # (pipe/engine.py PipelineEngine); a plain engine's refuses it
    _PIPELINED = False

    def __init__(self, model, config, params: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        comm.init_distributed(device=self.device)
        world = comm.get_world_size()
        if isinstance(config, str):
            config = DeepSpeedConfig.from_file(config, world_size=world, pipelined=self._PIPELINED)
        elif isinstance(config, dict):
            config = DeepSpeedConfig.from_dict(config, world_size=world, pipelined=self._PIPELINED)
        self.config: DeepSpeedConfig = config
        distributed = comm.is_initialized()
        sizes = config.dp_mesh_sizes(world)
        self.mesh = (build_mesh(MeshConfig(**sizes), axes_list=train_axes(sizes))
                     if distributed else single_device_mesh())
        self._plane = world_plane(self.mesh.shape)  # the axes the world spans
        self.dp_world = data_parallel_size(self.mesh)
        self.dp_rank = self.mesh.axis_index(DP_AXES)
        if config.train_batch_size != (config.train_micro_batch_size_per_gpu
                                       * config.gradient_accumulation_steps * self.dp_world):
            raise ValueError(f"train_batch_size {config.train_batch_size} != micro "
                             f"{config.train_micro_batch_size_per_gpu} x gas {config.gradient_accumulation_steps}"
                             f" x data-parallel world {self.dp_world}")
        comms_logger.configure(enabled=config.comms_logger.enabled, verbose=config.comms_logger.verbose)
        self.model = model
        self._refuse_moe(model, config)
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_batch_size = config.train_batch_size
        self.zero_stage = config.zero_optimization.stage
        self.global_steps = 0
        self.global_samples = 0
        self._seed = int(config.seed)  # dropout/layer-drop stream; restored by load_checkpoint
        self._enforce_elasticity(config.raw)

        self.training_dataloader = None  # set by deepspeed_io / set_dataloader
        self._dl_cursor = None  # the loader's cursor at the last COMPLETED step
        self._pending_dl_state = None  # a cursor loaded before any loader was attached

        # telemetry: the registry always runs (host-side dict updates); the
        # config gates the exporters, the JSONL sink and the monitor bridge
        self.monitor = MonitorMaster(config)
        tcfg = config.telemetry
        self.telemetry = Telemetry(jsonl_path=tcfg.jsonl_path if tcfg.enabled else "",
                                   watchdog_mode=tcfg.watchdog, device_sync_spans=tcfg.device_sync_spans,
                                   ledger=tcfg.ledger.enabled, jsonl_max_bytes=tcfg.jsonl_max_bytes,
                                   jsonl_keep=tcfg.jsonl_keep, device=self.device,
                                   ledger_collectives=tcfg.ledger.collectives.enabled,
                                   ici_gbps=tcfg.ledger.collectives.ici_gbps)
        self.telemetry.ledger.set_mesh_shape(self.mesh.shape)
        # the train step's ledger row reads its wall time from the step-time
        # histogram and publishes the engine's headline train/mfu gauge;
        # under wall_clock_breakdown from the train_batch timer instead,
        # which ends at the step's loss on the device (the span, without
        # device_sync_spans, ends when the host has enqueued the step)
        wall = "timer/train_batch_sec" if config.wall_clock_breakdown else "train/step_time_sec"
        self.telemetry.ledger.bind("train/train_step", wall_hist=wall, gauge="train")
        # the step is watched but never stable: the curriculum's batch
        # shapes legitimately make new signatures
        wd = self.telemetry.watchdog
        self._train_step = wd.watch(self._train_step_program, wd.unique_name("train/train_step"))
        self.timers = SynchronizedWallClockTimer(registry=self.telemetry.registry, device=self.device)
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size,
                                          steps_per_output=config.steps_per_print,
                                          registry=self.telemetry.registry)
        self._telemetry_bridge = (MonitorBridge(self.monitor)
                                  if tcfg.enabled and tcfg.monitor_bridge and self.monitor.enabled else None)
        self._last_seen_loss_scale = None  # boundary-sampled flip detection

        # resilience: the step always skips a non-finite update on the
        # device; the guardrail adds streak tracking and rewind at the cost
        # of one fetch of the overflow flag per step
        rcfg = config.resilience
        # each rank draws its own faults: the rank folds into the seed (the
        # JAX engine folds the process index into its retry seed, :2196)
        fi = dataclasses.replace(rcfg.fault_injection, seed=rcfg.fault_injection.seed + comm.get_rank())
        self.fault_injector = FaultInjector(fi) if fi.enabled else None
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
            log_dist(f"sparse_attention: {sparsity}", ranks=[0])
        self.curriculum_scheduler = None
        if config.curriculum_learning.enabled:
            self.curriculum_scheduler = CurriculumScheduler(config.curriculum_learning)
        ac = config.activation_checkpointing
        if ac.enabled:
            act_ckpt.set_config(ac)
            overrides = act_ckpt.model_overrides(model.config.num_layers)
            if overrides:
                model.config = model.config.replace(**overrides)
                log_dist(f"activation_checkpointing: {overrides}", ranks=[0])
        impl, reason = effective_loss_impl(model.config, mesh=self.mesh)
        note = "" if impl == model.config.loss_impl else f" (configured {model.config.loss_impl!r}: {reason})"
        log_dist(f"loss implementation: {impl}{note}", ranks=[0])

        self.opt_init, self.opt_update, base_lr = get_optimizer(config.optimizer.type, config.optimizer.params)
        self.lr_schedule = get_schedule(config.scheduler.type, config.scheduler.params, base_lr)
        if config.zero_optimization.offload_param.device != "none":
            mcfg = getattr(model, "config", None)
            if mcfg is None or not hasattr(mcfg, "param_offload"):
                raise NotImplementedError(
                    "offload_param needs a model family with per-layer param "
                    "streaming (models/transformer.py param_offload)")
            if not mcfg.param_offload:
                model.config = mcfg.replace(param_offload=True)

        if params is None:
            params = model.init(torch.Generator().manual_seed(0), self.device)
        # tensor (and pipeline) parallelism: the plan of every leaf's model
        # split and stage split, from the full shapes (the parameters are
        # made, or given, at full shape and sliced, so every model size
        # starts from the same weights; a TPParams tree is already this
        # rank's slices)
        tp_size = self.mesh.shape["model"]
        if tp_size > 1 and getattr(model.config, "attn_impl", None) == "sparse":
            raise NotImplementedError(
                f"attn_impl='sparse' with tensor parallelism (mesh model={tp_size}: block-sparse attention on a "
                "rank's H/tp heads) is not ported to deepspeed_tpu_torch yet")
        self.tp: Optional[TensorParallel] = plan_of(params)
        sliced = self.tp is not None
        if not sliced and (tp_size > 1 or self.mesh.shape["pipe"] > 1):
            self.tp = TensorParallel(self.mesh, model.logical_axes(), params)
        # (in the tree's own key order, which the layouts' leaves follow)
        full_shapes = params if not sliced else tree_map(lambda _, shape: shape, params, self.tp.full_shapes)
        params = tree_map(lambda t: t.to(device=self.device,
                                         dtype=torch.float32 if t.is_floating_point() else t.dtype), params)
        # data parallelism: the ZeRO runtime shards over the mesh (every
        # stage, a world of 1 under a process group included). A memory tier
        # at a world of 1 runs its single-device path; above 1 the cpu tier
        # holds this rank's shards (offload_param at stage 3 only, and no NVMe:
        # the config refuses the others there).
        self.zero: Optional[ZeroRuntime] = None
        self.z3: Optional[Zero3Params] = None
        if distributed and (config.offload_tier == "none" or self.dp_world > 1):
            if config.offload_tier != "none" and config.optimizer.type.lower() in ("lamb", "fusedlamb"):
                raise NotImplementedError("LAMB with the cpu tier at a data-parallel world above 1 is not ported: "
                                          "its host update takes a leaf at a time, and the trust ratio needs "
                                          "whole-leaf norms")
            axes_tree = model.logical_axes() if hasattr(model, "logical_axes") else tree_map(lambda _: None, params)
            zc = config.zero_optimization
            self.zero = ZeroRuntime(self.mesh, self.zero_stage, axes_tree, full_shapes, zc.reduce_bucket_size,
                                    zc.allgather_bucket_size)
            if self.tp is not None and not sliced:
                params = self.tp.shard(params)
            params = self.zero.shard_params(params)
            if self.zero_stage == 3:
                self.z3 = Zero3Params(params, self.device, self.zero.param_layouts, config.compute_dtype,
                                      zc.allgather_bucket_size, zc.reduce_bucket_size,
                                      host_grads=zc.offload_param.device != "none", tp=self.tp)
        # the memory tiers (zero/offload.py): the fp32 masters and the
        # optimizer state leave the device; params become the compute-dtype copy
        self.tier = (OffloadTier(config, params, self.device, self.opt_init, self.opt_update, zero=self.zero)
                     if config.offload_tier != "none" else None)
        fp16 = config.fp16
        self.fp16_enabled = fp16.enabled
        scale0 = fp16.loss_scale if fp16.loss_scale > 0 else float(2 ** fp16.initial_scale_power)

        def scalar(value, dtype):
            return torch.full((), value, dtype=dtype, device=self.device)

        self.state = {
            "step": scalar(0, torch.int32),
            "params": params,
            "opt": (self.opt_init(params if self.zero is None else self.zero.owned(params))
                    if self.tier is None else {}),
            "loss_scale": scalar(scale0 if fp16.enabled else 1.0, torch.float32),
            "good_steps": scalar(0, torch.int32),
            "skipped": scalar(0, torch.int32),
            "hysteresis": scalar(fp16.hysteresis, torch.int32),
        }
        if self.tier is not None:
            self.state.update(self.tier.state_entries())
            del params
        n_params = sum(t.numel() for t in tree_leaves(self.state["params"]))
        log_dist(f"engine ready: {n_params / 1e6:.1f}M params on this rank, zero_stage={self.zero_stage}, "
                 f"model={self.mesh.shape['model']}, mesh={self.mesh.shape}, device={self.device}, "
                 f"micro_bs={self.micro_batch_size}, "
                 f"gas={self.gradient_accumulation_steps}, dtype={config.compute_dtype}", ranks=[0])

    def _refuse_moe(self, model, config: DeepSpeedConfig) -> None:
        """An MoE model (``moe_every`` > 0) trains on one rank at ZeRO 0-2;
        the paths not ported for it are refused by name: expert parallelism
        (a data-parallel world above 1), tensor parallelism, ZeRO stage 3
        and the memory tiers."""
        if getattr(getattr(model, "config", None), "moe_every", 0) <= 0:
            return
        if self.mesh.shape["model"] > 1:
            raise NotImplementedError(f"MoE under tensor parallelism (mesh model={self.mesh.shape['model']}: the "
                                      "experts split over the model axis) is not ported to deepspeed_tpu_torch yet")
        refuse_expert_parallel(self.mesh)
        z = config.zero_optimization
        if z.stage == 3:
            raise NotImplementedError("MoE under ZeRO stage 3 (the expert banks gathered a layer at a time) is not "
                                      "ported to deepspeed_tpu_torch yet (stages 0-2 are)")
        for name, dev in (("offload_optimizer", z.offload_optimizer.device),
                          ("offload_param", z.offload_param.device)):
            if dev != "none":
                raise NotImplementedError(f"MoE with the memory tiers ({name} {dev!r}) is not ported to "
                                          "deepspeed_tpu_torch yet")
        ac = config.activation_checkpointing
        if ac.enabled and ac.cpu_checkpointing:
            raise NotImplementedError("MoE with the memory tiers (activation_checkpointing.cpu_checkpointing) is "
                                      "not ported to deepspeed_tpu_torch yet")

    def _enforce_elasticity(self, raw) -> None:
        """The elastic batch contract (JAX ``engine.py:693``): with
        ``elasticity.enabled`` the batch sizes must be the elastic solution
        at this engine's world. ``ignore_non_elastic_batch_info`` makes the
        solution replace the configured sizes; otherwise a mismatch raises
        ``ElasticityError``."""
        el = raw.get("elasticity", {}) if isinstance(raw, dict) else {}
        if not el.get("enabled"):
            return
        from ..elasticity import ElasticityError, compute_elastic_config

        final_batch, valid_gpus, micro = compute_elastic_config({"elasticity": el}, world_size=self.dp_world)
        if el.get("ignore_non_elastic_batch_info", False):
            self.train_batch_size = final_batch
            self.micro_batch_size = micro
            self.gradient_accumulation_steps = max(1, final_batch // (micro * self.dp_world))
            self.config.train_batch_size = final_batch
            self.config.train_micro_batch_size_per_gpu = micro
            self.config.gradient_accumulation_steps = self.gradient_accumulation_steps
            log_dist(f"elasticity: overriding configured batch sizes with the elastic solution "
                     f"train={final_batch}, micro={micro}, gas={self.gradient_accumulation_steps} for world "
                     f"{self.dp_world}", ranks=[0])
            return
        if self.train_batch_size != final_batch:
            raise ElasticityError(
                f"elastic training requires train_batch_size={final_batch} at "
                f"world size {self.dp_world} (valid worlds: {valid_gpus}); config "
                f"has {self.train_batch_size}. Set elasticity."
                f"ignore_non_elastic_batch_info to override."
            )

    @property
    def _dropout_enabled(self) -> bool:
        c = self.model.config
        return c.hidden_dropout > 0 or c.attn_dropout > 0 or c.pld_enabled

    def _cast(self, params):
        dt = self.config.compute_dtype
        return tree_map(lambda p: p.to(dt) if p.dtype == torch.float32 else p, params)

    def _compute_copy(self, params):
        """The compute-dtype copy of this rank's parameters the model reads,
        constrained to this rank's part and carrying the tensor-parallel
        plan."""
        out = self._cast(params)
        if self.zero is not None:
            out = shd.constrain(out, self.mesh, self.zero.param_layouts)
        return out if self.tp is None else TPParams(out, self.tp)

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
        if self.curriculum_scheduler is not None:
            batch = self._apply_curriculum(batch)
        wcb = self.config.wall_clock_breakdown
        self.tput_timer.start()
        if wcb:
            self.timers("train_batch").start()
            self.timers("step_dispatch").start()
        with self.telemetry.span("train/train_batch") as sp:
            dev_batch = {k: _to_device(v, self.device) for k, v in batch.items()}
            local = self.train_batch_size // self.dp_world
            for k, v in dev_batch.items():
                if v.shape[0] not in (self.train_batch_size, local):
                    raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, train_batch_size is "
                                     f"{self.train_batch_size}" + (f" (this rank's rows: {local})"
                                                                   if self.dp_world > 1 else ""))
            metrics = self._train_step(self.state, dev_batch)
            sp.set_sync(metrics["loss"])
        if wcb:
            self.timers("step_dispatch").stop()
            self.timers("train_batch").stop(barrier=metrics["loss"])
        self.tput_timer.stop()
        self.global_steps += 1
        fp = self.config.flops_profiler
        if fp.enabled and self.global_steps == fp.profile_step:
            self._run_flops_profiler(dev_batch)
        self.global_samples += self.train_batch_size
        spp = self.config.steps_per_print
        need_host = self.global_steps % spp == 0 or self.monitor.enabled
        if self.global_steps % spp == 0:
            self._report_progress(metrics)
            if wcb:
                self.timers.log(["train_batch", "step_dispatch"], normalizer=spp, memory_breakdown=True)
            see_memory_usage(f"after step {self.global_steps}", force=self.config.memory_breakdown,
                             device=self.device)
        if self.monitor.enabled:
            self.monitor.write_events([("Train/Samples/train_loss", float(metrics["loss"]), self.global_samples),
                                       ("Train/Samples/lr", float(metrics["lr"]), self.global_samples)])
        self._train_telemetry(batch, metrics if need_host else None, sp.dur_s)
        self._resilience_post_step(metrics)
        self._snapshot_dl_cursor()
        return metrics

    def _train_step_program(self, state: dict, dev_batch: dict) -> dict:
        """The watched step (``train/train_step``): the ``gas``
        micro-batches' forward and backward, then the update, on the batch
        already on the device. ``state`` is ``self.state``, passed so the
        signature and the ledger's argument bytes cover it; the update
        replaces ``self.state``."""
        gas = self.gradient_accumulation_steps
        micro = {k: v.reshape(gas, v.shape[0] // gas, *v.shape[1:]) for k, v in dev_batch.items()}
        b = self.micro_batch_size
        # a global batch: this rank's rows of every micro-batch, as JAX's
        # batch spec ("data", "fsdp") splits them
        micro = {k: v[:, self.dp_rank * b:(self.dp_rank + 1) * b] if v.shape[1] != b else v
                 for k, v in micro.items()}
        leaves = self._grad_leaves()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            loss_sum = loss_sum + self._accumulate(leaves, {k: v[i] for k, v in micro.items()}, i)
        loss = loss_sum / gas
        if self.zero is not None:
            loss = comm.all_reduce(loss, DP_AXES, "mean")
        return {"loss": loss, **self._apply_update(leaves, gas)}

    def _grad_leaves(self) -> dict:
        """The fp32 master parameters as fresh autograd leaves, whose
        ``.grad`` collects the micro-batches' gradients (under a memory tier,
        what the tier differentiates: ``OffloadTier.grad_leaves``)."""
        if self.z3 is not None:
            return self.z3.begin_step(self.state["params"])
        if self.tier is not None:
            return self.tier.grad_leaves()
        return tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), self.state["params"])

    def _accumulate(self, leaves, mb: dict, micro: int) -> torch.Tensor:
        """Forward and backward of one micro-batch (with dropout): the
        gradients of ``loss × loss_scale`` add into ``leaves``' ``.grad``.
        Returns the detached fp32 loss."""
        kw = {}
        if self._dropout_enabled:
            kw = {"rng": self._dropout_key(micro), "step": self.state["step"] + 1}
            if self.dp_rank:  # this rank's rows of the micro-batch draw their masks
                kw["row_offset"] = self.dp_rank * self.micro_batch_size
        weight = self._label_weight(mb)
        scale = self.state["loss_scale"] if weight is None else self.state["loss_scale"] * weight
        if self.z3 is not None:
            loss = self.z3.backward_micro(self.model, leaves, mb, scale, kw)
        elif self.tier is not None:
            loss = self.tier.backward_micro(self.model, leaves, mb, scale, kw)
        else:
            loss = self.model.loss(self._compute_copy(leaves), mb, **kw)
            (loss * scale).backward()
            loss = loss.detach().float()
        return loss if weight is None else loss * weight

    def _label_weight(self, mb: dict) -> Optional[torch.Tensor]:
        """For a batch with explicit ``labels`` at a data-parallel world
        above 1: ``world · c / C``, where ``c`` is this rank's labelled
        (``>= 0``) tokens in the micro-batch and ``C`` the whole micro-batch's
        (each at least 1, as the loss clamps its count). The rank's token
        mean times it, averaged over the ranks, is the token mean over the
        global micro-batch, which the JAX engine takes under pjit. Without
        labels every token is labelled, the ranks' counts are equal and the
        weight is 1: None, and no collective."""
        if self.zero is None or self.dp_world == 1 or "labels" not in mb:
            return None
        labelled = (mb["labels"] >= 0).sum().float()
        total = comm.all_reduce(labelled, DP_AXES, "sum")
        return self.dp_world * labelled.clamp(min=1.0) / total.clamp(min=1.0)

    @torch.no_grad()
    def _apply_update(self, leaves, n_micro: int) -> dict:
        """The step's update from the gradients in ``leaves``: unscale by
        ``1/(loss_scale·n_micro)``, check finiteness, clip, apply the
        optimizer at ``lr(step+1)`` and keep the old state where the
        gradients were not finite; the loss scale follows its rule.
        Replaces ``self.state``; returns {grad_norm, lr, loss_scale,
        overflow} as device tensors."""
        if self.tier is not None:
            return self._apply_tier_update(leaves, n_micro)
        state = self.state
        step1 = state["step"] + 1
        loss_scale = state["loss_scale"]
        reduce = None
        if self.z3 is not None:  # already reduce-scattered onto this rank's shards
            grads = self.z3.gradients()
        else:
            grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
        if self.zero is not None:
            grads = shd.constrain(grads, self.mesh, self.zero.param_layouts)
            if self.z3 is None:
                grads = self.zero.reduce_grads(grads)
            n_micro, reduce = n_micro * self.dp_world, self.zero.reduce_stats
        finite, gnorm = self._unscale_and_clip(grads, loss_scale, n_micro, reduce)
        lr = self.lr_schedule(step1)
        owned = state["params"] if self.zero is None else self.zero.owned(state["params"])
        kw = {}
        if self.zero is not None and self.config.optimizer.type.lower() in ("lamb", "fusedlamb"):
            kw["reduce_sq"] = self.zero.reduce_leaf_sq  # the trust ratio's whole-leaf norms
        new_params, new_opt = self.opt_update(grads, state["opt"], owned, step1, lr, **kw)

        def keep(new, old):
            return torch.where(finite, new, old)

        new_params = tree_map(keep, new_params, owned)
        if self.zero is not None:
            new_params = shd.constrain(self.zero.assemble(new_params, state["params"]), self.mesh,
                                       self.zero.param_layouts)
        scalars = self._scalars_after(finite, step1)
        self.state = {"step": scalars.pop("step"), "params": new_params,
                      "opt": tree_map(keep, new_opt, state["opt"]), **scalars}
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": loss_scale, "overflow": ~finite}

    def _unscale_and_clip(self, grads, loss_scale, n_micro: int, reduce=None):
        """In place on ``grads`` (where they live): unscale by
        ``1/(loss_scale·n_micro)``, then clip to the global norm ->
        (finite, norm before clipping), tensors on the gradients' device.
        ``reduce`` (the ZeRO runtime's ``reduce_stats``) turns the per-leaf
        sums of squares and non-finite counts of this rank's gradients into
        the whole model's."""
        gl = tree_leaves(grads)
        inv = (1.0 / (loss_scale * n_micro)).to(gl[0].device)
        for g in gl:
            g.mul_(inv)
        if reduce is None:
            finite = torch.stack([torch.isfinite(g).all() for g in gl]).all()
            gnorm = _global_norm(grads)
        else:
            # (on the engine's device: NCCL reduces there, and host gradients
            # under offload_param send only these scalars)
            sq, bad = reduce([torch.sum(torch.square(g.float())).to(self.device) for g in gl],
                             [(~torch.isfinite(g)).sum().float().to(self.device) for g in gl])
            finite, gnorm = bad == 0, torch.sqrt(sq)
        clip = self.config.gradient_clipping
        if clip > 0:
            factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in gl:
                g.mul_(factor.to(g.device))
        return finite, gnorm

    def _scalars_after(self, finite, step1) -> dict:
        """The step counter and the loss-scale state after a step whose
        gradients were ``finite`` (a device tensor)."""
        state, fp16 = self.state, self.config.fp16
        loss_scale = state["loss_scale"]
        if self.fp16_enabled and fp16.loss_scale == 0:
            new_scale, good, hyst = _dynamic_loss_scale(
                finite, loss_scale, state["good_steps"], state["hysteresis"], fp16)
        else:
            new_scale, good, hyst = loss_scale, state["good_steps"], state["hysteresis"]
        return {"step": torch.where(finite, step1, state["step"]), "loss_scale": new_scale, "good_steps": good,
                "skipped": state["skipped"] + (~finite).int(), "hysteresis": hyst}

    @torch.no_grad()
    def _apply_tier_update(self, leaves, n_micro: int) -> dict:
        """``_apply_update`` under a memory tier (JAX ``engine.py:764-840``,
        ``:1801-1852``): unscale, finiteness, norm and clipping where the
        gradients are (the device, or the host when the parameters are
        streamed), then ONE fetch of (finite, lr, step) and, for a finite
        step, the tier's in-place host update. A step that is not finite
        leaves the parameters, the host state and the disk untouched."""
        state = self.state
        step1 = state["step"] + 1
        loss_scale = state["loss_scale"]
        grads = self.z3.gradients() if self.z3 is not None else self.tier.gradients(leaves)
        reduce = None
        if self.zero is not None:  # onto this rank's shards, as _apply_update reduces them
            if self.z3 is None:
                grads = self.zero.reduce_grads(grads)
            n_micro, reduce = n_micro * self.dp_world, self.zero.reduce_stats
        finite, gnorm = self._unscale_and_clip(grads, loss_scale, n_micro, reduce)
        lr = self.lr_schedule(step1)
        finite = finite.to(self.device)
        fetched = torch.stack([finite.double(), lr.double(), step1.double()]).cpu()
        if bool(fetched[0]):
            with cost.paused():  # the host update is not the device's work
                self.tier.update(grads, int(fetched[2]), float(fetched[1]))
        self.state = {**state, **self._scalars_after(finite, step1), **self.tier.state_entries()}
        return {"grad_norm": gnorm.to(self.device), "lr": lr, "loss_scale": loss_scale, "overflow": ~finite}

    # ------------------------------------------------------------------
    # The 3-call loop: forward / backward / step (JAX engine.py:1965-2087)
    # ------------------------------------------------------------------

    def forward(self, batch: dict) -> torch.Tensor:
        """The loss of one micro-batch of [micro_batch_size, ...] leaves,
        without dropout or a gradient (a 0-d device tensor). The batch is
        kept for ``backward``."""
        self._last_batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        return self._eval_loss(self._last_batch)

    def _eval_loss(self, batch: dict) -> torch.Tensor:
        """The loss of ``batch`` without dropout or a gradient, this rank's
        (ZeRO-3: the layers gathered as in training, so every rank of the
        world calls it together)."""
        if self.z3 is not None:
            return self.z3.evaluate(lambda v: self.model.loss(v, batch), self.z3.view(self.state["params"]))
        with torch.no_grad():
            return self.model.loss(self._compute_copy(self.state["params"]), batch)

    __call__ = forward

    def backward(self, loss=None) -> None:
        """Accumulate fp32 gradients for the batch last passed to
        ``forward``: its loss is recomputed with dropout (``loss`` is not
        differentiated; it may be None)."""
        if self.tier is not None and self.tier.streamed:
            raise NotImplementedError(
                "offload_param supports the fused train_batch() path only "
                "(per-call gradient accumulation would round-trip the host-"
                "resident gradient tree through HBM); forward()/eval_batch() "
                "work normally")
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
        inj = self.fault_injector
        signal = guard is not None and guard.consume()
        injected = inj is not None and inj.preempt(step1)
        if comm.get_world_size() > 1 and (guard is not None or inj is not None):
            # every rank preempts (and takes its JIT checkpoint) together; a
            # guard or an injector is configured on every rank of a world
            flags = comm.all_reduce(torch.tensor([float(signal), float(injected)], device=self.device),
                                    self._plane, "max").tolist()
            signal, injected = flags[0] > 0, flags[1] > 0 and not flags[0] > 0
        if signal:
            self._preempt(source="signal")
        if inj is None:
            return
        if injected:
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
        the recompile table, the program ledger (the step's FLOPs, bytes
        and device memory, with achieved TFLOP/s, MFU and the roofline
        verdict), the step anatomy and the device-memory pools (params,
        optimizer state) beside the caching allocator's counts; appended to
        the JSONL log when a sink is configured. The collective ledger's
        ``comm_reconcile`` view rides beside them. The pools are this
        rank's own bytes (its shards under ZeRO)."""
        pools = {"params": tree_bytes(self.state["params"]), "opt_state": tree_bytes(self.state["opt"])}
        if "master" in self.state:
            pools["master_params"] = tree_bytes(self.state["master"])
        snap = self.telemetry.snapshot(
            hbm=hbm_snapshot(pools, self.device, self.config.telemetry.ledger.hbm_warn_fraction))
        self.telemetry.emit({"type": "snapshot", **snap})
        return snap

    def _run_flops_profiler(self, dev_batch: dict) -> None:
        """The ``flops_profiler`` block (JAX ``engine.py:1779-1800``): profile
        the loss over one micro-batch of the step's batch and print it.
        Advisory: a failure is logged, never raised into training."""
        from ..profiling.flops_profiler.profiler import FlopsProfiler

        fp = self.config.flops_profiler
        rows = max(1, self.train_batch_size // self.gradient_accumulation_steps)
        micro = {k: v[:rows] for k, v in dev_batch.items()}
        try:
            prof = FlopsProfiler(fp)
            params = self.full_params()
            res = prof.profile(lambda p, b: self.model.loss(self._cast(p), b), params, micro, params=params)
            prof.print_model_profile(res, detailed=fp.detailed)
        except (RuntimeError, ValueError, TypeError, NotImplementedError, OSError) as e:
            logger.warning(f"flops profiler failed: {e}")

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
        """A data-parallel dataloader over ``dataset`` (JAX engine.py:1907):
        this rank's ``train_batch_size / dp`` samples per batch, its sampler
        strided by the rank's data-parallel coordinate over the ``data`` x
        ``fsdp`` ranks. The first loader built is attached as the training
        loader whose cursor rides checkpoints; later ones (eval) stay
        detached."""
        kw.setdefault("num_replicas", self.dp_world)
        kw.setdefault("rank", self.dp_rank)
        loader = DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_batch_size // self.dp_world,
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
        return float(self._eval_loss(batch))

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
        (steps, samples, skipped steps, the dropout seed, the data-parallel
        world and the batch sizes, the guardrail's streak), so train k + save + load + train n−k draws
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
                     skipped_steps=self.skipped_steps, rng_seed=self._seed, dp_world=self.dp_world,
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
                            async_save=self._ckpt_async, latest=(os.path.join(save_dir, "latest"), tag),
                            layouts=self._state_layouts())

        if rcfg.enabled and not self._ckpt_async:
            # a failed attempt's staging leftovers are reclaimed by the next
            # attempt, so a retried atomic save stays atomic; an async save
            # is not retried (its errors surface at commit, where a retry
            # would snapshot a later state). At a world above 1 the save's
            # meeting points agree every rank's outcome (checkpoint/saver.py
            # _agree), so every rank fails an attempt together, and retries
            # it after its own backoff (the rank folds into the seed, as the
            # JAX engine folds the process index) from the staging agreement
            def note_retry(attempt, exc, delay):
                self.telemetry.counter("resilience/ckpt_retries").inc()
                logger.warning("checkpoint save %s/%s attempt %d failed (%s); retrying in %.2fs",
                               save_dir, tag, attempt, exc, delay)

            retry_call(do_save, policy=rcfg.retry, retry_on=(OSError,), no_retry_on=(PermanentIOError,),
                       seed=rcfg.fault_injection.seed + comm.get_rank(), on_retry=note_retry)
        else:
            do_save()
        if self.tier is not None and self.tier.nvme is not None:
            # the tier's masters and moments live on disk, outside self.state:
            # they go beside the engine's files (JAX engine.py:2200-2204)
            eng.commit()
            self.tier.nvme.save_state(os.path.join(save_dir, tag, "nvme_optimizer"))
        try:
            if comm.get_rank() == 0:
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
        if k <= 0 or comm.get_rank() != 0:
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
            state, client_state = eng.load(os.path.join(load_dir, tag), self.state, verify=verify,
                                           layouts=self._state_layouts())
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
                    state, client_state = eng.load(os.path.join(load_dir, cand), self.state, verify=True,
                                                   layouts=self._state_layouts())
                except CheckpointCorruptError as e2:
                    logger.warning("checkpoint %s/%s also corrupt (%s); continuing scan", load_dir, cand, e2)
                    continue
                self.telemetry.counter("resilience/ckpt_fallbacks").inc()
                self.telemetry.counter("resilience/recovered").inc()
                logger.warning("resilience: fell back from torn checkpoint %r to intact %r", tag, cand)
                if comm.get_rank() == 0:
                    saver.write_latest(os.path.join(load_dir, "latest"), cand)
                tag = cand
                break
            if state is None:
                raise CheckpointCorruptError(f"no intact checkpoint under {load_dir} (latest {tag!r} and every "
                                             "fallback failed verification)", path=load_dir) from err
        if self.tier is not None:
            state = self._adopt_tier_state(state, os.path.join(load_dir, tag))
        self.state = state
        self._accum, self._micro_count = None, 0  # a half-accumulated 3-call step is dropped
        self.global_steps = int(client_state.get("global_steps", int(state["step"])))
        self.global_samples = int(client_state.get("global_samples", 0))
        self._restore_training_state(client_state, restore_dataloader=_restore_dataloader)
        self.telemetry.histogram("resilience/reshard_sec").observe(time.perf_counter() - t0)
        self.telemetry.counter("resilience/resumes").inc()
        log_dist(f"loaded checkpoint {load_dir}/{tag} in {time.perf_counter() - t0:.2f} s", ranks=[0])
        return tag, client_state

    def _adopt_tier_state(self, state: dict, ckpt_dir: str) -> dict:
        """A loaded state into the tier's buffers (``OffloadTier.adopt``);
        the NVMe tier's masters and moments from ``<tag>/nvme_optimizer``
        (JAX ``engine.py:2453-2493``): without them the masters are rebuilt
        from the loaded parameters with zeroed moments and a restarted
        bias-correction clock, loudly."""
        leaves = saver.read_manifest(ckpt_dir)["leaves"]
        state = self.tier.adopt(state, has_master=any(k.startswith("master::") for k in leaves))
        nvme = self.tier.nvme
        if nvme is not None:
            state_dir = os.path.join(ckpt_dir, "nvme_optimizer")
            if nvme.load_state(state_dir):
                log_dist(f"restored NVMe optimizer tier (masters + moments, step {nvme.step_count}) from "
                         f"{state_dir}", ranks=[0])
            else:
                logger.warning(
                    "checkpoint %s has no nvme_optimizer state; Adam moments "
                    "restart from zero and the bias-correction clock is reset "
                    "(convergence will briefly re-warm)", state_dir)
                nvme.reset_from(self.tier.master_params_host(), step_count=0)
        return state

    def close(self) -> None:
        """Release what the engine holds outside Python's reach: the NVMe
        tier's I/O threads (its swap files stay until the next run on the
        path reclaims them)."""
        if self.tier is not None:
            self.tier.close()

    def _restore_training_state(self, client_state: dict, restore_dataloader: bool = True) -> None:
        """The host-side trajectory the client state captured at save: the
        dropout seed, the loader's cursor (not on a guardrail rewind, where
        data replay is the caller's part), the curriculum's difficulty and
        the guardrail's streak. The masks are keyed on the loaded device
        step; an ``rng_step`` that older checkpoints of the port carry is
        ignored. A checkpoint saved at another ``dp_world`` counts one
        ``resilience/topology_changes``."""
        self._seed = int(client_state.get("rng_seed", self._seed))
        saved_dp = int(client_state.get("dp_world", self.dp_world) or self.dp_world)
        if saved_dp != self.dp_world:
            self.telemetry.counter("resilience/topology_changes").inc()
            log_dist(f"elastic resume: checkpoint saved at dp={saved_dp} "
                     f"(micro={client_state.get('micro_batch_size', '?')}), live dp={self.dp_world} "
                     f"(micro={self.micro_batch_size}): each leaf loads whole; the data cursor rescales "
                     "through the global sample count", ranks=[0])
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

    def _state_layouts(self) -> Optional[dict]:
        """{checkpoint leaf key: LeafLayout} of the state leaves this rank
        holds a shard of (None without the ZeRO runtime)."""
        if self.zero is None:
            return None
        tree = {"opt": self.zero.opt_state_layouts(self.state["opt"]), "params": self.zero.param_layouts}
        if self.tier is not None:  # the cpu tier's host masters: the optimizer state's split
            tree["master"] = self.zero.opt_layouts
        flat = saver._flatten_with_paths(tree)
        return {k: v for k, v in flat.items() if v is not None and v.partial}

    def full_params(self) -> dict:
        """The whole fp32 parameter tree on every rank (ZeRO-3: gathered;
        under tensor parallelism the slices gathered over ``model``;
        collective)."""
        params = self.state["params"]
        if self.z3 is not None:
            from .zero.stage_1_and_2 import all_gather_rows

            lays = tree_leaves(self.zero.param_layouts)
            shards = tree_leaves(params)
            idx = [i for i, lay in enumerate(lays) if lay.sharded]
            out = list(shards)
            for i, f in zip(idx, all_gather_rows([shards[i] for i in idx], [lays[i] for i in idx],
                                                 self.config.zero_optimization.allgather_bucket_size)):
                out[i] = f
            it = iter(out)
            params = tree_map(lambda _: next(it), params)
        return params if self.tp is None else self.tp.gather(params)

    def _zero3_consolidated_16bit_state_dict(self) -> dict:
        """The weights in the compute dtype as a flat {"a/b": CPU tensor}
        dict in the JAX tree's order (ZeRO-3: gathered from every rank;
        collective)."""
        cdt = self.config.compute_dtype
        flat = saver._flatten_with_paths(self.full_params())
        return {key.replace(saver._SEP, "/"): (t.detach().to(cdt) if t.is_floating_point() else t.detach()).cpu()
                for key, t in flat.items()}

    def save_16bit_model(self, save_dir: str, save_filename: str = "model_weights.pt") -> bool:
        """Write the weights in the compute dtype for deployment, as a torch
        state dict (``torch.save``), the file the JAX engine writes."""
        sd = self._zero3_consolidated_16bit_state_dict()
        path = os.path.join(save_dir, save_filename)
        if comm.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            torch.save(sd, path)
        comm.barrier()
        log_dist(f"saved 16bit model weights to {path}", ranks=[0])
        return True
