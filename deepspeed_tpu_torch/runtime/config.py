"""The training subset of ``DeepSpeedConfig``, ported from
``deepspeed_tpu/runtime/config.py``.

One DeepSpeed JSON dict drives both packages: the batch triangulation
(train = micro × gas × world), ``fp16``/``bf16``, ``zero_optimization``,
``optimizer``, ``scheduler``, clipping, seed and ``steps_per_print`` parse
the same way, as do ``activation_checkpointing`` and ``checkpoint``. The
port runs on one device, so the world size is 1 and a ``mesh`` axis above 1
is refused. Blocks that belong to paths not ported yet
raise ``NotImplementedError`` when enabled, naming the block; ZeRO stages
0-3 are accepted, since on one device they are the same arithmetic.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops.optimizers import ONEBIT
from . import constants as C


class DeepSpeedConfigError(Exception):
    pass


def _sub(d: dict, key: str) -> dict:
    v = d.get(key, {})
    if v is None:
        return {}
    if not isinstance(v, dict):
        raise DeepSpeedConfigError(f"'{key}' must be an object, got {type(v)}")
    return v


def _build(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OffloadConfig:
    device: str = "none"  # none | cpu | nvme


@dataclass
class ZeroConfig:
    stage: int = 0
    offload_param: OffloadConfig = field(default_factory=OffloadConfig)
    offload_optimizer: OffloadConfig = field(default_factory=OffloadConfig)

    def __post_init__(self):
        if isinstance(self.offload_param, dict):
            self.offload_param = _build(OffloadConfig, self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = _build(OffloadConfig, self.offload_optimizer)
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"zero stage must be 0-3, got {self.stage}")


@dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: dict = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: dict = field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` block (reference checkpointing.py:825
    ``configure()``): remat over the layer stack, wired into the model by
    ``activation_checkpointing.model_overrides``. ``policy`` is a remat
    policy name; empty keeps the model's own (save_flash)."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = ""
    enabled: bool = False

    def check_ported(self) -> None:
        """cpu_checkpointing belongs to the memory tiers and
        partition_activations to tensor parallelism: neither is ported."""
        for name in ("cpu_checkpointing", "partition_activations"):
            if self.enabled and getattr(self, name):
                raise NotImplementedError(
                    f"activation_checkpointing.{name} is not ported to deepspeed_tpu_torch yet")


@dataclass
class CheckpointConfig:
    """The ``checkpoint`` block. ``keep_last_k > 0`` prunes older tags after
    each save (the 'latest'-pointed tag and the newest save are always
    kept); 0 keeps all. ``verify_integrity=False`` skips the digest pass on
    load. ``async_save`` and a non-native ``engine`` are not ported."""

    engine: Optional[str] = None  # native (None = native)
    async_save: bool = False
    keep_last_k: int = 0
    verify_integrity: bool = True

    def __post_init__(self):
        if self.keep_last_k < 0:
            raise DeepSpeedConfigError(f"checkpoint.keep_last_k must be >= 0, got {self.keep_last_k}")


@dataclass
class ProgressiveLayerDropConfig:
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclass
class MeshAxesConfig:
    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    context: int = 1
    model: int = 1


# Blocks whose ``enabled`` flag selects a path the port does not have yet.
_UNPORTED_BLOCKS = (
    C.CURRICULUM_LEARNING, C.FLOPS_PROFILER, "eigenvalue", C.RESILIENCE, C.TELEMETRY,
    C.ELASTICITY,
)


@dataclass
class DeepSpeedConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = C.STEPS_PER_PRINT_DEFAULT
    seed: int = C.SEED_DEFAULT
    gradient_clipping: float = C.GRADIENT_CLIPPING_DEFAULT

    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(
        default_factory=ProgressiveLayerDropConfig)
    mesh: MeshAxesConfig = field(default_factory=MeshAxesConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    raw: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_file(cls, path: str, world_size: int = 1) -> "DeepSpeedConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f), world_size=world_size)

    @classmethod
    def from_dict(cls, d: dict, world_size: int = 1) -> "DeepSpeedConfig":
        cfg = cls(
            train_batch_size=d.get(C.TRAIN_BATCH_SIZE),
            train_micro_batch_size_per_gpu=d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU),
            gradient_accumulation_steps=d.get(C.GRADIENT_ACCUMULATION_STEPS),
            steps_per_print=d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT),
            seed=int(d.get(C.SEED, C.SEED_DEFAULT)),
            gradient_clipping=d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT),
            fp16=_build(FP16Config, _sub(d, C.FP16)),
            bf16=_build(BF16Config, _sub(d, C.BF16)),
            zero_optimization=_build(ZeroConfig, _sub(d, C.ZERO_OPTIMIZATION)),
            optimizer=_build(OptimizerConfig, _sub(d, C.OPTIMIZER)),
            scheduler=_build(SchedulerConfig, _sub(d, C.SCHEDULER)),
            activation_checkpointing=_build(ActivationCheckpointingConfig,
                                            _sub(d, C.ACTIVATION_CHECKPOINTING)),
            progressive_layer_drop=_build(ProgressiveLayerDropConfig,
                                          _sub(d, C.PROGRESSIVE_LAYER_DROP)),
            mesh=_build(MeshAxesConfig, _sub(d, C.MESH)),
            checkpoint=_build(CheckpointConfig, _sub(d, C.CHECKPOINT)),
            raw=d,
        )
        cfg._triangulate_batch(world_size)
        cfg._validate()
        return cfg

    def _triangulate_batch(self, world_size: int) -> None:
        """train = micro × gas × world."""
        train, micro, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        ws = max(world_size, 1)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * ws)
        elif train is not None and gas is not None:
            micro = train // (gas * ws)
        elif micro is not None and gas is not None:
            train = micro * gas * ws
        elif train is not None:
            gas = 1
            micro = train // ws
        elif micro is not None:
            train = micro * ws
            gas = 1
        else:
            raise DeepSpeedConfigError(
                "at least one of train_batch_size / train_micro_batch_size_per_gpu must be set")
        self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps = (
            train, micro, gas)
        if train != micro * gas * ws:
            raise DeepSpeedConfigError(
                f"batch sizes inconsistent: train_batch_size={train} != "
                f"micro({micro}) * gas({gas}) * world({ws})")

    def _validate(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        z = self.zero_optimization
        for name in ("offload_optimizer", "offload_param"):
            if getattr(z, name).device != "none":
                raise NotImplementedError(
                    f"zero_optimization.{name} device {getattr(z, name).device!r} is not "
                    "ported to deepspeed_tpu_torch yet")
        if self.optimizer.type.lower() in ONEBIT:
            raise NotImplementedError(
                f"optimizer {self.optimizer.type!r} (the 1-bit family) is not ported to "
                "deepspeed_tpu_torch yet")
        self.activation_checkpointing.check_ported()
        if self.checkpoint.async_save:
            raise NotImplementedError("checkpoint.async_save is not ported to deepspeed_tpu_torch yet")
        if self.checkpoint.engine not in (None, "native"):
            raise NotImplementedError(f"checkpoint.engine {self.checkpoint.engine!r} is not ported to "
                                      "deepspeed_tpu_torch (native only)")
        for block in _UNPORTED_BLOCKS:
            sub = _sub(self.raw, block)
            if sub.get("enabled", False):
                raise NotImplementedError(f"config block {block!r} is not ported to deepspeed_tpu_torch yet")
        if self.raw.get(C.SPARSE_ATTENTION):
            raise NotImplementedError(
                f"config block {C.SPARSE_ATTENTION!r} is not ported to deepspeed_tpu_torch yet")
        big = {k: v for k, v in dataclasses.asdict(self.mesh).items() if v > 1}
        if big:
            raise NotImplementedError(f"mesh axes {big} > 1: deepspeed_tpu_torch runs on one device")

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 -> torch.bfloat16, fp16 -> torch.float16 (training keeps
        fp16 as fp16), else torch.float32."""
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
