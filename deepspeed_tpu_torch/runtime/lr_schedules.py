"""LR schedules as ``step -> lr`` functions on 0-d device tensors, ported
from ``deepspeed_tpu/runtime/lr_schedules.py``.

``step`` is a 0-d integer tensor (the engine's step counter, on its device)
and the result is a 0-d float32 tensor on the same device, so the train
step evaluates the schedule without reading the step on the host.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"


def constant(lr: float) -> Schedule:
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def lr_range_test(
    lr_range_test_min_lr: float = 1e-3,
    lr_range_test_step_size: int = 2000,
    lr_range_test_step_rate: float = 1.0,
    lr_range_test_staircase: bool = False,
    **_,
) -> Schedule:
    """Continuous or staircase ramp."""

    def fn(step):
        interval = step.float() / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


def one_cycle(
    cycle_min_lr: float = 0.0,
    cycle_max_lr: float = 1e-3,
    decay_lr_rate: float = 0.0,
    cycle_first_step_size: int = 2000,
    cycle_second_step_size: Optional[int] = None,
    cycle_first_stair_count: int = 0,
    cycle_second_stair_count: Optional[int] = None,
    decay_step_size: int = 0,
    **_,
) -> Schedule:
    """LR triangle, then decay."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = float(cycle_first_step_size + second)

    def fn(step):
        s = step.float()
        up_frac = torch.clamp(s / cycle_first_step_size, 0.0, 1.0)
        down_frac = torch.clamp((s - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        cycle_lr = torch.where(
            s < cycle_first_step_size,
            cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac,
            cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac,
        )
        past = torch.clamp(s - total_cycle, min=0.0)
        if decay_lr_rate > 0.0 and decay_step_size > 0:
            decay = 1.0 / (1.0 + decay_lr_rate * torch.floor(past / decay_step_size))
        else:
            decay = 1.0
        return torch.where(s >= total_cycle, cycle_min_lr * decay, cycle_lr)

    return fn


def warmup_lr(
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 1e-3,
    warmup_num_steps: int = 1000,
    warmup_type: str = "log",
    **_,
) -> Schedule:
    """Log or linear warmup, then flat."""

    def fn(step):
        s = torch.clamp(step.float(), 1.0, float(warmup_num_steps))
        if warmup_type == "log":
            frac = torch.log(s) / math.log(max(warmup_num_steps, 2))
        else:
            frac = s / warmup_num_steps
        frac = torch.clamp(frac, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return fn


def warmup_decay_lr(
    total_num_steps: int = 10000,
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 1e-3,
    warmup_num_steps: int = 1000,
    warmup_type: str = "log",
    **_,
) -> Schedule:
    """Warmup, then linear decay to 0."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step):
        s = step.float()
        decay = torch.clamp(
            (total_num_steps - s) / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return torch.where(s < warmup_num_steps, warm(step), warmup_max_lr * decay)

    return fn


SCHEDULES = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
}


def get_schedule(type_name: Optional[str], params: dict, base_lr: float) -> Schedule:
    if type_name is None:
        return constant(base_lr)
    if type_name not in SCHEDULES:
        raise ValueError(f"unknown scheduler {type_name}; have {list(SCHEDULES)}")
    return SCHEDULES[type_name](**params)
