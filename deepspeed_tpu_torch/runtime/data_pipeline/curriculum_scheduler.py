"""Curriculum learning scheduler, copied from
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py`` (host-only
Python; the port keeps its own copy because importing any ``deepspeed_tpu``
submodule imports jax).

Reference: ``deepspeed/runtime/data_pipeline/curriculum_scheduler.py:8``
(``CurriculumScheduler``): difficulty (e.g. sequence length) ramps from
``min_difficulty`` to ``max_difficulty`` over training by a schedule:

  fixed_linear:   difficulty grows linearly to max over total_curriculum_step
  fixed_root:     difficulty ~ (step/total)^(1/root_degree)
  fixed_discrete: explicit (difficulty, step) breakpoints
  custom:         user-provided callable step -> difficulty

Difficulties are rounded DOWN to a multiple of ``difficulty_step`` (8 by
default in the reference). In the port this bounds the number of distinct
sequence lengths the engine's truncation hook produces, and with them the
block-sparse kernels' per-length device lists.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..config import CurriculumConfig


class CurriculumScheduler:
    def __init__(self, config: CurriculumConfig | dict):
        if isinstance(config, dict):
            from ..config import _build

            config = _build(CurriculumConfig, config)
        self.config = config
        sc = dict(config.schedule_config)
        self.schedule_type = config.schedule_type
        self.min_difficulty = int(config.min_difficulty)
        self.max_difficulty = int(config.max_difficulty)
        self.difficulty_step = int(sc.get("difficulty_step", 8))
        self.total_curriculum_step = int(sc.get("total_curriculum_step", 10000))
        self.root_degree = int(sc.get("root_degree", 2))
        self.difficulties: list = sc.get("difficulty", [])
        self.max_steps: list = sc.get("max_step", [])
        self.custom_fn: Optional[Callable[[int], int]] = sc.get("custom_fn")
        self.current_difficulty = self.min_difficulty
        self.first_step = True
        if self.schedule_type == "fixed_discrete":
            assert len(self.difficulties) == len(self.max_steps) + 1, (
                "fixed_discrete needs len(difficulty) == len(max_step) + 1"
            )
        elif self.schedule_type == "custom":
            assert callable(self.custom_fn), "custom schedule needs a callable 'custom_fn'"

    # ------------------------------------------------------------------
    def _raw_difficulty(self, global_steps: int) -> float:
        t = min(1.0, max(0.0, global_steps / max(1, self.total_curriculum_step)))
        if self.schedule_type == "fixed_linear":
            frac = t
        elif self.schedule_type == "fixed_root":
            frac = t ** (1.0 / self.root_degree)
        elif self.schedule_type == "fixed_discrete":
            level = 0
            for i, boundary in enumerate(self.max_steps):
                if global_steps > boundary:
                    level = i + 1
            return float(self.difficulties[level])
        elif self.schedule_type == "custom":
            return float(self.custom_fn(global_steps))
        else:
            raise ValueError(f"unknown curriculum schedule {self.schedule_type!r}")
        return self.min_difficulty + frac * (self.max_difficulty - self.min_difficulty)

    def get_difficulty(self, global_steps: int) -> int:
        d = int(self._raw_difficulty(global_steps))
        if self.schedule_type in ("fixed_linear", "fixed_root"):
            d = (d // self.difficulty_step) * self.difficulty_step
        return max(self.min_difficulty, min(self.max_difficulty, d))

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    # -- checkpointable state (docs/resilience.md "elastic resume") --------
    # The schedule itself is a pure function of global_steps, but the LIVE
    # difficulty is what the engine's seqlen-truncation hook applies on the
    # next batch — a resumed run must re-enter at the same difficulty, not
    # at min_difficulty for one step.
    def state_dict(self) -> dict:
        return {"current_difficulty": self.current_difficulty,
                "first_step": self.first_step}

    def load_state_dict(self, sd: dict) -> None:
        self.current_difficulty = int(
            sd.get("current_difficulty", self.current_difficulty))
        self.first_step = bool(sd.get("first_step", self.first_step))
