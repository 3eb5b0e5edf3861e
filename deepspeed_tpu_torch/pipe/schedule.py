"""Declarative pipeline instruction schedules: the port of
``deepspeed_tpu/pipe/schedule.py`` (reference ``runtime/pipe/schedule.py``:
``PipeSchedule`` :6, ``InferenceSchedule`` :129, ``TrainSchedule`` :182,
the instruction classes :336-448), with the same clocks and the same
``num_pipe_buffers``.

The port's pipeline does not interpret these instructions one by one:
``pipe/engine.py`` runs a stage's ticks directly, the executed 1F1B
(``pipeline_train_1f1b``) on ``TrainSchedule``'s closed-form clocks. The
schedules are its specification (the executed trace is held against
them) and the buffer counts its memory bound; users of the reference may
subclass ``PipeSchedule`` as before.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


# ---------------------------------------------------------------------------
# Instructions (reference schedule.py:336-448)
# ---------------------------------------------------------------------------

class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{self.name}({inner})"

    def __eq__(self, other):
        return self.name == getattr(other, "name", None) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    pass  # kwargs: buffer_id


class ForwardPass(PipeInstruction):
    pass  # kwargs: buffer_id


class BackwardPass(PipeInstruction):
    pass  # kwargs: buffer_id


class SendActivation(PipeInstruction):
    pass  # kwargs: buffer_id


class RecvActivation(PipeInstruction):
    pass  # kwargs: buffer_id


class SendGrad(PipeInstruction):
    pass  # kwargs: buffer_id


class RecvGrad(PipeInstruction):
    pass  # kwargs: buffer_id


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

class PipeSchedule(ABC):
    """Yields, per local step, the list of instructions one stage executes."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        assert 0 <= stage_id < stages
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @abstractmethod
    def steps(self):
        ...

    def num_pipe_buffers(self) -> int:
        """Activation buffers needed — the pipeline's memory high-water mark."""
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id: int) -> bool:
        return 0 <= micro_batch_id < self.micro_batches

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only streaming (reference schedule.py:129): microbatch m enters
    stage s at clock m + s."""

    def steps(self):
        total = self.micro_batches + self.stages - 1
        out = []
        for clock in range(total):
            cmds = []
            m = clock - self.stage_id
            if self._valid_micro_batch(m):
                buf = m % self.num_pipe_buffers()
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buffer_id=buf))
                else:
                    cmds.append(RecvActivation(buffer_id=buf))
                cmds.append(ForwardPass(buffer_id=buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=buf))
            out.append(cmds)
        return out

    def num_pipe_buffers(self):
        return 2  # double-buffer: recv next while computing current


class TrainSchedule(PipeSchedule):
    """1F1B (reference schedule.py:182).

    Clocked formulation: with S stages and M microbatches, on stage s
      * forward of microbatch m runs at clock  2*m + s
      * backward of microbatch m runs at clock 2*m + 2*S - 1 - s
    so on the last stage each backward directly follows its forward, each
    stage's fwd and bwd clocks have opposite parity (never collide), sends
    precede the matching recv by exactly one clock in both directions, and
    stage s keeps at most S - s microbatches in flight (the 1F1B memory
    bound; GPipe would keep M).
    """

    def _fwd_clock(self, m: int) -> int:
        return 2 * m + self.stage_id

    def _bwd_clock(self, m: int) -> int:
        return 2 * m + 2 * self.stages - 1 - self.stage_id

    def steps(self):
        S, M = self.stages, self.micro_batches
        total_clocks = 2 * M + 2 * S - 2  # last bwd clock on stage 0 is 2(M-1)+2S-1
        fwd_at = {self._fwd_clock(m): m for m in range(M)}
        bwd_at = {self._bwd_clock(m): m for m in range(M)}
        nbuf = self.num_pipe_buffers()
        out = []
        for clock in range(total_clocks):
            cmds = []
            if clock in fwd_at:
                m = fwd_at[clock]
                buf = m % nbuf
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buffer_id=buf))
                else:
                    cmds.append(RecvActivation(buffer_id=buf))
                cmds.append(ForwardPass(buffer_id=buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=buf))
            if clock in bwd_at:
                m = bwd_at[clock]
                buf = m % nbuf
                if not self.is_last_stage:
                    cmds.append(RecvGrad(buffer_id=buf))
                cmds.append(BackwardPass(buffer_id=buf))
                if not self.is_first_stage:
                    cmds.append(SendGrad(buffer_id=buf))
            out.append(cmds)
        # epilogue: grad reduction + step (reference TrainSchedule tail)
        out.append([ReduceTiedGrads(), ReduceGrads(), OptimizerStep()])
        return out

    def num_pipe_buffers(self):
        """Peak in-flight microbatches on this stage = S - stage_id (capped by
        M) — the 1F1B memory advantage over GPipe's M buffers."""
        return max(1, min(self.micro_batches, self.stages - self.stage_id))
