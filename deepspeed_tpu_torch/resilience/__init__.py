"""The fault-tolerance layer (the port of ``deepspeed_tpu/resilience``'s
training and serving parts):

  * ``faults``      — the seeded deterministic ``FaultInjector`` (NaN
                      gradients, checkpoint write errors, garbage serving
                      logits, simulated preemption) and the process-global
                      slot the checkpoint writer consults;
  * ``guardrails``  — NaN/overflow streak tracking with skip → rewind →
                      diverged escalation;
  * ``preemption``  — SIGTERM/SIGINT → a flag the engine consumes at the
                      next step boundary (JIT checkpoint, then
                      ``PreemptionSignal``);
  * ``retry``       — bounded exponential backoff with seeded jitter around
                      checkpoint saves;
  * ``heartbeat``   — the supervisors' monotonic heartbeat-file judge;
  * ``invariants``  — the fleet's oracles (zero accepted loss, terminal
                      conservation, exactly-once failover, ...);
  * ``chaos``       — seeded fault schedules over the fleet, judged by the
                      oracles, with a delta-debugging shrink and replayable
                      reproducers (its names load on first use, so
                      ``python -m deepspeed_tpu_torch.resilience.chaos``
                      runs the module once);
  * typed errors    — ``errors`` (a copy of the JAX package's), the
                      fleet's RPC and journal errors among them.
"""

from .errors import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointError,
    CheckpointNotFoundError,
    CheckpointPeerError,
    CheckpointPeerPermanentError,
    ControlPlaneCrash,
    JournalCorruptError,
    JournalUnavailableError,
    PermanentIOError,
    PreemptionSignal,
    RequestRejected,
    ResilienceError,
    RpcConnectionLost,
    RpcError,
    RpcGarbledFrame,
    RpcRemoteError,
    RpcTimeout,
    TrainingDivergedError,
    TransientIOError,
)
from .faults import FaultInjector, clear_injector, get_injector, install_injector, maybe_io_error  # noqa: F401
from .guardrails import TrainingGuardrail  # noqa: F401
from .heartbeat import HeartbeatJudge  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
from .retry import RetryPolicy, backoff_delay, retry_call  # noqa: F401

_CHAOS = ("ChaosOutcome", "ChaosRunner", "DEFAULT_WORKLOAD", "FAKE_SITES", "FaultEntry", "FaultSchedule",
          "derive_seed", "replay_repro", "search", "shrink_schedule", "write_repro")


def __getattr__(name):
    if name in _CHAOS:
        from . import chaos

        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
