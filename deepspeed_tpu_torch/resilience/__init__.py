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
  * typed errors    — ``errors`` (a copy of the JAX package's), the
                      fleet's RPC and journal errors among them.

The fleet's invariants and chaos conductor are not ported yet.
"""

from .errors import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointError,
    CheckpointNotFoundError,
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
