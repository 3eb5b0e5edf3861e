"""Typed resilience errors — the exception vocabulary of the fault-tolerance
layer (docs/resilience.md).

Every failure the subsystem detects or injects surfaces as one of these
instead of an opaque low-level error, so callers (training loops, serving
drivers, CI harnesses) can branch on the failure *kind*:

  * checkpoint errors carry the offending path — a torn checkpoint is
    distinguishable from a missing one (load falls back only for the former);
  * ``PreemptionSignal`` is the simulated/real "save and exit" signal;
  * ``RequestRejected`` is the serving load-shed verdict with a typed reason.

Stdlib-only on purpose: ``checkpoint/saver.py`` (imported in offline tooling
contexts) and the report CLI must be able to import these without jax.

The port keeps this copy of ``deepspeed_tpu/resilience/errors.py`` (it imports
nothing of the JAX package); the checkpoint code raises
``CheckpointNotFoundError`` and ``CheckpointCorruptError``, the serving
engine ``RequestRejected``, and the other types wait for the port's
resilience layer.
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base class for every typed failure the resilience layer raises."""


class CheckpointError(ResilienceError):
    def __init__(self, message: str, path: str = ""):
        super().__init__(message)
        self.path = path


class CheckpointNotFoundError(CheckpointError):
    """No checkpoint at the requested path (missing directory, manifest, or
    'latest' tag) — nothing was ever durable there; there is nothing to fall
    back to and loading code should treat this as a cold start."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint exists but fails integrity verification (torn write,
    digest mismatch, missing shard file). The *directory* is suspect, not
    the tag namespace — load falls back to the newest intact sibling."""


class TrainingDivergedError(ResilienceError):
    """The NaN/overflow streak exceeded ``max_consecutive_bad_steps`` and no
    rewind target exists (rewind disabled, or no checkpoint was ever saved).
    Raised instead of burning compute on a poisoned trajectory."""


class PreemptionSignal(ResilienceError):
    """Preemption requested (injected by the fault injector, or wired to a
    real SIGTERM handler). Raised *before* a step is dispatched, so
    ``engine.state`` is the consistent post-previous-step state and can be
    checkpointed immediately."""

    def __init__(self, step: int):
        super().__init__(f"preemption signalled before step {step + 1}")
        self.step = step


class TransientIOError(OSError):
    """Injected *transient* I/O failure (the ``io_flaky`` fault site): the
    same operation retried is expected to succeed. Deliberately an
    ``OSError`` subclass — real transient storage errors arrive as plain
    ``OSError``/``IOError``, so retry wrappers key on ``OSError`` and this
    type exists only to make injected transience distinguishable in logs
    and tests from the permanent ``io_error`` site."""


class PermanentIOError(OSError):
    """Injected *permanent* I/O failure (the ``io_error`` fault site):
    models media/permission-class errors where retrying cannot help. An
    ``OSError`` subclass so existing except clauses keep working — but the
    engine's checkpoint retry wrapper explicitly refuses to retry it,
    because the injector's write clock advances across attempts and a
    blanket OSError retry would make the 'permanent' site quietly succeed
    on attempt 2 (indistinguishable from ``io_flaky``)."""


class CheckpointPeerError(OSError):
    """A multi-rank checkpoint save failed on another rank (its file writes,
    or rank 0's manifest and commit): at the save's agreement every rank
    raises, the failing ones their own error and the others this, with the
    failing ranks in ``ranks``. An ``OSError``, so a retried save retries on
    every rank together and the ranks meet again at the next attempt's
    staging agreement."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = list(ranks)


class CheckpointPeerPermanentError(PermanentIOError):
    """``CheckpointPeerError`` for a failure another rank reported as
    permanent: a ``PermanentIOError``, so no rank retries alone."""

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = list(ranks)


class JournalCorruptError(ResilienceError):
    """The request journal (``inference/journal.py``) holds a record whose
    frame fails its magic/CRC check with MORE valid data after it — bytes
    were corrupted in place (bit rot, a torn overwrite), not merely torn at
    the tail by a crash mid-append. A torn TAIL is expected (the crash the
    journal exists to survive) and is silently truncated on replay; mid-file
    corruption means the durable record of accepted requests cannot be
    trusted and must surface as this typed error, never as a silent partial
    replay."""

    def __init__(self, message: str, path: str = "", offset: int = -1):
        super().__init__(message)
        self.path = path
        self.offset = offset


class JournalUnavailableError(ResilienceError):
    """The request journal failed to make an append durable (ENOSPC, a
    failed fsync, or the injected journal-append ``io_error`` key) and has
    gone FAIL-CLOSED: once an append cannot be persisted, nothing later in
    the file can be trusted to survive a crash, so the journal refuses all
    further appends until the process restarts over the durable prefix.
    The accept path converts this into a typed ``journal_unavailable``
    rejection (503 at the gateway) — losing an accept is recoverable by the
    client retrying; silently accepting a request the journal never
    recorded is the unrecoverable outcome (docs/resilience.md)."""

    def __init__(self, message: str, path: str = ""):
        super().__init__(message)
        self.path = path


class ControlPlaneCrash(ResilienceError):
    """Injected control-plane failure (the ``router_crash`` fault site): the
    Router raises this at the armed step, modelling the gateway+router
    process dying mid-traffic. Recovery tests abandon the raising Router and
    rebuild one over the SAME replicas and journal — the in-process spelling
    of the ``bench.py --router-chaos`` SIGKILL."""


class RpcError(ResilienceError):
    """Base class for serving-RPC transport failures (``inference/rpc.py``).
    Stdlib-only like every other typed error here — the Router and the
    worker supervisor branch on the failure *kind*: a timeout is a HUNG
    verdict (the call may have executed; the reply never arrived in
    budget), a lost connection or garbled stream is a DEAD one."""


class RpcTimeout(RpcError):
    """The per-call deadline elapsed before a complete reply frame arrived.
    The remote side may or may not have executed the call — callers must
    treat the outcome as unknown (the Router's exactly-once failover and
    the worker's cumulative unacked-terminal buffer both exist for this)."""


class RpcConnectionLost(RpcError):
    """The transport connection failed (refused, reset, or peer closed) —
    a SIGKILL'd worker process manifests as exactly this on the next
    call."""


class RpcGarbledFrame(RpcError):
    """A frame failed the magic/CRC check: the byte stream is corrupt or
    desynchronized. The connection is unusable and is closed; a reconnect
    starts a fresh stream."""


class RpcRemoteError(RpcError):
    """The remote handler raised an exception that has no typed local
    mapping; carries the remote type name for logs/tests."""

    def __init__(self, remote_type: str, message: str):
        super().__init__(f"remote {remote_type}: {message}")
        self.remote_type = remote_type


class RequestRejected(ResilienceError):
    """Serving load-shed verdict: the request was refused admission instead
    of growing the arrival queue without bound. ``reason`` is a stable typed
    string: ``queue_full`` (per-engine or router-global bound),
    ``no_healthy_replicas`` (no replica accepting dispatch), or
    ``overloaded`` — the brownout back-off hint: the fleet is at max
    capacity, still saturated, and nothing queued was lower priority than
    this arrival, so clients should slow down rather than retry hot.
    (A deadline that expires while QUEUED surfaces as a result with status
    ``expired``, not an exception.)"""

    def __init__(self, uid: int, reason: str, detail: str = ""):
        super().__init__(
            f"request {uid} rejected ({reason})" + (f": {detail}" if detail else ""))
        self.uid = uid
        self.reason = reason
