"""The training subset of ``DeepSpeedConfig``, ported from
``deepspeed_tpu/runtime/config.py``.

One DeepSpeed JSON dict drives both packages: the batch triangulation
(train = micro × gas × world), ``fp16``/``bf16``, ``zero_optimization``,
``optimizer``, ``scheduler``, clipping, seed and ``steps_per_print`` parse
the same way, as do ``activation_checkpointing``, ``checkpoint``,
``sparse_attention`` (turned into the model's ``attn_impl="sparse"`` by the
engine), ``curriculum_learning`` and ``dataloader_drop_last``. The port
runs on one device, so the world size is 1 and a ``mesh`` axis above 1 is
refused. ``resilience`` (the NaN guardrail, preemption, checkpoint-save
retries and the training fault sites), ``csv_monitor``, the training
fields of ``telemetry`` and ``checkpoint.async_save`` parse as in the JAX
package. Blocks that belong to paths not ported yet raise
``NotImplementedError`` when enabled, naming the block: among them the
monitor and logging blocks (``tensorboard``, ``wandb``, ``comms_logger``,
and the flags ``wall_clock_breakdown``, ``memory_breakdown`` and
``dump_state`` set to true), which the port would otherwise accept and
ignore, the telemetry ``ledger`` (on by default in the JAX package: a
``telemetry`` block must pass ``"ledger": {"enabled": false}``) and its
flight-recorder blocks; ZeRO stages 0-3 are accepted, since on one device
they are the same arithmetic.
"""

from __future__ import annotations

import dataclasses
import json
import signal as _signal
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
    each save (the 'latest'-pointed tag, the newest save and the guardrail's
    rewind target are always kept); 0 keeps all. ``verify_integrity=False``
    skips the digest pass on load. ``async_save`` snapshots the state to
    host memory inside ``save_checkpoint`` and writes the files on a
    background thread, finished by the next save, a load or
    ``checkpoint_engine.commit()``. A non-native ``engine`` is not ported."""

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
class CurriculumConfig:
    """reference: runtime/data_pipeline/curriculum_scheduler.py:8."""

    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: dict = field(default_factory=dict)


@dataclass
class SparseAttentionConfig:
    """reference: runtime/config.py:283-466 sparse attention modes. The
    engine forwards the fields the mode's ``SparsityConfig`` takes to the
    model (``attn_impl="sparse"``, ``sparsity``)."""

    mode: str = "fixed"
    block: int = 16
    different_layout_per_head: bool = False
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1
    num_random_blocks: int = 0
    local_window_blocks: list = field(default_factory=lambda: [4])
    global_block_indices: list = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[list] = None
    num_sliding_window_blocks: int = 3


@dataclass
class MeshAxesConfig:
    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    context: int = 1
    model: int = 1


# ---------------------------------------------------------------------------
# The serving blocks ``inference/serving.ServingEngine`` reads (the JAX
# package's dataclasses, with their defaults and validation errors)
# ---------------------------------------------------------------------------

@dataclass
class RequestTraceConfig:
    """``telemetry.request_trace`` (also ``serving.request_trace``): record
    each request's arrived/admitted/chunk/first_token/terminal events in a
    ring of ``capacity`` events (``telemetry/request_trace.py``)."""

    enabled: bool = True
    capacity: int = 2048

    def __post_init__(self):
        if self.capacity < 1:
            raise DeepSpeedConfigError(
                f"telemetry.request_trace.capacity must be >= 1, "
                f"got {self.capacity}")


_FAULT_SITES = {"nan_grads", "io_error", "io_flaky", "garbage_logits", "preempt",
                "replica_dead", "replica_hang", "rpc_timeout", "rpc_conn_reset",
                "rpc_garbled_frame", "gateway_disconnect", "gateway_stall", "router_crash"}


@dataclass
class FaultInjectionConfig:
    """``serving.fault_injection`` and ``resilience.fault_injection``:
    deterministic faults (``resilience/faults.FaultInjector``). The port's
    serving engine consumes ``garbage_logits_uids`` (+ ``_phase``
    ``prefill|decode`` and the 0-based ``_decode_step``) and ``rate`` /
    ``sites``; the training engine ``nan_grad_steps`` and ``preempt_steps``
    (1-based global steps) and the checkpoint writer ``io_error_writes``
    and ``io_flaky_writes`` (1-based guarded writes, permanent and
    transient); the fleet ``replica_dead_at`` / ``replica_hang_at``
    ([replica, router step]), ``rpc_timeout_at`` / ``rpc_conn_reset_at`` /
    ``rpc_garbled_at`` ([method, nth call]), ``router_crash_at`` (router
    steps), the journal's ``io_error_journal_appends`` and the HTTP
    gateway's ``gateway_disconnect_at`` / ``gateway_stall_at`` ([uid, nth
    streamed token])."""

    enabled: bool = False
    seed: int = 0
    rate: float = 0.0
    sites: list = field(default_factory=list)
    nan_grad_steps: list = field(default_factory=list)
    io_error_writes: list = field(default_factory=list)
    io_flaky_writes: list = field(default_factory=list)
    io_error_journal_appends: list = field(default_factory=list)
    garbage_logits_uids: list = field(default_factory=list)
    garbage_logits_phase: str = "decode"
    garbage_logits_decode_step: int = 0
    preempt_steps: list = field(default_factory=list)
    replica_dead_at: list = field(default_factory=list)
    replica_hang_at: list = field(default_factory=list)
    rpc_timeout_at: list = field(default_factory=list)
    rpc_conn_reset_at: list = field(default_factory=list)
    rpc_garbled_at: list = field(default_factory=list)
    gateway_disconnect_at: list = field(default_factory=list)
    gateway_stall_at: list = field(default_factory=list)
    router_crash_at: list = field(default_factory=list)

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise DeepSpeedConfigError(
                f"fault_injection.rate must be in [0, 1], got {self.rate}")
        if self.garbage_logits_phase not in ("prefill", "decode"):
            raise DeepSpeedConfigError(
                "fault_injection.garbage_logits_phase must be prefill|decode, "
                f"got {self.garbage_logits_phase!r}")
        bad = set(self.sites) - _FAULT_SITES
        if bad:
            raise DeepSpeedConfigError(
                f"fault_injection.sites contains unknown site(s) {sorted(bad)}")
        pairs = {"replica_dead_at": ((int, int), "[replica_id, router_step] int pairs"),
                 "replica_hang_at": ((int, int), "[replica_id, router_step] int pairs"),
                 "rpc_timeout_at": ((str, int), "[method, nth_call] (str, int) pairs"),
                 "rpc_conn_reset_at": ((str, int), "[method, nth_call] (str, int) pairs"),
                 "rpc_garbled_at": ((str, int), "[method, nth_call] (str, int) pairs"),
                 "gateway_disconnect_at": ((int, int), "[uid, nth_token] int pairs"),
                 "gateway_stall_at": ((int, int), "[uid, nth_token] int pairs")}
        for name, (types, what) in pairs.items():
            for p in getattr(self, name):
                if (not isinstance(p, (list, tuple)) or len(p) != 2
                        or not all(isinstance(x, t) for x, t in zip(p, types))):
                    raise DeepSpeedConfigError(f"fault_injection.{name} entries must be {what}, got {p!r}")
        for s in self.router_crash_at:
            if not isinstance(s, int) or s < 1:
                raise DeepSpeedConfigError(
                    f"fault_injection.router_crash_at entries must be "
                    f"1-based router steps (positive ints), got {s!r}")
        for s in self.io_error_journal_appends:
            if not isinstance(s, int) or s < 1:
                raise DeepSpeedConfigError(
                    f"fault_injection.io_error_journal_appends entries must "
                    f"be 1-based append indices (positive ints), got {s!r}")


@dataclass
class PrefixCacheConfig:
    """``serving.prefix_cache``: prompt-prefix KV reuse. A host trie maps
    prompt prefixes (in whole ``block``s) to slots of a device pool
    ``[L, n_slots, max_prefix_len, H, Dh]`` (0 = the slot length);
    ``insert_policy`` ``always`` caches every admitted prompt's prefix,
    ``min_hits`` only one that ``min_hits`` prompts have shared."""

    enabled: bool = False
    n_slots: int = 8
    max_prefix_len: int = 0  # 0 = the serving slot length (Smax)
    block: int = 16
    insert_policy: str = "always"
    min_hits: int = 2

    def __post_init__(self):
        if self.insert_policy not in ("always", "min_hits"):
            raise DeepSpeedConfigError(
                f"serving.prefix_cache.insert_policy must be always|min_hits, "
                f"got {self.insert_policy!r}")
        if self.n_slots < 1:
            raise DeepSpeedConfigError(
                f"serving.prefix_cache.n_slots must be >= 1, got {self.n_slots}")
        if self.block < 1:
            raise DeepSpeedConfigError(
                f"serving.prefix_cache.block must be >= 1, got {self.block}")
        if self.min_hits < 1:
            raise DeepSpeedConfigError(
                f"serving.prefix_cache.min_hits must be >= 1, got {self.min_hits}")


@dataclass
class ChunkedPrefillConfig:
    """``serving.chunked_prefill``: prompt suffixes run as ``chunk_size``
    chunks (a power of two; the remainder as one power-of-two padded tail),
    ``chunks_per_step`` of them per scheduler step between decode steps."""

    enabled: bool = False
    chunk_size: int = 64
    chunks_per_step: int = 1

    def __post_init__(self):
        c = self.chunk_size
        if c < 1 or (c & (c - 1)) != 0:
            raise DeepSpeedConfigError(
                f"serving.chunked_prefill.chunk_size must be a power of two, got {c}")
        if self.chunks_per_step < 1:
            raise DeepSpeedConfigError(
                f"serving.chunked_prefill.chunks_per_step must be >= 1, "
                f"got {self.chunks_per_step}")


@dataclass
class TenantConfig:
    """One tenant of ``serving.tenants`` (and ``serving.gateway.auth.tenants``):
    ``weight`` is its DWRR share of admissions, ``max_queued`` its bound on
    arrived, queued requests (0 = none). ``token_sha256`` (the bearer
    token's SHA-256, never the token), ``rate_rps`` and ``burst`` (its token
    bucket) belong to the HTTP gateway."""

    token_sha256: str = ""
    weight: float = 1.0
    max_queued: int = 0
    rate_rps: float = 0.0
    burst: int = 8

    def __post_init__(self):
        if self.weight < 0.01:
            raise DeepSpeedConfigError(
                f"serving.gateway.auth tenant weight must be >= 0.01, "
                f"got {self.weight}")
        if self.max_queued < 0 or self.rate_rps < 0:
            raise DeepSpeedConfigError(
                "serving.gateway.auth tenant max_queued/rate_rps must be "
                ">= 0")
        if self.burst < 1:
            raise DeepSpeedConfigError(
                f"serving.gateway.auth tenant burst must be >= 1, "
                f"got {self.burst}")
        d = self.token_sha256
        if d and (len(d) != 64 or any(c not in "0123456789abcdef"
                                      for c in d.lower())):
            raise DeepSpeedConfigError(
                "serving.gateway.auth tenant token_sha256 must be a "
                "64-char hex SHA-256 digest (never the raw token)")


@dataclass
class SpeculationConfig:
    """``serving.speculation``: drafts of up to ``depth`` tokens a slot
    (``ngram``: prompt lookup over the request's own history once a suffix
    of ``ngram_min_match`` tokens recurs; ``draft_model``: a host-resident
    random scorer), verified in one forward pass; greedy requests keep
    the tokens of one-token decode exactly."""

    enabled: bool = False
    depth: int = 4
    ngram_min_match: int = 2
    draft_source: str = "ngram"

    def __post_init__(self):
        if self.draft_source not in ("ngram", "draft_model"):
            raise DeepSpeedConfigError(
                f"serving.speculation.draft_source must be ngram|draft_model, "
                f"got {self.draft_source!r}")
        if self.depth < 1:
            raise DeepSpeedConfigError(
                f"serving.speculation.depth must be >= 1, got {self.depth}")
        if self.ngram_min_match < 1:
            raise DeepSpeedConfigError(
                f"serving.speculation.ngram_min_match must be >= 1, "
                f"got {self.ngram_min_match}")


# ---------------------------------------------------------------------------
# The fleet's blocks under ``serving.router`` (and ``serving.gateway``),
# which ``inference/router.Router``, ``inference/rpc`` and
# ``launcher/serving_worker`` read: the JAX package's dataclasses, with
# their defaults and validation errors. ``disagg`` parses and refuses being
# enabled, and ``autoscale`` a ``scale_up_mfu`` threshold (``check_ported``).
# ---------------------------------------------------------------------------

@dataclass
class RouterHealthConfig:
    """``serving.router.health``: ``timeout`` is the step-latency bound past
    which a replica's step is a HUNG verdict (0 disables the check);
    ``max_attempts`` / ``base_delay_s`` / ``max_delay_s`` / ``jitter`` are
    the probation schedule (``resilience/retry.backoff_delay`` reads them);
    the ``max_attempts``-th hung verdict escalates to DEAD."""

    timeout: float = 5.0
    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.timeout < 0:
            raise DeepSpeedConfigError(
                f"serving.router.health.timeout must be >= 0, got {self.timeout}")
        if self.max_attempts < 1:
            raise DeepSpeedConfigError(
                f"serving.router.health.max_attempts must be >= 1, "
                f"got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise DeepSpeedConfigError(
                "serving.router.health delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise DeepSpeedConfigError(
                f"serving.router.health.jitter must be in [0, 1], "
                f"got {self.jitter}")


@dataclass
class JournalConfig:
    """``serving.router.journal``: the durable request journal
    (``inference/journal.RequestJournal``). Accepted requests, terminals
    and cancels are appended (fsync'd unless ``fsync`` is false); a Router
    built over an existing file replays it and reconciles with the
    replicas. Compaction every ``rotate_max_records`` appends keeps live
    requests and the last ``keep_terminals`` terminals."""

    enabled: bool = False
    path: str = ""
    fsync: bool = True
    rotate_max_records: int = 4096
    keep_terminals: int = 1024

    def __post_init__(self):
        if self.enabled and not self.path:
            raise DeepSpeedConfigError(
                "serving.router.journal.enabled requires journal.path")
        if self.rotate_max_records < 2:
            raise DeepSpeedConfigError(
                f"serving.router.journal.rotate_max_records must be >= 2, "
                f"got {self.rotate_max_records}")
        if self.keep_terminals < 0:
            raise DeepSpeedConfigError(
                f"serving.router.journal.keep_terminals must be >= 0, "
                f"got {self.keep_terminals}")


@dataclass
class RouterTransportConfig:
    """``serving.router.transport``: the RPC to worker-process replicas
    (``inference/rpc``, ``launcher/serving_worker``). ``family`` unix|tcp;
    TCP workers of slot i listen on ``port_base + i`` (0: an ephemeral port
    read from the worker's ready line). ``call_timeout_s`` is the per-call
    reply deadline (a missed one is the Router's HUNG verdict); the
    reconnect schedule is ``connect_attempts`` / ``base_delay_s`` /
    ``max_delay_s`` / ``jitter``. ``boot_timeout_s`` bounds a worker's boot,
    ``heartbeat_timeout_s`` its heartbeat file's staleness before a SIGKILL
    (0 disables)."""

    family: str = "unix"
    host: str = "127.0.0.1"
    port_base: int = 0
    call_timeout_s: float = 30.0
    connect_attempts: int = 4
    base_delay_s: float = 0.2
    max_delay_s: float = 2.0
    jitter: float = 0.25
    boot_timeout_s: float = 60.0
    heartbeat_timeout_s: float = 10.0

    def __post_init__(self):
        if self.family not in ("unix", "tcp"):
            raise DeepSpeedConfigError(
                f"serving.router.transport.family must be unix|tcp, "
                f"got {self.family!r}")
        if not 0 <= self.port_base <= 65535:
            raise DeepSpeedConfigError(
                f"serving.router.transport.port_base must be in [0, 65535], "
                f"got {self.port_base}")
        if self.call_timeout_s <= 0:
            raise DeepSpeedConfigError(
                f"serving.router.transport.call_timeout_s must be > 0, "
                f"got {self.call_timeout_s}")
        if self.connect_attempts < 1:
            raise DeepSpeedConfigError(
                f"serving.router.transport.connect_attempts must be >= 1, "
                f"got {self.connect_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise DeepSpeedConfigError(
                "serving.router.transport delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise DeepSpeedConfigError(
                f"serving.router.transport.jitter must be in [0, 1], "
                f"got {self.jitter}")
        if self.boot_timeout_s <= 0:
            raise DeepSpeedConfigError(
                f"serving.router.transport.boot_timeout_s must be > 0, "
                f"got {self.boot_timeout_s}")
        if self.heartbeat_timeout_s < 0:
            raise DeepSpeedConfigError(
                f"serving.router.transport.heartbeat_timeout_s must be "
                f">= 0, got {self.heartbeat_timeout_s}")


@dataclass
class AutoscaleConfig:
    """``serving.router.autoscale``: the elastic fleet
    (``inference/autoscaler.Autoscaler``), parsed and validated as in the
    JAX package. ``scale_up_mfu`` reads the program ledger's MFU gauges,
    which the port has not got: a threshold above 0 is refused
    (``check_ported``) rather than left to never fire."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_queue: int = 4
    scale_up_load: float = 3.0
    scale_up_step_s: float = 0.0
    scale_up_mfu: float = 0.0
    scale_down_load: float = 0.5
    up_consecutive: int = 2
    down_consecutive: int = 4
    cooldown_s: float = 5.0
    brownout_deadline_s: float = 0.0
    events_capacity: int = 256

    def __post_init__(self):
        if self.min_replicas < 1:
            raise DeepSpeedConfigError(
                f"serving.router.autoscale.min_replicas must be >= 1, "
                f"got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise DeepSpeedConfigError(
                f"serving.router.autoscale.max_replicas ({self.max_replicas}) "
                f"must be >= min_replicas ({self.min_replicas})")
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            raise DeepSpeedConfigError(
                "serving.router.autoscale up/down_consecutive must be >= 1")
        if self.cooldown_s < 0 or self.brownout_deadline_s < 0:
            raise DeepSpeedConfigError(
                "serving.router.autoscale cooldown_s/brownout_deadline_s "
                "must be >= 0")
        if (self.scale_up_queue < 0 or self.scale_up_load < 0
                or self.scale_up_step_s < 0 or self.scale_down_load < 0
                or not 0.0 <= self.scale_up_mfu <= 1.0):
            raise DeepSpeedConfigError(
                "serving.router.autoscale thresholds must be >= 0 "
                "(scale_up_mfu in [0, 1])")
        if 0 < self.scale_up_load < self.scale_down_load:
            raise DeepSpeedConfigError(
                f"serving.router.autoscale.scale_down_load "
                f"({self.scale_down_load}) must be <= scale_up_load "
                f"({self.scale_up_load})")
        if self.events_capacity < 1:
            raise DeepSpeedConfigError(
                f"serving.router.autoscale.events_capacity must be >= 1, "
                f"got {self.events_capacity}")

    def check_ported(self) -> None:
        if self.enabled and self.scale_up_mfu > 0:
            raise NotImplementedError(
                "serving.router.autoscale.scale_up_mfu (its signal is the program ledger's serving/mfu "
                "gauges, telemetry.ledger) is not ported to deepspeed_tpu_torch yet")


@dataclass
class DisaggConfig:
    """``serving.router.disagg``: disaggregated prefill/decode pools with a
    KV handoff (not ported yet; parsed and validated as in the JAX
    package, refused when enabled)."""

    enabled: bool = False
    prefill_replicas: int = 1
    decode_replicas: int = 1
    handoff_chunk: int = 64
    kv_compression: str = "none"
    prefill_min_replicas: int = 1
    prefill_max_replicas: int = 4
    decode_min_replicas: int = 1
    decode_max_replicas: int = 4
    prefill_scale_up_queue: int = 4
    prefill_scale_up_backlog: int = 4
    decode_scale_up_occupancy: float = 0.75
    decode_scale_up_step_s: float = 0.0

    def __post_init__(self):
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            raise DeepSpeedConfigError(
                "serving.router.disagg prefill_replicas/decode_replicas "
                "must be >= 1")
        w = self.handoff_chunk
        if w < 8 or w > 128 or (w & (w - 1)) != 0:
            raise DeepSpeedConfigError(
                f"serving.router.disagg.handoff_chunk must be a power of "
                f"two in [8, 128], got {w}")
        if self.kv_compression not in ("none", "int8"):
            raise DeepSpeedConfigError(
                f"serving.router.disagg.kv_compression must be none|int8, "
                f"got {self.kv_compression!r}")
        if self.prefill_min_replicas < 1 or self.decode_min_replicas < 1:
            raise DeepSpeedConfigError(
                "serving.router.disagg per-pool min replicas must be >= 1")
        if (self.prefill_max_replicas < self.prefill_min_replicas
                or self.decode_max_replicas < self.decode_min_replicas):
            raise DeepSpeedConfigError(
                "serving.router.disagg per-pool max replicas must be >= "
                "the pool's min replicas")
        if (self.prefill_scale_up_queue < 0
                or self.prefill_scale_up_backlog < 0
                or self.decode_scale_up_step_s < 0
                or not 0.0 <= self.decode_scale_up_occupancy <= 1.0):
            raise DeepSpeedConfigError(
                "serving.router.disagg scale thresholds must be >= 0 "
                "(decode_scale_up_occupancy in [0, 1])")


@dataclass
class GatewayAuthConfig:
    """``serving.gateway.auth``: bearer-token tenants of the HTTP gateway,
    each a ``TenantConfig`` holding its token's SHA-256 digest."""

    enabled: bool = False
    tenants: dict = field(default_factory=dict)

    def __post_init__(self):
        coerced = {}
        for tid, block in (self.tenants or {}).items():
            if not tid or any(ord(c) < 0x20 or c == "\x7f" for c in tid):
                raise DeepSpeedConfigError(
                    f"serving.gateway.auth.tenants id {tid!r} must be a "
                    f"non-empty string without control characters")
            coerced[tid] = (_build(TenantConfig, block)
                            if isinstance(block, dict) else block)
        self.tenants = coerced
        if self.enabled and not self.tenants:
            raise DeepSpeedConfigError(
                "serving.gateway.auth.enabled requires at least one "
                "entry in serving.gateway.auth.tenants")
        if self.enabled:
            for tid, t in self.tenants.items():
                if not t.token_sha256:
                    raise DeepSpeedConfigError(
                        f"serving.gateway.auth tenant {tid!r} needs a "
                        f"token_sha256 digest when auth is enabled")


@dataclass
class GatewayConfig:
    """``serving.gateway``: the HTTP/SSE front door
    (``launcher/http_gateway.HttpGateway``): bind address, the stream poll
    and write deadlines, ``Retry-After``, the body bound, the shutdown
    grace, the fleet ``/metrics`` refresh cadence and ``auth``."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0
    stream_poll_s: float = 0.05
    write_timeout_s: float = 10.0
    retry_after_s: float = 0.0
    max_body_bytes: int = 1 << 20
    shutdown_grace_s: float = 30.0
    metrics_fleet_refresh_s: float = 0.0
    auth: GatewayAuthConfig = field(default_factory=GatewayAuthConfig)

    def __post_init__(self):
        if isinstance(self.auth, dict):
            self.auth = _build(GatewayAuthConfig, self.auth)
        if not 0 <= self.port <= 65535:
            raise DeepSpeedConfigError(
                f"serving.gateway.port must be in [0, 65535], got {self.port}")
        if self.stream_poll_s <= 0:
            raise DeepSpeedConfigError(
                f"serving.gateway.stream_poll_s must be > 0, "
                f"got {self.stream_poll_s}")
        if self.write_timeout_s < 0 or self.retry_after_s < 0 \
                or self.shutdown_grace_s < 0 \
                or self.metrics_fleet_refresh_s < 0:
            raise DeepSpeedConfigError(
                "serving.gateway write_timeout_s/retry_after_s/"
                "shutdown_grace_s/metrics_fleet_refresh_s must be >= 0")
        if self.max_body_bytes < 1:
            raise DeepSpeedConfigError(
                f"serving.gateway.max_body_bytes must be >= 1, "
                f"got {self.max_body_bytes}")


@dataclass
class RouterConfig:
    """``serving.router``: ``replicas`` ``ServingEngine``s behind one
    ``Router``; ``affinity`` routes a prompt to the replica whose prefix
    trie holds its longest match; ``max_queue_len`` bounds arrived,
    unadmitted requests across the fleet (0 = none); and the ``health``,
    ``transport``, ``autoscale`` and ``journal`` sub-blocks above.
    ``disagg`` parses and is refused when enabled (``check_ported``)."""

    replicas: int = 1
    affinity: bool = True
    max_queue_len: int = 0
    health: RouterHealthConfig = field(default_factory=RouterHealthConfig)
    transport: RouterTransportConfig = field(
        default_factory=RouterTransportConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    disagg: DisaggConfig = field(default_factory=DisaggConfig)
    journal: JournalConfig = field(default_factory=JournalConfig)

    def __post_init__(self):
        if isinstance(self.health, dict):
            self.health = _build(RouterHealthConfig, self.health)
        if isinstance(self.transport, dict):
            self.transport = _build(RouterTransportConfig, self.transport)
        if isinstance(self.autoscale, dict):
            self.autoscale = _build(AutoscaleConfig, self.autoscale)
        if isinstance(self.disagg, dict):
            self.disagg = _build(DisaggConfig, self.disagg)
        if isinstance(self.journal, dict):
            self.journal = _build(JournalConfig, self.journal)
        if self.replicas < 1:
            raise DeepSpeedConfigError(
                f"serving.router.replicas must be >= 1, got {self.replicas}")
        if self.max_queue_len < 0:
            raise DeepSpeedConfigError(
                f"serving.router.max_queue_len must be >= 0, "
                f"got {self.max_queue_len}")

    def check_ported(self) -> None:
        self.autoscale.check_ported()
        if self.disagg.enabled:
            raise NotImplementedError(
                "serving.router.disagg (disaggregated prefill/decode pools with a KV handoff, and their "
                "per-pool autoscaling) is not ported to deepspeed_tpu_torch yet")


# ---------------------------------------------------------------------------
# The training engine's resilience, monitor and telemetry blocks (the JAX
# package's dataclasses, with their defaults and validation errors)
# ---------------------------------------------------------------------------

@dataclass
class PreemptionConfig:
    """``resilience.preemption``: ``enabled`` installs handlers for
    ``signals`` at engine init; the flag they set is consumed at the next
    step boundary, where the engine takes a just-in-time atomic checkpoint
    under ``save_dir``/``tag`` (none without ``save_dir``: the caller
    saves) and raises ``PreemptionSignal``."""

    enabled: bool = False
    save_dir: str = ""
    tag: str = "preempt"
    signals: list = field(default_factory=lambda: ["SIGTERM", "SIGINT"])

    def __post_init__(self):
        if not self.tag or "/" in self.tag:
            raise DeepSpeedConfigError(
                f"resilience.preemption.tag must be a plain tag name, got "
                f"{self.tag!r}")
        for name in self.signals:
            if not isinstance(name, str) or not name.startswith("SIG"):
                raise DeepSpeedConfigError(
                    f"resilience.preemption.signals entries must be signal "
                    f"names like 'SIGTERM', got {name!r}")
            if not hasattr(_signal, name):
                raise DeepSpeedConfigError(
                    f"resilience.preemption.signals: unknown signal {name!r}")
            if name in ("SIGKILL", "SIGSTOP"):
                raise DeepSpeedConfigError(
                    f"resilience.preemption.signals: {name} cannot be "
                    "caught; a handler can never run for it")


@dataclass
class RetryConfig:
    """``resilience.retry``: ``max_attempts`` tries of a synchronous
    checkpoint save; delays ``base_delay_s * 2**(attempt-1)`` capped at
    ``max_delay_s``, spread by +/- ``jitter`` with a seeded draw."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise DeepSpeedConfigError(
                f"resilience.retry.max_attempts must be >= 1, got "
                f"{self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise DeepSpeedConfigError("resilience.retry delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise DeepSpeedConfigError(
                f"resilience.retry.jitter must be in [0, 1], got {self.jitter}")


@dataclass
class ChaosConfig:
    """``resilience.chaos``: the fleet's seeded fault-schedule search. It
    parses, so one config serves both packages; the port has no search to
    run until the fleet is ported."""

    n_schedules: int = 64
    seed: int = 0
    max_faults: int = 4
    artifact_dir: str = "chaos-repros"
    shrink: bool = True

    def __post_init__(self):
        if self.n_schedules < 1:
            raise DeepSpeedConfigError(
                f"resilience.chaos.n_schedules must be >= 1, got "
                f"{self.n_schedules}")
        if self.max_faults < 1:
            raise DeepSpeedConfigError(
                f"resilience.chaos.max_faults must be >= 1, got "
                f"{self.max_faults}")
        if not self.artifact_dir:
            raise DeepSpeedConfigError(
                "resilience.chaos.artifact_dir must be a non-empty path")


@dataclass
class ResilienceConfig:
    """The ``resilience`` block. ``enabled`` arms the host-side NaN
    guardrail: one fetch of the step's overflow flag per step (the step
    itself always skips a non-finite update on the device), skip ->
    rewind to the last good checkpoint after ``max_consecutive_bad_steps``
    -> ``TrainingDivergedError`` with no rewind target; it also wraps
    synchronous saves in ``retry``. ``preemption`` and ``fault_injection``
    work without it."""

    enabled: bool = False
    max_consecutive_bad_steps: int = 3
    rewind: bool = True
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    fault_injection: FaultInjectionConfig = field(default_factory=FaultInjectionConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def __post_init__(self):
        if isinstance(self.preemption, dict):
            self.preemption = _build(PreemptionConfig, self.preemption)
        if isinstance(self.retry, dict):
            self.retry = _build(RetryConfig, self.retry)
        if isinstance(self.fault_injection, dict):
            self.fault_injection = _build(FaultInjectionConfig, self.fault_injection)
        if isinstance(self.chaos, dict):
            self.chaos = _build(ChaosConfig, self.chaos)
        if self.max_consecutive_bad_steps < 1:
            raise DeepSpeedConfigError(
                "resilience.max_consecutive_bad_steps must be >= 1, got "
                f"{self.max_consecutive_bad_steps}")


@dataclass
class MonitorBackendConfig:
    """``csv_monitor`` (and the refused ``tensorboard``/``wandb``): one CSV
    per tag under ``output_path``/``job_name`` (``monitor/monitor.py``)."""

    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"
    team: str = ""
    group: str = ""
    project: str = "deepspeed"


@dataclass
class LedgerConfig:
    """``telemetry.ledger``: the JAX package's program ledger, on there by
    default. The port has none, so a ``telemetry`` block must turn it off;
    ``hbm_warn_fraction`` sets the HBM-pool section's warning."""

    enabled: bool = True
    hbm_warn_fraction: float = 0.9
    collectives: dict = field(default_factory=dict)

    def __post_init__(self):
        if not (0.0 < self.hbm_warn_fraction <= 1.0):
            raise DeepSpeedConfigError(
                f"telemetry.ledger.hbm_warn_fraction must be in (0, 1], "
                f"got {self.hbm_warn_fraction}")


@dataclass
class TelemetryConfig:
    """The training fields of ``telemetry``. The registry (the step-time
    histogram, the ``train/*`` and ``resilience/*`` metrics) always runs;
    ``enabled`` turns on the exporters: the JSONL sink at ``jsonl_path``
    (rotated at ``jsonl_max_bytes``, ``jsonl_keep`` files kept) and, with
    ``monitor_bridge`` and a monitor on, the registry pushed into the
    monitor at each print boundary. ``device_sync_spans`` makes the step
    span wait for the step's loss. ``request_trace`` belongs to serving.
    The ledger and the flight-recorder blocks (``timeseries``, ``slo``,
    ``incidents``) are not ported and raise when on."""

    enabled: bool = False
    jsonl_path: str = ""
    jsonl_max_bytes: int = 0
    jsonl_keep: int = 3
    watchdog: str = "warn"
    device_sync_spans: bool = False
    monitor_bridge: bool = True
    ledger: LedgerConfig = field(default_factory=LedgerConfig)
    request_trace: RequestTraceConfig = field(default_factory=RequestTraceConfig)
    timeseries: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)
    incidents: dict = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.ledger, dict):
            self.ledger = _build(LedgerConfig, self.ledger)
        if isinstance(self.request_trace, dict):
            self.request_trace = _build(RequestTraceConfig, self.request_trace)
        if self.watchdog not in ("off", "warn", "raise"):
            raise DeepSpeedConfigError(
                f"telemetry.watchdog must be off|warn|raise, got {self.watchdog!r}")
        if self.jsonl_max_bytes < 0:
            raise DeepSpeedConfigError(
                f"telemetry.jsonl_max_bytes must be >= 0, "
                f"got {self.jsonl_max_bytes}")
        if self.jsonl_keep < 1:
            raise DeepSpeedConfigError(
                f"telemetry.jsonl_keep must be >= 1, got {self.jsonl_keep}")

    def check_ported(self) -> None:
        """The program ledger (default on), its collective X-ray and the
        flight-recorder blocks raise, naming themselves."""
        if self.ledger.enabled:
            raise NotImplementedError(
                "telemetry.ledger (the program ledger, on by default) is not ported to deepspeed_tpu_torch "
                "yet; pass {'ledger': {'enabled': False}} in the telemetry block")
        if self.ledger.collectives.get("enabled", False):
            raise NotImplementedError("telemetry.ledger.collectives is not ported to deepspeed_tpu_torch yet")
        for name in ("timeseries", "slo", "incidents"):
            if getattr(self, name).get("enabled", False):
                raise NotImplementedError(f"telemetry.{name} is not ported to deepspeed_tpu_torch yet")


# Blocks whose ``enabled`` flag selects a path the port does not have yet,
# and top-level flags that do so when true.
_UNPORTED_BLOCKS = (C.FLOPS_PROFILER, "eigenvalue", C.ELASTICITY, C.MONITOR_TENSORBOARD, C.MONITOR_WANDB,
                    C.COMMS_LOGGER)
_UNPORTED_FLAGS = (C.WALL_CLOCK_BREAKDOWN, C.MEMORY_BREAKDOWN, C.DUMP_STATE)


@dataclass
class DeepSpeedConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = C.STEPS_PER_PRINT_DEFAULT
    seed: int = C.SEED_DEFAULT
    gradient_clipping: float = C.GRADIENT_CLIPPING_DEFAULT
    dataloader_drop_last: bool = False

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
    curriculum_learning: CurriculumConfig = field(default_factory=CurriculumConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    csv_monitor: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

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
            dataloader_drop_last=d.get(C.DATALOADER_DROP_LAST, False),
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
            curriculum_learning=_build(CurriculumConfig, _sub(d, C.CURRICULUM_LEARNING)),
            sparse_attention=(_build(SparseAttentionConfig, d[C.SPARSE_ATTENTION])
                              if d.get(C.SPARSE_ATTENTION) else None),
            resilience=_build(ResilienceConfig, _sub(d, C.RESILIENCE)),
            csv_monitor=_build(MonitorBackendConfig, _sub(d, C.MONITOR_CSV)),
            telemetry=_build(TelemetryConfig, _sub(d, C.TELEMETRY)),
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
        if C.TELEMETRY in self.raw:  # the JAX defaults hold a ledger the port has not got
            self.telemetry.check_ported()
        if self.checkpoint.engine not in (None, "native"):
            raise NotImplementedError(f"checkpoint.engine {self.checkpoint.engine!r} is not ported to "
                                      "deepspeed_tpu_torch (native only)")
        for block in _UNPORTED_BLOCKS:
            sub = _sub(self.raw, block)
            if sub.get("enabled", False):
                raise NotImplementedError(f"config block {block!r} is not ported to deepspeed_tpu_torch yet")
        for flag in _UNPORTED_FLAGS:
            if self.raw.get(flag, False):
                raise NotImplementedError(f"config flag {flag!r} is not ported to deepspeed_tpu_torch yet")
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
