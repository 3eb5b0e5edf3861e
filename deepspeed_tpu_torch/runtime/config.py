"""The training subset of ``DeepSpeedConfig``, ported from
``deepspeed_tpu/runtime/config.py``.

One DeepSpeed JSON dict drives both packages: the batch triangulation
(train = micro × gas × data-parallel world), ``fp16``/``bf16``, ``zero_optimization``,
``optimizer``, ``scheduler``, clipping, seed and ``steps_per_print`` parse
the same way, as do ``activation_checkpointing``, ``checkpoint``,
``sparse_attention`` (turned into the model's ``attn_impl="sparse"`` by the
engine), ``curriculum_learning`` and ``dataloader_drop_last``. The port
runs data- and tensor-parallel over ``torch.distributed``: the ``mesh``
block's ``data``, ``fsdp`` and ``model`` axes take the world (their
product, -1 the remainder), the batch is triangulated at the data-parallel
world (``data`` x ``fsdp``), and under a ``model`` axis above 1 the memory
tiers and ``sparse_attention`` are refused by name
(``_validate_tensor_parallel``); a ``pipe`` axis above 1 runs only under
``pipe.PipelineEngine`` (``from_dict(..., pipelined=True)``, which refuses
what the pipeline does not run: ``_validate_pipeline``) and a plain engine
refuses it by name, as it refuses a ``context`` axis above 1.
``comms_logger``, ``sparse_gradients`` and the ``zero_optimization`` bucket
sizes and ``overlap_comm`` parse as in JAX. ``resilience`` (the NaN guardrail, preemption, checkpoint-save
retries and the training fault sites), ``csv_monitor``, the training
fields of ``telemetry`` with its program ``ledger`` (on by default, as in
JAX), ``flops_profiler``, the ``wall_clock_breakdown`` and
``memory_breakdown`` flags and ``checkpoint.async_save`` parse as in the
JAX package, the ledger's ``collectives`` included. Blocks that belong
to paths not ported yet raise ``NotImplementedError`` when enabled, naming
the block: among them ``tensorboard``, ``wandb``, ``eigenvalue``, the flag
``dump_state``, which the port would otherwise accept and ignore, and the
telemetry block's flight-recorder blocks. ZeRO stages 0-3 shard over the
mesh's ``data`` and ``fsdp`` axes (``runtime/zero/``). The memory tiers parse as in the JAX package
(``zero_optimization.offload_optimizer``/``offload_param`` with
``nvme_path``, ``sub_group_size``, the ``aio`` block, and
``activation_checkpointing.cpu_checkpointing``), and their invalid
combinations raise what the JAX engine raises (``_validate_offload``); at
a data-parallel world above 1 the NVMe tier and ``offload_param`` below
stage 3 are refused by name (not ported yet).
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def _default_nvme_path() -> str:
    import tempfile

    return os.path.join(tempfile.gettempdir(), "dstpu_nvme")


@dataclass
class OffloadConfig:
    """A ZeRO offload sub-block (reference runtime/zero/offload_config.py).
    ``pin_memory``, ``buffer_count`` and ``fast_init`` are accepted as in the
    JAX package: host buffers that a card copies are always pinned, and the
    NVMe tier double-buffers its groups."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: str = field(default_factory=_default_nvme_path)
    pin_memory: bool = True
    buffer_count: int = 4
    fast_init: bool = False


@dataclass
class ZeroConfig:
    """The JAX ``ZeroConfig`` (reference runtime/zero/config.py:77). The
    stage selects the sharding rules (``parallel/sharding.py``);
    ``reduce_bucket_size`` and ``allgather_bucket_size`` (bytes) size the
    ZeRO runtime's buckets. ``overlap_comm`` is parsed and ignored, as in
    JAX (where XLA schedules the collectives): the port's run in program
    order. The rest is accepted for config compatibility."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 5e8
    allgather_partitions: bool = True
    allgather_bucket_size: int = 5e8
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    offload_param: OffloadConfig = field(default_factory=OffloadConfig)
    offload_optimizer: OffloadConfig = field(default_factory=OffloadConfig)
    sub_group_size: int = 1e9  # bytes of fp32 master per NVMe swap group
    prefetch_bucket_size: int = 5e7
    param_persistence_threshold: int = 1e5
    max_live_parameters: int = 1e9
    max_reuse_distance: int = 1e9
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    zero_quantized_weights: bool = False

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
class AioConfig:
    """The ``aio`` block (reference runtime/swap_tensor/aio_config.py):
    ``thread_count`` sizes the NVMe tier's I/O pool; the rest is accepted
    as in the JAX package."""

    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


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
class TimeSeriesConfig:
    """Flight-recorder ring sub-block (``telemetry.timeseries``, mirrored as
    ``serving.timeseries``; ``telemetry/timeseries.py``,
    docs/observability.md "Flight recorder & SLOs").

    - ``enabled``: sample the configured metric set into bounded
      downsampling rings from the owning step/serve loop. Forced on when
      ``slo`` or ``incidents`` is enabled (both read the rings).
    - ``interval_s``: raw sampling/bucket interval on the fleet clock.
    - ``tiers``: coarser bucket intervals (seconds) rebuilt alongside raw;
      intervals <= ``interval_s`` are dropped.
    - ``capacity``: cells kept PER TIER per series (fixed deques — memory
      is O(series x tiers x capacity) regardless of run length).
    - ``flush_capacity``: closed-raw-cell journal bound for the step-reply
      piggyback flush (seq-cursor; cells evicted before a flush are lost).
    """

    enabled: bool = False
    interval_s: float = 0.25
    tiers: list = field(default_factory=lambda: [1.0, 10.0, 60.0])
    capacity: int = 240
    flush_capacity: int = 4096

    def __post_init__(self):
        if self.interval_s <= 0:
            raise DeepSpeedConfigError(
                f"telemetry.timeseries.interval_s must be > 0, "
                f"got {self.interval_s}")
        if self.capacity < 2:
            raise DeepSpeedConfigError(
                f"telemetry.timeseries.capacity must be >= 2, "
                f"got {self.capacity}")
        if self.flush_capacity < 1:
            raise DeepSpeedConfigError(
                f"telemetry.timeseries.flush_capacity must be >= 1, "
                f"got {self.flush_capacity}")


@dataclass
class SLOConfig:
    """SLO objective sub-block (``telemetry.slo``, mirrored as
    ``serving.slo``; ``telemetry/slo.py``, docs/observability.md).

    - ``enabled``: classify terminals + evaluate attainment/burn on the
      rings, publishing the ``slo/*`` gauges.
    - ``ttft_s`` / ``tpot_s``: per-request latency objectives (seconds);
      a finished request exceeding one counts as that dimension's
      violation. 0 disables the dimension's classification.
    - ``ttft_target`` / ``tpot_target`` / ``availability_target``: the SLO
      targets in (0, 1] — the error budget is ``1 - target``.
    - ``window_s``: rolling attainment window on the fleet clock.
    - ``fast_window_s`` / ``slow_window_s``: the multi-window burn-rate
      pair (5m/1h analogues, scaled so drills can use second-scale
      windows).
    - ``fast_burn_threshold``: fast-window burn at/over which the verdict
      is a breach (14.4 = the classic "30-day budget gone in ~2 days"
      page threshold) — an incident trigger on the rising edge.
    - ``eval_interval_s``: how often the Router re-evaluates.
    """

    enabled: bool = False
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    ttft_target: float = 0.99
    tpot_target: float = 0.99
    availability_target: float = 0.999
    window_s: float = 300.0
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn_threshold: float = 14.4
    eval_interval_s: float = 1.0

    def __post_init__(self):
        for name in ("ttft_target", "tpot_target", "availability_target"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise DeepSpeedConfigError(
                    f"telemetry.slo.{name} must be in (0, 1], got {v}")
        if self.ttft_s < 0 or self.tpot_s < 0:
            raise DeepSpeedConfigError(
                "telemetry.slo.ttft_s/tpot_s must be >= 0")
        for name in ("window_s", "fast_window_s", "slow_window_s",
                     "eval_interval_s"):
            if getattr(self, name) <= 0:
                raise DeepSpeedConfigError(
                    f"telemetry.slo.{name} must be > 0, "
                    f"got {getattr(self, name)}")
        if self.fast_burn_threshold <= 0:
            raise DeepSpeedConfigError(
                f"telemetry.slo.fast_burn_threshold must be > 0, "
                f"got {self.fast_burn_threshold}")


@dataclass
class IncidentConfig:
    """Incident-recorder sub-block (``telemetry.incidents``, mirrored as
    ``serving.incidents``; ``telemetry/incident.py``, docs/observability.md).

    - ``enabled``: stage/finalize durable incident bundles on the typed
      trigger matrix. Requires ``dir``.
    - ``dir``: bundle directory (the Router writes here; each replica's
      engine writes under ``<dir>/replica<rid>/``).
    - ``max_bundles``: bundle count bound per directory; oldest are
      LRU-pruned past it (storage stays O(configured capacity)).
    - ``window_before_s`` / ``window_after_s``: ring/trace capture window
      around the trigger; finalization waits ``window_after_s`` of fleet
      time so the aftermath is in the bundle too.
    """

    enabled: bool = False
    dir: str = ""
    max_bundles: int = 32
    window_before_s: float = 30.0
    window_after_s: float = 2.0

    def __post_init__(self):
        if self.enabled and not self.dir:
            raise DeepSpeedConfigError(
                "telemetry.incidents.enabled requires telemetry.incidents.dir")
        if self.max_bundles < 1:
            raise DeepSpeedConfigError(
                f"telemetry.incidents.max_bundles must be >= 1, "
                f"got {self.max_bundles}")
        if self.window_before_s < 0 or self.window_after_s < 0:
            raise DeepSpeedConfigError(
                "telemetry.incidents window_before_s/window_after_s "
                "must be >= 0")


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
# their defaults and validation errors.
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
    JAX package. ``scale_up_mfu`` reads the replicas' ``serving/mfu``
    gauges, which the program ledger publishes."""

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


@dataclass
class DisaggConfig:
    """``serving.router.disagg``: disaggregated prefill/decode pools with a
    KV handoff ``handoff_chunk`` tokens a window (``kv_compression``
    ``int8`` quantizes each window on the wire), and per-pool autoscaling
    envelopes and thresholds, as in the JAX package."""

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
    ``disagg`` splits the fleet into prefill and decode pools."""

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
    """``resilience.chaos``: the fleet's seeded fault-schedule search, run
    by ``resilience/chaos.py`` (``search``; ``python -m
    deepspeed_tpu_torch.resilience.chaos --search N``)."""

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
class CollectiveLedgerConfig:
    """``telemetry.ledger.collectives`` (``telemetry/collective_ledger.py``):
    record the collectives ``comm/`` issues during each watched program's
    first call, for the step anatomy and the comms-logger reconcile view.
    ``ici_gbps`` rates the link for the modeled comm times (0: the
    platform's rating, which no link of the port has: the times stay
    labeled nulls)."""

    enabled: bool = True
    ici_gbps: float = 0.0

    def __post_init__(self):
        if self.ici_gbps < 0:
            raise DeepSpeedConfigError(
                f"telemetry.ledger.collectives.ici_gbps must be >= 0, "
                f"got {self.ici_gbps}")


@dataclass
class LedgerConfig:
    """``telemetry.ledger`` (and the serving block's ``ledger``): the
    program ledger, on by default as in JAX (``telemetry/program_ledger.py``).
    ``hbm_warn_fraction`` sets the HBM-pool section's warning;
    ``collectives`` is the collective ledger's block."""

    enabled: bool = True
    hbm_warn_fraction: float = 0.9
    collectives: CollectiveLedgerConfig = field(default_factory=CollectiveLedgerConfig)

    def __post_init__(self):
        if isinstance(self.collectives, dict):
            self.collectives = _build(CollectiveLedgerConfig, self.collectives)
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
    span wait for the step's loss. ``ledger`` is the program ledger over
    ``train/train_step``. ``request_trace`` belongs to serving. The
    flight-recorder blocks (``timeseries``, ``slo``, ``incidents``: the JAX
    training engine reads none of them; serving has its own) raise when on."""

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
        """The flight-recorder blocks raise, naming themselves."""
        for name in ("timeseries", "slo", "incidents"):
            if getattr(self, name).get("enabled", False):
                raise NotImplementedError(f"telemetry.{name} is not ported to deepspeed_tpu_torch yet")


@dataclass
class ElasticityConfig:
    """The ``elasticity`` block (DeepSpeed's ``elasticity/config.py``):
    ``elasticity.compute_elastic_config`` solves it, the engine enforces
    the solution at its world size, and ``DSElasticAgent`` relaunches
    workers on it."""

    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: list = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.1
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True
    model_parallel_size: int = 1
    num_gpus_per_node: int = 1


@dataclass
class FlopsProfilerConfig:
    """``flops_profiler``: at step ``profile_step`` the engine profiles one
    micro-batch's loss and prints it (``profiling/flops_profiler``)."""

    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


# Blocks whose ``enabled`` flag selects a path the port does not have yet,
# and top-level flags that do so when true.
_UNPORTED_BLOCKS = ("eigenvalue", C.MONITOR_TENSORBOARD, C.MONITOR_WANDB)

# the mesh axes of the paths not ported yet, refused above 1 by name
_UNPORTED_AXES = {"context": "context parallelism (ring/Ulysses attention)"}


@dataclass
class CommsLoggerConfig:
    """``comms_logger``: record every collective ``comm/`` issues
    (``comm/logger.py``)."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
_UNPORTED_FLAGS = (C.DUMP_STATE,)


@dataclass
class DeepSpeedConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = C.STEPS_PER_PRINT_DEFAULT
    seed: int = C.SEED_DEFAULT
    gradient_clipping: float = C.GRADIENT_CLIPPING_DEFAULT
    sparse_gradients: bool = False
    dataloader_drop_last: bool = False
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False

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
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    aio: AioConfig = field(default_factory=AioConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)

    raw: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_file(cls, path: str, world_size: int = 1, pipelined: bool = False) -> "DeepSpeedConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f), world_size=world_size, pipelined=pipelined)

    @classmethod
    def from_dict(cls, d: dict, world_size: int = 1, pipelined: bool = False) -> "DeepSpeedConfig":
        """``pipelined``: the config of a ``pipe.PipelineEngine`` (a
        pipelined model), which may lay a ``pipe`` axis above 1."""
        cfg = cls(
            train_batch_size=d.get(C.TRAIN_BATCH_SIZE),
            train_micro_batch_size_per_gpu=d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU),
            gradient_accumulation_steps=d.get(C.GRADIENT_ACCUMULATION_STEPS),
            steps_per_print=d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT),
            seed=int(d.get(C.SEED, C.SEED_DEFAULT)),
            gradient_clipping=d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT),
            sparse_gradients=d.get(C.SPARSE_GRADIENTS, False),
            dataloader_drop_last=d.get(C.DATALOADER_DROP_LAST, False),
            wall_clock_breakdown=d.get(C.WALL_CLOCK_BREAKDOWN, False),
            memory_breakdown=d.get(C.MEMORY_BREAKDOWN, False),
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
            comms_logger=_build(CommsLoggerConfig, _sub(d, C.COMMS_LOGGER)),
            telemetry=_build(TelemetryConfig, _sub(d, C.TELEMETRY)),
            elasticity=_build(ElasticityConfig, _sub(d, C.ELASTICITY)),
            aio=_build(AioConfig, _sub(d, C.AIO)),
            flops_profiler=_build(FlopsProfilerConfig, _sub(d, C.FLOPS_PROFILER)),
            raw=d,
        )
        cfg._triangulate_batch(world_size)
        cfg._validate(world_size, pipelined)
        return cfg

    def _triangulate_batch(self, world_size: int) -> None:
        """train = micro × gas × the data-parallel world (``data`` x
        ``fsdp``: the ranks of one ``model`` line take the same rows)."""
        train, micro, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        ws = max(world_size, 1)
        try:
            sizes = self.dp_mesh_sizes(ws)
        except ValueError as e:
            raise DeepSpeedConfigError(f"mesh {dataclasses.asdict(self.mesh)} over a world of {ws}: {e}") from e
        ws = sizes["data"] * sizes["fsdp"]
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

    def dp_mesh_sizes(self, world: int) -> dict:
        """The ``mesh`` block's axis sizes over a world of ``world`` ranks
        (``comm.MeshConfig.sizes``: -1 takes the remainder)."""
        from ..comm.mesh import MeshConfig

        m = self.mesh
        return MeshConfig(pipe=m.pipe, data=m.data, fsdp=m.fsdp, context=m.context, model=m.model).sizes(world)

    def _validate(self, world_size: int = 1, pipelined: bool = False) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if pipelined:
            self._validate_pipeline()
        self._validate_offload()
        self._validate_tensor_parallel()
        z = self.zero_optimization
        if world_size > 1 and "nvme" in (z.offload_optimizer.device, z.offload_param.device):
            raise NotImplementedError(
                f"the NVMe tier at a data-parallel world of {world_size} is not ported to deepspeed_tpu_torch yet "
                "(the cpu tier is: each rank's shards in host memory)")
        if world_size > 1 and z.offload_param.device != "none" and z.stage != 3:
            raise NotImplementedError(
                f"offload_param at ZeRO stage {z.stage} and a data-parallel world of {world_size} is not ported to "
                "deepspeed_tpu_torch yet (at stage 3 it is: each rank streams its host shards)")
        if self.optimizer.type.lower() in ONEBIT:
            raise NotImplementedError(
                f"optimizer {self.optimizer.type!r} (the 1-bit family) is not ported to "
                "deepspeed_tpu_torch yet")
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
        for axis, what in _UNPORTED_AXES.items():
            size = getattr(self.mesh, axis)
            if size > 1:
                raise NotImplementedError(f"mesh axis {axis!r}={size}: {what} is not ported to "
                                          "deepspeed_tpu_torch yet (data and fsdp are)")
        if self.mesh.pipe > 1 and not pipelined:
            raise NotImplementedError(f"mesh axis 'pipe'={self.mesh.pipe}: pipeline parallelism runs through "
                                      "deepspeed_tpu_torch.pipe.PipelineEngine with a pipelined model "
                                      "(PipelinedTransformer); a plain DeepSpeedEngine refuses it")

    def _validate_pipeline(self) -> None:
        """What a pipelined engine does not run, refused by name: JAX's
        ``offload_param`` refusal (``deepspeed_tpu/runtime/engine.py:375``,
        its message), and, not ported under the pipeline yet, the other
        memory tiers and ZeRO stage 3."""
        z = self.zero_optimization
        if z.offload_param.device != "none":
            raise NotImplementedError(
                "offload_param under pipeline parallelism is not wired up "
                "(the pipelined loss path does not stream params); use the "
                "plain model family or drop offload_param")
        ac = self.activation_checkpointing
        if z.offload_optimizer.device != "none" or (ac.enabled and ac.cpu_checkpointing):
            raise NotImplementedError("the memory tiers (offload_optimizer, cpu_checkpointing) under pipeline "
                                      "parallelism are not ported to deepspeed_tpu_torch yet")
        if z.stage == 3:
            raise NotImplementedError("ZeRO stage 3 under pipeline parallelism (a stage's layers gathered inside "
                                      "the schedule) is not ported to deepspeed_tpu_torch yet (stages 0-2 are)")

    def _validate_tensor_parallel(self) -> None:
        """The paths not ported under a ``model`` axis above 1, refused by
        name: the memory tiers (offload_optimizer, offload_param and
        cpu_checkpointing) and block-sparse attention."""
        tp = self.mesh.model
        if tp <= 1:
            return
        z = self.zero_optimization
        for name, dev in (("offload_optimizer", z.offload_optimizer.device),
                          ("offload_param", z.offload_param.device)):
            if dev != "none":
                raise NotImplementedError(f"the memory tiers ({name} {dev!r}) with tensor parallelism (mesh model="
                                          f"{tp}) are not ported to deepspeed_tpu_torch yet")
        ac = self.activation_checkpointing
        if ac.enabled and ac.cpu_checkpointing:
            raise NotImplementedError(f"the memory tiers (activation_checkpointing.cpu_checkpointing) with tensor "
                                      f"parallelism (mesh model={tp}) are not ported to deepspeed_tpu_torch yet")
        if self.sparse_attention is not None:
            raise NotImplementedError(f"sparse_attention with tensor parallelism (mesh model={tp}: block-sparse "
                                      "attention on a rank's H/tp heads) is not ported to deepspeed_tpu_torch yet")

    def _validate_offload(self) -> None:
        """The memory tiers' combinations, refused as the JAX engine refuses
        them (``engine.py:333-389`` and ``:406-411``), with its messages."""
        z = self.zero_optimization
        off_opt, off_param = z.offload_optimizer.device, z.offload_param.device
        for name, dev in (("offload_optimizer", off_opt), ("offload_param", off_param)):
            if dev not in ("none", "cpu", "nvme"):
                raise ValueError(f"{name}.device must be none|cpu|nvme, got {dev!r}")
        if off_opt == "nvme" and self.fp16.enabled:
            raise NotImplementedError(
                "offload_optimizer device 'nvme' with fp16 dynamic loss "
                "scaling is not supported; use bf16")
        if off_param != "none":
            if off_opt == "none":
                raise ValueError(
                    "offload_param requires offload_optimizer device 'cpu' or "
                    "'nvme': with parameters tiered out of HBM, device-resident "
                    "fp32 masters + Adam moments (6x the bf16 param bytes) "
                    "would dwarf the savings")
            if off_param == "nvme" and off_opt != "nvme":
                raise ValueError(
                    "offload_param device 'nvme' pairs with offload_optimizer "
                    "device 'nvme' (fp32 masters+moments on disk; the bf16 "
                    "working set stays in pinned host DRAM, which the device "
                    "streams from — 2 bytes/param of DRAM instead of 16)")
        opt_type = self.optimizer.type.lower()
        if opt_type in ONEBIT and off_opt != "none":
            raise NotImplementedError(f"{opt_type} with offload_optimizer is unsupported")
        if opt_type in ONEBIT and off_param != "none":
            raise NotImplementedError(
                f"{opt_type} with offload_param is unsupported (replicated "
                "momenta live on device)")
        if off_opt == "nvme" and opt_type not in ("adam", "adamw", "fusedadam", "cpuadam"):
            raise NotImplementedError(
                f"nvme offload supports Adam(W) (the reference swaps Adam "
                f"states too), not {opt_type!r}")

    @property
    def offload_tier(self) -> str:
        """Where the optimizer state lives: none | cpu | nvme."""
        return self.zero_optimization.offload_optimizer.device

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
