"""Continuous-batching serving engine (the port of
``deepspeed_tpu/inference/serving.py``): a slot KV cache, ONE decode
program, bucketed prefill, prefix-cache KV reuse, chunked prefill,
speculative decoding, the disaggregated roles' KV handoff and the flight
recorder.

The engine is two machines, as in the JAX package:

  * ``SlotWorker`` owns the device: the slot KV cache
    ``[L, n_slots, Smax, H, Dh]``, the prefix pool, the sampler's
    ``torch.Generator`` and the inventory of programs that touch them, each
    watched by the recompile watchdog (telemetry/watchdog.py).
  * ``ServingEngine`` is pure host scheduling: queues, admission
    (earliest-arrived, or DWRR across tenants), the chunked-prefill state
    machine, prefix lookup and insert, deadlines, queue shedding, NaN
    quarantine and the adaptive speculation caps.

ONE decode program per engine lifetime. The JAX package compiles the
decode step once, over per-slot ``[n_slots]`` arrays (token, position,
write position, active, temperature, top-k, top-p), so admitting a request
with any prompt length or sampling parameters never recompiles. The port's
counterpart of that compiled program is one CUDA graph: ``decode_step``
(``apply_with_cache`` at T = 1 with a vector position, every layer's
attention through the split-KV decode kernel, the per-slot NaN sentinel,
``sample_logits_vector``) is warmed up on a side stream and captured once,
on its first call; each later step copies the host's per-slot arrays into
the graph's static input from a pinned buffer (one host-to-device copy),
replays the graph and reads one packed ``[n_slots, 2]`` int32 output
(token, bad) back (one device-to-host copy). The sampler draws from the
worker's seeded CUDA generator, registered with the graph so that every
replay advances its Philox offset. There is no eager fallback: a capture
or replay that fails raises. On the CPU the same step function runs
eagerly. Everything else (prefill per power-of-two bucket, chunks per
width, verify per power-of-two depth, the prefix copies, the slot fill)
runs eagerly on the engine's device, each still a watched program keyed
by its width or depth.

The graph holds the cache's addresses, so the cache and the prefix pool
are allocated once and only ever written in place (``apply_with_cache``,
``update_cache_slot`` and the copies below all write in place).

Idle and mid-prefill slots still flow through the decode step (static
shapes); they WRITE at position Smax, which the cache write drops, while
attending at position 0, and the host discards their tokens. Repetition
penalty is not supported here (its [n_slots, vocab] carry), as in the JAX
package: use ``InferenceEngine.generate``.

A fleet (``inference/router.Router``) drives the engine through the
scheduler surface below it: ``load``, ``idle``, ``queue_len``,
``live_requests``, ``prefix_match_len``, ``set_epoch`` and
``last_step_compiled``, which exempts a step from the Router's hung
verdict when it compiled a program, captured the decode graph or loaded
a kernel library.

Disaggregated roles (``role="prefill"|"decode"``, as in the JAX engine):
a prefill replica admits and prefills, then PARKS each finished prefill
(``_Handoff``) with its KV and first token resident and never decodes (it
builds no decode program and captures no graph); the Router streams the
slot's KV out window by window (``kv_export_window``: one eager read per
power-of-two width, to the host) into a decode replica's staged slot
(``kv_import_begin`` / ``kv_import_window`` / ``kv_import_commit``). The
import writes IN PLACE into the tensors the decode graph captured
(``copy_`` into the slot's window, like the prefix fetch), so the next
replay decodes from the imported KV.

The flight recorder (``timeseries``, ``slo``, ``incidents``): bounded
rings sampled from ``step()``, flushed over a worker's step reply
(``take_ring_flush``); every terminal classified against the SLO
thresholds (``classify_terminal``); incident bundles per replica under
``<dir>/replica<rid>/`` on a NaN quarantine or a watchdog refusal.

Tensor parallelism (an engine from ``init_inference`` at ``tp_size > 1``):
the JAX engine runs one scheduler that drives every device; here each
rank is a process, so the port splits the engine into a driver and
followers. The driver (model index 0) runs the scheduler, the clock,
admission, deadlines and sampling; its ``SlotWorker`` broadcasts each
device call (``decode``, ``prefill``, ``chunk``, ``verify``,
``prefix_fetch``, ``prefix_store``, ``fill_slot``, ``release``: the method
and its host arguments) over the mesh's ``model`` axis before running it.
A follower runs no scheduler and decides nothing on a clock: its entry
points (``serve``, ``drain``, ``step``, ``warm_decode``, ``warm_verify``,
``close``) run the driver's calls in order (``SlotWorker.follow``) until
the driver's matching entry point sends its closing message with its
result, which every rank then returns. The closing message goes from a
``finally``, so a driver that raises still releases its followers (which
then raise); a follower that hears nothing within the process group's
timeout raises. Followers never sample: the driver's tokens reach them as
the next call's arguments. The slot cache and the prefix pool hold the
rank's heads (``kv_slot_cache_spec`` / ``kv_prefix_pool_spec``). The
decode step runs eagerly under tensor parallelism, a route chosen at
construction (``decode_route`` in ``telemetry_snapshot()``): gloo's
collectives cannot be captured into a CUDA graph. Refused by name under
tensor parallelism: the disaggregated roles and their KV handoff, and the
fleet (``Router``, ``launcher/serving_worker.py``).

The program ledger (``ledger``, on by default as in JAX): each program's
first call at a signature runs under the FLOP and byte counter
(``telemetry/program_ledger.py``). The decode program's first call is its
CUDA graph capture: the warm-up runs uncounted and the capture is counted
once, so the ledger adds no graph, no replay and no launch.
``serving/decode`` reads ``serving/decode_step_sec`` and publishes the
``serving/mfu`` gauge; ``prefill[``, ``chunk_prefill[`` and ``verify[``
read their own latency histograms.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..models import transformer as tfm
from ..ops import op_builder
from ..parallel.sharding import kv_prefix_pool_spec, kv_slot_cache_spec, local_shape
from ..ops.decode_attention import decode_attention
from ..resilience import FaultInjector, RequestRejected, RpcConnectionLost
from ..runtime.config import (ChunkedPrefillConfig, FaultInjectionConfig,
                              IncidentConfig, LedgerConfig, PrefixCacheConfig,
                              RequestTraceConfig, SLOConfig, SpeculationConfig,
                              TenantConfig, TimeSeriesConfig)
from ..telemetry import (IncidentRecorder, RequestTracer, Telemetry,
                         TimeSeriesStore, classify_terminal, cost, hbm_snapshot,
                         tree_bytes)
from ..utils.logging import log_dist
from .engine import InferenceEngine
from .prefix_cache import PrefixIndex
from .sampling import sample_logits_vector, verify_logits_vector
from .speculation import make_drafter


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# consecutive zero-acceptance verify steps before a slot's drafting is
# suppressed outright; each further failed re-probe doubles the wait before
# the next one, capped at 2^_SPEC_PROBE_WAIT_MAX_LOG2 decode steps
_SPEC_SUPPRESS_AFTER = 3
_SPEC_PROBE_WAIT_MAX_LOG2 = 6

# rows of the decode step's packed int32 input [7, n_slots]; temperature
# and top-p travel as their float32 bits
_IN_TOK, _IN_POS, _IN_WPOS, _IN_ACTIVE, _IN_TEMP, _IN_TOPK, _IN_TOPP = range(7)


def pack_decode_inputs(last_tok, pos, wpos, active, temp, top_k, top_p) -> np.ndarray:
    """The host's per-slot arrays -> the decode step's packed int32 input
    [7, n_slots]."""
    out = np.empty((7, len(last_tok)), np.int32)
    out[_IN_TOK] = last_tok
    out[_IN_POS] = pos
    out[_IN_WPOS] = wpos
    out[_IN_ACTIVE] = active
    out[_IN_TEMP] = np.asarray(temp, np.float32).view(np.int32)
    out[_IN_TOPK] = top_k
    out[_IN_TOPP] = np.asarray(top_p, np.float32).view(np.int32)
    return out


@dataclass
class Request:
    """One generation request. ``arrival_time`` is seconds relative to the
    engine epoch (0.0 = already arrived). step() admits once its clock —
    wall time by default, or the caller's ``now`` — has passed it; drain()
    ignores it. ``deadline_s`` (seconds after arrival; 0 = the engine's
    ``default_deadline_s``, which may itself be 0 = none) bounds the
    request's latency: past it a queued request is shed (``expired``) and an
    in-flight one is evicted (``deadline_exceeded``) with what it produced.
    ``priority`` orders a fleet's overload shedding only. ``tenant`` is the
    caller's identity for fair scheduling and quotas: a host-side label
    that never reaches the device."""

    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32
    temperature: float = 0.0  # <= 0 greedy
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    eos_token: Optional[int] = None
    arrival_time: float = 0.0
    deadline_s: float = 0.0
    priority: int = 0
    tenant: str = ""


@dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray  # [n_generated] int32 (includes eos if emitted)
    prompt_len: int
    arrival_time: float
    admitted_time: float = 0.0
    first_token_time: float = 0.0  # TTFT reference point
    finish_time: float = 0.0
    slot: int = -1
    prefix_hit_tokens: int = 0  # prompt tokens reused from the prefix cache
    # ok | deadline_exceeded | cancelled | shed_queue_full | shed_tenant_quota
    # | expired | failed_nan
    status: str = "ok"
    requeues: int = 0  # NaN-quarantine replays this request went through

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def time_per_output_token(self) -> float:
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (n - 1)


@dataclass
class _Slot:
    uid: int = -1
    remaining: int = 0
    eos: int = -1  # -1 = never matches
    result: Optional[RequestResult] = None
    tokens: list = field(default_factory=list)
    prefix_entry: object = None  # acquired PrefixEntry released on finish
    request: Optional[Request] = None  # kept for quarantine requeue/deadline


@dataclass
class _Prefill:
    """A slot mid-admission: prefilling (idx of len(segments) chunks done).
    The slot is occupied (not free) but not yet decoding."""

    req: Request
    slot: int
    prompt: np.ndarray  # [S] int32
    segments: list  # [(start, width, live_len)] covering [prefix_len, S)
    idx: int = 0
    entry: object = None  # PrefixEntry backing the fetched prefix (acquired)
    t_admit: float = 0.0  # epoch-relative admission time


@dataclass
class _Handoff:
    """A prefill-role slot PARKED after admission: the prompt KV and first
    token are resident, but a prefill worker never decodes — the slot waits
    for the Router to stream its KV window into a decode replica
    (``kv_export_window``) and release it (``handoff_release``). Occupied
    (not in ``_free``), never ``_active``."""

    req: Request
    slot: int
    first: int  # the sampled first token (travels with the handoff)
    pos: int  # prompt length: KV resident in [0, pos)
    prefix_hit_tokens: int
    t_admit: float
    t_first: float
    entry: object = None  # acquired PrefixEntry, released on handoff_release


# one warm-up stream per device for every decode graph's capture: cuBLAS
# keeps a workspace for each stream it ran on until the process exits, so a
# stream made per capture would hold one more workspace (32 MiB on Hopper)
# for every replica a fleet ever builds (an autoscaler's, an upgrade's)
_WARMUP_STREAMS: dict = {}


def _warmup_stream(device) -> "torch.cuda.Stream":
    stream = _WARMUP_STREAMS.get(device)
    if stream is None:
        stream = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class SlotWorker:
    """The device half of the serving engine: the slot KV cache, the prefix
    pool, the sampler's generator and the watched programs that touch them.
    Every public method here is one device call whose result the host
    needs, or none; nothing in this class knows about requests, arrival
    times or health."""

    def __init__(self, engine: InferenceEngine, telemetry: Telemetry,
                 n_slots: int, budget: int, seed: int,
                 prefix_cfg: PrefixCacheConfig):
        self.cfg = engine.cfg
        self.params = engine.params
        self.device = engine.device
        self.telemetry = telemetry
        self.n_slots = int(n_slots)
        # tensor parallelism: the driver (model index 0) broadcasts each
        # device call; a follower runs them as they come (``follow``)
        self.tp = getattr(engine, "tp", None)
        self.mesh = getattr(engine, "mesh", None)
        self.lead = self.tp is None or self.tp.index == 0
        self._clock = time.perf_counter if self.lead else (lambda: 0.0)  # a follower reads no clock
        # the decode step: one CUDA graph on a card, eager on the CPU and
        # under tensor parallelism (gloo's collectives cannot be captured)
        self.decode_route = "graph" if self.device.type == "cuda" and self.tp is None else "eager"
        # only the cache ALLOCATION rounds up to a multiple of 128, as the
        # JAX package's decode kernel needs; admission stays at the model's
        # limit, so those tail positions are never admitted into
        self.Smax = -(-int(budget) // 128) * 128
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.spec = kv_slot_cache_spec(self._mesh_shape(), self.n_slots, self.cfg.num_heads)
        self._cache = self._kv(self.spec, self.n_slots, self.Smax)
        self.pmax = 0
        self._pool = None
        if prefix_cfg.enabled:
            self.pmax = int(prefix_cfg.max_prefix_len) or self.Smax
            if self.pmax > self.Smax:
                raise ValueError(
                    f"prefix_cache.max_prefix_len ({self.pmax}) exceeds the "
                    f"slot cache length {self.Smax}")
            self.pool_spec = kv_prefix_pool_spec(self._mesh_shape(), prefix_cfg.n_slots, self.cfg.num_heads)
            self._pool = self._kv(self.pool_spec, prefix_cfg.n_slots, self.pmax)

        self._decode = None  # the watched decode program, made at first use
        self._graph = None  # its CUDA graph (CUDA only), captured at first use
        self._prefills: dict[int, object] = {}  # bucket -> watched prefill
        self._chunk_progs: dict[int, object] = {}  # width -> watched chunk
        self._verifies: dict[tuple[int, bool], object] = {}  # (depth, greedy_only)
        self._fetch = None
        self._store = None
        self._fill = None
        # the disaggregated handoff's KV wire programs: width -> watched
        # window read / write (one per power-of-two width, as the chunks)
        self._kv_exports: dict[int, object] = {}
        self._kv_imports: dict[int, object] = {}
        self._decode_steps = 0
        # decode-kernel launches recorded into the graph per replay (split,
        # combine): the wrappers' counters advance only while capturing
        self.graph_launches = (0, 0)
        # the graph's replays on traffic (a warm-up's is not counted)
        self.graph_replays = 0
        # decode-kernel launches of the eager route (split, combine),
        # counted by the wrappers around each step
        self.eager_launches = [0, 0]
        # True once a program of the current scheduler step ran for the
        # first time at its signature (the decode graph's capture included):
        # the Router's hung verdict exempts such a step
        self.step_compiled = False

    def _mesh_shape(self) -> dict:
        return {} if self.mesh is None else self.mesh.shape

    def _kv(self, spec, slots: int, length: int) -> dict:
        """A KV cache [L, slots, length, H, Dh]: this rank's part under
        ``spec`` (its heads when ``model`` splits them)."""
        full = (self.cfg.num_layers, slots, length, self.cfg.num_heads, self.cfg.head_dim)
        L, b, s, h, dh = local_shape(full, spec, self._mesh_shape())
        if b != slots:
            raise NotImplementedError("the slot cache split over the data axes (data-parallel serving) "
                                      "is not ported to deepspeed_tpu_torch yet")
        return tfm.init_cache(self.cfg, slots, length, dtype=self.cfg.dtype, device=self.device, heads=h)

    # -- tensor parallelism: the driver's calls and the followers' loop -------

    def _tell(self, name: str, *args, **kw) -> None:
        """On the driver under tensor parallelism, broadcast one device call
        (method and host arguments) to the followers before running it."""
        if self.tp is not None and self.lead:
            comm.broadcast_object(("call", name, args, kw), self.tp.axis)

    def done(self, result, failed: bool = False) -> None:
        """The driver's closing message of an entry point: the followers
        return ``result`` (or raise when ``failed``)."""
        if self.tp is not None and self.lead:
            comm.broadcast_object(("done", result, failed), self.tp.axis)

    def follow(self):
        """A follower's loop: run every device call the driver broadcasts, in
        order, until its closing message; return the driver's result. Raises
        when the driver failed, or when no message comes within the process
        group's timeout."""
        if self.lead:
            raise RuntimeError("follow() runs on a tensor-parallel follower, not on the driver")
        while True:
            try:
                msg = comm.broadcast_object(None, self.tp.axis)
            except RuntimeError as e:
                raise RuntimeError(f"tensor-parallel follower (model index {self.tp.index}): no call from the "
                                   f"driver within the process group's timeout, or its group failed: {e}") from e
            if msg[0] == "done":
                _, result, failed = msg
                if failed:
                    raise RuntimeError(f"tensor-parallel follower (model index {self.tp.index}): the driver "
                                       "raised; its closing message ended this entry point")
                return result
            _, name, args, kw = msg
            getattr(self, name)(*args, **kw)

    # -- the decode step --------------------------------------------------

    @torch.no_grad()
    def decode_step(self, inp: torch.Tensor) -> torch.Tensor:
        """THE decode step function: packed int32 inputs [7, n_slots] on the
        engine's device (``pack_decode_inputs``) -> packed int32 [n_slots, 2]
        (next token, non-finite-logits flag). Advances every slot one token
        in the cache; rows with wpos = Smax write nothing. The CUDA graph
        captures exactly this function; tests call it eagerly to hold a
        replay against it."""
        toks, pos, wpos = inp[_IN_TOK], inp[_IN_POS], inp[_IN_WPOS]
        temp, top_p = inp[_IN_TEMP].view(torch.float32), inp[_IN_TOPP].view(torch.float32)
        logits, _ = tfm.apply_with_cache(self.cfg, self.params, toks[:, None].long(),
                                         self._cache, pos, write_pos=wpos)
        logits = logits[:, 0]
        # per-slot NaN sentinel in the same program: the host quarantines a
        # poisoned request and discards its token
        bad = ~torch.isfinite(logits).all(dim=-1)
        if self.lead:
            nxt = sample_logits_vector(logits, self._gen, temp, inp[_IN_TOPK], top_p)
            nxt = torch.where(inp[_IN_ACTIVE] != 0, nxt, 0)
        else:  # a follower never samples: the driver's tokens come with the next call
            nxt = torch.zeros_like(inp[_IN_TOK])
        return torch.stack([nxt, bad.to(torch.int32)], dim=1)

    def _capture(self):
        """Warm the step up on a side stream with every row idle (no write
        lands), then capture it once into a CUDA graph. The warm-up builds
        and loads the decode kernel, so nothing compiles inside the
        capture."""
        n, dev = self.n_slots, self.device
        idle = pack_decode_inputs(np.zeros(n, np.int32), np.zeros(n, np.int32),
                                  np.full(n, self.Smax, np.int32), np.zeros(n, np.int32),
                                  np.zeros(n, np.float32), np.zeros(n, np.int32),
                                  np.ones(n, np.float32))
        self._pin_in = torch.from_numpy(idle).pin_memory()
        self._static_in = self._pin_in.to(dev)
        self._pin_out = torch.empty((n, 2), dtype=torch.int32).pin_memory()
        self._done = torch.cuda.Event()
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), cost.paused():  # the ledger counts the capture alone
            for _ in range(2):
                self.decode_step(self._static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError("this torch cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state); the sampled decode "
                               "step needs it")
        register(self._gen)
        before = (decode_attention.launches, decode_attention.combine_launches)
        # an engine dropped earlier (its worker sits in a reference cycle)
        # must not be collected mid-capture: destroying its graph there
        # invalidates this capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._static_out = self.decode_step(self._static_in)
        finally:
            if collecting:
                gc.enable()
        self.graph_launches = (decode_attention.launches - before[0],
                               decode_attention.combine_launches - before[1])
        self._graph = graph

    def _decode_program(self, packed: np.ndarray) -> np.ndarray:
        if self.decode_route == "eager":
            before = (decode_attention.launches, decode_attention.combine_launches)
            out = self.decode_step(torch.from_numpy(packed).to(self.device)).cpu().numpy()
            self.eager_launches[0] += decode_attention.launches - before[0]
            self.eager_launches[1] += decode_attention.combine_launches - before[1]
            return out
        if self._graph is None:
            self._capture()
        self._pin_in.numpy()[...] = packed
        self._static_in.copy_(self._pin_in, non_blocking=True)
        self._graph.replay()
        self._pin_out.copy_(self._static_out, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return self._pin_out.numpy().copy()

    def decode(self, last_tok, pos, wpos, active, temp, top_k, top_p, warm: bool = False):
        """Advance EVERY slot one token: the compile-stable path (one
        program, one CUDA graph on the card). Returns host ``(next_token,
        bad)`` [n_slots] arrays; the read syncs, so the recorded latency is
        the device's. ``warm=True`` (every slot idle, made to capture)
        records neither a latency nor a decode step nor a replay."""
        self._tell("decode", last_tok, pos, wpos, active, temp, top_k, top_p, warm=warm)
        tm = self.telemetry
        if self._decode is None:
            wd = tm.watchdog
            self._decode = wd.watch(self._decode_program, wd.unique_name("serving/decode"),
                                    stable=True)
        t0 = self._clock()
        out = self._decode(pack_decode_inputs(last_tok, pos, wpos, active, temp, top_k, top_p))
        self.step_compiled |= bool(self._decode.last_call_compiled)
        if warm:
            return out[:, 0], out[:, 1].astype(bool)
        self._decode_steps += 1
        if self._graph is not None:
            self.graph_replays += 1
        # the capturing call is excluded from the latency histogram
        if not self._decode.last_call_compiled:
            tm.histogram("serving/decode_step_sec").observe(self._clock() - t0)
        tm.counter("serving/decode_steps").inc()
        return out[:, 0], out[:, 1].astype(bool)

    def decode_kernel_launches(self) -> tuple[int, int]:
        """(split, combine) decode-kernel launches the decode steps made on
        traffic and warm-ups. The graph route: the launches one replay
        makes, as the wrappers counted them while capturing, times the
        replays (a replay cannot count, so this follows from the capture;
        the profiler's kernel records over replays are what measure it).
        The eager route: the wrappers' counts around each step."""
        return (self.graph_launches[0] * self.graph_replays + self.eager_launches[0],
                self.graph_launches[1] * self.graph_replays + self.eager_launches[1])

    # -- eager programs ---------------------------------------------------

    def _upload(self, *rows) -> torch.Tensor:
        """Host [n] arrays -> one int32 [k, n] tensor on the device (floats
        as their bits): one copy for a call's per-slot operands."""
        packed = np.stack([np.asarray(r, np.float32).view(np.int32) if np.asarray(r).dtype.kind == "f"
                           else np.asarray(r, np.int32) for r in rows])
        return torch.from_numpy(packed).to(self.device)

    def _sample_one(self, logits, temperature, top_k, top_p) -> tuple[int, bool]:
        """First-token sampling of a prefill or chunk: (token, bad) on the
        host, one read. A follower samples nothing and reads nothing."""
        if not self.lead:
            return 0, False
        s = self._upload([temperature], [top_k], [top_p])
        logits = logits[:, 0]
        bad = ~torch.isfinite(logits).all(dim=-1)
        tok = sample_logits_vector(logits, self._gen, s[0].view(torch.float32), s[1],
                                   s[2].view(torch.float32))
        tok, bad = torch.stack([tok, bad.to(torch.int32)], dim=1)[0].tolist()
        return int(tok), bool(bad)

    def _slot_view(self, cache, slot: int, length: int) -> dict:
        """Row ``slot``'s first ``length`` positions as an in-place view."""
        return {kv: cache[kv][:, slot:slot + 1, :length] for kv in ("k", "v")}

    @torch.no_grad()
    def _prefill_program(self, bucket, padded, slot, true_len, temperature, top_k, top_p):
        # the padded tail is causally masked for the live tokens, and decode
        # overwrites its KV as the sequence grows into those positions
        prompt = torch.from_numpy(np.asarray(padded)).to(self.device).long()
        logits, _ = tfm.apply_with_cache(self.cfg, self.params, prompt,
                                         self._slot_view(self._cache, slot, bucket), 0,
                                         last_index=true_len - 1)
        return self._sample_one(logits, temperature, top_k, top_p)

    def prefill(self, bucket: int, padded, slot: int, true_len: int,
                temperature: float, top_k: int, top_p: float):
        """One-shot bucketed prompt prefill into ``slot``, written in place.
        Returns the host ``(first_token, bad)`` pair."""
        self._tell("prefill", bucket, padded, slot, true_len, temperature, top_k, top_p)
        tm = self.telemetry
        if bucket not in self._prefills:
            wd = tm.watchdog
            self._prefills[bucket] = wd.watch(
                self._prefill_program, wd.unique_name(f"serving/prefill[{bucket}]"), stable=True)
        prog = self._prefills[bucket]
        t0 = self._clock()
        out = prog(bucket, padded, slot, true_len, temperature, top_k, top_p)
        self.step_compiled |= bool(prog.last_call_compiled)
        if not prog.last_call_compiled:
            tm.histogram("serving/prefill_sec").observe(self._clock() - t0)
        tm.counter(f"serving/prefill_bucket[{bucket}]").inc()
        return out

    @torch.no_grad()
    def _chunk_program(self, width, toks, slot, start, live, temperature, top_k, top_p, fetch):
        # the chunk extends the slot's own row in place at [start,
        # start+width), attending to the fetched prefix and earlier chunks;
        # no other slot's row is touched
        toks = torch.from_numpy(np.asarray(toks)).to(self.device).long()
        pos = torch.tensor([start], dtype=torch.int32).to(self.device)
        logits, _ = tfm.apply_with_cache(self.cfg, self.params, toks,
                                         self._slot_view(self._cache, slot, self.Smax), pos,
                                         last_index=live - 1)
        if not fetch:
            # an intermediate chunk's token is mid-prompt garbage: no read,
            # so the next decode step queues behind it without a sync. A NaN
            # here reaches the final chunk's sentinel through attention.
            return None
        return self._sample_one(logits, temperature, top_k, top_p)

    def chunk(self, width: int, toks, slot: int, start: int, live: int,
              temperature: float, top_k: int, top_p: float, *, fetch: bool):
        """One prompt chunk through the ``width`` program. ``fetch=False``
        (an intermediate chunk) returns None without a device read; the
        final chunk returns ``(first_token, bad)``."""
        self._tell("chunk", width, toks, slot, start, live, temperature, top_k, top_p, fetch=fetch)
        if width not in self._chunk_progs:
            wd = self.telemetry.watchdog
            self._chunk_progs[width] = wd.watch(
                self._chunk_program, wd.unique_name(f"serving/chunk_prefill[{width}]"), stable=True)
        prog = self._chunk_progs[width]
        tm = self.telemetry
        t0 = self._clock()
        out = prog(width, toks, slot, start, live, temperature, top_k, top_p, fetch)
        self.step_compiled |= bool(prog.last_call_compiled)
        tm.counter(f"serving/chunk_bucket[{width}]").inc()
        if fetch and not prog.last_call_compiled:
            tm.histogram("serving/chunk_prefill_sec").observe(self._clock() - t0)
        return out

    @torch.no_grad()
    def _verify_program(self, depth, greedy_only, toks, pos, wpos, active, temp, top_k, top_p):
        # one forward pass scores depth + 1 positions per slot; draft KV is
        # written as it goes, and a rejected tail's stale KV stays causally
        # masked until later steps overwrite it. Idle rows write past Smax,
        # where every write is dropped.
        s = self._upload(pos, wpos, active, temp, top_k, top_p)
        toks = torch.from_numpy(np.asarray(toks)).to(self.device).long()
        logits, _ = tfm.apply_with_cache(self.cfg, self.params, toks, self._cache, s[0], write_pos=s[1])
        if not self.lead:
            return None  # a follower never samples and reads nothing back
        # the sentinel spans every position of the block
        bad = ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
        on = (s[2] != 0)[:, None]
        if greedy_only:
            # every emitted token is an argmax: no filtering, no draws
            greedy = logits.argmax(dim=-1).to(torch.int32)
            accept = toks[:, 1:] == greedy[:, :depth]
            packed = torch.cat([(accept & on).to(torch.int32), torch.where(on, greedy, 0),
                                bad.to(torch.int32)[:, None]], dim=1)
        else:
            accept, resample, clean = verify_logits_vector(
                logits, toks[:, 1:], self._gen, s[3].view(torch.float32), s[4], s[5].view(torch.float32))
            packed = torch.cat([(accept & on).to(torch.int32), torch.where(on, resample, 0),
                                torch.where(on, clean, 0), bad.to(torch.int32)[:, None]], dim=1)
        # ONE read per verify step
        p = packed.cpu().numpy()
        accept = p[:, :depth].astype(bool)
        if greedy_only:
            tokens = p[:, depth:2 * depth + 1]
            return accept, tokens, tokens, p[:, -1].astype(bool)
        return (accept, p[:, depth:2 * depth + 1], p[:, 2 * depth + 1:3 * depth + 2],
                p[:, -1].astype(bool))

    def verify(self, depth: int, toks, pos, wpos, active, temp, top_k, top_p,
               greedy_only: bool = False, warm: bool = False):
        """Score every slot's draft block in one forward pass through the
        ``depth`` verify program (at most two per power-of-two depth: the
        all-greedy one and the sampled one). Returns host ``(accept,
        resample, clean, bad)`` arrays ([n, depth] / [n, depth+1] /
        [n, depth+1] / [n]). ``warm=True`` (a dispatch with every slot idle,
        made to compile) records neither a latency nor a verify step."""
        self._tell("verify", depth, toks, pos, wpos, active, temp, top_k, top_p, greedy_only=greedy_only,
                   warm=warm)
        tm = self.telemetry
        key = (depth, greedy_only)
        if key not in self._verifies:
            wd = tm.watchdog
            name = f"serving/verify[{depth}{':greedy' if greedy_only else ''}]"
            self._verifies[key] = wd.watch(self._verify_program, wd.unique_name(name), stable=True)
        prog = self._verifies[key]
        t0 = self._clock()
        out = prog(depth, greedy_only, np.asarray(toks, np.int32), pos, np.asarray(wpos, np.int32),
                   active, temp, top_k, top_p)
        self.step_compiled |= bool(prog.last_call_compiled)
        if warm:
            return out
        if not prog.last_call_compiled:
            tm.histogram("serving/verify_step_sec").observe(self._clock() - t0)
        tm.counter("serving/verify_steps").inc()
        tm.counter(f"serving/verify_bucket[{depth}]").inc()
        return out

    @torch.no_grad()
    def _fetch_program(self, pool_slot, slot):
        # the whole [0, Pmax) window: past the entry's live length it is
        # garbage that the suffix prefill and decode overwrite before any
        # query attends to it
        for kv in ("k", "v"):
            self._cache[kv][:, slot, :self.pmax].copy_(self._pool[kv][:, pool_slot])

    def prefix_fetch(self, pool_slot: int, slot: int) -> None:
        """Copy a prefix-pool window into ``slot``, in place."""
        self._tell("prefix_fetch", pool_slot, slot)
        if self._fetch is None:
            wd = self.telemetry.watchdog
            self._fetch = wd.watch(self._fetch_program, wd.unique_name("serving/prefix_fetch"),
                                   stable=True)
        self._fetch(pool_slot, slot)
        self.step_compiled |= bool(self._fetch.last_call_compiled)

    @torch.no_grad()
    def _store_program(self, slot, pool_slot):
        for kv in ("k", "v"):
            self._pool[kv][:, pool_slot].copy_(self._cache[kv][:, slot, :self.pmax])

    def prefix_store(self, slot: int, pool_slot: int) -> None:
        """Copy ``slot``'s leading window into the prefix pool, in place."""
        self._tell("prefix_store", slot, pool_slot)
        if self._store is None:
            wd = self.telemetry.watchdog
            self._store = wd.watch(self._store_program, wd.unique_name("serving/prefix_store"),
                                   stable=True)
        self._store(slot, pool_slot)
        self.step_compiled |= bool(self._store.last_call_compiled)

    @torch.no_grad()
    def _kv_export_program(self, width, slot, start):
        # a pure read: the prefill slot keeps its KV for retries until the
        # Router releases it; one copy of both windows to the host
        kv = torch.stack([self._cache[kv][:, slot:slot + 1, start:start + width] for kv in ("k", "v")])
        kv = kv.cpu()
        return kv[0], kv[1]

    def kv_export(self, width: int, slot: int, start: int):
        """Fetch one ``[start, start + width)`` KV window of ``slot`` to the
        host: the disaggregated handoff's wire unit, one watched program per
        power-of-two width. Returns host ``(k, v)`` tensors
        ``[L, 1, width, H, Dh]`` in the cache's dtype."""
        self._refuse_handoff("kv_export")
        if width not in self._kv_exports:
            wd = self.telemetry.watchdog
            self._kv_exports[width] = wd.watch(
                self._kv_export_program, wd.unique_name(f"serving/kv_export[{width}]"), stable=True)
        prog = self._kv_exports[width]
        out = prog(width, slot, start)
        self.step_compiled |= bool(prog.last_call_compiled)
        self.telemetry.counter(f"serving/kv_export_bucket[{width}]").inc()
        return out

    @torch.no_grad()
    def _kv_import_program(self, width, k, v, slot, start):
        # IN PLACE into the tensors the decode graph captured; the cache is
        # never rebound
        for name, w in (("k", k), ("v", v)):
            self._cache[name][:, slot:slot + 1, start:start + width].copy_(w, non_blocking=False)

    def kv_import(self, width: int, k, v, slot: int, start: int) -> None:
        """Write one host KV window into ``[start, start + width)`` of
        ``slot``: the import half of the handoff wire. Idempotent (a
        replayed window writes the same bytes); the window is cast to the
        cache's dtype, so one program per width."""
        self._refuse_handoff("kv_import")
        if width not in self._kv_imports:
            wd = self.telemetry.watchdog
            self._kv_imports[width] = wd.watch(
                self._kv_import_program, wd.unique_name(f"serving/kv_import[{width}]"), stable=True)
        prog = self._kv_imports[width]
        dtype = self._cache["k"].dtype
        k = torch.as_tensor(k).to(dtype)
        v = torch.as_tensor(v).to(dtype)
        prog(width, k, v, slot, start)
        self.step_compiled |= bool(prog.last_call_compiled)
        self.telemetry.counter(f"serving/kv_import_bucket[{width}]").inc()

    def _refuse_handoff(self, what: str) -> None:
        if self.tp is not None:
            raise NotImplementedError(f"{what}: the KV handoff (disaggregated serving) under tensor parallelism "
                                      "is not ported to deepspeed_tpu_torch yet")

    @torch.no_grad()
    def _fill_program(self, slot, value):
        for kv in ("k", "v"):
            self._cache[kv][:, slot].fill_(value)

    def fill_slot(self, slot: int, value: float) -> None:
        """Overwrite one slot's whole KV row with ``value``, in place. Fault
        injection poisons with NaN, so the next program attending to the
        slot genuinely computes non-finite logits; quarantine scrubs with 0
        before the slot is reused. The scrub is load-bearing: attention
        weighs every cache position and zeroes masked ones after the fact,
        so a NaN parked anywhere in the row leaks through ``0 * NaN`` into
        every later occupant's logits."""
        self._tell("fill_slot", slot, value)
        if self._fill is None:
            wd = self.telemetry.watchdog
            self._fill = wd.watch(self._fill_program, wd.unique_name("serving/fill_slot"),
                                  stable=True)
        self._fill(slot, float(value))
        self.step_compiled |= bool(self._fill.last_call_compiled)

    def hbm_pools(self) -> dict:
        """Named device-memory pools this worker holds, from tensor bytes."""
        pools = {"params": tree_bytes(self.params)}
        if self._cache is not None:
            pools["slot_kv_cache"] = tree_bytes(self._cache)
        if self._pool is not None:
            pools["prefix_pool"] = tree_bytes(self._pool)
        return pools

    def release(self) -> None:
        """Drop the device state: the slot cache, the prefix pool, the
        decode graph (its private memory pool goes with it) and the graph's
        static and pinned buffers. The worker runs nothing afterwards."""
        self._tell("release")
        self._cache = self._pool = None
        if self._graph is not None:
            self._graph.reset()
        self._graph = None
        for name in ("_static_in", "_static_out", "_pin_in", "_pin_out", "_done"):
            self.__dict__.pop(name, None)

    def compile_counts(self) -> dict:
        """How many programs this worker compiled (first calls at a new
        signature; for decode on the card, graph captures): decode == 1
        whatever the workload mix, and every chunk width / prefix copy is
        likewise ONE program."""
        out = {
            "decode": int(self._decode._cache_size()) if self._decode is not None else 0,
            "prefill": {b: int(f._cache_size()) for b, f in sorted(self._prefills.items())},
            "decode_steps": self._decode_steps,
        }
        if self._chunk_progs:
            out["chunk_prefill"] = {w: int(f._cache_size()) for w, f in sorted(self._chunk_progs.items())}
        if self._verifies:
            ver: dict[int, int] = {}
            for (d, _greedy), f in self._verifies.items():
                ver[d] = ver.get(d, 0) + int(f._cache_size())
            out["verify"] = dict(sorted(ver.items()))
        if self._fetch is not None:
            out["prefix_fetch"] = int(self._fetch._cache_size())
        if self._store is not None:
            out["prefix_store"] = int(self._store._cache_size())
        if self._kv_exports:
            out["kv_export"] = {w: int(f._cache_size()) for w, f in sorted(self._kv_exports.items())}
        if self._kv_imports:
            out["kv_import"] = {w: int(f._cache_size()) for w, f in sorted(self._kv_imports.items())}
        if self._fill is not None:
            out["fill_slot"] = int(self._fill._cache_size())
        return out


def _block(value, cls):
    return cls(**value) if isinstance(value, dict) else value


class ServingEngine:
    """Continuous batching over an ``InferenceEngine``'s model and params:
    the host scheduler half. All device state and programs live in
    ``self.worker`` (``SlotWorker``).

    Config keys (``config`` dict or keyword arguments; keywords win), as in
    the JAX engine:
      n_slots             concurrent sequences resident in the slot cache
      max_seq_len         per-slot admission budget (prompt + generated);
                          0/absent = the engine's sequence budget
      min_prefill_bucket  smallest prompt bucket (power-of-two padding floor)
      seed                sampler generator seed
      replica_id          engine identity stamped into telemetry_snapshot()
      jsonl_path          telemetry JSONL event log ("" = off), with
                          jsonl_max_bytes / jsonl_keep rotation
      watchdog_mode       off|warn|raise when a compile-stable path compiles
                          (captures) a second time (default warn)
      request_trace       {enabled, capacity} per-request timelines
      tenants             {tenant id: {weight, max_queued, ...}} DWRR policy
      prefix_cache        {enabled, n_slots, max_prefix_len, block,
                          insert_policy, min_hits}
      chunked_prefill     {enabled, chunk_size, chunks_per_step}
      speculation         {enabled, depth, ngram_min_match, draft_source}
      max_queue_len       bound on ARRIVED not-yet-admitted requests (0 = none)
      default_deadline_s  deadline for requests without their own (0 = none)
      quarantine_max_requeues   clean replays granted to a NaN-faulted request
      slot_quarantine_after     consecutive NaN faults before a slot is
                          pulled from rotation
      fault_injection     {enabled, seed, rate, garbage_logits_*}
      role                both (co-located) | prefill | decode
      timeseries / slo / incidents   the flight recorder's blocks
      ledger              {enabled, hbm_warn_fraction}: the program ledger
    ``router`` and ``gateway`` sub-blocks belong to the fleet and are
    ignored here.
    """

    def __init__(self, engine: InferenceEngine, config: dict | None = None,
                 *, n_slots: int | None = None, max_seq_len: int | None = None,
                 min_prefill_bucket: int | None = None, seed: int | None = None,
                 telemetry: Telemetry | None = None,
                 replica_id: int | str | None = None,
                 prefix_cache: PrefixCacheConfig | dict | None = None,
                 chunked_prefill: ChunkedPrefillConfig | dict | None = None,
                 speculation: SpeculationConfig | dict | None = None,
                 fault_injection: FaultInjectionConfig | dict | None = None,
                 role: str | None = None):
        if engine.cfg.moe_every > 0:
            # the Router, the serving worker and the gateway build one, so
            # this refuses MoE for the fleet too
            raise NotImplementedError("ServingEngine with an MoE model (moe_every > 0: the slot decode step and its "
                                      "CUDA graph over the experts) is not ported to deepspeed_tpu_torch yet; "
                                      "InferenceEngine.generate serves it")
        config = dict(config or {})
        config.pop("router", None)  # the fleet's Router block
        config.pop("gateway", None)  # the HTTP front door's block
        self.role = role if role is not None else config.pop("role", "both")
        if self.role not in ("both", "prefill", "decode"):
            raise ValueError(f"serving role must be both|prefill|decode, got {self.role!r}")
        lc = _block(config.get("ledger", {}), LedgerConfig)
        self.ledger_cfg: LedgerConfig = lc
        n_slots = n_slots if n_slots is not None else config.get("n_slots", 8)
        max_seq_len = max_seq_len if max_seq_len is not None else config.get("max_seq_len", 0)
        engine_budget = min(engine.cfg.max_seq_len, engine.max_out_tokens)
        max_seq_len = max_seq_len or engine_budget
        min_prefill_bucket = (min_prefill_bucket if min_prefill_bucket is not None
                              else config.get("min_prefill_bucket", 16))
        seed = seed if seed is not None else config.get("seed", 0)
        rt = _block(config.get("request_trace", {}), RequestTraceConfig)
        ts = _block(config.get("timeseries", {}), TimeSeriesConfig)
        slo = _block(config.get("slo", {}), SLOConfig)
        inc = _block(config.get("incidents", {}), IncidentConfig)
        self.timeseries_cfg: TimeSeriesConfig = ts
        self.slo_cfg: SLOConfig = slo
        self.incidents_cfg: IncidentConfig = inc
        self.telemetry = telemetry if telemetry is not None else Telemetry(
            jsonl_path=config.get("jsonl_path", ""),
            watchdog_mode=config.get("watchdog_mode", "warn"),
            ledger=lc.enabled,
            jsonl_max_bytes=int(config.get("jsonl_max_bytes", 0)),
            jsonl_keep=int(config.get("jsonl_keep", 3)),
            ledger_collectives=lc.collectives.enabled,
            ici_gbps=lc.collectives.ici_gbps,
        )
        # program-ledger join rules: each program family reads its wall
        # time from its latency histogram; decode, the steady state,
        # nominates the engine's headline serving/mfu gauge
        self.telemetry.ledger.bind("serving/decode", wall_hist="serving/decode_step_sec", gauge="serving")
        self.telemetry.ledger.bind("serving/prefill[", wall_hist="serving/prefill_sec")
        self.telemetry.ledger.bind("serving/chunk_prefill[", wall_hist="serving/chunk_prefill_sec")
        self.telemetry.ledger.bind("serving/verify[", wall_hist="serving/verify_step_sec")
        pc = _block(prefix_cache if prefix_cache is not None else config.get("prefix_cache", {}),
                    PrefixCacheConfig)
        cp = _block(chunked_prefill if chunked_prefill is not None else config.get("chunked_prefill", {}),
                    ChunkedPrefillConfig)
        sp = _block(speculation if speculation is not None else config.get("speculation", {}),
                    SpeculationConfig)
        self.prefix_cfg: PrefixCacheConfig = pc
        self.chunk_cfg: ChunkedPrefillConfig = cp
        self.spec_cfg: SpeculationConfig = sp
        # built here so that a bad draft_source fails at engine build
        self._drafter = make_drafter(sp, vocab_size=engine.cfg.vocab_size) if sp.enabled else None
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        # per-slot adaptive draft cap (AIMD over the configured depth):
        # doubled on a fully accepted draft, halved on a rejection, so a
        # mispredicted slot's verifies ride the cheap small depths
        self._spec_len = np.full((n_slots,), 2, np.int32)
        # consecutive zero-acceptance verifies floor the cap at 1, then
        # suppress drafting (cap 0) with a decaying re-probe schedule
        self._spec_zero_streak = np.zeros((n_slots,), np.int32)
        self._spec_probe_wait = np.zeros((n_slots,), np.int32)
        self._spec_suppressed_steps = 0
        self._spec_probes = 0

        self.max_queue_len = int(config.get("max_queue_len", 0))
        self.default_deadline_s = float(config.get("default_deadline_s", 0.0))
        self.quarantine_max_requeues = int(config.get("quarantine_max_requeues", 1))
        self.slot_quarantine_after = int(config.get("slot_quarantine_after", 2))
        # tenant id -> TenantConfig: host-side scheduler state only; an empty
        # policy keeps single-pool earliest-arrival admission
        self._tenants: dict[str, TenantConfig] = {}
        self.set_tenant_policy(config.get("tenants", {}))
        self._dwrr_deficit: dict[str, float] = {}
        self._dwrr_at: str = ""
        fi = _block(fault_injection if fault_injection is not None else config.get("fault_injection", {}),
                    FaultInjectionConfig)
        self._inj: Optional[FaultInjector] = FaultInjector(fi) if fi.enabled else None

        self.engine = engine
        self.cfg = engine.cfg
        self.n_slots = int(n_slots)
        self.tp = getattr(engine, "tp", None)
        if self.tp is not None and self.role != "both":
            raise NotImplementedError(f"serving role {self.role!r} (disaggregated prefill/decode and its KV handoff) "
                                      "under tensor parallelism is not ported to deepspeed_tpu_torch yet")
        self._entry_depth = 0  # the driver's nesting of entry points (tensor parallelism)
        self.replica_id = replica_id if replica_id is not None else config.get("replica_id", 0)
        # admission stays at the MODEL's sequence limit (a learned position
        # table has nothing past it); the worker's cache rounds up to 128
        self.budget = int(max_seq_len)
        if self.budget > engine_budget:
            raise ValueError(
                f"max_seq_len ({self.budget}) exceeds the engine's sequence "
                f"budget {engine_budget} (min of model max_seq_len "
                f"{engine.cfg.max_seq_len} and max_out_tokens "
                f"{engine.max_out_tokens})")
        self.min_bucket = int(min_prefill_bucket)
        self.worker = SlotWorker(engine, self.telemetry, self.n_slots, self.budget, seed, pc)
        self.telemetry.ledger.set_device(self.worker.device)
        self.closed = False  # close() released the device state: a dead replica
        self.Smax = self.worker.Smax

        self._pfx: Optional[PrefixIndex] = None
        if pc.enabled:
            self._pfx = PrefixIndex(pc.n_slots, pc.block, insert_policy=pc.insert_policy,
                                    min_hits=pc.min_hits)
            self.telemetry.gauge("serving/prefix_pool_slots").set(pc.n_slots)

        n = self.n_slots
        self._slots = [_Slot() for _ in range(n)]
        self._free: deque[int] = deque(range(n))
        self._active = np.zeros((n,), np.bool_)
        self._pos = np.zeros((n,), np.int32)
        self._last_tok = np.zeros((n,), np.int32)
        self._temp = np.zeros((n,), np.float32)
        self._top_k = np.zeros((n,), np.int32)
        self._top_p = np.ones((n,), np.float32)

        self._queue: deque[Request] = deque()
        self._prefilling: dict[int, _Prefill] = {}  # slot -> admission state
        # disaggregated-serving state (empty for role "both"): the prefill
        # role parks finished admissions here until the Router streams
        # their KV out; the decode role stages imports here until commit
        self._handoffs: dict[int, _Handoff] = {}  # uid -> parked handoff
        self._imports: dict[int, dict] = {}  # uid -> staged KV import
        self._rr = 0  # round-robin cursor over prefilling slots
        self._results: dict[int, RequestResult] = {}
        self._requeues: dict[int, int] = {}  # uid -> quarantine replays
        # uid -> tenant id for live requests (anonymous requests stay out)
        self._uid_tenant: dict[int, str] = {}
        self._slot_faults = np.zeros((n,), np.int32)
        self._quarantined_slots: set[int] = set()
        # uids outside the queue bound: a fleet's failover/drain requeues
        self._exempt_uids: set[int] = set()
        # uids that reached a terminal state since step() last returned
        self._terminal_uids: list[int] = []
        self._deadlines_armed = self.default_deadline_s > 0
        self._epoch = time.perf_counter()
        self._trace_cursor = 0  # take_trace_flush's position in the trace
        self.tracer: Optional[RequestTracer] = (
            RequestTracer(rt.capacity, replica_id=self.replica_id,
                          clock=lambda: time.perf_counter() - self._epoch)
            if rt.enabled else None)
        # flight-recorder rings: sampled from the step loop on the engine
        # clock, flushed over a worker's step reply. SLO classification and
        # incident capture both read the rings, so either enables them
        self._rings: Optional[TimeSeriesStore] = (
            TimeSeriesStore(raw_interval_s=ts.interval_s, tiers=tuple(ts.tiers), capacity=ts.capacity,
                            flush_capacity=ts.flush_capacity)
            if (ts.enabled or slo.enabled or inc.enabled) else None)
        self._next_sample_t = 0.0
        self._ring_cursor = 0  # take_ring_flush's position in the journal
        # incident bundles per replica under <dir>/replica<rid>/, so a
        # fleet's recorders never collide
        self._incidents: Optional[IncidentRecorder] = None
        if inc.enabled:
            self._incidents = IncidentRecorder(
                os.path.join(inc.dir, f"replica{self.replica_id}"), source=f"replica{self.replica_id}",
                max_bundles=inc.max_bundles, window_before_s=inc.window_before_s,
                window_after_s=inc.window_after_s, registry=self.telemetry.registry)
            self.telemetry.watchdog.on_refusal = self._on_watchdog_refusal
        feat = []
        if pc.enabled:
            feat.append(f"prefix_cache[{pc.n_slots}x{self.worker.pmax}, "
                        f"block {pc.block}, {pc.insert_policy}]")
        if cp.enabled:
            feat.append(f"chunked_prefill[{cp.chunk_size}]")
        if sp.enabled:
            feat.append(f"speculation[depth {sp.depth}, {sp.draft_source}]")
        if self.role != "both":
            feat.append(f"role {self.role}")
        log_dist(
            f"serving engine: {n} slots x {self.Smax} tokens, cache "
            f"{tree_bytes(self.worker._cache) / 1e6:.1f} MB on {self.worker.device}"
            + (", " + ", ".join(feat) if feat else ""), ranks=[0])

    @property
    def is_driver(self) -> bool:
        """Whether this engine runs the scheduler: always, but for a
        tensor-parallel follower (model index above 0)."""
        return self.worker.lead

    @contextlib.contextmanager
    def _entry(self):
        """An entry point on the driver under tensor parallelism: the
        outermost one ends with the closing message, sent from ``finally``
        (flagged failed when the entry raised), carrying the entry's result
        (``box[0]``) to every follower."""
        if self.tp is None or self._entry_depth:
            yield [None]
            return
        self._entry_depth += 1
        box, failed = [None], True
        try:
            yield box
            failed = False
        finally:
            self._entry_depth -= 1
            self.worker.done(None if failed else box[0], failed)

    def follow(self):
        """A tensor-parallel follower's side of one driver entry point: run
        the driver's device calls until its closing message; return the
        driver's result. Every follower entry point is this."""
        return self.worker.follow()

    def _bucket_len(self, S: int) -> int:
        return min(_next_pow2(max(S, self.min_bucket)), self.Smax)

    def _segments(self, start: int, S: int) -> list[tuple[int, int, int]]:
        """Split [start, S) into (start, width, live_len) chunk segments:
        full ``chunk_size`` chunks, then ONE power-of-two bucketed segment for
        the remainder (padded, like the one-shot prefill). Only when that
        bucket would spill past the cache end does the remainder fall back to
        its unpadded binary decomposition. Widths are powers of two <=
        chunk_size, so the program set stays bounded."""
        C = self.chunk_cfg.chunk_size
        segs = []
        p = start
        while S - p >= C:
            segs.append((p, C, C))
            p += C
        r = S - p
        if r > 0:
            b = min(_next_pow2(max(r, min(self.min_bucket, C))), C)
            if p + b <= self.Smax:
                segs.append((p, b, r))
            else:
                while r > 0:
                    while b > r:
                        b //= 2
                    segs.append((p, b, b))
                    p += b
                    r -= b
        return segs

    # -- scheduler ------------------------------------------------------

    def set_tenant_policy(self, tenants: dict) -> None:
        """Install (or replace) the per-tenant scheduling policy: tenant id
        -> ``TenantConfig`` (or its dict). Host-side state only; an empty
        mapping restores single-pool earliest-arrival admission."""
        self._tenants = {str(tid): b if isinstance(b, TenantConfig) else TenantConfig(**dict(b))
                         for tid, b in dict(tenants or {}).items()}

    def _tenant_weight(self, tenant: str) -> float:
        tc = self._tenants.get(tenant)
        return tc.weight if tc is not None else 1.0

    def submit(self, request: Request) -> int:
        """Enqueue a request (admitted by the next step()/serve() iteration
        whose clock has passed its arrival_time). Raises ``ValueError`` for a
        request over the slot budget or a duplicate uid, and the typed
        ``RequestRejected`` when a queue bound sheds it."""
        S = int(np.asarray(request.prompt).shape[-1])
        if S + request.max_new_tokens > self.budget:
            raise ValueError(
                f"request {request.uid}: prompt ({S}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the slot budget {self.budget}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.uid}: max_new_tokens must be >= 1 "
                f"(got {request.max_new_tokens})")
        live = ({r.uid for r in self._queue} | set(self._results)
                | {s.uid for s in self._slots if s.uid >= 0}
                | {p.req.uid for p in self._prefilling.values()}
                | set(self._handoffs) | set(self._imports))
        if request.uid in live:
            raise ValueError(f"request uid {request.uid} is already in flight "
                             "or finished; uids must be unique per engine")
        now = time.perf_counter() - self._epoch
        counted = request.arrival_time <= now and request.uid not in self._exempt_uids
        if self.max_queue_len and counted:
            arrived = self.arrived_queue_len(now)
            if arrived >= self.max_queue_len:
                self.telemetry.counter("resilience/load_shed").inc()
                raise RequestRejected(
                    request.uid, "queue_full",
                    f"{arrived} arrived requests already queued "
                    f"(max_queue_len={self.max_queue_len})")
        tc = self._tenants.get(request.tenant)
        if tc is not None and tc.max_queued > 0 and counted:
            # the tenant's own bound holds even under global headroom
            mine = sum(1 for r in self._queue
                       if r.tenant == request.tenant and r.arrival_time <= now
                       and self._requeues.get(r.uid, 0) == 0
                       and r.uid not in self._exempt_uids)
            if mine >= tc.max_queued:
                self.telemetry.counter(f"tenant/{request.tenant}/rejected").inc()
                raise RequestRejected(
                    request.uid, "tenant_quota",
                    f"tenant {request.tenant!r} has {mine} arrived "
                    f"requests queued (max_queued={tc.max_queued})")
        if request.deadline_s > 0:
            self._deadlines_armed = True
        if request.tenant:
            self._uid_tenant[request.uid] = request.tenant
        self._queue.append(request)
        if self.tracer is not None:
            self.tracer.record(request.uid, "arrived", t=request.arrival_time, prompt_len=S)
        return request.uid

    def requeue(self, request: Request) -> int:
        """Re-admission of a request this process accepted once (a fleet's
        failover or drain): it re-enters the queue outside the queue-bound
        accounting, like a quarantine replay."""
        self._exempt_uids.add(int(request.uid))
        try:
            uid = self.submit(request)
        except (ValueError, RequestRejected):
            self._exempt_uids.discard(int(request.uid))
            raise
        if self.tracer is not None:
            self.tracer.record(uid, "requeued")
        return uid

    def withdraw(self, uid: int) -> Optional[Request]:
        """Remove a still-QUEUED request and hand it back without a result
        (it is moving, not terminal). None if the uid is not queued here."""
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                del self._queue[i]
                self._exempt_uids.discard(uid)
                self._uid_tenant.pop(uid, None)
                return r
        return None

    # -- disaggregated prefill/decode surface ----------------------------
    #
    # Prefill role: _activate parks finished admissions in self._handoffs;
    # the Router discovers them (handoff_ready), streams their KV windows
    # out (kv_export_window) and frees the slot once the decode side has
    # committed (handoff_release). Decode role: the Router stages a slot
    # (kv_import_begin), streams windows in (kv_import_window), then flips
    # it to decoding (kv_import_commit) or unwinds (kv_import_abort).
    # Every mutation is replay-tolerant — a retried RPC must not corrupt
    # the handoff state machine.

    def _check_kv_window(self, start: int, width: int) -> None:
        if width < 1 or (width & (width - 1)) != 0 or width > 128:
            raise ValueError(
                f"kv window width must be a power of two <= 128, got {width}")
        if start < 0 or start % width != 0 or start + width > self.Smax:
            raise ValueError(
                f"kv window [{start}, {start + width}) must be width-aligned "
                f"inside the {self.Smax}-token slot cache")

    def handoff_ready(self) -> list[dict]:
        """Parked prefill-role handoffs awaiting KV transfer — the block a
        worker process piggybacks on its step reply so the Router's handoff
        pump discovers finished prefills with zero extra round trips."""
        return [{"uid": int(uid), "pos": int(h.pos), "first": int(h.first),
                 "prefix_hit_tokens": int(h.prefix_hit_tokens),
                 "t_admit": float(h.t_admit), "t_first": float(h.t_first)}
                for uid, h in self._handoffs.items()]

    def kv_export_window(self, uid: int, start: int, width: int):
        """One host KV window of a parked handoff's slot — a pure read
        (replay-safe: a retried export returns the same bytes)."""
        h = self._handoffs.get(int(uid))
        if h is None:
            raise ValueError(f"uid {uid} is not parked for handoff")
        self._check_kv_window(start, width)
        return self.worker.kv_export(width, h.slot, start)

    def handoff_release(self, uid: int) -> bool:
        """Free a parked handoff's slot after the decode side committed —
        the request is MOVING, not terminal, so no result is synthesized
        (the decode replica owns it from here). Replay-tolerant: releasing
        an unknown uid is False, not an error."""
        h = self._handoffs.pop(int(uid), None)
        if h is None:
            return False
        if h.entry is not None:
            self._pfx.release(h.entry)
        # the slot's KV is finite (the prefill sentinel was checked before
        # parking) — stale-but-finite KV is causally masked for the next
        # occupant, the same contract every normal release relies on
        self._free.append(h.slot)
        self._exempt_uids.discard(int(uid))
        self.telemetry.counter("serving/handoffs_released").inc()
        if self.tracer is not None:
            self.tracer.record(int(uid), "handoff_released", slot=h.slot)
        return True

    def kv_import_begin(self, request: Request, pos: int, first: int,
                        prefix_hit_tokens: int = 0, t_admit: float = 0.0,
                        t_first: float = 0.0) -> int:
        """Stage a decode-role slot for an incoming KV handoff; returns the
        slot. Raises a typed ``RequestRejected(reason="no_slot")`` when no
        slot is free (the Router leaves the handoff parked and retries —
        that backlog is the decode pool's scale-up signal). Replay-
        tolerant: a uid already staged returns its existing slot."""
        uid = int(request.uid)
        if uid in self._imports:
            return int(self._imports[uid]["slot"])
        if not self._free:
            raise RequestRejected(uid, "no_slot",
                                  "no free decode slot for KV import")
        if int(pos) + int(request.max_new_tokens) - 1 > self.budget:
            raise ValueError(
                f"kv import for uid {uid}: pos ({pos}) + remaining tokens "
                f"exceed the slot budget {self.budget}")
        slot = self._free.popleft()
        self._imports[uid] = {
            "slot": slot, "req": request, "pos": int(pos),
            "first": int(first), "prefix_hit_tokens": int(prefix_hit_tokens),
            "t_admit": float(t_admit), "t_first": float(t_first),
        }
        if self.tracer is not None:
            self.tracer.record(uid, "kv_import_begin", slot=slot,
                               pos=int(pos))
        return slot

    def kv_import_window(self, uid: int, start: int, width: int, k, v) -> None:
        """Splat one streamed KV window into the staged slot. Idempotent —
        a replayed window rewrites the same bytes."""
        imp = self._imports.get(int(uid))
        if imp is None:
            raise ValueError(f"uid {uid} has no staged KV import")
        self._check_kv_window(start, width)
        self.worker.kv_import(width, k, v, imp["slot"], start)

    def kv_import_commit(self, uid: int) -> bool:
        """Flip a fully-streamed import to DECODING — the decode-role twin
        of ``_activate``. Replay-tolerant: committing a uid that already
        committed (active or terminal here) returns True; an unknown uid
        returns False (the Router treats it as a lost handoff)."""
        uid = int(uid)
        imp = self._imports.pop(uid, None)
        if imp is None:
            return bool(uid in self._results
                        or any(self._active[s] and self._slots[s].uid == uid
                               for s in range(self.n_slots)))
        slot, req = imp["slot"], imp["req"]
        st = self._slots[slot]
        st.uid = uid
        st.remaining = req.max_new_tokens - 1
        st.eos = req.eos_token if req.eos_token is not None else -1
        st.tokens = [imp["first"]]
        st.request = req
        st.result = RequestResult(
            uid=uid, tokens=np.zeros((0,), np.int32),
            prompt_len=imp["pos"], arrival_time=req.arrival_time,
            admitted_time=imp["t_admit"], first_token_time=imp["t_first"],
            slot=slot, prefix_hit_tokens=imp["prefix_hit_tokens"],
        )
        self._active[slot] = True
        self._pos[slot] = imp["pos"]
        self._last_tok[slot] = imp["first"]
        self._spec_len[slot] = 2
        self._spec_zero_streak[slot] = 0
        self._spec_probe_wait[slot] = 0
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        if req.deadline_s > 0 or self.default_deadline_s > 0:
            self._deadlines_armed = True
        self.telemetry.counter("serving/kv_imports_committed").inc()
        if self.tracer is not None:
            self.tracer.record(uid, "kv_import_commit", slot=slot)
        if imp["first"] == st.eos or st.remaining <= 0:
            self._finish(slot)
        return True

    def kv_import_abort(self, uid: int) -> bool:
        """Unwind a staged import (decode replica lost mid-stream, prefill
        side failed over): free the slot, forget the staging. The partial
        KV is finite garbage the next occupant's prefill masks/overwrites —
        same contract as every slot release. Replay-tolerant."""
        imp = self._imports.pop(int(uid), None)
        if imp is None:
            return False
        self._free.append(imp["slot"])
        self.telemetry.counter("serving/kv_imports_aborted").inc()
        if self.tracer is not None:
            self.tracer.record(int(uid), "kv_import_abort",
                               slot=imp["slot"])
        return True

    def result(self, uid: int) -> Optional[RequestResult]:
        """The terminal result for ``uid``, or None while in flight."""
        return self._results.get(uid)

    def partial_tokens(self, uid: int) -> Optional[np.ndarray]:
        """Tokens generated SO FAR for ``uid``: the decoding slot's tokens,
        an empty array while queued or mid-prefill, the terminal result's
        tokens, or None for a uid this engine does not hold. Host reads
        only."""
        res = self._results.get(uid)
        if res is not None:
            return np.asarray(res.tokens, np.int32)
        for slot in range(self.n_slots):
            st = self._slots[slot]
            if self._active[slot] and st.uid == uid:
                return np.asarray(st.tokens, np.int32)
        h = self._handoffs.get(uid)
        if h is not None:
            return np.asarray([h.first], np.int32)
        if (any(r.uid == uid for r in self._queue)
                or any(pf.req.uid == uid for pf in self._prefilling.values())
                or uid in self._imports):
            return np.zeros((0,), np.int32)
        return None

    def arrived_queue_len(self, now: float | None = None) -> int:
        """ARRIVED not-yet-admitted requests that count toward the queue
        bound (quarantine replays and requeues sit outside it)."""
        if now is None:
            now = time.perf_counter() - self._epoch
        return sum(1 for r in self._queue
                   if r.arrival_time <= now
                   and self._requeues.get(r.uid, 0) == 0
                   and r.uid not in self._exempt_uids)

    def live_progress(self) -> dict[int, list[int]]:
        """``{uid: tokens so far}`` for every decoding slot (what a worker
        process piggybacks on its step reply for streaming)."""
        return {st.uid: list(map(int, st.tokens))
                for slot, st in enumerate(self._slots)
                if self._active[slot] and st.uid >= 0}

    def live_requests(self) -> list[Request]:
        """Accepted, non-terminal requests in scheduler order (queued, then
        mid-prefill, then decoding): what a Router fails over when this
        replica is declared dead or hung. A closed replica is a lost one: it
        raises ``RpcConnectionLost``, as a dead worker's client does, so a
        control plane restarted over it (the chaos conductor's recovery)
        reconciles nothing with it and declares it dead at its first step."""
        if self.closed:
            raise RpcConnectionLost(f"replica {self.replica_id} is closed: its device state was released")
        out = list(self._queue)
        out.extend(pf.req for _, pf in sorted(self._prefilling.items()))
        # parked handoffs are accepted and non-terminal: a dead prefill
        # replica's failover replays them from scratch
        out.extend(h.req for _, h in sorted(self._handoffs.items()))
        out.extend(st.request for slot, st in enumerate(self._slots)
                   if self._active[slot] and st.request is not None)
        return out

    def prefix_match_len(self, prompt) -> int:
        """Longest cached-prefix match (tokens) for ``prompt`` with no side
        effect (``PrefixIndex.peek``: no hit/miss counts, no LRU bump), for
        the Router's affinity dispatch; 0 when the feature is off."""
        if self._pfx is None:
            return 0
        p = np.asarray(prompt).reshape(-1)
        if p.shape[0] < 2:
            return 0
        return self._pfx.peek(p, min(p.shape[0] - 1, self.worker.pmax))

    @property
    def load(self) -> int:
        """Queued + mid-prefill + decoding requests (least-loaded dispatch),
        plus parked handoffs and staged imports: both hold slots."""
        return (len(self._queue) + len(self._prefilling) + self.n_active
                + len(self._handoffs) + len(self._imports))

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._prefilling and not self._active.any()
                and not self._handoffs and not self._imports)

    @property
    def queue_len(self) -> int:
        """Requests queued (arrived or future-dated), not yet admitted."""
        return len(self._queue)

    @property
    def occupancy(self) -> float:
        """Fraction of slots held by decoding requests and staged KV
        imports: the decode pool's saturation signal for per-pool
        autoscaling (a staged import holds a slot)."""
        if not self.n_slots:
            return 0.0
        return (self.n_active + len(self._imports)) / self.n_slots

    def pending_arrival_times(self) -> list[float]:
        """Arrival times of every queued request (a Router's idle wait)."""
        return [r.arrival_time for r in self._queue]

    def set_epoch(self, epoch: float) -> None:
        """Align this engine's clock with a Router's, so that ``step(now=...)``
        and the request timings mean one instant across the fleet. Call
        only while idle: in-flight timings are epoch-relative."""
        self._epoch = float(epoch)

    def take_trace_flush(self, limit: int = 256) -> list[dict]:
        """Request-trace events recorded since the last call (bounded; the
        engine's own ring keeps them too): a Router mirrors them each step,
        so a worker process that dies has already shipped its timeline.
        Empty when tracing is off."""
        if self.tracer is None:
            return []
        events, self._trace_cursor = self.tracer.events_since(self._trace_cursor, limit)
        return events

    def take_ring_flush(self, limit: int = 256) -> list[dict]:
        """Closed flight-recorder ring cells since the last call, for a
        Router's per-replica mirror (the ``take_trace_flush`` contract:
        seq cursor, bounded, non-destructive). Empty when the rings are
        off."""
        if self._rings is None:
            return []
        cells, self._ring_cursor = self._rings.cells_since(self._ring_cursor, limit)
        return cells

    def _on_watchdog_refusal(self, name: str, signature: str) -> None:
        """First refusal of a compile-stable path -> incident trigger (the
        watchdog's ``on_refusal`` hook; raise-mode refusals are operational
        events worth an autopsy bundle, not just a counter)."""
        if self._incidents is not None:
            self._incidents.trigger(
                "watchdog_refusal", time.perf_counter() - self._epoch,
                program=name, signature=signature)

    def _maybe_sample_rings(self, now: float) -> None:
        """One flight-recorder sample per configured interval: scheduler
        gauges as-is, registry counters as deltas, histogram percentile
        estimates as ring-only series. Off-interval steps pay one float
        compare; the sampling walk itself is accumulated into the
        ``serving/ring_sample_sec`` counter, so its cost is measured."""
        if self._rings is None or not math.isfinite(now):
            return
        if now < self._next_sample_t:
            return
        t0 = time.perf_counter()
        iv = self._rings.raw_interval_s
        self._next_sample_t = (math.floor(now / iv) + 1.0) * iv
        reg = self.telemetry.registry
        gauges = {
            "serving/queue_depth": float(len(self._queue)),
            "serving/slot_occupancy": (self.n_active / self.n_slots
                                       if self.n_slots else 0.0),
            "serving/prefilling": float(len(self._prefilling)),
        }
        if self._pfx is not None:
            g = reg.get("serving/prefix_pool_used")
            if g is not None:
                gauges["serving/prefix_pool_used"] = g.value
        for hist_name, ring_name, q in (
                ("serving/ttft_sec", "serving/ttft_p90_s", 0.9),
                ("serving/tpot_sec", "serving/tpot_p90_s", 0.9),
                ("serving/decode_step_sec", "serving/decode_step_p50_s", 0.5)):
            h = reg.get(hist_name)
            if h is not None and h.count:
                gauges[ring_name] = h.quantile(q)
        if self._spec_drafted:
            gauges["serving/spec_acceptance"] = (
                self._spec_accepted / self._spec_drafted)
        counters = {}
        for name in ("slo/requests", "slo/failures", "slo/ttft_violations",
                     "slo/tpot_violations", "serving/tokens_out",
                     "resilience/quarantines"):
            c = reg.get(name)
            if c is not None:
                counters[name] = c.value
        self._rings.sample(now, gauges=gauges, counters=counters)
        reg.counter("serving/ring_sample_sec").inc(
            time.perf_counter() - t0)

    def _incident_context(self, st: dict, t0: float, t1: float) -> dict:
        """Engine-side incident capture: the ring window around the trigger,
        the trace events inside it, and a plain registry snapshot. Host
        dict/deque reads only, no device work (this runs on the step loop
        mid-incident). ``hbm`` is the port's memory view: the worker's
        pools from tensor bytes and the CUDA caching allocator's counts."""
        ctx: dict = {"metrics": self.telemetry.registry.snapshot()}
        if self._rings is not None:
            ctx["rings"] = self._rings.window_snapshot(t0, t1)
        if self.tracer is not None:
            ctx["trace_events"] = [
                ev for ev in self.tracer.events()
                if t0 <= float(ev.get("t", 0.0)) <= t1]
        ctx["scheduler"] = {
            "queue_depth": len(self._queue),
            "active": self.n_active,
            "prefilling": self.n_prefilling,
            "quarantined_slots": sorted(self._quarantined_slots),
        }
        if self.worker._cache is not None:
            ctx["hbm"] = hbm_snapshot(self.worker.hbm_pools(), self.worker.device)
            if self.worker.device.type != "cuda":
                ctx["hbm"]["device"] = "not measured: the CPU has no allocator counts"
        return ctx


    @property
    def last_step_compiled(self) -> bool:
        """True if the latest ``step()`` ran a program for the first time at
        its signature (the decode graph's capture and warm-up included) or
        built/loaded a kernel library: the Router exempts such a step from
        its hung verdict."""
        return self.worker.step_compiled

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def n_prefilling(self) -> int:
        return len(self._prefilling)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def quarantined_slots(self) -> set[int]:
        return set(self._quarantined_slots)

    def _pop_earliest_arrived(self, now: float) -> Optional[Request]:
        """The earliest-arrived request whose arrival_time has passed, off
        the queue: not the queue head, since a future-dated head must never
        block later-submitted requests that have arrived."""
        best_i, best_t = -1, None
        for i, r in enumerate(self._queue):
            if r.arrival_time <= now and (best_t is None or r.arrival_time < best_t):
                best_i, best_t = i, r.arrival_time
        if best_i < 0:
            return None
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def _pop_tenant_fair(self, now: float) -> Optional[Request]:
        """Deficit-weighted round robin over per-tenant arrival queues:
        earliest-arrival within a tenant; across tenants each admission
        costs one unit of deficit, topped up by the tenant's weight, so
        admission shares converge to the weight ratios. With one tenant
        backlogged this is exactly the earliest-arrival pop."""
        best: dict[str, int] = {}
        for i, r in enumerate(self._queue):
            if r.arrival_time > now:
                continue
            j = best.get(r.tenant)
            if j is None or r.arrival_time < self._queue[j].arrival_time:
                best[r.tenant] = i
        if not best:
            return None
        if len(best) == 1:
            (i,) = best.values()
            req = self._queue[i]
            del self._queue[i]
            return req
        # idle tenants bank no credit
        for t in [t for t in self._dwrr_deficit if t not in best]:
            del self._dwrr_deficit[t]
        ring = sorted(best)
        n = len(ring)
        idx = ring.index(self._dwrr_at) if self._dwrr_at in ring else 0
        # weights are >= 0.01, so every tenant crosses one unit within 100
        # passes; the bound is a guard, never reached
        for _ in range(101 * n):
            t = ring[idx]
            d = self._dwrr_deficit.get(t, 0.0)
            if d < 1.0:
                d += self._tenant_weight(t)  # one top-up per visit
            if d >= 1.0:
                d -= 1.0
                self._dwrr_deficit[t] = d
                # serve this tenant while its quantum lasts, else move on
                # before the next top-up
                self._dwrr_at = t if d >= 1.0 else ring[(idx + 1) % n]
                i = best[t]
                req = self._queue[i]
                del self._queue[i]
                return req
            self._dwrr_deficit[t] = d
            idx = (idx + 1) % n
            self._dwrr_at = ring[idx]
        return self._pop_earliest_arrived(now)

    def _admit(self, now: float):
        """Move arrived requests into free slots. Without the prefix and
        chunk features: the one-shot bucketed prefill; otherwise fetch the
        cached prefix and leave the request prefilling, for step() to
        advance chunk by chunk."""
        tm = self.telemetry
        while self._free and self._queue:
            req = self._pop_tenant_fair(now)
            if req is None:
                break
            slot = self._free.popleft()
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            S = prompt.shape[0]
            t_adm = time.perf_counter() - self._epoch
            tm.counter("serving/admissions").inc()
            tm.histogram("serving/queue_wait_sec").observe(max(t_adm - req.arrival_time, 0.0))
            if self.tracer is not None:
                self.tracer.record(req.uid, "admitted", t=t_adm, slot=slot)

            entry = None
            if self._pfx is not None:
                # at most S-1 tokens are reusable: the first token needs the
                # last prompt position's logits
                entry = self._pfx.lookup(prompt, min(S - 1, self.worker.pmax))
                if entry is not None:
                    self._pfx.acquire(entry)
                    tm.counter("serving/prefix_hits").inc()
                    tm.counter("serving/prefix_tokens_reused").inc(entry.length)
                    self.worker.prefix_fetch(entry.pool_slot, slot)
                    if self.tracer is not None:
                        self.tracer.record(req.uid, "prefix_hit", tokens=entry.length)
                else:
                    tm.counter("serving/prefix_misses").inc()
            P = entry.length if entry is not None else 0

            if P == 0 and not self.chunk_cfg.enabled:
                tm.histogram("serving/chunks_per_admit").observe(1)
                self._prefill_one_shot(req, slot, prompt, t_adm, entry)
                continue

            segments = self._segments(P, S)
            tm.histogram("serving/chunks_per_admit").observe(len(segments))
            self._prefilling[slot] = _Prefill(req=req, slot=slot, prompt=prompt, segments=segments,
                                              entry=entry, t_admit=t_adm)
            if not self.chunk_cfg.enabled:
                # a prefix hit with chunking off: the suffix runs through the
                # window path (it attends to the fetched prefix), all at once
                while slot in self._prefilling:
                    self._advance_prefill(slot)

    def _prefill_one_shot(self, req: Request, slot: int, prompt: np.ndarray, t_adm: float, entry):
        S = prompt.shape[0]
        bucket = self._bucket_len(S)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = prompt
        first, bad = self.worker.prefill(bucket, padded, slot, S, req.temperature, req.top_k, req.top_p)
        t_first = time.perf_counter() - self._epoch
        self._activate(slot, req, prompt, first, t_adm, t_first, entry, bad=bad)

    def _advance_prefill(self, slot: int):
        """Run ONE chunk of the slot's admission; on the final chunk the
        first token is sampled and the slot flips to decoding."""
        pf = self._prefilling[slot]
        start, width, live = pf.segments[pf.idx]
        toks = np.zeros((1, width), np.int32)
        toks[0, :live] = pf.prompt[start:start + live]
        if self.tracer is not None:
            self.tracer.record(pf.req.uid, "chunk", k=pf.idx, width=width, slot=slot)
        pf.idx += 1
        out = self.worker.chunk(width, toks, slot, start, live, pf.req.temperature,
                                pf.req.top_k, pf.req.top_p, fetch=pf.idx >= len(pf.segments))
        if out is None:
            return
        first, bad = out
        t_first = time.perf_counter() - self._epoch
        del self._prefilling[slot]
        self._activate(slot, pf.req, pf.prompt, first, pf.t_admit, t_first, pf.entry, bad=bad)

    def _activate(self, slot: int, req: Request, prompt: np.ndarray, first: int,
                  t_adm: float, t_first: float, entry, bad: bool = False):
        """Prompt KV resident + first token sampled: flip the slot to
        decoding and (policy permitting) cache the prompt's prefix. A ``bad``
        prefill is quarantined instead, and its KV never reaches the prefix
        cache."""
        if self._inj is not None and self._inj.garbage_logits(req.uid, "prefill"):
            # make the fault real: NaN KV that an engine ignoring the
            # sentinel would store and decode from
            self.worker.fill_slot(slot, float("nan"))
            self.telemetry.counter("resilience/injected_faults").inc()
            bad = True
        if bad:
            self.telemetry.counter("resilience/nan_logit_faults").inc()
            if entry is not None:
                self._pfx.release(entry)  # the pool entry is clean; the slot is not
            self._quarantine(slot, req, "prefill")
            self._release_slot(slot)
            return
        S = prompt.shape[0]
        eos = req.eos_token if req.eos_token is not None else -1
        if self.role == "prefill" and first != eos and req.max_new_tokens > 1:
            # the decode belongs to the decode pool: park the slot with its
            # KV resident for the Router to stream out (kv_export_window)
            # and release (handoff_release). A request that finishes at its
            # first token completes here. The prefix insert still happens:
            # the prefill pool's cache makes failover replays cheap
            if self._pfx is not None:
                self._insert_prefix(slot, prompt)
            self._handoffs[req.uid] = _Handoff(
                req=req, slot=slot, first=first, pos=S,
                prefix_hit_tokens=entry.length if entry is not None else 0,
                t_admit=t_adm, t_first=t_first, entry=entry)
            self.telemetry.counter("serving/handoffs_parked").inc()
            if self.tracer is not None:
                self.tracer.record(req.uid, "handoff_ready", t=t_first, slot=slot)
            return
        st = self._slots[slot]
        st.uid = req.uid
        st.remaining = req.max_new_tokens - 1
        st.eos = req.eos_token if req.eos_token is not None else -1
        st.tokens = [first]
        st.prefix_entry = entry
        st.request = req
        st.result = RequestResult(
            uid=req.uid, tokens=np.zeros((0,), np.int32), prompt_len=S,
            arrival_time=req.arrival_time, admitted_time=t_adm,
            first_token_time=t_first, slot=slot,
            prefix_hit_tokens=entry.length if entry is not None else 0)
        self._active[slot] = True
        self._pos[slot] = S
        self._last_tok[slot] = first
        self._spec_len[slot] = 2  # the adaptive draft cap re-ramps per request
        self._spec_zero_streak[slot] = 0
        self._spec_probe_wait[slot] = 0
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        if self.tracer is not None:
            self.tracer.record(req.uid, "first_token", t=t_first, slot=slot)
        if self._pfx is not None:
            self._insert_prefix(slot, prompt)
        if first == st.eos or st.remaining <= 0:
            self._finish(slot)

    def _insert_prefix(self, slot: int, prompt: np.ndarray):
        """Offer the freshly prefilled prompt to the prefix cache; a created
        entry copies the slot's leading window into the pool."""
        tm = self.telemetry
        skips_before = self._pfx.insert_skips
        res = self._pfx.insert(prompt, min(prompt.shape[0] - 1, self.worker.pmax))
        if res.evicted is not None:
            tm.counter("serving/prefix_evictions").inc()
        if res.created:
            self.worker.prefix_store(slot, res.entry.pool_slot)
            tm.counter("serving/prefix_inserts").inc()
        elif self._pfx.insert_skips > skips_before:
            tm.counter("serving/prefix_insert_skips").inc()
        tm.gauge("serving/prefix_pool_used").set(self._pfx.used_slots)

    def _finish(self, slot: int, status: str = "ok"):
        st = self._slots[slot]
        st.result.tokens = np.asarray(st.tokens, np.int32)
        st.result.finish_time = time.perf_counter() - self._epoch
        st.result.status = status
        st.result.requeues = self._requeues.get(st.uid, 0)
        self._results[st.uid] = st.result
        self._terminal_uids.append(st.uid)
        self._exempt_uids.discard(st.uid)
        res = st.result
        tm = self.telemetry
        tm.counter("serving/evictions").inc()
        tm.counter("serving/tokens_out").inc(len(res.tokens))
        # _finish is never a fault path (faults go through _quarantine): a
        # slot that decoded cleanly clears its suspicion
        self._slot_faults[slot] = 0
        tpot = 0.0
        if status == "ok":
            if res.requeues:
                tm.counter("resilience/recovered").inc()
            # latency stats cover completed requests only
            tm.histogram("serving/ttft_sec").observe(res.ttft)
            tpot = res.time_per_output_token
            if len(res.tokens) > 1:
                tm.histogram("serving/tpot_sec").observe(tpot)
        if self.slo_cfg.enabled:
            classify_terminal(tm.registry, self.slo_cfg, status, res.ttft,
                              tpot if len(res.tokens) > 1 else None)
        self._tenant_terminal(res.uid, status, res.ttft, tpot if len(res.tokens) > 1 else None)
        tm.emit({
            "type": "request", "uid": res.uid, "slot": slot,
            "prompt_len": res.prompt_len, "n_tokens": int(len(res.tokens)),
            "ttft_s": res.ttft, "tpot_s": tpot, "status": status,
            "arrival_s": res.arrival_time, "finish_s": res.finish_time,
            "prefix_hit_tokens": res.prefix_hit_tokens,
        })
        if self.tracer is not None:
            self.tracer.record(res.uid, "terminal", t=res.finish_time, status=status,
                               n_tokens=int(len(res.tokens)))
        self._release_slot(slot)

    def _tenant_terminal(self, uid: int, status: str, ttft: float, tpot: Optional[float]) -> None:
        """Per-tenant terminal accounting under ``tenant/<id>/...``; no-op
        for anonymous requests."""
        t = self._uid_tenant.pop(uid, "")
        if not t:
            return
        tm = self.telemetry
        tm.counter(f"tenant/{t}/requests").inc()
        if status == "ok":
            tm.histogram(f"tenant/{t}/ttft_sec").observe(ttft)
            if tpot is not None:
                tm.histogram(f"tenant/{t}/tpot_sec").observe(tpot)
        elif status.startswith("shed"):
            tm.counter(f"tenant/{t}/sheds").inc()
        if self.slo_cfg.enabled:
            # classify_terminal's verdict, scoped to the tenant
            ok = (status == "ok"
                  and not (ttft > self.slo_cfg.ttft_s > 0)
                  and not (tpot is not None and tpot > self.slo_cfg.tpot_s > 0))
            tm.counter(f"tenant/{t}/slo_ok" if ok else f"tenant/{t}/slo_miss").inc()

    def _release_slot(self, slot: int):
        """Host-side slot teardown shared by every terminal path: per-slot
        array resets only, no device work."""
        st = self._slots[slot]
        if st.prefix_entry is not None:
            self._pfx.release(st.prefix_entry)
        self._slots[slot] = _Slot()
        self._active[slot] = False
        # pos 0 is the freed slot's ATTENTION position (cheapest for the
        # decode kernel); its WRITE goes to wpos = Smax and is dropped
        self._pos[slot] = 0
        self._last_tok[slot] = 0
        self._temp[slot] = 0.0
        self._top_k[slot] = 0
        self._top_p[slot] = 1.0
        if slot in self._quarantined_slots:
            self.telemetry.gauge("resilience/quarantined_slots").set(len(self._quarantined_slots))
        else:
            self._free.append(slot)

    def _synth_result(self, req: Request, status: str, slot: int = -1):
        """Terminal result for a request that produced no tokens (shed,
        expired, cancelled before activation, failed quarantine)."""
        now = time.perf_counter() - self._epoch
        res = RequestResult(
            uid=req.uid, tokens=np.zeros((0,), np.int32),
            prompt_len=int(np.asarray(req.prompt).shape[-1]),
            arrival_time=req.arrival_time, finish_time=now, slot=slot,
            status=status, requeues=self._requeues.get(req.uid, 0))
        self._results[req.uid] = res
        self._terminal_uids.append(req.uid)
        self._exempt_uids.discard(req.uid)
        if self.slo_cfg.enabled:
            classify_terminal(self.telemetry.registry, self.slo_cfg, status, 0.0, None)
        self._tenant_terminal(req.uid, status, 0.0, None)
        self.telemetry.emit({
            "type": "request", "uid": req.uid, "slot": slot,
            "prompt_len": res.prompt_len, "n_tokens": 0, "status": status,
            "arrival_s": req.arrival_time, "finish_s": now,
        })
        if self.tracer is not None:
            self.tracer.record(req.uid, "terminal", t=now, status=status, n_tokens=0)
        return res

    # -- degradation paths ------------------------------------------------

    def _deadline_of(self, req: Request) -> float:
        d = req.deadline_s if req.deadline_s > 0 else self.default_deadline_s
        return req.arrival_time + d if d > 0 else float("inf")

    def cancel(self, uid: int) -> bool:
        """Cancel a request wherever it is: queued (removed), mid-prefill
        (slot scrubbed and freed, fetched prefix released) or mid-decode
        (evicted with its partial output). False if the uid is unknown or
        already finished."""
        tm = self.telemetry
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                del self._queue[i]
                self._synth_result(r, "cancelled")
                tm.counter("resilience/cancelled").inc()
                return True
        for slot, pf in list(self._prefilling.items()):
            if pf.req.uid == uid:
                if pf.entry is not None:
                    self._pfx.release(pf.entry)
                del self._prefilling[slot]
                self._synth_result(pf.req, "cancelled", slot=slot)
                # mid-prefill KV is unverified (intermediate sentinels are
                # never read): scrub before reuse
                self.worker.fill_slot(slot, 0.0)
                self._release_slot(slot)
                tm.counter("resilience/cancelled").inc()
                return True
        for slot in range(self.n_slots):
            if self._active[slot] and self._slots[slot].uid == uid:
                self._finish(slot, status="cancelled")
                tm.counter("resilience/cancelled").inc()
                return True
        h = self._handoffs.pop(uid, None)
        if h is not None:
            if h.entry is not None:
                self._pfx.release(h.entry)
            self._free.append(h.slot)
            self._synth_result(h.req, "cancelled", slot=h.slot)
            tm.counter("resilience/cancelled").inc()
            return True
        imp = self._imports.pop(uid, None)
        if imp is not None:
            self._free.append(imp["slot"])
            self._synth_result(imp["req"], "cancelled", slot=imp["slot"])
            tm.counter("resilience/cancelled").inc()
            return True
        return False

    def _sweep_deadlines(self, now: float):
        """Shed queued requests past their deadline; evict prefilling and
        decoding ones past theirs (with their partial output)."""
        tm = self.telemetry
        for r in [r for r in self._queue if now > self._deadline_of(r)]:
            self._queue.remove(r)
            self._synth_result(r, "expired")
            tm.counter("resilience/deadline_shed").inc()
        for slot, pf in list(self._prefilling.items()):
            if now > self._deadline_of(pf.req):
                if pf.entry is not None:
                    self._pfx.release(pf.entry)
                del self._prefilling[slot]
                self._synth_result(pf.req, "deadline_exceeded", slot=slot)
                self.worker.fill_slot(slot, 0.0)  # unverified mid-prefill KV
                self._release_slot(slot)
                tm.counter("resilience/deadline_evictions").inc()
        for slot in range(self.n_slots):
            st = self._slots[slot]
            if self._active[slot] and st.request is not None and now > self._deadline_of(st.request):
                self._finish(slot, status="deadline_exceeded")
                tm.counter("resilience/deadline_evictions").inc()
        for uid, h in list(self._handoffs.items()):
            # a parked handoff past its deadline is evicted like a decoding
            # slot: the Router's pump never committed it anywhere else
            if now > self._deadline_of(h.req):
                del self._handoffs[uid]
                if h.entry is not None:
                    self._pfx.release(h.entry)
                self._free.append(h.slot)
                self._synth_result(h.req, "deadline_exceeded", slot=h.slot)
                tm.counter("resilience/deadline_evictions").inc()

    def _shed_overflow(self, now: float):
        """Bounded arrival queue: past ``max_queue_len`` arrived requests,
        shed the newest arrivals. Quarantine replays and requeues sit
        outside the bound: they are neither shed nor displace an arrival."""
        if not self.max_queue_len:
            return
        arrived = [r for r in self._queue
                   if r.arrival_time <= now and self._requeues.get(r.uid, 0) == 0
                   and r.uid not in self._exempt_uids]
        excess = len(arrived) - self.max_queue_len
        if excess <= 0:
            return
        arrived.sort(key=lambda r: r.arrival_time)
        for r in arrived[-excess:]:
            self._queue.remove(r)
            self._synth_result(r, "shed_queue_full")
            self.telemetry.counter("resilience/load_shed").inc()

    def _quarantine(self, slot: int, req: Request, phase: str):
        """Non-finite logits for ``req`` in ``slot``: scrub the slot, then
        requeue the request once for a clean replay (a second fault fails
        it). Repeated faults on one slot pull it from rotation, never the
        last healthy one."""
        tm = self.telemetry
        tm.counter("resilience/quarantines").inc()
        if self.tracer is not None:
            self.tracer.record(req.uid, "quarantine", phase=phase, slot=slot)
        if self._incidents is not None:
            self._incidents.trigger("nan_quarantine", time.perf_counter() - self._epoch,
                                    uid=req.uid, slot=slot, phase=phase)
        self.worker.fill_slot(slot, 0.0)
        self._slot_faults[slot] += 1
        healthy = self.n_slots - len(self._quarantined_slots)
        if (self._slot_faults[slot] >= self.slot_quarantine_after
                and healthy > 1 and slot not in self._quarantined_slots):
            self._quarantined_slots.add(slot)
            tm.counter("resilience/slots_quarantined").inc()
            log_dist(f"serving: slot {slot} quarantined after "
                     f"{int(self._slot_faults[slot])} consecutive NaN faults", ranks=[0])
        n = self._requeues.get(req.uid, 0)
        if n < self.quarantine_max_requeues:
            self._requeues[req.uid] = n + 1
            tm.counter("resilience/requeues").inc()
            log_dist(f"serving: request {req.uid} hit non-finite logits in slot "
                     f"{slot} ({phase}); requeued for clean replay "
                     f"({n + 1}/{self.quarantine_max_requeues})", ranks=[0])
            self._queue.append(req)
        else:
            tm.counter("resilience/failed_requests").inc()
            self._synth_result(req, "failed_nan", slot=slot)

    # -- decode and verify steps ----------------------------------------

    def _step_decode(self, wpos):
        """Advance every active slot ONE token through the decode program."""
        tm = self.telemetry
        nxt, bad = self.worker.decode(self._last_tok, self._pos, wpos, self._active,
                                      self._temp, self._top_k, self._top_p)
        for slot in range(self.n_slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            if bad[slot]:
                # the slot's state is poisoned: drop its partial output, free
                # it and requeue; the batch keeps decoding
                tm.counter("resilience/nan_logit_faults").inc()
                self._quarantine(slot, st.request, "decode")
                self._release_slot(slot)
                continue
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.remaining -= 1
            self._pos[slot] += 1
            self._last_tok[slot] = tok
            if tok == st.eos or st.remaining <= 0:
                self._finish(slot)

    def _step_verify(self, drafts: dict[int, np.ndarray], wpos):
        """Advance every active slot up to ``bucket + 1`` tokens through ONE
        verify call; the bucket is the power-of-two ceiling of the longest
        draft, and shorter or draft-less slots ride along padded. A
        rejection rolls back by position only: ``pos`` never advances past
        the accepted prefix + bonus token."""
        tm = self.telemetry
        bucket = _next_pow2(max(len(d) for d in drafts.values()))
        toks = np.zeros((self.n_slots, bucket + 1), np.int32)
        toks[:, 0] = self._last_tok
        for slot, d in drafts.items():
            toks[slot, 1:1 + len(d)] = d
        greedy_only = bool(np.all(self._temp[self._active] <= 0.0))
        accept, resample, clean, bad = self.worker.verify(
            bucket, toks, self._pos, wpos, self._active, self._temp, self._top_k, self._top_p,
            greedy_only=greedy_only)
        self._spec_steps += 1
        for slot in range(self.n_slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            if bad[slot]:
                tm.counter("resilience/nan_logit_faults").inc()
                self._quarantine(slot, st.request, "verify")
                self._release_slot(slot)
                continue
            d = drafts.get(slot)
            rl = 0 if d is None else len(d)
            a = 0
            while a < rl and accept[slot, a]:
                a += 1
            # the accepted prefix + ONE token from the first free position:
            # the residual sample at a rejection, the clean one when the
            # draft ran out (a draft-less slot: exactly the decode sample)
            bonus = int(resample[slot, a]) if a < rl else int(clean[slot, a])
            burst = [int(x) for x in d[:a]] + [bonus] if rl else [bonus]
            if rl:
                if a == 0:
                    self._spec_zero_streak[slot] += 1
                    streak = int(self._spec_zero_streak[slot])
                    if streak >= _SPEC_SUPPRESS_AFTER:
                        self._spec_len[slot] = 0
                        self._spec_probe_wait[slot] = 1 << min(streak - _SPEC_SUPPRESS_AFTER,
                                                               _SPEC_PROBE_WAIT_MAX_LOG2)
                        tm.counter("serving/spec_suppressions").inc()
                    else:
                        self._spec_len[slot] = 1
                else:
                    self._spec_zero_streak[slot] = 0
                    self._spec_probe_wait[slot] = 0
                    self._spec_len[slot] = (min(self.spec_cfg.depth, 4 * rl) if a == rl
                                            else max(2, rl // 2))
            self._spec_drafted += rl
            self._spec_accepted += a
            tm.counter("serving/spec_drafted").inc(rl)
            tm.counter("serving/spec_accepted").inc(a)
            if rl:
                tm.histogram("serving/spec_acceptance").observe(a / rl)
            emitted = 0
            finished = False
            for tok in burst:
                # token by token, so EOS and max_new_tokens cut the burst
                # where one-token decode would have stopped
                st.tokens.append(tok)
                st.remaining -= 1
                self._pos[slot] += 1
                self._last_tok[slot] = tok
                emitted += 1
                if tok == st.eos or st.remaining <= 0:
                    finished = True
                    break
            tm.histogram("serving/spec_burst_tokens").observe(emitted)
            if finished:
                self._finish(slot)

    def _drafts(self) -> dict[int, np.ndarray]:
        drafts: dict[int, np.ndarray] = {}
        for slot in range(self.n_slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            # a draft longer than ``remaining`` would write KV past the
            # admission budget; the AIMD cap clamps it further
            cap = min(self.spec_cfg.depth, st.remaining, int(self._spec_len[slot]))
            if cap < 1:
                if self._spec_len[slot] == 0 and st.remaining > 0:
                    # a suppressed slot: tick its decaying probe timer down
                    # and re-arm a depth-1 probe when it runs out
                    self._spec_suppressed_steps += 1
                    self.telemetry.counter("serving/spec_suppressed_steps").inc()
                    self._spec_probe_wait[slot] -= 1
                    if self._spec_probe_wait[slot] <= 0:
                        self._spec_len[slot] = 1
                        self._spec_probes += 1
                        self.telemetry.counter("serving/spec_probes").inc()
                continue
            d = self._drafter.propose(
                np.concatenate([np.asarray(st.request.prompt, np.int32).reshape(-1),
                                np.asarray(st.tokens, np.int32)]), cap)
            if d.size:
                drafts[slot] = d
        return drafts

    def step(self, now: float | None = None, *, enforce_deadlines: bool = True) -> list[int]:
        """One scheduler iteration: sweep deadlines and shed queue overflow,
        admit arrived requests, advance at most ``chunks_per_step`` admission
        chunks (round robin over prefilling slots), then advance every active
        slot (one decode step, or one verify call when a slot drafted).
        Returns the uids that reached a TERMINAL state since the last step()
        returned. ``enforce_deadlines=False`` (drain) skips the sweep and
        the queue bound. On a tensor-parallel follower it runs the driver's
        step (``follow``) and returns the driver's result."""
        if self.closed:
            raise RpcConnectionLost(f"replica {self.replica_id} is closed: its device state was released")
        if not self.is_driver:
            return self.follow()
        with self._entry() as box:
            if now is None:
                now = time.perf_counter() - self._epoch
            self.worker.step_compiled = False  # a fresh heartbeat window
            libraries = op_builder.loaded_count()
            finished = self._step(now, enforce_deadlines)
            # a kernel library built or loaded inside the step (nvcc takes tens
            # of seconds on a cold cache) is compiling, not hanging
            if op_builder.loaded_count() != libraries:
                self.worker.step_compiled = True
            box[0] = finished
        return finished

    def _step(self, now: float, enforce_deadlines: bool) -> list[int]:
        tm = self.telemetry
        self._maybe_sample_rings(now)
        if self._incidents is not None and self._incidents.pending and math.isfinite(now):
            self._incidents.tick(now, self._incident_context)
        if enforce_deadlines:
            if self._deadlines_armed:
                self._sweep_deadlines(now)
            self._shed_overflow(now)
        self._admit(now)
        tm.gauge("serving/queue_depth").set(len(self._queue))
        tm.gauge("serving/prefilling_slots").set(len(self._prefilling))
        for _ in range(self.chunk_cfg.chunks_per_step):
            if not self._prefilling:
                break
            slots = sorted(self._prefilling)
            self._advance_prefill(slots[self._rr % len(slots)])
            self._rr += 1
        if not self._active.any():
            tm.gauge("serving/active_slots").set(0)
            finished, self._terminal_uids = self._terminal_uids, []
            return finished
        n_active = int(self._active.sum())
        tm.gauge("serving/active_slots").set(n_active)
        tm.histogram("serving/queue_depth_hist").observe(len(self._queue))
        tm.histogram("serving/slot_occupancy").observe(n_active / self.n_slots)
        if self._inj is not None:
            # decode-phase injection: NaN-poison the chosen slot BEFORE the
            # step, so this step genuinely computes non-finite logits
            for slot in range(self.n_slots):
                st = self._slots[slot]
                if self._active[slot] and self._inj.garbage_logits(st.uid, "decode", len(st.tokens) - 1):
                    self.worker.fill_slot(slot, float("nan"))
                    tm.counter("resilience/injected_faults").inc()
        # idle and prefilling slots WRITE at Smax (dropped) but attend at
        # their pos (0 when idle): a prefilling slot's row holds its prompt
        wpos = np.where(self._active, self._pos, np.int32(self.Smax)).astype(np.int32)
        drafts = self._drafts() if self._drafter is not None else {}
        if drafts:
            self._step_verify(drafts, wpos)
        else:
            self._step_decode(wpos)
        if not self._active.any():
            tm.gauge("serving/active_slots").set(0)
        finished, self._terminal_uids = self._terminal_uids, []
        return finished

    def drain(self) -> dict[int, RequestResult]:
        """Run steps until queue and slots are empty, ignoring arrival
        times, deadlines and the queue bound; return all results so far
        (on a tensor-parallel follower: the driver's)."""
        if not self.is_driver:
            return self.follow()
        with self._entry() as box:
            while self._queue or self._prefilling or self._active.any():
                self.step(now=float("inf"), enforce_deadlines=False)
            if self._incidents is not None and self._incidents.pending:
                # drain's now=inf never ticks the recorder: a staged incident
                # must not be lost because the engine idled
                self._incidents.flush(self._incident_context)
            box[0] = dict(self._results)
        return box[0]

    def serve(self, requests: list[Request]) -> dict[int, RequestResult]:
        """Wall-clock driver: admit each request once its arrival_time has
        passed and decode until every request of this call is terminal.
        Returns {uid: RequestResult} for them. The epoch resets only while
        the engine is idle. A request shed at submit time gets a result
        (status ``shed_<reason>``) rather than an exception. Under tensor
        parallelism every rank calls it; a follower's ``requests`` are not
        read, and every rank returns the driver's results."""
        if not self.is_driver:
            return self.follow()
        with self._entry() as box:
            if not self._queue and not self._prefilling and not self._active.any():
                self._epoch = time.perf_counter()
            target = set()
            for r in sorted(requests, key=lambda r: r.arrival_time):
                try:
                    target.add(self.submit(r))
                except RequestRejected as e:
                    self._synth_result(r, "shed_" + e.reason)
                    target.add(r.uid)
            while not target <= set(self._results):
                now = time.perf_counter() - self._epoch
                if not self._active.any() and not self._prefilling and self._queue:
                    wait = min(r.arrival_time for r in self._queue) - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                self.step()
            box[0] = {u: self._results[u] for u in target}
        return box[0]

    # -- observability --------------------------------------------------

    def compile_counts(self) -> dict:
        """Programs the worker compiled (decode: graph captures on the
        card): decode == 1 whatever the workload mix."""
        return self.worker.compile_counts()

    def close(self) -> None:
        """Release this replica's device memory (``SlotWorker.release``): a
        Router calls it when it declares the replica dead. Host state
        (results, counters, the request trace) stays readable; the engine
        steps no more (``step`` and ``live_requests`` raise
        ``RpcConnectionLost``). Under tensor parallelism every rank calls it
        and each releases its own."""
        if not self.is_driver:
            self.follow()
            self.closed = True
            return
        with self._entry():
            self.closed = True
            self.worker.release()

    def prefix_cache_stats(self) -> Optional[dict]:
        """Host-side prefix-cache view (hits, misses, reuse, pool occupancy,
        resident entries); None when the feature is off."""
        return self._pfx.stats() if self._pfx is not None else None

    def warm_decode(self) -> None:
        """Run the decode step once with every slot idle (each write lands
        past Smax and is dropped): on the card this builds and loads the
        decode kernel and captures the decode graph before any request
        waits on them. A worker process calls it at boot. It counts as no
        decode step and no replay. A prefill-role engine never decodes, so
        it builds no decode program and captures nothing."""
        if self.role == "prefill":
            return
        if not self.is_driver:
            self.follow()
            return
        n = self.n_slots
        with self._entry():
            self.worker.decode(np.zeros(n, np.int32), np.zeros(n, np.int32), np.full(n, self.Smax, np.int32),
                               np.zeros(n, bool), self._temp, self._top_k, self._top_p, warm=True)

    def warm_verify(self, *, sampled: bool = False) -> list[int]:
        """Run the speculative verify programs once ahead of traffic, one
        dispatch per power-of-two depth up to ``speculation.depth`` with
        every slot idle (each write lands past Smax and is dropped), so
        that no request pays a verify program's first call. Warms the
        all-greedy family; ``sampled=True`` adds the sampled one. Returns
        the depths; [] when speculation is off."""
        if self._drafter is None:
            return []
        if not self.is_driver:
            return self.follow()
        with self._entry() as box:
            box[0] = self._warm_verify(sampled)
        return box[0]

    def _warm_verify(self, sampled: bool) -> list[int]:
        depths, d = [], 1
        while True:
            depths.append(d)
            if d >= self.spec_cfg.depth:
                break
            d *= 2
        pos = np.zeros(self.n_slots, np.int32)
        wpos = np.full(self.n_slots, self.worker.Smax, np.int32)
        off = np.zeros(self.n_slots, bool)
        for b in depths:
            toks = np.zeros((self.n_slots, b + 1), np.int32)
            for greedy_only in ((True, False) if sampled else (True,)):
                self.worker.verify(b, toks, pos, wpos, off, self._temp, self._top_k, self._top_p,
                                   greedy_only=greedy_only, warm=True)
        return depths

    def spec_stats(self) -> Optional[dict]:
        """Speculation totals: drafted/accepted tokens, acceptance rate,
        verify calls; None when the feature is off."""
        if self._drafter is None:
            return None
        drafted, accepted = self._spec_drafted, self._spec_accepted
        return {
            "enabled": True,
            "depth": int(self.spec_cfg.depth),
            "draft_source": self.spec_cfg.draft_source,
            "verify_steps": int(self._spec_steps),
            "drafted": int(drafted),
            "accepted": int(accepted),
            "acceptance_rate": (accepted / drafted) if drafted else 0.0,
            "suppressed_steps": int(self._spec_suppressed_steps),
            "probes": int(self._spec_probes),
        }

    def telemetry_snapshot(self) -> dict:
        """ONE call that reports everything: the metrics registry, the
        recompile table, the program counts, the memory pools (params, slot
        KV, prefix pool) beside the allocator's counts, the request trace,
        and the prefix-cache, speculation and fault-injection views when on.
        Appended to the JSONL log (type ``snapshot``) when a sink is set."""
        if self._uid_tenant:
            qd: dict[str, int] = {}
            occ: dict[str, int] = {}
            for r in self._queue:
                if r.tenant:
                    qd[r.tenant] = qd.get(r.tenant, 0) + 1
            for s in self._slots:
                t = self._uid_tenant.get(s.uid) if s.uid >= 0 else None
                if t:
                    occ[t] = occ.get(t, 0) + 1
            for p in self._prefilling.values():
                t = self._uid_tenant.get(p.req.uid)
                if t:
                    occ[t] = occ.get(t, 0) + 1
            for t in set(qd) | set(occ):
                self.telemetry.gauge(f"tenant/{t}/queued").set(qd.get(t, 0))
                self.telemetry.gauge(f"tenant/{t}/slots").set(occ.get(t, 0))
        extra = {}
        if self._pfx is not None:
            extra["prefix_cache"] = self._pfx.stats()
        if self._drafter is not None:
            extra["speculation"] = self.spec_stats()
        if self._inj is not None:
            extra["fault_injection"] = self._inj.stats()
        if self.tracer is not None:
            extra["request_trace"] = self.tracer.events()
        if self._rings is not None:
            extra["rings"] = self._rings.snapshot()
        if self._incidents is not None:
            extra["incidents"] = self._incidents.index()
        if self.tp is not None:
            extra["tensor_parallel"] = {"tp_size": self.tp.size, "model_index": self.tp.index,
                                        "driver": self.is_driver, "heads": self.tp.heads(self.cfg.num_heads)}
        snap = self.telemetry.snapshot(
            replica_id=self.replica_id, compiles=self.compile_counts(), decode_route=self.worker.decode_route,
            hbm=hbm_snapshot(self.worker.hbm_pools(), self.worker.device, self.ledger_cfg.hbm_warn_fraction),
            **extra)
        self.telemetry.emit({"type": "snapshot", **snap})
        return snap
