"""Multi-replica serving router (the port of
``deepspeed_tpu/inference/router.py``): N ``ServingEngine`` replicas behind
one ``submit()/step()/cancel()`` surface, with the JAX Router's owner map,
exactly-once failover, hung/dead verdicts, drain, global shedding and
journal recovery. It is host code over the replicas' schedulers; on the
card every in-process replica's decode step is its own CUDA graph over
the split-KV decode kernel.

  * dispatch        ``submit`` routes to the least-loaded HEALTHY replica;
                    with ``router.affinity`` the replica whose prefix trie
                    holds the longest match of the prompt wins first
                    (``prefix_match_len``, a stat-free peek).
  * liveness        each replica's step is timed as its heartbeat: a step
                    observed past ``health.timeout`` is a HUNG verdict
                    (unless it compiled: ``last_step_compiled``), a step
                    that raises is DEAD. Hung replicas go on probation
                    with the backoff of ``resilience/retry.py`` and are
                    re-admitted when it elapses; the
                    ``health.max_attempts``-th hung verdict is DEAD.
  * failover        non-terminal requests on a failed replica are
                    re-dispatched EXACTLY ONCE, from the Router's own copy
                    of each accepted request (a SIGKILL'd worker cannot be
                    asked); a replay that meets a second failure ends as
                    ``failed_replica``. Replays enter through
                    ``ServingEngine.requeue`` outside the queue bound, and
                    prefill from scratch on a clean replica, so completed
                    greedy outputs equal an unfaulted run's.
  * draining        ``drain_replica``: stop dispatch, migrate still-QUEUED
                    requests to siblings, let in-flight work finish, then
                    detach. No accepted request is lost.
  * global shedding ``router.max_queue_len`` bounds arrived, unadmitted
                    requests across replicas (typed ``RequestRejected``).
  * journal         with ``router.journal`` every accept, terminal and
                    cancel is journaled (``inference/journal.py``); a
                    Router built over the same journal replays it and
                    reconciles with the surviving replicas.

  * membership      ``attach_replica`` grows the fleet (a new rid, never a
                    dead one resurrected); ``router.autoscale`` (or an
                    ``inference/autoscaler.Autoscaler`` bound here) grows,
                    shrinks, heals and browns out the fleet on every step;
                    ``rolling_upgrade`` replaces it replica by replica
                    (boot -> gate: a clean step plus a canary in the
                    reserved uid band -> drain), and autoscale evaluation
                    pauses while it runs.
  * streaming       ``partial_result`` is the HTTP gateway's feed
                    (``launcher/http_gateway.py``): tokens so far from host
                    state only (an in-process replica's slot tokens, which
                    the step's one device read filled; a worker's
                    step-reply piggyback once ``enable_stream_progress``).

``step()`` returns every uid that reached a terminal state since the last
call, across all replicas. Replicas are in-process (built from
``engine`` + ``config``, sharing its parameters, each with its own slot
cache, generator and decode graph) or prebuilt ``replica_engines``: any
mix of ``ServingEngine``s and ``rpc.ReplicaClient``s fronting worker
processes (``launcher/serving_worker.py``). An ``RpcTimeout`` is a HUNG
verdict, any other transport failure DEAD. A replica that leaves the fleet
(dead, or drained and retired) is ``close()``d: an in-process one frees its
slot cache, prefix pool and graph.

  * disaggregation  ``router.disagg`` splits the fleet into a PREFILL pool
                    (dispatch and failover replays land there) and a
                    DECODE pool; after every fleet step ``_pump_handoffs``
                    streams each parked prefill's slot KV window by window
                    (``handoff_chunk`` wide, ``rpc.encode_kv_window``, raw
                    or ``int8``) into a decode replica's staged slot, and
                    ownership moves at commit. In-process replicas go
                    through the same encode/decode as a worker's frames.
  * flight recorder ``timeseries`` / ``slo`` / ``incidents``: router rings
                    plus a mirror of each replica's flushed cells, the
                    SLO tracker over them, and incident bundles on dead
                    and hung verdicts, failovers, brownout, journal
                    recovery and failure, upgrade aborts and SLO burn.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from ..resilience import (ControlPlaneCrash, FaultInjector,
                          JournalUnavailableError, RequestRejected,
                          RpcError, RpcTimeout)
from ..resilience.retry import backoff_delay
from ..runtime.config import (FaultInjectionConfig, IncidentConfig,
                              RequestTraceConfig, RouterConfig,
                              RouterHealthConfig, SLOConfig,
                              TenantConfig, TimeSeriesConfig)
from ..telemetry import (IncidentRecorder, RequestTracer, SLOTracker,
                         Telemetry, TimeSeriesStore)
from ..telemetry.request_trace import RESERVED_UID_BASE
from ..utils.logging import log_dist
from .engine import InferenceEngine
from .serving import Request, RequestResult, ServingEngine

# per-process canary uid source: every rolling-upgrade wave's synthetic
# generate gets a uid in the RESERVED band, unique across successive
# upgrades on the same fleet (engines remember finished uids forever)
_canary_uids = itertools.count()


@dataclass
class _Replica:
    """Host-side record for one replica: its scheduler plus the router's
    view of its health and traffic. ``state`` machine:

        healthy --hung--> probation --backoff elapsed--> healthy
        healthy/probation --dead/escalation--> dead        (detached)
        healthy --drain_replica--> draining --idle--> drained (detached)
    """

    rid: int
    engine: ServingEngine
    role: str = "both"       # disagg pool membership: prefill|decode|both
    state: str = "healthy"
    hung_verdicts: int = 0
    readmit_at: float = 0.0  # router-clock time probation ends
    dispatched: int = 0      # requests routed here (submit + failover in)
    failed_over: int = 0     # requests moved OFF on a dead/hung verdict
    drained: int = 0         # queued requests migrated off at drain time
    completed: int = 0       # terminal results recorded from this replica
    last_step_sec: float = 0.0  # latest non-compiling step latency
    ok_steps: int = 0        # completed non-compiling steps: the rolling
    #                          upgrade's "newcomer proven healthy" gate

    @property
    def accepts(self) -> bool:
        """Eligible for new dispatch (submit/failover/migration targets)."""
        return self.state == "healthy"

    @property
    def stepped(self) -> bool:
        """Still driven by ``Router.step()`` (draining replicas finish
        their in-flight work; probation/dead/drained are not stepped)."""
        return self.state in ("healthy", "draining")


def tenant_idem_key(tenant: str, key: str) -> str:
    """Composite idempotency-map key scoping ``key`` to ``tenant``
    (docs/serving.md "Multi-tenant isolation"): a colliding
    ``X-DSTPU-Idempotency-Key`` from a DIFFERENT tenant must never replay
    the original tenant's uid/result. The separator is a control char no
    validated client key or tenant id can contain (the gateway rejects
    control chars in keys with 400; config rejects them in tenant ids), so
    composites cannot be forged. Anonymous submits (tenant ``""``) keep
    the BARE key — which is exactly the legacy-journal replay shim: a v1
    journal's tenant-less idem records recover into the anonymous pool
    unchanged, and the journal file format never changes (keys are opaque
    strings end to end)."""
    return f"{tenant}\x1f{key}" if tenant else str(key)


class Router:
    """N ``ServingEngine`` replicas behind one submit/step/cancel surface.

    ``config`` follows the ``serving`` schema of runtime/config.py — the
    same dict a single ServingEngine takes, with the ``router`` sub-block
    (``RouterConfig``: replicas / affinity / global ``max_queue_len`` /
    ``health``) consumed here and everything else handed to each replica.
    Every replica gets its own private telemetry registry (no counter-name
    collisions) plus ``replica_id=<rid>``; the router keeps a separate
    bundle for ``router/*`` metrics and the one JSONL sink.
    """

    def __init__(self, engine: InferenceEngine | None = None,
                 config: dict | None = None,
                 *, replicas: int | None = None,
                 telemetry: Telemetry | None = None,
                 replica_engines: list | None = None):
        config = dict(config or {})
        if any(getattr(e, "tp", None) is not None for e in [engine, *(replica_engines or [])]):
            raise NotImplementedError("the fleet (Router) over tensor-parallel engines is not ported to "
                                      "deepspeed_tpu_torch yet: serve a tp_size > 1 engine with ServingEngine")
        rc = config.get("router", {})
        if isinstance(rc, dict):
            rc = RouterConfig(**rc)
        if replica_engines is not None:
            if not replica_engines:
                raise ValueError("replica_engines must not be empty")
            rc.replicas = len(replica_engines)
        elif engine is None:
            raise ValueError(
                "Router needs an InferenceEngine to build in-process "
                "replicas, or prebuilt replica_engines")
        if replicas is not None:
            rc.replicas = int(replicas)
            if rc.replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {rc.replicas}")
        self.cfg: RouterConfig = rc
        self.health: RouterHealthConfig = rc.health
        self.affinity = bool(rc.affinity)
        self.max_queue_len = int(rc.max_queue_len)
        # disaggregated prefill/decode serving: when enabled, dispatch
        # targets the PREFILL pool only and _pump_handoffs streams finished
        # prefills' slot KV into the decode pool each step
        self.disagg = rc.disagg
        self._handoff_backlog = 0   # parked handoffs the last pump left
        self._handoffs_done = 0     # committed prefill->decode transfers
        # per-tenant isolation policy (docs/serving.md "Multi-tenant
        # isolation"): the router consumes weight/max_queued for brownout
        # ordering and fleet stats; every replica engine reads the SAME
        # ``tenants`` block from the shared sub-config for its DWRR pop
        # and per-replica quota. Empty = legacy anonymous single tenant.
        self._tenants: dict[str, TenantConfig] = {}
        self.set_tenant_policy(config.get("tenants", {}), _propagate=False)

        fi = config.get("fault_injection", {})
        if isinstance(fi, dict):
            fi = FaultInjectionConfig(**fi)
        # the router's OWN injector consumes the replica_* sites; each
        # replica engine builds its own from the same block for the
        # request-level sites (garbage_logits) — independent counters
        self._inj: Optional[FaultInjector] = (
            FaultInjector(fi) if fi.enabled else None)
        self._seed = int(fi.seed) if fi.enabled else 0

        self.telemetry = telemetry if telemetry is not None else Telemetry(
            jsonl_path=config.get("jsonl_path", ""),
            watchdog_mode=config.get("watchdog_mode", "warn"),
        )
        self._epoch = time.perf_counter()
        # durable request journal (docs/serving.md "Crash-safe control
        # plane"): accepted requests, terminals and cancels are journaled
        # at the accept boundary; a restart with the same journal replays
        # it, reconciles against surviving workers and re-dispatches the
        # unaccounted remainder. Disabled = no journal object = ZERO new
        # fsyncs on the submit/terminal hot path.
        jc = rc.journal
        self._journal = None
        self._journal_failure_noted = False  # one incident per fail-closed
        self._idem: dict[str, int] = {}  # idempotency key -> uid
        if jc.enabled:
            from .journal import RequestJournal

            self._journal = RequestJournal(
                jc.path, fsync=jc.fsync,
                rotate_max_records=jc.rotate_max_records,
                keep_terminals=jc.keep_terminals, telemetry=self.telemetry,
                injector=self._inj)
            st = self._journal.state
            if self._journal.recovered and st.epoch_wall is not None:
                # continue the fleet clock across the restart: in-flight
                # arrival times and deadlines were anchored to the dead
                # process's epoch, and a fresh epoch would push queued
                # arrivals into the apparent future
                # dstpu: allow[wall-clock-verdict] -- cross-process epoch continuation: perf_counter anchors die with their process, wall time is the only shared clock, and no liveness verdict reads this
                dead_for = time.time() - st.epoch_wall
                self._epoch = time.perf_counter() - max(0.0, dead_for)
        # fleet-level request tracing: the router records the dispatch /
        # failover edges (each replica keeps its own per-stage timeline);
        # a merged view carries BOTH replica ids across a failover
        # (telemetry/request_trace.request_timeline)
        rt = config.get("request_trace", {})
        if isinstance(rt, dict):
            rt = RequestTraceConfig(**rt)
        self.tracer: Optional[RequestTracer] = (
            RequestTracer(rt.capacity, replica_id="router",
                          clock=lambda: time.perf_counter() - self._epoch)
            if rt.enabled else None)
        sub = dict(config)
        # ONE sink at the router — N replicas appending to one JSONL path
        # would interleave half-written lines
        sub.pop("jsonl_path", None)
        # kept for runtime growth: the autoscaler's and the rolling
        # upgrade's in-process newcomers are built from the same engine and
        # per-replica config the constructor used
        self._base_engine = engine
        self._sub_config = sub
        self._replicas: list[_Replica] = []
        if replica_engines is not None:
            for rid, e in enumerate(replica_engines):
                # a ReplicaClient mirrors its rpc/* transport metrics into
                # the fleet registry; in-process engines have no transport
                if hasattr(e, "bind_telemetry"):
                    e.bind_telemetry(self.telemetry)
                # one clock across the fleet (a remote replica re-anchors
                # its own perf_counter to the router's elapsed time)
                e.set_epoch(self._epoch)
                # pool membership comes from the engine: a worker booted
                # with --role reports it in its ping reply, an in-process
                # engine carries it. A client never pinged reports "both",
                # which would collapse the pool split, so ask once here (a
                # failure is fine: the health machine owns dead boots)
                if rc.disagg.enabled and hasattr(e, "rpc"):
                    try:
                        e.ping()
                    except (RpcError, OSError):
                        pass
                self._replicas.append(_Replica(
                    rid, e, role=str(getattr(e, "role", "both") or "both")))
        else:
            roles = ["both"] * rc.replicas
            if rc.disagg.enabled:
                # the pool split overrides the flat replica count: the fleet
                # is prefill_replicas + decode_replicas engines over the
                # same parameters, differing only in scheduler role
                rc.replicas = (int(rc.disagg.prefill_replicas)
                               + int(rc.disagg.decode_replicas))
                roles = (["prefill"] * int(rc.disagg.prefill_replicas)
                         + ["decode"] * int(rc.disagg.decode_replicas))
            for rid in range(rc.replicas):
                # one InferenceEngine's parameters; each replica its own
                # slot cache, prefix pool, generator and decode graph
                e = ServingEngine(engine, config=sub, replica_id=rid,
                                  role=roles[rid])
                # one clock across the fleet: replica-relative timings
                # (queue wait, TTFT) stay comparable and step(now=...) means
                # the same instant on every replica
                e.set_epoch(self._epoch)
                self._replicas.append(_Replica(rid, e, role=roles[rid]))
        self._owner: dict[int, int] = {}      # live uid -> replica id
        self._seen: dict[int, set] = {}       # uid -> replicas that held it
        self._failovers: dict[int, int] = {}  # uid -> failover count
        # the owner map's PAYLOAD: the router's own copy of every accepted,
        # non-terminal request. Failover must not depend on asking the
        # failed replica for its requests back — a SIGKILL'd worker process
        # cannot answer, and an in-process replica shouldn't need to.
        self._requests: dict[int, Request] = {}
        # per-replica mirror of piggybacked request-trace events: the
        # merged timeline's source for a replica whose process is gone
        self._trace_mirror: dict[int, deque] = {}
        self._results: dict[int, RequestResult] = {}
        # uids made terminal OUTSIDE a step (cancel()) — drained into the
        # next step()'s return so the terminal-uid contract stays complete
        self._pending_terminal: list[int] = []
        self._steps = 0
        # overload brownout (docs/serving.md "Elastic fleet & brownout"):
        # driven by the autoscaler when the fleet is at max and still
        # saturated; degrades submit gracefully instead of shedding blindly
        self._brownout = False
        self._brownout_deadline_s = 0.0
        self._autoscaler = None
        # rolling-upgrade state machine, ticked by step() while one runs
        self._upgrade: Optional[_RollingUpgrade] = None
        # set by enable_stream_progress (an SSE gateway exists): remote
        # replicas piggyback tokens-so-far on step replies
        self._stream_progress = False
        # the fleet flight recorder: router-side rings, per-replica mirror
        # stores rebuilt from the step-reply cell flush, an SLO tracker over
        # both, and an incident recorder ticked by step(). SLO and
        # incidents imply the rings.
        ts = config.get("timeseries", {})
        if isinstance(ts, dict):
            ts = TimeSeriesConfig(**ts)
        slo = config.get("slo", {})
        if isinstance(slo, dict):
            slo = SLOConfig(**slo)
        inc = config.get("incidents", {})
        if isinstance(inc, dict):
            inc = IncidentConfig(**inc)
        self.timeseries_cfg: TimeSeriesConfig = ts
        self.slo_cfg: SLOConfig = slo
        self.incidents_cfg: IncidentConfig = inc
        self._rings: Optional[TimeSeriesStore] = (
            TimeSeriesStore(raw_interval_s=ts.interval_s,
                            tiers=tuple(ts.tiers), capacity=ts.capacity,
                            flush_capacity=ts.flush_capacity)
            if (ts.enabled or slo.enabled or inc.enabled) else None)
        self._next_sample_t = 0.0
        # rid -> mirror store fed by ingest of that replica's flushed cells
        self._ring_mirror: dict = {}
        self._slo: Optional[SLOTracker] = (
            SLOTracker(slo, self.telemetry.registry, self._slo_stores)
            if slo.enabled else None)
        self._next_slo_t = 0.0
        self._incidents: Optional[IncidentRecorder] = None
        if inc.enabled:
            self._incidents = IncidentRecorder(
                inc.dir, source="router", max_bundles=inc.max_bundles,
                window_before_s=inc.window_before_s,
                window_after_s=inc.window_after_s,
                registry=self.telemetry.registry)
        if self._journal is not None and self._journal.recovered:
            # cold-start recovery: the journal remembers what the dead
            # control plane promised; the workers remember what they were
            # doing. Reconcile the two before serving anything.
            self._recover(self._journal.state)
        self.telemetry.gauge("router/replicas").set(rc.replicas)
        self._update_gauges()
        log_dist(
            f"serving router: {rc.replicas} replicas, health.timeout="
            f"{self.health.timeout}s, affinity={self.affinity}, "
            f"global max_queue_len={self.max_queue_len or 'unbounded'}",
            ranks=[0])
        if rc.autoscale.enabled and replica_engines is None:
            # in-process fleets close the elasticity loop by themselves;
            # process-mode fleets construct an Autoscaler around their
            # WorkerSupervisor instead (it binds itself here)
            from .autoscaler import Autoscaler

            Autoscaler(self, rc.autoscale)

    # -- dispatch --------------------------------------------------------

    def _accepting(self, role: str | None = None) -> list[_Replica]:
        if role is None:
            return [r for r in self._replicas if r.accepts]
        return [r for r in self._replicas if r.accepts and r.role == role]

    def _dispatch_targets(self) -> list[_Replica]:
        """Replicas eligible for NEW request dispatch and for failover
        replays, which re-run admission and prefill from scratch: the
        prefill pool under disaggregation, every healthy replica
        otherwise."""
        if self.disagg.enabled:
            return self._accepting("prefill")
        return self._accepting()

    def _pick(self, candidates: list[_Replica], request: Request) -> _Replica:
        """Prefix-affinity first (longest stat-free trie match wins), then
        least-loaded with replica-id tiebreak."""
        if self.affinity:
            best, best_len = None, 0
            for r in candidates:
                n = r.engine.prefix_match_len(request.prompt)
                if n > best_len:
                    best, best_len = r, n
            if best is not None:
                self.telemetry.counter("router/affinity_hits").inc()
                return best
        return min(candidates, key=lambda r: (r.engine.load, r.rid))

    def submit(self, request: Request, *,
               idempotency_key: str | None = None) -> int:
        """Route a request to the best healthy replica. Raises typed
        ``RequestRejected`` when no replica accepts dispatch
        (``no_healthy_replicas``) or the GLOBAL arrived-queue bound is hit
        (``queue_full`` — or ``overloaded`` during brownout, the typed
        back-off hint); per-replica bounds may still reject underneath.

        ``idempotency_key``: caller-supplied retry identity (the gateway's
        ``X-DSTPU-Idempotency-Key``). Recorded in the journal's submit
        record and in ``idempotency_lookup``, so a retried key maps back to
        THIS uid — across a control-plane restart too — instead of forking
        a second request. The caller consults ``idempotency_lookup`` BEFORE
        submitting; this method does not dedup on its own.

        Brownout degradation ladder (docs/serving.md): deadline-free
        requests are tightened onto the brownout deadline; a full queue
        sheds the lowest-priority NEWEST queued request to admit a
        higher-priority arrival; only when nothing queued is lower
        priority does the arrival itself bounce — typed ``overloaded`` so
        clients know to back off rather than hammer a saturated fleet."""
        tm = self.telemetry
        if self._journal is not None and self._journal.unavailable:
            # fail-closed: a journal that cannot persist accepts means the
            # fleet must stop PROMISING — rejecting here is recoverable
            # (the client retries after the restart); accepting a request
            # the journal never recorded is not (docs/resilience.md)
            tm.counter("router/journal/unavailable_rejects").inc()
            self._count_reject(request.tenant)
            raise RequestRejected(
                request.uid, "journal_unavailable",
                "request journal is fail-closed after a write failure; "
                "accepts resume after a control-plane restart")
        healthy = self._dispatch_targets()
        if not healthy:
            tm.counter("router/shed").inc()
            raise RequestRejected(
                request.uid, "no_healthy_replicas",
                f"0 of {len(self._replicas)} replicas accepting dispatch")
        now = time.perf_counter() - self._epoch
        if (self._brownout and self._brownout_deadline_s > 0
                and request.deadline_s <= 0):
            # ladder rung 1: a browned-out fleet grants no open-ended
            # latency budgets — deadline-free work gets the brownout
            # deadline so a saturated backlog self-limits instead of
            # growing stale entries forever. Tenant-first ordering: while
            # some tenant sits over its quota, ONLY over-quota tenants'
            # arrivals are tightened — conformant tenants keep their open
            # budgets until the aggressor's own backlog is contained
            # (legacy uniform tightening when no tenant is over quota).
            over = self._over_quota_tenants()
            if not over or request.tenant in over:
                request = replace(request,
                                  deadline_s=self._brownout_deadline_s)
                tm.counter("router/autoscale/brownout_deadlines").inc()
        if self.max_queue_len and request.arrival_time <= now:
            # same population rule as the per-engine bound: requeued uids
            # (quarantine replays, failovers) sit outside the accounting
            arrived = sum(r.engine.arrived_queue_len(now)
                          for r in self._replicas if r.stepped)
            if arrived >= self.max_queue_len and not (
                    self._brownout and self._shed_lower_priority(request)):
                tm.counter("router/shed").inc()
                self._count_reject(request.tenant)
                if self._brownout:
                    tm.counter("router/autoscale/overloaded_rejects").inc()
                    raise RequestRejected(
                        request.uid, "overloaded",
                        f"fleet browned out at max capacity ({arrived} "
                        f"arrived across {len(healthy)} replicas, nothing "
                        f"queued is lower priority) — back off and retry")
                raise RequestRejected(
                    request.uid, "queue_full",
                    f"{arrived} arrived requests across {len(healthy)} "
                    f"healthy replicas (router max_queue_len="
                    f"{self.max_queue_len})")
        if request.uid in self._owner or request.uid in self._results:
            # same guard the engine applies per replica, lifted fleet-wide:
            # two submits with one uid would land on DIFFERENT replicas
            # (each engine only sees its own state), overwrite the owner
            # map, and silently drop the first request's result
            raise ValueError(
                f"request uid {request.uid} is already in flight or "
                "finished; uids must be unique per router")
        while True:
            target = self._pick(healthy, request)
            try:
                uid = target.engine.submit(request)
                break
            except RequestRejected:
                # typed per-replica rejection (tenant_quota / queue_full):
                # count it against the tenant, then let the caller's typed
                # back-off contract see the original reason
                self._count_reject(request.tenant)
                raise
            except RpcError as e:
                # a dispatch that cannot reach its replica earns its
                # verdict early, on the SAME mapping as step(): a timeout
                # is HUNG (slow-but-alive earns probation, not permanent
                # death), anything else is DEAD. Either way the replica
                # stops accepting, its in-flight work fails over, and we
                # re-pick among the survivors. If the submit executed
                # remotely but its reply was lost, the worker holds an
                # orphaned copy the owner map never points to — its
                # completion is ignored by _record (docs/serving.md)
                log_dist(f"router: replica {target.rid} transport failed at "
                         f"dispatch ({type(e).__name__}: {e})", ranks=[0])
                self._fail(target,
                           "hung" if isinstance(e, RpcTimeout) else "dead",
                           now, self._pending_terminal)
                healthy = self._dispatch_targets()
                if not healthy:
                    tm.counter("router/shed").inc()
                    raise RequestRejected(
                        request.uid, "no_healthy_replicas",
                        "last accepting replica failed at dispatch") from e
        self._owner[uid] = target.rid
        self._seen.setdefault(uid, set()).add(target.rid)
        self._requests[uid] = request
        scoped_key = (tenant_idem_key(request.tenant, str(idempotency_key))
                      if idempotency_key else None)
        if scoped_key:
            # tenant-scoped: a colliding key from another tenant maps to a
            # DIFFERENT composite, so it can never replay this uid
            self._idem[scoped_key] = uid
        if request.tenant:
            tm.counter(f"tenant/{request.tenant}/accepted").inc()
        if self._journal is not None:
            # the accept boundary: dispatch succeeded, so this request is
            # PROMISED — the journal learns it before the caller does. (A
            # crash in the window between the worker's accept and this
            # append leaves only an orphan the owner map never points to,
            # the documented lost-reply semantics.) The journal stores the
            # COMPOSITE idem key — replay rebuilds the tenant-scoped map
            # without a format change; bare v1 keys land in the anonymous
            # pool (tenant_idem_key docstring).
            try:
                self._journal.record_submit(request, key=scoped_key)
            except JournalUnavailableError as e:
                # UN-accept: the client is about to be told "rejected", so
                # the fleet must not quietly keep working the request. The
                # engine withdraw is best-effort (a prefill may already
                # hold the slot; its orphaned completion is ignored by
                # _record, the documented lost-reply semantics).
                self._owner.pop(uid, None)
                self._seen.pop(uid, None)
                self._requests.pop(uid, None)
                if scoped_key:
                    self._idem.pop(scoped_key, None)
                try:
                    target.engine.withdraw(uid)
                except (RpcError, OSError):
                    pass
                self._note_journal_failure(e)
                self._count_reject(request.tenant)
                raise RequestRejected(
                    request.uid, "journal_unavailable",
                    "request journal append failed (fail-closed); the "
                    "accept was withdrawn") from e
        target.dispatched += 1
        tm.counter("router/dispatched").inc()
        if self.tracer is not None:
            self.tracer.record(uid, "dispatched", to_replica=target.rid)
        self._update_gauges()
        return uid

    def idempotency_lookup(self, key: str, tenant: str = "") -> Optional[int]:
        """The uid an idempotency key already maps to for THIS tenant
        (None if never seen) — journal-backed, so the mapping survives a
        restart. Keys are tenant-scoped: another tenant's identical key
        resolves to a different composite and can never leak a uid across
        the boundary; anonymous callers share the bare-key legacy pool."""
        return self._idem.get(tenant_idem_key(tenant, str(key)))

    def idempotency_map(self) -> dict[str, int]:
        """A copy of the full key -> uid mapping (the gateway seeds its
        own cache from this after a recovery)."""
        return dict(self._idem)

    def request_tenant(self, uid: int) -> Optional[str]:
        """The tenant owning live request ``uid`` (None when unknown or
        terminal): the gateway's resume/fetch ownership check reads this
        for uids it did not mint itself (journal-recovered bands)."""
        req = self._requests.get(uid)
        return req.tenant if req is not None else None

    def max_uid_in_band(self, lo: int, hi: int) -> int:
        """Highest uid in ``[lo, hi)`` this router knows (live or
        terminal), or ``lo`` when none: a restarted gateway resumes its
        uid counter past the recovered band instead of re-minting uids the
        journal already owns."""
        best = int(lo)
        for uid in itertools.chain(self._owner, self._results):
            if lo <= uid < hi:
                best = max(best, uid)
        return best

    def cancel(self, uid: int) -> bool:
        """Cancel wherever the request lives; the terminal ``cancelled``
        result is recorded immediately AND the uid is still returned by the
        next ``step()`` (the lifted terminal-uid contract covers every
        terminal path, like the engine's). False if unknown/already done."""
        rid = self._owner.get(uid)
        if rid is None:
            return False
        if self._terminal_not_durable(uid):
            # fail closed: a cancel whose record cannot become durable
            # would resurrect after restart and run anyway — refuse it
            # (the client retries once the control plane restarts)
            self.telemetry.counter("router/journal/parked_terminals").inc()
            return False
        r = self._replicas[rid]
        if not r.engine.cancel(uid):
            return False
        if self._journal is not None:
            # the cancel record covers the crash window before the
            # terminal lands: a replay without the result still knows the
            # user cancelled — the uid is never re-dispatched. Best-effort
            # under a fail-closed journal, like every terminal append.
            try:
                self._journal.record_cancel(uid)
            except JournalUnavailableError as e:
                self._note_journal_failure(e)
        self._record(r, uid)
        self._pending_terminal.append(uid)
        return True

    def now(self) -> float:
        """Seconds on the fleet clock (the epoch every replica is anchored
        to) — arrival times, deadlines and autoscale cooldowns all read it."""
        return time.perf_counter() - self._epoch

    def enable_stream_progress(self) -> None:
        """Ask remote replicas to piggyback tokens-so-far on every step
        reply (the ``partial_result`` feed for SSE streaming). Opt-in,
        because the piggyback re-sends each live stream's token list per
        step: a fleet with no streaming front door must not pay that wire
        cost. The HTTP gateway flips this at construction; replicas
        attached later inherit it. In-process replicas need nothing."""
        self._stream_progress = True
        for r in self._replicas:
            if hasattr(r.engine, "stream_progress"):
                r.engine.stream_progress = True

    def partial_result(self, uid: int):
        """Incremental per-uid result, what the SSE gateway streams from:
        ``(tokens_so_far, terminal_result_or_None)``, or None for a uid the
        fleet does not hold. Host reads only: an in-process replica's slot
        tokens (filled by the step's one device read) or a remote replica's
        step-piggybacked progress cache, so polling costs no device work
        and no round trip. After a failover the replay decodes from
        scratch, so ``tokens_so_far`` may shrink for a while; greedy
        replays produce the same prefix, and the terminal result is always
        authoritative."""
        res = self._results.get(uid)
        if res is not None:
            return np.asarray(res.tokens, np.int32), res
        rid = self._owner.get(uid)
        if rid is None:
            return None
        toks = self._replicas[rid].engine.partial_tokens(uid)
        if toks is None:
            toks = np.zeros((0,), np.int32)
        return np.asarray(toks, np.int32), None

    # -- overload brownout (docs/serving.md "Elastic fleet & brownout") --

    @property
    def brownout(self) -> bool:
        return self._brownout

    def set_brownout(self, on: bool, *, deadline_s: float = 0.0) -> None:
        """Enter/leave overload brownout. The autoscaler flips this when
        the fleet is at ``max_replicas`` and still saturated (and back once
        the pressure clears); an operator may flip it manually. While on,
        ``submit`` degrades gracefully — see the ladder in its docstring."""
        on = bool(on)
        if on and not self._brownout:
            self.telemetry.counter("router/autoscale/brownouts").inc()
            self._incident("brownout_engaged", deadline_s=float(deadline_s))
            log_dist(
                "router: BROWNOUT on ("
                + (f"{deadline_s}s deadline for deadline-free requests, "
                   if deadline_s else "no deadline tightening, ")
                + "priority shedding armed)", ranks=[0])
        elif not on and self._brownout:
            self._incident("brownout_lifted")
            log_dist("router: brownout lifted", ranks=[0])
        self._brownout = on
        self._brownout_deadline_s = float(deadline_s) if on else 0.0
        self.telemetry.gauge("router/autoscale/brownout").set(1 if on else 0)

    # -- multi-tenant isolation (docs/serving.md) ------------------------

    def set_tenant_policy(self, tenants: dict, *,
                          _propagate: bool = True) -> None:
        """Install (or replace) the per-tenant policy fleet-wide: the
        router keeps weight/max_queued for brownout ordering and stats,
        and forwards the block to every in-process replica engine's DWRR
        scheduler (worker processes read the same ``tenants`` block from
        their boot config). Host-side state only — hot-swappable."""
        pol: dict[str, TenantConfig] = {}
        for tid, block in dict(tenants or {}).items():
            pol[str(tid)] = (block if isinstance(block, TenantConfig)
                             else TenantConfig(**dict(block)))
        self._tenants = pol
        if _propagate:
            for r in self._replicas:
                fn = getattr(r.engine, "set_tenant_policy", None)
                if fn is not None:
                    fn(tenants)

    def _tenant_live_counts(self) -> dict[str, int]:
        """Live accepted (queued or running) requests per tenant, from the
        router's OWN request copies — journal recovery rebuilds
        ``_requests``, so this accounting survives a restart for free."""
        live: dict[str, int] = {}
        for req in self._requests.values():
            if req.tenant:
                live[req.tenant] = live.get(req.tenant, 0) + 1
        return live

    def _over_quota_tenants(self) -> set[str]:
        """Tenants currently holding MORE live requests than their
        ``max_queued`` quota — the brownout ladder degrades these first
        (docs/serving.md "Multi-tenant isolation")."""
        if not self._tenants:
            return set()
        live = self._tenant_live_counts()
        return {t for t, tc in self._tenants.items()
                if tc.max_queued > 0 and live.get(t, 0) > tc.max_queued}

    def _count_reject(self, tenant: str) -> None:
        if tenant:
            self.telemetry.counter(f"tenant/{tenant}/rejected").inc()

    def tenant_excess(self) -> int:
        """Fleet backlog held by tenants OVER their ``max_queued`` quota.
        The autoscaler subtracts it from its queue signal: an aggressor's
        burst is answered by its own 429s and the tenant-first brownout,
        not by growing the fleet."""
        if not self._tenants:
            return 0
        live = self._tenant_live_counts()
        return sum(max(0, live.get(t, 0) - tc.max_queued)
                   for t, tc in self._tenants.items() if tc.max_queued > 0)

    def _shed_lower_priority(self, request: Request) -> bool:
        """Brownout ladder rung 2: make room for ``request`` by shedding
        the lowest-priority NEWEST still-QUEUED request (admitted work —
        prefill/decode already paid for — is never discarded). False when
        nothing queued is lower priority than the arrival. Tenant-first
        ordering: among eligible victims, requests from tenants currently
        OVER their quota shed before any conformant tenant's work — the
        noisy neighbor absorbs its own brownout first (docs/serving.md
        "Multi-tenant isolation")."""
        over = self._over_quota_tenants()
        victims = sorted(
            (req for uid, req in self._requests.items()
             if req.priority < request.priority
             and self._owner.get(uid) is not None
             and self._replicas[self._owner[uid]].stepped),
            key=lambda r: (r.tenant not in over, r.priority,
                           -r.arrival_time, -r.uid))
        for victim in victims[:8]:  # bounded withdraw probes per submit
            r = self._replicas[self._owner[victim.uid]]
            try:
                w = r.engine.withdraw(victim.uid)
            except RpcTimeout:
                # the withdraw MAY have executed (the worker pops the uid
                # and caches it; only the reply was lost) — if we walked
                # away here, no engine would ever report the uid terminal
                # and drain()/serve() would spin on it forever. Shed it
                # anyway: either side's leftover copy is an orphan whose
                # completion the owner map ignores (the documented
                # lost-reply semantics submit dispatch follows)
                w = victim
            except RpcError:
                # conn-loss/garble already paid the replay-safe retry; a
                # second failure means the replica is dying — its DEAD
                # verdict (next step) fails this uid over from router
                # state, so nothing strands
                continue
            if w is None:
                continue  # already admitted: finishes, not shed
            self._owner.pop(victim.uid, None)
            self._seen.pop(victim.uid, None)
            self._failovers.pop(victim.uid, None)
            self._synth_result(victim, "shed_brownout")
            self._pending_terminal.append(victim.uid)
            self.telemetry.counter("router/autoscale/brownout_shed").inc()
            if self.tracer is not None:
                self.tracer.record(victim.uid, "shed", reason="brownout",
                                   priority=victim.priority)
            log_dist(
                f"router: brownout shed request {victim.uid} (priority "
                f"{victim.priority}) for arrival {request.uid} (priority "
                f"{request.priority})", ranks=[0])
            return True
        return False

    def bind_autoscaler(self, autoscaler) -> None:
        """Attach the autoscaler whose ``tick`` rides every ``step()`` and
        whose decision ring the fleet snapshot carries."""
        self._autoscaler = autoscaler

    def mark_dead(self, rid: int) -> None:
        """External dead verdict: a supervisor OBSERVED the replica's worker
        process gone (stronger evidence than any transport timeout, also
        for a replica on probation: a dead process never re-admits). Its
        in-flight work fails over now instead of at the next step's
        transport error. No-op for replicas already dead or drained."""
        r = self._replicas[rid]
        if r.state in ("dead", "drained"):
            return
        log_dist(f"router: replica {rid} marked dead externally "
                 f"(supervisor observed the worker process gone)", ranks=[0])
        self._fail(r, "dead", self.now(), self._pending_terminal)

    def release_replica(self, rid: int) -> None:
        """``close()`` a replica that left the fleet (dead, or drained and
        retired): an in-process replica frees its slot cache, prefix pool
        and decode graph, a remote one's client closes so later calls fail
        fast. Best-effort: the replica serves nothing any more."""
        closer = getattr(self._replicas[rid].engine, "close", None)
        if closer is not None:
            try:
                closer()
            except (RpcError, OSError):
                pass

    # -- cold-start recovery (docs/serving.md "Crash-safe control plane") -

    def _recover(self, st) -> None:
        """Rebuild the owner map after a control-plane crash: replay the
        journal's terminals into ``_results``, then one reconcile round
        against every replica — a worker that survived the crash still
        holds its live requests and its UNACKED terminal results (the
        worker's replay-safe buffers), so nothing it knows is lost and nothing it
        holds runs twice. Journaled-accepted uids NOBODY accounts for
        (their worker died between crash and restart, or the crash landed
        between journal append and worker dispatch loss) re-dispatch
        through the existing exactly-once failover path."""
        from .rpc import decode_request, decode_result

        tm = self.telemetry
        tm.counter("router/recovery/recoveries").inc()
        self._idem.update(st.idem)
        for uid, t in st.terminals.items():
            if t.get("res") is not None and uid not in self._results:
                self._results[uid] = decode_result(t["res"])
                tm.counter("router/recovery/replayed_terminals").inc()
        live_uids = sorted(st.requests)
        held: dict[int, int] = {}       # uid -> rid still holding it live
        harvested: dict[int, RequestResult] = {}
        for r in self._replicas:
            rec_fn = getattr(r.engine, "reconcile", None)
            try:
                if rec_fn is not None:
                    out = rec_fn(live_uids)
                    live = {int(u) for u in out.get("live", ())}
                    results = {int(u): res
                               for u, res in (out.get("results") or {}).items()}
                else:
                    # in-process replica: the same questions over the
                    # generic scheduler surface
                    live = {int(q.uid) for q in r.engine.live_requests()}
                    results = {}
                    for uid in live_uids:
                        res = r.engine.result(uid)
                        if res is not None:
                            results[uid] = res
            except (RpcError, OSError) as e:
                # a worker that died between crash and restart cannot be
                # reconciled — its journaled requests fall through to the
                # re-dispatch path below
                log_dist(f"router: recovery reconcile with replica {r.rid} "
                         f"failed ({type(e).__name__}: {e}) — its requests "
                         f"fall through to failover", ranks=[0])
                continue
            for uid, res in results.items():
                if getattr(res, "status", "") == "cancelled":
                    # a journaled-LIVE uid with a worker-side cancelled
                    # result is an abandon orphan (the hung-verdict host
                    # cancel), never a user cancel — a durable cancel
                    # replays as a terminal and leaves the live set. The
                    # real copy is in flight elsewhere or re-dispatches.
                    continue
                harvested.setdefault(uid, res)
            for uid in live:
                if uid in st.requests:
                    held.setdefault(uid, r.rid)
        redispatch: list[Request] = []
        for uid in live_uids:
            req = decode_request(st.requests[uid])
            if uid in harvested:
                # the worker finished it while the brain was dead (or the
                # terminal's journal append was lost): harvest the unacked
                # result, make it durable NOW
                res = harvested[uid]
                self._results[uid] = res
                self._journal_terminal(uid, res)
                self._pending_terminal.append(uid)
                tm.counter("router/recovery/recovered_results").inc()
            elif uid in held:
                # still in flight on a surviving worker: adopt — rebuild
                # the owner map entry, never re-dispatch (nothing runs
                # twice)
                rid = held[uid]
                self._owner[uid] = rid
                self._seen.setdefault(uid, set()).add(rid)
                self._requests[uid] = req
                self._replicas[rid].dispatched += 1
                tm.counter("router/recovery/adopted_requests").inc()
            else:
                redispatch.append(req)
        for req in redispatch:
            # accepted, unaccounted: the existing exactly-once failover
            # path re-queues it on a clean replica (or fails it with a
            # typed terminal when none is left) — zero silent loss
            self._requests[req.uid] = req
            self._failover(req, self._pending_terminal)
            tm.counter("router/recovery/redispatched").inc()
        self._update_gauges()
        self._incident("journal_recovery", terminals=len(st.terminals),
                       adopted=len(held), harvested=len(harvested),
                       redispatched=len(redispatch))
        log_dist(
            f"router: recovered from journal — "
            f"{len(st.terminals)} journaled terminals, "
            f"{len(held)} adopted in flight, "
            f"{len(harvested)} results harvested from workers, "
            f"{len(redispatch)} re-dispatched", ranks=[0])

    # -- health / failover ----------------------------------------------

    def _note_journal_failure(self, e: JournalUnavailableError) -> None:
        """Account one failed journal append: counter + a ONE-TIME incident
        trigger (the journal stays fail-closed until restart, so every
        later append would re-fire the same root cause)."""
        tm = self.telemetry
        tm.counter("router/journal/append_failures").inc()
        if not self._journal_failure_noted:
            self._journal_failure_noted = True
            self._incident("journal_unavailable", error=str(e),
                           path=getattr(e, "path", ""))
            log_dist(f"router: request journal fail-closed ({e}) — "
                     f"rejecting new accepts until restart", ranks=[0])

    def _journal_terminal(self, uid: int, res=None,
                          status: str | None = None) -> None:
        """Best-effort terminal append: a fail-closed journal must never
        crash the serve loop mid-step — the restart re-derives lost
        terminals from the workers (docs/resilience.md)."""
        if self._journal is None:
            return
        try:
            self._journal.record_terminal(uid, res, status=status)
        except JournalUnavailableError as e:
            self._note_journal_failure(e)

    def _terminal_not_durable(self, uid: int) -> bool:
        """True when a terminal for ``uid`` delivered NOW is guaranteed to
        duplicate after a restart: the journal is fail-closed (the terminal
        append cannot become durable) while the uid's SUBMIT is durable, so
        the next incarnation will resurrect the request and deliver its own
        terminal. Fail closed on the promise too: park the request and let
        the restarted control plane resolve it exactly once. Uids the
        journal never accepted cannot resurrect — they deliver normally
        even while the journal is down."""
        j = self._journal
        return (j is not None and j.unavailable
                and uid in j.state.requests)

    def _record(self, r: _Replica, uid: int) -> None:
        res = r.engine.result(uid)
        if res is None or self._owner.get(uid) != r.rid:
            return
        if self._terminal_not_durable(uid):
            # the worker keeps the unacked result in its replay-safe
            # buffer; recovery harvests it and makes it durable then
            self.telemetry.counter("router/journal/parked_terminals").inc()
            return
        self._results[uid] = res
        r.completed += 1
        del self._owner[uid]
        self._seen.pop(uid, None)
        self._requests.pop(uid, None)
        self._journal_terminal(uid, res)

    def _collect(self, r: _Replica, uids, terminal: list) -> None:
        for uid in uids:
            if self._owner.get(uid) == r.rid and uid not in self._results:
                self._record(r, uid)
                if uid in self._results:  # parked terminals don't report
                    terminal.append(uid)

    def _synth_result(self, req: Request, status: str) -> RequestResult:
        now = time.perf_counter() - self._epoch
        res = RequestResult(
            uid=req.uid, tokens=np.zeros((0,), np.int32),
            prompt_len=int(np.asarray(req.prompt).shape[-1]),
            arrival_time=req.arrival_time, finish_time=now, status=status)
        self._results[req.uid] = res
        self._requests.pop(req.uid, None)
        if req.tenant and status.startswith("shed"):
            self.telemetry.counter(f"tenant/{req.tenant}/sheds").inc()
        # skips uids the journal never accepted (a shed submit's
        # synthesized result) — record_terminal filters those
        self._journal_terminal(req.uid, res)
        self.telemetry.emit({
            "type": "request", "uid": req.uid, "slot": -1,
            "prompt_len": res.prompt_len, "n_tokens": 0, "status": status,
            "arrival_s": req.arrival_time, "finish_s": now,
        })
        return res

    def _failover(self, req: Request, terminal: list,
                  from_rid: int | None = None) -> None:
        """Re-dispatch one request off a failed replica — exactly once per
        uid, never back to a replica that already held it."""
        tm = self.telemetry
        n = self._failovers.get(req.uid, 0)
        seen = self._seen.setdefault(req.uid, set())
        targets = [r for r in self._dispatch_targets()
                   if r.rid not in seen]
        if n >= 1 or not targets:
            self._owner.pop(req.uid, None)
            self._seen.pop(req.uid, None)
            if self._terminal_not_durable(req.uid):
                # a failed_replica verdict we cannot journal would be
                # re-delivered by the restarted control plane (which may
                # even harvest a real result instead) — park it live
                tm.counter("router/journal/parked_terminals").inc()
                log_dist(
                    f"router: request {req.uid} failover spent under a "
                    f"fail-closed journal — parked for restart", ranks=[0])
                return
            self._synth_result(req, "failed_replica")
            terminal.append(req.uid)
            tm.counter("router/failed_requests").inc()
            if self.tracer is not None:
                self.tracer.record(req.uid, "failover", from_replica=from_rid,
                                   outcome="failed_replica")
            log_dist(
                f"router: request {req.uid} failed_replica "
                f"({'failover already spent' if n >= 1 else 'no clean replica left'})",
                ranks=[0])
            return
        self._failovers[req.uid] = n + 1
        self._incident("failover", uid=req.uid, from_rid=from_rid)
        tgt = self._pick(targets, req)
        try:
            tgt.engine.requeue(req)
        except RpcError:
            # the chosen survivor's transport died between verdicts — its
            # own dead verdict lands on its next step; this request's
            # exactly-once budget is spent on the failed replay
            self._owner.pop(req.uid, None)
            self._seen.pop(req.uid, None)
            if self._terminal_not_durable(req.uid):
                tm.counter("router/journal/parked_terminals").inc()
                return
            self._synth_result(req, "failed_replica")
            terminal.append(req.uid)
            tm.counter("router/failed_requests").inc()
            if self.tracer is not None:
                self.tracer.record(req.uid, "failover", from_replica=from_rid,
                                   outcome="failed_replica")
            return
        self._owner[req.uid] = tgt.rid
        seen.add(tgt.rid)
        tgt.dispatched += 1
        tm.counter("router/failovers").inc()
        if self.tracer is not None:
            # the one edge that spans replicas: BOTH ids on one event, so a
            # merged timeline shows the request leaving the dead replica
            # and re-entering the clean one
            self.tracer.record(req.uid, "failover", from_replica=from_rid,
                               to_replica=tgt.rid)

    def _fail(self, r: _Replica, verdict: str, now: float,
              terminal: list) -> None:
        """Apply a hung/dead verdict: move the replica through its state
        machine and fail over every request it still owned. The failover
        population comes from the ROUTER's own request map — never from
        asking the failed replica (a SIGKILL'd worker cannot answer)."""
        tm = self.telemetry
        live = [self._requests[uid] for uid, rid in list(self._owner.items())
                if rid == r.rid and uid in self._requests]
        if verdict == "hung":
            r.hung_verdicts += 1
            tm.counter("router/hung_verdicts").inc()
            if r.hung_verdicts >= self.health.max_attempts:
                verdict = "dead"  # probation budget exhausted
            elif r.state == "draining":
                # a replica being retired gets no probation: re-admitting it
                # would hand fresh traffic to a replica the operator is
                # about to kill. The drain becomes a failover — its work
                # replays elsewhere, the replica detaches now.
                verdict = "dead"
        if verdict == "dead":
            r.state = "dead"
            tm.counter("router/replicas_dead").inc()
            self._incident("replica_dead", rid=r.rid, in_flight=len(live),
                           hung_verdicts=r.hung_verdicts)
            # a remote replica's client is closed so later snapshots /
            # cancels fail FAST instead of paying reconnect backoff toward
            # a process that is gone; an in-process one frees its memory
            self.release_replica(r.rid)
            log_dist(f"router: replica {r.rid} marked DEAD "
                     f"({len(live)} in-flight requests failing over)",
                     ranks=[0])
        else:
            # probation: re-admitted after the retry-policy backoff for
            # this verdict count (deterministic jitter, decorrelated by
            # replica id like multi-host checkpoint retries)
            delay = backoff_delay(r.hung_verdicts, self.health,
                                  seed=self._seed + r.rid)
            r.readmit_at = now + delay
            r.state = "probation"
            self._incident("replica_hung", rid=r.rid, in_flight=len(live),
                           verdicts=r.hung_verdicts, probation_s=delay)
            log_dist(
                f"router: replica {r.rid} HUNG (verdict "
                f"{r.hung_verdicts}/{self.health.max_attempts}); probation "
                f"{delay:.2f}s, {len(live)} requests failing over", ranks=[0])
            # abandon its work host-side so a re-admitted replica doesn't
            # keep decoding requests that now live elsewhere (its cancelled
            # results are ignored: the owner map has moved on). Best-effort
            # by construction: a genuinely hung worker process cannot
            # acknowledge the cancel either
            for req in live:
                try:
                    r.engine.cancel(req.uid)
                except (RpcError, OSError):  # hung transport
                    pass
        r.failed_over += len(live)
        for req in live:
            self._failover(req, terminal, from_rid=r.rid)
        self._update_gauges()

    # -- disaggregated prefill/decode handoff -------------------------

    def _pump_handoffs(self, now: float, terminal: list) -> None:
        """Stream every parked finished prefill into a decode-pool slot:
        per ready handoff, ``kv_import_begin`` on the least-loaded clean
        decode replica, the slot-KV window chunk by chunk
        (``disagg.handoff_chunk`` wide — the compiled export/import
        programs' pow2 bucket), then commit + release. Ownership moves to
        the decode replica ONLY at commit, so the exactly-once
        discipline covers the whole transfer window:

          * prefill dead mid-transfer — the decode-side staging is
            aborted and the prefill's dead/hung verdict replays its
            requests (this one included) from scratch through the prefill
            pool, exactly once.
          * decode dead pre-commit — NOT a failover: the uid never moved,
            the handoff stays parked and the next pump picks another
            decode replica.
          * decode dead post-commit — a normal failover; the replay
            re-enters via the prefill pool, whose prefix cache still holds
            the prompt's KV (commit released the prefill's copy cleanly,
            so the replay may land back on the SAME prefill replica).

        ``kv_import_begin`` rejecting with ``no_slot`` leaves the handoff
        parked; the standing backlog is the decode pool's scale-up
        signal."""
        from .rpc import decode_kv_window, encode_kv_window, kv_window_nbytes

        tm = self.telemetry
        W = int(self.disagg.handoff_chunk)
        comp = str(self.disagg.kv_compression)
        backlog = 0
        for pre in list(self._replicas):
            if pre.role != "prefill" or not pre.stepped:
                continue
            try:
                ready = pre.engine.handoff_ready()
            except RpcError:
                continue  # its verdict lands on its next step
            prefill_down = False
            for h in ready:
                uid = int(h["uid"])
                req = self._requests.get(uid)
                if self._owner.get(uid) != pre.rid or req is None:
                    # orphaned park (lost-reply submit) or already
                    # terminal router-side: the deadline sweep frees it
                    continue
                decs = [d for d in self._accepting("decode")
                        if d.rid not in self._seen.get(uid, set())]
                if not decs:
                    backlog += 1
                    continue
                dec = min(decs, key=lambda d: (d.engine.load, d.rid))
                t0 = time.perf_counter()
                if self.tracer is not None:
                    self.tracer.record(uid, "kv_handoff_started",
                                       from_replica=pre.rid,
                                       to_replica=dec.rid)
                try:
                    dec.engine.kv_import_begin(
                        req, int(h["pos"]), int(h["first"]),
                        prefix_hit_tokens=int(h.get("prefix_hit_tokens", 0)),
                        t_admit=float(h.get("t_admit", 0.0)),
                        t_first=float(h.get("t_first", 0.0)))
                except RequestRejected:
                    # decode pool saturated: stays parked, feeds the
                    # decode scale-up signal
                    backlog += 1
                    tm.counter("router/disagg/handoff_no_slot").inc()
                    continue
                except RpcError as e:
                    self._fail(dec, "hung" if isinstance(e, RpcTimeout)
                               else "dead", now, terminal)
                    backlog += 1
                    continue
                pos = int(h["pos"])
                wire_total = raw_total = 0
                imported = True
                for start in range(0, ((pos + W - 1) // W) * W, W):
                    try:
                        if hasattr(pre.engine, "rpc"):
                            window = pre.engine.kv_export_window(
                                uid, start, W, compression=comp)
                        else:
                            k, v = pre.engine.kv_export_window(uid, start, W)
                            window = encode_kv_window(k, v, comp)
                    except RpcError as e:
                        # prefill died mid-transfer: abort the staging,
                        # then the verdict replays its work from scratch
                        try:
                            dec.engine.kv_import_abort(uid)
                        except RpcError:
                            pass
                        self._fail(pre, "hung" if isinstance(e, RpcTimeout)
                                   else "dead", now, terminal)
                        imported = False
                        prefill_down = True
                        break
                    wire, raw = kv_window_nbytes(window)
                    wire_total += wire
                    raw_total += raw
                    try:
                        if hasattr(dec.engine, "rpc"):
                            dec.engine.kv_import_window(uid, start, W, window)
                        else:
                            kk, vv = decode_kv_window(window)
                            dec.engine.kv_import_window(uid, start, W, kk, vv)
                    except RpcError as e:
                        self._fail(dec, "hung" if isinstance(e, RpcTimeout)
                                   else "dead", now, terminal)
                        imported = False
                        break
                if prefill_down:
                    break  # _fail(pre) already replayed its whole slate
                if not imported:
                    backlog += 1  # still parked; next pump retries
                    continue
                try:
                    committed = dec.engine.kv_import_commit(uid)
                except RpcError as e:
                    self._fail(dec, "hung" if isinstance(e, RpcTimeout)
                               else "dead", now, terminal)
                    backlog += 1
                    continue
                if not committed:
                    backlog += 1  # staging swept decode-side; retry later
                    continue
                try:
                    pre.engine.handoff_release(uid)
                except RpcError:
                    pass  # verdict next step; the parked copy is an orphan
                seen = self._seen.setdefault(uid, set())
                # the prefill side released cleanly (no cancel, no stale
                # result), so a later decode-death replay MAY legally land
                # back on it — where its prefix pool still holds the KV
                seen.discard(pre.rid)
                seen.add(dec.rid)
                self._owner[uid] = dec.rid
                dec.dispatched += 1
                self._handoffs_done += 1
                dt = time.perf_counter() - t0
                tm.counter("router/disagg/handoffs").inc()
                tm.histogram("router/disagg/handoff_sec").observe(dt)
                tm.histogram("router/disagg/handoff_bytes").observe(
                    float(wire_total))
                if raw_total > wire_total:
                    tm.counter("router/disagg/kv_bytes_saved").inc(
                        raw_total - wire_total)
                if self.tracer is not None:
                    self.tracer.record(uid, "kv_handoff_done",
                                       from_replica=pre.rid,
                                       to_replica=dec.rid,
                                       bytes=int(wire_total))
        self._handoff_backlog = backlog
        tm.gauge("router/disagg/parked_handoffs").set(backlog)

    def _update_gauges(self) -> None:
        tm = self.telemetry
        tm.gauge("router/healthy_replicas").set(
            sum(1 for r in self._replicas if r.state == "healthy"))
        tm.gauge("router/live_requests").set(len(self._owner))
        if self.disagg.enabled:
            tm.gauge("router/disagg/prefill_replicas").set(
                len(self._accepting("prefill")))
            tm.gauge("router/disagg/decode_replicas").set(
                len(self._accepting("decode")))

    def _mirror_trace(self, r: _Replica) -> None:
        """Mirror the replica's piggybacked request-trace flush into a
        router-side ring: the merged timeline's only source once the
        replica's process is gone (its own buffer died with it)."""
        take = getattr(r.engine, "take_trace_flush", None)
        if take is None:
            return
        try:
            flush = take()
        # dstpu: allow[broad-except] -- tracing must never fail a fleet step: the flush is observability-only, and a replica able to raise ANY error here is still stepped (its verdict is earned in step(), not in trace mirroring)
        except Exception:  # noqa: BLE001 — tracing never fails a step
            return
        if flush:
            self._trace_mirror.setdefault(
                r.rid, deque(maxlen=2048)).extend(flush)

    # -- flight recorder ---------------------------------------------------

    def _mirror_rings(self, r: _Replica) -> None:
        """Ingest the replica's piggybacked closed ring cells into a
        router-side mirror store — the SLO windows' and incident bundles'
        only source for a replica whose process is gone."""
        if self._rings is None:
            return
        take = getattr(r.engine, "take_ring_flush", None)
        if take is None:
            return
        try:
            flush = take()
        # dstpu: allow[broad-except] -- same contract as _mirror_trace: ring mirroring is observability-only and must never fail a fleet step; the replica's verdict is earned from its step call, not its flush
        except Exception:  # noqa: BLE001 — rings never fail a step
            return
        if not flush:
            return
        store = self._ring_mirror.get(r.rid)
        if store is None:
            store = self._ring_mirror[r.rid] = TimeSeriesStore(
                raw_interval_s=self._rings.raw_interval_s,
                tiers=self._rings.intervals[1:],
                capacity=self._rings.capacity)
        for item in flush:
            if isinstance(item, dict) and "s" in item and "c" in item:
                store.ingest(str(item["s"]), item["c"])

    def _slo_stores(self) -> list:
        """Every store the SLO windows sum over: the router's own rings
        plus each replica mirror (dead replicas' last-flushed cells still
        count toward attainment — their failures happened)."""
        stores = [self._rings] if self._rings is not None else []
        stores.extend(self._ring_mirror.values())
        return stores

    def _sample_rings(self, now: float) -> None:
        """Router-side flight-recorder sample: fleet gauges as-is, registry
        counters as deltas (failovers, verdicts, brownout activity) — one
        call per raw interval from step()."""
        if self._rings is None or not math.isfinite(now):
            return
        if now < self._next_sample_t:
            return
        iv = self._rings.raw_interval_s
        self._next_sample_t = (math.floor(now / iv) + 1.0) * iv
        reg = self.telemetry.registry
        gauges = {
            "router/queue_depth": float(sum(
                r.engine.queue_len for r in self._replicas if r.stepped)),
            "router/healthy_replicas": float(sum(
                1 for r in self._replicas if r.state == "healthy")),
            "router/live_requests": float(len(self._owner)),
            "router/fleet_size": float(len(self._replicas)),
        }
        counters = {}
        for name in ("router/failovers", "router/failed_requests",
                     "router/hung_verdicts", "router/replicas_dead",
                     "router/autoscale/brownouts",
                     "router/autoscale/brownout_shed"):
            c = reg.get(name)
            if c is not None:
                counters[name] = c.value
        self._rings.sample(now, gauges=gauges, counters=counters)

    def _incident(self, kind: str, **detail) -> None:
        """Stage (or coalesce onto) an incident at the current fleet time —
        the one call every trigger site uses; a no-op when the recorder is
        off, so trigger sites carry no conditionals."""
        if self._incidents is not None:
            self._incidents.trigger(kind, self.now(), **detail)

    def _incident_context(self, st: dict, t0: float, t1: float) -> dict:
        """Router-side incident capture: ring windows (own + mirrors),
        merged trace events for the window restricted to in-flight and
        trigger uids, fleet/autoscale/upgrade state, SLO verdict, journal
        cursor. Host-memory reads ONLY — a dead replica cannot answer an
        RPC, and capture must never block the serve loop on one."""
        ctx: dict = {}
        rings: dict = {}
        if self._rings is not None:
            rings["router"] = self._rings.window_snapshot(t0, t1)
        if self._ring_mirror:
            rings["replicas"] = {
                rid: store.window_snapshot(t0, t1)
                for rid, store in self._ring_mirror.items()}
        if rings:
            ctx["rings"] = rings
        uids = set(self._owner)
        for ev in st.get("triggers", ()):
            if "uid" in ev:
                uids.add(int(ev["uid"]))
        events: list = []
        if self.tracer is not None:
            events.extend(self.tracer.events())
        for buf in self._trace_mirror.values():
            events.extend(buf)
        ctx["trace_events"] = sorted(
            (dict(ev) for ev in events
             if t0 <= float(ev.get("t", 0.0)) <= t1
             and (not uids or int(ev.get("uid", -1)) in uids)),
            key=lambda ev: (float(ev.get("t", 0.0)), int(ev.get("uid", 0))))
        ctx["fleet"] = {"replicas": {
            r.rid: {"state": r.state, "completed": r.completed,
                    "dispatched": r.dispatched,
                    "failed_over": r.failed_over,
                    "hung_verdicts": r.hung_verdicts}
            for r in self._replicas}}
        ctx["stats"] = self.router_stats()
        if self._autoscaler is not None:
            ctx["autoscale"] = self._autoscaler.describe()
        if self._upgrade is not None:
            ctx["upgrade"] = self._upgrade.status()
        if self._slo is not None and self._slo.last:
            ctx["slo"] = dict(self._slo.last)
        if self._journal is not None:
            ctx["journal"] = {
                "path": self._journal.path,
                "live_requests": len(self._journal.state.requests),
                "terminals": len(self._journal.state.terminals)}
        return ctx

    @property
    def incidents(self) -> Optional[IncidentRecorder]:
        """The router's incident recorder (None when off) — the gateway's
        ``/debug/incidents`` listing reads ``incidents.index()``."""
        return self._incidents

    # -- stepping --------------------------------------------------------

    def step(self, now: float | None = None, *,
             enforce_deadlines: bool = True) -> list[int]:
        """One fleet iteration: re-admit probation replicas whose backoff
        elapsed, then step every healthy/draining replica once (injecting
        ``replica_dead``/``replica_hang`` verdicts where armed), timing each
        step as its liveness heartbeat. Returns every uid that reached a
        terminal state across the fleet since the last call."""
        if now is None:
            now = time.perf_counter() - self._epoch
        tm = self.telemetry
        self._steps += 1
        if self._inj is not None and self._inj.router_crash(self._steps):
            # the control plane "dies" here: typed, pre-work, so the
            # journal holds exactly what a SIGKILL would have left behind
            tm.counter("resilience/injected_faults").inc()
            raise ControlPlaneCrash(
                f"fault injection: router_crash at router step {self._steps}")
        terminal: list[int] = self._pending_terminal
        self._pending_terminal = []
        for r in self._replicas:
            if r.state == "probation" and now >= r.readmit_at:
                r.state = "healthy"
                tm.counter("router/readmissions").inc()
                log_dist(f"router: replica {r.rid} re-admitted from "
                         f"probation", ranks=[0])
        for r in self._replicas:
            if not r.stepped:
                continue
            if self._inj is not None and self._inj.replica_dead(
                    r.rid, self._steps):
                tm.counter("resilience/injected_faults").inc()
                self._fail(r, "dead", now, terminal)
                continue
            t0 = time.perf_counter()
            try:
                uids = r.engine.step(now=now,
                                     enforce_deadlines=enforce_deadlines)
            except RpcTimeout as e:
                # the transport deadline elapsed with the call's outcome
                # unknown — the cross-process spelling of a step observed
                # past health.timeout: a HUNG verdict (probation, maybe the
                # process recovers), never a dead one
                log_dist(f"router: replica {r.rid} step timed out over RPC "
                         f"({e})", ranks=[0])
                self._fail(r, "hung", now, terminal)
                continue
            # dstpu: allow[broad-except] -- deliberately the widest net: ANY exception kind out of a replica step (typed RPC failure, in-process engine bug, codec error) means this replica cannot serve — the DEAD verdict + exactly-once failover below IS the typed handling
            except Exception as e:  # noqa: BLE001 — a dead worker IS an exception
                log_dist(f"router: replica {r.rid} step raised "
                         f"{type(e).__name__}: {e}", ranks=[0])
                self._fail(r, "dead", now, terminal)
                continue
            self._mirror_trace(r)
            self._mirror_rings(r)
            latency = time.perf_counter() - t0
            compiled = r.engine.last_step_compiled
            if self._inj is not None and self._inj.replica_hang(
                    r.rid, self._steps):
                tm.counter("resilience/injected_faults").inc()
                # synthetic heartbeat overrun: the verdict path under test
                # without wall-clock sleeps
                latency = max(latency, self.health.timeout * 2.0 + 1e-3)
                compiled = False
            if not compiled:
                # compiling steps are excluded from BOTH the latency
                # histogram and the hung verdict — a cold replica's first
                # step compiles for tens of seconds on real hardware, and
                # burning every request's exactly-once failover budget on
                # that is a false positive (same exclusion rule the
                # engine's latency histograms apply via last_call_compiled)
                tm.histogram("router/replica_step_sec").observe(latency)
                r.last_step_sec = latency
            # completions from this step are REAL even if the step then
            # draws a hung verdict — record before judging
            self._collect(r, uids, terminal)
            if (self.health.timeout > 0 and not compiled
                    and latency > self.health.timeout):
                self._fail(r, "hung", now, terminal)
                continue
            if not compiled:
                # only steps that survived the hung verdict count
                r.ok_steps += 1
            if r.state == "draining" and r.engine.idle:
                r.state = "drained"
                tm.counter("router/replicas_drained").inc()
                log_dist(f"router: replica {r.rid} drained and detached",
                         ranks=[0])
                self._update_gauges()
        if self.disagg.enabled:
            # after the fleet stepped: prefills that finished THIS step are
            # parked and ready, decode slots that freed THIS step can admit
            self._pump_handoffs(now, terminal)
        tm.gauge("router/queue_depth").set(
            sum(r.engine.queue_len for r in self._replicas if r.stepped))
        self._update_gauges()
        self._sample_rings(now)
        if (self._slo is not None and math.isfinite(now)
                and now >= self._next_slo_t):
            self._next_slo_t = now + self._slo.cfg.eval_interval_s
            verdict = self._slo.evaluate(now)
            if verdict.get("breach_rising"):
                self._incident("slo_fast_burn",
                               dims=verdict.get("breach_dims", []),
                               burn=verdict.get("burn", {}))
        if (self._incidents is not None and self._incidents.pending
                and math.isfinite(now)):
            self._incidents.tick(now, self._incident_context)
        if self._upgrade is not None and self._upgrade.state == "running":
            self._upgrade.tick(now)
        elif self._autoscaler is not None:
            # the elasticity loop closes here: every fleet step evaluates
            # the scaling signals (worker boots run on background threads;
            # a later tick attaches them). Autoscale evaluation PAUSES while
            # a rolling upgrade runs: the upgrade churns membership on
            # purpose, and its transient double capacity would read as
            # idleness
            self._autoscaler.tick(now)
        return terminal

    # -- draining / run loops -------------------------------------------

    def drain_replica(self, rid: int, *, block: bool = True) -> None:
        """Rolling-restart drain: stop dispatching to replica ``rid``,
        migrate its still-QUEUED requests to accepting siblings (not a
        failover — nothing failed, so the exactly-once budget is untouched),
        let in-flight prefills/decodes finish in place, then detach
        (state ``drained``). With no accepting sibling the queued requests
        stay and finish HERE before detach — drain never strands or sheds an
        accepted request. ``block=False`` returns after migration; the
        replica detaches during subsequent ``step()`` calls."""
        r = self._replicas[rid]
        if r.state != "healthy":
            raise ValueError(
                f"replica {rid} is {r.state}; only a healthy replica can "
                "start draining")
        r.state = "draining"
        self.telemetry.counter("router/drains").inc()
        self._update_gauges()
        # under disaggregation queued work exists only on prefill replicas,
        # and a migrated request must land in the SAME pool (a decode
        # replica would never prefill it)
        targets = (self._accepting(r.role) if self.disagg.enabled
                   else self._accepting())
        if targets:
            for req in list(r.engine.live_requests()):
                if self._owner.get(req.uid) != r.rid:
                    continue
                # never migrate onto a replica that already held this uid
                # (e.g. it cancelled the uid in a past hung-failover — its
                # engine's duplicate-uid guard would reject the requeue);
                # with no clean target the request simply finishes in place
                # on the draining replica, which keeps stepping
                eligible = [t for t in targets
                            if t.rid not in self._seen.get(req.uid, set())]
                if not eligible:
                    continue
                w = r.engine.withdraw(req.uid)
                if w is None:
                    continue  # already admitted — finishes in place
                tgt = self._pick(eligible, w)
                try:
                    tgt.engine.requeue(w)
                except RpcError:
                    # sibling transport died mid-migration: hand the
                    # request back to the draining replica (usually alive —
                    # we were just mid-conversation with it) to finish in
                    # place; the sibling's dead verdict lands on its next
                    # step
                    try:
                        r.engine.requeue(w)
                    except RpcError:
                        # both transports failed with the request held by
                        # NO engine — spend its failover budget rather
                        # than strand the uid (the payload is still in
                        # self._requests; _failover re-queues it on a
                        # clean replica or fails it terminally)
                        self._failover(w, self._pending_terminal,
                                       from_rid=r.rid)
                    continue
                self._owner[w.uid] = tgt.rid
                self._seen.setdefault(w.uid, set()).add(tgt.rid)
                tgt.dispatched += 1
                r.drained += 1
                self.telemetry.counter("router/migrated_requests").inc()
        log_dist(f"router: draining replica {rid} "
                 f"({r.drained} queued requests migrated, "
                 f"{r.engine.load} finishing in place)", ranks=[0])
        if block:
            while r.state == "draining":
                now = time.perf_counter() - self._epoch
                self.step()
                # future-dated queued work (no accepting sibling took it)
                # finishes at wall-clock pace — idle-wait instead of
                # hot-looping host scans, mirroring serve()
                pending = r.engine.pending_arrival_times()
                if (all(x.engine.idle for x in self._replicas if x.stepped)
                        and pending):
                    wait = min(pending) - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))

    def drain(self) -> dict[int, RequestResult]:
        """Run the whole fleet to completion (ignoring arrival times and
        deadlines, like ``ServingEngine.drain``); returns all results."""
        while self._owner:
            self.step(now=float("inf"), enforce_deadlines=False)
        if self._incidents is not None and self._incidents.pending:
            # a trigger staged during the final steps would otherwise wait
            # forever for window_after_s of fleet time that never comes
            self._incidents.flush(self._incident_context)
        return dict(self._results)

    def serve(self, requests: list[Request]) -> dict[int, RequestResult]:
        """Wall-clock loop mirroring ``ServingEngine.serve``: submit each
        request (a load-shed one still gets a ``shed_*`` result rather than
        an exception), then step the fleet until every submitted uid is
        terminal."""
        if not self._owner:
            self._epoch = time.perf_counter()
            for r in self._replicas:
                r.engine.set_epoch(self._epoch)
        target = set()
        for req in sorted(requests, key=lambda r: r.arrival_time):
            try:
                target.add(self.submit(req))
            except RequestRejected as e:
                self._synth_result(req, "shed_" + e.reason)
                target.add(req.uid)
        while not target <= set(self._results):
            now = time.perf_counter() - self._epoch
            busy = any(not r.engine.idle for r in self._replicas if r.stepped)
            if not busy:
                pending = [t for r in self._replicas if r.stepped
                           for t in r.engine.pending_arrival_times()]
                if pending:
                    wait = min(pending) - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
            self.step()
        return {u: self._results[u] for u in target}

    # -- fleet membership ------------------------------------------------

    def _spawn_inprocess(self, role: str | None = None) -> ServingEngine:
        """One more in-process replica from the constructor's engine and
        per-replica config: the autoscaler's and the rolling upgrade's
        default newcomer. It runs on the thread that steps the fleet, and
        on the card it captures its decode graph here, before it takes
        traffic (a capture must never overlap another thread's device
        work; a prefill-role newcomer captures none). ``role`` pins it to
        a disaggregated pool (per-pool scale-up)."""
        if self._base_engine is None:
            raise ValueError(
                "this fleet was built from prebuilt replica_engines; give "
                "the autoscaler a spawn callable or a WorkerSupervisor")
        e = ServingEngine(self._base_engine, config=self._sub_config,
                          replica_id=len(self._replicas), role=role or "both")
        if e.worker.device.type == "cuda":
            e.warm_decode()
        return e

    def attach_replica(self, engine) -> int:
        """Grow the fleet at runtime — the worker supervisor's respawn
        path: a SIGKILL'd worker's replacement process joins as a NEW
        replica id (the dead rid stays detached; a fresh process must not
        inherit its predecessor's exactly-once history or drain state).
        ``engine`` is anything with the scheduler surface — an in-process
        ``ServingEngine`` or an ``rpc.ReplicaClient``."""
        rid = len(self._replicas)
        if hasattr(engine, "bind_telemetry"):
            engine.bind_telemetry(self.telemetry)
        engine.set_epoch(self._epoch)
        if self._stream_progress and hasattr(engine, "stream_progress"):
            # a streaming front door is attached: joiners piggyback
            # tokens-so-far like the rest of the fleet
            engine.stream_progress = True
        self._replicas.append(_Replica(
            rid, engine, role=str(getattr(engine, "role", "both") or "both")))
        self.telemetry.gauge("router/replicas").set(len(self._replicas))
        self.telemetry.counter("router/replicas_attached").inc()
        self._update_gauges()
        log_dist(f"router: attached replica {rid} "
                 f"({len(self._accepting())} accepting dispatch)", ranks=[0])
        return rid

    # -- rolling upgrades -------------------------------------------------

    def rolling_upgrade(self, *, supervisor=None, slots: dict | None = None,
                        spawn=None, spec: dict | None = None,
                        gate_timeout_s: float = 120.0,
                        canary: bool = True,
                        canary_prompt=None,
                        canary_max_new: int = 2) -> None:
        """Begin a zero-downtime replica-by-replica fleet upgrade. For each
        replica that was healthy when the upgrade started, one WAVE:

          1. boot the NEW generation first (``supervisor.spawn`` on a
             background thread, so the fleet keeps stepping, or the
             ``spawn`` callable / ``_spawn_inprocess``, run inline on the
             stepping thread),
          2. ``attach_replica`` it and GATE on its first healthy
             non-compiling step plus, with ``canary`` on (the default), a
             canary generate served end to end by the newcomer: a tiny
             request in the RESERVED uid band (>= 2**62), submitted to the
             newcomer's scheduler directly (never journaled, never traced
             as user traffic) and driven by the ordinary fleet steps. A
             newcomer that dies, hangs, fails its canary or misses the gate
             within ``gate_timeout_s`` (fleet clock) ABORTS the upgrade:
             the old generation keeps serving, the newcomer is drained and
             retired. ``canary_prompt`` (default ``[1, 1, 1, 1]``) must be
             valid token ids for the model,
          3. only then ``drain_replica`` the old generation (queued work
             migrates, in-flight streams finish in place) and retire it.

        ``supervisor``/``slots`` follow the Autoscaler's contract: ``slots``
        maps attached rids to their supervisor slots, newcomers take fresh
        slots. ``spec`` (with a supervisor) installs the new generation's
        engine spec (``WorkerSupervisor.set_spec``) before the first boot.
        ``step()`` ticks the state machine; poll ``upgrade_status()``.
        Autoscale evaluation pauses meanwhile."""
        if self._upgrade is not None and self._upgrade.state == "running":
            raise ValueError("a rolling upgrade is already in progress")
        self.telemetry.counter("router/upgrades").inc()
        self._upgrade = _RollingUpgrade(
            self, supervisor=supervisor, slots=slots, spawn=spawn,
            spec=spec, gate_timeout_s=gate_timeout_s, canary=canary,
            canary_prompt=canary_prompt, canary_max_new=canary_max_new)
        log_dist(
            f"router: rolling upgrade started over replicas "
            f"{self._upgrade.plan} (gate: first healthy non-compiling step"
            f"{' + served canary' if canary else ''}, "
            f"{gate_timeout_s}s timeout)", ranks=[0])

    def upgrade_status(self) -> Optional[dict]:
        """State of the current/last rolling upgrade (None if never
        started): ``{state, reason, pending, current, waves, slots}``."""
        return None if self._upgrade is None else self._upgrade.status()

    # -- observability ---------------------------------------------------

    @property
    def results(self) -> dict[int, RequestResult]:
        return dict(self._results)

    def result(self, uid: int) -> Optional[RequestResult]:
        """The terminal result for ``uid`` (None while in flight) — the
        O(1) accessor; the ``results`` property copies the whole map."""
        return self._results.get(uid)

    def owner_of(self, uid: int) -> Optional[int]:
        """Replica id currently holding live request ``uid`` (None once
        terminal/unknown) — chaos drills target their kills with this."""
        return self._owner.get(uid)

    def replica_states(self) -> dict[int, str]:
        return {r.rid: r.state for r in self._replicas}

    def router_stats(self) -> dict:
        """Host-side fleet view: per-replica health state and traffic
        counts — the table ``python -m deepspeed_tpu.telemetry.report``
        renders."""
        out = {
            "steps": self._steps,
            "live_requests": len(self._owner),
            # failed-over requests whose replay COMPLETED ok — the
            # "recovered" number the bench smoke asserts on
            "failovers_recovered": sum(
                1 for uid, n in self._failovers.items()
                if n and uid in self._results and self._results[uid].ok),
            "replicas": {
                r.rid: {
                    "state": r.state,
                    "role": r.role,
                    "dispatched": r.dispatched,
                    "failed_over": r.failed_over,
                    "drained": r.drained,
                    "completed": r.completed,
                    "hung_verdicts": r.hung_verdicts,
                    "load": r.engine.load,
                } for r in self._replicas
            },
        }
        if self._tenants:
            live = self._tenant_live_counts()
            out["tenants"] = {
                t: {
                    "weight": tc.weight,
                    "max_queued": tc.max_queued,
                    "live": live.get(t, 0),
                    "over_quota": (tc.max_queued > 0
                                   and live.get(t, 0) > tc.max_queued),
                } for t, tc in sorted(self._tenants.items())
            }
        if self._inj is not None:
            out["fault_injection"] = self._inj.stats()
        if self.disagg.enabled:
            out["disagg"] = {
                "prefill_replicas": len(self._accepting("prefill")),
                "decode_replicas": len(self._accepting("decode")),
                "handoffs": self._handoffs_done,
                "parked_backlog": self._handoff_backlog,
            }
        spec = self._spec_aggregate()
        if spec is not None:
            out["speculation"] = spec
        return out

    def _spec_aggregate(self) -> Optional[dict]:
        """Fleet-wide speculative-decoding totals summed over every replica
        that has reported a stats block — in-process engines answer
        directly, worker processes via the step-reply piggyback cache
        (``rpc.ReplicaClient.spec_stats``; zero extra RPCs). A dead
        replica's last-known counts stay in the sum. None when no replica
        has the feature on."""
        drafted = accepted = steps = 0
        enabled = False
        for r in self._replicas:
            fn = getattr(r.engine, "spec_stats", None)
            s = fn() if fn is not None else None
            if not s:
                continue
            enabled = True
            drafted += int(s.get("drafted", 0))
            accepted += int(s.get("accepted", 0))
            steps += int(s.get("verify_steps", 0))
        if not enabled:
            return None
        return {
            "enabled": True,
            "drafted": drafted,
            "accepted": accepted,
            "verify_steps": steps,
            "acceptance_rate": (accepted / drafted) if drafted else 0.0,
        }

    def telemetry_snapshot(self, emit: bool = True) -> dict:
        """The fleet in one call: the router's own registry + per-replica
        ``ServingEngine.telemetry_snapshot()``s, kept under their replica
        ids so counter names never collide across replicas. Appended to the
        router's JSONL sink (type ``snapshot``) when one is configured —
        ``emit=False`` skips that (the gateway's periodic ``/metrics``
        refresh must not grow the JSONL on a scrape cadence)."""
        reps: dict = {}
        for r in self._replicas:
            try:
                reps[r.rid] = r.engine.telemetry_snapshot()
            except (RpcError, OSError) as e:  # a gone process can't report
                # the replica cannot report (SIGKILL'd worker, closed
                # transport): substitute the router-side trace mirror so
                # the merged request_timeline() still shows every event the
                # replica flushed before dying
                reps[r.rid] = {
                    "replica_id": r.rid,
                    "unreachable": f"{type(e).__name__}: {e}",
                    "request_trace": list(self._trace_mirror.get(r.rid, ())),
                }
                stats_fn = getattr(r.engine, "rpc_stats", None)
                if stats_fn is not None:
                    reps[r.rid]["transport"] = stats_fn()
        snap = {
            "router": {
                "metrics": self.telemetry.registry.snapshot(),
                **self.router_stats(),
                **({"request_trace": self.tracer.events()}
                   if self.tracer is not None else {}),
                **({"autoscale": self._autoscaler.describe()}
                   if self._autoscaler is not None else {}),
                **({"upgrade": self._upgrade.status()}
                   if self._upgrade is not None else {}),
                **({"rings": {
                        "router": self._rings.snapshot(),
                        **({"replicas": {
                                rid: s.snapshot() for rid, s
                                in self._ring_mirror.items()}}
                           if self._ring_mirror else {})}}
                   if self._rings is not None else {}),
                **({"slo": dict(self._slo.last)}
                   if self._slo is not None and self._slo.last else {}),
                **({"incidents": self._incidents.index()}
                   if self._incidents is not None else {}),
            },
            "replicas": reps,
        }
        if emit:
            self.telemetry.emit({"type": "snapshot", **snap})
        return snap


class _RollingUpgrade:
    """Replica-by-replica generation replacement, as a state machine ticked
    by ``Router.step()``: the upgrade never stalls the serve loop (clients
    are streaming tokens while it runs). One wave per replica that was
    healthy at start; within a wave the phases are

        boot -> gate -> drain        (success: old generation retired)
                  \\-> abort_drain    (failure: NEWCOMER drained/retired,
                                      old generation keeps serving, the
                                      whole upgrade stops)

    The gate is the newcomer's first healthy NON-COMPILING step
    (``_Replica.ok_steps``) plus its canary: a replacement that boots but
    cannot serve must never cost the fleet its proven old generation.
    Supervisor boots run on a background thread (the autoscaler's
    discipline; a boot there touches no device in this process); in-process
    builds run inline on the stepping thread, where the newcomer captures
    its decode graph. A retired in-process replica is ``close()``d, which
    frees its slot cache, prefix pool and graph."""

    def __init__(self, router: Router, *, supervisor=None,
                 slots: dict | None = None, spawn=None,
                 spec: dict | None = None, gate_timeout_s: float = 120.0,
                 canary: bool = True, canary_prompt=None,
                 canary_max_new: int = 2):
        self.router = router
        self.supervisor = supervisor
        self.slots: dict[int, int] = dict(slots or {})  # rid -> slot
        self._spawn_fn = spawn
        self.gate_timeout_s = float(gate_timeout_s)
        self.canary = bool(canary)
        self.canary_prompt = (np.asarray([1, 1, 1, 1], np.int32)
                              if canary_prompt is None
                              else np.asarray(canary_prompt, np.int32))
        self.canary_max_new = int(canary_max_new)
        self.state = "running"
        self.reason = ""
        self.plan: list[int] = [r.rid for r in router._replicas
                                if r.state == "healthy"]
        self.waves: list[dict] = []
        self._wave: Optional[dict] = None
        self._boot: Optional[dict] = None
        self._next_slot = max(self.slots.values(), default=-1) + 1
        asc = router._autoscaler
        if asc is not None:
            # a bound autoscaler owns the SAME slot namespace: newcomer
            # slots must not collide with ones it may allocate later, and
            # its rid->slot ledger must track every wave
            self._next_slot = max(self._next_slot, asc._slot_seq)
        if supervisor is not None and spec is not None:
            # the new generation's spec: running workers keep the old one
            # until their wave's retire->spawn replaces them
            supervisor.set_spec(spec)

    def _ledger_attach(self, rid: int, slot) -> None:
        """Record a newcomer in this upgrade's map AND the autoscaler's."""
        if slot is None:
            return
        self.slots[rid] = slot
        asc = self.router._autoscaler
        if asc is not None:
            asc._slots[rid] = slot
            asc._slot_seq = max(asc._slot_seq, slot + 1)

    def _ledger_retire(self, rid: int):
        """Drop ``rid`` from both maps; returns its slot (or None)."""
        slot = self.slots.pop(rid, None)
        asc = self.router._autoscaler
        if asc is not None:
            asc._slots.pop(rid, None)
        return slot

    # -- boots ------------------------------------------------------------

    def _begin_boot(self) -> None:
        holder: dict = {"slot": None, "result": None, "error": None,
                        "thread": None}
        if self.supervisor is None:
            # in-process replacement: same engine + config, built (and on
            # the card captured) inline on the stepping thread
            try:
                holder["result"] = (self._spawn_fn() if self._spawn_fn
                                    else self.router._spawn_inprocess())
            except (RpcError, OSError, RuntimeError) as e:
                holder["error"] = e
            self._boot = holder
            return
        slot = self._next_slot
        self._next_slot += 1
        holder["slot"] = slot

        def run():
            try:
                holder["result"] = self.supervisor.spawn(slot)
            except (RpcError, OSError, RuntimeError) as e:
                holder["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"dstt-upgrade-boot-{slot}")
        holder["thread"] = t
        self._boot = holder
        t.start()

    # -- the tick ----------------------------------------------------------

    def tick(self, now: float) -> None:
        if self.state != "running":
            return
        if self._wave is None:
            if not self.plan:
                self.state = "done"
                log_dist(
                    f"router: rolling upgrade complete "
                    f"({len([w for w in self.waves if w.get('outcome') == 'upgraded'])} "
                    f"replicas replaced)", ranks=[0])
                return
            old = self.plan.pop(0)
            if self.router._replicas[old].state != "healthy":
                # died or was drained since the plan snapshot: nothing
                # left to upgrade in this wave
                self.waves.append({"old_rid": old, "outcome": "skipped"})
                return
            self._wave = {"old_rid": old, "new_rid": None, "phase": "boot",
                          "started": round(now, 4)}
            self._begin_boot()
            return
        w = self._wave
        if w["phase"] == "boot":
            b = self._boot
            if b["thread"] is not None and b["thread"].is_alive():
                return  # still booting; the fleet keeps stepping
            if b["error"] is not None:
                self._abort(now, "newcomer boot failed: "
                            f"{type(b['error']).__name__}: {b['error']}",
                            boot_slot=b["slot"])
                return
            new_rid = self.router.attach_replica(b["result"])
            self._ledger_attach(new_rid, b["slot"])
            w["new_rid"] = new_rid
            w["phase"] = "gate"
            w["gate_start"] = now
            return
        if w["phase"] == "gate":
            new_r = self.router._replicas[w["new_rid"]]
            if new_r.state == "dead":
                self._abort(now, f"newcomer replica {w['new_rid']} died "
                            "before its first healthy step")
                return
            if self.canary and w.get("canary_uid") is None:
                # per-wave canary in the RESERVED uid band, submitted to the
                # newcomer's scheduler directly: never journaled, never
                # dispatched elsewhere, out of user timelines. Its deadline
                # bounds an abort-drain it could otherwise pin open, and
                # its arrival is NOW on the fleet clock (deadlines are
                # arrival + deadline_s)
                uid = RESERVED_UID_BASE + next(_canary_uids)
                try:
                    new_r.engine.submit(Request(
                        uid=uid, prompt=self.canary_prompt,
                        max_new_tokens=self.canary_max_new,
                        arrival_time=now,
                        deadline_s=max(1.0, self.gate_timeout_s)))
                except (RpcError, OSError, ValueError) as e:
                    self._abort(now, f"newcomer replica {w['new_rid']} "
                                f"refused its canary generate "
                                f"({type(e).__name__}: {e})")
                    return
                w["canary_uid"] = uid
            canary_ok = True
            if self.canary:
                try:
                    res = new_r.engine.result(w["canary_uid"])
                except (RpcError, OSError):
                    res = None  # transport hiccup: the timeout governs
                if res is not None and not res.ok:
                    self._abort(now, f"newcomer replica {w['new_rid']} "
                                f"failed its canary generate "
                                f"(status {res.status})")
                    return
                canary_ok = res is not None and res.ok
                if canary_ok:
                    w["canary_status"] = res.status
            if new_r.state == "healthy" and new_r.ok_steps >= 1 and canary_ok:
                # newcomer proven (booted, stepped clean, served a request
                # end to end): NOW the old generation may go
                self.router.drain_replica(w["old_rid"], block=False)
                w["phase"] = "drain"
                return
            if now - w["gate_start"] > self.gate_timeout_s:
                self._abort(now, f"newcomer replica {w['new_rid']} never "
                            "passed the gate (healthy non-compiling step"
                            + (" + served canary" if self.canary else "")
                            + f") within {self.gate_timeout_s}s")
            return
        if w["phase"] in ("drain", "abort_drain"):
            rid = w["old_rid"] if w["phase"] == "drain" else w["new_rid"]
            if self.router._replicas[rid].state == "draining":
                return
            # drained, or dead (the router already failed its in-flight
            # work over): either way the replica can go
            self._retire(rid)
            if w["phase"] == "drain":
                w["outcome"] = "upgraded"
                self.router.telemetry.counter("router/upgrade_waves").inc()
                log_dist(
                    f"router: upgrade wave done — replica {w['old_rid']} "
                    f"retired, replica {w['new_rid']} serving", ranks=[0])
                self.waves.append(w)
                self._wave = None
            else:
                w["outcome"] = "aborted"
                self.waves.append(w)
                self._wave = None
                self.state = "aborted"

    def _retire(self, rid: int) -> None:
        """Retire a replica that left the fleet: its worker slot, or, for
        an in-process replica, its device memory (``close()``)."""
        slot = self._ledger_retire(rid)
        if slot is None:
            self.router.release_replica(rid)
        self._retire_slot(slot)

    def _retire_slot(self, slot) -> None:
        """Retire a worker slot WITHOUT stalling the serve loop:
        ``WorkerSupervisor.retire`` SIGTERMs then waits up to its timeout,
        and a slow-to-exit old generation must not freeze every client's
        token stream for that long. Fire-and-forget is safe: the replica
        is already drained or dead, so nothing routes to it."""
        if slot is None or self.supervisor is None:
            return

        def run():
            try:
                self.supervisor.retire(slot)
            except OSError:  # a corpse's slot: reaping is best-effort
                pass

        threading.Thread(target=run, daemon=True,
                         name=f"dstt-upgrade-retire-{slot}").start()

    def _abort(self, now: float, reason: str, boot_slot=None) -> None:
        """Keep the OLD generation serving. A failed-boot newcomer only
        needs its slot reaped; an attached-but-unproven one is drained
        first (dispatch may already have routed arrivals to it: no accepted
        request is lost on the abort path either)."""
        self.reason = reason
        self.router.telemetry.counter("router/upgrade_aborts").inc()
        self.router._incident("upgrade_abort", reason=reason)
        log_dist(f"router: rolling upgrade ABORTED — {reason} (old "
                 "generation keeps serving)", ranks=[0])
        w = self._wave
        if w and w.get("canary_uid") is not None \
                and w.get("new_rid") is not None:
            # free the pending canary so the newcomer's abort-drain is not
            # pinned open by a request it can never serve
            try:
                self.router._replicas[w["new_rid"]].engine.cancel(
                    w["canary_uid"])
            except (RpcError, OSError):
                pass  # a dead/hung newcomer cannot acknowledge
        self._retire_slot(boot_slot)
        new_rid = w.get("new_rid") if w else None
        if new_rid is not None and \
                self.router._replicas[new_rid].state == "healthy":
            self.router.drain_replica(new_rid, block=False)
            w["phase"] = "abort_drain"
            return
        if new_rid is not None:
            self._retire(new_rid)
        if w is not None:
            w["outcome"] = "aborted"
            self.waves.append(w)
        self._wave = None
        self.state = "aborted"

    def status(self) -> dict:
        return {
            "state": self.state,
            "reason": self.reason,
            "pending": list(self.plan),
            "current": dict(self._wave) if self._wave else None,
            "waves": [dict(w) for w in self.waves],
            "slots": dict(self.slots),
        }


__all__ = ["Router", "tenant_idem_key"]
