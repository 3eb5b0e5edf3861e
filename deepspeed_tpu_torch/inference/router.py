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

``step()`` returns every uid that reached a terminal state since the last
call, across all replicas. Replicas are in-process (built from
``engine`` + ``config``, sharing its parameters, each with its own slot
cache, generator and decode graph) or prebuilt ``replica_engines``: any
mix of ``ServingEngine``s and ``rpc.ReplicaClient``s fronting worker
processes (``launcher/serving_worker.py``). An ``RpcTimeout`` is a HUNG
verdict, any other transport failure DEAD.

Not ported yet, each refused by name when its config enables it:
``router.autoscale`` (and ``bind_autoscaler``), ``router.disagg`` (the
prefill/decode pools and their KV handoff), ``rolling_upgrade``, the
``gateway`` block, and the ``timeseries`` / ``slo`` / ``incidents``
stores.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from ..resilience import (ControlPlaneCrash, FaultInjector,
                          JournalUnavailableError, RequestRejected,
                          RpcError, RpcTimeout)
from ..resilience.retry import backoff_delay
from ..runtime.config import (FaultInjectionConfig, GatewayConfig,
                              RequestTraceConfig, RouterConfig,
                              RouterHealthConfig, TenantConfig)
from ..telemetry import RequestTracer, Telemetry
from ..utils.logging import log_dist
from .engine import InferenceEngine
from .serving import Request, RequestResult, ServingEngine

# fleet observability blocks of the JAX Router the port has not got
_UNPORTED_BLOCKS = ("timeseries", "slo", "incidents")


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
    role: str = "both"       # scheduler role (the port serves "both")
    state: str = "healthy"
    hung_verdicts: int = 0
    readmit_at: float = 0.0  # router-clock time probation ends
    dispatched: int = 0      # requests routed here (submit + failover in)
    failed_over: int = 0     # requests moved OFF on a dead/hung verdict
    drained: int = 0         # queued requests migrated off at drain time
    completed: int = 0       # terminal results recorded from this replica
    last_step_sec: float = 0.0  # latest non-compiling step latency
    ok_steps: int = 0        # completed non-compiling steps

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
        rc = config.get("router", {})
        if isinstance(rc, dict):
            rc = RouterConfig(**rc)
        rc.check_ported()
        gw = config.get("gateway", {})
        (GatewayConfig(**gw) if isinstance(gw, dict) else gw).check_ported()
        for name in _UNPORTED_BLOCKS:
            blk = config.get(name)
            on = blk.get("enabled", False) if isinstance(blk, dict) else getattr(blk, "enabled", False)
            if on:
                raise NotImplementedError(
                    f"serving config block {name!r} (the fleet's flight recorder) is not ported to "
                    "deepspeed_tpu_torch yet")
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
        fi.check_ported()
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
                self._replicas.append(_Replica(rid, e))
        else:
            for rid in range(rc.replicas):
                # one InferenceEngine's parameters; each replica its own
                # slot cache, prefix pool, generator and decode graph
                e = ServingEngine(engine, config=sub, replica_id=rid)
                # one clock across the fleet: replica-relative timings
                # (queue wait, TTFT) stay comparable and step(now=...) means
                # the same instant on every replica
                e.set_epoch(self._epoch)
                self._replicas.append(_Replica(rid, e))
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

    # -- dispatch --------------------------------------------------------

    def _accepting(self) -> list[_Replica]:
        return [r for r in self._replicas if r.accepts]

    def _dispatch_targets(self) -> list[_Replica]:
        """Replicas eligible for NEW request dispatch and for failover
        replays, which re-run admission and prefill from scratch."""
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
            log_dist(
                "router: BROWNOUT on ("
                + (f"{deadline_s}s deadline for deadline-free requests, "
                   if deadline_s else "no deadline tightening, ")
                + "priority shedding armed)", ranks=[0])
        elif not on and self._brownout:
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
        raise NotImplementedError(
            "Router.bind_autoscaler (the elastic fleet, inference/autoscaler.py) is not ported to "
            "deepspeed_tpu_torch yet")

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
            closer = getattr(r.engine, "close", None)
            if closer is not None:
                # a remote replica's client is closed so later snapshots /
                # cancels fail FAST instead of paying reconnect backoff
                # toward a process that is gone
                try:
                    closer()
                except (RpcError, OSError):  # teardown is best-effort
                    pass
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

    def _update_gauges(self) -> None:
        tm = self.telemetry
        tm.gauge("router/healthy_replicas").set(
            sum(1 for r in self._replicas if r.state == "healthy"))
        tm.gauge("router/live_requests").set(len(self._owner))

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
        tm.gauge("router/queue_depth").set(
            sum(r.engine.queue_len for r in self._replicas if r.stepped))
        self._update_gauges()
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
        targets = self._accepting()
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
        self._replicas.append(_Replica(rid, engine))
        self.telemetry.gauge("router/replicas").set(len(self._replicas))
        self.telemetry.counter("router/replicas_attached").inc()
        self._update_gauges()
        log_dist(f"router: attached replica {rid} "
                 f"({len(self._accepting())} accepting dispatch)", ranks=[0])
        return rid

    # -- rolling upgrades -------------------------------------------------

    def rolling_upgrade(self, **kwargs) -> None:
        raise NotImplementedError(
            "Router.rolling_upgrade (worker-by-worker generation replacement) is not ported to "
            "deepspeed_tpu_torch yet")

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
            },
            "replicas": reps,
        }
        if emit:
            self.telemetry.emit({"type": "snapshot", **snap})
        return snap


__all__ = ["Router", "tenant_idem_key"]
