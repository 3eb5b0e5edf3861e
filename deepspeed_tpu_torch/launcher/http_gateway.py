"""HTTP/SSE front door (the port of ``deepspeed_tpu/launcher/http_gateway.py``):
one ``inference/router.Router`` behind a stdlib HTTP/1.1 server
(``http.server`` + ``threading``). Status codes, JSON bodies and SSE event
names and fields are the JAX gateway's.

  * ``POST /v1/generate``: JSON ``{"prompt": [ints], "max_new_tokens",
    "temperature", "top_k", "top_p", "eos_token", "stream"}`` with the
    ``X-DSTPU-Priority`` / ``X-DSTPU-Deadline-S`` headers. With ``stream``
    (the default) the reply is Server-Sent Events: one ``token`` event per
    generated token (its ``id:`` the token index) from the Router's
    ``partial_result``, then one ``done`` event with the terminal result;
    ``"stream": false`` waits and returns one JSON document.
  * session resume: ``X-DSTPU-Idempotency-Key`` maps durably (through the
    Router's journal) to the uid it first minted, so a retry gets the same
    uid, or the journaled result, never a second request; with
    ``Last-Event-ID: <n>`` the stream resumes at token ``n+1``.
  * typed rejections map to statuses: ``queue_full`` / ``overloaded`` /
    ``tenant_quota`` 429, ``forbidden`` 403, ``no_healthy_replicas`` /
    ``shutting_down`` / ``journal_unavailable`` 503, each with
    ``Retry-After`` (configured, or the autoscaler's cooldown); a malformed
    body 400, an oversized one 413.
  * tenants (``serving.gateway.auth``): ``Authorization: Bearer <token>``,
    hashed and compared digest to digest in constant time (the raw token is
    never stored or logged): 401 missing, 403 unknown, 429 with a
    per-tenant ``Retry-After`` when its token bucket is empty.
  * a client that disconnects, or stops reading past
    ``gateway.write_timeout_s``, is detected at the stream's next write
    (token events, or ~1 s keepalive comments) and its request is
    cancelled, which frees its slot and prefix references.
  * ``GET /healthz`` (200 serving, 503 draining or no healthy replica) and
    ``GET /metrics`` (the fleet registry as Prometheus text, or
    ``telemetry.prometheus_fleet_text`` of the fleet snapshot on the
    ``metrics_fleet_refresh_s`` cadence).
  * SIGTERM / SIGINT (``run()``, through ``resilience/preemption.
    PreemptionGuard``): stop accepting (503 ``shutting_down``), finish the
    open streams within ``shutdown_grace_s``, return 0.

Threading: exactly ONE thread, the serve loop (``run()``'s caller or
``start()``'s daemon), touches the Router, and so every device call and
every CUDA-graph capture of an in-process replica happens there. Handler
threads parse JSON into numpy, enqueue a command (submit / cancel, each
with a reply event) and read per-stream token feeds that the loop publishes
after every ``Router.step()`` from ``partial_result``, which reads host
state only. ``on_tick`` runs on the loop thread each iteration: drills do
their membership changes there (respawns, an upgrade's start).

Fault sites (``resilience/faults.py``): ``gateway_disconnect`` makes a
stream's write path observe a vanished client after its Nth token,
``gateway_stall`` a reader that stops draining; both take the real
disconnect -> cancel path.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import queue
import socket
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..inference.router import tenant_idem_key
from ..inference.serving import Request
from ..resilience import FaultInjector, RequestRejected
from ..resilience.preemption import PreemptionGuard
from ..runtime.config import (FaultInjectionConfig, GatewayAuthConfig,
                              GatewayConfig)
from ..telemetry import (RequestTracer, prometheus_fleet_text,
                         prometheus_text)
from ..utils.logging import log_dist

# RequestRejected reason -> HTTP status. 429 = the CLIENT should back off
# and retry (capacity exists or is being added); 503 = the fleet itself
# cannot serve (no healthy replica / shutting down); 403 = the caller is
# authenticated but not allowed to touch what it asked for.
_REASON_STATUS = {
    "queue_full": 429,
    "overloaded": 429,
    "tenant_quota": 429,
    "forbidden": 403,
    "no_healthy_replicas": 503,
    "shutting_down": 503,
    # the request journal failed closed (ENOSPC / write failure): the
    # fleet refuses new promises until the control plane restarts over
    # the durable prefix — a server-side outage, not client pressure
    "journal_unavailable": 503,
}


class _Server(ThreadingHTTPServer):
    """The stdlib server with a listen backlog for bursts: its default of 5
    pending connections overflows when tens of clients connect at once (a
    traffic burst, a fleet of clients reconnecting after a restart)."""

    request_queue_size = 128
    daemon_threads = True


class _TenantGate:
    """Gateway-side tenant auth + token-bucket rate limiting
    (docs/serving.md "Multi-tenant isolation"). Handler threads hit this
    concurrently, so the bucket state carries its OWN lock — the Router
    is never touched from here.

    Secret hygiene: the config stores only SHA-256 digests; a presented
    bearer token is hashed transiently and compared digest-to-digest with
    ``hmac.compare_digest`` (constant-time). The raw token is never
    stored on the gateway, never interpolated into an error message, and
    never reaches a log line, journal record, trace event, or metric (the
    ``secret-hygiene`` lint rule holds the package to it)."""

    def __init__(self, auth: GatewayAuthConfig, clock=time.monotonic):
        self.enabled = bool(auth.enabled)
        self.tenants = dict(auth.tenants)  # tenant id -> TenantConfig
        self._clock = clock
        self._lock = threading.Lock()
        self._level = {t: float(tc.burst)
                       for t, tc in self.tenants.items()}
        self._stamp = {t: float(clock()) for t in self.tenants}

    def authenticate(self, authorization: str | None) -> str:
        """The tenant id the ``Authorization`` header proves, or ``""``
        with auth disabled. Raises ``_HttpError``: 401 for a missing or
        malformed header (unauthenticated), 403 for a well-formed token
        that matches no tenant digest (unknown tenant)."""
        if not self.enabled:
            return ""
        if not authorization or not authorization.startswith("Bearer "):
            raise _HttpError(
                401, "missing or malformed Authorization header "
                     "(expected 'Bearer <token>')")
        presented = authorization[len("Bearer "):].strip()
        digest = hashlib.sha256(presented.encode("utf-8")).hexdigest()
        for tid, tc in self.tenants.items():
            if hmac.compare_digest(digest, tc.token_sha256):
                return tid
        raise _HttpError(403, "unknown tenant token")

    def rate_admit(self, tenant: str) -> float:
        """Consume one token from the tenant's bucket: 0.0 when admitted,
        else the seconds until the NEXT bucket token exists — the
        per-tenant ``Retry-After`` a 429 carries. Tenants without a
        ``rate_rps`` limit always admit."""
        tc = self.tenants.get(tenant)
        if tc is None or tc.rate_rps <= 0:
            return 0.0
        with self._lock:
            now = float(self._clock())
            level = min(
                float(tc.burst),
                self._level.get(tenant, float(tc.burst))
                + (now - self._stamp.get(tenant, now)) * tc.rate_rps)
            self._stamp[tenant] = now
            if level >= 1.0:
                self._level[tenant] = level - 1.0
                return 0.0
            self._level[tenant] = level
            return (1.0 - level) / tc.rate_rps


class _Stream:
    """One accepted request's token feed: the serve loop appends, the
    handler thread drains. ``tokens`` is the authoritative so-far list
    (replays after a failover may rewrite it; the handler only ever reads
    the suffix past what it already sent, and greedy replays re-produce
    the identical prefix)."""

    def __init__(self, uid: int):
        self.uid = uid
        self.cond = threading.Condition()
        self.tokens: list[int] = []
        self.result = None  # terminal RequestResult once done
        self.done = False

    def publish(self, tokens, result) -> None:
        """Serve-loop side: replace the token view, mark terminal."""
        with self.cond:
            if tokens is not None:
                self.tokens = [int(t) for t in tokens]
            if result is not None:
                self.result = result
                self.done = True
            self.cond.notify_all()

    def fail(self) -> None:
        """Terminally fail the feed with NO result (the fleet forgot the
        uid, or the loop is going down) — the handler replies/closes
        instead of waiting on tokens that can never come."""
        with self.cond:
            self.done = True
            self.cond.notify_all()


class HttpGateway:
    """One ``Router`` behind an HTTP/1.1 + SSE front door (see module
    docstring). ``config`` is a ``GatewayConfig``, a dict with the same
    keys (the ``serving.gateway`` schema), or None for defaults.

    Metrics land in the ROUTER's telemetry bundle under ``gateway/*`` (one
    fleet registry, one ``/metrics`` answer); per-request gateway stages
    (``http_accepted`` / ``stream_started`` / ``client_disconnected`` /
    ``stream_done``) are recorded by the gateway's own ``RequestTracer``
    stamped ``gateway<id>`` on the router's clock, merged by
    ``telemetry/request_trace.request_timeline``.
    """

    def __init__(self, router, config: GatewayConfig | dict | None = None,
                 *, gateway_id: int | str = 0,
                 fault_injection: FaultInjectionConfig | dict | None = None,
                 on_tick=None):
        if config is None:
            config = GatewayConfig()
        elif isinstance(config, dict):
            config = GatewayConfig(**config)
        self.cfg: GatewayConfig = config
        self.router = router
        self.gateway_id = gateway_id
        self.telemetry = router.telemetry
        self.tracer = RequestTracer(
            2048, replica_id=f"gateway{gateway_id}", clock=router.now)
        if fault_injection is not None and not isinstance(
                fault_injection, FaultInjector):
            fault_injection = FaultInjector(fault_injection)
        self._inj: Optional[FaultInjector] = (
            fault_injection if (fault_injection is not None
                                and fault_injection.enabled) else None)
        self._on_tick = on_tick
        self._cmds: queue.Queue = queue.Queue()
        self._streams: dict[int, _Stream] = {}
        self._lock = threading.Lock()  # guards _streams / flags below
        # uid namespace: gateway_id picks a 2^32-wide band (uids are
        # gid<<32 + n), so two gateways with distinct ids in front of one
        # Router can never collide — a collision would surface as a bogus
        # 400 blaming the client's request. String ids hash into a band
        # DISJOINT from numeric ones (bit 16 set), so a mixed int/str
        # fleet cannot alias either. NOTE: the DEFAULT id 0 is band 0 —
        # code that also submits its own small uids directly to the same
        # Router must give the gateway a nonzero id
        gid = (int(gateway_id)
               if str(gateway_id).isdigit() and int(gateway_id) < 0x10000
               else 0x10000 | (zlib.crc32(str(gateway_id).encode()) & 0xFFFF))
        self._uid = gid << 32
        # a RESTARTED gateway over a journal-recovered Router resumes its
        # uid counter past the recovered band (re-minting a journaled uid
        # would trip the fleet-wide duplicate-uid guard) and seeds the
        # idempotency map from the journal so retried keys replay instead
        # of forking fresh uids
        band_max = getattr(router, "max_uid_in_band", None)
        if band_max is not None:
            self._uid = max(self._uid, band_max(gid << 32, (gid + 1) << 32))
        self._idem: dict[str, int] = {}
        idem_map = getattr(router, "idempotency_map", None)
        if idem_map is not None:
            self._idem.update(idem_map())
        # tenant auth + rate limiting (docs/serving.md "Multi-tenant
        # isolation"). The gate is handler-thread state; the uid->tenant
        # ownership map below is serve-loop-owned (same discipline as
        # _idem) and backs the resume/fetch ownership check — a forged
        # reconnect against another tenant's uid gets 403, never a stream.
        self._gate = _TenantGate(self.cfg.auth)
        self._uid_tenant: dict[int, str] = {}
        if self._gate.enabled:
            # the auth block doubles as the fleet's scheduling policy —
            # install it on a router that was not configured with one, so
            # one config block drives auth, DWRR weights, and quotas
            setpol = getattr(router, "set_tenant_policy", None)
            if setpol is not None and not getattr(router, "_tenants", None):
                setpol(self._gate.tenants)
        self._draining = False
        self._stopped = False
        self._httpd: Optional[_Server] = None
        self._http_thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._guard: Optional[PreemptionGuard] = None
        # remote replicas piggyback tokens-so-far on step replies only
        # while a streaming front door exists — this gateway is one
        # (guarded: test fakes implement only the surface they exercise)
        enable = getattr(router, "enable_stream_progress", None)
        if enable is not None:
            enable()
        # fleet-labeled /metrics: the serve loop (the only thread allowed
        # to touch the Router, whose snapshot may RPC worker processes)
        # re-renders the fleet exposition text on a cadence; handler
        # threads serve the cached render under _lock. 0 = per-replica
        # series stay off /metrics (router-registry text only).
        self._fleet_metrics_text: Optional[str] = None
        self._next_fleet_refresh = 0.0
        self.telemetry.gauge("gateway/open_streams").set(0)
        self.telemetry.gauge("gateway/draining").set(0)

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def address(self) -> str:
        return f"http://{self.cfg.host}:{self.port}"

    def _bind(self) -> None:
        handler = _make_handler(self)
        self._httpd = _Server((self.cfg.host, self.cfg.port), handler)
        self._httpd.timeout = 1.0
        t = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"dstt-gw-http-{self.gateway_id}")
        with self._lock:
            self._http_thread = t
        t.start()
        log_dist(f"gateway {self.gateway_id}: listening on {self.address}",
                 ranks=[0])

    def start(self) -> None:
        """Bind and serve from a daemon loop thread (tests/drills; no
        signal handling — use ``trigger_shutdown()`` / ``stop()``)."""
        self._bind()
        self._loop_thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"dstt-gw-loop-{self.gateway_id}")
        self._loop_thread.start()

    def run(self) -> int:
        """Bind and serve on THIS thread until SIGTERM/SIGINT, then drain
        and return 0 — the process-entry discipline (module docstring)."""
        self._guard = PreemptionGuard(["SIGTERM", "SIGINT"])
        self._guard.install()
        self._bind()
        try:
            self._serve_loop()
        finally:
            self._guard.uninstall()
        return 0

    def trigger_shutdown(self) -> None:
        """Begin the graceful drain (the SIGTERM path, callable in-process
        by tests): stop accepting, finish in-flight streams, stop."""
        with self._lock:
            self._draining = True
        self.telemetry.gauge("gateway/draining").set(1)

    def stop(self) -> None:
        """Graceful drain + join (blocking; for ``start()`` callers)."""
        self.trigger_shutdown()
        t = self._loop_thread
        if t is not None:
            t.join(timeout=max(30.0, self.cfg.shutdown_grace_s + 30.0))

    def close(self) -> None:
        """Tear the sockets down (idempotent; ``stop``/``run`` call it).
        The thread handle is CLAIMED atomically under the lock: the serve
        loop's exit path and an external ``close()`` may run concurrently,
        and a check-then-join on the bare attribute could read a handle
        the other caller just nulled (``None.join`` crash — audit
        ``thread-race`` finding). The join itself happens outside the
        lock so a slow HTTP thread never stalls lock waiters."""
        httpd = self._httpd
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        with self._lock:
            t, self._http_thread = self._http_thread, None
        if t is not None:
            t.join(timeout=10.0)

    # -- the serve loop (the ONLY thread that touches the Router) ---------

    def _drain_cmds(self) -> None:
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return
            op = cmd["op"]
            if cmd.get("abandoned") and op == "submit":
                # the handler's wait deadline fired and it already replied
                # 503 — executing the submit now would admit a request
                # whose client was told it was refused (a leaked stream
                # no reader will ever drain). A late CANCEL still runs:
                # it is idempotent and frees fleet capacity either way.
                cmd["event"].set()
                continue
            if op == "submit":
                key = cmd.get("idem")
                # the gateway's map (and the replay lookup) key by the
                # TENANT-SCOPED composite; the router composes the same
                # key itself at submit, so the raw client key crosses the
                # submit boundary exactly once
                skey = (tenant_idem_key(cmd["request"].tenant, key)
                        if key else None)
                if skey and self._replay_idempotent(cmd, skey):
                    if cmd.get("abandoned") and cmd.get("fresh_stream"):
                        # the handler already 503'd and nobody else reads
                        # this feed: drop it (the REQUEST lives on — it
                        # was accepted in a previous life and another
                        # retry may still claim it; only the feed goes)
                        self._close_stream(cmd["uid"])
                        del cmd["stream"]
                    cmd["event"].set()
                    continue
                try:
                    kw = {"idempotency_key": key} if key else {}
                    uid = self.router.submit(cmd["request"], **kw)
                    if skey:
                        # dstpu: allow[thread-race] -- _idem is serve-loop-owned state: every access sits in _drain_cmds/_replay_idempotent, which only the loop executes; the audit's {main, thread} role pair is the run()-inline vs start()-daemon duality — two alternative entries to the ONE loop thread, never both in one process
                        self._idem[skey] = uid
                    if cmd["request"].tenant:
                        # dstpu: allow[thread-race] -- _uid_tenant is serve-loop-owned like _idem above: every access sits in _drain_cmds/_replay_idempotent, which only the loop executes; the audit's {main, thread} role pair is the run()-inline vs start()-daemon duality — two alternative entries to the ONE loop thread, never both in one process
                        self._uid_tenant[uid] = cmd["request"].tenant
                    stream = _Stream(uid)
                    with self._lock:
                        self._streams[uid] = stream
                    cmd["stream"] = stream
                    # stamped at the request's arrival instant: the HTTP
                    # accept PRECEDES the fleet's arrived/dispatched edges
                    # (equal clocks sort by stage rank)
                    self.tracer.record(
                        uid, "http_accepted",
                        t=float(cmd["request"].arrival_time),
                        priority=int(cmd["request"].priority))
                    self.telemetry.counter("gateway/accepted").inc()
                    if cmd.get("abandoned"):
                        # the handler gave up DURING the submit: undo —
                        # nobody will stream this uid. The stream is
                        # stripped BEFORE the event is set, so the handler
                        # sees a consistent refusal
                        self.router.cancel(uid)
                        self._close_stream(uid)
                        del cmd["stream"]
                        cmd["error"] = RequestRejected(
                            uid, "shutting_down",
                            "submit abandoned by its handler")
                except (RequestRejected, ValueError) as e:
                    cmd["error"] = e
            elif op == "cancel":
                cancelled = self.router.cancel(cmd["uid"])
                if cancelled:
                    self.telemetry.counter(
                        "gateway/cancelled_on_disconnect").inc()
                self._close_stream(cmd["uid"])
            cmd["event"].set()

    def _replay_idempotent(self, cmd: dict, key: str) -> bool:
        """Serve-loop side of the idempotency contract: a key that already
        maps to a uid NEVER submits again — the handler is attached to the
        existing stream (two concurrent retries share one feed, each with
        its own send cursor), or a fresh feed pre-filled from the fleet's
        progress cache / the journaled terminal result. False when the key
        is unseen (the caller submits normally).

        ``key`` is the TENANT-SCOPED composite, so another tenant's
        identical client key can never resolve here; the explicit
        ownership check below is defense in depth for the recovered/
        legacy pools — a uid the requesting tenant does not own answers
        403, never a stream."""
        uid = self._idem.get(key)
        if uid is None:
            lookup = getattr(self.router, "idempotency_lookup", None)
            if lookup is not None:
                uid = lookup(key)
            if uid is None:
                return False
            self._idem[key] = uid
        tenant = cmd["request"].tenant
        owner = self._uid_tenant.get(uid)
        if owner is None:
            fn = getattr(self.router, "request_tenant", None)
            owner = fn(uid) if fn is not None else None
            if owner:
                # dstpu: allow[thread-race] -- _uid_tenant is serve-loop-owned like _idem: only _drain_cmds/_replay_idempotent touch it and only the loop thread executes them; the flagged {main, thread} pair is the run()-inline vs start()-daemon duality, never both in one process
                self._uid_tenant[uid] = owner
        if owner and owner != tenant:
            self.telemetry.counter("gateway/ownership_rejects").inc()
            cmd["error"] = RequestRejected(
                uid, "forbidden",
                f"idempotency key does not belong to tenant {tenant!r}")
            cmd["replayed"] = True
            return True
        with self._lock:
            stream = self._streams.get(uid)
            if stream is None:
                stream = _Stream(uid)
                self._streams[uid] = stream
                fresh = True
            else:
                fresh = False
        if fresh:
            pr = self.router.partial_result(uid)
            if pr is not None:
                stream.publish(pr[0], pr[1])
            else:
                res = self.router.result(uid)
                if res is not None:
                    stream.publish(None, res)
                else:
                    # the fleet genuinely forgot the uid (terminal aged
                    # out of the journal's keep window): fail the feed so
                    # the handler answers instead of hanging
                    stream.fail()
        cmd["stream"] = stream
        cmd["uid"] = uid
        cmd["replayed"] = True
        cmd["fresh_stream"] = fresh
        self.telemetry.counter("gateway/idempotent_replays").inc()
        return True

    def _close_stream(self, uid: int) -> None:
        with self._lock:
            stream = self._streams.pop(uid, None)
            open_streams = len(self._streams)
        if stream is not None:
            # wake any handler still waiting so it observes the close
            stream.publish(None, self.router.result(uid))
        self.telemetry.gauge("gateway/open_streams").set(open_streams)

    def _publish(self) -> None:
        with self._lock:
            live = list(self._streams.values())
        for stream in live:
            pr = self.router.partial_result(stream.uid)
            if pr is None:
                # the fleet no longer holds the uid (e.g. cancelled
                # out-of-band, bypassing the gateway's cancel command) —
                # fail the stream rather than hang its reader: a publish
                # with no terminal result would be a no-op forever
                res = self.router.result(stream.uid)
                if res is not None:
                    stream.publish(None, res)
                else:
                    stream.fail()
                continue
            tokens, result = pr
            stream.publish(tokens, result)

    def _serve_loop(self) -> None:
        try:
            self._serve_loop_inner()
        finally:
            # containment for ANY escape path (a raising on_tick hook, a
            # Router bug): without this, handler threads would wait on
            # feeds that can never advance and new submits would block
            # their full command timeout against a dead loop
            # dstpu: allow[thread-race] -- one-way bool published by the dying loop: the store is GIL-atomic, nothing ever writes it back to False, and the handler-side readers poll it on a bounded cadence (0.5s command wait, per-token stream writes) — a lock would add a hot-path acquire to every poll for a flag whose staleness window is already bounded
            self._stopped = True
            with self._lock:
                streams = list(self._streams.values())
                self._streams.clear()
            for stream in streams:
                stream.fail()
            self.close()
            log_dist(f"gateway {self.gateway_id}: drained and stopped",
                     ranks=[0])

    def _serve_loop_inner(self) -> None:
        grace_deadline = None
        while True:
            if self._guard is not None and self._guard.pending():
                self.trigger_shutdown()
            self._drain_cmds()
            self.router.step()
            self._publish()
            self._refresh_fleet_metrics()
            if self._on_tick is not None:
                self._on_tick()
            with self._lock:
                draining = self._draining
                open_streams = len(self._streams)
            self.telemetry.gauge("gateway/open_streams").set(open_streams)
            if draining:
                if open_streams == 0:
                    break
                if grace_deadline is None and self.cfg.shutdown_grace_s > 0:
                    grace_deadline = (time.monotonic()
                                      + self.cfg.shutdown_grace_s)
                if (grace_deadline is not None
                        and time.monotonic() > grace_deadline):
                    log_dist(
                        f"gateway {self.gateway_id}: shutdown grace "
                        f"({self.cfg.shutdown_grace_s}s) elapsed with "
                        f"{open_streams} streams open — closing anyway",
                        ranks=[0])
                    with self._lock:
                        uids = list(self._streams)
                    for uid in uids:
                        self.router.cancel(uid)
                        self._close_stream(uid)
                    break
            if self.router._owner or not self._cmds.empty():
                continue  # live work: step again immediately
            time.sleep(min(self.cfg.stream_poll_s, 0.05))
        # drained: every accepted stream reached a terminal state (the
        # _serve_loop finally block does the teardown)

    def _refresh_fleet_metrics(self) -> None:
        """Serve-loop side of the fleet-labeled ``/metrics`` exposition:
        re-render ``prometheus_fleet_text`` on the configured cadence.
        The fleet snapshot may RPC worker processes, so only this thread
        may build it; handlers serve the cached text."""
        if self.cfg.metrics_fleet_refresh_s <= 0:
            return
        nowm = time.monotonic()
        if nowm < self._next_fleet_refresh:
            return
        # dstpu: allow[thread-race] -- _next_fleet_refresh is serve-loop-owned: the only writes are the __init__ 0.0 (before the thread exists) and this method, which only the loop thread calls; the audit's {main, thread} pair is the run()-inline vs start()-daemon duality — two alternative entries to the ONE loop thread, never both in one process
        self._next_fleet_refresh = nowm + self.cfg.metrics_fleet_refresh_s
        try:
            snap = self.router.telemetry_snapshot(emit=False)
        except TypeError:  # a fake router without the emit kwarg
            snap = self.router.telemetry_snapshot()
        text = prometheus_fleet_text(snap)
        with self._lock:
            self._fleet_metrics_text = text

    # -- handler-thread entry points --------------------------------------

    def _next_uid(self) -> int:
        with self._lock:
            self._uid += 1
            return self._uid

    def _command(self, cmd: dict, timeout: float = 120.0) -> dict:
        """Enqueue a command for the serve loop and wait for its reply.
        On deadline/stop the command is marked ABANDONED so the loop skips
        (or undoes) it — a submit the client was told was refused must not
        be silently admitted later."""
        cmd["event"] = threading.Event()
        self._cmds.put(cmd)
        deadline = time.monotonic() + timeout
        while not cmd["event"].wait(timeout=0.5):
            if self._stopped or time.monotonic() > deadline:
                cmd["abandoned"] = True
                # one last grace: the loop may be completing it right now.
                # The loop strips "stream" before setting the event when
                # it undoes an abandoned submit, so stream-present after
                # the event means the submit genuinely stands.
                if not cmd["event"].wait(timeout=0.25) or "stream" not in cmd:
                    cmd.setdefault("error", RequestRejected(
                        cmd.get("uid", -1), "shutting_down",
                        "gateway stopped before the command was processed"))
                break
        return cmd

    def retry_after_s(self) -> int:
        """The ``Retry-After`` hint on 429/503: configured, or derived
        from the autoscaler's cooldown (the earliest instant the fleet
        could have grown), with a 1-second floor."""
        if self.cfg.retry_after_s > 0:
            return max(1, int(round(self.cfg.retry_after_s)))
        asc = getattr(self.router, "_autoscaler", None)
        if asc is not None:
            return max(1, int(round(asc.cfg.cooldown_s)))
        return 1

    def healthz(self) -> tuple[int, dict]:
        states = self.router.replica_states()
        healthy = sum(1 for s in states.values() if s == "healthy")
        with self._lock:
            draining = self._draining
            open_streams = len(self._streams)
        body = {
            "status": ("draining" if draining
                       else "ok" if healthy else "unhealthy"),
            "healthy_replicas": healthy,
            "replicas": {str(k): v for k, v in states.items()},
            "open_streams": open_streams,
            "brownout": bool(self.router.brownout),
        }
        return (200 if body["status"] == "ok" else 503), body

    def telemetry_snapshot(self) -> dict:
        """The Router's fleet snapshot plus a ``gateway`` section — the
        gateway's stage events ride ``request_timeline`` merges."""
        snap = self.router.telemetry_snapshot()
        with self._lock:
            open_streams = len(self._streams)
        snap["gateway"] = {
            "gateway_id": self.gateway_id,
            "open_streams": open_streams,
            "request_trace": self.tracer.events(),
        }
        return snap


# -- the HTTP handler ---------------------------------------------------------


def _make_handler(gw: HttpGateway):
    """Handler class closed over the gateway (http.server instantiates one
    per connection; state lives on ``gw``)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # read deadline for request lines/bodies: a client that connects
        # and goes silent must not pin a handler thread forever
        timeout = 30.0

        def log_message(self, fmt, *args):  # http.server stderr chatter
            pass

        # -- plumbing ----------------------------------------------------

        def _reply_json(self, status: int, body: dict,
                        headers: dict | None = None) -> None:
            payload = json.dumps(body).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(payload)

        def _sse_event(self, event: str, data: dict,
                       event_id: int | None = None) -> None:
            # the id: line is the SSE-standard resume cursor: a client
            # reconnecting with Last-Event-ID <id> resumes AFTER it
            head = f"id: {event_id}\n" if event_id is not None else ""
            self.wfile.write(
                f"{head}event: {event}\ndata: {json.dumps(data)}\n\n"
                .encode())
            self.wfile.flush()

        # -- routes ------------------------------------------------------

        def do_GET(self):
            try:
                self._do_get()
            except (ConnectionError, socket.timeout, OSError):
                # the client vanished mid-reply: nothing to contain (GET
                # routes hold no fleet state), nothing worth a traceback
                gw.telemetry.counter("gateway/disconnects").inc()

        def _do_get(self):
            gw.telemetry.counter("gateway/http_requests").inc()
            if self.path == "/healthz":
                status, body = gw.healthz()
                self._reply_json(status, body)
                return
            if self.path == "/metrics":
                with gw._lock:
                    text = gw._fleet_metrics_text
                if text is None:  # no fleet cache (refresh cadence off)
                    text = prometheus_text(gw.telemetry.registry)
                payload = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            if self.path == "/debug/incidents":
                # directory listing only (no JSON parse, no Router call):
                # safe from a handler thread — IncidentRecorder.index()
                # reads the filesystem, never the recorder's staged state
                rec = getattr(gw.router, "incidents", None)
                self._reply_json(200, {
                    "enabled": rec is not None,
                    "incidents": rec.index() if rec is not None else [],
                })
                return
            self._reply_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                self._do_post()
            except (ConnectionError, socket.timeout, OSError):
                # a reply write to a vanished client — the SSE path has
                # its own containment (cancel); this guard covers the
                # JSON replies (rejections, blocking mode) whose request
                # is already terminal or was never admitted
                gw.telemetry.counter("gateway/disconnects").inc()

        def _do_post(self):
            gw.telemetry.counter("gateway/http_requests").inc()
            if self.path != "/v1/generate":
                self._reply_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req, stream_mode, idem_key, resume_from = \
                    self._parse_generate()
            except _HttpError as e:
                if e.status in (401, 403):
                    gw.telemetry.counter("gateway/auth_failures").inc()
                elif e.status == 429:
                    gw.telemetry.counter("gateway/rate_limited").inc()
                else:
                    gw.telemetry.counter("gateway/bad_requests").inc()
                self._reply_json(e.status, {"error": e.message}, e.headers)
                return
            with gw._lock:
                draining = gw._draining
            if draining:
                # SIGTERM discipline: stop ACCEPTING first; in-flight
                # streams keep draining underneath
                gw.telemetry.counter("gateway/rejected").inc()
                self._reply_json(503, {"error": "gateway shutting down",
                                       "reason": "shutting_down"},
                                 {"Retry-After": gw.retry_after_s()})
                return
            t0 = time.monotonic()
            cmd = gw._command({"op": "submit", "request": req,
                               "idem": idem_key})
            gw.telemetry.histogram("gateway/submit_wait_sec").observe(
                time.monotonic() - t0)
            err = cmd.get("error")
            if err is not None:
                self._reply_rejected(req, err)
                return
            stream = cmd["stream"]
            # a replayed idempotency key serves the ORIGINAL uid, never a
            # fork; resume-from only makes sense on a replayed stream
            uid = int(cmd.get("uid", req.uid))
            if not cmd.get("replayed"):
                resume_from = 0
            if stream_mode:
                self._stream_sse(uid, stream, start_from=resume_from)
            else:
                self._reply_blocking(uid, stream)

        # -- request parsing ---------------------------------------------

        def _parse_generate(self):
            # auth FIRST (header-only): an unauthenticated caller learns
            # nothing about body validation, and its request consumes no
            # rate-limit budget
            tenant = gw._gate.authenticate(self.headers.get("Authorization"))
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                raise _HttpError(400, "missing request body")
            if length > gw.cfg.max_body_bytes:
                raise _HttpError(
                    413, f"body of {length} bytes exceeds "
                         f"max_body_bytes={gw.cfg.max_body_bytes}")
            try:
                body = json.loads(self.rfile.read(length).decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise _HttpError(400, f"malformed JSON body: {e}") from e
            if not isinstance(body, dict):
                raise _HttpError(400, "body must be a JSON object")
            prompt = body.get("prompt")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise _HttpError(
                    400, "prompt must be a non-empty list of token ids")
            try:
                priority = int(self.headers.get("X-DSTPU-Priority") or 0)
                deadline_s = float(
                    self.headers.get("X-DSTPU-Deadline-S") or 0.0)
            except ValueError as e:
                raise _HttpError(
                    400, f"malformed X-DSTPU-Priority/X-DSTPU-Deadline-S "
                         f"header: {e}") from e
            try:
                req = Request(
                    uid=gw._next_uid(),
                    prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    eos_token=(None if body.get("eos_token") is None
                               else int(body["eos_token"])),
                    arrival_time=gw.router.now(),
                    deadline_s=deadline_s,
                    priority=priority,
                    tenant=tenant,
                )
            except (TypeError, ValueError) as e:
                raise _HttpError(400, f"bad request field: {e}") from e
            wait = gw._gate.rate_admit(tenant)
            if wait > 0:
                # token bucket empty: typed 429 with the PER-TENANT
                # Retry-After — the instant this tenant's next bucket
                # token exists, not a fleet-wide guess
                gw.telemetry.counter(f"tenant/{tenant}/rate_limited").inc()
                raise _HttpError(
                    429, f"tenant {tenant!r} rate limit exceeded "
                         f"(rate_rps={gw._gate.tenants[tenant].rate_rps})",
                    headers={"Retry-After": max(1, int(wait) + 1)})
            idem_key = (self.headers.get("X-DSTPU-Idempotency-Key")
                        or "").strip() or None
            if idem_key and any(ord(c) < 0x20 or c == "\x7f"
                                for c in idem_key):
                # control chars could forge the tenant-scoped composite
                # key (the \x1f separator) — reject before any map touch
                raise _HttpError(
                    400, "X-DSTPU-Idempotency-Key must not contain "
                         "control characters")
            resume_from = 0
            last_id = (self.headers.get("Last-Event-ID") or "").strip()
            if last_id:
                try:
                    resume_from = int(last_id) + 1  # resume AFTER that id
                except ValueError as e:
                    raise _HttpError(
                        400, f"malformed Last-Event-ID header: {e}") from e
                if resume_from < 0:
                    raise _HttpError(400, "Last-Event-ID must be >= 0")
            return req, bool(body.get("stream", True)), idem_key, resume_from

        def _reply_rejected(self, req, err) -> None:
            gw.telemetry.counter("gateway/rejected").inc()
            if isinstance(err, RequestRejected):
                status = _REASON_STATUS.get(err.reason, 429)
                headers = {"Retry-After": gw.retry_after_s()}
                self._reply_json(status, {
                    "error": str(err), "reason": err.reason,
                    "uid": req.uid}, headers)
                return
            # ValueError: the request itself is unservable (budget
            # violation, bad field) — the client's fault, not load
            self._reply_json(400, {"error": str(err), "uid": req.uid})

        # -- response modes ----------------------------------------------

        def _reply_blocking(self, uid: int, stream: _Stream) -> None:
            """``"stream": false``: wait for the terminal result, reply
            with one JSON document. No mid-flight disconnect detection
            here — nothing is written until the request is terminal, so a
            vanished reader surfaces only at the final write (contained
            by do_POST's transport guard); SSE is the mode with bounded
            disconnect→cancel containment."""
            with stream.cond:
                while not stream.done:
                    stream.cond.wait(timeout=gw.cfg.stream_poll_s)
                    if gw._stopped:
                        break
                res = stream.result
            gw._close_stream(uid)
            if res is None:
                self._reply_json(503, {"error": "gateway stopped before "
                                       "the request finished",
                                       "uid": uid})
                return
            self._reply_json(200, _result_json(uid, res))
            gw.tracer.record(uid, "stream_done",
                             status=res.status, n_tokens=len(res.tokens))
            gw.telemetry.counter("gateway/streams_done").inc()

        def _stream_sse(self, uid: int, stream: _Stream,
                        start_from: int = 0) -> None:
            """SSE mode: one ``token`` event per generated token as the
            feed advances (``id:`` = token index, the ``Last-Event-ID``
            cursor space), keepalive comments while idle, a final ``done``
            event; ANY write failure (gone client, stalled reader past the
            write deadline) cancels the request fleet-side.

            ``start_from`` (a replayed idempotency key + ``Last-Event-ID``)
            resumes mid-stream: tokens below it were delivered in a
            previous connection — possibly to a previous gateway PROCESS —
            and are skipped, so the client's concatenated view is one
            bitwise-identical stream."""
            # the slow-reader deadline: a client that stops draining its
            # socket turns the next send into a timeout, which is treated
            # exactly like a disconnect. 0 genuinely DISABLES it — the
            # class-level 30s request-read timeout must not linger on the
            # stream or the documented "0 = undeadlined writes" is false
            self.connection.settimeout(
                gw.cfg.write_timeout_s if gw.cfg.write_timeout_s > 0
                else None)
            t_start = time.monotonic()
            sent = int(start_from)
            started = False
            if sent > 0:
                gw.telemetry.counter("gateway/resumed_streams").inc()
                gw.tracer.record(uid, "stream_resumed", from_token=sent)
            last_write = time.monotonic()
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.send_header("X-DSTPU-Uid", str(uid))
                self.end_headers()
                while True:
                    with stream.cond:
                        if len(stream.tokens) <= sent and not stream.done:
                            stream.cond.wait(timeout=gw.cfg.stream_poll_s)
                        toks = list(stream.tokens)
                        done, res = stream.done, stream.result
                    for tok in toks[sent:]:
                        self._sse_event("token", {"i": sent, "token": tok},
                                        event_id=sent)
                        sent += 1
                        last_write = time.monotonic()
                        if not started:
                            started = True
                            gw.tracer.record(uid, "stream_started")
                        self._maybe_inject(uid, sent)
                    if done:
                        self._sse_event(
                            "done",
                            _result_json(uid, res) if res is not None
                            else {"uid": uid, "status": "unknown"})
                        break
                    if gw._stopped:
                        break
                    if time.monotonic() - last_write > 1.0:
                        # keepalive comment: bounds how long a vanished
                        # client can sit undetected holding a slot
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        last_write = time.monotonic()
                        gw.telemetry.counter("gateway/keepalives").inc()
            except (BrokenPipeError, ConnectionResetError, socket.timeout,
                    OSError) as e:
                self._on_disconnect(uid, sent, e)
                return
            except _InjectedDisconnect as e:
                self._on_disconnect(uid, sent, e)
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            gw._close_stream(uid)
            gw.tracer.record(uid, "stream_done",
                             status=res.status if res is not None
                             else "unknown",
                             n_tokens=sent,
                             stream_sec=round(time.monotonic() - t_start, 4))
            gw.telemetry.counter("gateway/streams_done").inc()
            gw.telemetry.histogram("gateway/stream_sec").observe(
                time.monotonic() - t_start)

        def _maybe_inject(self, uid: int, sent: int) -> None:
            if gw._inj is None:
                return
            if gw._inj.gateway_disconnect(uid, sent):
                gw.telemetry.counter("gateway/injected_faults").inc()
                raise _InjectedDisconnect(
                    f"fault injection: gateway_disconnect on uid {uid} "
                    f"after token {sent}")
            if gw._inj.gateway_stall(uid, sent):
                gw.telemetry.counter("gateway/injected_faults").inc()
                gw.telemetry.counter("gateway/stalls").inc()
                raise _InjectedDisconnect(
                    f"fault injection: gateway_stall (write deadline "
                    f"overrun) on uid {uid} after token {sent}")

        def _on_disconnect(self, uid: int, sent: int, exc) -> None:
            """The vanished/stalled reader path: cancel fleet-side so the
            slot and prefix refs are freed, record the edge."""
            if isinstance(exc, socket.timeout):
                gw.telemetry.counter("gateway/stalls").inc()
            gw.telemetry.counter("gateway/disconnects").inc()
            gw.tracer.record(uid, "client_disconnected", tokens_sent=sent,
                             error=type(exc).__name__)
            log_dist(
                f"gateway {gw.gateway_id}: client for uid {uid} gone after "
                f"{sent} tokens ({type(exc).__name__}) — cancelling",
                ranks=[0])
            gw._command({"op": "cancel", "uid": uid})

    return Handler


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


class _InjectedDisconnect(Exception):
    """Raised by the fault sites inside the stream write path — takes the
    exact containment route a real transport error takes."""


def _result_json(uid: int, res) -> dict:
    return {
        "uid": uid,
        "status": res.status,
        "tokens": [int(t) for t in np.asarray(res.tokens).reshape(-1)],
        "n_tokens": int(np.asarray(res.tokens).size),
        "prompt_len": int(res.prompt_len),
        "ttft_s": round(float(res.ttft), 6),
        "requeues": int(res.requeues),
    }


__all__ = ["HttpGateway"]
