"""Deterministic, config-selected fault injection (a copy of
``deepspeed_tpu/resilience/faults.py``, which imports no jax).

A seeded injector whose every decision is a pure function of
``(seed, site, key)``: two runs with the same config inject the same faults
at the same sites, so a recovery test is reproducible and a comparison
against an unfaulted run is meaningful. Sites:

  ``nan_grads``       non-finite loss and gradients at a chosen training
                      step: the engine sets the loss scale to +inf for that
                      step, so the values come out non-finite inside the
                      step and its update is skipped on the device.
  ``io_error``        ``PermanentIOError`` on the Nth guarded checkpoint
                      write (``checkpoint/saver.py`` consults the installed
                      injector before each file write).
  ``io_flaky``        ``TransientIOError`` on the Nth guarded write: the
                      write clock keeps advancing, so a retried save lands
                      on fresh write numbers and succeeds.
  ``garbage_logits``  NaN logits for a chosen request: the serving engine
                      poisons the request's slot KV, so the next program
                      attending to it computes non-finite logits.
  ``preempt``         simulated preemption before a chosen training step.
  ``replica_dead``    a Router replica dies before a chosen router step
                      (``inference/router.py``): it is never stepped again
                      and its in-flight requests fail over.
  ``replica_hang``    a replica's step at a chosen router step is observed
                      past ``health.timeout`` (the hung verdict's path).
  ``rpc_timeout``     the Nth RPC call of a method loses its reply to the
                      deadline after the call executed (``inference/rpc.py``).
  ``rpc_conn_reset``  the connection drops after the Nth call of a method
                      executed (over TCP an abortive RST, ``SO_LINGER(0)``).
  ``rpc_garbled_frame``  the Nth reply frame of a method fails its
                      integrity check.
  ``router_crash``    the control plane dies at a chosen router step
                      (``Router.step`` raises ``ControlPlaneCrash``).
  ``journal_append``  the Nth request-journal append fails permanently
                      (the ``io_error`` family, its own clock).
  ``gateway_disconnect``  the HTTP gateway's SSE stream for a request sees
                      its client gone after the Nth streamed token
                      (``launcher/http_gateway.py``): the request is
                      cancelled fleet-side, as for a real disconnect.
  ``gateway_stall``   the stream's reader stops draining after the Nth
                      token (the send overruns the write deadline): the
                      same cancel path.

Two selection modes compose:

  * **deterministic lists** (``nan_grad_steps``, ``io_error_writes``,
    ``io_flaky_writes``, ``garbage_logits_uids`` + phase/step,
    ``preempt_steps``) fire exactly once per listed key: a rewound step or
    a requeued request is NOT re-faulted, modelling a transient fault;
  * **rate mode** (``rate`` in (0, 1], optionally restricted by ``sites``)
    draws per opportunity from a crc32 hash of ``(seed, site,
    #opportunity)`` — deterministic across runs, independent across
    opportunities.
"""

from __future__ import annotations

import threading
import zlib
from collections import Counter
from typing import Any, Optional

from .errors import PermanentIOError, TransientIOError


def _get(cfg: Any, name: str, default):
    if isinstance(cfg, dict):
        return cfg.get(name, default)
    return getattr(cfg, name, default)


class FaultInjector:
    """Seeded deterministic fault source. ``cfg`` is a
    ``runtime.config.FaultInjectionConfig``, a plain dict with the same
    keys, or None (disabled)."""

    SITES = ("nan_grads", "io_error", "io_flaky", "garbage_logits", "preempt",
             "replica_dead", "replica_hang",
             "rpc_timeout", "rpc_conn_reset", "rpc_garbled_frame",
             "gateway_disconnect", "gateway_stall", "router_crash")

    def __init__(self, cfg: Any = None):
        self.enabled = bool(_get(cfg, "enabled", False)) if cfg is not None else False
        self.seed = int(_get(cfg, "seed", 0))
        self.rate = float(_get(cfg, "rate", 0.0))
        self.sites = set(_get(cfg, "sites", []) or [])
        self.nan_grad_steps = set(_get(cfg, "nan_grad_steps", []) or [])
        self.io_error_writes = set(_get(cfg, "io_error_writes", []) or [])
        self.io_flaky_writes = set(_get(cfg, "io_flaky_writes", []) or [])
        self.preempt_steps = set(_get(cfg, "preempt_steps", []) or [])
        self.garbage_logits_uids = set(_get(cfg, "garbage_logits_uids", []) or [])
        self.garbage_logits_phase = str(_get(cfg, "garbage_logits_phase", "decode"))
        self.garbage_logits_decode_step = int(_get(cfg, "garbage_logits_decode_step", 0))
        # 1-based RequestJournal appends that fail permanently (ENOSPC)
        self.io_error_journal_appends = set(_get(cfg, "io_error_journal_appends", []) or [])
        # [replica_id, router_step] pairs (1-based steps)
        self.replica_dead_at = {tuple(int(x) for x in p) for p in _get(cfg, "replica_dead_at", []) or []}
        self.replica_hang_at = {tuple(int(x) for x in p) for p in _get(cfg, "replica_hang_at", []) or []}
        # [method, nth call of that method] pairs (1-based, per client)
        self.rpc_timeout_at = {(str(p[0]), int(p[1])) for p in _get(cfg, "rpc_timeout_at", []) or []}
        self.rpc_conn_reset_at = {(str(p[0]), int(p[1])) for p in _get(cfg, "rpc_conn_reset_at", []) or []}
        self.rpc_garbled_at = {(str(p[0]), int(p[1])) for p in _get(cfg, "rpc_garbled_at", []) or []}
        # gateway stream faults: [uid, nth streamed token] pairs (1-based)
        self.gateway_disconnect_at = {tuple(int(x) for x in p) for p in _get(cfg, "gateway_disconnect_at", []) or []}
        self.gateway_stall_at = {tuple(int(x) for x in p) for p in _get(cfg, "gateway_stall_at", []) or []}
        # 1-based router steps at which the control plane crashes
        self.router_crash_at = set(_get(cfg, "router_crash_at", []) or [])
        self._writes = 0  # guarded-write clock (io_error and io_flaky)
        self._journal_appends = 0  # journal-append clock (io_error family)
        self._fired: set = set()  # list-mode keys fire exactly once
        self._lock = threading.Lock()
        self.injected: Counter = Counter()
        self.opportunities: Counter = Counter()

    def _rate_fire(self, site: str) -> bool:
        if self.rate <= 0.0 or (self.sites and site not in self.sites):
            return False
        # one independent deterministic draw per opportunity: a replayed
        # request gets a FRESH draw (its site's counter has advanced)
        n = self.opportunities[site]
        h = zlib.crc32(f"{self.seed}:{site}:{n}".encode()) & 0xFFFFFFFF
        return h / float(0x100000000) < self.rate

    def _fire(self, site: str, listed: bool, key) -> bool:
        """One fault decision. List-mode keys fire once, ever."""
        with self._lock:
            self.opportunities[site] += 1
            hit = False
            if listed:
                k = (site, key)
                if k not in self._fired:
                    self._fired.add(k)
                    hit = True
            if not hit:
                hit = self._rate_fire(site)
            if hit:
                self.injected[site] += 1
            return hit

    def nan_grads(self, step: int) -> bool:
        """True if the training step about to run (1-based global step)
        should see non-finite gradients."""
        if not self.enabled:
            return False
        return self._fire("nan_grads", step in self.nan_grad_steps, step)

    def io_error(self, path: str) -> None:
        """Guarded-write hook: advances the shared write clock and raises
        ``PermanentIOError`` when this write is armed for ``io_error``, or
        ``TransientIOError`` for ``io_flaky`` (1-based indices; a retry of a
        failed save advances the clock past the armed index, which is what
        makes the flaky site transient)."""
        if not self.enabled:
            return
        with self._lock:
            self._writes += 1
            n = self._writes
        if self._fire("io_error", n in self.io_error_writes, n):
            raise PermanentIOError(f"fault injection: io_error on guarded write #{n} ({path})")
        if self._fire("io_flaky", n in self.io_flaky_writes, n):
            raise TransientIOError(f"fault injection: io_flaky (transient) on guarded write #{n} ({path})")

    def journal_append(self, path: str) -> None:
        """Journal-append hook: advances its own append clock (a schedule
        arming "the 3rd journal append" must not depend on checkpoint
        writes) and raises ``PermanentIOError`` when the append is armed in
        ``io_error_journal_appends`` (1-based). The fired-set key
        ``("journal", n)`` never collides with the guarded writes' ints."""
        if not self.enabled:
            return
        with self._lock:
            self._journal_appends += 1
            n = self._journal_appends
        if self._fire("io_error", n in self.io_error_journal_appends, ("journal", n)):
            raise PermanentIOError(f"fault injection: io_error on journal append #{n} ({path})")

    def preempt(self, step: int) -> bool:
        """True if a preemption should fire before running ``step``
        (1-based global step)."""
        if not self.enabled:
            return False
        return self._fire("preempt", step in self.preempt_steps, step)

    def replica_dead(self, replica: int, step: int) -> bool:
        """True if Router replica ``replica`` is found dead before router
        step ``step`` (1-based)."""
        if not self.enabled:
            return False
        return self._fire("replica_dead", (replica, step) in self.replica_dead_at, (replica, step))

    def replica_hang(self, replica: int, step: int) -> bool:
        """True if replica ``replica``'s step at router step ``step`` is
        observed past ``health.timeout``."""
        if not self.enabled:
            return False
        return self._fire("replica_hang", (replica, step) in self.replica_hang_at, (replica, step))

    def rpc_timeout(self, method: str, call_n: int) -> bool:
        """True if the ``call_n``-th call of ``method`` (1-based, per
        client) loses its reply to the deadline."""
        if not self.enabled:
            return False
        return self._fire("rpc_timeout", (method, call_n) in self.rpc_timeout_at, (method, call_n))

    def rpc_conn_reset(self, method: str, call_n: int) -> bool:
        """True if the connection resets after the ``call_n``-th call of
        ``method`` executed."""
        if not self.enabled:
            return False
        return self._fire("rpc_conn_reset", (method, call_n) in self.rpc_conn_reset_at, (method, call_n))

    def rpc_garbled_frame(self, method: str, call_n: int) -> bool:
        """True if the ``call_n``-th reply frame of ``method`` fails its
        integrity check."""
        if not self.enabled:
            return False
        return self._fire("rpc_garbled_frame", (method, call_n) in self.rpc_garbled_at, (method, call_n))

    def gateway_disconnect(self, uid: int, token_n: int) -> bool:
        """True if the SSE stream for request ``uid`` should observe its
        client gone after streaming token ``token_n`` (1-based)."""
        if not self.enabled:
            return False
        return self._fire("gateway_disconnect", (uid, token_n) in self.gateway_disconnect_at, (uid, token_n))

    def gateway_stall(self, uid: int, token_n: int) -> bool:
        """True if the stream's reader should stall (send deadline overrun)
        after token ``token_n`` (1-based)."""
        if not self.enabled:
            return False
        return self._fire("gateway_stall", (uid, token_n) in self.gateway_stall_at, (uid, token_n))

    def router_crash(self, step: int) -> bool:
        """True if the control plane crashes (``ControlPlaneCrash`` out of
        ``Router.step``) at router step ``step`` (1-based)."""
        if not self.enabled:
            return False
        return self._fire("router_crash", step in self.router_crash_at, step)

    def garbage_logits(self, uid: int, phase: str, decode_step: int = 0) -> bool:
        """True if request ``uid`` should produce NaN logits now. ``phase``
        is ``prefill`` (at admission completion) or ``decode`` with the
        request's 0-based decode-step index."""
        if not self.enabled:
            return False
        listed = (
            uid in self.garbage_logits_uids
            and phase == self.garbage_logits_phase
            and (phase == "prefill" or decode_step == self.garbage_logits_decode_step)
        )
        return self._fire("garbage_logits", listed, (uid, phase, decode_step))

    def stats(self) -> dict:
        return {"injected": dict(self.injected), "opportunities": dict(self.opportunities),
                "guarded_writes": self._writes, "journal_appends": self._journal_appends}


# -- process-global injector -------------------------------------------
# checkpoint/saver.py's free functions have no engine handle to thread an
# injector through; they consult this slot instead. The training engine
# installs its injector (or None) at init; tests install/clear around
# save/load calls.

_installed: Optional[FaultInjector] = None


def install_injector(inj: Optional[FaultInjector]) -> None:
    global _installed
    _installed = inj


def clear_injector() -> None:
    install_injector(None)


def get_injector() -> Optional[FaultInjector]:
    return _installed


def maybe_io_error(path: str) -> None:
    """Guarded-write hook for code without an injector reference (no-op
    unless an enabled injector is installed)."""
    if _installed is not None:
        _installed.io_error(path)
