"""The serving fleet's autoscaler (the port of
``deepspeed_tpu/inference/autoscaler.py``): the fleet's own signals closed
back onto its membership. Grow under load, shrink when idle, heal after
crashes, and brown out when growth runs out of headroom.

Signals, read on every ``Router.step()`` from host-side cached state (a
tick never blocks on a replica's transport):

  * ``queue``            fleet-wide queued requests (arrival backlog), less
                         the backlog tenants hold over their quota
                         (``Router.tenant_excess``).
  * ``load_per_replica`` mean scheduler load (queued + prefilling +
                         decoding) per HEALTHY replica.
  * ``step_sec``         the slowest replica's last non-compiling step
                         latency (the Router's heartbeat sample).
  * ``mfu``              always None here: its source, the program
                         ledger's ``serving/mfu`` gauges, is not ported, so
                         ``AutoscaleConfig.check_ported`` refuses a
                         ``scale_up_mfu`` threshold.

Decisions, with hysteresis so a flapping metric never oscillates the fleet:
a signal must persist ``up_consecutive``/``down_consecutive`` evaluations
AND ``cooldown_s`` must have elapsed since the last action, on the
Router's clock (``step(now=...)``), never the wall clock. Scale-up spawns a
replica (a ``WorkerSupervisor`` slot booted on a background thread, a
caller's ``spawn`` callable, or the Router's ``_spawn_inprocess``, which
captures the newcomer's decode graph on the stepping thread) and
``attach_replica``s it as a NEW rid; scale-down ``drain_replica``s the
least-loaded healthy replica and retires it once drained (its worker slot,
or an in-process replica's device memory through ``close()``). A dead
worker is respawned through the supervisor as a NEW rid, a probation
replica whose process is gone first ``mark_dead``. At ``max_replicas``
with the up-signal still firing, the Router goes into brownout
(``Router.set_brownout``: deadline tightening, priority shedding, typed
``overloaded``); it lifts once the calm spans ``up_consecutive``
evaluations and ``cooldown_s``.

Every decision is a typed event in a bounded ring (``describe()``, carried
in ``Router.telemetry_snapshot()``) plus ``router/autoscale/*`` counters
and gauges.

Not ported: per-pool autoscaling of disaggregated fleets (the JAX
``pool_signals`` / ``_evaluate_pool``), which comes with ``router.disagg``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..resilience import RpcError
from ..runtime.config import AutoscaleConfig
from ..utils.logging import log_dist


class Autoscaler:
    """Close the signals -> membership loop for one ``Router``.

    ``config`` is an ``AutoscaleConfig`` or dict (default: the router's own
    ``serving.router.autoscale`` block). Replica construction, in
    precedence order:

      * ``supervisor``: a ``launcher/serving_worker.WorkerSupervisor``;
        scale-up spawns a fresh slot, crashes respawn through it, and
        drained replicas are ``retire()``d. ``slots`` maps the rids of
        ALREADY-attached replicas to their supervisor slots.
      * ``spawn`` / ``retire`` callables: ``spawn()`` returns anything with
        the scheduler surface; ``retire(rid, engine)`` is called once that
        replica has drained.
      * neither: the Router builds in-process ``ServingEngine`` replicas
        from its constructor engine and config.
    """

    def __init__(self, router, config=None, *,
                 supervisor=None,
                 spawn: Optional[Callable] = None,
                 retire: Optional[Callable] = None,
                 slots: Optional[dict] = None):
        if config is None:
            config = router.cfg.autoscale
        if isinstance(config, dict):
            config = AutoscaleConfig(**config)
        config.check_ported()
        self.cfg: AutoscaleConfig = config
        self.router = router
        self.supervisor = supervisor
        self._spawn_fn = spawn
        self._retire_fn = retire
        self.tm = router.telemetry
        self._slots: dict[int, int] = dict(slots or {})  # rid -> slot
        self._retiring: dict[int, Optional[int]] = {}    # rid -> slot|None
        self._slot_seq = max(self._slots.values(), default=-1) + 1
        healthy = sum(1 for r in router._replicas if r.state == "healthy")
        self.target = min(max(healthy, self.cfg.min_replicas),
                          self.cfg.max_replicas)
        self._up_for = 0
        self._down_for = 0
        self._down_since = float("inf")  # router-clock start of the streak
        self._calm_for = 0
        self._calm_since = float("inf")  # router-clock start of calm
        self._last_action = float("-inf")  # router-clock cooldown anchor
        self._retry_at = float("-inf")     # paced respawn retries
        # supervisor worker boots run on background threads: a process boot
        # takes seconds, and running one inline would freeze every
        # replica's stepping exactly when scale-up was meant to relieve
        # pressure. Later ticks harvest them (attach_replica); boots in
        # flight count toward the fleet's size so recovery never
        # double-spawns
        self._boots: list[dict] = []
        self.events: deque = deque(maxlen=self.cfg.events_capacity)
        self.tm.gauge("router/autoscale/target_replicas").set(self.target)
        self.tm.gauge("router/autoscale/brownout").set(0)
        router.bind_autoscaler(self)
        if self.cfg.enabled:
            log_dist(
                f"autoscaler: replicas {self.cfg.min_replicas}.."
                f"{self.cfg.max_replicas} (target {self.target}), up at "
                f"queue>={self.cfg.scale_up_queue} or load/replica>="
                f"{self.cfg.scale_up_load}, down at load/replica<="
                f"{self.cfg.scale_down_load}, hysteresis "
                f"{self.cfg.up_consecutive}/{self.cfg.down_consecutive} "
                f"ticks, cooldown {self.cfg.cooldown_s}s", ranks=[0])

    # -- observation ------------------------------------------------------

    def signals(self, now: float) -> dict:
        """The cheap per-tick signal set (cached host-side state only)."""
        healthy = [r for r in self.router._replicas if r.state == "healthy"]
        n = len(healthy)
        load = sum(r.engine.load for r in healthy)
        queue = sum(r.engine.queue_len for r in healthy)
        # noisy-neighbour containment: backlog a tenant holds ABOVE its
        # quota never counts toward scale-up
        excess = int(self.router.tenant_excess())
        return {
            "healthy": n,
            "target": self.target,
            "queue": max(0, queue - excess),
            "tenant_excess": excess,
            "load": load,
            "load_per_replica": load / max(1, n),
            "step_sec": max((r.last_step_sec for r in healthy), default=0.0),
            "mfu": None,  # the program ledger's gauges: not ported
        }

    def slot_of(self, rid: int) -> Optional[int]:
        """Supervisor slot currently backing replica ``rid`` (None for
        in-process replicas): chaos drills target their kills with this."""
        return self._slots.get(rid)

    # -- the tick ---------------------------------------------------------

    def tick(self, now: float | None = None) -> Optional[dict]:
        """One evaluation; ``Router.step()`` calls this after stepping the
        fleet. Returns the signal dict it acted on (None when disabled)."""
        if not self.cfg.enabled:
            return None
        if now is None:
            now = self.router.now()
        if now == float("inf"):
            # drain-mode steps (Router.drain runs the clock at +inf):
            # signals are meaningless there, and an inf cooldown anchor
            # would freeze every later decision
            return None
        self._finish_retirements(now)
        self._poll_boots(now)
        self._recover(now)
        sig = self.signals(now)
        self._evaluate(now, sig)
        return sig

    def _evaluate(self, now: float, sig: dict) -> None:
        c = self.cfg
        up = ((c.scale_up_queue > 0 and sig["queue"] >= c.scale_up_queue)
              or (c.scale_up_load > 0
                  and sig["load_per_replica"] >= c.scale_up_load)
              or (c.scale_up_step_s > 0
                  and sig["step_sec"] >= c.scale_up_step_s))
        down = (not up and sig["queue"] == 0
                and sig["load_per_replica"] <= c.scale_down_load
                and sig["healthy"] >= self.target)
        self._up_for = self._up_for + 1 if up else 0
        if down:
            if self._down_for == 0:
                self._down_since = now
            self._down_for += 1
        else:
            self._down_for = 0
            self._down_since = float("inf")
        if up:
            self._calm_for = 0
            self._calm_since = float("inf")
        else:
            if self._calm_for == 0:
                self._calm_since = now
            self._calm_for += 1

        # brownout: growth ran out of headroom but the pressure persists
        if (self.target >= c.max_replicas
                and self._up_for >= c.up_consecutive
                and not self.router.brownout):
            self.router.set_brownout(True,
                                     deadline_s=c.brownout_deadline_s)
            self._event("brownout_on", now, sig)
        elif (self.router.brownout and self._calm_for >= c.up_consecutive
                and now - self._calm_since >= c.cooldown_s):
            # lifting is deliberate, like scale-down: the calm must span
            # BOTH up_consecutive evaluations AND cooldown_s of fleet-clock
            # time (an unpaced caller ticks hundreds of times through a
            # 100 ms trough)
            self.router.set_brownout(False)
            self._event("brownout_off", now, sig)

        cool = now - self._last_action >= c.cooldown_s
        if (up and self._up_for >= c.up_consecutive and cool
                and self.target < c.max_replicas):
            self._scale_up(now, sig)
        elif (down and self._down_for >= c.down_consecutive
                and now - self._down_since >= c.cooldown_s and cool
                and self.target > c.min_replicas and not self._boots):
            # scale-down is the slow direction: the streak must span BOTH
            # down_consecutive evaluations AND cooldown_s of fleet-clock
            # time, and a boot in flight (a bet on MORE capacity) vetoes it
            self._scale_down(now, sig)

    def _bump(self, delta: int) -> None:
        self.target += delta
        self.tm.gauge("router/autoscale/target_replicas").set(self.target)

    # -- actions ----------------------------------------------------------

    def _begin_boot(self, kind: str, slot: int, respawn: bool) -> None:
        """Start a supervisor worker boot on a background thread (it runs
        a process and waits on its socket; nothing here touches the
        device). ``_poll_boots`` harvests it."""
        holder = {"kind": kind, "slot": slot, "respawn": respawn,
                  "result": None, "error": None}

        def run():
            try:
                holder["result"] = (self.supervisor.respawn(slot) if respawn
                                    else self.supervisor.spawn(slot))
            except (RpcError, OSError, RuntimeError) as e:
                holder["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"dstt-asc-boot-{kind}-{slot}")
        holder["thread"] = t
        self._boots.append(holder)
        t.start()

    def _poll_boots(self, now: float) -> None:
        """Harvest finished background boots: attach each new replica (a
        NEW rid), or absorb the failure and pace the retry."""
        for b in [b for b in self._boots if not b["thread"].is_alive()]:
            self._boots.remove(b)
            if b["error"] is not None:
                # a failed boot must not take the serving loop down: the
                # fleet keeps serving at its size and the cooldown paces
                # the retry
                self.tm.counter("router/autoscale/spawn_failures").inc()
                self._event(
                    "respawn_failed" if b["respawn"] else "spawn_failed",
                    now, None,
                    error=f"{type(b['error']).__name__}: {b['error']}")
                if b["respawn"] and self.supervisor is not None:
                    # a corpse whose respawn failed leaves supervision, or
                    # it would sit at the head of poll()'s queue forever
                    self.supervisor.retire(b["slot"])
                if b["kind"] == "scale_up":
                    self._bump(-1)  # the size it never reached
                self._last_action = now
                self._retry_at = now + max(self.cfg.cooldown_s, 1.0)
                continue
            rid = self.router.attach_replica(b["result"])
            self._slots[rid] = b["slot"]
            if b["kind"] == "scale_up":
                self.tm.counter("router/autoscale/scale_ups").inc()
                self._event("scale_up", now, None, rid=rid, slot=b["slot"])
                log_dist(f"autoscaler: scaled UP to {self.target} (attached "
                         f"replica {rid})", ranks=[0])
            else:
                self.tm.counter("router/autoscale/respawns").inc()
                self._event("respawn", now, None, rid=rid, slot=b["slot"])
                log_dist(f"autoscaler: recovered a lost worker as replica "
                         f"{rid}", ranks=[0])

    def _spawn(self):
        return (self._spawn_fn() if self._spawn_fn is not None
                else self.router._spawn_inprocess())

    def _scale_up(self, now: float, sig: dict) -> None:
        self._up_for = 0
        self._last_action = now
        if self.supervisor is not None:
            # async: the target moves to the DESIRED size now; the boot
            # lands via _poll_boots (or reverts the target on failure)
            slot = self._slot_seq
            self._slot_seq += 1
            self._bump(+1)
            self._event("scale_up_started", now, sig, slot=slot)
            self._begin_boot("scale_up", slot, respawn=False)
            return
        try:
            engine = self._spawn()
        except (RpcError, OSError, RuntimeError) as e:
            self.tm.counter("router/autoscale/spawn_failures").inc()
            self._event("spawn_failed", now, sig,
                        error=f"{type(e).__name__}: {e}")
            return
        rid = self.router.attach_replica(engine)
        self._bump(+1)
        self.tm.counter("router/autoscale/scale_ups").inc()
        self._event("scale_up", now, sig, rid=rid)
        log_dist(f"autoscaler: scaled UP to {self.target} (attached replica "
                 f"{rid})", ranks=[0])

    def _scale_down(self, now: float, sig: dict) -> None:
        healthy = [r for r in self.router._replicas if r.state == "healthy"]
        if len(healthy) <= self.cfg.min_replicas:
            return
        # least-loaded first; rookies (highest rid) break ties so the
        # longest-lived replicas (warmest prefix caches) survive
        victim = min(healthy, key=lambda r: (r.engine.load, -r.rid))
        self.router.drain_replica(victim.rid, block=False)
        self._bump(-1)
        self._down_for = 0
        self._last_action = now
        self._retiring[victim.rid] = self._slots.pop(victim.rid, None)
        self.tm.counter("router/autoscale/scale_downs").inc()
        self._event("scale_down", now, sig, rid=victim.rid)
        log_dist(f"autoscaler: scaling DOWN to {self.target} (draining "
                 f"replica {victim.rid})", ranks=[0])

    def _finish_retirements(self, now: float) -> None:
        """Retire replicas that finished draining (or died on the way out:
        the router already failed their work over): a worker slot, the
        caller's ``retire``, or an in-process replica's device memory."""
        for rid, slot in list(self._retiring.items()):
            state = self.router._replicas[rid].state
            if state == "draining":
                continue
            del self._retiring[rid]
            if slot is not None and self.supervisor is not None:
                self.supervisor.retire(slot)
            elif self._retire_fn is not None:
                self._retire_fn(rid, self.router._replicas[rid].engine)
            else:
                self.router.release_replica(rid)
            self._event("retired", now, None, rid=rid, state=state)

    def _recover(self, now: float) -> None:
        """Heal the fleet back to ``target``: reap dead/hung worker
        processes (the supervisor SIGKILLs stale heartbeats) and respawn +
        attach replacements as NEW rids. A probation replica counts as
        alive (a hung verdict re-admits after backoff) UNLESS its worker
        process is a corpse: then ``Router.mark_dead`` turns the probation
        into a dead verdict and the slot is respawned."""
        bad = list(self.supervisor.poll()) if self.supervisor is not None \
            else []
        if bad:
            # a slot whose replacement is already booting can re-report
            # its old corpse: leave it to the boot thread
            booting = {b["slot"] for b in self._boots}
            bad = [s for s in bad if s not in booting]
        if bad:
            for rid, s in list(self._slots.items()):
                if s in bad:
                    del self._slots[rid]
                    if self.router._replicas[rid].state in (
                            "healthy", "probation"):
                        self.router.mark_dead(rid)
        alive = sum(1 for r in self.router._replicas
                    if r.state in ("healthy", "probation"))
        # boots in flight count toward the expected size
        missing = self.target - alive - len(self._boots)
        if missing <= 0:
            for slot in bad:
                # a corpse the fleet no longer needs (its rid is already
                # dead/drained and the target is met): reap only
                self.supervisor.retire(slot)
            return
        if now < self._retry_at:
            return
        if self.supervisor is not None:
            # async: one replacement boot starts per tick (further corpses
            # wait a tick each; poll() keeps reporting them)
            if bad:
                self._begin_boot("respawn", bad.pop(0), respawn=True)
            else:
                slot = self._slot_seq
                self._slot_seq += 1
                self._begin_boot("respawn", slot, respawn=False)
            return
        while missing > 0:
            try:
                engine = self._spawn()
            except (RpcError, OSError, RuntimeError) as e:
                # boot failure: pace the retry instead of spinning
                self.tm.counter("router/autoscale/spawn_failures").inc()
                self._event("respawn_failed", now, None,
                            error=f"{type(e).__name__}: {e}")
                self._retry_at = now + max(self.cfg.cooldown_s, 1.0)
                return
            rid = self.router.attach_replica(engine)
            self.tm.counter("router/autoscale/respawns").inc()
            self._event("respawn", now, None, rid=rid)
            log_dist(f"autoscaler: recovered a lost worker as replica "
                     f"{rid}", ranks=[0])
            missing -= 1

    # -- observability ----------------------------------------------------

    def _event(self, kind: str, now: float, sig: Optional[dict],
               **extra) -> None:
        ev = {"t": round(float(now), 4), "kind": kind,
              "target": self.target, **extra}
        if sig is not None:
            ev["signals"] = {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in sig.items()}
        self.events.append(ev)

    def describe(self) -> dict:
        """The snapshot block: current target, brownout state, and the
        bounded decision-event ring."""
        return {
            "enabled": bool(self.cfg.enabled),
            "target": self.target,
            "min": self.cfg.min_replicas,
            "max": self.cfg.max_replicas,
            "brownout": bool(self.router.brownout),
            "events": list(self.events),
        }


__all__ = ["Autoscaler"]
