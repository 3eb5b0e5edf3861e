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
  * ``mfu``              mean fleet MFU from the program ledger's
                         ``serving/mfu`` gauges, folded in by ``observe``
                         from a ``Router.telemetry_snapshot()`` (or passed
                         to ``tick``) at the caller's cadence; None until
                         one is seen.

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

A disaggregated fleet (``router.disagg``) scales its prefill and decode
pools on their own signals (``pool_signals`` / ``_evaluate_pool``): the
prefill pool on its arrival queue and chunk backlog, the decode pool on
slot occupancy (staged imports included), step latency and the Router's
parked-handoff backlog; each within its own ``disagg`` envelope, with the
shared hysteresis and cooldown. Newcomers are role-pinned
(``_spawn_inprocess(role)``, or the supervisor's ``roles``), and a dead
worker heals back into its own pool.
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
        # disaggregated fleets scale the prefill and decode pools on their
        # OWN signals:
        # per-pool targets, min/max envelopes and hysteresis state, with
        # the shared cooldown/consecutive knobs from the autoscale block
        dg = getattr(router.cfg, "disagg", None)
        self._disagg = bool(dg is not None and dg.enabled)
        self.pool_cfg: dict[str, dict] = {}
        self.pool_target: dict[str, int] = {}
        self._pool: dict[str, dict] = {}
        if self._disagg:
            self.pool_cfg = {
                "prefill": {"min": int(dg.prefill_min_replicas),
                            "max": int(dg.prefill_max_replicas)},
                "decode": {"min": int(dg.decode_min_replicas),
                           "max": int(dg.decode_max_replicas)},
            }
            for role, pc in self.pool_cfg.items():
                n = sum(1 for r in router._replicas
                        if r.state == "healthy" and r.role == role)
                self.pool_target[role] = min(max(n, pc["min"]), pc["max"])
                self._pool[role] = {"up_for": 0, "down_for": 0,
                                    "down_since": float("inf"),
                                    "last_action": float("-inf")}
                self.tm.gauge(
                    f"router/autoscale/{role}_target_replicas").set(
                    self.pool_target[role])
            self.target = sum(self.pool_target.values())
        self._up_for = 0
        self._down_for = 0
        self._down_since = float("inf")  # router-clock start of the streak
        self._calm_for = 0
        self._calm_since = float("inf")  # router-clock start of calm
        self._last_action = float("-inf")  # router-clock cooldown anchor
        self._retry_at = float("-inf")     # paced respawn retries
        self._mfu: Optional[float] = None  # the last observed fleet MFU
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

    def observe(self, snapshot: dict) -> Optional[float]:
        """Fold a ``Router.telemetry_snapshot()`` into the MFU signal: the
        mean of the replicas' ``serving/mfu`` gauges (the program ledger).
        Snapshots are dear over RPC, so the caller picks the cadence; the
        last observation holds between calls."""
        vals = []
        for rep in (snapshot.get("replicas") or {}).values():
            gauges = (rep.get("metrics") or {}).get("gauges") or {}
            v = gauges.get("serving/mfu")
            if v is not None:
                vals.append(float(v))
        if vals:
            self._mfu = sum(vals) / len(vals)
        return self._mfu

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
            "mfu": self._mfu,
        }

    def slot_of(self, rid: int) -> Optional[int]:
        """Supervisor slot currently backing replica ``rid`` (None for
        in-process replicas): chaos drills target their kills with this."""
        return self._slots.get(rid)

    # -- the tick ---------------------------------------------------------

    def tick(self, now: float | None = None, snapshot: dict | None = None) -> Optional[dict]:
        """One evaluation; ``Router.step()`` calls this after stepping the
        fleet. ``snapshot`` (a ``Router.telemetry_snapshot()``) is folded
        into the MFU signal first. Returns the signal dict it acted on
        (None when disabled)."""
        if not self.cfg.enabled:
            return None
        if now is None:
            now = self.router.now()
        if now == float("inf"):
            # drain-mode steps (Router.drain runs the clock at +inf):
            # signals are meaningless there, and an inf cooldown anchor
            # would freeze every later decision
            return None
        if snapshot is not None:
            self.observe(snapshot)
        self._finish_retirements(now)
        self._poll_boots(now)
        self._recover(now)
        sig = self.signals(now)
        if self._disagg:
            # per-pool evaluation: each pool's OWN signals against its own
            # envelope and hysteresis; the fleet signals ride along for the
            # event ring
            sig["pools"] = {role: self._evaluate_pool(now, role)
                            for role in ("prefill", "decode")}
        else:
            self._evaluate(now, sig)
        return sig

    def _evaluate(self, now: float, sig: dict) -> None:
        c = self.cfg
        up = ((c.scale_up_queue > 0 and sig["queue"] >= c.scale_up_queue)
              or (c.scale_up_load > 0
                  and sig["load_per_replica"] >= c.scale_up_load)
              or (c.scale_up_step_s > 0
                  and sig["step_sec"] >= c.scale_up_step_s)
              or (c.scale_up_mfu > 0 and sig["mfu"] is not None
                  and sig["mfu"] >= c.scale_up_mfu))
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

    # -- per-pool evaluation (disaggregated fleets) -----------------------

    def pool_signals(self, now: float, role: str) -> dict:
        """One pool's cheap per-tick signal set. Prefill pressure is
        arrival backlog (queued) + chunk backlog (slots mid-prefill plus
        finished slots parked awaiting handoff); decode pressure is slot
        occupancy (staged imports included) + step latency, with the
        router's parked-handoff backlog as the slots-exhausted override."""
        members = [r for r in self.router._replicas
                   if r.state == "healthy" and r.role == role]
        n = len(members)
        load = sum(r.engine.load for r in members)
        queue = sum(r.engine.queue_len for r in members)
        sig = {
            "pool": role,
            "healthy": n,
            "target": self.pool_target[role],
            "queue": queue,
            "load": load,
            "load_per_replica": load / max(1, n),
            "step_sec": max((r.last_step_sec for r in members), default=0.0),
        }
        if role == "prefill":
            sig["backlog"] = load - queue  # mid-prefill + parked handoffs
        else:
            sig["occupancy"] = (sum(
                float(getattr(r.engine, "occupancy", 0.0)) for r in members)
                / max(1, n))
            sig["parked"] = int(self.router._handoff_backlog)
        return sig

    def _evaluate_pool(self, now: float, role: str) -> dict:
        c = self.cfg
        d = self.router.cfg.disagg
        st = self._pool[role]
        pc = self.pool_cfg[role]
        sig = self.pool_signals(now, role)
        if role == "prefill":
            up = ((d.prefill_scale_up_queue > 0
                   and sig["queue"] >= d.prefill_scale_up_queue)
                  or (d.prefill_scale_up_backlog > 0
                      and sig["backlog"] >= d.prefill_scale_up_backlog))
        else:
            up = ((d.decode_scale_up_occupancy > 0
                   and sig["occupancy"] >= d.decode_scale_up_occupancy)
                  # a parked handoff IS an exhausted decode pool: prefill
                  # finished work it cannot place
                  or sig["parked"] > 0
                  or (d.decode_scale_up_step_s > 0
                      and sig["step_sec"] >= d.decode_scale_up_step_s))
        down = (not up and sig["queue"] == 0
                and sig["load_per_replica"] <= c.scale_down_load
                and sig["healthy"] >= self.pool_target[role])
        st["up_for"] = st["up_for"] + 1 if up else 0
        if down:
            if st["down_for"] == 0:
                st["down_since"] = now
            st["down_for"] += 1
        else:
            st["down_for"] = 0
            st["down_since"] = float("inf")
        cool = now - st["last_action"] >= c.cooldown_s
        booting = any(b.get("role") == role for b in self._boots)
        if (up and st["up_for"] >= c.up_consecutive and cool
                and self.pool_target[role] < pc["max"]):
            self._scale_up(now, sig, role=role)
        elif (down and st["down_for"] >= c.down_consecutive
                and now - st["down_since"] >= c.cooldown_s and cool
                and self.pool_target[role] > pc["min"] and not booting):
            self._scale_down(now, sig, role=role)
        return sig

    def _bump_pool(self, role: Optional[str], delta: int) -> None:
        """Move the fleet target (and, in disagg mode, the pool target and
        its gauge) by ``delta``: the one bookkeeping path every scale and
        failed-boot revert shares."""
        self.target += delta
        self.tm.gauge("router/autoscale/target_replicas").set(self.target)
        if role is not None and role in self.pool_target:
            self.pool_target[role] += delta
            self.tm.gauge(f"router/autoscale/{role}_target_replicas").set(
                self.pool_target[role])

    # -- actions ----------------------------------------------------------

    def _begin_boot(self, kind: str, slot: int, respawn: bool,
                    role: Optional[str] = None) -> None:
        """Start a supervisor worker boot on a background thread (it runs
        a process and waits on its socket; nothing here touches the
        device). ``_poll_boots`` harvests it. ``role`` pins the worker to
        a disaggregated pool (``--role``; a respawn of the slot keeps it)."""
        holder = {"kind": kind, "slot": slot, "respawn": respawn,
                  "role": role, "result": None, "error": None}
        roles = getattr(self.supervisor, "roles", None)
        if role is not None and roles is not None:
            roles[slot] = role

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
                    # the size it never reached
                    self._bump_pool(b.get("role"), -1)
                self._last_action = now
                self._retry_at = now + max(self.cfg.cooldown_s, 1.0)
                continue
            rid = self.router.attach_replica(b["result"])
            self._slots[rid] = b["slot"]
            extra = {"pool": b["role"]} if b.get("role") else {}
            if b["kind"] == "scale_up":
                self.tm.counter("router/autoscale/scale_ups").inc()
                self._event("scale_up", now, None, rid=rid, slot=b["slot"],
                            **extra)
                log_dist(f"autoscaler: scaled UP to {self.target} (attached "
                         f"replica {rid})", ranks=[0])
            else:
                self.tm.counter("router/autoscale/respawns").inc()
                self._event("respawn", now, None, rid=rid, slot=b["slot"],
                            **extra)
                log_dist(f"autoscaler: recovered a lost worker as replica "
                         f"{rid}", ranks=[0])

    def _spawn(self, role: Optional[str] = None):
        return (self._spawn_fn() if self._spawn_fn is not None
                else self.router._spawn_inprocess(role=role))

    def _scale_up(self, now: float, sig: dict,
                  role: Optional[str] = None) -> None:
        self._up_for = 0
        self._last_action = now
        if role is not None:
            self._pool[role]["up_for"] = 0
            self._pool[role]["last_action"] = now
        extra = {"pool": role} if role else {}
        if self.supervisor is not None:
            # async: the target moves to the DESIRED size now; the boot
            # lands via _poll_boots (or reverts the target on failure)
            slot = self._slot_seq
            self._slot_seq += 1
            self._bump_pool(role, +1)
            self._event("scale_up_started", now, sig, slot=slot, **extra)
            self._begin_boot("scale_up", slot, respawn=False, role=role)
            return
        try:
            engine = self._spawn(role)
        except (RpcError, OSError, RuntimeError) as e:
            self.tm.counter("router/autoscale/spawn_failures").inc()
            self._event("spawn_failed", now, sig,
                        error=f"{type(e).__name__}: {e}", **extra)
            return
        rid = self.router.attach_replica(engine)
        self._bump_pool(role, +1)
        self.tm.counter("router/autoscale/scale_ups").inc()
        self._event("scale_up", now, sig, rid=rid, **extra)
        log_dist(f"autoscaler: scaled UP to {self.target} (attached replica "
                 f"{rid})", ranks=[0])

    def _scale_down(self, now: float, sig: dict,
                    role: Optional[str] = None) -> None:
        healthy = [r for r in self.router._replicas if r.state == "healthy"
                   and (role is None or r.role == role)]
        floor = (self.pool_cfg[role]["min"] if role is not None
                 else self.cfg.min_replicas)
        if len(healthy) <= floor:
            return
        # least-loaded first; rookies (highest rid) break ties so the
        # longest-lived replicas (warmest prefix caches) survive
        victim = min(healthy, key=lambda r: (r.engine.load, -r.rid))
        self.router.drain_replica(victim.rid, block=False)
        self._bump_pool(role, -1)
        self._down_for = 0
        self._last_action = now
        if role is not None:
            self._pool[role]["down_for"] = 0
            self._pool[role]["last_action"] = now
        self._retiring[victim.rid] = self._slots.pop(victim.rid, None)
        self.tm.counter("router/autoscale/scale_downs").inc()
        self._event("scale_down", now, sig, rid=victim.rid,
                    **({"pool": role} if role else {}))
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
        # disagg fleets heal per pool: a dead decode worker comes back as a
        # DECODE replica, not generic capacity
        pool_missing: dict[str, int] = {}
        if self._disagg:
            for role, tgt in self.pool_target.items():
                al = sum(1 for r in self.router._replicas
                         if r.state in ("healthy", "probation")
                         and r.role == role)
                boots = sum(1 for b in self._boots if b.get("role") == role)
                pool_missing[role] = tgt - al - boots
            missing = sum(max(0, m) for m in pool_missing.values())
        if missing <= 0:
            for slot in bad:
                # a corpse the fleet no longer needs (its rid is already
                # dead/drained and the target is met): reap only
                self.supervisor.retire(slot)
            return
        if now < self._retry_at:
            return
        need_role = None
        if pool_missing:
            need_role = max(pool_missing, key=lambda k: pool_missing[k])
        if self.supervisor is not None:
            # async: one replacement boot starts per tick (further corpses
            # wait a tick each; poll() keeps reporting them). A respawned
            # slot keeps its role (supervisor.roles is keyed by slot)
            if bad:
                slot = bad.pop(0)
                self._begin_boot(
                    "respawn", slot, respawn=True,
                    role=getattr(self.supervisor, "roles", {}).get(slot)
                    if self._disagg else None)
            else:
                slot = self._slot_seq
                self._slot_seq += 1
                self._begin_boot("respawn", slot, respawn=False,
                                 role=need_role)
            return
        while missing > 0:
            if pool_missing:
                need_role = max(pool_missing, key=lambda k: pool_missing[k])
            try:
                engine = self._spawn(need_role)
            except (RpcError, OSError, RuntimeError) as e:
                # boot failure: pace the retry instead of spinning
                self.tm.counter("router/autoscale/spawn_failures").inc()
                self._event("respawn_failed", now, None,
                            error=f"{type(e).__name__}: {e}")
                self._retry_at = now + max(self.cfg.cooldown_s, 1.0)
                return
            rid = self.router.attach_replica(engine)
            self.tm.counter("router/autoscale/respawns").inc()
            self._event("respawn", now, None, rid=rid,
                        **({"pool": need_role} if need_role else {}))
            log_dist(f"autoscaler: recovered a lost worker as replica "
                     f"{rid}", ranks=[0])
            if need_role is not None:
                pool_missing[need_role] -= 1
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
        out = {
            "enabled": bool(self.cfg.enabled),
            "target": self.target,
            "min": self.cfg.min_replicas,
            "max": self.cfg.max_replicas,
            "brownout": bool(self.router.brownout),
            "events": list(self.events),
        }
        if self._disagg:
            out["pools"] = {
                role: {"target": self.pool_target[role],
                       "min": pc["min"], "max": pc["max"]}
                for role, pc in self.pool_cfg.items()}
        return out


__all__ = ["Autoscaler"]
