"""Port parity: the serving fleet's autoscaler (``inference/autoscaler.py``)
and the Router's brownout ladder it drives.

Each case of ``tests/test_autoscaler.py`` (but the MFU signal's, whose
ledger the port refuses) runs once per package over the same host-only
scheduler fakes, or over real fp32 engines at ``tests/simple_model.py``
shapes with the same weights, on a fixed router clock (``step(now=...)``).
The decision events (kind, rid, slot, target and, where the clock is
fixed, the time), the ``router/*`` counters, the autoscale gauges, the
replica states and the terminal results must be equal; each case also
keeps the JAX test's own assertions. Cases whose worker boots run on a
background thread read the wall clock, so their events are compared
without times.
"""

import time
import types

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import Autoscaler as JaxAutoscaler
from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.resilience import RequestRejected as JaxRejected
from deepspeed_tpu.resilience import RpcConnectionLost as JaxConnLost
from deepspeed_tpu.resilience import RpcTimeout as JaxTimeout
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Autoscaler, Request, Router
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import RequestRejected, RpcConnectionLost, RpcTimeout
from deepspeed_tpu_torch.runtime import config as tconfig
from simple_model import tiny_transformer

SHAPES = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
MODEL = dict(SHAPES, decode_attn="xla", pos_emb="rotary")

JAX = types.SimpleNamespace(Router=JaxRouter, Autoscaler=JaxAutoscaler, Request=JaxRequest,
                            Rejected=JaxRejected, ConnLost=JaxConnLost, Timeout=JaxTimeout, name="jax")
TORCH = types.SimpleNamespace(Router=Router, Autoscaler=Autoscaler, Request=Request,
                              Rejected=RequestRejected, ConnLost=RpcConnectionLost, Timeout=RpcTimeout,
                              name="torch")


class _FakeEngine:
    """Host-only scheduler surface (everything the Router and the
    autoscaler read), with a controllable queue and an optional step
    fault; ``P`` supplies the package's transport error."""

    def __init__(self, P, rid=0):
        self.P, self.replica_id = P, rid
        self.queued = []
        self.last_step_compiled = False
        self.fail_next_step = False

    def submit(self, req):
        self.queued.append(req)
        return req.uid

    def requeue(self, req):
        return self.submit(req)

    def withdraw(self, uid):
        for i, r in enumerate(self.queued):
            if r.uid == uid:
                return self.queued.pop(i)
        return None

    def cancel(self, uid):
        return False

    def result(self, uid):
        return None

    def step(self, now=None, enforce_deadlines=True):
        if self.fail_next_step:
            self.fail_next_step = False
            raise self.P.ConnLost("fake worker gone")
        return []

    def live_requests(self):
        return list(self.queued)

    def arrived_queue_len(self, now=None):
        return len(self.queued)

    def prefix_match_len(self, prompt):
        return 0

    def pending_arrival_times(self):
        return []

    def set_epoch(self, epoch):
        pass

    def telemetry_snapshot(self):
        return {"replica_id": self.replica_id}

    @property
    def load(self):
        return len(self.queued)

    @property
    def idle(self):
        return not self.queued

    @property
    def queue_len(self):
        return len(self.queued)


class _FakeSupervisor:
    """Host-only WorkerSupervisor surface: a boot delay and a corpse set
    that poll() re-reports until the slot is respawned or retired."""

    def __init__(self, P, boot_s=0.0):
        self.P, self.boot_s = P, boot_s
        self.spawned, self.respawned, self.retired = [], [], []
        self.corpses = set()

    def spawn(self, slot):
        if self.boot_s:
            time.sleep(self.boot_s)
        self.spawned.append(slot)
        self.corpses.discard(slot)
        return _FakeEngine(self.P, 200 + slot)

    def respawn(self, slot):
        self.respawned.append(slot)
        return self.spawn(slot)

    def poll(self):
        return sorted(self.corpses)

    def retire(self, slot):
        self.retired.append(slot)
        self.corpses.discard(slot)


def _req(P, uid, priority=0, deadline_s=0.0):
    return P.Request(uid=uid, prompt=np.arange(4, dtype=np.int32), max_new_tokens=4, priority=priority,
                     deadline_s=deadline_s)


def _fleet(P, asc_cfg=None, router_cfg=None, n=1, spawn=None, retire=None):
    engines = [_FakeEngine(P, i) for i in range(n)]
    router = P.Router(replica_engines=engines, config={"router": {"health": {"timeout": 0}, **(router_cfg or {})}})
    spawned = []

    def default_spawn():
        e = _FakeEngine(P, 100 + len(spawned))
        spawned.append(e)
        return e

    asc = P.Autoscaler(router, {
        "enabled": True, "min_replicas": 1, "max_replicas": 2,
        "scale_up_queue": 3, "scale_up_load": 3.0, "scale_down_load": 0.5,
        "up_consecutive": 2, "down_consecutive": 3, "cooldown_s": 0.0,
        **(asc_cfg or {})}, spawn=spawn or default_spawn, retire=retire)
    return router, asc, engines, spawned


def _observe(router, asc, timed=True, **extra):
    """What a run showed: the decision events, the router counters and the
    autoscale gauges, the replica states and the terminal statuses."""
    keys = ("kind", "rid", "slot", "pool", "target", "state") + (("t",) if timed else ())
    events = [{k: e[k] for k in keys if k in e} for e in asc.events]
    snap = router.telemetry.registry.snapshot()
    return {"events": events,
            "counters": {k: v for k, v in snap["counters"].items() if k.startswith("router/")},
            "gauges": {k: v for k, v in snap["gauges"].items() if k.startswith("router/autoscale/")},
            "states": router.replica_states(), "target": asc.target, "brownout": router.brownout,
            "results": {u: r.status for u, r in router.results.items()}, **extra}


def _clear(router, engines):
    for e in engines:
        e.queued.clear()
    router._owner.clear()
    router._requests.clear()


# -- the cases: each runs one package and returns its observation ----------

def case_backlog_scales_up_after_hysteresis_window(P):
    router, asc, _, spawned = _fleet(P)
    for i in range(4):
        router.submit(_req(P, i))
    router.step(now=1.0)
    assert asc.target == 1 and not spawned
    router.step(now=2.0)
    assert asc.target == 2 and len(spawned) == 1
    return _observe(router, asc)


def case_flapping_signal_never_scales(P):
    router, asc, (eng,), spawned = _fleet(P)
    for t in range(10):
        if t % 2 == 0:
            for i in range(4):
                router.submit(_req(P, 1000 + t * 10 + i))
        else:
            for r in list(eng.queued):
                router.cancel(r.uid)
                eng.queued.clear()
            router._owner.clear()
            router._requests.clear()
        router.step(now=float(t))
    assert asc.target == 1 and not spawned
    return _observe(router, asc)


def case_cooldown_paces_consecutive_scale_ups(P):
    router, asc, _, spawned = _fleet(P, asc_cfg={"max_replicas": 4, "cooldown_s": 100.0})
    for i in range(12):
        router.submit(_req(P, i))
    for t in range(6):
        router.step(now=float(t))
    assert asc.target == 2 and len(spawned) == 1
    router.step(now=105.0)
    assert asc.target == 3 and len(spawned) == 2
    return _observe(router, asc)


def case_idle_scales_down_drains_and_retires(P):
    retired = []
    router, asc, _, _ = _fleet(P, n=2, retire=lambda rid, e: retired.append(rid))
    for t in range(10):
        router.step(now=float(t))
        if retired:
            break
    assert asc.target == 1 and retired == [1]
    assert router.replica_states() == {0: "healthy", 1: "drained"}
    return _observe(router, asc, retired=retired)


def case_min_replicas_floor_holds(P):
    router, asc, _, _ = _fleet(P, n=1)
    for t in range(20):
        router.step(now=float(t))
    assert asc.target == 1 and router.replica_states() == {0: "healthy"}
    return _observe(router, asc)


def case_dead_replica_respawned_as_new_rid(P):
    router, asc, (eng,), spawned = _fleet(P)
    eng.fail_next_step = True
    router.step(now=1.0)
    assert router.replica_states() == {0: "dead", 1: "healthy"} and len(spawned) == 1
    uid = router.submit(_req(P, 7))
    return _observe(router, asc, owner=router.owner_of(uid))


def case_spawn_failure_is_paced_not_fatal(P):
    def bad_spawn():
        raise RuntimeError("boot failed")

    router, asc, _, _ = _fleet(P, spawn=bad_spawn)
    for i in range(4):
        router.submit(_req(P, i))
    router.step(now=1.0)
    router.step(now=2.0)
    assert asc.target == 1 and any(e["kind"] == "spawn_failed" for e in asc.events)
    return _observe(router, asc)


def _supervised(P, sup, n, asc_cfg):
    router = P.Router(replica_engines=[_FakeEngine(P, i) for i in range(n)],
                      config={"router": {"health": {"timeout": 0}}})
    asc = P.Autoscaler(router, {"enabled": True, "min_replicas": 1, "max_replicas": 2, "scale_up_queue": 0,
                                "scale_up_load": 0.0, "scale_down_load": 0.0, "up_consecutive": 1,
                                "down_consecutive": 1000, "cooldown_s": 0.0, **asc_cfg},
                       supervisor=sup, slots={i: i for i in range(n)})
    return router, asc


def _tick_until(cond, tick, limit_s=5.0):
    deadline = time.monotonic() + limit_s
    while not cond():
        assert time.monotonic() < deadline
        tick()
        time.sleep(0.02)


def case_supervisor_boot_is_async_never_stalls_the_step_loop(P):
    sup = _FakeSupervisor(P, boot_s=0.3)
    router, asc = _supervised(P, sup, 1, {"scale_up_queue": 2, "scale_up_load": 2.0})
    for i in range(4):
        router.submit(_req(P, i))
    t0 = time.monotonic()
    router.step(now=1.0)
    assert time.monotonic() - t0 < 0.25  # the step did not pay the boot
    assert asc.target == 2 and len(router._replicas) == 1
    _tick_until(lambda: len(router._replicas) == 2, lambda: router.step(now=router.now()))
    assert sup.spawned == [1]
    return _observe(router, asc, timed=False, spawned=sup.spawned)


def case_probation_corpse_is_respawned_not_retired(P):
    sup = _FakeSupervisor(P)
    router, asc = _supervised(P, sup, 1, {})
    router._replicas[0].state = "probation"
    sup.corpses = {0}
    asc.tick(now=1.0)
    assert router.replica_states()[0] == "dead" and sup.retired == []
    _tick_until(lambda: len(router._replicas) == 2, lambda: asc.tick(now=router.now()))
    assert sup.respawned == [0] and router.replica_states()[1] == "healthy"
    return _observe(router, asc, timed=False, respawned=sup.respawned)


def case_exhausted_corpse_is_dropped_so_other_corpses_recover(P):
    class _ExhaustedSlot0(_FakeSupervisor):
        def respawn(self, slot):
            self.respawned.append(slot)
            if slot == 0:
                raise RuntimeError("serving worker slot 0 exhausted its respawn budget")
            return self.spawn(slot)

    sup = _ExhaustedSlot0(P)
    router, asc = _supervised(P, sup, 2, {"min_replicas": 2, "max_replicas": 3})
    router._replicas[0].state = "dead"
    router._replicas[1].state = "dead"
    sup.corpses = {0, 1}
    _tick_until(lambda: sum(s == "healthy" for s in router.replica_states().values()) == 2,
                lambda: asc.tick(now=router.now()))
    assert 0 in sup.retired and sup.respawned.count(0) == 1 and 1 in sup.respawned
    return _observe(router, asc, timed=False, respawned=sorted(sup.respawned), retired=sorted(sup.retired))


def _saturate_to_brownout(P, router):
    for i in range(4):
        router.submit(_req(P, i))
    for t in (1.0, 2.0, 3.0, 4.0):
        router.step(now=t)
    assert router.brownout


def case_brownout_ladder_deadline_priority_shed_and_overloaded(P):
    router, asc, engines, spawned = _fleet(P, asc_cfg={"brownout_deadline_s": 5.0},
                                           router_cfg={"max_queue_len": 4})
    _saturate_to_brownout(P, router)
    router.submit(_req(P, 50, priority=1))
    shed = [u for u, r in router.results.items() if r.status == "shed_brownout"]
    assert shed == [3] and 3 not in router._owner
    req50 = next(r for e in engines + spawned for r in e.queued if r.uid == 50)
    router.cancel(50)
    with pytest.raises(P.Rejected) as ei:
        router.submit(_req(P, 60, priority=0))
    assert ei.value.reason == "overloaded"
    return _observe(router, asc, deadline50=req50.deadline_s, reason=ei.value.reason)


def case_brownout_lifts_when_pressure_clears(P):
    router, asc, engines, spawned = _fleet(P, asc_cfg={"brownout_deadline_s": 5.0})
    _saturate_to_brownout(P, router)
    _clear(router, engines + spawned)
    router.step(now=5.0)
    router.step(now=6.0)
    assert not router.brownout
    router.submit(_req(P, 70))
    req70 = next(r for e in engines + spawned for r in e.queued if r.uid == 70)
    return _observe(router, asc, deadline70=req70.deadline_s)


def case_brownout_lift_requires_wall_time_not_just_ticks(P):
    """The calm must span cooldown_s on the router clock, not just ticks
    (JAX's test_brownout_lift_requires_wall_time_not_just_ticks)."""
    router, asc, engines, spawned = _fleet(P, asc_cfg={"cooldown_s": 5.0})
    for i in range(4):
        router.submit(_req(P, i))
    for t in (9.0, 10.0, 11.0, 12.0):
        router.step(now=t)
    assert router.brownout
    _clear(router, engines + spawned)
    lifted = []
    for k in range(10):
        router.step(now=13.0 + k * 0.01)
        lifted.append(router.brownout)
    assert all(lifted)
    router.step(now=19.0)
    assert not router.brownout
    return _observe(router, asc)


def case_brownout_shed_survives_withdraw_timeout(P):
    class _TimeoutOnceEngine(_FakeEngine):
        timeouts = 1

        def withdraw(self, uid):
            if self.timeouts:
                self.timeouts -= 1
                raise self.P.Timeout("reply lost to the per-call deadline")
            return super().withdraw(uid)

    router = P.Router(replica_engines=[_TimeoutOnceEngine(P, 0)],
                      config={"router": {"max_queue_len": 2, "health": {"timeout": 0}}})
    router.set_brownout(True)
    for uid, prio in ((0, 0), (1, 0), (2, 1)):
        router.submit(_req(P, uid, priority=prio))
    shed = [u for u, r in router.results.items() if r.status == "shed_brownout"]
    assert shed == [1] and 1 not in router._owner
    term = router.step(now=0.0)
    assert 1 in term
    snap = router.telemetry.registry.snapshot()
    return {"shed": shed, "term": term, "counters": snap["counters"], "states": router.replica_states()}


def case_own_deadline_survives_brownout_tightening(P):
    router, asc, engines, spawned = _fleet(P, asc_cfg={"brownout_deadline_s": 5.0})
    _saturate_to_brownout(P, router)
    router.submit(_req(P, 80, priority=3, deadline_s=99.0))
    req80 = next(r for e in engines + spawned for r in e.queued if r.uid == 80)
    assert req80.deadline_s == 99.0
    return _observe(router, asc)


def case_snapshot_carries_autoscale(P):
    router, asc, _, _ = _fleet(P)
    for i in range(4):
        router.submit(_req(P, i))
    router.step(now=1.0)
    router.step(now=2.0)
    block = router.telemetry_snapshot()["router"]["autoscale"]
    assert block["target"] == 2 and block["enabled"]
    return {"block": block, **_observe(router, asc)}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autoscaler_matches_jax(case):
    assert CASES[case](TORCH) == CASES[case](JAX)


# -- real engines -------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _inprocess_autoscaled(P, eng, kill_at=None):
    """Router(engine, config) with ``router.autoscale`` on builds its own
    autoscaler: a backlog of 6 grows the fleet, idle steps shrink it back
    to min, and (``kill_at``) a replica killed mid-run is replaced by a new
    rid. Fixed clock, every step observed."""
    cfg = {"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise",
           "router": {"replicas": 1, "health": {"timeout": 30.0},
                      "autoscale": {"enabled": True, "min_replicas": 1, "max_replicas": 2, "scale_up_queue": 2,
                                    "scale_up_load": 2.0, "scale_down_load": 0.5, "up_consecutive": 1,
                                    "down_consecutive": 2, "cooldown_s": 0.0}}}
    if P is JAX:
        cfg["ledger"] = {"enabled": False}
    if kill_at is not None:
        cfg["fault_injection"] = {"enabled": True, "replica_dead_at": [list(kill_at)]}
    router = P.Router(eng, config=cfg)
    asc = router._autoscaler
    assert asc is not None and asc.cfg.enabled
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=s).astype(np.int32) for s in (5, 11, 23)]
    for i in range(6):
        router.submit(P.Request(uid=i, prompt=prompts[i % 3], max_new_tokens=8))
    log = []
    for t in range(60):
        log.append((router.step(now=float(t)), router.replica_states(), asc.target))
        states = router.replica_states()
        if (not router._owner and asc.target == 1
                and sum(s == "healthy" for s in states.values()) == 1
                and all(s in ("healthy", "drained", "dead") for s in states.values())):
            break
    res = {u: (r.status, [int(x) for x in r.tokens]) for u, r in router.results.items()}
    return {**_observe(router, asc), "log": log, "results": res,
            "decode_programs": [r.engine.compile_counts()["decode"] for r in router._replicas]}


@pytest.mark.parametrize("kill_at", [None, (1, 4)], ids=["grow_and_shrink", "replica_killed"])
def test_inprocess_autoscaled_fleet_matches_jax(engines, kill_at):
    tout = _inprocess_autoscaled(TORCH, engines["torch"], kill_at)
    jout = _inprocess_autoscaled(JAX, engines["jax"], kill_at)
    assert tout == jout
    assert all(s == "ok" for s, _ in tout["results"].values()) and len(tout["results"]) == 6
    assert tout["counters"]["router/autoscale/scale_ups"] >= 1 and tout["target"] == 1
    assert all(n <= 1 for n in tout["decode_programs"])
    if kill_at is not None:
        assert tout["counters"]["router/autoscale/respawns"] >= 1


def test_inprocess_retirement_frees_the_replica(engines):
    """A replica the autoscaler drained and retired is close()d: its slot
    cache and prefix pool are released (the port's own contract)."""
    out = _inprocess_autoscaled(TORCH, engines["torch"])
    assert any(s == "drained" for s in out["states"].values())
    router = Router(engines["torch"], config={
        "n_slots": 2, "router": {"replicas": 2, "health": {"timeout": 0},
                                 "autoscale": {"enabled": True, "min_replicas": 1, "max_replicas": 2,
                                               "down_consecutive": 1, "cooldown_s": 0.0}}})
    for t in range(6):
        router.step(now=float(t))
    gone = [r for r in router._replicas if r.state == "drained"]
    assert len(gone) == 1 and gone[0].engine.worker._cache is None and gone[0].engine.worker._pool is None
    assert all(r.engine.worker._cache is not None for r in router._replicas if r.state == "healthy")


# -- config -------------------------------------------------------------------

def test_autoscale_config_schema_matches_jax():
    d = {"enabled": True, "min_replicas": 2, "max_replicas": 5, "cooldown_s": 1.5, "brownout_deadline_s": 10.0}
    a, b = tconfig.AutoscaleConfig(**d), jconfig.AutoscaleConfig(**d)
    assert vars(a) == vars(b)
    for bad in ({"min_replicas": 4, "max_replicas": 2}, {"scale_up_load": 1.0, "scale_down_load": 2.0},
                {"events_capacity": 0}, {"scale_up_mfu": 2.0}, {"cooldown_s": -1}):
        with pytest.raises(jconfig.DeepSpeedConfigError) as je:
            jconfig.AutoscaleConfig(**bad)
        with pytest.raises(tconfig.DeepSpeedConfigError) as te:
            tconfig.AutoscaleConfig(**bad)
        assert str(te.value) == str(je.value)


def test_scale_up_mfu_is_refused_not_dropped():
    """The MFU up-signal reads the program ledger's gauges, which the port
    refuses: a threshold that could never fire raises, naming it, from the
    config block, the Router and a directly built Autoscaler alike."""
    block = {"enabled": True, "scale_up_queue": 0, "scale_up_load": 0.0, "scale_up_mfu": 0.5}
    with pytest.raises(NotImplementedError, match="scale_up_mfu"):
        tconfig.RouterConfig(autoscale=block).check_ported()
    router = Router(replica_engines=[_FakeEngine(TORCH)], config={"router": {"health": {"timeout": 0}}})
    with pytest.raises(NotImplementedError, match="scale_up_mfu"):
        Autoscaler(router, block)
    tconfig.RouterConfig(autoscale=dict(block, enabled=False)).check_ported()
