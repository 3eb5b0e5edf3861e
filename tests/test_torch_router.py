"""Port parity: the serving fleet's Router.

The JAX ``Router`` and the port's, each over two (or three) in-process
``ServingEngine`` replicas of one fp32 model at ``tests/simple_model.py``
shapes with the same weights (``interop.params_from_jax``), are driven
through the same script on a fixed clock (``step(now=...)``). After every
step the terminal uids, every request's owner and the replica states must
be equal; at the end the tokens and statuses, ``router_stats()`` and the
``router/*`` counters. The cases mirror ``tests/test_router.py``: failover
mid-decode, mid-prefill and under speculation, drain (under load, and
interleaved with a sibling's death), typed global shedding and the
brownout ladder (deadline tightening, tenant-first priority shedding,
``overloaded``), prefix
affinity, hang probation and escalation, the exactly-once budget, the
compile exemption, cancel and duplicate uids, and verdict clocks that
never read the wall clock.
"""

import time as _time
import types

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference import router as jrouter_mod
from deepspeed_tpu.resilience import RequestRejected as JaxRejected
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import router as trouter_mod
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import RequestRejected
from deepspeed_tpu_torch.runtime import config as tconfig
from simple_model import tiny_transformer

# tests/simple_model.py's transformer; plain cached attention in both
SHAPES = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
MODEL = dict(SHAPES, decode_attn="xla", pos_emb="rotary")
FEATURES = {"prefix_cache": {"enabled": True, "n_slots": 4, "block": 8, "max_prefix_len": 64},
            "chunked_prefill": {"enabled": True, "chunk_size": 16}}

JAX = types.SimpleNamespace(Router=JaxRouter, Request=JaxRequest, Rejected=JaxRejected,
                            ServingEngine=JaxServingEngine, module=jrouter_mod, name="jax")
TORCH = types.SimpleNamespace(Router=Router, Request=Request, Rejected=RequestRejected,
                              ServingEngine=ServingEngine, module=trouter_mod, name="torch")


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _prompts(sizes, seed=0, vocab=97):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def _router(P, eng, n_slots=2, replicas=2, timeout=30.0, fi=None, health=None, **extra):
    router = {"replicas": replicas, "health": {"timeout": timeout, **(health or {})}}
    router.update(extra.pop("router", {}))
    cfg = {"n_slots": n_slots, "max_seq_len": 64, "router": router, **extra}
    if P is JAX:
        cfg["ledger"] = {"enabled": False}
    if fi is not None:
        cfg["fault_injection"] = {"enabled": True, "seed": 0, **fi}
    return P.Router(eng, config=cfg)


class _Obs:
    """What one package's run showed, step by step."""

    def __init__(self, router, uids):
        self.router, self.uids, self.log = router, list(uids), []

    def step(self, now=0.0, **kw):
        term = self.router.step(now=now, **kw)
        self.log.append(("step", list(term), {u: self.router.owner_of(u) for u in self.uids},
                         self.router.replica_states()))
        return term

    def note(self, *what):
        self.log.append(what)

    def finish(self):
        r = self.router
        res = {u: (res.status, [int(t) for t in res.tokens]) for u, res in r.results.items()}
        counters = {k: v for k, v in r.telemetry.registry.snapshot()["counters"].items()
                    if k.startswith(("router/", "resilience/"))}
        return {"log": self.log, "results": res, "stats": r.router_stats(), "counters": counters}


def _submit_all(P, router, prompts, max_new, uid0=0):
    for i, p in enumerate(prompts):
        router.submit(P.Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new))


def _steps_until_idle(obs, now=0.0, limit=60):
    for _ in range(limit):
        if not obs.router._owner:
            break
        obs.step(now)


# -- the cases: each runs one package's Router and returns its observation

def case_failover_mid_decode(P, eng):
    prompts = _prompts([5, 11, 23])
    router = _router(P, eng, fi={"replica_dead_at": [[0, 3]]}, watchdog_mode="raise")
    obs = _Obs(router, range(3))
    _submit_all(P, router, prompts, 8)
    _steps_until_idle(obs)
    out = obs.finish()
    out["decode_programs"] = [r.engine.compile_counts()["decode"] for r in router._replicas
                              if r.state != "dead"]
    return out


def case_failover_mid_prefill(P, eng):
    rng = np.random.default_rng(21)
    prompt = np.concatenate([rng.integers(0, 97, size=40), rng.integers(0, 97, size=5)]).astype(np.int32)
    router = _router(P, eng, fi={"replica_dead_at": [[0, 2]]}, watchdog_mode="raise", **FEATURES)
    obs = _Obs(router, [0])
    _submit_all(P, router, [prompt], 6)
    _steps_until_idle(obs)
    out = obs.finish()
    out["inserts"] = [r.engine.prefix_cache_stats()["inserts"] for r in router._replicas]
    return out


def case_speculation_failover(P, eng):
    prompts = _prompts([5, 11, 23])
    router = _router(P, eng, fi={"replica_dead_at": [[0, 3]]}, watchdog_mode="raise",
                     speculation={"enabled": True, "depth": 4})
    obs = _Obs(router, range(3))
    _submit_all(P, router, prompts, 24)
    _steps_until_idle(obs, limit=80)
    out = obs.finish()
    out["verify"] = [r.engine.compile_counts().get("verify", {}) for r in router._replicas if r.state != "dead"]
    return out


def case_drain_under_load(P, eng):
    prompts = _prompts([5, 9, 17, 6, 12], seed=2)
    router = _router(P, eng)
    obs = _Obs(router, list(range(5)) + [100])
    for i, p in enumerate(prompts):
        router.submit(P.Request(uid=i, prompt=p, max_new_tokens=4 + i))
    router.drain_replica(0, block=False)
    obs.note("drain", router.replica_states(), {u: router.owner_of(u) for u in range(5)})
    _steps_until_idle(obs)
    router.submit(P.Request(uid=100, prompt=prompts[0], max_new_tokens=2))
    obs.note("owner_100", router.owner_of(100))
    _steps_until_idle(obs)
    try:
        router.drain_replica(0)
    except ValueError as e:
        obs.note("drain_again", "only a healthy replica" in str(e))
    return obs.finish()


def case_drain_with_sibling_death(P, eng):
    prompts = _prompts([5, 11, 23, 9, 17, 6], seed=17)
    router = _router(P, eng, replicas=3, fi={"replica_dead_at": [[1, 3]]})
    obs = _Obs(router, list(range(6)) + [10, 11])
    _submit_all(P, router, prompts, 8)
    for _ in range(3):
        obs.step()
    _submit_all(P, router, _prompts([5, 9], seed=18), 4, uid0=10)
    router.drain_replica(0, block=False)
    obs.note("drain", {u: router.owner_of(u) for u in obs.uids})
    _steps_until_idle(obs)
    return obs.finish()


def case_global_shed(P, eng):
    prompts = _prompts([5, 11, 9], seed=3)
    router = _router(P, eng, n_slots=1, router={"max_queue_len": 2})
    obs = _Obs(router, range(3))
    _submit_all(P, router, prompts[:2], 2)
    try:
        router.submit(P.Request(uid=2, prompt=prompts[2], max_new_tokens=2))
    except P.Rejected as e:
        obs.note("rejected", e.uid, e.reason)
    _steps_until_idle(obs, now=float("inf"))
    return obs.finish()


def case_brownout_shed(P, eng):
    """Brownout under a full global queue (tenant "a" over its quota):
    deadline-free arrivals take the brownout deadline while no tenant is
    over quota, a higher-priority arrival sheds the over-quota tenant's
    newest queued request, an arrival that nothing queued is below bounces
    as ``overloaded``, and once the brownout lifts a full queue bounces as
    ``queue_full``. The tightened requests still queued at t=100 miss their
    deadline."""
    prompts = _prompts([5, 11, 9, 7, 6, 8], seed=23)
    router = _router(P, eng, n_slots=1, router={"max_queue_len": 3})
    router.set_tenant_policy({"a": {"max_queued": 1}, "b": {}})
    router.set_brownout(True, deadline_s=50.0)
    obs = _Obs(router, range(6))
    for uid, tenant, prio in ((0, "a", 0), (1, "a", 0), (2, "b", 0), (3, "b", 1), (4, "b", 0)):
        try:
            router.submit(P.Request(uid=uid, prompt=prompts[uid], max_new_tokens=3, priority=prio, tenant=tenant))
        except P.Rejected as e:
            obs.note("rejected", e.uid, e.reason)
    obs.note("brownout", router.brownout, {u: router.owner_of(u) for u in range(5)},
             {u: req.deadline_s for u, req in sorted(router._requests.items())})
    router.set_brownout(False)
    try:
        router.submit(P.Request(uid=5, prompt=prompts[5], max_new_tokens=3, priority=2, tenant="b"))
    except P.Rejected as e:
        obs.note("rejected", e.uid, e.reason)
    obs.step(0.0)
    _steps_until_idle(obs, now=100.0)
    return obs.finish()


def case_exempt_requeue(P, eng):
    """A failover/drain requeue sits outside the queue bound: the sweep
    neither sheds it nor lets it displace an accepted arrival."""
    prompts = _prompts([5, 11, 9], seed=8)
    extra = {"ledger": {"enabled": False}} if P is JAX else {}
    srv = P.ServingEngine(eng, n_slots=1, max_seq_len=64, config={"max_queue_len": 2, **extra})
    srv.submit(P.Request(uid=0, prompt=prompts[0], max_new_tokens=2))
    srv.submit(P.Request(uid=1, prompt=prompts[1], max_new_tokens=2))
    srv.requeue(P.Request(uid=2, prompt=prompts[2], max_new_tokens=2))
    first = srv.step(now=0.0)
    res = srv.drain()
    return {"first": first, "results": {u: (r.status, [int(t) for t in r.tokens]) for u, r in res.items()}}


def case_prefix_affinity(P, eng):
    rng = np.random.default_rng(30)
    shared = rng.integers(0, 97, size=24).astype(np.int32)
    filler = rng.integers(0, 97, size=9).astype(np.int32)
    router = _router(P, eng, **FEATURES)
    obs = _Obs(router, range(3))
    router.submit(P.Request(uid=0, prompt=filler, max_new_tokens=2))
    router.submit(P.Request(uid=1, prompt=np.concatenate([shared, filler[:5]]), max_new_tokens=2))
    obs.note("owners", router.owner_of(0), router.owner_of(1))
    _steps_until_idle(obs, now=float("inf"))
    router.submit(P.Request(uid=2, prompt=np.concatenate([shared, filler[:7]]), max_new_tokens=2))
    obs.note("owner_2", router.owner_of(2),
             [r.engine.prefix_match_len(np.concatenate([shared, filler[:7]])) for r in router._replicas])
    _steps_until_idle(obs, now=float("inf"))
    out = obs.finish()
    out["hits"] = [r.engine.prefix_cache_stats()["hits"] for r in router._replicas]
    return out


def case_hang_probation(P, eng):
    prompts = _prompts([5, 11])
    router = _router(P, eng, timeout=5.0, fi={"replica_hang_at": [[0, 2]]},
                     health={"max_attempts": 3, "base_delay_s": 1.0, "jitter": 0.0})
    obs = _Obs(router, [0, 1, 50])
    _submit_all(P, router, prompts, 8)
    for now in (0.0, 0.0, 0.5, 1.5):
        obs.step(now)
    _steps_until_idle(obs, now=1.5)
    router.submit(P.Request(uid=50, prompt=prompts[0], max_new_tokens=2))
    obs.note("owner_50", router.owner_of(50))
    _steps_until_idle(obs, now=1.5)
    return obs.finish()


def case_hang_escalates(P, eng):
    (p,) = _prompts([5])
    router = _router(P, eng, timeout=5.0, fi={"replica_hang_at": [[0, 1]]}, health={"max_attempts": 1})
    obs = _Obs(router, [0])
    _submit_all(P, router, [p], 8)
    _steps_until_idle(obs)
    return obs.finish()


def case_second_failure(P, eng):
    (p,) = _prompts([5])
    router = _router(P, eng, replicas=3, fi={"replica_dead_at": [[0, 2], [1, 4]]})
    obs = _Obs(router, [0])
    _submit_all(P, router, [p], 8)
    _steps_until_idle(obs)
    return obs.finish()


def case_compiling_step_exempt(P, eng):
    """With a 1 ns timeout only the compile exemption keeps the replicas
    healthy through their first steps: fresh engines, first calls."""
    p = _prompts([5, 11], seed=13)
    router = _router(P, eng, timeout=1e-9, health={"max_attempts": 3, "base_delay_s": 1.0, "jitter": 0.0})
    obs = _Obs(router, [0, 1])
    _submit_all(P, router, p, 4)
    obs.step()
    obs.note("compiled", [r.engine.last_step_compiled for r in router._replicas])
    router.health.timeout = 30.0
    _steps_until_idle(obs)
    return obs.finish()


def case_cancel_and_duplicate_uid(P, eng):
    prompts = _prompts([5, 11], seed=12)
    router = _router(P, eng)
    obs = _Obs(router, [0])
    _submit_all(P, router, prompts[:1], 8)
    try:
        router.submit(P.Request(uid=0, prompt=prompts[1], max_new_tokens=2))
    except ValueError as e:
        obs.note("duplicate", "unique per router" in str(e))
    obs.note("cancel", router.cancel(0), router.cancel(0), router.cancel(99))
    obs.step()
    # a drain never migrates onto a replica that already held the uid
    router = _router(P, eng)
    obs2 = _Obs(router, [0])
    _submit_all(P, router, prompts[:1], 2)
    router._seen[0].add(1)
    router.drain_replica(0, block=False)
    _steps_until_idle(obs2)
    # hung while draining: dead, never re-admitted
    router = _router(P, eng, timeout=5.0, fi={"replica_hang_at": [[0, 2]]}, health={"max_attempts": 3})
    obs3 = _Obs(router, [0])
    _submit_all(P, router, prompts[:1], 8)
    obs3.step()
    router._replicas[0].state = "draining"
    _steps_until_idle(obs3)
    return {"a": obs.finish(), "b": obs2.finish(), "c": obs3.finish()}


class _NoWallClock:
    def __getattr__(self, name):
        return getattr(_time, name)

    @staticmethod
    def time():
        raise AssertionError("time.time() consulted in a router verdict path")


def case_verdict_clocks(P, eng):
    prompts = _prompts([5, 11], seed=19)
    router = _router(P, eng, timeout=5.0, fi={"replica_hang_at": [[0, 2]]},
                     health={"max_attempts": 3, "base_delay_s": 1.0, "jitter": 0.0})
    mp = pytest.MonkeyPatch()
    mp.setattr(P.module, "time", _NoWallClock())
    try:
        obs = _Obs(router, [0, 1])
        _submit_all(P, router, prompts, 4)
        for now in (0.0, 0.0, 1.5):
            obs.step(now)
        _steps_until_idle(obs, now=1.5)
    finally:
        mp.undo()
    return obs.finish()


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_router_matches_jax(engines, case):
    fn = CASES[case]
    jout = fn(JAX, engines["jax"])
    tout = fn(TORCH, engines["torch"])
    assert tout == jout
    if case == "failover_mid_decode":
        teng = engines["torch"]
        prompts = _prompts([5, 11, 23])
        for i, p in enumerate(prompts):  # bitwise the solo generate
            assert tout["results"][i] == ("ok", [int(t) for t in teng.generate(p[None], max_new_tokens=8)[0]])
        assert tout["counters"]["router/failovers"] >= 1 and tout["stats"]["failovers_recovered"] >= 1
        assert tout["decode_programs"] == [1]
    elif case == "failover_mid_prefill":
        assert tout["inserts"][0] == 0 and tout["inserts"][1] >= 1
    elif case == "speculation_failover":
        assert tout["stats"]["speculation"]["drafted"] > 0
    elif case == "second_failure":
        assert tout["results"][0][0] == "failed_replica"
    elif case == "global_shed":
        assert ("rejected", 2, "queue_full") in tout["log"]
    elif case == "brownout_shed":
        assert ("rejected", 4, "overloaded") in tout["log"] and ("rejected", 5, "queue_full") in tout["log"]
        assert tout["results"][1][0] == "shed_brownout"
        assert tout["counters"]["router/autoscale/brownout_shed"] == 1
        assert tout["counters"]["router/autoscale/brownout_deadlines"] >= 1
    elif case == "hang_probation":
        assert tout["counters"]["router/readmissions"] == 1
    elif case == "compiling_step_exempt":
        assert ("compiled", [True, True]) in tout["log"]
    elif case == "prefix_affinity":
        assert tout["hits"][1] >= 1 and tout["counters"]["router/affinity_hits"] >= 1


def test_router_config_schema_matches_jax():
    """Fields, defaults and validation messages of every fleet block equal
    the JAX package's; the unported blocks parse and refuse by name."""
    import dataclasses

    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING else repr(f.default_factory()))
                for f in dataclasses.fields(cls)}

    for cls in ("RouterHealthConfig", "JournalConfig", "RouterTransportConfig", "AutoscaleConfig",
                "DisaggConfig", "GatewayAuthConfig", "GatewayConfig", "RouterConfig", "FaultInjectionConfig"):
        assert fields(getattr(tconfig, cls)) == fields(getattr(jconfig, cls)), cls
    for cls, kw in (("RouterConfig", {"replicas": 0}), ("RouterConfig", {"max_queue_len": -1}),
                    ("RouterHealthConfig", {"jitter": 2.0}), ("JournalConfig", {"enabled": True}),
                    ("RouterTransportConfig", {"family": "udp"}), ("AutoscaleConfig", {"scale_down_load": 9.0}),
                    ("DisaggConfig", {"handoff_chunk": 12}), ("GatewayConfig", {"port": 70000}),
                    ("FaultInjectionConfig", {"replica_dead_at": [[0]]}),
                    ("FaultInjectionConfig", {"router_crash_at": [0]})):
        with pytest.raises(jconfig.DeepSpeedConfigError) as je:
            getattr(jconfig, cls)(**kw)
        with pytest.raises(tconfig.DeepSpeedConfigError) as te:
            getattr(tconfig, cls)(**kw)
        assert str(te.value) == str(je.value), cls
    rc = tconfig.RouterConfig(replicas=3, health={"timeout": 2.5}, journal={"enabled": True, "path": "j"})
    assert (rc.replicas, rc.health.timeout, rc.journal.path) == (3, 2.5, "j")


@pytest.mark.parametrize("block,match", [
    ({"router": {"disagg": {"enabled": True}}}, "disagg"),
    ({"router": {"autoscale": {"enabled": True, "scale_up_mfu": 0.5}}}, "scale_up_mfu"),
    ({"timeseries": {"enabled": True}}, "timeseries"),
    ({"slo": {"enabled": True}}, "slo"),
    ({"incidents": {"enabled": True}}, "incidents"),
])
def test_unported_fleet_blocks_are_refused(engines, block, match):
    with pytest.raises(NotImplementedError, match=match):
        Router(engines["torch"], config={"n_slots": 2, **block})
