"""Port parity: the Router's rolling upgrade (``Router.rolling_upgrade``,
``_RollingUpgrade``) and ``WorkerSupervisor.set_spec``.

The cases of ``tests/test_http_gateway.py``'s rolling-upgrade section run
once per package over the same host-only fakes behind a real Router: the
waves (outcome, phase, old and new rid, canary status), the state and
reason, the slot ledgers, the replica states and the ``router/*`` counters
must be equal. Their newcomers boot on background threads, so the times in
a wave are left out there. In process, over real fp32 engines at
``tests/simple_model.py`` shapes with the same weights and a fixed clock,
``upgrade_status()`` must equal JAX's wave by wave, times included, with
the per-step terminal uids and every request's tokens: a canary pass under
live traffic, newcomers that die, hang or fail their canary, and autoscale
paused while the upgrade runs. One ``--device cpu`` worker is upgraded
through ``set_spec``.
"""

import itertools
import json
import os
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import Autoscaler as JaxAutoscaler
from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference import router as jrouter_mod
from deepspeed_tpu.launcher.serving_worker import WorkerSupervisor as JaxSupervisor
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Autoscaler, Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import router as trouter_mod
from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.telemetry.request_trace import RESERVED_UID_BASE
from simple_model import tiny_transformer

REPO = Path(__file__).resolve().parents[1]
SHAPES = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
MODEL = dict(SHAPES, decode_attn="xla", pos_emb="rotary")

JAX = types.SimpleNamespace(Router=JaxRouter, Autoscaler=JaxAutoscaler, Request=JaxRequest,
                            ServingEngine=JaxServingEngine, name="jax")
TORCH = types.SimpleNamespace(Router=Router, Autoscaler=Autoscaler, Request=Request,
                              ServingEngine=ServingEngine, name="torch")


class _FakeResult:
    def __init__(self, uid, status="ok"):
        self.uid, self.status, self.tokens = uid, status, [1, 2]

    @property
    def ok(self):
        return self.status == "ok"


class _FakeEngine:
    """Host-only scheduler surface; ``serves=False`` steps clean but never
    finishes a request (the hole the canary closes)."""

    def __init__(self, rid=0, compiled=False, serves=True):
        self.replica_id = rid
        self.queued, self._aged, self.results = [], [], {}
        self.last_step_compiled = compiled
        self.fail_next_step = False
        self.serves = serves
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)
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
        n = len(self.queued) + len(self._aged)
        self.queued = [r for r in self.queued if r.uid != uid]
        self._aged = [r for r in self._aged if r.uid != uid]
        if len(self.queued) + len(self._aged) == n:
            return False
        self.results[uid] = _FakeResult(uid, status="cancelled")
        return True

    def result(self, uid):
        return self.results.get(uid)

    def partial_tokens(self, uid):
        return np.zeros((0,), np.int32)

    def step(self, now=None, enforce_deadlines=True):
        if self.fail_next_step:
            self.fail_next_step = False
            raise OSError("fake worker gone")
        if not self.serves:
            return []
        done = [r.uid for r in self._aged]
        for r in self._aged:
            self.results[r.uid] = _FakeResult(r.uid)
        self._aged, self.queued = list(self.queued), []
        return done

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
    def __init__(self, fail_slots=(), compiled_slots=(), make=None):
        self.fail_slots, self.compiled_slots = set(fail_slots), set(compiled_slots)
        self.make = make
        self.spawned, self.retired, self.spec = [], [], None

    def set_spec(self, spec):
        self.spec = spec

    def poll(self):
        return []

    def spawn(self, slot):
        if slot in self.fail_slots:
            raise RuntimeError(f"boot of slot {slot} failed")
        e = self.make(slot) if self.make else _FakeEngine(200 + slot, compiled=slot in self.compiled_slots)
        self.spawned.append((slot, e))
        return e

    def retire(self, slot):
        self.retired.append(slot)


def _await(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


def _drive(router, n=50, dt=0.25, t0=10.0):
    for k in range(n):
        router.step(now=t0 + k * dt)
        st = router.upgrade_status()
        if st is not None and st["state"] != "running":
            for j in range(4):
                router.step(now=t0 + (n + j) * dt)
            return st
        time.sleep(0.005)  # background boot threads need real time
    return router.upgrade_status()


def _norm(status, timed=True):
    """``upgrade_status()`` with each canary uid as its offset-free band
    check (each package numbers its canaries from its own counter) and,
    for background boots, without the wave times."""
    def wave(w):
        w = dict(w)
        if "canary_uid" in w:
            w["canary_uid"] = w["canary_uid"] >= RESERVED_UID_BASE
        if not timed:
            w.pop("started", None)
            w.pop("gate_start", None)
        return w
    out = dict(status)
    out["waves"] = [wave(w) for w in status["waves"]]
    out["current"] = wave(status["current"]) if status["current"] else None
    return out


def _fleet(P, n):
    return P.Router(replica_engines=[_FakeEngine(i) for i in range(n)],
                    config={"router": {"health": {"timeout": 0}}})


def _seen(router, st, sup, **extra):
    counters = router.telemetry.registry.snapshot()["counters"]
    return {"status": _norm(st, timed=False), "states": router.replica_states(),
            "counters": {k: v for k, v in counters.items() if k.startswith("router/")},
            "spawned": [s for s, _ in sup.spawned], **extra}


# -- fakes behind a real Router: each case returns one package's view --------

def case_replaces_every_generation(P):
    router = _fleet(P, 2)
    sup = _FakeSupervisor()
    router.rolling_upgrade(supervisor=sup, slots={0: 0, 1: 1}, spec={"generation": 2})
    assert sup.spec == {"generation": 2}
    st = _drive(router)
    assert st["state"] == "done" and [w["outcome"] for w in st["waves"]] == ["upgraded", "upgraded"]
    assert router.replica_states() == {0: "drained", 1: "drained", 2: "healthy", 3: "healthy"}
    _await(lambda: sorted(sup.retired) == [0, 1])
    return _seen(router, st, sup, retired=sorted(sup.retired))


def case_syncs_the_autoscaler_slot_ledger(P):
    router = _fleet(P, 2)
    sup = _FakeSupervisor()
    asc = P.Autoscaler(router, {"enabled": True, "min_replicas": 1, "max_replicas": 4},
                       supervisor=sup, slots={0: 0, 1: 1})
    router.rolling_upgrade(supervisor=sup, slots=dict(asc._slots))
    st = _drive(router)
    assert st["state"] == "done" and asc._slots == {2: 2, 3: 3} and asc._slot_seq >= 4
    # autoscale evaluation paused while the upgrade ran: no decision event
    return _seen(router, st, sup, asc_slots=asc._slots, events=[e["kind"] for e in asc.events])


def case_aborts_on_boot_failure(P):
    router = _fleet(P, 2)
    sup = _FakeSupervisor(fail_slots={2})
    router.rolling_upgrade(supervisor=sup, slots={0: 0, 1: 1})
    st = _drive(router)
    assert st["state"] == "aborted" and "boot failed" in st["reason"]
    assert router.replica_states() == {0: "healthy", 1: "healthy"}
    return _seen(router, st, sup)


def case_aborts_when_newcomer_dies(P):
    router = _fleet(P, 2)

    def dying(slot):
        e = _FakeEngine(200 + slot)
        e.fail_next_step = True
        return e

    sup = _FakeSupervisor(make=dying)
    router.rolling_upgrade(supervisor=sup, slots={0: 0, 1: 1})
    st = _drive(router)
    assert st["state"] == "aborted" and "died" in st["reason"]
    _await(lambda: sup.retired == [2])
    return _seen(router, st, sup)


def case_gate_times_out_on_compiling_newcomer(P):
    router = _fleet(P, 1)
    sup = _FakeSupervisor(compiled_slots={1})
    router.rolling_upgrade(supervisor=sup, slots={0: 0}, gate_timeout_s=2.0)
    st = _drive(router, n=60)
    assert st["state"] == "aborted" and "non-compiling" in st["reason"]
    assert router.replica_states()[1] in ("drained", "dead")
    _await(lambda: sup.retired == [1])
    return _seen(router, st, sup)


def case_canary_closes_the_idle_step_gate(P):
    st = {}
    for canary in (True, False):
        router = _fleet(P, 1)
        sup = _FakeSupervisor(make=lambda slot: _FakeEngine(200 + slot, serves=False))
        router.rolling_upgrade(supervisor=sup, slots={0: 0}, gate_timeout_s=2.0, canary=canary)
        st[canary] = _seen(router, _drive(router, n=60), sup)
    assert st[True]["status"]["state"] == "aborted" and "canary" in st[True]["status"]["reason"]
    assert st[False]["status"]["state"] == "done"
    return st


def case_canary_uid_band_is_reserved(P):
    router = _fleet(P, 1)
    sup = _FakeSupervisor()
    router.rolling_upgrade(supervisor=sup, slots={0: 0})
    st = _drive(router)
    (_, newcomer), = sup.spawned
    assert [u for u in newcomer.results if u >= RESERVED_UID_BASE]
    assert all(u < RESERVED_UID_BASE for u in router.results)
    assert st["waves"][0].get("canary_status") == "ok"
    return _seen(router, st, sup)


def case_canary_rides_a_long_lived_fleet_clock(P):
    router = _fleet(P, 1)
    sup = _FakeSupervisor(make=lambda slot: _FakeEngine(300 + slot))
    router.rolling_upgrade(supervisor=sup, slots={0: 0}, gate_timeout_s=5.0)
    st = _drive(router, t0=10_000.0)
    (_, newcomer), = sup.spawned
    (canary,) = newcomer.submitted
    assert canary.arrival_time >= 10_000.0 and canary.arrival_time + canary.deadline_s > 10_000.0
    return _seen(router, st, sup, canary=(int(canary.max_new_tokens), float(canary.deadline_s),
                                          [int(t) for t in canary.prompt]))


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rolling_upgrade_matches_jax(case):
    assert CASES[case](TORCH) == CASES[case](JAX)


# -- in process, real engines, fixed clock -------------------------------------

@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _inprocess(P, eng, fi=None, autoscale=None, health=None, serving=None, upgrade_at=2, dt=0.25, **upgrade):
    """Two in-process replicas serving 6 greedy requests (arrived at 0);
    the upgrade starts before router step ``upgrade_at``; every step's
    terminal uids and the upgrade's status are observed."""
    router = {"replicas": 2, "health": {"timeout": 30.0, **(health or {})}}
    if autoscale is not None:
        router["autoscale"] = autoscale
    cfg = {"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise", "router": router, **(serving or {})}
    if P is JAX:
        cfg["ledger"] = {"enabled": False}
    if fi is not None:
        cfg["fault_injection"] = {"enabled": True, "seed": 0, **fi}
    r = P.Router(eng, config=cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, size=s).astype(np.int32) for s in (5, 11, 23, 7, 17, 3)]
    for i, p in enumerate(prompts):
        r.submit(P.Request(uid=i, prompt=p, max_new_tokens=8))
    log = []
    for k in range(80):
        if k == upgrade_at:
            r.rolling_upgrade(**upgrade)
        term = r.step(now=10.0 + k * dt)
        st = r.upgrade_status()
        log.append((term, r.replica_states(), st and _norm(st)))
        if st is not None and st["state"] != "running" and not r._owner and not any(
                s == "draining" for s in r.replica_states().values()):
            break
    counters = r.telemetry.registry.snapshot()["counters"]
    res = {u: (x.status, [int(t) for t in x.tokens]) for u, x in r.results.items()}
    return {"log": log, "results": res, "status": _norm(r.upgrade_status()),
            "counters": {k: v for k, v in counters.items() if k.startswith("router/")},
            "events": [(e["kind"], e["t"]) for e in r._autoscaler.events] if r._autoscaler else None}, r


@pytest.mark.parametrize("label,kw", [
    ("canary_pass", {}),
    # the newcomer (rid 2) attaches at router step 4 and steps from 5
    ("newcomer_dies", {"fi": {"replica_dead_at": [[2, 5]]}}),
    ("newcomer_hangs", {"fi": {"replica_hang_at": [[2, 5]]}, "gate_timeout_s": 2.0,
                        "health": {"base_delay_s": 30.0, "max_delay_s": 30.0, "jitter": 0.0}}),
    # the first canary's prefill turns out NaN and is not replayed
    ("canary_fails", {"fi": {"garbage_logits_uids": [RESERVED_UID_BASE], "garbage_logits_phase": "prefill"},
                      "serving": {"quarantine_max_requeues": 0}}),
    ("autoscale_paused", {"autoscale": {"enabled": True, "min_replicas": 1, "max_replicas": 3,
                                        "scale_up_queue": 1, "scale_up_load": 1.0, "scale_down_load": 0.5,
                                        "up_consecutive": 1, "down_consecutive": 1, "cooldown_s": 0.0}}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_inprocess_upgrade_matches_jax(engines, label, kw, monkeypatch):
    # each package numbers its canaries from 0 here, so the fault above
    # selects the first one in both
    monkeypatch.setattr(trouter_mod, "_canary_uids", itertools.count())
    tout, trouter = _inprocess(TORCH, engines["torch"], **kw)
    monkeypatch.setattr(jrouter_mod, "_canary_uids", itertools.count())
    jout, _ = _inprocess(JAX, engines["jax"], **kw)
    assert tout == jout
    st = tout["status"]
    # no accepted request is lost, whatever the waves did
    assert sorted(tout["results"]) == list(range(6)) and all(s == "ok" for s, _ in tout["results"].values())
    if label in ("canary_pass", "autoscale_paused"):
        waves = st["waves"]
        assert st["state"] == "done" and len(waves) >= 2 and all(w["outcome"] == "upgraded" for w in waves)
        assert all(w["canary_status"] == "ok" and w["canary_uid"] for w in waves)
        # the retired old generation freed its slot cache and prefix pool
        for w in waves:
            assert trouter._replicas[w["old_rid"]].engine.worker._cache is None
    else:
        assert st["state"] == "aborted"
        assert {"newcomer_dies": "died", "newcomer_hangs": "never passed",
                "canary_fails": "failed its canary"}[label] in st["reason"]
        assert trouter.replica_states()[0] == "healthy"
    if label == "autoscale_paused":
        # the autoscaler grew the fleet before the upgrade, then made no
        # decision while it ran (router steps 3 .. the one that ended it)
        done_at = next(k for k, (_, _, s) in enumerate(tout["log"]) if s and s["state"] != "running")
        assert tout["events"] and not [t for _, t in tout["events"] if 10.5 <= t < 10.0 + done_at * 0.25]


# -- WorkerSupervisor.set_spec --------------------------------------------------

def test_set_spec_is_durable_like_jax(tmp_path):
    """``set_spec`` swaps the spec later spawns boot, written tmp + fsync +
    rename (JAX's test_supervisor_set_spec_is_durable); the port keeps each
    generation's file, so an old worker's respawn boots its own."""
    specs = {}
    for name, cls in (("jax", JaxSupervisor), ("torch", WorkerSupervisor)):
        sup = cls({"model": {"a": 1}}, 0, workdir=str(tmp_path / name))
        first = sup.spec_path
        sup.set_spec({"model": {"a": 2}, "generation": 2})
        with open(sup.spec_path) as f:
            specs[name] = json.load(f)
        if name == "torch":
            with open(first) as f:
                assert json.load(f) == {"model": {"a": 1}}
            assert sup.spec_path != first
            assert not [p for p in os.listdir(tmp_path / name) if p.endswith(".tmp")]
    assert specs["torch"] == specs["jax"] == {"model": {"a": 2}, "generation": 2}


def test_worker_rolling_upgrade_through_set_spec(tmp_path):
    """One ``--device cpu`` worker upgraded through ``set_spec``: the
    newcomer boots the new spec file, passes its canary, the old worker drains and is retired with exit 0, and a
    request after the upgrade is served by the new generation."""
    model = {**SHAPES, "dtype": "float32"}
    spec = {"model": model, "engine_dtype": "fp32", "serving": {"n_slots": 2, "max_seq_len": 64}}
    sup = WorkerSupervisor(spec, 1, workdir=str(tmp_path / "wd"), device="cpu",
                           transport={"call_timeout_s": 60.0, "boot_timeout_s": 120.0},
                           env={"PYTHONPATH": str(REPO)})
    try:
        router = Router(config={"router": {"replicas": 1, "health": {"timeout": 60.0}}}, replica_engines=sup.start())
        router.submit(Request(uid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new_tokens=4))
        old_spec = sup.spec_path
        router.rolling_upgrade(supervisor=sup, slots={0: 0}, spec={**spec, "generation": 2}, gate_timeout_s=60.0)
        deadline = time.monotonic() + 120
        while router.upgrade_status()["state"] == "running" or router._owner:
            assert time.monotonic() < deadline, router.upgrade_status()
            router.step()
            time.sleep(0.01)
        st = router.upgrade_status()
        assert st["state"] == "done" and st["waves"][0]["outcome"] == "upgraded", st
        assert router.replica_states() == {0: "drained", 1: "healthy"} and st["slots"] == {1: 1}
        assert sup._slot_spec[1] == sup.spec_path != old_spec
        with open(sup.spec_path) as f:
            assert json.load(f)["generation"] == 2
        _await(lambda: 0 not in sup._procs, timeout=60.0)
        assert router.result(0).ok
        uid = router.submit(Request(uid=1, prompt=np.arange(1, 8, dtype=np.int32), max_new_tokens=4))
        assert router.owner_of(uid) == 1
        assert router.drain()[1].ok
    finally:
        sup.shutdown()


def test_respawn_keeps_the_slot_spec_generation(tmp_path, monkeypatch):
    """After ``set_spec`` a crash-respawn of an old slot boots the spec that
    slot booted from; a fresh slot boots the new one."""
    sup = WorkerSupervisor({"g": 1}, 1, workdir=str(tmp_path / "wd"), device="cpu",
                           respawn_backoff={"max_attempts": 5, "base_delay_s": 0.0, "max_delay_s": 0.0,
                                            "jitter": 0.0})
    booted = []

    def spawn(self, slot, spec_path=None):  # records what a boot would read
        path = spec_path or self.spec_path
        self._slot_spec[slot] = path
        booted.append((slot, json.loads(Path(path).read_text())["g"]))

    monkeypatch.setattr(WorkerSupervisor, "spawn", spawn)
    sup.spawn(0)
    sup.set_spec({"g": 2})
    sup.respawn(0)
    sup.spawn(1)
    assert booted == [(0, 1), (0, 1), (1, 2)]
