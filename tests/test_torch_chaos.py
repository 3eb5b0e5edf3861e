"""Port parity: the chaos conductor (``deepspeed_tpu_torch/resilience/chaos.py``)
against the JAX package's.

Schedules are JAX's byte for byte (``generate`` over seeds 0-31, the JSON
round trip, ``to_injector_config``); a fake-fleet run of each of seeds 0-15
gives JAX's outcome digest, tripped set, fired counts and
``chaos/site/*`` / ``router/*`` counters; ``shrink_schedule`` under a
planted oracle gives JAX's minimal schedule, ``write_repro`` JAX's bytes,
``search`` JAX's summary and artifacts, and ``replay_repro`` reproduces
bit-identically. One real-engine schedule (``replica_dead`` at step 2) over
fp32 tiny port ``ServingEngine`` replicas with the JAX model's weights
gives the JAX run's results and digest. The CLI (``python -m
deepspeed_tpu_torch.resilience.chaos``) prints ``bench.py``'s chaos rows
less their ``_drill_stamp`` keys and exits as they do: 0 only when every
schedule is green, or on replay when the digest and the tripped set match.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.resilience.faults import FaultInjector as JaxInjector
from deepspeed_tpu.resilience.invariants import Violation as JaxViolation
from deepspeed_tpu_torch import resilience as tres
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience.faults import FaultInjector
from deepspeed_tpu_torch.resilience.invariants import Violation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small workload, fast schedules, still every fake site
WL = dict(tchaos.DEFAULT_WORKLOAD, n_requests=5, n_replicas=2, max_new_tokens=4)
ALL_SITES_WL = dict(tchaos.DEFAULT_WORKLOAD, sites=list(FaultInjector.SITES))


def test_constants_and_exports_equal_jax():
    assert tchaos.DEFAULT_WORKLOAD == jchaos.DEFAULT_WORKLOAD
    assert tchaos.FAKE_SITES == jchaos.FAKE_SITES
    assert FaultInjector.SITES == JaxInjector.SITES
    assert sorted(tchaos.__all__) == sorted(jchaos.__all__)
    for name in tchaos.__all__:
        assert getattr(tres, name) is getattr(tchaos, name)
    assert [tchaos.derive_seed(s, i) for s in range(4) for i in range(9)] == \
        [jchaos.derive_seed(s, i) for s in range(4) for i in range(9)]


@pytest.mark.parametrize("seed", range(32))
def test_generate_is_jax_byte_for_byte(seed):
    for wl in (None, WL, ALL_SITES_WL):
        for max_faults in (4, 7):
            got = tchaos.FaultSchedule.generate(seed, wl, max_faults=max_faults)
            want = jchaos.FaultSchedule.generate(seed, wl, max_faults=max_faults)
            assert got.to_json() == want.to_json()
            back = tchaos.FaultSchedule.from_json(got.to_json())
            assert back.to_json() == got.to_json() and back.as_dict() == got.as_dict()
            assert back.sites() == want.sites()
            sub = [0, len(got.entries) - 1]
            assert got.subset(sub).to_json() == want.subset(sub).to_json()


def _lowering(mod, sched_json):
    try:
        return mod.FaultSchedule.from_json(sched_json).to_injector_config(), None
    except ValueError as e:
        return None, str(e)


def test_to_injector_config_equals_jax():
    texts = [jchaos.FaultSchedule.generate(jchaos.derive_seed(2, i), ALL_SITES_WL, max_faults=6).to_json()
             for i in range(48)]
    hand = [
        [("replica_dead", 1, 3), ("io_error", 0, 2), ("garbage_logits", 4, 5), ("router_crash", 0, 6)],
        [("garbage_logits", 1, 2), ("garbage_logits", 2, 3)],
        [("no_such_site", 0, 1)],
        [("rpc_garbled_frame", "step", 2), ("gateway_stall", 3, 1), ("nan_grads", 0, 4), ("io_flaky", 0, 1)],
    ]
    texts += [json.dumps({"entries": [{"site": s, "key": k, "at": a} for s, k, a in h], "workload": WL})
              for h in hand]
    for text in texts:
        assert _lowering(tchaos, text) == _lowering(jchaos, text)
    cfg = tchaos.FaultSchedule.from_json(texts[-4]).to_injector_config()
    assert cfg["replica_dead_at"] == [[1, 3]] and cfg["garbage_logits_decode_step"] == 5
    FaultInjector(cfg)  # the port's injector takes every lowered key


def _counters(runner):
    return {k: v for k, v in runner.telemetry.registry.snapshot()["counters"].items()
            if k.startswith(("chaos/", "router/"))}


def _view(out):
    return {"digest": out.digest, "summary": out.summary(), "accepted": out.accepted, "rejected": out.rejected,
            "results": {u: (r.status, [int(t) for t in r.tokens]) for u, r in out.results.items()},
            "tripped": sorted({v.invariant for v in out.violations})}


@pytest.fixture(scope="module")
def runners():
    tr, jr = tchaos.ChaosRunner(), jchaos.ChaosRunner()
    return {"torch": (tr, tr.reference(WL)), "jax": (jr, jr.reference(WL))}


@pytest.mark.parametrize("seed", range(16))
def test_fake_fleet_run_equals_jax(seed):
    views, counters = {}, {}
    for name, mod in (("torch", tchaos), ("jax", jchaos)):
        runner = mod.ChaosRunner()
        ref = runner.reference(WL)
        out = runner.run(mod.FaultSchedule.generate(mod.derive_seed(seed, 0), WL), reference=ref)
        views[name], counters[name] = _view(out), _counters(runner)
    assert views["torch"] == views["jax"]
    assert counters["torch"] == counters["jax"]
    assert not views["torch"]["tripped"]  # every schedule green under the oracles


def test_clean_run_green_and_deterministic(runners):
    runner, ref = runners["torch"]
    sched = tchaos.FaultSchedule(entries=[], workload=WL)
    a, b = runner.run(sched, reference=ref), runner.run(sched, reference=ref)
    assert not a.violations and sorted(a.results) == a.accepted == list(range(1, 6))
    assert a.digest == b.digest


@pytest.mark.parametrize("entry,crashes", [(("router_crash", 0, 3), 1), (("io_error", 0, 3), 0)])
def test_control_plane_recovery_equals_jax(runners, entry, crashes):
    """router_crash recovers exactly once; an io_error on the journal's append
    clock fails closed, restarts the control plane over the durable prefix,
    and every request still reaches one terminal."""
    views = {}
    for name, mod in (("torch", tchaos), ("jax", jchaos)):
        runner, ref = runners[name]
        out = runner.run(mod.FaultSchedule(entries=[mod.FaultEntry(*entry)], workload=WL), reference=ref)
        assert out.crashes == crashes and out.restarts >= 1 and not out.violations
        assert out.fired[entry[0]] == 1
        views[name] = _view(out)
    assert views["torch"] == views["jax"]
    if entry[0] == "io_error":
        assert _counters(runners["torch"][0])["router/journal/append_failures"] >= 1


def _tripwire(violation_cls):
    def oracle(out):
        if out.fired.get("garbage_logits"):
            return [violation_cls("garbage_tripwire", f"garbage fired {out.fired['garbage_logits']}x")]
        return []
    return oracle


PLANTED = {"torch": (tchaos, _tripwire(Violation)), "jax": (jchaos, _tripwire(JaxViolation))}


@pytest.mark.parametrize("seed", range(6))
def test_shrink_and_repro_equal_jax(tmp_path, seed):
    files = {}
    for name, (mod, oracle) in PLANTED.items():
        runner = mod.ChaosRunner()
        ref = runner.reference(WL)
        sched = mod.FaultSchedule.generate(mod.derive_seed(seed, 0), WL)
        out = runner.run(sched, reference=ref, oracles=[oracle])
        want = {v.invariant for v in out.violations}

        def still_fails(cand, runner=runner, ref=ref, oracle=oracle, want=want):
            got = runner.run(cand, reference=ref, oracles=[oracle])
            return bool(want) and want <= {v.invariant for v in got.violations}

        mini = mod.shrink_schedule(sched, still_fails) if want else sched
        final = runner.run(mini, reference=ref, oracles=[oracle])
        path = tmp_path / f"{name}.json"
        mod.write_repro(str(path), mini, final, search_seed=seed, index=0)
        files[name] = path.read_bytes()
        if want:
            assert still_fails(mini)
            for i in range(len(mini.entries)):  # minimal: no single entry can go
                assert not still_fails(mini.subset(j for j in range(len(mini.entries)) if j != i))
    assert files["torch"] == files["jax"]


def test_search_with_a_planted_oracle_equals_jax(tmp_path):
    rows, arts = {}, {}
    for name, (mod, oracle) in PLANTED.items():
        art = tmp_path / name
        row = mod.search(mod.ChaosRunner(), 10, 0, workload=WL, artifact_dir=str(art), oracles=[oracle])
        arts[name] = {p: (art / p).read_bytes() for p in sorted(os.listdir(art))}
        for v in row["violations"]:
            v["repro"] = os.path.basename(v["repro"])
        rows[name] = row
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]["violations"], "the planted oracle must trip in 10 schedules"
    assert arts["torch"] == arts["jax"]


def test_replay_repro_is_bit_identical(tmp_path):
    oracle = PLANTED["torch"][1]
    runner = tchaos.ChaosRunner()
    ref = runner.reference(WL)
    sched = tchaos.FaultSchedule.generate(tchaos.derive_seed(1, 4), WL)
    out = runner.run(sched, reference=ref, oracles=[oracle])
    path = tmp_path / "repro.json"
    tchaos.write_repro(str(path), sched, out, search_seed=1, index=4)
    repro = json.loads(path.read_text())
    got = tchaos.replay_repro(tchaos.ChaosRunner(), repro, oracles=[oracle])
    assert got["digest_match"] and got["violations_match"] and got["digest"] == out.digest
    want = jchaos.replay_repro(jchaos.ChaosRunner(), repro, oracles=[PLANTED["jax"][1]])
    assert (want["digest"], want["tripped"]) == (got["digest"], got["tripped"])
    repro["digest"] = "0" * 64
    assert not tchaos.replay_repro(tchaos.ChaosRunner(), repro, oracles=[oracle])["digest_match"]


# -- real engines ----------------------------------------------------------------


def test_real_engine_schedule_equals_jax(tiny_serving_engine):
    """replica_dead at router step 2 over 2 fp32 tiny ServingEngine replicas
    in each package, the port's with the JAX model's weights."""
    from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
    from deepspeed_tpu_torch import init_inference, interop
    from deepspeed_tpu_torch.inference import ServingEngine
    from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig

    c = tiny_serving_engine.model.config
    params = interop.params_from_jax(jax.tree.map(np.asarray, tiny_serving_engine.params))
    teng = init_inference(Model(TransformerConfig(
        vocab_size=c.vocab_size, max_seq_len=c.max_seq_len, num_layers=c.num_layers, num_heads=c.num_heads,
        hidden_size=c.hidden_size, dtype=torch.float32, decode_attn="xla", pos_emb="rotary")),
        config={"dtype": "fp32"}, params=params, device="cpu")
    built = []

    def factory(cls, eng):
        def engines(wl, fi):
            reps = [cls(eng, n_slots=2, max_seq_len=128, config={"replica_id": f"r{i}"})
                    for i in range(int(wl["n_replicas"]))]
            built.extend(reps)
            return reps
        return engines

    wl = dict(WL, n_requests=3, n_replicas=2, max_new_tokens=3)
    views = {}
    for name, mod, cls, eng in (("torch", tchaos, ServingEngine, teng),
                                ("jax", jchaos, JaxServingEngine, tiny_serving_engine)):
        runner = mod.ChaosRunner(engines=factory(cls, eng))
        sched = mod.FaultSchedule(entries=[mod.FaultEntry("replica_dead", key=0, at=2)], workload=wl)
        out = runner.run(sched)
        assert not out.violations, [str(v) for v in out.violations]
        assert out.fired["replica_dead"] == 1 and sorted(out.results) == [1, 2, 3]
        assert all(r.status == "ok" for r in out.results.values())
        views[name] = _view(out)
    assert views["torch"] == views["jax"]
    # the runner closed the port replicas it was given: no cache or graph outlives the run
    assert all(r.worker._cache is None for r in built if isinstance(r, ServingEngine))


def test_restart_over_a_closed_replica_declares_it_dead():
    """A replica declared dead is closed (its device state released); a
    journal outage then restarts the control plane over the same engines.
    The closed engine raises ``RpcConnectionLost`` from ``live_requests`` and
    ``step``, so the restarted Router reconciles nothing with it and declares
    it dead at its first step: every schedule stays green."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import ServingEngine
    from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
    from deepspeed_tpu_torch.resilience import RpcConnectionLost

    eng = init_inference(Model(TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4,
                                                 hidden_size=32, dtype=torch.float32)),
                         config={"dtype": "fp32"}, device="cpu")
    built = []

    def engines(wl, fi):
        reps = [ServingEngine(eng, config={"n_slots": int(wl["n_slots"]), "replica_id": i,
                                           **({"fault_injection": fi} if fi else {})})
                for i in range(int(wl["n_replicas"]))]
        built.append(reps)
        return reps

    runner = tchaos.ChaosRunner(engines=engines)
    ref = runner.reference()
    sched = tchaos.FaultSchedule(entries=[tchaos.FaultEntry("replica_dead", 1, 2), tchaos.FaultEntry("io_error", 0, 3),
                                          tchaos.FaultEntry("garbage_logits", 8, 2)])
    a, b = runner.run(sched, reference=ref), runner.run(sched, reference=ref)
    assert not a.violations and not b.violations, [str(v) for v in a.violations + b.violations]
    assert a.digest == b.digest and a.restarts >= 1 and a.fired["replica_dead"] == 1
    assert all(r.status == "ok" for r in a.results.values()) and len(a.results) == 8
    closed = built[-1][1]
    assert closed.closed
    with pytest.raises(RpcConnectionLost):
        closed.live_requests()
    with pytest.raises(RpcConnectionLost):
        closed.step(now=0.0)


# -- the command line -------------------------------------------------------------

def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.resilience.chaos", *args], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300)


def test_cli_search_and_replay(tmp_path, capsys):
    proc = _cli("--search", "6", "--seed", "1", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(row) == {"metric", "value", "unit", "schedules_run", "sites_covered", "site_fired", "violations",
                        "seed", "elapsed_s"}
    assert row["schedules_run"] == row["value"] == 6 and row["violations"] == [] and row["sites_covered"]
    want = jchaos.search(jchaos.ChaosRunner(), 6, 1, artifact_dir=str(tmp_path / "unused"))
    assert row["sites_covered"] == want["sites_covered"]

    runner = tchaos.ChaosRunner()
    sched = tchaos.FaultSchedule.generate(tchaos.derive_seed(1, 2), tchaos.DEFAULT_WORKLOAD)
    out = runner.run(sched, reference=runner.reference(sched.workload))
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    tchaos.write_repro(str(good), sched, out, search_seed=1, index=2)
    repro = json.loads(good.read_text())
    repro["violations"] = ["zero_accepted_loss"]
    bad.write_text(json.dumps(repro))
    capsys.readouterr()
    assert tchaos.main(["--replay", str(good)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"metric", "value", "unit", "repro", "digest", "digest_match", "tripped",
                        "violations_match", "elapsed_s"}
    assert row["digest"] == out.digest and row["digest_match"] and row["value"] == 1
    assert tchaos.main(["--replay", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["violations_match"] is False
    with pytest.raises(SystemExit) as usage:
        tchaos.main([])
    assert usage.value.code == 2
