"""Port parity: elastic training (``deepspeed_tpu_torch/elasticity``) against
the JAX package's.

``compute_elastic_config`` gives JAX's batch, worlds and micro-batch (or
raises JAX's class with JAX's message) over a grid of v0.1 / v0.2 configs
and world sizes. The agent runs JAX's drills (``tests/test_elastic_launcher.py``)
over ``python -c`` workers that import no torch: a clean exit, restarts,
exhaustion and the batch env run under both packages' agents with equal
exit codes and restart counts; membership change, hung worker, fresh
heartbeat file, torn hostfile, startup grace and the wall-clock-free
verdict run on the port's. Restart backoff sleeps JAX's deterministic
delays. ``python -m deepspeed_tpu_torch.elasticity`` prints what
``bin/dstpu_elastic`` prints and exits with its code.
"""

import importlib.machinery
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.elasticity import elastic_agent as jagent_mod
from deepspeed_tpu_torch import elasticity as tel
from deepspeed_tpu_torch.elasticity import __main__ as tcli
from deepspeed_tpu_torch.elasticity import elastic_agent as tagent_mod
from deepspeed_tpu_torch.resilience.heartbeat import HeartbeatJudge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jel, "torch": tel}

ELASTIC_CFG = {
    "elasticity": {
        "enabled": True,
        "max_train_batch_size": 64,
        "micro_batch_sizes": [1, 2, 4],
        "min_gpus": 1,
        "max_gpus": 16,
        "min_time": 0,
        "version": 0.1,
    }
}
# restart pacing is a real sleep: zero it in the drills (the delays have their own test)
NO_BACKOFF = {"base_delay_s": 0.0, "max_delay_s": 0.0, "jitter": 0.0}


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw), None
    except Exception as e:  # noqa: BLE001 -- the class and message are what is compared
        return None, (type(e).__name__, str(e))


ALGEBRA = [
    {"micro_batch_sizes": [1, 2, 4], "max_train_batch_size": 64, "min_gpus": 1, "max_gpus": 16},
    {"micro_batch_sizes": [8, 16], "max_train_batch_size": 64, "max_gpus": 32},
    {"micro_batch_sizes": [2, 4, 6], "max_train_batch_size": 600, "max_gpus": 48},
    {"micro_batch_sizes": [3, 5], "max_train_batch_size": 120, "min_gpus": 2, "max_gpus": 12,
     "prefer_larger_batch": False},
    {"micro_batch_sizes": [64], "max_train_batch_size": 64},
    {"micro_batch_sizes": [4, 8], "max_train_batch_size": 256, "version": 0.2, "model_parallel_size": 2,
     "num_gpus_per_node": 4, "max_gpus": 32},
    {"micro_batch_sizes": [2, 4], "max_train_batch_size": 96, "version": 0.2, "model_parallel_size": 8,
     "num_gpus_per_node": 4, "max_gpus": 64},
    {"micro_batch_sizes": [1, 3], "max_train_batch_size": 48, "version": 0.2, "max_gpus": 32},
    {"micro_batch_sizes": [], "max_train_batch_size": 64},
    {"micro_batch_sizes": [128], "max_train_batch_size": 64},
    {"micro_batch_sizes": [7], "max_train_batch_size": 8, "min_gpus": 2, "max_gpus": 4},
]
WORLDS = [0, 1, 2, 3, 4, 7, 8, 12, 16, 24]


@pytest.mark.parametrize("case", range(len(ALGEBRA)))
def test_compute_elastic_config_equals_jax(case):
    block = {"enabled": True, **ALGEBRA[case]}
    for world in WORLDS:
        got = _outcome(tel.compute_elastic_config, {"elasticity": block}, world_size=world)
        want = _outcome(jel.compute_elastic_config, {"elasticity": block}, world_size=world)
        assert got == want, (world, got, want)
    assert tel.get_valid_gpus(64, [8, 16], 1, 16) == jel.get_valid_gpus(64, [8, 16], 1, 16)


def test_error_classes_keep_jax_hierarchy():
    for name in ("ElasticityConfigError", "ElasticityIncompatibleWorldSize"):
        assert issubclass(getattr(tel, name), tel.ElasticityError)
        assert getattr(tel, name).__mro__[1].__name__ == getattr(jel, name).__mro__[1].__name__


# -- the agent -----------------------------------------------------------------

def _agent(pkg, command, **kw):
    el = PACKAGES[pkg]
    kw.setdefault("static_world_size", 4)
    kw.setdefault("monitor_interval", 0.05)
    kw.setdefault("restart_backoff", NO_BACKOFF)
    return el.DSElasticAgent(kw.pop("cfg", ELASTIC_CFG), el.WorkerSpec(command=command), **kw)


_FAIL_TWICE = (
    "import pathlib, sys\n"
    "p = pathlib.Path({marker!r})\n"
    "n = int(p.read_text()) if p.exists() else 0\n"
    "p.write_text(str(n + 1))\n"
    "sys.exit(0 if n >= 2 else 1)\n"
)
_final, _valid, _micro = jel.compute_elastic_config(ELASTIC_CFG, world_size=12)
_BATCH_ENV = (
    "import os, sys\n"
    f"ok = (os.environ['DSTPU_ELASTIC_BATCH'] == '{_final}' and "
    f"os.environ['DSTPU_ELASTIC_MICRO_BATCH'] == '{_micro}' and os.environ['DSTPU_ELASTIC_WORLD_SIZE'] == '12' "
    "and os.environ['DSTPU_ELASTIC_GENERATION'] == '0')\n"
    "sys.exit(0 if ok else 9)\n"
)
DRILLS = {
    # name: (worker code, agent kwargs, expected rc, expected restarts)
    "clean_exit": ("print('ok')", {}, 0, 0),
    "restarts_failed_worker": (_FAIL_TWICE, {"max_restarts": 5}, 0, 2),
    "exhausts_restarts": ("import sys; sys.exit(3)", {"max_restarts": 1}, 3, 1),
    "passes_batch_env": (_BATCH_ENV, {"static_world_size": 12}, 0, 0),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_agent_drill_equals_jax(tmp_path, drill):
    code, kw, rc, restarts = DRILLS[drill]
    seen = {}
    for pkg in ("jax", "torch"):
        marker = tmp_path / f"attempts-{pkg}"
        agent = _agent(pkg, [sys.executable, "-c", code.format(marker=str(marker))], **kw)
        seen[pkg] = (agent.run(), agent.restart_count, marker.read_text() if marker.exists() else None)
    assert seen["torch"] == seen["jax"] == (rc, restarts, "3" if drill == "restarts_failed_worker" else None)


def test_agent_rejects_incompatible_world():
    cfg = json.loads(json.dumps(ELASTIC_CFG))
    cfg["elasticity"]["micro_batch_sizes"] = [64]
    for pkg in ("jax", "torch"):
        agent = _agent(pkg, [sys.executable, "-c", "pass"], cfg=cfg, static_world_size=3)
        with pytest.raises(PACKAGES[pkg].ElasticityIncompatibleWorldSize, match="not in the elastic set"):
            agent.run()


def _wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def test_agent_restarts_on_membership_change(tmp_path):
    hostfile, out = tmp_path / "hostfile", tmp_path / "worlds"
    hostfile.write_text("node-0 slots=4\n")
    script = (
        "import os, pathlib, time\n"
        f"p = pathlib.Path({str(out)!r})\n"
        "with p.open('a') as f: f.write(os.environ['DSTPU_ELASTIC_WORLD_SIZE'] + '\\n')\n"
        "time.sleep(30)\n"
    )
    agent = _agent("torch", [sys.executable, "-c", script], static_world_size=None, hostfile=str(hostfile),
                   monitor_interval=0.1, max_restarts=3)

    def grow_then_kill():
        # event-driven: grow only after generation 0 recorded its world, kill
        # only after generation 1 recorded the grown one
        _wait_for(lambda: out.exists() and out.read_text().split())
        hostfile.write_text("node-0 slots=4\nnode-1 slots=8\n")
        _wait_for(lambda: out.exists() and "12" in out.read_text().split())
        agent._stop(signal.SIGKILL)

    t = threading.Thread(target=grow_then_kill)
    t.start()
    rc = agent.run(max_generations=2)
    t.join()
    assert out.read_text().split() == ["4", "12"]
    assert agent.restart_count == 1 and rc == -signal.SIGKILL


def test_agent_kills_hung_worker_on_stale_heartbeat(tmp_path):
    """Generation 0 touches the heartbeat once and wedges; the agent SIGKILLs
    it after the timeout and generation 1 exits cleanly."""
    hb, marker = tmp_path / "heartbeat", tmp_path / "gen"
    script = (
        "import os, pathlib, time\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "gen = int(os.environ['DSTPU_ELASTIC_GENERATION'])\n"
        "m.write_text(str(gen))\n"
        "if gen == 0:\n"
        "    pathlib.Path(os.environ['DSTPU_ELASTIC_HEARTBEAT']).touch()\n"
        "    time.sleep(60)\n"
    )
    agent = _agent("torch", [sys.executable, "-c", script], monitor_interval=0.1, max_restarts=2,
                   heartbeat_file=str(hb), heartbeat_timeout=1.0)
    t0 = time.monotonic()
    assert agent.run() == 0
    t1 = time.monotonic()
    assert agent.restart_count == 1 and marker.read_text() == "1"
    assert t1 - t0 < 30  # the timeout killed it, not the sleep
    # the agent's own record: both launches, and the kill of the hung one between them
    g0, g1 = agent.generations
    assert [g0["generation"], g1["generation"], g0["world"], g1["world"]] == [0, 1, 4, 4]
    assert t0 <= g0["launched_at"] < g0["killed_at"] < g1["launched_at"] <= t1 and g1["killed_at"] is None
    assert g0["killed_at"] - g0["launched_at"] >= 1.0  # not before the heartbeat timeout


def test_agent_heartbeat_stale_exhausted_exits_1(tmp_path):
    script = ("import os, pathlib, time\n"
              "pathlib.Path(os.environ['DSTPU_ELASTIC_HEARTBEAT']).touch()\n"
              "time.sleep(60)\n")
    agent = _agent("torch", [sys.executable, "-c", script], monitor_interval=0.1, max_restarts=0,
                   heartbeat_file=str(tmp_path / "hb"), heartbeat_timeout=0.5)
    assert agent.run() == 1 and agent.restart_count == 0


def test_agent_heartbeat_env_and_fresh_file(tmp_path):
    hb = tmp_path / "hb"
    hb.write_text("stale")
    code = ("import os, sys\n"
            "p = os.environ['DSTPU_ELASTIC_HEARTBEAT']\n"
            "sys.exit(0 if os.path.exists(p) and open(p).read() == '' else 7)\n")
    agent = _agent("torch", [sys.executable, "-c", code], heartbeat_file=str(hb), heartbeat_timeout=30.0)
    assert agent.run() == 0
    assert tel.HEARTBEAT_ENV == jagent_mod.HEARTBEAT_ENV == "DSTPU_ELASTIC_HEARTBEAT"


@pytest.mark.parametrize("policy,seed", [(None, 0), (None, 5), ({"base_delay_s": 1.0, "max_delay_s": 8.0,
                                                                 "jitter": 0.25}, 3)])
def test_restart_backoff_sleeps_jax_delays(monkeypatch, policy, seed):
    slept = {"jax": [], "torch": []}
    for pkg, mod in (("jax", jagent_mod), ("torch", tagent_mod)):
        monkeypatch.setattr(mod.time, "sleep", lambda d, pkg=pkg: slept[pkg].append(d))
        agent = PACKAGES[pkg].DSElasticAgent(ELASTIC_CFG, PACKAGES[pkg].WorkerSpec(command=["true"]),
                                             static_world_size=4, restart_backoff=policy, backoff_seed=seed)
        for restart in range(0, 9):
            agent.restart_count = restart
            agent._backoff()
    assert slept["torch"] == slept["jax"] and len(slept["torch"]) == 9
    if policy is None:  # the default: 1 s doubling to 30 s, +/- 25 %
        assert 0.75 <= slept["torch"][0] <= 1.25 and max(slept["torch"]) <= 30 * 1.25


def test_agent_membership_poll_tolerates_torn_hostfile(tmp_path):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("node-0 slots=4\n")
    agent = _agent("torch", [sys.executable, "-c", "pass"], static_world_size=None, hostfile=str(hostfile))
    assert agent.current_world_size() == 4
    hostfile.write_text("node-0 slots=")  # mid-rewrite: a torn token
    assert agent.current_world_size() == 0
    hostfile.unlink()  # mid-rewrite: briefly absent
    assert agent.current_world_size() == 0
    hostfile.write_text("node-0 slots=4\nnode-1 slots=4\n")
    assert agent.current_world_size() == 8
    hostfile.write_text("node-0 slots=")
    bad = _agent("torch", [sys.executable, "-c", "pass"], static_world_size=None, hostfile=str(hostfile),
                 monitor_interval=0.01)
    with pytest.raises(ValueError, match="no readable hosts"):
        bad.run()
    with pytest.raises(ValueError, match="need a hostfile"):
        tel.DSElasticAgent(ELASTIC_CFG, tel.WorkerSpec(command=["true"]))


def test_heartbeat_startup_grace_vs_step_timeout(tmp_path):
    hb = tmp_path / "hb"
    agent = _agent("torch", [sys.executable, "-c", "pass"], heartbeat_file=str(hb), heartbeat_timeout=0.2,
                   heartbeat_grace=30.0)
    hb.write_text("")
    agent._hb_judge = HeartbeatJudge(str(hb), 0.2, 30.0)
    agent._hb_judge.reset()
    time.sleep(0.3)  # past the step timeout, inside the startup grace
    assert not agent._heartbeat_stale()
    hb.touch()  # the first heartbeat: the step clock takes over
    assert not agent._heartbeat_stale()
    time.sleep(0.3)
    assert agent._heartbeat_stale()
    assert _agent("torch", ["true"], heartbeat_timeout=2.0).heartbeat_grace == 20.0


def test_heartbeat_staleness_never_consults_wall_clock(tmp_path, monkeypatch):
    import time as _time

    from deepspeed_tpu_torch.resilience import heartbeat as hb_mod

    class _NoWallClock:
        def __getattr__(self, name):
            return getattr(_time, name)

        @staticmethod
        def time():
            raise AssertionError("time.time() consulted in the heartbeat verdict path")

    hb = tmp_path / "hb"
    agent = _agent("torch", [sys.executable, "-c", "pass"], heartbeat_file=str(hb), heartbeat_timeout=0.2,
                   heartbeat_grace=30.0)
    hb.write_text("")
    agent._hb_judge = HeartbeatJudge(str(hb), 0.2, 30.0)
    agent._hb_judge.reset()
    monkeypatch.setattr(tagent_mod, "time", _NoWallClock())
    monkeypatch.setattr(hb_mod, "time", _NoWallClock())
    time.sleep(0.3)
    assert not agent._heartbeat_stale()
    hb.touch()
    assert not agent._heartbeat_stale()
    time.sleep(0.3)
    assert agent._heartbeat_stale()


# -- python -m deepspeed_tpu_torch.elasticity against bin/dstpu_elastic --------

def _jax_cli():
    path = os.path.join(REPO, "bin", "dstpu_elastic")
    loader = importlib.machinery.SourceFileLoader("_dstpu_elastic_bin", path)
    spec = importlib.util.spec_from_loader("_dstpu_elastic_bin", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


CLI_CASES = {
    "compatible_world": (ELASTIC_CFG, ["-w", "12"], 0),
    "no_world": (ELASTIC_CFG, [], 0),
    "incompatible_world": (ELASTIC_CFG, ["-w", "7"], 3),
    "missing_config": (None, [], 2),
    "not_a_dict": ([], [], 2),
    "bad_field": ({"elasticity": dict(ELASTIC_CFG["elasticity"], micro_batch_sizes="oops")}, ["-w", "12"], 2),
    "empty_micro_batches": ({"elasticity": dict(ELASTIC_CFG["elasticity"], micro_batch_sizes=[])}, [], 2),
    "unparseable": ("{not json", [], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_elastic_cli_equals_dstpu_elastic(tmp_path, capsys, case):
    cfg, extra, rc = CLI_CASES[case]
    path = tmp_path / "ds.json"
    if cfg is not None:
        path.write_text(cfg if isinstance(cfg, str) else json.dumps(cfg))
    argv = ["-c", str(path), *extra]
    got = (tcli.main(argv), *capsys.readouterr())
    want = (_jax_cli().main(argv), *capsys.readouterr())
    assert got == want
    assert got[0] == rc
    assert got[2] == "" or got[2].startswith("dstpu_elastic:")


def test_elastic_cli_usage_error_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main([])
    assert e.value.code == 2


def test_python_m_elasticity_runs(tmp_path):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(ELASTIC_CFG))
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.elasticity", "-c", str(path), "-w", "7"],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 3 and "not in the elastic set" in proc.stderr
