"""The port's serving worker processes (``launcher/serving_worker.py``).

Real OS processes with ``--device cpu``: one worker is one port
``ServingEngine`` behind the RPC in its own interpreter, its weights
rebuilt from the spec (seed 0), so its greedy tokens equal this process's
``generate`` over the same spec. Round trip and SIGTERM drain over unix
and tcp, the supervisor's kill -9, respawn and reattach, the respawn
budget's healing on a fake clock, and the heartbeat judge. A worker boot
here costs an interpreter and a torch import (~3 s), so nothing in this
file is slow.
"""

import json
import os
import pathlib
import signal
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import Request, Router
from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor, build_serving_engine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import HeartbeatJudge
from deepspeed_tpu_torch.runtime.config import RouterTransportConfig

REPO = str(pathlib.Path(__file__).resolve().parents[1])
MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64,
             decode_attn="xla", pos_emb="rotary")
SPEC = {"model": {**MODEL, "dtype": "float32"}, "engine_dtype": "fp32",
        "serving": {"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise"}}
BACKOFF = {"max_attempts": 10, "base_delay_s": 0.05, "max_delay_s": 0.1, "jitter": 0.0}


@pytest.fixture(scope="module")
def engine():
    return init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, device="cpu")


def _transport(family="unix", **kw):
    kw = {"call_timeout_s": 120.0, "boot_timeout_s": 120.0, "heartbeat_timeout_s": 30.0,
          "base_delay_s": 0.05, "max_delay_s": 0.2, **kw}
    if family == "tcp":
        kw.update(family="tcp", host="127.0.0.1", port_base=0)
    return RouterTransportConfig(**kw)


def _supervisor(n, family="unix", tmp=None):
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return WorkerSupervisor(SPEC, n, transport=_transport(family), respawn_backoff=BACKOFF, device="cpu",
                            env=env, workdir=tmp)


def _events(log_path):
    out = []
    with open(log_path) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def _prompts(seed=0, sizes=(5, 11)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=s).astype(np.int32) for s in sizes]


def test_spec_builds_the_seeded_weights(engine):
    srv = build_serving_engine(SPEC, replica_id=3, device="cpu")
    assert srv.replica_id == 3 and srv.n_slots == 2
    mine, theirs = (torch.utils._pytree.tree_leaves(e.params) for e in (srv.engine, engine))
    assert len(mine) == len(theirs) and all(torch.equal(a, b) for a, b in zip(mine, theirs))
    with pytest.raises(ValueError, match="dtype"):
        build_serving_engine({"model": {**MODEL, "dtype": "int8"}}, device="cpu")


@pytest.mark.parametrize("family", ["unix", "tcp"])
def test_worker_process_roundtrip_and_sigterm_drain(engine, family):
    """One worker process: it boots from the spec with the same weights
    (greedy tokens equal this process's generate), serves the scheduler
    surface over the RPC, heartbeats, and on SIGTERM drains its in-flight
    work, prints its ``drained`` line and exits 0."""
    prompts = _prompts()
    refs = [engine.generate(p[None], max_new_tokens=6)[0] for p in prompts]
    sup = _supervisor(1, family)
    try:
        (client,) = sup.start()
        if family == "tcp":
            assert client.rpc.path.startswith("tcp://127.0.0.1:")
        assert client.ping()["pid"] == sup.proc(0).pid
        for i, p in enumerate(prompts):
            client.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        done = set()
        for _ in range(40):
            done |= set(client.step(now=0.0))
            if len(done) == 2:
                break
        assert done == {0, 1}
        for i in range(2):
            res = client.result(i)
            assert res.ok
            np.testing.assert_array_equal(res.tokens, refs[i])
        assert client.compile_counts()["decode"] == 1
        snap = client.telemetry_snapshot()
        assert snap["replica_id"] == 0 and snap["transport"]["calls"] > 0
        hb = sup._hb_path[0]
        m0 = os.path.getmtime(hb)
        deadline = time.monotonic() + 10.0  # the beat thread touches it every ~0.5 s
        while os.path.getmtime(hb) <= m0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.getmtime(hb) > m0
        assert sup.poll() == []
        client.submit(Request(uid=7, prompt=prompts[0], max_new_tokens=6))
        client.step(now=0.0)  # admitted, decoding
        os.kill(sup.proc(0).pid, signal.SIGTERM)
        assert sup.proc(0).wait(timeout=60) == 0
        events = _events(sup._logs[0])
        assert {"ready", "drained"} <= {e.get("event") for e in events}
        drained = next(e for e in events if e.get("event") == "drained")
        assert drained["in_flight_at_signal"] >= 1 and drained["results"] >= 3
        assert drained["decode_kernel_launches"] == [0, 0]  # the CPU runs no kernel
        assert sup.poll() == [0]
    finally:
        sup.shutdown()


def test_supervisor_kill9_respawn_and_router_reattach(engine, tmp_path):
    """SIGKILL a worker mid-decode: the Router's DEAD verdict replays its
    requests from the Router's copies with the same tokens; the supervisor
    sees the corpse, respawns it on a fresh socket path and heartbeat, and
    the replacement joins as a NEW replica that serves traffic."""
    prompts = _prompts(3)
    refs = [engine.generate(p[None], max_new_tokens=8)[0] for p in prompts]
    workdir = str(tmp_path / "w")
    sup = _supervisor(2, tmp=workdir)
    try:
        clients = sup.start()
        router = Router(config={"router": {"replicas": 2, "health": {"timeout": 60.0}}}, replica_engines=clients)
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        router.step(now=0.0)
        assert [router.owner_of(u) for u in (0, 1)] == [0, 1]
        old_sock = clients[0].rpc.path
        sup.kill(0, signal.SIGKILL)
        res = router.drain()
        for i in range(2):
            assert res[i].ok, (i, res[i].status)
            np.testing.assert_array_equal(res[i].tokens, refs[i])
        assert router.replica_states()[0] == "dead"
        assert router.telemetry.registry.snapshot()["counters"]["router/failovers"] == 1
        assert sup.poll() == [0]
        new_client = sup.respawn(0)
        assert sup.respawns == 1 and new_client.rpc.path != old_sock and not os.path.exists(old_sock)
        rid = router.attach_replica(new_client)
        assert rid == 2
        router.drain_replica(1, block=True)
        router.submit(Request(uid=9, prompt=prompts[0], max_new_tokens=8))
        assert router.owner_of(9) == rid
        np.testing.assert_array_equal(router.drain()[9].tokens, refs[0])
        assert new_client.compile_counts()["decode"] == 1
        # a restarted supervisor adopts the live workers from their pidfiles
        heir = WorkerSupervisor(SPEC, 2, workdir=workdir, transport=_transport(), device="cpu")
        adopted = heir.adopt()
        assert sorted(adopted) == [0, 1] and adopted[0].ping()["pid"] == sup.proc(0).pid
        for c in adopted.values():
            c.close()
    finally:
        sup.shutdown()
    assert not any(name.endswith(".pid") for name in os.listdir(workdir))


def test_worker_without_a_card_refuses_to_start(tmp_path):
    """``--device cuda`` (the default) with no card raises; it never falls
    back to the CPU."""
    import subprocess
    import sys

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SPEC))
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.serving_worker",
                           "--socket", str(tmp_path / "s.sock"), "--spec", str(spec)],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert not (tmp_path / "s.sock").exists()


class _FakeProc:
    def __init__(self, rc=None):
        self.returncode = rc

    def poll(self):
        return self.returncode


class _FakeJudge:
    def __init__(self, stale=False):
        self._stale = stale

    def stale(self):
        return self._stale


def test_respawn_budget_heals_after_sustained_health(tmp_path):
    """``_respawn_count`` decays by one per ``respawn_heal_s`` of healthy
    uptime on the supervisor's (fake) monotonic clock; a crash loop still
    exhausts the budget, and a stale slot never heals."""
    clk = {"t": 1000.0}
    sup = WorkerSupervisor({}, 0, workdir=str(tmp_path), max_respawns=3, respawn_heal_s=60.0,
                           clock=lambda: clk["t"])
    sup._procs[0] = _FakeProc()
    sup._hb_judge[0] = _FakeJudge()
    sup._respawn_count[0] = 2
    sup._heal_anchor[0] = clk["t"]
    assert sup.poll() == [] and sup._respawn_count[0] == 2
    clk["t"] += 59.0
    sup.poll()
    assert sup._respawn_count[0] == 2
    clk["t"] += 2.0
    sup.poll()
    assert sup._respawn_count[0] == 1
    clk["t"] += 130.0
    sup.poll()
    assert sup._respawn_count[0] == 0
    sup._respawn_count[1] = 3
    with pytest.raises(RuntimeError, match="exhausted its respawn budget"):
        sup.respawn(1)
    sup._procs[2] = _FakeProc(rc=-9)
    sup._hb_judge[2] = _FakeJudge(stale=True)
    sup._respawn_count[2] = 1
    sup._heal_anchor[2] = clk["t"]
    clk["t"] += 120.0
    assert sup.poll() == [2] and sup._respawn_count[2] == 1


def test_heartbeat_judge_grace_then_timeout(tmp_path, monkeypatch):
    """Staleness is judged on the monotonic clock against the judge's own
    observations of the file changing: the startup grace until the first
    touch, the timeout after it; a deleted file is stale."""
    path = tmp_path / "hb"
    path.write_text("")
    mono = {"t": 100.0}
    monkeypatch.setattr("deepspeed_tpu_torch.resilience.heartbeat.time.monotonic", lambda: mono["t"])
    judge = HeartbeatJudge(str(path), timeout=2.0)
    judge.reset()
    mono["t"] += 19.0
    assert not judge.stale()  # inside the 10x grace
    mono["t"] += 2.0
    assert judge.stale()
    os.utime(path, (time.time() + 5, time.time() + 5))  # the first touch
    assert not judge.stale()
    mono["t"] += 1.5
    assert not judge.stale()
    mono["t"] += 1.0
    assert judge.stale()
    path.unlink()
    assert judge.stale()
    assert not HeartbeatJudge(str(path), timeout=0).stale()
