"""Port parity: the serving RPC (DSRP frames, the codec, the client and
server) and the Router over remote replicas.

The port's frames must be the JAX package's byte for byte, each package's
client must talk to the other's server, and the transport's failure modes
(lost replies, resets, corrupt frames, deadlines) must map onto the
Router's health machine as they do in JAX. Remote replicas here are real
port ``ServingEngine``s behind a real ``RpcServer`` in a thread
(``WorkerHost``): the transport and scheduler surface of a worker process
without a process boot (``tests/test_torch_serving_worker.py`` boots
real ones).
"""

import os
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from deepspeed_tpu.inference import rpc as jrpc
from deepspeed_tpu.inference.serving import Request as JaxRequest
from deepspeed_tpu.inference.serving import RequestResult as JaxResult
from deepspeed_tpu.resilience import FaultInjector as JaxInjector
from deepspeed_tpu.runtime.config import RouterTransportConfig as JaxTransport
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import rpc as trpc
from deepspeed_tpu_torch.inference.serving import RequestResult
from deepspeed_tpu_torch.launcher.serving_worker import WorkerHost
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import (FaultInjector, RpcConnectionLost, RpcGarbledFrame,
                                            RpcTimeout)
from deepspeed_tpu_torch.runtime.config import RouterTransportConfig

TRANSPORT = dict(call_timeout_s=60.0, connect_attempts=2, base_delay_s=0.05, max_delay_s=0.1, jitter=0.0)
FAMILIES = ["unix", "tcp"]
MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64,
             decode_attn="xla", pos_emb="rotary")


def _sock_pair(family):
    if family == "unix":
        a, b = socket.socketpair()
        a.settimeout(5.0)
        b.settimeout(5.0)
        return a, b
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.settimeout(5.0)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    a.settimeout(5.0)
    a.connect(lst.getsockname())
    b, _ = lst.accept()
    b.settimeout(5.0)
    lst.close()
    return a, b


def _addr(tmp_path, name, family):
    return "tcp://127.0.0.1:0" if family == "tcp" else os.path.join(str(tmp_path), f"{name}.sock")


def _raw_frame(send, obj) -> bytes:
    """The bytes ``send`` puts on a socketpair for ``obj``."""
    a, b = socket.socketpair()
    b.settimeout(5.0)
    try:
        send(a, obj)
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


# ---------------------------------------------------------------- frames

def _objects():
    req = dict(uid=3, prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, temperature=0.5, top_k=7,
               top_p=0.9, eos_token=2, arrival_time=1.25, deadline_s=3.0, priority=1, tenant="acme")
    res = dict(uid=3, tokens=np.asarray([4, 5], np.int32), prompt_len=9, arrival_time=1.25,
               admitted_time=1.5, first_token_time=1.75, finish_time=2.0, slot=1, status="ok", requeues=1)
    return {
        "nested": {"method": "step", "arr": np.arange(7, dtype=np.int32),
                   "f": np.float32(0.1), "i": np.int64(3),
                   "nested": {"f": 1.5, "l": [1, "two", None, (2, 3)]}, "mat": np.ones((2, 3), np.float32)},
        "request_frame": {"id": 7, "method": "submit", "kwargs": {"request": trpc.encode_request(Request(**req))}},
        "result_reply": {"id": 7, "ok": True, "result": {"1": trpc.encode_result(RequestResult(**res))}},
        "error_reply": {"id": 8, "ok": False, "error": "RequestRejected", "message": "full", "uid": 3,
                        "reason": "queue_full"},
        "unicode": {"tenant": "ténant", "empty": [], "none": None},
    }


@pytest.mark.parametrize("name", list(_objects()))
def test_frame_bytes_equal_jax(name):
    obj = _objects()[name]
    tb = _raw_frame(trpc.send_frame, obj)
    assert tb == _raw_frame(jrpc.send_frame, obj)
    assert tb[:4] == b"DSRP" and struct.unpack("!I", tb[4:8])[0] == len(tb) - 12


@pytest.mark.parametrize("writer,reader", [(jrpc, trpc), (trpc, jrpc)], ids=["jax_to_torch", "torch_to_jax"])
def test_frames_and_codec_cross_packages(writer, reader):
    a, b = socket.socketpair()
    try:
        obj = _objects()["nested"]
        writer.send_frame(a, obj)
        out = reader.recv_frame(b, timeout=5.0)
        np.testing.assert_array_equal(out["arr"], obj["arr"])
        assert out["arr"].dtype == np.int32 and out["mat"].shape == (2, 3)
        assert out["nested"] == {"f": 1.5, "l": [1, "two", None, [2, 3]]}
    finally:
        a.close()
        b.close()
    req_cls = JaxRequest if reader is jrpc else Request
    res_cls = JaxResult if reader is jrpc else RequestResult
    req = (Request if writer is trpc else JaxRequest)(
        uid=3, prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, temperature=0.5, top_k=7, top_p=0.9,
        eos_token=2, arrival_time=1.25, deadline_s=3.0, priority=2, tenant="acme")
    back = reader.decode_request(writer.encode_request(req))
    assert isinstance(back, req_cls)
    np.testing.assert_array_equal(back.prompt, req.prompt)
    assert writer.encode_request(req) == reader.encode_request(back)
    res = (RequestResult if writer is trpc else JaxResult)(
        uid=3, tokens=np.asarray([4, 5], np.int32), prompt_len=9, arrival_time=1.25, finish_time=2.0,
        slot=1, status="ok", requeues=1)
    back = reader.decode_result(writer.encode_result(res))
    assert isinstance(back, res_cls) and back.ok
    assert writer.encode_result(res) == reader.encode_result(back)


@pytest.mark.parametrize("family", FAMILIES)
def test_frame_garble_truncation_and_deadline(family):
    cases = []
    payload = b'{"x":1}'
    cases.append((b"XXXX" + struct.pack("!II", 2, 0) + b"{}", RpcGarbledFrame, "bad frame header", False))
    cases.append((b"DSRP" + struct.pack("!II", len(payload), zlib.crc32(payload)) + b'{"x":2}',
                  RpcGarbledFrame, "crc mismatch", False))
    cases.append((b"DSRP" + struct.pack("!II", len(payload), zlib.crc32(payload)) + payload[:3],
                  RpcConnectionLost, "mid-frame", True))
    for data, err, match, close in cases:
        a, b = _sock_pair(family)
        try:
            a.sendall(data)
            if close:
                a.close()
            with pytest.raises(err, match=match):
                trpc.recv_frame(b, timeout=5.0)
        finally:
            a.close()
            b.close()
    a, b = _sock_pair(family)
    try:
        with pytest.raises(RpcTimeout):
            trpc.recv_frame(b, timeout=0.05)
    finally:
        a.close()
        b.close()


def test_fault_sites_decide_like_jax():
    cfg = {"enabled": True, "seed": 3, "rate": 0.3,
           "sites": ["rpc_timeout", "replica_hang", "router_crash"],
           "rpc_timeout_at": [["step", 2]], "rpc_conn_reset_at": [["submit", 1]],
           "rpc_garbled_at": [["step", 3]], "replica_dead_at": [[0, 4]], "replica_hang_at": [[1, 2]],
           "router_crash_at": [5], "io_error_journal_appends": [2]}
    ti, ji = FaultInjector(cfg), JaxInjector(cfg)
    for inj_t, inj_j in ((ti, ji),):
        for n in range(1, 8):
            for m in ("step", "submit"):
                assert inj_t.rpc_timeout(m, n) == inj_j.rpc_timeout(m, n)
                assert inj_t.rpc_conn_reset(m, n) == inj_j.rpc_conn_reset(m, n)
                assert inj_t.rpc_garbled_frame(m, n) == inj_j.rpc_garbled_frame(m, n)
            for rid in (0, 1):
                assert inj_t.replica_dead(rid, n) == inj_j.replica_dead(rid, n)
                assert inj_t.replica_hang(rid, n) == inj_j.replica_hang(rid, n)
            assert inj_t.router_crash(n) == inj_j.router_crash(n)
        for _ in range(3):
            outcome = []
            for inj in (inj_t, inj_j):
                try:
                    inj.journal_append("j")
                    outcome.append(None)
                except OSError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1]
    assert ti.stats() == ji.stats()
    assert ti.injected["rpc_conn_reset"] == 1 and ti.injected["router_crash"] >= 1


@pytest.mark.parametrize("server_pkg,client_pkg", [(trpc, jrpc), (jrpc, trpc)],
                         ids=["jax_client_torch_server", "torch_client_jax_server"])
def test_echo_across_packages(tmp_path, server_pkg, client_pkg):
    server = server_pkg.RpcServer(os.path.join(str(tmp_path), "echo.sock"),
                                  {"echo": lambda **kw: kw, "boom": lambda: 1 / 0})
    stop = threading.Event()
    t = threading.Thread(target=server.serve_forever, kwargs={"should_stop": stop.is_set}, daemon=True)
    t.start()
    try:
        transport = (JaxTransport if client_pkg is jrpc else RouterTransportConfig)(**TRANSPORT)
        client = client_pkg.RpcClient(server.address, transport=transport)
        out = client.call("echo", a=1, arr=np.arange(4, dtype=np.int32), s="x")
        assert out["a"] == 1 and out["s"] == "x"
        np.testing.assert_array_equal(out["arr"], np.arange(4))
        with pytest.raises(Exception, match="ZeroDivisionError"):
            client.call("boom")
        assert client.call("echo", again=True) == {"again": True}  # the stream survived
        client.close()
    finally:
        stop.set()
        t.join(timeout=5)
        server.close()


def test_real_timeout_drops_desynced_stream(tmp_path):
    """A real deadline miss leaves the late reply in the stream: the
    client drops the connection, and the next call gets its own reply."""
    path = os.path.join(str(tmp_path), "late.sock")
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lst.settimeout(10.0)
    lst.bind(path)
    lst.listen(2)
    calls = []
    gate = threading.Event()

    def serve():
        while len(calls) < 2:
            conn, _ = lst.accept()
            try:
                while True:
                    req = trpc.recv_frame(conn, timeout=10.0)
                    calls.append(req["method"])
                    if len(calls) == 1:
                        gate.wait(5.0)  # past the client's 0.2 s deadline
                    trpc.send_frame(conn, {"id": req["id"], "ok": True, "result": {"served": req["method"]}})
            except (OSError, trpc.RpcError):
                conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        client = trpc.RpcClient(path, transport=RouterTransportConfig(
            call_timeout_s=0.2, connect_attempts=2, base_delay_s=0.01, max_delay_s=0.02, jitter=0.0))
        with pytest.raises(RpcTimeout):
            client.call("first")
        gate.set()
        assert not client.connected
        assert client.call("second", timeout=10.0) == {"served": "second"}
        assert client.stats["reconnects"] >= 1
        client.close()
    finally:
        lst.close()
        t.join(timeout=5)


# ------------------------------------------------- thread-hosted replicas

@pytest.fixture(scope="module")
def engine():
    return init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, device="cpu")


class _ThreadWorker:
    """A port ServingEngine behind a port RpcServer in a thread; ``stop()``
    stands in for a SIGKILL: the listener and streams close."""

    def __init__(self, engine, tmp_path, name, replica_id=0, family="unix"):
        self.engine = ServingEngine(engine, config={"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise"},
                                    replica_id=replica_id)
        self.host = WorkerHost(self.engine)
        self.server = trpc.RpcServer(_addr(tmp_path, name, family), self.host.handlers())
        self.path = self.server.address
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        kwargs={"should_stop": self._stop.is_set}, daemon=True)
        self._thread.start()

    def client(self, **kw):
        kw.setdefault("transport", RouterTransportConfig(**TRANSPORT))
        return trpc.ReplicaClient(self.path, **kw)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.server.close()


def _prompts(sizes, seed=0, vocab=97):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def _refs(engine, prompts, n):
    return [engine.generate(p[None], max_new_tokens=n)[0] for p in prompts]


def test_replica_client_matches_inprocess_engine(engine, tmp_path):
    """The scheduler surface over the wire gives what the same requests
    give on an in-process engine: tokens, statuses, terminal order."""
    prompts = _prompts([5, 11, 23])
    local = ServingEngine(engine, config={"n_slots": 2, "max_seq_len": 64})
    w = _ThreadWorker(engine, tmp_path, "solo", replica_id=9)
    try:
        client = w.client(replica_id=9)
        assert client.ping()["replica_id"] == 9
        orders = []
        for srv in (local, client):
            for i, p in enumerate(prompts):
                srv.submit(Request(uid=i, prompt=p, max_new_tokens=8))
            order = []
            for _ in range(40):
                order += srv.step(now=0.0)
                if len(order) == 3:
                    break
            orders.append(order)
        assert orders[0] == orders[1] and sorted(orders[1]) == [0, 1, 2]
        for i in range(3):
            r, lr = client.result(i), local.result(i)
            assert (r.status, r.slot, r.prompt_len) == (lr.status, lr.slot, lr.prompt_len)
            np.testing.assert_array_equal(r.tokens, lr.tokens)
        assert client.idle and client.load == 0
        assert client.compile_counts()["decode"] == 1
        snap = client.telemetry_snapshot()
        assert snap["replica_id"] == 9 and snap["transport"]["calls"] > 0
        assert snap["decode_kernel_launches"] == [0, 0]  # no graph on the CPU
        assert client.prefix_match_len(prompts[0]) == 0
    finally:
        w.stop()


def test_worker_profile_window_and_warm_decode(engine):
    """A WorkerHost's profiler window, armed by ``profile_decode_steps``,
    opens at the next step that begins with a decoding slot and closes
    after that many steps;
    ``telemetry_snapshot`` reports its kernel records (none on the CPU,
    where the decode step runs eagerly and no graph replays). The boot
    warm-up counts as no decode step."""
    srv = ServingEngine(engine, config={"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise"})
    srv.warm_decode()
    counts = srv.compile_counts()
    assert (counts["decode"], counts["decode_steps"]) == (1, 0)
    assert srv.telemetry.registry.snapshot()["counters"].get("serving/decode_steps", 0) == 0
    host = WorkerHost(srv)
    assert host.profile_decode_steps(2) == {"armed": 2}
    for i, p in enumerate(_prompts([5, 11], seed=3)):
        host.submit(trpc.encode_request(Request(uid=i, prompt=p, max_new_tokens=8)))
    host.step(now=0.0)  # prefill: nothing was decoding when it began
    assert host._prof is None and host.telemetry_snapshot()["decode_kernel_records"] is None
    host.step(now=0.0)
    assert host._prof is not None
    host.step(now=0.0)
    snap = host.telemetry_snapshot()
    assert host._prof is None and snap["decode_kernel_records"] == {"split": 0, "combine": 0, "replays": 0}
    assert snap["decode_kernel_launches"] == [0, 0] and srv.compile_counts()["decode_steps"] == 3


@pytest.mark.parametrize("family", FAMILIES)
def test_step_reply_loss_recovered_by_replay(engine, tmp_path, family):
    """A step reply lost to a reset (over TCP a linger-0 RST) or a garbled
    frame is re-delivered after the retry: nothing lost, nothing doubled."""
    prompts = _prompts([5, 11], seed=5)
    refs = _refs(engine, prompts, 8)
    w = _ThreadWorker(engine, tmp_path, "retry", family=family)
    try:
        client = w.client(fault_injection={"enabled": True, "seed": 0, "rpc_conn_reset_at": [["step", 2]],
                                           "rpc_garbled_at": [["step", 5]]})
        for i, p in enumerate(prompts):
            client.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        done = []
        for _ in range(40):
            done += client.step(now=0.0)
            if len(done) >= 2:
                break
        assert sorted(done) == [0, 1]
        for i in range(2):
            np.testing.assert_array_equal(client.result(i).tokens, refs[i])
        st = client.rpc_stats()
        assert st["conn_resets"] >= 1 and st["garbled_frames"] >= 1
        assert st["reconnects"] >= 2 and st["retries"] >= 2
    finally:
        w.stop()


def _mixed_fleet(engine, tmp_path, name, family="unix", fi=None, health=None):
    w = _ThreadWorker(engine, tmp_path, name, replica_id=0, family=family)
    client = w.client(replica_id=0, fault_injection=fi)
    local = ServingEngine(engine, config={"n_slots": 2, "max_seq_len": 64}, replica_id=1)
    router = Router(config={"router": {"replicas": 2, "health": {"timeout": 30.0, **(health or {})}}},
                    replica_engines=[client, local])
    return w, client, local, router


@pytest.mark.parametrize("family", FAMILIES)
def test_remote_kill_fails_over_like_inprocess(engine, tmp_path, family):
    """Killing the remote replica's transport mid-decode is the DEAD
    verdict; its requests fail over from the Router's copies and end as
    the in-process fleet's ``replica_dead`` run ends: the same owners
    before the kill, the same tokens, the same failover count."""
    prompts = _prompts([5, 11, 23])
    ref = Router(engine, config={"n_slots": 2, "max_seq_len": 64,
                                 "router": {"replicas": 2, "health": {"timeout": 30.0}},
                                 "fault_injection": {"enabled": True, "replica_dead_at": [[0, 3]]}})
    w, client, local, router = _mixed_fleet(engine, tmp_path, "kill", family)
    try:
        for r in (ref, router):
            for i, p in enumerate(prompts):
                r.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        assert [router.owner_of(u) for u in range(3)] == [ref.owner_of(u) for u in range(3)]
        on_remote = [u for u in range(3) if router.owner_of(u) == 0]
        for r in (ref, router):
            r.step(now=0.0)
            r.step(now=0.0)
        w.stop()  # the SIGKILL stand-in
        res, ref_res = router.drain(), ref.drain()
        for i in range(3):
            assert res[i].ok and ref_res[i].ok
            np.testing.assert_array_equal(res[i].tokens, ref_res[i].tokens)
        assert router.replica_states() == ref.replica_states() == {0: "dead", 1: "healthy"}
        counters = router.telemetry.registry.snapshot()["counters"]
        assert counters["router/failovers"] == len(on_remote) == \
            ref.telemetry.registry.snapshot()["counters"]["router/failovers"]
        assert counters["rpc/calls"] > 0
        snap = router.telemetry_snapshot()
        assert "unreachable" in snap["replicas"][0]
        assert any(e["event"] == "admitted" for e in snap["replicas"][0]["request_trace"])
    finally:
        w.stop()


def test_rpc_timeout_is_a_hung_verdict(engine, tmp_path):
    prompts = _prompts([5, 11], seed=7)
    refs = _refs(engine, prompts, 8)
    w, client, local, router = _mixed_fleet(
        engine, tmp_path, "hang", fi={"enabled": True, "seed": 0, "rpc_timeout_at": [["step", 2]]},
        health={"max_attempts": 3, "base_delay_s": 1.0, "jitter": 0.0})
    try:
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        router.step(now=0.0)
        router.step(now=0.0)  # the injected timeout on the remote step
        assert router.replica_states()[0] == "probation" and client.rpc_stats()["timeouts"] == 1
        router.step(now=0.5)
        assert router.replica_states()[0] == "probation"
        router.step(now=1.5)
        assert router.replica_states()[0] == "healthy"
        res = router.drain()
        for i in range(2):
            np.testing.assert_array_equal(res[i].tokens, refs[i])
        assert client.idle  # the hung path's cancels reached the worker
        router.submit(Request(uid=50, prompt=prompts[0], max_new_tokens=2))
        assert router.owner_of(50) == 0
        router.drain()
    finally:
        w.stop()


def test_attach_replica_grows_fleet(engine, tmp_path):
    (p,) = _prompts([5], seed=9)
    ref = _refs(engine, [p], 4)[0]
    local = ServingEngine(engine, config={"n_slots": 2, "max_seq_len": 64}, replica_id=0)
    router = Router(config={"router": {"replicas": 1, "health": {"timeout": 30.0}}}, replica_engines=[local])
    w = _ThreadWorker(engine, tmp_path, "grow", replica_id=1)
    try:
        assert router.attach_replica(w.client(replica_id=1)) == 1
        assert router.replica_states() == {0: "healthy", 1: "healthy"}
        router.drain_replica(0, block=True)
        router.submit(Request(uid=0, prompt=p, max_new_tokens=4))
        assert router.owner_of(0) == 1
        np.testing.assert_array_equal(router.drain()[0].tokens, ref)
        assert router.telemetry_snapshot()["replicas"][1]["replica_id"] == 1
    finally:
        w.stop()


def test_jax_decode_request_of_port_frame_over_wire():
    """A JAX client's submit frame decodes into the port's Request."""
    req = JaxRequest(uid=1, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3, tenant="a")
    raw = _raw_frame(jrpc.send_frame, {"id": 1, "method": "submit", "kwargs": {"request": jrpc.encode_request(req)}})
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        frame = trpc.recv_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()
    back = trpc.decode_request(frame["kwargs"]["request"])
    assert isinstance(back, Request) and back.tenant == "a"
    np.testing.assert_array_equal(back.prompt, req.prompt)
