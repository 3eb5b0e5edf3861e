"""Port parity: the HTTP/SSE gateway (``launcher/http_gateway.py``).

The JAX ``HttpGateway`` over the JAX Router and the port's over the
port's, each over two in-process fp32 replicas at ``tests/simple_model.py``
shapes with the same weights (``interop.params_from_jax``), are sent the
same HTTP script. Status codes, JSON bodies, ``Retry-After`` and SSE event
sequences must be equal, less the fields a clock enters (``ttft_s``) and
the token count a disconnect cut. The script covers blocking and SSE
requests; 401, 403 and 429 with ``Retry-After`` from tenant auth and rate
limits; the typed rejections (``queue_full``, ``overloaded`` and the rest)
from a host-only router that raises the package's own ``RequestRejected``;
malformed requests; an idempotency-key replay and a ``Last-Event-ID``
resume; a client that resets its socket mid-stream (``cancelled``, slots
free); ``/healthz`` and the ``/metrics`` names; draining on shutdown; and
both gateway fault keys. Greedy streams are also held against
``generate``.
"""

import json
import socket
import struct
import threading
import time
import types

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference.serving import RequestResult as JaxResult
from deepspeed_tpu.launcher.http_gateway import HttpGateway as JaxGateway
from deepspeed_tpu.resilience import RequestRejected as JaxRejected
from deepspeed_tpu.runtime.config import AutoscaleConfig as JaxAutoscaleConfig
from deepspeed_tpu.telemetry import Telemetry as JaxTelemetry
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Router
from deepspeed_tpu_torch.inference.serving import RequestResult
from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import RequestRejected
from deepspeed_tpu_torch.runtime.config import AutoscaleConfig
from deepspeed_tpu_torch.telemetry import Telemetry
from simple_model import tiny_transformer

SHAPES = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
MODEL = dict(SHAPES, decode_attn="xla", pos_emb="rotary")
TOKEN = "s3cret-tenant-a"

JAX = types.SimpleNamespace(Router=JaxRouter, Gateway=JaxGateway, Rejected=JaxRejected, Result=JaxResult,
                            Telemetry=JaxTelemetry, AutoscaleConfig=JaxAutoscaleConfig, name="jax")
TORCH = types.SimpleNamespace(Router=Router, Gateway=HttpGateway, Rejected=RequestRejected, Result=RequestResult,
                              Telemetry=Telemetry, AutoscaleConfig=AutoscaleConfig, name="torch")


def _digest(token):
    import hashlib

    return hashlib.sha256(token.encode()).hexdigest()


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _router(P, eng, replicas=2, **extra):
    cfg = {"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise",
           "router": {"replicas": replicas, "health": {"timeout": 60.0}}, **extra}
    if P is JAX:
        cfg["ledger"] = {"enabled": False}
    return P.Router(eng, config=cfg)


class _Gateway:
    """A started gateway, torn down by the context manager."""

    def __init__(self, P, router, cfg=None, **kw):
        self.gw = P.Gateway(router, {"stream_poll_s": 0.005, "shutdown_grace_s": 5.0, **(cfg or {})}, **kw)

    def __enter__(self):
        self.gw.start()
        return self.gw

    def __exit__(self, *exc):
        self.gw.trigger_shutdown()
        self.gw.stop()
        self.gw.close()


def _post(gw, body, headers=None, raw_body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
    payload = raw_body if raw_body is not None else json.dumps(body)
    conn.request("POST", "/v1/generate", body=payload, headers=headers or {})
    resp = conn.getresponse()
    out = {"status": resp.status, "retry_after": resp.getheader("Retry-After"), "uid": resp.getheader("X-DSTPU-Uid")}
    if resp.getheader("Content-Type", "").startswith("application/json"):
        out["json"] = json.loads(resp.read())
        conn.close()
    else:
        out["events"] = _read_sse(resp, conn)
    return out


def _get(gw, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def _read_sse(resp, conn):
    events, buf = [], b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            ev = {}
            for line in block.splitlines():
                if line.startswith(b"event: "):
                    ev["event"] = line[7:].decode()
                elif line.startswith(b"data: "):
                    ev["data"] = json.loads(line[6:])
                elif line.startswith(b"id: "):
                    ev["id"] = int(line[4:])
            if ev:
                events.append(ev)
        if any(e.get("event") == "done" for e in events):
            break
    conn.close()
    return events


def _clockless(out):
    """A reply with the fields a clock enters dropped: ``ttft_s``."""
    out = json.loads(json.dumps(out))
    for ev in out.get("events", []):
        if ev.get("event") == "done":
            ev["data"].pop("ttft_s", None)
    if isinstance(out.get("json"), dict):
        out["json"].pop("ttft_s", None)
    return out


def _sse_socket(gw, body, timeout=30.0):
    data = json.dumps(body).encode()
    req = b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n" % len(data) + data
    s = socket.create_connection(("127.0.0.1", gw.port), timeout=timeout)
    s.sendall(req)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    return s, buf


def _rst_close(s):
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 97, size=s)] for s in (5, 11, 23)]


def _slots_free(router):
    return all(r.engine.n_active == 0 and r.engine.n_prefilling == 0 and r.engine.n_free == r.engine.n_slots
               for r in router._replicas if r.state == "healthy")


# -- the scripts: each drives one package's gateway and returns the transcript

def script_stream_and_blocking(P, eng):
    """Blocking and SSE greedy requests, an idempotency-key replay (same
    uid, never a second submit) and a Last-Event-ID resume."""
    router = _router(P, eng)
    p = _prompts()
    out = []
    with _Gateway(P, router) as gw:
        out.append(_post(gw, {"prompt": p[0], "max_new_tokens": 8, "stream": False}))
        out.append(_post(gw, {"prompt": p[1], "max_new_tokens": 8}))
        key = {"X-DSTPU-Idempotency-Key": "retry-1"}
        out.append(_post(gw, {"prompt": p[2], "max_new_tokens": 8}, headers=key))
        dispatched = router.telemetry.registry.snapshot()["counters"]["router/dispatched"]
        out.append(_post(gw, {"prompt": p[2], "max_new_tokens": 8}, headers={**key, "Last-Event-ID": "3"}))
        out.append(_post(gw, {"prompt": p[2], "max_new_tokens": 8, "stream": False}, headers=key))
        again = router.telemetry.registry.snapshot()["counters"]["router/dispatched"]
        assert again == dispatched  # replays, not submits
        # counted before each reply is written (streams_done is counted
        # after it, so a read here could race it)
        c = router.telemetry.registry.snapshot()["counters"]
        counters = {k: c.get(k) for k in ("gateway/accepted", "gateway/http_requests",
                                          "gateway/idempotent_replays", "gateway/resumed_streams")}
    return {"replies": [_clockless(o) for o in out], "counters": counters}


def script_disconnect_and_faults(P, eng):
    """A client that resets its socket mid-stream, and the two fault keys
    (uids 1 and 2 of gateway 0's band): each request ends ``cancelled``
    and every replica's slots are free again."""
    router = _router(P, eng)
    p = _prompts()
    fi = {"enabled": True, "gateway_disconnect_at": [[1, 2]], "gateway_stall_at": [[2, 3]]}
    with _Gateway(P, router, fault_injection=fi) as gw:
        cut = [_post(gw, {"prompt": p[0], "max_new_tokens": 16}), _post(gw, {"prompt": p[1], "max_new_tokens": 16})]
        s, _ = _sse_socket(gw, {"prompt": p[2], "max_new_tokens": 40})
        buf = b""
        while buf.count(b"event: token") < 2:
            buf += s.recv(4096)
        _rst_close(s)
        _wait(lambda: not router._owner and _slots_free(router))
        statuses = {u: router.result(u).status for u in (1, 2, 3)}
        counters = router.telemetry.registry.snapshot()["counters"]
    assert statuses == {1: "cancelled", 2: "cancelled", 3: "cancelled"}
    return {"cut": [[e["data"] for e in o["events"]] for o in cut], "statuses": statuses,
            "counters": {k: counters.get(k, 0) for k in (
                "gateway/cancelled_on_disconnect", "gateway/injected_faults", "gateway/stalls",
                "gateway/disconnects", "gateway/accepted")}}


class _StreamParker:
    """An ``on_tick`` hook: once armed, it parks the serve loop as soon as a
    request the fleet holds has ``after`` tokens, until ``release`` is set,
    so the stream is open, in a known state, while the test reads."""

    def __init__(self, router, after=2):
        self.router, self.after = router, after
        self.armed = False
        self.parked, self.release = threading.Event(), threading.Event()

    def __call__(self):
        if not self.armed or self.release.is_set():
            return
        for uid in list(self.router._owner):
            got = self.router.partial_result(uid)
            if got is not None and len(got[0]) >= self.after:
                self.parked.set()
                self.release.wait(timeout=30)
                return


def _counter(router, name):
    return router.telemetry.registry.snapshot()["counters"].get(name, 0)


def script_healthz_metrics_and_drain(P, eng):
    """``/healthz`` while serving, the ``/metrics`` names, then draining:
    new requests get 503 ``shutting_down``, the open stream finishes. Each
    read waits for the state it reads: ``/metrics`` for the blocking
    reply's ``gateway/streams_done`` (counted after the reply is written),
    the draining ``/healthz`` for the serve loop parked with the stream
    open."""
    router = _router(P, eng)
    p = _prompts()
    parker = _StreamParker(router)
    ctx = _Gateway(P, router, cfg={"retry_after_s": 3.0}, on_tick=parker)
    gw = ctx.__enter__()
    try:
        out = {"healthz": _get(gw, "/healthz"), "unknown": _get(gw, "/nope")}
        _post(gw, {"prompt": p[0], "max_new_tokens": 4, "stream": False})
        _wait(lambda: _counter(router, "gateway/streams_done") >= 1)
        status, ctype, text = _get(gw, "/metrics")
        out["metrics"] = (status, ctype, sorted({line.split(" ")[0].split("{")[0] for line in text.splitlines()
                                                 if line and not line.startswith("#")}))
        parker.armed = True
        s, _ = _sse_socket(gw, {"prompt": p[1], "max_new_tokens": 12})
        assert parker.parked.wait(timeout=30)
        gw.trigger_shutdown()
        out["refused"] = _post(gw, {"prompt": p[2], "max_new_tokens": 4})
        out["draining"] = _get(gw, "/healthz")
        parker.release.set()
        buf = b""
        while b"event: done" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        s.close()
        out["finished"] = b'"status": "ok"' in buf.split(b"event: done", 1)[1]
        gw._loop_thread.join(timeout=30)
        out["loop_ended"] = not gw._loop_thread.is_alive()
    finally:
        ctx.__exit__()
    assert out["finished"] and out["loop_ended"]
    return out


class _FakeRouter:
    """Host-only Router surface for the typed rejections: ``submit``
    raises the package's own ``RequestRejected`` with ``reject_with``."""

    def __init__(self, P, autoscale_cooldown=None):
        self.P = P
        self.telemetry = P.Telemetry()
        self._epoch = time.perf_counter()
        self._owner, self._results, self._tenants = {}, {}, {}
        self.reject_with = None
        self.brownout = False
        self._autoscaler = (types.SimpleNamespace(cfg=P.AutoscaleConfig(cooldown_s=autoscale_cooldown))
                            if autoscale_cooldown is not None else None)
        self.submitted = []

    def now(self):
        return time.perf_counter() - self._epoch

    def submit(self, request, idempotency_key=None):
        if self.reject_with is not None:
            raise self.P.Rejected(request.uid, self.reject_with, "fleet says no")
        if request.prompt.size > 40:
            raise ValueError("prompt plus max_new_tokens exceeds the budget")
        self.submitted.append((int(request.uid), request.tenant, int(request.priority),
                               float(request.deadline_s), int(request.max_new_tokens)))
        self._owner[request.uid] = 0
        self._results[request.uid] = self.P.Result(
            uid=request.uid, tokens=np.asarray([7, 8], np.int32), prompt_len=int(request.prompt.size),
            arrival_time=0.0, status="ok", finish_time=0.0)
        return request.uid

    def cancel(self, uid):
        return False

    def step(self, now=None, enforce_deadlines=True):
        done = list(self._owner)
        self._owner.clear()
        return done

    def partial_result(self, uid):
        res = self._results.get(uid)
        return None if res is None else (np.asarray(res.tokens, np.int32), res)

    def result(self, uid):
        return self._results.get(uid)

    def replica_states(self):
        return {0: "healthy"}

    def telemetry_snapshot(self):
        return {"router": {"metrics": self.telemetry.registry.snapshot()}, "replicas": {}}


def script_rejections_and_bad_requests(P, eng):
    """Every typed rejection's status, body and ``Retry-After`` (the
    autoscaler's cooldown), and the 400/413 of malformed requests."""
    router = _FakeRouter(P, autoscale_cooldown=7.0)
    out = {}
    with _Gateway(P, router, cfg={"max_body_bytes": 200}) as gw:
        for reason in ("queue_full", "overloaded", "tenant_quota", "forbidden", "no_healthy_replicas",
                       "shutting_down", "journal_unavailable", "something_new"):
            router.reject_with = reason
            out[reason] = _post(gw, {"prompt": [1, 2, 3]})
        router.reject_with = None
        bad = {"no_body": dict(raw_body=""), "not_json": dict(raw_body="{nope"),
               "not_object": dict(body=[1, 2]), "empty_prompt": dict(body={"prompt": []}),
               "float_prompt": dict(body={"prompt": [1.5]}), "too_big": dict(body={"prompt": list(range(80))}),
               "budget": dict(body={"prompt": list(range(41))}),
               "bad_field": dict(body={"prompt": [1], "max_new_tokens": "many"}),
               "bad_priority": dict(body={"prompt": [1]}, headers={"X-DSTPU-Priority": "high"}),
               "control_key": dict(body={"prompt": [1]}, headers={"X-DSTPU-Idempotency-Key": "a\tb"}),
               "bad_event_id": dict(body={"prompt": [1]}, headers={"Last-Event-ID": "x"}),
               "negative_event_id": dict(body={"prompt": [1]}, headers={"Last-Event-ID": "-5"})}
        for name, kw in bad.items():
            out[name] = _post(gw, kw.get("body"), headers=kw.get("headers"), raw_body=kw.get("raw_body"))
        out["headers"] = _post(gw, {"prompt": [1, 2], "max_new_tokens": 5, "stream": False},
                               headers={"X-DSTPU-Priority": "3", "X-DSTPU-Deadline-S": "2.5"})
    out["submitted"] = router.submitted
    return {k: _clockless(v) if isinstance(v, dict) else v for k, v in out.items()}


def script_tenant_auth_and_rate_limit(P, eng):
    """Bearer auth and the per-tenant token bucket: 401, 403, 200 and 429
    with the tenant's ``Retry-After``; the proven tenant rides the
    request."""
    router = _FakeRouter(P)
    auth = {"enabled": True, "tenants": {"a": {"token_sha256": _digest(TOKEN), "rate_rps": 0.01, "burst": 1},
                                          "b": {"token_sha256": _digest("other-b")}}}
    out = {}
    with _Gateway(P, router, cfg={"auth": auth}) as gw:
        out["missing"] = _post(gw, {"prompt": [1]})
        out["malformed"] = _post(gw, {"prompt": [1]}, headers={"Authorization": "Token x"})
        out["unknown"] = _post(gw, {"prompt": [1]}, headers={"Authorization": "Bearer nobody"})
        out["ok"] = _post(gw, {"prompt": [1], "stream": False}, headers={"Authorization": f"Bearer {TOKEN}"})
        out["limited"] = _post(gw, {"prompt": [1]}, headers={"Authorization": f"Bearer {TOKEN}"})
        out["other"] = _post(gw, {"prompt": [1], "stream": False}, headers={"Authorization": "Bearer other-b"})
        out["healthz_open"] = _get(gw, "/healthz")
        counters = {k: v for k, v in router.telemetry.registry.snapshot()["counters"].items()
                    if k.startswith(("gateway/auth", "gateway/rate", "tenant/"))}
    out["submitted"], out["counters"] = router.submitted, counters
    assert out["limited"]["status"] == 429 and out["missing"]["status"] == 401
    return {k: _clockless(v) if isinstance(v, dict) else v for k, v in out.items()}


SCRIPTS = {name[len("script_"):]: fn for name, fn in dict(globals()).items() if name.startswith("script_")}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_gateway_matches_jax(engines, script):
    tout = SCRIPTS[script](TORCH, engines["torch"])
    jout = SCRIPTS[script](JAX, engines["jax"])
    assert tout == jout


def test_sse_greedy_tokens_equal_generate(engines):
    """The streamed tokens of the first script equal the port's
    ``generate`` and the JAX engine's, token for token."""
    out = script_stream_and_blocking(TORCH, engines["torch"])
    p = _prompts()
    for reply, prompt in zip(out["replies"][:3], p):
        ref = engines["torch"].generate(np.asarray([prompt], np.int32), max_new_tokens=8)[0]
        jref = engines["jax"].generate(np.asarray([prompt], np.int32), max_new_tokens=8)[0]
        got = reply["json"]["tokens"] if "json" in reply else [e["data"]["token"] for e in reply["events"]
                                                               if e["event"] == "token"]
        assert got == [int(t) for t in ref] == [int(t) for t in np.asarray(jref)]
    resumed = out["replies"][3]["events"]
    assert [e["id"] for e in resumed if e["event"] == "token"] == list(range(4, 8))


def test_gateway_streams_while_a_newcomer_joins(engines):
    """An in-process rolling upgrade under a live SSE stream through the
    port's gateway: the stream's tokens equal a run without the upgrade,
    the newcomers are built and warmed on the serve-loop thread (the one
    thread that touches the engines), and the new generation serves."""
    import threading

    router = _router(TORCH, engines["torch"])
    p = _prompts()
    built_on = []
    spawn = router._spawn_inprocess

    def recording_spawn():
        built_on.append(threading.current_thread().name)
        return spawn()

    router._spawn_inprocess = recording_spawn
    go = threading.Event()

    def on_tick():  # membership changes on the loop thread, like a drill's
        if go.is_set() and router.upgrade_status() is None:
            router.rolling_upgrade()

    with _Gateway(TORCH, router, on_tick=on_tick) as gw:
        base = _post(gw, {"prompt": p[2], "max_new_tokens": 12})
        s, _ = _sse_socket(gw, {"prompt": p[2], "max_new_tokens": 12})
        go.set()
        _wait(lambda: router.upgrade_status() is not None)
        buf = b""
        while b"event: done" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        s.close()
        _wait(lambda: router.upgrade_status()["state"] != "running", timeout=60)
        after = _post(gw, {"prompt": p[2], "max_new_tokens": 12})
    done = [json.loads(line[6:]) for block in buf.split(b"\n\n") for line in block.splitlines()
            if b"event: done" in block and line.startswith(b"data: ")][0]
    ref = [e["data"]["token"] for e in base["events"] if e["event"] == "token"]
    assert done["status"] == "ok" and done["tokens"] == ref
    assert [e["data"]["token"] for e in after["events"] if e["event"] == "token"] == ref
    assert router.upgrade_status()["state"] == "done"
    assert built_on and all(name.startswith("dstt-gw-loop") for name in built_on)
