"""Port parity: disaggregated prefill/decode serving.

The JAX ``Router`` and the port's, each over in-process replicas of one
fp32 model at ``tests/simple_model.py`` shapes with the same weights
(``interop.params_from_jax``), split into a PREFILL pool and a DECODE pool
(``router.disagg``), are driven through the same script. The KV window
codec (``rpc.encode_kv_window``) must give JAX's bytes for fp32 and bf16
windows, raw and int8, and need neither ``jax`` nor ``ml_dtypes`` for bf16.
The fleets must give equal greedy tokens (and equal to the port's
co-located fleet), equal ``router_stats()`` and ``router/*`` counters, and
equal program sets (prefill replicas never build a decode program, decode
replicas never a prefill one, one KV program per side for the one
handoff width), with speculation off and on. JAX's failover matrix
(``tests/test_disagg.py``): the prefill dead mid-transfer replays from
scratch exactly once, the decode dead before commit is no failover, the
decode dead after commit fails over through the prefill's prefix cache,
and a TCP reset in the middle of the KV stream is absorbed by the
replay-safe retry. Per-pool autoscaling and the int8 wire end to end, the
engines' handoff surface, the invariant oracles against JAX's on the same
artifacts, and real ``--role`` worker processes over TCP with bf16 windows.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference import rpc as jrpc
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.launcher.serving_worker import WorkerHost as JaxWorkerHost
from deepspeed_tpu.resilience import RequestRejected as JaxRejected
from deepspeed_tpu.resilience import RpcConnectionLost as JaxLost
from deepspeed_tpu.resilience import invariants as jinv
from deepspeed_tpu.runtime.config import RouterTransportConfig as JaxTransport
from deepspeed_tpu.telemetry import request_timeline as jax_timeline
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import rpc as trpc
from deepspeed_tpu_torch.launcher.serving_worker import WorkerHost, WorkerSupervisor, build_serving_engine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import RequestRejected, RpcConnectionLost
from deepspeed_tpu_torch.resilience import invariants as tinv
from deepspeed_tpu_torch.runtime.config import RouterTransportConfig
from deepspeed_tpu_torch.telemetry import request_timeline
from simple_model import tiny_transformer

REPO = str(pathlib.Path(__file__).resolve().parents[1])
SHAPES = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
MODEL = dict(SHAPES, decode_attn="xla", pos_emb="rotary")
# the JAX disagg tests' serving matrix at these shapes: chunked prefill, the
# prefix cache and request tracing, under watchdog raise
MATRIX = {
    "n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise",
    "chunked_prefill": {"enabled": True, "chunk_size": 16},
    "prefix_cache": {"enabled": True, "n_slots": 4, "block": 8, "max_prefix_len": 64,
                     "insert_policy": "always"},
    "request_trace": {"enabled": True},
}
SPECULATION = {"enabled": True, "depth": 4, "ngram_min_match": 2}
TRANSPORT = dict(call_timeout_s=60.0, connect_attempts=2, base_delay_s=0.05, max_delay_s=0.1, jitter=0.0)

JAX = types.SimpleNamespace(Router=JaxRouter, Request=JaxRequest, Lost=JaxLost, Rejected=JaxRejected,
                            ServingEngine=JaxServingEngine, WorkerHost=JaxWorkerHost, rpc=jrpc,
                            Transport=JaxTransport, timeline=jax_timeline, name="jax")
TORCH = types.SimpleNamespace(Router=Router, Request=Request, Lost=RpcConnectionLost, Rejected=RequestRejected,
                              ServingEngine=ServingEngine, WorkerHost=WorkerHost, rpc=trpc,
                              Transport=RouterTransportConfig, timeline=request_timeline, name="torch")


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _cfg(P, extra=None, router=None, **kw):
    cfg = {**MATRIX, **kw, "router": router or {}}
    if extra:
        cfg.update(extra)
    if P is JAX:
        cfg["ledger"] = {"enabled": False}
    return cfg


def _disagg(P, eng, prefill=2, decode=2, disagg=None, router=None, **kw):
    dg = {"enabled": True, "prefill_replicas": prefill, "decode_replicas": decode, **(disagg or {})}
    return P.Router(eng, config=_cfg(P, router={"disagg": dg, **(router or {})}, **kw))


def _prompts(sizes, seed=7, vocab=97):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=s).astype(np.int32) for s in sizes]


def _pools(router):
    st = router.router_stats()
    return ([r for r, rep in sorted(st["replicas"].items()) if rep["role"] == "prefill"],
            [r for r, rep in sorted(st["replicas"].items()) if rep["role"] == "decode"])


def _finish(router):
    res = {u: (r.status, [int(t) for t in r.tokens]) for u, r in router.results.items()}
    counters = {k: v for k, v in router.telemetry.registry.snapshot()["counters"].items()
                if k.startswith(("router/", "resilience/"))}
    programs = {}
    for r in router._replicas:
        cc = r.engine.compile_counts()
        programs[r.rid] = {k: cc.get(k) for k in ("decode", "prefill", "chunk_prefill", "kv_export",
                                                  "kv_import", "verify")}
    return {"results": res, "stats": router.router_stats(), "counters": counters, "programs": programs}


def _assert_same(jout, tout):
    assert tout["results"] == jout["results"]
    assert tout["stats"] == jout["stats"]
    assert tout["counters"] == jout["counters"]
    for key in ("programs", "timeline", "extra"):
        if key in jout:
            assert tout[key] == jout[key], key


# -- the KV window codec ------------------------------------------------------


def _window(seed, dtype, shape=(2, 1, 64, 4, 16)):
    """One (k, v) window as the JAX package holds it (numpy, ml_dtypes bf16)
    and as the port does (host tensors with the same bits)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal(shape).astype(np.float32) * 3 for _ in range(2))
    if dtype == "float32":
        return (k, v), (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    jk, jv = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return (jk, jv), tuple(torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) for a in (jk, jv))


def _bits(a):
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("comp", ["none", "int8"])
def test_kv_window_codec_bytes_equal_jax(dtype, comp):
    """``encode_kv_window`` gives JAX's frame byte for byte (the scale in
    double, the division in float32, round half to even), and so does
    ``kv_window_nbytes``; both decoders give the same bits back, before and
    after a real frame round trip."""
    for seed in range(3):
        (jk, jv), (tk, tv) = _window(seed, dtype)
        jenc, tenc = jrpc.encode_kv_window(jk, jv, comp), trpc.encode_kv_window(tk, tv, comp)
        assert json.dumps(tenc) == json.dumps(jenc)
        assert trpc.kv_window_nbytes(tenc) == jrpc.kv_window_nbytes(jenc)
        wire = json.loads(json.dumps(trpc._enc_value(tenc)))
        jdec = jrpc.decode_kv_window(jrpc._dec_value(wire))
        tdec = trpc.decode_kv_window(trpc._dec_value(wire))
        assert trpc.kv_window_nbytes(trpc._dec_value(wire)) == jrpc.kv_window_nbytes(jrpc._dec_value(wire))
        for a, b in zip(jdec, tdec):
            assert _bits(b) == _bits(a)
            if dtype == "bfloat16":
                assert b.dtype == torch.bfloat16
        if comp == "none":
            assert _bits(tdec[0]) == _bits(tk)


_NO_ML_DTYPES = r"""
import json, socket, sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
sys.modules["deepspeed_tpu"] = None
import numpy as np, torch
from deepspeed_tpu_torch.inference import rpc
expected = json.load(open(sys.argv[1]))
for case in expected:
    k, v = (torch.frombuffer(bytearray(bytes.fromhex(h)), dtype=torch.bfloat16).reshape(case["shape"])
            for h in (case["k"], case["v"]))
    enc = rpc.encode_kv_window(k, v, case["comp"])
    assert json.dumps(enc) == case["frame"], case["comp"]
    assert list(rpc.kv_window_nbytes(enc)) == case["nbytes"]
    a, b = socket.socketpair()
    rpc.send_frame(a, {"window": enc})
    got = rpc.recv_frame(b, 10.0)["window"]
    dk, dv = rpc.decode_kv_window(got)
    assert dk.dtype == torch.bfloat16 and list(dk.shape) == case["shape"]
    assert dk.view(torch.int16).numpy().tobytes().hex() == case["dk"]
    assert dv.view(torch.int16).numpy().tobytes().hex() == case["dv"]
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok", len(expected))
"""


def test_bf16_window_codec_needs_neither_jax_nor_ml_dtypes(tmp_path):
    """In a process where ``jax`` and ``ml_dtypes`` cannot be imported, a
    bf16 window still encodes to JAX's frame (raw and int8), crosses a
    real DSRP frame and decodes to the bits JAX decodes."""
    cases = []
    for seed, comp in ((0, "none"), (1, "int8")):
        (jk, jv), _ = _window(seed, "bfloat16")
        enc = jrpc.encode_kv_window(jk, jv, comp)
        dk, dv = jrpc.decode_kv_window(jrpc._dec_value(json.loads(json.dumps(enc))))
        cases.append({"comp": comp, "shape": list(jk.shape), "k": _bits(jk).hex(), "v": _bits(jv).hex(),
                      "frame": json.dumps(enc), "nbytes": list(jrpc.kv_window_nbytes(enc)),
                      "dk": _bits(dk).hex(), "dv": _bits(dv).hex()})
    path = tmp_path / "expected.json"
    path.write_text(json.dumps(cases))
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 2")


def test_kv_wire_int8_roundtrip_tolerance():
    """JAX's documented int8 tolerance holds for the port's codec: the
    per-element error is at most absmax/254, the wire a quarter of fp32
    (half of bf16), and the raw codec round-trips bitwise."""
    for dtype, ratio in (("float32", 4), ("bfloat16", 2)):
        _, (k, v) = _window(0, dtype)
        enc = trpc.encode_kv_window(k, v, "int8")
        dk, dv = trpc.decode_kv_window(enc)
        for orig, back in ((k, dk), (v, dv)):
            orig, back = torch.as_tensor(orig).float().numpy(), torch.as_tensor(back).float().numpy()
            tol = float(np.max(np.abs(orig))) / 127.0 * 0.5001
            if dtype == "bfloat16":
                tol += float(np.max(np.abs(orig))) * 2.0 ** -8  # the rounding back to bf16
            assert float(np.max(np.abs(orig - back))) <= tol
        wire, raw = trpc.kv_window_nbytes(enc)
        assert raw == ratio * wire
        rk, _ = trpc.decode_kv_window(trpc.encode_kv_window(k, v, "none"))
        assert _bits(rk) == _bits(k)


# -- fleets: parity and programs ---------------------------------------------


def case_parity(P, eng, speculation=False):
    extra = {"speculation": SPECULATION} if speculation else {}
    prompts = _prompts((9, 23, 41, 17, 30, 12))
    r = _disagg(P, eng, **extra)
    for i, p in enumerate(prompts):
        r.submit(P.Request(uid=100 + i, prompt=p, max_new_tokens=12))
    r.drain()
    out = _finish(r)
    # a second wave reuses every program of the handoff path
    for i, p in enumerate(prompts[:3]):
        r.submit(P.Request(uid=200 + i, prompt=p, max_new_tokens=12))
    r.drain()
    out["extra"] = {"second": _finish(r)}
    out["tokens"] = {u: t for u, (_, t) in out["extra"]["second"]["results"].items()}
    return out


@pytest.mark.parametrize("speculation", [False, True], ids=["spec_off", "spec_on"])
def test_disagg_fleet_matches_jax_and_colocated(engines, speculation):
    jout = case_parity(JAX, engines["jax"], speculation)
    tout = case_parity(TORCH, engines["torch"], speculation)
    _assert_same(jout, tout)
    st = tout["stats"]
    assert st["disagg"]["handoffs"] == 6 and st["disagg"]["parked_backlog"] == 0
    pre, dec = [0, 1], [2, 3]
    assert all(st["replicas"][r]["completed"] == 0 for r in pre)
    for r in pre:
        p = tout["programs"][r]
        assert p["decode"] == 0 and p["kv_import"] is None and p["kv_export"] == {64: 1} and not p["verify"]
    for r in dec:
        p = tout["programs"][r]
        assert p["decode"] == 1 and p["kv_export"] is None and p["kv_import"] == {64: 1}
        assert not p["prefill"] and p["chunk_prefill"] is None
        assert all(n <= 2 for n in (p["verify"] or {}).values())
    # the port's co-located fleet gives the same greedy streams
    extra = {"speculation": SPECULATION} if speculation else {}
    base = Router(engines["torch"], config=_cfg(TORCH, router={"replicas": 1}, **extra))
    prompts = _prompts((9, 23, 41, 17, 30, 12))
    for i, p in enumerate(prompts):
        base.submit(Request(uid=i, prompt=p, max_new_tokens=12))
    ref = base.drain()
    for i in range(6):
        assert ref[i].ok and tout["tokens"][100 + i] == [int(t) for t in ref[i].tokens]


# -- the failover matrix --------------------------------------------------------


def _gone(P, what):
    def raiser(*a, **kw):
        raise P.Lost(f"injected: {what}")
    return raiser


def case_prefill_dead_mid_transfer(P, eng):
    r = _disagg(P, eng, prefill=2, decode=1)
    r.submit(P.Request(uid=0, prompt=_prompts((23,), seed=3)[0], max_new_tokens=12))
    victim = r.owner_of(0)
    r._replicas[victim].engine.kv_export_window = _gone(P, "prefill died mid-transfer")
    r.drain()
    out = _finish(r)
    out["programs"] = {k: v for k, v in out["programs"].items() if k != victim}
    events = P.timeline(r.telemetry_snapshot(), 0)
    out["timeline"] = [e["event"] for e in events if e["event"].startswith(("kv_handoff", "failover"))]
    out["extra"] = {"victim": victim, "states": r.replica_states()}
    return out


def case_decode_dead_pre_commit(P, eng):
    r = _disagg(P, eng, prefill=1, decode=2)
    victim = _pools(r)[1][0]
    r._replicas[victim].engine.kv_import_window = _gone(P, "decode died pre-commit")
    r.submit(P.Request(uid=0, prompt=_prompts((30,), seed=5)[0], max_new_tokens=12))
    r.drain()
    out = _finish(r)
    out["programs"] = {k: v for k, v in out["programs"].items() if k != victim}
    out["extra"] = {"victim": victim, "states": r.replica_states(), "failovers": r._failovers.get(0, 0)}
    return out


def case_decode_dead_post_commit(P, eng):
    r = _disagg(P, eng, prefill=1, decode=2)
    pre, dec = _pools(r)
    r.submit(P.Request(uid=0, prompt=_prompts((32,), seed=9)[0], max_new_tokens=12))
    for _ in range(300):
        if r.owner_of(0) in dec:
            break
        r.step(now=float("inf"), enforce_deadlines=False)
    victim = r.owner_of(0)
    r.mark_dead(victim)
    r.drain()
    out = _finish(r)
    out["programs"] = {k: v for k, v in out["programs"].items() if k != victim}
    out["extra"] = {"victim": victim, "prefix_hits": r._replicas[pre[0]].engine.prefix_cache_stats()["hits"]}
    return out


@pytest.mark.parametrize("case", [case_prefill_dead_mid_transfer, case_decode_dead_pre_commit,
                                  case_decode_dead_post_commit],
                         ids=["prefill_dead_mid_transfer", "decode_dead_pre_commit", "decode_dead_post_commit"])
def test_handoff_failover_matrix_matches_jax(engines, case):
    jout, tout = case(JAX, engines["jax"]), case(TORCH, engines["torch"])
    _assert_same(jout, tout)
    st, res = tout["stats"], tout["results"]
    assert res[0][0] == "ok"
    if case is case_prefill_dead_mid_transfer:
        # the aborted attempt and the clean retry; one recovered failover
        assert tout["timeline"].count("kv_handoff_started") == 2
        assert tout["timeline"].count("kv_handoff_done") == 1 and "failover" in tout["timeline"]
        assert st["failovers_recovered"] == 1 and st["disagg"]["handoffs"] == 1
        assert tout["extra"]["states"][tout["extra"]["victim"]] == "dead"
    elif case is case_decode_dead_pre_commit:
        # never owned it: no failover burned
        assert tout["extra"]["failovers"] == 0 and st["failovers_recovered"] == 0
        assert tout["counters"].get("router/failovers", 0) == 0 and st["disagg"]["handoffs"] == 1
    else:
        # a failover whose replay hits the prefill's prefix pool
        assert st["failovers_recovered"] == 1 and st["disagg"]["handoffs"] == 2
        assert tout["extra"]["prefix_hits"] >= 1


class _RoleWorker:
    """A role-pinned engine behind a real RpcServer in a thread (either
    package): the disaggregated worker's transport without a process."""

    def __init__(self, P, eng, role, replica_id):
        self.engine = P.ServingEngine(eng, config=_cfg(P), replica_id=replica_id, role=role)
        self.host = P.WorkerHost(self.engine)
        self.server = P.rpc.RpcServer("tcp://127.0.0.1:0", self.host.handlers())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        kwargs={"should_stop": self._stop.is_set}, daemon=True)
        self._thread.start()

    def client(self, P, **kw):
        return P.rpc.ReplicaClient(self.server.address, transport=P.Transport(**TRANSPORT), **kw)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.server.close()


def case_rst_on_kv_stream(P, eng):
    pre_w, dec_w = _RoleWorker(P, eng, "prefill", 0), _RoleWorker(P, eng, "decode", 1)
    try:
        dec_c = dec_w.client(P, replica_id=1, fault_injection={
            "enabled": True, "seed": 0, "rpc_conn_reset_at": [["kv_import_window", 1]]})
        r = P.Router(config={"router": {"replicas": 2, "health": {"timeout": 60.0}, "disagg": {"enabled": True}}},
                     replica_engines=[pre_w.client(P, replica_id=0), dec_c])
        pools = _pools(r)
        for i, p in enumerate(_prompts((9, 23), seed=17)):
            r.submit(P.Request(uid=i, prompt=p, max_new_tokens=8))
        r.drain()
        out = _finish(r)
        del out["programs"]
        rs = dec_c.rpc_stats()
        out["extra"] = {"pools": pools, "states": r.replica_states(),
                        "reset_retried": rs["conn_resets"] >= 1 and rs["retries"] >= 1}
        return out
    finally:
        pre_w.stop()
        dec_w.stop()


def test_rst_in_the_kv_stream_is_absorbed_like_jax(engines):
    """A linger-0 TCP reset loses a ``kv_import_window`` reply after the
    worker applied it; the replay-safe retry re-sends the idempotent
    window and the handoff commits: no verdict, no failover, JAX's
    tokens."""
    jout, tout = case_rst_on_kv_stream(JAX, engines["jax"]), case_rst_on_kv_stream(TORCH, engines["torch"])
    _assert_same(jout, tout)
    assert tout["extra"] == {"pools": ([0], [1]), "states": {0: "healthy", 1: "healthy"}, "reset_retried": True}
    assert tout["stats"]["disagg"]["handoffs"] == 2 and tout["counters"].get("router/failovers", 0) == 0


# -- per-pool autoscaling and the int8 wire ----------------------------------


def case_per_pool_autoscaling(P, eng):
    r = P.Router(eng, config=_cfg(P, router={
        "disagg": {"enabled": True, "prefill_replicas": 1, "decode_replicas": 1, "prefill_max_replicas": 2,
                   "decode_max_replicas": 2, "prefill_scale_up_queue": 3, "prefill_scale_up_backlog": 3,
                   "decode_scale_up_occupancy": 0.75},
        "autoscale": {"enabled": True, "min_replicas": 1, "max_replicas": 4, "up_consecutive": 2,
                      "down_consecutive": 2, "cooldown_s": 0.0}}))
    rng = np.random.default_rng(3)
    for i in range(8):
        r.submit(P.Request(uid=i, prompt=rng.integers(1, 97, size=20 + i).astype(np.int32), max_new_tokens=16))
    t = 0.0
    while r._owner:
        t += 1.0
        r.step(now=t, enforce_deadlines=False)
    for _ in range(30):  # idle ticks drive the per-pool scale-down
        t += 1.0
        r.step(now=t)
    out = _finish(r)
    asc = r._autoscaler.describe()
    out["extra"] = {"moves": [(e["kind"], e.get("pool"), e.get("rid")) for e in asc["events"]],
                    "pools": asc["pools"], "target": asc["target"],
                    "gauges": {k: v for k, v in r.telemetry.registry.snapshot()["gauges"].items()
                               if k.endswith("_target_replicas")}}
    return out


def test_per_pool_autoscaling_matches_jax(engines):
    """Each pool scales on its own signals (the prefill pool on its queue,
    the decode pool on occupancy and parked handoffs) and both return to
    their floors: the same decisions, pools and gauges as JAX."""
    jout = case_per_pool_autoscaling(JAX, engines["jax"])
    tout = case_per_pool_autoscaling(TORCH, engines["torch"])
    _assert_same(jout, tout)
    moves = tout["extra"]["moves"]
    assert any(p == "prefill" for k, p, _ in moves if k.startswith("scale_up"))
    assert any(p == "decode" for k, p, _ in moves if k.startswith("scale_up"))
    assert tout["extra"]["pools"]["prefill"]["target"] == 1 and tout["extra"]["pools"]["decode"]["target"] == 1
    assert all(s == "ok" for s, _ in tout["results"].values())


def case_int8_wire(P, eng):
    r = _disagg(P, eng, prefill=1, decode=1, disagg={"kv_compression": "int8"})
    for i, p in enumerate(_prompts((9, 23), seed=13)):
        r.submit(P.Request(uid=i, prompt=p, max_new_tokens=8))
    r.drain()
    return _finish(r)


def test_int8_wire_end_to_end_matches_jax(engines):
    """``kv_compression: int8``: both packages quantize to the same bytes
    and import the same dequantized KV, so the fleets agree token for
    token and count the same bytes saved (3/4 of fp32's)."""
    jout, tout = case_int8_wire(JAX, engines["jax"]), case_int8_wire(TORCH, engines["torch"])
    _assert_same(jout, tout)
    assert all(s == "ok" and len(t) >= 1 for s, t in tout["results"].values())
    assert tout["stats"]["disagg"]["handoffs"] == 2 and tout["counters"]["router/disagg/kv_bytes_saved"] > 0


# -- the engines' handoff surface -------------------------------------------


def case_engine_surface(P, eng):
    pre = P.ServingEngine(eng, config=_cfg(P, n_slots=3), replica_id=0, role="prefill")
    dec = P.ServingEngine(eng, config=_cfg(P), replica_id=1, role="decode")
    log = []
    prompts = _prompts((9, 20, 5))
    for i, p in enumerate(prompts[:2]):
        pre.submit(P.Request(uid=i, prompt=p, max_new_tokens=6, deadline_s=50.0 if i else 0.0))
    # a request that finishes at its first token completes on the prefill side
    pre.submit(P.Request(uid=2, prompt=prompts[2], max_new_tokens=1))
    t = 0.0
    while pre._queue or pre._prefilling:
        log.append(("pre_step", pre.step(now=t)))
        t += 0.01
    ready = pre.handoff_ready()
    log.append(("ready", [(h["uid"], h["pos"], h["first"]) for h in ready]))
    log.append(("pre_view", pre.load, pre.idle, [q.uid for q in pre.live_requests()],
                [int(x) for x in pre.partial_tokens(0)], pre.result(2).status))
    h = ready[0]
    slot = dec.kv_import_begin(pre._handoffs[0].req, h["pos"], h["first"], prefix_hit_tokens=h["prefix_hit_tokens"])
    log.append(("begin", slot, dec.kv_import_begin(pre._handoffs[0].req, h["pos"], h["first"]), dec.occupancy,
                dec.load, dec.idle))
    for start in range(0, 64, 64):
        dec.kv_import_window(0, start, 64, *pre.kv_export_window(0, start, 64))
    log.append(("commit", dec.kv_import_commit(0), dec.kv_import_commit(0), dec.kv_import_commit(99)))
    log.append(("release", pre.handoff_release(0), pre.handoff_release(0)))
    while not dec.idle:
        log.append(("dec_step", dec.step(now=t)))
        t += 0.01
    log.append(("tokens", [int(x) for x in dec.result(0).tokens]))
    # a staged import and a parked handoff: cancel each, then a deadline
    dec.kv_import_begin(pre._handoffs[1].req, 20, 1)
    log.append(("abort", dec.kv_import_abort(1), dec.kv_import_abort(1)))
    dec.kv_import_begin(pre._handoffs[1].req, 20, 1)
    log.append(("cancel_import", dec.cancel(1), dec.result(1).status))
    log.append(("bad_window", _raises(lambda: pre.kv_export_window(1, 3, 64)),
                _raises(lambda: pre.kv_export_window(1, 0, 48)), _raises(lambda: pre.kv_export_window(7, 0, 64))))
    log.append(("deadline", pre.step(now=100.0), pre.result(1).status, pre.n_free, pre.idle))
    return {"log": log, "counters": {k: v for k, v in pre.telemetry.registry.snapshot()["counters"].items()
                                     if k.startswith(("serving/handoff", "serving/kv_", "resilience/"))},
            "dec_counters": {k: v for k, v in dec.telemetry.registry.snapshot()["counters"].items()
                             if k.startswith(("serving/kv_", "resilience/"))}}


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def test_engine_handoff_surface_matches_jax(engines):
    """Parking (a request done at its first token completes locally),
    ``handoff_ready``, load/idle/occupancy/live requests, replay-tolerant
    begin/commit/release/abort, cancels of a staged import, window checks
    and the deadline sweep of a parked handoff: step for step JAX's."""
    jout, tout = case_engine_surface(JAX, engines["jax"]), case_engine_surface(TORCH, engines["torch"])
    assert tout == jout
    assert tout["dec_counters"]["serving/kv_import_bucket[64]"] == 1


def test_kv_import_writes_into_the_captured_cache(engines):
    """The import copies into the slot cache the decode step reads (never a
    new tensor), so the next decode step reads the imported KV."""
    eng = engines["torch"]
    dec = ServingEngine(eng, config=_cfg(TORCH), role="decode")
    cache = dec.worker._cache
    ptrs = {kv: cache[kv].data_ptr() for kv in ("k", "v")}
    k = torch.full((2, 1, 64, 4, 16), 0.5)
    dec.kv_import_begin(Request(uid=5, prompt=np.arange(7, dtype=np.int32), max_new_tokens=3), 7, 1)
    dec.kv_import_window(5, 0, 64, k, k * 2)
    slot = dec._imports[5]["slot"]
    assert dec.worker._cache is cache and {kv: cache[kv].data_ptr() for kv in ("k", "v")} == ptrs
    assert torch.equal(cache["k"][:, slot, :64], k[:, 0]) and torch.equal(cache["v"][:, slot, :64], k[:, 0] * 2)
    assert dec.compile_counts()["kv_import"] == {64: 1}


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_prefill_and_decode_roles_build_programs_of_their_own_side(engines, role):
    """A prefill replica's warm-up builds nothing (it never decodes); a
    decode replica's builds the decode program."""
    srv = ServingEngine(engines["torch"], config=_cfg(TORCH), role=role)
    srv.warm_decode()
    assert srv.compile_counts()["decode"] == (0 if role == "prefill" else 1)
    assert srv.worker.graph_launches == (0, 0)


# -- the invariant oracles ------------------------------------------------------


def _artifacts():
    R = types.SimpleNamespace
    results = {0: R(status="ok", tokens=[1, 2, 3]), 1: R(status="failed_replica", tokens=[]),
               2: R(status="ok", tokens=[4, 5]), 9: R(status="ok", tokens=[7])}
    ref = {0: [1, 2, 3], 1: [9], 2: [4, 6], 3: [1]}
    views = [{"name": "a", "n_active": 1, "n_prefilling": 0, "queue_len": 2, "load": 3, "n_free": 2,
              "n_slots": 4, "quarantined": 1, "prefix_refs": [{"len": 8, "refs": 1}]},
             {"name": "b", "n_active": 0, "n_prefilling": 0, "queue_len": 0, "load": 0, "n_free": 4,
              "n_slots": 4, "quarantined": 0}]
    stats = {"failovers_recovered": 1, "replicas": {0: {"state": "dead", "failed_over": 3},
                                                     1: {"state": "healthy", "failed_over": 0}}}
    return results, ref, views, stats


def test_invariant_oracles_give_jax_violations():
    """Every oracle, on clean and on faulted artifacts, returns the same
    violations as JAX's (and ``check`` raises on the same lists)."""
    results, ref, views, stats = _artifacts()

    def calls(inv):
        out = [inv.zero_accepted_loss([0, 1, 2, 3], results),
               inv.zero_accepted_loss([0, 2], results),
               inv.terminal_uid_conservation([0, 1, 2], results, rejected=[9]),
               inv.terminal_uid_conservation([0, 1, 2, 9], results),
               inv.bitwise_parity_vs_reference(results, ref),
               inv.bitwise_parity_vs_reference(results, ref, uids=[0]),
               inv.occupancy_drained(views),
               inv.occupancy_drained(views[1:]),
               inv.exactly_once_failover(stats, min_recovered=2),
               inv.exactly_once_failover(stats, min_recovered=1),
               inv.single_decode_program({"decode": 2}),
               inv.single_decode_program({"decode": 1}),
               inv.no_raw_secret_in_artifacts({"log": "token s3cr3t here", "j": b"nothing"}, ["s3cr3t"]),
               inv.no_raw_secret_in_artifacts({"log": "clean"}, ["s3cr3t"])]
        return [[(v.invariant, v.message, v.details) for v in vs] for vs in out]

    assert calls(tinv) == calls(jinv)
    assert any(calls(tinv)) and not all(calls(tinv))
    with pytest.raises(tinv.InvariantViolation) as te:
        tinv.check(tinv.zero_accepted_loss([0, 3], results))
    with pytest.raises(jinv.InvariantViolation) as je:
        jinv.check(jinv.zero_accepted_loss([0, 3], results))
    assert str(te.value) == str(je.value)
    tinv.check([])


def test_occupancy_view_of_a_port_engine_matches_jax(engines):
    views = []
    for P, eng in ((JAX, engines["jax"]), (TORCH, engines["torch"])):
        srv = P.ServingEngine(eng, config=_cfg(P), role="prefill")
        srv.submit(P.Request(uid=0, prompt=_prompts((9,))[0], max_new_tokens=4))
        srv.step(now=0.0)
        views.append((jinv if P is JAX else tinv).occupancy_view(srv, name="pre"))
    assert views[1] == views[0]


# -- real --role worker processes over TCP, bf16 windows -----------------------


def test_role_workers_over_tcp_carry_bf16_windows(tmp_path):
    """A prefill-role and a decode-role worker process (``--role``, one bf16
    spec, ``--device cpu``) behind a Router over TCP: every request crosses
    the process boundary as bf16 windows (the Router relays the frames
    without decoding them), the prefill worker completes nothing and
    builds no decode program, and the greedy streams equal a co-located
    in-process engine's on the same spec."""
    spec = {"model": {**MODEL, "dtype": "bfloat16"}, "engine_dtype": "bf16",
            "serving": {"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise"}}
    transport = RouterTransportConfig(call_timeout_s=120.0, boot_timeout_s=120.0, heartbeat_timeout_s=30.0,
                                      base_delay_s=0.05, max_delay_s=0.2, jitter=0.0, family="tcp",
                                      host="127.0.0.1", port_base=0)
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    sup = WorkerSupervisor(spec, 2, transport=transport, roles={0: "prefill", 1: "decode"}, device="cpu",
                           workdir=str(tmp_path), env=env)
    try:
        clients = sup.start()
        assert [c.role for c in clients] == ["prefill", "decode"]
        router = Router(config={"router": {"replicas": 2, "health": {"timeout": 60.0},
                                           "disagg": {"enabled": True, "handoff_chunk": 32}}},
                        replica_engines=clients)
        dtypes = []
        export = clients[0].kv_export_window

        def spy(*a, **kw):
            window = export(*a, **kw)
            dtypes.append((window["codec"], window["k"].dtype))
            return window

        clients[0].kv_export_window = spy
        prompts = _prompts((5, 11, 40), seed=0)
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        out = router.drain()
        st = router.router_stats()
        assert st["disagg"]["handoffs"] == 3
        assert st["replicas"][0]["completed"] == 0 and st["replicas"][1]["completed"] == 3
        # 5 and 11 tokens: one 32-wide window each; 40: two
        assert dtypes == [("raw", torch.bfloat16)] * 4
        assert clients[0].compile_counts()["decode"] == 0
        assert clients[1].compile_counts()["kv_import"] == {"32": 1}
        solo = build_serving_engine(spec, device="cpu")
        for i, p in enumerate(prompts):
            solo.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        ref = solo.drain()
        for i in range(3):
            assert out[i].ok
            np.testing.assert_array_equal(out[i].tokens, ref[i].tokens)
    finally:
        sup.shutdown()
