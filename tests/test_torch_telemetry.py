"""Port parity: the telemetry core, the fault injector, the prefix index,
the drafters and the serving config blocks.

The same updates through the JAX package's modules and the port's give
equal registry snapshots, Prometheus text, JSONL events (rotation
included), request timelines and Perfetto exports. The port's recompile
watchdog counts one compilation per abstract signature and refuses a
stable path's second one before the call runs. Serving blocks the port has
not got raise ``NotImplementedError`` naming them.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import prefix_cache as jpc
from deepspeed_tpu.inference import speculation as jspec
from deepspeed_tpu.resilience import faults as jfaults
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.inference import prefix_cache as tpc
from deepspeed_tpu_torch.inference import speculation as tspec
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import faults as tfaults
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.telemetry.watchdog import RecompileError, RecompileWatchdog, abstract_signature


def _updates(reg):
    rng = np.random.default_rng(0)
    for i in range(200):
        reg.counter("serving/tokens_out").inc(int(rng.integers(1, 9)))
        reg.gauge("serving/queue_depth").set(int(rng.integers(0, 30)))
        reg.histogram("serving/ttft_sec").observe(float(rng.lognormal(-3, 1)))
        reg.histogram("serving/decode_step_sec").observe(0.0 if i % 17 == 0 else float(rng.uniform(1e-4, 1e-2)))
    reg.counter("tenant/a/requests").inc()


def test_registry_snapshot_and_prometheus_match_jax():
    jreg, treg = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    _updates(jreg)
    _updates(treg)
    assert treg.snapshot() == jreg.snapshot()
    assert ttel.prometheus_text(treg) == jtel.prometheus_text(jreg)
    fleet = {"router": {"metrics": treg.snapshot()},
             "replicas": {0: {"metrics": treg.snapshot()}, 1: {}, 2: {"metrics": treg.snapshot()}}}
    assert ttel.prometheus_fleet_text(fleet) == jtel.prometheus_fleet_text(fleet)
    with pytest.raises(TypeError):
        treg.gauge("serving/tokens_out")
    h = treg.histogram("serving/ttft_sec")
    assert h.summary()["p50"] == jreg.histogram("serving/ttft_sec").summary()["p50"]


def _events(path):
    out = []
    for name in sorted(os.listdir(os.path.dirname(path))):
        with open(os.path.join(os.path.dirname(path), name)) as f:
            out.append((name, [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]))
    return out


def test_jsonl_events_and_rotation_match_jax(tmp_path):
    logs = {}
    for pkg, tel in (("jax", jtel), ("port", ttel)):
        d = tmp_path / pkg
        d.mkdir()
        sink = tel.JsonlExporter(str(d / "run.jsonl"), max_bytes=300, keep=2)
        for i in range(40):
            sink.emit({"type": "request", "uid": i, "status": "ok", "n_tokens": i % 7})
        sink.close()
        logs[pkg] = _events(str(d / "run.jsonl"))
    assert logs["port"] == logs["jax"]
    assert [name for name, _ in logs["port"]] == ["run.jsonl", "run.jsonl.1", "run.jsonl.2"]


def test_spans_feed_the_registry_and_sink(tmp_path):
    tm = ttel.Telemetry(jsonl_path=str(tmp_path / "t.jsonl"), device_sync_spans=True)
    with tm.span("serve") as outer:
        with tm.span("decode", sync=torch.ones(3)) as sp:
            sp.annotate(slots=4)
        outer.set_sync({"x": torch.zeros(2)})
    with pytest.raises(ZeroDivisionError):
        with tm.span("fails"):
            1 / 0
    with tm.span("after"):
        pass
    hist = tm.snapshot()["metrics"]["histograms"]
    assert {"span/serve", "span/serve/decode", "span/after"} <= set(hist)
    assert "span/fails" not in hist
    tm.close()
    evs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert [e["path"] for e in evs] == ["serve/decode", "serve", "after"]
    assert evs[0]["slots"] == 4 and evs[0]["depth"] == 1


def test_watchdog_one_compile_per_signature_warn_and_raise(monkeypatch):
    from deepspeed_tpu_torch.telemetry import watchdog

    warned = []
    monkeypatch.setattr(watchdog.logger, "warning", warned.append)
    wd = RecompileWatchdog(ttel.MetricsRegistry(), mode="warn")
    calls = []
    fn = wd.watch(lambda x, n: calls.append(x.shape) or x.sum(), "serving/decode", stable=True)
    fn(torch.zeros(4), 1)
    fn(torch.ones(4), 7)  # same signature: a python int is keyed by its type
    assert fn._cache_size() == 1 and not fn.last_call_compiled
    fn(torch.zeros(5), 1)  # a second signature on a stable path: warned
    assert fn._cache_size() == 2 and fn.last_call_compiled
    assert len(warned) == 1 and "compiled 2 times" in warned[0]
    row = wd.compile_table()[0]
    assert row["compiles"] == 2 and row["signatures"][0] == "(float32[4]@cpu, int)"
    assert wd.unique_name("serving/decode") == "serving/decode#2"
    assert abstract_signature((np.zeros((2, 3), np.int32),)) == "(int32[2,3])"

    wd = RecompileWatchdog(ttel.MetricsRegistry(), mode="raise")
    cache = torch.zeros(4)

    def write(x):
        cache.add_(x)

    prog = wd.watch(write, "serving/fill_slot", stable=True)
    prog(torch.ones(4))
    for _ in range(2):  # a retry of the refused signature is refused again
        with pytest.raises(RecompileError, match="refused before execution"):
            prog(torch.ones(4, dtype=torch.float64))
    assert torch.equal(cache, torch.ones(4))  # the refused call never ran
    row = wd.compile_table()[0]
    assert row["compiles"] == 1 and row["refusals"] == 2
    assert [e["type"] for e in wd.events] == ["compile", "refusal"]
    with pytest.raises(ValueError):
        RecompileWatchdog(mode="loud")


@pytest.fixture(scope="module")
def tiny_engine():
    cfg = TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)
    return init_inference(Model(cfg), config={"dtype": "fp32"}, device="cpu")


def test_serving_decode_refused_before_it_runs_and_cache_survives(tiny_engine):
    srv = ServingEngine(tiny_engine, config={"n_slots": 2, "watchdog_mode": "raise"})
    srv.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4))
    srv.step(now=0.0)
    w = srv.worker
    before = {kv: t.clone() for kv, t in w._cache.items()}
    n = 3  # a slot count the decode program never ran with
    with pytest.raises(RecompileError):
        w.decode(np.zeros(n, np.int32), np.ones(n, np.int32), np.ones(n, np.int32), np.ones(n, bool),
                 np.zeros(n, np.float32), np.zeros(n, np.int32), np.ones(n, np.float32))
    assert all(torch.equal(w._cache[kv], before[kv]) for kv in before)
    srv.drain()
    assert srv.result(0).ok and srv.compile_counts()["decode"] == 1
    snap = srv.telemetry_snapshot()
    assert snap["metrics"]["counters"]["refusal/serving/decode"] == 1
    assert snap["hbm"]["pools"]["slot_kv_cache"] == 2 * 2 * 2 * 128 * 32 * 4
    assert {"metrics", "recompile_table", "compiles", "hbm", "request_trace"} <= set(snap)


def test_request_timeline_and_perfetto_match_jax(tiny_engine):
    srv = ServingEngine(tiny_engine, config={"n_slots": 1, "chunked_prefill": {"enabled": True, "chunk_size": 8}})
    for i in range(3):
        srv.submit(Request(uid=i, prompt=np.arange(3, 20 + i, dtype=np.int32), max_new_tokens=3,
                           arrival_time=0.1 * i))
    t = 0.0
    while not srv.idle:
        srv.step(now=t)
        t += 0.05
    events = srv.tracer.events()
    assert [e["event"] for e in srv.tracer.events(uid=0)][:4] == ["arrived", "admitted", "chunk", "chunk"]
    jt = jtel.RequestTracer(capacity=4096, replica_id=0)
    tt = ttel.RequestTracer(capacity=4096, replica_id=0)
    for ev in events:
        attrs = {k: v for k, v in ev.items() if k not in ("uid", "event", "t", "replica_id")}
        jt.record(ev["uid"], ev["event"], t=ev["t"], **attrs)
        tt.record(ev["uid"], ev["event"], t=ev["t"], **attrs)
    assert tt.events() == jt.events() and tt.events_since(5, 4) == jt.events_since(5, 4)
    snap = {"request_trace": tt.events()}
    assert ttel.request_timeline(snap, uid=1) == jtel.request_timeline(snap, uid=1)
    assert ttel.to_perfetto(tt.events()) == jtel.to_perfetto(jt.events())
    assert {e["name"] for e in ttel.to_perfetto(events)["traceEvents"]} >= {"queued", "prefill", "decode", "chunk"}


@pytest.mark.parametrize("block", ["ledger", "timeseries", "slo", "incidents"])
def test_unported_blocks_are_refused(tiny_engine, block):
    with pytest.raises(NotImplementedError, match=block):
        ServingEngine(tiny_engine, config={block: {"enabled": True}})
    ServingEngine(tiny_engine, config={block: {"enabled": False}})


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_disaggregated_roles_are_refused(tiny_engine, role):
    with pytest.raises(NotImplementedError, match=role):
        ServingEngine(tiny_engine, config={"role": role})
    with pytest.raises(ValueError):
        ServingEngine(tiny_engine, role="mixed")


@pytest.mark.parametrize("cls,kw", [
    ("PrefixCacheConfig", {"insert_policy": "lfu"}), ("PrefixCacheConfig", {"n_slots": 0}),
    ("PrefixCacheConfig", {"min_hits": 0}), ("ChunkedPrefillConfig", {"chunk_size": 48}),
    ("ChunkedPrefillConfig", {"chunks_per_step": 0}), ("SpeculationConfig", {"depth": 0}),
    ("SpeculationConfig", {"draft_source": "eagle"}), ("TenantConfig", {"weight": 0.001}),
    ("TenantConfig", {"token_sha256": "abc"}), ("FaultInjectionConfig", {"rate": 2.0}),
    ("FaultInjectionConfig", {"sites": ["disk"]}), ("FaultInjectionConfig", {"rpc_timeout_at": [[1, 2]]}),
    ("RequestTraceConfig", {"capacity": 0}),
])
def test_serving_config_validation_matches_jax(cls, kw):
    with pytest.raises(jconfig.DeepSpeedConfigError) as je:
        getattr(jconfig, cls)(**kw)
    with pytest.raises(tconfig.DeepSpeedConfigError) as te:
        getattr(tconfig, cls)(**kw)
    assert str(te.value) == str(je.value)
    import dataclasses
    assert {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))} == \
        {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}


def test_fault_injector_decisions_match_jax():
    cfg = {"enabled": True, "seed": 3, "rate": 0.2, "sites": ["garbage_logits"],
           "garbage_logits_uids": [4, 9], "garbage_logits_phase": "decode", "garbage_logits_decode_step": 2}
    ji, ti = jfaults.FaultInjector(cfg), tfaults.FaultInjector(cfg)
    for uid in range(12):
        for step in range(5):
            assert ti.garbage_logits(uid, "decode", step) == ji.garbage_logits(uid, "decode", step)
        assert ti.garbage_logits(uid, "prefill") == ji.garbage_logits(uid, "prefill")
    assert ti.stats()["injected"] == ji.stats()["injected"] and ti.injected["garbage_logits"] > 2
    assert not tfaults.FaultInjector(None).garbage_logits(4, "decode", 2)


def test_prefix_index_and_drafters_match_jax():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 50, size=40)
    jidx = jpc.PrefixIndex(3, 8, insert_policy="min_hits", min_hits=2)
    tidx = tpc.PrefixIndex(3, 8, insert_policy="min_hits", min_hits=2)
    for i in range(30):
        p = np.concatenate([base[:int(rng.integers(8, 40))], rng.integers(0, 50, size=5)])
        out = []
        for idx in (jidx, tidx):
            e = idx.lookup(p, len(p) - 1)
            if e is not None:
                idx.acquire(e)
            r = idx.insert(p, len(p) - 1)
            if e is not None and i % 3:
                idx.release(e)
            out.append((None if e is None else (e.length, e.pool_slot), r.created, r.skipped,
                        None if r.entry is None else r.entry.pool_slot, idx.peek(p, len(p) - 1)))
        assert out[0] == out[1]
    assert tidx.stats() == jidx.stats()
    for source in ("ngram", "draft_model"):
        jc = jconfig.SpeculationConfig(enabled=True, depth=6, draft_source=source)
        tc = tconfig.SpeculationConfig(enabled=True, depth=6, draft_source=source)
        jd, td = jspec.make_drafter(jc, vocab_size=50), tspec.make_drafter(tc, vocab_size=50)
        for n in (3, 17, 60):
            h = np.concatenate([np.tile(rng.integers(0, 50, size=4), 5), rng.integers(0, 50, size=n)])
            for depth in (1, 4, 6):
                np.testing.assert_array_equal(td.propose(h, depth), jd.propose(h, depth))
