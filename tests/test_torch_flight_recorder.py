"""Port parity: the fleet's flight recorder.

Every case of the JAX package's ``tests/test_flight_recorder.py`` that does
not read the program ledger, through the JAX modules and the port's copies
side by side: the bounded downsampling rings (``telemetry/timeseries.py``),
the SLO tracker and terminal classifier (``slo.py``), the incident
recorder (``incident.py``), the autopsy CLI (``python -m
deepspeed_tpu_torch.telemetry.autopsy`` against ``bin/dstpu_autopsy``),
JSONL rotation, Prometheus text, the config blocks, and the wiring: a clean
serving run with the whole recorder on writes no bundle, changes no token
and builds no extra program; a replica's death leaves ONE coalesced bundle
that both packages' autopsies validate with no problems; brownout, a NaN
quarantine and a watchdog refusal trigger bundles of their kind; a
worker's step reply carries its ring cells into the Router's mirror; the
report CLI's ``--watch`` loop and its interval check.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.telemetry import autopsy as jautopsy
from deepspeed_tpu.telemetry import incident as jinc
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu.telemetry import timeseries as jts
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import rpc as trpc
from deepspeed_tpu_torch.launcher.serving_worker import WorkerHost
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.config import RouterTransportConfig
from deepspeed_tpu_torch.telemetry import autopsy as tautopsy
from deepspeed_tpu_torch.telemetry import incident as tinc
from deepspeed_tpu_torch.telemetry import slo as tslo
from deepspeed_tpu_torch.telemetry import timeseries as tts
from simple_model import tiny_transformer

REPO = str(pathlib.Path(__file__).resolve().parents[1])
JAX_AUTOPSY = [sys.executable, os.path.join(REPO, "bin", "dstpu_autopsy")]
PORT_AUTOPSY = [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.autopsy"]
MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64, decode_attn="xla",
             pos_emb="rotary")
PKGS = {"jax": (jts, jslo, jinc, jconfig), "torch": (tts, tslo, tinc, tconfig)}


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**MODEL)), config={"dtype": "fp32"}, params=params,
                          device="cpu")
    return {"jax": jeng, "torch": teng}


def _both(fn):
    """Run ``fn(ts, slo, incident, config)`` over each package's modules;
    the port's result must equal JAX's."""
    out = {name: fn(*mods) for name, mods in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- timeseries rings -----------------------------------------------------------


def test_rings_tiers_aggregate_and_stay_bounded():
    def run(ts, *_):
        store = ts.TimeSeriesStore(raw_interval_s=0.25, tiers=(1.0,), capacity=8)
        for i in range(100):
            store.sample(i * 0.25, gauges={"g": float(i)})
        return store.snapshot(), ts.SCHEMA

    snap, schema = _both(run)
    assert snap["schema"] == schema
    tiers = snap["series"]["g"]
    assert len(tiers["0.25s"]) == 8 and len(tiers["1s"]) == 8
    t, lo, hi, s, n = tiers["1s"][-1]
    assert n == 4 and hi - lo == 3 and s == lo + hi + (lo + 1) + (lo + 2)


def test_rings_counter_deltas_and_reset_clamp():
    def run(ts, *_):
        store = ts.TimeSeriesStore(raw_interval_s=1.0, tiers=(), capacity=16)
        for t, c in ((0.0, 10.0), (1.0, 13.0), (2.0, 2.0), (3.0, 5.0)):
            store.sample(t, counters={"c": c})
        return store.window_sum("c", 0.0, 10.0)

    assert _both(run) == (6.0, 3)


def test_rings_window_prefers_finest_tier_that_reaches():
    def run(ts, *_):
        store = ts.TimeSeriesStore(raw_interval_s=0.25, tiers=(1.0,), capacity=4)
        for i in range(40):
            store.sample(i * 0.25, gauges={"g": 1.0})
        return store.window("g", 9.4, 10.0), store.window("g", 6.5, 10.0)

    recent, wide = _both(run)
    assert recent and all(len(c) == 5 for c in recent) and wide[0][0] <= 6.5


def test_rings_flush_cursor_and_mirror_ingest():
    def run(ts, *_):
        src = ts.TimeSeriesStore(raw_interval_s=1.0, tiers=(4.0,), capacity=32)
        dst = ts.TimeSeriesStore(raw_interval_s=1.0, tiers=(4.0,), capacity=32)
        cursor = 0
        for i in range(10):
            src.sample(float(i), gauges={"g": float(i)})
            cells, cursor = src.cells_since(cursor)
            for item in cells:
                dst.ingest(item["s"], item["c"])
        out = [dst.window_sum("g", 0.0, 20.0), bool(dst.snapshot()["series"]["g"]["4s"]),
               src.cells_since(cursor)]
        dst.ingest("g", [0.0, 99.0, 99.0, 99.0, 1])
        dst.ingest("g", [1.0, 2.0])
        dst.ingest("g", "nonsense")
        return out + [dst.window_sum("g", 0.0, 20.0)]

    out = _both(run)
    assert out[0] == (sum(range(9)), 9) and out[1] and out[2][0] == [] and out[3] == out[0]


def test_rings_nonfinite_now_is_ignored():
    def run(ts, *_):
        store = ts.TimeSeriesStore(raw_interval_s=1.0)
        store.sample(float("inf"), gauges={"g": 1.0})
        store.sample(float("nan"), gauges={"g": 1.0})
        return store.series_names()

    assert _both(run) == []


# -- slo ----------------------------------------------------------------------------


class _Reg:
    """Minimal registry double: named counters and gauges with .value."""

    class _M:
        def __init__(self):
            self.value = 0.0

        def inc(self, v=1.0):
            self.value += v

        def set(self, v):
            self.value = float(v)

    def __init__(self):
        self.m = {}

    def counter(self, name):
        return self.m.setdefault(name, self._M())

    gauge = counter

    def get(self, name):
        return self.m.get(name)

    def values(self):
        return {k: m.value for k, m in sorted(self.m.items())}


def _slo_cfg(config, **over):
    base = dict(enabled=True, ttft_s=0.5, tpot_s=0.05, ttft_target=0.9, tpot_target=0.9,
                availability_target=0.9, window_s=10.0, fast_window_s=5.0, slow_window_s=10.0,
                fast_burn_threshold=2.0, eval_interval_s=1.0)
    base.update(over)
    return config.SLOConfig(**base)


def test_slo_attainment_burn_and_rising_edge():
    def run(ts, slo, _inc, config):
        reg = _Reg()
        store = ts.TimeSeriesStore(raw_interval_s=1.0, tiers=())
        tracker = slo.SLOTracker(_slo_cfg(config), reg, lambda: [store])
        req = viol = 0
        for i in range(5):
            req += 2
            viol += 1
            store.sample(float(i), counters={"slo/requests": float(req), "slo/ttft_violations": float(viol)})
        verdicts = [tracker.evaluate(5.0), tracker.evaluate(5.5), tracker.evaluate(100.0)]
        store.sample(101.0, counters={"slo/requests": float(req), "slo/ttft_violations": float(viol)})
        store.sample(102.0, counters={"slo/requests": float(req + 2), "slo/ttft_violations": float(viol + 2)})
        verdicts.append(tracker.evaluate(103.0))
        return verdicts, reg.values()

    (v1, v2, v3, v4), gauges = _both(run)
    assert v1["attainment"]["ttft"] == pytest.approx(0.5) and v1["burn"]["ttft"]["fast"] == pytest.approx(5.0)
    assert v1["breach"] and v1["breach_dims"] == ["ttft"] and v1["breach_rising"] is True
    assert v2["breach_rising"] is False
    assert v3["attainment"] == {"ttft": 1.0, "tpot": 1.0, "availability": 1.0} and not v3["breach"]
    assert v4["breach_rising"] is True and gauges["slo/fast_burn_breach"] == 1.0


def test_classify_terminal_counter_matrix():
    def run(_ts, slo, _inc, config):
        reg, cfg = _Reg(), _slo_cfg(config)
        for args in (("ok", 0.1, 0.01), ("ok", 0.9, 0.01), ("ok", 0.1, 0.2), ("deadline_exceeded", 9.0, None),
                     ("ok", 0.1, None)):
            slo.classify_terminal(reg, cfg, *args)
        return reg.values()

    assert _both(run) == {"slo/failures": 1, "slo/requests": 5, "slo/tpot_violations": 1,
                          "slo/ttft_violations": 1}


# -- incidents --------------------------------------------------------------------


def _bundle(path):
    b = json.load(open(path))
    b.pop("wall_time")
    return b


def test_incident_stage_coalesce_finalize(tmp_path):
    (tmp_path / ".expected-incidents").touch()

    def run(_ts, _slo, inc, _config):
        d = tmp_path / inc.__name__.split(".")[0]
        rec = inc.IncidentRecorder(str(d / "inc"), source="test", window_before_s=5.0, window_after_s=2.0)
        out = [rec.trigger("replica_dead", 10.0, rid=1), rec.trigger("failover", 10.1, uid=7), rec.pending,
               rec.tick(11.0)]
        calls = []
        path = rec.tick(12.5, lambda st, t0, t1: calls.append((t0, t1)) or {"rings": {"x": 1}})
        out += [os.path.basename(path), calls, _bundle(path), rec.pending]
        out += [[(e["seq"], e["kind"], e["file"]) for e in rec.index()], rec.trigger("brownout_engaged", 20.0),
                os.path.basename(rec.flush()), [e["kind"] for e in rec.index()]]
        return out

    out = _both(run)
    assert out[:4] == [True, False, True, None] and out[5] == [(5.0, 12.0)]
    assert [t["kind"] for t in out[6]["triggers"]] == ["replica_dead", "failover"]
    assert out[-1] == ["brownout_engaged", "replica_dead"]


def test_incident_prune_and_seq_resume(tmp_path):
    (tmp_path / ".expected-incidents").touch()

    def run(_ts, _slo, inc, _config):
        d = str(tmp_path / inc.__name__.split(".")[0])
        rec = inc.IncidentRecorder(d, max_bundles=3, window_after_s=0.0)
        for i in range(5):
            rec.trigger("failover", float(i))
            rec.tick(float(i))
        seqs = [e["seq"] for e in rec.index()]
        rec2 = inc.IncidentRecorder(d, max_bundles=3, window_after_s=0.0)
        rec2.trigger("failover", 9.0)
        rec2.tick(9.0)
        return seqs, rec2.index()[0]["seq"]

    assert _both(run) == ([4, 3, 2], 5)


def test_incident_context_error_is_contained(tmp_path):
    (tmp_path / ".expected-incidents").touch()

    def run(_ts, _slo, inc, _config):
        rec = inc.IncidentRecorder(str(tmp_path / inc.__name__.split(".")[0]), window_after_s=0.0)
        rec.trigger("nan_quarantine", 1.0, uid=3)

        def bad(st, t0, t1):
            raise RuntimeError("half-dead replica")

        b = inc.IncidentRecorder.load(rec.tick(1.0, bad))
        return b["context_error"], b["triggers"]

    err, triggers = _both(run)
    assert "RuntimeError" in err and triggers[0]["uid"] == 3


def test_incident_kind_normalization(tmp_path):
    (tmp_path / ".expected-incidents").touch()

    def run(_ts, _slo, inc, _config):
        rec = inc.IncidentRecorder(str(tmp_path / inc.__name__.split(".")[0]), window_after_s=0.0)
        rec.trigger("Some New Kind!", 0.0)
        return os.path.basename(rec.tick(0.0)), inc.KINDS

    name, kinds = _both(run)
    assert name.endswith("-some_new_kind_.json") and all(k == k.lower() for k in kinds)


def test_nan_quarantine_trigger_engine_side(tmp_path):
    (tmp_path / ".expected-incidents").touch()

    def run(_ts, _slo, inc, _config):
        rec = inc.IncidentRecorder(str(tmp_path / inc.__name__.split(".")[0]), source="replica0",
                                   window_after_s=0.0)
        rec.trigger("nan_quarantine", 2.0, uid=9, slot=1, phase="decode")
        b = inc.IncidentRecorder.load(rec.tick(2.0))
        return b["kind"], b["triggers"][0]["slot"]

    assert _both(run) == ("nan_quarantine", 1)


# -- the autopsy CLI ----------------------------------------------------------------


def _make_bundle(tmp_path, inc=tinc, **over):
    (tmp_path / ".expected-incidents").touch()
    rec = inc.IncidentRecorder(str(tmp_path / "inc"), window_before_s=2.0, window_after_s=0.5)
    rec.trigger("replica_dead", 5.0, rid=1, in_flight=2)
    rec.trigger("failover", 5.1, uid=11, from_rid=1)
    return rec.tick(6.0, lambda st, t0, t1: {
        "rings": {"router": {"schema": tts.SCHEMA, "t0": t0, "t1": t1,
                             "series": {"router/queue_depth": [[5.0, 0.0, 3.0, 6.0, 4]]}}},
        "trace_events": [
            {"t": 5.0, "uid": 11, "event": "dispatched", "replica_id": 1},
            {"t": 5.2, "uid": 11, "event": "failover", "replica_id": "router", "from_replica": 1,
             "to_replica": 0}],
        "stats": {"steps": 42}, **over})


def _cli(cmd, *args):
    proc = subprocess.run(cmd + [str(a) for a in args], capture_output=True, text=True, timeout=60, cwd=REPO)
    return proc.returncode, proc.stdout


def test_autopsy_renders_and_exits_zero(tmp_path):
    path = _make_bundle(tmp_path)
    rc, out = _cli(PORT_AUTOPSY, path)
    assert (rc, out) == _cli(JAX_AUTOPSY, path)
    assert rc == 0 and "replica_dead" in out and "failover" in out and "router/queue_depth" in out
    assert "bundle consistent" in out


def test_autopsy_exit_code_contract(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "other/1"}')
    path = _make_bundle(tmp_path)
    b = json.load(open(path))
    b["kind"] = "brownout_engaged"
    mangled = tmp_path / "mangled.json"
    mangled.write_text(json.dumps(b))
    codes = []
    for args in ((tmp_path / "nope.json",), (bad,), (mangled,), ("--list", os.path.dirname(path)), ()):
        rc, out = _cli(PORT_AUTOPSY, *args)
        jrc, jout = _cli(JAX_AUTOPSY, *args)
        assert rc == jrc
        if args and args[0] in (mangled, "--list"):
            assert out == jout
        codes.append(rc)
    assert codes == [2, 2, 1, 0, 2]


def test_autopsy_perfetto_export(tmp_path):
    path = _make_bundle(tmp_path)
    outs = []
    for cmd, name in ((PORT_AUTOPSY, "t.json"), (JAX_AUTOPSY, "j.json")):
        rc, _ = _cli(cmd, path, "--perfetto", tmp_path / name)
        assert rc == 0
        # a string replica id's pid is its hash, salted per process
        outs.append([{k: v for k, v in ev.items() if k != "pid"}
                     for ev in json.load(open(tmp_path / name))["traceEvents"]])
    assert outs[0] == outs[1] and outs[0]


# -- jsonl rotation, prometheus, config ---------------------------------------------


def test_jsonl_exporter_size_rotation(tmp_path):
    def run(mod, d):
        d.mkdir()
        exp = mod.JsonlExporter(str(d / "run.jsonl"), max_bytes=256, keep=2)
        for i in range(100):
            exp.emit({"type": "x", "i": i, "pad": "p" * 32})
        exp.close()
        files = sorted(p.name for p in d.glob("run.jsonl*"))
        return files, {f: [{k: v for k, v in json.loads(ln).items() if k != "t"}
                           for ln in (d / f).read_text().splitlines()] for f in files}

    tout, jout = run(ttel, tmp_path / "t"), run(jtel, tmp_path / "j")
    assert tout == jout
    assert tout[0] == ["run.jsonl", "run.jsonl.1", "run.jsonl.2"]
    assert tout[1]["run.jsonl.1"][-1]["i"] + 1 == tout[1]["run.jsonl"][0]["i"] and tout[1]["run.jsonl"][-1]["i"] == 99


def test_jsonl_exporter_no_rotation_by_default(tmp_path):
    exp = ttel.JsonlExporter(str(tmp_path / "run.jsonl"))
    for i in range(50):
        exp.emit({"i": i, "pad": "p" * 64})
    exp.close()
    assert not list(tmp_path.glob("run.jsonl.*"))
    assert len((tmp_path / "run.jsonl").read_text().splitlines()) == 50


def test_prometheus_help_type_lines():
    texts = []
    for mod in (ttel, jtel):
        reg = mod.MetricsRegistry()
        reg.counter("serving/admissions").inc(3)
        reg.gauge("router/queue_depth").set(2)
        reg.histogram("serving/ttft_sec").observe(0.1)
        texts.append(mod.prometheus_text(reg))
    assert texts[0] == texts[1]
    declared = {}
    for line in texts[0].splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            declared[name] = kind
    assert declared["dstpu_serving_admissions_total"] == "counter"
    assert declared["dstpu_router_queue_depth"] == "gauge" and declared["dstpu_serving_ttft_sec"] == "summary"


def test_prometheus_fleet_text_replica_labels():
    snap = {"router": {"metrics": {"counters": {"router/failovers": 2.0}, "gauges": {}, "histograms": {}}},
            "replicas": {
                0: {"metrics": {"counters": {"serving/admissions": 3.0}, "gauges": {},
                                "histograms": {"serving/ttft_sec": {"count": 2, "sum": 0.4, "mean": 0.2, "p50": 0.2,
                                                                    "p90": 0.3, "p99": 0.3, "min": 0.1,
                                                                    "max": 0.3}}}},
                1: {"metrics": {"counters": {"serving/admissions": 5.0}, "gauges": {}, "histograms": {}}},
                2: {"replica_id": 2, "unreachable": "RpcError: gone"}}}
    text = ttel.prometheus_fleet_text(snap)
    assert text == jtel.prometheus_fleet_text(snap)
    assert 'dstpu_serving_admissions_total{replica="1"} 5' in text
    assert text.count("# TYPE dstpu_serving_admissions_total counter") == 1


@pytest.mark.parametrize("cls,kw", [
    ("TimeSeriesConfig", {"interval_s": 0.0}), ("TimeSeriesConfig", {"capacity": 1}),
    ("TimeSeriesConfig", {"flush_capacity": 0}), ("SLOConfig", {"availability_target": 1.5}),
    ("SLOConfig", {"fast_window_s": -1.0}), ("SLOConfig", {"ttft_s": -1.0}),
    ("SLOConfig", {"fast_burn_threshold": 0.0}), ("IncidentConfig", {"enabled": True, "dir": ""}),
    ("IncidentConfig", {"max_bundles": 0}), ("IncidentConfig", {"window_after_s": -1.0}),
    ("TelemetryConfig", {"jsonl_max_bytes": -1}), ("TelemetryConfig", {"jsonl_keep": 0}),
    ("GatewayConfig", {"metrics_fleet_refresh_s": -1.0}),
])
def test_flight_recorder_config_validation(cls, kw):
    """Fields, defaults and validation messages equal JAX's; the training
    ``telemetry`` block still refuses the recorder's blocks when on (the
    JAX training engine reads none of them)."""
    import dataclasses

    def fields(c):
        return {f.name: (f.default if f.default is not dataclasses.MISSING else repr(f.default_factory()))
                for f in dataclasses.fields(c)}

    if cls != "TelemetryConfig":
        assert fields(getattr(tconfig, cls)) == fields(getattr(jconfig, cls))
    with pytest.raises(jconfig.DeepSpeedConfigError) as je:
        getattr(jconfig, cls)(**kw)
    with pytest.raises(tconfig.DeepSpeedConfigError) as te:
        getattr(tconfig, cls)(**kw)
    assert str(te.value) == str(je.value)
    tc = tconfig.TelemetryConfig(timeseries={"enabled": True, "interval_s": 0.5}, ledger={"enabled": False})
    with pytest.raises(NotImplementedError, match="timeseries"):
        tc.check_ported()
    assert tconfig.GatewayConfig(metrics_fleet_refresh_s=5.0).metrics_fleet_refresh_s == 5.0


# -- report --watch ---------------------------------------------------------------------

def test_report_watch_loop_host_only():
    import io

    from deepspeed_tpu.telemetry import report as jreport
    from deepspeed_tpu_torch.telemetry import report as treport

    outs = {}
    for name, rep in (("jax", jreport), ("torch", treport)):
        out, sleeps = io.StringIO(), []
        frames = iter(["frame-a\n", "frame-b\n", "frame-c\n"])
        assert rep.watch_loop(lambda: next(frames), 2.5, out=out, sleep=sleeps.append, iterations=3) == 0
        outs[name] = (out.getvalue(), sleeps)
    text, sleeps = outs["torch"]
    assert outs["torch"] == outs["jax"]
    assert text.count(treport._CLEAR) == 3 and "frame-a" in text and "frame-c" in text
    assert sleeps == [2.5, 2.5]  # no sleep after the final frame


def test_report_watch_rejects_bad_interval(tmp_path):
    from deepspeed_tpu.telemetry import report as jreport
    from deepspeed_tpu_torch.telemetry import report as treport

    p = tmp_path / "t.jsonl"
    p.write_text("")
    for rep in (jreport, treport):
        with pytest.raises(SystemExit):
            rep.main([str(p), "--watch", "0"])


# -- the wiring -----------------------------------------------------------------------


def _flight_config(tmp_path, **over):
    cfg = {"timeseries": {"enabled": True, "interval_s": 0.05},
           "slo": {"enabled": True, "ttft_s": 30.0, "tpot_s": 30.0, "window_s": 10.0, "fast_window_s": 5.0,
                   "slow_window_s": 10.0, "eval_interval_s": 0.1},
           "incidents": {"enabled": True, "dir": str(tmp_path / "incidents"), "window_before_s": 10.0,
                         "window_after_s": 0.2}}
    cfg.update(over)
    return cfg


def test_clean_serving_writes_zero_bundles(engines, tmp_path):
    """The quiescence gate: the whole recorder on (rings, SLO, incidents,
    watchdog raise) writes no bundle, builds no extra program and changes
    no token, in the port as in JAX; every terminal is SLO-classified."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 97, size=4 + 3 * i).astype(np.int32) for i in range(6)]

    def run(SE, R, eng, config):
        srv = SE(eng, n_slots=4, max_seq_len=64, config=config)
        return srv, srv.serve([R(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])

    base_srv, base = run(ServingEngine, Request, engines["torch"], {"watchdog_mode": "raise"})
    fr_srv, fr = run(ServingEngine, Request, engines["torch"], {"watchdog_mode": "raise", **_flight_config(tmp_path)})
    _, jfr = run(JaxServingEngine, JaxRequest, engines["jax"],
                 {"watchdog_mode": "raise", "ledger": {"enabled": False}, **_flight_config(tmp_path / "j")})
    for uid in base:
        np.testing.assert_array_equal(base[uid].tokens, fr[uid].tokens)
        np.testing.assert_array_equal(fr[uid].tokens, jfr[uid].tokens)
    assert fr_srv.compile_counts() == base_srv.compile_counts()
    assert list((tmp_path / "incidents").rglob("incident-*.json")) == []
    assert "serving/queue_depth" in fr_srv._rings.series_names()
    reg = fr_srv.telemetry.registry
    assert reg.get("slo/requests").value == len(prompts) and reg.get("slo/failures") is None
    assert reg.get("serving/ring_sample_sec").value >= 0.0
    snap = fr_srv.telemetry_snapshot()
    assert snap["rings"]["schema"] == tts.SCHEMA and snap["incidents"] == []


def _dead_replica_run(P, eng, tmp_path):
    cfg = {"n_slots": 2, "max_seq_len": 64, "router": {"replicas": 2, "health": {"timeout": 30.0}},
           # sampled at every fleet step: with a wall-clock interval the
           # samples after the failover (and so which counters become ring
           # series) depended on the host's speed
           **_flight_config(tmp_path, timeseries={"enabled": True, "interval_s": 1e-4}),
           "fault_injection": {"enabled": True, "replica_dead_at": [[1, 3]]}}
    if P == "jax":
        cfg["ledger"] = {"enabled": False}
    R, Q = (JaxRouter, JaxRequest) if P == "jax" else (Router, Request)
    router = R(eng, config=cfg)
    rng = np.random.default_rng(3)
    reqs = [Q(uid=i, prompt=rng.integers(0, 97, size=5).astype(np.int32), max_new_tokens=5) for i in range(8)]
    res = router.serve(reqs)
    router.drain()
    return router, res


def test_replica_dead_fault_produces_one_autopsy_bundle(engines, tmp_path):
    """A replica's death mid-traffic stages ``replica_dead``, coalesces the
    failover storm onto it, and the drained fleet leaves ONE bundle: the
    same kinds as JAX's run, validated with no problems by the port's
    autopsy AND the JAX one (its CLI exits 0 on the port's bundle)."""
    (tmp_path / ".expected-incidents").touch()
    kinds = {}
    for P in ("jax", "torch"):
        router, res = _dead_replica_run(P, engines[P], tmp_path / P)
        assert all(r.status == "ok" for r in res.values())
        bundles = sorted((tmp_path / P / "incidents").glob("incident-*.json"))
        assert len(bundles) == 1
        b = json.load(open(bundles[0]))
        kinds[P] = (b["kind"], sorted({t["kind"] for t in b["triggers"]}), sorted(b),
                    sorted(b["rings"]["router"]["series"]))
        snap = router.telemetry_snapshot(emit=False)
        assert snap["router"]["incidents"][0]["kind"] == "replica_dead"
        assert "slo" in snap["router"] and "rings" in snap["router"]
    assert kinds["torch"] == kinds["jax"]
    assert kinds["torch"][0] == "replica_dead" and "failover" in kinds["torch"][1]
    path = str(sorted((tmp_path / "torch" / "incidents").glob("incident-*.json"))[0])
    bundle = tautopsy.load_bundle(path)
    assert tautopsy.validate(bundle) == [] and jautopsy.validate(jautopsy.load_bundle(path)) == []
    assert any(ev["event"] == "failover" for ev in bundle["trace_events"])
    for cmd in (PORT_AUTOPSY, JAX_AUTOPSY):
        rc, out = _cli(cmd, path)
        assert rc == 0 and "replica_dead" in out and "failover" in out


def test_brownout_triggers(engines, tmp_path):
    (tmp_path / ".expected-incidents").touch()
    out = {}
    for P, R in (("jax", JaxRouter), ("torch", Router)):
        cfg = {"n_slots": 2, "router": {"replicas": 1}, **_flight_config(tmp_path / P, slo={"enabled": False})}
        if P == "jax":
            cfg["ledger"] = {"enabled": False}
        router = R(engines[P], config=cfg)
        router.set_brownout(True, deadline_s=1.5)
        assert router.incidents.pending
        router.incidents.flush(router._incident_context)
        router.set_brownout(False)
        router.incidents.flush(router._incident_context)
        out[P] = sorted(e["kind"] for e in router.incidents.index())
    assert out["torch"] == out["jax"] == ["brownout_engaged", "brownout_lifted"]


def test_nan_quarantine_and_watchdog_refusal_write_engine_bundles(engines, tmp_path):
    """Engine-side triggers, in both packages: an injected NaN's quarantine
    writes a ``nan_quarantine`` bundle under ``replica<rid>/`` (the scheduler
    block and ring window in it), and a watchdog refusal of a second decode
    signature under raise writes a ``watchdog_refusal`` one."""
    (tmp_path / ".expected-incidents").touch()
    out = {}
    for P, SE, Q in (("jax", JaxServingEngine, JaxRequest), ("torch", ServingEngine, Request)):
        cfg = {"n_slots": 2, "max_seq_len": 64, **_flight_config(tmp_path / P),
               "fault_injection": {"enabled": True, "garbage_logits_uids": [1], "garbage_logits_phase": "decode",
                                   "garbage_logits_decode_step": 1}}
        if P == "jax":
            cfg["ledger"] = {"enabled": False}
        srv = SE(engines[P], config=cfg, replica_id=3)
        res = srv.serve([Q(uid=i, prompt=np.arange(4 + i, dtype=np.int32), max_new_tokens=4) for i in range(3)])
        srv.drain()
        d = tmp_path / P / "incidents" / "replica3"
        bundles = sorted(d.glob("incident-*.json"))
        b = json.load(open(bundles[0]))
        out[P] = ([r.status for _, r in sorted(res.items())], [p.name.split("-", 2)[2] for p in bundles],
                  b["triggers"][0]["uid"], sorted(b["scheduler"]), sorted(k for k in b if k not in ("hbm",)))
        wd = srv.telemetry.watchdog
        wd.mode = "raise"
        fn = wd.watch(lambda x: x, "probe/stable", stable=True)
        fn(np.zeros(2, np.float32))
        with pytest.raises(Exception, match="refused"):
            fn(np.zeros(3, np.float32))
        srv.drain()
        srv._incidents.flush(srv._incident_context)
        out[P] += (sorted(e["kind"] for e in srv._incidents.index()),)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == ["nan_quarantine.json"]
    assert out["torch"][-1] == ["nan_quarantine", "watchdog_refusal"]


def test_worker_step_reply_carries_ring_cells_into_the_router_mirror(engines, tmp_path):
    """A worker's closed ring cells ride its step reply (no extra RPC) into
    the Router's per-replica mirror store, which the SLO windows read."""
    srv = ServingEngine(engines["torch"], config={"n_slots": 2, "max_seq_len": 64,
                                                   "timeseries": {"enabled": True, "interval_s": 0.01}})
    host = WorkerHost(srv)
    server = trpc.RpcServer("tcp://127.0.0.1:0", host.handlers())
    stop = threading.Event()
    t = threading.Thread(target=server.serve_forever, kwargs={"should_stop": stop.is_set}, daemon=True)
    t.start()
    try:
        client = trpc.ReplicaClient(server.address, transport=RouterTransportConfig(call_timeout_s=60.0))
        router = Router(config={"router": {"replicas": 1}, "timeseries": {"enabled": True, "interval_s": 0.01},
                                "slo": {"enabled": True, "ttft_s": 30.0, "eval_interval_s": 0.01}},
                        replica_engines=[client])
        res = router.serve([Request(uid=i, prompt=np.arange(5, dtype=np.int32), max_new_tokens=8)
                            for i in range(3)])
        assert all(r.ok for r in res.values())
        mirror = router._ring_mirror[0]
        assert "serving/queue_depth" in mirror.series_names()
        snap = router.telemetry_snapshot(emit=False)
        assert 0 in snap["router"]["rings"]["replicas"] and "slo" in snap["router"]
    finally:
        stop.set()
        t.join(timeout=5)
        server.close()
