"""Port parity: the program ledger and what reads it.

The ledger's derivations (``table``, ``_derive``, ``anatomy``) against the
JAX package's on the same rows, registry and peaks: the hbm-bound and
compute-bound fixtures of ``tests/test_program_ledger.py``, an unrated
platform, and the first-program-owns-the-gauge rule; ``step_anatomy`` and
``pipeline_bubble_fraction``; the peak table (the CPU unrated in both
packages, H100 names resolved most specific first); ``hbm_snapshot``'s warn
threshold; the report CLI's text from the same JSONL in both packages
(default, ``--step-anatomy``, ``--json``, ``--watch`` on an injected
clock); a serving engine with the ledger on runs the programs, calls and
tokens it runs with it off; the timers' ``timer/<name>_sec`` mirror; the
debug name maps; and a module-scoped training engine pair (JAX's and the
port's, the same weights) with the JAX package's default telemetry and
``wall_clock_breakdown``, whose ledger rows, compile tables and timers
agree where both count. (``test_program_ledger.py::
test_training_engine_ledger_and_hbm`` fails on the JAX side, in its
collective X-ray, so these compare other outputs.) The kernels' cost
formulas are held to the figures of ``PERF.md`` §6 at the table's shapes.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.telemetry import collective_ledger as jcl
from deepspeed_tpu.telemetry import program_ledger as jpl
from deepspeed_tpu.telemetry import report as jreport
from deepspeed_tpu.utils import debug as jdebug
from deepspeed_tpu.utils import memory as jmem
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import decode_attention as da
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk
from deepspeed_tpu_torch.telemetry import collective_ledger as tcl
from deepspeed_tpu_torch.telemetry import program_ledger as tpl
from deepspeed_tpu_torch.telemetry import report as treport
from deepspeed_tpu_torch.utils import debug as tdebug
from deepspeed_tpu_torch.utils import memory as tmem
from deepspeed_tpu_torch.utils import timer as ttimer
from simple_model import base_config, tiny_transformer

# -- derivations against the JAX ledger ------------------------------------------------

# flops, bytes, wall s, peak TFLOP/s, peak GB/s, more rows under the same binding
FIXTURES = {
    "hbm_bound": (2e12, 1e12, 1.0, 4.0, 1000.0, ()),
    "compute_bound": (8e12, 1e12, 8.0, 4.0, 1000.0, ()),
    "unrated": (2e12, 1e12, 1.0, None, None, ()),
    "first_owns_gauge": (2e12, 1e12, 1.0, 4.0, 1000.0, (("prog#2", 8e12, 1e12),)),
}


def _fixture_ledger(pl, registry_cls, flops, nbytes, wall_s, peak_tf, peak_bw, more):
    reg = registry_cls()
    reg.histogram("wall").observe(wall_s)
    led = pl.ProgramLedger(reg)
    for name, f, b in (("prog", flops, nbytes),) + tuple(more):
        led.entries[name] = {"name": name, "compiles": 1, "compile_s": 0.1, "flops": f, "bytes_accessed": b,
                             "arith_intensity": f / b}
    led.bind("prog", wall_hist="wall", gauge="fix")
    platform = "tpu" if peak_tf else "cpu"
    led.set_platform({"platform": platform, "device_kind": "fixture", "label": "fixture",
                      "peak_tflops": peak_tf, "peak_hbm_gbps": peak_bw})
    return led, reg


@pytest.mark.parametrize("case", list(FIXTURES))
def test_ledger_rows_and_gauges_equal_jax(case):
    tl, treg = _fixture_ledger(tpl, ttel.MetricsRegistry, *FIXTURES[case])
    jl, jreg = _fixture_ledger(jpl, jtel.MetricsRegistry, *FIXTURES[case])
    assert tl.table(treg) == jl.table(jreg)
    assert tl.anatomy(treg) == jl.anatomy(jreg)
    assert treg.snapshot()["gauges"] == jreg.snapshot()["gauges"]
    row = tl.entries["prog"]
    assert tl._derive(row, None) == jl._derive(row, None)
    tops = {r["name"]: r for r in tl.table(treg)}
    if case == "hbm_bound":
        assert tops["prog"]["roofline"] == "hbm-bound" and tops["prog"]["mfu"] == pytest.approx(0.5)
    elif case == "compute_bound":
        assert tops["prog"]["roofline"] == "compute-bound" and tops["prog"]["mfu"] == pytest.approx(0.25)
    elif case == "unrated":
        assert tops["prog"]["roofline"] == "unrated:cpu" and "fix/mfu" not in treg.snapshot()["gauges"]
    else:  # the FIRST captured match owns the headline gauge
        assert treg.snapshot()["gauges"]["fix/mfu"] == pytest.approx(tops["prog"]["mfu"])


@pytest.mark.parametrize("peaks", [
    {"platform": "gpu", "peak_tflops": 989.0, "peak_hbm_gbps": 3350.0, "peak_ici_gbps": 450.0},
    {"platform": "cpu", "peak_tflops": None, "peak_hbm_gbps": None},
])
@pytest.mark.parametrize("wall", [None, {"count": 3, "p50": 0.02}, {"count": 3, "p50": 1e-9}])
def test_step_anatomy_equals_jax(peaks, wall):
    row = {"name": "train/train_step", "flops": 5.9e13, "bytes_accessed": 1.2e11}
    assert tcl.step_anatomy(row, wall, peaks, None) == jcl.step_anatomy(row, wall, peaks, None)
    for s, m in ((1, 4), (4, 8), (8, 1), (2, 0)):
        assert tcl.pipeline_bubble_fraction(s, m) == jcl.pipeline_bubble_fraction(s, m)


def test_cpu_rows_stay_unrated_in_both_packages():
    cpu = tpl.platform_peaks("cpu")
    assert cpu == jpl.platform_peaks(jax.devices("cpu")[0])
    led = tpl.ProgramLedger(ttel.MetricsRegistry(), device="cpu")
    led.capture("p", {"flops": 1e9, "bytes_accessed": 1e8}, 0.1)
    (row,) = led.table()
    assert row["roofline"] == "unrated:cpu" and "mfu" not in row


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "gpu_h100_sxm"), ("NVIDIA H100 SXM5 80GB", "gpu_h100_sxm"),
    ("NVIDIA H100 PCIe", "gpu_h100_pcie"), ("NVIDIA H100 NVL", "unknown"), ("NVIDIA A100-SXM4-80GB", "unknown"),
])
def test_h100_name_resolution(name, key):
    p = tpl.platform_peaks("cuda", name=name)
    assert p["platform"] == "gpu" and p["device_kind"] == name
    assert {k: p[k] for k in tpl.PEAKS[key]} == tpl.PEAKS[key]
    led = tpl.ProgramLedger(ttel.MetricsRegistry())
    led.set_platform(p)
    led.registry.histogram("w").observe(0.5)
    led.bind("p", "w", gauge="g")
    led.capture("p", {"flops": 1e14, "bytes_accessed": 1e11}, 0.1)
    (row,) = led.table()
    if key == "unknown":
        assert row["roofline"] == "unrated:gpu" and "mfu" not in row
    else:
        assert row["mfu"] == pytest.approx(1e14 / 0.5 / 1e12 / tpl.PEAKS[key]["peak_tflops"])
        assert row["roofline"] == "compute-bound"


def test_hbm_snapshot_warn_threshold_equals_jax(monkeypatch):
    stats = {"bytes_in_use": 95, "peak_bytes_in_use": 97, "bytes_limit": 100}
    monkeypatch.setattr(jmem, "device_memory_stats", lambda device=None: dict(stats))
    monkeypatch.setattr(tmem, "device_memory_stats", lambda device=None: dict(stats))
    for pools, frac in (({"params": 60, "kv": 35, "empty": 0}, 0.9), ({"params": 60}, 0.99)):
        assert tpl.hbm_snapshot(pools, warn_fraction=frac) == jpl.hbm_snapshot(pools, warn_fraction=frac)
    assert tpl.hbm_snapshot({"params": 60}, warn_fraction=0.9)["warn"] is True
    # the caching allocator's reserved bytes count toward the warning too
    monkeypatch.setattr(tmem, "device_memory_stats", lambda device=None: {**stats, "bytes_in_use": 50,
                                                                          "bytes_reserved": 95})
    assert tpl.hbm_snapshot({"params": 60}, warn_fraction=0.9)["warn"] is True
    monkeypatch.undo()
    assert tmem.device_memory_stats("cpu") == {} and tmem.see_memory_usage("x") == {}


# -- the kernels' cost formulas against PERF.md section 6 -------------------------------

HBM, BF16 = 3.35e12, 989e12  # the bounds' data-sheet rates


def _bound_us(flops, nbytes, peak=BF16):
    return round(max(nbytes / HBM, flops / peak) * 1e6, 1)


def test_kernel_cost_formulas_reproduce_the_kernel_table():
    """Each entry point's (flops, bytes) at the table's shapes gives the
    table's operations, bytes and bound (``PERF.md`` §6, rows 1-10)."""
    (f, b), = da.decode_cost(8, 1024, 12, 64, 2).values()  # row 1, pos 1023: every key live
    assert round(b / 1e6, 1) == 25.2 and _bound_us(f, b, 67e12) == 7.5
    flash = fa.flash_cost(8, 1024, 1024, 12, 64, 2)  # rows 2-4, causal
    assert round(flash["flash_forward"][1] / 1e6, 1) == 50.7 and _bound_us(*flash["flash_forward"]) == 15.1
    assert round(flash["flash_backward_dkdv"][0] / 1e9, 1) == 25.8 and _bound_us(*flash["flash_backward_dkdv"]) == 26.1
    assert round(flash["flash_backward_dq"][0] / 1e9, 1) == 19.3 and _bound_us(*flash["flash_backward_dq"]) == 19.6
    x = fx.xent_cost(16384, 768, 50304, 2)  # rows 5-7
    assert round(x["fused_xent_forward"][0] / 1e12, 2) == 1.27
    assert round(max(x["fused_xent_forward"][1] / HBM, x["fused_xent_forward"][0] / BF16) * 1e3, 2) == 1.28
    pair = [sum(x[k][i] for k in ("xent_ds_pass", "xent_dw_pass", "xent_dh_pass")) for i in (0, 1)]
    assert round(pair[0] / 1e12, 2) == 3.80 and round(pair[0] / BF16 * 1e3, 2) == 3.84
    for row in ("xent_dh_pass", "xent_dw_pass"):  # one row alone: the ds pass and its own product
        alone = x["xent_ds_pass"][0] + x[row][0]
        assert round(alone / 1e12, 2) == 2.53 and round(alone / BF16 * 1e3, 2) == 2.56
    layout = SPARSITY_CONFIGS["fixed"](num_heads=12, block=64, num_local_blocks=4, num_global_blocks=1,
                                       attention="unidirectional").make_layout(8192)
    lists = sk.device_lists(layout, True, 8192, "cpu")  # rows 8-10: fixed-64, B=2, S=8192
    assert lists.pairs == 2304 == int(lists.k_counts.sum())
    s = sk.sparse_cost(2, 8192, 12, 64, 2, lists)
    assert [round(s[k][0] / 1e9, 1) for k in ("sparse_forward", "sparse_backward_dq", "sparse_backward_dkdv")] \
        == [58.0, 87.0, 116.0]
    assert [_bound_us(*s[k]) for k in ("sparse_forward", "sparse_backward_dq", "sparse_backward_dkdv")] \
        == [58.6, 87.9, 117.3]


# -- the report CLI: one JSONL, both packages -------------------------------------------

@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    """A JAX training engine and the port's from the same weights, with the
    JAX package's default telemetry (the ledger on), a JSONL sink and
    wall_clock_breakdown; three steps each, then a snapshot."""
    d = tmp_path_factory.mktemp("pair")
    out = {}
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 33)).astype(np.int32)
    for P in ("jax", "torch"):
        ds = base_config(train_batch_size=4, train_micro_batch_size_per_gpu=2, wall_clock_breakdown=True,
                         steps_per_print=3, telemetry={"enabled": True, "jsonl_path": str(d / f"{P}.jsonl")})
        if P == "jax":
            eng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh())
            params = jax.tree.map(np.asarray, eng.state["params"])
        else:
            cfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
            eng, _, _, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(cfg), config=ds, device="cpu",
                                                          model_parameters=interop.params_from_jax(params))
        for _ in range(3):
            eng.train_batch({"tokens": tokens})
        out[P] = {"snap": eng.telemetry_snapshot(), "jsonl": str(d / f"{P}.jsonl"), "engine": eng}
        eng.telemetry.close()
    return out


@pytest.fixture(scope="module")
def serving_jsonl(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "serving.jsonl"
    eng = deepspeed_tpu_torch.init_inference(ttfm.Model(ttfm.TransformerConfig(
        vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)), config={"dtype": "fp32"},
        device="cpu")
    srv = ServingEngine(eng, config={"n_slots": 2, "jsonl_path": str(path), "chunked_prefill": {"enabled": True},
                                     "prefix_cache": {"enabled": True}})
    srv.serve([Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32), max_new_tokens=4) for i in range(3)])
    srv.telemetry_snapshot()
    srv.telemetry.close()
    return str(path)


def test_engine_pair_ledger_rows_agree_where_both_count(engine_pair):
    j, t = engine_pair["jax"]["snap"], engine_pair["torch"]["snap"]
    jrow = next(r for r in j["program_ledger"] if r["name"] == "train/train_step")
    (trow,) = t["program_ledger"]
    assert trow["name"] == "train/train_step"
    assert t["platform"] == j["platform"] and trow["roofline"] == jrow["roofline"] == "unrated:cpu"
    for row in (jrow, trow):
        assert row["flops"] > 0 and row["bytes_accessed"] > 0 and row["compiles"] >= 1
        assert row["wall_count"] == 3 and row["achieved_tflops"] > 0
    assert trow["arith_intensity"] == pytest.approx(trow["flops"] / trow["bytes_accessed"])
    # one batch shape, one signature: the port's step "compiles" once (this
    # jax build traces the JAX step twice on its first calls)
    assert [(r["name"], r["compiles"]) for r in t["recompile_table"]] == [("train/train_step", 1)]
    assert trow["compiles"] == 1 and "train/train_step" in {r["name"] for r in j["recompile_table"]}
    janat = next(r for r in j["step_anatomy"] if r["name"] == "train/train_step")
    (tanat,) = t["step_anatomy"]
    assert {k: tanat[k] for k in ("platform", "compute_time_s", "hbm_time_s", "comm_time_s",
                                  "exposed_comm_estimate_s", "comm_rated")} == \
        {k: janat[k] for k in ("platform", "compute_time_s", "hbm_time_s", "comm_time_s",
                               "exposed_comm_estimate_s", "comm_rated")}
    for name in ("timer/train_batch_sec", "timer/step_dispatch_sec"):
        assert t["metrics"]["histograms"][name]["count"] == j["metrics"]["histograms"][name]["count"] == 3
    assert "train/arith_intensity" in t["metrics"]["gauges"] and "train/arith_intensity" in j["metrics"]["gauges"]
    assert t["hbm"]["pools"] == j["hbm"]["pools"]


@pytest.mark.parametrize("source", ["torch", "jax", "serving"])
@pytest.mark.parametrize("mode", [[], ["--step-anatomy"], ["--json"]], ids=["summary", "step_anatomy", "json"])
def test_report_text_equals_jax(engine_pair, serving_jsonl, capsys, source, mode):
    path = serving_jsonl if source == "serving" else engine_pair[source]["jsonl"]
    assert jreport.main([path, *mode]) == 0
    jtext = capsys.readouterr().out
    assert treport.main([path, *mode]) == 0
    assert capsys.readouterr().out == jtext
    if not mode:
        assert "program roofline" in jtext and ("unrated" in jtext)


def test_report_watch_on_an_injected_clock_equals_jax(engine_pair):
    path = engine_pair["torch"]["jsonl"]
    outs = {}
    for name, rep in (("jax", jreport), ("torch", treport)):
        out, sleeps = io.StringIO(), []
        assert rep.watch_loop(lambda: rep.summarize(rep.load_events(path)), 1.5, out=out,
                              sleep=sleeps.append, iterations=2) == 0
        outs[name] = (out.getvalue(), sleeps)
    assert outs["torch"] == outs["jax"] and outs["torch"][1] == [1.5]
    assert outs["torch"][0].count(treport._CLEAR) == 2


# -- serving: the ledger adds no program and no call ------------------------------------

def test_serving_ledger_adds_no_program_and_no_call():
    eng = deepspeed_tpu_torch.init_inference(ttfm.Model(ttfm.TransformerConfig(
        vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)), config={"dtype": "fp32"},
        device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, size=4 + 5 * i).astype(np.int32) for i in range(5)]
    runs = {}
    for on in (False, True):
        srv = ServingEngine(eng, config={"n_slots": 2, "watchdog_mode": "raise", "ledger": {"enabled": on},
                                         "chunked_prefill": {"enabled": True, "chunk_size": 16},
                                         "speculation": {"enabled": True, "depth": 2}})
        before = da.decode_attention.launches
        res = srv.serve([Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
        snap = srv.telemetry_snapshot()
        runs[on] = {"tokens": {u: r.tokens.tolist() for u, r in res.items()}, "compiles": srv.compile_counts(),
                    "programs": {r["name"]: r["compiles"] for r in snap["recompile_table"]},
                    "counters": {k: v for k, v in snap["metrics"]["counters"].items()},
                    "launches": da.decode_attention.launches - before, "ledger": snap.get("program_ledger")}
    on, off = runs[True], runs[False]
    for key in ("tokens", "compiles", "programs", "counters", "launches"):
        assert on[key] == off[key], key
    assert off["ledger"] is None
    assert {r["name"] for r in on["ledger"]} == set(on["programs"])
    decode = next(r for r in on["ledger"] if r["name"] == "serving/decode")
    assert decode["flops"] > 0 and decode["roofline"] == "unrated:cpu" and decode["wall_count"] > 0


# -- timers, memory and the debug name maps -----------------------------------------------

def test_timers_mirror_into_the_registry_as_jax():
    regs = {}
    for name, mod, reg_cls in (("jax", jtimer, jtel.MetricsRegistry), ("torch", ttimer, ttel.MetricsRegistry)):
        reg = reg_cls()
        timers = mod.SynchronizedWallClockTimer(registry=reg)
        for _ in range(3):
            timers("fwd").start()
            timers("fwd").stop()
        timers("bwd").start()
        timers("bwd").stop()
        tput = mod.ThroughputTimer(batch_size=8, start_step=0, steps_per_output=2, registry=reg)
        for _ in range(4):
            tput.start()
            tput.stop()
        timers.log(["fwd", "bwd"], memory_breakdown=True)
        snap = reg.snapshot()
        regs[name] = ({k: v["count"] for k, v in snap["histograms"].items()}, sorted(snap["gauges"]),
                      timers("fwd").count)
    assert regs["torch"] == regs["jax"]
    assert regs["torch"][0] == {"timer/fwd_sec": 3, "timer/bwd_sec": 1}
    assert regs["torch"][1] == ["train/samples_per_sec"]
    t = ttimer.SynchronizedWallClockTimer(registry=ttel.MetricsRegistry())
    t("x").start(barrier=torch.zeros(1))
    t("x").stop(barrier=torch.zeros(1))  # a CPU barrier synchronises nothing
    assert t("x").count == 1


def test_debug_param_names_equal_jax():
    params = jax.tree.map(np.asarray, tiny_transformer().init(jax.random.PRNGKey(0)))
    tparams = interop.params_from_jax(params)
    jnames = jdebug.extract_param_names(params)
    tnames = tdebug.extract_param_names(tparams)
    assert sorted(tnames) == sorted(jnames)
    assert all(tuple(tnames[k].shape) == tuple(jnames[k].shape) for k in jnames)
    leaf = tnames["layers/wq"]
    assert tdebug.debug_param_name(leaf) == "layers/wq"
    assert len(tdebug.tree_summary(tparams, max_leaves=3).splitlines()) == 4
    module = torch.nn.Linear(3, 2)
    assert sorted(tdebug.extract_param_names(module)) == ["bias", "weight"]


def test_snapshot_json_round_trips(engine_pair):
    snap = engine_pair["torch"]["snap"]
    json.loads(json.dumps(snap))
    assert snap["program_ledger"][0]["ops"] > 0
