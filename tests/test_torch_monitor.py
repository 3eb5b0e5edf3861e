"""Port parity: the CSV monitor (``monitor/monitor.py``), the telemetry
bridge into it and the training engine's events and telemetry block.

The same events through the JAX ``MonitorMaster`` and the port's give the
same CSV files, byte for byte. A training run writes one row per step to
each of its two tags, as the JAX engine does.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.telemetry import MetricsRegistry as JRegistry
from deepspeed_tpu.telemetry import MonitorBridge as JBridge
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.telemetry import MetricsRegistry as TRegistry
from deepspeed_tpu_torch.telemetry import MonitorBridge as TBridge
from simple_model import tiny_transformer

EVENTS = [("Train/Samples/train_loss", 4.5, 8), ("Train/Samples/lr", 1e-3, 8), ("a/b", 1, 1), ("a_b", 2, 2),
          ("Train/Samples/train_loss", np.float32(4.25), 16), ("x", float("nan"), 3)]


def _files(d):
    return {name: open(os.path.join(d, name)).read() for name in sorted(os.listdir(d))}


def _cfg(mod, path, job="run"):
    return mod.DeepSpeedConfig.from_dict({"train_batch_size": 2, "csv_monitor": {
        "enabled": True, "output_path": str(path), "job_name": job}}, world_size=1)


@pytest.mark.parametrize("split", [1, 2, 6])
def test_csv_files_match_jax(tmp_path, split):
    """The events in batches of ``split``: the same file per tag, one
    header each (two tags that map to one file share it), the same rows."""
    jm, tm = jmon.MonitorMaster(_cfg(jconfig, tmp_path / "jax")), tmon.MonitorMaster(_cfg(tconfig, tmp_path / "port"))
    assert jm.enabled and tm.enabled
    for i in range(0, len(EVENTS), split):
        jm.write_events(EVENTS[i:i + split])
        tm.write_events(EVENTS[i:i + split])
    jm.close()
    tm.close()
    jf, tf = _files(tmp_path / "jax" / "run"), _files(tmp_path / "port" / "run")
    assert tf == jf and len(tf) == 4
    assert tf["a_b.csv"] == "step,a/b\n1,1\n2,2\n"  # read in text mode


def test_csv_monitor_appends_and_is_off_by_default(tmp_path):
    tm = tmon.MonitorMaster(_cfg(tconfig, tmp_path))
    tm.write_events(EVENTS[:1])
    tm.close()
    again = tmon.MonitorMaster(_cfg(tconfig, tmp_path))  # a restarted job appends, no second header
    again.write_events(EVENTS[4:5])
    again.close()
    rows = list(csv.reader(open(tmp_path / "run" / "Train_Samples_train_loss.csv")))
    assert rows == [["step", "Train/Samples/train_loss"], ["8", "4.5"], ["16", "4.25"]]
    off = tmon.MonitorMaster(tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2}))
    assert not off.enabled
    off.write_events(EVENTS)  # nothing to write to


def test_monitor_bridge_events_match_jax():
    """A registry with a counter, a gauge and a histogram: the same events,
    histograms as p50/p90/p99, under the same tags."""
    events = []
    for Reg, Bridge in ((JRegistry, JBridge), (TRegistry, TBridge)):
        reg = Reg()
        reg.counter("resilience/ckpt_retries").inc(2)
        reg.gauge("train/loss").set(3.5)
        for v in (0.1, 0.2, 0.4, 0.8):
            reg.histogram("train/step_time_sec").observe(v)

        class Sink:
            enabled = True
            got = []

            def write_events(self, ev):
                self.got.extend(ev)

        sink = Sink()
        out = Bridge(sink).push(reg, 7)
        assert out == sink.got
        events.append(out)
    assert events[1] == events[0] and len(events[0]) == 5


DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 2}


def test_training_writes_one_row_per_step_like_jax(tmp_path):
    """Three train_batch steps from the same weights with csv_monitor on:
    the same two files with the same steps (samples) as the JAX engine's,
    the losses to 1e-5 and the lr exactly; with telemetry on, the bridge
    pushes the registry at the print boundary (step 2) and the JSONL sink
    gets the snapshot."""
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 33)).astype(np.int32)
    runs = {}
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), mesh=single_device_mesh(), config={
        **DS, "csv_monitor": {"enabled": True, "output_path": str(tmp_path / "jax"), "job_name": "j"}})
    init = jax.tree.map(np.asarray, jeng.state["params"])
    for _ in range(3):
        jeng.train_batch({"tokens": tokens})
    jeng.monitor.close()
    runs["jax"] = tmp_path / "jax" / "j"
    jsonl = tmp_path / "telemetry.jsonl"
    cfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
    teng = tengine.DeepSpeedEngine(ttfm.Model(cfg), {
        **DS, "csv_monitor": {"enabled": True, "output_path": str(tmp_path / "port"), "job_name": "j"},
        "telemetry": {"enabled": True, "jsonl_path": str(jsonl), "ledger": {"enabled": False}}},
        params=interop.params_from_jax(init), device="cpu")
    for _ in range(3):
        teng.train_batch({"tokens": tokens})
    runs["port"] = tmp_path / "port" / "j"
    jtags = sorted(os.listdir(runs["jax"]))
    assert [t for t in sorted(os.listdir(runs["port"])) if not t.startswith("Telemetry_")] == jtags
    for name in jtags:
        jrows = list(csv.reader(open(runs["jax"] / name)))
        trows = list(csv.reader(open(runs["port"] / name)))
        assert trows[0] == jrows[0] and len(trows) == len(jrows) == 4
        assert [r[0] for r in trows] == [r[0] for r in jrows] == [jrows[0][0], "4", "8", "12"]
        np.testing.assert_allclose([float(r[1]) for r in trows[1:]], [float(r[1]) for r in jrows[1:]], rtol=1e-5)
    # the bridge pushed the registry once (step 2 of 3), beside the engine's own tags
    bridged = [t for t in os.listdir(runs["port"]) if t.startswith("Telemetry_")]
    assert "Telemetry_train_steps.csv" in bridged and "Telemetry_train_step_time_sec_p50.csv" in bridged
    assert list(csv.reader(open(runs["port"] / "Telemetry_train_steps.csv")))[1:] == [["2", "2.0"]]
    snap = teng.telemetry_snapshot()
    assert snap["metrics"]["counters"]["train/steps"] == 3
    assert snap["metrics"]["histograms"]["train/step_time_sec"]["count"] == 3
    assert snap["hbm"]["pools"]["params"] > 0 and snap["hbm"]["pools"]["opt_state"] == 2 * snap["hbm"]["pools"]["params"]
    teng.telemetry.close()
    kinds = [json.loads(line).get("type") for line in open(jsonl)]
    assert "snapshot" in kinds and "span" in kinds


def test_telemetry_block_refusals_name_themselves():
    ok = tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2, "telemetry": {
        "enabled": True, "ledger": {"enabled": False, "hbm_warn_fraction": 0.5}}})
    assert ok.telemetry.enabled and ok.telemetry.ledger.hbm_warn_fraction == 0.5
    for block, name in ((({"enabled": True}), "telemetry.ledger"),
                        ({"ledger": {"enabled": False, "collectives": {"enabled": True}}},
                         "telemetry.ledger.collectives"),
                        ({"ledger": {"enabled": False}, "timeseries": {"enabled": True}}, "telemetry.timeseries"),
                        ({"ledger": {"enabled": False}, "slo": {"enabled": True}}, "telemetry.slo"),
                        ({"ledger": {"enabled": False}, "incidents": {"enabled": True}}, "telemetry.incidents")):
        with pytest.raises(NotImplementedError, match=name):
            tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2, "telemetry": block})
    with pytest.raises(tconfig.DeepSpeedConfigError, match="watchdog"):
        tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2, "telemetry": {"watchdog": "loud"}})
