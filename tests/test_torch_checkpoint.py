"""Port parity: checkpoint save and resume.

The port writes the JAX package's format 3 (a crc32 manifest and one
``.npy`` per leaf under ``::``-joined keys), so a checkpoint moves between
the packages both ways: a JAX engine's checkpoint sharded over the 8-device
CPU mesh loads into the port, and the port's into the JAX engine. After a
load the next step of either engine tracks the other with the tolerances of
tests/test_torch_training.py (loss 1e-5, grad norm 1e-4 relative). Within the
port a round trip is bitwise, and train 2 + save + load + train 3 equals
train 5 bitwise with dropout on.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh, single_device_mesh
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.resilience.errors import CheckpointCorruptError, CheckpointNotFoundError
from simple_model import base_config, tiny_transformer

DS = base_config(train_batch_size=8, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=1,
                 optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}})
TCFG = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
TOKENS = np.random.default_rng(0).integers(0, 128, size=(8, 33)).astype(np.int32)


def _port_engine(params=None, cfg=TCFG, ds=DS):
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(cfg), config=ds, model_parameters=params,
                                                  device="cpu")
    return eng


def _flat(state):
    return {k: v for k, v in saver._flatten_with_paths(state).items()}


def _assert_states_equal(port_state, jax_state):
    jflat = {"::".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(jax_state))[0]}
    tflat = _flat(port_state)
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert v.shape == jflat[k].shape, k
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)


def _assert_next_step_tracks(teng, jeng):
    jm = jax.device_get(jeng.train_batch({"tokens": TOKENS}))
    tm = teng.train_batch({"tokens": TOKENS})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert teng.get_global_step() == jeng.get_global_step()


def test_round_trip_is_bitwise(tmp_path):
    eng = _port_engine()
    eng.train_batch({"tokens": TOKENS})
    eng.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert (tmp_path / "zero_to_fp32.py").exists()
    fresh = _port_engine()
    tag, client = fresh.load_checkpoint(str(tmp_path))
    assert tag == "global_step1" and client["note"] == "hi" and client["global_steps"] == 1
    assert fresh.global_steps == 1 and fresh.global_samples == 8
    a, b = _flat(eng.state), _flat(fresh.state)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_manifest_matches_jax(tmp_path):
    """The same state saved by both packages: the same leaf keys, shapes,
    dtypes, file names, format, and client-state keys among the JAX
    engine's (both key their dropout masks on the device step)."""
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=DS, mesh=single_device_mesh())
    teng = _port_engine(interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"])))
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    teng.save_checkpoint(str(tmp_path / "port"), tag="t")
    jm = json.loads((tmp_path / "jax" / "t" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "t" / "manifest.json").read_text())
    assert tm["format"] == jm["format"] == 3
    assert tm["leaves"] == jm["leaves"]
    assert set(tm["checksums"]) == set(jm["checksums"])
    assert set(tm["client_state"]) <= set(jm["client_state"])
    for fname, crc in tm["checksums"].items():  # identical arrays give identical files
        if fname.startswith("params::"):
            assert crc == jm["checksums"][fname], fname


def test_sharded_jax_checkpoint_loads_into_the_port(tmp_path):
    """ZeRO-3 over the 8-device CPU mesh writes shard files; the port
    assembles each leaf whole, equal to the JAX state, and the next step
    tracks the JAX engine's next step."""
    ds = dict(DS, train_micro_batch_size_per_gpu=1, zero_optimization={"stage": 3})
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds,
                                             mesh=build_mesh(MeshConfig(data=8)))
    jeng.train_batch({"tokens": TOKENS})
    jeng.save_checkpoint(str(tmp_path))
    manifest = json.loads((tmp_path / "global_step1" / "manifest.json").read_text())
    assert any("shards" in e for e in manifest["leaves"].values())
    teng = _port_engine()
    tag, _ = teng.load_checkpoint(str(tmp_path))
    assert tag == "global_step1" and teng.global_steps == 1
    _assert_states_equal(teng.state, jeng.state)
    _assert_next_step_tracks(teng, jeng)


def test_port_checkpoint_loads_into_the_jax_engine(tmp_path):
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=DS, mesh=single_device_mesh())
    teng = _port_engine(interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"])))
    teng.train_batch({"tokens": TOKENS})
    teng.save_checkpoint(str(tmp_path))
    tag, client = jeng.load_checkpoint(str(tmp_path))
    assert tag == "global_step1" and jeng.global_steps == 1 and client["rng_seed"] == teng.config.seed
    _assert_states_equal(teng.state, jeng.state)
    _assert_next_step_tracks(teng, jeng)


def test_corrupt_and_missing_checkpoints_raise_typed_errors(tmp_path):
    eng = _port_engine()
    eng.save_checkpoint(str(tmp_path), tag="a")
    victim = tmp_path / "a" / "params::wte.full.npy"
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        _port_engine().load_checkpoint(str(tmp_path), tag="a")
    with pytest.raises(CheckpointNotFoundError):
        _port_engine().load_checkpoint(str(tmp_path), tag="missing")
    with pytest.raises(CheckpointNotFoundError):
        saver.read_manifest(str(tmp_path / "nowhere"))
    assert _port_engine().load_checkpoint(str(tmp_path / "empty")) == (None, {})


def test_latest_falls_back_to_the_newest_intact_tag(tmp_path):
    eng = _port_engine()
    for _ in range(3):
        eng.train_batch({"tokens": TOKENS})
        eng.save_checkpoint(str(tmp_path))
    assert saver.find_checkpoints(str(tmp_path)) == ["global_step3", "global_step2", "global_step1"]
    os.remove(tmp_path / "global_step3" / "opt::m::wte.full.npy")  # torn
    fresh = _port_engine()
    tag, client = fresh.load_checkpoint(str(tmp_path))
    assert tag == "global_step2" and fresh.global_steps == 2 and int(fresh.state["step"]) == 2
    assert (tmp_path / "latest").read_text() == "global_step2"
    with pytest.raises(CheckpointCorruptError):  # an explicit tag never falls back
        _port_engine().load_checkpoint(str(tmp_path), tag="global_step3")


def test_keep_last_k_prunes(tmp_path):
    eng = _port_engine(ds=dict(DS, checkpoint={"keep_last_k": 2}))
    for _ in range(4):
        eng.train_batch({"tokens": TOKENS})
        eng.save_checkpoint(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == ["global_step3", "global_step4"]
    # async saves keep keep_last_k too: the save still in flight counts among the k
    eng = _port_engine(ds=dict(DS, checkpoint={"keep_last_k": 2, "async_save": True}))
    for _ in range(4):
        eng.train_batch({"tokens": TOKENS})
        eng.save_checkpoint(str(tmp_path / "async"))
        assert len([p for p in (tmp_path / "async").iterdir() if p.is_dir()]) <= 3  # k + the staging dir
    eng.checkpoint_engine.commit()
    assert sorted(p.name for p in (tmp_path / "async").iterdir() if p.is_dir()) == ["global_step3",
                                                                                    "global_step4"]
    assert (tmp_path / "async" / "latest").read_text() == "global_step4"


def test_resume_with_dropout_is_bitwise(tmp_path):
    """train 2 + save + load into a fresh engine + train 3 == train 5: the
    state comes back exactly and the host's step count reseeds the dropout
    generators, so every mask is the uninterrupted run's."""
    cfg = TCFG.replace(hidden_dropout=0.1, attn_dropout=0.1, attn_impl="flash")
    params = ttfm.init(cfg, torch.Generator().manual_seed(3))
    ds = dict(DS, seed=7)
    straight = _port_engine(params, cfg, ds)
    ref = [float(straight.train_batch({"tokens": TOKENS})["loss"]) for _ in range(5)]
    first = _port_engine(params, cfg, ds)
    got = [float(first.train_batch({"tokens": TOKENS})["loss"]) for _ in range(2)]
    first.save_checkpoint(str(tmp_path))
    second = _port_engine(ttfm.init(cfg, torch.Generator().manual_seed(99)), cfg, dict(ds, seed=1))
    second.load_checkpoint(str(tmp_path))
    got += [float(second.train_batch({"tokens": TOKENS})["loss"]) for _ in range(3)]
    assert got == ref
    for a, b in zip(topt.tree_leaves(second.state["params"]), topt.tree_leaves(straight.state["params"])):
        assert torch.equal(a, b)


def test_zero_to_fp32_reads_the_port_checkpoint(tmp_path):
    eng = _port_engine()
    eng.train_batch({"tokens": TOKENS})
    eng.save_checkpoint(str(tmp_path))
    out = tmp_path / "weights.npz"
    proc = subprocess.run([sys.executable, str(tmp_path / "zero_to_fp32.py"), str(tmp_path), str(out)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    weights = np.load(out)
    for key, leaf in _flat(eng.state["params"]).items():
        np.testing.assert_array_equal(weights[f"params::{key}"], leaf.numpy())
    full = saver.consolidate_checkpoint(str(tmp_path / "global_step1"))
    np.testing.assert_array_equal(full["step"], np.int32(1))
