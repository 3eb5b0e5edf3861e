"""Port parity: checkpoints under tensor parallelism.

A save under a ``model`` axis writes each distinct shard once, with its
bounds on every split dimension, as a JAX multi-device save lists them.
Checked here, over the session-wide runs of ``test_torch_tp_training.py``
(``tp_runs``):

  * a tp-2 ZeRO-1 save loads into a port engine at tp 1 (one process, no
    process group) and at ``data 2 x model 2`` under ZeRO 3, and equals the
    saving world's state, gathered to full shape, leaf for leaf
    (parameters and both Adam moments);
  * a JAX ZeRO-3 save on its ``{fsdp: 4, model: 2}`` mesh loads in the
    port at ``data 2 x model 2`` under ZeRO 3 with the parameters and the
    moments exact (JAX ``test_checkpoint.py:65-81``);
  * the port's save at ``data 2 x model 2`` under ZeRO 3 lists the same
    shards, in the same order, as the JAX engine's save on that mesh.
"""

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.models import transformer as tfm
from simple_model import base_config
from test_torch_tp_training import MODEL, tp_runs  # noqa: F401  (the session-wide runs)


def _world_state(world, case, what):
    prefix = f"{case}::{what}::"
    return {k[len(prefix):]: v for k, v in world[0][0].items() if k.startswith(prefix)}


def test_tp2_save_loads_at_tp1_leaf_for_leaf(tp_runs):
    eng = deepspeed_tpu_torch.initialize(
        model=tfm.Model(tfm.TransformerConfig(**MODEL, dtype=torch.float32)),
        config=base_config(train_micro_batch_size_per_gpu=8, zero_optimization={"stage": 1}), device="cpu")[0]
    eng.load_checkpoint(tp_runs["save_tp2s1"], tag="port")
    assert int(eng.state["step"]) == 3
    params = _world_state(tp_runs["w2"], "tp2s1", "params")
    opt = _world_state(tp_runs["w2"], "tp2s1", "opt")
    got = {k: t.numpy() for k, t in saver._flatten_with_paths(eng.state["params"]).items()}
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    got_opt = {k: t.numpy() for k, t in saver._flatten_with_paths(
        {m: eng.state["opt"][m] for m in ("m", "v")}).items()}
    assert set(got_opt) == set(opt)
    for k, v in opt.items():
        np.testing.assert_array_equal(got_opt[k], v, err_msg=k)
    manifest = saver.read_manifest(str(tp_runs["save_tp2s1"]) + "/port")
    wq = manifest["leaves"]["params::layers::wq"]
    assert wq["shape"] == [2, 64, 4, 16] and [s["index"][2] for s in wq["shards"]] == [[0, 2], [2, 4]]


def test_tp2_save_loads_at_data2_model2_zero3(tp_runs):
    params = _world_state(tp_runs["w2"], "tp2s1", "params")
    opt = _world_state(tp_runs["w2"], "tp2s1", "opt")
    for r in range(4):
        for what, ref in (("params", params), ("opt", opt)):
            prefix = f"tp2load::loaded::{what}::"
            got = {k[len(prefix):]: v for k, v in tp_runs["w4"][0][r].items() if k.startswith(prefix)}
            assert set(got) == set(ref), what
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {r} {what}::{k}")


def test_jax_fsdp4_model2_zero3_save_loads_at_data2_model2(tp_runs):
    want = tp_runs["jax"]["fsdp4"]
    for r in range(4):
        for what, ref in (("params", want["params"]), ("opt::m", want["m"]), ("opt::v", want["v"])):
            prefix = f"jaxload::loaded::{what}::"
            got = {k[len(prefix):]: v for k, v in tp_runs["w4"][0][r].items() if k.startswith(prefix)}
            assert set(got) == set(ref), what
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {r} {what}::{k}")


def test_manifest_shard_table_equals_jax_on_the_same_mesh(tp_runs):
    jm, pm = tp_runs["jax"]["x3_manifest"], tp_runs["port_x3_manifest"]
    compared = 0
    for key, je in jm["leaves"].items():
        if not key.startswith(("params::", "opt::m::", "opt::v::")):
            continue
        pe = pm["leaves"][key]
        assert pe["shape"] == je["shape"], key
        assert ("shards" in pe) == ("shards" in je), key
        if "shards" in je:
            assert [s["index"] for s in pe["shards"]] == [s["index"] for s in je["shards"]], key
            assert [s["file"] for s in pe["shards"]] == [s["file"] for s in je["shards"]], key
            compared += 1
    assert compared >= 20
