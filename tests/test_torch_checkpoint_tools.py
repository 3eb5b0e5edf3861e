"""Port parity: the offline checkpoint tools (``checkpoint/universal.py``,
``checkpoint/state_dict_factory.py``), ``save_16bit_model`` and async saves.

The two packages share the on-disk format 3, so a reshape of one
port-saved checkpoint by each package must give the same manifest and the
same bytes in every file; the Megatron merge and split are pure numpy and
exact; both engines' ``save_16bit_model`` from the same weights write the
same keys and bitwise-equal bf16 tensors.
"""

import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import state_dict_factory as jsdf
from deepspeed_tpu.checkpoint import universal as juniv
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.checkpoint import state_dict_factory as tsdf
from deepspeed_tpu_torch.checkpoint import universal as tuniv
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import engine as tengine

MODEL = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32)
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 10**9}
TOKENS = np.random.default_rng(0).integers(0, 97, size=(4, 33)).astype(np.int32)


def _port_engine(ds=DS, params=None, **model_kw):
    cfg = ttfm.TransformerConfig(**MODEL, **model_kw)
    return tengine.DeepSpeedEngine(ttfm.Model(cfg), ds, params=params, device="cpu")


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A port-saved checkpoint after two steps (so the optimizer moments are
    not zero)."""
    root = tmp_path_factory.mktemp("port_ckpt")
    eng = _port_engine()
    eng.train_batch({"tokens": TOKENS})
    eng.train_batch({"tokens": TOKENS})
    eng.save_checkpoint(str(root), tag="t")
    return str(root / "t")


def _tree_files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


RESHAPES = {"merge": (1, None), "two": (2, None), "four": (4, None), "eight_some_keys": (8, ["params::wte",
                                                                                          "opt::m::wte"])}


@pytest.mark.parametrize("name", list(RESHAPES))
def test_reshape_gives_the_jax_tools_manifest_and_bytes(port_ckpt, tmp_path, name):
    num_files, keys = RESHAPES[name]
    if name == "merge":
        jm = juniv.merge_checkpoint(port_ckpt, str(tmp_path / "jax"))
        tm = tuniv.merge_checkpoint(port_ckpt, str(tmp_path / "port"))
    else:
        jm = juniv.reshape_checkpoint(port_ckpt, str(tmp_path / "jax"), num_files, keys=keys)
        tm = tuniv.reshape_checkpoint(port_ckpt, str(tmp_path / "port"), num_files, keys=keys)
    assert tm == jm
    assert _tree_files(tmp_path / "port") == _tree_files(tmp_path / "jax")
    assert tuniv.inspect_checkpoint(str(tmp_path / "port")) == juniv.inspect_checkpoint(str(tmp_path / "port"))
    if num_files > 1 and keys is None:
        assert any("shards" in e for e in tm["leaves"].values())
    # the reshaped checkpoint is first-class: it verifies and loads into the port
    saver.verify_checkpoint(str(tmp_path / "port"))
    eng = _port_engine()
    eng.load_checkpoint(str(tmp_path), tag="port")
    want = saver.consolidate_checkpoint(port_ckpt)
    for key, arr in saver._flatten_with_paths(eng.state).items():
        np.testing.assert_array_equal(arr.numpy(), want[key])


def test_inspect_matches_jax(port_ckpt):
    info = tuniv.inspect_checkpoint(port_ckpt)
    assert info == juniv.inspect_checkpoint(port_ckpt)
    assert info["total_files"] == len(info["leaves"]) and info["client_state"]["global_steps"] == 2


def _megatron_shards(rng, n, heads=4, hn=8, hidden=32):
    names = {"layers.0.attention.query_key_value.weight": (3 * heads * hn // n, hidden),
             "layers.0.attention.query_key_value.bias": (3 * heads * hn // n,),
             "layers.0.mlp.dense_h_to_4h.weight": (4 * hidden // n, hidden),
             "layers.0.attention.dense.weight": (hidden, heads * hn // n),
             "layers.0.mlp.dense_4h_to_h.weight": (hidden, 4 * hidden // n),
             "word_embeddings.weight": (64 // n, hidden),
             "layers.0.input_layernorm.weight": (hidden,)}
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in names.items()} for _ in range(n)]


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
@pytest.mark.parametrize("src,dst", [(2, 1), (2, 4), (4, 2), (1, 2)])
def test_state_dict_factory_merge_and_split_match_jax(version, src, dst):
    shards = _megatron_shards(np.random.default_rng(src * 10 + dst), src)
    jl = jsdf.SDLoaderFactory.get_sd_loader(shards, num_heads=4, version=version)
    tl = tsdf.SDLoaderFactory.get_sd_loader(shards, num_heads=4, version=version)
    jm, tm = jl.merge_state_dict(), tl.merge_state_dict()
    assert list(tm) == list(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k])
    for rank in range(dst):
        js, ts = jl.get_split_state_dict(dst, rank), tl.get_split_state_dict(dst, rank)
        assert list(ts) == list(js)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
    # the primitives alone, and merge(split) is the identity
    p = shards[0]["layers.0.attention.query_key_value.weight"]
    parts = [tsdf.split_query_key_value(p, 2, i, version=version) for i in range(2)]
    np.testing.assert_array_equal(tsdf.merge_query_key_value(parts, version=version), p)
    np.testing.assert_array_equal(parts[1], jsdf.split_query_key_value(p, 2, 1, version=version))


def test_state_dict_factory_npz_and_refusals(tmp_path):
    shards = _megatron_shards(np.random.default_rng(0), 2)
    paths = []
    for i, sd in enumerate(shards):
        paths.append(str(tmp_path / f"rank{i}.npz"))
        np.savez(paths[-1], **sd)
    merged = tsdf.SDLoaderFactory.get_sd_loader(paths, num_heads=4).merge_state_dict()
    ref = jsdf.SDLoaderFactory.get_sd_loader(paths, num_heads=4).merge_state_dict()
    for k in ref:
        np.testing.assert_array_equal(merged[k], ref[k])
    with pytest.raises(ValueError):
        tsdf.SDLoaderFactory.get_sd_loader(shards, sd_type="HF")
    with pytest.raises(ValueError):
        tsdf.MegatronSDLoader([str(tmp_path / "x.bin")], num_heads=4)


BF16_DS = dict(DS, bf16={"enabled": True})


def test_save_16bit_model_matches_jax(tmp_path):
    """Both engines from the same fp32 weights: the same keys in the same
    order, bf16 tensors bitwise equal (both round to nearest even)."""
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(**MODEL, dtype=jnp.bfloat16)),
                                             config=BF16_DS, mesh=single_device_mesh())
    init = jax.tree.map(np.asarray, jeng.state["params"])
    rng = np.random.default_rng(3)  # values that need rounding to bf16
    init = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 1e-3, init)
    jeng.state["params"] = jax.tree.map(jnp.asarray, init)
    teng = _port_engine(BF16_DS, params=interop.params_from_jax(init), dtype=torch.bfloat16)
    jeng.save_16bit_model(str(tmp_path / "jax"))
    teng.save_16bit_model(str(tmp_path / "port"), save_filename="w.pt")
    jsd = torch.load(tmp_path / "jax" / "model_weights.pt")
    tsd = torch.load(tmp_path / "port" / "w.pt")
    assert list(tsd) == list(jsd) and "layers/wq" in tsd
    for k in jsd:
        assert tsd[k].dtype == jsd[k].dtype == torch.bfloat16, k
        assert torch.equal(tsd[k].view(torch.int16), jsd[k].view(torch.int16)), k
    assert torch.equal(tsd["wte"], teng.state["params"]["wte"].to(torch.bfloat16))


def test_async_save_loads_equal_to_a_sync_save(tmp_path):
    eng = _port_engine(dict(DS, checkpoint={"async_save": True}), hidden_dropout=0.1)
    sync = _port_engine(params=None, hidden_dropout=0.1)
    for e in (eng, sync):
        e.train_batch({"tokens": TOKENS})
    sync.state = eng.state
    sync.save_checkpoint(str(tmp_path / "sync"))
    eng.save_checkpoint(str(tmp_path / "async"))
    eng.train_batch({"tokens": TOKENS})  # a step while the writer runs: the snapshot is the saved state
    eng.checkpoint_engine.commit()
    a, s = (json.loads((tmp_path / d / "global_step1" / "manifest.json").read_text()) for d in ("async", "sync"))
    assert a == s  # the same leaves, digests and client state
    for d in ("async", "sync"):
        fresh = _port_engine()
        fresh.load_checkpoint(str(tmp_path / d))
        for x, y in zip(tree_leaves(fresh.state), tree_leaves(sync.state)):
            assert torch.equal(x, y)


def test_async_save_holds_its_checkpoint_engine_only_until_commit(tmp_path):
    """The exit hook that commits an in-flight async save keeps the
    checkpoint engine (and its pinned staging buffer) alive only while that
    save is pending: a dropped engine's pending save still commits, and
    once committed the checkpoint engine is freed with its owner."""
    eng = _port_engine(dict(DS, checkpoint={"async_save": True}))
    eng.train_batch({"tokens": TOKENS})
    eng.save_checkpoint(str(tmp_path / "a"))
    ckpt = weakref.ref(eng.checkpoint_engine)
    del eng
    gc.collect()
    assert ckpt() is not None and not (tmp_path / "a" / "latest").exists()
    ckpt().commit()
    assert (tmp_path / "a" / "latest").read_text() == "global_step1"
    gc.collect()
    assert ckpt() is None
    eng = _port_engine(dict(DS, checkpoint={"async_save": True}))
    eng.save_checkpoint(str(tmp_path / "b"))
    eng.checkpoint_engine.commit()
    ckpt = weakref.ref(eng.checkpoint_engine)
    del eng
    gc.collect()
    assert ckpt() is None
