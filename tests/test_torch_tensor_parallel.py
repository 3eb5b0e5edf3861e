"""Port parity: tensor-parallel serving's building blocks and engine.

The JAX ``InferenceEngine`` at ``tensor_parallel.tp_size`` 2 and 4 places
each weight with a sharding over the 8-device CPU mesh (``data`` x
``model``) and lets XLA derive the collectives; the port runs one gloo
process per tensor-parallel rank (``tests/torch_dp_worker.py tp_engine``,
one world of 2 and one of 4, each started once per session) with the
collectives written out. Checked here:

  * the KV-cache specs equal JAX's ``PartitionSpec``s over a grid of mesh
    shapes, slot counts and head counts;
  * ``interop.tp_params_from_jax`` gives each rank exactly the JAX array's
    shard on the device at the same mesh coordinates;
  * ``LinearLayer`` -> ``LinearAllreduce`` equals the dense product;
  * ``forward`` logits within 1e-4 of JAX's at the same ``tp_size`` (fp32,
    summation order only) and greedy ``generate`` tokens equal, for a
    GPT-2-like config, an ALiBi config and one whose heads and vocab ``tp``
    does not divide (those leaves stay whole on both sides); every rank
    returns the same outputs;
  * each refusal raises and names itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.parallel import sharding as jshd
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.comm.mesh import AXIS_ORDER, Mesh
from deepspeed_tpu_torch.inference import ServingEngine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.parallel import sharding as tshd
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from test_torch_comm import run_world, shared_once

BASE = dict(vocab_size=128, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)
CASES = {
    "gpt2": {},
    "alibi": dict(pos_emb="alibi", num_heads=8, hidden_size=64),
    # 6 heads: split 3 + 3 at tp 2, whole at tp 4; vocab 211 whole at both;
    # an untied head
    "nondiv": dict(num_heads=6, hidden_size=48, vocab_size=211, tie_embeddings=False),
}
MAX_NEW = 5


def _cfg(name: str) -> dict:
    return {**BASE, **CASES[name]}


def _flat(tree, prefix="", leaf=np.asarray) -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "::", leaf))
        else:
            out[key] = leaf(v)
    return out


def _tokens(name: str) -> np.ndarray:
    return np.random.default_rng(len(name)).integers(0, _cfg(name)["vocab_size"], size=(2, 9)).astype(np.int32)


def _jax_engine(name: str, tp: int):
    cfg = JaxConfig(**_cfg(name), dtype=jnp.float32, loss_chunk_size=0)
    return JaxInferenceEngine(model=JaxModel(cfg), config={"dtype": "fp32", "tensor_parallel": {"tp_size": tp}})


LAYERS = {k: v.astype(np.float32) for k, v in {
    "w1": np.random.default_rng(0).standard_normal((16, 32)) * 0.1, "b1": np.linspace(-1, 1, 32),
    "w2": np.random.default_rng(1).standard_normal((32, 16)) * 0.1, "b2": np.full(16, 0.5),
    "x": np.random.default_rng(2).standard_normal((4, 16))}.items()}


def _tp_world(tp):
    def compute(tmp):
        np.savez(tmp / "layers.npz", **LAYERS)
        cases, jax_out = [], {}
        for name in CASES:
            jeng = _jax_engine(name, tp)
            params = jax.tree.map(np.asarray, jeng.params)
            np.savez(tmp / f"{name}.npz", **_flat(params))
            tokens = _tokens(name)
            cases.append({"name": name, "model": _cfg(name), "params": str(tmp / f"{name}.npz"),
                          "tokens": tokens.tolist(), "max_new": MAX_NEW})
            jax_out[name] = {"logits": np.asarray(jeng.forward(tokens)),
                             "generate": np.asarray(jeng.generate(tokens, max_new_tokens=MAX_NEW))}
        arrays, meta = run_world("tp_engine", {"layers": str(tmp / "layers.npz"), "cases": cases}, tp, tmp)
        return jax_out, arrays, meta
    return compute


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def tp_world(request, tmp_path_factory):
    tp = request.param
    return (tp, *shared_once(tmp_path_factory, f"tp_engine_world{tp}", _tp_world(tp)))


# ---------------------------------------------------------------------------
# specs and shards (in process: no world needed)
# ---------------------------------------------------------------------------

MESHES = [{"data": 8, "model": 1}, {"data": 4, "model": 2}, {"data": 2, "model": 4}, {"data": 1, "model": 8},
          {"data": 2, "fsdp": 2, "model": 2}, {"fsdp": 4, "model": 2}]


class _FakeJaxMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_kv_specs_equal_jax(mesh):
    jmesh = _FakeJaxMesh({a: mesh.get(a, 1) for a in AXIS_ORDER})
    for n_slots in (1, 2, 3, 4, 8, 16):
        for heads in (1, 2, 3, 4, 6, 8, 12):
            for jfn, tfn in ((jshd.kv_slot_cache_spec, tshd.kv_slot_cache_spec),
                             (jshd.kv_prefix_pool_spec, tshd.kv_prefix_pool_spec)):
                want = tuple(jfn(jmesh, n_slots, heads))
                assert tfn(mesh, n_slots, heads) == want, (mesh, n_slots, heads)


@pytest.mark.parametrize("name,tp", [("gpt2", 2), ("alibi", 4), ("nondiv", 2), ("nondiv", 4)])
def test_tp_shards_equal_jax_device_shards(name, tp):
    """Every rank's slice of every leaf equals, exactly, JAX's shard on the
    device at the same (data, model) coordinates of the engine's mesh."""
    jeng = _jax_engine(name, tp)
    full = jax.tree.map(np.asarray, jeng.params)
    devices = np.asarray(jeng.mesh.devices)  # axes in AXIS_ORDER, as the port's rank array
    ranks = np.arange(devices.size).reshape(devices.shape)
    model = Model(TransformerConfig(**_cfg(name)))
    jflat = _flat(jeng.params, leaf=lambda a: a)  # the placed jax arrays
    for rank in range(devices.size):
        shard = interop.tp_params_from_jax(full, model, Mesh(ranks, rank))
        assert shard.tp.index == rank % tp
        for key, t in _flat(shard).items():
            arr = jflat[key]
            dev = devices.ravel()[rank]
            want = next(s.data for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(t, np.asarray(want), err_msg=f"rank {rank} {key}")


# ---------------------------------------------------------------------------
# the TP layers and the engine over gloo worlds of 2 and 4
# ---------------------------------------------------------------------------

def test_tp_linear_layers_match_dense(tp_world):
    """Column-parallel ``LinearLayer`` -> row-parallel ``LinearAllreduce``
    equals the dense two-layer product on every rank (bias once, after the
    reduce); each rank holds its columns / rows."""
    tp, _, arrays, _ = tp_world
    dense = (LAYERS["x"] @ LAYERS["w1"] + LAYERS["b1"]) @ LAYERS["w2"] + LAYERS["b2"]
    for r, a in enumerate(arrays):
        np.testing.assert_allclose(a["layers::y"], dense, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a["layers::w1_shard"], np.split(LAYERS["w1"], tp, axis=1)[r])
        np.testing.assert_array_equal(a["layers::w2_shard"], np.split(LAYERS["w2"], tp, axis=0)[r])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_forward_matches_jax(tp_world, name):
    """Within 1e-4 of JAX's at the same tp_size, the same on every rank, and
    bitwise the same when the engine is handed the rank's slices
    (``interop.tp_params_from_jax``) in place of the full tree."""
    tp, jax_out, arrays, meta = tp_world
    for a in arrays:
        # fp32 both sides, summation order only
        np.testing.assert_allclose(a[f"{name}::logits"], jax_out[name]["logits"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a[f"{name}::logits"], arrays[0][f"{name}::logits"])
        np.testing.assert_array_equal(a[f"{name}::logits_from_shards"], a[f"{name}::logits"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_generate_matches_jax(tp_world, name):
    """Greedy tokens equal JAX's; sampled ones equal across the ranks (one
    seeded generator each, over the same all-gathered logits)."""
    tp, jax_out, arrays, meta = tp_world
    for a in arrays:
        np.testing.assert_array_equal(a[f"{name}::generate"], jax_out[name]["generate"])
        np.testing.assert_array_equal(a[f"{name}::sampled"], arrays[0][f"{name}::sampled"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_split_leaves_follow_the_specs(tp_world, name):
    """What each rank holds: a leaf ``model`` divides is split (the rank's
    heads, FFN columns and vocab rows), one it does not divide stays whole,
    as JAX replicates it."""
    tp, _, arrays, meta = tp_world
    cfg = _cfg(name)
    H, V = cfg["num_heads"], cfg["vocab_size"]
    heads_split, vocab_split = H % tp == 0, V % tp == 0
    for r, (a, m) in enumerate(zip(arrays, meta)):
        info = m[name]
        assert info["split"] == {"wte": vocab_split, "layers/wq": heads_split, "layers/wo": heads_split,
                                 "layers/wi": True, "layers/wo_mlp": True}
        assert info["heads"] == (H // tp if heads_split else H)
        assert a[f"{name}::shard::wq"].shape[2] == info["heads"]
        assert a[f"{name}::shard::wo"].shape[1] == info["heads"]
        assert a[f"{name}::shard::wte"].shape[0] == (V // tp if vocab_split else V)


# ---------------------------------------------------------------------------
# refusals (in process)
# ---------------------------------------------------------------------------

def test_tp_refusals_name_themselves(monkeypatch):
    model = Model(TransformerConfig(**BASE))
    with pytest.raises(NotImplementedError, match="tp_size=2 in a single process"):
        init_inference(model, config={"tensor_parallel": {"tp_size": 2}}, device="cpu")
    with pytest.raises(NotImplementedError, match="tp_size=4 in a single process"):
        init_inference(model, config={"mp_size": 4}, device="cpu")
    with pytest.raises(NotImplementedError, match="quantization"):
        init_inference(model, config={"quantize": {"enabled": True}}, device="cpu")
    # a world other than tp_size would put a data axis above 1 under the server
    for key in ("WORLD_SIZE", "DSTPU_NUM_PROCESSES"):
        monkeypatch.setenv(key, "4")
        with pytest.raises(NotImplementedError, match=f"{key}=4\\) but tp_size is 2.*data axis of 2"):
            init_inference(model, config={"tensor_parallel": {"tp_size": 2}}, device="cpu")
        monkeypatch.delenv(key)


def test_tp_fleet_handoff_and_training_are_refused():
    """Behind the fleet, in a disaggregated role (the KV handoff) and in
    training with block-sparse attention, tensor parallelism raises by name. A TP engine is faked by
    its plan attribute: the refusals read nothing else."""
    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.serving_worker import build_serving_engine

    eng = init_inference(Model(TransformerConfig(**BASE)), config={"dtype": "fp32"}, device="cpu")
    eng.tp = object()
    with pytest.raises(NotImplementedError, match="the fleet \\(Router\\) over tensor-parallel engines"):
        Router(eng, config={"n_slots": 2, "router": {"replicas": 2}})
    with pytest.raises(NotImplementedError, match="role 'prefill'.*under tensor parallelism"):
        ServingEngine(eng, config={"n_slots": 2, "role": "prefill"})
    with pytest.raises(NotImplementedError, match="serving worker of a tensor-parallel engine"):
        build_serving_engine({"model": BASE, "tensor_parallel": {"tp_size": 2}}, device="cpu")
    # training under a model axis is ported; its unported paths are refused by name
    DeepSpeedConfig.from_dict({"train_batch_size": 2, "mesh": {"data": 1, "model": 2}}, world_size=2)
    with pytest.raises(NotImplementedError, match="sparse_attention with tensor parallelism"):
        DeepSpeedConfig.from_dict({"train_batch_size": 2, "mesh": {"data": 1, "model": 2},
                                   "sparse_attention": {"mode": "fixed", "block": 16}}, world_size=2)
