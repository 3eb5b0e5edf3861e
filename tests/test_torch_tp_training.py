"""Port parity: tensor-parallel training (the mesh's ``model`` axis through
``initialize`` -> ``train_batch``) against the JAX engine.

The JAX engine runs on a subset of its CPU devices laid out as the port's
world is (``mesh=`` over 2 devices for ``data 1 x model 2``, over 4 for
``data 2 x model 2``), GSPMD partitioning every leaf by its spec; the port
runs one gloo process per rank (``tests/torch_dp_worker.py``, each world
started once per session) with the collectives written out and
differentiated through. Checked here:

  * the four conjugate collectives (``copy_to_model``,
    ``reduce_from_model``, ``gather_from_model``, ``scatter_to_model``)
    forward and backward at worlds 2 and 4 equal their dense counterparts
    exactly (integer-valued fp32 inputs, so every sum is exact);
  * the vocab-parallel ``lm_loss_from_hidden`` at tp 2 and 4 (tied head,
    untied head, and a vocabulary ``tp`` does not divide, which stays whole)
    gives the loss and the gradients of ``hidden`` and the head within 1e-5
    of the port's tp-1 loss and of JAX's;
  * 3 ``train_batch`` calls at tp 2 (ZeRO 0 and 1, clipping on, an ALiBi
    config, a config whose heads ``tp`` does not divide) and at ``data 2 x
    model 2`` (ZeRO 2 and 3) give losses within rtol 2e-5 of the JAX
    engine's on the same mesh, and parameters, gathered to full shape,
    within 1e-5 (the noise allowance of ``test_torch_zero``);
  * ``partition_activations`` gives the losses of remat without it;
  * each rank holds about 1/tp of the split leaves, and its heads;
  * the paths not ported under tensor parallelism raise by name.

The checkpoints under tensor parallelism are in ``test_torch_tp_checkpoint.py``,
which reads the same session-wide runs (``tp_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import MeshConfig as JaxMeshConfig
from deepspeed_tpu.comm.mesh import build_mesh as jax_build_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.comm.mesh import Mesh
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.module_inject.layers import TensorParallel, TPParams
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from simple_model import base_config, random_tokens, tiny_transformer
from test_torch_comm import run_world, shared_once
from test_torch_zero import _assert_params, _losses, _params

MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
STEPS = 3
LOSS_RTOL = 2e-5
OPS_ATOL = 1e-5
LAMB = {"type": "Lamb", "params": {"lr": 1e-3}}
# the JAX engines: (model overrides, mesh, ZeRO stage, config overrides); the port's cases name theirs
JAX_RUNS = {
    "tp2": ({}, {"data": 1, "model": 2}, 1, {}),
    "x3": ({}, {"data": 2, "model": 2}, 3, {}),
    "alibi": ({"pos_emb": "alibi"}, {"data": 1, "model": 2}, 1, {}),
    # one head: attention stays whole at tp 2, the FFN and the vocabulary split
    "heads1": ({"num_heads": 1}, {"data": 1, "model": 2}, 1, {}),
    # LAMB: each whole leaf's trust ratio, a replicated leaf counted once
    "lamb": ({}, {"data": 2, "model": 2}, 2, {"optimizer": LAMB}),
}
TP2 = {"mesh": {"model": 2}, "train_micro_batch_size_per_gpu": 8}
X22 = {"mesh": {"data": 2, "model": 2}, "train_micro_batch_size_per_gpu": 4}
REMAT = {"enabled": True, "policy": "nothing_saveable"}
CASES = [
    {"world": 2, "name": "tp2s0", "jax": "tp2", "ds": {**TP2, "zero_optimization": {"stage": 0}}, "steps": STEPS},
    # saved after its steps: test_torch_tp_checkpoint.py loads it at tp 1
    {"world": 2, "name": "tp2s1", "jax": "tp2", "ds": {**TP2, "zero_optimization": {"stage": 1}}, "steps": STEPS,
     "save_after": STEPS, "full_opt": True, "save16": True},
    {"world": 2, "name": "alibi", "jax": "alibi", "ds": {**TP2, "zero_optimization": {"stage": 1}}, "steps": STEPS},
    {"world": 2, "name": "heads1", "jax": "heads1", "ds": {**TP2, "zero_optimization": {"stage": 1}}, "steps": STEPS},
    {"world": 2, "name": "remat", "jax": "tp2", "ds": {**TP2, "zero_optimization": {"stage": 1},
                                           "activation_checkpointing": REMAT}, "steps": STEPS},
    {"world": 2, "name": "part", "jax": "tp2", "ds": {**TP2, "zero_optimization": {"stage": 1}, "activation_checkpointing": {
        **REMAT, "partition_activations": True}}, "steps": STEPS},
    {"name": "x2", "world": 4, "jax": "x3", "ds": {**X22, "zero_optimization": {"stage": 2}}, "steps": STEPS},
    # saved after its steps: its manifest's shard table against JAX's on the same mesh
    {"name": "x3", "world": 4, "jax": "x3", "ds": {**X22, "zero_optimization": {"stage": 3}}, "steps": STEPS,
     "save_after": STEPS},
    {"name": "x3part", "world": 4, "jax": "x3", "ds": {**X22, "zero_optimization": {"stage": 3},
                                                       "activation_checkpointing": {
                                                           "enabled": True, "policy": "dots_saveable",
                                                           "partition_activations": True}}, "steps": STEPS},
    {"name": "lamb", "world": 4, "jax": "lamb", "ds": {**X22, "zero_optimization": {"stage": 2}, "optimizer": LAMB},
     "steps": STEPS},
    # a JAX ZeRO-3 save on {fsdp: 4, model: 2} (8 devices) loaded at data 2 x model 2
    {"name": "jaxload", "world": 4, "ds": {**X22, "zero_optimization": {"stage": 3}}, "steps": 1,
     "load_tag": "jax", "loaded_state": True},
    # the port's tp-2 ZeRO-1 save (world 2, above) loaded at data 2 x model 2 under ZeRO 3
    {"name": "tp2load", "world": 4, "ds": {**X22, "zero_optimization": {"stage": 3}}, "steps": 1,
     "load_tag": "port", "loaded_state": True},
]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {k: np.asarray(v) for k, v in saver._flatten_with_paths(tree).items()}


def _jax_engine(model_over, mesh, stage, micro, **cfg_over):
    """``test_engine.py``'s engine on ``mesh`` over the first devices it
    covers (``data`` x ``fsdp`` x ``model``)."""
    n = int(np.prod(list(mesh.values())))
    cfg = base_config(train_micro_batch_size_per_gpu=micro, **cfg_over)
    cfg["zero_optimization"] = {"stage": stage}
    jmesh = jax_build_mesh(JaxMeshConfig(**{"data": 1, **mesh}), devices=jax.devices()[:n])
    return deepspeed_tpu.initialize(model=tiny_transformer(**model_over), config=cfg, mesh=jmesh)[0]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "tp_runs", _tp_runs)


def _tp_runs(tmp):
    """The JAX engines, a JAX ZeRO-3 save on {fsdp: 4, model: 2}, then the
    port's worlds of 2 (tp 2) and 4 (data 2 x model 2) over every case."""
    tokens = random_tokens(16)["tokens"]
    jax_runs, inits = {}, {}
    for name, (over, mesh, stage, cfg_over) in JAX_RUNS.items():
        eng = _jax_engine(over, mesh, stage, micro=16 // (2 * mesh["data"]), **cfg_over)
        inits[name] = _flat(_np(eng.state["params"]))
        losses = [float(eng.train_batch({"tokens": tokens})["loss"]) for _ in range(STEPS)]
        jax_runs[name] = {"losses": losses, "params": _flat(_np(eng.state["params"]))}
        if name == "x3":
            eng.save_checkpoint(str(tmp / "jax_x3"), tag="t")
            jax_runs["x3_manifest"] = saver.read_manifest(str(tmp / "jax_x3" / "t"))
        np.savez(tmp / f"params_{name}.npz", **inits[name])
    eng = _jax_engine({}, {"fsdp": 4, "model": 2}, 3, micro=2)
    eng.train_batch({"tokens": tokens})
    eng.save_checkpoint(str(tmp / "jax_fsdp4"), tag="jax")
    jax_runs["fsdp4"] = {"params": _flat(_np(eng.state["params"])),
                         "m": _flat(_np(eng.state["opt"]["m"])), "v": _flat(_np(eng.state["opt"]["v"]))}
    np.savez(tmp / "tokens.npz", tokens=tokens)
    cases = []
    for c in CASES:
        c = dict(c)
        c["params"] = str(tmp / f"params_{c.get('jax', 'tp2')}.npz")
        c["model"] = JAX_RUNS[c.get("jax", "tp2")][0]
        if c.get("save_after"):
            c["save"] = str(tmp / f"port_{c['name']}")
        if c.get("save16"):
            c["save16"] = str(tmp / f"port16_{c['name']}")
        if c["name"] == "jaxload":
            c["load"] = str(tmp / "jax_fsdp4")
        if c["name"] == "tp2load":
            c["load"] = str(tmp / "port_tp2s1")
        cases.append(c)
    spec = {"params": str(tmp / "params_tp2.npz"), "tokens": str(tmp / "tokens.npz"), "model": MODEL,
            "ds": base_config(), "cases": cases}
    for w in ("w2", "w4"):
        (tmp / w).mkdir(exist_ok=True)
    w2 = run_world("tp_train", spec, 2, tmp / "w2")
    w4 = run_world("tp_train", spec, 4, tmp / "w4")
    port_x3 = saver.read_manifest(str(tmp / "port_x3" / "port"))
    weights16 = {k: v.float().numpy() for k, v in torch.load(tmp / "port16_tp2s1" / "model_weights.pt").items()}
    return {"jax": jax_runs, "w2": w2, "w4": w4, "port_x3_manifest": port_x3, "init_tp2": inits["tp2"],
            "save_tp2s1": str(tmp / "port_tp2s1"), "tokens": tokens, "weights16_tp2s1": weights16}


@pytest.mark.parametrize("case", [c["name"] for c in CASES if "jax" in c])
def test_losses_and_params_match_jax(tp_runs, case):
    c = next(c for c in CASES if c["name"] == case)
    world = tp_runs["w4" if c.get("world") == 4 else "w2"]
    want = tp_runs["jax"][c["jax"]]
    for r in range(len(world[0])):
        np.testing.assert_allclose(_losses(world, case, r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(world, case, r), want["params"])


def test_partition_activations_keeps_the_losses(tp_runs):
    """At data 1 x model 2, remat with partition_activations gives remat's
    losses (JAX ``test_partition_activations_matches_on_tp_mesh``), and at
    data 2 x model 2 under ZeRO 3 the losses of plain ZeRO 3."""
    for r in range(2):
        np.testing.assert_allclose(_losses(tp_runs["w2"], "part", r), _losses(tp_runs["w2"], "remat", r),
                                   rtol=LOSS_RTOL)
    for r in range(4):
        np.testing.assert_allclose(_losses(tp_runs["w4"], "x3part", r), _losses(tp_runs["w4"], "x3", r),
                                   rtol=LOSS_RTOL)


def test_save_16bit_model_writes_full_leaves(tp_runs):
    """``save_16bit_model`` at tp 2 writes every leaf at full shape: the
    gathered parameters in the compute dtype (fp32 here), as at tp 1."""
    got, want = tp_runs["weights16_tp2s1"], _params(tp_runs["w2"], "tp2s1")
    assert set(got) == {k.replace("::", "/") for k in want}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k.replace("::", "/")], v, err_msg=k)


def test_each_rank_holds_its_slices_and_heads(tp_runs):
    """A rank of tp 2 keeps half the heads (all of them when ``tp`` does not
    divide the heads) and holds its slices: the split leaves' share of the
    parameters; under ZeRO 3 at data 2 x model 2 about a quarter of them."""
    meta2, meta4 = tp_runs["w2"][1], tp_runs["w4"][1]
    full = sum(v.size for v in tp_runs["init_tp2"].values())
    for r in range(2):
        assert meta2[r]["tp2s0"]["heads"] == 2 and meta2[r]["heads1"]["heads"] == 1
        assert meta2[r]["tp2s0"]["mesh"]["model"] == 2 and meta2[r]["tp2s0"]["dp_rank"] == 0
        assert 0.5 * full < meta2[r]["tp2s0"]["param_numel"] < 0.6 * full
    for r in range(4):
        assert meta4[r]["x3"]["dp_rank"] == r // 2
        # a quarter of the split leaves, half of those only ZeRO splits (LayerNorms, row-parallel biases)
        assert 0.25 < meta4[r]["x3"]["held"]["params"] < 0.3
        assert 0.25 < meta4[r]["x2"]["held"]["opt_state"] < 0.3


# ---------------------------------------------------------------------------
# The collectives and the vocab-parallel loss
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "tied": dict(vocab_size=128),
    "untied": dict(vocab_size=128, tie_embeddings=False),
    # a vocabulary neither 2 nor 4 divides: the head stays whole, the plain loss runs
    "whole": dict(vocab_size=129),
}
LOSS_B, LOSS_S, LOSS_D = 2, 16, 64


def _loss_cfg(name):
    return dict(MODEL, **LOSS_CASES[name], loss_chunk_size=8)


def _ops_inputs(tmp, world):
    """Integer-valued inputs for the collectives ([world, ...] per rank) and
    each loss case's hidden states, labels and head, from a seed."""
    rng = np.random.default_rng(world)

    def ints(*shape):
        return rng.integers(-4, 5, size=shape).astype(np.float32)

    arrays = {"x": ints(world, 3, 8), "g": ints(world, 3, 8), "g_wide": ints(world, 3, 8 * world),
              "x_wide": ints(world, 3, 4 * world, 5), "g_narrow": ints(world, 3, 4, 5)}
    # the scatter's input is the same on every rank, as a replicated activation is
    arrays["x_wide"][:] = arrays["x_wide"][0]
    for name, over in LOSS_CASES.items():
        V = over["vocab_size"]
        arrays[f"{name}::hidden"] = rng.standard_normal((LOSS_B, LOSS_S, LOSS_D)).astype(np.float32)
        labels = rng.integers(0, V, size=(LOSS_B, LOSS_S))
        labels[0, :3] = -100
        arrays[f"{name}::labels"] = labels.astype(np.int64)
        arrays[f"{name}::wte"] = (0.05 * rng.standard_normal((V, LOSS_D))).astype(np.float32)
        if over.get("tie_embeddings") is False:
            arrays[f"{name}::lm_head"] = (0.05 * rng.standard_normal((LOSS_D, V))).astype(np.float32)
    path = tmp / f"ops_inputs{world}.npz"
    np.savez(path, **arrays)
    return path, arrays


@pytest.fixture(scope="module")
def tp_ops(tmp_path_factory):
    return shared_once(tmp_path_factory, "tp_ops", _tp_ops)


def _tp_ops(tmp):
    out = {}
    for world in (2, 4):
        path, arrays = _ops_inputs(tmp, world)
        spec = {"inputs": str(path), "cases": [{"name": n, "model": _loss_cfg(n)} for n in LOSS_CASES]}
        (tmp / f"w{world}").mkdir(exist_ok=True)
        out[world] = {"inputs": arrays, "ranks": run_world("tp_ops", spec, world, tmp / f"w{world}")[0]}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_conjugate_collectives_equal_their_dense_counterparts(tp_ops, world):
    a, ranks = tp_ops[world]["inputs"], tp_ops[world]["ranks"]
    for r in range(world):
        got = ranks[r]
        np.testing.assert_array_equal(got["copy::fwd"], a["x"][r])
        np.testing.assert_array_equal(got["copy::bwd"], a["g"].sum(0))
        np.testing.assert_array_equal(got["reduce::fwd"], a["x"].sum(0))
        np.testing.assert_array_equal(got["reduce::bwd"], a["g"][r])
        np.testing.assert_array_equal(got["gather::fwd"], np.concatenate(list(a["x"]), axis=-1))
        np.testing.assert_array_equal(got["gather::bwd"], np.split(a["g_wide"][r], world, axis=-1)[r])
        np.testing.assert_array_equal(got["scatter::fwd"], np.split(a["x_wide"][r], world, axis=1)[r])
        np.testing.assert_array_equal(got["scatter::bwd"], np.concatenate(list(a["g_narrow"]), axis=1))


def _head_keys(name, a):
    """The leaf the loss projects with: the untied head, else the tied ``wte``."""
    return ("lm_head",) if f"{name}::lm_head" in a else ("wte",)


def _port_loss(name, a):
    """The port's tp-1 loss and gradients on the same inputs."""
    cfg = tfm.TransformerConfig(**_loss_cfg(name), dtype=torch.float32)
    params = {k: torch.from_numpy(a[f"{name}::{k}"]).requires_grad_() for k in _head_keys(name, a)}
    hidden = torch.from_numpy(a[f"{name}::hidden"]).requires_grad_()
    loss = tfm.lm_loss_from_hidden(cfg, params, hidden, torch.from_numpy(a[f"{name}::labels"]))
    loss.backward()
    return {"loss": loss.detach().numpy(), "d_hidden": hidden.grad.numpy(),
            **{f"d_{k}": t.grad.numpy() for k, t in params.items()}}


def _jax_loss(name, a):
    cfg = jtfm.TransformerConfig(**_loss_cfg(name), dtype=jnp.float32)
    params = {k: jnp.asarray(a[f"{name}::{k}"]) for k in _head_keys(name, a)}

    def f(p, h):
        return jtfm.lm_loss_from_hidden(cfg, p, h, jnp.asarray(a[f"{name}::labels"]))

    loss, (gp, gh) = jax.value_and_grad(f, argnums=(0, 1))(params, jnp.asarray(a[f"{name}::hidden"]))
    return {"loss": np.asarray(loss), "d_hidden": np.asarray(gh), **{f"d_{k}": np.asarray(g) for k, g in gp.items()}}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_vocab_parallel_loss_matches_tp1_and_jax(tp_ops, world, name):
    a, ranks = tp_ops[world]["inputs"], tp_ops[world]["ranks"]
    ref, jref = _port_loss(name, a), _jax_loss(name, a)
    assert set(ref) == set(jref)
    for r in range(world):
        for k in ref:
            got = ranks[r][f"{name}::{k}"]
            np.testing.assert_allclose(got, ref[k], atol=OPS_ATOL, rtol=0, err_msg=f"{k} vs tp 1")
            np.testing.assert_allclose(got, jref[k], atol=OPS_ATOL, rtol=0, err_msg=f"{k} vs JAX")


# ---------------------------------------------------------------------------
# Refusals and the loss rule
# ---------------------------------------------------------------------------

def _plan(model_cfg, tp=2):
    """A rank-0 plan over a mesh of ``tp`` ranks on ``model`` (no process
    group: nothing is communicated)."""
    mesh = Mesh(np.arange(tp).reshape(1, 1, 1, 1, tp), 0)
    params = tfm.init(model_cfg, torch.Generator().manual_seed(0))
    return TensorParallel(mesh, tfm.logical_axes(model_cfg), params), params


def test_unported_paths_under_tensor_parallelism_raise_by_name():
    base = {"train_batch_size": 2, "mesh": {"model": 2}}
    DeepSpeedConfig.from_dict(base, world_size=2)
    refused = [({"sparse_attention": {"mode": "fixed", "block": 16}}, "sparse_attention with tensor parallelism"),
               ({"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
                "memory tiers \\(offload_optimizer"),
               ({"activation_checkpointing": {"enabled": True, "cpu_checkpointing": True}},
                "memory tiers \\(activation_checkpointing.cpu_checkpointing"),
               ({"mesh": {"model": 2, "pipe": 2}}, "'pipe'=2: pipeline parallelism"),
               ({"mesh": {"model": 2, "context": 2}}, "'context'=2: context parallelism")]
    for over, what in refused:
        world = 4 if "mesh" in over else 2
        with pytest.raises(NotImplementedError, match=what):
            DeepSpeedConfig.from_dict({**base, **over}, world_size=world)
    cfg = tfm.TransformerConfig(**MODEL, attn_impl="sparse", sparsity={"mode": "fixed", "block": 16})
    tp, params = _plan(cfg)
    with pytest.raises(NotImplementedError, match="attn_impl='sparse' under tensor parallelism"):
        tfm.apply(cfg, TPParams(tp.shard(params), tp), torch.zeros((1, 32), dtype=torch.long))


def test_tp_params_from_jax_slices_the_optimizer_state_as_the_parameters():
    """``interop.tp_params_from_jax(..., opt=)``: each rank's slices of the
    moments are the parameters' slices (so both engines can start from one
    state), a non-tree leaf passes whole, and the ranks' slices make up the
    full leaves."""
    from deepspeed_tpu_torch import interop

    from deepspeed_tpu_torch.ops.optimizers import tree_map

    cfg = tfm.TransformerConfig(**MODEL)
    tree = tree_map(lambda t: t.numpy(), tfm.init(cfg, torch.Generator().manual_seed(0)))
    opt = {"m": tree, "v": tree, "count": np.asarray(3, np.int32)}
    parts = []
    for rank in range(2):
        mesh = Mesh(np.arange(2).reshape(1, 1, 1, 1, 2), rank)
        params, o = interop.tp_params_from_jax(tree, tfm.Model(cfg), mesh, opt=opt)
        for k in ("m", "v"):
            for path, t in saver._flatten_with_paths(o[k]).items():
                np.testing.assert_array_equal(t.numpy(), saver._flatten_with_paths(params)[path].numpy())
        assert int(o["count"]) == 3 and params.tp.index == rank
        parts.append(o["m"])
    np.testing.assert_array_equal(torch.cat([p["layers"]["wq"] for p in parts], dim=2).numpy(), tree["layers"]["wq"])
    np.testing.assert_array_equal(torch.cat([p["wte"] for p in parts], dim=0).numpy(), tree["wte"])


def test_fused_loss_falls_back_to_the_vocab_parallel_chunked_loss():
    """Under a model axis the fused loss gives way to the chunked one with
    JAX's reason (JAX ``transformer.py:1204-1213``), whatever the rows."""
    cfg = tfm.TransformerConfig(**MODEL, loss_impl="fused_xent")
    jcfg = jtfm.TransformerConfig(**MODEL, loss_impl="fused_xent")
    tp, _ = _plan(cfg)
    impl, reason = tfm.effective_loss_impl(cfg, n_rows=1024, mesh=tp.mesh)
    jmesh = jax_build_mesh(JaxMeshConfig(data=1, model=2), devices=jax.devices()[:2])
    assert (impl, reason.split(";")[0]) == (lambda r: (r[0], r[1].split(";")[0]))(
        jtfm.effective_loss_impl(jcfg, mesh=jmesh, n_rows=1024))
    assert impl == "chunked" and "tensor-parallel" in reason
    assert tfm.effective_loss_impl(cfg, n_rows=1024) == ("fused_xent", "configured")
