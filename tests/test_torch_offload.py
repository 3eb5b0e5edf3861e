"""Port parity: ZeRO-Offload (the cpu tier), the parameter tier, CPU
activation checkpoints and the memory estimators, against the JAX package.

The cases of ``tests/test_offload.py``, each held to the JAX engine: both
engines start from the JAX init (``interop.params_from_jax``), bf16 on the
CPU, a single-device JAX mesh. The cpu tier moves where the update runs,
not what it computes, so its losses track the JAX offload engine's and the
port's unoffloaded engine's within JAX's own rtol 2e-2 over 4 steps; the
parameter tier is the same arithmetic again, so on the CPU its losses equal
the plain offload engine's exactly, as do remat over it and CPU activation
checkpoints' gradients. Invalid tier combinations raise what the JAX engine
raises, with its message. A cpu-tier checkpoint crosses between the two
packages both ways.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.runtime import zero as jzero
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import zero as tzero
from deepspeed_tpu_torch.runtime.zero.host_optimizer import HostMemoryError, host_empty

RTOL = 2e-2  # tests/test_offload.py's tolerance for offload against no offload
STEPS = 4
MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, hidden_size=32, loss_chunk_size=0)


def _cfg(off_opt="none", stage=2, off_param="none", gas=1, nvme_path=None):
    zero = {"stage": stage}
    if off_opt != "none":
        zero["offload_optimizer"] = {"device": off_opt, **({"nvme_path": nvme_path} if nvme_path else {})}
    if off_param != "none":
        zero["offload_param"] = {"device": off_param}
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4 // gas, "gradient_accumulation_steps": 2 * gas,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": zero, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
            "steps_per_print": 10**9}


def _batch(seed=0):
    return {"tokens": np.random.default_rng(seed).integers(0, 128, size=(8, 33)).astype(np.int32)}


def _jax_engine(cfg, **tover):
    model = jtfm.Model(jtfm.TransformerConfig(dtype=jnp.bfloat16, **MODEL, **tover))
    return deepspeed_tpu.initialize(model=model, config=cfg, mesh=single_device_mesh())[0]


def _port_engine(cfg, params, **tover):
    model = ttfm.Model(ttfm.TransformerConfig(dtype=torch.bfloat16, **MODEL, **tover))
    return deepspeed_tpu_torch.initialize(model=model, config=cfg, model_parameters=params, device="cpu")[0]


def _init_params():
    """The JAX engine's fp32 init, as numpy (its master under the cpu tier)."""
    return jax.tree.map(np.asarray, _jax_engine(_cfg()).state["params"])


def _train(engine, steps=STEPS):
    return [float(engine.train_batch(_batch())["loss"]) for _ in range(steps)]


@pytest.fixture(scope="module")
def runs():
    """JAX and port cpu-tier engines, the port's unoffloaded one and its
    parameter-tier ones (with and without remat), 4 steps each."""
    init = _init_params()
    out = {"init": init}
    je = _jax_engine(_cfg("cpu"))
    out["jax_cpu"] = (je, _train(je))
    # the unoffloaded engine first: the first bf16 products of a process can
    # round otherwise than later ones, and the tiers are compared exactly
    for name, cfg, tover in [("plain", _cfg(), {}), ("cpu", _cfg("cpu"), {}),
                             ("param", _cfg("cpu", off_param="cpu"), {}),
                             ("param_remat", _cfg("cpu", off_param="cpu"),
                              {"remat": True, "remat_policy": "nothing_saveable"})]:
        e = _port_engine(cfg, interop.params_from_jax(init), **tover)
        out[name] = (e, _train(e))
    return out


def test_offload_state_layout(runs):
    """The JAX offload state tree: bf16 params, fp32 master, moments shaped
    like the master, the same keys; the host leaves are plain host tensors
    on the CPU (pinned on a card: tests/test_torch_cuda_tiers.py)."""
    je, _ = runs["jax_cpu"]
    te, _ = runs["cpu"]
    assert set(te.state) == set(je.state)
    assert te.state["params"]["wte"].dtype == torch.bfloat16
    assert te.state["master"]["wte"].dtype == torch.float32
    assert te.state["opt"]["m"]["wte"].shape == te.state["master"]["wte"].shape
    jleaves = jax.tree_util.tree_flatten_with_path(je.state)[0]
    tflat = {"/".join(map(str, p)): t for p, t in _flat(te.state)}
    for path, leaf in jleaves:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        assert tuple(tflat[key].shape) == tuple(leaf.shape), key
        assert str(tflat[key].dtype).rsplit(".", 1)[-1] == str(leaf.dtype), key


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_offload_trains_like_jax_and_like_no_offload(runs):
    _, jl = runs["jax_cpu"]
    te, tl = runs["cpu"]
    _, pl = runs["plain"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tl, pl, rtol=RTOL)
    assert tl[-1] < tl[0]
    # the master stayed fp32 and moved; the bf16 copy mirrors it
    np.testing.assert_allclose(te.state["master"]["wte"].numpy(), te.state["params"]["wte"].float().numpy(),
                               atol=1e-2)
    assert not torch.equal(te.state["master"]["wte"], interop.params_from_jax(runs["init"])["wte"])


def test_offload_param_matches_the_plain_offload_engine_exactly(runs):
    """The parameter tier only moves where tensors live: the same losses as
    the cpu tier bit for bit, and with remat over it too; gradients reach
    the host tree, and the parameters stay there in bf16."""
    _, tl = runs["cpu"]
    pe, pl = runs["param"]
    _, rl = runs["param_remat"]
    assert pl == tl and rl == tl
    assert pe.model.config.param_offload
    assert all(t.device.type == "cpu" and t.dtype == torch.bfloat16 for t in tree_leaves(pe.state["params"]))
    s = pe.tier.streamer
    assert s.h2d_bytes > 0 and s.d2h_bytes > 0


@pytest.mark.parametrize("stage", [0, 3])
def test_offload_composes_with_every_stage(runs, stage):
    e = _port_engine(_cfg("cpu", stage=stage, off_param="cpu" if stage == 3 else "none"),
                     interop.params_from_jax(runs["init"]))
    assert np.isfinite(_train(e, 1)).all()


def test_offload_param_gas_accumulates_on_host(runs):
    """gas > 1 over streamed parameters: the host gradient is the sum of the
    micro-batches' (copied, then added): the plain offload engine's step."""
    init = interop.params_from_jax(runs["init"])
    a = _train(_port_engine(_cfg("cpu", off_param="cpu", gas=2), init), 2)
    b = _train(_port_engine(_cfg("cpu", gas=2), interop.params_from_jax(runs["init"])), 2)
    assert a == b


def test_offload_param_3call_loop_gated_like_jax(runs):
    je = _jax_engine(_cfg("cpu", stage=1, off_param="cpu"))
    te = _port_engine(_cfg("cpu", stage=1, off_param="cpu"), interop.params_from_jax(runs["init"]))
    micro = {"tokens": _batch()["tokens"][:4]}
    je.forward(micro)
    assert np.isfinite(float(te.forward(micro)))  # the eval path works
    with pytest.raises(NotImplementedError, match="train_batch") as jerr:
        je.backward()
    with pytest.raises(NotImplementedError, match="train_batch") as terr:
        te.backward()
    assert str(terr.value) == str(jerr.value)


def test_offload_3call_loop_equals_train_batch(runs):
    """The cpu tier (no parameter tier) keeps DeepSpeed's 3-call loop: two
    micro-batches through forward/backward/step give train_batch's update."""
    init = runs["init"]
    a = _port_engine(_cfg("cpu"), interop.params_from_jax(init))
    b = _port_engine(_cfg("cpu"), interop.params_from_jax(init))
    a.train_batch(_batch())
    tokens = _batch()["tokens"]
    for i in range(2):
        b.forward({"tokens": tokens[4 * i:4 * (i + 1)]})
        b.backward()
        b.step()
    for x, y in zip(tree_leaves(a.state["master"]), tree_leaves(b.state["master"])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


INVALID = {
    "param_without_optimizer": ({"offload_param": {"device": "cpu"}}, {}),
    "nvme_param_cpu_optimizer": ({"offload_param": {"device": "nvme"}, "offload_optimizer": {"device": "cpu"}}, {}),
    "nvme_with_fp16": ({"offload_optimizer": {"device": "nvme"}}, {"fp16": {"enabled": True}, "bf16": {"enabled": False}}),
    "bad_param_device": ({"offload_param": {"device": "disk"}, "offload_optimizer": {"device": "cpu"}}, {}),
    "onebit_with_offload": ({"stage": 1, "offload_optimizer": {"device": "cpu"}},
                            {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 2}}}),
    "nvme_not_adam": ({"offload_optimizer": {"device": "nvme"}}, {"optimizer": {"type": "SGD", "params": {"lr": 0.1}}}),
}


@pytest.mark.parametrize("name", list(INVALID))
def test_invalid_tier_combinations_raise_like_jax(name, tmp_path):
    zero, top = INVALID[name]
    cfg = _cfg()
    cfg["zero_optimization"].update(zero)
    for sub in ("offload_optimizer", "offload_param"):
        if sub in cfg["zero_optimization"]:
            cfg["zero_optimization"][sub]["nvme_path"] = str(tmp_path)
    cfg.update(top)
    with pytest.raises((ValueError, NotImplementedError)) as jerr:
        _jax_engine(cfg)
    with pytest.raises(type(jerr.value)) as terr:
        tconfig.DeepSpeedConfig.from_dict(cfg)
    assert str(terr.value) == str(jerr.value)


def test_the_optimizers_bad_device_raises():
    """The port refuses an unknown offload_optimizer device too (the JAX
    engine reads it as none); partition_activations stays refused, and so
    do the NVMe tier and offload_param below stage 3 at a data-parallel
    world above 1 (the cpu tier shards there), while a mesh that does not
    cover the world is a config error."""
    cfg = _cfg()
    cfg["zero_optimization"]["offload_optimizer"] = {"device": "disk"}
    with pytest.raises(ValueError, match="none|cpu|nvme"):
        tconfig.DeepSpeedConfig.from_dict(cfg)
    world2 = {"train_batch_size": 16, "mesh": {"data": 2}}
    for tier in (_cfg("cpu"), _cfg("cpu", stage=3, off_param="cpu")):
        tconfig.DeepSpeedConfig.from_dict({**tier, **world2}, world_size=2)
    for tier, what in ((_cfg("nvme", nvme_path="/nonexistent"), "NVMe tier"),
                       (_cfg("cpu", off_param="cpu"), "offload_param at ZeRO stage 2")):
        with pytest.raises(NotImplementedError, match=what):
            tconfig.DeepSpeedConfig.from_dict({**tier, **world2}, world_size=2)
    with pytest.raises(tconfig.DeepSpeedConfigError, match="does not cover"):
        tconfig.DeepSpeedConfig.from_dict({**_cfg("cpu"), "mesh": {"data": 2}})
    tp2 = {"mesh": {"model": 2}}
    for tier, what in ((_cfg("cpu"), "offload_optimizer 'cpu'"),
                       (_cfg("cpu", stage=3, off_param="cpu"), "offload_optimizer 'cpu'"),
                       (_cfg(stage=1) | {"activation_checkpointing": {"enabled": True, "cpu_checkpointing": True}},
                        "activation_checkpointing.cpu_checkpointing")):
        with pytest.raises(NotImplementedError, match=f"memory tiers \\({what}.*tensor parallelism"):
            tconfig.DeepSpeedConfig.from_dict({**tier, **tp2}, world_size=2)


def test_offload_keys_parse_like_jax():
    from deepspeed_tpu.runtime import config as jconfig

    d = _cfg("nvme", nvme_path="/x/y", off_param="nvme")
    d["zero_optimization"]["offload_optimizer"].update(pin_memory=False, buffer_count=8, fast_init=True)
    d["zero_optimization"]["sub_group_size"] = 123456
    d["aio"] = {"thread_count": 3, "block_size": 4096}
    j = jconfig.DeepSpeedConfig.from_dict(d, world_size=1)
    t = tconfig.DeepSpeedConfig.from_dict(d, world_size=1)
    import dataclasses

    for sub in ("offload_optimizer", "offload_param"):
        assert dataclasses.asdict(getattr(t.zero_optimization, sub)) == dataclasses.asdict(
            getattr(j.zero_optimization, sub))
    assert t.zero_optimization.sub_group_size == j.zero_optimization.sub_group_size
    assert dataclasses.asdict(t.aio) == dataclasses.asdict(j.aio)


def test_cpu_tier_checkpoint_crosses_both_ways(runs, tmp_path):
    """A JAX cpu-tier checkpoint (bf16 params as raw <V2 payloads) loads into
    the port and continues as JAX does; the port's (bf16 params as their
    fp32 values) loads into the JAX engine and continues as the port does."""
    je = _jax_engine(_cfg("cpu", stage=1))
    _train(je, 2)
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    te = _port_engine(_cfg("cpu", stage=1), interop.params_from_jax(runs["init"]))
    te.load_checkpoint(str(tmp_path / "j"))
    assert int(te.state["step"]) == 2
    np.testing.assert_allclose(_train(te, 1), _train(je, 1), rtol=1e-4)
    te.save_checkpoint(str(tmp_path / "t"), tag="u")
    je2 = _jax_engine(_cfg("cpu", stage=1))
    je2.load_checkpoint(str(tmp_path / "t"))
    assert je2.state["params"]["wte"].dtype == jnp.bfloat16
    np.testing.assert_allclose(_train(je2, 1), _train(te, 1), rtol=1e-4)


def test_interop_carries_a_jax_offload_engines_state(runs):
    """load_offload_state: a trained JAX offload engine's params, master and
    moments into the port's tier buffers; the next step matches JAX's."""
    je = _jax_engine(_cfg("cpu", stage=1))
    _train(je, 2)
    te = _port_engine(_cfg("cpu", stage=1), interop.params_from_jax(runs["init"]))
    master = te.state["master"]["wte"]
    interop.load_offload_state(te, jax.tree.map(np.asarray, je.state))
    assert te.state["master"]["wte"] is master  # in place, in the tier's buffer
    np.testing.assert_array_equal(te.state["master"]["wte"].numpy(), np.asarray(je.state["master"]["wte"]))
    te.state["step"] = torch.tensor(2, dtype=torch.int32)
    np.testing.assert_allclose(_train(te, 1), _train(je, 1), rtol=1e-4)


@pytest.mark.parametrize("policy", ["save_flash", "nothing_saveable"])
def test_cpu_checkpointing_gives_the_no_offload_remat_gradients(policy):
    cfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=3, num_heads=4, hidden_size=32,
                                 attn_impl="flash", loss_chunk_size=16, remat=True, remat_policy=policy)
    params = ttfm.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, size=(2, 33)))

    def grads(c):
        leaves = {k: ({n: t.detach().clone().requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                      else v.detach().clone().requires_grad_()) for k, v in params.items()}
        loss = ttfm.causal_lm_loss(c, leaves, {"tokens": tokens})
        loss.backward()
        return loss.item(), [t.grad for t in tree_leaves(leaves)]

    (la, ga), (lb, gb) = grads(cfg), grads(cfg.replace(remat_offload=True))
    assert la == lb
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_checkpointing_refuses_other_policies_like_jax():
    jcfg = jtfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32,
                                  remat=True, remat_policy="dots_saveable", remat_offload=True)
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError) as jerr:
        jtfm.apply(jcfg, jtfm.init(jcfg, jax.random.PRNGKey(0)), jnp.asarray(tokens))
    tcfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32,
                                  remat=True, remat_policy="dots_saveable", remat_offload=True)
    with pytest.raises(ValueError) as terr:
        ttfm.apply(tcfg, ttfm.init(tcfg, torch.Generator().manual_seed(0)), torch.from_numpy(tokens).long())
    assert str(terr.value) == str(jerr.value)


def test_engine_with_cpu_checkpointing_tracks_jax():
    """The activation_checkpointing block's cpu_checkpointing through both
    engines: the same losses as JAX's over 3 fp32 steps (the remat parity
    tests' tolerance)."""
    from deepspeed_tpu.runtime import activation_checkpointing as jac
    from deepspeed_tpu_torch.runtime import activation_checkpointing as tac

    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}}, "steps_per_print": 10**9,
          "activation_checkpointing": {"enabled": True, "cpu_checkpointing": True, "policy": "save_flash"}}
    kw = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32, loss_chunk_size=16)
    try:
        je = deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(**kw)), config=ds,
                                      mesh=single_device_mesh())[0]
        te = deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**kw)), config=ds, device="cpu",
                                            model_parameters=interop.params_from_jax(
                                                jax.tree.map(np.asarray, je.state["params"])))[0]
        assert te.model.config.remat_offload and je.model.config.remat_offload
        batch = {"tokens": np.random.default_rng(3).integers(0, 97, size=(4, 33)).astype(np.int32)}
        jl = [float(je.train_batch(batch)["loss"]) for _ in range(3)]
        tl = [float(te.train_batch(batch)["loss"]) for _ in range(3)]
    finally:
        jac.reset()
        tac.reset()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


GRID = [(P, chips, hosts, off, stage) for P in (1_000_000_000, 124_439_808, 6_658_596_864)
        for chips, hosts in ((1, 1), (8, 1), (8, 2)) for off in (False, True) for stage in (1, 2, 3)]


def test_memory_estimators_match_jax_on_a_grid():
    fns = {1: "estimate_zero1_model_states_mem_needs", 2: "estimate_zero2_model_states_mem_needs",
           3: "estimate_zero3_model_states_mem_needs"}
    for P, chips, hosts, off, stage in GRID:
        j = getattr(jzero, fns[stage])(P, num_chips=chips, num_hosts=hosts, offload_optimizer=off)
        t = getattr(tzero, fns[stage])(P, num_chips=chips, num_hosts=hosts, offload_optimizer=off)
        assert (t.per_chip_hbm, t.per_host_dram, str(t)) == (j.per_chip_hbm, j.per_host_dram, str(j))


def test_print_mem_estimates_and_model_count_match_jax(capsys):
    jzero.print_mem_estimates(124_439_808, num_chips=8)
    j = capsys.readouterr().out
    tzero.print_mem_estimates(124_439_808, num_chips=8)
    assert capsys.readouterr().out == j
    kw = dict(vocab_size=50304, max_seq_len=1024, num_layers=2, num_heads=12, hidden_size=768)
    je = jzero.estimate_from_model(jtfm.Model(jtfm.TransformerConfig(**kw)), stage=2, offload_optimizer=True)
    te = tzero.estimate_from_model(ttfm.Model(ttfm.TransformerConfig(**kw)), stage=2, offload_optimizer=True)
    assert (te.per_chip_hbm, te.per_host_dram) == (je.per_chip_hbm, je.per_host_dram)


# -- no fallback --------------------------------------------------------------

def test_a_pinning_failure_raises_with_the_byte_count():
    if torch.cuda.is_available():
        pytest.skip("pinning succeeds where there is a card")
    with pytest.raises(HostMemoryError, match="4096 bytes"):
        host_empty((1024,), torch.float32, pin=True)


def test_an_offload_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card where there is one")
    model = ttfm.Model(ttfm.TransformerConfig(dtype=torch.bfloat16, **MODEL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=_cfg("cpu"))


def test_a_failed_aio_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    src = tmp_path / "csrc" / "aio"
    src.mkdir(parents=True)
    (src / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(op_builder, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        op_builder.build_host("aio/broken.cpp")
    assert "error" in str(err.value)
    assert not os.path.exists(tmp_path / "build" / "libbroken.so")


@pytest.mark.parametrize("opt", [{"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}},
                                 {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}}])
def test_other_optimizers_update_leafwise_on_the_host(runs, opt):
    """The cpu tier runs any optimizer of ops/optimizers.py on the host, a
    leaf at a time in place: in fp32 its steps equal the unoffloaded
    engine's exactly (the same operations on the same values)."""
    def engine(off):
        cfg = {**_cfg(off), "optimizer": opt, "bf16": {"enabled": False}}
        model = ttfm.Model(ttfm.TransformerConfig(**MODEL))
        return deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                              model_parameters=interop.params_from_jax(runs["init"]))[0]

    a, b = engine("none"), engine("cpu")
    assert _train(a, 2) == _train(b, 2)
    assert set(b.state["opt"]) == set(a.state["opt"])


def test_param_offload_model_streams_host_params_like_jax():
    """The model with param_offload over host parameters and no engine
    streamer: each leaf through ``stream_to_device``, the gradients back on
    the host leaves; loss and gradients equal the plain model's exactly and
    JAX's param_offload model's within fp32 rounding."""
    kw = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32, loss_chunk_size=0)
    jcfg = jtfm.TransformerConfig(**kw, param_offload=True)
    jparams = jtfm.init(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 97, size=(2, 17)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: jtfm.causal_lm_loss(jcfg, p, {"tokens": jnp.asarray(tokens)}))(jparams)
    tcfg = ttfm.TransformerConfig(**kw)

    def loss_and_grads(cfg):
        leaves = {k: ({n: t.requires_grad_() for n, t in v.items()} if isinstance(v, dict) else v.requires_grad_())
                  for k, v in interop.params_from_jax(jax.tree.map(np.asarray, jparams)).items()}
        loss = ttfm.causal_lm_loss(cfg, leaves, {"tokens": torch.from_numpy(tokens).long()})
        loss.backward()
        return loss.item(), [t.grad for t in tree_leaves(leaves)]

    (la, ga), (lb, gb) = loss_and_grads(tcfg), loss_and_grads(tcfg.replace(param_offload=True))
    assert la == lb and all(torch.equal(a, b) for a, b in zip(ga, gb))
    np.testing.assert_allclose(lb, float(jloss), rtol=1e-5)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    for a, b in zip(gb, jleaves):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
