"""Port parity: the training path (config, schedules, optimizers, loss
scaling, the model's loss and its gradients, and ``initialize`` ->
``train_batch`` as a whole).

The same numpy inputs and the JAX package's initial weights (carried over
with ``interop.params_from_jax``) go through both packages, fp32 on the CPU.
The JAX flash-attention path runs its Pallas kernels in interpret mode; the
port's CPU tensors take the plain versions the CUDA kernels are held against.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import engine as jengine
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from simple_model import base_config, tiny_transformer

STEPS = [0, 1, 2, 10, 999, 1000, 5000]


def _leaves(tree):
    """Leaves of a nested dict in jax.tree.leaves order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]

SCHEDULES = {
    "constant": (None, {}),
    "lr_range": ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 100,
                                 "lr_range_test_step_rate": 2.0}),
    "lr_range_stair": ("LRRangeTest", {"lr_range_test_staircase": True, "lr_range_test_step_size": 300}),
    "one_cycle": ("OneCycle", {"cycle_min_lr": 1e-5, "cycle_max_lr": 1e-3, "cycle_first_step_size": 500,
                               "decay_lr_rate": 0.5, "decay_step_size": 200}),
    "warmup_log": ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 1000}),
    "warmup_linear": ("WarmupLR", {"warmup_max_lr": 6e-4, "warmup_num_steps": 10, "warmup_type": "linear"}),
    "warmup_decay": ("WarmupDecayLR", {"total_num_steps": 4000, "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 1000}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedules_match_jax(name):
    kind, params = SCHEDULES[name]
    jfn = jlr.get_schedule(kind, params, 3e-4)
    tfn = tlr.get_schedule(kind, params, 3e-4)
    for step in STEPS:
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        # float32 arithmetic on both sides, the same operations
        np.testing.assert_allclose(float(got), float(jfn(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


OPTIMIZERS = {
    "adam_l2": ("Adam", {"lr": 1e-2, "weight_decay": 0.01}),
    "adamw": ("AdamW", {"lr": 1e-2, "weight_decay": 0.1, "betas": [0.8, 0.95]}),
    "lamb": ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    "sgd": ("SGD", {"lr": 0.1}),
    "sgd_nesterov": ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-3}),
    "adagrad": ("Adagrad", {"lr": 0.1, "weight_decay": 1e-3}),
}


def _tree(rng):
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32),
                       "b": rng.standard_normal(3).astype(np.float32)}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    kind, cfg = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jinit, jupd, jlr_ = jopt.get_optimizer(kind, cfg)
    tinit, tupd, tlr_ = topt.get_optimizer(kind, cfg)
    assert jlr_ == tlr_
    jp, js = jax.tree.map(jnp.asarray, params), jinit(jax.tree.map(jnp.asarray, params))
    tp = interop.params_from_jax(params)
    ts = tinit(tp)
    for step in (1, 2):  # the second update sees non-zero moments
        grads = _tree(rng)
        jp, js = jupd(jax.tree.map(jnp.asarray, grads), js, jp, jnp.asarray(step), jnp.float32(tlr_))
        with torch.no_grad():
            tp, ts = tupd(interop.params_from_jax(grads), ts, tp, torch.tensor(step), torch.tensor(tlr_))
    # fp32, the same elementwise operations in the same order
    for port, ref in zip(_leaves({"p": tp, "s": ts}),
                         jax.tree.leaves({"p": jp, "s": js})):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dynamic_loss_scale_matches_jax():
    fp16 = {"enabled": True, "loss_scale_window": 3, "hysteresis": 2, "min_loss_scale": 4.0}
    jfp, tfp = jconfig.FP16Config(**fp16), tconfig.FP16Config(**fp16)
    finite_seq = np.random.default_rng(0).random(60) < 0.7
    js = (jnp.float32(64.0), jnp.int32(0), jnp.int32(2))
    ts = (torch.tensor(64.0), torch.tensor(0, dtype=torch.int32), torch.tensor(2, dtype=torch.int32))
    for finite in finite_seq:
        js = jengine._dynamic_loss_scale(jnp.asarray(finite), js[0], js[1], js[2], jfp)
        ts = tengine._dynamic_loss_scale(torch.tensor(bool(finite)), ts[0], ts[1], ts[2], tfp)
        assert [float(t) for t in ts] == [float(j) for j in js]


BENCH_DS = {
    "train_batch_size": 64, "train_micro_batch_size_per_gpu": 16, "gradient_accumulation_steps": 4,
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1}, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "steps_per_print": 1000000, "mesh": {"data": -1},
}

CONFIGS = {
    "base_config": base_config(),  # 16 != 1 x 2 on one device: both raise
    "base_config_one_device": base_config(train_batch_size=2),
    "bench": BENCH_DS,
    "triangulate_gas": {"train_batch_size": 12, "train_micro_batch_size_per_gpu": 3,
                        "fp16": {"enabled": True, "initial_scale_power": 12, "hysteresis": 3},
                        "seed": 7, "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 5}}},
    "inconsistent": {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
                     "gradient_accumulation_steps": 2},
    "fp16_and_bf16": {"train_batch_size": 2, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
    "no_batch": {"optimizer": {"type": "SGD"}},
}


def _config_view(cfg):
    return {
        "batch": (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu, cfg.gradient_accumulation_steps),
        "print_seed_clip": (cfg.steps_per_print, cfg.seed, cfg.gradient_clipping),
        "fp16": tuple(getattr(cfg.fp16, f) for f in ("enabled", "loss_scale", "initial_scale_power",
                                                     "loss_scale_window", "hysteresis", "min_loss_scale")),
        "bf16": cfg.bf16.enabled, "zero": cfg.zero_optimization.stage,
        "optimizer": (cfg.optimizer.type, cfg.optimizer.params),
        "scheduler": (cfg.scheduler.type, cfg.scheduler.params),
        "dtype": str(cfg.compute_dtype).rsplit(".", 1)[-1].strip("'>"),
    }


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_parses_like_jax(name):
    d = CONFIGS[name]
    try:
        ref = _config_view(jconfig.DeepSpeedConfig.from_dict(d, world_size=1))
    except jconfig.DeepSpeedConfigError:
        with pytest.raises(tconfig.DeepSpeedConfigError):
            tconfig.DeepSpeedConfig.from_dict(d, world_size=1)
        return
    assert _config_view(tconfig.DeepSpeedConfig.from_dict(d, world_size=1)) == ref


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
    {"optimizer": {"type": "OneBitAdam"}},
    {"flops_profiler": {"enabled": True}},
    {"activation_checkpointing": {"enabled": True, "cpu_checkpointing": True}},
    {"elasticity": {"enabled": True}},
    {"telemetry": {"enabled": True}},
    {"mesh": {"data": 2}},
])
def test_unported_config_blocks_raise(block):
    with pytest.raises(NotImplementedError):
        tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2, **block})


# The monitor and logging blocks the JAX engine acts on (MonitorMaster, comms
# logging, timers, state dumps); the port has no monitor/ yet.
MONITOR_BLOCKS = {
    "csv_monitor": {"enabled": True, "output_path": "logs", "job_name": "run"},
    "tensorboard": {"enabled": True, "output_path": "logs"},
    "wandb": {"enabled": True, "project": "p"},
    "comms_logger": {"enabled": True, "verbose": True},
    "wall_clock_breakdown": True,
    "memory_breakdown": True,
    "dump_state": True,
}


@pytest.mark.parametrize("name", list(MONITOR_BLOCKS))
def test_monitor_and_logging_blocks_are_refused_not_dropped(name):
    d = {"train_batch_size": 2, name: MONITOR_BLOCKS[name]}
    ref = jconfig.DeepSpeedConfig.from_dict(d, world_size=1)  # the reference takes it and acts on it
    ref_value = getattr(ref, name)
    assert (ref_value.enabled if hasattr(ref_value, "enabled") else ref_value) is True
    with pytest.raises(NotImplementedError, match=name):
        tconfig.DeepSpeedConfig.from_dict(d)


def test_monitor_and_logging_blocks_parse_when_off():
    off = {name: {**v, "enabled": False} if isinstance(v, dict) else False for name, v in MONITOR_BLOCKS.items()}
    cfg = tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2, **off})
    assert cfg.train_batch_size == 2


def _models(**kw):
    base = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32)
    jcfg = jtfm.TransformerConfig(**base, dtype=jnp.float32, **kw)
    tcfg = ttfm.TransformerConfig(**base, dtype=torch.float32, **kw)
    jparams = jtfm.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)  # non-trivial LayerNorm and bias leaves
    jparams = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                           jparams)
    return jcfg, tcfg, jparams


LOSS_CASES = {
    "xla_chunked": {"loss_chunk_size": 16},
    "flash_chunked": {"attn_impl": "flash", "loss_chunk_size": 16},
    "flash_alibi_local": {"attn_impl": "flash", "pos_emb": "alibi", "local_attn_window": 8,
                          "local_attn_layers": (1, 0), "loss_chunk_size": 0},
    "xla_alibi_local": {"pos_emb": "alibi", "local_attn_window": 8, "local_attn_layers": (1, 0)},
    "flash_neox": {"attn_impl": "flash", "pos_emb": "rotary", "parallel_residual": True},
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_gradients_match_jax(name):
    """causal_lm_loss and its parameter gradients; fp32, summation order
    only through two layers and the loss (1e-5 on the loss, gradients as
    tests/test_flash_attention.py:64)."""
    jcfg, tcfg, jparams = _models(**LOSS_CASES[name])
    toks = np.random.default_rng(1).integers(0, 97, size=(2, 65)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jtfm.causal_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}))(
        jax.tree.map(jnp.asarray, jparams))
    tp = topt.tree_map(lambda t: t.requires_grad_(True), interop.params_from_jax(jparams))
    tl = ttfm.causal_lm_loss(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for port, ref in zip(_leaves(topt.tree_map(lambda t: t.grad, tp)), jax.tree.leaves(jg)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5)


WHOLE_SLICE_DS = base_config(
    train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2,
    optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    scheduler={"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                              "warmup_num_steps": 10}},
)


def test_whole_slice_train_batch_tracks_jax():
    """initialize -> 3 × train_batch with attn_impl='flash', fp32, from the
    same weights. Loss 1e-5 relative and grad norm 1e-4 relative (summation
    order through forward, backward and the norm); lr exact to fp32; params
    after 3 AdamW steps within 1e-6. The key bias ``bk`` is the exception:
    its gradient is zero in exact arithmetic (it shifts each query's scores
    by a constant), so in both packages Adam normalises rounding noise into
    steps of up to lr; it is held to 1e-4, the size of one such step."""
    jmodel = tiny_transformer(attn_impl="flash", max_seq_len=128)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, config=WHOLE_SLICE_DS, mesh=single_device_mesh())
    init_params = jax.tree.map(np.asarray, jeng.state["params"])
    tcfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=128, num_layers=2, num_heads=4,
                                  hidden_size=64, attn_impl="flash")
    teng, _, _, sched = deepspeed_tpu_torch.initialize(
        model=ttfm.Model(tcfg), config=WHOLE_SLICE_DS, model_parameters=interop.params_from_jax(init_params),
        device="cpu")
    assert sched is teng.lr_schedule
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 129)).astype(np.int32)
    for _ in range(3):
        jm = jax.device_get(jeng.train_batch({"tokens": tokens}))
        tm = teng.train_batch({"tokens": tokens})
        assert not bool(tm["overflow"]) and not bool(jm["overflow"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert teng.get_global_step() == jeng.get_global_step() == 3
    jparams = jax.tree.map(np.asarray, jeng.state["params"])
    for name in jparams["layers"]:
        np.testing.assert_allclose(teng.state["params"]["layers"][name].numpy(), jparams["layers"][name],
                                   rtol=0, atol=1e-4 if name == "bk" else 1e-6, err_msg=name)
    for name in set(jparams) - {"layers"}:
        np.testing.assert_allclose(teng.state["params"][name].numpy(), jparams[name], rtol=0, atol=1e-6,
                                   err_msg=name)


def _tiny_engine(ds, **model_kw):
    cfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32,
                                 **model_kw)
    return tengine.DeepSpeedEngine(ttfm.Model(cfg), ds, device="cpu")


def test_fp16_overflow_skips_and_loss_scale_follows_the_rule():
    ds = {"train_batch_size": 2, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
          "fp16": {"enabled": True, "initial_scale_power": 32, "hysteresis": 2},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    eng = _tiny_engine(ds, dtype=torch.float16)
    tokens = np.random.default_rng(0).integers(0, 97, size=(2, 33)).astype(np.int32)
    before = topt.tree_map(torch.clone, eng.state["params"])
    fp16 = jconfig.FP16Config(**ds["fp16"])
    js = (jnp.float32(2.0 ** 32), jnp.int32(0), jnp.int32(2))
    for i in range(3):
        m = eng.train_batch({"tokens": tokens})
        assert bool(m["overflow"])  # grads of loss × 2^32 overflow fp16
        assert float(m["loss_scale"]) == float(js[0])
        js = jengine._dynamic_loss_scale(jnp.asarray(False), *js, fp16)
        assert eng.skipped_steps == i + 1 and eng.get_global_step() == 0
        assert eng.loss_scale == float(js[0])
    for a, b in zip(topt.tree_leaves(eng.state["params"]), topt.tree_leaves(before)):
        assert torch.equal(a, b)
    eng.state["loss_scale"] = torch.tensor(256.0)
    m = eng.train_batch({"tokens": tokens})
    assert not bool(m["overflow"]) and eng.get_global_step() == 1 and eng.skipped_steps == 3
    assert any(not torch.equal(a, b) for a, b in zip(topt.tree_leaves(eng.state["params"]),
                                                       topt.tree_leaves(before)))


def test_dropout_and_layer_drop():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    assert ttfm._dropout(x, 0.0, gen) is x and ttfm._dropout(x, 0.3, None) is x
    y = ttfm._dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005  # 200k Bernoulli(0.7): sd 0.001
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))

    ds = {"train_batch_size": 2, "steps_per_print": 1000, "seed": 3,
          "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.01},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    tokens = np.random.default_rng(0).integers(0, 97, size=(2, 33)).astype(np.int32)
    params = ttfm.init(ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4,
                                              hidden_size=32), torch.Generator().manual_seed(0))
    losses = []
    for seed in (3, 3, 4):
        cfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4,
                                     hidden_size=32, hidden_dropout=0.2, attn_dropout=0.2)
        eng = tengine.DeepSpeedEngine(ttfm.Model(cfg), {**ds, "seed": seed}, params=params, device="cpu")
        assert eng.model.config.pld_enabled  # the config block turns layer drop on
        losses.append(float(eng.train_batch({"tokens": tokens})["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    # eval_batch runs without dropout or layer drop
    plain = ttfm.causal_lm_loss(ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2,
                                                       num_heads=4, hidden_size=32),
                                params, {"tokens": torch.from_numpy(tokens)})
    eng = tengine.DeepSpeedEngine(ttfm.Model(cfg), ds, params=params, device="cpu")
    assert float(plain) == pytest.approx(eng.eval_batch({"tokens": tokens}), rel=1e-6)
