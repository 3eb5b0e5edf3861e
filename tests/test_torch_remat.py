"""Port parity: activation checkpointing (remat).

Remat changes what the backward keeps, never the arithmetic: for every
policy and group size the loss and the gradients equal those without remat
exactly (fp32 on the CPU, the same operations on the same inputs, dropout
replayed from the layers' seeded generators). The ``activation_checkpointing``
block and ``model_overrides`` are held against the JAX package's, and three
``train_batch`` steps with remat track the JAX engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import activation_checkpointing as tac
from deepspeed_tpu_torch.runtime import config as tconfig
from simple_model import base_config, tiny_transformer

POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable", "save_flash", "dots_and_flash"]
TINY = dict(vocab_size=97, max_seq_len=64, num_layers=4, num_heads=4, hidden_size=32, attn_impl="flash",
            hidden_dropout=0.1, attn_dropout=0.1, loss_chunk_size=16)


def _loss_and_grads(cfg, params, tokens, seed=11):
    leaves = topt.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss = ttfm.causal_lm_loss(cfg, leaves, {"tokens": tokens}, rng=ttfm.dropout_key(seed, 0))
    loss.backward()
    return loss.detach(), topt.tree_leaves(topt.tree_map(lambda t: t.grad, leaves))


@pytest.fixture(scope="module")
def tiny_inputs():
    cfg = ttfm.TransformerConfig(**TINY)
    params = ttfm.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, size=(2, 33)))
    return cfg, params, tokens, _loss_and_grads(cfg, params, tokens)


@pytest.mark.parametrize("group", [0, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gives_the_gradients_of_no_remat(tiny_inputs, policy, group):
    cfg, params, tokens, (ref_loss, ref_grads) = tiny_inputs
    loss, grads = _loss_and_grads(cfg.replace(remat=True, remat_policy=policy, remat_group=group), params, tokens)
    assert loss.item() == ref_loss.item()
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("policy,forwards", [("nothing_saveable", 8), ("everything_saveable", 4),
                                             ("dots_saveable", 8), ("save_flash", 4), ("dots_and_flash", 4)])
def test_flash_policies_keep_the_forward_out_of_the_recompute(tiny_inputs, monkeypatch, policy, forwards):
    """The flash forward runs once per layer in the forward, and again in the
    backward only under the policies that do not save its outputs (the
    port's counterpart of 48 vs 96 launches per train_batch on the card)."""
    cfg, params, tokens, _ = tiny_inputs
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference", lambda *a, **k: calls.append(1) or plain(*a, **k))
    _loss_and_grads(cfg.replace(remat=True, remat_policy=policy), params, tokens)
    assert len(calls) == forwards


def test_group_that_does_not_divide_warns_and_goes_per_layer(tiny_inputs):
    cfg, params, tokens, (ref_loss, _) = tiny_inputs
    cfg3 = cfg.replace(remat=True, remat_group=3)
    with pytest.warns(UserWarning, match="falling back to per-layer"):
        assert [list(r) for r in ttfm._remat_groups(cfg3)] == [[0], [1], [2], [3]]
    assert [list(r) for r in ttfm._remat_groups(cfg.replace(remat=True, remat_group=2))] == [[0, 1], [2, 3]]
    with pytest.warns(UserWarning, match="falling back to per-layer"):
        loss, _ = _loss_and_grads(cfg3, params, tokens)
    assert loss.item() == ref_loss.item()


@pytest.mark.parametrize("field,value", [("remat_policy", "checkpoint_dots"), ("remat_offload", True),
                                         ("remat_partition_axis", "model")])
def test_unported_remat_options_raise(field, value):
    with pytest.raises(NotImplementedError):
        ttfm.TransformerConfig(remat=True, **{field: value})


AC_BLOCKS = {
    "off": {"enabled": False},
    "on": {"enabled": True},
    "policy": {"enabled": True, "policy": "dots_saveable"},
    "groups": {"enabled": True, "number_checkpoints": 2},
    "groups_uneven": {"enabled": True, "number_checkpoints": 3},
    "knobs": {"enabled": True, "contiguous_memory_optimization": True, "profile": True, "policy": "save_flash"},
}


@pytest.fixture
def clean_act_ckpt():
    jac.reset()
    tac.reset()
    yield
    jac.reset()
    tac.reset()


@pytest.mark.parametrize("name", list(AC_BLOCKS))
def test_activation_checkpointing_block_matches_jax(clean_act_ckpt, name):
    block = AC_BLOCKS[name]
    ds = {"train_batch_size": 2, "activation_checkpointing": block}
    jcfg = jconfig.DeepSpeedConfig.from_dict(ds, world_size=1).activation_checkpointing
    tcfg = tconfig.DeepSpeedConfig.from_dict(ds, world_size=1).activation_checkpointing
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jac.set_config(jcfg)
    tac.set_config(tcfg)
    assert tac.model_overrides(4) == jac.model_overrides(4)
    assert tac.summarize() == jac.checkpointing.summarize()
    jac.reset()
    tac.reset()
    assert dataclasses.asdict(tac.configure(deepspeed_config=ds, num_checkpoints=1)) == dataclasses.asdict(
        jac.configure(deepspeed_config=ds, num_checkpoints=1))
    assert tac.is_configured() and jac.is_configured()


def test_checkpoint_api_replays_the_global_rng(clean_act_ckpt):
    """``checkpoint(fn, *args)`` under the default (nothing_saveable) policy:
    a segment drawing dropout from the global RNG gets the gradient of the
    plain call, because the RNG state is restored for the recompute."""
    tac.configure(deepspeed_config={"activation_checkpointing": {}})
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    w = torch.randn(16, 16, generator=torch.Generator().manual_seed(1)).requires_grad_(True)

    def segment(x, w):
        return torch.nn.functional.dropout(torch.tanh(x @ w), 0.3)

    torch.manual_seed(5)
    segment(x, w).sum().backward()
    ref = (x.grad.clone(), w.grad.clone())
    x.grad = w.grad = None
    torch.manual_seed(5)
    tac.checkpoint_wrapped(segment)(x, w).sum().backward()
    torch.testing.assert_close((x.grad, w.grad), ref, rtol=0, atol=0)
    with tac.get_rng_tracker().fork():
        pass


def test_cpu_checkpointing_and_partition_activations_raise(clean_act_ckpt):
    for knob in ("cpu_checkpointing", "partition_activations"):
        with pytest.raises(NotImplementedError):
            tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2,
                                               "activation_checkpointing": {"enabled": True, knob: True}})
        with pytest.raises(NotImplementedError):
            tac.configure(deepspeed_config={"activation_checkpointing": {knob: True}})


REMAT_DS = base_config(
    train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2,
    optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    activation_checkpointing={"enabled": True, "policy": "dots_and_flash", "number_checkpoints": 1},
)


def test_train_batch_with_remat_tracks_jax(clean_act_ckpt):
    """initialize -> 3 × train_batch, both engines turning remat on from the
    activation_checkpointing block (dots_and_flash, one checkpoint group),
    fp32 from the same weights: the tolerances of
    tests/test_torch_training.py (loss 1e-5, grad norm 1e-4, lr exact to fp32)."""
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(attn_impl="flash", max_seq_len=128),
                                             config=REMAT_DS, mesh=single_device_mesh())
    assert jeng.model.config.remat and jeng.model.config.remat_group == 2
    init_params = jax.tree.map(np.asarray, jeng.state["params"])
    tcfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=64,
                                  attn_impl="flash")
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(tcfg), config=REMAT_DS,
                                                   model_parameters=interop.params_from_jax(init_params),
                                                   device="cpu")
    mc = teng.model.config
    assert (mc.remat, mc.remat_policy, mc.remat_group) == (True, "dots_and_flash", 2)
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 129)).astype(np.int32)
    for _ in range(3):
        jm = jax.device_get(jeng.train_batch({"tokens": tokens}))
        tm = teng.train_batch({"tokens": tokens})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert teng.get_global_step() == jeng.get_global_step() == 3
    assert float(jnp.asarray(jm["loss"])) < 10.0
