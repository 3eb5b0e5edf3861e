"""Port parity: DeepSpeed's 3-call loop ``loss = engine(micro_batch)`` ->
``engine.backward(loss)`` -> ``engine.step()``.

Against the JAX engine's 3-call loop from the same weights on the same
micro-batches (fp32 on the CPU, flash attention and the fused loss: the
JAX side runs its Pallas kernels in interpret mode, the port's CPU tensors
take the kernels' plain versions): the losses to 1e-5 relative and the
parameters to 1e-6. Against the port's own ``train_batch``, which runs the
same update: bitwise, dropout included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import engine as tengine

MODEL = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32, attn_impl="flash",
             loss_impl="fused_xent")
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
      "optimizer": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}}, "gradient_clipping": 1.0,
      "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.01, "warmup_max_lr": 0.05,
                                                   "warmup_num_steps": 4}},
      "steps_per_print": 10**9}
STEPS = 2


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=(4, 33)).astype(np.int32) for _ in range(STEPS)]


def _micro(tokens):
    return [{"tokens": tokens[i * 2:(i + 1) * 2]} for i in range(2)]


@pytest.fixture(scope="module")
def jax_loop():
    """The JAX engine's 3-call loop over STEPS steps -> (initial params,
    the forward losses, the final params), as numpy."""
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)),
                                             config=DS, mesh=single_device_mesh())
    init = jax.tree.map(np.asarray, jeng.state["params"])
    losses = []
    for tokens in _batches():
        for i, mb in enumerate(_micro(tokens)):
            loss = jeng(mb)
            losses.append(float(loss))
            jeng.backward(loss)
            assert jeng.is_gradient_accumulation_boundary() == (i == 1)
            jeng.step()
    assert jeng.get_global_step() == STEPS
    return init, losses, [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jeng.state["params"]))]


def _port(init, **model_kw):
    model = ttfm.Model(ttfm.TransformerConfig(**{**MODEL, **model_kw}))
    return tengine.DeepSpeedEngine(model, DS, params=interop.params_from_jax(init), device="cpu")


def _loop(eng):
    losses = []
    for tokens in _batches():
        for i, mb in enumerate(_micro(tokens)):
            loss = eng(mb)
            assert loss.ndim == 0 and not loss.requires_grad
            losses.append(float(loss))
            eng.backward(loss)
            assert eng.is_gradient_accumulation_boundary() == (i == 1)
            before = eng.state
            eng.step()
            assert (eng.state is before) == (i == 0)  # a no-op before the boundary
    return losses


def test_three_call_loop_matches_jax(jax_loop):
    init, jlosses, jparams = jax_loop
    eng = _port(init)
    losses = _loop(eng)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert eng.get_global_step() == eng.global_steps == STEPS
    for port, ref in zip(tree_leaves(eng.state["params"]), jparams):
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_three_call_loop_equals_train_batch(jax_loop, dropout):
    """The loop and train_batch run one update function on the same
    micro-batches; with dropout the backward draws train_batch's masks
    (seed, step, micro-batch), while forward's loss has none."""
    init = jax_loop[0]
    loop = _port(init, hidden_dropout=dropout, attn_dropout=dropout)
    fused = _port(init, hidden_dropout=dropout, attn_dropout=dropout)
    losses = _loop(loop)
    for step, tokens in enumerate(_batches()):
        m = fused.train_batch({"tokens": tokens})
        if dropout == 0.0:
            mean = (torch.zeros(()) + losses[2 * step] + losses[2 * step + 1]) / 2
            np.testing.assert_allclose(float(m["loss"]), float(mean), rtol=1e-6)
    for a, b in zip(tree_leaves(loop.state), tree_leaves(fused.state)):
        assert torch.equal(a, b)


def test_backward_needs_a_forward_and_a_load_drops_the_accumulation(jax_loop, tmp_path):
    eng = _port(jax_loop[0])
    with pytest.raises(RuntimeError, match="forward"):
        eng.backward()
    eng.save_checkpoint(str(tmp_path))
    mb = _micro(_batches()[0])[0]
    eng(mb)
    eng.backward()  # loss=None: backward recomputes it anyway
    assert eng._micro_count == 1 and not eng.is_gradient_accumulation_boundary()
    eng.load_checkpoint(str(tmp_path))
    assert eng._micro_count == 0 and eng._accum is None
