"""Port parity: the inference engine and its sampler.

The JAX ``InferenceEngine`` (decode through the Pallas kernel in interpret
mode) and the port's engine on the CPU, with the JAX engine's weights
carried over through ``interop.params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig

TINY = dict(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=JaxModel(JaxConfig(**TINY, dtype=jnp.float32, loss_chunk_size=0)),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**TINY)), config={"dtype": "fp32"},
                          params=params, device="cpu")
    return jeng, teng


def _prompt(B=2, S=9, seed=0):
    return np.random.default_rng(seed).integers(0, 97, size=(B, S)).astype(np.int32)


def test_greedy_generate_matches_jax(engines):
    jeng, teng = engines
    prompt = _prompt()
    ref = jeng.generate(prompt, max_new_tokens=8)
    out = teng.generate(prompt, max_new_tokens=8)
    assert out.dtype == np.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out, ref)


def test_forward_matches_jax(engines):
    jeng, teng = engines
    prompt = _prompt(S=12, seed=4)
    # fp32 both sides, summation order only
    np.testing.assert_allclose(teng.forward(prompt).numpy(), np.asarray(jeng.forward(prompt)),
                               rtol=1e-4, atol=1e-4)


def test_sampled_generate_shape_and_range(engines):
    _, teng = engines
    out = teng.generate(_prompt(), max_new_tokens=6, temperature=0.8, top_k=20, top_p=0.9,
                        repetition_penalty=1.2, generator=torch.Generator().manual_seed(3))
    assert out.shape == (2, 6) and (out >= 0).all() and (out < 97).all()
    again = teng.generate(_prompt(), max_new_tokens=6, temperature=0.8, top_k=20, top_p=0.9,
                          repetition_penalty=1.2, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(out, again)  # seeded generator: reproducible


def test_sequence_budget_and_unported_options_raise(engines):
    _, teng = engines
    with pytest.raises(ValueError):
        teng.generate(_prompt(S=100), max_new_tokens=29)
    cfg = TransformerConfig(**TINY)
    for config in ({"tensor_parallel": {"tp_size": 2}}, {"quantize": {"enabled": True}}):
        with pytest.raises(NotImplementedError):
            init_inference(Model(cfg), config=config, device="cpu")
    with pytest.raises(ValueError):
        init_inference(Model(cfg), config={"dtype": "int8"}, device="cpu")
    eng = init_inference(Model(cfg), config={"dtype": "fp16"}, device="cpu")
    assert eng.dtype == torch.bfloat16 and eng.params["wte"].dtype == torch.bfloat16


def _logits(seed=0, B=3, V=50):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


@pytest.mark.parametrize("k", [0, 1, 5, 49, 50])
def test_top_k_matches_jax(k):
    x = _logits()
    np.testing.assert_array_equal(tsampling.apply_top_k(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jsampling.apply_top_k(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 1.0])
def test_top_p_matches_jax(p):
    x = _logits(seed=1)
    np.testing.assert_array_equal(tsampling.apply_top_p(torch.from_numpy(x), p).numpy(),
                                  np.asarray(jsampling.apply_top_p(jnp.asarray(x), p)))


def test_repetition_penalty_and_seen_match_jax():
    x = _logits(seed=2)
    toks = np.random.default_rng(3).integers(0, 50, size=(3, 4)).astype(np.int32)
    jseen = jsampling.update_seen(jnp.zeros((3, 50), jnp.bool_), jnp.asarray(toks))
    tseen = tsampling.update_seen(torch.zeros(3, 50, dtype=torch.bool), torch.from_numpy(toks))
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    np.testing.assert_array_equal(
        tsampling.apply_repetition_penalty(torch.from_numpy(x), tseen, 1.3).numpy(),
        np.asarray(jsampling.apply_repetition_penalty(jnp.asarray(x), jseen, 1.3)))
    greedy = tsampling.sample_logits(torch.from_numpy(x), torch.Generator(),
                                     tsampling.SamplerConfig(temperature=0.0, repetition_penalty=1.3),
                                     seen=tseen)
    ref = jsampling.sample_logits(jnp.asarray(x), jax.random.PRNGKey(0),
                                  jsampling.SamplerConfig(temperature=0.0, repetition_penalty=1.3),
                                  seen=jseen)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref))
