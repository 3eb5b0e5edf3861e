"""Port parity: the transformer model family.

The same weights (``tfm.init`` of the JAX package, carried over with
``interop.params_from_jax``) and the same numpy tokens go through the JAX
functions and their ports, in fp32 on the CPU. The JAX decode step runs the
Pallas decode kernel in interpret mode, as the JAX package's own tests run
it; the port's CPU decode step runs the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm

# fp32 on both sides; matmul and softmax summation orders differ between
# XLA and PyTorch, a few ulps per op through two layers
TOL = 1e-4
V, SMAX = 97, 128

CONFIGS = {
    "gpt2": {},
    "neox": {"pos_emb": "rotary", "rotary_pct": 0.5, "parallel_residual": True},
    "gptj": {"pos_emb": "rotary", "rotary_interleaved": True, "activation": "relu",
             "tie_embeddings": False},
    "bloom": {"pos_emb": "alibi", "embed_ln": True, "activation": "gelu_exact"},
}


def _models(**kw):
    base = dict(vocab_size=V, max_seq_len=SMAX, num_layers=2, num_heads=4, hidden_size=32)
    jcfg = jtfm.TransformerConfig(**base, dtype=jnp.float32, loss_chunk_size=0, **kw)
    tcfg = ttfm.TransformerConfig(**base, dtype=torch.float32, **kw)
    jparams = jtfm.init(jcfg, jax.random.PRNGKey(0))
    # non-trivial LayerNorm and bias leaves, so a misplaced one shows
    rng = np.random.default_rng(7)
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), jparams)
    tparams = interop.params_from_jax(jparams)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jparams), tparams


def _tokens(B, T, seed=1):
    return np.random.default_rng(seed).integers(0, V, size=(B, T)).astype(np.int32)


def _close(port, ref, tol=TOL):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CONFIGS) + ["bert"])
def test_apply_logits_match_jax(name):
    kw = CONFIGS.get(name, {"norm_style": "post", "causal": False, "final_ln": False})
    jcfg, tcfg, jp, tp = _models(**kw)
    toks = _tokens(2, 13)
    _close(ttfm.apply(tcfg, tp, torch.from_numpy(toks).long()),
           jtfm.apply(jcfg, jp, jnp.asarray(toks)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_decode_match_jax(name):
    """Prefill 11 tokens, then two single-token decode steps at scalar pos."""
    jcfg, tcfg, jp, tp = _models(**CONFIGS[name])
    B, T = 2, 11
    toks = _tokens(B, T)
    jcache = jtfm.init_cache(jcfg, B, SMAX)
    tcache = ttfm.init_cache(tcfg, B, SMAX)
    jl, jcache = jtfm.apply_with_cache(jcfg, jp, jnp.asarray(toks), jcache, 0)
    tl, tcache = ttfm.apply_with_cache(tcfg, tp, torch.from_numpy(toks).long(), tcache, 0)
    _close(tl, jl)
    for step in range(2):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
        jl, jcache = jtfm.apply_with_cache(jcfg, jp, jnp.asarray(nxt), jcache, T + step)
        tl, tcache = ttfm.apply_with_cache(
            tcfg, tp, torch.from_numpy(nxt).long(), tcache, torch.tensor(T + step))
        _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_last_only_and_last_index_match_jax():
    jcfg, tcfg, jp, tp = _models()
    toks = _tokens(2, 9)
    for kw in ({"last_only": True}, {"last_index": 4}, {"last_index": 99}):
        jl, _ = jtfm.apply_with_cache(jcfg, jp, jnp.asarray(toks), jtfm.init_cache(jcfg, 2, SMAX), 0, **kw)
        tl, _ = ttfm.apply_with_cache(tcfg, tp, torch.from_numpy(toks).long(),
                                      ttfm.init_cache(tcfg, 2, SMAX), 0, **kw)
        assert tl.shape == (2, 1, V)
        _close(tl, jl)


@pytest.mark.parametrize("T", [1, 4])
def test_per_row_pos_write_pos_drop_matches_jax(T):
    """Per-row positions; row 1 is idle (write_pos = Smax: its write is
    dropped) and row 2's block runs past the cache end (the tail dropped)."""
    jcfg, tcfg, jp, tp = _models(pos_emb="rotary")
    B = 3
    prompt = _tokens(B, 20)
    jcache = jtfm.init_cache(jcfg, B, SMAX)
    jl, jcache = jtfm.apply_with_cache(jcfg, jp, jnp.asarray(prompt), jcache, 0)
    tcache = interop.params_from_jax(jax.tree.map(np.asarray, jcache))
    before = {kv: t.clone() for kv, t in tcache.items()}

    toks = _tokens(B, T, seed=3)
    pos = np.array([20, 5, SMAX - 2], np.int32)
    write_pos = np.array([20, SMAX, SMAX - 2], np.int32)
    jl, jcache = jtfm.apply_with_cache(jcfg, jp, jnp.asarray(toks), jcache, jnp.asarray(pos),
                                       write_pos=jnp.asarray(write_pos))
    tl, tcache = ttfm.apply_with_cache(tcfg, tp, torch.from_numpy(toks).long(), tcache,
                                       torch.from_numpy(pos), write_pos=torch.from_numpy(write_pos))
    _close(tl, jl)
    for kv in ("k", "v"):
        assert torch.equal(tcache[kv][:, 1], before[kv][:, 1])  # idle row untouched
        _close(tcache[kv], jcache[kv])


def test_cache_slot_window_roundtrip_matches_jax():
    jcfg, tcfg, _, _ = _models()
    rng = np.random.default_rng(5)
    cache_np = {kv: rng.standard_normal((2, 3, SMAX, 4, 8)).astype(np.float32) for kv in ("k", "v")}
    jcache = jax.tree.map(jnp.asarray, cache_np)
    tcache = interop.params_from_jax(cache_np)
    for slot, start in ((1, 10), (2, SMAX - 4), (0, SMAX)):  # the last start is clamped
        jw = jtfm.slice_cache_slot(jcache, slot, 6, start)
        tw = ttfm.slice_cache_slot(tcache, slot, 6, start)
        _close(tw["k"], jw["k"])
        _close(tw["v"], jw["v"])
    window = {kv: rng.standard_normal((2, 1, 5, 4, 8)).astype(np.float32) for kv in ("k", "v")}
    for slot, start in ((1, 7), (2, SMAX - 1)):
        jcache = jtfm.update_cache_slot(jcache, jax.tree.map(jnp.asarray, window), slot, start)
        ttfm.update_cache_slot(tcache, interop.params_from_jax(window), slot, start)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("interleaved", [False, True])
def test_rotary_and_layer_norm_match_jax(interleaved):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    positions = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    _close(ttfm.rotary_embed(torch.from_numpy(x), torch.from_numpy(positions), 12, interleaved),
           jtfm.rotary_embed(jnp.asarray(x), jnp.asarray(positions), 12, interleaved))
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale, bias = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    y = ttfm.layer_norm(torch.from_numpy(h).bfloat16(), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    assert y.dtype == torch.bfloat16
    ref = jtfm.layer_norm(jnp.asarray(h, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    _close(y.float(), ref.astype(jnp.float32), tol=1e-2)  # one bf16 rounding of outputs < 4
    _close(ttfm.alibi_slopes(12), jtfm.alibi_slopes(12))


@pytest.mark.parametrize("field,value", [
    ("attn_impl", "ring"), ("weight_bits", 8), ("act_quant_bits", 8),
    ("attn_impl", "ulysses"), ("remat_partition_axis", "context"),
])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError):
        ttfm.TransformerConfig(**{field: value})
