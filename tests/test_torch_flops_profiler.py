"""Port parity: the flops profiler (``profiling/flops_profiler/profiler.py``).

With ``attn_impl="xla"`` and the same weights (``interop.params_from_jax``),
the port's matmul FLOPs (``mm``/``bmm``, counted as 2·M·N·K) equal the JAX
profiler's ``dot_general`` FLOPs exactly, in total and under each of the
model's named scopes (``embed``, ``attn``, ``ffn``, ``lm_head``; the
attention products and the loss's head sit outside them in both models).
The rest of the count (elementwise ops, transcendentals, reductions) comes
from ATen ops that fuse differently from JAX's primitives (one
``native_layer_norm`` against its decomposition): at these widths the
port's non-matmul FLOPs were measured 6.9% (the loss) and 4.4% (the
logits) below JAX's, and are held within 12%. The engine's
``flops_profiler`` block prints the profile once, at ``profile_step``, as
the JAX engine does; ``get_model_profile`` counts the model's parameters
as JAX's does.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.profiling.flops_profiler import profiler as jprof
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.profiling.flops_profiler import profiler as tprof
from simple_model import base_config, tiny_transformer

SCOPES = ("embed", "attn", "ffn", "lm_head")
NON_MATMUL_RTOL = 0.12


def _top(scope: str) -> str:
    head = scope.split("/", 1)[0] if scope else ""
    return head if head in SCOPES else ""


def _jax_matmul_by_scope(jaxpr) -> dict:
    """dot_general FLOPs under each top-level named scope (the JAX
    profiler's walk, ``count_jaxpr_flops``, kept to matmuls)."""
    out: dict = {}

    def visit(jx, mult):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            inners = [eqn.params.get(k) for k in ("jaxpr", "call_jaxpr", "fun_jaxpr", "body_jaxpr", "branches")]
            inners = [x for x in inners if x is not None]
            if inners:
                m = mult * (eqn.params.get("length", 1) if name == "scan" else 1)
                for inner in inners:
                    for sub in (inner if isinstance(inner, (tuple, list)) else [inner]):
                        visit(sub.jaxpr if hasattr(sub, "jaxpr") else sub, m)
                continue
            if name == "dot_general":
                key = _top(jprof._eqn_scope(eqn))
                out[key] = out.get(key, 0.0) + jprof._dot_general_flops(eqn) * mult
    visit(jaxpr, 1.0)
    return out


def _fold(by_scope: dict) -> dict:
    out: dict = {}
    for k, v in by_scope.items():
        out[_top(k)] = out.get(_top(k), 0.0) + v
    return out


@pytest.fixture(scope="module")
def pair():
    jmodel = tiny_transformer(attn_impl="xla")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64,
                                 attn_impl="xla")
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 17)).astype(np.int32)
    return jmodel, params, ttfm.Model(cfg), interop.params_from_jax(params), tokens


@pytest.mark.parametrize("fn", ["loss", "logits"])
def test_matmul_flops_equal_jax_per_scope(pair, fn):
    jmodel, jparams, tmodel, tparams, tokens = pair
    if fn == "loss":
        jf, tf = jmodel.loss, tmodel.loss
        jargs, targs = (jparams, {"tokens": tokens}), (tparams, {"tokens": torch.from_numpy(tokens)})
    else:
        jf, tf = jmodel.apply, tmodel.apply
        jargs, targs = (jparams, tokens), (tparams, torch.from_numpy(tokens).long())
    jres = jprof.FlopsProfiler().profile(jf, *jargs, time_it=False, params=jparams)
    tres = tprof.FlopsProfiler().profile(tf, *targs, time_it=False, params=tparams)
    jscopes = _jax_matmul_by_scope(jax.make_jaxpr(jf)(*jargs).jaxpr)
    assert tres.matmul_flops == jres.by_primitive["dot_general"] == sum(jscopes.values())
    assert _fold(tres.matmul_by_scope) == {k: v for k, v in jscopes.items() if v}
    assert set(_fold(tres.by_scope)) == {k for k in _fold(jres.by_scope) if k in SCOPES or k == ""}
    if fn == "logits":
        assert jscopes["lm_head"] > 0 and _fold(tres.matmul_by_scope)["lm_head"] == jscopes["lm_head"]
    rest_t = tres.total_flops - tres.matmul_flops
    rest_j = jres.total_flops - jres.by_primitive["dot_general"]
    assert rest_t == pytest.approx(rest_j, rel=NON_MATMUL_RTOL)
    assert tres.total_params == jres.total_params


def test_print_model_profile_tree(pair, capsys):
    _, _, tmodel, tparams, tokens = pair
    prof = tprof.FlopsProfiler()
    res = prof.profile(tmodel.apply, tparams, torch.from_numpy(tokens).long(), params=tparams)
    assert res.latency_s > 0 and res.tflops_per_sec > 0
    text = prof.print_model_profile(res, detailed=True, depth=0)
    assert capsys.readouterr().out.strip() == text.strip()
    for name in SCOPES[1:] + ("mm",):
        assert f"  {name}" in text
    tree = tprof.scope_tree(res.by_scope)
    assert tree["flops"] == pytest.approx(res.total_flops)
    assert tprof.scope_tree({"a/b": 2.0, "a": 1.0}) == jprof.scope_tree({"a/b": 2.0, "a": 1.0})
    flops, n_params, latency = tprof.get_model_profile(tmodel, tokens_shape=(1, 16))
    jflops, jparams_n, _ = jprof.get_model_profile(tiny_transformer(attn_impl="xla"), tokens_shape=(1, 16),
                                                   time_it=False)
    assert n_params == jparams_n and latency > 0
    assert flops == pytest.approx(jflops, rel=0.05)


def test_engine_flops_profiler_prints_once_at_profile_step(capsys):
    ds = base_config(train_batch_size=4, train_micro_batch_size_per_gpu=2,
                     flops_profiler={"enabled": True, "profile_step": 2, "detailed": True})
    cfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(cfg), config=ds, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 33)).astype(np.int32)
    outs = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        capsys.readouterr()
        for _ in range(3):
            eng.train_batch({"tokens": tokens})
        outs[name] = capsys.readouterr().out
    assert outs["jax"].count("flops profiler (reference: flops-profiler)") == 1
    assert outs["torch"].count("flops profiler (reference: flops-profiler)") == 1
    for scope in ("ffn", "attn"):
        assert f"  {scope}" in outs["torch"]
