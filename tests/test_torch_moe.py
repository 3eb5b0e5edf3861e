"""Port parity: mixture of experts on one rank (``deepspeed_tpu_torch/moe/``
and the MoE paths of the model, the training engine and the inference
engine).

The same numpy inputs and weights (``interop.params_from_jax``) go through
the JAX functions and their ports in fp32 on the CPU. The routing is
compared first and exactly (each token's experts, queue positions and kept
flags, layer by layer for the model); on a mismatch the message prints the
logit margin of the tokens that differ. Values follow: the gating to 1e-6,
the model's logits and loss to 2e-5 relative, its gradients to 1e-4, and
the engines to ``test_torch_zero.py``'s ``LOSS_RTOL`` and
``_assert_params``.

The JAX training engine runs on ``single_device_mesh()``, so each micro-step
gates that micro-batch's rows, as the port at world 1 with the same micro
and gas does: the gated token sets, and so the capacities and drops, are
the same. Full forward and cached decode agree only without drops (the JAX
package's own note): that identity is held at an ample capacity factor.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.experts import apply_experts as japply_experts
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.moe.experts import apply_experts as tapply_experts
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.pipe import PipelinedTransformer
from deepspeed_tpu_torch.pipe.engine import PipelineEngine
from simple_model import base_config
from test_torch_zero import LOSS_RTOL, _assert_params

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=4, num_heads=4, hidden_size=64)
MOE = dict(moe_every=2, num_experts=4, moe_top_k=1, moe_capacity_factor=1.0)
VALUE_RTOL, GRAD_RTOL = 2e-5, 1e-4


def _configs(**kw):
    kw = {**TINY, **MOE, **kw}
    return (jtfm.TransformerConfig(**kw, dtype=jnp.float32, loss_chunk_size=0),
            ttfm.TransformerConfig(**kw, loss_chunk_size=0))


def _params(jcfg, seed=0):
    """(JAX params, the port's): JAX's init with noise on every leaf, so a
    misplaced LayerNorm or bias leaf shows."""
    rng = np.random.default_rng(seed + 7)
    npp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                       jtfm.init(jcfg, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, npp), interop.params_from_jax(npp)


def _tokens(B, S, seed=1, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def _close(port, ref, rtol=VALUE_RTOL, atol=1e-6):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _assert_same_routing(port_dispatch, jax_dispatch, logits, what):
    """The dense dispatch [T, E, C] of both packages equal; on a mismatch
    the tokens that differ and their top-2 logit margins."""
    pd, jd = np.asarray(port_dispatch), np.asarray(jax_dispatch)
    bad = np.nonzero((pd != jd).any(axis=(1, 2)))[0]
    if len(bad):
        top = np.sort(np.asarray(logits)[bad], axis=-1)
        raise AssertionError(f"{what}: routing differs at tokens {bad.tolist()}, logit margins "
                             f"{(top[:, -1] - top[:, -2]).tolist()}")


# ---------------------------------------------------------------------------
# Gating, dispatch/combine, the dense route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,experts,factor", [(64, 4, 1.0), (64, 4, 1.25), (4, 4, 1.0), (8192, 64, 1.0),
                                                   (1000, 7, 2.0)])
def test_compute_capacity_matches_jax(tokens, experts, factor):
    assert tsm.compute_capacity(tokens, experts, factor) == jsm.compute_capacity(tokens, experts, factor)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("skew", [0.0, 2.0], ids=["random", "skewed"])
def test_gating_matches_jax(top_k, skew):
    """combine, dispatch and aux at a capacity small enough to drop tokens
    (``skewed`` sends most tokens to expert 0)."""
    logits = np.random.default_rng(3).standard_normal((48, 6)).astype(np.float32)
    logits[:, 0] += skew
    capacity = 5
    jfn, tfn = (jsm.top1_gating, tsm.top1_gating) if top_k == 1 else (jsm.top2_gating, tsm.top2_gating)
    jc, jd, ja = jfn(jnp.asarray(logits), capacity)
    tc, td, ta = tfn(torch.from_numpy(logits), capacity)
    _assert_same_routing(td, jd, logits, f"top{top_k}")
    assert int(np.asarray(jd).sum()) < 48 * top_k  # tokens were dropped
    _close(tc, jc, rtol=1e-6)
    _close(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_combine_matches_the_jax_einsums(top_k):
    """The slot-table dispatch against JAX's one-hot einsums, the experts
    between them the same weights, with drops (capacity factor 1.0)."""
    rng = np.random.default_rng(5)
    T, M, E, Fd = 40, 16, 4, 32
    x = rng.standard_normal((T, M)).astype(np.float32)
    gate = rng.standard_normal((M, E)).astype(np.float32)
    experts = {"wi": (rng.standard_normal((E, M, Fd)) / 4).astype(np.float32),
               "wo": (rng.standard_normal((E, Fd, M)) / 6).astype(np.float32)}
    C = jsm.compute_capacity(T * top_k, E, 1.0)
    logits = x @ gate
    jgate = jsm.top1_gating if top_k == 1 else jsm.top2_gating
    _, jd, _ = jgate(jnp.asarray(x) @ jnp.asarray(gate), C)
    r, _, tc = tsm.route(torch.from_numpy(x), torch.from_numpy(gate), 1.0, top_k)
    assert tc == C
    _assert_same_routing(tsm._dense(r, E, C)[1], jd, logits, f"top{top_k} dispatch")
    jx = {k: jnp.asarray(v) for k, v in experts.items()}
    tx = {k: torch.from_numpy(v) for k, v in experts.items()}
    jout, jaux = jsm.moe_dispatch_combine(jnp.asarray(x), jnp.asarray(gate), lambda ei: japply_experts(jx, ei),
                                          capacity_factor=1.0, top_k=top_k)
    tout, taux = tsm.moe_dispatch_combine(torch.from_numpy(x), torch.from_numpy(gate),
                                          lambda ei: tapply_experts(tx, ei), capacity_factor=1.0, top_k=top_k)
    _close(tout, jout)
    _close(taux, jaux, rtol=1e-6)
    table = tsm.slot_table(tsm.slot_index(r, E, C), T, E * C)
    assert table.shape == (E * C,) and (table == T).any()  # static shape; some slots empty
    kept = table[table < T]
    assert len(torch.unique(kept)) == len(kept) or top_k == 2


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_decode_route_matches_jax_with_a_tie(top_k):
    """``moe_ffn_dense``: every expert on every token; gate columns 0 and 1
    are equal, so each token's probabilities tie there and the threshold
    keeps both whenever they reach it."""
    rng = np.random.default_rng(9)
    M, E, Fd = 16, 4, 32
    gate = rng.standard_normal((M, E)).astype(np.float32)
    gate[:, 1] = gate[:, 0]
    moe = {"gate": gate, "experts": {"wi": (rng.standard_normal((E, M, Fd)) / 4).astype(np.float32),
                                     "wo": (rng.standard_normal((E, Fd, M)) / 6).astype(np.float32)}}
    h = rng.standard_normal((3, 5, M)).astype(np.float32)
    jcfg, tcfg = _configs(moe_top_k=top_k)
    ref = jlayer.moe_ffn_dense(jcfg, jax.tree.map(jnp.asarray, moe), jnp.asarray(h))
    out = tlayer.moe_ffn_dense(tcfg, interop.params_from_jax(moe), torch.from_numpy(h))
    _close(out, ref)
    probs = torch.softmax(torch.from_numpy(h.reshape(-1, M) @ gate), dim=-1)
    thresh = torch.topk(probs, top_k, dim=-1).values[:, -1:]
    assert ((probs >= thresh).sum(-1) > top_k).any()  # a tie kept more than k experts


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recording():
    """Record each MoE layer's routing in both packages, in layer order: the
    JAX gating's dispatch and logits (through an ordered host callback, so
    its scans stay compiled) and the port's dense dispatch."""
    rec = {"jax": [], "port": []}

    def jwrap(fn):
        def gating(logits, capacity, rng=None):
            out = fn(logits, capacity, rng)
            jax.debug.callback(lambda d, lg: rec["jax"].append((np.asarray(d), np.asarray(lg))), out[1], logits,
                               ordered=True)
            return out
        return gating

    def troute(x, gate_w, capacity_factor=1.25, top_k=1, rng=None):
        r, aux, C = plain_route(x, gate_w, capacity_factor, top_k, rng)
        rec["port"].append(tsm._dense(r, gate_w.shape[1], C)[1].detach().numpy())
        return r, aux, C

    plain_route = tsm.route
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "top1_gating", jwrap(jsm.top1_gating))
        mp.setattr(jsm, "top2_gating", jwrap(jsm.top2_gating))
        mp.setattr(tsm, "route", troute)
        yield rec
        jax.effects_barrier()


@pytest.fixture(autouse=True)
def _no_active_mesh():
    """Direct JAX model calls must not pick up a mesh an engine of another
    test left as the MoE sharding hook's (as ``test_dropout_moe.py``)."""
    jtfm._ACTIVE_MESH[0] = None
    yield
    jtfm._ACTIVE_MESH[0] = None


def _check_routes(rec, what):
    assert len(rec["jax"]) == len(rec["port"]) > 0
    for i, ((jd, logits), pd) in enumerate(zip(rec["jax"], rec["port"])):
        _assert_same_routing(pd, jd, logits, f"{what}: MoE call {i}")


MODEL_CASES = {
    "grouped": {},
    "loop": {"num_layers": 3},  # 3 % 2: JAX's Python-loop fallback
    "top2_neox": {"moe_top_k": 2, "pos_emb": "rotary", "rotary_pct": 0.5, "parallel_residual": True,
                  "moe_every": 1},  # MoE layers stay sequential pre-LN
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_apply_logits_and_aux_match_jax(name):
    jcfg, tcfg = _configs(**MODEL_CASES[name])
    jp, tp = _params(jcfg)
    toks = _tokens(2, 24)
    with _recording() as rec:
        jl, ja = jtfm.apply(jcfg, jp, jnp.asarray(toks), with_aux=True)
        tl, ta = ttfm.apply(tcfg, tp, torch.from_numpy(toks).long(), with_aux=True)
    _check_routes(rec, name)
    assert len(rec["port"]) == tcfg.num_layers // tcfg.moe_every
    _close(tl, jl, atol=1e-5)
    _close(ta, ja)


def test_loss_and_gradients_match_jax():
    """causal_lm_loss (the aux term included) and every gradient, the
    routing of the forward compared first."""
    jcfg, tcfg = _configs(moe_aux_coeff=0.5)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(2, 33, seed=2)
    with _recording() as rec:
        jtfm.apply(jcfg, jp, jnp.asarray(toks[:, :-1]))
        ttfm.apply(tcfg, tp, torch.from_numpy(toks[:, :-1]).long())
    _check_routes(rec, "loss")
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtfm.causal_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)})))(jp)
    leaves = topt.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl = ttfm.causal_lm_loss(tcfg, leaves, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    _close(tl, jl)
    tflat = saver._flatten_with_paths(topt.tree_map(lambda t: t.grad, leaves))
    jflat = _jflat(jg)
    assert set(tflat) == set(jflat)
    for k, g in tflat.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], rtol=GRAD_RTOL, atol=1e-6, err_msg=k)
    assert np.abs(jflat["moe::gate"]).max() > 0 and np.abs(jflat["moe::experts::wo"]).max() > 0


def test_sparse_attention_moe_loss_matches_jax():
    """attn_impl='sparse': the MoE layers call the model's attention
    dispatch, the block-sparse one here (its plain version on the CPU)."""
    sparsity = {"mode": "fixed", "block": 16, "num_local_blocks": 2}
    jcfg, tcfg = _configs(attn_impl="sparse", sparsity=sparsity)
    jp, tp = _params(jcfg, seed=3)
    toks = _tokens(2, 65, seed=4)
    jl = jtfm.causal_lm_loss(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _close(ttfm.causal_lm_loss(tcfg, tp, {"tokens": torch.from_numpy(toks)}), jl)


def test_decode_matches_full_forward_at_ample_capacity():
    """Prefill (the capacity path) then a decode step (the dense route)
    against the full forward: equal without drops (capacity factor 8)."""
    _, tcfg = _configs(moe_capacity_factor=8.0)
    _, tp = _params(_configs()[0], seed=5)
    prompt = torch.from_numpy(_tokens(2, 9, seed=6)).long()
    full = ttfm.apply(tcfg, tp, prompt)[:, -1]
    cache = ttfm.init_cache(tcfg, 2, 32)
    logits, cache = ttfm.apply_with_cache(tcfg, tp, prompt, cache, 0, last_only=True)
    _close(logits[:, -1], full, rtol=1e-4, atol=1e-4)
    nxt = logits[:, -1].argmax(-1)[:, None]
    dec, _ = ttfm.apply_with_cache(tcfg, tp, nxt, cache, torch.tensor(9))
    _close(dec[:, -1], ttfm.apply(tcfg, tp, torch.cat([prompt, nxt], 1))[:, -1], rtol=1e-4, atol=1e-4)


def test_generate_matches_jax():
    """Greedy tokens through the prefill's capacity path and the decode
    steps' dense route, top-2."""
    kw = {**TINY, **MOE, "moe_top_k": 2}
    jeng = JaxInferenceEngine(model=jtfm.Model(jtfm.TransformerConfig(**kw, dtype=jnp.float32, loss_chunk_size=0)),
                              config={"dtype": "fp32"})
    teng = deepspeed_tpu_torch.init_inference(
        ttfm.Model(ttfm.TransformerConfig(**kw)), config={"dtype": "fp32"},
        params=interop.params_from_jax(jax.tree.map(np.asarray, jeng.params)), device="cpu")
    prompt = _tokens(2, 9, seed=8)
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=6), jeng.generate(prompt, max_new_tokens=6))


def _jflat(tree) -> dict:
    return {"::".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_params_from_jax_carries_every_moe_leaf():
    jcfg, tcfg = _configs()
    npp = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.PRNGKey(0)))
    carried = saver._flatten_with_paths(interop.params_from_jax(npp))
    own = saver._flatten_with_paths(ttfm.init(tcfg, torch.Generator().manual_seed(0)))
    jflat = _jflat(npp)
    moe = {k for k in jflat if k.startswith("moe::")}
    assert moe == {"moe::gate", "moe::experts::wi", "moe::experts::wo"}
    assert set(carried) == set(own) == set(jflat)
    for k, v in jflat.items():
        assert tuple(carried[k].shape) == tuple(own[k].shape) == v.shape, k
        np.testing.assert_array_equal(carried[k].numpy(), v, err_msg=k)
    assert ttfm.logical_axes(tcfg)["moe"] == jtfm.logical_axes(jcfg)["moe"]
    from deepspeed_tpu.moe.experts import init_experts as jinit
    from deepspeed_tpu_torch.moe import init_experts as tinit

    jbank, tbank = jinit(jax.random.PRNGKey(1), 4, 64, 256), tinit(torch.Generator().manual_seed(1), 4, 64, 256)
    for k in ("wi", "wo"):  # JAX's shapes and scales (1/sqrt(fan-in)), other draws
        assert tuple(tbank[k].shape) == jbank[k].shape
        np.testing.assert_allclose(float(tbank[k].std()), float(jnp.std(jbank[k])), rtol=0.05)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("mesh", [{}, {"data": 8}, {"data": 2, "fsdp": 4}], ids=["one", "data8", "data2_fsdp4"])
def test_moe_leaf_specs_match_jax(stage, mesh):
    """Each MoE leaf's spec under ZeRO's rules is JAX's (``expert`` on
    ``("data", "fsdp")``), and one the port's layouts accept: at most one
    ZeRO dimension."""
    from deepspeed_tpu.parallel import sharding as jshd
    from deepspeed_tpu_torch.parallel import sharding as tshd
    from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import ZERO_FALLBACK

    shape_of = SimpleNamespace(shape={"pipe": 1, "data": 1, "fsdp": 1, "context": 1, "model": 1, **mesh})
    _, tcfg = _configs()
    axes = ttfm.logical_axes(tcfg)["moe"]
    shapes = ttfm.init(tcfg, torch.Generator().manual_seed(0))["moe"]
    tp_rules, to_rules = tshd.zero_stage_rules(stage)
    jp_rules, jo_rules = jshd.zero_stage_rules(stage)
    for path, shape in saver._flatten_with_paths(shapes).items():
        ax = axes["gate"] if path == "gate" else axes["experts"][path.split("::")[-1]]
        for tr, jr, fb in ((tp_rules, jp_rules, ZERO_FALLBACK if stage == 3 else None),
                           (to_rules, jo_rules, ZERO_FALLBACK)):
            spec = tshd.spec_from_logical(ax, tuple(shape.shape), tr, shape_of, zero_fallback=fb)
            assert spec == tuple(jshd.spec_from_logical(ax, tuple(shape.shape), jr, shape_of, zero_fallback=fb)), path
            tshd.split_dims(spec)


# ---------------------------------------------------------------------------
# The training engine: three steps, remat, checkpoints both ways
# ---------------------------------------------------------------------------

DS = base_config(train_batch_size=8, train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=2,
                 zero_optimization={"stage": 1},
                 optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}})
STEPS = 3


def _batch(step):
    return {"tokens": _tokens(8, 33, seed=100 + step)}


def _port_engine(params, ds=DS, **kw):
    return deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**{**TINY, **MOE, **kw})),
                                          config=ds, model_parameters=params, device="cpu")[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX engine (micro 4 x gas 2 on one device) and the port's from
    its weights: STEPS steps, each engine's checkpoint, a next step, then
    each engine resumed from the other's checkpoint and stepped again."""
    tmp = tmp_path_factory.mktemp("moe")
    jeng = deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(**TINY, **MOE, dtype=jnp.float32)),
                                    config=DS, mesh=single_device_mesh())[0]
    init = interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"]))
    teng = _port_engine(topt.tree_map(torch.clone, init))
    out = {"jax": [], "port": [], "init": init}
    for step in range(STEPS):
        out["jax"].append(float(jax.device_get(jeng.train_batch(_batch(step))["loss"])))
        out["port"].append(float(teng.train_batch(_batch(step))["loss"]))
    out["jax_params"] = _jflat(jeng.state["params"])
    out["port_params"] = {k: v.numpy() for k, v in saver._flatten_with_paths(teng.state["params"]).items()}
    jeng.save_checkpoint(str(tmp / "jax"))
    teng.save_checkpoint(str(tmp / "port"))
    out["jax_next"] = float(jax.device_get(jeng.train_batch(_batch(STEPS))["loss"]))
    out["port_next"] = float(teng.train_batch(_batch(STEPS))["loss"])
    jeng.load_checkpoint(str(tmp / "port"))
    teng.load_checkpoint(str(tmp / "jax"))
    out["jax_from_port"] = float(jax.device_get(jeng.train_batch(_batch(STEPS))["loss"]))
    out["port_from_jax"] = float(teng.train_batch(_batch(STEPS))["loss"])
    out["steps"] = (jeng.get_global_step(), teng.get_global_step())
    return out


def test_train_batch_tracks_the_jax_engine(runs):
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=LOSS_RTOL)
    _assert_params(runs["port_params"], runs["jax_params"])
    assert runs["port"][-1] < runs["port"][0]


def test_checkpoints_resume_across_the_packages(runs):
    """A port save resumed by JAX to the port's next loss, and a JAX save
    resumed by the port to JAX's."""
    assert runs["steps"] == (STEPS + 1, STEPS + 1)
    np.testing.assert_allclose(runs["jax_from_port"], runs["port_next"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs["port_from_jax"], runs["jax_next"], rtol=LOSS_RTOL)


def test_remat_and_reruns_take_the_same_steps_bitwise(runs):
    """save_flash remat over the MoE groups gives the no-remat losses, and
    the same steps from the same state repeat bitwise."""
    ds = dict(DS, activation_checkpointing={"enabled": True, "policy": "save_flash"})
    remat = _port_engine(topt.tree_map(torch.clone, runs["init"]), ds)
    assert remat.model.config.remat
    assert [float(remat.train_batch(_batch(s))["loss"]) for s in range(STEPS)] == runs["port"]


# ---------------------------------------------------------------------------
# What this slice does not run: refused by name
# ---------------------------------------------------------------------------

def _moe_model(**kw):
    return ttfm.Model(ttfm.TransformerConfig(**{**TINY, **MOE, **kw}))


def _train(ds_extra, model_kw=None):
    ds = dict(DS, **ds_extra)
    deepspeed_tpu_torch.initialize(model=_moe_model(**(model_kw or {})), config=ds, device="cpu")


class _StubPipelined:
    """A pipelined model's attributes over an MoE config (PipelinedTransformer
    itself refuses MoE first)."""
    num_micro_batches, num_stages, layers_per_stage = 2, 2, 2
    config = ttfm.TransformerConfig(**TINY, **MOE)


def _dispatch_in_world2(monkeypatch):
    from deepspeed_tpu_torch import comm

    monkeypatch.setattr(comm, "is_initialized", lambda: True)
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    tsm.moe_dispatch_combine(torch.zeros(8, 4), torch.zeros(4, 2), lambda e: e)


def _engine_on(axis):
    """The engine's own check on a mesh whose ``axis`` is 2 (a world of 2,
    which one process cannot open)."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    mesh = SimpleNamespace(shape={"pipe": 1, "data": 1, "fsdp": 1, "context": 1, "model": 1, axis: 2})
    return lambda _: DeepSpeedEngine._refuse_moe(SimpleNamespace(mesh=mesh), _moe_model(),
                                                 DeepSpeedConfig.from_dict(DS))


def _apply_with_cache_uneven(_):
    cfg = ttfm.TransformerConfig(**{**TINY, **MOE, "num_layers": 5})
    params = ttfm.init(cfg, torch.Generator().manual_seed(0))
    ttfm.apply_with_cache(cfg, params, torch.zeros(1, 3, dtype=torch.long), ttfm.init_cache(cfg, 1, 8), 0)


def _serving(_):
    eng = deepspeed_tpu_torch.init_inference(_moe_model(), config={"dtype": "fp32"}, device="cpu")
    ServingEngine(eng, config={"n_slots": 2})


REFUSED = {
    "data_parallel_world": (_engine_on("data"), "expert parallelism"),
    "fsdp_world": (_engine_on("fsdp"), "expert parallelism"),
    "dispatch_in_a_world_of_2": (_dispatch_in_world2, "expert parallelism"),
    "mesh_model": (_engine_on("model"), "tensor parallelism"),
    "zero3": (lambda _: _train({"zero_optimization": {"stage": 3}}), "ZeRO stage 3"),
    "offload_optimizer": (lambda _: _train({"zero_optimization": {"stage": 1,
                                                                  "offload_optimizer": {"device": "cpu"}}}),
                          "offload_optimizer"),
    "offload_param": (lambda _: _train({"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"},
                                                              "offload_param": {"device": "cpu"}}}),
                      "memory tiers"),
    "cpu_checkpointing": (lambda _: _train({"activation_checkpointing": {"enabled": True,
                                                                         "cpu_checkpointing": True}}),
                          "cpu_checkpointing"),
    "tp_size": (lambda _: deepspeed_tpu_torch.init_inference(_moe_model(), config={"tensor_parallel": {"tp_size": 2}},
                                                             device="cpu"), "tp_size=2"),
    "serving_engine": (_serving, "ServingEngine with an MoE model"),
    "pipelined_transformer": (lambda _: PipelinedTransformer(ttfm.TransformerConfig(**TINY, **MOE), 2),
                              "PipelinedTransformer with MoE"),
    "pipe_1f1b": (lambda _: PipelineEngine(_StubPipelined(), dict(DS, pipeline={"schedule": "1f1b"}), device="cpu"),
                  "1F1B"),
    "apply_with_cache_uneven_depth": (_apply_with_cache_uneven, "num_layers divisible by moe_every"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_moe_paths_are_refused_by_name(monkeypatch, name):
    """Every MoE path outside this slice raises NotImplementedError naming
    itself; nothing takes an MoE model silently."""
    call, words = REFUSED[name]
    with pytest.raises(NotImplementedError, match=words):
        call(monkeypatch)
