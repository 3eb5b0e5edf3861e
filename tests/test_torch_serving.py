"""Port parity: the continuous-batching serving engine.

The JAX ``ServingEngine`` (decode through the Pallas kernel in interpret
mode) and the port's on the CPU, over the same weights (carried by
``interop.params_from_jax``), driven with ``step(now=...)`` on a fixed clock
so that nothing depends on wall time. Greedy requests must give the same
tokens, statuses, prefix hits, requeues and order of terminal uids in both,
across the feature matrix (prefix cache, chunked prefill, n-gram
speculation), two DWRR tenants, deadlines, queue shedding and an injected
NaN quarantine; the port's decode counts as one program throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.resilience import RequestRejected as JaxRejected
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import RequestRejected

TINY = dict(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32,
            pos_emb="rotary", decode_attn="kernel")
# the JAX package's ledger (not ported) is off on both sides
BASE = {"n_slots": 3, "ledger": {"enabled": False}}


@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=JaxModel(JaxConfig(**TINY, dtype=jnp.float32, loss_chunk_size=0)),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    teng = init_inference(Model(TransformerConfig(**TINY)), config={"dtype": "fp32"},
                          params=params, device="cpu")
    return jeng, teng


def _requests(n=7, seed=0):
    """A shared 16-token system prompt with repetitive tails (so the n-gram
    drafter finds matches), staggered arrivals, varied lengths."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 97, size=16)
    out = []
    for i in range(n):
        motif = rng.integers(0, 97, size=int(rng.integers(2, 5)))
        tail = np.tile(motif, int(rng.integers(2, 6)))
        out.append(dict(uid=i, prompt=np.concatenate([system, tail]).astype(np.int32),
                        max_new_tokens=int(3 + (5 * i) % 9), arrival_time=0.25 * (i // 2)))
    return out


def _drive(srv, reqs, rejected_cls, clock=np.arange(0.0, 4.0, 0.25), tail_now=100.0, max_steps=400):
    """Submit everything, step on the fixed clock, then until idle; return
    (terminal uids in order, {uid: rejection reason})."""
    rejected = {}
    for r in reqs:
        try:
            srv.submit(r)
        except rejected_cls as e:
            rejected[r.uid] = e.reason
    order = []
    for t in clock:
        order += srv.step(now=float(t))
    for _ in range(max_steps):
        if srv.idle:
            break
        order += srv.step(now=tail_now)
    assert srv.idle
    return order, rejected


def _both(engines, config, specs, **kw):
    jeng, teng = engines
    jsrv = JaxServingEngine(jeng, config=dict(config))
    tsrv = ServingEngine(teng, config=dict(config))
    jout = _drive(jsrv, [JaxRequest(**s) for s in specs], JaxRejected, **kw)
    tout = _drive(tsrv, [Request(**s) for s in specs], RequestRejected, **kw)
    return jsrv, tsrv, jout, tout


def _assert_same(jsrv, tsrv, jout, tout):
    assert tout == jout  # terminal uid order and rejections
    assert set(tsrv._results) == set(jsrv._results)
    for uid, jr in jsrv._results.items():
        tr = tsrv._results[uid]
        np.testing.assert_array_equal(tr.tokens, jr.tokens, err_msg=f"uid {uid}")
        assert (tr.status, tr.prefix_hit_tokens, tr.requeues, tr.prompt_len, tr.slot) == \
            (jr.status, jr.prefix_hit_tokens, jr.requeues, jr.prompt_len, jr.slot), uid
    assert tsrv.compile_counts()["decode"] == 1


FEATURES = {
    "plain": {},
    "prefix_cache": {"prefix_cache": {"enabled": True, "n_slots": 4, "block": 8}},
    "chunked_prefill": {"chunked_prefill": {"enabled": True, "chunk_size": 8}},
    "speculation": {"speculation": {"enabled": True, "depth": 4}},
    "all": {"prefix_cache": {"enabled": True, "n_slots": 4, "block": 8},
            "chunked_prefill": {"enabled": True, "chunk_size": 8, "chunks_per_step": 2},
            "speculation": {"enabled": True, "depth": 4}},
}


@pytest.mark.parametrize("features", list(FEATURES))
def test_feature_matrix_matches_jax(engines, features):
    """Staggered arrivals, slot reuse (7 requests, 3 slots), EOS and
    max-tokens, under each feature alone and all together."""
    jeng, _ = engines
    specs = _requests()
    # uid 2 stops at EOS: a token of its own greedy stream, first seen there
    ref = jeng.generate(specs[2]["prompt"][None], max_new_tokens=specs[2]["max_new_tokens"])[0]
    stop = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    specs[2]["eos_token"] = int(ref[stop])
    jsrv, tsrv, jout, tout = _both(engines, {**BASE, **FEATURES[features]}, specs)
    _assert_same(jsrv, tsrv, jout, tout)
    assert len(tsrv._results[2].tokens) == stop + 1
    assert {r.slot for r in tsrv._results.values()} == {0, 1, 2}
    if "prefix_cache" in FEATURES[features]:
        assert sum(r.prefix_hit_tokens > 0 for r in tsrv._results.values()) >= 2
        assert tsrv.prefix_cache_stats()["hits"] == jsrv.prefix_cache_stats()["hits"]
    if "speculation" in FEATURES[features]:
        ts, js = tsrv.spec_stats(), jsrv.spec_stats()
        assert ts["drafted"] > 0 and (ts["drafted"], ts["accepted"], ts["verify_steps"]) == \
            (js["drafted"], js["accepted"], js["verify_steps"])
    if "chunked_prefill" in FEATURES[features]:
        assert tsrv.compile_counts()["chunk_prefill"].keys() == jsrv.compile_counts()["chunk_prefill"].keys()


def test_budget_rejection_matches_jax(engines):
    jeng, teng = engines
    for srv, req in ((JaxServingEngine(jeng, config=BASE), JaxRequest),
                     (ServingEngine(teng, config=BASE), Request)):
        with pytest.raises(ValueError, match="slot budget"):
            srv.submit(req(uid=0, prompt=np.zeros(100, np.int32), max_new_tokens=29))
        with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
            srv.submit(req(uid=1, prompt=np.zeros(4, np.int32), max_new_tokens=0))


def test_tenants_deadlines_and_shedding_match_jax(engines):
    """Two DWRR tenants (weights 2:1) and anonymous requests on one slot: an
    in-flight request evicted at its deadline, a queued one that expires,
    a submit refused by a tenant's quota and future arrivals shed past
    max_queue_len when the clock reaches them."""
    rng = np.random.default_rng(5)

    def spec(uid, size, **kw):
        return dict(uid=uid, prompt=rng.integers(0, 97, size=size).astype(np.int32),
                    **{"max_new_tokens": 4, **kw})

    specs = [spec(i, 6 + i, tenant="a" if i % 2 else "b") for i in range(6)]
    specs.append(spec(6, 5, max_new_tokens=30, deadline_s=0.6))  # admitted first, then evicted
    specs.append(spec(7, 5, tenant="a"))  # a's fourth queued request: over its quota
    specs.append(spec(8, 5, deadline_s=0.3))  # expires in the queue
    specs += [spec(i, 7, max_new_tokens=3, arrival_time=50.0) for i in range(9, 15)]
    config = {**BASE, "n_slots": 1, "max_queue_len": 8,
              "tenants": {"a": {"weight": 2.0, "max_queued": 3}, "b": {"weight": 1.0}}}
    jsrv, tsrv, jout, tout = _both(engines, config, specs, clock=list(np.arange(0.0, 1.0, 0.1)) + [60.0],
                                   tail_now=61.0)
    _assert_same(jsrv, tsrv, jout, tout)
    assert tout[1] == {7: "tenant_quota"}
    statuses = {u: r.status for u, r in tsrv._results.items()}
    assert statuses[6] == "deadline_exceeded" and statuses[8] == "expired"
    assert "shed_queue_full" in statuses.values(), statuses
    jc = jsrv.telemetry_snapshot()["metrics"]["counters"]
    tc = tsrv.telemetry_snapshot()["metrics"]["counters"]
    for name in ("tenant/a/requests", "tenant/b/requests", "tenant/a/rejected", "resilience/load_shed",
                 "resilience/deadline_shed", "resilience/deadline_evictions"):
        assert tc[name] == jc[name], name


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_nan_quarantine_matches_jax(engines, phase):
    """An injected NaN (the slot's KV poisoned, so the sentinel computed on
    the device must fire) requeues the request once; its replay finishes
    with the tokens of a clean run."""
    specs = _requests(n=4, seed=3)
    fi = {"enabled": True, "garbage_logits_uids": [1], "garbage_logits_phase": phase,
          "garbage_logits_decode_step": 1}
    jsrv, tsrv, jout, tout = _both(engines, {**BASE, "fault_injection": fi}, specs)
    _assert_same(jsrv, tsrv, jout, tout)
    assert tsrv._results[1].requeues == 1 and tsrv._results[1].status == "ok"
    counters = tsrv.telemetry_snapshot()["metrics"]["counters"]
    assert counters["resilience/quarantines"] == 1 and counters["resilience/injected_faults"] == 1


def test_cancel_withdraw_requeue_and_partial_tokens(engines):
    _, teng = engines
    srv = ServingEngine(teng, config={**BASE, "n_slots": 1})
    specs = _requests(n=4, seed=4)
    for s in specs:
        srv.submit(Request(**{**s, "arrival_time": 0.0}))
    srv.step(now=0.0)
    active = next(st.uid for st in srv._slots if st.uid >= 0)
    assert len(srv.partial_tokens(active)) >= 1 and len(srv.partial_tokens(3)) == 0
    assert srv.partial_tokens(99) is None
    moved = srv.withdraw(3)
    assert moved.uid == 3 and srv.withdraw(3) is None
    assert srv.cancel(2) and srv.result(2).status == "cancelled"
    assert srv.cancel(active) and srv.result(active).status == "cancelled"
    srv.requeue(moved)
    srv.drain()
    assert srv.result(3).ok and srv.idle and srv.n_free == 1


@pytest.mark.parametrize("sampled", [False, True])
def test_warm_verify_compiles_each_depth_once_like_jax(engines, sampled):
    """``warm_verify`` dispatches each power-of-two verify depth once with
    every slot idle: the same depths and verify programs as JAX's, no
    verify step recorded, and nothing observable changed, so the greedy
    traffic after it compiles no verify program and gives JAX's tokens
    (and those of an engine that was not warmed)."""
    jeng, teng = engines
    config = {**BASE, **FEATURES["speculation"], "watchdog_mode": "raise"}
    jsrv, tsrv = JaxServingEngine(jeng, config=dict(config)), ServingEngine(teng, config=dict(config))
    assert tsrv.warm_verify(sampled=sampled) == jsrv.warm_verify(sampled=sampled) == [1, 2, 4]
    warmed = tsrv.compile_counts()["verify"]
    assert warmed == jsrv.compile_counts()["verify"] == {d: 1 + sampled for d in (1, 2, 4)}
    assert tsrv.spec_stats()["verify_steps"] == jsrv.spec_stats()["verify_steps"] == 0
    assert tsrv.telemetry.registry.snapshot()["counters"].get("serving/verify_steps", 0) == 0
    assert ServingEngine(teng, config={**BASE}).warm_verify() == []
    if sampled:
        return
    specs = _requests()
    jout = _drive(jsrv, [JaxRequest(**s) for s in specs], JaxRejected)
    tout = _drive(tsrv, [Request(**s) for s in specs], RequestRejected)
    _assert_same(jsrv, tsrv, jout, tout)
    assert tsrv.compile_counts()["verify"] == warmed and tsrv.spec_stats()["verify_steps"] > 0
    cold = ServingEngine(teng, config=dict(config))
    _drive(cold, [Request(**s) for s in specs], RequestRejected)
    for uid, r in cold._results.items():
        np.testing.assert_array_equal(tsrv._results[uid].tokens, r.tokens, err_msg=f"uid {uid}")


def test_sampled_mix_keeps_one_decode_program(engines):
    """Distinct prompt lengths, sampling parameters and arrival times: ONE
    decode program, and seeded engines sample the same tokens."""
    _, teng = engines
    rng = np.random.default_rng(4)
    specs = [dict(uid=i, prompt=rng.integers(0, 97, size=4 + 3 * i).astype(np.int32), max_new_tokens=3 + i,
                  temperature=float(i % 3) * 0.7, top_k=int(i % 4) * 5, top_p=1.0 - 0.05 * (i % 2),
                  arrival_time=0.01 * i) for i in range(8)]
    runs = []
    for _ in range(2):
        srv = ServingEngine(teng, config={**BASE, "n_slots": 4, "seed": 11, "watchdog_mode": "raise",
                                          "speculation": {"enabled": True, "depth": 2}})
        _drive(srv, [Request(**s) for s in specs], RequestRejected)
        runs.append({u: r.tokens for u, r in srv._results.items()})
        counts = srv.compile_counts()
        assert counts["decode"] == 1 and all(v == 1 for v in counts["prefill"].values()), counts
    for uid in runs[0]:
        np.testing.assert_array_equal(runs[0][uid], runs[1][uid])
        assert ((runs[0][uid] >= 0) & (runs[0][uid] < 97)).all()


def _logits(seed=0, B=6, V=50):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


def test_filter_logits_vector_matches_jax():
    x = _logits()
    t = np.array([0.0, 0.5, 1.0, 1.3, 0.8, 2.0], np.float32)
    k = np.array([0, 1, 5, 49, 50, 7], np.int32)
    p = np.array([1.0, 0.9, 0.3, 0.0, 0.95, 1.0], np.float32)
    ref = np.asarray(jsampling._filter_logits_vector(jnp.asarray(x), jnp.asarray(t), jnp.asarray(k),
                                                     jnp.asarray(p)))
    out = tsampling._filter_logits_vector(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(k),
                                          torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # greedy rows of the sampler are the argmax, exactly
    tok = tsampling.sample_logits_vector(torch.from_numpy(x), torch.Generator().manual_seed(0),
                                         torch.zeros(6), torch.from_numpy(k), torch.from_numpy(p))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jnp.argmax(jnp.asarray(x), -1)))


def test_verify_logits_vector_greedy_rows_match_jax():
    """Greedy rows: the same accept verdicts, and resample/clean the argmax,
    in both packages; sampled rows give tokens in range and accept only
    tokens the filter keeps."""
    B, D, V = 4, 3, 40
    logits = np.random.default_rng(7).standard_normal((B, D + 1, V)).astype(np.float32) * 2
    greedy = logits.argmax(-1)
    draft = greedy[:, :D].copy()
    draft[1, 1] = (draft[1, 1] + 1) % V  # a rejection mid-draft
    draft[3, 0] = (draft[3, 0] + 5) % V
    t = np.array([0.0, 0.0, 0.9, 0.0], np.float32)
    k = np.array([0, 3, 5, 0], np.int32)
    p = np.array([1.0, 0.9, 0.8, 1.0], np.float32)
    ja, jr, jc = (np.asarray(a) for a in jsampling.verify_logits_vector(
        jnp.asarray(logits), jnp.asarray(draft), jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(k),
        jnp.asarray(p)))
    ta, tr, tc = (a.numpy() for a in tsampling.verify_logits_vector(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.Generator().manual_seed(0),
        torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p)))
    g = t <= 0
    np.testing.assert_array_equal(ta[g], ja[g])
    np.testing.assert_array_equal(tr[g], jr[g])
    np.testing.assert_array_equal(tc[g], jc[g])
    assert ta.shape == (B, D) and tr.shape == tc.shape == (B, D + 1)
    assert ((tc[2] >= 0) & (tc[2] < V)).all()
    kept = np.sort(logits[2] / 0.9, axis=-1)[:, ::-1][:, 4:5] <= logits[2] / 0.9  # top-5 at each position
    assert kept[np.arange(D + 1), tc[2]].all()
