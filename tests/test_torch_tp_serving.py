"""Port parity: the ``ServingEngine`` under tensor parallelism.

The JAX ``ServingEngine`` over a ``tensor_parallel.tp_size: 2`` engine
(one scheduler driving the 8-device CPU mesh, decode through the Pallas
kernel in interpret mode) against the port's over a gloo world of 2
processes (``tests/torch_dp_worker.py tp_serving``, started once per
session): the driver (rank 0) runs the scheduler and broadcasts each
device call, the follower runs them. fp32, greedy, every request arrived
at 0.0 so that no clock decides, with the prefix cache, chunked prefill
and n-gram speculation on. The streams, statuses, prefix hits, requeues
and slots must equal JAX's, and the follower's ``serve`` must return the
driver's results. Then the closing message: a driver that raises inside
``serve`` makes its follower raise, and a follower whose driver has gone
raises instead of waiting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from test_torch_comm import run_world, shared_once
from test_torch_tensor_parallel import _flat

TP = 2
MODEL = dict(vocab_size=96, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32, pos_emb="rotary",
             decode_attn="kernel")
SERVING = {"n_slots": 3, "ledger": {"enabled": False},
           "prefix_cache": {"enabled": True, "n_slots": 4, "block": 8},
           "chunked_prefill": {"enabled": True, "chunk_size": 8, "chunks_per_step": 2},
           "speculation": {"enabled": True, "depth": 4}}


def _requests(n=7, seed=0):
    """A shared 16-token system prompt with repetitive tails (the n-gram
    drafter finds matches), all arrived at 0.0."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, MODEL["vocab_size"], size=16)
    out = []
    for i in range(n):
        motif = rng.integers(0, MODEL["vocab_size"], size=int(rng.integers(2, 5)))
        tail = np.tile(motif, int(rng.integers(2, 6)))
        out.append(dict(uid=i, prompt=np.concatenate([system, tail]).astype(np.int32).tolist(),
                        max_new_tokens=int(3 + (5 * i) % 9), arrival_time=0.0))
    return out


def _serving_world(tmp):
    jeng = JaxInferenceEngine(model=JaxModel(JaxConfig(**MODEL, dtype=jnp.float32, loss_chunk_size=0)),
                              config={"dtype": "fp32", "tensor_parallel": {"tp_size": TP}})
    np.savez(tmp / "params.npz", **_flat(jax.tree.map(np.asarray, jeng.params)))
    reqs = _requests()
    jsrv = JaxServingEngine(jeng, config=dict(SERVING))
    jres = jsrv.serve([JaxRequest(**{**r, "prompt": np.asarray(r["prompt"], np.int32)}) for r in reqs])
    jax_results = {u: {"tokens": np.asarray(r.tokens).tolist(), "status": r.status,
                       "prefix_hit_tokens": int(r.prefix_hit_tokens), "requeues": int(r.requeues),
                       "prompt_len": int(r.prompt_len), "slot": int(r.slot)} for u, r in jres.items()}
    spec = {"params": str(tmp / "params.npz"), "model": MODEL, "serving": SERVING, "requests": reqs,
            "timeout_s": 120.0}
    _, meta = run_world("tp_serving", spec, TP, tmp)
    left = (tmp / "out" / "rank1.left.txt").read_text()
    return jax_results, meta, left


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return shared_once(tmp_path_factory, "tp_serving_world2", _serving_world)


def test_tp_serving_streams_match_jax(served):
    jax_results, meta, _ = served
    driver = {int(u): r for u, r in meta[0]["results"].items()}
    assert set(driver) == set(jax_results)
    assert any(r["prefix_hit_tokens"] for r in driver.values())  # the prefix cache served a hit
    for uid, want in jax_results.items():
        assert driver[uid] == want, uid


def test_tp_serving_every_rank_returns_the_drivers_results(served):
    _, meta, _ = served
    assert meta[1]["results"] == meta[0]["results"]
    assert meta[0]["depths"] == meta[1]["depths"] == [1, 2, 4]


def test_tp_serving_caches_hold_each_ranks_heads(served):
    """The slot cache and the prefix pool by the KV specs (heads over
    ``model``); the decode step eager under tensor parallelism, one program."""
    _, meta, _ = served
    for r, m in enumerate(meta):
        assert m["spec"] == [None, None, None, "model", None]
        assert m["cache_heads"] == m["pool_heads"] == MODEL["num_heads"] // TP
        assert m["decode_route"] == "eager" and m["compiles"] == 1
        assert m["tensor_parallel"] == {"tp_size": TP, "model_index": r, "driver": r == 0,
                                        "heads": MODEL["num_heads"] // TP}


def test_tp_serving_driver_fault_and_lost_driver_raise(served):
    """A driver that raises inside ``serve`` still sends its closing message
    (from ``finally``): its follower raises, naming the driver. A follower
    left waiting by a driver that has gone raises too."""
    _, meta, left = served
    assert meta[0]["raised"] == "planted driver fault"
    assert "the driver raised" in meta[1]["raised"]
    assert "tensor-parallel follower (model index 1): no call from the driver" in left
