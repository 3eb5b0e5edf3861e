"""A synchronous save under ``resilience`` at a gloo world of 2
(``tests/torch_dp_worker.py ckpt_retry``, started once for the module):
every meeting point of a multi-rank save agrees each rank's outcome over
the world (``checkpoint/saver.py`` ``_agree``), so a write that fails on
rank 1 alone fails the attempt on both ranks and both retry it, as the JAX
engine retries at every world with the process index folded into its
backoff seed (``deepspeed_tpu/runtime/engine.py:2171-2197``). A transient
fault on rank 1's first write: one retry a rank, one commit, files equal
to an unfaulted save's byte for byte, loaded at a world of 1. A permanent
one: both ranks raise at once, no retry, no hang."""

import filecmp
import os

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.models import transformer as tfm
from simple_model import base_config, random_tokens
from test_torch_comm import run_world, shared_once

MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32)
RETRY = {"max_attempts": 3, "base_delay_s": 0.01, "max_delay_s": 0.05}
CASES = [{"name": "clean"}, {"name": "flaky", "fault": {"io_flaky_writes": [1]}},
         {"name": "permanent", "fault": {"io_error_writes": [1]}}]
WORLD_TIMEOUT_S = 120  # a hang at a meeting point fails the module instead of stalling it


def _ds(world=2):
    return base_config(train_batch_size=8, train_micro_batch_size_per_gpu=4 // world, gradient_accumulation_steps=2,
                       zero_optimization={"stage": 1})


def _runs(tmp):
    tokens = random_tokens(8)["tokens"]
    cfg = tfm.TransformerConfig(**MODEL, dtype=torch.float32)
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in saver._flatten_with_paths(params).items()})
    np.savez(tmp / "tokens.npz", tokens=tokens)
    spec = {"params": str(tmp / "params.npz"), "tokens": str(tmp / "tokens.npz"), "model": MODEL, "ds": _ds(),
            "retry": RETRY, "cases": CASES, "dir": str(tmp / "ckpt"), "timeout_s": 60.0}
    _, meta = run_world("ckpt_retry", spec, 2, tmp, timeout=WORLD_TIMEOUT_S)
    # the flaky save at a world of 1: its next loss is the clean save's
    losses = {}
    for name in ("clean", "flaky"):
        eng = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=_ds(world=1), device="cpu")[0]
        eng.load_checkpoint(str(tmp / "ckpt" / name), tag="t")
        losses[name] = float(eng.train_batch({"tokens": tokens})["loss"])
    return {"meta": meta, "dir": str(tmp / "ckpt"), "losses": losses}


def _get(tmp_path_factory):
    return shared_once(tmp_path_factory, "ckpt_agreement", _runs)


def test_transient_fault_on_one_rank_is_retried_on_both(tmp_path_factory):
    runs = _get(tmp_path_factory)
    for r in range(2):
        m = runs["meta"][r]
        assert m["clean"]["error"] is None and m["clean"]["retries"] == 0
        assert m["flaky"]["error"] is None and m["flaky"]["retries"] == 1, m["flaky"]
    clean, flaky = (os.path.join(runs["dir"], n, "t") for n in ("clean", "flaky"))
    names = sorted(os.listdir(clean))
    assert names == sorted(os.listdir(flaky)) and "manifest.json" in names
    assert not os.path.exists(flaky + saver._STAGE_SUFFIX)  # committed once, no staging left behind
    _, mismatch, errors = filecmp.cmpfiles(clean, flaky, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    manifest = saver.read_manifest(flaky)
    assert any("shards" in e for e in manifest["leaves"].values())  # each rank wrote its shards
    assert runs["losses"]["flaky"] == runs["losses"]["clean"]


def test_permanent_fault_on_one_rank_raises_on_both(tmp_path_factory):
    runs = _get(tmp_path_factory)
    m0, m1 = (runs["meta"][r]["permanent"] for r in range(2))
    assert m1["error"] == "PermanentIOError" and m0["error"] == "CheckpointPeerPermanentError", (m0, m1)
    assert m0["ranks"] == [1]
    assert m0["retries"] == m1["retries"] == 0
    assert max(m0["seconds"], m1["seconds"]) < 30
    assert not os.path.exists(os.path.join(runs["dir"], "permanent", "t", "manifest.json"))
