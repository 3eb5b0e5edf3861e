"""Tensor-parallel serving on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (tensor parallelism is held to the JAX package on the CPU in
``test_torch_tensor_parallel.py`` and ``test_torch_tp_serving.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp.py -q

Two ranks share the card under gloo (this process and a partner started
here with ``subprocess``), at ``tp_size`` 2: in fp32 their greedy
``generate`` tokens equal tp 1's, and each rank launches the split-KV
decode kernel on its own heads, 2 layers x (new - 1) times (split and
combine) a generate; the ``ServingEngine``'s driver and follower give tp
1's streams, with the decode step eager and 2 + 2 launches a step on each
rank.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops.decode_attention import decode_attention

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=256, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=128)
PROMPT = np.random.default_rng(0).integers(0, 256, size=(3, 40)).astype(np.int32)
NEW = 16
SERVE = {"n_slots": 4, "prefix_cache": {"enabled": True, "n_slots": 2, "max_prefix_len": 64},
         "chunked_prefill": {"enabled": True, "chunk_size": 16}}


def _requests():
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, size=32)
    return [Request(uid=i, prompt=np.concatenate([shared, rng.integers(0, 256, size=4 + i)]).astype(np.int32),
                    max_new_tokens=6 + i) for i in range(6)]


def _engine(device, tp):
    cfg = {"dtype": "fp32"} if tp == 1 else {"dtype": "fp32", "tensor_parallel": {"tp_size": tp}}
    return deepspeed_tpu_torch.init_inference(Model(TransformerConfig(**TINY)), config=cfg, device=device)


def _job(eng, job):
    """(generate tokens, their decode launches) or the served streams and
    the launches a decode step, for this rank."""
    if job == "generate":
        eng.generate(PROMPT, max_new_tokens=2)
        decode_attention.launches = decode_attention.combine_launches = 0
        out = eng.generate(PROMPT, max_new_tokens=NEW)
        return out.tolist(), [decode_attention.launches, decode_attention.combine_launches]
    srv = ServingEngine(eng, config=SERVE)
    res = srv.serve(_requests())
    w = srv.worker
    per_step = [n / w._decode_steps for n in w.decode_kernel_launches()]
    streams = {u: np.asarray(r.tokens).tolist() for u, r in sorted(res.items())}
    route = srv.telemetry_snapshot()["decode_route"]
    srv.close()
    return streams, per_step, route


_PARTNER = """
import sys
sys.path.insert(0, {tests!r})
from deepspeed_tpu_torch import comm
from test_torch_cuda_tp import _engine, _job
comm.init_distributed(init_method="file://" + sys.argv[1], world_size=2, rank=1, backend="gloo", timeout_s=120.0)
print("RESULT", repr(_job(_engine(sys.argv[3], 2), sys.argv[2])))
comm.destroy_distributed()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA decode kernel")
    return torch.device("cuda", 0)


def _tp2(device, tmp_path, job):
    store = str(tmp_path / "store")
    partner = subprocess.Popen([sys.executable, "-c", _PARTNER.format(tests=str(REPO / "tests")), store, job,
                                str(device)],
                               env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        comm.init_distributed(init_method=f"file://{store}", world_size=2, rank=0, backend="gloo", timeout_s=120.0)
        mine = _job(_engine(device, 2), job)
        out = partner.communicate(timeout=300)[0]
    finally:
        comm.destroy_distributed()
        if partner.poll() is None:
            partner.kill()
            partner.wait()
    assert partner.returncode == 0, out[-3000:]
    theirs = ast.literal_eval(next(line for line in out.splitlines() if line.startswith("RESULT"))[len("RESULT "):])
    return mine, theirs


def test_tp2_generate_on_the_card_equals_tp1(cuda_device, tmp_path):
    ref, ref_launches = _job(_engine(cuda_device, 1), "generate")
    expect = TINY["num_layers"] * (NEW - 1)
    assert ref_launches == [expect, expect]
    for tokens, launches in _tp2(cuda_device, tmp_path, "generate"):
        assert tokens == ref
        assert launches == [expect, expect]  # each rank, on its own 2 heads


def test_tp2_serving_on_the_card_equals_tp1(cuda_device, tmp_path):
    ref, ref_per_step, ref_route = _job(_engine(cuda_device, 1), "serve")
    L = TINY["num_layers"]
    assert ref_route == "graph" and ref_per_step == [L, L]
    for streams, per_step, route in _tp2(cuda_device, tmp_path, "serve"):
        assert streams == ref  # the follower's serve() returned the driver's streams
        assert route == "eager" and per_step == [L, L]
