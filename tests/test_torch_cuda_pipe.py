"""Pipeline parallelism on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (the pipeline is held to the JAX engine on the CPU in
``test_torch_pipe.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pipe.py -q

Two ranks share the card under gloo (this process, stage 0, and a partner
started here with ``subprocess``, stage 1) at mesh ``pipe`` 2, bf16 through
the flash kernels and the fused loss at a small width (head dim 64, the
Hopper kernels' shape), under GPipe and the executed 1F1B: each rank's
losses over 3 ``train_batch`` calls are within phase 29's limit
(``chip_smoke.PIPE_LOSS_GAP``) of a world-1 plain engine's on the same
weights and batches, each rank launches the flash forward, dK/dV and dQ 2
layers x 4 micro-batches a ``train_batch`` (the forward twice that under
1F1B, its backward's recompute), and only the last stage launches the fused
loss.
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
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, max_seq_len=256, num_layers=4, num_heads=4, hidden_size=256, dtype=torch.bfloat16,
             attn_impl="flash", loss_impl="fused_xent")
STAGES, MICRO, ROWS = 2, 4, 2  # batch 8 = 2 rows x 4 micro-batches
STEPS = 3
COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq, fx.fused_xent_forward)


def _ds(schedule=None):
    ds = {"train_batch_size": ROWS * MICRO, "train_micro_batch_size_per_gpu": ROWS,
          "gradient_accumulation_steps": MICRO, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 10**6}
    return ds if schedule is None else {**ds, "mesh": {"pipe": STAGES}, "pipeline": {"schedule": schedule}}


def _batch(step):
    rng = np.random.default_rng(200 + step)
    return {"tokens": rng.integers(0, SMALL["vocab_size"], size=(ROWS * MICRO, SMALL["max_seq_len"] + 1))
            .astype(np.int32)}


def _train(device, schedule=None):
    """(losses, [flash fwd, dK/dV, dQ, fused-loss forward] launches per
    train_batch) of 3 steps from the seeded weights: the plain engine, or
    this rank's stage of the pipelined one."""
    from deepspeed_tpu_torch.pipe import PipelineEngine, PipelinedTransformer

    cfg = TransformerConfig(**SMALL)
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    if schedule is None:
        eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config=_ds(), model_parameters=params,
                                             device=device)[0]
    else:
        params["layers"] = {k: v.reshape((STAGES, -1) + tuple(v.shape[1:])) for k, v in params["layers"].items()}
        eng = PipelineEngine(PipelinedTransformer(cfg, STAGES), _ds(schedule), params=params, device=device)
    losses, launches = [], []
    for step in range(STEPS):
        before = [c.launches for c in COUNTERS]
        losses.append(float(eng.train_batch(_batch(step))["loss"]))
        launches.append([c.launches - b for c, b in zip(COUNTERS, before)])
    return losses, launches


_PARTNER = """
import sys
sys.path.insert(0, {tests!r})
from deepspeed_tpu_torch import comm
from test_torch_cuda_pipe import _train
comm.init_distributed(init_method="file://" + sys.argv[1], world_size=2, rank=1, backend="gloo", timeout_s=300.0)
print("RESULT", repr(_train(sys.argv[2], sys.argv[3])))
comm.destroy_distributed()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA flash and fused-loss kernels")
    return torch.device("cuda", 0)


def _loss_limit():
    sys.path.insert(0, str(REPO))
    try:
        from chip_smoke import PIPE_LOSS_GAP
    finally:
        sys.path.remove(str(REPO))
    return PIPE_LOSS_GAP["gpt2"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipe2_train_batch_on_the_card_matches_world1(cuda_device, tmp_path, schedule):
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, ref_launches = _train(cuda_device)
    K = SMALL["num_layers"] // STAGES
    store = str(tmp_path / "store")
    partner = subprocess.Popen([sys.executable, "-c", _PARTNER.format(tests=str(REPO / "tests")), store,
                                str(cuda_device), schedule],
                               env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        comm.init_distributed(init_method=f"file://{store}", world_size=2, rank=0, backend="gloo", timeout_s=300.0)
        mine = _train(cuda_device, schedule)
        out = partner.communicate(timeout=600)[0]
    finally:
        comm.destroy_distributed()
        if partner.poll() is None:
            partner.kill()
            partner.wait()
    assert partner.returncode == 0, out[-3000:]
    theirs = ast.literal_eval(next(line for line in out.splitlines() if line.startswith("RESULT"))[len("RESULT "):])
    limit = _loss_limit()
    fwd = (2 if schedule == "1f1b" else 1) * K * MICRO
    loss_calls = MICRO if schedule == "1f1b" else 1
    assert ref_launches == [[SMALL["num_layers"] * MICRO] * 3 + [MICRO]] * STEPS
    for stage, (losses, launches) in enumerate((mine, theirs)):
        assert max(abs(a - b) / abs(b) for a, b in zip(losses, ref)) <= limit, (stage, losses, ref)
        assert launches == [[fwd, K * MICRO, K * MICRO, loss_calls if stage == STAGES - 1 else 0]] * STEPS
