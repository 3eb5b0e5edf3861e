"""Tensor-parallel training on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (tensor-parallel training is held to the JAX engine on the CPU in
``test_torch_tp_training.py`` and ``test_torch_tp_checkpoint.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp_train.py -q

Two ranks share the card under gloo (this process and a partner started
here with ``subprocess``) at mesh ``model`` 2, bf16 through the flash
kernels at a small width (head dim 64, the Hopper kernels' shape): each
rank's losses over 3 ``train_batch`` calls are within phase 28's limit
(``chip_smoke.TPT_LOSS_GAP``) of tp 1's on the same batches, and each rank
launches the flash forward, dK/dV and dQ kernels 2 layers x gas times a
``train_batch``, every forward on its own H/2 heads.
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

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=256, dtype=torch.bfloat16,
             attn_impl="flash", loss_chunk_size=64)
GAS = 2
STEPS = 3
COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)


def _ds(tp):
    ds = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "bf16": {"enabled": True},
          "gradient_clipping": 1.0, "steps_per_print": 10**6}
    return {**ds, "mesh": {"model": tp}} if tp > 1 else ds


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, SMALL["vocab_size"], size=(8, SMALL["max_seq_len"] + 1)).astype(np.int32)}


def _train(device, tp):
    """(losses, flash launches per train_batch, the heads each flash forward
    saw) of 3 steps from the seeded weights."""
    cfg = TransformerConfig(**SMALL)
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config=_ds(tp), model_parameters=params, device=device)[0]
    heads, plain = [], tfm.flash_attention

    def seen(q, *a, **kw):
        heads.append(int(q.shape[2]))
        return plain(q, *a, **kw)

    tfm.flash_attention = seen
    losses, launches = [], []
    try:
        for step in range(STEPS):
            before = [c.launches for c in COUNTERS]
            losses.append(float(eng.train_batch(_batch(step))["loss"]))
            launches.append([c.launches - b for c, b in zip(COUNTERS, before)])
    finally:
        tfm.flash_attention = plain
    return losses, launches, sorted(set(heads))


_PARTNER = """
import sys
sys.path.insert(0, {tests!r})
from deepspeed_tpu_torch import comm
from test_torch_cuda_tp_train import _train
comm.init_distributed(init_method="file://" + sys.argv[1], world_size=2, rank=1, backend="gloo", timeout_s=300.0)
print("RESULT", repr(_train(sys.argv[2], 2)))
comm.destroy_distributed()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA flash kernels")
    return torch.device("cuda", 0)


def _loss_limit():
    sys.path.insert(0, str(REPO))
    try:
        from chip_smoke import TPT_LOSS_GAP
    finally:
        sys.path.remove(str(REPO))
    return TPT_LOSS_GAP["gpt2"]


def test_tp2_train_batch_on_the_card_matches_tp1(cuda_device, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, ref_launches, ref_heads = _train(cuda_device, 1)
    L, H = SMALL["num_layers"], SMALL["num_heads"]
    assert ref_launches == [[L * GAS] * 3] * STEPS and ref_heads == [H]
    store = str(tmp_path / "store")
    partner = subprocess.Popen([sys.executable, "-c", _PARTNER.format(tests=str(REPO / "tests")), store,
                                str(cuda_device)],
                               env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        comm.init_distributed(init_method=f"file://{store}", world_size=2, rank=0, backend="gloo", timeout_s=300.0)
        mine = _train(cuda_device, 2)
        out = partner.communicate(timeout=600)[0]
    finally:
        comm.destroy_distributed()
        if partner.poll() is None:
            partner.kill()
            partner.wait()
    assert partner.returncode == 0, out[-3000:]
    theirs = ast.literal_eval(next(line for line in out.splitlines() if line.startswith("RESULT"))[len("RESULT "):])
    limit = _loss_limit()
    for losses, launches, heads in (mine, theirs):
        assert max(abs(a - b) / abs(b) for a, b in zip(losses, ref)) <= limit, (losses, ref)
        assert launches == [[L * GAS] * 3] * STEPS  # each rank: forward, dK/dV and dQ, 2 layers x gas
        assert heads == [H // 2]  # on its own heads
