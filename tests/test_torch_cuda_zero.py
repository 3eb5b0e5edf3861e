"""Data-parallel ZeRO on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (ZeRO is held to the JAX package on the CPU in
``test_torch_zero.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_zero.py -q

In a world of 1 under NCCL, through the real communicator, stages 0-3 give
the same losses bitwise; in a world of 2 under gloo with both ranks on the
card (a second process started here with ``subprocess``), two stage-3
steps give a world of 1's losses on the same global batch, the second
after an update, with the parameters on the card and with them (and the
cpu tier's masters and moments) in host memory.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.models.transformer import init as model_init
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, max_seq_len=128, num_layers=2, num_heads=2, hidden_size=128, attn_impl="flash")
TOKENS = np.random.default_rng(0).integers(0, 128, size=(8, 129)).astype(np.int32)
LOSS_RTOL = 1e-5  # bf16: the same steps with the gradients summed in another order


TIERS = {"offload_optimizer": {"device": "cpu"}, "offload_param": {"device": "cpu"}}


def _ds(stage, micro, tiers=False):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": True}, "zero_optimization": {"stage": stage, **(TIERS if tiers else {})},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and NCCL")
    return torch.device("cuda", 0)


def _params():
    return model_init(TransformerConfig(**TINY), torch.Generator().manual_seed(7))


def test_world1_nccl_stages_agree(cuda_device, tmp_path):
    """ZeRO 0-3 in a world of 1 under NCCL: 3 steps each from the same
    weights, every flash kernel launched 2 layers x gas 2 times a step, the
    losses equal to stage 0's bitwise."""
    comm.init_distributed(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="nccl",
                          device=cuda_device)
    try:
        losses = {}
        for stage in (0, 1, 2, 3):
            eng = deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=_ds(stage, 4),
                                                 model_parameters=tree_map(lambda t: t.clone(), _params()),
                                                 device=cuda_device)[0]
            assert eng.zero is not None and torch.distributed.get_backend() == "nccl"
            before = fa.flash_forward.launches
            losses[stage] = [float(eng.train_batch({"tokens": TOKENS})["loss"]) for _ in range(3)]
            assert fa.flash_forward.launches - before == 3 * 2 * 2
    finally:
        comm.destroy_distributed()
    for stage in (1, 2, 3):
        np.testing.assert_array_equal(losses[stage], losses[0])


_RANK1 = """
import sys
import numpy as np, torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig, init
sys.path.insert(0, {tests!r})
from test_torch_cuda_zero import TINY, TOKENS, _ds
comm.init_distributed(init_method="file://" + sys.argv[1], world_size=2, rank=1, backend="gloo", timeout_s=120.0)
eng = deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=_ds(3, 2, sys.argv[2] == "1"),
                                     model_parameters=init(TransformerConfig(**TINY), torch.Generator().manual_seed(7)),
                                     device="cuda:0")[0]
print("LOSS", *(repr(float(eng.train_batch({{"tokens": TOKENS}})["loss"])) for _ in range(2)))
comm.destroy_distributed()
"""


@pytest.mark.parametrize("tiers", [False, True], ids=["on_the_card", "cpu_tier_offload_param"])
def test_world2_gloo_on_one_card_stage3_step_equals_world1(cuda_device, tmp_path, tiers):
    """Two ranks share the card under gloo; two ZeRO-3 steps give a world
    of 1's losses on the same global batch (the second after an update).
    With the cpu tier and ``offload_param`` each rank's parameter shards,
    gradient shards, masters and moments are in pinned host memory."""
    ref = deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=_ds(3, 4),
                                         model_parameters=_params(), device=cuda_device)[0]
    want = [float(ref.train_batch({"tokens": TOKENS})["loss"]) for _ in range(2)]
    del ref
    store = str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    partner = subprocess.Popen([sys.executable, "-c", _RANK1.format(tests=str(REPO / "tests")), store,
                                str(int(tiers))], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True)
    try:
        comm.init_distributed(init_method=f"file://{store}", world_size=2, rank=0, backend="gloo", timeout_s=120.0)
        eng = deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=_ds(3, 2, tiers),
                                             model_parameters=_params(), device=cuda_device)[0]
        got = [float(eng.train_batch({"tokens": TOKENS})["loss"]) for _ in range(2)]
        assert eng.zero.fraction_held() == {"params": 0.5, "opt_state": 0.5}
        if tiers:
            for tree in (eng.state["params"], eng.state["master"], eng.state["opt"], eng.z3.streamer.grads):
                assert all(t.device.type == "cpu" and t.is_pinned() for t in tree_leaves(tree))
        out = partner.communicate(timeout=300)[0]
    finally:
        comm.destroy_distributed()
        if partner.poll() is None:
            partner.kill()
            partner.wait()
    assert partner.returncode == 0, out[-3000:]
    other = [float(x) for x in next(line for line in out.splitlines() if line.startswith("LOSS")).split()[1:]]
    assert got == other
    assert want[1] != want[0]  # the update moved the loss
    print(f"world 2 vs world 1: losses {got} vs {want}, relative {np.abs(np.subtract(got, want)) / want}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
