"""Mixture of experts on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (the MoE paths are held to the JAX package on the CPU in
``test_torch_moe.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py -q

The gating and the slot-table dispatch on the card route every token as
their CPU run does and agree in value (fp32, TF32 off); a small bf16 MoE
model through the flash kernels and the fused loss repeats its steps
bitwise from the same weights and launches each flash kernel once a layer
and the fused loss once a ``train_batch``; its ``generate`` launches the
decode split and combine kernels once a layer a decode step.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.moe import sharded_moe as sm
from deepspeed_tpu_torch.moe.experts import apply_experts
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.ops.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.optimizers import tree_leaves

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, max_seq_len=256, num_layers=4, num_heads=4, hidden_size=256, dtype=torch.bfloat16,
             attn_impl="flash", loss_impl="fused_xent", moe_every=2, num_experts=8, moe_capacity_factor=1.0)
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 1,
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "zero_optimization": {"stage": 1},
      "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 10**6}
COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq, fx.fused_xent_forward)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA flash, fused-loss and decode kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gating_and_dispatch_on_the_card_match_the_cpu(cuda_device, top_k):
    g = torch.Generator().manual_seed(top_k)
    T, M, E, Fd = 512, 64, 8, 128
    x, gate = torch.randn(T, M, generator=g), torch.randn(M, E, generator=g)
    experts = {"wi": torch.randn(E, M, Fd, generator=g) / 8, "wo": torch.randn(E, Fd, M, generator=g) / 11}
    out = {}
    for dev in ("cpu", cuda_device):
        r, aux, C = sm.route(x.to(dev), gate.to(dev), 1.0, top_k)
        ex = {k: v.to(dev) for k, v in experts.items()}
        y, aux2 = sm.moe_dispatch_combine(x.to(dev), gate.to(dev), lambda ei: apply_experts(ex, ei), 1.0, top_k)
        out[str(dev)] = (sm._dense(r, E, C)[1].cpu(), y.cpu(), aux.cpu(), aux2.cpu())
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert torch.equal(card[0], cpu[0])  # the same tokens in the same slots, the same drops
    assert not card[0].sum(dim=(1, 2)).eq(top_k).all()  # capacity 1.0 dropped some
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card[2], cpu[2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(card[3], cpu[3], rtol=1e-6, atol=1e-6)


def _steps(device, steps=3):
    cfg = TransformerConfig(**SMALL)
    eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config=DS, device=device,
                                         model_parameters=tfm.init(cfg, torch.Generator().manual_seed(0)))[0]
    losses, launches = [], []
    for step in range(steps):
        batch = {"tokens": np.random.default_rng(step).integers(0, SMALL["vocab_size"], size=(4, 257))
                 .astype(np.int32)}
        before = [c.launches for c in COUNTERS]
        losses.append(float(eng.train_batch(batch)["loss"]))
        launches.append([c.launches - b for c, b in zip(COUNTERS, before)])
    return losses, launches, [t.cpu() for t in tree_leaves({"p": eng.state["params"], "o": eng.state["opt"]})]


def test_moe_train_batch_repeats_bitwise_and_launches_the_kernels(cuda_device):
    first, launches, state = _steps(cuda_device)
    again, _, state_again = _steps(cuda_device)
    assert first == again and all(np.isfinite(first))
    assert all(torch.equal(a, b) for a, b in zip(state, state_again))
    L = SMALL["num_layers"]
    assert launches == [[L, L, L, 1]] * 3


def test_moe_generate_launches_the_decode_kernels(cuda_device):
    cfg = TransformerConfig(**SMALL)
    eng = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"}, device=cuda_device)
    prompt = np.random.default_rng(5).integers(0, SMALL["vocab_size"], size=(2, 16))
    split, combine = decode_attention.launches, decode_attention.combine_launches
    out = eng.generate(prompt, max_new_tokens=6)
    L = SMALL["num_layers"]
    assert out.shape == (2, 6)
    assert decode_attention.launches - split == decode_attention.combine_launches - combine == 5 * L
