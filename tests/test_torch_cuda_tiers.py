"""The memory tiers' pinned paths on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (the tiers are held to the JAX package on the CPU in
``test_torch_offload.py`` and ``test_torch_nvme.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tiers.py -q
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.runtime.zero.host_optimizer import host_empty

pytestmark = pytest.mark.cuda

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, hidden_size=64, attn_impl="flash",
            dtype=torch.bfloat16, loss_chunk_size=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tiers' pinned copies and streams")
    return torch.device("cuda")


def _ds(off_opt="none", off_param="none", nvme_path=""):
    z = {"stage": 1}
    if off_opt != "none":
        z["offload_optimizer"] = {"device": off_opt, "nvme_path": nvme_path}
    if off_param != "none":
        z["offload_param"] = {"device": off_param, "nvme_path": nvme_path}
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "zero_optimization": z,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 10**9}


def _losses(cuda_device, ds, steps=3, **model_kw):
    cfg = tfm.TransformerConfig(**{**TINY, **model_kw})
    params = tfm.init(cfg, torch.Generator().manual_seed(0), cuda_device)
    eng = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds, model_parameters=params)[0]
    batch = {"tokens": np.random.default_rng(0).integers(0, 128, size=(8, 65)).astype(np.int32)}
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(steps)]
    return eng, losses


def test_host_buffers_are_pinned(cuda_device):
    assert host_empty((1024,), torch.float32, pin=True).is_pinned()


def test_cpu_tier_on_the_card(cuda_device):
    """master and moments pinned on the host, bf16 params on the card; the
    losses track the unoffloaded engine's (rtol 2e-2, the CPU parity test's)."""
    plain, ref = _losses(cuda_device, _ds())
    eng, losses = _losses(cuda_device, _ds("cpu"))
    assert all(t.is_pinned() for t in tree_leaves(eng.state["master"]) + tree_leaves(eng.state["opt"]))
    assert all(t.is_cuda and t.dtype == torch.bfloat16 for t in tree_leaves(eng.state["params"]))
    np.testing.assert_allclose(losses, ref, rtol=2e-2)
    assert eng.tier.stats["d2h_bytes"] > 0 and eng.tier.stats["h2d_bytes"] > 0


def test_param_streaming_equals_the_cpu_tier(cuda_device):
    """offload_param: the params stay pinned on the host, stream a layer at a
    time; the trajectory is the cpu tier's (same arithmetic, other place)."""
    _, ref = _losses(cuda_device, _ds("cpu"))
    eng, losses = _losses(cuda_device, _ds("cpu", "cpu"))
    assert all(t.is_pinned() and t.dtype == torch.bfloat16 for t in tree_leaves(eng.state["params"]))
    np.testing.assert_allclose(losses, ref, rtol=1e-6)
    s = eng.tier.streamer
    assert s.h2d_bytes > 0 and s.d2h_bytes > 0
    with pytest.raises(NotImplementedError, match="train_batch"):
        eng.backward()


def test_nvme_tier_resumes_bitwise_on_the_card(cuda_device, tmp_path):
    ds = _ds("nvme", nvme_path=str(tmp_path / "swap"))
    eng, losses = _losses(cuda_device, ds, steps=2)
    assert np.isfinite(losses).all() and eng.state["opt"] == {}
    eng.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    batch = {"tokens": np.random.default_rng(1).integers(0, 128, size=(8, 65)).astype(np.int32)}
    want = float(eng.train_batch(batch)["loss"])
    after = tree_map(torch.clone, eng.state["params"])
    eng.close()
    cfg = tfm.TransformerConfig(**TINY)
    eng2 = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds)[0]
    eng2.load_checkpoint(str(tmp_path / "ckpt"))
    assert float(eng2.train_batch(batch)["loss"]) == want
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(after), tree_leaves(eng2.state["params"])))
    eng2.close()


def test_cpu_checkpointing_gradients_on_the_card(cuda_device):
    """remat_offload: the boundaries go to pinned host memory and back; the
    gradients equal the no-offload remat's exactly."""
    cfg = tfm.TransformerConfig(**{**TINY, "dtype": torch.float32, "remat": True, "remat_policy": "save_flash"})
    params = tfm.init(cfg, torch.Generator().manual_seed(0), cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, size=(2, 33))).to(cuda_device)

    def grads(c):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        tfm.causal_lm_loss(c, leaves, {"tokens": tokens}).backward()
        return [t.grad for t in tree_leaves(leaves)]

    for a, b in zip(grads(cfg), grads(cfg.replace(remat_offload=True))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_async_save_of_the_cpu_tier_resumes_bitwise(cuda_device, tmp_path):
    """checkpoint.async_save over the cpu tier: the bf16 device params are
    snapshotted through the pinned staging buffer, the pinned master and
    moments cloned; a fresh engine loads the committed save and steps as
    the uninterrupted one does."""
    ds = {**_ds("cpu"), "checkpoint": {"async_save": True}}
    eng, _ = _losses(cuda_device, ds, steps=2)
    eng.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    eng.checkpoint_engine.commit()
    batch = {"tokens": np.random.default_rng(1).integers(0, 128, size=(8, 65)).astype(np.int32)}
    want = float(eng.train_batch(batch)["loss"])
    eng2 = deepspeed_tpu_torch.initialize(model=tfm.Model(tfm.TransformerConfig(**TINY)), config=ds)[0]
    eng2.load_checkpoint(str(tmp_path / "ckpt"))
    assert all(t.is_pinned() for t in tree_leaves(eng2.state["master"]))
    assert float(eng2.train_batch(batch)["loss"]) == want
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.state["master"]), tree_leaves(eng2.state["master"])))
