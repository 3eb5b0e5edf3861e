"""The program ledger on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
no JAX (the ledger is held to the JAX package on the CPU in
``test_torch_program_ledger.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ledger.py -q

Counting a kernel adds no launch and records the kernel's own cost
formula; the serving decode's first call captures ONE CUDA graph with the
ledger on, as with it off, with the same launches a replay; the card's
rows are rated against its data-sheet peaks.
"""

import contextlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops import decode_attention as da
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.telemetry.cost import CostCounter
from deepspeed_tpu_torch.telemetry.program_ledger import PEAKS, platform_peaks

pytestmark = pytest.mark.cuda

TINY = dict(vocab_size=128, max_seq_len=128, num_layers=2, num_heads=2, hidden_size=128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs")
    return torch.device("cuda")


def _launches():
    return (fa.flash_forward.launches, fa.flash_backward_dkdv.launches, fa.flash_backward_dq.launches,
            fx.fused_xent_forward.launches, fx.xent_fwd_combine.launches, fx.xent_ds_pass.launches,
            fx.xent_dw_pass.launches, fx.xent_dh_pass.launches, da.decode_attention.launches,
            da.decode_attention.combine_launches)


def _kernel_calls(dev):
    """Flash forward + backward, the fused loss forward + backward and one
    decode call on bf16 tensors."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=g, device=dev, dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    fa.flash_attention(q, k, v).float().sum().backward()
    h = torch.randn(256, 64, generator=g, device=dev, dtype=torch.bfloat16).requires_grad_()
    w = (0.1 * torch.randn(64, 512, generator=g, device=dev, dtype=torch.bfloat16)).requires_grad_()
    labels = torch.randint(0, 512, (256,), generator=g, device=dev)
    fx.fused_linear_xent(h, w, labels).sum().backward()
    qd = torch.randn(2, 4, 64, generator=g, device=dev, dtype=torch.bfloat16)
    kc, vc = (torch.randn(2, 256, 4, 64, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    da.decode_attention(qd, kc, vc, torch.tensor([100, 255], device=dev, dtype=torch.int32))
    torch.cuda.synchronize(dev)


def test_counting_a_kernel_adds_no_launch(cuda_device):
    runs = {}
    for counting in (False, True):
        before = _launches()
        with (CostCounter(cuda_device) if counting else contextlib.nullcontext()) as c:
            _kernel_calls(cuda_device)
        runs[counting] = (tuple(a - b for a, b in zip(_launches(), before)), c)
    assert runs[True][0] == runs[False][0]
    assert runs[True][0][:3] == (1, 1, 1) and runs[True][0][8:] == (1, 1)
    c = runs[True][1]
    flash = fa.flash_cost(2, 256, 256, 4, 64, 2)
    xent = fx.xent_cost(256, 64, 512, 2)
    expect = {**{n: flash[n] for n in ("flash_forward", "flash_backward_dkdv", "flash_backward_dq")},
              **xent, **da.decode_cost(2, 256, 4, 64, 2)}
    assert {n: (r["flops"], r["bytes"]) for n, r in c.kernels.items()} == {
        n: (float(f), float(b)) for n, (f, b) in expect.items()}
    assert all(r["calls"] == 1 for r in c.kernels.values())


def _serve(engine, ledger):
    srv = ServingEngine(engine, config={"n_slots": 4, "watchdog_mode": "raise", "ledger": {"enabled": ledger}})
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 128, size=5 + 3 * i).astype(np.int32), max_new_tokens=8)
            for i in range(6)]
    res = srv.serve(reqs)
    return srv, {u: r.tokens.tolist() for u, r in res.items()}


def test_decode_graph_captured_once_with_the_ledger(cuda_device):
    engine = deepspeed_tpu_torch.init_inference(Model(TransformerConfig(**TINY)), config={"dtype": "bf16"})
    off, tokens_off = _serve(engine, False)
    on, tokens_on = _serve(engine, True)
    L = TINY["num_layers"]
    assert tokens_on == tokens_off
    assert on.compile_counts()["decode"] == off.compile_counts()["decode"] == 1
    assert on.worker.graph_launches == off.worker.graph_launches == (L, L)
    assert on.worker.graph_replays == off.worker.graph_replays > 0
    row = next(r for r in on.telemetry_snapshot()["program_ledger"] if r["name"] == "serving/decode")
    # the warm-up runs uncounted: the capture's one step is the row
    assert row["kernels"]["decode_attention"]["calls"] == L
    assert row["roofline"] in ("hbm-bound", "compute-bound") and row["temp_bytes"] >= 0


def test_platform_peaks_on_the_card_are_rated(cuda_device):
    name = torch.cuda.get_device_name(cuda_device)
    peaks = platform_peaks(cuda_device)
    assert peaks["platform"] == "gpu" and peaks["device_kind"] == name
    if "H100" not in name:
        pytest.skip(f"{name} is not in the peak table (its rows stay unrated)")
    key = "gpu_h100_pcie" if "pcie" in name.lower() else "gpu_h100_sxm"
    assert peaks["peak_tflops"] == PEAKS[key]["peak_tflops"] and peaks["peak_hbm_gbps"] == PEAKS[key]["peak_hbm_gbps"]
    cfg = TransformerConfig(**TINY, attn_impl="flash", dtype=torch.bfloat16)
    eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config={
        "train_batch_size": 8, "bf16": {"enabled": True}, "telemetry": {"enabled": True}})[0]
    batch = {"tokens": np.random.default_rng(0).integers(0, 128, size=(8, 129)).astype(np.int32)}
    for _ in range(3):
        eng.train_batch(batch)
    torch.cuda.synchronize(cuda_device)
    snap = eng.telemetry_snapshot()
    (row,) = snap["program_ledger"]
    assert row["name"] == "train/train_step" and row["roofline"] in ("hbm-bound", "compute-bound")
    assert 0 < row["mfu"] < 1 and snap["metrics"]["gauges"]["train/mfu"] == row["mfu"]
    assert row["argument_bytes"] > 0 and row["kernels"]["flash_forward"]["calls"] == cfg.num_layers
