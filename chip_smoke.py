#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or makes the script exit non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from deepspeed_tpu_torch/csrc, one nvcc per source,
     all started together;
  3. hold the kernel against its plain PyTorch version at the serving shape
     (B=8, Smax=1024, H=12, D=64; bf16 and fp32; per-row and scalar pos;
     with and without ALiBi; plus D=128 and D=8), then time the kernel, the
     plain version and torch's scaled_dot_product_attention (a yardstick the
     port never calls) against the HBM bound;
  4. init_inference -> generate at GPT-2-125M width (12 layers, d768, 12
     heads, vocab 50304, max_seq_len 1024, bf16, random weights from a
     seeded torch.Generator): 8 prompts of 768 tokens, 256 new tokens,
     greedy and sampled, checking that every decode step of every layer
     went through the kernel, that the first decode step's logits agree
     with the plain cached-attention path, and that on a small fp32 model
     greedy tokens through the kernel equal the plain path's;
  5. load the flash-attention kernels (forward, dK/dV, dQ);
  6. hold each flash kernel against its plain version: bf16 and fp32;
     causal, bidirectional, ALiBi, window 256 and window 0 at B=8, S=1024,
     H=12, D=64; the ragged causal edge S=1000; S=128; D=128. Then time
     each kernel, its plain version and torch's scaled_dot_product_attention
     (a yardstick the port never calls) against the bound at that shape;
  7. initialize -> train_batch at GPT-2-125M width (the model bench.py
     times: 12 layers, d768, 12 heads, vocab 50304, S=1024, bf16, flash
     attention, loss chunk 256, AdamW, clipping 1.0, ZeRO stage 1, batch 64
     = micro 16 x gas 4): one warm-up step and five timed steps, checking
     48 = 12 x 4 launches of each flash kernel per train_batch, a finite
     falling loss and no overflow;
  8. slice parity: five fp32 steps of a small model through the kernels and
     through plain attention give the same losses, and at full width in
     bf16 the first step's loss and grad norm agree on an 8-row batch;
  9. hold each fused-loss kernel (forward, dH, dW) against its plain version
     at the training shape (N = 16 x 1024 rows, D = 768, V = 50304, bf16,
     one row in seven ignored, the head as wte.t()), and in fp32 and fp16 at
     N = 2048, and at V = 50257 and V = 777; then time each kernel, the
     plain versions and, as a reference point only, the cuBLAS logits
     product of the chunked loss, against the bound at that shape;
 10. train through the fused loss under remat at GPT-2-125M width: phase 7's
     configuration with loss_impl="fused_xent", remat=True,
     remat_policy="dots_and_flash", one warm-up and five timed steps,
     checking 48 launches of each flash kernel and 4 of each fused-loss
     kernel per train_batch, then one step under nothing_saveable with 96
     flash-forward launches;
 11. slice parity: five fp32 steps of a small model with the fused loss and
     with the chunked loss give the same losses, and at full width in bf16
     the first step's loss and grad norm agree;
 12. checkpoint and resume: a small bf16 model with dropout trained 2 steps,
     saved, loaded into a fresh engine and trained 3 more gives the losses of
     5 uninterrupted steps bitwise; at full width one save/load round trip
     into a fresh engine (seconds, bytes) and one step whose loss equals the
     uninterrupted engine's.
It prints a ``{"kernels": [...]}`` line, a ``{"training": {...}}`` line,
then as its last line ``{"ok": true, "device": {...}}``. Without a GPU it
exits 1 and prints no result.

    python3 chip_smoke.py --profile chiprun_out/profile

also traces one generate(max_new_tokens=64), one train_batch of phase 7 and
one of phase 10 with torch.profiler and prints the device's busy share and
its time by kernel.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_xent as fx
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (the kernel's math)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
KERNEL_SOURCES = ("decode_attention", "flash_attention", "fused_xent")
FLASH_COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
XENT_COUNTERS = (fx.fused_xent_forward, fx.fused_xent_backward_dh, fx.fused_xent_backward_dw)
B, SMAX, H, D = 8, 1024, 12, 64
POS_ROWS = [0, 1, 127, 128, 500, 767, 1022, 1023]
# fp32: the kernel and the plain version differ in summation order only.
# bf16/fp16: both accumulate in fp32 and round the output once, so they
# differ by at most about one ulp (bf16 2^-7, fp16 2^-10 relative) of
# outputs below 2.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}
# First decode step's fp32 logits, kernel vs plain cached attention, both in
# bf16: the plain path rounds scores, probabilities and the PV product to
# bf16 where the kernel keeps fp32, and the difference passes through 12
# layers before the vocab projection.
LOGITS_TOL = 0.1
PROMPT_LEN, MAX_NEW = 768, 256
PROFILE_NEW = 64


def median_ms(fn, flush, runs=100, warmup=10):
    """Median device time of ``fn`` over ``runs`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2) so every run reads the
    cache cold, as each layer of a decode step does. The flush also keeps
    the device busy while the host enqueues ``fn``."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_checks(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(dtype, d, pos, alibi):
        q = torch.randn(B, H, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, SMAX, H, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, SMAX, H, d, generator=gen, device=dev).to(dtype)
        slopes = tfm.alibi_slopes(H, dev) if alibi else None
        out = decode_attention(q, k, v, pos, alibi_slopes=slopes)
        torch.cuda.synchronize()
        ref = decode_attention_reference(q, k, v, pos, alibi_slopes=slopes)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
        label = f"{str(dtype)[6:]} D={d} pos={'rows' if torch.is_tensor(pos) else pos} alibi={alibi}"
        print(f"  kernel vs plain  {label:<38} max_abs_err={err:.3e}  tol={TOL[dtype]:.0e}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"decode_attention disagrees with its plain version: {label}")
        return err

    pos_rows = torch.tensor(POS_ROWS, dtype=torch.int32, device=dev)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for pos in (pos_rows, 700):
            for alibi in (False, True):
                errs[dtype] = max(errs[dtype], case(dtype, D, pos, alibi))
    errs[torch.bfloat16] = max(errs[torch.bfloat16], case(torch.bfloat16, 128, pos_rows, False))
    errs[torch.float32] = max(errs[torch.float32], case(torch.float32, 8, pos_rows, True))
    return errs


def kernel_timing(dev):
    """Times at the serving shape in bf16 with every row at pos 1023."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, SMAX, H, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, SMAX, H, D, generator=gen, device=dev).bfloat16()
    pos = torch.full((B,), SMAX - 1, dtype=torch.int32, device=dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(SMAX, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    lib_err = (library()[:, :, 0].float() - decode_attention_reference(q, k, v, pos).float()).abs().max().item()
    times = {
        "ms": median_ms(lambda: decode_attention(q, k, v, pos), flush),
        "plain_ms": median_ms(lambda: decode_attention_reference(q, k, v, pos), flush),
        "library_ms": median_ms(library, flush),
    }
    live_keys = int((pos.long() + 1).clamp(max=SMAX).sum())
    elt = q.element_size()
    nbytes = 2 * live_keys * H * D * elt + 2 * B * H * D * elt + B * 4  # k,v live prefix; q, out; pos
    flops = 4 * live_keys * H * D  # q·k and p·v, a multiply and an add each
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    times["bound_ms"] = max(bytes_ms, ops_ms)
    times["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  timing bf16 B={B} Smax={SMAX} H={H} D={D} pos=1023 (L2 flushed per run): "
          f"kernel {times['ms']*1e3:.1f} us, plain {times['plain_ms']*1e3:.1f} us, "
          f"sdpa {times['library_ms']*1e3:.1f} us (max_abs_err vs plain {lib_err:.2e}), "
          f"bound {times['bound_ms']*1e3:.2f} us ({nbytes/1e6:.1f} MB / 3.35 TB/s)")
    return times


# Flash kernels vs their plain versions. Forward output: as for decode; lse is
# fp32 in both and differs in summation order only. Gradients, as max abs
# error over the reference's max |value|: fp32 summation order only; bf16
# rounds P and dS to bf16 (fp16) at the same points in both, but a value near
# a rounding boundary can land one ulp (2^-8; fp16 2^-11 relative) apart.
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}
LSE_TOL = 1e-3
FS = 1024  # the training sequence length


def flash_case(dev, gen, dtype, B, S, H, D, causal=True, alibi=False, window=None):
    """One kernel-vs-plain check of all three flash kernels; raises on a
    disagreement. The backward kernels get the plain forward's O and lse,
    so each kernel is held against its plain version on the same inputs."""
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype) for _ in range(4))
    kw = {"causal": causal, "alibi_slopes": tfm.alibi_slopes(H, dev) if alibi else None,
          "window": window}
    out, lse = fa.flash_forward(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    delta = fa.flash_delta(ref_out, dout)
    dk, dv = fa.flash_backward_dkdv(q, k, v, dout, ref_lse, delta, **kw)
    dq = fa.flash_backward_dq(q, k, v, dout, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    ref_dq, ref_dk, ref_dv = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, dout, **kw)

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def rel_err(a, b):
        return abs_err(a, b) / max(b.float().abs().max().item(), 1e-6)

    errs = {
        "flash_forward": (abs_err(out, ref_out), abs_err(out, ref_out), TOL[dtype]),
        "flash_backward_dkdv": (max(abs_err(dk, ref_dk), abs_err(dv, ref_dv)),
                                max(rel_err(dk, ref_dk), rel_err(dv, ref_dv)), FLASH_GRAD_TOL[dtype]),
        "flash_backward_dq": (abs_err(dq, ref_dq), rel_err(dq, ref_dq), FLASH_GRAD_TOL[dtype]),
    }
    lse_err = abs_err(lse, ref_lse)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
    label = (f"{str(dtype)[6:]} B={B} S={S} D={D} {'causal' if causal else 'bidir'}"
             f"{' alibi' if alibi else ''}{'' if window is None else f' window={window:g}'}")
    ok = finite and lse_err <= LSE_TOL and all(checked <= tol for _, checked, tol in errs.values())
    print(f"  flash vs plain  {label:<44} out {errs['flash_forward'][0]:.2e} (tol {TOL[dtype]:.0e}), "
          f"lse {lse_err:.2e}, dK/dV {errs['flash_backward_dkdv'][1]:.2e}, "
          f"dQ {errs['flash_backward_dq'][1]:.2e} (rel, tol {FLASH_GRAD_TOL[dtype]:.0e})  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"a flash kernel disagrees with its plain version: {label}")
    return errs


def flash_checks(dev):
    """Every case of phase 6 -> {kernel: {dtype: (max abs err, max rel err)}}."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {name: {dt: (0.0, 0.0) for dt in TOL} for name in ("flash_forward", "flash_backward_dkdv",
                                                                 "flash_backward_dq")}
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        cases = [dict(B=8, S=FS, H=H, D=D, **kw) for kw in (
            {}, {"causal": False}, {"alibi": True}, {"window": 256.0}, {"window": 0.0})]
        cases += [dict(B=8, S=1000, H=H, D=D), dict(B=8, S=128, H=H, D=D), dict(B=2, S=FS, H=H, D=128)]
        for case in cases:
            for name, (a, r, _) in flash_case(dev, gen, dtype, **case).items():
                worst[name][dtype] = tuple(max(x, y) for x, y in zip(worst[name][dtype], (a, r)))
            torch.cuda.empty_cache()
    return worst


def flash_bounds(B, S, H, D, elt):
    """{kernel: (bound_ms, bound_by, bytes, flops)} from the shape: each input
    read once and each output written once; causal work is the S(S+1)/2
    live (q, k) pairs, 2 flops per multiply-add of each D-long product."""
    t = B * S * H * D * elt
    rows = B * H * S * 4
    pairs = B * H * S * (S + 1) // 2
    work = {"flash_forward": (4 * t + rows, 2 * 2 * D * pairs),          # q,k,v -> O, lse
            "flash_backward_dkdv": (6 * t + 2 * rows, 4 * 2 * D * pairs),  # q,k,v,dO,lse,Δ -> dK,dV
            "flash_backward_dq": (5 * t + 2 * rows, 3 * 2 * D * pairs)}    # q,k,v,dO,lse,Δ -> dQ
    out = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)
    return out


def flash_timing(dev):
    """Times at the training shape, bf16, causal, B=8: each kernel, the plain
    versions, and SDPA's forward and backward as the yardstick."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S = 8, FS
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(4))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.flash_delta(out, dout)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))  # [B, H, S, D]
    lib_err = (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2).float() - out.float()).abs().max().item()
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    o_lib = sdpa(qr, kr, vr, is_causal=True)
    plain_bwd = median_ms(lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout), flush, runs=30)
    lib_bwd = median_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), dot, retain_graph=True), flush)
    times = {
        "flash_forward": {
            "ms": median_ms(lambda: fa.flash_forward(q, k, v), flush),
            "plain_ms": median_ms(lambda: fa.flash_attention_reference(q, k, v), flush, runs=30),
            "library_ms": median_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)},
        "flash_backward_dkdv": {
            "ms": median_ms(lambda: fa.flash_backward_dkdv(q, k, v, dout, lse, delta), flush),
            "plain_ms": plain_bwd, "library_ms": lib_bwd},
        "flash_backward_dq": {
            "ms": median_ms(lambda: fa.flash_backward_dq(q, k, v, dout, lse, delta), flush),
            "plain_ms": plain_bwd, "library_ms": lib_bwd},
    }
    fwd_bwd_lib = median_ms(
        lambda: torch.autograd.grad(sdpa(qr, kr, vr, is_causal=True), (qr, kr, vr), dot), flush)
    for name, (bound, by, nbytes, flops) in flash_bounds(B, S, H, D, 2).items():
        times[name].update(bound_ms=bound, bound_by=by)
        t = times[name]
        print(f"  timing {name:<20} bf16 B={B} S={S} H={H} D={D} causal: kernel {t['ms']*1e3:8.1f} us, "
              f"plain {t['plain_ms']*1e3:8.1f} us, sdpa {t['library_ms']*1e3:7.1f} us, bound "
              f"{bound*1e3:5.1f} us ({by}: {nbytes/1e6:.1f} MB, {flops/1e9:.1f} GFLOP), "
              f"{flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"  sdpa forward+backward {fwd_bwd_lib*1e3:.1f} us (its backward alone is the library time of "
          f"both backward rows); sdpa vs kernel output max_abs_err {lib_err:.2e}; plain backward times "
          f"all three gradients")
    return times


BENCH_DS = {
    "train_batch_size": 64, "train_micro_batch_size_per_gpu": 16, "gradient_accumulation_steps": 4,
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1}, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "steps_per_print": 1000000,
}
TRAIN_STEPS = 5


def gpt2_config(**kw):
    """GPT-2-125M at full width, as bench.py:139-171 trains it; phase 7 with
    the chunked loss and no remat (the 80 GB card holds the activations),
    phase 10 with bench.py's fused loss and dots_and_flash remat."""
    return TransformerConfig(vocab_size=50304, max_seq_len=FS, num_layers=12, num_heads=12, hidden_size=768,
                             pos_emb="learned", tie_embeddings=True, dtype=torch.bfloat16,
                             attn_impl="flash", loss_chunk_size=256, **kw)


def counts():
    return [c.launches for c in FLASH_COUNTERS] + [decode_attention.launches] + [c.launches for c in XENT_COUNTERS]


def reset_counts():
    for c in FLASH_COUNTERS + XENT_COUNTERS:
        c.launches = 0
    decode_attention.launches = 0


def train(dev):
    model = Model(gpt2_config())
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=BENCH_DS)
    torch.cuda.synchronize()
    print(f"  initialize: {time.perf_counter() - t0:.2f} s on {engine.device}")
    B, S, L = BENCH_DS["train_batch_size"], FS, model.config.num_layers
    gas = BENCH_DS["gradient_accumulation_steps"]
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, S + 1)).astype(np.int32)}
    t0 = time.perf_counter()
    warm = engine.train_batch(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = counts()
        metrics.append(engine.train_batch(batch))
        per_step.append([a - b for a, b in zip(counts(), before)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    losses = [float(warm["loss"])] + [float(m["loss"]) for m in metrics]
    overflow = any(bool(m["overflow"]) for m in [warm] + metrics)
    expect = L * gas
    ok = (all(step[:3] == [expect] * 3 and step[3:] == [0] * 4 for step in per_step)
          and all(np.isfinite(losses)) and losses[-1] < losses[0] and not overflow)
    step_s = seconds / TRAIN_STEPS
    tok_s = B * S / step_s
    n_params = L * 12 * 768 * 768 + 50304 * 768 + S * 768  # bench.py:219-221
    bench_flops = 6 * n_params + L * 12 * S * 768
    result = {
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
        "tflops_model": tok_s * model.flops_per_token() / 1e12, "tflops_bench_formula": tok_s * bench_flops / 1e12,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
        "grad_norms": [float(m["grad_norm"]) for m in [warm] + metrics], "overflow": overflow,
        "launches_per_train_batch": per_step[0][:3],
    }
    print(f"  train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): {result['step_ms']:.1f} ms/step, "
          f"{tok_s:.0f} tokens/s, {result['tflops_model']:.1f} TFLOP/s (Model.flops_per_token), "
          f"{result['tflops_bench_formula']:.1f} TFLOP/s (bench.py formula), peak {result['peak_gib']:.2f} GiB")
    print(f"  flash launches per train_batch {per_step} (expect {L} x {gas} = {expect} of each, 0 decode); "
          f"losses {[round(x, 4) for x in losses]}; overflow {overflow}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the training phase failed its checks")
    return launches[:3], result, engine, batch


def train_parity(dev):
    """Phase 8: the slice through the kernels against plain attention."""
    tiny = TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=64)
    params = tfm.init(tiny, torch.Generator().manual_seed(0), dev)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 1000000}
    batch = {"tokens": np.random.default_rng(2).integers(0, 97, size=(4, 129)).astype(np.int32)}
    traj = {}
    for impl in ("flash", "xla"):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(tiny.replace(attn_impl=impl)), config=ds,
                                                      model_parameters=params)
        traj[impl] = [float(eng.train_batch(batch)["loss"]) for _ in range(5)]
    # fp32: the kernels and plain attention differ in summation order only;
    # five AdamW steps keep that near 1e-6 relative
    small_err = max(abs(a - b) / abs(b) for a, b in zip(traj["flash"], traj["xla"]))
    ok = small_err <= 1e-4
    print(f"  small fp32 model, 5 steps: flash {[round(x, 5) for x in traj['flash']]} vs plain "
          f"{[round(x, 5) for x in traj['xla']]}, max rel err {small_err:.2e} (tol 1e-4)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the small model's loss through the kernels differs from plain attention")

    cfg = gpt2_config()
    params = tfm.init(cfg, torch.Generator().manual_seed(1), dev)
    ds8 = dict(BENCH_DS, train_batch_size=8, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=1)
    batch = {"tokens": np.random.default_rng(3).integers(0, 50304, size=(8, FS + 1)).astype(np.int32)}
    first = {}
    for impl in ("flash", "xla"):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(cfg.replace(attn_impl=impl)), config=ds8,
                                                      model_parameters=params)
        m = eng.train_batch(batch)
        first[impl] = (float(m["loss"]), float(m["grad_norm"]))
        del eng, m
        torch.cuda.empty_cache()
    # bf16: the plain path rounds the scores to bf16 before the softmax where
    # the kernels keep them in fp32, through 12 layers
    loss_err = abs(first["flash"][0] - first["xla"][0]) / abs(first["xla"][0])
    gnorm_err = abs(first["flash"][1] - first["xla"][1]) / abs(first["xla"][1])
    ok = loss_err <= 1e-2 and gnorm_err <= 5e-2 and all(np.isfinite(first["flash"]))
    print(f"  full width bf16, first train_batch (8 rows, gas 1): loss {first['flash'][0]:.5f} vs "
          f"{first['xla'][0]:.5f} (rel {loss_err:.2e}, tol 1e-2), grad norm {first['flash'][1]:.5f} vs "
          f"{first['xla'][1]:.5f} (rel {gnorm_err:.2e}, tol 5e-2)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the full-width step through the kernels disagrees with plain attention")
    return {"small_fp32_max_rel_err": small_err, "full_width_loss_rel_err": loss_err,
            "full_width_grad_norm_rel_err": gnorm_err}


# Fused-loss kernels vs their plain versions. nll and lse: the logits are
# exact fp32 products of the inputs' values in both, summed over D and
# log-sum-exp'd over V in other orders: about 1e-6 relative of values near
# 11. dH and dW, as max abs error over the reference's max |value|: ds is
# rounded to the input type at the same points in both, but a value near a
# rounding boundary can land one ulp apart (as for the flash gradients).
XENT_TOL = 1e-3
XENT_GRAD_TOL = FLASH_GRAD_TOL
XN, XD, XV = 16 * FS, 768, 50304  # the main path's rows (micro 16 x S 1024), width and vocab


def xent_inputs(dev, gen, N, D, V, dtype):
    """hidden [N, D] ~ N(0, 1) (post-LayerNorm scale), the head as wte.t()
    of a [V, D] buffer ~ N(0, 0.02) (the model's init), int32 labels with
    one row in seven ignored, g = the masked mean's cotangent."""
    h = torch.randn(N, D, generator=gen, device=dev).to(dtype)
    wte = (torch.randn(V, D, generator=gen, device=dev) * 0.02).to(dtype)
    y = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    y[::7] = -1
    mask = (y >= 0).float()
    return h, wte.t(), y, mask / mask.sum()


def xent_case(dev, gen, N, D, V, dtype):
    """One kernel-vs-plain check of the three fused-loss kernels; raises on
    a disagreement. The backward kernels get the plain forward's lse."""
    h, head, y, g = xent_inputs(dev, gen, N, D, V, dtype)
    nll, lse = fx.fused_xent_forward(h, head, y)
    ref_nll, ref_lse = fx.fused_linear_xent_reference(h, head, y)
    dh = fx.fused_xent_backward_dh(h, head, y, ref_lse, g)
    dw = fx.fused_xent_backward_dw(h, head, y, ref_lse, g)
    torch.cuda.synchronize()
    ref_dh, ref_dw = fx.fused_linear_xent_backward_reference(h, head, y, ref_lse, g)

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def rel_err(a, b):
        return abs_err(a, b) / max(b.float().abs().max().item(), 1e-12)

    errs = {"fused_xent_forward": (abs_err(nll, ref_nll), abs_err(lse, ref_lse)),
            "fused_xent_backward_dh": (abs_err(dh, ref_dh), rel_err(dh, ref_dh)),
            "fused_xent_backward_dw": (abs_err(dw, ref_dw), rel_err(dw, ref_dw))}
    finite = all(bool(torch.isfinite(t).all()) for t in (nll, lse, dh, dw))
    ignored_zero = dh[::7].abs().max().item() == 0.0
    ok = (finite and ignored_zero and max(errs["fused_xent_forward"]) <= XENT_TOL
          and errs["fused_xent_backward_dh"][1] <= XENT_GRAD_TOL[dtype]
          and errs["fused_xent_backward_dw"][1] <= XENT_GRAD_TOL[dtype] and dw.stride() == head.stride())
    label = f"{str(dtype)[6:]} N={N} D={D} V={V}"
    print(f"  fused xent vs plain  {label:<32} nll {errs['fused_xent_forward'][0]:.2e}, "
          f"lse {errs['fused_xent_forward'][1]:.2e} (tol {XENT_TOL:.0e}), dH {errs['fused_xent_backward_dh'][1]:.2e}, "
          f"dW {errs['fused_xent_backward_dw'][1]:.2e} (rel, tol {XENT_GRAD_TOL[dtype]:.0e}), ignored rows' dH 0: "
          f"{ignored_zero}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"a fused-loss kernel disagrees with its plain version: {label}")
    return errs


def xent_checks(dev):
    """Every case of phase 9 -> {kernel: {dtype: (max abs err, second)}}, the
    second being the lse's abs error (forward) or the max rel error (dH, dW)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {name: {} for name in ("fused_xent_forward", "fused_xent_backward_dh", "fused_xent_backward_dw")}
    cases = [(XN, XD, XV, torch.bfloat16), (2048, XD, XV, torch.float32), (2048, XD, XV, torch.float16),
             (2048, XD, 50257, torch.bfloat16), (2048, XD, 777, torch.bfloat16)]
    for N, D, V, dtype in cases:
        for name, e in xent_case(dev, gen, N, D, V, dtype).items():
            old = worst[name].get(dtype, (0.0, 0.0))
            worst[name][dtype] = tuple(max(x, y) for x, y in zip(old, e))
        torch.cuda.empty_cache()
    return worst


def xent_bounds(N, D, V, elt):
    """{kernel: (bound_ms, bound_by, bytes, flops)}: each input read once and
    each output written once; the logits take 2·N·D·V flops, and each
    backward computes them again before its own product of the same size."""
    hw = (N * D + D * V) * elt
    rows = N * 4
    work = {"fused_xent_forward": (hw + rows + 2 * rows, 2 * N * D * V),               # h, W, y -> nll, lse
            "fused_xent_backward_dh": (hw + 3 * rows + N * D * elt, 4 * N * D * V),    # h, W, y, lse, g -> dH
            "fused_xent_backward_dw": (hw + 3 * rows + D * V * elt, 4 * N * D * V)}    # h, W, y, lse, g -> dW
    out = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)
    return out


def xent_timing(dev):
    """Times at the training shape, bf16: each kernel, the plain versions,
    and the cuBLAS [N, D]·[D, V] product the chunked loss runs (a reference
    point only: it is not the same function, and the port never calls it
    for this loss)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h, head, y, g = xent_inputs(dev, gen, XN, XD, XV, torch.bfloat16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    _, lse = fx.fused_xent_forward(h, head, y)
    plain_bwd = median_ms(lambda: fx.fused_linear_xent_backward_reference(h, head, y, lse, g), flush,
                          runs=5, warmup=1)
    times = {
        "fused_xent_forward": {"ms": median_ms(lambda: fx.fused_xent_forward(h, head, y), flush, runs=10, warmup=2),
                               "plain_ms": median_ms(lambda: fx.fused_linear_xent_reference(h, head, y), flush,
                                                     runs=5, warmup=1)},
        "fused_xent_backward_dh": {"ms": median_ms(lambda: fx.fused_xent_backward_dh(h, head, y, lse, g), flush,
                                                   runs=10, warmup=2), "plain_ms": plain_bwd},
        "fused_xent_backward_dw": {"ms": median_ms(lambda: fx.fused_xent_backward_dw(h, head, y, lse, g), flush,
                                                   runs=10, warmup=2), "plain_ms": plain_bwd},
    }
    cublas_ms = median_ms(lambda: h @ head, flush, runs=20, warmup=3)
    for name, (bound, by, nbytes, flops) in xent_bounds(XN, XD, XV, 2).items():
        t = times[name]
        t.update(bound_ms=bound, bound_by=by, library_ms=None, cublas_logits_ms=cublas_ms)
        print(f"  timing {name:<23} bf16 N={XN} D={XD} V={XV}: kernel {t['ms']:8.2f} ms, plain {t['plain_ms']:8.2f} ms, "
              f"bound {bound:.2f} ms ({by}: {nbytes/1e6:.1f} MB, {flops/1e12:.2f} TFLOP), "
              f"{flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"  no single PyTorch call computes this function (library: null); reference point only: the cuBLAS "
          f"logits product [N, D]·[D, V] bf16 {cublas_ms:.2f} ms; the plain backward times dH and dW together")
    return times


FUSED = dict(loss_impl="fused_xent", remat=True, remat_policy="dots_and_flash")


def train_fused(dev):
    """Phase 10: phase 7's step through the fused loss under dots_and_flash
    remat (bench.py's tuned configuration)."""
    model = Model(gpt2_config(**FUSED))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=BENCH_DS)
    B, S, L = BENCH_DS["train_batch_size"], FS, model.config.num_layers
    gas = BENCH_DS["gradient_accumulation_steps"]
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, S + 1)).astype(np.int32)}
    t0 = time.perf_counter()
    warm = engine.train_batch(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = counts()
        metrics.append(engine.train_batch(batch))
        per_step.append([a - b for a, b in zip(counts(), before)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(warm["loss"])] + [float(m["loss"]) for m in metrics]
    overflow = any(bool(m["overflow"]) for m in [warm] + metrics)
    expect = [L * gas] * 3 + [0] + [gas] * 3
    ok = (all(step == expect for step in per_step) and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and not overflow)
    step_s = seconds / TRAIN_STEPS
    tok_s = B * S / step_s
    n_params = L * 12 * 768 * 768 + 50304 * 768 + S * 768  # bench.py:219-221
    bench_flops = 6 * n_params + L * 12 * S * 768
    result = {
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
        "tflops_model": tok_s * model.flops_per_token() / 1e12, "tflops_bench_formula": tok_s * bench_flops / 1e12,
        "peak_gib": peak, "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in [warm] + metrics],
        "overflow": overflow, "launches_per_train_batch": per_step[0],
    }
    print(f"  fused loss + dots_and_flash remat, train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): "
          f"{result['step_ms']:.1f} ms/step, {tok_s:.0f} tokens/s, {result['tflops_model']:.1f} TFLOP/s "
          f"(Model.flops_per_token), {result['tflops_bench_formula']:.1f} TFLOP/s (bench.py formula), "
          f"peak {peak:.2f} GiB")
    print(f"  launches per train_batch [flash fwd, dK/dV, dQ, decode, xent fwd, dH, dW] {per_step} "
          f"(expect {expect}); losses {[round(x, 4) for x in losses]}; overflow {overflow}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused-loss remat training phase failed its checks")

    # nothing_saveable recomputes every layer, the flash forward included
    engine.model.config = engine.model.config.replace(remat_policy="nothing_saveable")
    before = counts()
    m = engine.train_batch(batch)
    step = [a - b for a, b in zip(counts(), before)]
    engine.model.config = engine.model.config.replace(remat_policy="dots_and_flash")
    expect_ns = [2 * L * gas, L * gas, L * gas, 0] + [gas] * 3
    ok = step == expect_ns and np.isfinite(float(m["loss"])) and not bool(m["overflow"])
    print(f"  one train_batch under nothing_saveable: launches {step} (expect {expect_ns}), "
          f"loss {float(m['loss']):.4f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("nothing_saveable did not recompute the flash forward")
    result["launches_per_train_batch_nothing_saveable"] = step
    return [launches[4], launches[5], launches[6]], result, engine, batch


def fused_parity(dev):
    """Phase 11: the slice through the fused loss against the chunked loss."""
    tiny = TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=64,
                             attn_impl="flash", remat=True, remat_policy="dots_and_flash")
    params = tfm.init(tiny, torch.Generator().manual_seed(0), dev)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 1000000}
    batch = {"tokens": np.random.default_rng(2).integers(0, 97, size=(4, 129)).astype(np.int32)}
    traj = {}
    for impl in ("fused_xent", "chunked"):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(tiny.replace(loss_impl=impl)), config=ds,
                                                      model_parameters=params)
        traj[impl] = [float(eng.train_batch(batch)["loss"]) for _ in range(5)]
    # fp32: the fused kernels and the chunked loss differ in summation order only
    small_err = max(abs(a - b) / abs(b) for a, b in zip(traj["fused_xent"], traj["chunked"]))
    ok = small_err <= 1e-4
    print(f"  small fp32 model, 5 steps: fused {[round(x, 5) for x in traj['fused_xent']]} vs chunked "
          f"{[round(x, 5) for x in traj['chunked']]}, max rel err {small_err:.2e} (tol 1e-4)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the small model's fused loss differs from the chunked loss")

    cfg = gpt2_config(remat=True, remat_policy="dots_and_flash")
    params = tfm.init(cfg, torch.Generator().manual_seed(1), dev)
    ds8 = dict(BENCH_DS, train_batch_size=8, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=1)
    batch = {"tokens": np.random.default_rng(3).integers(0, 50304, size=(8, FS + 1)).astype(np.int32)}
    first = {}
    for impl in ("fused_xent", "chunked"):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(cfg.replace(loss_impl=impl)), config=ds8,
                                                      model_parameters=params)
        m = eng.train_batch(batch)
        first[impl] = (float(m["loss"]), float(m["grad_norm"]))
        del eng, m
        torch.cuda.empty_cache()
    # bf16: the chunked loss rounds the logits to bf16 before its fp32
    # log-sum-exp where the fused kernels keep the fp32 accumulators
    loss_err = abs(first["fused_xent"][0] - first["chunked"][0]) / abs(first["chunked"][0])
    gnorm_err = abs(first["fused_xent"][1] - first["chunked"][1]) / abs(first["chunked"][1])
    ok = loss_err <= 1e-2 and gnorm_err <= 5e-2 and all(np.isfinite(first["fused_xent"]))
    print(f"  full width bf16, first train_batch (8 rows, gas 1): loss {first['fused_xent'][0]:.5f} vs "
          f"{first['chunked'][0]:.5f} (rel {loss_err:.2e}, tol 1e-2), grad norm {first['fused_xent'][1]:.5f} vs "
          f"{first['chunked'][1]:.5f} (rel {gnorm_err:.2e}, tol 5e-2)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the full-width step through the fused loss disagrees with the chunked loss")
    return {"small_fp32_max_rel_err": small_err, "full_width_loss_rel_err": loss_err,
            "full_width_grad_norm_rel_err": gnorm_err}


def checkpoint_resume(dev, trainer, batch):
    """Phase 12: resume is bitwise on a small model with dropout; a
    full-width round trip of ``trainer`` into a fresh engine."""
    small = TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=64,
                              dtype=torch.bfloat16, attn_impl="flash", hidden_dropout=0.1, attn_dropout=0.1,
                              **FUSED)
    params = tfm.init(small, torch.Generator().manual_seed(6), dev)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "bf16": {"enabled": True}, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "seed": 9,
          "gradient_clipping": 1.0, "steps_per_print": 1000000}
    tokens = {"tokens": np.random.default_rng(7).integers(0, 97, size=(4, 129)).astype(np.int32)}

    def engine(p=params):
        return deepspeed_tpu_torch.initialize(model=Model(small), config=ds, model_parameters=p)[0]

    root = tempfile.mkdtemp(prefix="dstt_ckpt_")
    try:
        straight = engine()
        ref = [float(straight.train_batch(tokens)["loss"]) for _ in range(5)]
        first = engine()
        got = [float(first.train_batch(tokens)["loss"]) for _ in range(2)]
        first.save_checkpoint(os.path.join(root, "small"))
        second = engine(tfm.init(small, torch.Generator().manual_seed(99), dev))
        second.load_checkpoint(os.path.join(root, "small"))
        got += [float(second.train_batch(tokens)["loss"]) for _ in range(3)]
        ok = got == ref
        print(f"  small bf16 model with dropout, train 2 + save + load + train 3: {got}; 5 straight: {ref}; "
              f"max abs diff {max(abs(a - b) for a, b in zip(got, ref)):.3e} (bitwise expected)  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("resume from a checkpoint did not reproduce the uninterrupted run")

        full = os.path.join(root, "full")
        t0 = time.perf_counter()
        trainer.save_checkpoint(full)
        save_s = time.perf_counter() - t0
        tag_dir = os.path.join(full, f"global_step{trainer.global_steps}")
        nbytes = sum(os.path.getsize(os.path.join(tag_dir, f)) for f in os.listdir(tag_dir))
        fresh = deepspeed_tpu_torch.initialize(model=Model(gpt2_config(**FUSED)), config=BENCH_DS)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_checkpoint(full)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a = float(trainer.train_batch(batch)["loss"])
        b = float(fresh.train_batch(batch)["loss"])
        ok = a == b and np.isfinite(a)
        print(f"  full width: save {save_s:.2f} s ({nbytes / 2**30:.3f} GiB in {len(os.listdir(tag_dir))} files), "
              f"load into a fresh engine {load_s:.2f} s; next step loss {b:.6f} vs uninterrupted {a:.6f} "
              f"(bitwise expected)  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the full-width engine restored from a checkpoint diverged")
        del fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"small_resume_losses": got, "full_save_s": save_s, "full_load_s": load_s, "full_bytes": nbytes,
            "full_next_loss": b}


def serve(dev):
    cfg = TransformerConfig(vocab_size=50304, max_seq_len=1024, num_layers=12, num_heads=12,
                            hidden_size=768, pos_emb="learned", tie_embeddings=True)
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
    torch.cuda.synchronize()
    print(f"  init_inference: {time.perf_counter() - t0:.2f} s on {engine.device}")
    cfg = engine.cfg
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, PROMPT_LEN)).astype(np.int32)
    expect = cfg.num_layers * (MAX_NEW - 1)
    engine.generate(prompt, max_new_tokens=2)  # warm-up: library handles, allocator

    results = {}
    for name, kw in (("greedy", {}), ("sampled", {"temperature": 0.8, "top_k": 50, "top_p": 0.9})):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        decode_attention.launches = 0
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_new_tokens=MAX_NEW, **kw)
        seconds = time.perf_counter() - t0
        launches = decode_attention.launches
        ok = (out.shape == (B, MAX_NEW) and out.dtype == np.int32
              and (out >= 0).all() and (out < cfg.vocab_size).all() and launches == expect)
        print(f"  generate {name}: {out.shape} in {seconds:.3f} s, kernel launches {launches} "
              f"(expect {cfg.num_layers} x {MAX_NEW - 1} = {expect}), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"generate {name} failed its checks")
        results[name] = {"seconds": seconds, "launches": launches,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    # prefill alone, to split generate's time into prefill and decode
    prompt_t = torch.from_numpy(prompt).long().to(dev)
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, B, SMAX, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tfm.apply_with_cache(cfg, engine.params, prompt_t, cache, 0, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0

        # first decode step: kernel path vs the plain cached-attention path
        tok = logits[:, -1].argmax(-1)[:, None]
        cache_plain = {kv: t.clone() for kv, t in cache.items()}
        lk, _ = tfm.apply_with_cache(cfg, engine.params, tok, cache, PROMPT_LEN)
        lx, _ = tfm.apply_with_cache(cfg.replace(decode_attn="xla"), engine.params, tok,
                                     cache_plain, PROMPT_LEN)
        err = (lk - lx).abs().max().item()
        agree = (lk.argmax(-1) == lx.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(lk).all()) and lk.shape == (B, 1, cfg.vocab_size) and err <= LOGITS_TOL
    print(f"  first decode step logits, kernel vs plain path: max_abs_err={err:.3e} "
          f"(|logits| max {lk.abs().max().item():.2f}), argmax agreement {agree:.3f}, "
          f"tol={LOGITS_TOL}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the kernel path's logits disagree with the plain path's")

    # small input, fp32: greedy tokens through the kernel equal the plain path's
    tiny = TransformerConfig(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)
    small_prompt = np.random.default_rng(1).integers(0, 97, size=(4, 21)).astype(np.int32)
    small = {mode: deepspeed_tpu_torch.init_inference(
        Model(tiny.replace(decode_attn=mode)), config={"dtype": "fp32"}).generate(
            small_prompt, max_new_tokens=32) for mode in ("kernel", "xla")}
    ok = np.array_equal(small["kernel"], small["xla"])
    print(f"  small fp32 model, greedy generate(32): kernel path tokens == plain path tokens: {ok}")
    if not ok:
        raise SystemExit("greedy tokens through the kernel differ from the plain path's")

    g = results["greedy"]
    decode_s = g["seconds"] - prefill_s
    e2e = {"prefill_s": prefill_s, "generate_s": g["seconds"],
           "decode_ms_per_step": decode_s / (MAX_NEW - 1) * 1e3,
           "tokens_per_s": B * MAX_NEW / g["seconds"],
           "decode_tokens_per_s": B * (MAX_NEW - 1) / decode_s,
           "sampled_generate_s": results["sampled"]["seconds"],
           "peak_gib": g["peak_gib"], "logits_max_abs_err_kernel_vs_plain": err}
    print(f"  greedy: prefill {prefill_s*1e3:.1f} ms, decode {e2e['decode_ms_per_step']:.3f} ms/step "
          f"({e2e['decode_tokens_per_s']:.0f} tokens/s over {B} rows), "
          f"{e2e['tokens_per_s']:.0f} tokens/s end to end")
    print(json.dumps({"serving": e2e}))
    return g["launches"], engine, prompt


def profile(label, fn, out_dir):
    """Trace ``fn`` with torch.profiler: device busy share of the wall time
    and device time by kernel name. Writes the Chrome trace into ``out_dir``."""
    import os

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"  profile {label}: the profiler recorded no device events; device time not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    print(f"  profile {label}: wall {wall_us/1e3:.1f} ms, device busy "
          f"{busy/1e3:.1f} ms ({busy/wall_us:.1%}), {len(kernels)} kernel launches")
    for name, us in top:
        print(f"    {us/1e3:9.3f} ms  {us/busy:6.1%}  {name[:100]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label.split('(')[0]}_trace.json"))
    print(json.dumps({"profile": {"label": label, "wall_ms": wall_us / 1e3,
                                  "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
                                  "kernel_launches": len(kernels),
                                  "top_ms": {n[:80]: us / 1e3 for n, us in top}}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace a short generate and a train_batch into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # full-fp32 matmuls in the plain versions the kernel is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    op_builder.build_many(KERNEL_SOURCES)
    op_builder.load("decode_attention")
    print(f"[2] built {', '.join(KERNEL_SOURCES)} (one nvcc each, in parallel) in "
          f"{time.perf_counter() - t0:.2f} s")

    print("[3] decode_attention kernel vs plain")
    errs = kernel_checks(dev)
    times = kernel_timing(dev)

    print("[4] serving: init_inference -> generate at GPT-2-125M width")
    launches, engine, prompt = serve(dev)
    if args.profile:
        profile(f"generate(max_new_tokens={PROFILE_NEW})",
                lambda: engine.generate(prompt, max_new_tokens=PROFILE_NEW), args.profile)
    del engine
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    op_builder.load("flash_attention")
    print(f"[5] loaded flash_attention (forward, dK/dV, dQ) in {time.perf_counter() - t0:.2f} s")

    print("[6] flash kernels vs plain")
    flash_errs = flash_checks(dev)
    flash_times = flash_timing(dev)
    torch.cuda.empty_cache()

    print("[7] training: initialize -> train_batch at GPT-2-125M width")
    flash_launches, training, trainer, batch = train(dev)
    if args.profile:
        profile("train_batch", lambda: trainer.train_batch(batch), args.profile)
    del trainer
    torch.cuda.empty_cache()

    print("[8] slice parity: flash kernels vs plain attention")
    training["parity"] = train_parity(dev)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    op_builder.load("fused_xent")
    print(f"[9] loaded fused_xent (forward, dH, dW) in {time.perf_counter() - t0:.2f} s; fused-loss kernels vs plain")
    xent_errs = xent_checks(dev)
    xent_times = xent_timing(dev)
    torch.cuda.empty_cache()

    print("[10] training: the fused loss under dots_and_flash remat at GPT-2-125M width")
    xent_launches, training["fused_remat"], trainer, batch = train_fused(dev)
    if args.profile:
        profile("train_batch_fused_remat", lambda: trainer.train_batch(batch), args.profile)

    print("[11] slice parity: the fused loss vs the chunked loss")
    training["fused_remat"]["parity"] = fused_parity(dev)
    torch.cuda.empty_cache()

    print("[12] checkpoint and resume")
    training["checkpoint"] = checkpoint_resume(dev, trainer, batch)
    del trainer
    torch.cuda.empty_cache()

    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:54",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
        "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
    }]
    replaces = {"flash_forward": "deepspeed_tpu/ops/pallas/flash_attention.py:182",
                "flash_backward_dkdv": "deepspeed_tpu/ops/pallas/flash_attention.py:282",
                "flash_backward_dq": "deepspeed_tpu/ops/pallas/flash_attention.py:335"}
    for (name, where), n in zip(replaces.items(), flash_launches):
        t, e = flash_times[name], flash_errs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
            "replaces": where, "launches": n,
            "max_abs_err": e[torch.bfloat16][0], "max_abs_err_fp32": e[torch.float32][0],
            "max_abs_err_fp16": e[torch.float16][0],
            "max_rel_err": e[torch.bfloat16][1], "max_rel_err_fp32": e[torch.float32][1],
            "max_rel_err_fp16": e[torch.float16][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    replaces = {"fused_xent_forward": "deepspeed_tpu/ops/pallas/fused_xent.py:73",
                "fused_xent_backward_dh": "deepspeed_tpu/ops/pallas/fused_xent.py:171",
                "fused_xent_backward_dw": "deepspeed_tpu/ops/pallas/fused_xent.py:193"}
    for (name, where), n in zip(replaces.items(), xent_launches):
        t, e = xent_times[name], xent_errs[name]
        second = "lse_max_abs_err" if name == "fused_xent_forward" else "max_rel_err"  # what e[dtype][1] holds
        kernels.append({
            "name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/fused_xent.cu",
            "replaces": where, "launches": n,
            "max_abs_err": e[torch.bfloat16][0], "max_abs_err_fp32": e[torch.float32][0],
            "max_abs_err_fp16": e[torch.float16][0],
            second: e[torch.bfloat16][1], f"{second}_fp32": e[torch.float32][1],
            f"{second}_fp16": e[torch.float16][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "cublas_logits_ms": t["cublas_logits_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"training": training}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
