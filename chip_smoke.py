#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or makes the script exit non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from deepspeed_tpu_torch/csrc, one nvcc per source,
     all started together;
  3. print the split-KV decode kernels' registers and spills from the
     build; hold them against their plain PyTorch version at the serving
     shape (B=8, Smax=1024, H=12, D=64; bf16 and fp32; per-row and scalar
     pos; with and without ALiBi; plus D=128, D=8 and D=100, the per-element
     load path), at positions on the splits' edges (0, split - 1, split,
     Smax - 1, past the end) and with rows ending in different splits, and
     check that a negative pos writes zeros; then time the kernels, the
     plain version and torch's scaled_dot_product_attention (a yardstick the
     port never calls) against the HBM bound;
  4. init_inference -> generate at GPT-2-125M width (12 layers, d768, 12
     heads, vocab 50304, max_seq_len 1024, bf16, random weights from a
     seeded torch.Generator): 8 prompts of 768 tokens, 256 new tokens,
     greedy and sampled, checking that every decode step of every layer
     went through the split and combine kernels, that the first decode
     step's logits agree with the plain cached-attention path, and that on
     a small fp32 model greedy tokens through the kernels equal the plain
     path's;
  5. load the flash-attention kernels (forward, dK/dV, dQ); count each
     kernel's HGMMA (wgmma) instructions in its SASS (cuobjdump) beside its
     registers and spills from the build, failing if the bf16 forward, dK/dV
     or dQ kernel has none; the same for the fused-loss backward's mainloop
     (csrc/fused_xent.cu: its ds, dW and dH instances), failing if one that
     the main path runs has none;
  6. hold each flash kernel against its plain version: bf16, fp32 and fp16;
     causal, bidirectional, ALiBi, window 256 and window 0 at B=8, S=1024,
     H=12, D=64; the ragged causal edge S=1000; S=128; D=128. Then time
     each kernel, its plain version and torch's scaled_dot_product_attention
     (a yardstick the port never calls) against the bound at that shape,
     with each kernel's ratio to SDPA (the backward kernels' also to SDPA's
     forward+backward less its forward);
  7. initialize -> train_batch at GPT-2-125M width (the model bench.py
     times: 12 layers, d768, 12 heads, vocab 50304, S=1024, bf16, flash
     attention, loss chunk 256, AdamW, clipping 1.0, ZeRO stage 1, batch 64
     = micro 16 x gas 4): one warm-up step and five timed steps, checking
     48 = 12 x 4 launches of each flash kernel per train_batch, a finite
     falling loss and no overflow;
  8. slice parity: five fp32 steps of a small model through the kernels and
     through plain attention give the same losses, and at full width in
     bf16 the first step's loss and grad norm agree on an 8-row batch;
  9. hold the fused-loss forward and backward (dH and dW: per vocab chunk a
     ds pass, a dW product and a dH product) against their plain versions
     at the training shape (N = 16 x 1024 rows, D = 768, V = 50304, bf16,
     one row in seven ignored, the head as wte.t()), and in fp32 and fp16 at
     N = 2048, and at V = 50257, V = 777, one column past a backward chunk
     and D = 770; two backward calls must give bitwise-equal dH and dW. Then
     time the forward, the whole backward against the pair's bound, each
     backward kernel alone over every chunk in order, the plain versions
     and, as a reference point only, the cuBLAS logits product of the
     chunked loss;
 10. train through the fused loss under remat at GPT-2-125M width: phase 7's
     configuration with loss_impl="fused_xent", remat=True,
     remat_policy="dots_and_flash", one warm-up and five timed steps,
     checking 48 launches of each flash kernel, 4 of the fused-loss forward
     and 4 x 7 (vocab chunks) of each backward kernel per train_batch, then
     one step under nothing_saveable with 96 flash-forward launches;
 11. slice parity: five fp32 steps of a small model with the fused loss and
     with the chunked loss give the same losses, and at full width in bf16
     the first step's loss and grad norm agree;
 12. checkpoint and resume: a small bf16 model with dropout trained 2 steps,
     saved, loaded into a fresh engine and trained 3 more gives the losses of
     5 uninterrupted steps bitwise; at full width one save/load round trip
     into a fresh engine (seconds, bytes) and one step whose loss equals the
     uninterrupted engine's;
 13. load the block-sparse attention kernels (forward, dQ, dK/dV);
 14. hold each sparse kernel against its plain version: fixed, bigbird,
     bslongformer, variable and dense layouts at blocks 16, 32, 64 and 128,
     causal and bidirectional, bf16, fp16 and fp32, D = 64 (and 128), a
     layout with a key block no query attends (dK = dV = 0 exactly), and the
     main path's shape (B=2, S=8192, H=12, D=64, bf16, fixed-64). Then time
     each kernel, its plain version, SDPA with the layout as a boolean mask
     (a yardstick the port never calls) and the port's dense flash kernels
     at that shape, for the slice's fixed-64 layout and the bigbird-128
     layout of benchmarks/sparse_attention_bench.py;
 15. long-sequence training: initialize -> train_batch at GPT-2-125M width
     with max_seq_len 8192 and the DeepSpeed sparse_attention block (fixed,
     block 64, 4 local blocks, 1 global, unidirectional), batch 8 = micro 2
     x gas 4: one warm-up and five timed steps, checking 48 = 12 x 4
     launches of each sparse kernel and none of the flash kernels per
     train_batch and a finite falling loss; beside it the same model with
     dense flash attention at S = 8192;
 16. slice parity: five fp32 steps of a small sparse model through the
     kernels and through the plain versions give the same losses, and at
     full width in bf16 the first step's loss and grad norm agree on one
     8192-token row;
 17. the curriculum and the dataloader: initialize(training_data=...) over
     seeded tokens with the fixed_discrete seqlen curriculum [2048, 4096,
     8192] at steps [1, 2]; each step's length follows the schedule with
     its own cached lists; train 2 + save + fresh engine and loader + load
     + train 3 gives the uninterrupted run's losses bitwise and resumes at
     the same difficulty and loader cursor.
It prints a ``{"kernels": [...]}`` line, a ``{"training": {...}}`` line,
then as its last line ``{"ok": true, "device": {...}}``. Without a GPU it
exits 1 and prints no result.

    python3 chip_smoke.py --profile chiprun_out/profile

also traces one generate(max_new_tokens=64), one train_batch of phases 7,
10 and 15 with torch.profiler and prints the device's busy share, its time
by kernel and the host's top ops by self time; and times phase 10's model
without remat beside it, which shows what remat's recompute costs the step.
"""

import argparse
import json
import os
import re
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
from deepspeed_tpu_torch.ops.decode_attention import SPLIT_KEYS, decode_attention, decode_attention_reference
from deepspeed_tpu_torch.ops.optimizers import tree_map
from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (the kernel's math)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
KERNEL_SOURCES = ("decode_attention", "flash_attention", "fused_xent", "sparse_attention")
FLASH_COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
XENT_COUNTERS = (fx.fused_xent_forward, fx.xent_ds_pass, fx.xent_dw_pass, fx.xent_dh_pass)
SPARSE_COUNTERS = (sk.sparse_forward, sk.sparse_backward_dq, sk.sparse_backward_dkdv)
SPARSE_NAMES = ("sparse_forward", "sparse_backward_dq", "sparse_backward_dkdv")
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


# GPU clock cycles of a spin enqueued before each timed call (~0.5-1 ms):
# longer than any wrapper's host enqueue, so the events time the device
HOST_COVER_CYCLES = 1_000_000


def median_ms(fn, flush, runs=100, warmup=10):
    """Median device time of ``fn`` over ``runs`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2) so every run reads the
    cache cold, as each layer of a decode step does. A spin kernel after the
    flush keeps the device busy while the host enqueues ``fn``, so the time
    between the events is the device's even where the host is slow."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_checks(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(dtype, d, pos, alibi, label_pos=None):
        q = torch.randn(B, H, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, SMAX, H, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, SMAX, H, d, generator=gen, device=dev).to(dtype)
        slopes = tfm.alibi_slopes(H, dev) if alibi else None
        out = decode_attention(q, k, v, pos, alibi_slopes=slopes)
        torch.cuda.synchronize()
        ref = decode_attention_reference(q, k, v, pos, alibi_slopes=slopes)
        # a negative position attends to nothing: the kernels write zeros
        # there (the plain version averages every masked key, as the JAX
        # package's does)
        dead = (torch.as_tensor(pos, device=dev).expand(B) < 0)[:, None, None]
        ref = torch.where(dead, torch.zeros_like(ref), ref)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
        label = f"{str(dtype)[6:]} D={d} pos={label_pos or ('rows' if torch.is_tensor(pos) else pos)} alibi={alibi}"
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
    for dtype in (torch.bfloat16, torch.float32):
        errs[dtype] = max(errs[dtype], case(dtype, 100, pos_rows, True))  # 16-byte loads cannot read its rows
        # the splits' edges: the first key, a split's last and the next one's
        # first, the cache's last key, and past it (clamped)
        for pos in (0, SPLIT_KEYS - 1, SPLIT_KEYS, SMAX - 1, SMAX + 5):
            errs[dtype] = max(errs[dtype], case(dtype, D, pos, False))
        rows = torch.tensor([SPLIT_KEYS - 1, SPLIT_KEYS, 2 * SPLIT_KEYS + 3, -1, 5, SMAX - 1, 3 * SPLIT_KEYS - 1,
                             -7], dtype=torch.int32, device=dev)  # rows ending in different splits, two negative
        errs[dtype] = max(errs[dtype], case(dtype, D, rows, True, label_pos="split rows"))
        errs[dtype] = max(errs[dtype], case(dtype, D, -1, False))
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
    times["library_ratio"] = times["ms"] / times["library_ms"]
    # calls back to back: the host's cost of one call wherever it exceeds the
    # device's (the decode step is host-bound)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    times["back_to_back_us"] = (time.perf_counter() - t0) / 200 * 1e6
    live_keys = int((pos.long() + 1).clamp(max=SMAX).sum())
    elt = q.element_size()
    nbytes = 2 * live_keys * H * D * elt + 2 * B * H * D * elt + B * 4  # k,v live prefix; q, out; pos
    flops = 4 * live_keys * H * D  # q·k and p·v, a multiply and an add each
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    times["bound_ms"] = max(bytes_ms, ops_ms)
    times["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  timing bf16 B={B} Smax={SMAX} H={H} D={D} pos=1023 (L2 flushed per run): "
          f"kernels (split + combine) {times['ms']*1e3:.1f} us ({times['library_ratio']:.2f}x sdpa, "
          f"{nbytes / (times['ms'] * 1e-3) / 1e9:.0f} GB/s), plain {times['plain_ms']*1e3:.1f} us, "
          f"sdpa {times['library_ms']*1e3:.1f} us (max_abs_err vs plain {lib_err:.2e}), "
          f"bound {times['bound_ms']*1e3:.2f} us ({nbytes/1e6:.1f} MB / 3.35 TB/s); wrapper calls back to back "
          f"{times['back_to_back_us']:.1f} us each")
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
    bwd_by_difference = fwd_bwd_lib - times["flash_forward"]["library_ms"]
    for name, (bound, by, nbytes, flops) in flash_bounds(B, S, H, D, 2).items():
        times[name].update(bound_ms=bound, bound_by=by, library_ratio=times[name]["ms"] / times[name]["library_ms"])
        t = times[name]
        also = ""
        if name != "flash_forward":
            t["library_fwd_bwd_less_fwd_ms"] = bwd_by_difference
            t["library_fwd_bwd_less_fwd_ratio"] = t["ms"] / bwd_by_difference
            also = f", {t['library_fwd_bwd_less_fwd_ratio']:.2f}x its fwd+bwd less fwd"
        print(f"  timing {name:<20} bf16 B={B} S={S} H={H} D={D} causal: kernel {t['ms']*1e3:8.1f} us "
              f"({t['library_ratio']:.2f}x sdpa{also}), plain {t['plain_ms']*1e3:8.1f} us, sdpa "
              f"{t['library_ms']*1e3:7.1f} us, bound {bound*1e3:5.1f} us ({by}: {nbytes/1e6:.1f} MB, "
              f"{flops/1e9:.1f} GFLOP), {flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"  sdpa forward+backward {fwd_bwd_lib*1e3:.1f} us, less its forward "
          f"{bwd_by_difference*1e3:.1f} us (its backward alone, timed on a "
          f"retained graph, is the library time of both backward rows); sdpa vs kernel output max_abs_err "
          f"{lib_err:.2e}; plain backward times all three gradients")
    return times


# The flash library's kernels, read from the SASS and from the build.
FLASH_KERNELS = ("flash_fwd_hopper", "flash_dkdv_hopper", "flash_dq_hopper", "flash_fwd_f32_kernel",
                 "flash_dkdv_f32_kernel", "flash_dq_f32_kernel")
# the entry point -> the kernel that runs it at the main path's shape (bf16, D = 64)
MAIN_PATH_KERNEL = {"flash_forward": "flash_fwd_hopper bf16 D64",
                    "flash_backward_dkdv": "flash_dkdv_hopper bf16 D64",
                    "flash_backward_dq": "flash_dq_hopper bf16 D64"}


def kernel_label(mangled):
    """'flash_fwd_hopper bf16 D64' from a mangled template instance, else None."""
    base = next((k for k in FLASH_KERNELS if k in mangled), None)
    if base is None:
        return None
    tail = mangled.split(base, 1)[1]
    dtype = "bf16" if "nv_bfloat16" in tail else "fp16" if "__half" in tail else "fp32"
    dp = re.search(r"Li(\d+)E", tail)  # the first int template argument: the padded head dim
    dp = dp.group(1) if dp else "?"
    return f"{base} {dtype} D{dp}"


def cuobjdump():
    """The CUDA toolkit's cuobjdump, else the copy that Triton's package carries."""
    found = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                      "cuobjdump")
    if os.path.exists(found):
        return found
    import importlib.util
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin", "cuobjdump")
        if os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found: neither the CUDA toolkit nor triton carries it")


def ptxas_report(source, label):
    """{label: registers and spill bytes} of each kernel of csrc/<source>.cu
    that ``label`` names, from ptxas's report of this run's build."""
    info, fn = {}, None
    for line in op_builder.PTXAS_INFO.get(source, []):
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = label(line)
            if fn:
                info.setdefault(fn, {"registers": None, "spill_stores": None, "spill_loads": None})
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()
            info[fn]["spill_stores"] = int(words[words.index("spill") - 2])
            info[fn]["spill_loads"] = int(words[-4])
        elif fn and "Used" in line and "registers" in line:
            words = line.split()
            info[fn]["registers"] = int(words[words.index("Used") + 1])
    return info


def decode_label(text):
    """'decode_split_kernel bf16 W8 G8 NV1' (16-byte loads of 8 elements, 8
    lanes a row, one load a lane) or 'decode_combine_kernel bf16' from a
    mangled template instance, else None."""
    m = re.search(r"decode_(split|combine)_kernelI(13__nv_bfloat16|f)((?:Li\d+E)*)E", text)
    if m is None:
        return None
    args = "".join(f" {k}{v}" for k, v in zip(("W", "G", "NV"), re.findall(r"Li(\d+)E", m.group(3))))
    return f"decode_{m.group(1)}_kernel {'fp32' if m.group(2) == 'f' else 'bf16'}{args}"


# the decode kernels that run at the serving shape (bf16, D = 64)
DECODE_MAIN_PATH = ("decode_split_kernel bf16 W8 G8 NV1", "decode_combine_kernel bf16")


def decode_registers():
    """Print the decode kernels' registers and spills from the build; return
    those of the serving shape's instances."""
    info = ptxas_report("decode_attention", decode_label)
    for name, v in sorted(info.items()):
        print(f"  {name:<36} registers {v['registers']}  spill stores {v['spill_stores']} B, "
              f"loads {v['spill_loads']} B")
    return {name: info.get(name, {}) for name in DECODE_MAIN_PATH}


def sass_report(source, label, main_path):
    """Per kernel of csrc/<source>.cu that ``label`` names: HGMMA instructions
    in its SASS, and its registers and spill bytes from ptxas's report of
    this run's build. Fails if a kernel of ``main_path`` has no HGMMA."""
    lib = op_builder.build_many([source])[source]
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    info, fn = ptxas_report(source, label), None
    for v in info.values():
        v["hgmma"] = 0
    for line in sass.splitlines():
        if "Function :" in line:
            fn = label(line.split("Function :", 1)[1].strip())
            if fn:
                info.setdefault(fn, {"registers": None, "spill_stores": None, "spill_loads": None, "hgmma": 0})
        elif fn and "HGMMA" in line:
            info[fn]["hgmma"] += 1
    for name, v in sorted(info.items()):
        print(f"  {name:<36} HGMMA {v['hgmma']:4d}  registers {v['registers']}  spill stores "
              f"{v['spill_stores']} B, loads {v['spill_loads']} B")
    for name in main_path:
        if info.get(name, {}).get("hgmma", 0) == 0:
            raise SystemExit(f"{name} has no HGMMA instruction in its SASS")
    return info


# The fused-loss backward's kernels on the main path (bf16, the tied head
# wteᵀ): each pass of the mainloop, and which operand it reads MN-major.
XENT_MAIN_PATH = {"ds": "xent_gemm_hopper bf16 ds A:K B:K", "dW": "xent_gemm_hopper bf16 dW A:MN B:MN",
                  "dH": "xent_gemm_hopper bf16 dH A:K B:MN"}


def xent_label(mangled):
    """'xent_gemm_hopper bf16 dH A:K B:MN' (the epilogue, then how A and B are
    read) from a mangled instance of the fused-loss backward mainloop, else
    None."""
    m = re.search(r"xent_gemm_hopperI(13__nv_bfloat16|6__half)Lb([01])ELb([01])ENS_5(Ds|Dw|Dh)Out", mangled)
    if m is None:
        return None
    dtype = "bf16" if "bfloat16" in m.group(1) else "fp16"
    epilogue = {"Ds": "ds", "Dw": "dW", "Dh": "dH"}[m.group(4)]
    major = {"0": "K", "1": "MN"}
    return f"xent_gemm_hopper {dtype} {epilogue} A:{major[m.group(2)]} B:{major[m.group(3)]}"


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
    phase 10 with bench.py's fused loss and dots_and_flash remat, phases
    15-17 with max_seq_len 8192."""
    base = dict(vocab_size=50304, max_seq_len=FS, num_layers=12, num_heads=12, hidden_size=768,
                pos_emb="learned", tie_embeddings=True, dtype=torch.bfloat16, attn_impl="flash",
                loss_chunk_size=256)
    return TransformerConfig(**{**base, **kw})


def counts():
    return [c.launches for c in FLASH_COUNTERS] + [decode_attention.launches] + [c.launches for c in XENT_COUNTERS]


N_COUNTS = 8  # len(counts()); sparse_counts() follow it in a step's launches
COUNT_LABEL = "[flash fwd, dK/dV, dQ, decode, xent fwd, ds, dW, dH, sparse fwd, dQ, dK/dV]"


def sparse_counts():
    return [c.launches for c in SPARSE_COUNTERS]


def reset_counts():
    for c in FLASH_COUNTERS + XENT_COUNTERS + SPARSE_COUNTERS:
        c.launches = 0
    decode_attention.launches = decode_attention.combine_launches = 0


def timed_steps(engine, batch, steps):
    """One warm-up and ``steps`` timed train_batch calls -> (warm-up s,
    step s, metrics of every call, per-step [flash+decode+xent counts,
    sparse counts])."""
    t0 = time.perf_counter()
    warm = engine.train_batch(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, per_step = [warm], []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = counts() + sparse_counts()
        metrics.append(engine.train_batch(batch))
        per_step.append([a - b for a, b in zip(counts() + sparse_counts(), before)])
    torch.cuda.synchronize()
    return warm_s, (time.perf_counter() - t0) / steps, metrics, per_step


def train(dev):
    model = Model(gpt2_config())
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=BENCH_DS)
    torch.cuda.synchronize()
    print(f"  initialize: {time.perf_counter() - t0:.2f} s on {engine.device}")
    B, S, L = BENCH_DS["train_batch_size"], FS, model.config.num_layers
    gas = BENCH_DS["gradient_accumulation_steps"]
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, S + 1)).astype(np.int32)}
    warm_s, step_s, metrics, per_step = timed_steps(engine, batch, TRAIN_STEPS)
    launches = counts()
    losses = [float(m["loss"]) for m in metrics]
    overflow = any(bool(m["overflow"]) for m in metrics)
    expect = L * gas
    ok = (all(step == [expect] * 3 + [0] * 8 for step in per_step)
          and all(np.isfinite(losses)) and losses[-1] < losses[0] and not overflow)
    tok_s = B * S / step_s
    n_params = L * 12 * 768 * 768 + 50304 * 768 + S * 768  # bench.py:219-221
    bench_flops = 6 * n_params + L * 12 * S * 768
    result = {
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
        "tflops_model": tok_s * model.flops_per_token() / 1e12, "tflops_bench_formula": tok_s * bench_flops / 1e12,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
        "grad_norms": [float(m["grad_norm"]) for m in metrics], "overflow": overflow,
        "launches_per_train_batch": per_step[0][:3],
    }
    print(f"  train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): {result['step_ms']:.1f} ms/step, "
          f"{tok_s:.0f} tokens/s, {result['tflops_model']:.1f} TFLOP/s (Model.flops_per_token), "
          f"{result['tflops_bench_formula']:.1f} TFLOP/s (bench.py formula), peak {result['peak_gib']:.2f} GiB")
    print(f"  launches per train_batch {COUNT_LABEL} "
          f"{per_step} (expect {L} x {gas} = {expect} of each flash kernel, none of the others); "
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
    """One kernel-vs-plain check of the fused-loss kernels: the forward, and
    the backward (its three kernels over every vocab chunk) called twice,
    which must give bitwise-equal dH and dW; raises on a disagreement. The
    backward gets the plain forward's lse."""
    h, head, y, g = xent_inputs(dev, gen, N, D, V, dtype)
    nll, lse = fx.fused_xent_forward(h, head, y)
    ref_nll, ref_lse = fx.fused_linear_xent_reference(h, head, y)
    dh, dw = fx.fused_xent_backward(h, head, y, ref_lse, g)
    dh2, dw2 = fx.fused_xent_backward(h, head, y, ref_lse, g)
    torch.cuda.synchronize()
    bitwise = torch.equal(dh, dh2) and torch.equal(dw, dw2)
    del dh2, dw2
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
    ok = (finite and ignored_zero and bitwise and max(errs["fused_xent_forward"]) <= XENT_TOL
          and errs["fused_xent_backward_dh"][1] <= XENT_GRAD_TOL[dtype]
          and errs["fused_xent_backward_dw"][1] <= XENT_GRAD_TOL[dtype] and dw.stride() == head.stride())
    chunks = len(fx.vocab_chunks(V, fx.backward_chunk(N, V, h.element_size())))
    label = f"{str(dtype)[6:]} N={N} D={D} V={V} ({chunks} chunk{'s' if chunks > 1 else ''})"
    print(f"  fused xent vs plain  {label:<44} nll {errs['fused_xent_forward'][0]:.2e}, "
          f"lse {errs['fused_xent_forward'][1]:.2e} (tol {XENT_TOL:.0e}), dH {errs['fused_xent_backward_dh'][1]:.2e}, "
          f"dW {errs['fused_xent_backward_dw'][1]:.2e} (rel, tol {XENT_GRAD_TOL[dtype]:.0e}), ignored rows' dH 0: "
          f"{ignored_zero}, two calls bitwise: {bitwise}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"a fused-loss kernel disagrees with its plain version: {label}")
    return errs


def xent_checks(dev):
    """Every case of phase 9 -> {kernel: {dtype: (max abs err, second)}}, the
    second being the lse's abs error (forward) or the max rel error (dH, dW).
    Beyond the main path's shape: fp32 and fp16, a vocab that is not a
    multiple of 8 (50257) or of the tile (777), one column past a backward
    chunk (8193 at N = 16384, whose chunk is 8192), and a width that is not
    a multiple of 8 (770: TMA cannot read such rows, so hidden and the head
    go through padded copies)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {name: {} for name in ("fused_xent_forward", "fused_xent_backward_dh", "fused_xent_backward_dw")}
    cases = [(XN, XD, XV, torch.bfloat16), (2048, XD, XV, torch.float32), (2048, XD, XV, torch.float16),
             (2048, XD, 50257, torch.bfloat16), (2048, XD, 777, torch.bfloat16),
             (XN, XD, fx.backward_chunk(XN, XV, 2) + 1, torch.bfloat16), (2048, 770, XV, torch.bfloat16)]
    for N, D, V, dtype in cases:
        for name, e in xent_case(dev, gen, N, D, V, dtype).items():
            old = worst[name].get(dtype, (0.0, 0.0))
            worst[name][dtype] = tuple(max(x, y) for x, y in zip(old, e))
        torch.cuda.empty_cache()
    return worst


def xent_bounds(N, D, V, elt):
    """{name: (bound_ms, bound_by, bytes, flops)}: each input read once and
    each output written once. The logits take 2·N·D·V flops. The forward
    computes them once; the backward pair ("fused_xent_backward") once more
    and then its two products; each of the pair's rows alone
    ("..._dh", "..._dw") would compute them again before its own product."""
    hw = (N * D + D * V) * elt
    rows = N * 4
    work = {"fused_xent_forward": (hw + rows + 2 * rows, 2 * N * D * V),               # h, W, y -> nll, lse
            "fused_xent_backward": (hw + 3 * rows + (N * D + D * V) * elt, 6 * N * D * V),  # h, W, y, lse, g -> dH, dW
            "fused_xent_backward_dh": (hw + 3 * rows + N * D * elt, 4 * N * D * V),    # h, W, y, lse, g -> dH
            "fused_xent_backward_dw": (hw + 3 * rows + D * V * elt, 4 * N * D * V)}    # h, W, y, lse, g -> dW
    out = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)
    return out


def xent_timing(dev):
    """Times at the training shape, bf16: the forward kernel; the whole
    backward (dH and dW together: three kernels over each vocab chunk); each
    of its three kernels alone over every chunk in order; the plain
    versions; and, as a reference point only, the cuBLAS [N, D]·[D, V]
    product the chunked loss runs (not the same function; the port never
    calls it for this loss)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h, head, y, g = xent_inputs(dev, gen, XN, XD, XV, torch.bfloat16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    _, lse = fx.fused_xent_forward(h, head, y)
    plain_bwd = median_ms(lambda: fx.fused_linear_xent_backward_reference(h, head, y, lse, g), flush,
                          runs=5, warmup=1)
    backward_ms = median_ms(lambda: fx.fused_xent_backward(h, head, y, lse, g), flush, runs=10, warmup=2)
    chunk = fx.backward_chunk(XN, XV, 2)
    chunks = fx.vocab_chunks(XV, chunk)
    passes = {}
    for name, launch in zip(("ds", "dW", "dH"), fx.BACKWARD_PASSES):
        ms = median_ms(lambda: fx.fused_xent_backward(h, head, y, lse, g, passes=(launch,)), flush, runs=10,
                       warmup=2)
        passes[name] = {"kernel": XENT_MAIN_PATH[name], "ms": ms, "tflops": 2 * XN * XD * XV / (ms * 1e-3) / 1e12}
    cublas_ms = median_ms(lambda: h @ head, flush, runs=20, warmup=3)
    bounds = xent_bounds(XN, XD, XV, 2)
    pair_bound, pair_by, _, pair_flops = bounds["fused_xent_backward"]
    times = {"fused_xent_forward": {"ms": median_ms(lambda: fx.fused_xent_forward(h, head, y), flush, runs=10,
                                                   warmup=2),
                                    "plain_ms": median_ms(lambda: fx.fused_linear_xent_reference(h, head, y), flush,
                                                          runs=5, warmup=1)}}
    for name in ("fused_xent_backward_dh", "fused_xent_backward_dw"):
        # the pair's kernels carry both rows: each row gives the pair's time and bound
        times[name] = {"ms": backward_ms, "plain_ms": plain_bwd, "pair_bound_ms": pair_bound,
                       "row_bound_ms": bounds[name][0], "passes": passes, "chunks": len(chunks),
                       "chunk_width": chunk}
    t = times["fused_xent_forward"]
    bound, by, nbytes, flops = bounds["fused_xent_forward"]
    t.update(bound_ms=bound, bound_by=by, library_ms=None, cublas_logits_ms=cublas_ms)
    print(f"  timing fused_xent_forward  bf16 N={XN} D={XD} V={XV}: kernel {t['ms']:8.2f} ms, plain "
          f"{t['plain_ms']:8.2f} ms, bound {bound:.2f} ms ({by}: {nbytes/1e6:.1f} MB, {flops/1e12:.2f} TFLOP), "
          f"{flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    for name in ("fused_xent_backward_dh", "fused_xent_backward_dw"):
        times[name].update(bound_ms=pair_bound, bound_by=pair_by, library_ms=None, cublas_logits_ms=cublas_ms)
    print(f"  timing fused_xent_backward (dH and dW) bf16: {backward_ms:8.3f} ms for {len(chunks)} chunks of "
          f"{chunk} columns, plain {plain_bwd:8.2f} ms, pair bound {pair_bound:.2f} ms ({pair_by}: "
          f"{pair_flops/1e12:.2f} TFLOP), {pair_flops / (backward_ms * 1e-3) / 1e12:.1f} TFLOP/s; each row alone "
          f"{bounds['fused_xent_backward_dh'][0]:.2f} ms")
    for name, v in passes.items():
        print(f"    {v['kernel']:<36} alone over all {len(chunks)} chunks {v['ms']:.3f} ms, "
              f"{v['tflops']:.1f} TFLOP/s")
    print(f"    the three alone sum to {sum(v['ms'] for v in passes.values()):.3f} ms")
    print(f"  no single PyTorch call computes these functions (library: null); reference points only: the cuBLAS "
          f"logits product [N, D]·[D, V] bf16 {cublas_ms:.2f} ms, x 3 = {3 * cublas_ms:.2f} ms for the backward's "
          f"three products; the plain backward times dH and dW together")
    return times


FUSED = dict(loss_impl="fused_xent", remat=True, remat_policy="dots_and_flash")


def train_fused(dev, no_remat=False):
    """Phase 10: phase 7's step through the fused loss under dots_and_flash
    remat (bench.py's tuned configuration); with ``no_remat``, beside it the
    same model without remat."""
    model = Model(gpt2_config(**FUSED))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=BENCH_DS)
    B, S, L = BENCH_DS["train_batch_size"], FS, model.config.num_layers
    gas = BENCH_DS["gradient_accumulation_steps"]
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, S + 1)).astype(np.int32)}
    warm_s, step_s, metrics, per_step = timed_steps(engine, batch, TRAIN_STEPS)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    overflow = any(bool(m["overflow"]) for m in metrics)
    chunks = len(fx.vocab_chunks(50304, fx.backward_chunk(B // gas * S, 50304, 2)))
    expect = [L * gas] * 3 + [0] + [gas] + [gas * chunks] * 3 + [0] * 3
    ok = (all(step == expect for step in per_step) and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and not overflow)
    tok_s = B * S / step_s
    n_params = L * 12 * 768 * 768 + 50304 * 768 + S * 768  # bench.py:219-221
    bench_flops = 6 * n_params + L * 12 * S * 768
    result = {
        "warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
        "tflops_model": tok_s * model.flops_per_token() / 1e12, "tflops_bench_formula": tok_s * bench_flops / 1e12,
        "peak_gib": peak, "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in metrics],
        "overflow": overflow, "launches_per_train_batch": per_step[0],
    }
    print(f"  fused loss + dots_and_flash remat, train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): "
          f"{result['step_ms']:.1f} ms/step, {tok_s:.0f} tokens/s, {result['tflops_model']:.1f} TFLOP/s "
          f"(Model.flops_per_token), {result['tflops_bench_formula']:.1f} TFLOP/s (bench.py formula), "
          f"peak {peak:.2f} GiB")
    print(f"  launches per train_batch {COUNT_LABEL} {per_step} (expect {expect}: {gas} backward calls, "
          f"each {chunks} vocab chunks x 3 kernels); losses {[round(x, 4) for x in losses]}; overflow {overflow}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused-loss remat training phase failed its checks")

    # nothing_saveable recomputes every layer, the flash forward included
    engine.model.config = engine.model.config.replace(remat_policy="nothing_saveable")
    before = counts()
    m = engine.train_batch(batch)
    step = [a - b for a, b in zip(counts(), before)]
    engine.model.config = engine.model.config.replace(remat_policy="dots_and_flash")
    expect_ns = [2 * L * gas, L * gas, L * gas, 0, gas] + [gas * chunks] * 3
    ok = step == expect_ns and np.isfinite(float(m["loss"])) and not bool(m["overflow"])
    print(f"  one train_batch under nothing_saveable: launches {step} (expect {expect_ns}), "
          f"loss {float(m['loss']):.4f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("nothing_saveable did not recompute the flash forward")
    result["launches_per_train_batch_nothing_saveable"] = step
    result["backward_chunks"] = chunks

    if no_remat:
        result["no_remat"] = train_no_remat(batch, step_s)
    return launches[4:8], result, engine, batch


def train_no_remat(batch, remat_step_s):
    """Phase 10's model with the fused loss and no remat: what the recompute
    costs the step (a host diagnostic, run with ``--profile``)."""
    B, S = BENCH_DS["train_batch_size"], FS
    bare, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(gpt2_config(loss_impl="fused_xent")), config=BENCH_DS)
    _, bare_s, bare_metrics, _ = timed_steps(bare, batch, TRAIN_STEPS)
    bare_losses = [float(m["loss"]) for m in bare_metrics]
    result = {"step_ms": bare_s * 1e3, "tokens_per_s": B * S / bare_s,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": bare_losses}
    ok = all(np.isfinite(bare_losses))
    print(f"  beside it, the fused loss without remat: {bare_s * 1e3:.1f} ms/step, {B * S / bare_s:.0f} tokens/s, "
          f"peak {result['peak_gib']:.2f} GiB; remat adds {(remat_step_s - bare_s) * 1e3:.1f} ms a step  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused loss without remat gave a non-finite loss")
    del bare
    torch.cuda.empty_cache()
    return result


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


# ---------------------------------------------------------------------------
# Phases 13-17: block-sparse attention and long-sequence training
# ---------------------------------------------------------------------------

SS = 8192  # the long-sequence slice's length
SPARSE_BLOCK = {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
                "attention": "unidirectional"}  # the reference's default mode, in its own spelling
BIGBIRD_128 = ("bigbird", {"block": 128, "num_random_blocks": 2, "num_sliding_window_blocks": 3,
                           "num_global_blocks": 1})  # benchmarks/sparse_attention_bench.py:62-64
SPARSE_CHECK_LAYOUTS = {
    "fixed": {"num_local_blocks": 4, "num_global_blocks": 1},
    "bigbird": {"num_random_blocks": 1, "num_sliding_window_blocks": 3, "num_global_blocks": 1},
    "bslongformer": {"num_sliding_window_blocks": 3},
    "variable": {"local_window_blocks": [1, 2], "global_block_indices": [0], "num_random_blocks": 1},
    "dense": {},
}


def slice_layout(H=12):
    kw = {k: v for k, v in SPARSE_BLOCK.items() if k != "mode"}
    return SPARSITY_CONFIGS["fixed"](num_heads=H, **kw).make_layout(SS)


def sparse_case(dev, gen, dtype, layout, block, causal, B, H, D, label):
    """One kernel-vs-plain check of the three sparse kernels (the backward
    kernels get the plain forward's O and lse); raises on a disagreement.
    -> ({kernel: (max abs err, max rel err)}, dK, dV, lists)."""
    S = layout.shape[-1] * block
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype) for _ in range(4))
    lists = sk.device_lists(layout, causal, S, dev)
    kw = {"causal": causal}
    out, lse = sk.sparse_forward(q, k, v, lists, **kw)
    ref_out, ref_lse = sk.sparse_attention_reference(q, k, v, lists, **kw)
    delta = fa.flash_delta(ref_out, dout)
    dq = sk.sparse_backward_dq(q, k, v, dout, ref_lse, delta, lists, **kw)
    dk, dv = sk.sparse_backward_dkdv(q, k, v, dout, ref_lse, delta, lists, **kw)
    torch.cuda.synchronize()
    ref_dq, ref_dk, ref_dv = sk.sparse_attention_backward_reference(q, k, v, ref_out, ref_lse, dout, lists, **kw)

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def rel_err(a, b):
        return abs_err(a, b) / max(b.float().abs().max().item(), 1e-6)

    errs = {"sparse_forward": (abs_err(out, ref_out), abs_err(out, ref_out), TOL[dtype]),
            "sparse_backward_dq": (abs_err(dq, ref_dq), rel_err(dq, ref_dq), FLASH_GRAD_TOL[dtype]),
            "sparse_backward_dkdv": (max(abs_err(dk, ref_dk), abs_err(dv, ref_dv)),
                                     max(rel_err(dk, ref_dk), rel_err(dv, ref_dv)), FLASH_GRAD_TOL[dtype])}
    lse_err = abs_err(lse, ref_lse)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
    ok = finite and lse_err <= LSE_TOL and all(checked <= tol for _, checked, tol in errs.values())
    if not ok or label:
        print(f"  sparse vs plain  {label or 'case':<44} {str(dtype)[6:]} B={B} S={S} H={H} D={D} block={block} "
              f"{'causal' if causal else 'bidir'}: out {errs['sparse_forward'][0]:.2e} (tol {TOL[dtype]:.0e}), "
              f"lse {lse_err:.2e}, dQ {errs['sparse_backward_dq'][1]:.2e}, dK/dV "
              f"{errs['sparse_backward_dkdv'][1]:.2e} (rel, tol {FLASH_GRAD_TOL[dtype]:.0e})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"a sparse kernel disagrees with its plain version: {label} {dtype} block={block}")
    return {name: e[:2] for name, e in errs.items()}, dk, dv, lists


def sparse_checks(dev):
    """Every case of phase 14 -> {kernel: {dtype: (max abs err, max rel err)}}."""
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = {name: {dt: (0.0, 0.0) for dt in TOL} for name in SPARSE_NAMES}

    def check(dtype, layout, block, causal, H, D, label=""):
        errs, dk, dv, lists = sparse_case(dev, gen, dtype, layout, block, causal, 2, H, D, label)
        for name, e in errs.items():
            worst[name][dtype] = tuple(max(x, y) for x, y in zip(worst[name][dtype], e))
        return dk, dv, lists

    n = 0
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for mode, kw in SPARSE_CHECK_LAYOUTS.items():
            for block in sk.BLOCKS:
                layout = SPARSITY_CONFIGS[mode](num_heads=4, block=block, **kw).make_layout(16 * block)
                for causal in (True, False):
                    check(dtype, layout, block, causal, 4, 64)
                    n += 1
        for block in (16, 128):
            check(dtype, SPARSITY_CONFIGS["bigbird"](num_heads=4, block=block).make_layout(8 * block),
                  block, True, 4, 128)
            n += 1
        w = {name: worst[name][dtype] for name in SPARSE_NAMES}
        print(f"  {str(dtype)[6:]:<9} 5 layouts x blocks {sk.BLOCKS} x causal/bidirectional at D=64, and D=128: "
              f"worst out {w['sparse_forward'][0]:.2e} (tol {TOL[dtype]:.0e}), dQ {w['sparse_backward_dq'][1]:.2e}, "
              f"dK/dV {w['sparse_backward_dkdv'][1]:.2e} (rel, tol {FLASH_GRAD_TOL[dtype]:.0e})  ok")
        torch.cuda.empty_cache()

    unattended = np.zeros((8, 8), np.int64)
    unattended[np.arange(8), np.arange(8)] = 1
    unattended[:, 0] = 1
    unattended[5, 5] = 0  # causal: no query block attends key block 5
    for dtype in (torch.bfloat16, torch.float32):
        dk, dv, lists = check(dtype, unattended, 64, True, 4, 64, "key block 5 unattended")
        zero = (int(lists.q_counts[5]) == 0 and dk[:, 320:384].abs().max().item() == 0.0
                and dv[:, 320:384].abs().max().item() == 0.0)
        print(f"    its dK and dV rows are exactly 0: {zero}")
        if not zero:
            raise SystemExit("a key block no query attends got non-zero dK/dV")
    check(torch.bfloat16, slice_layout(), 64, True, 12, 64, "main path: fixed-64")
    print(f"  {n + 3} cases, every one within tolerance")
    torch.cuda.empty_cache()
    return worst


def sparse_bounds(B, S, H, D, elt, lists):
    """{kernel: (bound_ms, bound_by, bytes, flops)}: each input read once and
    each output written once (the lists a kernel walks included); the work
    is this layout's active block pairs, diagonal blocks counted whole:
    4·block²·D flops per pair per (b, h) forward, 6 for dQ, 8 for dK/dV."""
    t = B * S * H * D * elt
    rows = B * H * S * 4
    pairs = int(lists.k_counts.sum()) * B * H
    per = lists.block ** 2 * D
    kq = (lists.k_lists.numel() + lists.k_counts.numel()) * 4
    qk = (lists.q_lists.numel() + lists.q_counts.numel()) * 4
    work = {"sparse_forward": (4 * t + rows + kq, 4 * per * pairs),             # q,k,v -> O, lse
            "sparse_backward_dq": (5 * t + 2 * rows + kq, 6 * per * pairs),     # q,k,v,dO,lse,Δ -> dQ
            "sparse_backward_dkdv": (6 * t + 2 * rows + qk, 8 * per * pairs)}   # q,k,v,dO,lse,Δ -> dK,dV
    out = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)
    return out


def sparse_timing(dev, label, layout):
    """Times at the main path's shape (B=2, S=8192, H=12, D=64, bf16,
    causal) for one layout: each kernel, the plain versions, SDPA with the
    layout as a boolean [S, S] mask, and the dense causal flash kernels."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, S, H, D = 2, SS, 12, 64
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(4))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    lists = sk.device_lists(layout, True, S, dev)
    out, lse = sk.sparse_forward(q, k, v, lists)
    delta = fa.flash_delta(out, dout)
    blk = lists.block
    dense = torch.from_numpy(np.kron(np.asarray(layout[0], bool), np.ones((blk, blk), bool))).to(dev)
    mask = dense & torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))  # [B, H, S, D]
    lib_err = (sdpa(qt, kt, vt, attn_mask=mask).transpose(1, 2).float() - out.float()).abs().max().item()
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    o_lib = sdpa(qr, kr, vr, attn_mask=mask)
    plain_bwd = median_ms(lambda: sk.sparse_attention_backward_reference(q, k, v, out, lse, dout, lists), flush,
                          runs=3, warmup=1)
    lib_bwd = median_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), dot, retain_graph=True), flush,
                        runs=20, warmup=3)
    times = {
        "sparse_forward": {"ms": median_ms(lambda: sk.sparse_forward(q, k, v, lists), flush, runs=30),
                           "plain_ms": median_ms(lambda: sk.sparse_attention_reference(q, k, v, lists), flush,
                                                 runs=3, warmup=1),
                           "library_ms": median_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), flush, runs=20,
                                                   warmup=3)},
        "sparse_backward_dq": {"ms": median_ms(lambda: sk.sparse_backward_dq(q, k, v, dout, lse, delta, lists),
                                               flush, runs=30),
                               "plain_ms": plain_bwd, "library_ms": lib_bwd},
        "sparse_backward_dkdv": {"ms": median_ms(lambda: sk.sparse_backward_dkdv(q, k, v, dout, lse, delta, lists),
                                                 flush, runs=30),
                                 "plain_ms": plain_bwd, "library_ms": lib_bwd},
    }
    f_out, f_lse = fa.flash_forward(q, k, v)
    f_delta = fa.flash_delta(f_out, dout)
    flash = {"flash_forward": median_ms(lambda: fa.flash_forward(q, k, v), flush, runs=10, warmup=2),
             "flash_backward_dq": median_ms(lambda: fa.flash_backward_dq(q, k, v, dout, f_lse, f_delta), flush,
                                            runs=10, warmup=2),
             "flash_backward_dkdv": median_ms(lambda: fa.flash_backward_dkdv(q, k, v, dout, f_lse, f_delta), flush,
                                              runs=10, warmup=2)}
    counts_q = lists.q_counts.float()
    pairs = int(lists.k_counts.sum())
    print(f"  {label}: {pairs} active block pairs of {blk} per (b, h) after tril (density "
          f"{pairs / (lists.k_lists.shape[0] * (lists.k_lists.shape[0] + 1) / 2):.3f}); query blocks per key block: "
          f"max {int(counts_q.max())}, mean {counts_q.mean().item():.1f}")
    for name, (bound, by, nbytes, flops) in sparse_bounds(B, S, H, D, 2, lists).items():
        t = times[name]
        t.update(bound_ms=bound, bound_by=by)
        dense_name = {"sparse_forward": "flash_forward", "sparse_backward_dq": "flash_backward_dq",
                      "sparse_backward_dkdv": "flash_backward_dkdv"}[name]
        t["dense_flash_ms"] = flash[dense_name]
        print(f"    {name:<21} kernel {t['ms']*1e3:8.1f} us, plain {t['plain_ms']*1e3:9.1f} us, sdpa+mask "
              f"{t['library_ms']*1e3:8.1f} us, dense flash {flash[dense_name]*1e3:8.1f} us, bound "
              f"{bound*1e3:6.1f} us ({by}: {nbytes/1e6:.1f} MB, {flops/1e9:.1f} GFLOP), "
              f"{flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"    sdpa+mask vs kernel output max_abs_err {lib_err:.2e}; sdpa's backward is the library time of both "
          f"backward rows; the plain backward times all three gradients")
    times["pairs_per_bh"] = pairs
    times["q_per_key_block_max_mean"] = [int(counts_q.max()), counts_q.mean().item()]
    del q, k, v, dout, qr, kr, vr, o_lib, mask, dense, flush
    torch.cuda.empty_cache()
    return times


SPARSE_TRAIN_DS = dict(BENCH_DS, train_batch_size=8, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=4,
                       sparse_attention=SPARSE_BLOCK)


def train_sparse(dev):
    """Phase 15: the long-sequence slice, and dense flash at the same length."""
    model = Model(gpt2_config(max_seq_len=SS))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=SPARSE_TRAIN_DS)
    cfg = engine.model.config
    B, L, gas = SPARSE_TRAIN_DS["train_batch_size"], cfg.num_layers, SPARSE_TRAIN_DS["gradient_accumulation_steps"]
    print(f"  model: attn_impl={cfg.attn_impl}, sparsity={cfg.sparsity}")
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, SS + 1)).astype(np.int32)}
    warm_s, step_s, metrics, per_step = timed_steps(engine, batch, TRAIN_STEPS)
    launches = sparse_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    overflow = any(bool(m["overflow"]) for m in metrics)
    expect = [0] * N_COUNTS + [L * gas] * 3
    # the same batch six times at lr 6e-4 without warm-up: the loss falls up
    # to the fifth step, and the last may overshoot (phase 7's fifth does)
    ok = (cfg.attn_impl == "sparse" and all(step == expect for step in per_step) and all(np.isfinite(losses))
          and losses[-2] < losses[0] and not overflow)
    tok_s = B * SS / step_s
    result = {"warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
              "tflops_model_dense_attention_formula": tok_s * model.flops_per_token() / 1e12, "peak_gib": peak,
              "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in metrics], "overflow": overflow,
              "launches_per_train_batch": per_step[0][N_COUNTS:]}
    print(f"  sparse, train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): {result['step_ms']:.1f} ms/step, "
          f"{tok_s:.0f} tokens/s, {result['tflops_model_dense_attention_formula']:.1f} TFLOP/s by "
          f"Model.flops_per_token (its dense attention term counts the keys the kernels skip), peak {peak:.2f} GiB")
    print(f"  launches per train_batch {COUNT_LABEL} "
          f"{per_step} (expect {expect}); losses {[round(x, 4) for x in losses]}; overflow {overflow}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the long-sequence sparse training phase failed its checks")
    del engine
    torch.cuda.empty_cache()

    flash_ds = {k: v for k, v in SPARSE_TRAIN_DS.items() if k != "sparse_attention"}
    dense_model = Model(gpt2_config(max_seq_len=SS))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=dense_model, config=flash_ds)
    warm_s, step_s, metrics, per_step = timed_steps(engine, batch, TRAIN_STEPS)
    dense_peak = torch.cuda.max_memory_allocated() / 2**30
    dense_losses = [float(m["loss"]) for m in metrics]
    expect = [L * gas] * 3 + [0] * 8
    ok = all(step == expect for step in per_step) and all(np.isfinite(dense_losses))
    tok_s = B * SS / step_s
    result["dense_flash"] = {"warmup_step_s": warm_s, "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
                             "tflops_model": tok_s * dense_model.flops_per_token() / 1e12, "peak_gib": dense_peak,
                             "losses": dense_losses}
    print(f"  dense flash at S={SS}, train_batch x{TRAIN_STEPS} after one warm-up ({warm_s:.2f} s): "
          f"{step_s * 1e3:.1f} ms/step, {tok_s:.0f} tokens/s, {result['dense_flash']['tflops_model']:.1f} TFLOP/s, "
          f"peak {dense_peak:.2f} GiB; launches {per_step[0]}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the dense flash yardstick at S=8192 failed its checks")
    print(f"  sparse step / dense flash step: {result['step_ms'] / result['dense_flash']['step_ms']:.3f}")
    del engine
    torch.cuda.empty_cache()
    return launches, result, batch


class _PlainSparse(torch.autograd.Function):
    """The plain versions on CUDA tensors, for phase 16's comparison only:
    the port's wrapper never takes them for a CUDA tensor."""

    @staticmethod
    def forward(ctx, q, k, v, lists, causal, scale):
        out, lse = sk.sparse_attention_reference(q, k, v, lists, causal=causal, sm_scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lists, ctx.causal, ctx.scale = lists, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = sk.sparse_attention_backward_reference(q, k, v, out, lse, dout, ctx.lists, causal=ctx.causal,
                                                       sm_scale=ctx.scale)
        return (*grads, None, None, None)


def _plain_sparse_attention(q, k, v, layout, causal=True, sm_scale=None, block=None):
    lists = sk.device_lists(layout, causal, q.shape[1], q.device)
    scale = 1.0 / q.shape[-1] ** 0.5 if sm_scale is None else sm_scale
    return _PlainSparse.apply(q, k, v, lists, causal, scale)


def first_steps(cfg, ds, params, batch, steps, plain):
    """Losses (and grad norms) of ``steps`` train_batch calls from
    ``params``, through the kernels or, with ``plain``, through the plain
    versions (the model's sparse dispatch pointed at them for the run)."""
    kernel_fn = tfm.sparse_flash_attention
    if plain:
        tfm.sparse_flash_attention = _plain_sparse_attention
    try:
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds,
                                                      model_parameters=tree_map(torch.clone, params))
        before = sparse_counts()
        ms = [eng.train_batch(batch) for _ in range(steps)]
        out = [(float(m["loss"]), float(m["grad_norm"])) for m in ms]
        launched = [a - b for a, b in zip(sparse_counts(), before)]
    finally:
        tfm.sparse_flash_attention = kernel_fn
    del eng, ms
    torch.cuda.empty_cache()
    return out, launched


def sparse_parity(dev):
    """Phase 16: the slice through the sparse kernels against the plain versions."""
    tiny = TransformerConfig(vocab_size=97, max_seq_len=512, num_layers=2, num_heads=4, hidden_size=64,
                             attn_impl="sparse", sparsity={"mode": "bigbird", "block": 32, "num_random_blocks": 1},
                             loss_chunk_size=128)
    params = tfm.init(tiny, torch.Generator().manual_seed(0), dev)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 1000000}
    batch = {"tokens": np.random.default_rng(2).integers(0, 97, size=(4, 513)).astype(np.int32)}
    kern, launched = first_steps(tiny, ds, params, batch, 5, plain=False)
    plain, plain_launched = first_steps(tiny, ds, params, batch, 5, plain=True)
    # fp32: the kernels and the plain versions differ in summation order only
    small_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(kern, plain))
    ok = small_err <= 1e-4 and launched == [20] * 3 and plain_launched == [0] * 3
    print(f"  small fp32 model (bigbird-32, S=512), 5 steps: kernels {[round(x[0], 5) for x in kern]} vs plain "
          f"{[round(x[0], 5) for x in plain]}, max rel err {small_err:.2e} (tol 1e-4); launches {launched} and "
          f"{plain_launched}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the small model's loss through the sparse kernels differs from the plain versions")

    cfg = gpt2_config(max_seq_len=SS)
    params = tfm.init(cfg, torch.Generator().manual_seed(1), dev)
    ds1 = dict(SPARSE_TRAIN_DS, train_batch_size=1, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=1)
    batch = {"tokens": np.random.default_rng(3).integers(0, 50304, size=(1, SS + 1)).astype(np.int32)}
    (k1,), _ = first_steps(cfg, ds1, params, batch, 1, plain=False)
    (p1,), _ = first_steps(cfg, ds1, params, batch, 1, plain=True)
    # bf16: the plain versions take one softmax over each query block's
    # gathered row where the kernels go online, so P rounds to bf16 against
    # another running maximum, through 12 layers
    loss_err = abs(k1[0] - p1[0]) / abs(p1[0])
    gnorm_err = abs(k1[1] - p1[1]) / abs(p1[1])
    ok = loss_err <= 1e-2 and gnorm_err <= 5e-2 and all(np.isfinite(k1))
    print(f"  full width bf16, first train_batch (one {SS}-token row): loss {k1[0]:.5f} vs {p1[0]:.5f} "
          f"(rel {loss_err:.2e}, tol 1e-2), grad norm {k1[1]:.5f} vs {p1[1]:.5f} (rel {gnorm_err:.2e}, tol 5e-2)  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the full-width step through the sparse kernels disagrees with the plain versions")
    return {"small_fp32_max_rel_err": small_err, "full_width_loss_rel_err": loss_err,
            "full_width_grad_norm_rel_err": gnorm_err}


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 2048, "max_difficulty": SS,
              "schedule_type": "fixed_discrete",
              "schedule_config": {"difficulty": [2048, 4096, SS], "max_step": [1, 2]}}


def curriculum_resume(dev):
    """Phase 17: the curriculum and the dataloader through save and resume."""
    ds = dict(SPARSE_TRAIN_DS, curriculum_learning=CURRICULUM)
    cfg = gpt2_config(max_seq_len=SS)
    data = [{"tokens": row} for row in
            np.random.default_rng(5).integers(0, 50304, size=(48, SS + 1)).astype(np.int32)]

    def engine():
        params = tfm.init(cfg, torch.Generator().manual_seed(6), dev)
        return deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds, training_data=data,
                                              model_parameters=params)

    sk.LIST_CACHE.clear()
    straight, _, loader, _ = engine()
    ref, lengths = [], []
    for _, b in zip(range(5), loader):
        ref.append(float(straight.train_batch(b)["loss"]))
        lengths.append(straight.curriculum_scheduler.get_current_difficulty())
    cached = sorted({key[0] for key in sk.LIST_CACHE if key[2].startswith("cuda")})
    del straight
    torch.cuda.empty_cache()
    d = CURRICULUM["schedule_config"]["difficulty"]
    expect = [d[0], d[0], d[1], d[2], d[2]]  # steps 0-4 against max_step [1, 2]
    ok = lengths == expect and cached == d and all(np.isfinite(ref))
    print(f"  5 steps from the loader: lengths {lengths} (expect {expect}), cached lists per length {cached}, "
          f"losses {[round(x, 4) for x in ref]}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the curriculum did not follow its schedule")

    root = tempfile.mkdtemp(prefix="dstt_curriculum_")
    try:
        first, _, loader, _ = engine()
        got = [float(first.train_batch(b)["loss"]) for _, b in zip(range(2), loader)]
        first.save_checkpoint(root)
        saved = (first.curriculum_scheduler.state_dict(), dict(first._dl_cursor))
        del first
        torch.cuda.empty_cache()
        second, _, loader, _ = engine()
        second.load_checkpoint(root)
        resumed = (second.curriculum_scheduler.state_dict(), loader.state_dict())
        got += [float(second.train_batch(b)["loss"]) for _, b in zip(range(3), loader)]
        del second
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = got == ref and resumed == saved
    print(f"  train 2 + save + fresh engine and loader + load + train 3: {got}; 5 straight: {ref}; resumed at "
          f"difficulty {resumed[0]['current_difficulty']} and loader batch {resumed[1]['batches_yielded']} (saved "
          f"{saved[0]['current_difficulty']}, {saved[1]['batches_yielded']}) (bitwise expected)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("resume with the curriculum and the dataloader did not reproduce the uninterrupted run")
    return {"lengths": lengths, "cached_lengths": cached, "losses": ref, "resumed_losses": got,
            "resumed_difficulty": resumed[0]["current_difficulty"],
            "resumed_loader_batch": resumed[1]["batches_yielded"]}


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
        decode_attention.launches = decode_attention.combine_launches = 0
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_new_tokens=MAX_NEW, **kw)
        seconds = time.perf_counter() - t0
        launches, combines = decode_attention.launches, decode_attention.combine_launches
        ok = (out.shape == (B, MAX_NEW) and out.dtype == np.int32
              and (out >= 0).all() and (out < cfg.vocab_size).all() and launches == combines == expect)
        print(f"  generate {name}: {out.shape} in {seconds:.3f} s, kernel launches {launches} split, "
              f"{combines} combine (expect {cfg.num_layers} x {MAX_NEW - 1} = {expect} each), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"generate {name} failed its checks")
        results[name] = {"seconds": seconds, "launches": launches, "combine_launches": combines,
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
    return (g["launches"], g["combine_launches"]), engine, prompt


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
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    print("  host ops by self time (the profiler's own cost inflates them):")
    for a in host:
        print(f"    {a.self_cpu_time_total/1e3:9.3f} ms  x{a.count:<6d} {a.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label.split('(')[0]}_trace.json"))
    print(json.dumps({"profile": {"label": label, "wall_ms": wall_us / 1e3,
                                  "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
                                  "kernel_launches": len(kernels),
                                  "top_ms": {n[:80]: us / 1e3 for n, us in top},
                                  "host_self_ms": {a.key[:80]: a.self_cpu_time_total / 1e3 for a in host}}}))


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

    print("[3] decode_attention kernels vs plain; their registers and spills (ptxas):")
    decode_regs = decode_registers()
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
    print(f"[5] loaded flash_attention (forward, dK/dV, dQ) in {time.perf_counter() - t0:.2f} s; "
          f"its kernels' SASS (cuobjdump) and registers (ptxas):")
    sass = sass_report("flash_attention", kernel_label, MAIN_PATH_KERNEL.values())
    print("  the fused-loss backward's mainloop (csrc/fused_xent.cu), each epilogue and operand layout:")
    xent_sass = sass_report("fused_xent", xent_label, XENT_MAIN_PATH.values())

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
    print(f"[9] loaded fused_xent (forward; backward: ds, dW, dH) in {time.perf_counter() - t0:.2f} s; "
          f"fused-loss kernels vs plain")
    xent_errs = xent_checks(dev)
    xent_times = xent_timing(dev)
    torch.cuda.empty_cache()

    print("[10] training: the fused loss under dots_and_flash remat at GPT-2-125M width")
    xent_launches, training["fused_remat"], trainer, batch = train_fused(dev, no_remat=bool(args.profile))
    if args.profile:
        profile("train_batch_fused_remat", lambda: trainer.train_batch(batch), args.profile)

    print("[11] slice parity: the fused loss vs the chunked loss")
    training["fused_remat"]["parity"] = fused_parity(dev)
    torch.cuda.empty_cache()

    print("[12] checkpoint and resume")
    training["checkpoint"] = checkpoint_resume(dev, trainer, batch)
    del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    op_builder.load("sparse_attention")
    print(f"[13] loaded sparse_attention (forward, dQ, dK/dV) in {time.perf_counter() - t0:.2f} s")

    print("[14] sparse kernels vs plain")
    sparse_errs = sparse_checks(dev)
    sparse_times = sparse_timing(dev, "fixed-64 (the slice's layout)", slice_layout())
    name, kw = BIGBIRD_128
    bigbird_times = sparse_timing(dev, "bigbird-128 (benchmarks/sparse_attention_bench.py)",
                                  SPARSITY_CONFIGS[name](num_heads=12, **kw).make_layout(SS))

    print(f"[15] long-sequence training: initialize -> train_batch at GPT-2-125M width, S={SS}, sparse attention")
    sparse_launches, training["sparse"], sparse_batch = train_sparse(dev)
    if args.profile:
        engine = deepspeed_tpu_torch.initialize(model=Model(gpt2_config(max_seq_len=SS)), config=SPARSE_TRAIN_DS)[0]
        engine.train_batch(sparse_batch)
        profile("train_batch_sparse", lambda: engine.train_batch(sparse_batch), args.profile)
        del engine
        torch.cuda.empty_cache()

    print("[16] slice parity: sparse kernels vs their plain versions")
    training["sparse"]["parity"] = sparse_parity(dev)
    torch.cuda.empty_cache()

    print("[17] the curriculum and the dataloader through save and resume")
    training["curriculum"] = curriculum_resume(dev)
    torch.cuda.empty_cache()

    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:54",
        "launches": launches[0], "combine_launches": launches[1],
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
        "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"], "library_ratio": times["library_ratio"],
        "back_to_back_us": times["back_to_back_us"],
        "registers": decode_regs[DECODE_MAIN_PATH[0]].get("registers"),
        "spill_stores": decode_regs[DECODE_MAIN_PATH[0]].get("spill_stores"),
        "combine_registers": decode_regs[DECODE_MAIN_PATH[1]].get("registers"),
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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "library_ratio": t["library_ratio"],
            **{k: t[k] for k in ("library_fwd_bwd_less_fwd_ms", "library_fwd_bwd_less_fwd_ratio") if k in t},
            "hgmma": sass.get(MAIN_PATH_KERNEL[name], {}).get("hgmma", 0),
            "registers": sass.get(MAIN_PATH_KERNEL[name], {}).get("registers"),
            "spill_stores": sass.get(MAIN_PATH_KERNEL[name], {}).get("spill_stores"),
        })
    replaces = {"fused_xent_forward": "deepspeed_tpu/ops/pallas/fused_xent.py:73",
                "fused_xent_backward_dh": "deepspeed_tpu/ops/pallas/fused_xent.py:171",
                "fused_xent_backward_dw": "deepspeed_tpu/ops/pallas/fused_xent.py:193"}
    fwd_launches, ds_launches, dw_launches, dh_launches = xent_launches
    gas = BENCH_DS["gradient_accumulation_steps"]
    # the backward pair: the ds pass feeds both rows, then each row's own product
    carried = {"fused_xent_backward_dh": (("ds", ds_launches), ("dH", dh_launches)),
               "fused_xent_backward_dw": (("ds", ds_launches), ("dW", dw_launches))}
    for name, where in replaces.items():
        t, e = xent_times[name], xent_errs[name]
        second = "lse_max_abs_err" if name == "fused_xent_forward" else "max_rel_err"  # what e[dtype][1] holds
        entry = {
            "name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/fused_xent.cu",
            "replaces": where, "launches": fwd_launches if name == "fused_xent_forward" else carried[name][1][1],
            "max_abs_err": e[torch.bfloat16][0], "max_abs_err_fp32": e[torch.float32][0],
            "max_abs_err_fp16": e[torch.float16][0],
            second: e[torch.bfloat16][1], f"{second}_fp32": e[torch.float32][1],
            f"{second}_fp16": e[torch.float16][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "cublas_logits_ms": t["cublas_logits_ms"],
        }
        if name != "fused_xent_forward":
            entry.update(
                ms_is="the pair: dH and dW together, as one backward call computes them",
                row_bound_ms=t["row_bound_ms"], chunks=t["chunks"], chunk_width=t["chunk_width"],
                kernels=[{"name": XENT_MAIN_PATH[k], "launches": n,
                          "launches_per_train_batch": n // TRAIN_STEPS, "ms": t["passes"][k]["ms"],
                          "hgmma": xent_sass[XENT_MAIN_PATH[k]]["hgmma"],
                          "registers": xent_sass[XENT_MAIN_PATH[k]]["registers"],
                          "spill_stores": xent_sass[XENT_MAIN_PATH[k]]["spill_stores"]}
                         for k, n in carried[name]],
                backward_calls_per_train_batch=gas)
        kernels.append(entry)
    replaces = {"sparse_forward": "deepspeed_tpu/ops/sparse_attention/kernels.py:75",
                "sparse_backward_dq": "deepspeed_tpu/ops/sparse_attention/kernels.py:154",
                "sparse_backward_dkdv": "deepspeed_tpu/ops/sparse_attention/kernels.py:192"}
    for (name, where), n in zip(replaces.items(), sparse_launches):
        t, e, bb = sparse_times[name], sparse_errs[name], bigbird_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
            "replaces": where, "launches": n,
            "max_abs_err": e[torch.bfloat16][0], "max_abs_err_fp32": e[torch.float32][0],
            "max_abs_err_fp16": e[torch.float16][0],
            "max_rel_err": e[torch.bfloat16][1], "max_rel_err_fp32": e[torch.float32][1],
            "max_rel_err_fp16": e[torch.float16][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "dense_flash_ms": t["dense_flash_ms"],
            "bigbird128": {k: bb[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                               "dense_flash_ms")},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"training": training}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
