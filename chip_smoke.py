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
     or dQ kernel has none; the same for the fused loss's mainloop
     (csrc/fused_xent.cu: its forward's logsumexp instance and the
     backward's ds, dW and dH instances), failing if one that the main path
     runs has none;
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
  9. hold the fused-loss forward (the logits product reducing each vocab
     tile to partials, then their combine) and backward (dH and dW: per
     vocab chunk a ds pass, a dW product and a dH product) against their
     plain versions
     at the training shape (N = 16 x 1024 rows, D = 768, V = 50304, bf16,
     one row in seven ignored, the head as wte.t()), and in fp32 and fp16 at
     N = 2048, and at V = 50257, V = 777, one column past a backward chunk
     and D = 770; two backward calls must give bitwise-equal dH and dW. Then
     time the forward and each of its two kernels alone, the whole backward
     against the pair's bound, each backward kernel alone over every chunk
     in order, the plain versions and, as reference points only, the cuBLAS
     logits product of the chunked loss and F.cross_entropy over it;
 10. train through the fused loss under remat at GPT-2-125M width: phase 7's
     configuration with loss_impl="fused_xent", remat=True,
     remat_policy="dots_and_flash", one warm-up and five timed steps,
     checking 48 launches of each flash kernel, 4 of each fused-loss forward
     kernel (product, combine) and 4 x 7 (vocab chunks) of each backward
     kernel per train_batch, then
     one step under nothing_saveable with 96 flash-forward launches;
 11. slice parity: five fp32 steps of a small model with the fused loss and
     with the chunked loss give the same losses, and at full width in bf16
     the first step's loss and grad norm agree;
 12. checkpoint and resume: a small bf16 model with dropout trained 2 steps,
     saved, loaded into a fresh engine and trained 3 more gives the losses of
     5 uninterrupted steps bitwise; at full width one save/load round trip
     into a fresh engine (seconds, bytes) and one step whose loss equals the
     uninterrupted engine's;
 13. load the block-sparse attention kernels (forward, dQ, dK/dV); count
     the HGMMA instructions of each kernel in its SASS beside its registers
     and spills from the build, failing if the Hopper forward, dQ or dK/dV
     instance the main path runs (bf16, D = 64, block 64) has none;
 14. hold each sparse kernel against its plain version: fixed, bigbird,
     bslongformer, variable and dense layouts at blocks 16, 32, 64 and 128,
     causal and bidirectional, bf16, fp16 and fp32, D = 64 (and 128), a
     layout with a key block no query attends (dK = dV = 0 exactly), long
     lists at blocks 64 and 128, D = 100 and a view off 16 bytes (the
     padding route), two calls of each 16-bit kernel bitwise equal, a query
     block with an empty list (O = 0, lse = NEG_INF exactly), and the main path's
     shape (B=2, S=8192, H=12, D=64, bf16, fixed-64). Then time each
     kernel, the plain versions, SDPA with the layout as a boolean mask (a yardstick the port
     never calls) and the port's dense flash kernels at that shape, for the
     slice's fixed-64 layout and the bigbird-128 layout of
     benchmarks/sparse_attention_bench.py;
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
     the same difficulty and loader cursor;
 18. the serving engine (inference/serving.ServingEngine) over
     init_inference at GPT-2-125M width (phase 4's model): 16 slots, the
     prefix cache (8 x 512 tokens), chunked prefill (256), the decode step
     one CUDA graph captured once. Workload (a): 64 requests sharing a
     512-token system prompt with 8-48-token tails and 64-128 new tokens,
     all greedy and arrived at 0 (benchmarks/serving_throughput.py:169-191),
     through serve() with speculation off, then on (depth 8); workload (b):
     64 ragged requests, half sampled, at Poisson arrivals of 32/s
     (:147-166). It checks that every request ends ok, one decode program
     per engine, 12 split and 12 combine launches a replay (and the
     profiler's kernel records over 5 steps), the prefix hits of (a), one
     replay against the eager step function bit for bit, the first-token
     logits of (a) against generate's prefill, and on a small fp32 model
     the tokens of generate with speculation off and on; it prints
     tokens/s, TTFT p50/p99, TPOT p50, decode ms/step as graph replay and
     as the eager step, the prefix hit rate, the speculation acceptance
     rate and the slot occupancy, each beside the card's name and power
     limit.
 19. training resilience at GPT-2-125M width (phase 10's model and config
     without remat: fused loss, flash attention, bf16, batch 64 = micro 16
     x gas 4), nine drills that each fail the script: a NaN step (a +inf
     loss scale through the kernels) is skipped and 4 clean steps equal 5
     with the poisoned one bitwise; two NaN steps in a row rewind to the
     last good tag bitwise; a real SIGTERM gives PreemptionSignal and a JIT
     checkpoint from which a fresh engine resumes bitwise; a transient
     write failure is retried once; a permanent one raises and leaves
     'latest' on the intact tag; an async save (a step running while its
     writer does) equals a synchronous save; DeepSpeed's 3-call loop
     against train_batch over two steps, with each kernel's launches per
     step on both loops, and on a small fp32 model; save_16bit_model read
     back bitwise; the CSV monitor's one row per step. It prints, beside
     the card's name and power limit, step ms with the guardrail on and
     off and of both loops, the JIT checkpoint's seconds, and how long a
     synchronous and an async save block the caller (and the commit).
 20. the serving fleet at GPT-2-125M width (phase 18's configuration),
     workload (b): one engine as the yardstick; a Router over 2 in-process
     replicas (their decode steps two CUDA graphs on the split-KV kernel),
     unfaulted, then with replica 0 killed before router step 10
     (benchmarks/serving_throughput.py:339-405): every request terminal,
     failovers recovered, survivors idle with their slots accounted, one
     decode program a replica, each replica's launches = 12 x its replays
     (so by construction: the profiler's kernel records over 3 fleet
     steps are the measurement), the dead
     replica's device memory released; a small fp32 fleet's kill whose
     greedy streams must equal the unfaulted run's; the request journal
     (fsync on) through a router_crash and a new Router's recovery, every
     accepted request delivered exactly once; 2 worker processes on the
     card under a WorkerSupervisor (unix sockets), worker 0 SIGKILLed after
     router step 10, the DEAD verdict's failover, respawn and
     attach_replica, each worker's decode launches as it reports them
     (its boot warm-up excluded), the live workers' own profiler kernel
     records over 3 decoding steps after the timed run, and a SIGTERM
     drain with exit 0. It prints tokens/s, TTFT p50/p99 and TPOT
     p50 of each run, the time from the kill to the last failed-over
     admission, the recovery time, the worker boot and respawn seconds,
     beside the card's name and power limit.
 21. the fleet's front door and membership at GPT-2-125M width (phase 18's
     configuration; bench.py --gateway-chaos and --surge at this width,
     without the flight recorder): (a) the Router over 2 in-process
     replicas alone, then behind launcher/http_gateway.HttpGateway on
     127.0.0.1, workload (b) as client threads at its Poisson arrivals,
     half blocking POSTs, half SSE streams: every SSE stream's token events
     equal its done event and the fleet's result, greedy ones counted
     against one engine's (bf16), and the profiler's kernel records over
     streamed requests equal 12 split + 12 combine a replay; (b) 3 clients
     reset their sockets mid-stream: each request ends cancelled and every
     replica's slots and prefix references return to 0; (c) a rolling
     upgrade of both replicas under 64 live requests: every wave upgraded,
     each canary served through the newcomer's graph, no request lost, the
     old generation's memory released; (d) an autoscaled in-process fleet
     (1..3, bench.py's block) under the surge trace (two bursts and a
     high-priority third, heavy-tailed prompts), one replica killed
     mid-trace: it grows to 3, browns out, respawns the dead one as a new
     rid, shrinks back to 1, and every accepted request ends terminal; a
     small fp32 fleet's greedy streams through the gateway equal generate's
     across an upgrade; (e) 2 worker processes over TCP behind the gateway,
     one SIGKILLed, respawned and attached, then a set_spec rolling upgrade
     of both. It prints client TTFT p50/p99 beside the Router's, TPOT p50,
     tokens/s through the gateway against the Router alone, each wave's
     boot/gate/drain ms, signal -> attached ms, shed counts, worker boot and
     respawn s, and decode launches per replica and per worker.
It prints a ``{"serving_engine": {...}}`` line, a ``{"resilience": {...}}``
line, a ``{"fleet": {...}}`` line, a ``{"gateway": {...}}`` line, a ``{"kernels": [...]}`` line, a ``{"training": {...}}`` line,
then as its last line ``{"ok": true, "device": {...}}``. Without a GPU it
exits 1 and prints no result.

    python3 chip_smoke.py --profile chiprun_out/profile

also traces one generate(max_new_tokens=64), one train_batch of phases 7,
10 and 15 and 20 serving steps of phase 18's workload (a) with torch.profiler and prints the device's busy share, its time
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
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk
from deepspeed_tpu_torch.resilience import PermanentIOError, PreemptionSignal, install_injector
from deepspeed_tpu_torch.resilience.preemption import deactivate_guard

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (the kernel's math)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
KERNEL_SOURCES = ("decode_attention", "flash_attention", "fused_xent", "sparse_attention")
FLASH_COUNTERS = (fa.flash_forward, fa.flash_backward_dkdv, fa.flash_backward_dq)
XENT_COUNTERS = (fx.fused_xent_forward, fx.xent_fwd_combine, fx.xent_ds_pass, fx.xent_dw_pass, fx.xent_dh_pass)
SPARSE_COUNTERS = (sk.sparse_forward, sk.sparse_backward_dq, sk.sparse_backward_dkdv)
SPARSE_NAMES = ("sparse_forward", "sparse_backward_dq", "sparse_backward_dkdv")
# the kernels of csrc/sparse_attention.cu, read from the SASS and from the build
SPARSE_KERNELS = ("sparse_fwd_hopper", "sparse_bwd_dq_hopper", "sparse_bwd_dkdv_hopper", "sparse_fwd_kernel",
                  "sparse_bwd_dq_kernel", "sparse_bwd_dkdv_kernel")
# the entry point -> the kernel that runs it on the main path (bf16, D = 64, block 64)
SPARSE_MAIN_PATH = {"sparse_forward": "sparse_fwd_hopper bf16 D64 B64",
                    "sparse_backward_dq": "sparse_bwd_dq_hopper bf16 D64 B64",
                    "sparse_backward_dkdv": "sparse_bwd_dkdv_hopper bf16 D64 B64"}
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


# The fused loss's mainloop on the main path (bf16, the tied head wteᵀ):
# each of its epilogues (the forward's per-tile logsumexp, the backward's
# passes), and which operand it reads MN-major.
XENT_MAIN_PATH = {"fwd": "xent_gemm_hopper bf16 lse A:K B:K",
                  "ds": "xent_gemm_hopper bf16 ds A:K B:K", "dW": "xent_gemm_hopper bf16 dW A:MN B:MN",
                  "dH": "xent_gemm_hopper bf16 dH A:K B:MN"}


def xent_label(mangled):
    """'xent_gemm_hopper bf16 dH A:K B:MN' (the epilogue, then how A and B are
    read) from a mangled instance of the fused loss's mainloop, else None."""
    m = re.search(r"xent_gemm_hopperI(13__nv_bfloat16|6__half)Lb([01])ELb([01])ENS_\d(Ds|Dw|Dh|Lse)Out", mangled)
    if m is None:
        return None
    dtype = "bf16" if "bfloat16" in m.group(1) else "fp16"
    epilogue = {"Lse": "lse", "Ds": "ds", "Dw": "dW", "Dh": "dH"}[m.group(4)]
    major = {"0": "K", "1": "MN"}
    return f"xent_gemm_hopper {dtype} {epilogue} A:{major[m.group(2)]} B:{major[m.group(3)]}"


def sparse_label(mangled):
    """'sparse_bwd_dkdv_hopper bf16 D64 B64' (the padded head dim, then the
    block, or PR 4's kernels' tile) from a mangled instance of a kernel of
    csrc/sparse_attention.cu, else None."""
    base = next((k for k in SPARSE_KERNELS if k in mangled), None)
    if base is None:
        return None
    tail = mangled.split(base, 1)[1]
    dtype = "bf16" if "nv_bfloat16" in tail else "fp16" if "__half" in tail else "fp32"
    ints = re.findall(r"Li(\d+)E", tail)[:2]
    return f"{base} {dtype} D{ints[0]} B{ints[1]}" if len(ints) == 2 else None


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


N_COUNTS = 9  # len(counts()); sparse_counts() follow it in a step's launches
N_SPARSE = 3  # len(sparse_counts())
COUNT_LABEL_9 = "[flash fwd, dK/dV, dQ, decode, xent fwd, combine, ds, dW, dH]"  # counts()
COUNT_LABEL = COUNT_LABEL_9[:-1] + ", sparse fwd, dQ, dK/dV]"


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
    ok = (all(step == [expect] * 3 + [0] * (N_COUNTS - 3 + N_SPARSE) for step in per_step)
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
    """Times at the training shape, bf16: the forward (its product and its
    combine, and each alone); the whole backward (dH and dW together: three
    kernels over each vocab chunk); each of its three kernels alone over
    every chunk in order; the plain versions; and, as reference points
    only, the cuBLAS [N, D]·[D, V] product the chunked loss runs and the
    unfused F.cross_entropy over it (neither the same function; the port
    never calls them for this loss)."""
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
    yl = y.long()
    unfused_ms = median_ms(lambda: torch.nn.functional.cross_entropy(h @ head, yl, ignore_index=-1,
                                                                     reduction="none"), flush, runs=10, warmup=2)
    # the forward's two kernels alone, on the parameter block fused_xent_forward builds
    hh, ww = fx.tma_operands(h, head)
    part = torch.empty(3, XN, fx.vocab_tiles(XV), dtype=torch.float32, device=dev)
    fwd_p = fx._params(hh, ww, y, nll=torch.empty(XN, device=dev), lse=torch.empty(XN, device=dev), part=part)
    fwd_kernels = {"product": median_ms(lambda: fx._launch("dstt_xent_fwd", fwd_p, dev), flush, runs=10, warmup=2),
                   "combine": median_ms(lambda: fx._launch("dstt_xent_fwd_combine", fwd_p, dev), flush, runs=20,
                                        warmup=2)}
    times = {"fused_xent_forward": {"ms": median_ms(lambda: fx.fused_xent_forward(h, head, y), flush, runs=10,
                                                   warmup=2),
                                    "plain_ms": median_ms(lambda: fx.fused_linear_xent_reference(h, head, y), flush,
                                                          runs=5, warmup=1),
                                    "product_ms": fwd_kernels["product"], "combine_ms": fwd_kernels["combine"],
                                    "unfused_cross_entropy_ms": unfused_ms}}
    for name in ("fused_xent_backward_dh", "fused_xent_backward_dw"):
        # the pair's kernels carry both rows: each row gives the pair's time and bound
        times[name] = {"ms": backward_ms, "plain_ms": plain_bwd, "pair_bound_ms": pair_bound,
                       "row_bound_ms": bounds[name][0], "passes": passes, "chunks": len(chunks),
                       "chunk_width": chunk}
    t = times["fused_xent_forward"]
    bound, by, nbytes, flops = bounds["fused_xent_forward"]
    t.update(bound_ms=bound, bound_by=by, library_ms=None, cublas_logits_ms=cublas_ms)
    print(f"  timing fused_xent_forward  bf16 N={XN} D={XD} V={XV}: kernels {t['ms']:8.3f} ms (the product "
          f"{t['product_ms']:.3f}, the combine {t['combine_ms']:.3f} alone), plain {t['plain_ms']:8.2f} ms, bound "
          f"{bound:.2f} ms ({by}: {nbytes/1e6:.1f} MB, {flops/1e12:.2f} TFLOP), "
          f"{flops / (t['ms'] * 1e-3) / 1e12:.1f} TFLOP/s; {t['ms'] / cublas_ms:.2f}x the cuBLAS logits product, "
          f"{t['ms'] / unfused_ms:.2f}x F.cross_entropy(h @ w) unfused ({unfused_ms:.3f} ms)")
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
          f"three products, and F.cross_entropy over it {unfused_ms:.2f} ms; the plain backward times dH and dW "
          f"together")
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
    expect = [L * gas] * 3 + [0] + [gas] * 2 + [gas * chunks] * 3 + [0] * N_SPARSE
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
    print(f"  launches per train_batch {COUNT_LABEL} {per_step} (expect {expect}: {gas} forward calls, each "
          f"the product and its combine; {gas} backward calls, each {chunks} vocab chunks x 3 kernels); losses {[round(x, 4) for x in losses]}; overflow {overflow}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused-loss remat training phase failed its checks")

    # nothing_saveable recomputes every layer, the flash forward included
    engine.model.config = engine.model.config.replace(remat_policy="nothing_saveable")
    before = counts()
    m = engine.train_batch(batch)
    step = [a - b for a, b in zip(counts(), before)]
    engine.model.config = engine.model.config.replace(remat_policy="dots_and_flash")
    expect_ns = [2 * L * gas, L * gas, L * gas, 0, gas, gas] + [gas * chunks] * 3
    ok = step == expect_ns and np.isfinite(float(m["loss"])) and not bool(m["overflow"])
    print(f"  one train_batch under nothing_saveable: launches {step} (expect {expect_ns}), "
          f"loss {float(m['loss']):.4f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("nothing_saveable did not recompute the flash forward")
    result["launches_per_train_batch_nothing_saveable"] = step
    result["backward_chunks"] = chunks

    if no_remat:
        result["no_remat"] = train_no_remat(batch, step_s)
    return launches[4:9], result, engine, batch


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


def sparse_case(dev, gen, dtype, layout, block, causal, B, H, D, label, view=False):
    """One kernel-vs-plain check of the three sparse kernels (the backward
    kernels get the plain forward's O and lse); raises on a disagreement.
    ``view``: q/k/v/dO are views 4 bytes past 16-byte alignment with strides
    of D + 4 elements. -> ({kernel: (max abs err, max rel err)}, dK, dV,
    lists)."""
    S = layout.shape[-1] * block
    q, k, v, dout = (torch.randn(B, S, H, D + 4 * view, generator=gen, device=dev).to(dtype)[..., 2 * view:2 * view + D]
                     for _ in range(4))
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

    def check(dtype, layout, block, causal, H, D, label="", view=False):
        errs, dk, dv, lists = sparse_case(dev, gen, dtype, layout, block, causal, 2, H, D, label, view)
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
    n += 2
    for block in sk.HOPPER_BLOCKS:
        layout = long_list_layout(block)
        for dtype in (torch.bfloat16, torch.float16):
            dk, dv, lists = check(dtype, layout, block, True, 4, 64,
                                  f"long lists ({layout.shape[0]} query blocks), block {block}, "
                                  "key block 3 unattended")
            rows = slice(3 * block, 4 * block)
            zero = dk[:, rows].abs().max().item() == 0.0 and dv[:, rows].abs().max().item() == 0.0
            print(f"    key block 3's dK and dV exactly 0: {zero}")
            if not zero:
                raise SystemExit("an unattended key block got non-zero dK/dV")
            check(dtype, layout, block, True, 2, 100, f"D=100 (padded), block {block}")
            check(dtype, layout, block, True, 2, 64, f"a view off 16 bytes (padded), block {block}", view=True)
            n += 3
    bitwise = sparse_bitwise(dev, gen)
    print(f"  the forward, dQ and dK/dV twice over dirty memory, bitwise equal: {bitwise}")
    if not bitwise:
        raise SystemExit("two sparse kernel calls gave different bits")
    empty = sparse_empty_list(dev, gen)
    print(f"  a query block with an empty list (blocks 64 and 128, causal and bidirectional): O = 0 and lse = "
          f"NEG_INF exactly, the rest within tolerance: {empty}")
    if not empty:
        raise SystemExit("the sparse forward mishandled an empty list")
    check(torch.bfloat16, slice_layout(), 64, True, 12, 64, "main path: fixed-64")
    print(f"  {n + 1} cases, every one within tolerance")
    torch.cuda.empty_cache()
    return worst


def long_list_layout(block):
    """Long lists (37 query blocks at block 64, 19 at 128): key blocks 0
    and 1 attended by every query block, key block 3 by none."""
    n = 37 if block == 64 else 19
    layout = np.eye(n, dtype=np.int64)
    layout[:, :2] = 1
    layout[3, 3] = 0
    return layout


def sparse_bitwise(dev, gen):
    """Whether two calls of the 16-bit forward, dQ and dK/dV into fresh
    buffers, over memory left dirty in between, give the same bits at blocks
    64 and 128."""
    for block in sk.HOPPER_BLOCKS:
        layout = long_list_layout(block)
        S = layout.shape[0] * block
        q, k, v, dout = (torch.randn(2, S, 12, 64, generator=gen, device=dev).bfloat16() for _ in range(4))
        lists = sk.device_lists(layout, True, S, dev)
        out, lse = sk.sparse_forward(q, k, v, lists)
        delta = fa.flash_delta(out, dout)
        runs = []
        for seed in range(2):
            torch.randn(64 * 2**20, device=dev, generator=torch.Generator(dev).manual_seed(seed))  # freed at once
            out2, lse2 = sk.sparse_forward(q, k, v, lists)
            dq = sk.sparse_backward_dq(q, k, v, dout, lse, delta, lists)
            dk, dv = sk.sparse_backward_dkdv(q, k, v, dout, lse, delta, lists)
            torch.cuda.synchronize()
            runs.append((out2, lse2, dq, dk, dv))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            return False
    return True


def sparse_empty_list(dev, gen):
    """Lists built by hand with query block 4 of 6 empty (no layout gives
    one): the 16-bit forward at blocks 64 and 128 writes O = 0 and
    lse = NEG_INF there exactly, over dirty memory, and matches the plain
    version everywhere. -> whether every case held."""
    for block in sk.HOPPER_BLOCKS:
        for causal in (True, False):
            arrays = list(sk.layout_to_lists(np.ones((6, 6), np.int64), causal))
            arrays[1][4] = 0
            tables = [torch.from_numpy(a).to(dev) for a in (*arrays, *sk.grid_orders(arrays[1], arrays[3]))]
            lists = sk.SparseLists(*tables[:4], block=block, dq_order=tables[4], dkdv_order=tables[5])
            q, k, v = (torch.randn(2, 6 * block, 12, 64, generator=gen, device=dev).bfloat16() for _ in range(3))
            torch.randn(64 * 2**20, device=dev, generator=torch.Generator(dev).manual_seed(block))  # freed at once
            out, lse = sk.sparse_forward(q, k, v, lists, causal=causal)
            ref_out, ref_lse = sk.sparse_attention_reference(q, k, v, lists, causal=causal)
            torch.cuda.synchronize()
            rows = slice(4 * block, 5 * block)
            if not (out[:, rows].abs().max().item() == 0.0 and bool((lse[:, :, rows] == sk.NEG_INF).all())
                    and (out.float() - ref_out.float()).abs().max().item() <= TOL[torch.bfloat16]
                    and (lse - ref_lse).abs().max().item() <= LSE_TOL):
                return False
    return True


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
        t.update(dense_flash_ms=flash[dense_name], dense_flash_ratio=t["ms"] / flash[dense_name],
                 library_ratio=t["ms"] / t["library_ms"], tflops=flops / (t["ms"] * 1e-3) / 1e12)
        print(f"    {name:<21} kernel {t['ms']*1e3:8.1f} us ({t['dense_flash_ratio']:.3f}x dense flash, "
              f"{t['library_ratio']:.3f}x sdpa+mask), plain {t['plain_ms']*1e3:9.1f} us, sdpa+mask "
              f"{t['library_ms']*1e3:8.1f} us, dense flash {flash[dense_name]*1e3:8.1f} us, bound "
              f"{bound*1e3:6.1f} us ({by}: {nbytes/1e6:.1f} MB, {flops/1e9:.1f} GFLOP), {t['tflops']:.1f} TFLOP/s")
    faster = {name: times[name]["dense_flash_ratio"] < 1 for name in SPARSE_NAMES}
    print(f"    faster than the dense flash kernel for the same output: forward {faster['sparse_forward']}, "
          f"dQ {faster['sparse_backward_dq']}, dK/dV {faster['sparse_backward_dkdv']}")
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
    expect = [L * gas] * 3 + [0] * (N_COUNTS - 3 + N_SPARSE)
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
    ok = small_err <= 1e-4 and launched == [20] * 3 and plain_launched == [0] * N_SPARSE
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


# Phase 18: the continuous-batching serving engine at GPT-2-125M width
# (inference/serving.py), its decode step one CUDA graph.
SERVE_SLOTS, SERVE_REQUESTS, SHARED_PREFIX = 16, 64, 512
SERVE_CONFIG = {"n_slots": SERVE_SLOTS, "seed": 0,
                "prefix_cache": {"enabled": True, "n_slots": 8, "max_prefix_len": SHARED_PREFIX},
                "chunked_prefill": {"enabled": True, "chunk_size": 256}}
SPEC_DEPTH = 8
RAGGED_RATE = 32.0  # Poisson arrivals of workload (b), requests per second
# First-token logits, serving vs generate's prefill, both bf16: the serving
# path fetches the 512-token prefix that another request's 256-token chunks
# wrote, and runs its own tail as one chunk over the whole slot window,
# where generate runs the prompt in one pass; the products round at other
# shapes and the difference passes through 12 layers.
FIRST_LOGITS_TOL = 0.25
PROFILE_SERVE_STEPS = 20


def shared_prefix_workload(vocab, seed=0):
    """benchmarks/serving_throughput.py:169-191: 64 requests, one 512-token
    system prompt shared by all, 8-48-token unique tails, 64-128 new
    tokens, all greedy; every request arrived at 0 (its Poisson draws are
    made and dropped, so the tokens are the benchmark's)."""
    from deepspeed_tpu_torch.inference import Request

    rng = np.random.default_rng(seed)
    rng.exponential(1.0, size=SERVE_REQUESTS)
    shared = rng.integers(0, vocab, size=SHARED_PREFIX).astype(np.int32)
    reqs = []
    for i in range(SERVE_REQUESTS):
        tail = rng.integers(0, vocab, size=int(rng.integers(8, 49))).astype(np.int32)
        reqs.append(Request(uid=i, prompt=np.concatenate([shared, tail]),
                            max_new_tokens=int(rng.integers(64, 129))))
    return reqs


def ragged_workload(vocab, rate, seed=0, uid0=0):
    """benchmarks/serving_throughput.py:147-166: 64 requests at Poisson
    arrivals of ``rate`` per second, 6-48-token prompts, 8-32 new tokens,
    half sampled at temperature 0.5-1.2, top-k < 20, top-p 0.8-1.0."""
    from deepspeed_tpu_torch.inference import Request

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=SERVE_REQUESTS))
    reqs = []
    for i in range(SERVE_REQUESTS):
        greedy = i % 2 == 0
        reqs.append(Request(
            uid=uid0 + i, prompt=rng.integers(0, vocab, size=int(rng.integers(6, 49))).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 33)),
            temperature=0.0 if greedy else float(rng.uniform(0.5, 1.2)),
            top_k=0 if greedy else int(rng.integers(0, 20)),
            top_p=1.0 if greedy else float(rng.uniform(0.8, 1.0)),
            arrival_time=float(arrivals[i])))
    return reqs


def serving_metrics(results, seconds):
    ok = [r for r in results.values() if r.ok]
    tokens = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft for r in ok]
    tpot = [r.time_per_output_token for r in ok if len(r.tokens) > 1]
    return {"requests": len(results), "ok": len(ok), "tokens": tokens, "seconds": seconds,
            "tokens_per_s": tokens / seconds, "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "tpot_p50_ms": float(np.percentile(tpot, 50)) * 1e3}


def serving_engine(engine, speculation):
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    srv = ServingEngine(engine, config={**SERVE_CONFIG, "watchdog_mode": "raise",
                                        "speculation": {"enabled": speculation, "depth": SPEC_DEPTH}})
    # a warm-up outside the measured runs: the graph capture, the allocator
    srv.serve([Request(uid=100000 + i, prompt=np.arange(1, 20 + i, dtype=np.int32), max_new_tokens=4)
               for i in range(2)])
    return srv


def record_first_logits(srv):
    """Wrap the worker's first-token sampling to keep each request's fp32
    first-token logits (instrumentation for the check; the engine is
    unchanged)."""
    w, last, kept = srv.worker, {}, {}
    sample, activate = w._sample_one, srv._activate

    def sample_one(logits, *a):
        last["logits"] = logits[0, 0].float().clone()
        return sample(logits, *a)

    def activate_(slot, req, *a, **kw):
        kept[req.uid] = last.pop("logits")
        return activate(slot, req, *a, **kw)

    w._sample_one, srv._activate = sample_one, activate_
    return kept


def run_workload(srv, reqs, label, smi):
    reset_counts()
    steps0, (s0, c0) = srv.worker._decode_steps, srv.worker.decode_kernel_launches()
    hits0 = (srv.prefix_cache_stats() or {}).get("hits", 0)
    occ = srv.telemetry.histogram("serving/slot_occupancy")
    occ_n, occ_sum = occ.count, occ.sum
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve(reqs)
    seconds = time.perf_counter() - t0
    m = serving_metrics(res, seconds)
    s1, c1 = srv.worker.decode_kernel_launches()
    m.update(decode_steps=srv.worker._decode_steps - steps0, split_launches=s1 - s0, combine_launches=c1 - c0,
             python_counter_launches=decode_attention.launches,
             slot_occupancy=(occ.sum - occ_sum) / max(occ.count - occ_n, 1))
    stats = srv.prefix_cache_stats()
    lookups = stats["hits"] + stats["misses"]
    m["prefix_hit_rate"] = stats["hits"] / lookups if lookups else 0.0
    m["prefix_hits"] = stats["hits"] - hits0
    spec = srv.spec_stats()
    if spec is not None:
        m["spec_acceptance_rate"], m["spec_drafted"], m["verify_steps"] = (
            spec["acceptance_rate"], spec["drafted"], spec["verify_steps"])
    print(f"  [{smi}] {label}: {m['ok']}/{m['requests']} ok, {m['tokens']} tokens in {seconds:.3f} s = "
          f"{m['tokens_per_s']:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; "
          f"TPOT p50 {m['tpot_p50_ms']:.3f} ms; slot occupancy {m['slot_occupancy']:.3f}; prefix hit rate "
          f"{m['prefix_hit_rate']:.3f}"
          + (f"; speculation acceptance {m['spec_acceptance_rate']:.3f} ({m['spec_drafted']} drafted, "
             f"{m['verify_steps']} verify calls)" if spec is not None else ""))
    expect = srv.cfg.num_layers
    ok = (m["ok"] == m["requests"] and m["split_launches"] == m["combine_launches"] == expect * m["decode_steps"]
          and srv.worker.graph_launches == (expect, expect) and srv.compile_counts()["decode"] == 1)
    print(f"    decode steps {m['decode_steps']} (graph replays), split/combine launches by the graph "
          f"{m['split_launches']}/{m['combine_launches']} (expect {expect} x {m['decode_steps']}), decode "
          f"programs {srv.compile_counts()['decode']}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"serving {label} failed its checks")
    return res, m


def replay_vs_eager(srv, dev):
    """One graph replay against the same step function called eagerly on a
    copy of the same state (cache and generator), bit for bit."""
    from deepspeed_tpu_torch.inference.serving import pack_decode_inputs

    w = srv.worker
    wpos = np.where(srv._active, srv._pos, w.Smax).astype(np.int32)
    packed = pack_decode_inputs(srv._last_tok, srv._pos, wpos, srv._active, srv._temp, srv._top_k, srv._top_p)
    cache0 = {kv: t.clone() for kv, t in w._cache.items()}
    gen0 = w._gen.get_state()
    out_graph = w._decode_program(packed)
    cache_graph = {kv: t.clone() for kv, t in w._cache.items()}
    for kv in cache0:
        w._cache[kv].copy_(cache0[kv])
    w._gen.set_state(gen0)
    out_eager = w.decode_step(torch.from_numpy(packed).to(dev)).cpu().numpy()
    same = bool(np.array_equal(out_graph, out_eager)) and all(torch.equal(w._cache[kv], cache_graph[kv])
                                                              for kv in cache0)
    print(f"  one graph replay vs the step function eagerly on a copy of the state ({srv.n_active} rows active, "
          f"{int((srv._temp[srv._active] > 0).sum())} sampled): packed output and cache bitwise equal: {same}")
    if not same:
        raise SystemExit("the decode graph's replay differs from the eager step")
    for kv in cache0:
        w._cache[kv].copy_(cache_graph[kv])
    return packed


def decode_step_times(srv, dev, packed, reps=100):
    """Host-clock ms per decode step on one state (every row active, writes
    dropped so the state does not change): the graph replay with its two
    copies, and the eager step function ending in a synchronise."""
    w = srv.worker
    packed = packed.copy()
    packed[2] = w.Smax  # wpos: every write dropped
    inp = torch.from_numpy(packed).to(dev)
    times = {}
    for name, fn in (("graph", lambda: w._decode_program(packed)),
                     ("eager", lambda: (w.decode_step(inp), torch.cuda.synchronize()))):
        for _ in range(5):
            fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        times[name] = statistics.median(ts) * 1e3
    return times


def profiled_kernel_counts(srv, steps=5):
    """Kernel records of ``steps`` serving steps under torch.profiler: the
    split and combine kernels against num_layers x the decode steps taken."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    s0 = srv.worker._decode_steps
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum("decode_split_kernel" in n for n in names), sum("decode_combine_kernel" in n for n in names),
            srv.worker._decode_steps - s0)


def serving_parity_small(dev):
    """Small fp32 model on the card: every greedy request's tokens equal
    generate's, speculation off and on."""
    from deepspeed_tpu_torch.inference import ServingEngine

    tiny = TransformerConfig(vocab_size=97, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=32)
    eng = deepspeed_tpu_torch.init_inference(Model(tiny), config={"dtype": "fp32"})
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 97, size=40).astype(np.int32)
    from deepspeed_tpu_torch.inference import Request

    reqs = [Request(uid=i, prompt=np.concatenate([shared, rng.integers(0, 97, size=int(rng.integers(3, 30)))])
                    .astype(np.int32), max_new_tokens=int(rng.integers(8, 40))) for i in range(12)]
    refs = {r.uid: eng.generate(r.prompt[None], max_new_tokens=r.max_new_tokens)[0] for r in reqs}
    for spec in (False, True):
        srv = ServingEngine(eng, config={"n_slots": 4, "prefix_cache": {"enabled": True, "n_slots": 4, "block": 8},
                                         "chunked_prefill": {"enabled": True, "chunk_size": 16},
                                         "speculation": {"enabled": spec, "depth": 4}})
        res = srv.serve(reqs)
        ok = all(np.array_equal(res[u].tokens, refs[u]) for u in refs) and srv.compile_counts()["decode"] == 1
        print(f"  small fp32 model, {len(reqs)} greedy requests through 4 slots, speculation "
              f"{'on' if spec else 'off'}: tokens == generate's for every request: {ok}")
        if not ok:
            raise SystemExit("serving's greedy tokens differ from generate's")


def first_token_check(engine, reqs, res, kept):
    """Each request's first-token logits against generate's prefill of its
    prompt, within FIRST_LOGITS_TOL; the first tokens agree, or where they
    do not, generate's top two logits lie within that tolerance (a near tie
    that logits differing by less than the tolerance may order either
    way), which is printed."""
    cfg, dev = engine.cfg, engine.device
    errs, agree, ties = [], 0, []
    with torch.inference_mode():
        for r in reqs:
            prompt = torch.from_numpy(r.prompt[None]).long().to(dev)
            cache = tfm.init_cache(cfg, 1, -(-len(r.prompt) // 128) * 128, device=dev)
            ref, _ = tfm.apply_with_cache(cfg, engine.params, prompt, cache, 0, last_only=True)
            ref = ref[0, -1].float()
            errs.append((kept[r.uid] - ref).abs().max().item())
            served = int(res[r.uid].tokens[0])
            if ref.argmax().item() == served:
                agree += 1
            else:
                ties.append((r.uid, (ref.max() - ref[served]).item()))
    err = max(errs)
    ok = err <= FIRST_LOGITS_TOL and all(gap <= FIRST_LOGITS_TOL for _, gap in ties)
    print(f"  full width bf16, workload (a): first-token logits vs generate's prefill, max_abs_err {err:.3e} "
          f"(tol {FIRST_LOGITS_TOL}), first tokens agree {agree}/{len(reqs)}; the others' gap between generate's "
          f"top logit and the served token's {[f'uid {u}: {g:.3e}' for u, g in ties]}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("serving's first tokens disagree with generate's prefill")
    return err


def serve_engine_phase(dev, smi, profile_dir=None):
    from deepspeed_tpu_torch.inference import Request

    cfg = TransformerConfig(vocab_size=50304, max_seq_len=1024, num_layers=12, num_heads=12,
                            hidden_size=768, pos_emb="learned", tie_embeddings=True)
    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
    vocab = engine.cfg.vocab_size
    out = {"config": {**SERVE_CONFIG, "speculation_depth": SPEC_DEPTH, "ragged_rate_per_s": RAGGED_RATE}}
    shared = shared_prefix_workload(vocab)

    srv = serving_engine(engine, speculation=False)
    w = srv.worker
    print(f"  slot cache {w._cache['k'].numel() * 2 * 2 / 1e9:.3f} GB, prefix pool "
          f"{w._pool['k'].numel() * 2 * 2 / 1e9:.3f} GB; the decode graph records {w.graph_launches} "
          f"(split, combine) launches a replay")
    kept = record_first_logits(srv)
    res, out["shared_prefix"] = run_workload(srv, shared, "workload (a) shared prefix, speculation off", smi)
    first_hit = min(r.first_token_time for r in res.values())
    late = [r for r in res.values() if r.admitted_time > first_hit]
    hits_ok = all(r.prefix_hit_tokens >= SHARED_PREFIX for r in late) and len(late) >= SERVE_REQUESTS - SERVE_SLOTS
    print(f"    prefix cache: {len(late)} requests admitted after the first prefix insert, each with "
          f"prefix_hit_tokens >= {SHARED_PREFIX}: {hits_ok} (hit tokens {sorted({r.prefix_hit_tokens for r in late})})")
    if not hits_ok:
        raise SystemExit("the prefix cache missed on workload (a)")
    out["first_token_logits_max_abs_err"] = first_token_check(engine, shared, res, kept)
    del w._sample_one, srv._activate  # the instrumentation off: the class's methods again
    greedy_off = {u: r.tokens for u, r in res.items()}

    ragged = ragged_workload(vocab, RAGGED_RATE, uid0=1000)
    res_b, out["ragged"] = run_workload(srv, ragged, f"workload (b) ragged, Poisson {RAGGED_RATE:g}/s", smi)
    in_range = all(((r.tokens >= 0) & (r.tokens < vocab)).all() for r in res_b.values())
    if not in_range:
        raise SystemExit("workload (b) produced tokens outside the vocabulary")

    # a mid-run state for the bitwise check, the step times and the profiler
    for r in ragged_workload(vocab, RAGGED_RATE, seed=1, uid0=2000)[:SERVE_SLOTS]:
        r.arrival_time = 0.0
        srv.submit(r)
    for _ in range(8):
        srv.step()
    packed = replay_vs_eager(srv, dev)
    times = decode_step_times(srv, dev, packed)
    out["decode_ms_per_step"] = times
    print(f"  [{smi}] decode ms/step on one state ({SERVE_SLOTS} rows): graph replay {times['graph']:.3f}, "
          f"eager step function {times['eager']:.3f} ({times['eager'] / times['graph']:.2f}x)")
    split, combine, steps = profiled_kernel_counts(srv)
    ok = split == combine == cfg.num_layers * steps and steps > 0
    print(f"  profiler over 5 serving steps: {split} split and {combine} combine kernel records for {steps} decode "
          f"steps (expect {cfg.num_layers} x {steps})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the profiler does not see the decode kernels in every graph replay")
    out["profiled_launches"] = {"split": split, "combine": combine, "decode_steps": steps}
    srv.drain()
    out["compile_counts"] = srv.compile_counts()
    del srv
    torch.cuda.empty_cache()

    srv = serving_engine(engine, speculation=True)
    res, out["shared_prefix_speculation"] = run_workload(
        srv, shared, f"workload (a) shared prefix, speculation on (depth {SPEC_DEPTH})", smi)
    # in bf16 the verify pass (plain cached attention over depth + 1
    # positions) and the decode kernel round differently, so greedy streams
    # may part where two logits nearly tie; the fp32 check below is exact
    same = sum(np.array_equal(greedy_off[u], r.tokens) for u, r in res.items())
    out["shared_prefix_speculation"]["greedy_streams_equal_to_speculation_off"] = same
    print(f"    greedy token streams identical to speculation off: {same}/{len(res)} (bf16; not required)")
    out["compile_counts_speculation"] = srv.compile_counts()
    if profile_dir:
        prof_srv = serving_engine(engine, speculation=False)
        for r in shared_prefix_workload(vocab, seed=3):
            prof_srv.submit(r)
        prof_srv.step()
        profile(f"serving_steps(x{PROFILE_SERVE_STEPS})",
                lambda: [prof_srv.step() for _ in range(PROFILE_SERVE_STEPS)], profile_dir)
        prof_srv.drain()
        del prof_srv
    del srv
    torch.cuda.empty_cache()
    serving_parity_small(dev)
    print(json.dumps({"serving_engine": out}))
    # the main path's launches: the three workload runs' graph replays
    runs = [out[k] for k in ("shared_prefix", "ragged", "shared_prefix_speculation")]
    return sum(m["split_launches"] for m in runs), sum(m["combine_launches"] for m in runs)


# ---------------------------------------------------------------------------
# Phase 19: training resilience at GPT-2-125M width
# ---------------------------------------------------------------------------

# Phase 10's model and config without remat (the drills' time), the fused
# loss and flash attention; drill engines share the seeded initial weights
RESILIENCE_MODEL = dict(loss_impl="fused_xent")
# the 3-call loop against train_batch, at full width in bf16 and on a small
# fp32 model: both loops run one accumulation and one update function on
# the same micro-batches through deterministic kernels (the loop adds a
# no-grad forward whose loss it returns), so the parameters and the losses
# must agree bitwise. A tolerance would not do at full width: AdamW moves
# an element by about lr whatever its gradient, so a dropped micro-batch
# would stay within any limit of the order of lr


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.state["params"]), tree_leaves(b.state["params"])))


def _max_param_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a.state["params"]),
                                                           tree_leaves(b.state["params"])))


def _drill(name, ok, detail):
    print(f"  {name}: {detail}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 19 drill failed: {name}")


def _timed(fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def three_call_step(engine, tokens):
    """One step of DeepSpeed's 3-call loop over the gas micro-batches of a
    train_batch-sized batch -> the forward losses."""
    gas = engine.gradient_accumulation_steps
    mb = tokens.shape[0] // gas
    losses = []
    for i in range(gas):
        loss = engine({"tokens": tokens[i * mb:(i + 1) * mb]})
        engine.backward(loss)
        engine.step()
        losses.append(loss)
    return losses


def loop_parity_small(dev):
    """A small fp32 model through the flash and fused-loss kernels: two
    steps of the 3-call loop against two train_batch steps."""
    cfg = TransformerConfig(vocab_size=1000, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=64,
                            attn_impl="flash", loss_impl="fused_xent")
    ds = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}}, "gradient_clipping": 1.0,
          "steps_per_print": 1000000}
    a = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds)[0]
    b = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds)[0]
    rng = np.random.default_rng(3)
    for _ in range(2):
        tokens = rng.integers(0, 1000, size=(8, 257)).astype(np.int32)
        a.train_batch({"tokens": tokens})
        three_call_step(b, tokens)
    return _max_param_diff(a, b)


def resilience_phase(dev, smi):
    """Phase 19: the nine drills, the 3-call loop and the timings -> result."""
    B, S = BENCH_DS["train_batch_size"], FS
    gas = BENCH_DS["gradient_accumulation_steps"]
    rng = np.random.default_rng(19)
    bs = [rng.integers(0, 50304, size=(B, S + 1)).astype(np.int32) for _ in range(6)]

    def model():
        return Model(gpt2_config(**RESILIENCE_MODEL))

    root = tempfile.mkdtemp(prefix="dstt_resilience_")
    out = {"config": {"model": "GPT-2-125M", "micro": BENCH_DS["train_micro_batch_size_per_gpu"], "gas": gas,
                      "seq": S, "remat": False, "loss_impl": "fused_xent", "attn_impl": "flash"}}
    csv_dir = os.path.join(root, "csv")
    try:
        reset_counts()
        clean = deepspeed_tpu_torch.initialize(model=model(), config=BENCH_DS)[0]
        guarded = deepspeed_tpu_torch.initialize(model=model(), config={**BENCH_DS, "resilience": {
            "enabled": True, "max_consecutive_bad_steps": 2, "retry": {"base_delay_s": 0.01},
            "preemption": {"enabled": True, "signals": ["SIGTERM"], "save_dir": os.path.join(root, "jit")},
            "fault_injection": {"enabled": True, "nan_grad_steps": [3, 6, 7]}}})[0]

        # 1. NaN skip: 4 clean steps against 5 with step 3 poisoned by a +inf loss scale
        for t in bs[:4]:
            clean.train_batch({"tokens": t})
        skipped_metrics = None
        for i, t in enumerate(bs[:2] + [bs[5]] + bs[2:4]):
            m = guarded.train_batch({"tokens": t})
            if i == 2:
                skipped_metrics = (bool(m["overflow"]), float(m["grad_norm"]))
        ok = (guarded.skipped_steps == 1 and skipped_metrics[0] and not np.isfinite(skipped_metrics[1])
              and guarded.loss_scale == 1.0 and _params_equal(guarded, clean))
        _drill("1 NaN skip", ok, f"skipped_steps {guarded.skipped_steps}, the poisoned step's overflow "
               f"{skipped_metrics[0]} and grad norm {skipped_metrics[1]}, parameters bitwise equal to 4 clean steps")

        # 2. rewind: save a good tag, then NaN at steps 6 and 7 (max_consecutive_bad_steps 2)
        good = os.path.join(root, "good")
        guarded.save_checkpoint(good, tag="g5")
        guarded.train_batch({"tokens": bs[4]})
        guarded.train_batch({"tokens": bs[4]})
        counters = guarded.telemetry.registry.snapshot()["counters"]
        ok = (counters.get("resilience/rewinds") == 1 and guarded.global_steps == 5
              and guarded.get_global_step() == 4 and _params_equal(guarded, clean))
        _drill("2 rewind", ok, f"rewinds {counters.get('resilience/rewinds')}, host step {guarded.global_steps}, "
               "parameters bitwise equal to the g5 tag's")

        # 3. preemption by a real SIGTERM: a JIT checkpoint, then a fresh engine resumes
        import signal
        os.kill(os.getpid(), signal.SIGTERM)
        try:
            guarded.train_batch({"tokens": bs[4]})
            raised = False
        except PreemptionSignal:
            raised = True
        jit_s = guarded.telemetry.registry.snapshot()["histograms"]["resilience/jit_ckpt_sec"]["sum"]
        out["jit_checkpoint_s"] = jit_s
        resumed = deepspeed_tpu_torch.initialize(model=model(), config={
            **BENCH_DS, "checkpoint": {"async_save": True},
            "csv_monitor": {"enabled": True, "output_path": csv_dir, "job_name": "phase19"}})[0]
        tag, _ = resumed.load_checkpoint(os.path.join(root, "jit"))
        resumed.train_batch({"tokens": bs[4]})
        clean.train_batch({"tokens": bs[4]})
        ok = raised and tag == "preempt" and _params_equal(resumed, clean)
        _drill("3 preemption", ok, f"SIGTERM -> PreemptionSignal {raised}, JIT checkpoint {jit_s:.2f} s, a fresh "
               f"engine loads {tag!r} and one more step equals the clean run's bitwise")

        # 4. a transient write failure is retried (the fresh engine of drill
        # 3 took the process's injector slot, which the saver consults)
        inj = guarded.fault_injector
        install_injector(inj)
        inj.io_flaky_writes = {inj.stats()["guarded_writes"] + 3}
        guarded.save_checkpoint(good, tag="flaky")
        retries = guarded.telemetry.registry.snapshot()["counters"].get("resilience/ckpt_retries")
        _drill("4 transient write failure", retries == 1 and open(os.path.join(good, "latest")).read() == "flaky",
               f"resilience/ckpt_retries {retries}, 'latest' -> flaky")

        # 5. a permanent one raises and leaves 'latest' on the intact tag
        inj.io_error_writes = {inj.stats()["guarded_writes"] + 5}
        try:
            guarded.save_checkpoint(good, tag="broken")
            perm = False
        except PermanentIOError:
            perm = True
        latest = open(os.path.join(good, "latest")).read()
        ok = perm and latest == "flaky" and not os.path.exists(os.path.join(good, "broken"))
        _drill("5 permanent write failure", ok, f"PermanentIOError {perm}, 'latest' -> {latest}, no 'broken' tag")

        # 6. async save: returns after the snapshot; a step runs; commit; then
        # the same state (cloned before the save) saved synchronously
        snapshot = tree_map(torch.clone, resumed.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.save_checkpoint(os.path.join(root, "async"), tag="a")
        out["async_save_blocks_s"] = time.perf_counter() - t0
        resumed.train_batch({"tokens": bs[0]})  # the next step while the writer runs
        t0 = time.perf_counter()
        resumed.checkpoint_engine.commit()
        out["async_commit_s"] = time.perf_counter() - t0
        clean.state = snapshot
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean.save_checkpoint(os.path.join(root, "sync"), tag="a")
        out["sync_save_blocks_s"] = time.perf_counter() - t0
        del snapshot
        man = [json.load(open(os.path.join(root, d, "a", "manifest.json"))) for d in ("async", "sync")]
        guarded.load_checkpoint(os.path.join(root, "async"))
        reference = deepspeed_tpu_torch.initialize(model=model(), config=BENCH_DS)[0]
        reference.load_checkpoint(os.path.join(root, "sync"))
        ok = (man[0]["checksums"] == man[1]["checksums"] and man[0]["leaves"] == man[1]["leaves"]
              and all(torch.equal(x, y) for x, y in zip(tree_leaves(guarded.state), tree_leaves(reference.state))))
        _drill("6 async save", ok, f"blocks the caller {out['async_save_blocks_s']:.3f} s, commit after one step "
               f"{out['async_commit_s']:.2f} s; a synchronous save blocks {out['sync_save_blocks_s']:.2f} s; the "
               "loaded states and the files' crc32 equal")

        # 7. the 3-call loop (guarded, from the async save) against train_batch
        # (reference, from the sync save): two steps from the same state
        launches = {}
        tb_losses, loop_losses = [], []
        steps = {"train_batch": lambda t: tb_losses.append(float(reference.train_batch({"tokens": t})["loss"])),
                 "three_call": lambda t: loop_losses.append(float(sum(three_call_step(guarded, t))) / gas)}
        for label, fn in steps.items():
            before = counts()
            for t in bs[1:3]:
                fn(t)
            launches[label] = [(a - b) // 2 for a, b in zip(counts(), before)]
        diff = _max_param_diff(guarded, reference)
        differing = sum(int((x != y).sum()) for x, y in zip(tree_leaves(guarded.state["params"]),
                                                            tree_leaves(reference.state["params"])))
        rel = max(abs(a - b) / abs(b) for a, b in zip(loop_losses, tb_losses))
        # the GPT-2-width engines' launches over drills 1-7 (the SIGTERM
        # step raises before it launches), before the small model's
        out["launches"] = counts()
        small = loop_parity_small(dev)
        chunks = len(fx.vocab_chunks(50304, fx.backward_chunk(B // gas * S, 50304, 2)))
        L = 12
        want_tb = [L * gas] * 3 + [0, gas, gas] + [gas * chunks] * 3
        want_loop = [2 * L * gas, L * gas, L * gas, 0, 2 * gas, 2 * gas] + [gas * chunks] * 3
        ok = (differing == 0 and loop_losses == tb_losses and small == 0.0
              and launches["train_batch"] == want_tb and launches["three_call"] == want_loop)
        out["three_call"] = {"max_param_diff": diff, "params_differing": differing, "max_loss_rel_diff": rel,
                             "small_fp32_max_param_diff": small,
                             "losses": loop_losses, "train_batch_losses": tb_losses, "launches_per_step": launches,
                             "tolerance": "bitwise"}
        _drill("7 3-call loop", ok, f"two steps: params max |diff| {diff:.3e} ({differing} elements differ), "
               f"losses max rel diff {rel:.3e}, small fp32 model {small:.3e} (all bitwise: expect 0); "
               f"launches per step {COUNT_LABEL_9} train_batch {launches['train_batch']} (expect {want_tb}), "
               f"3-call {launches['three_call']} (expect {want_loop})")

        # 8. save_16bit_model, read back with torch.load
        reference.save_16bit_model(os.path.join(root, "w16"))
        sd = torch.load(os.path.join(root, "w16", "model_weights.pt"))
        params = reference.state["params"]
        want = {"wte": params["wte"], "wpe": params["wpe"], "lnf_scale": params["lnf_scale"],
                "lnf_bias": params["lnf_bias"], **{f"layers/{k}": v for k, v in params["layers"].items()}}
        ok = (sorted(sd) == sorted(want) and all(sd[k].dtype == torch.bfloat16 for k in sd)
              and all(torch.equal(sd[k], v.to(torch.bfloat16).cpu()) for k, v in want.items()))
        _drill("8 save_16bit_model", ok, f"{len(sd)} bf16 tensors read back with torch.load, bitwise the "
               "engine's bf16 cast")

        # 9. the CSV monitor: one row per train_batch of the resumed engine
        resumed.monitor.close()
        rows = {f: open(os.path.join(csv_dir, "phase19", f)).read().splitlines()[1:]
                for f in sorted(os.listdir(os.path.join(csv_dir, "phase19")))}
        ok = sorted(rows) == ["Train_Samples_lr.csv", "Train_Samples_train_loss.csv"] and all(
            len(r) == 2 for r in rows.values())
        _drill("9 CSV monitor", ok, f"{ {k: len(v) for k, v in rows.items()} } rows for 2 train_batch calls")
        del resumed, clean

        # timings: guardrail off vs on, 3-call loop vs train_batch
        for e in (reference, guarded):
            e.train_batch({"tokens": bs[0]})
        out["step_ms_guardrail_off"] = _timed(lambda: reference.train_batch({"tokens": bs[0]}), TRAIN_STEPS)
        out["step_ms_guardrail_on"] = _timed(lambda: guarded.train_batch({"tokens": bs[0]}), TRAIN_STEPS)
        out["step_ms_three_call"] = _timed(lambda: three_call_step(reference, bs[0]), TRAIN_STEPS)
        print(f"  [{smi}] step ms: guardrail off {out['step_ms_guardrail_off']:.1f}, on "
              f"{out['step_ms_guardrail_on']:.1f}; 3-call loop {out['step_ms_three_call']:.1f} vs train_batch "
              f"{out['step_ms_guardrail_off']:.1f}; JIT checkpoint {jit_s:.2f} s; save blocks the caller: sync "
              f"{out['sync_save_blocks_s']:.2f} s, async {out['async_save_blocks_s']:.3f} s (+ commit "
              f"{out['async_commit_s']:.2f} s)")
        del guarded, reference
    finally:
        deactivate_guard()  # SIGTERM is the default's again
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["card"] = smi
    print(json.dumps({"resilience": out}))
    return out


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


# ---------------------------------------------------------------------------
# Phase 20: the serving fleet (inference/router.py, journal.py, rpc.py,
# launcher/serving_worker.py) at GPT-2-125M width
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 2
KILL_STEP = 10  # benchmarks/serving_throughput.py --kill-step 10
FLEET_HEALTH = {"timeout": 30.0}
PROFILE_STEPS = 3  # a worker's profiled decoding steps, after the timed run
JOURNAL_CRASH_STEP = 20
# the worker processes' transport: their boots (interpreter, CUDA context,
# weights, the decode kernel's library and graph) and the first steps
# take seconds, not the JAX defaults' budget
FLEET_TRANSPORT = {"family": "unix", "call_timeout_s": 120.0, "boot_timeout_s": 300.0,
                   "heartbeat_timeout_s": 60.0, "base_delay_s": 0.05, "max_delay_s": 0.2}
GPT2_SPEC = dict(vocab_size=50304, max_seq_len=1024, num_layers=12, num_heads=12, hidden_size=768,
                 pos_emb="learned", tie_embeddings=True)


def fleet_config(serve_config, **extra):
    return {**serve_config, "watchdog_mode": "raise",
            "router": {"replicas": FLEET_REPLICAS, "health": dict(FLEET_HEALTH)}, **extra}


def serve_fleet(router, reqs, on_step=None):
    """Router.serve, with ``on_step(router)`` called after every step (the
    kill drill's hook); returns (results, seconds)."""
    router._epoch = time.perf_counter()
    for r in router._replicas:
        r.engine.set_epoch(router._epoch)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = {router.submit(r) for r in sorted(reqs, key=lambda r: r.arrival_time)}
    while not uids <= set(router.results):
        now = router.now()
        stepped = [r for r in router._replicas if r.stepped]
        if all(r.engine.idle for r in stepped):
            pending = [t for r in stepped for t in r.engine.pending_arrival_times()]
            if pending and min(pending) > now:
                time.sleep(min(min(pending) - now, 0.05))
        router.step()
        if on_step is not None:
            on_step(router)
    seconds = time.perf_counter() - t0
    return {u: router.result(u) for u in uids}, seconds


def replica_bytes(engine):
    w = engine.worker
    return sum(t.numel() * t.element_size() for pool in (w._cache, w._pool) if pool is not None
               for t in pool.values())


def check_fleet_contract(router, res, label, killed):
    """benchmarks/serving_throughput.py:363-384: every request terminal, the
    failover counters, and every survivor idle with its slots accounted."""
    stats = router.router_stats()
    counters = router.telemetry.registry.snapshot()["counters"]
    survivors = [r for r in router._replicas if r.state != "dead"]
    slots_ok = all(r.engine.n_active == 0 and r.engine.n_prefilling == 0
                   and r.engine.n_free + len(r.engine.quarantined_slots) == r.engine.n_slots for r in survivors)
    terminal = all(x is not None for x in res.values())
    failover_ok = (not killed) or (counters.get("router/failovers", 0) > 0 and stats["failovers_recovered"] > 0)
    decode_ok = all(r.engine.compile_counts()["decode"] == 1 for r in router._replicas)
    ok = terminal and slots_ok and failover_ok and decode_ok
    print(f"    contract: every request terminal {terminal}; router/failovers {counters.get('router/failovers', 0)}, "
          f"failovers_recovered {stats['failovers_recovered']}, failed_replica "
          f"{sum(r.status == 'failed_replica' for r in res.values())}; survivors idle with n_free + quarantined "
          f"= n_slots {slots_ok}; one decode program a replica {decode_ok} "
          f"{[r.engine.compile_counts()['decode'] for r in router._replicas]}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"fleet {label} failed the benchmark's contract")
    return stats, counters


def replica_launches(router, expect):
    """(split, combine) decode-kernel launches per replica: the launches one
    replay makes, counted by the wrappers at capture (num_layers each),
    times the graph's replays. The product holds by construction; the
    profiler's kernel records (fleet_profiled_launches) measure it."""
    out, ok = [], True
    for r in router._replicas:
        w = r.engine.worker
        split, combine = w.decode_kernel_launches()
        replays = w.graph_replays
        ok &= w.graph_launches == (expect, expect) and split == combine == expect * replays
        out.append({"rid": r.rid, "state": r.state, "replays": replays, "split": split, "combine": combine})
    return out, ok


def run_fleet(router, reqs, label, smi, expect, on_step=None, killed=False):
    before = [r.engine.worker.decode_kernel_launches() for r in router._replicas]
    res, seconds = serve_fleet(router, reqs, on_step)
    m = serving_metrics(res, seconds)
    stats, counters = check_fleet_contract(router, res, label, killed)
    launches, ok = replica_launches(router, expect)
    for entry, (s0, c0) in zip(launches, before):
        entry["split_in_run"], entry["combine_in_run"] = entry["split"] - s0, entry["combine"] - c0
    m.update(replicas=launches, failovers=counters.get("router/failovers", 0),
             failovers_recovered=stats["failovers_recovered"],
             states=router.replica_states())
    print(f"  [{smi}] {label}: {m['ok']}/{m['requests']} ok, {m['tokens']} tokens in {seconds:.3f} s = "
          f"{m['tokens_per_s']:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; "
          f"TPOT p50 {m['tpot_p50_ms']:.3f} ms; replica states {m['states']}")
    total = (sum(e["split"] for e in launches), sum(e["combine"] for e in launches))
    replays = sum(e["replays"] for e in launches)
    print(f"    decode launches by the replicas' graphs (split, combine) {[(e['split'], e['combine']) for e in launches]}"
          f" = {total} for {replays} replays (the capture's {expect} x replays each, by construction)  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"fleet {label}: the decode launches do not match the replays")
    return res, m


def fleet_profiled_launches(router, vocab, steps=3):
    """torch.profiler's kernel records over a few fleet steps: the split
    and combine kernels against num_layers x the replays the replicas
    made in that window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for r in ragged_workload(vocab, RAGGED_RATE, seed=4, uid0=5000)[:2 * FLEET_REPLICAS]:
        r.arrival_time = 0.0
        router.submit(r)
    router.step()
    router.step()
    before = sum(r.engine.worker.graph_replays for r in router._replicas)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            router.step()
        torch.cuda.synchronize()
    replays = sum(r.engine.worker.graph_replays for r in router._replicas) - before
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    router.drain()
    return (sum("decode_split_kernel" in n for n in names), sum("decode_combine_kernel" in n for n in names),
            replays)


def failover_timing(router, res):
    """(seconds from the kill to the last failed-over request's admission
    on its survivor, the failed-over uids), on the fleet clock."""
    ev = [e for e in router.tracer.events() if e["event"] == "failover" and "to_replica" in e]
    if not ev:
        return None, []
    t_kill = min(e["t"] for e in ev)
    uids = sorted({e["uid"] for e in ev})
    return max(res[u].admitted_time for u in uids) - t_kill, uids


def fleet_parity_small(dev):
    """A small fp32 fleet on the card: the replica_dead kill's completed
    greedy streams equal the unfaulted fleet's and generate's (the JAX
    Router's contract: a replay prefills from scratch on a clean replica)."""
    from deepspeed_tpu_torch.inference import Request, Router

    tiny = TransformerConfig(vocab_size=97, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=32)
    eng = deepspeed_tpu_torch.init_inference(Model(tiny), config={"dtype": "fp32"}, device=dev)
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, 97, size=int(rng.integers(4, 40))).astype(np.int32), int(rng.integers(8, 40)))
             for _ in range(12)]
    out = {}
    for label, fi in (("unfaulted", None), ("killed", {"enabled": True, "replica_dead_at": [[0, 3]]})):
        cfg = {"n_slots": 4, "router": {"replicas": 2, "health": dict(FLEET_HEALTH)}}
        if fi:
            cfg["fault_injection"] = fi
        router = Router(eng, config=cfg)
        res = router.serve([Request(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(specs)])
        out[label] = (res, router.telemetry.registry.snapshot()["counters"].get("router/failovers", 0))
    refs = [eng.generate(p[None], max_new_tokens=n)[0] for p, n in specs]
    (res_a, _), (res_b, failovers) = out["unfaulted"], out["killed"]
    same = all(res_b[i].ok and np.array_equal(res_b[i].tokens, res_a[i].tokens)
               and np.array_equal(res_b[i].tokens, refs[i]) for i in range(len(specs)))
    ok = same and failovers > 0
    print(f"  small fp32 fleet (2 layers, prefix cache off), 2 replicas, replica 0 killed at router step 3: "
          f"{failovers} failovers; every greedy request's tokens == the unfaulted fleet's == generate's: {same}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fp32 fleet's failed-over streams differ from the unfaulted run")
    return {"failovers": failovers, "tokens_equal": same}


def journal_drill(engine, serve_config, vocab, smi):
    """Router with the journal (fsync on) crashed by router_crash_at, then
    a new Router over the same journal and the surviving replicas: every
    accepted request ends in exactly one terminal."""
    from deepspeed_tpu_torch.inference import Router, ServingEngine
    from deepspeed_tpu_torch.inference.journal import replay
    from deepspeed_tpu_torch.resilience import ControlPlaneCrash

    d = tempfile.mkdtemp(prefix="dstt_journal_")
    try:
        path = os.path.join(d, "router.journal")
        reps = [ServingEngine(engine, config={**serve_config, "watchdog_mode": "raise"}, replica_id=i)
                for i in range(FLEET_REPLICAS)]
        for r in reps:
            r.warm_decode()
        rc = {"replicas": FLEET_REPLICAS, "health": dict(FLEET_HEALTH),
              "journal": {"enabled": True, "path": path, "fsync": True}}
        a = Router(config={"router": rc, "fault_injection": {"enabled": True, "router_crash_at": [JOURNAL_CRASH_STEP]}},
                   replica_engines=reps)
        reqs = ragged_workload(vocab, RAGGED_RATE, seed=6, uid0=7000)
        for r in reqs:
            r.arrival_time = 0.0
        accepted = [a.submit(r) for r in reqs]
        first = []
        crashed = False
        try:
            for _ in range(10 * JOURNAL_CRASH_STEP):
                first += a.step()
        except ControlPlaneCrash:
            crashed = True
        a._journal.close()  # what the OS does for the killed process
        del a
        t0 = time.perf_counter()
        b = Router(config={"router": rc}, replica_engines=reps)
        recovery_s = time.perf_counter() - t0
        counters = {k.split("/")[-1]: v for k, v in b.telemetry.registry.snapshot()["counters"].items()
                    if k.startswith("router/recovery/")}
        second = []
        while b._owner or b._pending_terminal:
            second += b.step(now=float("inf"), enforce_deadlines=False)
        delivered = first + second
        st = replay(path)
        once = sorted(delivered) == sorted(accepted) and len(set(delivered)) == len(delivered)
        ok = (crashed and once and set(st.terminals) == set(accepted) and not st.requests
              and all(b.result(u) is not None and b.result(u).ok for u in accepted))
        print(f"  [{smi}] journal drill (fsync on): router_crash at step {JOURNAL_CRASH_STEP} with "
              f"{len(first)} of {len(accepted)} terminal; recovery {recovery_s * 1e3:.1f} ms ({counters}); every "
              f"accepted request delivered exactly once ({len(delivered)} terminal uids, no duplicate, no loss): "
              f"{once}; the journal replays {len(st.terminals)} terminals, {len(st.requests)} live  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the journal drill lost or duplicated a request")
        out = {"recovery_s": recovery_s, "terminal_before_crash": len(first), "accepted": len(accepted),
               "recovery_counters": counters, "journal_records": st.records}
        del b, reps
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _socket_dir():
    """A short directory for the workers' unix sockets (AF_UNIX paths stop
    at ~108 bytes): the system temp directory, or one under the working
    directory used by a relative path when that is too long."""
    d = tempfile.mkdtemp(prefix="dstt_fleet_")
    if len(d) + len("/w0g0.sock") < 100:
        return d, d
    shutil.rmtree(d, ignore_errors=True)
    d = tempfile.mkdtemp(prefix="dstt_fleet_", dir=".")
    return d, os.path.relpath(d)


def worker_fleet(serve_config, vocab, smi, device="cuda", model_spec=None, engine_dtype="bf16"):
    """Two worker processes under a WorkerSupervisor, a Router over their
    ReplicaClients; worker 0 SIGKILLed after router step KILL_STEP, its
    requests failed over, the worker respawned and attached; every request
    terminal; each worker's decode launches as it reports them; SIGTERM
    drains."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.inference import Request, Router
    from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor

    model = {**(model_spec or GPT2_SPEC), "dtype": "float32"}
    spec = {"model": model, "engine_dtype": engine_dtype, "serving": {**serve_config, "watchdog_mode": "raise"}}
    real, workdir = _socket_dir()
    sup = WorkerSupervisor(spec, FLEET_REPLICAS, workdir=workdir, transport=FLEET_TRANSPORT, device=device,
                           respawn_backoff={"max_attempts": 10, "base_delay_s": 0.05, "max_delay_s": 0.1,
                                            "jitter": 0.0})
    out = {}
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(FLEET_REPLICAS) as ex:  # both boot at once
            clients = list(ex.map(sup.spawn, range(FLEET_REPLICAS)))
        out["boot_s"] = time.perf_counter() - t0
        router = Router(config={"router": {"replicas": FLEET_REPLICAS, "health": dict(FLEET_HEALTH),
                                           "transport": FLEET_TRANSPORT}}, replica_engines=clients)
        reported, records = {}, {}
        killed = {}

        def read(slot, client):
            snap = client.telemetry_snapshot()
            reported[slot], records[slot] = snap["decode_kernel_launches"], snap["decode_kernel_records"]

        def kill_after(r):
            if r._steps == KILL_STEP and not killed:
                read(0, clients[0])
                sup.kill(0, signal.SIGKILL)
                killed["t"] = r.now()

        reqs = ragged_workload(vocab, RAGGED_RATE, uid0=9000)
        res, seconds = serve_fleet(router, reqs, kill_after)
        m = serving_metrics(res, seconds)
        counters = router.telemetry.registry.snapshot()["counters"]
        terminal = all(x is not None for x in res.values())
        dead_ok = router.replica_states()[0] == "dead" and counters.get("router/failovers", 0) > 0
        print(f"  [{smi}] worker processes ({FLEET_REPLICAS}, unix sockets, {device}): booted together in "
              f"{out['boot_s']:.1f} s; worker 0 SIGKILLed after router step {KILL_STEP}: {m['ok']}/{m['requests']} "
              f"ok, {m['tokens']} tokens in {seconds:.3f} s = {m['tokens_per_s']:.1f} tokens/s; TTFT p50 "
              f"{m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; TPOT p50 {m['tpot_p50_ms']:.3f} ms; "
              f"DEAD verdict and {counters.get('router/failovers', 0)} failovers from the Router's copies: "
              f"{dead_ok}; every request terminal {terminal}")
        if not (terminal and dead_ok):
            raise SystemExit("the worker fleet did not fail over the killed worker's requests")
        bad = sup.poll()
        t0 = time.perf_counter()
        fresh = sup.respawn(0)
        out["respawn_s"] = time.perf_counter() - t0
        rid = router.attach_replica(fresh)
        # after the timed run: each live worker traces its next
        # PROFILE_STEPS decoding steps (the decode kernels' device records
        # beside its graph replays in that window)
        for client in (clients[1], fresh):
            client.rpc.call("profile_decode_steps", steps=PROFILE_STEPS)
        extra = [Request(uid=9900 + i, prompt=np.arange(1, 30 + i, dtype=np.int32), max_new_tokens=8)
                 for i in range(2)]
        for r in extra:
            router.submit(r)
        owners = [router.owner_of(r.uid) for r in extra]
        done = router.drain()
        attach_ok = bad == [0] and rid in owners and all(done[r.uid].ok for r in extra)
        print(f"    supervisor: poll() {bad}, respawned worker 0 in {out['respawn_s']:.1f} s, attached as replica "
              f"{rid}; two new requests owned by {owners} and ok: {attach_ok}")
        if not attach_ok:
            raise SystemExit("the respawned worker did not rejoin the fleet")
        for slot, client in ((1, clients[1]), (2, fresh)):
            read(slot, client)
        sup.shutdown(signal.SIGTERM, timeout=120.0)
        drained = {}
        for slot in range(FLEET_REPLICAS):
            lines = [json.loads(x) for x in open(sup._logs[slot]) if x.startswith("{")]
            ev = [e for e in lines if e.get("event") == "drained"]
            drained[slot] = (sup.proc(slot).returncode, ev[0] if ev else None)
        drain_ok = all(rc == 0 and ev is not None for rc, ev in drained.values())
        L = model["num_layers"]
        launches_ok = device != "cuda" or all(
            v[0] > 0 and v[0] == v[1] for v in reported.values()) and all(
            records[k] is not None and records[k]["replays"] > 0
            and records[k]["split"] == records[k]["combine"] == L * records[k]["replays"] for k in (1, 2))
        print(f"    decode-kernel launches (split, combine) as each worker reported them, its warm-up replay "
              f"excluded: worker 0 before its kill {reported[0]}, worker 1 {reported[1]}, the respawned worker "
              f"{reported[2]}; worker 1's and the respawned worker's profiler over {PROFILE_STEPS} decoding steps "
              f"after the timed run (split and combine kernel records, replays; expect {L} x replays): "
              f"{[(k, r and (r['split'], r['combine'], r['replays'])) for k, r in records.items() if k]}  "
              f"{'ok' if launches_ok else 'FAIL'}; SIGTERM: exit codes and drained lines "
              f"{[(rc, ev and ev['decode_kernel_launches']) for rc, ev in drained.values()]}  "
              f"{'ok' if drain_ok else 'FAIL'}")
        if not (launches_ok and drain_ok):
            raise SystemExit("a worker launched no decode kernel, its profiler saw other than num_layers split "
                             "and combine kernels a replay, or it did not drain on SIGTERM")
        out.update(metrics=m, failovers=counters.get("router/failovers", 0), reported_launches=reported,
                   profiled_launches=records, drained={s: ev for s, (_, ev) in drained.items()})
        return out
    finally:
        sup.shutdown(signal.SIGKILL, timeout=10.0)
        shutil.rmtree(real, ignore_errors=True)


def fleet_phase(dev, smi, model_cfg=None, serve_config=None, vocab_cap=None):
    """Phase 20. ``model_cfg``/``serve_config`` default to phase 18's
    (GPT-2-125M, bf16); a smaller pair rehearses the phase's control flow."""
    from deepspeed_tpu_torch.inference import Router

    cuda = dev.type == "cuda"
    cfg = model_cfg or TransformerConfig(**GPT2_SPEC)
    expect = cfg.num_layers if cuda else 0  # decode-kernel launches a replay
    serve_config = serve_config or SERVE_CONFIG
    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16" if model_cfg is None else "fp32"},
                                                device=dev)
    vocab = vocab_cap or engine.cfg.vocab_size
    out = {"config": {**serve_config, "replicas": FLEET_REPLICAS, "kill_step": KILL_STEP,
                      "health": FLEET_HEALTH, "ragged_rate_per_s": RAGGED_RATE}}
    reset_counts()

    # one engine, the yardstick
    srv = serving_engine(engine, speculation=False) if model_cfg is None else None
    if srv is not None:
        _, out["one_engine"] = run_workload(srv, ragged_workload(vocab, RAGGED_RATE), "one engine, workload (b)", smi)
        del srv
    # two in-process replicas, unfaulted
    router = Router(engine, config=fleet_config(serve_config))
    for r in router._replicas:
        r.engine.warm_decode()
    workload = ragged_workload(vocab, RAGGED_RATE)
    res_a, out["two_replicas"] = run_fleet(router, workload, f"{FLEET_REPLICAS} in-process replicas, workload (b)",
                                           smi, expect)
    if cuda:
        split, combine, replays = fleet_profiled_launches(router, vocab)
        L = cfg.num_layers
        ok = split == combine == L * replays and replays > 0
        print(f"    profiler over 3 fleet steps: {split} split and {combine} combine kernel records for {replays} "
              f"replays across the replicas (expect {L} x {replays})  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the profiler does not see the decode kernels in every replica's replays")
        out["two_replicas"]["profiled"] = {"split": split, "combine": combine, "replays": replays}
    del router
    # the same with replica 0 killed before router step KILL_STEP
    router = Router(engine, config=fleet_config(
        serve_config, fault_injection={"enabled": True, "seed": 0, "replica_dead_at": [[0, KILL_STEP]]}))
    for r in router._replicas:
        r.engine.warm_decode()
    victim = router._replicas[0].engine
    held = {"bytes": replica_bytes(victim)}
    close = victim.close

    def measured_close():  # instrumentation: the device memory around the release
        if cuda:
            torch.cuda.synchronize()
            held["before"] = torch.cuda.memory_allocated()
        close()
        if cuda:
            torch.cuda.synchronize()
            held["after"] = torch.cuda.memory_allocated()

    victim.close = measured_close
    res_k, out["two_replicas_killed"] = run_fleet(
        router, ragged_workload(vocab, RAGGED_RATE),
        f"{FLEET_REPLICAS} in-process replicas, replica 0 killed before router step {KILL_STEP}", smi, expect,
        killed=True)
    to_admit, moved = failover_timing(router, res_k)
    greedy = [u for u in moved if res_k[u].ok and workload[u].temperature <= 0]
    same = sum(np.array_equal(res_k[u].tokens, res_a[u].tokens) for u in greedy)
    released = (held.get("before", 0) - held.get("after", 0)) if cuda else 0
    rel_ok = (not cuda) or (victim.worker._cache is None and released >= held["bytes"])
    print(f"    {len(moved)} requests failed over; the kill to the last one's admission on the survivor "
          f"{(to_admit or 0) * 1e3:.1f} ms; greedy failed-over requests whose tokens equal the unfaulted run's: "
          f"{same}/{len(greedy)} (bf16; reported, not required)")
    print(f"    the dead replica's device memory: allocated {held.get('before', 0) / 1e9:.3f} GB before its release, "
          f"{held.get('after', 0) / 1e9:.3f} GB after ({released / 1e9:.3f} GB freed; its slot cache and prefix pool "
          f"{held['bytes'] / 1e9:.3f} GB)  {'ok' if rel_ok else 'FAIL'}")
    if not rel_ok:
        raise SystemExit("the dead replica kept its device memory")
    out["two_replicas_killed"].update(kill_to_last_admission_s=to_admit, failed_over=len(moved),
                                      greedy_failed_over=len(greedy), greedy_equal_to_unfaulted=same,
                                      released_bytes=released, replica_bytes=held["bytes"])
    del router, victim, close, measured_close
    if cuda:
        torch.cuda.empty_cache()
    out["fp32_failover_parity"] = fleet_parity_small(dev)
    out["journal"] = journal_drill(engine, serve_config, vocab, smi)
    del engine
    if cuda:
        torch.cuda.empty_cache()
    out["workers"] = worker_fleet(serve_config, vocab, smi, device=dev.type,
                                  model_spec=None if model_cfg is None else {
                                      k: getattr(cfg, k) for k in ("vocab_size", "max_seq_len", "num_layers",
                                                                   "num_heads", "hidden_size")},
                                  engine_dtype="bf16" if model_cfg is None else "fp32")
    print(json.dumps({"fleet": out}, default=str))
    inproc = [e for k in ("two_replicas", "two_replicas_killed") for e in out[k]["replicas"]]
    return {"inprocess": [(e["split_in_run"], e["combine_in_run"]) for e in inproc],
            "workers": {str(k): v for k, v in out["workers"]["reported_launches"].items()}}


# ---------------------------------------------------------------------------
# Phase 21: the fleet's front door and membership (launcher/http_gateway.py,
# inference/autoscaler.py, Router.rolling_upgrade, WorkerSupervisor.set_spec)
# at GPT-2-125M width: bench.py --gateway-chaos (:1161) and --surge (:939)
# ---------------------------------------------------------------------------

DISCONNECTS = 3
GATEWAY_CFG = {"host": "127.0.0.1", "port": 0, "shutdown_grace_s": 60.0}
# bench.py:985-1008's trace shape: burst A (30%) at 0-0.3 s, burst B (50%) at
# 2.5-3.2 s, high-priority burst C (20%) at 4.5-5.5 s; one prompt in five
# heavy. Its lengths scaled to GPT-2's context: 16-96 tokens, heavy 256-768;
# 32 new tokens, greedy
SURGE_REQUESTS = 96
SURGE_KILL_AT = 2.9  # seconds into the trace: mid burst B
# bench.py:1025-1034's autoscale block, the load threshold set to 3/4 of a
# replica's 16 slots (its fleet had 2-slot replicas)
SURGE_AUTOSCALE = {"enabled": True, "min_replicas": 1, "max_replicas": 3, "scale_up_queue": 3,
                   "scale_up_load": 12.0, "scale_down_load": 0.5, "up_consecutive": 2, "down_consecutive": 8,
                   "cooldown_s": 0.75, "brownout_deadline_s": 60.0}
SURGE_QUEUE = 12  # bench.py:1027 router max_queue_len
MEMORY_SLACK = 1 << 20  # what a wave may leave beyond its level (rounding)
# cuBLAS's workspaces (32 MiB each on Hopper) for a thread's first use of a
# stream: the serve loop's first captures (the warm-up and capture streams)
CUBLAS_LOOP_WORKSPACES = 2 * (32 << 20)


class LoopCalls:
    """The gateway's ``on_tick``: runs queued calls (``run``) and every
    ``watchers`` entry on the serve-loop thread, the one thread that touches
    the Router and its engines."""

    def __init__(self):
        import queue

        self._q = queue.Queue()
        self._empty = queue.Empty
        self.watchers = []

    def __call__(self):
        for w in self.watchers:
            w()
        while True:
            try:
                fn, box = self._q.get_nowait()
            except self._empty:
                return
            try:
                box["value"] = fn()
            except BaseException as e:  # handed back to the caller's thread
                box["error"] = e
            box["done"].set()

    def run(self, fn, timeout=300.0):
        import threading

        box = {"done": threading.Event()}
        self._q.put((fn, box))
        if not box["done"].wait(timeout):
            raise SystemExit("a call on the gateway's serve loop did not return")
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def wait(self, cond, timeout=120.0, what="the fleet"):
        """Poll ``cond`` on the loop thread until it holds."""
        deadline = time.monotonic() + timeout
        while not self.run(cond):
            if time.monotonic() > deadline:
                raise SystemExit(f"{what} did not settle within {timeout:.0f} s")
            time.sleep(0.05)


def sse_event(block):
    """(event, data) of one SSE block, None for a keepalive comment."""
    name = data = None
    for line in block.splitlines():
        if line.startswith(b"event: "):
            name = line[7:].decode()
        elif line.startswith(b"data: "):
            data = json.loads(line[6:])
    return None if name is None else (name, data)


def http_generate(port, body, stream, t0, headers=None):
    """One client: POST /v1/generate, then the blocking JSON or the SSE
    events. Times are perf_counter seconds after ``t0``: sent, each token
    event's arrival, the end."""
    import http.client

    sent = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps({**body, "stream": stream}), headers=headers or {})
        resp = conn.getresponse()
        rec = {"status": resp.status, "stream": stream, "sent": sent - t0}
        if not resp.getheader("Content-Type", "").startswith("text/event-stream"):
            rec["json"] = json.loads(resp.read())
            rec["end"] = time.perf_counter() - t0
            return rec
        rec["uid"], toks, times, buf = int(resp.getheader("X-DSTPU-Uid")), [], [], b""
        while "json" not in rec:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                ev = sse_event(block)
                if ev and ev[0] == "token":
                    toks.append(ev[1]["token"])
                    times.append(time.perf_counter() - t0)
                elif ev and ev[0] == "done":
                    rec["json"] = ev[1]
        rec.update(tokens=toks, token_times=times, end=time.perf_counter() - t0)
        return rec
    finally:
        conn.close()


def run_trace(port, items, t0):
    """Client threads, one a request: ``items`` are (offset s, body, stream,
    headers); each thread sends at t0 + offset (perf_counter, one clock for
    every process of the machine). Returns the records in item order."""
    import threading

    out = [None] * len(items)

    def client(i, offset, body, stream, headers):
        delay = t0 + offset - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        out[i] = http_generate(port, body, stream, t0, headers)

    threads = [threading.Thread(target=client, args=(i, *it), daemon=True) for i, it in enumerate(items)]
    lag = time.perf_counter() - t0  # how late this process took up the trace
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    return lag, out


_CLIENTS = []  # the client process pool, made at first use


def client_pool():
    """The clients run in a process of their own, so that their threads
    share no interpreter lock with the gateway and its serve loop. One
    process, started (chip_smoke imported) before the first trace: a trace
    taken up late would send its requests in one burst."""
    if not _CLIENTS:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        _CLIENTS.append(ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")))
        _CLIENTS[0].submit(run_trace, 0, [], 0.0).result(300)  # imports chip_smoke there
    return _CLIENTS[0]


def send_trace(port, items, t0):
    return client_pool().submit(run_trace, port, items, t0)


TRACE_LAG_S = 0.1  # the most a trace may start after its time 0


def join_trace(trace, timeout=600.0):
    lag, records = trace.result(timeout)
    if any(r is None for r in records):
        raise SystemExit("a gateway client did not finish")
    if lag > TRACE_LAG_S:
        raise SystemExit(f"the client process took the trace up {lag:.3f} s late; its arrivals would bunch")
    return records


def close_clients():
    while _CLIENTS:
        _CLIENTS.pop().shutdown(wait=True, cancel_futures=True)


def request_body(r):
    return {"prompt": [int(t) for t in r.prompt], "max_new_tokens": int(r.max_new_tokens),
            "temperature": float(r.temperature), "top_k": int(r.top_k), "top_p": float(r.top_p)}


def client_metrics(records, router_results):
    """Client-side TTFT (send -> first SSE token event) and TPOT (between
    token events) beside the Router's own, and tokens/s through the
    gateway (every reply's tokens over the trace's time 0 -> last reply)."""
    sse = [r for r in records if r["stream"] and r.get("token_times")]
    ttft = [r["token_times"][0] - r["sent"] for r in sse]
    tpot = [(r["token_times"][-1] - r["token_times"][0]) / (len(r["token_times"]) - 1)
            for r in sse if len(r["token_times"]) > 1]
    tokens = sum(len(r["json"].get("tokens", [])) for r in records if "json" in r)
    span = max(r["end"] for r in records)  # from the trace's time 0, as the Router alone's run counts
    ok = [x for x in router_results.values() if x is not None and x.ok]
    return {"requests": len(records), "ok": sum(r.get("json", {}).get("status") == "ok" for r in records),
            "tokens": tokens, "seconds": span, "tokens_per_s": tokens / span,
            "client_ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "client_ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "client_tpot_p50_ms": float(np.percentile(tpot, 50)) * 1e3,
            "router_ttft_p50_ms": float(np.percentile([x.ttft for x in ok], 50)) * 1e3,
            "router_ttft_p99_ms": float(np.percentile([x.ttft for x in ok], 99)) * 1e3,
            "router_tpot_p50_ms": float(np.percentile([x.time_per_output_token for x in ok
                                                       if len(x.tokens) > 1], 50)) * 1e3}


def uid_of(rec):
    return rec.get("uid", rec.get("json", {}).get("uid"))


def one_engine_greedy(engine, serve_config, reqs):
    """The greedy requests' tokens from one ServingEngine (all arrived at 0):
    the yardstick greedy streams are counted against."""
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    srv = ServingEngine(engine, config={**serve_config, "watchdog_mode": "raise"})
    greedy = [r for r in reqs if r.temperature <= 0]
    res = srv.serve([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in greedy])
    srv.close()
    return {u: [int(t) for t in x.tokens] for u, x in res.items()}


def stream_contract(records, results):
    """Every completed SSE stream: its token events == its done event's
    tokens == the fleet's result for the uid (the same run, so required)."""
    bad = [uid_of(r) for r in records if r["stream"] and r.get("json", {}).get("status") == "ok"
           and not (r["tokens"] == r["json"]["tokens"] == [int(t) for t in results[uid_of(r)].tokens])]
    return not bad, bad


def replays_of(router):
    return {r.rid: r.engine.worker.graph_replays for r in router._replicas if hasattr(r.engine, "worker")}


def loop_timer(router, gw, calls):
    """Instrumentation of the serve loop while a trace runs, over the ticks
    with work in flight: the period between ticks, and the time of each
    ``router.step()`` and of each publish of the streams' feeds in them.
    Returns a function that removes it and gives (periods, steps,
    publishes) in seconds."""
    ticks, steps, publishes = [], [], []
    step, publish = router.step, gw._publish

    def timed(fn, out):
        def call(*a, **kw):
            busy, t = bool(router._owner), time.perf_counter()
            res = fn(*a, **kw)
            if busy:
                out.append(time.perf_counter() - t)
            return res
        return call

    def tick():
        if router._owner:
            ticks.append(time.perf_counter())

    def install():
        router.step, gw._publish = timed(step, steps), timed(publish, publishes)
        calls.watchers.append(tick)

    def remove():
        del router.step, gw._publish
        calls.watchers.remove(tick)
        return list(np.diff(ticks)), steps, publishes

    calls.run(install)
    return lambda: calls.run(remove)


def gateway_traffic(router, gw, calls, reqs, smi, label, ref=None):
    """(a): ``reqs`` through the gateway, half blocking, half SSE (greedy
    and sampled alike), as client threads at their arrival times."""
    replays0 = calls.run(lambda: replays_of(router))
    items = [(float(r.arrival_time), request_body(r), (i // 2) % 2 == 0, None) for i, r in enumerate(reqs)]
    timer = loop_timer(router, gw, calls)
    t0 = time.perf_counter()
    records = join_trace(send_trace(gw.port, items, t0))
    periods, steps, publishes = timer()
    uids = [uid_of(r) for r in records]
    results = calls.run(lambda: {u: router.result(u) for u in uids})
    m = client_metrics(records, results)
    contract, bad = stream_contract(records, results)
    delta = calls.run(lambda: {rid: n - replays0.get(rid, 0) for rid, n in replays_of(router).items()})
    L = router._replicas[0].engine.worker.graph_launches[0]
    m.update(replays=delta, decode_launches={rid: (L * n, L * n) for rid, n in delta.items()},
             http_status={s: sum(r["status"] == s for r in records) for s in {r["status"] for r in records}},
             loop_period_p50_ms=float(np.percentile(periods, 50)) * 1e3,
             loop_period_p90_ms=float(np.percentile(periods, 90)) * 1e3,
             loop_step_p50_ms=float(np.percentile(steps, 50)) * 1e3,
             loop_publish_p50_ms=float(np.percentile(publishes, 50)) * 1e3, loop_ticks=len(periods))
    greedy_equal = None
    if ref is not None:
        pos = {r.uid: i for i, r in enumerate(reqs)}
        greedy = [(records[pos[u]], u) for u in ref]
        greedy_equal = sum(rec["json"].get("tokens") == ref[u] for rec, u in greedy)
        m["greedy_equal_to_one_engine"], m["greedy"] = greedy_equal, len(greedy)
    print(f"  [{smi}] {label}: {m['ok']}/{m['requests']} ok (HTTP {m['http_status']}), {m['tokens']} tokens in "
          f"{m['seconds']:.3f} s = {m['tokens_per_s']:.1f} tokens/s; client TTFT p50 {m['client_ttft_p50_ms']:.1f} ms, "
          f"p99 {m['client_ttft_p99_ms']:.1f} ms (the Router's {m['router_ttft_p50_ms']:.1f} / "
          f"{m['router_ttft_p99_ms']:.1f} ms); TPOT p50 client {m['client_tpot_p50_ms']:.3f} ms, Router "
          f"{m['router_tpot_p50_ms']:.3f} ms; the serve loop with work in flight: a tick every "
          f"{m['loop_period_p50_ms']:.2f} ms (p90 {m['loop_period_p90_ms']:.2f}) over {m['loop_ticks']} ticks, in it "
          f"router.step() {m['loop_step_p50_ms']:.2f} ms and the streams' publish {m['loop_publish_p50_ms']:.2f} ms "
          f"(p50s); decode launches per replica (split, combine) from the replays "
          f"{m['decode_launches']}"
          + (f"; greedy requests equal to one engine's {greedy_equal}/{m['greedy']} (bf16; reported)"
             if ref is not None else ""))
    launched = L == 0 or all(n > 0 for n in delta.values())  # L = 0: the CPU's eager step
    ok = m["ok"] == m["requests"] and contract and launched
    print(f"    every SSE stream's token events == its done event == the fleet's result: {contract} {bad[:4]}; "
          f"every replica's graph replayed: {launched}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"gateway {label}: a request failed, a stream disagrees with its result, or a replica's "
                         "decode kernels never ran")
    return records, m


def gateway_profiled(router, gw, calls, vocab, L):
    """The profiler's kernel records over a few streamed requests, started
    and stopped on the serve loop: num_layers split and combine kernels per
    replay the replicas made in that window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start():
        prof.start()
        return sum(replays_of(router).values())

    def stop():
        torch.cuda.synchronize()
        prof.stop()
        return sum(replays_of(router).values())

    before = calls.run(start)
    reqs = ragged_workload(vocab, RAGGED_RATE, seed=21)[:4]
    join_trace(send_trace(gw.port, [(0.0, {**request_body(r), "temperature": 0.0}, True, None) for r in reqs],
                          time.perf_counter()))
    replays = calls.run(stop) - before
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    split, combine = sum("decode_split_kernel" in n for n in names), sum("decode_combine_kernel" in n for n in names)
    ok = replays > 0 and split == combine == L * replays
    print(f"    profiler on the serve loop over 4 streamed requests: {split} split and {combine} combine kernel "
          f"records for {replays} replays across the replicas (expect {L} x {replays})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the profiler does not see the decode kernels in the gateway's replays")
    return {"split": split, "combine": combine, "replays": replays}


def prefix_refs(engine):
    pfx = getattr(engine, "_pfx", None)
    return sum(e.refs for e in pfx.entries()) if pfx is not None else 0


def gateway_disconnects(router, gw, calls, vocab, smi):
    """(b): DISCONNECTS clients reset their sockets after two token events:
    each request ends ``cancelled``, and slot and prefix-reference
    occupancy return to 0 on every replica."""
    import socket
    import struct

    reqs = ragged_workload(vocab, RAGGED_RATE, seed=22)[:DISCONNECTS]
    socks = []
    for r in reqs:
        data = json.dumps({**request_body(r), "temperature": 0.0, "max_new_tokens": 400}).encode()
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=60)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n" % len(data) + data)
        socks.append(s)
    uids = []
    for s in socks:
        buf = b""
        while buf.count(b"event: token") < 2:
            buf += s.recv(65536)
        uids.append(int(re.search(rb"X-DSTPU-Uid: (\d+)", buf).group(1)))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        s.close()
    t0 = time.perf_counter()

    def settled():
        res = [router.result(u) for u in uids]
        live = [r for r in router._replicas if r.state == "healthy"]
        return (all(x is not None for x in res) and not router._owner
                and all(r.engine.n_active == 0 and r.engine.n_prefilling == 0 and prefix_refs(r.engine) == 0
                        for r in live))

    calls.wait(settled, timeout=60, what="the disconnected requests")
    seconds = time.perf_counter() - t0
    statuses = calls.run(lambda: [router.result(u).status for u in uids])
    counters = router.telemetry.registry.snapshot()["counters"]
    ok = statuses == ["cancelled"] * DISCONNECTS and counters.get("gateway/cancelled_on_disconnect", 0) >= DISCONNECTS
    print(f"  [{smi}] (b) {DISCONNECTS} clients reset mid-stream after 2 tokens: statuses {statuses}; every replica "
          f"back to 0 active, 0 prefilling, 0 prefix references in {seconds * 1e3:.1f} ms; "
          f"gateway/cancelled_on_disconnect {counters.get('gateway/cancelled_on_disconnect', 0)}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("a disconnected request was not cancelled or kept its slot")
    return {"statuses": statuses, "settle_ms": seconds * 1e3}


def upgrade_watcher(router, marks):
    """Records each wave's phase changes on the fleet clock, and each
    newcomer's graph replays when its gate passes."""
    seen = {}

    def watch():
        st = router.upgrade_status()
        if st is None:
            return
        cur = st["current"]
        if cur is not None and seen.get(cur["old_rid"]) != cur["phase"]:
            seen[cur["old_rid"]] = cur["phase"]
            w = marks.setdefault(cur["old_rid"], {})
            w[cur["phase"]] = router.now()
            if cur["phase"] == "drain":
                new = router._replicas[cur["new_rid"]].engine
                w["newcomer_replays_at_gate"] = new.worker.graph_replays if hasattr(new, "worker") else None
        for wave in st["waves"]:
            w = marks.setdefault(wave["old_rid"], {})
            if "end" not in w:
                w["end"] = router.now()
    return watch


def wave_times(status, marks):
    out = []
    for w in status["waves"]:
        m = marks.get(w["old_rid"], {})
        start = w.get("started", m.get("boot"))
        out.append({"old_rid": w["old_rid"], "new_rid": w.get("new_rid"), "outcome": w["outcome"],
                    "canary_status": w.get("canary_status"),
                    "boot_ms": (w["gate_start"] - start) * 1e3 if "gate_start" in w else None,
                    "gate_ms": (m["drain"] - w["gate_start"]) * 1e3 if "drain" in m and "gate_start" in w else None,
                    "drain_ms": (m["end"] - m["drain"]) * 1e3 if "drain" in m and "end" in m else None,
                    "newcomer_replays_at_gate": m.get("newcomer_replays_at_gate")})
    return out


def upgrade_once(router, gw, calls, reqs, cuda):
    """One rolling upgrade of every healthy replica while ``reqs`` stream
    in; returns (status, wave times, records, memory before, after)."""
    marks = {}
    calls.watchers.append(upgrade_watcher(router, marks))
    mem = (lambda: (torch.cuda.synchronize(), torch.cuda.memory_allocated())[1]) if cuda else (lambda: 0)
    before = calls.run(mem)
    trace = send_trace(gw.port, [(float(r.arrival_time), request_body(r), i % 2 == 0, None)
                                 for i, r in enumerate(reqs)], time.perf_counter())
    time.sleep(0.3)
    calls.run(router.rolling_upgrade)
    calls.wait(lambda: router.upgrade_status()["state"] != "running"
               and not any(s == "draining" for s in router.replica_states().values()), timeout=240,
               what="the rolling upgrade")
    records = join_trace(trace)
    calls.run(lambda: None)  # one more tick: the watcher stamps the last wave's end
    calls.watchers.pop()
    status = calls.run(router.upgrade_status)
    return status, wave_times(status, marks), records, before, calls.run(mem)


def gateway_upgrade(router, gw, calls, vocab, smi, cuda):
    """(c): a rolling upgrade of the 2 in-process replicas under live
    traffic: every wave ``upgraded``, each canary served through the
    newcomer's graph, no accepted request lost, the old generation's
    memory released. A second upgrade under light traffic shows the
    memory level of a wave alone: the first one's newcomers are the first
    graphs captured on the serve loop's thread, whose cuBLAS handle then
    takes its workspaces (once per thread and stream)."""
    status, waves, records, before, after = upgrade_once(router, gw, calls, ragged_workload(vocab, RAGGED_RATE,
                                                                                            seed=23), cuda)
    status2, waves2, records2, before2, after2 = upgrade_once(router, gw, calls, ragged_workload(
        vocab, RAGGED_RATE, seed=26)[:8], cuda)
    old = [w["old_rid"] for w in status["waves"] + status2["waves"]]
    released = calls.run(lambda: all(router._replicas[rid].engine.worker._cache is None for rid in old))
    newcomers = calls.run(lambda: {w["new_rid"]: (router._replicas[w["new_rid"]].engine.worker.graph_replays,
                                                  router._replicas[w["new_rid"]].engine.compile_counts()["decode"])
                                   for w in status["waves"] + status2["waves"]})
    lost = [uid_of(r) for r in records + records2 if r["status"] != 200 or r.get("json", {}).get("status") != "ok"]
    every = waves + waves2
    canary_graph = all(w["canary_status"] == "ok" and (not cuda or (w["newcomer_replays_at_gate"] or 0) >= 1)
                       for w in every)
    ok = (status["state"] == status2["state"] == "done" and [w["outcome"] for w in every] == ["upgraded"] * 4
          and canary_graph and not lost and released and all(d == 1 for _, d in newcomers.values())
          and after - before <= CUBLAS_LOOP_WORKSPACES + MEMORY_SLACK and after2 <= before2 + MEMORY_SLACK)
    print(f"  [{smi}] (c) rolling upgrade of 2 in-process replicas under 64 live requests, then again under 8: "
          f"states {status['state']}, {status2['state']}; waves {[(w['old_rid'], w['new_rid'], w['outcome']) for w in every]}; "
          f"boot / gate / drain ms {[(round(w['boot_ms'] or 0, 1), round(w['gate_ms'] or 0, 1), round(w['drain_ms'] or 0, 1)) for w in every]}; "
          f"each canary ok through the newcomer's graph (its replays when the gate passed "
          f"{[w['newcomer_replays_at_gate'] for w in every]}; decode programs {[d for _, d in newcomers.values()]}): "
          f"{canary_graph}; requests lost {lost}; the old generations released {released}; device memory "
          f"{before} B before the first upgrade, {after} B after ({(after - before) / 2**20:+.1f} MiB: the serve "
          f"loop's first captures), {before2} B before the second, {after2} B after "
          f"({(after2 - before2) / 2**20:+.1f} MiB)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the rolling upgrade lost a request, a wave failed, or memory stayed held")
    return {"state": status["state"], "waves": waves, "second_waves": waves2, "memory_before": before,
            "memory_after": after, "memory_before_second": before2, "memory_after_second": after2,
            "newcomer_replays": {str(k): v[0] for k, v in newcomers.items()}}


def surge_trace(vocab, seed=31):
    """bench.py:985-1008's shape at GPT-2's context (SURGE_* above)."""
    rng = np.random.default_rng(seed)
    n_a, n_c = int(SURGE_REQUESTS * 0.3), int(SURGE_REQUESTS * 0.2)
    n_b = SURGE_REQUESTS - n_a - n_c
    items = []
    for i in range(SURGE_REQUESTS):
        heavy = rng.random() < 0.2
        size = int(rng.integers(256, 769) if heavy else rng.integers(16, 97))
        prompt = [int(t) for t in rng.integers(0, vocab, size=size)]
        if i < n_a:
            offset, prio = float(rng.uniform(0.0, 0.3)), int(rng.integers(0, 2))
        elif i < n_a + n_b:
            offset, prio = float(rng.uniform(2.5, 3.2)), int(rng.integers(0, 2))
        else:
            offset, prio = float(rng.uniform(4.5, 5.5)), 2
        items.append((offset, {"prompt": prompt, "max_new_tokens": 32}, i % 2 == 0, {"X-DSTPU-Priority": str(prio)}))
    return items


def gateway_surge(engine, serve_config, vocab, smi, cuda):
    """(d): the autoscaler on an in-process fleet behind the gateway: the
    surge trace grows it to 3, brownout engages at that maximum, a replica
    killed mid-trace comes back as a new rid, the fleet shrinks back to 1,
    and every accepted request ends in a terminal state."""
    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway

    router = Router(engine, config={**serve_config, "watchdog_mode": "raise",
                                    "router": {"replicas": 1, "max_queue_len": SURGE_QUEUE,
                                               "health": dict(FLEET_HEALTH), "autoscale": SURGE_AUTOSCALE}})
    for r in router._replicas:
        r.engine.warm_decode()
    asc = router._autoscaler
    seen = {"max_healthy": 1, "up_since": None, "signal_to_attached_ms": [], "brownout": False}
    spawn = router._spawn_inprocess
    spawn_ms = []

    def timed_spawn():  # instrumentation: the newcomer's build and capture
        t = time.perf_counter()
        e = spawn()
        spawn_ms.append((time.perf_counter() - t) * 1e3)
        return e

    router._spawn_inprocess = timed_spawn
    c = asc.cfg

    def watch():
        now, n = router.now(), len(router._replicas)
        sig = asc.signals(now)
        up = sig["queue"] >= c.scale_up_queue or sig["load_per_replica"] >= c.scale_up_load
        if up and seen["up_since"] is None:
            seen["up_since"] = now
        if n > seen.get("n", 1) and seen["up_since"] is not None:
            seen["signal_to_attached_ms"].append((now - seen["up_since"]) * 1e3)
            seen["up_since"] = None
        seen["n"] = n
        seen["max_healthy"] = max(seen["max_healthy"], sig["healthy"])
        seen["brownout"] |= router.brownout

    calls = LoopCalls()
    calls.watchers.append(watch)
    gw = HttpGateway(router, GATEWAY_CFG, gateway_id=2, on_tick=calls)
    gw.start()
    try:
        items = surge_trace(vocab)
        t0 = time.perf_counter()
        trace = send_trace(gw.port, items, t0)
        time.sleep(max(0.0, t0 + SURGE_KILL_AT - time.perf_counter()))

        def kill():
            live = [r for r in router._replicas if r.state == "healthy"]
            victim = max(live, key=lambda r: (r.engine.load, r.rid))
            router.mark_dead(victim.rid)
            return victim.rid, len(live)

        killed, live_at_kill = calls.run(kill)
        records = join_trace(trace)
        seconds = time.perf_counter() - t0
        calls.wait(lambda: (asc.target == 1 and not asc._boots
                            and sum(s == "healthy" for s in router.replica_states().values()) == 1
                            and not any(s == "draining" for s in router.replica_states().values())),
                   timeout=180, what="the shrinking fleet")
        snap = calls.run(lambda: (router.replica_states(), list(asc.events),
                                  router.telemetry.registry.snapshot()["counters"],
                                  {r.rid: (r.engine.worker.graph_replays, r.engine.compile_counts()["decode"],
                                           r.engine.worker._cache is None) for r in router._replicas}))
    finally:
        gw.stop()
        gw.close()
    states, events, counters, reps = snap
    accepted = [r for r in records if r["status"] == 200]
    terminal = all(r.get("json", {}).get("status") for r in accepted)
    shed429 = sum(r["status"] == 429 for r in records)
    a = {k.rsplit("/", 1)[1]: int(v) for k, v in counters.items() if k.startswith("router/autoscale/")}
    respawned = [e["rid"] for e in events if e["kind"] == "respawn"]
    retired_freed = all(gone for rid, (_, _, gone) in reps.items() if states[rid] in ("drained", "dead"))
    ok = (seen["max_healthy"] >= 3 and a.get("brownouts", 0) >= 1 and seen["brownout"] and respawned
          and all(rid != killed for rid in respawned) and a.get("scale_downs", 0) >= 1 and terminal
          and sum(s == "healthy" for s in states.values()) == 1 and retired_freed
          and all(d <= 1 for _, d, _ in reps.values()))
    statuses = {}
    for r in accepted:
        s = r.get("json", {}).get("status")
        statuses[s] = statuses.get(s, 0) + 1
    print(f"  [{smi}] (d) autoscaler 1..3 under the surge trace ({SURGE_REQUESTS} requests, bursts at 0, 2.5 and "
          f"4.5 s) in {seconds:.2f} s: peak {seen['max_healthy']} healthy; replica {killed} killed at "
          f"{SURGE_KILL_AT} s ({live_at_kill} live), respawned as {respawned}; brownout engaged "
          f"{a.get('brownouts', 0)}x, shed: {a.get('brownout_shed', 0)} queued (brownout_shed), "
          f"{a.get('overloaded_rejects', 0)} overloaded, HTTP 429 {shed429}; scale-ups {a.get('scale_ups', 0)}, "
          f"downs {a.get('scale_downs', 0)}, respawns {a.get('respawns', 0)}; signal -> attached ms "
          f"{[round(x, 1) for x in seen['signal_to_attached_ms']]}, newcomer build + capture ms "
          f"{[round(x, 1) for x in spawn_ms]}; accepted {len(accepted)}, terminal {terminal} {statuses}; final "
          f"states {states}; retired replicas released {retired_freed}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the autoscaled fleet did not grow, brown out, heal and shrink back, or lost a request")
    return {"seconds": seconds, "max_healthy": seen["max_healthy"], "killed": killed, "respawned": respawned,
            "autoscale": a, "http_429": shed429, "accepted": len(accepted), "statuses": statuses,
            "signal_to_attached_ms": seen["signal_to_attached_ms"], "spawn_ms": spawn_ms,
            "replays": {str(rid): v[0] for rid, v in reps.items()}, "states": states}


def gateway_workers(serve_config, vocab, smi, device="cuda", model_spec=None, engine_dtype="bf16"):
    """(e): 2 worker processes over TCP behind the gateway: worker 0
    SIGKILLed mid-trace, respawned by its supervisor and attached; then a
    ``set_spec`` rolling upgrade of both workers."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway
    from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor

    model = {**(model_spec or GPT2_SPEC), "dtype": "float32"}
    spec = {"model": model, "engine_dtype": engine_dtype, "serving": {**serve_config, "watchdog_mode": "raise"}}
    transport = {**FLEET_TRANSPORT, "family": "tcp", "host": "127.0.0.1"}
    real, workdir = _socket_dir()
    sup = WorkerSupervisor(spec, FLEET_REPLICAS, workdir=workdir, transport=transport, device=device,
                           respawn_backoff={"max_attempts": 10, "base_delay_s": 0.05, "max_delay_s": 0.1,
                                            "jitter": 0.0})
    out = {}
    gw = None
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(FLEET_REPLICAS) as ex:
            clients = list(ex.map(sup.spawn, range(FLEET_REPLICAS)))
        out["boot_s"] = time.perf_counter() - t0
        router = Router(config={"router": {"replicas": FLEET_REPLICAS, "health": dict(FLEET_HEALTH),
                                           "transport": transport}}, replica_engines=clients)
        calls = LoopCalls()
        gw = HttpGateway(router, GATEWAY_CFG, gateway_id=3, on_tick=calls)
        gw.start()
        reported = {}

        def launches(client):
            return tuple(client.telemetry_snapshot()["decode_kernel_launches"])

        reqs = ragged_workload(vocab, RAGGED_RATE, seed=24)
        t0 = time.perf_counter()
        trace = send_trace(gw.port, [(float(r.arrival_time), request_body(r), i % 2 == 0, None)
                                     for i, r in enumerate(reqs)], t0)
        time.sleep(0.7)
        reported["worker 0 before its kill"] = calls.run(lambda: launches(clients[0]))
        sup.kill(0, signal.SIGKILL)
        records = join_trace(trace)
        dead = calls.run(lambda: router.replica_states()[0])
        t1 = time.perf_counter()
        fresh = sup.respawn(0)
        out["respawn_s"] = time.perf_counter() - t1
        rid = calls.run(lambda: router.attach_replica(fresh))
        ok_a = dead == "dead" and all(r["status"] == 200 and r["json"].get("status") == "ok" for r in records)
        counters = router.telemetry.registry.snapshot()["counters"]
        print(f"  [{smi}] (e) {FLEET_REPLICAS} worker processes over TCP behind the gateway, booted together in "
              f"{out['boot_s']:.1f} s; worker 0 SIGKILLed 0.7 s into workload (b): replica 0 {dead}, "
              f"{counters.get('router/failovers', 0)} failovers, every request ok {ok_a}; respawned in "
              f"{out['respawn_s']:.1f} s and attached as replica {rid}")
        if not ok_a:
            raise SystemExit("the worker fleet behind the gateway lost a request to the SIGKILL")
        # both live workers serve a few requests before the upgrade
        more = ragged_workload(vocab, RAGGED_RATE, seed=27)[:8]

        def completed():
            return {k: v["completed"] for k, v in router.router_stats()["replicas"].items()}

        done0 = calls.run(completed)
        extra = join_trace(send_trace(gw.port, [(0.0, {**request_body(r), "temperature": 0.0}, True, None)
                                                for r in more], time.perf_counter()))
        owners = sorted(k for k, n in calls.run(completed).items() if n > done0.get(k, 0))
        ok_b = all(r["status"] == 200 and r["json"].get("status") == "ok" for r in extra) and rid in owners
        print(f"    8 more requests after the attach, served by replicas {owners}: {ok_b}")
        if not ok_b:
            raise SystemExit("the respawned worker did not serve after its attach")
        for name, client in (("worker 1", clients[1]), ("respawned worker", fresh)):
            reported[name] = calls.run(lambda c=client: launches(c))
        # the new generation: the same model under a spec of its own, so
        # the newcomers boot the spec set_spec installs
        marks = {}
        calls.watchers.append(upgrade_watcher(router, marks))
        calls.run(lambda: router.rolling_upgrade(supervisor=sup, slots={1: 1, rid: 0},
                                                 spec={**spec, "generation": 2}, gate_timeout_s=300.0))
        light = ragged_workload(vocab, 4.0, seed=25)[:8]
        trace = send_trace(gw.port, [(float(r.arrival_time), request_body(r), True, None) for r in light],
                           time.perf_counter())
        calls.wait(lambda: router.upgrade_status()["state"] != "running"
                   and not any(s == "draining" for s in router.replica_states().values()), timeout=300,
                   what="the workers' rolling upgrade")
        upgrade_records = join_trace(trace)
        calls.run(lambda: None)
        status = calls.run(router.upgrade_status)
        waves = wave_times(status, marks)
        new_clients = {w["new_rid"]: router._replicas[w["new_rid"]].engine for w in status["waves"]}
        for w in status["waves"]:
            reported[f"newcomer replica {w['new_rid']}"] = calls.run(
                lambda c=new_clients[w["new_rid"]]: launches(c))
        spec_ok = all(json.loads(open(sup._slot_spec[s]).read()).get("generation") == 2
                      for s in status["slots"].values())
        ok = (status["state"] == "done" and [w["outcome"] for w in waves] == ["upgraded"] * 2 and spec_ok
              and all(w["canary_status"] == "ok" for w in waves)
              and all(r["status"] == 200 and r["json"].get("status") == "ok" for r in upgrade_records)
              and (device != "cuda" or all(v[0] > 0 and v[0] == v[1] for v in reported.values())))
        print(f"    set_spec rolling upgrade of both workers under 8 streams: state {status['state']}, waves "
              f"{[(w['old_rid'], w['new_rid'], w['outcome'], w['canary_status']) for w in waves]}; boot / gate / "
              f"drain ms {[(round(w['boot_ms'] or 0), round(w['gate_ms'] or 0), round(w['drain_ms'] or 0)) for w in waves]}; "
              f"newcomers booted the new spec {spec_ok}; decode launches (split, combine) as each worker reported "
              f"them {reported}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the workers' rolling upgrade failed or a worker launched no decode kernel")
        out.update(waves=waves, reported_launches={k: list(v) for k, v in reported.items()},
                   failovers=counters.get("router/failovers", 0))
        return out
    finally:
        if gw is not None:
            gw.stop()
            gw.close()
        sup.shutdown(signal.SIGTERM, timeout=60.0)
        sup.shutdown(signal.SIGKILL, timeout=10.0)
        shutil.rmtree(real, ignore_errors=True)


def gateway_parity_small(dev):
    """A small fp32 fleet behind the gateway with an in-process rolling
    upgrade started mid-stream: every greedy stream (SSE token events and
    blocking replies) equals generate's tokens (required)."""
    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway

    tiny = TransformerConfig(vocab_size=97, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=32)
    eng = deepspeed_tpu_torch.init_inference(Model(tiny), config={"dtype": "fp32"}, device=dev)
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, 97, size=int(rng.integers(4, 40))).astype(np.int32), int(rng.integers(8, 40)))
             for _ in range(12)]
    router = Router(eng, config={"n_slots": 4, "watchdog_mode": "raise",
                                 "router": {"replicas": 2, "health": dict(FLEET_HEALTH)}})
    for r in router._replicas:
        r.engine.warm_decode()
    calls = LoopCalls()
    gw = HttpGateway(router, GATEWAY_CFG, on_tick=calls)
    gw.start()
    try:
        items = [(0.05 * i, {"prompt": [int(t) for t in p], "max_new_tokens": n}, i % 2 == 0, None)
                 for i, (p, n) in enumerate(specs)]
        trace = send_trace(gw.port, items, time.perf_counter())
        time.sleep(0.2)
        calls.run(router.rolling_upgrade)
        records = join_trace(trace)
        calls.wait(lambda: router.upgrade_status()["state"] != "running", timeout=120, what="the fp32 upgrade")
        state = calls.run(lambda: router.upgrade_status()["state"])
    finally:
        gw.stop()
        gw.close()
    refs = [[int(t) for t in eng.generate(p[None], max_new_tokens=n)[0]] for p, n in specs]
    same = all(r["json"]["status"] == "ok" and r["json"]["tokens"] == ref and (not r["stream"] or r["tokens"] == ref)
               for r, ref in zip(records, refs))
    ok = same and state == "done"
    print(f"  small fp32 fleet (2 layers) behind the gateway, a rolling upgrade started mid-stream (state {state}): "
          f"every greedy stream's tokens (SSE events and blocking replies) == generate's: {same}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fp32 fleet's gateway streams differ from generate")
    return {"tokens_equal": same, "upgrade": state}


def gateway_phase(dev, smi, model_cfg=None, serve_config=None, vocab_cap=None):
    """Phase 21. ``model_cfg``/``serve_config`` default to phase 18's
    (GPT-2-125M, bf16); a smaller pair rehearses the phase's control flow."""
    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway

    cuda = dev.type == "cuda"
    cfg = model_cfg or TransformerConfig(**GPT2_SPEC)
    L = cfg.num_layers if cuda else 0
    serve_config = serve_config or SERVE_CONFIG
    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16" if model_cfg is None else "fp32"},
                                                device=dev)
    vocab = vocab_cap or engine.cfg.vocab_size
    out = {"config": {**serve_config, "replicas": FLEET_REPLICAS, "ragged_rate_per_s": RAGGED_RATE,
                      "gateway": GATEWAY_CFG, "surge_autoscale": SURGE_AUTOSCALE, "surge_queue": SURGE_QUEUE}}
    reset_counts()
    try:
        client_pool()  # the client process, started before any trace's time 0
        workload = ragged_workload(vocab, RAGGED_RATE, seed=11)
        ref = one_engine_greedy(engine, serve_config, workload)
        router = Router(engine, config=fleet_config(serve_config))
        for r in router._replicas:
            r.engine.warm_decode()  # both graphs captured before the gateway binds
        res, seconds = serve_fleet(router, ragged_workload(vocab, RAGGED_RATE, seed=11))
        out["router_alone"] = serving_metrics(res, seconds)
        m = out["router_alone"]
        print(f"  [{smi}] (a) the Router alone, workload (b): {m['ok']}/{m['requests']} ok, {m['tokens_per_s']:.1f} "
              f"tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; TPOT p50 "
              f"{m['tpot_p50_ms']:.3f} ms")
        calls = LoopCalls()
        gw = HttpGateway(router, GATEWAY_CFG, gateway_id=1, on_tick=calls)
        gw.start()
        try:
            _, out["through_gateway"] = gateway_traffic(router, gw, calls, workload, smi,
                                                        f"(a) workload (b) through the gateway ({gw.address})", ref)
            out["through_gateway"]["tokens_per_s_vs_router_alone"] = (
                out["through_gateway"]["tokens_per_s"] / out["router_alone"]["tokens_per_s"])
            if cuda:
                out["through_gateway"]["profiled"] = gateway_profiled(router, gw, calls, vocab, L)
            out["disconnects"] = gateway_disconnects(router, gw, calls, vocab, smi)
            out["upgrade"] = gateway_upgrade(router, gw, calls, vocab, smi, cuda)
        finally:
            gw.stop()
            gw.close()
        inproc = {str(k): v for k, v in out["through_gateway"]["decode_launches"].items()}
        del router
        if cuda:
            torch.cuda.empty_cache()
        out["surge"] = gateway_surge(engine, serve_config, vocab, smi, cuda)
        out["fp32_gateway_parity"] = gateway_parity_small(dev)
        del engine
        if cuda:
            torch.cuda.empty_cache()
        out["workers"] = gateway_workers(serve_config, vocab, smi, device=dev.type,
                                         model_spec=None if model_cfg is None else {
                                             k: getattr(cfg, k) for k in ("vocab_size", "max_seq_len", "num_layers",
                                                                          "num_heads", "hidden_size")},
                                         engine_dtype="bf16" if model_cfg is None else "fp32")
        print(json.dumps({"gateway": out}, default=str))
        return {"inprocess": inproc, "surge_replays": out["surge"]["replays"],
                "workers": out["workers"]["reported_launches"]}
    finally:
        close_clients()  # the client processes


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
    print("  the fused loss's mainloop (csrc/fused_xent.cu: the forward and the backward), each epilogue and "
          "operand layout:")
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
    print(f"[9] loaded fused_xent (forward: product and combine; backward: ds, dW, dH) in "
          f"{time.perf_counter() - t0:.2f} s; the forward's product instance {XENT_MAIN_PATH['fwd']}: HGMMA "
          f"{xent_sass[XENT_MAIN_PATH['fwd']]['hgmma']}; fused-loss kernels vs plain")
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
    print(f"[13] loaded sparse_attention (forward, dQ, dK/dV) in "
          f"{time.perf_counter() - t0:.2f} s; its kernels' SASS (cuobjdump) and registers (ptxas):")
    sparse_sass = sass_report("sparse_attention", sparse_label, SPARSE_MAIN_PATH.values())

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

    print("[18] serving engine: ServingEngine over init_inference at GPT-2-125M width, the decode step one CUDA graph")
    serving_launches = serve_engine_phase(dev, smi, args.profile)
    torch.cuda.empty_cache()

    print("[19] training resilience at GPT-2-125M width: NaN skip, rewind, preemption, write faults, async "
          "save, the 3-call loop, save_16bit_model, the CSV monitor")
    resilience = resilience_phase(dev, smi)
    torch.cuda.empty_cache()

    print(f"[20] serving fleet: Router over {FLEET_REPLICAS} in-process replicas (unfaulted, then replica 0 killed "
          f"at router step {KILL_STEP}), the journal's crash drill, {FLEET_REPLICAS} worker processes under a "
          f"WorkerSupervisor (SIGKILL, respawn, SIGTERM drain), at GPT-2-125M width")
    fleet = fleet_phase(dev, smi)
    torch.cuda.empty_cache()

    print(f"[21] the fleet's front door and membership at GPT-2-125M width: {FLEET_REPLICAS} in-process replicas "
          f"behind the HTTP/SSE gateway (workload (b) blocking and streamed, disconnects, a rolling upgrade under "
          f"traffic), the autoscaler under the surge trace with a replica killed, {FLEET_REPLICAS} worker processes "
          f"over TCP (SIGKILL, respawn, a set_spec rolling upgrade)")
    gateway = gateway_phase(dev, smi)

    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:54",
        "launches": launches[0], "combine_launches": launches[1],
        "serving_launches": serving_launches[0], "serving_combine_launches": serving_launches[1],
        "fleet_inprocess_launches": fleet["inprocess"], "fleet_worker_launches": fleet["workers"],
        "gateway_inprocess_launches": gateway["inprocess"], "gateway_surge_replays": gateway["surge_replays"],
        "gateway_worker_launches": gateway["workers"],
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
            "resilience_launches": resilience["launches"][list(replaces).index(name)],
            "hgmma": sass.get(MAIN_PATH_KERNEL[name], {}).get("hgmma", 0),
            "registers": sass.get(MAIN_PATH_KERNEL[name], {}).get("registers"),
            "spill_stores": sass.get(MAIN_PATH_KERNEL[name], {}).get("spill_stores"),
        })
    replaces = {"fused_xent_forward": "deepspeed_tpu/ops/pallas/fused_xent.py:73",
                "fused_xent_backward_dh": "deepspeed_tpu/ops/pallas/fused_xent.py:171",
                "fused_xent_backward_dw": "deepspeed_tpu/ops/pallas/fused_xent.py:193"}
    fwd_launches, combine_launches, ds_launches, dw_launches, dh_launches = xent_launches
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
        r19 = resilience["launches"]
        entry["resilience_launches"] = (
            {"product": r19[4], "combine": r19[5]} if name == "fused_xent_forward"
            else {"ds": r19[6], "dH" if name == "fused_xent_backward_dh" else "dW": r19[8 if name.endswith("dh") else 7]})
        if name == "fused_xent_forward":
            fwd = xent_sass[XENT_MAIN_PATH["fwd"]]
            entry.update(
                ms_is="the forward: its product and its combine, as one call runs them",
                unfused_cross_entropy_ms=t["unfused_cross_entropy_ms"],
                kernels=[{"name": XENT_MAIN_PATH["fwd"], "launches": fwd_launches,
                          "launches_per_train_batch": fwd_launches // TRAIN_STEPS, "ms": t["product_ms"],
                          "hgmma": fwd["hgmma"], "registers": fwd["registers"], "spill_stores": fwd["spill_stores"]},
                         {"name": "xent_lse_combine", "launches": combine_launches,
                          "launches_per_train_batch": combine_launches // TRAIN_STEPS, "ms": t["combine_ms"]}])
        else:
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
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_ratio", "dense_flash_ms",
             "dense_flash_ratio", "tflops")
    for (name, where), n in zip(replaces.items(), sparse_launches):
        t, e, bb = sparse_times[name], sparse_errs[name], bigbird_times[name]
        built = sparse_sass.get(SPARSE_MAIN_PATH[name], {})
        kernels.append({
            "name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
            "replaces": where, "launches": n,
            "max_abs_err": e[torch.bfloat16][0], "max_abs_err_fp32": e[torch.float32][0],
            "max_abs_err_fp16": e[torch.float16][0],
            "max_rel_err": e[torch.bfloat16][1], "max_rel_err_fp32": e[torch.float32][1],
            "max_rel_err_fp16": e[torch.float16][1],
            **{k: t[k] for k in timed},
            "kernel": SPARSE_MAIN_PATH[name], "hgmma": built.get("hgmma", 0), "registers": built.get("registers"),
            "spill_stores": built.get("spill_stores"),
            "bigbird128": {k: bb[k] for k in timed},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"training": training}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
