#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or makes the script exit non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the decode-attention kernel from deepspeed_tpu_torch/csrc;
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
     greedy tokens through the kernel equal the plain path's.
It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a GPU it exits 1 and prints no
result.

    python3 chip_smoke.py --profile chiprun_out/profile

also traces one generate(max_new_tokens=64) with torch.profiler and prints
the device's busy share and its time by kernel.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (the kernel's math)
B, SMAX, H, D = 8, 1024, 12, 64
POS_ROWS = [0, 1, 127, 128, 500, 767, 1022, 1023]
# fp32: the kernel and the plain version differ in summation order only.
# bf16: both accumulate in fp32 and round the output to bf16 once, so they
# differ by at most about one bf16 ulp (2^-7 relative) of outputs below 2.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def profile(engine, prompt, out_dir):
    """Trace one generate of PROFILE_NEW tokens with torch.profiler: device
    busy share of the wall time and device time by kernel name. Writes the
    Chrome trace into ``out_dir``."""
    import os

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=PROFILE_NEW)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("  profile: the profiler recorded no device events; device time not measured")
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"  profile generate(max_new_tokens={PROFILE_NEW}): wall {wall_us/1e3:.1f} ms, device busy "
          f"{busy/1e3:.1f} ms ({busy/wall_us:.1%}), {len(kernels)} kernel launches")
    for name, us in top:
        print(f"    {us/1e3:9.3f} ms  {us/busy:6.1%}  {name[:100]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "generate_trace.json"))
    print(json.dumps({"profile": {"max_new_tokens": PROFILE_NEW, "wall_ms": wall_us / 1e3,
                                  "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
                                  "kernel_launches": len(kernels),
                                  "top_ms": {n[:80]: us / 1e3 for n, us in top}}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace a short generate into DIR")
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
    op_builder.load("decode_attention")
    print(f"[2] built decode_attention in {time.perf_counter() - t0:.2f} s")

    print("[3] decode_attention kernel vs plain")
    errs = kernel_checks(dev)
    times = kernel_timing(dev)

    print("[4] serving: init_inference -> generate at GPT-2-125M width")
    launches, engine, prompt = serve(dev)
    if args.profile:
        profile(engine, prompt, args.profile)

    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:54",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_fp32": errs[torch.float32],
        "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
