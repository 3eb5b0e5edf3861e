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
     drain with exit 0 (the worker processes of phases 21 and 22 boot
     beside these two, so no later phase waits for its boot). It prints
     tokens/s, TTFT p50/p99 and TPOT
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
 22. disaggregated prefill/decode serving at GPT-2-125M width (phase 18's
     configuration, 64-token KV windows), the flight recorder on throughout
     (rings, SLOs, incident bundles into a temporary directory): (a)
     workloads (a) and (b) through 2 co-located replicas and through 1
     prefill + 1 decode replica, every request ok, the prefill replica with
     no decode program, no graph and no completion, the decode replica's
     launches 12 + 12 a replay; the profiler's kernel records over the
     prefill replica's own steps (no decode kernel) and over the decode
     replica's (12 + 12 a replay); a small fp32 fleet's 1 + 1 greedy
     streams equal to 2 co-located replicas'; workload (b) co-located with
     the recorder off; (b) the int8 wire: the bytes saved and the largest
     per-window dequantisation error against JAX's bound; (c) 2 prefill + 1
     decode worker processes over TCP, the prefill worker streaming the
     second handoff SIGKILLed between two of its windows, judged by
     resilience/invariants.py (zero accepted loss, terminal conservation,
     exactly-once failover), the dead verdict, bf16 windows across the
     process boundary, and one incident bundle holding the kill and its
     failovers that the autopsy validates; (d) per-pool autoscaling 1..2
     under phase 21's surge trace, each pool scaling at least once and both
     back to 1; (e) the SLO tracker's verdict and the rings' cells against
     their bound. It prints tokens/s, TTFT and TPOT disaggregated against
     co-located, handoff ms p50/p99, bytes per handoff, the parked
     backlog's peak and the recorder's cost.
 23. the launch stack, elastic training and the chaos conductor at
     GPT-2-125M width. The worker is this script in its hidden
     ``--elastic-worker`` mode: phase 7's step through the fused loss on
     the card, its batch (64 = 16 x gas 4) from an ``elasticity`` block
     through the engine, a heartbeat touch after every train_batch and
     save, a synchronous save after every other step but the last, one
     JSON line per step and per generation. (a) ``python -m
     deepspeed_tpu_torch.launcher.runner --hostfile <localhost slots=1>``
     runs it 6 steps uninterrupted (the drills' reference): the rendezvous
     env (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, the DSTPU_* keys), 48
     launches of each flash kernel a train_batch, rc 0; then SIGTERM to a
     second launch's process group mid-step, and its whole tree (runner,
     launch, worker) gone within 30 s with none of it on the card. (b)
     ``DSElasticAgent`` over that hostfile: generation 0 trains 4 steps
     (saving after steps 2 and 4) and SIGKILLs itself, the agent backs off
     and relaunches, and generation 1 loads 'latest' and trains to step 6;
     every loss equals (a)'s bitwise, restart_count 1, rc 0. (c) the
     hang drill: generation 0 stops touching the heartbeat after step 2;
     the agent (timeout 3 x the longest gap between (b)'s touches, at least
     5 s; grace 600 s) SIGKILLs it and generation 1 resumes bitwise to step
     4; it prints the last touch -> kill seconds and the relaunch's boot ->
     first step. (d) ``ChaosRunner`` over 3 real ``ServingEngine``
     replicas (2 slots, phase 18's model and seeded weights, 6 new tokens,
     each replica with the schedule's fault injection): 4 generated
     schedules over the fake-fleet sites, each run twice, green under the
     invariant oracles with one digest, 12 + 12 decode launches a replay,
     the device memory after the last schedule beside the first's; then a
     64-schedule fake-fleet ``search`` with a planted oracle on
     ``garbage_logits``, shrunk to a reproducer that no single entry can
     leave, which ``replay_repro`` re-executes bit-identically.
 24. the memory tiers (runtime/zero/): (a) phase 7's configuration with
     zero_optimization.offload_optimizer cpu against none, from the same
     seeded weights: the fp32 masters and Adam moments in pinned host
     memory, the update on the host in place, the bf16 copy back to the
     card; step ms and peak memory of each beside the estimator's HBM and
     host figures, the first three losses within the CPU parity test's
     rtol 2e-2, 48 launches of each flash kernel a train_batch; (b)
     offload_param cpu on it: the parameters stream from pinned host memory
     a layer at a time (the backward streams each layer again), the
     gradients go to the host; its host-to-device and device-to-host bytes
     a step against the reckoning; (c) offload_optimizer and offload_param
     nvme under a temporary directory: the NVMe tier's read and write GB/s
     from its own byte counts and clock, then save -> a fresh engine loads
     -> one step, bitwise the uninterrupted engine's; (d) GPT-3 6.7B widths
     (32 layers, d_model 4096, 32 heads, 2048 positions, vocab 50304, the
     fused loss), whose 16P bytes exceed the card's free memory: host
     MemAvailable and the disk's free bytes decide the tier (cpu when host
     memory holds 12P and the buffers, else nvme; depth cut only as far as
     both force), one train_batch, its seconds, the host update's, peak HBM
     against the estimator's 2P + 4P.
 25. profiling (telemetry/program_ledger.py, cost.py, report.py,
     profiling/flops_profiler, utils/timer.py, env_report.py): (a) phase 7's
     configuration and (b) phase 10's with the JAX package's default
     telemetry block (the program ledger on, a JSONL sink),
     wall_clock_breakdown, memory_breakdown and the flops profiler at step
     2, the ledger off, on, then off again from the same seeded weights: step
     ms and the first train_batch's seconds each way, the train/train_step
     row (FLOPs, bytes, intensity, wall p50, achieved TFLOP/s, mfu and the
     roofline verdict, rated against the H100's data sheet) with its
     kernels' calls, its FLOPs against Model.flops_per_token x tokens, and
     the launches a train_batch unchanged by the ledger; (c) phase 18's
     serving engine on workload (a), the ledger off then on: the
     serving/decode row (hbm-bound), the serving/mfu gauge, one decode
     graph with 12 + 12 launches a replay either way; (d) python -m
     deepspeed_tpu_torch.telemetry.report over (a)'s and (c)'s JSONL, its
     rows rated; (e) python -m deepspeed_tpu_torch.env_report; (f) host µs a
     call of the flash forward and the fused loss's forward with no counter
     active (``kernel_call_timing``, which also times a parent checkout).
 26. data parallelism (comm/, parallel/sharding.py, runtime/zero/): (a) a
     world of 1 under NCCL, through the real communicator: phase 7's
     configuration under ZeRO 0, 1, 2 and 3 from the same seeded weights,
     one warm-up and 3 timed steps each: ms/step, peak memory, the comms
     logger's collectives and bytes a step beside the reckoning
     (``dp_reckoning``), 48 launches of each flash kernel per train_batch
     and none of the other kernels, and each stage's loss within 2e-3 of
     stage 0's; (b) a world of 2 under
     gloo, both ranks on the card (this script in its hidden
     ``--dp-worker`` mode, a FileStore rendezvous; booted at the phase's
     start beside (a), they wait for it to finish): each rank first probes
     which gloo collectives take CUDA tensors, then runs ZeRO 1 and ZeRO 3
     at global batch 32 = 2 x micro 4 x gas 4, each rank's losses within
     2e-3 of a world of 1 on the same global batches, each rank's
     optimizer-state bytes (and at ZeRO 3 parameter bytes) about half of
     world 1's, the logged bytes a step beside the reckoning; the ZeRO-3
     state saved at world 2 is loaded at world 1 under ZeRO 1: every fp32
     leaf it loads (masters and moments) bitwise the one world 2 gathered
     and saved, and its next loss within ``DP_LOSS_RTOL`` of world 2's.
 27. tensor-parallel serving (module_inject/layers.py, the model's model
     axis, parallel/sharding.py's KV specs, the ServingEngine's driver and
     followers): gloo worlds of 2 and 4 ranks sharing the card (this
     script in its hidden ``--tp-worker`` mode), booted together while
     this process runs tp 1. (a) init_inference -> generate at GPT-2-125M
     width (6 and 3 heads a rank), 4 x 128-token prompts, 32 new tokens:
     in fp32 the greedy tokens equal tp 1's; in bf16 the first decode
     step's logits within ``TP_BF16_GAP`` of tp 1's, and above it when
     model index 1's wo shards are zeroed (a rank computing the wrong
     heads); each rank launches the split and combine decode kernels 12 x
     31 times a generate, on its own heads. (b) the ServingEngine at tp 2
     (the driver and its follower; the decode step eager) and at tp 1 (one
     CUDA graph) over the first 16 requests of workload (a), new tokens
     cut to a quarter: fp32 greedy streams equal, every rank's serve()
     returns the driver's results, tokens/s, TTFT p50/p99 and TPOT p50
     beside tp 1's, 12 + 12 decode launches a step on each rank, and a
     decode step's all-reduces, all-gather and bytes against the
     reckoning (``tp_reckoning``). No scaling is claimed: one card, gloo.
 28. tensor-parallel training (comm's conjugate collectives, the TP layers
     under autograd, the vocab-parallel loss, partition_activations, ZeRO x
     TP, TP-sharded checkpoints): gloo worlds sharing the card (this script
     in its hidden ``--tp-train-worker`` mode), booted while this process
     runs tp 1 on the same global batches. (a) tp 2 at phase 7's model (6
     heads and 25152 vocab rows a rank), ZeRO 1, batch 8 = micro 4 x gas 2,
     one warm-up and 3 timed steps: each rank's losses within
     ``TPT_LOSS_GAP`` of tp 1's, and the first batch's loss with model
     index 1's wo shard zeroed beyond it; 24 launches of each flash kernel
     per train_batch on each rank and none of the fused loss (whose config
     falls back to the chunked loss here, as reported); ms/step, peak
     memory and each rank's parameter and optimizer-state bytes beside tp
     1's; the collectives over ``model`` a step against the reckoning
     (``tp_train_reckoning``). (b) data 2 x model 2 under ZeRO 3 with
     dots_and_flash remat and partition_activations, batch 16: losses
     within the limit; the saved layer boundaries' bytes a rank half of
     those without partition_activations, and the peak memory both ways;
     the state saved there loaded at world 1, whose next loss is (b)'s
     within the limit. No scaling is claimed: one card, gloo.
 29. pipeline parallelism (pipe/: PipelineEngine over a PipelinedTransformer,
     the stages' ppermute over ``pipe``, the tied embedding's gradient
     summed over it): a gloo world of 2 ranks, one stage each (this script
     in its hidden ``--pipe-worker`` mode), booted while this process runs a
     world-1 plain engine on the same weights and batches; phase 7's model
     with the fused loss (6 layers a stage), batch 8 = micro 2 x 4
     micro-batches, GPipe then the executed 1F1B, one warm-up and 2 timed
     steps each: each rank's losses within ``PIPE_LOSS_GAP`` of world 1's,
     and the first batch's loss with the last stage's wo zeroed beyond it;
     each kernel's launches a train_batch on each stage as reckoned from the
     code (``pipe_reckoning``: 24 of each flash kernel, the forward 48 under
     1F1B, and the fused loss on the last stage only); the ppermute count
     and bytes a step as reckoned; the bubble gauge 0.2; 1F1B's forward
     clocks ``TrainSchedule``'s; ms/step and peak memory a rank beside world
     1's. No scaling is claimed: one card, gloo;
 30. mixture of experts on one rank (moe/: GShard top-1 gating with
     capacity, the slot-table dispatch and combine, the expert bank) at
     GPT-3 125M widths with 64 experts on every other layer (Megatron-
     DeepSpeed's ds_pretrain_gpt_125M_MoE64.sh: top-1, capacity factor 1.0,
     aux coefficient 0.01; 1.94 B parameters), bf16, flash attention, the
     fused loss, ZeRO 1, batch 8 = one micro-batch of 8 x 1024 tokens: (a)
     the first MoE layer in bf16 against fp32 on the same input and weights
     (the routing equal, the output within ``TOL``, experts.wo zeroed far
     outside it); the bf16 kernel path's first loss within ``MOE_LOSS_GAP`` of the fp32
     plain path's (plain attention, chunked loss) on the same weights and
     batch and one MoE layer's experts.wo zeroed beyond it; the share of
     tokens dropped at step 0; 2 timed steps whose kernel launches equal
     ``moe_reckoning``'s; the first step from the same weights in a second
     engine bitwise equal (loss, masters, moments); ms/step, tokens/s and
     the peak beside the state's reckoning; (b) init_inference -> generate,
     8 x 128-token prompts, 64 new tokens: fp32 greedy tokens through the
     decode kernel equal to the plain path's, the bf16 first decode step's
     logit gap, bf16 decode ms a step beside the dense route's 3.62 GB of
     experts a step, and the decode kernel's launches (12 + 12 a step).
Every phase prints its seconds (``phase N: S s``), and the script its
total.
It prints a ``{"serving_engine": {...}}`` line, a ``{"resilience": {...}}``
line, a ``{"fleet": {...}}`` line, a ``{"gateway": {...}}`` line, a ``{"disagg": {...}}`` line, an
``{"elastic": {...}}`` line, a ``{"chaos": {...}}`` line, a ``{"profiling": {...}}`` line, a
``{"zero": {...}}`` line, a ``{"tensor_parallel": {...}}`` line, a
``{"tensor_parallel_training": {...}}`` line, a ``{"pipeline": {...}}`` line, a ``{"moe": {...}}`` line, a
``{"kernels": [...]}`` line, a
``{"training": {...}}`` line,
then as its last line ``{"ok": true, "device": {...}}``. Without a GPU it
exits 1 and prints no result.

    python3 chip_smoke.py --profile chiprun_out/profile

also traces one generate(max_new_tokens=64), one train_batch of phases 7,
10 and 15 and 20 serving steps of phase 18's workload (a) with torch.profiler and prints the device's busy share, its time
by kernel and the host's top ops by self time; and times phase 10's model
without remat beside it, which shows what remat's recompute costs the step.
"""

import argparse
import gc
import json
import os
import re
import shutil
import signal
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
from deepspeed_tpu_torch.runtime.swap_tensor import flatten

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


def bounds(work):
    """{kernel: (flops, bytes)} -> {kernel: (bound_ms, bound_by, bytes,
    flops)} on the tensor cores' bf16 peak and the HBM rate."""
    out = {}
    for name, (flops, nbytes) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)
    return out


def flash_bounds(B, S, H, D, elt):
    """{kernel: (bound_ms, bound_by, bytes, flops)} from the shape, the
    work the program ledger counts for each launch (``fa.flash_cost``):
    each input read once and each output written once; causal work is the
    S(S+1)/2 live (q, k) pairs, 2 flops per multiply-add of each D-long
    product."""
    return bounds(fa.flash_cost(B, S, S, H, D, elt))


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
    """{name: (bound_ms, bound_by, bytes, flops)} from the passes the
    program ledger counts (``fx.xent_cost``): each input read once and each
    output written once, 2·N·D·V flops for the logits. The forward computes
    them once; the backward pair ("fused_xent_backward": the ds, dW and dH
    passes) once more and then its two products; each of the pair's rows
    alone ("..._dh", "..._dw": the ds pass and its own product) would
    compute them again before its product."""
    w = fx.xent_cost(N, D, V, elt)

    def total(*names):
        return tuple(sum(w[n][i] for n in names) for i in (0, 1))

    return bounds({"fused_xent_forward": w["fused_xent_forward"],
                   "fused_xent_backward": total("xent_ds_pass", "xent_dw_pass", "xent_dh_pass"),
                   "fused_xent_backward_dh": total("xent_ds_pass", "xent_dh_pass"),
                   "fused_xent_backward_dw": total("xent_ds_pass", "xent_dw_pass")})


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
    """{kernel: (bound_ms, bound_by, bytes, flops)} from the work the program
    ledger counts (``sk.sparse_cost``): each input read once and each output
    written once (the lists a kernel walks included); this layout's active
    block pairs, diagonal blocks counted whole: 4·block²·D flops per pair
    per (b, h) forward, 6 for dQ, 8 for dK/dV."""
    return bounds(sk.sparse_cost(B, S, H, D, elt, lists))


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


_RESPAWN_FAST = {"max_attempts": 10, "base_delay_s": 0.05, "max_delay_s": 0.1, "jitter": 0.0}


def _worker_spec(serve_config, model_spec, engine_dtype, **serving):
    model = {**(model_spec or GPT2_SPEC), "dtype": "float32"}
    return {"model": model, "engine_dtype": engine_dtype,
            "serving": {**serve_config, "watchdog_mode": "raise", **serving}}


def fleet_worker_plan(serve_config, device="cuda", model_spec=None, engine_dtype="bf16"):
    """Phase 20's workers: (spec, count, supervisor keywords)."""
    return (_worker_spec(serve_config, model_spec, engine_dtype), FLEET_REPLICAS,
            {"transport": FLEET_TRANSPORT, "device": device, "respawn_backoff": _RESPAWN_FAST})


def gateway_worker_plan(serve_config, device="cuda", model_spec=None, engine_dtype="bf16"):
    """Phase 21 (e)'s workers, over TCP."""
    return (_worker_spec(serve_config, model_spec, engine_dtype), FLEET_REPLICAS,
            {"transport": {**FLEET_TRANSPORT, "family": "tcp", "host": "127.0.0.1"}, "device": device,
             "respawn_backoff": _RESPAWN_FAST})


def disagg_worker_plan(serve_config, device="cuda", model_spec=None, engine_dtype="bf16"):
    """Phase 22 (c)'s 2 prefill + 1 decode workers, over TCP, recorder on."""
    return (_worker_spec(serve_config, model_spec, engine_dtype, **FLIGHT_RECORDER), 3,
            {"transport": {**FLEET_TRANSPORT, "family": "tcp", "host": "127.0.0.1", "port_base": 0},
             "device": device, "roles": {0: "prefill", 1: "prefill", 2: "decode"}})


# worker processes booted ahead of their phase (``boot_workers_ahead``):
# plan name -> (supervisor, socket directory, wait)
_AHEAD: dict = {}


def _boot_workers(plan):
    """A WorkerSupervisor over a plan's workers, all spawned at once on
    background threads -> (supervisor, socket directory, wait); ``wait()``
    -> (clients, seconds from the spawn to the last worker serving)."""
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.launcher.serving_worker import WorkerSupervisor

    spec, n, kw = plan
    real, workdir = _socket_dir()
    sup = WorkerSupervisor(spec, n, workdir=workdir, **kw)
    t0, served = time.perf_counter(), {}

    def spawn(slot):
        client = sup.spawn(slot)
        served[slot] = time.perf_counter()
        return client

    ex = ThreadPoolExecutor(n)
    futures = [ex.submit(spawn, slot) for slot in range(n)]
    ex.shutdown(wait=False)

    def wait():
        clients = [f.result() for f in futures]
        return clients, max(served.values()) - t0

    return sup, real, wait


def _shutdown_ahead():
    """At exit: stop the workers booted ahead that no phase took."""
    import signal

    for sup, real, _ in _AHEAD.values():
        sup.shutdown(signal.SIGKILL, timeout=10.0)
        shutil.rmtree(real, ignore_errors=True)
    _AHEAD.clear()


def boot_workers_ahead(**plans) -> None:
    """Boot later phases' workers now, beside this phase's (each phase
    boots ~22 s on the card): ``name=plan``; the phase takes them with
    ``phase_workers(name, plan)``."""
    import atexit

    if not _AHEAD:
        atexit.register(_shutdown_ahead)
    for name, plan in plans.items():
        _AHEAD[name] = _boot_workers(plan)


def phase_workers(name, plan):
    """(supervisor, socket directory, wait) of a phase's workers: booted
    ahead under ``name``, else booted now from ``plan``."""
    ahead = _AHEAD.pop(name, None)
    return ahead if ahead is not None else _boot_workers(plan)


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
    profiler's kernel records (fleet_profiled_launches) measure it. A
    prefill-role replica captures nothing and replays nothing."""
    out, ok = [], True
    for r in router._replicas:
        w = r.engine.worker
        split, combine = w.decode_kernel_launches()
        replays = w.graph_replays
        if r.role == "prefill":
            ok &= w._graph is None and replays == 0 and split == combine == 0
        else:
            ok &= w.graph_launches == (expect, expect) and split == combine == expect * replays
        out.append({"rid": r.rid, "state": r.state, "role": r.role, "replays": replays, "split": split,
                    "combine": combine})
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


def worker_fleet(serve_config, vocab, smi, device="cuda", model_spec=None, engine_dtype="bf16", ahead=None):
    """Two worker processes under a WorkerSupervisor, a Router over their
    ReplicaClients; worker 0 SIGKILLed after router step KILL_STEP, its
    requests failed over, the worker respawned and attached; every request
    terminal; each worker's decode launches as it reports them; SIGTERM
    drains. ``ahead``: later phases' worker plans, booted beside these
    (``boot_workers_ahead``)."""
    import signal

    from deepspeed_tpu_torch.inference import Request, Router

    spec, _, _ = plan = fleet_worker_plan(serve_config, device, model_spec, engine_dtype)
    model = spec["model"]
    sup, real, wait = phase_workers("fleet", plan)  # both boot at once
    boot_workers_ahead(**(ahead or {}))
    out = {}
    try:
        clients, out["boot_s"] = wait()
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


def fleet_phase(dev, smi, model_cfg=None, serve_config=None, vocab_cap=None, ahead=None):
    """Phase 20. ``model_cfg``/``serve_config`` default to phase 18's
    (GPT-2-125M, bf16); a smaller pair rehearses the phase's control flow.
    ``ahead``: later phases' worker plans, booted beside this phase's
    workers."""
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
                                  engine_dtype="bf16" if model_cfg is None else "fp32", ahead=ahead)
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

    def timed_spawn(role=None):  # instrumentation: the newcomer's build and capture
        t = time.perf_counter()
        e = spawn(role=role)
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

    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.launcher.http_gateway import HttpGateway

    spec, _, kw = plan = gateway_worker_plan(serve_config, device, model_spec, engine_dtype)
    model, transport = spec["model"], kw["transport"]
    sup, real, wait = phase_workers("gateway", plan)
    out = {}
    gw = None
    try:
        clients, out["boot_s"] = wait()
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


# ---------------------------------------------------------------------------
# Phase 22: disaggregated prefill/decode serving (inference/router.py's
# handoff pump, rpc.encode_kv_window, the roles of inference/serving.py and
# launcher/serving_worker.py, per-pool autoscaling), judged by
# resilience/invariants.py, with the flight recorder (telemetry/timeseries.py,
# slo.py, incident.py, autopsy.py) on throughout, at GPT-2-125M width
# ---------------------------------------------------------------------------

HANDOFF_CHUNK = 64
# the fleet's flight recorder: rings at 0.25 s, SLO objectives loose enough
# that the workloads' own arrival bursts breach nothing (TTFT 5 s, TPOT
# 250 ms), incident bundles into a temporary directory
FLIGHT_RECORDER = {"timeseries": {"enabled": True, "interval_s": 0.25},
                   "slo": {"enabled": True, "ttft_s": 5.0, "tpot_s": 0.25, "window_s": 30.0,
                           "fast_window_s": 10.0, "slow_window_s": 30.0, "eval_interval_s": 0.5}}
DRILL_REQUESTS = 12  # workload (a)'s first requests through the worker kill drill
# per-pool envelopes 1..2 over phase 21's surge trace; the autoscale block's
# hysteresis as SURGE_AUTOSCALE's, the pools' thresholds at its queue and
# 3/4 of a replica's 16 slots
DISAGG_AUTOSCALE = {"enabled": True, "min_replicas": 1, "max_replicas": 4, "scale_down_load": 0.5,
                    "up_consecutive": 2, "down_consecutive": 8, "cooldown_s": 0.75}
DISAGG_POOLS = {"prefill_max_replicas": 2, "decode_max_replicas": 2, "prefill_scale_up_queue": 3,
                "prefill_scale_up_backlog": 12, "decode_scale_up_occupancy": 0.75}


def recorder_config(inc_dir, **extra):
    return {**FLIGHT_RECORDER, "incidents": {"enabled": True, "dir": inc_dir, "window_before_s": 10.0,
                                             "window_after_s": 0.5}, **extra}


def disagg_config(serve_config, inc_dir, prefill=1, decode=1, **disagg):
    return {**serve_config, "watchdog_mode": "raise", **recorder_config(inc_dir),
            "router": {"health": dict(FLEET_HEALTH),
                       "disagg": {"enabled": True, "prefill_replicas": prefill, "decode_replicas": decode,
                                  "handoff_chunk": HANDOFF_CHUNK, **disagg}}}


def pools(router):
    return ([r for r in router._replicas if r.role == "prefill"], [r for r in router._replicas if r.role == "decode"])


def handoff_metrics(router, peak):
    """The pump's histograms and counters: handoff ms p50/p99, bytes per
    handoff, the parked backlog's peak, the int8 bytes saved."""
    reg = router.telemetry.registry
    h, b = reg.get("router/disagg/handoff_sec"), reg.get("router/disagg/handoff_bytes")
    saved = reg.get("router/disagg/kv_bytes_saved")
    n = int(h.count) if h is not None else 0
    return {"handoffs": router.router_stats()["disagg"]["handoffs"],
            "handoff_ms_p50": h.quantile(0.5) * 1e3 if n else None,
            "handoff_ms_p99": h.quantile(0.99) * 1e3 if n else None,
            "bytes_per_handoff": (b.sum / b.count) if b is not None and b.count else None,
            "wire_bytes": b.sum if b is not None else 0, "kv_bytes_saved": saved.value if saved is not None else 0,
            "parked_backlog_peak": peak}


def disagg_contract(router, res, label):
    """Every request terminal and ok, every replica idle with its slots
    accounted (a parked handoff released, a staged import committed), the
    prefill pool's replicas with no decode program and no completion, one
    decode program a decode replica."""
    stats = router.router_stats()
    pre, dec = pools(router)
    live = [r for r in router._replicas if r.state != "dead"]
    slots_ok = all(r.engine.idle and r.engine.n_free + len(r.engine.quarantined_slots) == r.engine.n_slots
                   for r in live)
    terminal = all(x is not None and x.ok for x in res.values())
    roles_ok = (all(r.engine.compile_counts()["decode"] == 0 and r.completed == 0 for r in pre)
                and all(r.engine.compile_counts()["decode"] == 1 for r in dec))
    ok = terminal and slots_ok and roles_ok and stats["disagg"]["parked_backlog"] == 0
    print(f"    contract: every request terminal and ok {terminal}; every replica idle with n_free + quarantined = "
          f"n_slots {slots_ok}; prefill replicas no decode program and no completion, one decode program a decode "
          f"replica {roles_ok}; parked backlog {stats['disagg']['parked_backlog']}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"disaggregated fleet {label} failed its contract")
    return stats


def run_disagg(router, reqs, label, smi, expect):
    peak = {"parked": 0}

    def watch(r):
        peak["parked"] = max(peak["parked"], r._handoff_backlog)

    res, seconds = serve_fleet(router, reqs, watch)
    m = serving_metrics(res, seconds)
    disagg_contract(router, res, label)
    launches, ok = replica_launches(router, expect)
    m.update(handoff_metrics(router, peak["parked"]), replicas=launches)
    print(f"  [{smi}] {label}: {m['ok']}/{m['requests']} ok, {m['tokens']} tokens in {seconds:.3f} s = "
          f"{m['tokens_per_s']:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; "
          f"TPOT p50 {m['tpot_p50_ms']:.3f} ms; {m['handoffs']} handoffs, handoff p50 "
          f"{m['handoff_ms_p50'] or 0:.2f} ms, p99 {m['handoff_ms_p99'] or 0:.2f} ms, "
          f"{(m['bytes_per_handoff'] or 0) / 1e6:.3f} MB per handoff, parked backlog peak {m['parked_backlog_peak']}")
    print(f"    decode launches (split, combine) by replica {[(e['role'], e['split'], e['combine']) for e in launches]}"
          f" for replays {[e['replays'] for e in launches]} (the capture's {expect} x replays; 0 on prefill)  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"disaggregated fleet {label}: a prefill replica decoded, or the launches do not match")
    return res, m


def run_colocated(engine, serve_config, reqs, label, smi, inc_dir, recorder=True):
    from deepspeed_tpu_torch.inference import Router

    extra = recorder_config(inc_dir) if recorder else {}
    router = Router(engine, config={**fleet_config(serve_config), **extra})
    for r in router._replicas:
        r.engine.warm_decode()
    res, seconds = serve_fleet(router, reqs)
    m = serving_metrics(res, seconds)
    check_fleet_contract(router, res, label, killed=False)
    print(f"  [{smi}] {label}: {m['ok']}/{m['requests']} ok, {m['tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; TPOT p50 {m['tpot_p50_ms']:.3f} ms")
    return router, res, m


def profiled_roles(router, vocab, L):
    """torch.profiler's kernel records over the prefill replica's own steps
    (its chunks run; no decode kernel may appear) and then over the decode
    replica's own steps (num_layers split and combine records a replay)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    (pre,), (dec,) = pools(router)
    for r in ragged_workload(vocab, RAGGED_RATE, seed=12, uid0=60000)[:4]:
        r.arrival_time, r.max_new_tokens = 0.0, 16
        router.submit(r)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while pre.engine._queue or pre.engine._prefilling:
            pre.engine.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    pre_records = (sum("decode_split_kernel" in n for n in names), sum("decode_combine_kernel" in n for n in names),
                   len(names))
    router.step()  # the pump hands the parked prefills to the decode replica
    before = dec.engine.worker.graph_replays
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            dec.engine.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    replays = dec.engine.worker.graph_replays - before
    dec_records = (sum("decode_split_kernel" in n for n in names), sum("decode_combine_kernel" in n for n in names),
                   replays)
    router.drain()
    ok = pre_records[:2] == (0, 0) and pre_records[2] > 0 and replays > 0 and dec_records[:2] == (L * replays,) * 2
    print(f"    profiler: the prefill replica's own steps {pre_records[2]} kernel records, {pre_records[0]} split + "
          f"{pre_records[1]} combine decode kernels (expect 0); the decode replica's 3 steps {dec_records[0]} split "
          f"+ {dec_records[1]} combine for {replays} replays (expect {L} x replays)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the profiler saw a decode kernel on the prefill replica or other than num_layers a replay")
    return {"prefill_records": pre_records[2], "prefill_decode_kernels": list(pre_records[:2]),
            "decode_split": dec_records[0], "decode_combine": dec_records[1], "decode_replays": replays}


def disagg_parity_small(dev, inc_dir):
    """A small fp32 fleet on the device: the 1 + 1 disaggregated fleet's
    greedy streams must equal the co-located fleet's (2 replicas) exactly."""
    from deepspeed_tpu_torch.inference import Request, Router

    tiny = TransformerConfig(vocab_size=97, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=32)
    eng = deepspeed_tpu_torch.init_inference(Model(tiny), config={"dtype": "fp32"}, device=dev)
    rng = np.random.default_rng(8)
    specs = [(rng.integers(0, 97, size=int(rng.integers(4, 150))).astype(np.int32), int(rng.integers(8, 40)))
             for _ in range(12)]
    small = {"n_slots": 4, "prefix_cache": {"enabled": True, "n_slots": 4, "max_prefix_len": 128},
             "chunked_prefill": {"enabled": True, "chunk_size": 32}}
    runs = {}
    for label, cfg in (("colocated", {**small, "router": {"replicas": 2}}),
                       ("disagg", disagg_config(small, inc_dir))):
        router = Router(eng, config=cfg)
        runs[label] = router.serve([Request(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(specs)])
    same = all(runs["disagg"][i].ok and np.array_equal(runs["disagg"][i].tokens, runs["colocated"][i].tokens)
               for i in range(len(specs)))
    print(f"  small fp32 fleet (2 layers), 1 prefill + 1 decode vs 2 co-located replicas: every greedy stream "
          f"equal: {same}  {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("the fp32 disaggregated fleet's greedy streams differ from the co-located fleet's")
    return {"requests": len(specs), "tokens_equal": same}


def int8_wire(engine, serve_config, vocab, smi, inc_dir, expect):
    """(b): (a)'s disaggregated workload (b) with kv_compression int8: the
    bytes saved against the raw bytes, the largest per-window dequantisation
    error against JAX's bound (absmax / 127 x 0.5001, tests/test_disagg.py's),
    before and after the rounding back to the cache's dtype."""
    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.inference.rpc import dequantize_int8, quantize_int8

    router = Router(engine, config=disagg_config(serve_config, inc_dir, kv_compression="int8"))
    for r in router._replicas:
        r.engine.warm_decode()
    (pre,), _ = pools(router)
    worst = {"f32": 0.0, "cast": 0.0}
    export = pre.engine.kv_export_window

    def measured_export(uid, start, width):  # instrumentation: the windows' quantisation error
        k, v = export(uid, start, width)
        for a in (k, v):
            a32 = a.float().numpy()
            q, scale = quantize_int8(a)
            bound = float(np.max(np.abs(a32))) / 127.0 * 0.5001
            if bound:
                back = dequantize_int8(q, scale)
                worst["f32"] = max(worst["f32"], float(np.max(np.abs(back - a32))) / bound)
                cast = torch.as_tensor(dequantize_int8(q, scale, str(a.dtype).rsplit(".", 1)[-1])).float().numpy()
                worst["cast"] = max(worst["cast"], float(np.max(np.abs(cast - a32))) / bound)
        return k, v

    pre.engine.kv_export_window = measured_export
    _, m = run_disagg(router, ragged_workload(vocab, RAGGED_RATE, seed=13), "(b) 1 + 1, workload (b), int8 wire",
                      smi, expect)
    raw = m["wire_bytes"] + m["kv_bytes_saved"]
    m.update(saved_fraction=m["kv_bytes_saved"] / raw if raw else 0.0, dequant_err_over_bound=worst["f32"],
             dequant_err_over_bound_after_cast=worst["cast"])
    ok = m["kv_bytes_saved"] > 0 and worst["f32"] <= 1.0
    print(f"    int8 wire: {m['kv_bytes_saved'] / 1e6:.2f} MB saved of {raw / 1e6:.2f} MB raw "
          f"({m['saved_fraction']:.3f}); the largest per-window error / JAX's bound {worst['f32']:.4f} in fp32 "
          f"(<= 1), {worst['cast']:.4f} after the rounding back to the cache's dtype  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the int8 wire saved nothing or broke JAX's quantisation bound")
    return m


def disagg_workers(serve_config, vocab, smi, inc_dir, device="cuda", model_spec=None, engine_dtype="bf16"):
    """(c): 2 prefill-role and 1 decode-role worker processes over TCP; the
    prefill worker that streams the second handoff is SIGKILLed between two
    of its windows (bench.py:843-870's drill). Judged by the port's
    invariants: zero accepted-request loss, exactly-once failover, the dead
    verdict; bf16 windows crossed the process boundary; the kill leaves one
    coalesced incident bundle that the autopsy validates."""
    import signal

    from deepspeed_tpu_torch.inference import Router
    from deepspeed_tpu_torch.resilience import invariants
    from deepspeed_tpu_torch.telemetry import autopsy

    spec, _, kw = plan = disagg_worker_plan(serve_config, device, model_spec, engine_dtype)
    model, transport = spec["model"], kw["transport"]
    sup, real, wait = phase_workers("disagg", plan)  # all boot at once
    out = {}
    try:
        clients, out["boot_s"] = wait()
        router = Router(config={**recorder_config(inc_dir), "router": {
            "replicas": 3, "health": dict(FLEET_HEALTH), "transport": transport,
            "disagg": {"enabled": True, "handoff_chunk": HANDOFF_CHUNK}}}, replica_engines=clients)
        roles = [r.role for r in router._replicas]
        seen = {"uids": [], "dtypes": set(), "windows": 0}
        killed = {}

        def instrument(slot, client):
            export = client.kv_export_window

            def drill(uid, start, width, **kw):
                if uid not in seen["uids"]:
                    seen["uids"].append(uid)
                if not killed and start > 0 and seen["uids"].index(uid) == 1:
                    # the second handoff, between two of its windows
                    sup.kill(slot, signal.SIGKILL)
                    sup.proc(slot).wait(timeout=30)
                    killed.update(slot=slot, uid=uid, start=start, t=router.now())
                window = export(uid, start, width, **kw)
                seen["dtypes"].add(str(window["k"].dtype))
                seen["windows"] += 1
                return window

            client.kv_export_window = drill

        for slot in (0, 1):
            instrument(slot, clients[slot])
        reqs = shared_prefix_workload(vocab)[:DRILL_REQUESTS]
        for r in reqs:
            r.uid += 20000
        terminal_events = []
        step = router.step

        def recording_step(*a, **kw):  # the terminal uids every step returns
            uids = step(*a, **kw)
            terminal_events.extend(uids)
            return uids

        router.step = recording_step
        res, seconds = serve_fleet(router, reqs)
        router.drain()  # finalizes the staged incident
        m = serving_metrics(res, seconds)
        stats = router.router_stats()
        accepted = [r.uid for r in reqs]
        results = {u: router.result(u) for u in accepted if router.result(u) is not None}
        violations = (invariants.zero_accepted_loss(accepted, results)
                      + invariants.terminal_uid_conservation(accepted, router.results)
                      + invariants.exactly_once_failover(stats, min_recovered=1, terminal_events=terminal_events))
        victim = killed.get("slot")
        dead = victim is not None and router.replica_states()[victim] == "dead"
        bundles = sorted(f for f in os.listdir(inc_dir) if f.startswith("incident-"))
        kill_bundles = []
        for f in bundles:
            b = autopsy.load_bundle(os.path.join(inc_dir, f))
            if any(t["kind"] == "replica_dead" for t in b["triggers"]):
                kill_bundles.append((f, b))
        problems = autopsy.validate(kill_bundles[0][1]) if len(kill_bundles) == 1 else ["no single kill bundle"]
        cli = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.telemetry.autopsy",
                              os.path.join(inc_dir, kill_bundles[0][0])] if kill_bundles else [sys.executable, "-c",
                                                                                              "exit(2)"],
                             capture_output=True, text=True, timeout=120)
        triggers = [t["kind"] for t in kill_bundles[0][1]["triggers"]] if kill_bundles else []
        bf16 = seen["dtypes"] == {"torch.bfloat16"} if engine_dtype == "bf16" else bool(seen["dtypes"])
        ok = (not violations and dead and bf16 and len(kill_bundles) == 1 and not problems and cli.returncode == 0
              and roles == ["prefill", "prefill", "decode"] and stats["disagg"]["handoffs"] >= DRILL_REQUESTS)
        reported = {}
        other = 1 - victim if victim is not None else 1  # the surviving prefill worker
        for slot in (2, other):
            snap = clients[slot].telemetry_snapshot()
            reported[slot] = snap["decode_kernel_launches"]
        # the decode worker's graph replays launched the kernel; the
        # surviving prefill worker never decoded
        L = model["num_layers"]
        ok &= device != "cuda" or (reported[2][0] > 0 and reported[2][0] == reported[2][1]
                                   and reported[2][0] % L == 0 and list(reported[other]) == [0, 0])
        print(f"  [{smi}] (c) 2 prefill + 1 decode worker processes over TCP ({device}), booted together in "
              f"{out['boot_s']:.1f} s, roles {roles}; prefill worker {victim} SIGKILLed before window "
              f"{killed.get('start')} of handoff 2 (uid {killed.get('uid')}): {m['ok']}/{m['requests']} ok, "
              f"{m['tokens_per_s']:.1f} tokens/s; {stats['disagg']['handoffs']} handoffs, {seen['windows']} windows "
              f"exported, window dtypes {sorted(seen['dtypes'])}; invariants (zero accepted loss, terminal "
              f"conservation, exactly-once failover): {[str(v) for v in violations] or 'none violated'}; dead "
              f"verdict {dead}; failovers_recovered {stats['failovers_recovered']}; incident bundles {bundles}, the "
              f"kill's triggers {triggers}, autopsy problems {problems}, its CLI exit {cli.returncode}; decode "
              f"launches as reported {reported}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the disaggregated worker drill broke an invariant, sent no bf16 window or left no "
                             "single valid incident bundle")
        out.update(metrics=m, handoffs=stats["disagg"]["handoffs"], windows=seen["windows"],
                   window_dtypes=sorted(seen["dtypes"]), killed=killed, failovers_recovered=stats["failovers_recovered"],
                   violations=[str(v) for v in violations], bundles=bundles, kill_triggers=triggers,
                   autopsy_exit=cli.returncode, reported_launches=reported,
                   handoff=handoff_metrics(router, None))
        return out
    finally:
        sup.shutdown(signal.SIGKILL, timeout=10.0)
        shutil.rmtree(real, ignore_errors=True)


def disagg_surge(engine, serve_config, vocab, smi, inc_dir):
    """(d): phase 21's surge trace into a 1 + 1 disaggregated fleet with
    per-pool envelopes 1..2: each pool must scale on its own signals at
    least once, and both must return to 1."""
    from deepspeed_tpu_torch.inference import Request, Router

    cfg = disagg_config(serve_config, inc_dir, **DISAGG_POOLS)
    cfg["router"]["autoscale"] = dict(DISAGG_AUTOSCALE)
    router = Router(engine, config=cfg)
    for r in router._replicas:
        r.engine.warm_decode()
    asc = router._autoscaler
    reqs = [Request(uid=30000 + i, prompt=np.asarray(body["prompt"], np.int32),
                    max_new_tokens=body["max_new_tokens"], arrival_time=offset,
                    priority=int(headers["X-DSTPU-Priority"]))
            for i, (offset, body, _, headers) in enumerate(surge_trace(vocab))]
    peak = {"prefill": 1, "decode": 1}

    def watch(r):
        for role in peak:
            peak[role] = max(peak[role], sum(x.state == "healthy" and x.role == role for x in r._replicas))

    res, seconds = serve_fleet(router, reqs, watch)
    t_end = time.perf_counter() + 60.0
    while time.perf_counter() < t_end:
        router.step()
        states = router.replica_states()
        if (asc.pool_target == {"prefill": 1, "decode": 1} and not asc._boots
                and not any(s == "draining" for s in states.values())):
            break
        time.sleep(0.02)
    events = [(e["kind"], e.get("pool")) for e in asc.events]
    decisions = {role: sum(k in ("scale_up", "scale_down") and p == role for k, p in events) for role in peak}
    ups = {role: sum(k == "scale_up" and p == role for k, p in events) for role in peak}
    healthy = {role: sum(r.state == "healthy" and r.role == role for r in router._replicas) for role in peak}
    terminal = all(x is not None and x.ok for x in res.values())
    ok = (terminal and all(n >= 1 for n in decisions.values()) and asc.pool_target == {"prefill": 1, "decode": 1}
          and healthy == {"prefill": 1, "decode": 1})
    print(f"  [{smi}] (d) per-pool autoscaling 1..2 each under the surge trace ({len(reqs)} requests) in "
          f"{seconds:.2f} s: peak healthy {peak}; scale decisions {decisions} (ups {ups}); final targets "
          f"{asc.pool_target}, healthy {healthy}; every request terminal and ok {terminal}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("a pool made no scale decision or did not return to 1, or a request was lost")
    return {"seconds": seconds, "peak": peak, "decisions": decisions, "ups": ups, "events": events,
            "final_targets": dict(asc.pool_target), "metrics": serving_metrics(res, seconds)}


def ring_cells(router):
    """Cells held by the Router's rings and its per-replica mirrors, beside
    their bound (series x tiers x capacity)."""
    snaps = [router._rings.snapshot()] + [s.snapshot() for s in router._ring_mirror.values()]
    cells = sum(len(c) for s in snaps for tiers in s["series"].values() for c in tiers.values())
    bound = sum(len(s["series"]) for s in snaps) * len(router._rings.intervals) * router._rings.capacity
    return cells, bound


def disagg_phase(dev, smi, model_cfg=None, serve_config=None, vocab_cap=None):
    """Phase 22. ``model_cfg``/``serve_config`` default to phase 18's
    (GPT-2-125M, bf16); a smaller pair rehearses the phase's control flow."""
    from deepspeed_tpu_torch.inference import Router

    cuda = dev.type == "cuda"
    cfg = model_cfg or TransformerConfig(**GPT2_SPEC)
    L = cfg.num_layers
    expect = L if cuda else 0
    serve_config = serve_config or SERVE_CONFIG
    engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16" if model_cfg is None else "fp32"},
                                                device=dev)
    vocab = vocab_cap or engine.cfg.vocab_size
    inc_root = tempfile.mkdtemp(prefix="dstt_incidents_")
    out = {"config": {**serve_config, "handoff_chunk": HANDOFF_CHUNK, "flight_recorder": FLIGHT_RECORDER,
                      "pools": DISAGG_POOLS, "autoscale": DISAGG_AUTOSCALE}}
    try:
        # (a) parity and speed: co-located 2 against disaggregated 1 + 1
        for key, label, make in (("a", "workload (a)", lambda: shared_prefix_workload(vocab)),
                                 ("b", "workload (b)", lambda: ragged_workload(vocab, RAGGED_RATE, seed=14))):
            _, res_c, mc = run_colocated(engine, serve_config, make(), f"(a) 2 co-located, {label}", smi,
                                         os.path.join(inc_root, f"colo_{key}"))
            router = Router(engine, config=disagg_config(serve_config, os.path.join(inc_root, f"dis_{key}")))
            for r in router._replicas:
                r.engine.warm_decode()
            reqs = make()
            res_d, md = run_disagg(router, reqs, f"(a) 1 prefill + 1 decode, {label}", smi, expect)
            greedy = [r.uid for r in reqs if r.temperature <= 0]
            same = sum(np.array_equal(res_d[u].tokens, res_c[u].tokens) for u in greedy)
            md.update(greedy=len(greedy), greedy_equal_to_colocated=same,
                      tokens_per_s_vs_colocated=md["tokens_per_s"] / mc["tokens_per_s"],
                      tpot_p50_vs_colocated=md["tpot_p50_ms"] / mc["tpot_p50_ms"],
                      ttft_p50_vs_colocated=md["ttft_p50_ms"] / mc["ttft_p50_ms"])
            print(f"    disaggregated / co-located: tokens/s {md['tokens_per_s_vs_colocated']:.3f}, TTFT p50 "
                  f"{md['ttft_p50_vs_colocated']:.3f}, TPOT p50 {md['tpot_p50_vs_colocated']:.3f}; greedy streams "
                  f"equal to the co-located fleet's {same}/{len(greedy)} (bf16; reported, not required)")
            if key == "b":
                cells, bound = ring_cells(router)
                slo = dict(router._slo.last) if router._slo is not None else {}
                ok = 0 < cells <= bound
                print(f"  [{smi}] (e) SLO tracker's last verdict: attainment {slo.get('attainment')}, breach "
                      f"{slo.get('breach')}; rings {cells} cells (bound {bound})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("the flight recorder's rings hold more cells than their bound, or none")
                out["slo"] = {"attainment": slo.get("attainment"), "burn": slo.get("burn"),
                              "breach": slo.get("breach"), "ring_cells": cells, "ring_bound": bound}
                if cuda:
                    md["profiled"] = profiled_roles(router, vocab, L)
            out[f"colocated_{key}"], out[f"disagg_{key}"] = mc, md
            del router
            if cuda:
                torch.cuda.empty_cache()
        _, _, off = run_colocated(engine, serve_config, ragged_workload(vocab, RAGGED_RATE, seed=14),
                                  "(a) 2 co-located, workload (b), flight recorder off", smi, inc_root, recorder=False)
        out["colocated_b_recorder_off"] = off
        out["recorder_cost"] = out["colocated_b"]["tokens_per_s"] / off["tokens_per_s"]
        print(f"    the flight recorder on / off, co-located workload (b): tokens/s {out['recorder_cost']:.3f}")
        out["fp32_parity"] = disagg_parity_small(dev, os.path.join(inc_root, "small"))
        out["int8"] = int8_wire(engine, serve_config, vocab, smi, os.path.join(inc_root, "int8"), expect)
        out["surge"] = disagg_surge(engine, serve_config, vocab, smi, os.path.join(inc_root, "surge"))
        del engine
        if cuda:
            torch.cuda.empty_cache()
        inc_dir = os.path.join(inc_root, "workers")
        os.makedirs(inc_dir)
        out["workers"] = disagg_workers(serve_config, vocab, smi, inc_dir, device=dev.type,
                                        model_spec=None if model_cfg is None else {
                                            k: getattr(cfg, k) for k in ("vocab_size", "max_seq_len", "num_layers",
                                                                         "num_heads", "hidden_size")},
                                        engine_dtype="bf16" if model_cfg is None else "fp32")
        print(json.dumps({"disagg": out}, default=str))
        return {"decode_replicas": [(e["split"], e["combine"]) for k in ("disagg_a", "disagg_b")
                                    for e in out[k]["replicas"] if e["role"] == "decode"],
                "prefill_replicas": [(e["split"], e["combine"]) for k in ("disagg_a", "disagg_b")
                                     for e in out[k]["replicas"] if e["role"] == "prefill"],
                "workers": {str(k): v for k, v in out["workers"]["reported_launches"].items()}}
    finally:
        shutil.rmtree(inc_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 23: the launch stack, elastic training and the chaos conductor
# ---------------------------------------------------------------------------

ELASTIC_SEED = 1000  # step k trains on tokens from np.random.default_rng(ELASTIC_SEED + k)
# the elastic block solves world 1 to phase 7's batch (64 = 16 x gas 4); the
# configured micro-batch of 1 is what the solution replaces
ELASTIC_BLOCK = {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [8, 16], "min_gpus": 1,
                 "max_gpus": 8, "ignore_non_elastic_batch_info": True}
ELASTIC_DS = {**{k: v for k, v in BENCH_DS.items() if k not in ("train_batch_size", "gradient_accumulation_steps")},
              "train_micro_batch_size_per_gpu": 1, "elasticity": ELASTIC_BLOCK, "checkpoint": {"keep_last_k": 1}}
# the CPU rehearsal's worker: the same control flow at a tiny size
ELASTIC_TINY = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32, dtype=torch.float32,
                    attn_impl="flash", loss_impl="fused_xent")
ELASTIC_TINY_DS = {"train_micro_batch_size_per_gpu": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                   "gradient_clipping": 1.0, "steps_per_print": 1000000, "checkpoint": {"keep_last_k": 1},
                   "elasticity": {**ELASTIC_BLOCK, "max_train_batch_size": 8, "micro_batch_sizes": [2, 4]}}
ELASTIC_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "DSTPU_COORDINATOR",
               "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID", "DSTPU_WORLD_INFO", "DSTPU_ELASTIC_WORLD_SIZE",
               "DSTPU_ELASTIC_MICRO_BATCH", "DSTPU_ELASTIC_BATCH", "DSTPU_ELASTIC_GENERATION")
TREE_GONE_BOUND_S = 30.0  # SIGTERM to the launch's process group -> no process of its tree left
CARD_FREE_SLACK = 256 << 20  # the card's free bytes after the SIGTERMed tree, at most this below those before it
RESTART_BACKOFF = {"base_delay_s": 1.0, "max_delay_s": 1.0, "jitter": 0.25}
# the elastic worker saves after every other step (each GPT-2 save writes
# 1.5 GB, ~3.5 s on the card); the drills' kills follow saved steps
ELASTIC_SAVE_EVERY = 2
ELASTIC_STEPS = 6  # the uninterrupted run (the launch stack's) and the crash drill
CRASH_AFTER, HANG_AFTER = 4, 2
CHAOS_SCHEDULES = 4  # 8 before phase 29 (a run 1.1-1.8 s on an H100, two a schedule): its seconds came out here
CHAOS_SEARCH = 64
CHAOS_SEED = 23
CHAOS_PLANTED_SITE = "garbage_logits"
CHAOS_MEMORY_SLACK = 64 << 20  # allocated bytes the last schedule may hold beyond the first's


def elastic_model(name):
    if name == "tiny":
        return TransformerConfig(**ELASTIC_TINY), ELASTIC_TINY_DS
    return gpt2_config(**RESILIENCE_MODEL), ELASTIC_DS


def _emit(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()


def elastic_worker(args) -> int:
    """``--elastic-worker``: phase 23's training process. It takes its batch
    from the elasticity block through the engine, resumes from ``--save-dir``
    when it holds a checkpoint, touches ``DSTPU_ELASTIC_HEARTBEAT`` after
    every train_batch (and after every save), saves synchronously after each
    step, and appends a JSON line per step and one per generation to
    ``--out``. With ``--save-dir`` it saves after every ``ELASTIC_SAVE_EVERY``-th
    step but the last (nothing resumes from it): a resume restarts from the
    latest such step. Generation 0 SIGKILLs itself after ``--crash-after`` steps, or
    stops touching the heartbeat and sleeps after ``--hang-after``. Its stamps
    are time.monotonic(), the clock of the agent's generation records."""
    from deepspeed_tpu_torch.elasticity import HEARTBEAT_ENV

    t_boot = time.monotonic()
    cfg, ds = elastic_model(args.model)
    # the card unless the caller asks for the CPU: without one this raises
    engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds,
                                            device=None if args.device == "cuda" else args.device)[0]
    gen = int(os.environ.get("DSTPU_ELASTIC_GENERATION", "0"))
    env = {k: os.environ.get(k) for k in ELASTIC_ENV}
    agent_batch = (env["DSTPU_ELASTIC_BATCH"], env["DSTPU_ELASTIC_MICRO_BATCH"])
    if agent_batch != (None, None) and agent_batch != (str(engine.train_batch_size), str(engine.micro_batch_size)):
        raise SystemExit(f"the agent's elastic solution {agent_batch} is not the engine's "
                         f"({engine.train_batch_size}, {engine.micro_batch_size})")
    resumed = None
    if args.save_dir and os.path.exists(os.path.join(args.save_dir, "latest")):
        resumed, _ = engine.load_checkpoint(args.save_dir)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t_ready = time.monotonic()
    hb = os.environ.get(HEARTBEAT_ENV)
    record = {"event": "generation", "generation": gen, "pid": os.getpid(), "ppid": os.getppid(),
              "device": str(engine.device), "env": env, "resumed_from": resumed,
              "batch": [engine.train_batch_size, engine.micro_batch_size, engine.gradient_accumulation_steps],
              "boot_s": t_ready - t_boot, "steps": [], "losses": [], "launches": [], "touches": [],
              "built": sorted(op_builder.PTXAS_INFO)}  # the sources this process compiled: none expected
    B, S = engine.train_batch_size, cfg.max_seq_len
    for step in range(engine.global_steps, args.steps):
        tokens = np.random.default_rng(ELASTIC_SEED + step).integers(0, cfg.vocab_size, size=(B, S + 1))
        t0 = time.monotonic()
        record.setdefault("first_step_start", t0)
        before = counts() + sparse_counts()
        metrics = engine.train_batch({"tokens": tokens.astype(np.int32)})
        loss = float(metrics["loss"])  # synchronises
        launches = [a - b for a, b in zip(counts() + sparse_counts(), before)]
        if hb:
            os.utime(hb)
            record["touches"].append(time.monotonic())
        t_save = time.monotonic()
        if args.save_dir and (step + 1) % ELASTIC_SAVE_EVERY == 0 and step + 1 < args.steps:
            engine.save_checkpoint(args.save_dir)
            if hb:
                os.utime(hb)
                record["touches"].append(time.monotonic())
        record["steps"].append(step + 1)
        record["losses"].append(loss)
        record["launches"].append(launches)
        _emit(args.out, {"event": "step", "generation": gen, "step": step + 1, "loss": loss, "pid": os.getpid(),
                         "ppid": os.getppid(), "step_s": t_save - t0, "save_s": time.monotonic() - t_save})
        if gen == 0 and step + 1 in (args.crash_after, args.hang_after):
            _emit(args.out, record)
            if step + 1 == args.crash_after:
                os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(600)  # wedged: alive, never touching the heartbeat again
            return 3  # the agent did not kill it
    _emit(args.out, record)
    return 0


def _read_events(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _generations(path):
    return [e for e in _read_events(path) if e["event"] == "generation"]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


def _card_free(cuda):
    """The card's free bytes over every process on it (cudaMemGetInfo)."""
    return torch.cuda.mem_get_info()[0] if cuda else 0


def _check(ok, what, detail=""):
    print(f"    {what}{': ' + detail if detail else ''}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 23 failed: {what}")


def _split_launches(launches):
    """A step's counts() + sparse_counts() delta -> (flash fwd, dK/dV, dQ),
    (xent fwd, combine, ds, dW, dH), (sparse fwd, dQ, dK/dV)."""
    return launches[:3], launches[4:N_COUNTS], launches[N_COUNTS:]


def _check_step_launches(gens, cfg, cuda):
    """Every train_batch of every generation: 48 of each flash kernel (L x gas)
    and the fused loss's launches (gas of each forward kernel, gas x chunks of
    each backward one), no decode and no sparse launch (the model is dense);
    none at all on the CPU. -> the totals of flash, xent and sparse launches."""
    flash_total, xent_total, sparse_total = [0] * 3, [0] * 5, [0] * N_SPARSE
    per_batch = None
    for g in gens:
        gas = g["batch"][2]
        for launches in g["launches"]:
            flash, xent, sparse = _split_launches(launches)
            flash_total = [a + b for a, b in zip(flash_total, flash)]
            xent_total = [a + b for a, b in zip(xent_total, xent)]
            sparse_total = [a + b for a, b in zip(sparse_total, sparse)]
            want_flash = [cfg.num_layers * gas] * 3 if cuda else [0, 0, 0]
            xent_ok = (xent[0] == xent[1] == gas and xent[2] == xent[3] == xent[4] > 0
                       and xent[2] % gas == 0) if cuda else xent == [0] * 5
            if (flash != want_flash or not xent_ok or launches[3] != 0 or sparse != [0] * N_SPARSE
                    or len(launches) != N_COUNTS + N_SPARSE):
                _check(False, f"kernel launches per train_batch {COUNT_LABEL}",
                       f"{launches} (flash expect {want_flash}, decode and sparse 0)")
            per_batch = launches
    return flash_total, xent_total, sparse_total, per_batch


def _worker_cmd(model, device, *args):
    return [sys.executable, os.path.abspath(__file__), "--elastic-worker", "--model", model, "--device", device,
            *[str(a) for a in args]]


def _launch_stack(root, hostfile, model, device, cfg, cuda):
    """(a): the runner -> launch -> the worker for ``ELASTIC_STEPS`` steps
    (the drills' uninterrupted reference), then SIGTERM to a second launch."""
    here = os.path.dirname(os.path.abspath(__file__))
    runner = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--hostfile", hostfile]
    out_path = os.path.join(root, "launch.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(runner + _worker_cmd(model, device, "--steps", ELASTIC_STEPS, "--out", out_path)[1:],
                          cwd=here, timeout=900)
    wall = time.perf_counter() - t0
    gens = _generations(out_path)
    _check(proc.returncode == 0 and len(gens) == 1 and gens[0]["steps"] == list(range(1, ELASTIC_STEPS + 1)),
           f"runner -> launch -> worker, {ELASTIC_STEPS} steps uninterrupted (the drills' reference), rc 0",
           f"rc {proc.returncode} in {wall:.2f} s, losses {[round(x, 4) for x in gens[0]['losses']] if gens else None}")
    g = gens[0]
    env = g["env"]
    want = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
            "DSTPU_COORDINATOR": "127.0.0.1:29500", "DSTPU_NUM_PROCESSES": "1", "DSTPU_PROCESS_ID": "0"}
    from deepspeed_tpu_torch.launcher.runner import decode_world_info

    _check({k: env[k] for k in want} == want and decode_world_info(env["DSTPU_WORLD_INFO"]) == {"localhost": [0]}
           and g["device"].startswith(device),
           "the worker's rendezvous env and device", f"{ {k: env[k] for k in want} } on {g['device']}")
    flash, xent, sparse, per_batch = _check_step_launches(gens, cfg, cuda)
    want_batch = [64, 16, 4] if model == "gpt2" else [8, 4, 2]
    _check(g["built"] == [] and g["batch"] == want_batch,
           "the worker reused phase 2's kernels and took the elastic batch",
           f"built {g['built']}, batch/micro/gas {g['batch']}, launches a train_batch {per_batch}")

    # a second launch, SIGTERMed mid-step: the launch forwards it to the worker's group.
    # The tree's pids are checked in /proc; what it held on the card is checked by the
    # card's free memory (nvidia-smi's compute-app pids are the host's, not this
    # container's, so they cannot be matched with the tree)
    term_path = os.path.join(root, "term.jsonl")
    free_before = _card_free(cuda)
    proc = subprocess.Popen(runner + _worker_cmd(model, device, "--steps", 100000, "--out", term_path)[1:],
                            cwd=here, start_new_session=True)
    deadline = time.monotonic() + 600
    steps = []
    while not steps:
        if time.monotonic() > deadline or proc.poll() is not None:
            os.killpg(proc.pid, signal.SIGKILL)
            _check(False, "the SIGTERM drill's worker reached a step")
        time.sleep(0.05)
        steps = [e for e in _read_events(term_path) if e["event"] == "step"]
    time.sleep(0.05)  # inside the next step
    tree = [proc.pid, steps[0]["ppid"], steps[0]["pid"]]  # runner, launch, worker
    free_during = _card_free(cuda)
    t_sig = time.perf_counter()
    os.killpg(proc.pid, signal.SIGTERM)
    proc.wait(timeout=TREE_GONE_BOUND_S)
    while any(_alive(p) for p in tree) and time.perf_counter() - t_sig < TREE_GONE_BOUND_S:
        time.sleep(0.02)
    gone_s = time.perf_counter() - t_sig
    left = [p for p in tree if _alive(p)]
    # a dead process's device memory is released asynchronously: wait for it within the bound
    while _card_free(cuda) < free_before - CARD_FREE_SLACK and time.perf_counter() - t_sig < TREE_GONE_BOUND_S:
        time.sleep(0.02)
    free_s, free_after = time.perf_counter() - t_sig, _card_free(cuda)
    mib = 2 ** 20
    _check(not left and (not cuda or (free_during < free_before - CARD_FREE_SLACK
                                      and free_after >= free_before - CARD_FREE_SLACK)),
           f"SIGTERM to the launch mid-step: the tree gone and the card's memory back within "
           f"{TREE_GONE_BOUND_S:.0f} s", f"runner/launch/worker {tree} gone from /proc in {gone_s:.3f} s; card free "
           f"{free_before / mib:.0f} MiB before the launch, {free_during / mib:.0f} MiB mid-step, "
           f"{free_after / mib:.0f} MiB {free_s:.3f} s after SIGTERM")
    return {"rc": 0, "wall_s": wall, "boot_s": g["boot_s"], "env": {k: env[k] for k in want}, "gen": g,
            "launches_per_train_batch": per_batch, "losses": g["losses"], "sigterm_tree_gone_s": gone_s,
            "sigterm_step_reached": len(steps), "sigterm_card_free_s": free_s,
            "card_free_mib": {"before": free_before / mib, "mid_step": free_during / mib, "after": free_after / mib}
            }, flash, xent, sparse


def _agent(ds, cmd, hostfile, hb, timeout, grace=600.0):
    from deepspeed_tpu_torch.elasticity import DSElasticAgent, WorkerSpec

    return DSElasticAgent(ds, WorkerSpec(command=cmd), hostfile=hostfile, monitor_interval=0.1, max_restarts=2,
                          heartbeat_file=hb, heartbeat_timeout=timeout, heartbeat_grace=grace,
                          restart_backoff=RESTART_BACKOFF)


def _elastic_drills(root, hostfile, model, device, cfg, ds, cuda, straight):
    """(b) crash drill and (c) hang drill, each against the uninterrupted
    run ``straight`` (the launch stack's generation record)."""
    ref = dict(zip(straight["steps"], straight["losses"]))
    gens_all = []
    n, c = ELASTIC_STEPS, CRASH_AFTER

    # (b) crash: generation 0 trains CRASH_AFTER steps (saving after every
    # other one) and SIGKILLs itself
    crash_path, crash_ckpt, hb = (os.path.join(root, n) for n in ("crash.jsonl", "crash_ckpt", "crash_hb"))
    agent = _agent(ds, _worker_cmd(model, device, "--steps", n, "--save-dir", crash_ckpt, "--crash-after", c,
                                          "--out", crash_path), hostfile, hb, timeout=300.0)
    t0 = time.perf_counter()
    rc = agent.run()
    crash_s = time.perf_counter() - t0
    gens = _generations(crash_path)
    gens_all += gens
    got = {s: x for g in gens for s, x in zip(g["steps"], g["losses"])}
    later = list(range(c + 1, n + 1))
    ok = (rc == 0 and agent.restart_count == 1 and [g["steps"] for g in gens] == [list(range(1, c + 1)), later]
          and gens[1]["resumed_from"] == f"global_step{c}" and all(got[s] == ref[s] for s in range(1, n + 1)))
    _check(ok, f"crash drill: SIGKILL after step {c} (saved), the agent relaunches, generation 1 resumes to "
               f"step {n}",
           f"rc {rc}, restart_count {agent.restart_count}, steps {[g['steps'] for g in gens]}, steps {c + 1}-{n} "
           f"losses {[got.get(s) for s in later]} vs uninterrupted {[ref[s] for s in later]} (bitwise), "
           f"{crash_s:.2f} s")
    steps = [e for e in _read_events(crash_path) if e["event"] == "step"]
    touches = gens[0]["touches"]
    gap = max(b - a for a, b in zip(touches, touches[1:]))
    relaunch_boot = gens[1]["first_step_start"] - agent.generations[1]["launched_at"]
    crash = {"rc": rc, "restart_count": agent.restart_count, "seconds": crash_s,
             "losses": [got[s] for s in range(1, n + 1)],
             "step_s": [e["step_s"] for e in steps], "save_s": [e["save_s"] for e in steps],
             "max_touch_gap_s": gap, "relaunch_boot_to_first_step_s": relaunch_boot,
             "relaunch_boot_s": gens[1]["boot_s"]}

    # (c) hang: generation 0 stops touching the heartbeat after step
    # HANG_AFTER (saved)
    timeout = max(5.0, 3.0 * gap)
    hang_path, hang_ckpt, hb = (os.path.join(root, n) for n in ("hang.jsonl", "hang_ckpt", "hang_hb"))
    agent = _agent(ds, _worker_cmd(model, device, "--steps", 2 * HANG_AFTER, "--save-dir", hang_ckpt,
                                          "--hang-after", HANG_AFTER, "--out", hang_path), hostfile, hb,
                   timeout=timeout)
    t0 = time.perf_counter()
    rc = agent.run()
    hang_s = time.perf_counter() - t0
    gens = _generations(hang_path)
    gens_all += gens
    got = {s: x for g in gens for s, x in zip(g["steps"], g["losses"])}
    kills = [g["killed_at"] for g in agent.generations if g["killed_at"] is not None]
    ok = (rc == 0 and agent.restart_count == 1 and len(kills) == 1 and agent.generations[0]["killed_at"] is not None
          and [g["steps"] for g in gens] == [[1, 2], [3, 4]] and all(got[s] == ref[s] for s in range(1, 5)))
    touch_to_kill = kills[0] - gens[0]["touches"][-1] if ok else float("nan")
    relaunch_boot_hang = gens[1]["first_step_start"] - agent.generations[1]["launched_at"] if ok else float("nan")
    _check(ok, f"hang drill: heartbeat timeout {timeout:.2f} s (3 x the longest gap between touches, at least 5 s), "
               "grace 600 s; the hung worker SIGKILLed and relaunched, generation 1 resumes to step 4",
           f"rc {rc}, restart_count {agent.restart_count}, kills {len(kills)}, steps {[g['steps'] for g in gens]}, "
           f"steps 3-4 losses {[got.get(s) for s in (3, 4)]} vs uninterrupted {[ref[s] for s in (3, 4)]} (bitwise); "
           f"last touch -> kill {touch_to_kill:.3f} s; relaunch boot -> first step {relaunch_boot_hang:.2f} s; "
           f"{hang_s:.2f} s")
    hang = {"rc": rc, "restart_count": agent.restart_count, "seconds": hang_s, "heartbeat_timeout_s": timeout,
            "last_touch_to_kill_s": touch_to_kill, "relaunch_boot_to_first_step_s": relaunch_boot_hang,
            "relaunch_boot_s": gens[1]["boot_s"], "losses": [got[s] for s in range(1, 5)],
            "first_touch_after_relaunch_s": gens[1]["touches"][0] - agent.generations[1]["launched_at"]}
    return {"straight_losses": straight["losses"], "straight_boot_s": straight["boot_s"], "crash": crash,
            "hang": hang}, gens_all


def _chaos_engines(engine, built):
    """The ChaosRunner's factory: fresh ServingEngine replicas over one set of
    weights, each with the schedule's fault injection (so garbage logits fire
    in the replica's decode)."""
    from deepspeed_tpu_torch.inference import ServingEngine

    def engines(wl, fi):
        reps = [ServingEngine(engine, config={"n_slots": int(wl["n_slots"]), "seed": 0, "watchdog_mode": "raise",
                                              "replica_id": i, **({"fault_injection": fi} if fi else {})})
                for i in range(int(wl["n_replicas"]))]
        built.append(reps)
        return reps

    return engines


def _replica_launches(reps, L):
    """(split, combine, replays) over one run's replicas, each checked: the
    capture's L + L a replay times its replays."""
    split = combine = replays = 0
    for r in reps:
        w = r.worker
        s, c = w.decode_kernel_launches()
        if w.graph_replays and w.graph_launches != (L, L):
            _check(False, "decode launches a replay", f"replica {r.replica_id}: {w.graph_launches} (expect {L}, {L})")
        split, combine, replays = split + s, combine + c, replays + w.graph_replays
    return split, combine, replays


def _chaos(dev, smi, cfg_model):
    from deepspeed_tpu_torch.resilience import chaos

    cuda = dev.type == "cuda"
    L = cfg_model.num_layers if cuda else 0
    engine = deepspeed_tpu_torch.init_inference(Model(cfg_model), config={"dtype": "bf16" if cuda else "fp32"},
                                                device=dev)
    built = []
    runner = chaos.ChaosRunner(engines=_chaos_engines(engine, built))
    wl = dict(chaos.DEFAULT_WORKLOAD)
    t0 = time.perf_counter()
    ref = runner.reference(wl)
    ref_s = time.perf_counter() - t0
    _check(all(r.status == "ok" for r in ref.values()) and len(ref) == wl["n_requests"],
           f"the unfaulted reference over {wl['n_replicas']} real replicas", f"{len(ref)} ok in {ref_s:.2f} s")
    rows, mem, launches = [], [], [0, 0, 0]
    for i in range(CHAOS_SCHEDULES):
        sched = chaos.FaultSchedule.generate(chaos.derive_seed(CHAOS_SEED, i), wl)
        outs = []
        for _ in range(2):
            n_built = len(built)
            t0 = time.perf_counter()
            outs.append(runner.run(sched, reference=ref))
            seconds = time.perf_counter() - t0
            for reps in built[n_built:]:
                launches = [a + b for a, b in zip(launches, _replica_launches(reps, L))]
            if cuda:
                torch.cuda.synchronize()
                mem.append((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()))
        a, b = outs
        rows.append({"schedule": i, "entries": [e.as_dict() for e in sched.entries], "digest": a.digest,
                     "fired": dict(a.fired), "statuses": a.summary()["statuses"], "crashes": a.crashes,
                     "restarts": a.restarts, "steps": a.steps, "seconds": seconds})
        ok = not a.violations and not b.violations and a.digest == b.digest
        _check(ok, f"schedule {i} {[(e.site, e.key, e.at) for e in sched.entries]}: green twice, one digest",
               f"fired {dict(a.fired)}, statuses {a.summary()['statuses']}, digest {a.digest[:12]} / "
               f"{b.digest[:12]}, violations {[str(v) for v in a.violations + b.violations]}, {seconds:.2f} s")
    split, combine, replays = launches
    _check(split == combine == L * replays and (replays > 0 or not cuda),
           "decode launches over every replica's replays", f"{split} split + {combine} combine for {replays} "
           f"replays ({L} + {L} a replay)")
    counters = runner.telemetry.registry.snapshot()["counters"]
    sites = sorted({k.split("/")[2] for k in counters if k.startswith("chaos/site/")})
    per_site = {s: {"fired": counters.get(f"chaos/site/{s}/fired", 0),
                    "survived": counters.get(f"chaos/site/{s}/survived", 0)} for s in sites}
    per_schedule = [r["seconds"] for r in rows]
    if cuda:
        grown = mem[-1][0] - mem[0][0]
        _check(grown <= CHAOS_MEMORY_SLACK, "device memory after the last schedule beside the first",
               f"allocated {mem[0][0] / 2**20:.1f} -> {mem[-1][0] / 2**20:.1f} MiB, reserved "
               f"{mem[0][1] / 2**20:.1f} -> {mem[-1][1] / 2**20:.1f} MiB over {len(mem)} runs")
    print(f"    [{smi}] {CHAOS_SCHEDULES} schedules x 2 over {wl['n_replicas']} real replicas: "
          f"{statistics.median(per_schedule):.2f} s a run (median; {min(per_schedule):.2f}-{max(per_schedule):.2f}); "
          f"fired/survived by site {per_site}")
    del engine
    built.clear()

    # the fake fleet's search with a planted oracle, shrunk and replayed
    def planted(out):
        n = out.fired.get(CHAOS_PLANTED_SITE, 0)
        return [chaos.Violation("planted_tripwire", f"{CHAOS_PLANTED_SITE} fired {n}x")] if n else []

    with tempfile.TemporaryDirectory(prefix="dstt_chaos_") as art:
        t0 = time.perf_counter()
        fake = chaos.ChaosRunner()
        row = chaos.search(fake, CHAOS_SEARCH, CHAOS_SEED, artifact_dir=art, oracles=[planted])
        search_s = time.perf_counter() - t0
        _check(bool(row["violations"]), f"a {CHAOS_SEARCH}-schedule fake-fleet search trips the planted oracle",
               f"{len(row['violations'])} schedules tripped, sites covered {row['sites_covered']}, {search_s:.2f} s")
        v = row["violations"][0]
        with open(v["repro"], "rb") as f:
            written = f.read()
        repro = json.loads(written)
        mini = chaos.FaultSchedule.from_dict(repro["schedule"])
        fake_ref = fake.reference(mini.workload)

        def trips(cand):
            return "planted_tripwire" in {x.invariant for x in fake.run(cand, reference=fake_ref,
                                                                        oracles=[planted]).violations}

        minimal = trips(mini) and all(not trips(mini.subset(j for j in range(len(mini.entries)) if j != k))
                                      for k in range(len(mini.entries)))
        rep = chaos.replay_repro(chaos.ChaosRunner(), repro, oracles=[planted])
        again = os.path.join(art, "again.json")
        chaos.write_repro(again, mini, rep["outcome"], search_seed=CHAOS_SEED, index=v["schedule_index"])
        with open(again, "rb") as f:
            rewritten = f.read()
        _check(minimal and rep["digest_match"] and rep["violations_match"] and rewritten == written,
               "shrunk to a minimal reproducer; replay_repro reproduces it bit-identically",
               f"schedule {v['schedule_index']}: {v['entries']} -> {v['minimal_entries']} entries "
               f"{[(e.site, e.key, e.at) for e in mini.entries]}, digest {rep['digest'][:12]}, rewritten file "
               f"{'identical' if rewritten == written else 'differs'}")
    return {"workload": wl, "schedules": rows, "reference_s": ref_s, "seconds_per_run_median":
            statistics.median(per_schedule), "per_site": per_site,
            "decode_launches": {"split": split, "combine": combine, "replays": replays},
            "memory_first_last": [mem[0], mem[-1]] if mem else None,
            "search": {"schedules": CHAOS_SEARCH, "seed": CHAOS_SEED, "planted_site": CHAOS_PLANTED_SITE,
                       "tripped": len(row["violations"]), "first": {k: v[k] for k in ("schedule_index", "entries",
                                                                                      "minimal_entries")},
                       "seconds": search_s, "replay_digest_match": rep["digest_match"]}}, split, combine


def elastic_chaos_phase(dev, smi, model=None):
    """Phase 23: (a) the launch stack, (b)/(c) the elastic agent's crash and
    hang drills, (d) chaos schedules over real replicas and a fake-fleet
    search. ``model="tiny"`` rehearses the control flow on the CPU."""
    cuda = dev.type == "cuda"
    model = model or "gpt2"
    cfg, ds = elastic_model(model)
    device = "cuda" if cuda else "cpu"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()  # the workers share the card with this process
    with tempfile.TemporaryDirectory(prefix="dstt_elastic_") as root:
        hostfile = os.path.join(root, "hostfile")
        with open(hostfile, "w") as f:
            f.write("localhost slots=1\n")
        print("  (a) the launch stack: python -m deepspeed_tpu_torch.launcher.runner --hostfile <localhost slots=1>")
        launch, flash_a, xent_a, sparse_a = _launch_stack(root, hostfile, model, device, cfg, cuda)
        print("  (b)/(c) DSElasticAgent over that hostfile: the crash drill and the hang drill")
        drills, gens = _elastic_drills(root, hostfile, model, device, cfg, ds, cuda, launch.pop("gen"))
    flash_b, xent_b, sparse_b, _ = _check_step_launches(gens, cfg, cuda)
    _check(all(g["built"] == [] and g["device"].startswith(device) for g in gens),
           "every generation on the intended device, loading the built kernels (no worker compiled a source)",
           f"{len(gens)} generations on {sorted({g['device'] for g in gens})}")
    elastic = {"launch": launch, **drills, "config": {"elasticity": ds["elasticity"], "model": model},
               "flash_launches": [a + b for a, b in zip(flash_a, flash_b)],
               "xent_launches": [a + b for a, b in zip(xent_a, xent_b)],
               "sparse_launches": [a + b for a, b in zip(sparse_a, sparse_b)]}
    print(f"  [{smi}] workers' kernel launches (flash fwd, dK/dV, dQ) {elastic['flash_launches']}, fused loss (fwd, "
          f"combine, ds, dW, dH) {elastic['xent_launches']}, sparse (fwd, dQ, dK/dV) {elastic['sparse_launches']}")
    print(json.dumps({"elastic": elastic}))
    print("  (d) chaos: ChaosRunner over real ServingEngine replicas, then a fake-fleet search with a planted oracle")
    chaos_cfg = TransformerConfig(**GPT2_SPEC) if cuda else TransformerConfig(
        **{k: v for k, v in ELASTIC_TINY.items() if k not in ("attn_impl", "loss_impl")})
    chaos_out, split, combine = _chaos(dev, smi, chaos_cfg)
    chaos_out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"chaos": chaos_out}))
    print(f"  phase 23: {chaos_out['phase_s']:.1f} s")
    return {"flash": elastic["flash_launches"], "xent": elastic["xent_launches"],
            "sparse": elastic["sparse_launches"], "decode": (split, combine),
            "seconds": chaos_out["phase_s"]}



# ---------------------------------------------------------------------------
# Phase 24: the memory tiers
# ---------------------------------------------------------------------------

# cpu-tier losses against the unoffloaded run's: the CPU parity test's
# tolerance (tests/test_torch_offload.py, JAX's own rtol 2e-2)
TIER_LOSS_RTOL = 2e-2
TIER_STEPS = 2  # timed steps after one warm-up (3 before phase 29); the warm-up's and their losses are compared
# GPT-3 6.7B (Brown et al. 2020, Table 2.1): 32 layers, d_model 4096, 32
# heads of 128, 2048 positions; vocab 50304 (bench.py's padding)
GPT3_67B = dict(vocab_size=50304, max_seq_len=2048, num_layers=32, num_heads=32, hidden_size=4096,
                pos_emb="learned", tie_embeddings=True, dtype=torch.bfloat16, attn_impl="flash",
                loss_impl="fused_xent")
HOST_MARGIN = 4 << 30  # host bytes left to the process and the system beside a tier's buffers


def tier_ds(off_opt="none", off_param="none", nvme_path="", base=None, **over):
    ds = json.loads(json.dumps(base or BENCH_DS))
    z = ds["zero_optimization"]
    if off_opt != "none":
        z["offload_optimizer"] = {"device": off_opt, "nvme_path": nvme_path}
    if off_param != "none":
        z["offload_param"] = {"device": off_param, "nvme_path": nvme_path}
    ds.update(over)
    return ds


def mem_available() -> int:
    """The host's MemAvailable in bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def tier_run(label, model_cfg, ds, params, batch, steps=TIER_STEPS):
    """initialize -> one warm-up and ``steps`` timed train_batch calls ->
    (result, engine). Peak memory over the timed steps; each step's flash
    launches; the streamer's and the cpu tier's copy bytes per step."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.initialize(model=Model(model_cfg), config=ds,
                                            model_parameters=tree_map(torch.clone, params))[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, per_step = [], []
    t0 = time.perf_counter()
    losses.append(float(engine.train_batch(batch)["loss"]))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tier = engine.tier
    bytes0 = copy_bytes(engine)
    t0 = time.perf_counter()
    for _ in range(steps):
        before = counts()
        losses.append(float(engine.train_batch(batch)["loss"]))
        per_step.append([a - b for a, b in zip(counts(), before)])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    h2d, d2h = [(b - a) / steps for a, b in zip(bytes0, copy_bytes(engine))]
    res = {"init_s": init_s, "warmup_s": warm_s, "step_ms": step_s * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
           "launches_per_train_batch": per_step[0], "h2d_bytes_per_step": h2d, "d2h_bytes_per_step": d2h,
           "host_update_s": tier.stats["update_s"] if tier is not None else None,
           "host_buffers_gib": tier.stats["pinned_bytes"] / 2**30 if tier is not None else None}
    print(f"  {label}: init {init_s:.2f} s, warm-up {warm_s:.2f} s, {res['step_ms']:.1f} ms/step, peak "
          f"{res['peak_gib']:.2f} GiB, losses {[round(x, 4) for x in losses]}, launches per train_batch "
          f"{COUNT_LABEL_9} {per_step[0]}" + (f", host update {res['host_update_s']:.3f} s, H2D {h2d / 1e6:.1f} MB "
                                              f"and D2H {d2h / 1e6:.1f} MB a step" if tier is not None else ""))
    return res, engine


def copy_bytes(engine):
    """(host-to-device, device-to-host) bytes the tier has copied so far."""
    tier = engine.tier
    if tier is None:
        return 0, 0
    h2d, d2h = tier.stats["h2d_bytes"], tier.stats["d2h_bytes"]
    if tier.streamer is not None:
        h2d, d2h = h2d + tier.streamer.h2d_bytes, d2h + tier.streamer.d2h_bytes
    return h2d, d2h


def _tier_fail(what):
    raise SystemExit(f"phase 24: {what}")


def memory_tiers_phase(dev, smi, big_layers=None):
    """Phase 24: (a) the cpu tier against no offload at phase 7's
    configuration, (b) offload_param cpu, (c) the NVMe tier with save ->
    load -> step bitwise, (d) one step of GPT-3 6.7B widths whose 16P
    bytes of state exceed the card's free memory. Returns its record; every
    failed check exits non-zero."""
    from deepspeed_tpu_torch.runtime.zero import count_params, estimate_zero1_model_states_mem_needs

    out = {"card": smi}
    cfg = gpt2_config()
    P = count_params(Model(cfg))
    L, gas = cfg.num_layers, BENCH_DS["gradient_accumulation_steps"]
    params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(24), dev)
    B = BENCH_DS["train_batch_size"]
    batch = {"tokens": np.random.default_rng(24).integers(0, cfg.vocab_size, size=(B, cfg.max_seq_len + 1)
                                                          ).astype(np.int32)}
    expect = [L * gas] * 3 + [0] * (N_COUNTS - 3)

    # (a) the cpu tier against no offload
    print(f"  (a) GPT-2-125M ({P} params), phase 7's configuration, offload_optimizer none vs cpu; {smi}")
    plain, eng = tier_run("no offload", cfg, tier_ds(), params, batch)
    del eng
    cpu, eng = tier_run("offload_optimizer cpu", cfg, tier_ds("cpu"), params, batch)
    pinned = all(t.is_pinned() for t in tree_leaves(eng.state["master"]) + tree_leaves(eng.state["opt"]))
    del eng
    est_plain = estimate_zero1_model_states_mem_needs(P)
    est_cpu = estimate_zero1_model_states_mem_needs(P, offload_optimizer=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(cpu["losses"][:3], plain["losses"][:3]))
    ok = (rel <= TIER_LOSS_RTOL and pinned and all(np.isfinite(cpu["losses"]))
          and cpu["launches_per_train_batch"] == expect and plain["launches_per_train_batch"] == expect)
    out["a"] = {"params": P, "plain": plain, "cpu": cpu, "loss_max_rel_err": rel, "loss_rtol": TIER_LOSS_RTOL,
                "estimate_hbm_gib": {"plain": est_plain.per_chip_hbm / 2**30, "cpu": est_cpu.per_chip_hbm / 2**30},
                "estimate_dram_gib": {"plain": est_plain.per_host_dram / 2**30, "cpu": est_cpu.per_host_dram / 2**30}}
    print(f"  (a) estimator: HBM {est_plain.per_chip_hbm / 2**30:.2f} -> {est_cpu.per_chip_hbm / 2**30:.2f} GiB, "
          f"host DRAM 0 -> {est_cpu.per_host_dram / 2**30:.2f} GiB (model states only); measured peak "
          f"{plain['peak_gib']:.2f} -> {cpu['peak_gib']:.2f} GiB; step {plain['step_ms']:.1f} -> "
          f"{cpu['step_ms']:.1f} ms; losses max rel err {rel:.2e} (tol {TIER_LOSS_RTOL}); master and moments "
          f"pinned {pinned}; {L} x {gas} = {L * gas} launches of each flash kernel a train_batch  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _tier_fail("the cpu tier disagrees with the unoffloaded run")

    # (b) offload_param: the parameters stream from host memory a layer at a time
    param, eng = tier_run("offload_param cpu", cfg, tier_ds("cpu", "cpu"), params, batch)
    del eng
    # reckoned per step: each micro-batch streams the bf16 parameters in for
    # the forward (2P bytes) and the layers' again for the backward (2P_L;
    # the top-level leaves stay for it), sends its fp32 gradients out (4P)
    # and, after the first, reads the running sum back in (4P)
    P_L = sum(t.numel() for t in tree_leaves(params["layers"]))
    e = torch.empty((), dtype=cfg.dtype).element_size()  # 2: bf16
    reckon_h2d, reckon_d2h = gas * (e * P + e * P_L) + (gas - 1) * 4 * P, gas * 4 * P
    rel_b = max(abs(a - b) / abs(b) for a, b in zip(param["losses"][:3], cpu["losses"][:3]))
    ok = (rel_b <= TIER_LOSS_RTOL and param["launches_per_train_batch"] == expect
          and abs(param["h2d_bytes_per_step"] - reckon_h2d) <= 0.01 * reckon_h2d
          and abs(param["d2h_bytes_per_step"] - reckon_d2h) <= 0.01 * reckon_d2h)
    out["b"] = {**param, "loss_max_rel_err_vs_cpu": rel_b, "reckoned_h2d_bytes": reckon_h2d,
                "reckoned_d2h_bytes": reckon_d2h, "2P": 2 * P, "4P": 4 * P, "2P_layers": 2 * P_L}
    print(f"  (b) H2D {param['h2d_bytes_per_step']:.0f} bytes a step against the reckoned "
          f"{reckon_h2d} (= {gas} x (2P + 2P_L) + {gas - 1} x 4P; 2P = {e * P}, the layers' 2P_L = {e * P_L}); "
          f"D2H {param['d2h_bytes_per_step']:.0f} against {reckon_d2h} (= {gas} x 4P); peak "
          f"{param['peak_gib']:.2f} GiB against the cpu tier's {cpu['peak_gib']:.2f}; losses vs the cpu tier max rel "
          f"err {rel_b:.2e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        _tier_fail("offload_param's step or its copies are off")

    # (c) the NVMe tier, then save -> load -> one step bitwise
    root = tempfile.mkdtemp(prefix="dstt-tiers-")
    try:
        out["c"] = nvme_drill(cfg, params, batch, root, expect, gas, P)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params
    torch.cuda.empty_cache()

    # (d) a model the card cannot hold
    out["d"] = big_model_step(dev, smi, big_layers)
    return out


# the NVMe tier's I/O settings for phase 24: 8 aio threads (the host's
# cores; the aio block's default is 1) and groups of 1e8 bytes of master,
# so a step reads one group ahead and writes one behind
NVME_AIO = {"thread_count": 8}
NVME_SUB_GROUP = 100_000_000


def nvme_drill(cfg, params, batch, root, expect, gas, P):
    swap, ckpt = os.path.join(root, "swap"), os.path.join(root, "ckpt")
    ds = tier_ds("nvme", "nvme", swap, aio=NVME_AIO)
    ds["zero_optimization"]["sub_group_size"] = NVME_SUB_GROUP
    res, eng = tier_run("offload_optimizer + offload_param nvme", cfg, ds, params, batch)
    sw = eng.tier.nvme.swapper
    read0, written0 = sw.bytes_read, sw.bytes_written
    t0 = time.perf_counter()
    eng.train_batch(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    upd = eng.tier.stats["update_s"]
    rd, wr = sw.bytes_read - read0, sw.bytes_written - written0
    res.update(step_read_bytes=rd, step_write_bytes=wr, host_update_s_measured=upd, groups=eng.tier.nvme.num_groups,
               read_gbps=rd / upd / 1e9, write_gbps=wr / upd / 1e9, aio_threads=eng.config.aio.thread_count)
    print(f"  (c) one more step {step_s:.2f} s: the tier read {rd / 1e9:.3f} GB and wrote {wr / 1e9:.3f} GB "
          f"(12P = {12 * P / 1e9:.3f} GB each way) in its {upd:.3f} s update: {res['read_gbps']:.2f} GB/s read, "
          f"{res['write_gbps']:.2f} GB/s written (the two overlap; {res['groups']} groups, {res['aio_threads']} aio "
          f"threads), under {swap}")
    eng.save_checkpoint(ckpt, tag="t")
    loss_a = float(eng.train_batch(batch)["loss"])
    after_a = {k: t.clone() for k, t in flatten(eng.state["params"])}
    eng.close()
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds, model_parameters=tree_map(torch.clone, params))[0]
    eng.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t0
    loss_b = float(eng.train_batch(batch)["loss"])
    after_b = dict(flatten(eng.state["params"]))
    bitwise = loss_a == loss_b and all(torch.equal(after_a[k], after_b[k]) for k in after_a)
    max_diff = max(float((after_a[k].float() - after_b[k].float()).abs().max()) for k in after_a)
    step_count = eng.tier.nvme.step_count
    eng.close()
    del eng
    ok = (bitwise and res["launches_per_train_batch"] == expect and np.isfinite(res["losses"]).all()
          and rd == 12 * P and wr == 12 * P)
    res.update(resume_bitwise=bitwise, resume_loss=loss_b, uninterrupted_loss=loss_a, engine_and_load_s=load_s,
               nvme_step_count=step_count, resume_param_max_abs_diff=max_diff, groups=res.get("groups"))
    print(f"  (c) save -> fresh engine + load ({load_s:.2f} s) -> one step: loss {loss_b:.6f} vs uninterrupted "
          f"{loss_a:.6f}, parameters bitwise {bitwise} (max abs diff {max_diff:.3g}); the tier's clock {step_count}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _tier_fail("the NVMe tier's step, its I/O or its resume is off")
    return res


def big_model_step(dev, smi, big_layers=None):
    """(d) GPT-3 6.7B widths: measure host memory and the disk first, take
    the cpu tier if host memory holds 12P and the tier's buffers, else the
    NVMe tier if the disk holds 12P, cutting depth only as far as both
    force; train one step."""
    from deepspeed_tpu_torch.runtime.zero import count_params, estimate_zero1_model_states_mem_needs
    from deepspeed_tpu_torch.runtime.zero.offload import CHUNK

    torch.cuda.empty_cache()
    free_hbm, total_hbm = torch.cuda.mem_get_info()
    avail = mem_available()
    nvme_root = tempfile.mkdtemp(prefix="dstt-nvme-")
    disk_free = shutil.disk_usage(nvme_root).free
    layers = big_layers or GPT3_67B["num_layers"]
    buffers = 2 * CHUNK * (4 + 2)

    def fits(n_layers):
        p = count_params(Model(TransformerConfig(**{**GPT3_67B, "num_layers": n_layers})))
        if avail >= 12 * p + buffers + HOST_MARGIN:
            return "cpu", p
        if disk_free >= 12 * p + HOST_MARGIN:
            return "nvme", p
        return None, p

    tier, P = fits(layers)
    while tier is None and layers > 1:
        layers -= 1
        tier, P = fits(layers)
    P32 = count_params(Model(TransformerConfig(**GPT3_67B)))
    rec = {"free_hbm_bytes": free_hbm, "total_hbm_bytes": total_hbm, "mem_available_bytes": avail,
           "nvme_path": nvme_root, "disk_free_bytes": disk_free, "params_32_layers": P32,
           "16P_32_layers": 16 * P32, "layers": layers, "params": P, "tier": tier}
    print(f"  (d) GPT-3 6.7B widths (Brown et al. 2020, Table 2.1; vocab 50304): {P32} params at 32 layers, 16P = "
          f"{16 * P32 / 1e9:.1f} GB against {free_hbm / 1e9:.1f} GB free of the card's {total_hbm / 1e9:.1f}; host "
          f"MemAvailable {avail / 1e9:.1f} GB, {disk_free / 1e9:.1f} GB free under {nvme_root}: tier {tier}, "
          f"{layers} layers ({P} params, 12P = {12 * P / 1e9:.1f} GB); {smi}")
    try:
        if tier is None:
            _tier_fail("neither host memory nor the disk holds one layer's optimizer state")
        cfg = TransformerConfig(**{**GPT3_67B, "num_layers": layers})
        ds = {"train_batch_size": 1, "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1.2e-4, "weight_decay": 0.1}},
              "zero_optimization": {"stage": 1, "offload_optimizer": {"device": tier, "nvme_path": nvme_root},
                                    "sub_group_size": NVME_SUB_GROUP * 10},
              "aio": NVME_AIO, "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 1000000}
        t0 = time.perf_counter()
        params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(67), dev)
        torch.cuda.synchronize()
        rec["init_params_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds, model_parameters=params)[0]
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec["engine_s"] = time.perf_counter() - t0
        rec["tier_host_buffers_gib"] = eng.tier.stats["pinned_bytes"] / 2**30
        rec["tier_alloc_s"] = eng.tier.stats["pin_s"]
        batch = {"tokens": np.random.default_rng(67).integers(0, cfg.vocab_size, size=(1, cfg.max_seq_len + 1)
                                                              ).astype(np.int32)}
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rec["step_s"] = time.perf_counter() - t0
        rec["launches_per_train_batch"] = [a - b for a, b in zip(counts(), before)]
        rec["host_update_s"] = eng.tier.stats["update_s"]
        rec["peak_hbm_gib"] = torch.cuda.max_memory_allocated() / 2**30
        est = estimate_zero1_model_states_mem_needs(P, offload_optimizer=True)
        rec["estimate_hbm_gib"], rec["estimate_dram_gib"] = est.per_chip_hbm / 2**30, est.per_host_dram / 2**30
        rec["loss"], rec["overflow"] = loss, bool(m["overflow"])
        eng.close()
        del eng, m
    finally:
        shutil.rmtree(nvme_root, ignore_errors=True)
    torch.cuda.empty_cache()
    ok = np.isfinite(loss) and not rec["overflow"] and 16 * P > free_hbm and rec["launches_per_train_batch"][:3] == [layers] * 3
    print(f"  (d) initialize {rec['engine_s']:.1f} s (host buffers {rec['tier_host_buffers_gib']:.1f} GiB in "
          f"{rec['tier_alloc_s']:.1f} s); one train_batch {rec['step_s']:.1f} s, of which the host update "
          f"{rec['host_update_s']:.1f} s; loss {loss:.4f}; peak HBM {rec['peak_hbm_gib']:.2f} GiB against the "
          f"estimator's {rec['estimate_hbm_gib']:.2f} GiB of model states (2P + 4P; activations excluded), host "
          f"{rec['estimate_dram_gib']:.1f} GiB; launches {COUNT_LABEL_9} {rec['launches_per_train_batch']}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _tier_fail("the step of the model the card cannot hold failed")
    return rec


# ---------------------------------------------------------------------------
# Phase 25: the program ledger, the flops profiler, the timers, the report
# CLI and env_report
# ---------------------------------------------------------------------------

PROFILE_TIMED_STEPS = 5
# the train step's ledger FLOPs against Model.flops_per_token x tokens: the
# counter counts the work done (the causal kernels' halved pairs, the
# chunked loss's logits twice, elementwise work), the formula 6 x the matmul
# parameters plus a dense attention term
LEDGER_FLOPS_BAND = (0.9, 1.25)


def ledger_training(model_kw, ledger, jsonl):
    """One engine of phase 25 (a)/(b): phase 7's configuration (or phase
    10's with ``model_kw``), the JAX package's default telemetry block with
    its JSONL sink and the ledger ``ledger``, wall_clock_breakdown,
    memory_breakdown and the flops profiler at step 2. Runs the first
    train_batch (timed), step 2 (the profile) and PROFILE_TIMED_STEPS timed
    steps -> {first_s, step_ms, per_step launches, snapshot, model}."""
    model = Model(gpt2_config(**model_kw))
    ds = {**BENCH_DS, "steps_per_print": 2 + PROFILE_TIMED_STEPS, "wall_clock_breakdown": True,
          "memory_breakdown": True, "flops_profiler": {"enabled": True, "profile_step": 2},
          "telemetry": {"enabled": True, "jsonl_path": jsonl, "ledger": {"enabled": ledger}}}
    engine = deepspeed_tpu_torch.initialize(model=model, config=ds)[0]
    B = BENCH_DS["train_batch_size"]
    batch = {"tokens": np.random.default_rng(0).integers(0, 50304, size=(B, FS + 1)).astype(np.int32)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    engine.train_batch(batch)  # step 2: the flops profiler's
    reset_counts()
    per_step = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_TIMED_STEPS):
        before = counts()
        m = engine.train_batch(batch)
        per_step.append([a - b for a, b in zip(counts(), before)])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PROFILE_TIMED_STEPS * 1e3
    if not np.isfinite(float(m["loss"])):
        raise SystemExit("phase 25: a training loss is not finite")
    snap = engine.telemetry_snapshot()
    engine.telemetry.close()
    del engine
    torch.cuda.empty_cache()
    return {"first_s": first_s, "step_ms": step_ms, "per_step": per_step, "snap": snap, "model": model}


def ledger_training_case(label, model_kw, tmp, expect_kernels):
    """Phase 25 (a)/(b): the configuration with the ledger off, on, then
    off again in this call (the two off runs show the call's noise) ->
    (the printed record, the ledger-on JSONL). The row must be rated with
    0 < mfu < 1, its FLOPs inside LEDGER_FLOPS_BAND of the model formula,
    its kernel rows' calls ``expect_kernels``, and the launches a step the
    same every way."""
    off = ledger_training(model_kw, False, os.path.join(tmp, f"{label}_off.jsonl"))
    on = ledger_training(model_kw, True, os.path.join(tmp, f"{label}_on.jsonl"))
    off2 = ledger_training(model_kw, False, os.path.join(tmp, f"{label}_off2.jsonl"))
    row = next(r for r in on["snap"]["program_ledger"] if r["name"] == "train/train_step")
    B = BENCH_DS["train_batch_size"]
    formula = on["model"].flops_per_token() * B * FS
    ratio = row["flops"] / formula
    kernels = {k: v["calls"] for k, v in row.get("kernels", {}).items()}
    rec = {"ledger_on_step_ms": on["step_ms"], "ledger_off_step_ms": [off["step_ms"], off2["step_ms"]],
           "first_train_batch_s_on": on["first_s"], "first_train_batch_s_off": [off["first_s"], off2["first_s"]],
           "launches_per_train_batch_on": on["per_step"][0], "launches_per_train_batch_off": off["per_step"][0],
           "flops_per_token_formula": on["model"].flops_per_token(), "ledger_over_formula": ratio,
           "gauges": {k: v for k, v in on["snap"]["metrics"]["gauges"].items() if k.startswith("train/")},
           "timers": {k: v for k, v in on["snap"]["metrics"]["histograms"].items() if k.startswith("timer/")},
           "row": {k: row.get(k) for k in ("flops", "matmul_flops", "bytes_accessed", "arith_intensity",
                                            "wall_p50_s", "achieved_tflops", "mfu", "roofline", "roof_tflops",
                                            "roof_fraction", "argument_bytes", "output_bytes", "temp_bytes",
                                            "compile_s", "ops")},
           "kernel_calls": kernels, "platform": on["snap"]["platform"]}
    r = rec["row"]
    print(f"  {label}: step ms ledger off / on / off {off['step_ms']:.1f} / {on['step_ms']:.1f} / "
          f"{off2['step_ms']:.1f} (on x{2 * on['step_ms'] / (off['step_ms'] + off2['step_ms']):.3f} of the offs' "
          f"mean); the first train_batch {off['first_s']:.2f} / {on['first_s']:.2f} / {off2['first_s']:.2f} s")
    print(f"    train/train_step on {rec['platform']['label']}: {r['flops'] / 1e12:.3f} TFLOP "
          f"({r['matmul_flops'] / 1e12:.3f} matmul-class), {r['bytes_accessed'] / 1e9:.2f} GB, intensity "
          f"{r['arith_intensity']:.1f} FLOP/B, wall p50 {r['wall_p50_s'] * 1e3:.1f} ms, achieved "
          f"{r['achieved_tflops']:.1f} TFLOP/s, mfu {r['mfu']:.4f}, {r['roofline']} (roof {r['roof_tflops']:.0f} "
          f"TFLOP/s); argument {r['argument_bytes'] / 2**30:.2f} GiB, output {r['output_bytes'] / 2**30:.3f} GiB, "
          f"temp {r['temp_bytes'] / 2**30:.2f} GiB; {r['ops']} ops and kernels counted in {r['compile_s']:.2f} s")
    print(f"    ledger FLOPs / (Model.flops_per_token x {B * FS} tokens = {formula / 1e12:.3f} TFLOP) = "
          f"{ratio:.4f} (band {LEDGER_FLOPS_BAND}); kernel calls in the row {kernels} (expect {expect_kernels}); "
          f"launches a train_batch {COUNT_LABEL_9} on {on['per_step'][0]}, off {off['per_step'][0]}")
    ok = (r["roofline"] in ("compute-bound", "hbm-bound") and r["mfu"] is not None and 0 < r["mfu"] < 1
          and LEDGER_FLOPS_BAND[0] <= ratio <= LEDGER_FLOPS_BAND[1] and kernels == expect_kernels
          and all(s == on["per_step"][0] for s in on["per_step"] + off["per_step"] + off2["per_step"])
          and rec["gauges"].get("train/mfu") == r["mfu"])
    print(f"    {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 25 {label}: the ledger's train_step row failed its checks")
    return rec, os.path.join(tmp, f"{label}_on.jsonl")


def ledger_serving(engine, ledger, jsonl, smi, label):
    """Phase 18's ServingEngine with the ledger ``ledger`` over workload (a)
    (run_workload checks 12 + 12 launches a replay and one decode program)."""
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    srv = ServingEngine(engine, config={**SERVE_CONFIG, "watchdog_mode": "raise", "jsonl_path": jsonl,
                                        "ledger": {"enabled": ledger}})
    srv.serve([Request(uid=100000 + i, prompt=np.arange(1, 20 + i, dtype=np.int32), max_new_tokens=4)
               for i in range(2)])
    _, m = run_workload(srv, shared_prefix_workload(engine.cfg.vocab_size), label, smi)
    snap = srv.telemetry_snapshot()
    out = {"metrics": m, "graph_launches": list(srv.worker.graph_launches), "snap": snap,
           "decode_compiles": snap["metrics"]["counters"].get("compile/serving/decode")}
    srv.telemetry.close()
    del srv
    torch.cuda.empty_cache()
    return out


def report_text(jsonl, *extra):
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.telemetry.report", jsonl, *extra],
                          capture_output=True, text=True, timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise SystemExit(f"phase 25 (d): the report CLI failed on {jsonl}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def kernel_call_timing(dev, reps=100, rounds=9):
    """What the kernels' cost hook (``telemetry.cost.kernel``) costs a call
    with no counter active: host µs per call of ``flash_attention``'s and
    ``fused_linear_xent``'s forward, back to back under ``no_grad`` with one
    synchronise at the end of each of ``rounds`` rounds (the median round),
    at a small shape (the host's cost shows) and at phase 7's
    per-micro-batch shape. Uses only what the parent commit has, so the same
    function times the parent's package (load this file by its path from
    the parent's checkout)."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, (B, S) in (("small", (1, 128)), ("phase7", (16, FS))):
        q, k, v = (torch.randn(B, S, 12, 64, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(3))
        N = B * S
        h = torch.randn(N, 768, generator=g, device=dev, dtype=torch.bfloat16)
        w = 0.02 * torch.randn(768, 50304 if label == "phase7" else 4096, generator=g, device=dev,
                               dtype=torch.bfloat16)
        labels = torch.randint(0, w.shape[1], (N,), generator=g, device=dev)
        for name, fn in (("flash_attention_fwd", lambda: fa.flash_attention(q, k, v)),
                         ("fused_linear_xent_fwd", lambda: fx.fused_linear_xent(h, w, labels))):
            with torch.no_grad():
                for _ in range(10):
                    fn()
                per_round = []
                for _ in range(rounds):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize(dev)
                    per_round.append((time.perf_counter() - t0) / reps * 1e6)
            out[f"{name}_{label}_us"] = statistics.median(per_round)
    return out


def hook_ns(dev, calls=200_000):
    """ns per ``with cost.kernel(...)`` around nothing, no counter active:
    the hook's own cost a kernel call."""
    from deepspeed_tpu_torch.telemetry import cost

    def costs():
        return {}

    t0 = time.perf_counter()
    for _ in range(calls):
        with cost.kernel(dev, costs):
            pass
    return (time.perf_counter() - t0) / calls * 1e9


def profiling_phase(dev, smi):
    """Phase 25 -> its record."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="dstt_p25_")
    try:
        L, gas = 12, BENCH_DS["gradient_accumulation_steps"]
        flash = {"flash_forward": L * gas, "flash_backward_dkdv": L * gas, "flash_backward_dq": L * gas}
        print(f"  (a) phase 7's configuration with the JAX package's default telemetry block, wall_clock_breakdown, "
              f"memory_breakdown and flops_profiler at step 2; ledger off, then on")
        out["a_chunked_loss"], jsonl_a = ledger_training_case("(a) chunked loss", {}, tmp, flash)
        xent = {"fused_xent_forward": gas, "xent_ds_pass": gas, "xent_dw_pass": gas, "xent_dh_pass": gas}
        print("  (b) phase 10's configuration (the fused loss under dots_and_flash remat), the same blocks")
        out["b_fused_loss"], _ = ledger_training_case("(b) fused loss", FUSED, tmp, {**flash, **xent})

        print("  (c) phase 18's serving engine on workload (a), ledger off, then on")
        cfg = TransformerConfig(vocab_size=50304, max_seq_len=1024, num_layers=12, num_heads=12,
                                hidden_size=768, pos_emb="learned", tie_embeddings=True)
        engine = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "bf16"})
        jsonl_c = os.path.join(tmp, "serving_on.jsonl")
        off = ledger_serving(engine, False, os.path.join(tmp, "serving_off.jsonl"), smi, "workload (a), ledger off")
        on = ledger_serving(engine, True, jsonl_c, smi, "workload (a), ledger on")
        del engine
        torch.cuda.empty_cache()
        row = next(r for r in on["snap"]["program_ledger"] if r["name"] == "serving/decode")
        gauge = on["snap"]["metrics"]["gauges"].get("serving/mfu")
        keep = ("flops", "bytes_accessed", "arith_intensity", "wall_p50_s", "wall_count", "achieved_tflops", "mfu",
                "roofline", "roof_fraction", "argument_bytes", "output_bytes", "temp_bytes", "kernels")
        rec = {"decode_row": {k: row.get(k) for k in keep}, "serving_mfu_gauge": gauge,
               "programs": [r["name"] for r in on["snap"]["program_ledger"]],
               "tokens_per_s_on": on["metrics"]["tokens_per_s"], "tokens_per_s_off": off["metrics"]["tokens_per_s"],
               "tpot_p50_ms_on": on["metrics"]["tpot_p50_ms"], "tpot_p50_ms_off": off["metrics"]["tpot_p50_ms"],
               "graph_launches_on": on["graph_launches"], "graph_launches_off": off["graph_launches"],
               "decode_compiles_on": on["decode_compiles"], "decode_compiles_off": off["decode_compiles"],
               "replay_launches_on": [on["metrics"]["split_launches"], on["metrics"]["combine_launches"]],
               "decode_steps_on": on["metrics"]["decode_steps"]}
        d = rec["decode_row"]
        print(f"    serving/decode: {d['flops'] / 1e9:.3f} GFLOP, {d['bytes_accessed'] / 1e6:.1f} MB a step, intensity "
              f"{d['arith_intensity']:.2f} FLOP/B, wall p50 {d['wall_p50_s'] * 1e3:.3f} ms over {d['wall_count']} "
              f"replays, {d['achieved_tflops']:.3f} TFLOP/s, mfu {d['mfu']:.5f}, {d['roofline']}; serving/mfu gauge "
              f"{gauge}; decode kernel rows {d['kernels']}")
        print(f"    tokens/s {off['metrics']['tokens_per_s']:.1f} off, {on['metrics']['tokens_per_s']:.1f} on; graph "
              f"launches a replay {off['graph_launches']} off, {on['graph_launches']} on; compile/serving/decode "
              f"{off['decode_compiles']} off, {on['decode_compiles']} on; programs in the ledger {rec['programs']}")
        ok = (d["roofline"] == "hbm-bound" and gauge is not None and gauge == d["mfu"] and 0 < gauge < 1
              and on["graph_launches"] == off["graph_launches"] == [L, L]
              and on["decode_compiles"] == off["decode_compiles"] == 1
              and d["kernels"] == {"decode_attention": {**d["kernels"]["decode_attention"], "calls": L}})
        print(f"    {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase 25 (c): the serving ledger failed its checks")
        out["c_serving"] = rec

        print("  (d) python -m deepspeed_tpu_torch.telemetry.report over (a)'s and (c)'s JSONL")
        texts = {"a": report_text(jsonl_a), "c": report_text(jsonl_c), "c_anatomy": report_text(jsonl_c, "--step-anatomy")}
        for key in ("a", "c"):
            lines = texts[key].splitlines()
            start = next(i for i, ln in enumerate(lines) if ln.startswith("program roofline"))
            section = lines[start:lines.index("", start)]
            hbm = next(i for i, ln in enumerate(lines) if ln.startswith("hbm memory ledger"))
            print("\n".join("    " + ln for ln in section + lines[hbm:hbm + 3]))
        rated = all("NVIDIA H100" in t and "unrated" not in t for t in (texts["a"], texts["c"]))
        print(f"    rated H100 rows, no 'unrated': {rated}  {'ok' if rated else 'FAIL'}")
        if not rated:
            raise SystemExit("phase 25 (d): the report's rows are not rated against the H100")
        out["d_report_rated"] = rated

        print("  (e) python -m deepspeed_tpu_torch.env_report")
        proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.env_report"], capture_output=True,
                              text=True, timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
        print("\n".join("    " + ln for ln in proc.stdout.splitlines()))
        built = proc.returncode == 0 and "NOT BUILT" not in proc.stdout and "H100" in proc.stdout
        print(f"    every kernel source built, the card named: {built}  {'ok' if built else 'FAIL'}")
        if not built:
            raise SystemExit(f"phase 25 (e): env_report failed (rc {proc.returncode}):\n{proc.stderr}")
        out["e_env_report_ok"] = built

        out["f_kernel_call_us"] = t = kernel_call_timing(dev)
        out["f_hook_ns"] = hook_ns(dev)
        print("  (f) host us a call, back to back, no counter active, the median of 9 rounds (the parent "
              "commit's are timed by the same function from its checkout): "
              + ", ".join(f"{k} {v:.1f}" for k, v in t.items())
              + f"; the cost hook alone {out['f_hook_ns']:.0f} ns a call")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 26: data parallelism (comm/, runtime/zero/)
# ---------------------------------------------------------------------------

DP_STEPS = 3  # timed steps after the warm-up (a), compared steps (b)
DP_SEED = 2600
# (b)'s losses against world 1's, relative: the same bf16 steps with the
# gradients summed in another order (read 3.65e-6 at ZeRO 1, 2.26e-6 at
# ZeRO 3 on an H100; one step moves the loss about 1e-3); so is the next
# loss of world 2's ZeRO-3 save resumed at world 1 (a world of 1's token
# mean against two ranks' means averaged), whose loaded state is held to
# the saved one bitwise. (a)'s stages are held bitwise: nothing in them
# changes an order.
DP_LOSS_RTOL = 1e-5
# (b)'s parameters: |world 2 - world 1| / |world 1 - initial| over every
# element, after the same 4 steps: read 3.30e-2 (ZeRO 1) and 3.28e-2
# (ZeRO 3) on an H100, Adam's steps on near-zero gradients that the other
# summation order flips; a world that skipped its update reads 1
DP_PARAM_GAP = 0.05
DP_WORLD2 = {"micro": 4, "gas": 4}  # (b): global batch 32 = 2 ranks x micro 4 x gas 4
DP_PROBE = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "all_to_all")


def dp_config(stage, train_batch, micro, gas, base=None):
    ds = dict(base or BENCH_DS)
    return {**ds, "train_batch_size": train_batch, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "zero_optimization": {"stage": stage},
            "comms_logger": {"enabled": True}}


def dp_batch(cfg, rows, step):
    """The global batch of ``step`` (every rank draws the same one)."""
    rng = np.random.default_rng(DP_SEED + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(rows, cfg.max_seq_len + 1)).astype(np.int32)}


def dp_params(cfg):
    """The phase's weights, from one seeded generator on the host."""
    return tfm.init(cfg, torch.Generator().manual_seed(DP_SEED))


def state_bytes(engine) -> dict:
    return {"params": sum(t.numel() * t.element_size() for t in tree_leaves(engine.state["params"])),
            "opt_state": sum(t.numel() * t.element_size() for t in tree_leaves(engine.state["opt"]))}


def comm_totals() -> dict:
    from deepspeed_tpu_torch.comm import comms_logger

    s = comms_logger.summary()
    return {"count": sum(v["count"] for k, v in s.items() if k != "by_axis"),
            "bytes": sum(v["bytes"] for k, v in s.items() if k != "by_axis"),
            "staged_bytes": comms_logger.staged_bytes,
            "ops": {k: v for k, v in s.items() if k != "by_axis"}}


def dp_steps(engine, cfg, steps, first_step=0, warm=True):
    """(warm-up s, ms a step, losses, per-step launches, comms a step, peak
    bytes): one warm-up call (step ``first_step``) when ``warm``, then
    ``steps`` calls on the phase's global batches, ending in a synchronise."""
    from deepspeed_tpu_torch.comm import comms_logger

    cuda = engine.device.type == "cuda"
    losses, warm_s = [], 0.0
    step = first_step
    if warm:
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(dp_batch(cfg, engine.train_batch_size, step))["loss"]))
        warm_s = time.perf_counter() - t0
        step += 1
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    comms_logger.reset()
    reset_counts()
    per_step, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = counts() + sparse_counts()
        metrics.append(engine.train_batch(dp_batch(cfg, engine.train_batch_size, step)))
        per_step.append([a - b for a, b in zip(counts() + sparse_counts(), before)])
        step += 1
    if cuda:
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    losses += [float(m["loss"]) for m in metrics]
    tot = comm_totals()
    per = {"count": tot["count"] / steps, "bytes": tot["bytes"] / steps, "staged_bytes": tot["staged_bytes"] / steps}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return warm_s, step_ms, losses, per_step, per, peak, tot["ops"]


def dp_reckoning(P, P_layers, stage, world, gas, elt):
    """The bytes a step's collectives should log (their operands), written
    before the first run in PERF.md. Stages 0-2 reduce P fp32 gradient
    elements (all-reduce; stage 2 at world > 1 reduce-scatter), and at
    world > 1 stages 1-2 all-gather each rank's P / world fp32 parameter
    shard. Stage 3 at world > 1, per micro-batch: each rank's ``elt``-byte
    (compute dtype) shard of every leaf gathered in the forward, of the
    layers (``P_layers``) again in the backward, and P fp32 gradient
    elements reduce-scattered; at world 1 nothing is split, so only the
    gradients are all-reduced, a layer at a time. Scalars (the loss, the
    norm) are left out."""
    if stage < 3:
        return 4 * P + (4 * P // world if stage in (1, 2) and world > 1 else 0)
    if world == 1:
        return gas * 4 * P
    return gas * (elt * P // world + elt * P_layers // world + 4 * P)


def dp_probe(device) -> dict:
    """Which gloo collectives take a tensor on ``device`` (run in every rank
    at once): each is called on a tensor there; a refused call is recorded
    by its error. comm/ does not try a collective and catch this: it hands
    gloo the collectives in GLOO_CUDA_NATIVE on CUDA tensors as they are,
    and this table checks that gloo takes each."""
    import torch.distributed as dist

    world = dist.get_world_size()
    out = {}
    x = torch.arange(4 * world, dtype=torch.float32, device=device)
    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "broadcast": lambda: dist.broadcast(x.clone(), src=0),
             "all_gather": lambda: dist.all_gather_into_tensor(torch.empty(4 * world * world, device=device), x),
             "reduce_scatter": lambda: dist.reduce_scatter_tensor(torch.empty(4, device=device), x),
             "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x), x)}
    for name in DP_PROBE:
        try:
            calls[name]()
            if device.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "native"
        except (RuntimeError, ValueError, NotImplementedError) as e:  # the probe's answer, not a route
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
    if device.type == "cuda":
        out["timing"] = dp_route_timing(device)
        from deepspeed_tpu_torch.comm.collectives import GLOO_CUDA_NATIVE

        wrong = {k: out[k] for k in GLOO_CUDA_NATIVE if out[k] != "native"}
        if wrong:
            raise SystemExit(f"phase 26: comm hands gloo CUDA tensors for collectives it refused: {wrong}")
    return out


DP_ROUTE_BYTES = 64 << 20


def dp_route_timing(device, reps=3) -> dict:
    """ms of one 64 MB fp32 all_reduce and all_gather on ``device`` tensors
    under gloo (every rank at once), handed to gloo as CUDA tensors and
    staged by hand through pinned host buffers, alternating the two."""
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.randn(DP_ROUTE_BYTES // 4, device=device)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out = torch.empty(world * x.numel(), device=device)
    host_out = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)

    def staged_reduce():
        host.copy_(x)
        dist.all_reduce(host)
        x.copy_(host)

    def staged_gather():
        host.copy_(x)
        dist.all_gather_into_tensor(host_out, host)
        out.copy_(host_out)

    calls = {"all_reduce": (lambda: dist.all_reduce(x), staged_reduce),
             "all_gather": (lambda: dist.all_gather_into_tensor(out, x), staged_gather)}
    res = {}
    for name, (native, staged) in calls.items():
        times = {"native": [], "staged": []}
        for _ in range(reps):
            for label, fn in (("native", native), ("staged", staged)):
                torch.cuda.synchronize(device)
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(device)
                times[label].append((time.perf_counter() - t0) * 1e3)
        res[name] = {k: statistics.median(v) for k, v in times.items()}
    return res


def leaf_digest(t) -> list:
    """An integer digest of an fp32 tensor: its int32 bit patterns summed,
    and summed weighted by position, in int64 on its device."""
    bits = t.detach().reshape(-1).view(torch.int32).long()
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return [int(bits.sum()), int((bits * w).sum())]


def gathered_state_digest(engine) -> list:
    """``leaf_digest`` of every whole fp32 leaf of the masters (gathered
    under ZeRO-3) and of the optimizer's params-shaped state (each leaf's
    shards gathered where the ZeRO runtime split it): what a checkpoint
    holds, in the tree's order. Collective under a ZeRO runtime."""
    from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import all_gather_rows

    leaves = tree_leaves(engine.full_params())
    for _, sub in sorted(engine.state["opt"].items()):
        if not isinstance(sub, dict):
            continue
        part = tree_leaves(sub)
        if engine.zero is not None:
            lays = tree_leaves(engine.zero.opt_layouts)
            idx = [i for i, lay in enumerate(lays) if lay.sharded]
            whole = all_gather_rows([part[i] for i in idx], [lays[i] for i in idx],
                                    engine.config.zero_optimization.allgather_bucket_size)
            for i, t in zip(idx, whole):
                part[i] = t
        leaves += part
    return [leaf_digest(t) for t in leaves if t.dtype == torch.float32]


def dp_worker(args) -> int:
    """``--dp-worker``: one rank of phase 26 (b). Joins the gloo world
    through ``--store`` (a FileStore), probes gloo on the device, runs
    stage 1 and stage 3 on the phase's global batches, saves the stage-3
    state after its third step into ``--save-dir`` and takes a fourth
    step; appends one JSON record to ``--out``."""
    from deepspeed_tpu_torch import comm

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    comm.init_distributed(init_method=f"file://{args.store}", world_size=world, rank=rank, backend="gloo",
                          timeout_s=300.0)
    if args.wait_for:  # booted beside phase 26 (a): go once it is done with the card
        deadline = time.monotonic() + 900
        while not os.path.exists(args.wait_for):
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 26: no {args.wait_for} within 900 s")
            time.sleep(0.1)
    cfg = gpt2_config() if args.model == "gpt2" else TransformerConfig(**DP_TINY)
    base = BENCH_DS if args.model == "gpt2" else DP_TINY_DS
    micro, gas = DP_WORLD2["micro"], DP_WORLD2["gas"]
    rec = {"rank": rank, "world": world, "device": str(dev),
           "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "probe": dp_probe(dev)}
    params = dp_params(cfg)
    for stage in (1, 3):
        engine = deepspeed_tpu_torch.initialize(
            model=Model(cfg), config=dp_config(stage, micro * gas * world, micro, gas, base),
            model_parameters=tree_map(lambda t: t.clone(), params), device=dev)[0]
        warm_s, step_ms, losses, per_step, per, peak, ops = dp_steps(engine, cfg, DP_STEPS, warm=True)
        full = [t.detach().float().cpu() for t in tree_leaves(engine.full_params())]  # collective at ZeRO 3
        if rank == 0:
            torch.save(full, dp_params_path(args.out, stage))
        entry = {"losses": losses, "step_ms": step_ms, "warmup_s": warm_s, "launches": per_step,
                 "comm_per_step": per, "comm_ops": ops, "state_bytes": state_bytes(engine), "peak_bytes": peak,
                 "held": engine.zero.fraction_held(),
                 "params_checksum": [float(sum(t.double().sum() for t in full)),
                                     float(sum((t.double() ** 2).sum() for t in full))]}
        del full
        if stage == 3:
            entry["saved_digest"] = gathered_state_digest(engine)  # collective: both ranks
            engine.save_checkpoint(args.save_dir, tag="world2_stage3")
            entry["next_loss"] = float(engine.train_batch(dp_batch(cfg, engine.train_batch_size,
                                                                   DP_STEPS + 1))["loss"])
        rec[f"stage{stage}"] = entry
        del engine
        gc.collect()  # the engine's telemetry holds a cycle through it
        if cuda:
            torch.cuda.empty_cache()
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    comm.destroy_distributed()
    return 0


DP_TINY = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64, dtype=torch.float32,
               attn_impl="flash", loss_chunk_size=16)
DP_TINY_DS = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0, "steps_per_print": 1000000}


def _dp_fail(what):
    raise SystemExit(f"phase 26: {what}")


def dp_params_path(rec_path, stage):
    """Where rank 0 of (b) leaves its fp32 parameters after the compared steps."""
    return os.path.join(os.path.dirname(rec_path), f"params_stage{stage}.pt")


def dp_param_gap(got, ref, init) -> tuple[float, float]:
    """(|got - ref| / |ref - init|, |ref - init|): Frobenius norms over
    every leaf, summed in fp64 on ``ref``'s device."""
    num = den = 0.0
    for g, r, i in zip(got, ref, init):
        r = r.double()
        num += float(((g.to(r.device, torch.float64) - r) ** 2).sum())
        den += float(((r - i.to(r.device, torch.float64)) ** 2).sum())
    return (num / den) ** 0.5, den ** 0.5


def dp_launches_ok(per_step, flash, cuda) -> bool:
    """Every step ``flash`` launches of each flash kernel and none of the
    others (the CPU runs the kernels' plain versions: none at all)."""
    want = ([flash] * 3 if cuda else [0] * 3) + [0] * (N_COUNTS - 3 + N_SPARSE)
    return all(s == want for s in per_step)


def data_parallel_phase(dev, smi, model="gpt2"):
    """Phase 26. (a) a world of 1 under NCCL (gloo on the CPU) through the
    real communicator: phase 7's configuration under ZeRO 0-3 from the same
    seeded weights; (b) a world of 2 under gloo, both ranks on ``dev``
    (``--dp-worker`` processes), against a world of 1 on the same global
    batches, and a world-2 stage-3 checkpoint resumed at world 1, stage 1."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comms_logger

    cuda = dev.type == "cuda"
    cfg = gpt2_config() if model == "gpt2" else TransformerConfig(**DP_TINY)
    base = BENCH_DS if model == "gpt2" else DP_TINY_DS
    micro, gas = (16, 4) if model == "gpt2" else (4, 2)
    L = cfg.num_layers
    params = dp_params(cfg)
    P = sum(t.numel() for t in tree_leaves(params))
    P_layers = sum(t.numel() for t in tree_leaves(params["layers"]))
    elt = torch.empty((), dtype=cfg.dtype).element_size()

    def reckon(stage, world, g):
        return dp_reckoning(P, P_layers, stage, world, g, elt)

    out = {"card": smi, "params": P}
    tmp = tempfile.mkdtemp(prefix="dstt-phase26-")
    # (b)'s ranks boot now, beside (a), and wait for go_b before their first
    # use of the card
    save_dir = os.path.join(tmp, "ckpt")
    rec_path = os.path.join(tmp, "ranks.jsonl")
    go_b = os.path.join(tmp, "b.go")
    env = {**os.environ, "WORLD_SIZE": "2", "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    cmd = [sys.executable, os.path.abspath(__file__), "--dp-worker", "--model", model,
           "--device", str(dev), "--save-dir", save_dir, "--out", rec_path, "--store",
           os.path.join(tmp, "store_b"), "--wait-for", go_b]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r), "LOCAL_RANK": "0"}) for r in range(2)]
    try:
        # (a) world 1 under the real communicator
        comm.init_distributed(init_method=f"file://{os.path.join(tmp, 'store_a')}", world_size=1, rank=0,
                              backend="nccl" if cuda else "gloo", device=dev)
        a = {}
        for stage in (0, 1, 2, 3):
            engine = deepspeed_tpu_torch.initialize(
                model=Model(cfg), config=dp_config(stage, micro * gas, micro, gas, base),
                model_parameters=tree_map(lambda t: t.clone(), params), device=dev)[0]
            warm_s, step_ms, losses, per_step, per, peak, _ = dp_steps(engine, cfg, DP_STEPS)
            a[f"stage{stage}"] = {"step_ms": step_ms, "warmup_s": warm_s, "losses": losses,
                                  "launches_per_train_batch": per_step, "comm_per_step": per,
                                  "reckoned_bytes_per_step": reckon(stage, 1, gas),
                                  "peak_gib": None if peak is None else peak / 2**30,
                                  "state_bytes": state_bytes(engine)}
            print(f"  (a) world 1 ({'nccl' if cuda else 'gloo'}), ZeRO {stage}: {step_ms:.1f} ms/step, peak "
                  f"{a[f'stage{stage}']['peak_gib']} GiB, {per['count']:.0f} collectives and "
                  f"{per['bytes'] / 1e6:.1f} MB a step (reckoned {reckon(stage, 1, gas) / 1e6:.1f}),"
                  f" launches {COUNT_LABEL} {per_step[0]} each step, losses {[round(x, 5) for x in losses]}  [{smi}]")
            del engine
            gc.collect()  # the engine's telemetry holds a cycle through it: free its state before the next
            if cuda:
                torch.cuda.empty_cache()
        comm.destroy_distributed()
        comms_logger.configure(enabled=False)
        ref = a["stage0"]["losses"]
        for stage in (0, 1, 2, 3):
            got = a[f"stage{stage}"]
            got["loss_rel_to_stage0"] = max(abs(x - y) / abs(y) for x, y in zip(got["losses"], ref))
            if got["losses"] != ref or not all(np.isfinite(got["losses"])):
                _dp_fail(f"(a) ZeRO {stage}'s losses {got['losses']} are not stage 0's {ref} bitwise")
            if not dp_launches_ok(got["launches_per_train_batch"], L * gas, cuda):
                _dp_fail(f"(a) ZeRO {stage}: launches per train_batch {COUNT_LABEL} "
                         f"{got['launches_per_train_batch']}, expected {L * gas} of each flash kernel and no other")
            if got["comm_per_step"]["count"] < 1:
                _dp_fail(f"(a) ZeRO {stage} issued no collective")
        out["a"] = a

        # (b) world 2 under gloo, both ranks on this device, booted at the
        # phase's start (above): they go once (a) is done with the card
        with open(go_b, "w") as f:
            f.write("go\n")
        t0 = time.perf_counter()
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0, 0]:
            _dp_fail(f"(b) a rank failed: exit codes {rcs}")
        ranks = sorted((json.loads(line) for line in open(rec_path)), key=lambda r: r["rank"])
        b = {"ranks_s": time.perf_counter() - t0, "probe": ranks[0]["probe"]}
        # the world-1 reference on the same global batches (no process group)
        gb = DP_WORLD2["micro"] * DP_WORLD2["gas"] * 2
        ref_eng = deepspeed_tpu_torch.initialize(
            model=Model(cfg), config=dp_config(1, gb, gb // DP_WORLD2["gas"], DP_WORLD2["gas"], base),
            model_parameters=tree_map(lambda t: t.clone(), params), device=dev)[0]
        ref_losses = [float(ref_eng.train_batch(dp_batch(cfg, gb, s))["loss"]) for s in range(DP_STEPS + 1)]
        ref_bytes = state_bytes(ref_eng)
        ref_params = tree_leaves(ref_eng.full_params())
        init = tree_leaves(params)
        b["world1_param_change"] = dp_param_gap(ref_params, ref_params, init)[1]
        if not b["world1_param_change"] > 0:
            _dp_fail("(b) world 1's steps did not move its parameters")
        gaps = {stage: dp_param_gap(torch.load(dp_params_path(rec_path, stage)), ref_params, init)[0]
                for stage in (1, 3)}
        del ref_eng, ref_params
        gc.collect()
        b["world1_losses"] = ref_losses
        b["world1_state_bytes"] = ref_bytes
        for stage in (1, 3):
            rows = [r[f"stage{stage}"] for r in ranks]
            if rows[1]["params_checksum"] != rows[0]["params_checksum"]:
                _dp_fail(f"(b) ZeRO {stage}: the ranks' parameters differ (checksums "
                         f"{[r['params_checksum'] for r in rows]})")
            if not gaps[stage] <= DP_PARAM_GAP:
                _dp_fail(f"(b) ZeRO {stage}: the parameters are {gaps[stage]:.3e} of world 1's change away from "
                         f"world 1's (limit {DP_PARAM_GAP})")
            for r, row in enumerate(rows):
                rel = max(abs(x - y) / abs(y) for x, y in zip(row["losses"], ref_losses))
                row["loss_rel_to_world1"] = rel
                if rel > DP_LOSS_RTOL:
                    _dp_fail(f"(b) rank {r}, ZeRO {stage}: losses {row['losses']} vs world 1's {ref_losses} "
                             f"({rel:.2e} > {DP_LOSS_RTOL})")
                if not dp_launches_ok(row["launches"], L * DP_WORLD2["gas"], cuda):
                    _dp_fail(f"(b) rank {r}, ZeRO {stage}: launches per train_batch {COUNT_LABEL} {row['launches']}")
            opt_ratio = rows[0]["state_bytes"]["opt_state"] / ref_bytes["opt_state"]
            par_ratio = rows[0]["state_bytes"]["params"] / ref_bytes["params"]
            b[f"stage{stage}"] = {"ranks": rows, "opt_state_ratio_to_world1": opt_ratio,
                                  "params_ratio_to_world1": par_ratio, "param_gap_to_world1": gaps[stage],
                                  "reckoned_bytes_per_step": reckon(stage, 2, DP_WORLD2["gas"])}
            want_par = 0.5 if stage == 3 else 1.0
            if not (0.45 < opt_ratio < 0.55) or not (want_par - 0.05 < par_ratio < want_par + 0.05):
                _dp_fail(f"(b) ZeRO {stage}: a rank holds {opt_ratio:.3f} of world 1's optimizer state and "
                         f"{par_ratio:.3f} of its parameters")
            per = rows[0]["comm_per_step"]
            print(f"  (b) world 2 (gloo, both ranks on {dev}), ZeRO {stage}: {rows[0]['step_ms']:.1f} ms/step; a "
                  f"rank holds {opt_ratio:.3f} of world 1's optimizer-state bytes and {par_ratio:.3f} of its "
                  f"parameter bytes; {per['count']:.0f} collectives, {per['bytes'] / 1e6:.1f} MB a step "
                  f"(reckoned {b[f'stage{stage}']['reckoned_bytes_per_step'] / 1e6:.1f}, host-staged "
                  f"{per['staged_bytes'] / 1e6:.1f}); losses vs world 1 within "
                  f"{max(r['loss_rel_to_world1'] for r in rows):.2e}, parameters {gaps[stage]:.3e} of world 1's "
                  f"change from world 1's  [{smi}]")
        # the world-2 stage-3 checkpoint resumed at world 1, stage 1
        res = deepspeed_tpu_torch.initialize(
            model=Model(cfg), config=dp_config(1, gb, gb // DP_WORLD2["gas"], DP_WORLD2["gas"], base),
            device=dev)[0]
        res.load_checkpoint(save_dir, tag="world2_stage3")
        loaded = gathered_state_digest(res)
        saved = ranks[0]["stage3"]["saved_digest"]
        same = [a == b for a, b in zip(loaded, saved)]
        resumed = float(res.train_batch(dp_batch(cfg, gb, DP_STEPS + 1))["loss"])
        del res
        gc.collect()  # the engine's telemetry holds a cycle through it
        w2 = ranks[0]["stage3"]["next_loss"]
        rel = abs(resumed - w2) / abs(w2)
        b["resume"] = {"world1_stage1_next_loss": resumed, "world2_stage3_next_loss": w2, "rel": rel,
                       "leaves": len(saved), "leaves_bitwise": sum(same)}
        print(f"  (b) the world-2 ZeRO-3 checkpoint resumed at world 1, ZeRO 1: {sum(same)} of {len(saved)} fp32 "
              f"leaves (masters and moments) bitwise the ones world 2 gathered and saved; next loss {resumed:.6f} "
              f"vs world 2's {w2:.6f} ({rel:.2e}, limit {DP_LOSS_RTOL}); gloo on {dev.type}: {b['probe']}")
        # the state is the checkpoint's bitwise; the next loss is a world of
        # 1's mean against the mean of two ranks' means: rounding apart
        if len(loaded) != len(saved) or not all(same) or not len(saved):
            _dp_fail(f"(b) the resumed state differs from what world 2 saved at leaves "
                     f"{[i for i, ok in enumerate(same) if not ok]} of {len(saved)} ({len(loaded)} loaded)")
        if not rel <= DP_LOSS_RTOL:
            _dp_fail(f"(b) the resumed loss {resumed} is {rel:.2e} from world 2's {w2} (limit {DP_LOSS_RTOL})")
        out["b"] = b
    finally:
        for p in procs:  # (a) failed before (b)'s ranks were let go
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        comm.destroy_distributed()
    return out


# ---------------------------------------------------------------------------
# Phase 27: tensor-parallel serving (init_inference at tp_size > 1 over the
# mesh's model axis; the ServingEngine's driver and followers) at GPT-2-125M
# width, gloo ranks sharing the one card
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)
TP_B, TP_PROMPT, TP_NEW = 4, 128, 32  # (a) generate: rows, prompt tokens, new tokens
# (b) the first 16 requests of workload (a), one for each slot, their new
# tokens cut to a quarter (16-32): a TP decode step under gloo is a host
# round trip per collective
TP_SERVE_REQUESTS, TP_SERVE_NEW_DIV = 16, 4
TP_DECODE_PROBE = 4  # (b) idle decode steps whose collectives are counted
# (a) the largest |logit| gap of the first decode step, tp N against tp 1,
# both bf16 (bf16 rounds each rank's partial product of a row-parallel
# layer before the fp32 sum, where tp 1 rounds the whole product once; the
# difference passes through 12 layers): read 0.0264 at tp 2 and 0.0259 at
# tp 4 on an H100, about 3x below this limit; a rank computing the wrong
# heads (model index 1's wo shards zeroed) read 3.05 and 2.00
TP_BF16_GAP = 0.08
TP_TINY = dict(vocab_size=96, max_seq_len=256, num_layers=2, num_heads=4, hidden_size=64)


def tp_model(model):
    """Phase 4's serving model at full width (``gpt2``), or the CPU
    rehearsal's (``tiny``); the engine dtype is the caller's."""
    if model == "gpt2":
        return TransformerConfig(vocab_size=50304, max_seq_len=1024, num_layers=12, num_heads=12, hidden_size=768,
                                 pos_emb="learned", tie_embeddings=True)
    return TransformerConfig(**TP_TINY)


def tp_params(cfg):
    """The weights every engine of phase 27 starts from: ``init_inference``'s
    own draw (seed 0, on the host), made once a process."""
    return Model(cfg).init(torch.Generator().manual_seed(0), "cpu")


def tp_prompt(cfg):
    return np.random.default_rng(27).integers(0, cfg.vocab_size, size=(TP_B, TP_PROMPT)).astype(np.int32)


def tp_serve_workload(cfg):
    """The first requests of workload (a) (benchmarks/serving_throughput.py:
    169-191) with their new tokens cut, and on the CPU rehearsal its
    512-token shared prefix cut to the model's context."""
    from deepspeed_tpu_torch.inference import Request

    short = cfg.max_seq_len < SHARED_PREFIX + 48 + 128
    return [Request(uid=r.uid, prompt=r.prompt[-40:] if short else r.prompt,
                    max_new_tokens=r.max_new_tokens // TP_SERVE_NEW_DIV)
            for r in shared_prefix_workload(cfg.vocab_size)[:TP_SERVE_REQUESTS]]


def tp_serve_config(cfg):
    if cfg.max_seq_len >= SHARED_PREFIX + 48 + 128:
        return {**SERVE_CONFIG, "watchdog_mode": "raise"}
    return {"n_slots": 8, "seed": 0, "watchdog_mode": "raise",
            "prefix_cache": {"enabled": True, "n_slots": 4, "max_prefix_len": 64},
            "chunked_prefill": {"enabled": True, "chunk_size": 16}}


def first_step_logits(engine, prompt):
    """The first decode step's fp32 logits [B, V] after a prefill of
    ``prompt``, through the decode kernel (every rank calls it under tensor
    parallelism; every rank returns the full logits)."""
    cfg = engine.cfg
    toks = torch.from_numpy(prompt).long().to(engine.device)
    S = toks.shape[1]
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, toks.shape[0], -(-(S + 1) // 128) * 128, device=engine.device,
                               heads=engine.heads)
        logits, cache = tfm.apply_with_cache(cfg, engine.params, toks, cache, 0, last_only=True)
        nxt = logits[:, -1].argmax(-1)[:, None]
        step, _ = tfm.apply_with_cache(cfg, engine.params, nxt, cache, S)
    return step[:, 0].float().cpu()


def tp_generate(engine, prompt):
    """(greedy tokens of ``TP_NEW``, (split, combine) decode-kernel launches
    of that generate, seconds)."""
    engine.generate(prompt, max_new_tokens=2)  # warm-up: library handles, the allocator
    decode_attention.launches = decode_attention.combine_launches = 0
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompt, max_new_tokens=TP_NEW)
    return out, (decode_attention.launches, decode_attention.combine_launches), time.perf_counter() - t0


def tp_results_digest(res) -> dict:
    return {str(u): [r.status, np.asarray(r.tokens).tolist()] for u, r in sorted(res.items())}


def tp_serve(engine, cfg):
    """(b) on one rank (or at tp 1): warm the engine, serve the workload cut
    on the clock, then count the collectives of ``TP_DECODE_PROBE`` decode
    steps (every slot idle: the same shapes as a loaded step)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    srv = ServingEngine(engine, config=tp_serve_config(cfg))
    srv.serve([Request(uid=100000 + i, prompt=np.arange(1, 20 + i, dtype=np.int32), max_new_tokens=4)
               for i in range(2)])  # a warm-up outside the measured run
    reqs = tp_serve_workload(cfg)
    w = srv.worker
    steps0, launches0 = w._decode_steps, w.decode_kernel_launches()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve(reqs)
    seconds = time.perf_counter() - t0
    steps = w._decode_steps - steps0
    launches = [b - a for a, b in zip(launches0, w.decode_kernel_launches())]
    out = {"metrics": serving_metrics(res, seconds) if srv.is_driver else None, "decode_steps": steps,
           "launches": launches, "launches_per_step": [n / max(steps, 1) for n in launches],
           "results": tp_results_digest(res), "decode_route": srv.telemetry_snapshot()["decode_route"]}
    comm.comms_logger.reset()
    comm.comms_logger.configure(enabled=True)
    for _ in range(TP_DECODE_PROBE):
        srv.warm_decode()
    out["decode_comm"] = {k: {"count": v["count"] / TP_DECODE_PROBE, "bytes": v["bytes"] / TP_DECODE_PROBE}
                          for k, v in comm.comms_logger.summary().items() if "@" in k}
    comm.comms_logger.configure(enabled=False)
    srv.close()
    return out


def tp_reckoning(cfg, n_slots, tp) -> dict:
    """The collectives one decode step of ``n_slots`` rows issues at ``tp``
    (fp32 on the wire): an all-reduce of B·T·D after every row-parallel
    layer (2 a layer) and one for the vocab-split embedding, one
    all-gather of the rank's B·T·V/tp logits; plus, over the driver's
    broadcasts, the call and the closing message (pickles, not reckoned)."""
    B, D = n_slots, cfg.hidden_size
    split_vocab = cfg.vocab_size % tp == 0
    n_reduce = 2 * cfg.num_layers + (1 if split_vocab else 0)
    return {"all_reduce": {"count": n_reduce, "bytes": n_reduce * B * D * 4},
            "all_gather": {"count": 1 if split_vocab else 0,
                           "bytes": B * (cfg.vocab_size // tp) * 4 if split_vocab else 0}}


def tp_worker(args) -> int:
    """``--tp-worker``: one rank of phase 27 at tp = ``WORLD_SIZE``. Joins
    the gloo world through ``--store``; (a) greedy generate in fp32 and
    bf16 (tokens, the first decode step's logits, its decode launches),
    and in bf16 once more with model index 1's ``wo`` shards zeroed (the
    wrong-heads control); with ``--tp-serve``, once the file ``--wait-for``
    exists (the parent's signal that nothing else runs on the card), (b)
    the ServingEngine over the workload cut. Appends one JSON record to
    ``--out``; rank 0 saves its logits beside it."""
    from deepspeed_tpu_torch import comm

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(init_method=f"file://{args.store}", world_size=world, rank=rank, backend="gloo",
                          timeout_s=300.0)
    cfg = tp_model(args.model)
    prompt = tp_prompt(cfg)
    rec = {"rank": rank, "world": world, "device": str(dev), "kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    logits = {}
    params = tp_params(cfg)
    for dtype in ("fp32", "bf16"):
        eng = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": dtype, "tensor_parallel":
                                                                     {"tp_size": world}}, params=params, device=dev)
        out, launches, seconds = tp_generate(eng, prompt)
        logits[dtype] = first_step_logits(eng, prompt)
        rec[dtype] = {"tokens": out.tolist(), "launches": launches, "seconds": seconds, "heads": eng.heads,
                      "wq_shape": list(eng.params["layers"]["wq"].shape)}
        if dtype == "bf16":  # the control: one rank's heads computed wrong
            if eng.tp.index == 1:
                eng.params["layers"]["wo"].zero_()
            logits["wrong_heads"] = first_step_logits(eng, prompt)
        del eng
        gc.collect()
    if rank == 0:
        torch.save(logits, f"{args.out}.logits.pt")
    if args.tp_serve:
        deadline = time.monotonic() + 600
        while not os.path.exists(args.wait_for):
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 27: no {args.wait_for} within 600 s")
            time.sleep(0.1)
        eng = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": "fp32", "tensor_parallel":
                                                                     {"tp_size": world}}, params=params, device=dev)
        rec["serve"] = tp_serve(eng, cfg)
        del eng
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    comm.destroy_distributed()
    return 0


def _tp_fail(what):
    raise SystemExit(f"phase 27: {what}")


def tensor_parallel_phase(dev, smi, model="gpt2"):
    """Phase 27. The gloo worlds of tp 2 and tp 4 (``--tp-worker``
    processes, all on ``dev``) boot first, all at once; meanwhile this
    process runs tp 1's generate in fp32 and bf16. (a) generate in each
    world; once the tp 4 world is done, tp 1's ServingEngine over the
    workload cut (its decode step one CUDA graph) is timed here while the
    tp 2 world waits; then (b) the ServingEngine at tp 2, alone on the card.
    Checks: fp32 greedy tokens and streams equal tp 1's, the bf16 first-step
    logit gap within ``TP_BF16_GAP`` and the wrong-heads control above it,
    every rank's decode launches 12 x (new - 1) a generate and 12 + 12 a
    serving decode step, the collectives a decode step as reckoned, every
    rank's serve() returning the driver's results."""
    cuda = dev.type == "cuda"
    cfg = tp_model(model)
    L = cfg.num_layers
    prompt = tp_prompt(cfg)
    t_phase = time.perf_counter()
    out = {"config": {"model": model, "B": TP_B, "prompt": TP_PROMPT, "new": TP_NEW,
                      "serve_requests": TP_SERVE_REQUESTS, "serve_config": tp_serve_config(cfg)}}
    ref, ref_logits = {}, {}
    with tempfile.TemporaryDirectory(prefix="dstt_tp_") as tmp:
        paths = {tp: os.path.join(tmp, f"tp{tp}.jsonl") for tp in TP_SIZES}
        go = os.path.join(tmp, "serve.go")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)), "LOCAL_RANK": "0"}
        procs = {}
        for tp in TP_SIZES:
            cmd = [sys.executable, os.path.abspath(__file__), "--tp-worker", "--model", model, "--device", str(dev),
                   "--out", paths[tp], "--store", os.path.join(tmp, f"store{tp}")]
            if tp == TP_SIZES[0]:  # (b) at the smallest tp, once the card is free
                cmd += ["--tp-serve", "--wait-for", go]
            procs[tp] = [subprocess.Popen(cmd, env={**env, "WORLD_SIZE": str(tp), "RANK": str(r)})
                         for r in range(tp)]
        try:
            engines, params = {}, tp_params(cfg)
            for dtype in ("fp32", "bf16"):
                eng = engines[dtype] = deepspeed_tpu_torch.init_inference(Model(cfg), config={"dtype": dtype},
                                                                          params=params, device=dev)
                tokens, launches, seconds = tp_generate(eng, prompt)
                ref[dtype] = {"tokens": tokens.tolist(), "launches": launches, "seconds": seconds}
                ref_logits[dtype] = first_step_logits(eng, prompt)
            del engines["bf16"], eng
            rcs = {tp: [p.wait(timeout=900) for p in procs[tp]] for tp in TP_SIZES[1:]}
            # tp 1's serving, timed while the tp 2 world waits for the signal
            ref["serve"] = tp_serve(engines.pop("fp32"), cfg)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            with open(go, "w") as f:
                f.write("go\n")
            rcs[TP_SIZES[0]] = [p.wait(timeout=900) for p in procs[TP_SIZES[0]]]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        out["ranks_s"] = time.perf_counter() - t_phase
        if any(rc != 0 for r in rcs.values() for rc in r):
            _tp_fail(f"a rank failed: exit codes {rcs}")
        ranks = {tp: sorted((json.loads(line) for line in open(paths[tp])), key=lambda r: r["rank"])
                 for tp in TP_SIZES}
        logits = {tp: torch.load(f"{paths[tp]}.logits.pt") for tp in TP_SIZES}
    m1 = ref["serve"]["metrics"]
    print(f"  [{smi}] tp 1: generate fp32 {ref['fp32']['seconds']:.3f} s, bf16 {ref['bf16']['seconds']:.3f} s (the "
          f"ranks booting beside it); serving ({ref['serve']['decode_route']}) {m1['tokens']} tokens in "
          f"{m1['seconds']:.3f} s = {m1['tokens_per_s']:.1f} tokens/s, TTFT p50 {m1['ttft_p50_ms']:.1f} ms, p99 "
          f"{m1['ttft_p99_ms']:.1f} ms, TPOT p50 {m1['tpot_p50_ms']:.3f} ms")

    expect = L * (TP_NEW - 1) if cuda else 0
    for tp in TP_SIZES:
        rs = ranks[tp]
        gap = {k: float((logits[tp][k] - ref_logits["bf16" if k == "wrong_heads" else k]).abs().max())
               for k in ("fp32", "bf16", "wrong_heads")}
        entry = {"gap_vs_tp1": gap, "heads_per_rank": rs[0]["fp32"]["heads"],
                 "launches_per_generate": [r[d]["launches"] for r in rs for d in ("fp32", "bf16")],
                 "generate_s": {d: [r[d]["seconds"] for r in rs] for d in ("fp32", "bf16")}}
        fp32_equal = all(r["fp32"]["tokens"] == ref["fp32"]["tokens"] for r in rs)
        bf16_same = all(r["bf16"]["tokens"] == rs[0]["bf16"]["tokens"] for r in rs)
        entry["bf16_tokens_equal_tp1"] = rs[0]["bf16"]["tokens"] == ref["bf16"]["tokens"]
        launches_ok = all(tuple(x) == (expect, expect) for x in entry["launches_per_generate"])
        print(f"  [{smi}] (a) tp {tp}: {entry['heads_per_rank']} heads a rank; fp32 greedy tokens == tp 1's: "
              f"{fp32_equal}; first-step logits vs tp 1 fp32 {gap['fp32']:.3e}, bf16 {gap['bf16']:.4f} "
              f"(limit {TP_BF16_GAP}), bf16 with model index 1's wo zeroed {gap['wrong_heads']:.4f} (must exceed "
              f"it); bf16 tokens equal across ranks {bf16_same}, == tp 1's {entry['bf16_tokens_equal_tp1']}; "
              f"decode launches a generate (split, combine) per rank and dtype {entry['launches_per_generate']} "
              f"(expect {expect} each)")
        if not fp32_equal:
            _tp_fail(f"(a) tp {tp}: fp32 greedy tokens differ from tp 1's")
        if not gap["bf16"] <= TP_BF16_GAP < gap["wrong_heads"]:
            _tp_fail(f"(a) tp {tp}: bf16 first-step logit gap {gap['bf16']} against the limit {TP_BF16_GAP} "
                     f"(the wrong-heads control read {gap['wrong_heads']})")
        if not (bf16_same and launches_ok):
            _tp_fail(f"(a) tp {tp}: ranks disagree on tokens or launched the decode kernel other than {expect} times")
        out[f"tp{tp}"] = entry

    # (b) the ServingEngine at the smallest tp against tp 1
    tp = TP_SIZES[0]
    rs = ranks[tp]
    mt = rs[0]["serve"]["metrics"]
    streams_equal = rs[0]["serve"]["results"] == ref["serve"]["results"]
    followers_equal = all(r["serve"]["results"] == rs[0]["serve"]["results"] for r in rs)
    per_step = [r["serve"]["launches_per_step"] for r in rs]
    launch_ok = all(p == ([L, L] if cuda else [0, 0]) for p in per_step)
    reck = tp_reckoning(cfg, tp_serve_config(cfg)["n_slots"], tp)
    got = {op: {"count": sum(v["count"] for k, v in rs[0]["serve"]["decode_comm"].items() if k.startswith(op)),
                "bytes": sum(v["bytes"] for k, v in rs[0]["serve"]["decode_comm"].items() if k.startswith(op))}
           for op in ("all_reduce", "all_gather", "broadcast")}
    comm_ok = all(got[op] == reck[op] for op in reck)
    print(f"  [{smi}] (b) ServingEngine at tp {tp} ({rs[0]['serve']['decode_route']} decode): {mt['tokens']} tokens "
          f"in {mt['seconds']:.3f} s = {mt['tokens_per_s']:.1f} tokens/s (tp 1 {m1['tokens_per_s']:.1f}), TTFT p50 "
          f"{mt['ttft_p50_ms']:.1f} ms / p99 {mt['ttft_p99_ms']:.1f} ms (tp 1 {m1['ttft_p50_ms']:.1f} / "
          f"{m1['ttft_p99_ms']:.1f}), TPOT p50 {mt['tpot_p50_ms']:.3f} ms (tp 1 {m1['tpot_p50_ms']:.3f}); fp32 "
          f"streams == tp 1's: {streams_equal}; every rank's serve() returned the driver's results: "
          f"{followers_equal}; decode launches a step per rank (split, combine) {per_step}; a decode step's "
          f"collectives on rank 0 {got} against the reckoning {reck}")
    if not (streams_equal and followers_equal and launch_ok and comm_ok and mt["ok"] == mt["requests"]):
        _tp_fail("(b) the tensor-parallel ServingEngine failed its checks")
    out["serve"] = {"tp1": m1, f"tp{tp}": mt, "tp1_decode_route": ref["serve"]["decode_route"],
                    "decode_route": rs[0]["serve"]["decode_route"], "decode_steps": rs[0]["serve"]["decode_steps"],
                    "launches_per_step": per_step, "launches": [r["serve"]["launches"] for r in rs],
                    "decode_comm": got, "reckoning": reck, "tp1_launches": ref["serve"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"tensor_parallel": out}))
    return out


# ---------------------------------------------------------------------------
# Phase 28: tensor-parallel training
# ---------------------------------------------------------------------------

# (a) tp 2 alone at phase 7's model: global batch 8 = micro 4 x gas 2, ZeRO 1;
# (b) data 2 x model 2 under ZeRO 3 with dots_and_flash remat and
# partition_activations: global batch 16 = 2 x micro 4 x gas 2
TPT_CASES = {"a": {"data": 1, "tp": 2, "micro": 4, "gas": 2, "stage": 1},
             "b": {"data": 2, "tp": 2, "micro": 4, "gas": 2, "stage": 3}}
# timed steps after one warm-up, whose losses are compared too; (b)'s steps
# take ~6 s under gloo, so it times 2
TPT_STEPS = {"a": 3, "b": 2}
TPT_REMAT = {"enabled": True, "policy": "dots_and_flash"}
# each rank's losses against tp 1's on the same global batches, relative, by
# model: fp32 at the tiny size (the CPU rehearsal) sums in another order
# only; at GPT-2 width in bf16 each rank rounds its partial products (read
# 2.90e-5 over (a)'s 4 steps on an H100, the wrong-shard control 7.16e-4)
TPT_LOSS_GAP = {"gpt2": 2e-4, "tiny": 1e-5}
TPT_TINY = dict(vocab_size=96, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64, dtype=torch.float32,
                attn_impl="flash", loss_chunk_size=16)


def tpt_model(model):
    return gpt2_config() if model == "gpt2" else TransformerConfig(**TPT_TINY)


def tpt_config(case, model, reference=False, partition=True):
    """The case's config on its mesh, or for the ``reference`` at tp 1 (one
    process, the same global batch: the micro-batches of every data index
    in one)."""
    c = TPT_CASES[case]
    rows = c["micro"] * c["gas"] * c["data"]
    micro = c["micro"] * c["data"] if reference else c["micro"]
    ds = dp_config(c["stage"], rows, micro, c["gas"], BENCH_DS if model == "gpt2" else DP_TINY_DS)
    if not reference:
        ds["mesh"] = {"data": c["data"], "model": c["tp"]}
    if case == "b":
        ds["activation_checkpointing"] = {**TPT_REMAT, "partition_activations": partition}
    return ds


class BoundaryMeter:
    """Counts the bytes of the layer regions' inputs that the model's
    checkpoints keep for their recompute (the saved boundaries), by
    wrapping the ``checkpoint`` the model calls."""

    def __init__(self):
        self.bytes = 0
        self._orig = None

    def __enter__(self):
        self._orig = orig = tfm.checkpoint

        def counted(fn, *args, **kw):
            if getattr(fn, "__name__", "") == "run":  # a layer region (the loss chunks are not boundaries)
                self.bytes += args[0].numel() * args[0].element_size()
            return orig(fn, *args, **kw)

        tfm.checkpoint = counted
        return self

    def __exit__(self, *exc):
        tfm.checkpoint = self._orig


def tp_train_reckoning(cfg, micro, gas) -> dict:
    """The collectives a train_batch logs over ``model`` at ZeRO 1 without
    remat (case a), written before the first run in PERF.md. Per micro-batch
    and 2L + 1 of each: the forward's reduce of the embedding and of each
    layer's two row-parallel products, the backward's all-reduce of each
    column-parallel input's gradient (q/k/v's, wi's, the head's), all of
    micro x S x D fp32; then per loss chunk three all-reduces of micro x
    chunk fp32 (the max, the sum of exponentials, the gold logit), in the
    forward and again in the chunk's recompute. Keyed as the comms logger
    keys them over ``model``."""
    S, D, L = cfg.max_seq_len, cfg.hidden_size, cfg.num_layers
    chunk = cfg.loss_chunk_size
    chunks = S // chunk if chunk and S % chunk == 0 and S > chunk else 1
    big = 2 * (2 * L + 1)
    row = micro * (S // chunks) * 4  # one loss all-reduce's bytes
    return {"all_reduce[sum]": {"count": gas * (big + 4 * chunks),
                                "bytes": gas * (big * micro * S * D * 4 + 4 * chunks * row)},
            "all_reduce[max]": {"count": gas * 2 * chunks, "bytes": gas * 2 * chunks * row}}


def tp_train_worker(args) -> int:
    """``--tp-train-worker``: one rank of phase 28's case ``--tpt-case``
    (a: tp 2; b: data 2 x model 2). Joins the gloo world through
    ``--store`` and waits for ``--wait-for`` (the card to itself); (a) the
    wrong-shard control (model index 1's ``wo`` zeroed, the first batch's
    loss), then one warm-up and ``TPT_STEPS`` timed steps with the flash
    launches and the collectives counted; (b) the same with partition_
    activations, the saved boundaries' bytes and the peak memory, a save
    into ``--save-dir`` and the next step, then a warm-up and one step
    without partition_activations. Appends one JSON record to ``--out``."""
    from deepspeed_tpu_torch import comm

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(init_method=f"file://{args.store}", world_size=world, rank=rank, backend="gloo",
                          timeout_s=600.0)
    deadline = time.monotonic() + 900
    while not os.path.exists(args.wait_for):
        if time.monotonic() > deadline:
            raise SystemExit(f"phase 28: no {args.wait_for} within 900 s")
        time.sleep(0.05)
    case = args.tpt_case
    cfg = tpt_model(args.model)
    params = dp_params(cfg)
    rec = {"rank": rank, "world": world, "case": case, "kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    runs = (True, False) if case == "b" else (True,)
    for partition in runs:
        engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=tpt_config(case, args.model,
                                                                                  partition=partition),
                                                model_parameters=tree_map(lambda t: t.clone(), params),
                                                device=dev)[0]
        entry = {"heads": engine.tp.heads(cfg.num_heads), "vocab_rows": int(engine.tp.full_shapes["wte"][0]
                                                                             // engine.tp.size),
                 "model_index": engine.tp.index, "dp_rank": engine.dp_rank, "state_bytes": state_bytes(engine),
                 "fused_fallback": list(tfm.effective_loss_impl(cfg.replace(loss_impl="fused_xent"),
                                                                n_rows=engine.micro_batch_size * cfg.max_seq_len,
                                                                mesh=engine.mesh))}
        if case == "a":  # the control: one rank's row-parallel heads wrong
            wo = engine.state["params"]["layers"]["wo"]
            keep = wo.clone()
            if engine.tp.index == 1:
                wo.zero_()
            entry["wrong_shard_loss"] = float(engine.eval_batch(dp_batch(cfg, engine.train_batch_size, 0)))
            wo.copy_(keep)
            del keep
        # without partition_activations (b) takes one step after its warm-up,
        # for its peak and its boundaries only
        steps = TPT_STEPS[case] if partition else 1
        with BoundaryMeter() as meter:
            warm_s, step_ms, losses, per_step, per, peak, ops = dp_steps(engine, cfg, steps)
        entry.update(warmup_s=warm_s, step_ms=step_ms, losses=losses, launches=per_step, comm_per_step=per,
                     comm_ops=ops, peak_bytes=peak, boundary_bytes_per_train_batch=meter.bytes // (steps + 1))
        if case == "b" and partition:
            engine.save_checkpoint(args.save_dir, tag="tp_b")
            entry["next_loss"] = float(engine.train_batch(dp_batch(cfg, engine.train_batch_size,
                                                                   steps + 1))["loss"])
        rec["partition" if partition and case == "b" else "plain" if case == "b" else "run"] = entry
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    comm.destroy_distributed()
    return 0


def _tpt_fail(what):
    raise SystemExit(f"phase 28: {what}")


def tpt_reference(dev, cfg, model, case):
    """tp 1 in this process on the case's global batches: (warm-up s, ms a
    step, losses, per-step launches, peak bytes, state bytes, engine)."""
    engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=tpt_config(case, model, reference=True),
                                            model_parameters=dp_params(cfg), device=dev)[0]
    with BoundaryMeter() as meter:
        warm_s, step_ms, losses, per_step, per, peak, ops = dp_steps(engine, cfg, TPT_STEPS[case])
    return {"warmup_s": warm_s, "step_ms": step_ms, "losses": losses, "launches": per_step, "peak_bytes": peak,
            "state_bytes": state_bytes(engine),
            "boundary_bytes_per_train_batch": meter.bytes // (TPT_STEPS[case] + 1)}


def rel_gap(got, ref) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(got, ref))


def tensor_parallel_training_phase(dev, smi, model="gpt2"):
    """Phase 28. The gloo worlds of (a) tp 2 and (b) data 2 x model 2
    (``--tp-train-worker`` processes, all on ``dev``) boot first and wait;
    meanwhile this process runs tp 1 on each case's global batches. Then
    (a) runs alone on the card, then (b); then (b)'s saved state is loaded
    here at world 1 and takes the next step. Checks: each rank's losses
    within ``TPT_LOSS_GAP`` of tp 1's and the wrong-shard control above it;
    each rank's flash forward, dK/dV and dQ launched 12 x gas times a
    train_batch on its own heads and no other kernel; (a)'s collectives
    over ``model`` as reckoned (``tp_train_reckoning``); (b)'s saved
    boundaries about half of those without partition_activations; the
    world-1 resume's next loss within the limit of (b)'s."""
    cuda = dev.type == "cuda"
    cfg = tpt_model(model)
    L = cfg.num_layers
    t_phase = time.perf_counter()
    limit = TPT_LOSS_GAP[model]
    out = {"config": {"model": model, "cases": TPT_CASES, "remat_b": TPT_REMAT, "steps": TPT_STEPS,
                      "loss_gap": limit}}
    with tempfile.TemporaryDirectory(prefix="dstt_tpt_") as tmp:
        paths = {c: os.path.join(tmp, f"{c}.jsonl") for c in TPT_CASES}
        go = {c: os.path.join(tmp, f"{c}.go") for c in TPT_CASES}
        save_dir = os.path.join(tmp, "ckpt")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)), "LOCAL_RANK": "0"}
        procs = {}
        for c, spec in TPT_CASES.items():
            n = spec["data"] * spec["tp"]
            cmd = [sys.executable, os.path.abspath(__file__), "--tp-train-worker", "--tpt-case", c, "--model", model,
                   "--device", str(dev), "--out", paths[c], "--store", os.path.join(tmp, f"store_{c}"),
                   "--wait-for", go[c], "--save-dir", save_dir]
            procs[c] = [subprocess.Popen(cmd, env={**env, "WORLD_SIZE": str(n), "RANK": str(r)}) for r in range(n)]
        try:
            ref = {c: tpt_reference(dev, cfg, model, c) for c in TPT_CASES}
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            rcs = {}
            for c in TPT_CASES:  # each world alone on the card
                with open(go[c], "w") as f:
                    f.write("go\n")
                rcs[c] = [p.wait(timeout=900) for p in procs[c]]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        out["ranks_s"] = time.perf_counter() - t_phase
        if any(rc != 0 for r in rcs.values() for rc in r):
            _tpt_fail(f"a rank failed: exit codes {rcs}")
        ranks = {c: sorted((json.loads(line) for line in open(paths[c])), key=lambda r: r["rank"])
                 for c in TPT_CASES}
        # (b)'s state at world 1: its next loss against (b)'s
        engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=tpt_config("b", model, reference=True),
                                                device=dev)[0]
        engine.load_checkpoint(save_dir, tag="tp_b")
        resumed = float(engine.train_batch(dp_batch(cfg, engine.train_batch_size, TPT_STEPS["b"] + 1))["loss"])
        del engine
        gc.collect()

    def launches_ok(per_step, gas):
        want = ([L * gas] * 3 if cuda else [0] * 3) + [0] * (N_COUNTS - 3 + N_SPARSE)
        return all(s == want for s in per_step)

    # (a)
    c = TPT_CASES["a"]
    ra, r1 = ranks["a"], ref["a"]
    gaps = [rel_gap(r["run"]["losses"], r1["losses"]) for r in ra]
    control = [abs(r["run"]["wrong_shard_loss"] - r1["losses"][0]) / abs(r1["losses"][0]) for r in ra]
    reck = tp_train_reckoning(cfg, c["micro"], c["gas"])
    got, data_axes = {}, {}
    for key, v in ra[0]["run"]["comm_ops"].items():
        op, _, axis = key.partition("@")
        per = {"count": v["count"] / TPT_STEPS["a"], "bytes": v["bytes"] / TPT_STEPS["a"]}
        (got if axis == "model" else data_axes)[op if axis == "model" else key] = per
    comm_ok = got == reck
    a_launch_ok = all(launches_ok(r["run"]["launches"], c["gas"]) for r in ra)
    heads_ok = all(r["run"]["heads"] == cfg.num_heads // c["tp"] for r in ra)
    fallback = ra[0]["run"]["fused_fallback"]
    entry_a = {"loss_gap_vs_tp1": gaps, "wrong_shard_gap": control, "losses": [r["run"]["losses"] for r in ra],
               "tp1_losses": r1["losses"], "step_ms": [r["run"]["step_ms"] for r in ra], "tp1_step_ms": r1["step_ms"],
               "peak_bytes": [r["run"]["peak_bytes"] for r in ra], "tp1_peak_bytes": r1["peak_bytes"],
               "state_bytes": [r["run"]["state_bytes"] for r in ra], "tp1_state_bytes": r1["state_bytes"],
               "launches_per_train_batch": [r["run"]["launches"][0] for r in ra],
               "tp1_launches_per_train_batch": r1["launches"][0], "heads_per_rank": ra[0]["run"]["heads"],
               "vocab_rows_per_rank": ra[0]["run"]["vocab_rows"], "comm_on_model_per_step": got,
               "reckoning": reck, "comm_other_axes_per_step": data_axes, "fused_fallback": fallback,
               "warmup_s": [r["run"]["warmup_s"] for r in ra]}
    byte_share = [r["run"]["state_bytes"]["params"] / r1["state_bytes"]["params"] for r in ra]
    opt_share = [r["run"]["state_bytes"]["opt_state"] / r1["state_bytes"]["opt_state"] for r in ra]
    entry_a.update(params_share=byte_share, opt_share=opt_share)
    print(f"  [{smi}] (a) tp 2 ({entry_a['heads_per_rank']} heads and {entry_a['vocab_rows_per_rank']} vocab rows a "
          f"rank, ZeRO 1, batch {c['micro'] * c['gas']} = micro {c['micro']} x gas {c['gas']}): "
          f"{[round(x, 1) for x in entry_a['step_ms']]} ms/step (tp 1 {r1['step_ms']:.1f}), peak "
          f"{[round(x / 2**30, 3) for x in entry_a['peak_bytes'] if x] or 'n/a'} GiB (tp 1 "
          f"{(r1['peak_bytes'] or 0) / 2**30:.3f}), parameter bytes {[round(x, 3) for x in byte_share]} and "
          f"optimizer-state bytes {[round(x, 3) for x in opt_share]} of tp 1's; losses {entry_a['losses'][0]} vs tp 1 "
          f"{r1['losses']}: gap {max(gaps):.3e} (limit {limit}); wrong-shard control {min(control):.3e} (must "
          f"exceed it); launches a train_batch {COUNT_LABEL} {entry_a['launches_per_train_batch']} (expect "
          f"{L} x {c['gas']} of each flash kernel); collectives over model a step {got} against {reck}; other axes "
          f"{data_axes}; a fused_xent config here: {fallback}")
    if not max(gaps) <= limit < min(control):
        _tpt_fail(f"(a) loss gap {max(gaps)} against the limit {limit} (the wrong-shard control read "
                  f"{min(control)})")
    if not (a_launch_ok and heads_ok and comm_ok and fallback[0] == "chunked"):
        _tpt_fail(f"(a) launches {a_launch_ok}, heads {heads_ok}, collectives {comm_ok} or the fused fallback "
                  f"{fallback} failed")
    out["a"] = entry_a

    # (b)
    c = TPT_CASES["b"]
    rb, r1 = ranks["b"], ref["b"]
    gaps = [rel_gap(r["partition"]["losses"], r1["losses"]) for r in rb]
    part_b = [r["partition"]["boundary_bytes_per_train_batch"] for r in rb]
    plain_b = [r["plain"]["boundary_bytes_per_train_batch"] for r in rb]
    boundary_share = [p / q for p, q in zip(part_b, plain_b)]
    next_losses = [r["partition"]["next_loss"] for r in rb]
    resume_gap = abs(resumed - next_losses[0]) / abs(next_losses[0])
    b_launch_ok = all(launches_ok(r[k]["launches"], c["gas"]) for r in rb for k in ("partition", "plain"))
    entry_b = {"loss_gap_vs_tp1": gaps, "losses": [r["partition"]["losses"] for r in rb], "tp1_losses": r1["losses"],
               "step_ms": [r["partition"]["step_ms"] for r in rb], "tp1_step_ms": r1["step_ms"],
               "peak_bytes_partitioned": [r["partition"]["peak_bytes"] for r in rb],
               "peak_bytes_whole": [r["plain"]["peak_bytes"] for r in rb], "tp1_peak_bytes": r1["peak_bytes"],
               "boundary_bytes_partitioned": part_b, "boundary_bytes_whole": plain_b,
               "boundary_share": boundary_share, "state_bytes": [r["partition"]["state_bytes"] for r in rb],
               "launches_per_train_batch": [r["partition"]["launches"][0] for r in rb],
               "next_losses": next_losses, "world1_resumed_next_loss": resumed, "resume_gap": resume_gap,
               "comm_per_step": rb[0]["partition"]["comm_per_step"]}
    print(f"  [{smi}] (b) data 2 x model 2, ZeRO 3, {TPT_REMAT['policy']} remat with partition_activations, batch "
          f"{c['micro'] * c['gas'] * c['data']}: {[round(x, 1) for x in entry_b['step_ms']]} ms/step (tp 1 "
          f"{r1['step_ms']:.1f}); losses {entry_b['losses'][0]} vs tp 1 {r1['losses']}: gap {max(gaps):.3e} (limit "
          f"{limit}); saved boundaries a train_batch {part_b} bytes vs {plain_b} without "
          f"partition_activations (share {[round(x, 3) for x in boundary_share]}); peak "
          f"{[round((x or 0) / 2**30, 3) for x in entry_b['peak_bytes_partitioned']]} GiB vs "
          f"{[round((x or 0) / 2**30, 3) for x in entry_b['peak_bytes_whole']]} GiB without; launches a "
          f"train_batch {entry_b['launches_per_train_batch']}; the state saved here loaded at world 1: next loss "
          f"{resumed:.6f} vs (b)'s {next_losses} (gap {resume_gap:.3e})")
    if not (max(gaps) <= limit and resume_gap <= limit and b_launch_ok
            and all(0.45 <= s <= 0.55 for s in boundary_share)):
        _tpt_fail("(b) failed its checks")
    out["b"] = entry_b
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"tensor_parallel_training": out}))
    return out


# ---------------------------------------------------------------------------
# Phase 29: pipeline parallelism
# ---------------------------------------------------------------------------

PIPE_STAGES = 2
PIPE_MICRO = 4  # micro-batches a train_batch (the config's gradient_accumulation_steps)
PIPE_MB = 2  # rows a micro-batch: the global batch is 8 = 2 x 4
PIPE_STEPS = 2  # timed steps after one warm-up, per schedule; the warm-up's loss is compared too
PIPE_SCHEDULES = ("gpipe", "1f1b")
# each rank's losses against the world-1 plain engine's on the same weights
# and batches, relative, by model: fp32 at the tiny size (the CPU
# rehearsal) sums the gradients in another order only; at GPT-2 width in
# bf16 the stages compute the plain engine's micro-batches, so only the
# gradient sums' order and GPipe's one fused-loss call over every row move
# the loss (PERF.md: the prediction before the first run)
PIPE_LOSS_GAP = {"gpt2": 2e-4, "tiny": 1e-5}
PIPE_TINY = dict(vocab_size=512, max_seq_len=128, num_layers=4, num_heads=4, hidden_size=64, dtype=torch.float32,
                 attn_impl="flash", loss_impl="fused_xent")


def pipe_model(model):
    return gpt2_config(loss_impl="fused_xent") if model == "gpt2" else TransformerConfig(**PIPE_TINY)


def pipe_config(model, schedule, reference=False):
    """The pipelined engine's config over ``pipe`` = 2, or the world-1 plain
    engine's (``reference``): the same micro-batches as gas."""
    ds = dp_config(1, PIPE_MB * PIPE_MICRO, PIPE_MB, PIPE_MICRO, BENCH_DS if model == "gpt2" else DP_TINY_DS)
    if not reference:
        ds.update(mesh={"pipe": PIPE_STAGES}, pipeline={"schedule": schedule})
    return ds


def pipe_params(cfg, stacked=True):
    """The phase's weights (``dp_params``), the layers as [S, K, ...] when
    ``stacked`` (the pipelined model's tree)."""
    params = dp_params(cfg)
    if stacked:
        S = PIPE_STAGES
        params["layers"] = {k: v.reshape((S, v.shape[0] // S) + tuple(v.shape[1:])) for k, v in params["layers"].items()}
    return params


def pipe_reckoning(cfg, cuda) -> dict:
    """What a train_batch should launch and send on each stage, by schedule,
    reckoned from the code before the run (PERF.md). Launches in
    ``counts() + sparse_counts()`` order: every stage runs its K layers'
    flash forward, dK/dV and dQ once a micro-batch (the executed 1F1B's
    forward twice: once in its forward, once in the backward's recompute);
    the last stage alone runs the fused loss: GPipe one call over all M x mb
    rows (one product and one combine; a ds, dW and dH pass a vocab chunk of
    ``fused_xent_backward``'s rule at that row count), 1F1B one call a
    micro-batch. ppermute: GPipe M + S - 2 sends a direction (the last
    tick's has no reader), 1F1B two a tick over 2M + 2S - 2 ticks, each of
    one micro-batch's activation (mb x seq x d in the compute dtype); every
    rank of the axis logs every call."""
    S, M, mb = PIPE_STAGES, PIPE_MICRO, PIPE_MB
    K = cfg.num_layers // S
    seq, V = cfg.max_seq_len, cfg.vocab_size
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    msg = mb * seq * cfg.hidden_size * elt
    out = {}
    for sched in PIPE_SCHEDULES:
        calls, rows = (M, mb * seq) if sched == "1f1b" else (1, M * mb * seq)
        chunks = len(fx.vocab_chunks(V, fx.backward_chunk(rows, V, elt)))
        flash = [(2 if sched == "1f1b" else 1) * K * M, K * M, K * M]
        xent = [calls, calls] + [calls * chunks] * 3
        launches = [(flash + [0] + (xent if s == S - 1 else [0] * 5) + [0] * N_SPARSE) if cuda
                    else [0] * (N_COUNTS + N_SPARSE) for s in range(S)]
        sends = 2 * (2 * M + 2 * S - 2) if sched == "1f1b" else 2 * (M + S - 2)
        out[sched] = {"launches": launches, "ppermute": {"count": sends, "bytes": sends * msg},
                      "fused_loss_rows_a_call": rows, "vocab_chunks": chunks}
    return out


def pipe_worker(args) -> int:
    """``--pipe-worker``: one rank (one stage) of phase 29's world. Joins
    the gloo world through ``--store``, waits for ``--wait-for`` (the card
    to itself), then for each schedule: a ``PipelineEngine`` over a
    ``PipelinedTransformer`` from the phase's weights; under GPipe first the
    wrong-stage control (the last stage's ``wo`` zeroed, the first batch's
    loss); one warm-up and ``PIPE_STEPS`` timed steps with the kernel
    launches and the collectives counted. Appends one JSON record to
    ``--out``."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.pipe import PipelineEngine, PipelinedTransformer

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(init_method=f"file://{args.store}", world_size=world, rank=rank, backend="gloo",
                          timeout_s=600.0)
    deadline = time.monotonic() + 900
    while not os.path.exists(args.wait_for):
        if time.monotonic() > deadline:
            raise SystemExit(f"phase 29: no {args.wait_for} within 900 s")
        time.sleep(0.05)
    cfg = pipe_model(args.model)
    params = pipe_params(cfg)
    rec = {"rank": rank, "world": world, "kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    for sched in PIPE_SCHEDULES:
        engine = PipelineEngine(PipelinedTransformer(cfg, PIPE_STAGES), pipe_config(args.model, sched),
                                params=tree_map(lambda t: t.clone(), params), device=dev)
        entry = {"stage": engine.stage_id, "state_bytes": state_bytes(engine),
                 "bubble": engine.telemetry.registry.snapshot()["gauges"]["train/pipe/bubble_fraction"]}
        if sched == "gpipe":  # the control: the last stage's attention output projections zeroed
            wo = engine.state["params"]["layers"]["wo"]
            keep = wo.clone()
            if engine.stage_id == PIPE_STAGES - 1:
                wo.zero_()
            entry["wrong_stage_loss"] = float(engine.eval_batch(dp_batch(cfg, engine.train_batch_size, 0)))
            wo.copy_(keep)
            del keep
        warm_s, step_ms, losses, per_step, per, peak, ops = dp_steps(engine, cfg, PIPE_STEPS)
        entry.update(warmup_s=warm_s, step_ms=step_ms, losses=losses, launches=per_step, comm_per_step=per,
                     comm_ops=ops, peak_bytes=peak, trace=engine.last_trace)
        rec[sched] = entry
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    comm.destroy_distributed()
    return 0


def _pipe_fail(what):
    raise SystemExit(f"phase 29: {what}")


def pipeline_phase(dev, smi, model="gpt2"):
    """Phase 29. A gloo world of 2 ranks, pipe 2 (``--pipe-worker``
    processes, both on ``dev``), boots first and waits; meanwhile this
    process runs the world-1 plain engine on the same weights and batches
    (micro 2 x gas 4). Then the world runs GPipe and the executed 1F1B.
    Checks, on each rank and schedule: losses within ``PIPE_LOSS_GAP`` of
    world 1's and the wrong-stage control beyond it; each kernel's launches
    a train_batch equal to ``pipe_reckoning`` (none of the fused loss on
    stage 0); the ppermute count and bytes a step as reckoned; the bubble
    gauge (S-1)/(M+S-1); the 1F1B trace's forward clocks ``TrainSchedule``'s."""
    from deepspeed_tpu_torch.pipe import schedule as pipe_schedule
    from deepspeed_tpu_torch.telemetry.collective_ledger import pipeline_bubble_fraction

    cuda = dev.type == "cuda"
    cfg = pipe_model(model)
    t_phase = time.perf_counter()
    limit = PIPE_LOSS_GAP[model]
    reck = pipe_reckoning(cfg, cuda)
    out = {"config": {"model": model, "stages": PIPE_STAGES, "micro_batches": PIPE_MICRO, "micro_rows": PIPE_MB,
                      "steps": PIPE_STEPS, "loss_gap": limit}, "reckoning": reck}
    with tempfile.TemporaryDirectory(prefix="dstt_pipe_") as tmp:
        path, go = os.path.join(tmp, "ranks.jsonl"), os.path.join(tmp, "go")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)), "LOCAL_RANK": "0",
               "WORLD_SIZE": str(PIPE_STAGES)}
        cmd = [sys.executable, os.path.abspath(__file__), "--pipe-worker", "--model", model, "--device", str(dev),
               "--out", path, "--store", os.path.join(tmp, "store"), "--wait-for", go]
        procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r)}) for r in range(PIPE_STAGES)]
        try:
            engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=pipe_config(model, None, reference=True),
                                                    model_parameters=pipe_params(cfg, stacked=False), device=dev)[0]
            warm_s, step_ms, losses, per_step, _, peak, _ = dp_steps(engine, cfg, PIPE_STEPS)
            ref = {"warmup_s": warm_s, "step_ms": step_ms, "losses": losses, "launches": per_step, "peak_bytes": peak}
            del engine
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            with open(go, "w") as f:
                f.write("go\n")
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["ranks_s"] = time.perf_counter() - t_phase
        if any(rcs):
            _pipe_fail(f"a rank failed: exit codes {rcs}")
        ranks = sorted((json.loads(line) for line in open(path)), key=lambda r: r["rank"])
    bubble = pipeline_bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    control = [abs(r["gpipe"]["wrong_stage_loss"] - ref["losses"][0]) / abs(ref["losses"][0]) for r in ranks]
    ok = min(control) > limit
    for sched in PIPE_SCHEDULES:
        want = reck[sched]
        entry = {"step_ms": [], "peak_bytes": [], "losses": [], "loss_gap": [], "launches_per_train_batch": [],
                 "ppermute_per_step": [], "bubble": [], "state_bytes": []}
        for r in ranks:
            e, stage = r[sched], r[sched]["stage"]
            pp = [v for k, v in e["comm_ops"].items() if k.startswith("ppermute@")]
            sent = {"count": sum(v["count"] for v in pp) / PIPE_STEPS, "bytes": sum(v["bytes"] for v in pp) / PIPE_STEPS}
            gap = rel_gap(e["losses"], ref["losses"])
            launch_ok = all(step == want["launches"][stage] for step in e["launches"])
            for k, v in (("step_ms", e["step_ms"]), ("peak_bytes", e["peak_bytes"]), ("losses", e["losses"]),
                         ("loss_gap", gap), ("launches_per_train_batch", e["launches"][0]),
                         ("ppermute_per_step", sent), ("bubble", e["bubble"]), ("state_bytes", e["state_bytes"])):
                entry[k].append(v)
            ok = ok and gap <= limit and launch_ok and sent == want["ppermute"] and abs(e["bubble"] - bubble) < 1e-12
            if sched == "1f1b":
                clocks = [t for t, f in enumerate(e["trace"][0]) if f]
                steps = pipe_schedule.TrainSchedule(PIPE_MICRO, PIPE_STAGES, stage).steps()
                ok = ok and clocks == [t for t, st in enumerate(steps)
                                       if any(isinstance(c, pipe_schedule.ForwardPass) for c in st)]
        out[sched] = entry
        print(f"  [{smi}] {sched}: pipe {PIPE_STAGES} ({cfg.num_layers // PIPE_STAGES} layers a stage, batch "
              f"{PIPE_MB * PIPE_MICRO} = micro {PIPE_MB} x {PIPE_MICRO}): "
              f"{[round(x, 1) for x in entry['step_ms']]} ms/step a rank (world-1 plain engine {ref['step_ms']:.1f}), "
              f"peak {[round((x or 0) / 2**30, 3) for x in entry['peak_bytes']]} GiB (world 1 "
              f"{(ref['peak_bytes'] or 0) / 2**30:.3f}); losses {entry['losses'][0]} vs world 1 {ref['losses']}: gap "
              f"{max(entry['loss_gap']):.3e} (limit {limit}); launches a train_batch {COUNT_LABEL} by stage "
              f"{entry['launches_per_train_batch']} (reckoned {want['launches']}); ppermute a step "
              f"{entry['ppermute_per_step']} (reckoned {want['ppermute']}); bubble gauge {entry['bubble']} "
              f"(expect {bubble})")
    out["world1"] = ref
    out["wrong_stage_gap"] = control
    print(f"  [{smi}] wrong-stage control (the last stage's wo zeroed): gap {control} (must exceed {limit})")
    if not ok:
        _pipe_fail("a check failed (losses, the control, launches, ppermute bytes, the bubble or the 1F1B clocks)")
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"pipeline": out}))
    return out


# ---------------------------------------------------------------------------
# Phase 30: mixture of experts on one rank (moe/: GShard gating, the slot-
# table dispatch, the expert bank) through initialize -> train_batch and
# init_inference -> generate at 125M-MoE-64 widths
# ---------------------------------------------------------------------------

MOE_SEED = 3000
MOE_ROWS = 8  # one micro-batch of 8 rows: T = 8 x 1024 tokens gated at once
MOE_STEPS = 2  # timed train_batch calls after the warm-up
MOE_PROMPT, MOE_NEW = 128, 64
# the bf16 kernel path's first loss (flash, fused loss) against the fp32
# plain path's (plain attention, chunked loss) on the same weights and
# batch, relative, by model. At the initial weights the MoE branch moves
# the loss little (76% of step 0's tokens dropped, the kept ones scaled by
# a gate near 1/64): on an H100 the gap read 5.685e-5 and the control (the
# first MoE layer's experts.wo zeroed) 1.131e-4, both the same in every
# run; the limit sits between them, and ``moe_layer_check`` holds the MoE
# layer itself with a control far outside (PERF.md)
MOE_LOSS_GAP = {"gpt2": 8e-5, "tiny": 1e-5}
MOE_TINY = dict(vocab_size=512, max_seq_len=256, num_layers=4, num_heads=4, hidden_size=64, dtype=torch.float32,
                attn_impl="flash", loss_impl="fused_xent", moe_every=2, num_experts=8, moe_capacity_factor=1.0)


def moe_model(model, **kw):
    """GPT-3 125M widths with 64 experts on every other layer (Megatron-
    DeepSpeed examples_deepspeed/MoE/ds_pretrain_gpt_125M_MoE64.sh: top-1,
    capacity factor 1.0, min capacity 4, aux coefficient 0.01), bf16, flash
    attention, the fused loss; or the CPU rehearsal's tiny model."""
    if model == "gpt2":
        cfg = gpt2_config(loss_impl="fused_xent", moe_every=2, num_experts=64, moe_top_k=1, moe_capacity_factor=1.0,
                          moe_aux_coeff=0.01)
    else:
        cfg = TransformerConfig(**MOE_TINY)
    return cfg.replace(**kw)


def moe_config(model):
    base = BENCH_DS if model == "gpt2" else DP_TINY_DS
    return {**base, "train_batch_size": MOE_ROWS, "train_micro_batch_size_per_gpu": MOE_ROWS,
            "gradient_accumulation_steps": 1, "zero_optimization": {"stage": 1}}


def moe_params(cfg, dev):
    """The phase's weights, drawn on ``dev`` from one seeded generator: the
    same tensors each call."""
    return tfm.init(cfg, torch.Generator(device=dev).manual_seed(MOE_SEED), dev)


def moe_batch(cfg, step):
    rng = np.random.default_rng(MOE_SEED + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(MOE_ROWS, cfg.max_seq_len + 1)).astype(np.int32)}


def moe_reckoning(cfg, P, cuda) -> dict:
    """Reckoned from the code before the run (PERF.md). Launches a
    train_batch in ``counts() + sparse_counts()`` order: each of the 12
    layers' flash forward, dK/dV and dQ once (no remat, one micro-batch),
    the fused loss's product and combine once, and a ds, dW and dH pass a
    vocab chunk of ``fused_xent_backward``'s rule at 8 x 1024 rows; decode
    per generate: the split and the combine kernel once a layer a decode
    step. State bytes: the fp32 masters (4 B a parameter), Adam's two fp32
    moments (8), the fp32 gradients (4) and the bf16 compute copy (2). The
    dense decode route reads every expert's two matrices a step."""
    L, elt = cfg.num_layers, torch.empty((), dtype=cfg.dtype).element_size()
    rows = MOE_ROWS * cfg.max_seq_len
    chunks = len(fx.vocab_chunks(cfg.vocab_size, fx.backward_chunk(rows, cfg.vocab_size, elt)))
    launches = ([L] * 3 + [0] + [1, 1] + [chunks] * 3 + [0] * N_SPARSE) if cuda else [0] * (N_COUNTS + N_SPARSE)
    n_moe = L // cfg.moe_every
    expert_bytes = n_moe * cfg.num_experts * 2 * cfg.hidden_size * cfg.ffn_size * elt
    return {"launches": launches, "vocab_chunks": chunks, "state_bytes": 18 * P,
            "decode_launches": [(MOE_NEW - 1) * L] * 2 if cuda else [0, 0],
            "decode_expert_bytes": expert_bytes, "decode_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "capacity": max(int(rows * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.num_experts), 4)}


class RouteRecorder:
    """Records each capacity-path gating's (dropped choices, choices,
    capacity) and its ``Route`` while it is entered."""

    def __enter__(self):
        from deepspeed_tpu_torch.moe import sharded_moe

        self.seen, self.routes, self.module, plain = [], [], sharded_moe, sharded_moe.route

        def route(*a, **k):
            r, aux, C = plain(*a, **k)
            self.seen.append(((~r.kept).sum(), r.kept.numel(), C))
            # detached: the weights' graph would keep every autograd
            # function's context of the step alive past its backward
            self.routes.append(type(r)(*(t.detach() for t in r)))
            return r, aux, C

        self.plain, sharded_moe.route = plain, route
        return self

    def __exit__(self, *exc):
        self.module.route = self.plain

    def drop_share(self) -> float:
        return float(sum(int(d) for d, _, _ in self.seen)) / max(1, sum(n for _, n, _ in self.seen))


def _moe_fail(what):
    raise SystemExit(f"phase 30: {what}")


def moe_layer_check(dev, smi, cfg, params) -> dict:
    """The first MoE layer at the phase's shapes (8 x 1024 unit-normal
    tokens, 64 experts, capacity 128) in the compute dtype against fp32 on
    the same input and the same (rounded) weights: the routing equal (the
    capacity path's logits are fp32 products of the same values in both),
    the output within ``TOL`` of the fp32 output's largest magnitude, and
    with ``experts.wo`` zeroed far outside it."""
    from deepspeed_tpu_torch.moe import layer as moe_layer

    g = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    h = torch.randn(MOE_ROWS, cfg.max_seq_len, cfg.hidden_size, generator=g, device=dev).to(cfg.dtype)
    first = tree_map(lambda t: t[0].to(cfg.dtype), params["moe"])
    outs = {}
    with torch.no_grad():
        for name, p, x, c in (("low", first, h, cfg),
                              ("fp32", tree_map(lambda t: t.float(), first), h.float(), cfg.replace(dtype=torch.float32)),
                              ("control", {**first, "experts": {**first["experts"],
                                                                "wo": torch.zeros_like(first["experts"]["wo"])}}, h, cfg)):
            with RouteRecorder() as rec:
                outs[name] = (moe_layer.moe_ffn_apply(c, p, x)[0].float(), rec.routes[0])
    ref, r32 = outs["fp32"]
    scale = float(ref.abs().max())
    same = all(torch.equal(a, b) for a, b in zip(outs["low"][1][:3], r32[:3]))
    err = float((outs["low"][0] - ref).abs().max()) / scale
    control = float((outs["control"][0] - ref).abs().max()) / scale
    tol = TOL[cfg.dtype]
    kept = int(r32.kept.sum())
    print(f"  [{smi}] (a) the first MoE layer, {MOE_ROWS} x {cfg.max_seq_len} unit-normal tokens, {cfg.dtype} against "
          f"fp32 on the same weights: routing {'equal' if same else 'DIFFERS'} ({kept} of {r32.kept.numel()} kept), "
          f"max abs err {err:.3e} of the output's largest magnitude (limit {tol}); experts.wo zeroed: {control:.3e}")
    if not (same and err <= tol and control > 10 * tol):
        _moe_fail("(a) the MoE layer against fp32: routing, value or control")
    return {"routing_equal": same, "kept": kept, "rel_err": err, "control_rel_err": control, "tol": tol}


def moe_generate(dev, smi, cfg, params, reck, cuda):
    """(b): fp32 greedy tokens through the decode kernel against the plain
    cached attention's; the bf16 engine's first decode step's logits against
    fp32's; bf16 decode ms a step and the decode kernel's launches."""
    prompt = np.random.default_rng(MOE_SEED - 1).integers(0, cfg.vocab_size, size=(MOE_ROWS, MOE_PROMPT))
    f32 = cfg.replace(dtype=torch.float32)
    kernel = deepspeed_tpu_torch.init_inference(Model(f32), config={"dtype": "fp32"}, params=params, device=dev)
    plain = deepspeed_tpu_torch.init_inference(Model(f32.replace(decode_attn="xla")), config={"dtype": "fp32"},
                                               params=params, device=dev)
    toks = kernel.generate(prompt, max_new_tokens=MOE_NEW)
    toks_plain = plain.generate(prompt, max_new_tokens=MOE_NEW)
    same = bool((toks == toks_plain).all())
    bf16 = deepspeed_tpu_torch.init_inference(Model(cfg.replace(dtype=torch.bfloat16)), config={"dtype": "bf16"},
                                              params=params, device=dev)

    def first_step_logits(eng):
        with torch.inference_mode():
            p = torch.as_tensor(prompt, dtype=torch.long, device=dev)
            cache = tfm.init_cache(eng.cfg, MOE_ROWS, MOE_PROMPT + 128, device=dev)
            tfm.apply_with_cache(eng.cfg, eng.params, p, cache, 0, last_only=True)
            nxt = torch.as_tensor(toks[:, :1], dtype=torch.long, device=dev)
            return tfm.apply_with_cache(eng.cfg, eng.params, nxt, cache, MOE_PROMPT)[0][:, 0]

    gap = float((first_step_logits(bf16) - first_step_logits(kernel)).abs().max())
    del kernel, plain
    bf16.generate(prompt, max_new_tokens=2)  # warm-up
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    bf16.generate(prompt, max_new_tokens=1)
    sync()
    t_prefill = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    out = bf16.generate(prompt, max_new_tokens=MOE_NEW)
    sync()
    t_all = time.perf_counter() - t0
    launches = [decode_attention.launches, decode_attention.combine_launches]
    step_ms = (t_all - t_prefill) / (MOE_NEW - 1) * 1e3
    res = {"fp32_tokens_equal_plain": same, "bf16_first_step_logit_gap": gap, "decode_ms_per_step": step_ms,
           "prefill_ms": t_prefill * 1e3, "decode_launches": launches,
           "decode_expert_gb_per_step": reck["decode_expert_bytes"] / 1e9,
           "decode_bound_ms": reck["decode_bound_ms"], "finite": bool(np.isfinite(out).all())}
    print(f"  [{smi}] (b) generate {MOE_ROWS} x {MOE_PROMPT}-token prompts, {MOE_NEW} new: fp32 greedy tokens "
          f"through the decode kernel {'equal' if same else 'DIFFER FROM'} the plain path's; bf16 first decode "
          f"step's logits within {gap:.3e} of fp32's; bf16 decode {step_ms:.3f} ms/step (prefill "
          f"{t_prefill * 1e3:.1f} ms) beside the dense route's {reck['decode_expert_bytes'] / 1e9:.2f} GB of "
          f"experts a step (>= {reck['decode_bound_ms']:.3f} ms at 3.35 TB/s); decode launches [split, combine] "
          f"{launches} (reckoned {reck['decode_launches']})")
    del bf16
    return res


def moe_phase(dev, smi, model="gpt2"):
    """Phase 30. (a) the first MoE layer against fp32 (``moe_layer_check``);
    initialize -> train_batch of the MoE model at ZeRO 1,
    world 1, one micro-batch of 8 rows: the fp32 plain path's loss and the
    bf16 kernel path's first loss on the same weights and batch within
    ``MOE_LOSS_GAP`` and one MoE layer's experts.wo zeroed beyond it; the
    warm-up's dropped share; ``MOE_STEPS`` timed steps with each kernel's
    launches against ``moe_reckoning``; the first step from the same
    weights in a second engine bitwise equal (loss, masters, moments).
    (b) init_inference -> generate (``moe_generate``)."""
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    # earlier phases' engines hold reference cycles (their telemetry): free
    # them first, for the update's peak (about 65 GiB) needs the card
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    leftover = torch.cuda.memory_allocated() if cuda else None
    cfg = moe_model(model)
    limit = MOE_LOSS_GAP[model]
    params = moe_params(cfg, dev)
    P = sum(t.numel() for t in tree_leaves(params))
    P_experts = sum(t.numel() for t in tree_leaves(params["moe"]["experts"]))
    reck = moe_reckoning(cfg, P, cuda)
    out = {"card": smi, "params": P, "expert_params": P_experts, "reckoning": reck, "loss_gap_limit": limit,
           "entry_allocated_bytes": leftover}
    batch0 = moe_batch(cfg, 0)
    with torch.no_grad():
        plain = cfg.replace(dtype=torch.float32, attn_impl="xla", loss_impl="chunked")
        ref = float(tfm.causal_lm_loss(plain, params, {"tokens": torch.as_tensor(batch0["tokens"], device=dev)}))
    out["layer"] = moe_layer_check(dev, smi, cfg, params)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = deepspeed_tpu_torch.initialize(model=Model(cfg), config=moe_config(model), model_parameters=params,
                                            device=dev)[0]
    del params
    wo = engine.state["params"]["moe"]["experts"]["wo"][0]
    keep = wo.clone()
    wo.zero_()
    control = abs(engine.eval_batch(batch0) - ref) / abs(ref)
    wo.copy_(keep)
    del keep, wo
    with RouteRecorder() as routes:
        t0 = time.perf_counter()
        m0 = engine.train_batch(batch0)
        loss0 = float(m0["loss"])
        warm_s = time.perf_counter() - t0
    digest0 = gathered_state_digest(engine)
    gap = abs(loss0 - ref) / abs(ref)
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    per_step, losses = [], [loss0]
    t0 = time.perf_counter()
    for step in range(1, MOE_STEPS + 1):
        before = counts() + sparse_counts()
        losses.append(float(engine.train_batch(moe_batch(cfg, step))["loss"]))
        per_step.append([a - b for a, b in zip(counts() + sparse_counts(), before)])
    if cuda:
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_STEPS  # the float() of each loss waits for its step
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the same first step again, in a second engine from the same weights
    again = deepspeed_tpu_torch.initialize(model=Model(cfg), config=moe_config(model),
                                           model_parameters=moe_params(cfg, dev), device=dev)[0]
    loss0_again = float(again.train_batch(batch0)["loss"])
    # the CPU's index backward (the embeddings' gradients) sums a row's
    # duplicates in no fixed order above a few hundred tokens: the CPU
    # rehearsal holds the loss alone
    bitwise = loss0_again == loss0 and (gathered_state_digest(again) == digest0 or not cuda)
    del again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tok_s = MOE_ROWS * cfg.max_seq_len / step_s
    launch_ok = all(s == reck["launches"] for s in per_step)
    a = {"step_ms": step_s * 1e3, "tokens_per_s": tok_s, "warmup_s": warm_s, "losses": losses,
         "fp32_plain_loss": ref, "loss_gap": gap, "control_gap": control, "dropped_share_step0": routes.drop_share(),
         "capacity": routes.seen[0][2] if routes.seen else None, "moe_calls_step0": len(routes.seen),
         "launches_per_train_batch": per_step, "peak_gib": None if peak is None else peak / 2**30,
         "reckoned_state_gib": reck["state_bytes"] / 2**30, "bitwise_rerun": bitwise}
    out["a"] = a
    print(f"  [{smi}] (a) {P / 1e9:.3f} B parameters ({P_experts / 1e9:.3f} B of them experts), ZeRO 1, batch "
          f"{MOE_ROWS} x {cfg.max_seq_len}: {a['step_ms']:.1f} ms/step, {tok_s:.0f} tokens/s, peak "
          f"{a['peak_gib']} GiB (state reckoned {a['reckoned_state_gib']:.2f} GiB before activations; earlier "
          f"phases' leftovers {(leftover or 0) / 2**30:.2f} GiB at entry); step 0 "
          f"dropped {a['dropped_share_step0']:.4f} of its tokens over {a['moe_calls_step0']} MoE layers at capacity "
          f"{a['capacity']} (reckoned {reck['capacity']}); launches a train_batch {COUNT_LABEL} {per_step} "
          f"(reckoned {reck['launches']}); losses {[round(x, 5) for x in losses]}")
    print(f"  [{smi}] (a) the bf16 kernel path's first loss {loss0:.6f} vs the fp32 plain path's {ref:.6f}: gap "
          f"{gap:.3e} (limit {limit}); one MoE layer's experts.wo zeroed: {control:.3e} (must exceed the limit); "
          f"the first step again from the same weights: loss and fp32 state {'bitwise equal' if bitwise else 'DIFFER'}")
    ok = (launch_ok and bitwise and gap <= limit and control > limit and all(np.isfinite(losses))
          and len(routes.seen) == cfg.num_layers // cfg.moe_every and routes.seen[0][2] == reck["capacity"])
    if not ok:
        _moe_fail("(a) a check failed (launches, the bitwise rerun, the loss gap, the control or the routing)")
    b = moe_generate(dev, smi, cfg, moe_params(cfg, dev), reck, cuda)
    out["b"] = b
    if not (b["fp32_tokens_equal_plain"] and b["decode_launches"] == reck["decode_launches"] and b["finite"]):
        _moe_fail("(b) a check failed (fp32 tokens against the plain path's, or the decode launches)")
    if cuda:
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"moe": out}))
    return out


def cache_bytecode() -> str:
    """Let this process and the ones it starts (serving workers, training
    generations, ranks) cache the bytecode they compile, under
    build/pycache in the checkout: where the environment sets
    PYTHONDONTWRITEBYTECODE and the installed packages hold no bytecode,
    every process otherwise compiles torch's Python sources afresh (~9 s of
    a process's boot on the card's host). Returns the directory."""
    where = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = where
    sys.dont_write_bytecode = False
    sys.pycache_prefix = where
    return where


_PHASE_T0 = [0.0]


def phase_done(n) -> float:
    """Print ``phase N: S s`` for the phase that ends now (since the last
    call) and start the next one's clock."""
    now = time.perf_counter()
    seconds = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
    print(f"  phase {n}: {seconds:.1f} s")
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace a short generate and a train_batch into DIR")
    # phase 23's training process (chip_smoke.py is its own worker)
    ap.add_argument("--elastic-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--model", default="gpt2", choices=("gpt2", "tiny"), help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=6, help=argparse.SUPPRESS)
    ap.add_argument("--save-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.devnull, help=argparse.SUPPRESS)
    ap.add_argument("--crash-after", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--hang-after", type=int, default=0, help=argparse.SUPPRESS)
    # phase 26's ranks
    ap.add_argument("--dp-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    # phase 27's ranks
    ap.add_argument("--tp-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tp-serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--wait-for", default="", help=argparse.SUPPRESS)
    # phase 28's ranks
    ap.add_argument("--tp-train-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tpt-case", default="a", choices=tuple(TPT_CASES), help=argparse.SUPPRESS)
    # phase 29's ranks
    ap.add_argument("--pipe-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.elastic_worker:
        return elastic_worker(args)
    if args.dp_worker:
        return dp_worker(args)
    if args.tp_worker:
        return tp_worker(args)
    if args.tp_train_worker:
        return tp_train_worker(args)
    if args.pipe_worker:
        return pipe_worker(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU", file=sys.stderr)
        return 1
    cache_bytecode()
    dev = torch.device("cuda", 0)
    # full-fp32 matmuls in the plain versions the kernel is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _PHASE_T0[0] = T_START = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    phase_done(1)
    t0 = time.perf_counter()
    op_builder.build_many(KERNEL_SOURCES)
    op_builder.load("decode_attention")
    print(f"[2] built {', '.join(KERNEL_SOURCES)} (one nvcc each, in parallel) in "
          f"{time.perf_counter() - t0:.2f} s")

    phase_done(2)
    print("[3] decode_attention kernels vs plain; their registers and spills (ptxas):")
    decode_regs = decode_registers()
    errs = kernel_checks(dev)
    times = kernel_timing(dev)

    phase_done(3)
    print("[4] serving: init_inference -> generate at GPT-2-125M width")
    launches, engine, prompt = serve(dev)
    if args.profile:
        profile(f"generate(max_new_tokens={PROFILE_NEW})",
                lambda: engine.generate(prompt, max_new_tokens=PROFILE_NEW), args.profile)
    del engine
    torch.cuda.empty_cache()

    phase_done(4)
    t0 = time.perf_counter()
    op_builder.load("flash_attention")
    print(f"[5] loaded flash_attention (forward, dK/dV, dQ) in {time.perf_counter() - t0:.2f} s; "
          f"its kernels' SASS (cuobjdump) and registers (ptxas):")
    sass = sass_report("flash_attention", kernel_label, MAIN_PATH_KERNEL.values())
    print("  the fused loss's mainloop (csrc/fused_xent.cu: the forward and the backward), each epilogue and "
          "operand layout:")
    xent_sass = sass_report("fused_xent", xent_label, XENT_MAIN_PATH.values())

    phase_done(5)
    print("[6] flash kernels vs plain")
    flash_errs = flash_checks(dev)
    flash_times = flash_timing(dev)
    torch.cuda.empty_cache()

    phase_done(6)
    print("[7] training: initialize -> train_batch at GPT-2-125M width")
    flash_launches, training, trainer, batch = train(dev)
    if args.profile:
        profile("train_batch", lambda: trainer.train_batch(batch), args.profile)
    del trainer
    torch.cuda.empty_cache()

    phase_done(7)
    print("[8] slice parity: flash kernels vs plain attention")
    training["parity"] = train_parity(dev)
    torch.cuda.empty_cache()

    phase_done(8)
    t0 = time.perf_counter()
    op_builder.load("fused_xent")
    print(f"[9] loaded fused_xent (forward: product and combine; backward: ds, dW, dH) in "
          f"{time.perf_counter() - t0:.2f} s; the forward's product instance {XENT_MAIN_PATH['fwd']}: HGMMA "
          f"{xent_sass[XENT_MAIN_PATH['fwd']]['hgmma']}; fused-loss kernels vs plain")
    xent_errs = xent_checks(dev)
    xent_times = xent_timing(dev)
    torch.cuda.empty_cache()

    phase_done(9)
    print("[10] training: the fused loss under dots_and_flash remat at GPT-2-125M width")
    xent_launches, training["fused_remat"], trainer, batch = train_fused(dev, no_remat=bool(args.profile))
    if args.profile:
        profile("train_batch_fused_remat", lambda: trainer.train_batch(batch), args.profile)

    phase_done(10)
    print("[11] slice parity: the fused loss vs the chunked loss")
    training["fused_remat"]["parity"] = fused_parity(dev)
    torch.cuda.empty_cache()

    phase_done(11)
    print("[12] checkpoint and resume")
    training["checkpoint"] = checkpoint_resume(dev, trainer, batch)
    del trainer
    torch.cuda.empty_cache()

    phase_done(12)
    t0 = time.perf_counter()
    op_builder.load("sparse_attention")
    print(f"[13] loaded sparse_attention (forward, dQ, dK/dV) in "
          f"{time.perf_counter() - t0:.2f} s; its kernels' SASS (cuobjdump) and registers (ptxas):")
    sparse_sass = sass_report("sparse_attention", sparse_label, SPARSE_MAIN_PATH.values())

    phase_done(13)
    print("[14] sparse kernels vs plain")
    sparse_errs = sparse_checks(dev)
    sparse_times = sparse_timing(dev, "fixed-64 (the slice's layout)", slice_layout())
    name, kw = BIGBIRD_128
    bigbird_times = sparse_timing(dev, "bigbird-128 (benchmarks/sparse_attention_bench.py)",
                                  SPARSITY_CONFIGS[name](num_heads=12, **kw).make_layout(SS))

    phase_done(14)
    print(f"[15] long-sequence training: initialize -> train_batch at GPT-2-125M width, S={SS}, sparse attention")
    sparse_launches, training["sparse"], sparse_batch = train_sparse(dev)
    if args.profile:
        engine = deepspeed_tpu_torch.initialize(model=Model(gpt2_config(max_seq_len=SS)), config=SPARSE_TRAIN_DS)[0]
        engine.train_batch(sparse_batch)
        profile("train_batch_sparse", lambda: engine.train_batch(sparse_batch), args.profile)
        del engine
        torch.cuda.empty_cache()

    phase_done(15)
    print("[16] slice parity: sparse kernels vs their plain versions")
    training["sparse"]["parity"] = sparse_parity(dev)
    torch.cuda.empty_cache()

    phase_done(16)
    print("[17] the curriculum and the dataloader through save and resume")
    training["curriculum"] = curriculum_resume(dev)
    torch.cuda.empty_cache()

    phase_done(17)
    print("[18] serving engine: ServingEngine over init_inference at GPT-2-125M width, the decode step one CUDA graph")
    serving_launches = serve_engine_phase(dev, smi, args.profile)
    torch.cuda.empty_cache()

    phase_done(18)
    print("[19] training resilience at GPT-2-125M width: NaN skip, rewind, preemption, write faults, async "
          "save, the 3-call loop, save_16bit_model, the CSV monitor")
    resilience = resilience_phase(dev, smi)
    torch.cuda.empty_cache()

    phase_done(19)
    print(f"[20] serving fleet: Router over {FLEET_REPLICAS} in-process replicas (unfaulted, then replica 0 killed "
          f"at router step {KILL_STEP}), the journal's crash drill, {FLEET_REPLICAS} worker processes under a "
          f"WorkerSupervisor (SIGKILL, respawn, SIGTERM drain), at GPT-2-125M width")
    fleet = fleet_phase(dev, smi, ahead={"gateway": gateway_worker_plan(SERVE_CONFIG),
                                        "disagg": disagg_worker_plan(SERVE_CONFIG)})
    torch.cuda.empty_cache()

    phase_done(20)
    print(f"[21] the fleet's front door and membership at GPT-2-125M width: {FLEET_REPLICAS} in-process replicas "
          f"behind the HTTP/SSE gateway (workload (b) blocking and streamed, disconnects, a rolling upgrade under "
          f"traffic), the autoscaler under the surge trace with a replica killed, {FLEET_REPLICAS} worker processes "
          f"over TCP (SIGKILL, respawn, a set_spec rolling upgrade)")
    gateway = gateway_phase(dev, smi)
    torch.cuda.empty_cache()

    phase_done(21)
    print(f"[22] disaggregated prefill/decode serving at GPT-2-125M width with the flight recorder on: 2 co-located "
          f"against 1 prefill + 1 decode in-process replicas (workloads (a) and (b)), the int8 wire, 2 prefill + 1 "
          f"decode worker processes over TCP with a prefill SIGKILLed mid-handoff, per-pool autoscaling under the "
          f"surge trace, the SLO tracker and the rings")
    disagg = disagg_phase(dev, smi)
    torch.cuda.empty_cache()

    phase_done(22)
    print("[23] the launch stack, elastic training and the chaos conductor at GPT-2-125M width: the runner -> "
          "launch -> a training worker (and SIGTERM to a second launch), DSElasticAgent's crash and hang drills "
          f"resuming bitwise, {CHAOS_SCHEDULES} chaos schedules twice over 3 real ServingEngine replicas, a "
          "64-schedule fake-fleet search shrunk and replayed")
    p23 = elastic_chaos_phase(dev, smi)
    _PHASE_T0[0] = time.perf_counter()
    torch.cuda.empty_cache()

    print("[24] the memory tiers: ZeRO-Offload to pinned host memory and to NVMe, per-layer parameter streaming "
          "at GPT-2-125M width against no offload, then one step of GPT-3 6.7B widths, whose 16 bytes a "
          "parameter the card cannot hold")
    t0 = time.perf_counter()
    tiers = memory_tiers_phase(dev, smi)
    tiers["phase_s"] = time.perf_counter() - t0
    training["memory_tiers"] = tiers
    print(f"  phase 24: {tiers['phase_s']:.1f} s")
    tier_launches = {"a_cpu": tiers["a"]["cpu"]["launches_per_train_batch"],
                     "b_offload_param": tiers["b"]["launches_per_train_batch"],
                     "c_nvme": tiers["c"]["launches_per_train_batch"],
                     "d_gpt3_6.7b": tiers["d"]["launches_per_train_batch"]}

    print("[25] profiling: the program ledger, the flops profiler, wall-clock and memory breakdowns at GPT-2-125M "
          "width (phases 7 and 10 with the JAX package's default telemetry, phase 18's serving engine), the "
          "report CLI and env_report")
    t0 = time.perf_counter()
    prof = profiling_phase(dev, smi)
    prof["phase_s"] = time.perf_counter() - t0
    print(f"  phase 25: {prof['phase_s']:.1f} s")
    print(json.dumps({"profiling": prof}))

    print("[26] data parallelism: phase 7's configuration under ZeRO 0-3 in a world of 1 under NCCL (the real "
          "communicator), then a world of 2 under gloo with both ranks on the card (ZeRO 1 and 3) against a world "
          "of 1 on the same global batches, and the world-2 ZeRO-3 checkpoint resumed at world 1")
    t0 = time.perf_counter()
    zero = data_parallel_phase(dev, smi)
    zero["phase_s"] = time.perf_counter() - t0
    print(f"  phase 26: {zero['phase_s']:.1f} s")
    _PHASE_T0[0] = time.perf_counter()

    print(f"[27] tensor-parallel serving at GPT-2-125M width: init_inference -> generate at tp 1, 2 and 4 (fp32 "
          f"and bf16; gloo ranks sharing the card, {TP_B} x {TP_PROMPT}-token prompts, {TP_NEW} new tokens), then "
          f"the ServingEngine at tp 1 and tp {TP_SIZES[0]} (the driver and its follower) over the first "
          f"{TP_SERVE_REQUESTS} requests of workload (a)")
    tpar = tensor_parallel_phase(dev, smi)
    phase_done(27)

    print(f"[28] tensor-parallel training at GPT-2-125M width: (a) tp 2 (ZeRO 1, batch 8) and (b) data 2 x model 2 "
          f"(ZeRO 3, {TPT_REMAT['policy']} remat, partition_activations, batch 16), gloo ranks sharing the card, "
          f"against tp 1 on the same global batches; (b)'s state resumed at world 1")
    tpt = tensor_parallel_training_phase(dev, smi)
    phase_done(28)
    training["tensor_parallel"] = tpt
    tpt_launches = {**{f"a_rank{r}": v for r, v in enumerate(tpt["a"]["launches_per_train_batch"])},
                    **{f"b_rank{r}": v for r, v in enumerate(tpt["b"]["launches_per_train_batch"])}}

    print(f"[29] pipeline parallelism at GPT-2-125M width: pipe {PIPE_STAGES} ({12 // PIPE_STAGES} layers a stage), "
          f"GPipe and the executed 1F1B, batch {PIPE_MB * PIPE_MICRO} = micro {PIPE_MB} x {PIPE_MICRO} micro-batches, "
          f"the fused loss on the last stage, gloo ranks sharing the card, against a world-1 plain engine on the same "
          f"weights and batches")
    pipe = pipeline_phase(dev, smi)
    phase_done(29)
    training["pipeline"] = pipe

    print(f"[30] mixture of experts on one rank at 125M-MoE-64 widths (12 layers, d768, 64 experts on every other "
          f"layer, top-1, capacity factor 1.0): (a) initialize -> train_batch at ZeRO 1, batch {MOE_ROWS} x 1024, "
          f"against the fp32 plain path, a zeroed expert bank and a rerun of the first step; (b) init_inference -> "
          f"generate, {MOE_ROWS} x {MOE_PROMPT}-token prompts, {MOE_NEW} new tokens")
    moe = moe_phase(dev, smi)
    phase_done(30)
    training["moe"] = moe
    moe_launches = moe["a"]["launches_per_train_batch"][0]
    pipe_launches = {f"{sched}_stage{r}": v for sched in PIPE_SCHEDULES
                     for r, v in enumerate(pipe[sched]["launches_per_train_batch"])}
    print(json.dumps({"zero": zero}))
    dp_launches = {**{f"world1_stage{s}": zero["a"][f"stage{s}"]["launches_per_train_batch"][0] for s in range(4)},
                   **{f"world2_stage{s}_rank{r}": zero["b"][f"stage{s}"]["ranks"][r]["launches"][0]
                      for s in (1, 3) for r in range(2)}}

    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:54",
        "launches": launches[0], "combine_launches": launches[1],
        "serving_launches": serving_launches[0], "serving_combine_launches": serving_launches[1],
        "fleet_inprocess_launches": fleet["inprocess"], "fleet_worker_launches": fleet["workers"],
        "gateway_inprocess_launches": gateway["inprocess"], "gateway_surge_replays": gateway["surge_replays"],
        "gateway_worker_launches": gateway["workers"],
        "disagg_decode_replica_launches": disagg["decode_replicas"],
        "disagg_prefill_replica_launches": disagg["prefill_replicas"],
        "disagg_worker_launches": disagg["workers"],
        "chaos_launches": p23["decode"][0], "chaos_combine_launches": p23["decode"][1],
        "data_parallel_launches_per_train_batch": {k: v[3] for k, v in dp_launches.items()},
        "tensor_parallel_training_launches_per_train_batch": {k: v[3] for k, v in tpt_launches.items()},
        "tensor_parallel_launches_per_generate": {f"tp{tp}": tpar[f"tp{tp}"]["launches_per_generate"]
                                                  for tp in TP_SIZES},
        "tensor_parallel_serving_launches_per_step": tpar["serve"]["launches_per_step"],
        "tensor_parallel_serving_launches": tpar["serve"]["launches"],
        "moe_launches_per_generate": {"split": moe["b"]["decode_launches"][0],
                                      "combine": moe["b"]["decode_launches"][1]},
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
            "elastic_worker_launches": p23["flash"][list(replaces).index(name)],
            "memory_tiers_launches_per_train_batch": {k: v[list(replaces).index(name)]
                                                      for k, v in tier_launches.items()},
            "data_parallel_launches_per_train_batch": {k: v[list(replaces).index(name)]
                                                       for k, v in dp_launches.items()},
            "tensor_parallel_training_launches_per_train_batch": {k: v[list(replaces).index(name)]
                                                                  for k, v in tpt_launches.items()},
            "pipeline_launches_per_train_batch": {k: v[list(replaces).index(name)] for k, v in pipe_launches.items()},
            "moe_launches_per_train_batch": moe_launches[list(replaces).index(name)],
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
        r19, w23 = resilience["launches"], p23["xent"]  # w23: product, combine, ds, dW, dH
        entry["elastic_worker_launches"] = (
            {"product": w23[0], "combine": w23[1]} if name == "fused_xent_forward"
            else {"ds": w23[2], "dH" if name == "fused_xent_backward_dh" else "dW": w23[4 if name.endswith("dh") else 3]})
        entry["resilience_launches"] = (
            {"product": r19[4], "combine": r19[5]} if name == "fused_xent_forward"
            else {"ds": r19[6], "dH" if name == "fused_xent_backward_dh" else "dW": r19[8 if name.endswith("dh") else 7]})
        entry["data_parallel_launches_per_train_batch"] = {  # phase 26 runs the chunked loss: all 0
            k: ({"product": v[4], "combine": v[5]} if name == "fused_xent_forward"
                else {"ds": v[6], "dH" if name == "fused_xent_backward_dh" else "dW": v[8 if name.endswith("dh") else 7]})
            for k, v in dp_launches.items()}
        entry["tensor_parallel_training_launches_per_train_batch"] = {  # phase 28: the chunked loss (all 0)
            k: ({"product": v[4], "combine": v[5]} if name == "fused_xent_forward"
                else {"ds": v[6], "dH" if name == "fused_xent_backward_dh" else "dW": v[8 if name.endswith("dh") else 7]})
            for k, v in tpt_launches.items()}
        entry["pipeline_launches_per_train_batch"] = {  # phase 29: the last stage's only
            k: ({"product": v[4], "combine": v[5]} if name == "fused_xent_forward"
                else {"ds": v[6], "dH" if name == "fused_xent_backward_dh" else "dW": v[8 if name.endswith("dh") else 7]})
            for k, v in pipe_launches.items()}
        entry["moe_launches_per_train_batch"] = (
            {"product": moe_launches[4], "combine": moe_launches[5]} if name == "fused_xent_forward"
            else {"ds": moe_launches[6],
                  "dH" if name == "fused_xent_backward_dh" else "dW": moe_launches[8 if name.endswith("dh") else 7]})
        t24 = tier_launches["d_gpt3_6.7b"]  # the fused loss runs in (d)
        entry["memory_tiers_launches_per_train_batch"] = (
            {"product": t24[4], "combine": t24[5]} if name == "fused_xent_forward"
            else {"ds": t24[6], "dH" if name == "fused_xent_backward_dh" else "dW": t24[8 if name.endswith("dh") else 7]})
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
    for i, ((name, where), n) in enumerate(zip(replaces.items(), sparse_launches)):
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
            "elastic_worker_launches": p23["sparse"][i],  # counted in the workers; the model is dense
            "data_parallel_launches_per_train_batch": {k: v[N_COUNTS + i] for k, v in dp_launches.items()},
            "tensor_parallel_training_launches_per_train_batch": {k: v[N_COUNTS + i]
                                                                  for k, v in tpt_launches.items()},
            "pipeline_launches_per_train_batch": {k: v[N_COUNTS + i] for k, v in pipe_launches.items()},
            "moe_launches_per_train_batch": moe_launches[N_COUNTS + i],  # dense attention: 0
        })
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"training": training}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
