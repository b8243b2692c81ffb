#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Every serving family of the port at full width: deepseek-7b (the dense
path, kernels K1 flash-attention and K2 flash-decode), granite-moe-3b-a800m
(the MoE path: K1 and K2 at GQA 24/8 and head dim 64, exact-length
prefills), mistral-nemo-12b (K1 and K2 at GQA 32/8 and head dim 128; the
engine only, at 20 of its 40 layers), llava-next-mistral-7b (the vlm path:
K1 over an image request's 2944 positions and K2 over a 3072 cache, GQA
32/8), rwkv6-1.6b (the RWKV-6 path, kernel K3 WKV-6), recurrentgemma-9b
(the hybrid path: RG-LRU and ring-buffer local attention, no kernel; at 20
of its 38 layers) and whisper-tiny (the encoder-decoder, no kernel); the
paper's three CNN payloads at 224 px; the calibration that turns eight of
them into the serverless simulator's numbers, and the replay of a winning
policy stack on deepseek-7b's real server, held to the simulator; and
training (deepseek-7b at 20 of its layers and rwkv6-1.6b, at full width,
through K1 with its backward K1-bwd and K3 with K3-bwd, and AdamW through
K4 grad_sumsq and K5 adamw_update, each step a replay of its captured CUDA
graph).  Phases, in order; any
failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), and the seconds of
     ``import torch`` and of the first CUDA context in a fresh process;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc each, all
     at once) and print the build time and ptxas's register/shared-memory lines;
  3. hold each kernel against its plain PyTorch version on the card: each
     path's shapes (granite's ragged S=100 at batch 4 and S=300 at batch 1
     for K1, its per-row masks over a 512 cache for K2, mistral-nemo's GQA
     32/8, llava's (2, 2944) at GQA 32/8 for K1 and its per-row masks over a
     3072 cache for K2, also at the llava engine's positions) plus GQA,
     window, ragged-S, head-dim and float32 cases; every bf16 case of K1
     and K2 also row by row against the plain version in float32 (each
     row's relative L2 error, ``ROW_REL_TOL``), and at llava's shapes the
     plain version with one KV tile dropped must read above that bar; for
     K2 also masks whose all-false tiles lie at the start, around a band,
     in the middle and at the end, a row with no valid position (the mean of
     V), and a band slice of a longer cache; K2's row log-sum-exp
     (``return_lse``) at the long-KV chunk (1, 8192, 32, 128), a chunk with
     no valid position, deepseek's, llava's and qwen3's (1, 8) decode shapes,
     its output bit for bit K2's without it (``decode_lse_checks``); for K3
     one head alone, a T that
     is not a multiple of its chunk, decays near 0 and near 1, and the state
     updated in place at T=1 and T=100; the backward kernels K1-bwd and
     K3-bwd at the training shapes and around them (``bwd_kernel_checks``),
     the bf16 cases of K1-bwd row by row, with a dropped query or key tile
     that must read above the bar; K4 and K5 on bf16 and float32 leaves of
     ragged sizes, one element, more than a kernel table holds, K5's tile
     edges and zero gradients and moments (``optim_kernel_checks``), each
     run twice bit for bit, K5 bit for bit the plain update;
  4. each path in bf16 with seeded random weights: logits (and for rwkv the
     recurrent state) on the kernel path against the plain path; the
     uncaptured prefill's logits and the tokens of the uncaptured path (the
     prefill and the decode step run eagerly on the card), greedy and
     sampled; then the path itself, every prefill, admission and decode
     step a replay of its captured CUDA graph — deepseek through the
     engine's ``generate`` and the ``ContinuousServer``, rwkv through
     ``generate`` and ``generate_stream``, granite-moe-3b-a800m through
     ``generate`` at the exact prompt length and the ``ContinuousServer``
     (each admission a replay of the batch-1 graph of its exact length) — with
     every kernel's launch count set to 0 just before and read just after:
     the replayed prefill's logits must equal the uncaptured one's within
     the bf16 tolerance and the replayed tokens the uncaptured path's; K1's
     count, replays included, layers x prefills (replays, capture warm-ups
     and eager admissions), K2's layers x steps and K3's layers x (prefills
     + steps); the completion order the uncaptured server's; the server's
     drain split between admission and decode (both drains: the first
     pays the captures), and the memory of its admission graphs.  granite's logits check runs a
     float32 copy of its weights (the gate) and the bf16 weights (reported,
     with the share of expert routes the plain path would pick otherwise),
     the plain path taking the kernel path's routes, so that a routing flip
     from rounding cannot stand in for a kernel fault;
  5. SqueezeNet, ResNet-18 and ResNeXt-50 at 224 px, float32, seeded
     weights: batch 1 and batch 4 of random images on the card against the
     CPU (top-1 and logits), parameter MB against the paper's, the first
     call's and the warm forward's ms, the device time and launches of a
     forward (torch.profiler), and its bound; the same forward captured
     into a ``ForwardGraph``: its logits against the uncaptured forward's,
     its first call, warm ms, device time and host launch calls;
  6. each kernel's time at its path's shapes (the engine's, and for K1 and
     K2 the continuous server's and granite's engine's too): CUDA events
     over back-to-back calls
     (inputs rotated through copies that span four times the L2) and the
     device time of the same calls from a torch.profiler trace (every kernel
     a call launches, summed), its bound, the plain version's time and one
     PyTorch library call's time where there is one (K2 also at the
     long-KV chunk (1, 8192, 32, 128) and over the whole 16,384-position
     cache, each with and without its row lse); the K1, K2 and K3
     wrappers' host time per call; K3 under narrower split plans than
     its own and at one head alone; and K1-bwd and K3-bwd at the training
     shapes (K1-bwd also at granite's GQA 24/8, head dim 64), K1-bwd beside
     the backward of the library's attention; K4 and K5 at deepseek-7b's
     20-layer leaves (``optim_timings``, run at the start of phase 10, when
     the engines are freed) beside ``torch._foreach_norm`` and
     ``torch.optim.AdamW(fused=True)`` (and ``torch._fused_adamw_`` on
     float32 moments, where it takes them), each with its rate in TB/s;
  7. where a full-width prefill's and decode step's time goes, per path: host
     wall, device time by kernel (torch.profiler), the host's launch calls
     and each one's bound; the prefill and the decode step each replayed
     (the trace must name K1's, K2's or K3's kernels, and a replayed prefill
     make one graph launch) and uncaptured, with the busy share of each;
     then, with those engines freed, mistral-nemo-12b at full width and
     ``MISTRAL_LAYERS`` of its 40 layers through the engine
     (batch 4, prompt 100 in bucket 128, 32 new): logits kernel against
     plain, replayed greedy and sampled tokens against the uncaptured ones,
     K1 and K2 counted, the peak memory, and its prefill and decode rows;
     then, each alone on the card and freed before the next (phases 4 and
     7 for each): llava-next-mistral-7b (logits kernel against plain with
     seeded random patch embeddings, a float32 copy of the weights the gate;
     the engine at batch 2, prompt 2944 exact over the reference's zero
     patch embeddings, 32 new, replayed against uncaptured, K1 and K2
     counted), recurrentgemma-9b at full width and ``HYBRID_LAYERS`` of
     its 38 layers (the engine at batch 1, prompt 3072, 16
     new, which wraps the ring and takes the chunked attention, and at
     batch 4, prompt 100, 32 new, replayed against uncaptured; a float32
     copy at 5 layers, the card against the CPU) and whisper-tiny (the
     engine at batch 4, prompt 100, 32 new over 1500 zero frames, replayed
     against uncaptured; the float32 model with random frames, the card
     against the CPU), each with its peak memory;
  8. the port's ``calibrate`` of the three CNNs, deepseek-7b,
     granite-moe-3b-a800m, rwkv6-1.6b, recurrentgemma-9b and whisper-tiny at
     full width into a temporary cache file: every entry printed and
     checked against the v2 schema, K1 and K2 launched while deepseek-7b and
     granite are measured (each with a batch curve) and K3 while rwkv6-1.6b
     is, the handlers built from the cache, the peak memory (this phase
     follows 6 and 7 because it frees the engines they use); llava is not
     calibrated (the reference's vlm calibration fails, and the port's
     follows it); then, on that cache file, the port's serverless platform
     (``platform_step``, host time only, nothing measured): the three CNNs
     on ``lambda`` at 1024 MB and deepseek-7b on ``modal_gpu`` at 16384 MB
     (refused on ``lambda``), the paper's cold, warm and scalability
     experiments for each and one shared fleet, every report printed with
     its SLA, and deepseek-7b's zero-jitter cold response held to its
     cold-start breakdown plus its warm response; then, on the same cache
     (``scenario_step``, host time only, nothing measured), every named
     scenario whose fleet the cache holds (all but ``sharded_110b``, whose
     qwen1.5-110b no single card holds at full width; printed as not run,
     with its size) at scale 1.0: ``ExperimentSpec(name, winner,
     versus="baseline")`` and ``versus=rival`` on a platform built with
     ``calibrated=`` the cache, each result's ``summary_line``, every
     request recorded and every time finite, a repeat run and
     ``run_specs`` with one and two workers giving equal rows, and
     ``gpu_serverless``'s ``adaptive`` beating ``baseline`` on cold rate and
     p95 on the card's deepseek-7b entry (the other verdicts printed, not
     gated); then the memory advisor's tier for each CNN on its card entry;
     then, on the same cache (``replay_step``, nothing measured), the
     sim-to-real replay (``repro_torch.core.replay_real``): gpu_serverless'
     time-scaled trace under ``adaptive`` at scale 0.5 and ``baseline`` at
     0.1, each warm request a real submit and run of deepseek-7b's
     ``ContinuousServer`` at full width and each cold a real construction
     and first serve (the graphs' capture), with K1 and K2 counted; each
     metric's sim, real and error printed, both within the reference's
     tolerances, every request served, and an evicted container's server
     freed (the allocated memory after the last cold within one server of
     that after the first);
  10. (after 8, every engine freed) phase 6's K4/K5 timings, then training
     (``train_phase``): deepseek-7b at full width and 20 of its 30 layers
     and rwkv6-1.6b at full width and depth (``tmix.wo`` redrawn), batch 4,
     seq 512, each three times from one seed: ``make_train_step`` called
     directly for 3 steps and for 8, then 8 steps through a ``TrainGraph``
     (the warm-up step, the capture, 7 replays), as ``train()`` steps; per
     step the loss, grad norm, lr, host wall and K1/K1-bwd or K3/K3-bwd
     launches (layers x 2 and layers) and K4/K5 (once), step 3 traced
     (device time, busy share, K4's and K5's time), the peak memory
     allocated and reserved, the losses finite and falling; the two
     uncaptured runs compared bit for bit, and the replayed run held bit
     for bit to the uncaptured one (losses, and params after 3 steps in
     host memory); then the gate: deepseek-7b, granite-moe-3b-a800m and
     rwkv6-1.6b at 2 layers in float32, every gradient leaf and one AdamW
     step on the kernel path against the plain path, one K4/K5 step against
     the plain update, and the microbatched step (``num_micro=2``)
     replayed against uncaptured;
  11. (after 10, every engine freed) the sharded paths
     (``sharded_phase``): two ranks (``repro_torch.launch.mesh.spawn``), then
     four and eight, on
     the cards present, NCCL with a card each when there are two, gloo when
     they share one (the backend and card count printed): deepseek-7b at
     full width and ``SHARDED_LAYERS`` layers, bf16, on the (1, 2) mesh
     (tensor parallel),
     batch 4, prompt 100, 32 new, greedy, uncaptured: its prefill logits
     row by row (``ROW_REL_TOL``) against the single card's engine with its
     row-parallel products split as the two ranks split them
     (``split_rows``), and against the plain single card (the bf16
     reordering bar, ``LOGITS_REL_TOL``), the
     tokens of both (and where they part, the step and the sharded
     engine's logit margin there), K1 and K2 counted per rank (layers x
     prefills, layers x steps) and one decode step's collectives per rank
     held to ``plan_shards``' formula; then the same ranks' prefill with the
     reference's sequence parallelism (``use_mesh(mesh, seq_parallel=True)``,
     ``seq_parallel_prefills``) against their prefill without it (logits row
     by row and the cache shards, and whether bit-equal), its collectives
     against ``launch/comms.py``'s prefill plan, K1 counted per rank; the
     float32 gates at 2 layers and
     full width (deepseek-7b on (1, 2) and (2, 1), granite-moe-3b-a800m on
     (1, 2), its experts split two ways, rwkv6-1.6b on (1, 2), K3 on the
     local heads, ``tmix.wo`` redrawn): equal tokens and prefill logits
     within ``SHARDED_REL_TOL``; the sequence-parallel float32 gates on
     (1, 2) (``seq_parallel_gates``: deepseek-7b, granite-moe-3b-a800m and
     rwkv6-1.6b at 2 layers, recurrentgemma-9b at one pattern unit,
     whisper-tiny whole): the cut prefill's logits within
     ``SHARDED_REL_TOL`` of the single card's; one AdamW step of
     deepseek-7b at 2 layers in float32 on (2, 1) data parallel, (2, 1)
     FSDP, (1, 2) tensor parallel and (1, 2) sequence parallel, loss, grad
     norm and every param within ``SHARDED_REL_TOL`` of the single card's
     step (the sequence-parallel step's params also of the tensor parallel
     step's), K1-bwd, K4 and K5 counted per rank; then the layouts that
     cut a KV sequence or heads inside
     (``new_layouts_rank``): deepseek-7b (``SHARDED_LAYERS`` layers) at
     batch 1 on (2, 1), its
     16,384-position cache cut over "data", an 8,176-token prompt and 32 new
     tokens, unwindowed and with a 4,096-position window, every step's
     logits held to the bit (``ROW_REL_TOL``) to one card that splits its
     cache at 8,192 and combines the halves as the ranks do
     (``split_decode``), the tokens to that card's and printed beside the
     plain card's; recurrentgemma-9b at full width and ``SHARDED_LAYERS``
     layers (two pattern units and the remainder) in bf16 on (1, 2), held
     row by row to one card that splits its row products and
     its projections' columns as the ranks do (``split_rows``,
     ``split_project``), its float32 gate at one pattern unit and one float32
     TP step (over the elements above the gradient noise, as phase 10's
     gate); whisper-tiny's float32 gate on (1, 2); then on four ranks
     whisper-tiny's on (1, 4), and on eight qwen3-moe-235b-a22b's on (1, 8)
     at full width and ``QWEN3_LAYERS`` layers, each rank drawing its own
     shards (``wide_rank``); every new run's decode-step collectives held to
     ``launch/comms.py``'s plan of its layout; each rank's peak memory and
     the phase's seconds.  Rank 0 runs each single-card oracle in the same
     run;
  9. one JSON line with the kernels (launches summed over every path), then
     the last line ``{"ok": true, ...}``.
"""
from __future__ import annotations

import contextlib
import json
import math
from itertools import count
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K1 and K2 in bf16 held a second way: each output row (one query's head,
# hd values) against the plain version in float32 on the same inputs, by
# the row's relative L2 error, the largest over the rows.  Rounding the
# probabilities and the output to bf16 gives about 2e-3.  A 64-key tile
# dropped from a row that attends to about 2900 keys changes that row by
# about sqrt(64/2900) = 0.15; TOL's elementwise 2e-2 on llava's outputs of
# about 0.03 would not see it.
ROW_REL_TOL = 1e-2
# the keys of the tile that the fault reading drops (phase 3, llava's
# shapes): for K1 from the rows past FAULT_ROWS, for K2 from every row
FAULT_TILE, FAULT_ROWS = (1024, 1088), 2048
# kernel path vs plain path at full width: the plain path rounds attention
# probabilities to bf16 before PV, the kernels do not; over 30 bf16 layers
# the last logits may differ by this much relative to their L2 norm
LOGITS_REL_TOL = 5e-2
# rwkv6-1.6b, kernel path vs plain path.  In bf16, K3's float32 sums round
# differently by about 2e-7 (phase 3), and the bf16 casts after it turn some
# of those into one-ulp flips (2^-8) that compound over 24 layers and a state
# that keeps about 150 steps of memory (w0 = -5): on an H100 the logits
# differ by about 4.6e-2 (PERF.md).  So the bf16 bar only catches a broken
# kernel (its error is of order 1), and the sharp check is the same
# comparison with the weights in float32, where nothing is rounded to bf16.
RWKV_REL_TOL = {torch.bfloat16: 1e-1, torch.float32: 1e-3}
# K3 against its plain version: float32 on both sides, sums in another order;
# the error of the recurrence grows with the state, so it is held relative
# to the largest magnitude of each output (o, and the final state)
# (and K3-bwd's, whose outputs, sums over the rebuilt state and its
# gradient, came within 5.7e-7 of that measure on an H100)
WKV_REL_TOL = 1e-5
# a CNN forward on the card against the same forward on the CPU, float32 on
# both sides with TF32 off: cuDNN and the CPU's convolutions sum in other
# orders (and may pick Winograd or FFT algorithms), which at 224 px and up to
# 50 layers comes to about 1e-5 relative L2; a TF32 convolution (10 bits of
# mantissa) would be off by about 1e-3
CNN_REL_TOL = 1e-4
# The seeded random CNNs give every image nearly the same logits; the part
# that differs from image to image (the logits less their batch mean, about
# 5% of the whole at 57 and 64 px on the CPU) is held on its own at batch 4,
# so that a mix-up of the images in a batch fails.  Against that part the
# same sum-order error is about 20 times larger, hence 10 times the
# tolerance; and the part must be there at all.
CNN_CENTRED_TOL = 1e-3
CNN_MIN_PER_IMAGE_SHARE = 1e-3
# the paper's package MB, and the range the reference's tests accept
CNN_PAPER_MB = {"squeezenet": (5, 3, 7), "resnet18": (45, 40, 50), "resnext50": (98, 85, 105)}
# sampled decoding in phase 4: temperature and seed
SAMPLE_T, SAMPLE_SEED = 0.8, 17
# granite-moe-3b-a800m, kernel path vs plain path on the same expert routes
# (the plain path takes the kernel path's top-k): with the weights in
# float32, where nothing is rounded to bf16, K1's and K2's float32 sums
# differ from the plain versions' by about 1e-7 a layer; this bar is far
# above that and far below a broken kernel's error (of order 1)
MOE_REL_TOL = 1e-3
# a float32 model against the same model on another path (llava: kernel
# against plain; recurrentgemma-9b and whisper-tiny: the card against the
# CPU): sums in another order, about 1e-6 relative L2 at full width; a
# broken kernel or a slip per row or channel is of order 1
F32_REL_TOL = 1e-4
# llava's engine: an image request, LLaVA-NeXT's 2880 anyres image positions
# and 64 text tokens, in a cache that holds its 32 new tokens
LLAVA_PROMPT, LLAVA_CACHE = 2944, 3072
# recurrentgemma-9b's long prompt: past its 2048 window (the ring wraps
# during the prefill) and a multiple of 1024 past 2048 (the chunked attention)
HYBRID_LONG = 3072
ENGINE_CACHE = {"vlm": LLAVA_CACHE, "hybrid": HYBRID_LONG + 16}
# phase 4+7's mistral-nemo-12b and recurrentgemma-9b run at full width and
# this many of their 40 and 38 layers (recurrentgemma: six pattern units and
# the 2-layer remainder, as at 38): with the replay step the script took
# 1058 s of its 1200 on a slow host, these two phases 180.5 s of it at full
# depth (an uncaptured step's launch calls grow with the depth);
# llava-next-mistral-7b keeps K1 and K2 at mistral's GQA 32/8 and head dim
# 128 at full depth
MISTRAL_LAYERS = HYBRID_LAYERS = 20
CALIBRATED = ["squeezenet", "resnet18", "resnext50", "deepseek-7b", "granite-moe-3b-a800m",
              "rwkv6-1.6b", "recurrentgemma-9b", "whisper-tiny"]
# phase 10: deepseek-7b trains at 20 of its 30 layers (at 30 its bf16
# weights and gradients and float32 moments alone are 82.9 GB), rwkv6-1.6b
# at all 24; TRAIN_STEPS AdamW steps at batch 4, seq 512, step 3 traced
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 4, 512, 3e-4
TRAIN_PROFILED = 2
# the gate: float32 gradients, kernel path against plain path, per leaf
# relative L2: the kernels sum in another order (about 1e-6 a layer)
GATE_REL_TOL = 1e-4
# an element of a gradient below this share of its leaf's rms is at the
# rounding noise of the comparison, where AdamW's first step (the sign of
# the gradient) may go either way
GATE_NOISE = 1e-2
# phase 10: the params are copied to host memory after this many steps of
# each run, and the replayed run held to the uncaptured one there
TRAIN_SNAP = 3
# K4 and K5 against their plain versions: float32 on both sides, sums (K4)
# in another order: the sum of squares and the moments within this relative
# error, float32 params too; bf16 params within one unit in the last place.
# K5 rounds every operation on its own, as the plain version does, so where
# K5 alone is held to it (phases 3 and 6) it must also equal it bit for bit;
# one step of the gate also goes through K4's sum, whose order differs
OPT_REL_TOL = 1e-6
OPT_BF16_ULPS = 1
OPT_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
CNN_ENTRY = {"kind", "warm_exec_s", "first_call_s"}
LLM_ENTRY = {"kind", "warm_exec_s", "init_s", "compile_s", "package_mb", "tokens_per_s",
             "batch_curve"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, arg_sets: list, iters: int = 60, warm: int = 5) -> float:
    """Mean time of ``fn(*args)`` over CUDA events, cycling through
    ``arg_sets`` so that each launch reads inputs the L2 no longer holds,
    as in the model, where a layer's weights pass between two calls."""
    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(prof) -> list:
    """The device events of a torch.profiler trace, summed by name, less the
    spans of ``record_function`` (``torch.optim``'s ``Optimizer.step#...``
    among them), which the profiler also reports on the device, over the
    kernels they hold: summed with those kernels they would count them twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def device_ms(fn, arg_sets: list, iters: int = 30, tries: int = 3,
              floor_ms: float = 0.0) -> float | None:
    """Device time per call of ``fn(*args)`` over the same rotation of
    inputs as ``time_ms``: every kernel the calls launch, summed from a
    torch.profiler trace, so host work between launches does not count.
    A trace that holds no device time, or less a call than ``floor_ms``
    (a bound no run can beat: the profiler dropped some of its kernels,
    as it does now and then), is taken again, up to ``tries`` times; then
    None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in kernel_events(prof))
        if total_us > 0 and total_us / 1e3 / iters >= floor_ms:
            return total_us / 1e3 / iters
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_us(fn, args, iters: int = 200) -> float:
    """Host time per call of ``fn(*args)``: the launches are queued and not
    waited for, so this is the wrapper's own cost, while the card keeps up."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def cold_copies(make, nbytes: int) -> list:
    """Enough copies of ``make()``'s inputs (``nbytes`` each) to span four
    times the card's L2."""
    return [make() for _ in range(max(2, math.ceil(4 * L2_BYTES / nbytes)))]


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand(shape, dtype, gen, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    log(f"[check] {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, rel_tol: float) -> float:
    """Max abs error, held to ``rel_tol`` times the largest magnitude of
    ``want``."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= rel_tol * scale
    log(f"[check] {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
        f"relative={err / scale:.3e} tol={rel_tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def row_rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each output row's relative L2 error over the last axis (hd)."""
    return (got.float() - want).norm(dim=-1) / want.norm(dim=-1)


def check_rows(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A bf16 kernel's output against its plain version in float32
    (``want``), row by row: the largest row's relative L2 error, held to
    ``ROW_REL_TOL``."""
    torch.cuda.synchronize()
    rel = row_rel(got, want)
    worst = rel.max().item()
    ok = bool(torch.isfinite(got).all()) and worst <= ROW_REL_TOL
    log(f"[check] {name}, each row against float32: worst row rel_l2={worst:.3e} "
        f"median {rel.median().item():.3e} tol={ROW_REL_TOL:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return worst


def check_grad_rows(name: str, got: torch.Tensor, want: torch.Tensor, zero=None) -> float:
    """``check_rows`` for a gradient.  ``zero`` marks the rows whose
    gradient is 0 in exact arithmetic (query 0's dq: a softmax over one key
    has none), where both sides hold rounding noise and a relative error
    means nothing: they are held to ``ROW_REL_TOL`` of the largest row's
    norm instead, and the rest row by row."""
    if zero is None:
        return check_rows(name, got, want)
    top = want.norm(dim=-1).max().item()
    worst_zero = got.float().norm(dim=-1)[zero].max().item()
    ok = worst_zero <= ROW_REL_TOL * top
    log(f"[check] {name}: {int(zero.sum())} rows whose gradient is 0, largest norm there "
        f"{worst_zero:.3e} against {ROW_REL_TOL:g} x the largest row {top:.3e}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return check_rows(name, got[~zero], want[~zero])


def fault_reads(name: str, want: torch.Tensor, plain: torch.Tensor,
                faulty: torch.Tensor) -> None:
    """The plain version in float32 with the keys of ``FAULT_TILE``
    dropped, as a kernel that skips that tile would compute it, read by
    ``check_rows``'s measure against ``want``: it must lie above the bar, or
    the bar could not see the fault.  Also says whether ``check``'s
    elementwise bf16 tolerance, against the bf16 ``plain`` version, would
    let the fault pass."""
    worst = row_rel(faulty, want).max().item()
    f16 = faulty.to(plain.dtype).float()
    passes = torch.allclose(f16, plain.float(), atol=TOL[plain.dtype], rtol=TOL[plain.dtype])
    log(f"[check] {name}, keys {FAULT_TILE[0]}-{FAULT_TILE[1] - 1} dropped in the plain "
        f"version: worst row rel_l2={worst:.3e} against the bar {ROW_REL_TOL:g}: "
        f"{'seen' if worst > ROW_REL_TOL else 'NOT SEEN'}; the elementwise tol "
        f"{TOL[plain.dtype]:g} would {'pass' if passes else 'fail'} it (max_abs_err "
        f"{(f16 - plain.float()).abs().max().item():.3e})")
    if not worst > ROW_REL_TOL:
        raise SystemExit(f"{name}: the row bar cannot see a dropped KV tile")


def wkv_inputs(b, t, h, hd, gen, dev, log_decay=-2.0):
    """r, k, v ~ N(0,1); decays w = exp(-exp(randn + log_decay)), realistic
    at -2, near 0 at +2, near 1 at -6; u and a small initial state, all
    float32."""
    shape = (b, t, h, hd)
    r, k, v = (rand(shape, torch.float32, gen, dev) for _ in range(3))
    w = torch.exp(-torch.exp(rand(shape, torch.float32, gen, dev) + log_decay))
    u = rand((h, hd), torch.float32, gen, dev) * 0.5
    s0 = rand((b, h, hd, hd), torch.float32, gen, dev) * 0.1
    return r, k, v, w, u, s0


def plain_scan(r, k, v, w, u, state, *, out_state=None):
    """``dispatch.rwkv_scan`` through K3's plain version, on the card."""
    from repro_torch.kernels.rwkv.ref import wkv6_ref

    o, s = wkv6_ref(r, k, v, w, u, state)
    return o, (s if out_state is None else out_state.copy_(s))


def kernel_checks(dev) -> dict:
    """Phase 3: every kernel against its plain version.  Returns the
    largest error at the main paths' shapes, per kernel."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.decode.ref import flash_decode_ref
    from repro_torch.kernels.rwkv import wkv
    from repro_torch.kernels.rwkv.ref import wkv6_ref
    from repro_torch.models.layers import causal_window_mask, sdpa

    gen = torch.Generator(device=dev).manual_seed(0)
    main_err = {"flash_attention": 0.0, "flash_decode": 0.0, "wkv6": 0.0}
    for (b, s, h, kh, hd, win, dt, main) in [
            (4, 128, 32, 32, 128, 0, torch.bfloat16, True),   # engine prefill
            (4, 512, 32, 32, 128, 0, torch.bfloat16, True),   # server prefill
            (4, 100, 24, 8, 64, 0, torch.bfloat16, True),     # granite engine prefill
            (1, 300, 24, 8, 64, 0, torch.bfloat16, True),     # granite admission, S=300
            (1, 20, 24, 8, 64, 0, torch.bfloat16, True),      # granite admission, S=20
            (4, 128, 32, 8, 128, 0, torch.bfloat16, True),    # mistral-nemo engine prefill
            (2, 2944, 32, 8, 128, 0, torch.bfloat16, True),   # llava engine prefill
            (4, 100, 24, 8, 64, 0, torch.float32, False),     # granite, float32 copy
            (2, 256, 8, 2, 64, 0, torch.bfloat16, False),     # GQA
            (1, 256, 4, 4, 128, 64, torch.bfloat16, False),   # window 64
            (1, 300, 4, 1, 128, 0, torch.float32, False),     # ragged, MQA, f32
            (2, 192, 8, 2, 64, 64, torch.float32, False),     # GQA window f32
            (1, 70, 4, 4, 32, 0, torch.float32, False),       # head dim 32
            (1, 300, 8, 2, 64, 0, torch.bfloat16, False),     # head dim 64, ragged
            (2, 333, 4, 2, 32, 100, torch.bfloat16, False)]:  # head dim 32, ragged, window
        q = rand((b, s, h, hd), dt, gen, dev)
        k, v = rand((b, s, kh, hd), dt, gen, dev), rand((b, s, kh, hd), dt, gen, dev)
        name = f"K1 flash_attention q{(b, s, h, hd)} kv{kh} window={win} {dt}"
        got = flash.flash_attention(q, k, v, window=win)
        plain = flash_attention_ref(q, k, v, window=win)
        if dt == torch.bfloat16:
            q32, k32, v32 = q.float(), k.float(), v.float()
            want = flash_attention_ref(q32, k32, v32, window=win)
            check_rows(name, got, want)
            if s == LLAVA_PROMPT:
                pos = torch.arange(s, device=dev)
                drop = ((pos[:, None] >= FAULT_ROWS) & (pos[None, :] >= FAULT_TILE[0])
                        & (pos[None, :] < FAULT_TILE[1]))
                fault_reads(name, want, plain,
                            sdpa(q32, k32, v32, causal_window_mask(pos, pos, win) & ~drop))
            del q32, k32, v32, want
        err = check(name, got, plain, TOL[dt])
        if main:
            main_err["flash_attention"] = max(main_err["flash_attention"], err)
    for (b, s, h, kh, hd, per_row, win, dt, main) in [
            (4, 256, 32, 32, 128, False, 0, torch.bfloat16, True),   # engine decode
            (4, 256, 32, 32, 128, True, 0, torch.bfloat16, True),    # same, per row
            (4, 512, 32, 32, 128, True, 0, torch.bfloat16, True),    # server decode
            (4, 256, 24, 8, 64, False, 0, torch.bfloat16, True),     # granite engine decode
            (4, 512, 24, 8, 64, True, 0, torch.bfloat16, True),      # granite server decode
            (4, 256, 32, 8, 128, False, 0, torch.bfloat16, True),    # mistral-nemo decode
            (2, 3072, 32, 8, 128, True, 0, torch.bfloat16, True),    # llava decode
            (4, 256, 24, 8, 64, False, 0, torch.float32, False),     # granite, float32 copy
            (2, 1024, 8, 2, 64, False, 0, torch.bfloat16, False),    # GQA
            (2, 512, 8, 8, 128, True, 64, torch.bfloat16, False),    # window 64
            (3, 300, 4, 1, 128, True, 0, torch.float32, False),      # ragged, MQA, f32
            (2, 700, 8, 2, 64, True, 0, torch.float32, False)]:      # GQA, f32
        q = rand((b, 1, h, hd), dt, gen, dev)
        k, v = rand((b, s, kh, hd), dt, gen, dev), rand((b, s, kh, hd), dt, gen, dev)
        kv = torch.arange(s, device=dev)
        if per_row:
            pos = torch.randint(0, s, (b,), generator=gen, device=dev)
            valid = kv[None, :] <= pos[:, None]
            if win:
                valid &= (pos[:, None] - kv[None, :]) < win
        else:
            valid = kv <= (2 * s) // 3
        form = "(B,S)" if per_row else "(S,)"
        name = (f"K2 flash_decode q{(b, 1, h, hd)} cache{(b, s, kh, hd)} mask {form} "
                f"window={win} {dt}")
        got = fd.flash_decode(q, k, v, valid)
        if dt == torch.bfloat16:
            check_rows(name, got, flash_decode_ref(q.float(), k.float(), v.float(), valid))
        err = check(name, got, flash_decode_ref(q, k, v, valid), TOL[dt])
        if main:
            main_err["flash_decode"] = max(main_err["flash_decode"], err)
    err = llava_decode_check(gen, dev)
    main_err["flash_decode"] = max(main_err["flash_decode"], err)
    decode_skip_checks(gen, dev)
    main_err["flash_decode"] = max(main_err["flash_decode"], decode_lse_checks(gen, dev))
    for (b, t, h, hd, log_decay, main) in [
            (4, 100, 32, 64, -2.0, True),     # the rwkv engine's prefill
            (4, 1, 32, 64, -2.0, True),       # its decode step
            (1, 2048, 32, 64, -2.0, False),   # a long prompt
            (2, 96, 2, 32, -2.0, False),
            (1, 256, 1, 16, -2.0, False),
            (2, 128, 4, 128, -2.0, False),
            (1, 100, 1, 64, -2.0, False),     # B*H = 1: the split plan's narrowest CTAs
            (4, 100, 8, 128, -2.0, False),    # head dim 128 at the prefill length
            (4, 37, 32, 64, -2.0, False),     # T not a multiple of the chunk
            (4, 100, 32, 64, 2.0, False),     # decays near 0
            (4, 100, 32, 64, -6.0, False)]:   # decays near 1
        r, k, v, w, u, s0 = wkv_inputs(b, t, h, hd, gen, dev, log_decay)
        o, s = wkv.wkv6(r, k, v, w, u, s0)
        want_o, want_s = wkv6_ref(r, k, v, w, u, s0)
        errs = [check_rel(f"K3 wkv6 {(b, t, h, hd)} log decay {log_decay:g} {what}", got, want,
                          WKV_REL_TOL)
                for what, got, want in (("o", o, want_o), ("final state", s, want_s))]
        if main:
            main_err["wkv6"] = max(main_err["wkv6"], *errs)
    for t in (1, 100):      # the engine's shapes, the state updated in place
        r, k, v, w, u, s0 = wkv_inputs(4, t, 32, 64, gen, dev)
        o, s = wkv.wkv6(r, k, v, w, u, s0)
        state = s0.clone()
        o_in, _ = wkv.wkv6(r, k, v, w, u, state, out_state=state)
        torch.cuda.synchronize()
        if not (torch.equal(o_in, o) and torch.equal(state, s)):
            raise SystemExit(f"K3 wkv6 T={t}: the in-place state differs from a separate one")
        log(f"[check] K3 wkv6 (4, {t}, 32, 64) in place over s0 equals a separate state "
            "buffer bit for bit: ok")
    return main_err


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two finite bf16 tensors in units of the
    last place: the bit patterns mapped to integers in the order of the
    values (a negative value to minus its magnitude's bits, so that -0 and
    +0 meet and the step across 0 is one ulp of the smallest subnormal)."""
    def order(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(a) - order(b)).abs().max()) if a.numel() else 0


def opt_leaves(sizes, dtype, gen, dev, scale: float = 1.0, square: bool = False) -> list:
    out = []
    for n in sizes:
        t = torch.randn((n,), generator=gen, device=dev) * scale
        out.append((t.square() if square else t).to(dtype))
    return out


def optim_case(sizes, pdt, gdt, gen, dev):
    """Leaves of ``sizes``: params ``pdt``, grads ``gdt``, float32 moments
    (nu >= 0), and the update's scalars (clip scale, lr, b1c, b2c)."""
    return (opt_leaves(sizes, pdt, gen, dev), opt_leaves(sizes, gdt, gen, dev, 0.3),
            opt_leaves(sizes, torch.float32, gen, dev, 0.01),
            opt_leaves(sizes, torch.float32, gen, dev, 0.01, square=True),
            torch.tensor([0.7, 3e-4, 0.271, 0.142625], device=dev))


def zero_halves(g: list, mu: list, nu: list) -> None:
    """As an embedding's rows that no token of a step touched: the first half
    of each leaf's gradient and moments zero (a quarter of mu -0), where K5
    takes its shortcut past the divisions for a zero operand."""
    for leaf in zip(g, mu, nu):
        for t in leaf:
            t[:t.numel() // 2] = 0
        leaf[1][:leaf[1].numel() // 4] = -0.0


def check_update(name: str, got: tuple, want: tuple, exact: bool = False) -> float:
    """K5's params and moments against the plain update's: moments and
    float32 params within ``OPT_REL_TOL`` of their leaf's largest
    magnitude, bf16 params within ``OPT_BF16_ULPS``, and with ``exact``
    every leaf equal bit for bit.  -> the largest absolute difference over
    params and moments."""
    torch.cuda.synchronize()
    worst_rel, ulps, err = 0.0, 0, 0.0
    for kind, gs, ws in zip(("p", "mu", "nu"), got, want):
        for g, w in zip(gs, ws):
            if not g.numel():
                continue
            err = max(err, (g.float() - w.float()).abs().max().item())
            if kind == "p" and g.dtype == torch.bfloat16:
                ulps = max(ulps, bf16_ulps(g, w))
            else:
                scale = w.abs().max().item()
                worst_rel = max(worst_rel, (g - w).abs().max().item() / max(scale, 1e-30))
    equal = all(torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    ok = worst_rel <= OPT_REL_TOL and ulps <= OPT_BF16_ULPS and (equal or not exact) and all(
        bool(torch.isfinite(t).all()) for ts in got for t in ts)
    log(f"[check] {name}: max_abs_err={err:.3e}, worst relative {worst_rel:.3e} (tol "
        f"{OPT_REL_TOL:g}), bf16 params within {ulps} ulp (tol {OPT_BF16_ULPS}), "
        f"{'bit for bit equal' if equal else 'not bit-equal'}"
        f"{' (required)' if exact else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def optim_kernel_checks(dev) -> None:
    """Phase 3 for K4 and K5 against their plain versions on the same
    leaves: bf16 and float32 params and gradients, ragged sizes (not
    multiples of 8), a leaf of 1 element, an empty one, leaves wider than
    a block's tile, and more leaves than one table of the kernel's
    parameter holds (150 > 128 for K4, > 64 for K5); for K5 also the edges
    of its tiles (tails of 1-7 elements after whole 8-vectors, a leaf
    shorter than one step of a block's threads, one step and a tile, each
    and one more or less) and half of each leaf's gradient and moments zero
    (``zero_halves``); every case run twice, bit for bit the same, and K5 bit
    for bit the plain update.  (Phase 6 checks them again at
    deepseek-7b's 20-layer leaves, the training step's.)"""
    from repro_torch.kernels.optim import adamw
    from repro_torch.kernels.optim.ref import adamw_update_ref, grad_sumsq_ref

    gen = torch.Generator(device=dev).manual_seed(21)
    base = [4096 * 11, 1, 7, 0, 300001, 64 * 129, 16385, 3]
    many = [int(n) for n in torch.randint(1, 20000, (150,), generator=torch.Generator()
                                          .manual_seed(22))]
    tile, step = adamw.UPDATE_TILE, adamw.THREADS * 8
    edges = [1, 2, 3, 4, 5, 6, 7, 9, 15, step - 1, step, step + 1, tile - 1, tile, tile + 1,
             2 * tile + 7]
    for tag, sizes in (("ragged", base), ("150 leaves", many), ("tile edges", edges),
                       ("zero halves", base)):
        for dt in (torch.bfloat16, torch.float32):
            grads = opt_leaves(sizes, dt, gen, dev, 0.3)
            got, again = adamw.grad_sumsq(grads), adamw.grad_sumsq(grads)
            want = grad_sumsq_ref(grads)
            check_rel(f"K4 grad_sumsq {tag} {len(sizes)} leaves {dt}", got, want, OPT_REL_TOL)
            if not torch.equal(got, again):
                raise SystemExit(f"K4 {tag} {dt}: two runs differ")
        for pdt, gdt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                         (torch.bfloat16, torch.float32)):
            p, g, mu, nu, scalars = optim_case(sizes, pdt, gdt, gen, dev)
            if tag == "zero halves":
                zero_halves(g, mu, nu)
            runs = []
            for fn in (adamw.adamw_update, adamw.adamw_update, adamw_update_ref):
                leaves = [[t.clone() for t in ts] for ts in (p, mu, nu)]
                fn(leaves[0], g, leaves[1], leaves[2], scalars, **OPT_HYPER)
                runs.append(leaves)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for x, y in zip(runs[0], runs[1]) for a, b in zip(x, y)):
                raise SystemExit(f"K5 {tag} {pdt}/{gdt}: two runs differ")
            check_update(f"K5 adamw_update {tag} {len(sizes)} leaves, params {pdt}, grads "
                         f"{gdt}", runs[0], runs[2], exact=True)
    log("[check] K4 and K5: every case's two runs bit for bit equal, K5 bit for bit the "
        "plain update")


def llava_decode_check(gen, dev) -> float:
    """Phase 3 for K2 at the llava engine's decode: a 3072 cache with 2944
    to 2975 valid positions per row (its first and last step), in bf16,
    elementwise and row by row, and the fault reading with a tile of the
    rows' keys dropped.  -> the largest elementwise error."""
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.decode.ref import flash_decode_ref

    b, s, h, kh, hd, dt = 2, LLAVA_CACHE, 32, 8, 128, torch.bfloat16
    q = rand((b, 1, h, hd), dt, gen, dev)
    k, v = rand((b, s, kh, hd), dt, gen, dev), rand((b, s, kh, hd), dt, gen, dev)
    kv = torch.arange(s, device=dev)
    last = torch.tensor([LLAVA_PROMPT + 31, LLAVA_PROMPT], device=dev)
    valid = kv[None, :] <= last[:, None]
    name = (f"K2 flash_decode q{(b, 1, h, hd)} cache{(b, s, kh, hd)} mask (B,S), the llava "
            f"engine's positions {last.tolist()} {dt}")
    got = fd.flash_decode(q, k, v, valid)
    plain = flash_decode_ref(q, k, v, valid)
    q32, k32, v32 = q.float(), k.float(), v.float()
    want = flash_decode_ref(q32, k32, v32, valid)
    check_rows(name, got, want)
    tile = (kv >= FAULT_TILE[0]) & (kv < FAULT_TILE[1])
    fault_reads(name, want, plain, flash_decode_ref(q32, k32, v32, valid & ~tile))
    return check(name, got, plain, TOL[dt])


def decode_skip_checks(gen, dev) -> None:
    """Phase 3 for K2's tile skipping, at the continuous server's cache
    shape in bf16: all-false tiles at the start, around a window band, in the
    middle and at the end of a row; a row with no valid position, which must
    come out as the mean of V over the cache; and a band slice."""
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.decode.ref import flash_decode_ref

    b, s, h, hd, dt = 4, 512, 32, 128, torch.bfloat16
    q = rand((b, 1, h, hd), dt, gen, dev)
    k, v = rand((b, s, h, hd), dt, gen, dev), rand((b, s, h, hd), dt, gen, dev)
    kv = torch.arange(s, device=dev)
    skip = torch.stack([kv >= 312, (kv >= 200) & (kv < 264),
                        (kv < 70) | ((kv >= 412) & (kv < 462)), kv <= 100])
    check(f"K2 flash_decode cache{(b, s, h, hd)} (B,S) mask, all-false tiles at the start, "
          "around a band, in the middle, at the end, bf16",
          fd.flash_decode(q, k, v, skip), flash_decode_ref(q, k, v, skip), TOL[dt])
    empty = skip.clone()
    empty[2] = False
    got = fd.flash_decode(q, k, v, empty)
    check(f"K2 flash_decode cache{(b, s, h, hd)} (B,S) mask, row 2 without a valid "
          "position, bf16", got, flash_decode_ref(q, k, v, empty), TOL[dt])
    check("K2 flash_decode row without a valid position against the mean of V",
          got[2].float(), v[2].float().mean(dim=0)[None], TOL[dt])
    band_k, band_v = k[:, 100:228], v[:, 100:228]
    valid = torch.arange(128, device=dev) < 90
    check(f"K2 flash_decode band slice [100:228] of cache{(b, s, h, hd)} (S,) mask, bf16",
          fd.flash_decode(q, band_k, band_v, valid),
          flash_decode_ref(q, band_k, band_v, valid), TOL[dt])


def decode_lse_checks(gen, dev) -> float:
    """Phase 3 for K2's row log-sum-exp (``return_lse``), at the shapes of
    the sequence-sharded decodes of phase 11 and of the engines: the output
    bit for bit K2's without it, against the plain version, and the lse
    against the plain version's (float32 either way), -inf for a chunk
    with no valid position.  -> the largest error of o at the main paths'
    shapes."""
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.decode.ref import flash_decode_ref

    worst = 0.0
    for (b, s, h, kh, hd, form, dt, main) in [
            (1, 8192, 32, 32, 128, "all", torch.bfloat16, True),     # deepseek long-KV chunk
            (1, 8192, 32, 32, 128, "none", torch.bfloat16, True),    # a chunk before its turn
            (4, 256, 32, 32, 128, "rows", torch.bfloat16, True),     # deepseek engine decode
            (2, 3072, 32, 8, 128, "rows", torch.bfloat16, True),     # llava engine decode
            (4, 32, 64, 4, 128, "rows", torch.float32, True),        # qwen3 (1, 8) chunk
            (4, 64, 16, 1, 256, "rows", torch.bfloat16, False)]:     # MQA, head dim 256
        q = rand((b, 1, h, hd), dt, gen, dev)
        k, v = rand((b, s, kh, hd), dt, gen, dev), rand((b, s, kh, hd), dt, gen, dev)
        kv = torch.arange(s, device=dev)
        if form == "rows":
            valid = kv[None, :] <= torch.randint(0, s, (b, 1), generator=gen, device=dev)
            valid[-1] = False       # and one row without a valid position
        else:
            valid = torch.full((s,), form == "all", dtype=torch.bool, device=dev)
        name = (f"K2 flash_decode with lse q{(b, 1, h, hd)} cache{(b, s, kh, hd)} "
                f"valid {form} {dt}")
        o, lse = fd.flash_decode(q, k, v, valid, return_lse=True)
        plain_o, plain_lse = flash_decode_ref(q, k, v, valid, return_lse=True)
        same = torch.equal(o, fd.flash_decode(q, k, v, valid))
        log(f"[check] {name}: o bit for bit K2's without lse: {same}")
        if not same:
            raise SystemExit(f"{name}: the lse output changes o")
        err = check(name + ", o", o, plain_o, TOL[dt])
        empty = torch.isneginf(plain_lse)
        if not torch.equal(torch.isneginf(lse), empty):
            raise SystemExit(f"{name}: -inf lse rows {torch.isneginf(lse).tolist()} are not "
                             f"the rows without a valid position {empty.tolist()}")
        if (~empty).any():
            check(name + f", lse ({int(empty.sum())} rows -inf)", lse[~empty],
                  plain_lse[~empty], TOL[torch.float32])
        else:
            log(f"[check] {name}, lse: every row -inf, as no position is valid: ok")
        if main:
            worst = max(worst, err)
    return worst


def logits_check(eng, cfg, dev) -> None:
    """Phase 4a: full-width prefill and one decode step, kernel path against
    plain path on the same weights and tokens."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.decode.ref import flash_decode_ref
    from repro_torch.models import api

    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device=dev)

    def run():
        last, cache = api.prefill(eng.params, {"tokens": tokens}, cfg, 256, last_pos=99)
        step, _ = api.decode_step(eng.params, cache, nxt, 100, cfg)
        return last.float(), step.float()

    kern = run()
    with mock.patch.object(dispatch, "flash_attention", flash_attention_ref), \
            mock.patch.object(dispatch, "flash_decode", flash_decode_ref):
        plain = run()
    for what, a, b in zip(("prefill last logits", "decode-step logits"), kern, plain):
        rel = ((a - b).norm() / b.norm()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"[model] {what} (4,{cfg.vocab_size}): kernel vs plain rel_l2={rel:.3e} "
            f"(tol {LOGITS_REL_TOL:g}) max_abs={(a - b).abs().max().item():.3e} "
            f"argmax agreement={agree:.2f}")
        if not torch.isfinite(a).all() or rel > LOGITS_REL_TOL:
            raise SystemExit(f"full-width {what}: kernel path disagrees with plain path")


def uncaptured():
    """New decode steps, prefills and CNN forwards stay uncaptured: their
    ``replay`` then runs the step function itself, through the same static
    buffers, on the card.  The reference that the replayed steps are held
    against."""
    from repro_torch.serving import graphs
    return mock.patch.object(graphs.CapturedStep, "capture", lambda self: None)


def serve(srv, reqs) -> tuple[dict, float]:
    """Drain ``reqs`` through ``srv``: ({rid: tokens}, wall seconds).  The
    seconds spent in admission rounds (prefill, scatter and the first
    tokens' copy to the host, which waits for them) and their count are
    kept in ``srv.split``."""
    admit = srv._admit
    split = {"admit_s": 0.0, "rounds": 0}

    def timed_admit():
        t0 = time.perf_counter()
        admitted = bool(srv.queue) and not srv.active.all()
        admit()
        split["admit_s"] += time.perf_counter() - t0
        split["rounds"] += admitted

    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    with mock.patch.object(srv, "_admit", timed_admit):
        done = srv.run()
    torch.cuda.synchronize()
    srv.split = split
    return {c.rid: c.tokens for c in done}, time.perf_counter() - t0


def graph_runs(step_graphs) -> int:
    """The steps of ``step_graphs`` that ran on the card: each capture's
    warm-up step and each replay."""
    return sum(g.replays + g.captured for g in step_graphs)


def pool_mb(pool) -> float:
    """MB the caching allocator holds for the graph memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool)) / 1e6


def deepseek_inputs(cfg) -> tuple:
    """The engine's prompts (4, 100) and the server's 8 requests."""
    from repro_torch.serving.continuous import Request

    prompts = torch.randint(0, cfg.vocab_size, (4, 100), generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=int(rng.integers(20, 301))).tolist(),
                    n_new=int(rng.integers(8, 25))) for i in range(8)]
    return prompts, reqs


def uncaptured_tokens(eng, prompts, reqs=None, n_new: int = 32) -> dict:
    """The uncaptured prefill's logits and the tokens of the uncaptured
    prefill and decode step on the card, on ``eng``'s weights: the engine
    greedy and sampled (``n_new`` tokens), and the server's completions and
    its drain's split between admission and decode."""
    from repro_torch.serving.continuous import ContinuousServer
    from repro_torch.serving.engine import InferenceEngine

    with uncaptured():
        plain = InferenceEngine(eng.cfg, params=eng.params, max_cache=eng.max_cache)
        logits, _ = plain._prefill(*plain._prompt(prompts, n_new))
        out = {"prefill": logits.clone(),
               "greedy": plain.generate(prompts, n_new).tokens,
               "sampled": plain.generate(prompts, n_new, temperature=SAMPLE_T,
                                         seed=SAMPLE_SEED).tokens}
        if reqs is not None:
            srv = ContinuousServer(eng.cfg, slots=4, max_seq=512, params=eng.params)
            out["server"], wall = serve(srv, reqs)
            out["server split"] = dict(srv.split, wall_s=wall)
            if srv.compile_stats()["graphs"] or srv.compile_stats()["prefill_graphs"]:
                raise SystemExit("the uncaptured server captured a graph")
    if plain.compile_stats()["graphs"] or plain.compile_stats()["prefill_graphs"]:
        raise SystemExit("the uncaptured engine captured a graph")
    return out


def prefill_check(eng, prompts, want, n_new: int = 32) -> float:
    """Phase 4: the engine's replayed prefill of ``prompts`` (capturing its
    graph at the first use) against the uncaptured prefill's logits, on the
    card.  -> the largest difference."""
    tokens, last_pos, cache_len = eng._prompt(prompts, n_new)
    got, _ = eng._prefill(tokens, last_pos, cache_len)
    graph = eng._prefills[tuple(tokens.shape)]
    if not graph.captured:
        raise SystemExit(f"{eng.cfg.name}: the prefill graph {tuple(tokens.shape)} was "
                         "not captured")
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    log(f"[graph] {eng.cfg.name} prefill {tuple(tokens.shape)}, replayed vs uncaptured "
        f"logits {tuple(got.shape)}: max abs difference {err:.3e}"
        f"{' (bit for bit equal)' if err == 0 else ''}")
    check(f"{eng.cfg.name} replayed prefill logits", got, want, TOL[got.dtype])
    return err


def same_tokens(what: str, got, want) -> None:
    ok = torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want
    log(f"[graph] {what}: replayed tokens equal the uncaptured step's: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: the replayed decode step's tokens differ from the "
                         "uncaptured step's")


class StepRecorder:
    """Records what two greedy runs of an engine computed, so that runs
    that part can say where.  While ``recording()`` is open the engine's
    decode step, captured then, copies each step's logits into a static
    buffer at a row that the step advances on the device (modulo the
    buffer's rows, so replays after the check stay in bounds: two small
    copies a step, which live as long as the step, kept on it).  ``take()``
    returns the run's step logits, its replayed prefill's logits and its
    cache, cloned."""

    def __init__(self, eng, batch: int, n_new: int):
        dev = eng.device
        self.rows = max(n_new - 1, 1)
        self.logits = torch.zeros((self.rows, batch, eng.cfg.vocab_size), dtype=eng.cfg.cdt,
                                  device=dev)
        self.row = torch.zeros((1,), dtype=torch.long, device=dev)

    def recording(self):
        from repro_torch.models import api

        decode_step = api.decode_step

        def recorded(*args, **kw):
            logits, cache = decode_step(*args, **kw)
            self.logits.index_copy_(0, torch.remainder(self.row, self.rows),
                                    logits[None].to(self.logits.dtype))
            self.row.add_(1)
            return logits, cache
        return mock.patch.object(api, "decode_step", recorded)

    def take(self, eng, shape) -> dict:
        from repro_torch.models.common import tensor_leaves

        out = {"steps": self.logits.clone(), "prefill": eng._prefills[shape].logits.clone(),
               "cache": [t.clone() for t in tensor_leaves(eng._cache)]}
        self.row.zero_()
        return out


def explain_split(cfg, first, second, runs: list, s: int) -> str:
    """Where two greedy runs on the same prompts part: the first token that
    differs (0: the prefill's), both runs' top-5 logits there for the rows
    that differ, the largest difference of those logits (every row), and of
    the KV cache at the positions written up to that step (the whole
    recurrent state for a family without a KV cache)."""
    rows, steps = (first != second).nonzero(as_tuple=True)
    step = int(steps.min())
    if step == 0:
        a, b = runs[0]["prefill"].float(), runs[1]["prefill"].float()
        where = "the replayed prefill's logits"
    else:
        a, b = runs[0]["steps"][step - 1].float(), runs[1]["steps"][step - 1].float()
        where = f"decode step {step - 1}'s logits"
    lines = [f"[split] {cfg.name}: the two greedy runs first differ at token {step} "
             f"(rows {sorted(set(rows[steps == step].tolist()))}; {len(rows)} tokens in "
             f"all); {where}: max |difference| {(a - b).abs().max().item():.6e} over "
             f"every row" + (" (not recorded: the decode graph existed before the check)"
                             if step and not runs[0]["steps"].any() else "")]
    for r in sorted(set(rows[steps == step].tolist())):
        for n, x in (("first", a), ("second", b)):
            top = torch.topk(x[r], 5)
            lines.append(f"[split]   row {r} {n} run top-5: " + ", ".join(
                f"{int(i)}:{float(v):.6f}" for v, i in zip(top.values, top.indices)))
    kv = cfg.family in ("dense", "moe", "vlm")
    diff = 0.0
    for x, y in zip(runs[0]["cache"], runs[1]["cache"]):
        if kv:   # (L,B,S,K,hd): the positions up to the differing step
            x, y = x[:, :, :s + step], y[:, :, :s + step]
        diff = max(diff, (x.float() - y.float()).abs().max().item())
    lines.append(f"[split]   max |difference| of the cache "
                 f"{f'at positions < {s + step}' if kv else '(the whole state)'} after "
                 f"each run: {diff:.6e}")
    return "\n".join(lines)


def engine_path(eng, cfg, want: dict, prompts, n_new: int = 32) -> dict:
    """Phase 4b, the engine: one prefill, then greedy twice and sampled once
    (``n_new`` tokens), each prefill and decode step a replay of its
    captured graph, held against the uncaptured prefill's logits and the
    uncaptured path's tokens.  Where the two greedy runs differ, it prints
    where they part (``explain_split``) and fails.  Returns the rates, the
    prefills and the decode steps that ran on the card (replays and each
    capture's warm-up step)."""
    b, s = prompts.shape
    graphs = eng.compile_stats()["graphs"]
    prefill_err = prefill_check(eng, prompts, want["prefill"], n_new)
    shape = tuple(eng._prompt(prompts, n_new)[0].shape)
    rec = StepRecorder(eng, b, n_new)
    with rec.recording():
        step = eng._decoder(b, 0.0)   # captured now, the recorder in it
    # the captured step writes into the recorder's buffers at every replay:
    # they must live as long as the step does (phase 7 replays it again)
    step.recorder = rec
    rec.row.zero_()                   # the capture's warm-up step wrote row 0
    first = eng.generate(prompts, n_new)
    runs = [rec.take(eng, shape)]
    res = eng.generate(prompts, n_new)
    runs.append(rec.take(eng, shape))
    toks = res.tokens
    if toks.shape != (b, n_new) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit(f"{cfg.name} generate: bad tokens {toks.shape}")
    if not torch.equal(first.tokens, toks):
        last_pos = eng._prompt(prompts, n_new)[1]
        log(explain_split(cfg, first.tokens, toks, runs,
                          s if last_pos is None else last_pos + 1))
        rows, steps = (first.tokens != toks).nonzero(as_tuple=True)
        raise SystemExit(f"{cfg.name} generate: two greedy runs on the same prompts differ, "
                         f"first at row {int(rows[0])}, token {int(steps[0])} "
                         f"({len(rows)} tokens in all); the first run equals the uncaptured "
                         f"path's: {torch.equal(first.tokens, want['greedy'])}, the second: "
                         f"{torch.equal(toks, want['greedy'])}")
    recorded = int((runs[0]["steps"] != 0).flatten(1).any(1).sum())
    log(f"[graph] {cfg.name} two replayed greedy runs: tokens equal; of their {recorded} "
        f"recorded steps the logits equal bit for bit: "
        f"{torch.equal(runs[0]['steps'], runs[1]['steps'])}, the prefill logits: "
        f"{torch.equal(runs[0]['prefill'], runs[1]['prefill'])}, the caches: "
        f"{all(torch.equal(x, y) for x, y in zip(runs[0]['cache'], runs[1]['cache']))}")
    del runs
    same_tokens(f"{cfg.name} engine greedy, batch {b}, {n_new} new", toks, want["greedy"])
    sampled = eng.generate(prompts, n_new, temperature=SAMPLE_T, seed=SAMPLE_SEED)
    same_tokens(f"{cfg.name} engine sampled (temperature {SAMPLE_T}, seed {SAMPLE_SEED})",
                sampled.tokens, want["sampled"])
    prompt = (f"{s} (bucket {eng._prefill_shapes(s, n_new)[0]})" if cfg.family == "dense"
              else f"{s} (exact)")
    log(f"[engine] {cfg.name} generate batch {b}, prompt {prompt}, max_cache "
        f"{eng.max_cache}, {n_new} new: prefill {res.prefill_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms, {res.tokens_per_s:.1f} tok/s; sampled "
        f"{sampled.tokens_per_s:.1f} tok/s; graphs captured {eng.compile_stats()['graphs']}")
    return {"prefill_ms": res.prefill_s * 1e3, "decode_tok_s": res.tokens_per_s,
            "steps": 3 * (n_new - 1) + eng.compile_stats()["graphs"] - graphs,
            "prefills": graph_runs(eng._prefills.values()), "prefill_err": prefill_err}


def main_path(eng, cfg, want: dict, prompts, reqs) -> dict:
    """Phase 4b: the engine (``engine_path``) and the continuous server (the
    8 requests twice) at full width, each prefill, admission and decode
    step a replay of its captured graph (a MoE server's admissions a
    batch-1 graph per exact prompt length), held against the uncaptured
    path's tokens and completion order.  Returns the engine's numbers with
    the server's rate and its prefills (admission replays and capture
    warm-ups) and decode steps added, and the server's drains split
    between admission and decode (the first drain, which captures, too)."""
    from repro_torch.serving.continuous import ContinuousServer

    out = engine_path(eng, cfg, want, prompts)
    srv = ContinuousServer(cfg, slots=4, max_seq=512, params=eng.params)
    got, first_wall = serve(srv, reqs)
    first_split = dict(srv.split, wall_s=first_wall)
    same_tokens(f"{cfg.name} server, 8 requests on 4 slots", got, want["server"])
    if list(got) != list(want["server"]):
        raise SystemExit(f"{cfg.name} server: completion order {list(got)}, uncaptured "
                         f"{list(want['server'])}")
    got, wall = serve(srv, reqs)
    same_tokens(f"{cfg.name} server, the same 8 requests again on its graph", got,
                want["server"])
    if list(got) != list(want["server"]):
        raise SystemExit(f"{cfg.name} server: completion order {list(got)} on its graphs, "
                         f"uncaptured {list(want['server'])}")
    if any(len(got[r.rid]) != r.n_new for r in reqs):
        raise SystemExit(f"continuous server: completions {[len(t) for t in got.values()]}"
                         f" do not match the requests")
    if any(not 0 <= t < cfg.vocab_size for t in sum(got.values(), [])):
        raise SystemExit("continuous server: token out of the vocabulary")
    n_tok = sum(r.n_new for r in reqs)
    log(f"[server] {cfg.name} 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, 4 slots, max_seq 512: {n_tok} tokens "
        f"in {wall:.3f} s ({n_tok / wall:.1f} tok/s; the first drain, which captures, "
        f"{first_wall:.3f} s), {srv.steps} decode steps over both")
    admissions = [g for g, _ in srv._admissions.values()] + list(srv._exact.values())
    split = {"replayed": dict(srv.split, wall_s=wall), "first drain, capturing": first_split,
             "uncaptured": want["server split"]}
    for name, sp in split.items():
        log(f"[server] {cfg.name} drain split, {name}: {sp['wall_s']:.3f} s = admission "
            f"{sp['admit_s']:.3f} s in {sp['rounds']} rounds (prefill, scatter and the "
            f"first tokens) + decode and host bookkeeping {sp['wall_s'] - sp['admit_s']:.3f} s"
            + (" (PR 18, eager exact-length admissions: admission 0.342 of 0.697 s)"
               if cfg.family == "moe" and name == "replayed" else ""))
    staging = sum(t.numel() * t.element_size() for t in (srv._staging or {}).values())
    log(f"[memory] {cfg.name} server admission graphs: buckets {sorted(srv._admissions)}, "
        f"exact lengths {sorted(srv._exact)}, their shared pool {pool_mb(srv._pool):.1f} MB, "
        f"the staging cache {staging / 1e6:.1f} MB; the engine's prefill graphs "
        f"{sorted(eng._prefills)}, pool {pool_mb(eng._pool):.1f} MB")
    out.update(server_tok_s=n_tok / wall, split=split,
               steps=out["steps"] + srv.steps + srv.compile_stats()["graphs"],
               prefills=out["prefills"] + graph_runs(admissions))
    return out


def redraw_wo(params, cfg, dev) -> None:
    """Each rwkv layer's ``tmix.wo`` drawn anew from N(0, 1/d) (seed 6), in
    the param dtype: the init's 0 cuts the WKV branch, K3 included, out of
    the logits and the gradient."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for lp in params["layers"]:
        lp["tmix"]["wo"]["w"] = (rand((cfg.d_model, cfg.d_model), torch.float32, gen, dev)
                                 * cfg.d_model ** -0.5).to(cfg.pdt)


def rwkv_engine(cfg, dev):
    """The rwkv engine on seeded weights, with each layer's time-mix output
    projection ``wo`` drawn anew from N(0, 1/d).  The model's own init
    draws ``wo`` at scale 0, and then the whole WKV branch — K3 included —
    adds exactly nothing to the logits, so no check of the logits would
    see K3."""
    from repro_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, seed=0, max_cache=256)
    redraw_wo(eng.params, cfg, dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{eng.stats()['params'] / 1e9:.3f} B params {cfg.param_dtype}, seeded init "
        f"with wo redrawn {time.perf_counter() - t0:.1f} s")
    return eng


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def redraw_bn(tree, gen):
    """``tree`` with every folded BatchNorm's scale drawn from U(0.5, 1.5)
    and its bias from N(0, 0.1) on ``gen``'s device: the init's 1 and 0
    would hide a BatchNorm dropped or broadcast on the wrong axis."""
    if isinstance(tree, list):
        return [redraw_bn(t, gen) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias"}:
        c, dev = tree["scale"].shape, tree["scale"].device
        return {"scale": 0.5 + torch.rand(c, generator=gen, device=dev),
                "bias": 0.1 * torch.randn(c, generator=gen, device=dev)}
    return {k: redraw_bn(v, gen) for k, v in tree.items()}


def rwkv_logits_check(params, cfg, dev) -> None:
    """Phase 4a for rwkv: a full-width prefill of 100 tokens and one decode
    step, kernel path against plain path on the same weights and tokens;
    the logits and the wkv state after each, held to ``RWKV_REL_TOL`` of
    the compute dtype."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import api

    tol = RWKV_REL_TOL[cfg.cdt]

    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (4, 100), generator=gen, device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device=dev)

    def run():
        last, state = api.prefill(params, {"tokens": tokens}, cfg)
        wkv_prefill = state["wkv"].clone()
        step, state = api.decode_step(params, state, nxt, 100, cfg)
        return last.float(), wkv_prefill, step.float(), state["wkv"]

    kern = run()
    with mock.patch.object(dispatch, "rwkv_scan", plain_scan):
        plain = run()
    for what, a, b in zip(("prefill last logits", "wkv state after prefill",
                           "decode-step logits", "wkv state after decode"), kern, plain):
        rel = ((a - b).norm() / b.norm()).item()
        agree = ""
        if "logits" in what:
            agree = f" argmax agreement={(a.argmax(-1) == b.argmax(-1)).float().mean().item():.2f}"
        log(f"[model] {cfg.name} {cfg.compute_dtype} {what} {tuple(a.shape)}: kernel vs "
            f"plain rel_l2={rel:.3e} (tol {tol:g}) max_abs={(a - b).abs().max().item():.3e}"
            f"{agree}")
        if not torch.isfinite(a).all() or rel > tol:
            raise SystemExit(f"full-width {cfg.name} {cfg.compute_dtype} {what}: kernel "
                             "path disagrees with plain path")


def rwkv_main_path(eng, cfg, want: dict) -> dict:
    """Phase 4b for rwkv: the engine at batch 4, prompt 100 (exact, no
    bucket), 32 new tokens, through one prefill, ``generate`` twice and
    ``generate_stream`` greedy and ``generate`` sampled, each prefill and
    decode step a replay, held against the uncaptured prefill's logits and
    the uncaptured path's tokens.  Returns the rates, the prefills and the
    decode steps that ran on the card (replays and capture warm-ups)."""
    gen = torch.Generator().manual_seed(8)
    prompts = torch.randint(0, cfg.vocab_size, (4, 100), generator=gen)
    prefill_err = prefill_check(eng, prompts, want["prefill"])
    first = eng.generate(prompts, 32)
    res = eng.generate(prompts, 32)
    toks = res.tokens
    if toks.shape != (4, 32) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit(f"{cfg.name} generate: bad tokens {toks.shape}")
    if not torch.equal(first.tokens, toks):
        raise SystemExit(f"{cfg.name} generate: two greedy runs on the same prompts differ")
    same_tokens(f"{cfg.name} engine greedy, batch 4, 32 new", toks, want["greedy"])
    stream = eng.generate_stream(prompts, 32)
    if not torch.equal(stream.tokens, toks):
        raise SystemExit(f"{cfg.name}: generate_stream's tokens differ from generate's")
    sampled = eng.generate(prompts, 32, temperature=SAMPLE_T, seed=SAMPLE_SEED)
    same_tokens(f"{cfg.name} engine sampled (temperature {SAMPLE_T}, seed {SAMPLE_SEED})",
                sampled.tokens, want["sampled"])
    log(f"[engine] {cfg.name} generate batch 4, prompt 100 (exact), 32 new: prefill "
        f"{res.prefill_s * 1e3:.3f} ms, decode {res.decode_s * 1e3:.3f} ms, "
        f"{res.tokens_per_s:.1f} tok/s; generate_stream equal, "
        f"{stream.tokens_per_s:.1f} tok/s; sampled {sampled.tokens_per_s:.1f} tok/s; "
        f"graphs captured {eng.compile_stats()['graphs']}")
    return {"prefill_ms": res.prefill_s * 1e3, "decode_tok_s": res.tokens_per_s,
            "prefills": graph_runs(eng._prefills.values()),
            "steps": 4 * 31 + eng.compile_stats()["graphs"], "prefill_err": prefill_err}


def rwkv_uncaptured_tokens(eng) -> dict:
    gen = torch.Generator().manual_seed(8)
    prompts = torch.randint(0, eng.cfg.vocab_size, (4, 100), generator=gen)
    return uncaptured_tokens(eng, prompts)


def moe_logits_check(params, cfg, dev) -> None:
    """Phase 4a for granite: a full-width prefill of (4, 100) tokens at the
    exact length and one decode step, kernel path against plain path on the
    same weights and tokens.  The plain path takes the kernel path's expert
    routes (its ``torch.topk`` returns the kernel run's indices, in call
    order, and its own probabilities there): otherwise a rounding
    difference in attention that reorders two experts' scores at a token's
    top-8 boundary (routing flips) would send that token elsewhere, and the
    logits would differ with no kernel at fault.  How many routes the plain
    path would have chosen otherwise is counted and printed.  In float32
    the logits are held to ``MOE_REL_TOL``; in bf16 they are printed."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.decode.ref import flash_decode_ref
    from repro_torch.models import api

    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (4, 100), generator=gen, device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device=dev)
    topk, routes, differ = torch.topk, [], [0, 0]

    def recording(probs, k, dim=-1):
        out = topk(probs, k, dim=dim)
        routes.append(out.indices)
        return out

    def replaying(probs, k, dim=-1):
        idx = routes[differ[1]]
        own = topk(probs, k, dim=dim).indices
        differ[0] += int((own[..., :, None] != idx[..., None, :]).all(-1).sum())
        differ[1] += 1
        return torch.gather(probs, dim, idx), idx

    def run():
        last, cache = api.prefill(params, {"tokens": tokens}, cfg, 256)
        step, _ = api.decode_step(params, cache, nxt, 100, cfg)
        return last.float(), step.float()

    with mock.patch.object(torch, "topk", recording):
        kern = run()
    with mock.patch.object(dispatch, "flash_attention", flash_attention_ref), \
            mock.patch.object(dispatch, "flash_decode", flash_decode_ref), \
            mock.patch.object(torch, "topk", replaying):
        plain = run()
    n_routes = sum(r.numel() for r in routes)
    if differ[1] != len(routes) or len(routes) != 2 * cfg.num_layers:
        raise SystemExit(f"{cfg.name}: {len(routes)} routings recorded, {differ[1]} replayed, "
                         f"not 2 x {cfg.num_layers} layers")
    gated = cfg.cdt == torch.float32
    for what, a, b in zip(("prefill last logits", "decode-step logits"), kern, plain):
        rel = ((a - b).norm() / b.norm()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"[model] {cfg.name} {cfg.compute_dtype} {what} {tuple(a.shape)}: kernel vs plain "
            f"on the kernel path's routes rel_l2={rel:.3e} "
            f"({f'tol {MOE_REL_TOL:g}' if gated else 'reported, not held'}) "
            f"max_abs={(a - b).abs().max().item():.3e} argmax agreement={agree:.2f}")
        if not torch.isfinite(a).all() or (gated and rel > MOE_REL_TOL):
            raise SystemExit(f"full-width {cfg.name} {cfg.compute_dtype} {what}: kernel "
                             "path disagrees with plain path")
    log(f"[model] {cfg.name} {cfg.compute_dtype}: the plain path's own router picks another "
        f"expert for {differ[0]} of {n_routes} (token, choice) routes "
        f"({differ[0] / n_routes:.3e}) over the prefill and the step")


def granite_engine(cfg, dev):
    from repro_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, seed=0, max_cache=256)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok} of d_ff {cfg.d_ff}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}, "
        f"{eng.stats()['params'] / 1e9:.3f} B params {cfg.param_dtype}, seeded init "
        f"{time.perf_counter() - t0:.1f} s")
    return eng


def kernel_counts(cfg, e2e: dict) -> dict:
    """The K1 and K2 launches since the counts were set to 0, held to layers
    x prefills and layers x decode steps of the path's run ``e2e``."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv

    launches = {"flash_attention": flash.launches, "flash_decode": fd.launches}
    log(f"[kernels] launches on the {cfg.name} path: {launches}, wkv6 {wkv.launches}; "
        f"{e2e['steps']} decode steps on the card (replays and capture warm-ups) x "
        f"{cfg.num_layers} layers = {e2e['steps'] * cfg.num_layers}; {e2e['prefills']} "
        f"prefills (replays, capture warm-ups and eager admissions) x {cfg.num_layers} "
        f"layers = {e2e['prefills'] * cfg.num_layers}")
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel of the {cfg.name} path never launched: {launches}")
    if fd.launches != cfg.num_layers * e2e["steps"]:
        raise SystemExit(f"K2 launched {fd.launches} times on {cfg.name}, not layers x steps "
                         f"{cfg.num_layers * e2e['steps']}")
    if flash.launches != cfg.num_layers * e2e["prefills"]:
        raise SystemExit(f"K1 launched {flash.launches} times on {cfg.name}, not layers x "
                         f"prefills {cfg.num_layers * e2e['prefills']}")
    return launches


def timings(dev) -> dict:
    """Phase 6: each kernel at its paths' shapes, by CUDA events and by
    device time, beside its bound, its plain version and a library call."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.decode.ref import flash_decode_ref
    from repro_torch.kernels.rwkv import wkv

    gen = torch.Generator(device=dev).manual_seed(4)
    dt, out = torch.bfloat16, {}

    def bhsd(*xs):   # the library's (B,H,S,hd) layout, as views
        return tuple(x.transpose(1, 2) for x in xs)

    def row(shape, kernel, plain, library, sets, bound_):
        ms, plain_ms = time_ms(kernel, sets), time_ms(plain, sets)
        lib_ms = None if library is None else time_ms(library, sets)
        return dict(shape=shape, ms=ms, device_ms=device_ms(kernel, sets), plain_ms=plain_ms,
                    plain_device_ms=device_ms(plain, sets), library_ms=lib_ms,
                    library_device_ms=None if library is None else device_ms(library, sets),
                    bound=bound_)

    # K1 at deepseek's engine prefill (batch 4, bucket 128), its server's
    # admission prefill (4 slots, bucket 512), granite's engine prefill
    # (batch 4, 100 tokens exact, GQA 24/8, head dim 64) and llava's (batch
    # 2, 2880 image and 64 text positions exact, GQA 32/8)
    for tag, (b, s, h, kh, hd) in (("", (4, 128, 32, 32, 128)),
                                   ("server", (4, 512, 32, 32, 128)),
                                   ("granite", (4, 100, 24, 8, 64)),
                                   ("llava", (2, 2944, 32, 8, 128))):
        nbytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * 2   # q, k, v in; o out
        flops = 4 * hd * h * b * s * (s + 1) // 2   # QK^T and PV over the causal pairs
        sets = cold_copies(lambda: (rand((b, s, h, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev)), nbytes)
        out["flash_attention" + (f" {tag}" if tag else "")] = row(
            f"q {(b, s, h, hd)} kv heads {kh} bf16 causal",
            lambda q, k, v: flash.flash_attention(q, k, v),
            lambda q, k, v: flash_attention_ref(q, k, v),
            lambda q, k, v, gqa=h != kh: F.scaled_dot_product_attention(
                *bhsd(q, k, v), is_causal=True, enable_gqa=gqa),
            sets, bound(nbytes, flops, dt))

    # K2 at deepseek's engine's last decode step (100 + 32 positions of a 256
    # cache, one (S,) mask), at its server's (a 512 cache, a (B,S) mask whose
    # rows end in different tiles), at granite's engine's last step and at
    # llava's (batch 2, 2944 + 32 positions of a 3072 cache, the engine's
    # (B,S) mask)
    kv = torch.arange(3072, device=dev)
    for tag, b, s, valid, (h, kh, hd) in (
            ("", 4, 256, kv[:256] < 132, (32, 32, 128)),
            ("server", 4, 512, kv[None, :512] <= torch.tensor([[40], [170], [300], [470]],
                                                              device=dev), (32, 32, 128)),
            ("granite", 4, 256, kv[:256] < 132, (24, 8, 64)),
            ("llava", 2, 3072, (kv < 2976)[None].repeat(2, 1), (32, 8, 128))):
        n_valid = int(valid.sum()) * (b if valid.dim() == 1 else 1)   # over the batch
        # the valid positions of the cache are read, q read, o written, the mask read
        nbytes = (2 * b * h * hd + 2 * n_valid * kh * hd) * 2 + valid.numel()
        flops = 4 * hd * h * n_valid
        mask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
        sets = cold_copies(lambda: (rand((b, 1, h, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev)), 4 * b * s * kh * hd)
        ends = (f"{int(valid.sum())} valid" if valid.dim() == 1 else
                f"rows valid to {[int(r.sum()) for r in valid]}")
        out["flash_decode" + (f" {tag}" if tag else "")] = row(
            f"q {(b, 1, h, hd)} cache {(b, s, kh, hd)} bf16, {ends}",
            lambda q, k, v, valid=valid: fd.flash_decode(q, k, v, valid),
            lambda q, k, v, valid=valid: flash_decode_ref(q, k, v, valid),
            lambda q, k, v, mask=mask, gqa=h != kh: F.scaled_dot_product_attention(
                *bhsd(q, k, v), attn_mask=mask, enable_gqa=gqa),
            sets, bound(nbytes, flops, dt))
        if not tag:
            out["flash_decode"]["host_us"] = host_us(
                lambda q, k, v: fd.flash_decode(q, k, v, valid), sets[0])
    # K2 at the long-KV decode: a rank's chunk of deepseek-7b's 16,384-position
    # cache (batch 1, 8,192 positions, all valid at the last step) and the
    # whole cache on one card (the 8,208 positions of an 8,176-token prompt
    # and 32 new tokens valid), each without and with the row lse
    for tag, s, n_valid in (("chunk", 8192, 8192), ("long", 16384, 8208)):
        b, h, kh, hd = 1, 32, 32, 128
        valid = kv_long = torch.arange(s, device=dev) < n_valid
        nbytes = (2 * b * h * hd + 2 * n_valid * kh * hd) * 2 + s
        flops = 4 * hd * h * n_valid
        mask = kv_long[None, None, None, :]
        sets = cold_copies(lambda: (rand((b, 1, h, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev),
                                    rand((b, s, kh, hd), dt, gen, dev)), 4 * b * s * kh * hd)
        out[f"flash_decode {tag}"] = r = row(
            f"q {(b, 1, h, hd)} cache {(b, s, kh, hd)} bf16, {n_valid} valid",
            lambda q, k, v, valid=valid: fd.flash_decode(q, k, v, valid),
            lambda q, k, v, valid=valid: flash_decode_ref(q, k, v, valid),
            lambda q, k, v, mask=mask: F.scaled_dot_product_attention(*bhsd(q, k, v),
                                                                      attn_mask=mask),
            sets, bound(nbytes + 4 * b * h, flops, dt))
        lse_fn = (lambda q, k, v, valid=valid: fd.flash_decode(q, k, v, valid, return_lse=True))
        r.update(lse_ms=time_ms(lse_fn, sets), lse_device_ms=device_ms(lse_fn, sets))
    out["flash_attention"]["host_us"] = host_us(
        lambda q, k, v: flash.flash_attention(q, k, v),
        (rand((4, 128, 32, 128), dt, gen, dev), rand((4, 128, 32, 128), dt, gen, dev),
         rand((4, 128, 32, 128), dt, gen, dev)))

    # K3 at the rwkv engine's prefill (the row) and decode-step shapes, the
    # state updated in place as the model does; no PyTorch call computes the
    # WKV recurrence, so there is no library time
    for tag, (b, t, h, hd) in (("", (4, 100, 32, 64)), ("decode", (4, 1, 32, 64))):
        seq_bytes, state_bytes = 4 * b * t * h * hd, 4 * b * h * hd * hd
        # r, k, v, w in and o out; u in; the state in and out
        nbytes = 5 * seq_bytes + 4 * h * hd + 2 * state_bytes
        # per (i, j): r*S into the sum, k*v, w*S + kv; the bonus term factors
        # into v_j * sum_i r_i u_i k_i, about 4 more per j
        flops = (5 * hd + 4) * hd * b * t * h
        sets = cold_copies(lambda: wkv_inputs(b, t, h, hd, gen, dev),
                           4 * seq_bytes + state_bytes)
        out["wkv6" + (f" {tag}" if tag else "")] = row(
            f"r/k/v/w {(b, t, h, hd)} float32, state in place",
            lambda r, k, v, w, u, s0: wkv.wkv6(r, k, v, w, u, s0, out_state=s0),
            lambda r, k, v, w, u, s0: plain_scan(r, k, v, w, u, s0, out_state=s0),
            None, sets, bound(nbytes, flops, torch.float32))
        if tag:
            out["wkv6 decode"]["host_us"] = host_us(
                lambda r, k, v, w, u, s0: wkv.wkv6(r, k, v, w, u, s0, out_state=s0), sets[0])
    out["wkv6 plans"] = wkv6_plans(gen, dev)
    return out


def wkv6_plans(gen, dev) -> dict:
    """K3's device and event times at the engine's prefill shape under split_plan's
    plan and under narrower CTAs (more of them per head), and at one head
    alone: whether the split or the step loop holds the kernel.  These
    launches go to the kernel directly and are not counted."""
    from repro_torch.kernels.rwkv import wkv

    def launch(plan):
        def call(r, k, v, w, u, s0):
            b, t, h, hd = r.shape
            o = torch.empty_like(r)
            err = wkv._kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                u.data_ptr(), s0.data_ptr(), o.data_ptr(), s0.data_ptr(),
                                b, t, h, hd, *plan, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"K3 under plan {plan}: CUDA error {err}")
        return call

    out = {}
    for (b, t, h, hd) in ((4, 100, 32, 64), (1, 100, 1, 64)):
        sets = cold_copies(lambda: wkv_inputs(b, t, h, hd, gen, dev),
                           4 * (4 * b * t * h * hd + b * h * hd * hd))
        p, cols, lanes = wkv.split_plan(hd)
        for c in ((cols, cols // 2, cols // 4) if b * h > 1 else (cols,)):
            plan = (hd // c, c, lanes)
            out[f"{(b, t, h, hd)} plan {plan}"] = (device_ms(launch(plan), sets),
                                                    time_ms(launch(plan), sets))
    return out


# the CUDA API calls (`cuda*` and `cu*`) that put work on a stream, as the
# profiler names them: a kernel launch, a graph launch, a copy, a fill
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def profiled(tag, setup, body, n, nbytes, flops, watch=(), dtype=torch.bfloat16,
             top=10, require=()) -> dict:
    """Host wall of ``body(setup())`` per one of its ``n`` calls, then its
    device time by kernel from torch.profiler, beside the bound (operations
    at ``dtype``'s peak): the ``top`` largest kernels, and any kernel whose
    name holds a string of ``watch``; fails if no kernel's name holds a
    string of ``require``.  Returns the host wall (``wall``), the device
    time (``device``, 0: not measured), the kernel launches
    (``launches``), the host's launch calls (``calls``, ``LAUNCH_CALLS``)
    and its graph launches (``graphs``), per call, in ms where a time."""
    from torch.profiler import ProfilerActivity, profile

    def once(around=contextlib.nullcontext()) -> float:
        state = setup()
        torch.cuda.synchronize()
        with around:
            t0 = time.perf_counter()
            body(state)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    once()
    wall_ms = once()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    once(prof)
    events = prof.key_averages()
    kern = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    calls = sum(e.count for e in events if e.key in LAUNCH_CALLS) / n
    out = {"wall": wall_ms, "device": device_ms, "launches": launches, "calls": calls,
           "graphs": sum(e.count for e in events if e.key == "cudaGraphLaunch") / n}
    kernel_calls = sum(e.count for e in events if e.key in LAUNCH_CALLS[:4]) / n
    if not out["graphs"] and launches < kernel_calls:
        log(f"[{tag}] the trace holds {launches:.1f} kernels a call for {kernel_calls:.1f} "
            "kernel launch calls: it lost events, so its device time is a lower bound")
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log(f"[{tag}] host wall {wall_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
        f"{calls:.1f} host launch calls (" + ", ".join(
            f"{e.key} {e.count / n:.1f}" for e in events if e.key in LAUNCH_CALLS) + ")")
    missing = [r for r in require if not any(r in e.key for e in kern)]
    if missing:
        raise SystemExit(f"[{tag}] no kernel named {missing} in the trace")
    if device_ms == 0:
        log(f"[{tag}] device time: not measured (the trace holds no device time)")
        return out
    log(f"[{tag}] device time {device_ms:.4f} ms in {launches:.1f} kernel launches, busy "
        f"share of the host wall {device_ms / wall_ms:.3f}; by kernel, per call:")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(w in e.key for w in watch):
            log(f"[{tag}]   {e.self_device_time_total / 1e3 / n:8.4f} ms  "
                f"{e.count / n:6.1f} launches  {e.key[:90]}")
    return out


def weight_counts(params) -> tuple[int, int, int]:
    """(bytes of every weight but the embedding table, layer params, head
    params): what a step reads, and what its matrix products multiply."""
    from repro_torch.models.common import count_params, param_bytes

    table = params["embed"]["embedding"]
    layers = params["layers"] if "layers" in params else (params["units"], params["extra"])
    return (param_bytes(params) - table.numel() * table.element_size(),
            count_params(layers), count_params(params["embed"]) - table.numel())


def decode_steps(tag, eng, setup, pos, n, nbytes, flops, watch, batch: int = 4) -> tuple:
    """Phase 7's decode rows: ``n`` replays of the engine's captured step at
    ``batch`` rows from position ``pos``, after ``setup(engine)`` (a prefill
    that returns the last logits), then ``n`` steps of an uncaptured step on
    the same weights.  The replayed trace must hold the
    ``watch`` kernels.  -> (host wall, device ms, host launch calls) of a
    replayed step, then of an uncaptured one."""
    from repro_torch.serving.engine import InferenceEngine

    def run(engine):
        step = engine._decoder(batch, 0.0)   # before the prefill: a capture runs a step

        def prefill():
            step.start(setup(engine).argmax(-1), pos)

        def body(_):
            for _ in range(n):
                step.replay()
        return prefill, body

    out = []
    for name, around in (("replayed", contextlib.nullcontext()), ("uncaptured", uncaptured())):
        with around:
            engine = eng if name == "replayed" else InferenceEngine(
                eng.cfg, params=eng.params, max_cache=eng.max_cache)
            prefill, body = run(engine)
            r = profiled(f"{tag} {name}", prefill, body, n, nbytes, flops, watch,
                         require=watch if name == "replayed" else ())
        out += [r["wall"], r["device"], r["calls"]]
    return tuple(out)


def prefill_rows(tag, eng, tokens, last, nbytes, flops, watch) -> dict:
    """Phase 7's prefill rows: 4 prefills of ``tokens`` (the engine's
    ``_prefill``, as ``generate`` runs it) replayed from the engine's
    captured graph, then 4 uncaptured on the same weights.  The replayed
    trace must hold the ``watch`` kernels and one graph launch a prefill.
    -> {"replayed": profiled's dict, "uncaptured": ...}."""
    from repro_torch.serving.engine import InferenceEngine

    out = {}
    for name, around in (("replayed", contextlib.nullcontext()), ("uncaptured", uncaptured())):
        with around:
            engine = eng if name == "replayed" else InferenceEngine(
                eng.cfg, params=eng.params, max_cache=eng.max_cache)

            def prefills(_, engine=engine):
                for _ in range(4):
                    engine._prefill(tokens, last, engine.max_cache)
            out[name] = profiled(f"{tag} {name}", lambda: None, prefills, 4, nbytes, flops,
                                 watch, require=watch if name == "replayed" else ())
    r = out["replayed"]
    if r["graphs"] != 1:
        raise SystemExit(f"{tag}: {r['graphs']} graph launches a replayed prefill, not 1")
    return out


def breakdown(eng, cfg, dev, tag: str = "") -> tuple:
    """Phase 7 for a dense model (deepseek; mistral-nemo with ``tag``, the
    prefix of its log lines): where the engine's time goes at full width, for
    a prefill (batch 4, bucket 128) and for a decode step (batch 4, 100..115
    cached positions), replayed and uncaptured: the host wall, the device
    time by kernel from torch.profiler, the host's launch calls, and the
    least time the card could take (every weight but the embedding table
    read once, the cache read or written once, the matrix products at the
    bf16 peak).  Returns the prefill rows (``prefill_rows``) and the decode
    rows (``decode_steps``)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, last = 4, 128, 99
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    w_bytes, layer_params, head_params = weight_counts(eng.params)
    kv_row = 2 * cfg.num_layers * cfg.kv_dim * 2       # k and v of one position, bf16

    attn_flops = 4 * cfg.num_layers * cfg.q_dim * b * s * (s + 1) // 2
    prefill = prefill_rows(f"{tag}prefill", eng, tokens, last, w_bytes + kv_row * b * s,
                           2 * layer_params * b * s + 2 * head_params * b + attn_flops,
                           ("flash_fwd",))

    n = 16
    return prefill, decode_steps(f"{tag}decode", eng,
                                 lambda e: e._prefill(tokens, last, e.max_cache)[0],
                                 last + 1, n,
                                 w_bytes + kv_row * b * (last + 1 + n // 2),
                                 2 * (layer_params + head_params) * b,
                                 ("decode_split", "decode_combine"))


def dryrun_bounds(cfg, prefill: dict, step: tuple, card: str) -> None:
    """The dry-run's count held to the card (after phase 7's ``breakdown``):
    the deepseek-7b (4, 128) bucketed prefill and its decode step over a
    256-position cache, each run once as the one rank of a (1, 1) mesh on
    meta tensors under a fake process group (``launch/dryrun.py``, a few
    seconds of host time, nothing on the card), each roofline
    ``bound_time_s`` beside the device time the card measured for the
    replayed prefill and decode step.  A measured time under its bound
    means the count is wrong: it raises."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    with dryrun.fake_group(1):
        mesh = make_local_mesh(1, 1, device="meta")
        for tag, shape, b, s, measured in (
                ("prefill", "prefill_32k", 4, 128, prefill["replayed"]["device"]),
                ("decode step", "decode_32k", 4, 256, step[1])):
            rec = dryrun.run_pair(cfg.name, shape, multi_pod=False, out_dir="", verbose=False,
                                  mesh=mesh, batch=b, seq=s)
            t = rec["roofline"]
            bound_ms = t["bound_time_s"] * 1e3
            log(f"[dryrun] {cfg.name} {tag} ({b}, {s}) on a (1, 1) meta mesh: bound "
                f"{bound_ms:.4f} ms ({t['dominant']}: {rec['cost']['flops'] / 1e12:.4f} TFLOP, "
                f"{rec['cost']['bytes accessed'] / 1e9:.3f} GB); the card's replayed "
                f"{tag} {fmt_ms(measured)} ({card})")
            if not measured:
                log(f"[dryrun] the card's {tag}: device time not measured; no check")
            elif measured < bound_ms:
                raise SystemExit(f"[dryrun] the card's {tag} took {measured:.4f} ms, under "
                                 f"the dry-run's bound {bound_ms:.4f} ms: the count is wrong")
    log(f"[dryrun] both pairs counted in {time.perf_counter() - t0:.1f} s of host time")


def rwkv_breakdown(eng, cfg, dev) -> tuple:
    """Phase 7 for rwkv: a full-width prefill (batch 4, 100 tokens, exact)
    and a decode step (batch 4), each replayed and uncaptured.  Bound: every
    weight but the embedding table read once, the recurrent state written
    (prefill) or read and written (decode) once, the matrix products at the
    bf16 peak and K3's operations."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, s = 4, 100
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    w_bytes, layer_params, head_params = weight_counts(eng.params)
    hd = cfg.d_model // cfg.num_heads
    state_bytes = cfg.num_layers * b * (cfg.num_heads * hd * hd * 4 + 2 * cfg.d_model * 2)
    wkv_flops = 5 * hd * cfg.d_model * cfg.num_layers * b   # per token, K3 (timings())

    prefill = prefill_rows("rwkv prefill", eng, tokens, None, w_bytes + state_bytes,
                           (2 * layer_params + wkv_flops) * b * s + 2 * head_params * b,
                           ("wkv6_kernel",))

    return prefill, decode_steps("rwkv decode", eng,
                                 lambda e: e._prefill(tokens, None, s)[0], s, 16,
                                 w_bytes + 2 * state_bytes,
                                 (2 * (layer_params + head_params) + wkv_flops) * b,
                                 ("wkv6_kernel",))


def moe_breakdown(eng, cfg, dev) -> tuple:
    """Phase 7 for granite: a full-width prefill (batch 4, 100 tokens at the
    exact length) and a decode step (batch 4, 100..107 cached positions),
    each replayed and uncaptured.  Bound: every weight but the embedding
    table read once (the capacity dispatch runs every expert, at a decode
    step too), the cache written or read once; the products at the bf16
    peak, the experts' over their whole capacity buffers (E, C, d), C the
    capacity of the step's one group, and the router's."""
    from repro_torch.models.common import count_params
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(12)
    b, s, n = 4, 100, 8     # 8 steps: an uncaptured step launches about 3,600 kernels
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    w_bytes, _, head_params = weight_counts(eng.params)
    attn_params = count_params(eng.params["layers"][0]["attn"])
    kv_row = 2 * cfg.num_layers * cfg.kv_dim * 2       # k and v of one position, bf16
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def layer_flops(t):     # the products of every layer over t tokens
        return cfg.num_layers * (2 * attn_params * t + 2 * d * e * t
                                 + 6 * d * f * e * capacity(t, cfg))

    attn_flops = 4 * cfg.num_layers * cfg.q_dim * b * s * (s + 1) // 2
    prefill = prefill_rows("granite prefill", eng, tokens, None, w_bytes + kv_row * b * s,
                           layer_flops(b * s) + attn_flops + 2 * head_params * b,
                           ("flash_fwd",))
    return prefill, decode_steps("granite decode", eng,
                                 lambda e_: e_._prefill(tokens, None, e_.max_cache)[0], s, n,
                                 w_bytes + kv_row * b * (s + n // 2),
                                 layer_flops(b) + 2 * head_params * b,
                                 ("decode_split", "decode_combine"))


def mistral_phase(cfg, dev) -> tuple:
    """mistral-nemo-12b at full width through the engine alone, with every
    other engine freed: logits kernel against plain path, then batch 4,
    prompt 100 (bucket 128), 32 new, greedy twice and sampled once, each
    prefill and step replayed and held against the uncaptured path's
    tokens, K1 and K2 counted; then phase 7's prefill and decode rows.
    -> (the run's numbers, the launches, the prefill rows, the decode
    rows)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv

    eng = phase_start(cfg, dev)
    logits_check(eng, cfg, dev)
    prompts, _ = deepseek_inputs(cfg)
    want = uncaptured_tokens(eng, prompts)
    flash.launches = fd.launches = wkv.launches = 0
    out = engine_path(eng, cfg, want, prompts)
    launches = kernel_counts(cfg, out)
    peak_line(cfg)
    prefill, steps = breakdown(eng, cfg, dev, "mistral-nemo ")
    del eng
    torch.cuda.empty_cache()
    return out, launches, prefill, steps


def phase_start(cfg, dev):
    """Free what earlier phases left, reset the peak memory and seed the
    model's engine, alone on the card.  -> the engine."""
    from repro_torch.serving.engine import InferenceEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, seed=0, max_cache=ENGINE_CACHE.get(cfg.family, 256))
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}, "
        f"{eng.stats()['params'] / 1e9:.3f} B params {cfg.param_dtype}, seeded init "
        f"{time.perf_counter() - t0:.1f} s")
    return eng


def peak_line(cfg) -> None:
    log(f"[memory] {cfg.name} alone on the card: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def vlm_logits_check(params, cfg, dev, tol: float) -> None:
    """Phase 4a for llava: a full-width prefill of (2, 2944) tokens whose
    first 2880 positions are seeded random patch embeddings, N(0, 0.02) as
    a projector's output (zeros would let a merge that drops them pass), and
    one decode step at a (B,) position, kernel path against plain path on
    the same weights and inputs; the logits held to ``tol`` relative L2."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.decode.ref import flash_decode_ref
    from repro_torch.models import api

    gen = torch.Generator(device=dev).manual_seed(13)
    b, s = 2, LLAVA_PROMPT
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    patches = (rand((b, cfg.num_image_tokens, cfg.d_model), torch.float32, gen, dev)
               * 0.02).to(cfg.cdt)
    nxt = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
    pos = torch.full((b,), s, device=dev)

    def run():
        last, cache = api.prefill(params, {"tokens": tokens, "patch_embeds": patches}, cfg,
                                  LLAVA_CACHE)
        step, _ = api.decode_step(params, cache, nxt, pos, cfg)
        return last.float(), step.float()

    kern = run()
    with mock.patch.object(dispatch, "flash_attention", flash_attention_ref), \
            mock.patch.object(dispatch, "flash_decode", flash_decode_ref):
        plain = run()
    for what, a, w in zip(("prefill last logits", "decode-step logits"), kern, plain):
        rel = ((a - w).norm() / w.norm()).item()
        agree = (a.argmax(-1) == w.argmax(-1)).float().mean().item()
        log(f"[model] {cfg.name} {cfg.compute_dtype} {what} {tuple(a.shape)}, random patch "
            f"embeddings: kernel vs plain rel_l2={rel:.3e} (tol {tol:g}) "
            f"max_abs={(a - w).abs().max().item():.3e} argmax agreement={agree:.2f}")
        if not torch.isfinite(a).all() or rel > tol:
            raise SystemExit(f"full-width {cfg.name} {cfg.compute_dtype} {what}: kernel "
                             "path disagrees with plain path")


def llava_phase(cfg, dev) -> tuple:
    """llava-next-mistral-7b at full width alone on the card, the path
    through K1 and K2 at an image request's length: logits kernel against
    plain path (a float32 copy of the weights, the gate, then the bf16
    weights at the bf16 bar); then the engine at batch 2, prompt 2944 exact
    (2880 image positions, the reference's zero patch embeddings, and 64
    text tokens), 32 new, max_cache 3072, greedy twice and sampled once,
    each prefill and step replayed and held against the uncaptured path, K1
    and K2 counted; then phase 7's prefill and decode rows.  -> (the run's
    numbers, the launches, the prefill rows, the decode rows)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv

    eng = phase_start(cfg, dev)
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    vlm_logits_check(tree_map(torch.Tensor.float, eng.params), f32, dev, F32_REL_TOL)
    torch.cuda.empty_cache()
    vlm_logits_check(eng.params, cfg, dev, LOGITS_REL_TOL)
    prompts = torch.randint(0, cfg.vocab_size, (2, LLAVA_PROMPT),
                            generator=torch.Generator().manual_seed(14))
    want = uncaptured_tokens(eng, prompts)
    flash.launches = fd.launches = wkv.launches = 0
    out = engine_path(eng, cfg, want, prompts)
    launches = kernel_counts(cfg, out)
    peak_line(cfg)

    b, s = prompts.shape
    tokens = prompts.to(dev)
    w_bytes, layer_params, head_params = weight_counts(eng.params)
    kv_row = 2 * cfg.num_layers * cfg.kv_dim * 2       # k and v of one position, bf16
    attn_flops = 4 * cfg.num_layers * cfg.q_dim * b * s * (s + 1) // 2
    prefill = prefill_rows("llava prefill", eng, tokens, None, w_bytes + kv_row * b * s,
                           2 * layer_params * b * s + 2 * head_params * b + attn_flops,
                           ("flash_fwd",))
    n = 16
    steps = decode_steps("llava decode", eng,
                         lambda e: e._prefill(tokens, None, e.max_cache)[0], s, n,
                         w_bytes + kv_row * b * (s + n // 2),
                         2 * (layer_params + head_params) * b,
                         ("decode_split", "decode_combine"), batch=b)
    del eng
    torch.cuda.empty_cache()
    return out, launches, prefill, steps


def card_vs_cpu(tag, params, cfg, dev, inputs: dict, n_steps: int = 4) -> None:
    """A float32 model on the card against the same model on the CPU: the
    prefill's last logits and ``n_steps`` decode steps at (B,) positions,
    fed the same seeded tokens, each held to ``F32_REL_TOL`` relative L2."""
    from repro_torch.models import api

    cpu = tree_map(torch.Tensor.cpu, params)
    b, s = inputs["tokens"].shape
    nxt = torch.randint(0, cfg.vocab_size, (n_steps, b), generator=torch.Generator().manual_seed(18))

    def run(p, device):
        out = []
        logits, cache = api.prefill(p, {k: v.to(device) for k, v in inputs.items()}, cfg,
                                    s + n_steps)
        out.append(logits.float().cpu())
        for i in range(n_steps):
            logits, cache = api.decode_step(p, cache, nxt[i].to(device),
                                            torch.full((b,), s + i, device=device), cfg)
            out.append(logits.float().cpu())
        return out

    for i, (a, w) in enumerate(zip(run(params, dev), run(cpu, torch.device("cpu")))):
        rel = ((a - w).norm() / w.norm()).item()
        what = "prefill last logits" if i == 0 else f"decode step {i} logits"
        log(f"[model] {tag} {what} {tuple(a.shape)}: card vs CPU rel_l2={rel:.3e} "
            f"(tol {F32_REL_TOL:g}) max_abs={(a - w).abs().max().item():.3e}")
        if not torch.isfinite(a).all() or rel > F32_REL_TOL:
            raise SystemExit(f"{tag} {what}: the card disagrees with the CPU")


def redraw(tree, gen, names: dict):
    """``tree`` with each leaf whose key is in ``names`` drawn anew, as
    ``names[key](shape)`` says (on ``gen``'s device): the init sets these
    to constants, which would hide a slip per channel."""
    if isinstance(tree, list):
        return [redraw(t, gen, names) for t in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: (names[k](v, gen) if k in names and isinstance(v, torch.Tensor)
                else redraw(v, gen, names)) for k, v in tree.items()}


def _normal(mean, std):
    return lambda t, gen: (mean + std * torch.randn(t.shape, generator=gen, device=t.device,
                                                    dtype=torch.float32)).to(t.dtype)


def hybrid_phase(cfg, dev) -> tuple:
    """recurrentgemma-9b at full width alone on the card: the engine at
    batch 1, prompt 3072 exact (the chunked attention, the ring wrapped
    during the prefill), 16 new, then at batch 4, prompt 100 exact, 32 new,
    each prefill and step replayed and held against the uncaptured path;
    a float32 copy at full width and 5 layers (one pattern unit and the
    2-layer remainder, the init's constant biases and decay redrawn) on the
    card against the CPU; then phase 7's rows at batch 4.  -> ({run: its
    numbers}, the prefill rows, the decode rows)."""
    from repro_torch.models import hybrid
    from repro_torch.models.common import tensor_leaves

    eng = phase_start(cfg, dev)
    runs = {}
    for b, s, n_new in ((1, HYBRID_LONG, 16), (4, 100, 32)):
        prompts = torch.randint(0, cfg.vocab_size, (b, s),
                                generator=torch.Generator().manual_seed(15))
        want = uncaptured_tokens(eng, prompts, n_new=n_new)
        runs[f"{cfg.name} ({b},{s})"] = engine_path(eng, cfg, want, prompts, n_new)
    peak_line(cfg)

    cfg5 = cfg.replace(num_layers=5, param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(16)
    params = redraw(hybrid.init_params(cfg5, gen, dev), gen,
                    {"conv_b": _normal(0.0, 0.1), "b": _normal(0.0, 0.1),
                     "lam": _normal(2.0, 0.5)})
    tokens = torch.randint(0, cfg.vocab_size, (4, 100), generator=torch.Generator().manual_seed(17))
    card_vs_cpu(f"{cfg.name} float32, 5 layers", params, cfg5, dev, {"tokens": tokens})
    del params

    b, s = 4, 100
    tokens = prompts.to(dev)
    w_bytes, layer_params, head_params = weight_counts(eng.params)
    ring = sum(t.numel() * t.element_size() for t in tensor_leaves(eng._cache))
    prefill = prefill_rows("recurrentgemma prefill", eng, tokens, None, w_bytes + ring,
                           2 * layer_params * b * s + 2 * head_params * b, ())
    steps = decode_steps("recurrentgemma decode", eng,
                         lambda e: e._prefill(tokens, None, e.max_cache)[0], s, 16,
                         w_bytes + 2 * ring, 2 * (layer_params + head_params) * b, ())
    del eng
    torch.cuda.empty_cache()
    return runs, prefill, steps


def whisper_phase(cfg, dev) -> tuple:
    """whisper-tiny at full width alone on the card: the engine at batch 4,
    prompt 100 exact, 32 new, over the reference's 1500 zero frames, each
    prefill and step replayed and held against the uncaptured path; the
    float32 model with random frames (the init's constant biases and
    LayerNorms redrawn) on the card against the CPU; then phase 7's rows.
    -> (the run's numbers, the prefill rows, the decode rows)."""
    from repro_torch.models import encdec
    from repro_torch.models.common import count_params, param_bytes

    eng = phase_start(cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 100), generator=torch.Generator().manual_seed(19))
    want = uncaptured_tokens(eng, prompts)
    out = engine_path(eng, cfg, want, prompts)
    peak_line(cfg)

    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(20)
    params = redraw(encdec.init_params(f32, gen, dev), gen,
                    {"b": _normal(0.0, 0.1), "scale": _normal(1.0, 0.2),
                     "bias": _normal(0.0, 0.1)})
    cpu_gen = torch.Generator().manual_seed(21)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (4, 100), generator=cpu_gen),
              "frame_embeds": torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=cpu_gen)}
    card_vs_cpu(f"{cfg.name} float32", params, f32, dev, inputs)
    del params

    b, s, se, d = 4, 100, cfg.encoder_seq, cfg.d_model
    tokens = prompts.to(dev)
    p = eng.params
    # every weight read once (the tied embedding table by the unembedding),
    # the decoder positions a row each; the cross-attention's keys and values
    # over the frames are written (prefill) or read (a step) once
    pos_table = p["dec_pos"]
    w_bytes = param_bytes(p) - pos_table.numel() * pos_table.element_size()
    x_kv = 2 * cfg.num_layers * b * se * cfg.kv_dim * 2
    enc, dec = count_params(p["enc_layers"]), count_params(p["dec_layers"])
    x_proj = 2 * d * cfg.kv_dim * cfg.num_layers          # xattn wk and wv
    table = count_params(p["embed"])
    prefill_flops = (2 * enc * b * se + 4 * cfg.encoder_layers * d * b * se * se
                     + 2 * (dec - x_proj) * b * s + 2 * x_proj * b * se
                     + 4 * cfg.num_layers * d * b * (s * (s + 1) // 2 + s * se)
                     + 2 * table * b)
    prefill = prefill_rows("whisper prefill", eng, tokens, None, w_bytes + x_kv,
                           prefill_flops, ())
    step_flops = 2 * (dec - x_proj + table) * b + 4 * cfg.num_layers * d * b * (s + se)
    steps = decode_steps("whisper decode", eng,
                         lambda e: e._prefill(tokens, None, e.max_cache)[0], s, 16,
                         w_bytes + x_kv, step_flops, ())
    del eng
    torch.cuda.empty_cache()
    return out, prefill, steps


# ----------------------------------------------------------------------
# the backward kernels (K1-bwd, K3-bwd) and training
# ----------------------------------------------------------------------

def bwd_kernel_checks(dev) -> dict:
    """Phase 3 for the backward kernels against their plain versions on the
    same inputs.  K1-bwd at deepseek-7b's training shape, granite's GQA
    24/8 at head dim 64, llava's GQA 32/8 at 2944 positions, windowed,
    ragged and head-dim-32 cases, float32 and bf16, from K1's own output
    and row log-sum-exp (itself held to the plain one), each gradient
    relative to its largest magnitude; every bf16 case also row by row
    against the plain version in float32 (``check_rows``), and at llava's
    shapes a dK/dV pass that skips one query tile (its rows of dO dropped)
    and a dQ pass that skips one key tile must read above that bar.  K3-bwd
    at rwkv6-1.6b's training shape, with and without a gradient on the
    final state, at a T that is not a multiple of its chunk, decays near 0
    and near 1 and every head dim.  -> the largest error at the training
    shapes, per kernel."""
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                                   flash_attention_bwd_ref,
                                                   flash_attention_fwd_ref)
    from repro_torch.kernels.rwkv import wkv_bwd
    from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref
    from repro_torch.models.layers import causal_window_mask

    gen = torch.Generator(device=dev).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    main_err = {"flash_attention_bwd": 0.0, "wkv6_bwd": 0.0}
    for (b, s, h, kh, hd, win, dt, main) in [
            (4, 512, 32, 32, 128, 0, bf, True),     # deepseek-7b's train step
            (2, 256, 32, 32, 128, 0, f32, True),    # its float32 gate
            (2, 512, 24, 8, 64, 0, bf, False),      # granite's GQA 24/8, head dim 64
            (2, 256, 24, 8, 64, 0, f32, True),      # its float32 gate
            (2, LLAVA_PROMPT, 32, 8, 128, 0, bf, False),   # llava's GQA 32/8
            (1, 256, 4, 4, 128, 64, bf, False),     # window 64
            (2, 192, 8, 2, 64, 64, f32, False),     # GQA window, float32
            (1, 300, 4, 1, 128, 0, f32, False),     # ragged, MQA, float32
            (1, 300, 8, 2, 64, 0, bf, False),       # ragged, head dim 64
            (1, 70, 4, 4, 32, 0, f32, False),       # head dim 32
            (2, 333, 4, 2, 32, 100, bf, False)]:    # head dim 32, ragged, window
        q, do = rand((b, s, h, hd), dt, gen, dev), rand((b, s, h, hd), dt, gen, dev)
        k, v = rand((b, s, kh, hd), dt, gen, dev), rand((b, s, kh, hd), dt, gen, dev)
        name = f"K1-bwd flash_attention_bwd q{(b, s, h, hd)} kv{kh} window={win} {dt}"
        o, lse = flash.flash_attention(q, k, v, window=win, with_lse=True)
        check_rel(f"{name}: K1's lse", lse, flash_attention_fwd_ref(q, k, v, window=win)[1],
                  TOL[f32])
        got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, window=win)
        plain = flash_attention_bwd_ref(q, k, v, o, do, lse, window=win)
        for what, g, p in zip(("dq", "dk", "dv"), got, plain):
            err = check_rel(f"{name} {what}", g.float(), p.float(), TOL[dt])
            if main:
                main_err["flash_attention_bwd"] = max(main_err["flash_attention_bwd"], err)
        del plain
        if dt == bf:
            # the plain version in float32 on the kernel's own inputs, K1's
            # output and lse included: what is held is the backward's work
            q32, k32, v32, do32, o32 = q.float(), k.float(), v.float(), do.float(), o.float()
            lse32 = lse
            want = flash_attention_bwd_ref(q32, k32, v32, o32, do32, lse32, window=win)
            first = torch.zeros(q.shape[:3], dtype=torch.bool, device=dev)
            first[:, 0] = True    # position 0 sees one key: its dq is 0
            for what, g, w, zero in zip(("dq", "dk", "dv"), got, want, (first, None, None)):
                check_grad_rows(f"{name} {what}", g, w, zero)
            if s == LLAVA_PROMPT:
                pos = torch.arange(s, device=dev)
                mask = causal_window_mask(pos, pos, win)
                drop = ((pos[:, None] >= FAULT_ROWS) & (pos[None, :] >= FAULT_TILE[0])
                        & (pos[None, :] < FAULT_TILE[1]))
                fdq = attention_bwd_ref(q32, k32, v32, o32, do32, lse32, mask & ~drop)[0]
                do32[:, FAULT_TILE[0]:FAULT_TILE[1]] = 0
                _, fdk, fdv = attention_bwd_ref(q32, k32, v32, o32, do32, lse32, mask)
                for what, faulty, w in (("dq, keys", fdq, want[0]), ("dk, dO rows", fdk, want[1]),
                                        ("dv, dO rows", fdv, want[2])):
                    live = ~first if what.startswith("dq") else slice(None)
                    worst = row_rel(faulty[live], w[live]).max().item()
                    log(f"[check] {name} {what} {FAULT_TILE[0]}-{FAULT_TILE[1] - 1} dropped in "
                        f"the plain version: worst row rel_l2={worst:.3e} against the bar "
                        f"{ROW_REL_TOL:g}: {'seen' if worst > ROW_REL_TOL else 'NOT SEEN'}")
                    if not worst > ROW_REL_TOL:
                        raise SystemExit(f"{name}: the row bar cannot see a dropped tile")
                del fdq, fdk, fdv
            del q32, k32, v32, do32, o32, want
    for (b, t, h, hd, log_decay, final, main) in [
            (4, 512, 32, 64, -2.0, False, True),    # rwkv6-1.6b's train step: dS_T = 0
            (4, 512, 32, 64, -2.0, True, False),    # a gradient on the final state
            (4, 37, 32, 64, -2.0, True, False),     # T not a multiple of the chunk
            (4, 100, 32, 64, 2.0, True, False),     # decays near 0
            (4, 100, 32, 64, -6.0, True, False),    # decays near 1
            (2, 100, 8, 128, -2.0, True, False),
            (2, 64, 4, 32, -2.0, True, False),
            (1, 33, 2, 16, -2.0, True, False)]:
        ins = wkv_inputs(b, t, h, hd, gen, dev, log_decay)
        do = rand((b, t, h, hd), f32, gen, dev)
        ds_t = (rand((b, h, hd, hd), f32, gen, dev) if final
                else torch.zeros((b, h, hd, hd), device=dev))
        got = wkv_bwd.wkv6_bwd(*ins, do, ds_t)
        again = wkv_bwd.wkv6_bwd(*ins, do, ds_t)
        plain = wkv6_bwd_ref(*ins, do, ds_t)
        name = f"K3-bwd wkv6_bwd {(b, t, h, hd)} log decay {log_decay:g} dS_T {'random' if final else 0}"
        for what, g, p, a in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, plain, again):
            err = check_rel(f"{name} {what}", g, p, WKV_REL_TOL)
            if not torch.equal(g, a):
                raise SystemExit(f"{name} {what}: two runs differ")
            if main:
                main_err["wkv6_bwd"] = max(main_err["wkv6_bwd"], err)
    log("[check] K3-bwd: every case's two runs bit for bit equal")
    return main_err


def bwd_timings(dev) -> dict:
    """Phase 6 for the backward kernels at the training shapes: K1-bwd at
    deepseek-7b's (4, 512, 32, 128) bf16 causal and at granite's GQA 24/8,
    head dim 64, (2, 512), and K3-bwd at rwkv6-1.6b's (4, 512, 32, 64)
    float32, by CUDA events and profiler device time,
    beside the bound, the plain version's time and, for K1-bwd, the library
    call's: the backward of ``F.scaled_dot_product_attention`` (its forward
    run once per input set, outside the timing; timed only, never used by
    the port)."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.attention.ref import flash_attention_bwd_ref
    from repro_torch.kernels.rwkv import wkv_bwd
    from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}

    def timed(shape, kernel, plain, library, sets, bound_):
        return dict(shape=shape, ms=time_ms(kernel, sets), device_ms=device_ms(kernel, sets),
                    plain_ms=time_ms(plain, sets[:2], iters=6, warm=1),
                    plain_device_ms=device_ms(plain, sets[:2], iters=4, tries=1),
                    library_ms=None if library is None else time_ms(library, sets),
                    library_device_ms=None if library is None else device_ms(library, sets),
                    bound=bound_)

    dt = torch.bfloat16
    for key, (b, s, h, kh, hd) in (("flash_attention_bwd", (4, 512, 32, 32, 128)),
                                   ("flash_attention_bwd granite", (2, 512, 24, 8, 64))):
        def k1_set(b=b, s=s, h=h, kh=kh, hd=hd):
            q, do = (rand((b, s, h, hd), dt, gen, dev) for _ in range(2))
            k, v = (rand((b, s, kh, hd), dt, gen, dev) for _ in range(2))
            o, lse = flash.flash_attention(q, k, v, with_lse=True)
            lib = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
            lib_o = F.scaled_dot_product_attention(*lib, is_causal=True, enable_gqa=h != kh)
            return q, k, v, o, do, lse, (lib_o, lib, do.transpose(1, 2))

        # q, o, dO read and dq written, k, v read and dk, dv written (bf16),
        # the lse read; five products over the causal pairs of every query
        # head: QK^T, dO V^T, P^T dO, dS K, dS^T Q
        nbytes = (4 * h + 4 * kh) * b * s * hd * 2 + b * h * s * 4
        flops = 5 * 2 * b * h * (s * (s + 1) // 2) * hd
        out[key] = timed(
            f"q/o/dO {(b, s, h, hd)}, k/v {kh} heads, bf16 causal",
            lambda q, k, v, o, do, lse, _: flash_bwd.flash_attention_bwd(q, k, v, o, do, lse),
            lambda q, k, v, o, do, lse, _: flash_attention_bwd_ref(q, k, v, o, do, lse),
            lambda *a: torch.autograd.grad(a[-1][0], a[-1][1], a[-1][2], retain_graph=True),
            cold_copies(k1_set, nbytes), bound(nbytes, flops, dt))

    b, t, h, hd = 4, 512, 32, 64
    f32 = torch.float32

    def k3_set():
        r, k, v, w, u, s0 = wkv_inputs(b, t, h, hd, gen, dev)
        return r, k, v, w, u, s0, rand((b, t, h, hd), f32, gen, dev), torch.zeros_like(s0)

    # r, k, v, w, dO read and dr, dk, dv, dw written; u, s0 and dS_T read,
    # du and ds0 written; per (i, j) and step, the state rebuilt (k v, w S
    # + kv: 3 operations) and the backward's four sums and dS update (11)
    seq, state = b * t * h * hd * 4, b * h * hd * hd * 4
    nbytes = 9 * seq + 3 * state + 2 * h * hd * 4
    flops = 14 * b * t * h * hd * hd
    out["wkv6_bwd"] = timed(
        f"r/k/v/w/dO {(b, t, h, hd)} float32, dS_T 0",
        lambda *a: wkv_bwd.wkv6_bwd(*a), lambda *a: wkv6_bwd_ref(*a), None,
        cold_copies(k3_set, nbytes), bound(nbytes, flops, f32))
    return out


def optim_timings(dev) -> tuple[dict, dict]:
    """Phase 6 for K4 and K5, run with phase 10 (every engine freed first:
    the leaves take 58.6 GB): at deepseek-7b's 20-layer leaves, the
    training step's (4.886 B bf16 params, bf16 gradients, float32 moments),
    seeded.  First each leaf through K5 and through the plain update from
    copies of its params and moments, held to the phase 3 bars and bit for
    bit, and K4 over every leaf against the plain sum; then each by CUDA
    events and profiler device time over every leaf at once, beside its
    bound, its plain version's time and, timed only and never used by the
    port, the library calls that compute the same function:
    ``torch._foreach_norm`` and a sum of the squared norms for K4; for K5
    ``torch._fused_adamw_`` on the float32 moments beside the bf16 params
    and gradients, the same function, where it takes them (PyTorch 2.11
    refuses: it wants one dtype for all four, and the refusal is printed),
    and ``torch.optim.AdamW(fused=True).step()`` over the same params and
    gradients, with moments in the params' dtype (14 bytes a param where K5
    moves 22).  Each row's rate is its own bytes over its device time.  The
    library step's device time leaves out the optimizer's
    ``record_function`` span, which the profiler also reports on the device
    (``kernel_events``).  -> (the timing rows, the largest error against
    the plain versions)."""
    from repro_torch.configs.registry import get
    from repro_torch.kernels.optim import adamw
    from repro_torch.kernels.optim.ref import adamw_update_ref, grad_sumsq_ref
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves

    torch.cuda.empty_cache()
    cfg = get("deepseek-7b").config.replace(num_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(23)
    params = list(tensor_leaves(api.init_params(cfg, gen, dev)))
    grads = [torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * 1e-3
             for p in params]
    mu = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in params]
    nu = [torch.randn(p.shape, generator=gen, device=dev).square_().mul_(1e-6) for p in params]
    scalars = torch.tensor([0.7, 3e-4, 0.271, 0.142625], device=dev)
    n = sum(p.numel() for p in params)
    log(f"[time] K4/K5 at {cfg.name}'s {TRAIN_LAYERS}-layer leaves: {len(params)} leaves, "
        f"{n / 1e9:.3f} B params {params[0].dtype}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    errs = {}
    got = adamw.grad_sumsq(grads)
    errs["grad_sumsq"] = check_rel(f"K4 grad_sumsq, {len(grads)} leaves of {cfg.name}", got,
                                   grad_sumsq_ref(grads), OPT_REL_TOL)
    worst = 0.0
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        runs = []
        for fn in (adamw.adamw_update, adamw_update_ref):
            leaf = [p.clone()], [m.clone()], [v.clone()]
            fn(leaf[0], [g], leaf[1], leaf[2], scalars, **OPT_HYPER)
            runs.append(leaf)
        worst = max(worst, check_update(f"K5 adamw_update, leaf {i} {tuple(p.shape)}",
                                        *runs, exact=True) if i < 3 or p.numel() > 4e8 else
                    quiet_update_err(*runs))
        del runs
    errs["adamw_update"] = worst
    log(f"[check] K5 adamw_update over every leaf of {cfg.name}: max_abs_err {worst:.3e} "
        "(each leaf within the phase 3 bars, and bit for bit the plain update)")

    sumsq_bytes = sum(g.numel() * g.element_size() for g in grads)
    update_bytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
                       for p, g in zip(params, grads))
    out = {}

    def sumsq_lib():
        return torch.stack(torch._foreach_norm(grads)).float().square().sum()

    # every device time held to the bound: below it the trace lost kernels
    k4 = (lambda: adamw.grad_sumsq(grads), lambda: grad_sumsq_ref(grads))
    k4_bound = bound(sumsq_bytes, 2 * n, torch.float32)
    out["grad_sumsq"] = dict(
        shape=f"{len(grads)} bf16 gradient leaves, {n / 1e9:.3f} B elements",
        ms=time_ms(k4[0], [()], iters=20, warm=2),
        device_ms=device_ms(k4[0], [()], iters=10, floor_ms=k4_bound[0]),
        plain_ms=time_ms(k4[1], [()], iters=3, warm=1),
        plain_device_ms=device_ms(k4[1], [()], iters=2, tries=1, floor_ms=k4_bound[0]),
        library_ms=time_ms(sumsq_lib, [()], iters=10, warm=2),
        library_device_ms=device_ms(sumsq_lib, [()], iters=5, floor_ms=k4_bound[0]),
        bound=k4_bound)

    def k5():
        adamw.adamw_update(params, grads, mu, nu, scalars, **OPT_HYPER)

    def k5_plain():
        adamw_update_ref(params, grads, mu, nu, scalars, **OPT_HYPER)

    # the bound is the bytes (32.1 ms): the 17 float32 operations an element
    # (the clip scale 1, mu 3, nu 4, the corrections, sqrt, eps and quotient
    # 5, the decay 2, the step 2) take 1.2 ms at the float32 peak; the
    # divisions and the square root are sequences of instructions on the
    # card, not single operations, and the kernel's arithmetic hides under
    # its loads all the same
    k5_bound = bound(update_bytes, 17 * n, torch.float32)
    row = dict(shape=f"{len(params)} leaves, {n / 1e9:.3f} B bf16 params, bf16 gradients, "
               "float32 moments", ms=time_ms(k5, [()], iters=20, warm=2),
               device_ms=device_ms(k5, [()], iters=10, floor_ms=k5_bound[0]),
               plain_ms=time_ms(k5_plain, [()], iters=3, warm=1),
               plain_device_ms=device_ms(k5_plain, [()], iters=2, tries=1,
                                         floor_ms=k5_bound[0]),
               bound=k5_bound)
    row["rate_tbs"] = update_bytes / row["device_ms"] / 1e9 if row["device_ms"] else None

    steps = [torch.ones((), device=dev) for _ in params]

    def fused_f32():
        torch._fused_adamw_(params, grads, mu, nu, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
                            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

    try:
        fused_f32()
    except RuntimeError as e:
        row["library_f32"] = f"refused: {str(e).splitlines()[0]}"
    else:
        f32_ms = device_ms(fused_f32, [()], iters=5, floor_ms=k5_bound[0])
        rate = "not measured" if f32_ms is None else f"{update_bytes / f32_ms / 1e9:.3f} TB/s"
        row["library_f32"] = (f"{time_ms(fused_f32, [()], iters=10, warm=2):.4f} ms (device "
                              f"{fmt_ms(f32_ms)}, {rate})")
    del mu, nu, steps
    torch.cuda.empty_cache()
    for p, g in zip(params, grads):
        p.requires_grad_(True)
        p.grad = g
    lib = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                            fused=True)
    # (the library's moments are bf16: its own bound is 14 bytes a param)
    row.update(library_ms=time_ms(lib.step, [()], iters=10, warm=2),
               library_device_ms=device_ms(lib.step, [()], iters=5,
                                           floor_ms=14 * n / HBM_BYTES_PER_S * 1e3))
    row["library_rate_tbs"] = (14 * n / row["library_device_ms"] / 1e9
                               if row["library_device_ms"] else None)
    out["adamw_update"] = row
    log(f"[memory] K4/K5 timings: peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    del lib, params, grads
    torch.cuda.empty_cache()
    return out, errs


def quiet_update_err(got: tuple, want: tuple) -> float:
    """``check_update`` with ``exact`` and without its line, for the many
    leaves of one model."""
    torch.cuda.synchronize()
    err = 0.0
    for kind, gs, ws in zip(("p", "mu", "nu"), got, want):
        for g, w in zip(gs, ws):
            err = max(err, (g.float() - w.float()).abs().max().item())
            if kind == "p" and g.dtype == torch.bfloat16:
                bad = bf16_ulps(g, w) > OPT_BF16_ULPS
            else:
                bad = (g - w).abs().max().item() > OPT_REL_TOL * max(w.abs().max().item(), 1e-30)
            if bad or not torch.equal(g, w) or not torch.isfinite(g).all():
                raise SystemExit(f"K5: a leaf of {g.numel()} elements disagrees with the plain "
                                 "update")
    return err


def train_run(cfg, dev, *, layers_note: str, captured: bool, steps: int = TRAIN_STEPS,
              traced: bool = True) -> dict:
    """Phase 10's run: ``steps`` AdamW steps of ``cfg`` (seeded weights;
    rwkv's ``tmix.wo`` redrawn, or its init of 0 would cut K3 out of the
    gradient) at batch ``TRAIN_BATCH``, seq ``TRAIN_SEQ``, lr ``TRAIN_LR``
    (cosine, as ``train()`` sets it), on ``LMBatches`` seed 0, remat on:
    ``captured``, through a ``TrainGraph`` as ``train()`` steps (step 1 the
    capture's warm-up, then the capture; every later step a replay), else
    ``make_train_step`` called directly.  Per step the loss, grad norm, lr,
    host wall and the kernels' launches (K1 layers x 2, K1-bwd layers, or
    K3 and K3-bwd; K4 and K5 once), each held to its count; step
    ``TRAIN_PROFILED + 1`` traced (device time, busy share, K4's and K5's
    share); the losses finite and falling; the peak memory allocated and
    reserved; the params copied to host memory after ``TRAIN_SNAP`` steps.
    -> the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.optim import adamw
    from repro_torch.kernels.rwkv import wkv, wkv_bwd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.models.common import count_params, tensor_leaves
    from repro_torch.serving.graphs import TrainGraph
    from repro_torch.train.data import LMBatches
    from repro_torch.train.loop import batch_on
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    mode = "replayed" if captured else "uncaptured"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if cfg.family == "ssm":
        redraw_wo(params, cfg, dev)
    opt = AdamW(learning_rate=cosine_schedule(TRAIN_LR, warmup=max(TRAIN_STEPS // 10, 1),
                                              total=TRAIN_STEPS))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = LMBatches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[train] {cfg.name} {mode}: {cfg.num_layers} layers {layers_note}, d={cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params {cfg.param_dtype}, float32 AdamW moments; seeded "
        f"init {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, lr "
        f"{TRAIN_LR:g}, remat on; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        "before the first step")
    kernels = ({"K1": flash, "K1-bwd": flash_bwd} if cfg.family != "ssm"
               else {"K3": wkv, "K3-bwd": wkv_bwd})
    want = {name: cfg.num_layers * (1 if "bwd" in name else 2) for name in kernels}
    kernels.update({"K4": adamw.SUMSQ, "K5": adamw.UPDATE})
    want.update({"K4": 1, "K5": 1})
    for mod in (flash, flash_bwd, wkv, wkv_bwd, adamw.SUMSQ, adamw.UPDATE):
        mod.launches = 0
    graph, losses, walls, device, snap = None, [], [], None, None
    for i in range(steps):
        batch = batch_on(data(i), cfg, dev)
        before = {name: mod.launches for name, mod in kernels.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()

        def one_step():
            nonlocal graph
            if not captured:
                return step_fn(params, state, batch)[2]
            if graph is None:
                graph = TrainGraph(step_fn, params, state, batch, dev)
            return graph.run(batch)

        if traced and i == TRAIN_PROFILED:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                m = one_step()
                torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
            kern = sorted(kernel_events(prof), key=lambda e: -e.self_device_time_total)
            device = sum(e.self_device_time_total for e in kern) / 1e6
        else:
            m = one_step()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if i and not (traced and i == TRAIN_PROFILED):
            walls.append(wall)
        losses.append(loss)
        counts = {name: mod.launches - before[name] for name, mod in kernels.items()}
        log(f"[train] {cfg.name} {mode} step {i + 1}: loss {loss:.4f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e} host wall {wall * 1e3:.1f} "
            f"ms{' (traced)' if traced and i == TRAIN_PROFILED else ''}"
            f"{' (warm-up and capture)' if captured and i == 0 else ''}; launches {counts} "
            f"(want {want})")
        if counts != want:
            raise SystemExit(f"{cfg.name} {mode} step {i + 1}: kernel launches {counts}, not "
                             f"{want}")
        if i + 1 == TRAIN_SNAP:
            snap = [p.detach().to("cpu") for p in tensor_leaves(params)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    wall_ms = float(np.median(walls)) * 1e3 if walls else float("nan")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the step's bound: the layers' products 8 times (forward, the remat's
    # forward, backward twice) and the unembedding's 6 times a token at the
    # bf16 peak, then AdamW's 22 bytes a bf16 param (the param read and
    # written, its gradient read, both float32 moments read and written)
    head = params["embed"].get("unembed", params["embed"])
    layer_params = n_params - count_params(params["embed"])
    flops = 8 * layer_params * tokens + 6 * count_params(head) * tokens
    bound_s = flops / PEAK_FLOPS[torch.bfloat16] + 22 * n_params / HBM_BYTES_PER_S
    if device:
        log(f"[train] {cfg.name} {mode} step bound {bound_s * 1e3:.1f} ms: {flops / 1e12:.1f} "
            f"TFLOP at the bf16 peak {flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.1f} ms, then "
            f"AdamW's {22 * n_params / 1e9:.1f} GB {22 * n_params / HBM_BYTES_PER_S * 1e3:.1f} "
            "ms")
        log(f"[train] {cfg.name} {mode} step {TRAIN_PROFILED + 1} by kernel (device ms, "
            "launches):")
        for e in kern[:12]:
            log(f"[train]   {e.self_device_time_total / 1e3:9.3f}  {e.count:6d}  {e.key[:90]}")
    by_kernel = {}
    for label, keys in (("K1", ("flash_fwd",)), ("K1-bwd", ("bwd_dot", "bwd_dkdv", "bwd_dq")),
                        ("K3", ("wkv6_kernel",)), ("K3-bwd", ("wkv6_bwd_kernel", "du_sum")),
                        ("K4", ("sumsq_tiles", "sumsq_final")), ("K5", ("adamw_update",)),
                        ("products (nvjet, gemm)", ("nvjet", "gemm", "Gemm"))):
        ms = sum(e.self_device_time_total for e in kern if any(k in e.key for k in keys)) \
            if device else 0
        if ms:
            by_kernel[label] = ms / 1e3
            log(f"[train]   {label}: {ms / 1e3:.3f} ms, {ms / 1e3 / (device * 1e3):.3f} of "
                "the step's device time")
    busy = "not measured" if not device else (
        f"{device * 1e3:.1f} ms, busy share {device * 1e3 / wall_ms:.3f} of the median step "
        f"wall ({device / prof_wall:.3f} of the traced step's own wall)")
    log(f"[train] {cfg.name} {mode}: median wall of steps 2-{steps} untraced {wall_ms:.1f} ms "
        f"({tokens / wall_ms * 1e3:.0f} tokens/s); device time of step {TRAIN_PROFILED + 1} "
        f"from its trace: {busy}; peak allocated {peak:.2f} GiB, reserved {reserved:.2f} GiB; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # (a short run ends inside the first steps' rise of the loss: only finite)
    if not all(math.isfinite(x) for x in losses) or \
            steps == TRAIN_STEPS and not losses[-1] < losses[0]:
        raise SystemExit(f"{cfg.name} training: losses {losses} are not finite and falling")
    launches = {name: mod.launches for name, mod in kernels.items()}
    del params, state, step_fn, m, graph
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_ms": wall_ms, "device_ms": None if not device
            else device * 1e3, "busy": None if not device else device * 1e3 / wall_ms,
            "peak_gib": peak, "reserved_gib": reserved, "tokens_per_s": tokens / wall_ms * 1e3,
            "launches": launches, "params": n_params, "bound_ms": bound_s * 1e3,
            "by_kernel": by_kernel, "snap": snap}


def same_params(a: list, b: list) -> tuple[bool, float]:
    """Whether two host copies of the params are bit for bit equal, and the
    worst relative L2 of a leaf between them."""
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    worst = max(((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()
                for x, y in zip(a, b))
    return equal, worst


def train_model(cfg, dev, note: str) -> dict:
    """Phase 10 for one model: the uncaptured step twice from the same seed
    (``TRAIN_SNAP`` steps, then ``TRAIN_STEPS``), which shows whether it is
    bit-reproducible, then the replayed step (``TRAIN_STEPS``), held bit for
    bit to the uncaptured run (losses of every step, params after
    ``TRAIN_SNAP`` steps), or, where the uncaptured step is itself not
    reproducible, by the gate's ``GATE_REL_TOL``.  -> {"uncaptured": run,
    "replayed": run}."""
    first = train_run(cfg, dev, layers_note=note, captured=False, steps=TRAIN_SNAP,
                      traced=False)
    plain = train_run(cfg, dev, layers_note=note, captured=False)
    replay = train_run(cfg, dev, layers_note=note, captured=True)
    repro, worst = same_params(first["snap"], plain["snap"])
    repro = repro and first["losses"] == plain["losses"][:TRAIN_SNAP]
    log(f"[train] {cfg.name}: two uncaptured runs from one seed, {TRAIN_SNAP} steps: losses and "
        f"params bit for bit equal: {repro} (worst leaf rel_l2 {worst:.3e})")
    equal, worst = same_params(replay["snap"], plain["snap"])
    losses_equal = replay["losses"] == plain["losses"]
    log(f"[train] {cfg.name}: replayed against uncaptured: the {TRAIN_STEPS} losses bit for "
        f"bit equal: {losses_equal}; params after {TRAIN_SNAP} steps bit for bit equal: "
        f"{equal} (worst leaf rel_l2 {worst:.3e})")
    if repro and not (equal and losses_equal):
        raise SystemExit(f"{cfg.name}: the replayed train step differs from the uncaptured "
                         "step, which is bit-reproducible")
    if not repro:
        rel = max(abs(a - b) / abs(b) for a, b in zip(replay["losses"], plain["losses"]))
        log(f"[train] {cfg.name}: the uncaptured step is not bit-reproducible, so the replay "
            f"is held to the gate's bar {GATE_REL_TOL:g}: params worst rel_l2 {worst:.3e}, "
            f"losses worst relative {rel:.3e}")
        if not (worst <= GATE_REL_TOL and rel <= GATE_REL_TOL):
            raise SystemExit(f"{cfg.name}: the replayed train step differs from the "
                             "uncaptured step past the gate's bar")
    for run in (first, plain, replay):
        run.pop("snap")
    return {"uncaptured": plain, "replayed": replay, "first": first}


def grad_gate(cfg, dev) -> dict:
    """Phase 10's gate: ``cfg`` at 2 layers, full width, float32, seeded
    weights (rwkv's ``tmix.wo`` redrawn): every parameter's gradient of one
    train step's loss (batch 2, seq 256) on the kernel path (K1 with K1-bwd,
    K3 with K3-bwd) against the same on the plain path, autograd through
    the plain forwards on the card, each held to ``GATE_REL_TOL`` relative
    L2; then one AdamW step from each side's gradients, the new params held
    to the same bar.  A MoE's plain side takes the kernel side's expert
    routes, as ``moe_logits_check``.  -> the kernels' launches on the
    kernel path."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.rwkv import wkv, wkv_bwd
    from repro_torch.kernels.rwkv.ref import wkv6_ref
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves
    from repro_torch.train.data import LMBatches
    from repro_torch.kernels.optim import adamw
    from repro_torch.kernels.optim.ref import adamw_update_ref, grad_sumsq_ref
    from repro_torch.train.loop import batch_on
    from repro_torch.train.optimizer import AdamW

    torch.cuda.empty_cache()
    cfg = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    if cfg.family == "ssm":
        redraw_wo(params, cfg, dev)
    leaves = [p.requires_grad_() for p in tensor_leaves(params)]
    batch = batch_on(LMBatches(cfg.vocab_size, 2, 256, seed=3)(0), cfg, dev)
    topk, routes, replayed = torch.topk, [], [0]

    def recording(probs, k, dim=-1):
        out = topk(probs, k, dim=dim)
        routes.append(out.indices)
        return out

    def replaying(probs, k, dim=-1):
        idx = routes[replayed[0]]
        replayed[0] += 1
        return torch.gather(probs, dim, idx), idx

    def grads():
        loss, _ = api.train_loss(params, batch, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    for mod in (flash, flash_bwd, wkv, wkv_bwd):
        mod.launches = 0
    with mock.patch.object(torch, "topk", recording):
        k_loss, k_grads = grads()
    launches = {"flash_attention": flash.launches, "flash_attention_bwd": flash_bwd.launches,
                "wkv6": wkv.launches, "wkv6_bwd": wkv_bwd.launches}
    with mock.patch.object(dispatch, "flash_attention", flash_attention_ref), \
            mock.patch.object(dispatch, "rwkv_scan",
                              lambda r, k, v, w, u, s, out_state=None: wkv6_ref(r, k, v, w, u, s)), \
            mock.patch.object(torch, "topk", replaying):
        p_loss, p_grads = grads()
    if replayed[0] != len(routes):
        raise SystemExit(f"{cfg.name} gate: {len(routes)} routings recorded, {replayed[0]} "
                         "replayed")
    if cfg.family == "ssm" and not launches["wkv6_bwd"] or \
            cfg.family != "ssm" and not launches["flash_attention_bwd"]:
        raise SystemExit(f"{cfg.name} gate: the kernel path launched {launches}")
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(k_grads, p_grads)]
    worst = max(rel)
    log(f"[gate] {cfg.name} 2 layers float32, batch 2, seq 256: loss kernel {k_loss:.6f} plain "
        f"{p_loss:.6f}; {len(rel)} gradient leaves, worst rel_l2 {worst:.3e} (leaf "
        f"{rel.index(worst)}), median {float(np.median(rel)):.3e}, tol {GATE_REL_TOL:g}; "
        f"kernel launches {launches}")
    if not worst <= GATE_REL_TOL or not all(torch.isfinite(g).all() for g in k_grads):
        raise SystemExit(f"{cfg.name} gate: a gradient on the kernel path differs from the "
                         "plain path's")
    with torch.no_grad():
        for p in leaves:
            p.requires_grad_(False)
        twin, third = [p.clone() for p in leaves], [p.clone() for p in leaves]
        opt = AdamW(learning_rate=3e-4)
        k_state, p_state, q_state = opt.init(leaves), opt.init(twin), opt.init(third)
        n4, n5 = adamw.SUMSQ.launches, adamw.UPDATE.launches
        opt.update(leaves, list(k_grads), k_state)         # K4 and K5
        opt.update(twin, list(p_grads), p_state)
        launches.update(grad_sumsq=adamw.SUMSQ.launches - n4,
                        adamw_update=adamw.UPDATE.launches - n5)
        # the kernel path's gradients once more, through the plain update
        with mock.patch.object(dispatch, "grad_sumsq", grad_sumsq_ref), \
                mock.patch.object(dispatch, "adamw_update", adamw_update_ref):
            opt.update(third, list(k_grads), q_state)
        if adamw.SUMSQ.launches - n4 != 2 or adamw.UPDATE.launches - n5 != 2:
            raise SystemExit(f"{cfg.name} gate: K4 and K5 did not launch once an update")
        check_update(f"{cfg.name} gate: one K4/K5 step against the plain update, the kernel "
                     "path's gradients", (leaves, k_state["mu"], k_state["nu"]),
                     (third, q_state["mu"], q_state["nu"]))
        del third, q_state
        moments = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                      for key in ("mu", "nu") for a, b in zip(k_state[key], p_state[key]))
        # AdamW's first step moves each element by lr * g / (|g| + eps): the
        # sign of g.  An element whose gradient lies at the rounding noise
        # (below GATE_NOISE of its leaf's rms) may move either way on either
        # path, by at most 2 lr apart; the rest must agree.
        worst, flips, floor = 0.0, 0, 0
        for a, b, g in zip(leaves, twin, p_grads):
            sure = g.abs() >= GATE_NOISE * g.square().mean().sqrt()
            worst = max(worst, ((a - b)[sure].norm() / b[sure].norm().clamp_min(1e-30)).item())
            floor += int((~sure).sum())
            flips += int(((a - b).abs() > 1e-3 * opt.learning_rate)[~sure].sum())
            if ((a - b).abs()[~sure] > 2.0001 * opt.learning_rate).any():
                raise SystemExit(f"{cfg.name} gate: an AdamW step moved further than 2 lr")
    log(f"[gate] {cfg.name}: one AdamW step from each side's gradients: mu and nu worst rel_l2 "
        f"{moments:.3e}; params over the elements whose gradient is at least {GATE_NOISE:g} "
        f"of its leaf's rms worst rel_l2 {worst:.3e}, tol {GATE_REL_TOL:g}; {floor} elements "
        f"below, {flips} of them moved apart (each by at most 2 lr)")
    if not (moments <= GATE_REL_TOL and worst <= GATE_REL_TOL):
        raise SystemExit(f"{cfg.name} gate: the AdamW step differs between the paths")
    del params, leaves, twin, k_grads, p_grads
    torch.cuda.empty_cache()
    return launches


def micro_gate(cfg, dev) -> dict:
    """Phase 10's gate for the microbatched step: ``cfg`` at 2 layers in
    float32, batch 2, seq 256, ``num_micro=2``, three steps through a
    ``TrainGraph`` (the warm-up, then two replays) against three steps of
    ``make_train_step`` called directly, from one seed: losses and params
    bit for bit, the backward kernel once a layer a microbatch and K4 and
    K5 once a step, replays included.  -> the kernels' launches."""
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.optim import adamw
    from repro_torch.kernels.rwkv import wkv, wkv_bwd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves
    from repro_torch.serving.graphs import TrainGraph
    from repro_torch.train.data import LMBatches
    from repro_torch.train.loop import batch_on
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    cfg = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
    data = LMBatches(cfg.vocab_size, 2, 256, seed=5)
    mods = {"flash_attention": flash, "flash_attention_bwd": flash_bwd, "wkv6": wkv,
            "wkv6_bwd": wkv_bwd, "grad_sumsq": adamw.SUMSQ, "adamw_update": adamw.UPDATE}
    runs = []
    for captured in (False, True):
        params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev)
        if cfg.family == "ssm":
            redraw_wo(params, cfg, dev)
        opt = AdamW(learning_rate=cosine_schedule(1e-3, warmup=1, total=3))
        state = opt.init(params)
        step_fn = make_train_step(cfg, opt, num_micro=2)
        before = {k: m.launches for k, m in mods.items()}
        graph, losses = None, []
        for i in range(3):
            batch = batch_on(data(i), cfg, dev)
            if captured:
                graph = graph or TrainGraph(step_fn, params, state, batch, dev)
                m = graph.run(batch)
            else:
                m = step_fn(params, state, batch)[2]
            losses.append(float(m["loss"]))
        counts = {k: m.launches - before[k] for k, m in mods.items()}
        runs.append((losses, [p.detach().clone() for p in tensor_leaves(params)], counts))
        del params, state, step_fn, graph
    (want_l, want_p, _), (got_l, got_p, counts) = runs
    bwd = "wkv6_bwd" if cfg.family == "ssm" else "flash_attention_bwd"
    equal = got_l == want_l and all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    log(f"[gate] {cfg.name} 2 layers float32, batch 2, seq 256, num_micro 2: three replayed "
        f"TrainGraph steps against three uncaptured: losses {' '.join(f'{x:.6f}' for x in got_l)}"
        f"; losses and params bit for bit equal: {equal}; launches {counts}")
    if not equal or not all(math.isfinite(x) for x in got_l):
        raise SystemExit(f"{cfg.name}: the replayed microbatched step differs from the "
                         "uncaptured one")
    if counts[bwd] != 3 * 2 * cfg.num_layers or counts["grad_sumsq"] != 3 \
            or counts["adamw_update"] != 3:
        raise SystemExit(f"{cfg.name} microbatched: kernel launches {counts}")
    torch.cuda.empty_cache()
    return counts


def train_phase(dev) -> tuple:
    """Phase 10, with every engine freed: first phase 6's K4/K5 timings
    (``optim_timings``, which need the card's memory); then deepseek-7b at
    full width and ``TRAIN_LAYERS`` of its 30 layers (the cut one card
    forces: at 30 layers the bf16 weights and gradients and the two float32
    moments alone take 6.91 B x 12 bytes = 82.9 GB), and rwkv6-1.6b at full
    width and depth, each through ``train_model`` (uncaptured twice,
    replayed once); then the float32 gate (``grad_gate``, ``micro_gate``)
    for deepseek-7b, granite-moe-3b-a800m and rwkv6-1.6b.  -> ({name:
    {mode: run}}, the kernels' launches summed over the runs and the gate's
    kernel paths, K4's and K5's timing rows, their errors)."""
    from repro_torch.configs.registry import get

    times, errs = optim_timings(dev)
    runs = {}
    launches = dict.fromkeys(("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd",
                              "grad_sumsq", "adamw_update"), 0)
    names = {"K1": "flash_attention", "K1-bwd": "flash_attention_bwd", "K3": "wkv6",
             "K3-bwd": "wkv6_bwd", "K4": "grad_sumsq", "K5": "adamw_update"}
    full = get("deepseek-7b").config
    for cfg, note in ((full.replace(num_layers=TRAIN_LAYERS),
                       f"of its {full.num_layers} (the cut one card forces)"),
                      (get("rwkv6-1.6b").config, "(full depth)")):
        runs[cfg.name] = train_model(cfg, dev, note)
        for run in runs[cfg.name].values():
            for name, n in run["launches"].items():
                launches[names[name]] += n
    for arch in ("deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b"):
        for gate in (grad_gate, micro_gate):
            for name, n in gate(get(arch).config, dev).items():
                launches[name] += n
    return runs, launches, times, errs


# ----------------------------------------------------------------------
# phase 11: the sharded paths (two ranks)
# ----------------------------------------------------------------------

SHARDED_WORLD = 2
SHARDED_NEW = 32
# phase 11's qwen3-moe-235b-a22b on (1, 8): full width, this many layers
# (each holds 2.4 B expert parameters; the single card's oracle holds them
# whole in float32)
QWEN3_LAYERS = 2
# phase 11's float32 gates and train step: the sharded run against the
# single card, relative L2 (logits, each param leaf) and relative (loss,
# grad norm): the ranks' float32 partial sums are reduced in another
# order, about 1e-7 a layer
SHARDED_REL_TOL = 1e-4
SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ = 4, 128
# phase 11's bf16 runs at full width (deepseek-7b on (1, 2) and its long-KV
# decode on (2, 1), recurrentgemma-9b on (1, 2)) take this many layers of
# their 30 and 38: their time goes to gloo's copies through host memory,
# which grow with the depth, and the script's 1200 s left no room for the
# whole depth on a slower host (1133-1164 s of the script's time with it)
SHARDED_LAYERS = 8
# phase 11's deepseek-7b in bf16: the sharded prefill logits are
# held row by row to ROW_REL_TOL against the single card computing the
# sharded arithmetic (``split_rows``).  Against the plain single card they
# are held to LOGITS_REL_TOL: any change of summation order moves this
# random model's bf16 logits by about 1.8e-2 relative L2 (on an H100, the
# single card against itself with its wo/wd products summed in float32:
# 1.82e-2, worst row 1.86e-2; PERF.md), past ROW_REL_TOL.


def mesh_prefill(eng, prompts, n_new: int = SHARDED_NEW) -> torch.Tensor:
    """The engine's uncaptured prefill of ``prompts``: the last real token's
    logits of every row (a mesh engine's rows gathered), float32."""
    tokens, last_pos, cache_len = eng._prompt(prompts, n_new)
    with eng._on_mesh(tokens.shape[0]):
        logits, _ = eng._prefill(eng._local_rows(tokens), last_pos, cache_len)
        return eng._all_rows(logits.float(), 0)


def split_rows(p: dict, key: str, x: torch.Tensor, full_in: int, *,
               cut_seq: bool = False) -> torch.Tensor:
    """``models.layers.row_dense`` on one card as ``SHARDED_WORLD`` ranks of a
    model axis compute it: the input dim cut into their equal slices, each
    slice's products in float32 (``float32_products``, at a rank's
    shapes), the partial sums added in rank order and rounded once.  Phase
    11's single-card oracle of the sharded bf16 arithmetic (one card, no
    mesh: ``cut_seq`` is never set)."""
    from repro_torch.models.common import float32_products
    assert not cut_seq
    q = p[key]
    parts = [float32_products(xs.contiguous(), ws) for xs, ws in
             zip(x.chunk(SHARDED_WORLD, -1), q["w"].chunk(SHARDED_WORLD, 0))]
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    y = y.to(x.dtype)
    return y + q["b"].to(y.dtype) if "b" in q else y


def split_project(p: dict, key: str, x: torch.Tensor, n: int, cfg) -> torch.Tensor:
    """``models.layers.project_heads`` on one card as ``SHARDED_WORLD`` ranks
    compute it where the rules cut its columns: each rank's equal chunk of
    the columns (a contiguous weight of its own, and its bias) as its own
    product, the chunks put side by side as the ranks' gather does; all
    ``n`` heads.  A product's bits can depend on its width (on an H100,
    recurrentgemma-9b's 256-column ``wk`` at 4 rows x 100 tokens differs
    from its two 128-column halves), so phase 11's split oracle computes
    each rank's width, as ``split_rows`` sums each rank's rows."""
    from repro_torch.models.common import dense
    q = p[key]
    ws = [w.contiguous() for w in q["w"].chunk(SHARDED_WORLD, -1)]
    bs = q["b"].chunk(SHARDED_WORLD, -1) if "b" in q else [None] * SHARDED_WORLD
    y = torch.cat([dense({"w": w} if b is None else {"w": w, "b": b}, x)
                   for w, b in zip(ws, bs)], -1)
    return y.reshape(*y.shape[:2], n, -1)


def sharded_engine_run(cfg, mesh, prompts, params_fn, n_new: int = SHARDED_NEW, *,
                       split: bool = False, local_fn=None) -> dict:
    """``cfg``'s engine on ``params_fn()`` (seeded whole weights on the
    card): the single card's on rank 0 first (uncaptured, while the other
    ranks wait; with ``split`` also its prefill with the row products and
    the projections' columns split as the ranks split them, ``split_rows``
    and ``split_project``), then the mesh engine's on every rank, on its
    cut of ``params_fn()`` or, with ``local_fn``, on ``local_fn()``, the
    rank's shards drawn as they are and given to the engine as its
    ``shards`` (no rank holds the whole weights then),
    the K1/K2/K3 launches and the collectives of its ``generate`` counted.
    -> the single card's prefill logits and greedy
    tokens (rank 0), the mesh run's, and its counts."""
    import torch.distributed as dist

    from repro_torch import shardctx
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv
    from repro_torch.serving.engine import InferenceEngine

    out = {}
    if mesh.rank == 0:
        with uncaptured():
            eng = InferenceEngine(cfg, params=params_fn(), max_cache=256)
            out["want_logits"] = mesh_prefill(eng, prompts, n_new).cpu()
            if split:
                from repro_torch.models import hybrid, layers
                with mock.patch.object(layers, "row_dense", split_rows), \
                        mock.patch.object(hybrid, "row_dense", split_rows), \
                        mock.patch.object(layers, "project_heads", split_project), \
                        mock.patch.object(hybrid, "project_heads", split_project):
                    out["split_logits"] = mesh_prefill(eng, prompts, n_new).cpu()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["want"] = eng.generate(prompts, n_new).tokens
            out["single_s"] = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
    dist.barrier()
    if local_fn is None:
        eng = InferenceEngine(cfg, params=params_fn(), max_cache=256, mesh=mesh)
    else:
        eng = InferenceEngine(cfg, shards=local_fn(), max_cache=256, mesh=mesh)
    torch.cuda.empty_cache()
    out["logits"] = mesh_prefill(eng, prompts, n_new).cpu()
    flash.launches = fd.launches = wkv.launches = 0
    shardctx.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["tokens"] = eng.generate(prompts, n_new).tokens
    out["mesh_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_attention": flash.launches, "flash_decode": fd.launches,
                       "wkv6": wkv.launches}
    out["collectives"] = shardctx.counts()
    out["engine"] = eng
    return out


def step_collectives(name: str, eng, toks: torch.Tensor, pos: int) -> dict:
    """One decode step's collectives on this rank (every row's next token
    at ``pos``, the engine's cache after its ``generate``) against
    ``launch/comms.py``'s plan of the layout (PERF.md has the formula):
    counts and bytes must be equal.  -> both."""
    from repro_torch import shardctx
    from repro_torch.launch import comms
    from repro_torch.models import api

    mesh, b = eng.mesh, toks.shape[0]
    with eng._on_mesh(b):
        local = eng._local_rows(toks[:, -1:])[:, 0].to(mesh.device)
        shardctx.reset_counts()
        api.decode_step(eng.params, eng._cache, local,
                        torch.full((local.shape[0],), pos, device=mesh.device), eng.cfg)
        got = shardctx.counts()
    plan = {k: (n, float(v)) for k, (n, v) in comms.decode_step(
        eng.cfg, mesh.shape, batch=b, cache_len=eng.max_cache,
        model_index=mesh.coords["model"]).items()}
    log(f"[sharded] rank {mesh.rank} {name}: one decode step (batch {b}) moves {got}; the "
        f"layout's plan (launch/comms.py): {plan}; bytes per rank "
        f"{sum(v[1] for v in got.values()):.0f} against {sum(v[1] for v in plan.values()):.0f}")
    if got != plan:
        raise SystemExit(f"rank {mesh.rank} {name}: one decode step's collectives {got} differ "
                         f"from the plan {plan}")
    return {"counted": got, "plan": plan}


def hold_engine_run(name: str, run: dict, *, rel_tol: float | None = None,
                    row_tol: float | None = None, tokens_equal: bool) -> dict:
    """Rank 0: the mesh run's prefill logits against the single card's
    (relative L2 under ``rel_tol``, or row by row under ``row_tol``), and,
    when the run has them, row by row under ``ROW_REL_TOL`` against the
    single card's with the sharded arithmetic (``split_rows``); then its
    greedy tokens (equal with ``tokens_equal``, else printed and where they
    part).  -> what it measured."""
    got, want = run["logits"], run["want_logits"]
    rows = row_rel(got, want)
    rel = ((got - want).norm() / want.norm()).item()
    ok = bool(torch.isfinite(got).all()) and (
        rows.max().item() <= row_tol if rel_tol is None else rel <= rel_tol)
    log(f"[sharded] {name}: prefill logits {tuple(got.shape)} against the single card: rel_l2 "
        f"{rel:.3e}, worst row {rows.max().item():.3e} (tol "
        f"{'row ' + format(row_tol, 'g') if rel_tol is None else format(rel_tol, 'g')}) "
        f"{'ok' if ok else 'FAIL'}")
    out = {"rel": rel, "worst_row": rows.max().item()}
    if "split_logits" in run:
        sl = run["split_logits"]
        split_rows_rel = row_rel(got, sl)
        out.update(split_rel=((got - sl).norm() / sl.norm()).item(),
                   split_worst_row=split_rows_rel.max().item(),
                   split_max_abs=(got - sl).abs().max().item(),
                   split_vs_single=row_rel(sl, want).max().item())
        split_ok = out["split_worst_row"] <= ROW_REL_TOL
        log(f"[sharded] {name}: prefill logits against the single card with its products "
            f"split as the ranks split them: rel_l2 {out['split_rel']:.3e}, worst "
            f"row {out['split_worst_row']:.3e}, max_abs {out['split_max_abs']:.3e} (tol row "
            f"{ROW_REL_TOL:g}) {'ok' if split_ok else 'FAIL'}; that single card against the "
            f"plain one: worst row {out['split_vs_single']:.3e}")
        ok = ok and split_ok
    if not ok:
        raise SystemExit(f"{name}: the sharded prefill disagrees with the single card")
    toks, ref = run["tokens"], run["want"]
    same = torch.equal(toks, ref)
    log(f"[sharded] {name}: greedy tokens equal the single card's: {same}")
    parts = []
    for r in range(toks.shape[0]):
        diff = (toks[r] != ref[r]).nonzero()
        if len(diff):
            parts.append((r, int(diff[0])))
    if tokens_equal and not same:
        raise SystemExit(f"{name}: sharded greedy tokens differ from the single card's at "
                         f"(row, step) {parts}")
    return {**out, "tokens_equal": same, "parts": parts}


def parting_margins(eng, prompts, toks, ref, parts) -> list:
    """For each row where the mesh run's tokens part from the single
    card's: the mesh engine's logit margin there between its own token and
    the single card's (a prefill of the row's prompt and the tokens before
    the step; every rank runs it)."""
    out = []
    for r, step in parts:
        prefix = torch.cat([prompts[r], toks[r, :step]])[None]
        logits = mesh_prefill(eng, prefix, 1)[0]
        out.append((r, step, (logits[int(toks[r, step])] - logits[int(ref[r, step])]).item()))
    return out


def sharded_train_check(cfg, mesh, name: str, fsdp: bool, want: dict,
                        kernels=("flash_attention", "flash_attention_bwd", "grad_sumsq",
                                 "adamw_update"), *, seq_parallel: bool = False,
                        keep: bool = False, against: list | None = None) -> dict:
    """One AdamW step of ``cfg`` (float32) on ``mesh`` (FSDP specs with
    ``fsdp``), K4 and K5 counted, against the single card's step in
    ``want`` (rank 0's): loss, grad norm and every param leaf (gathered).
    Each of ``kernels`` (the family's: the hybrid's attention is plain, as
    the reference's) must launch.  Where ``want`` holds the single card's
    gradients, the params are held as phase 10's gate holds them: over the
    elements whose gradient is at least ``GATE_NOISE`` of its leaf's rms
    (AdamW's first step takes the sign of the gradient, which rounding
    decides below that), the rest each within 2 lr.  With ``seq_parallel``
    the step runs under ``use_mesh(mesh, seq_parallel=True)``; with
    ``keep`` rank 0 returns the params after the step (host, ``params``);
    ``against``, such params of another layout's step, which rank 0 holds
    these to as well."""
    from repro_torch import shardctx
    from repro_torch.kernels.attention import flash, flash_bwd
    from repro_torch.kernels.optim import adamw
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.models.common import leaf_paths, tensor_leaves
    from repro_torch.train.optimizer import AdamW

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(learning_rate=1e-3)
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh, fsdp=fsdp)
    params = sharding.shard_tree(
        api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), pspecs, mesh)
    torch.cuda.empty_cache()
    state = opt.init(params)
    batch = train_batch(cfg, dev)
    step = make_train_step(cfg, opt, mesh=mesh, param_pspecs=pspecs)
    for m in (flash, flash_bwd, adamw.SUMSQ, adamw.UPDATE):
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shardctx.use_mesh(mesh, seq_parallel=seq_parallel):
        _, _, metrics = step(params, state, sharding.shard_batch(batch, mesh))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash.launches, "flash_attention_bwd": flash_bwd.launches,
                "grad_sumsq": adamw.SUMSQ.launches, "adamw_update": adamw.UPDATE.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"launches": launches, "wall_s": wall, "peak_gib": peak}
    log(f"[sharded] rank {mesh.rank} train {name}: K1 {launches['flash_attention']}, K1-bwd "
        f"{launches['flash_attention_bwd']}, K4 {launches['grad_sumsq']}, K5 "
        f"{launches['adamw_update']}; step {wall:.3f} s, peak allocated {peak:.2f} GiB")
    if not all(launches[k] for k in kernels):
        raise SystemExit(f"train {name}: a kernel of the sharded step never launched: {launches}")
    # the params after the step, gathered leaf by leaf (every rank takes
    # part), each held on rank 0 against the single card's: on the host,
    # or, with the gradients' noise floor, on the card a slice at a time
    rels, sure_rels, floor, apart = [], [], 0, False
    kept, other = [], []
    for local, spec, i in zip(tensor_leaves(params), sharding.spec_leaves(pspecs), count()):
        a = sharding.gather(local.detach(), spec, mesh)
        if mesh.rank == 0 and keep:
            kept.append(a.cpu())
        if mesh.rank == 0 and against is not None:
            b = against[i]
            other.append(((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)).item())
        if mesh.rank == 0 and "grads" not in want:
            a, b = a.cpu(), want["params"][i]
            rels.append(((a - b).norm() / b.norm().clamp_min(1e-30)).item())
        elif mesh.rank == 0:
            a, b, g = a.reshape(-1), want["params"][i].reshape(-1), want["grads"][i].reshape(-1)
            parts = [(a[j:j + 2**26], b[j:j + 2**26].to(dev), g[j:j + 2**26].to(dev))
                     for j in range(0, a.numel(), 2**26)]
            cut = GATE_NOISE * (sum(gc.double().square().sum() for _, _, gc in parts)
                                / a.numel()).sqrt()
            sums = torch.zeros(4, dtype=torch.float64, device=dev)   # all, then the sure
            for ac, bc, gc in parts:
                d, sure = ac - bc, gc.abs() >= cut
                sums += torch.stack([d.double().square().sum(), bc.double().square().sum(),
                                     d[sure].double().square().sum(),
                                     bc[sure].double().square().sum()])
                floor += int((~sure).sum())
                apart |= bool((d.abs()[~sure] > 2.0001 * opt.learning_rate).any())
            sums = sums.sqrt().tolist()
            rels.append(sums[0] / max(sums[1], 1e-30))
            sure_rels.append(sums[2] / max(sums[3], 1e-30))
            del parts
        del a
    if mesh.rank == 0:
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        rl = abs(loss - want["loss"]) / abs(want["loss"])
        rg = abs(gnorm - want["gnorm"]) / abs(want["gnorm"])
        worst = max(rels)
        if "grads" in want:
            unmasked = worst
            names = ["/".join(map(str, k)) for k in leaf_paths(api.abstract_params(cfg))]
            worst = max(sure_rels)
            log(f"[sharded] train {name}: params, every element: worst leaf rel_l2 "
                f"{unmasked:.3e} ({names[rels.index(unmasked)]}); {floor} elements with a "
                f"gradient below {GATE_NOISE:g} of their leaf's rms, each within 2 lr: "
                f"{not apart}")
            if apart:
                raise SystemExit(f"train {name}: an AdamW step moved further than 2 lr")
        ok = rl <= SHARDED_REL_TOL and rg <= SHARDED_REL_TOL and worst <= SHARDED_REL_TOL
        log(f"[sharded] train {name}: loss {loss:.6f} (single card {want['loss']:.6f}, "
            f"relative {rl:.3e}), grad norm {gnorm:.6f} ({want['gnorm']:.6f}, {rg:.3e}), "
            f"params after the step worst leaf rel_l2 {worst:.3e}"
            + (" over the elements above the gradient noise" if "grads" in want else "")
            + f" (tol {SHARDED_REL_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"train {name}: the sharded step disagrees with the single card")
        out.update(loss_rel=rl, gnorm_rel=rg, param_rel=worst)
        if against is not None:
            out["other_param_rel"] = max(other)
            log(f"[sharded] train {name}: params after the step against the tensor parallel "
                f"step's: worst leaf rel_l2 {max(other):.3e} (tol {SHARDED_REL_TOL:g})")
            if max(other) > SHARDED_REL_TOL:
                raise SystemExit(f"train {name}: the step disagrees with the tensor parallel "
                                 "step")
        if keep:
            out["params"] = kept
    del params, state
    torch.cuda.empty_cache()
    return out


def train_batch(cfg, dev) -> dict:
    """Phase 11's training batch: ``LMBatches`` of seed 0, and the audio
    and vlm families' stub embeddings (``modal_extras``)."""
    from repro_torch.train.data import LMBatches, modal_extras
    from repro_torch.train.loop import batch_on
    return batch_on({**LMBatches(cfg.vocab_size, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ,
                                 seed=0)(0), **modal_extras(cfg, SHARDED_TRAIN_BATCH)}, cfg, dev)


def single_train_step(cfg, dev, *, grads: bool = False) -> dict:
    """Rank 0's oracle: one AdamW step of ``cfg`` on the single card from the
    same seed and batch.  -> loss, grad norm and the params (host), and
    with ``grads`` the gradients the step took (host)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves
    from repro_torch.train.optimizer import AdamW

    opt = AdamW(learning_rate=1e-3)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = train_batch(cfg, dev)
    out = {}
    if grads:
        leaves = [p.requires_grad_() for p in tensor_leaves(params)]
        loss, _ = api.train_loss(params, batch, cfg)
        out["grads"] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        del leaves, loss
    _, _, m = make_train_step(cfg, opt)(params, opt.init(params), batch)
    out.update(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
               params=[t.detach().cpu() for t in tensor_leaves(params)])
    del params
    torch.cuda.empty_cache()
    return out


# phase 11's long-KV decode: deepseek-7b at batch 1 on (2, 1), whose batch
# does not divide the data axis, so the rules cut its 16,384-position cache
# over "data"; an 8,176-token prompt (bucket 8,192) and 32 new tokens, so that
# decode crosses the chunk boundary at 8,192; unwindowed, and with a
# 4,096-position window whose band straddles the boundary
LONG_CACHE, LONG_PROMPT, LONG_WINDOW = 16384, 8176, 4096


def split_decode(half: int):
    """``dispatch.flash_decode`` as one card computes what two ranks of a
    sequence-sharded cache compute: a cache of ``2 * half`` positions cut
    at ``half``, K2 with its row lse on each part, the parts combined by
    ``shardctx.merge_softmax`` (``combine_softmax``'s arithmetic).  Phase
    11's single-card oracle of the long-KV decode, as ``split_rows`` is of
    the row-parallel products."""
    from repro_torch import shardctx
    from repro_torch.kernels.decode import flash_decode as fd

    def decode(q, k, v, valid, *, return_lse: bool = False):
        if return_lse or k.shape[1] != 2 * half:
            return fd.flash_decode(q, k, v, valid, return_lse=return_lse)
        parts = [fd.flash_decode(q, k[:, i:i + half], v[:, i:i + half],
                                 valid[..., i:i + half].contiguous(), return_lse=True)
                 for i in (0, half)]
        return shardctx.merge_softmax([o for o, _ in parts], [lse for _, lse in parts])
    return decode


def stepped_logits(eng, prompts, toks) -> list:
    """The engine's uncaptured prefill of ``prompts`` and a decode step for
    each token of ``toks`` (B, n) but the last, fed in (teacher-forced, so
    every engine steps through the same tokens), at each row's position as
    a device tensor, as ``generate`` steps: each one's logits, float32 on
    the host, a mesh engine's rows gathered."""
    from repro_torch.models import api

    tokens, last_pos, cache_len = eng._prompt(prompts, toks.shape[1])
    s = prompts.shape[1]
    out = []
    with eng._on_mesh(tokens.shape[0]):
        logits, cache = eng._prefill(eng._local_rows(tokens), last_pos, cache_len)
        out.append(eng._all_rows(logits.float(), 0).cpu())
        for i in range(toks.shape[1] - 1):
            tok = eng._local_rows(toks[:, i:i + 1])[:, 0].to(eng.device)
            pos = torch.full((tok.shape[0],), s + i, device=eng.device)
            logits, _ = api.decode_step(eng.params, cache, tok, pos, eng.cfg)
            out.append(eng._all_rows(logits.float(), 0).cpu())
    return out


def long_kv_run(cfg, mesh, window: int) -> dict:
    """deepseek-7b (``cfg``, ``SHARDED_LAYERS`` layers, bf16) at batch 1 over
    ``LONG_CACHE`` positions on ``mesh``, its cache's sequence cut over
    "data": on rank 0 first, uncaptured, the plain single card's greedy
    tokens and teacher-forced logits, and the same with the cache split
    at ``LONG_CACHE / 2`` (``split_decode``); then the mesh engine's
    logits on the plain card's tokens, its ``generate``, K1/K2 counted, and
    one decode step's collectives against the plan."""
    import torch.distributed as dist

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    wcfg = cfg.replace(attention_window=window) if window else cfg
    dev = mesh.device
    prompts = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                            generator=torch.Generator().manual_seed(5))

    def params_fn():
        return api.init_params(wcfg, torch.Generator(device=dev).manual_seed(0), dev)

    out, want = {}, [None]
    torch.cuda.reset_peak_memory_stats()
    if mesh.rank == 0:
        with uncaptured():
            eng = InferenceEngine(wcfg, params=params_fn(), max_cache=LONG_CACHE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want[0] = eng.generate(prompts, SHARDED_NEW).tokens
            out["single_s"] = time.perf_counter() - t0
            out["plain"] = stepped_logits(eng, prompts, want[0])
            with mock.patch.object(dispatch, "flash_decode", split_decode(LONG_CACHE // 2)):
                out["split_tokens"] = eng.generate(prompts, SHARDED_NEW).tokens
                out["split"] = stepped_logits(eng, prompts, want[0])
        out["want"] = want[0]
        del eng
        torch.cuda.empty_cache()
    dist.broadcast_object_list(want, src=0)
    eng = InferenceEngine(wcfg, params=params_fn(), max_cache=LONG_CACHE, mesh=mesh)
    torch.cuda.empty_cache()
    out["mesh"] = stepped_logits(eng, prompts, want[0])
    flash.launches = fd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["tokens"] = eng.generate(prompts, SHARDED_NEW).tokens
    out["mesh_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_attention": flash.launches, "flash_decode": fd.launches}
    name = f"{cfg.name} (2, 1) batch 1 long-KV" + (f" window {window}" if window else "")
    k = out["launches"]
    want_k = {"flash_attention": cfg.num_layers,
              "flash_decode": cfg.num_layers * (SHARDED_NEW - 1)}
    log(f"[sharded] rank {mesh.rank} {name}: K1 {k['flash_attention']}, K2 (with lse) "
        f"{k['flash_decode']} (layers x prefills, layers x steps: {want_k}); generate "
        f"{out['mesh_s']:.3f} s")
    if k != want_k:
        raise SystemExit(f"rank {mesh.rank} {name}: K1/K2 launches {k}, not {want_k}")
    out["step"] = step_collectives(name, eng, out["tokens"], LONG_PROMPT + SHARDED_NEW - 1)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["name"] = name
    del eng
    torch.cuda.empty_cache()
    return out


def hold_long_kv(run: dict) -> dict:
    """Rank 0: the long-KV mesh run's logits at every step against the
    single card that splits the cache as the ranks do (row by row, bit for
    bit where they are, held to ``ROW_REL_TOL``) and its tokens equal to
    that card's; against the plain single card, the logits' relative L2
    and the tokens, printed.  -> what it measured."""
    name = run["name"]
    rows = [row_rel(m, s).max().item() for m, s in zip(run["mesh"], run["split"])]
    bits = sum(torch.equal(m, s) for m, s in zip(run["mesh"], run["split"]))
    plain = [((m - p).norm() / p.norm()).item() for m, p in zip(run["mesh"], run["plain"])]
    ok = max(rows) <= ROW_REL_TOL and all(bool(torch.isfinite(m).all()) for m in run["mesh"])
    log(f"[sharded] {name}: logits of the prefill and {len(rows) - 1} decode steps against the "
        f"single card splitting its cache at {LONG_CACHE // 2}: worst row rel_l2 "
        f"{max(rows):.3e} (tol {ROW_REL_TOL:g}), {bits} of {len(rows)} steps bit for bit "
        f"{'ok' if ok else 'FAIL'}; against the plain single card: rel_l2 worst "
        f"{max(plain):.3e}, last {plain[-1]:.3e}")
    same_split = torch.equal(run["tokens"], run["split_tokens"])
    same_plain = torch.equal(run["tokens"], run["want"])
    parts = (run["tokens"][0] != run["want"][0]).nonzero()
    log(f"[sharded] {name}: greedy tokens equal the split single card's: {same_split}; the "
        f"plain single card's: {same_plain}"
        + ("" if same_plain else f" (they part at step {int(parts[0])})"))
    if not ok or not same_split:
        raise SystemExit(f"{name}: the sequence-sharded decode disagrees with the single card "
                         "that splits its cache as the ranks do")
    return {"worst_row": max(rows), "bit_steps": bits, "steps": len(rows),
            "plain_rel": max(plain), "tokens_equal_split": same_split,
            "tokens_equal_plain": same_plain, "single_s": run["single_s"]}


def leafwise_params(cfg, dev, mesh=None, specs=None):
    """Seeded random weights of ``cfg`` drawn one leaf at a time on
    ``dev``, each from its own generator (seeded by its index): norm scales
    1, biases 0, the embedding N(0, 1/d), every other matrix N(0, 1/fan-in).
    With ``mesh``, each leaf is cut to the rank's shard by ``specs`` as soon
    as it is drawn, so that no rank holds the whole weights (qwen3's 128
    experts a layer are 2.4 B parameters); without, the whole tree, the
    same numbers."""
    from repro_torch.launch import sharding
    from repro_torch.models import api

    count = [0]

    def make(node, spec, keys=()):
        if isinstance(node, dict):
            return {k: make(v, None if spec is None else spec[k], keys + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [make(v, None if spec is None else spec[j], keys)
                    for j, v in enumerate(node)]
        gen = torch.Generator(device=dev).manual_seed(1000 + count[0])
        count[0] += 1
        shape = tuple(node.shape)
        t = torch.empty(shape, dtype=node.dtype, device=dev)   # drawn in place
        if keys[-1] == "scale":
            t.fill_(1.0)
        elif keys[-1] in ("b", "bias"):
            t.zero_()
        else:
            fan_in = cfg.d_model if keys[-1] == "embedding" else shape[-2]
            t.normal_(0.0, fan_in ** -0.5, generator=gen)
        return t if mesh is None else sharding.shard(t, spec, mesh)

    return make(api.abstract_params(cfg), specs)


def gate_run(cfg, mesh, name: str, params_fn, local_fn=None) -> dict:
    """A float32 gate: ``cfg`` through ``sharded_engine_run`` (on
    ``local_fn()``'s shards where given), K2 counted where the family runs
    it, one decode step's collectives against the plan, and on rank 0 the
    prefill logits within ``SHARDED_REL_TOL`` of the single card's and the
    greedy tokens equal.  -> rank 0's reading, the launches and the step's
    collectives."""
    prompts = deepseek_inputs(cfg)[0]
    run = sharded_engine_run(cfg, mesh, prompts, params_fn, local_fn=local_fn)
    eng = run.pop("engine")
    log(f"[sharded] rank {mesh.rank} {name}: launches {run['launches']}; generate "
        f"{run['mesh_s']:.3f} s")
    if cfg.family in ("dense", "moe", "vlm") and not run["launches"]["flash_decode"]:
        raise SystemExit(f"rank {mesh.rank} {name}: K2 never launched on the sharded path")
    out = {"launches": run["launches"], "mesh_s": run["mesh_s"],
           "step": step_collectives(name, eng, run["tokens"],
                                    prompts.shape[1] + SHARDED_NEW - 1)}
    if mesh.rank == 0:
        out.update(hold_engine_run(name, run, rel_tol=SHARDED_REL_TOL, tokens_equal=True))
    del eng, run
    torch.cuda.empty_cache()
    return out


def seq_parallel_prefills(cfg, mesh, params, inputs: dict, name: str) -> dict:
    """One prefill of ``inputs`` (every row; the mesh cuts none over "data")
    through ``steps.make_prefill_step`` on this rank's shards ``params``
    (the rules' specs), without the flag and then with the reference's
    sequence parallelism (``use_mesh(mesh, seq_parallel=True)``): each
    run's collectives against ``launch/comms.py``'s plan of it, K1 and K3
    counted, and the cut run's logits and this rank's cache shards against
    the flag-less run's (whether bit-equal: under gloo the cut layout sums
    the same float32 partials).  -> the cut run's logits (host) and what
    was measured."""
    from repro_torch import shardctx
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.rwkv import wkv
    from repro_torch.launch import comms, sharding, steps
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves

    b, s = inputs["tokens"].shape
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    abs_cache = api.init_cache(cfg, b, s, device="meta")
    cache_sp = sharding.cache_pspecs(abs_cache, cfg, mesh, batch=b)
    step = steps.make_prefill_step(cfg, mesh=mesh, param_pspecs=pspecs, cache_pspecs=cache_sp)
    runs = {}
    for flag in (False, True):
        cache = sharding.local_zeros(abs_cache, cache_sp, mesh)
        flash.launches = wkv.launches = 0
        shardctx.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shardctx.use_mesh(mesh, seq_parallel=flag):
            logits, cache = step(params, inputs, cache)
        torch.cuda.synchronize()
        got = shardctx.counts()
        plan = {k: (n, float(v)) for k, (n, v) in comms.prefill(
            cfg, mesh.shape, batch=b, seq=s, seq_parallel=flag,
            model_index=mesh.coords["model"]).items()}
        runs[flag] = {"logits": logits.float(), "cache": list(tensor_leaves(cache)),
                      "counted": got, "plan": plan, "s": time.perf_counter() - t0,
                      "launches": {"flash_attention": flash.launches, "wkv6": wkv.launches}}
        if got != plan:
            raise SystemExit(f"rank {mesh.rank} {name}: the prefill's collectives {got} "
                             f"(sequence parallel: {flag}) differ from the plan {plan}")
    cut, whole = runs[True], runs[False]
    rows = row_rel(cut["logits"], whole["logits"])
    cache_rel = max(((a.float() - c.float()).norm() / c.float().norm().clamp_min(1e-30)).item()
                    for a, c in zip(cut["cache"], whole["cache"]))
    out = {"bit_equal": bool(torch.equal(cut["logits"], whole["logits"])),
           "cache_bit_equal": all(torch.equal(a, c) for a, c in zip(cut["cache"],
                                                                      whole["cache"])),
           "worst_row": rows.max().item(), "cache_rel": cache_rel,
           "launches": cut["launches"], "counted": cut["counted"],
           "flagless_counted": whole["counted"], "s": cut["s"], "flagless_s": whole["s"]}
    ratio = (sum(v[1] for v in cut["counted"].values())
             / max(sum(v[1] for v in whole["counted"].values()), 1e-30))
    log(f"[sharded] rank {mesh.rank} {name} sequence parallel: prefill "
        f"{tuple(inputs['tokens'].shape)} "
        f"moves {cut['counted']} (the plan's, launch/comms.py); without the flag "
        f"{whole['counted']}; link bytes {ratio:.4f} of the flag-less; launches "
        f"{cut['launches']}; logits bit-equal to the flag-less run's: {out['bit_equal']} "
        f"(worst row {out['worst_row']:.3e}), cache shards bit-equal: "
        f"{out['cache_bit_equal']} (worst leaf rel_l2 {cache_rel:.3e}); "
        f"{cut['s']:.3f} s, flag-less {whole['s']:.3f} s")
    out["link_ratio"] = ratio
    return {"logits": cut["logits"].cpu(), **out}


def seq_parallel_gates(rank: int, tp) -> tuple[dict, dict]:
    """The float32 gates of sequence parallelism on (1, 2), 2 layers at full
    width (recurrentgemma-9b one pattern unit, whisper-tiny whole): the
    cut prefill's last logits within ``SHARDED_REL_TOL`` of the single
    card's (rank 0), its collectives the plan's, and against the
    flag-less mesh run (``seq_parallel_prefills``); K1 (dense, MoE) and K3
    (RWKV-6) launched.  -> (rank 0's readings, the launches)."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get
    from repro_torch.launch import sharding
    from repro_torch.models import api

    dev = tp.device
    report, launches = {}, {}
    for arch in ("deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b", "recurrentgemma-9b",
                 "whisper-tiny"):
        full = get(arch).config
        layers = (len(full.pattern) if full.pattern else
                  full.num_layers if full.family == "audio" else 2)
        gcfg = f32(full, layers)
        name = f"{arch} (1, 2) float32, {layers} layers"
        inputs = {"tokens": deepseek_inputs(gcfg)[0].to(dev)}
        if gcfg.family == "audio":
            inputs["frame_embeds"] = torch.randn(
                (4, gcfg.encoder_seq, gcfg.d_model), generator=torch.Generator().manual_seed(5)
            ).to(dev)
        params = api.init_params(gcfg, torch.Generator(device=dev).manual_seed(0), dev)
        if gcfg.family == "ssm":
            redraw_wo(params, gcfg, dev)
        want = api.prefill(params, inputs, gcfg)[0].float().cpu() if rank == 0 else None
        dist.barrier()
        local = sharding.shard_tree(params, sharding.param_pspecs(
            api.abstract_params(gcfg), gcfg, tp), tp)
        del params
        torch.cuda.empty_cache()
        r = seq_parallel_prefills(gcfg, tp, local, inputs, name)
        del local
        torch.cuda.empty_cache()
        kernel = {"dense": "flash_attention", "moe": "flash_attention",
                  "ssm": "wkv6"}.get(gcfg.family)
        if kernel and r["launches"][kernel] != layers:
            raise SystemExit(f"rank {rank} {name}: {kernel} launched {r['launches'][kernel]} "
                             f"times in the cut prefill, not once a layer ({layers})")
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        got = r.pop("logits")
        if rank == 0:
            rel = ((got - want).norm() / want.norm()).item()
            ok = bool(torch.isfinite(got).all()) and rel <= SHARDED_REL_TOL
            log(f"[sharded] {name} sequence parallel: prefill logits {tuple(got.shape)} "
                f"against the single card: rel_l2 {rel:.3e} (tol {SHARDED_REL_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name}: the cut prefill disagrees with the single card")
            report[name] = {"rel": rel, **r}
    return report, launches


def f32(cfg, layers: int | None = None):
    """``cfg`` in float32, at ``layers`` layers where given."""
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    return cfg if layers is None else cfg.replace(num_layers=layers)


def new_layouts_rank(rank: int, tp, dp) -> tuple[dict, dict]:
    """Phase 11's layouts that cut a KV sequence or heads inside, on the
    two ranks: deepseek-7b's long-KV decode over "data", unwindowed and
    windowed; recurrentgemma-9b on (1, 2) at full width in bf16
    (held row by row to the single card with its row products split as the
    ranks split them, ``split_rows``), its float32 gate at one pattern unit
    and one float32 train step there; whisper-tiny's float32 gate on
    (1, 2).  -> (rank 0's readings, the launches)."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get
    from repro_torch.models import api

    dev = tp.device
    report, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    cfg = get("deepseek-7b").config.replace(num_layers=SHARDED_LAYERS)
    for window in (0, LONG_WINDOW):
        t0 = time.perf_counter()
        run = long_kv_run(cfg, dp, window)
        add(run["launches"])
        entry = {"mesh_s": run["mesh_s"], "step": run["step"], "peak_gib": run["peak_gib"]}
        if rank == 0:
            entry.update(hold_long_kv(run))
        entry["wall_s"] = time.perf_counter() - t0
        report[run["name"]] = entry
        del run

    hcfg = get("recurrentgemma-9b").config.replace(num_layers=SHARDED_LAYERS)
    prompts = deepseek_inputs(hcfg)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = sharded_engine_run(hcfg, tp, prompts, lambda: api.init_params(
        hcfg, torch.Generator(device=dev).manual_seed(0), dev), split=True)
    eng = run.pop("engine")
    name = f"{hcfg.name} (1, 2) bf16"
    entry = {"mesh_s": run["mesh_s"], "collectives": run["collectives"],
             "step": step_collectives(name, eng, run["tokens"],
                                      prompts.shape[1] + SHARDED_NEW - 1),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        entry.update(hold_engine_run(name, run, row_tol=LOGITS_REL_TOL, tokens_equal=False),
                     single_s=run["single_s"])
    entry["wall_s"] = time.perf_counter() - t0
    report[name] = entry
    del eng, run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gcfg = f32(hcfg, len(hcfg.pattern))
    name = f"{hcfg.name} (1, 2) float32, {gcfg.num_layers} layers"
    report[name] = r = gate_run(gcfg, tp, name, lambda: api.init_params(
        gcfg, torch.Generator(device=dev).manual_seed(0), dev))
    add(r["launches"])
    want = single_train_step(gcfg, dev, grads=True) if rank == 0 else None
    dist.barrier()
    name = f"{hcfg.name} (1, 2) tensor parallel, {gcfg.num_layers} layers"
    report[f"train {name}"] = r = sharded_train_check(
        gcfg, tp, name, False, want, kernels=("grad_sumsq", "adamw_update"))
    add(r["launches"])
    r["wall_s"] = time.perf_counter() - t0     # the gate and the train step
    del want

    wcfg = f32(get("whisper-tiny").config)
    name = f"{wcfg.name} (1, 2) float32"
    report[name] = r = gate_run(wcfg, tp, name, lambda: api.init_params(
        wcfg, torch.Generator(device=dev).manual_seed(0), dev))
    add(r["launches"])
    return report, launches


def wide_rank(rank: int, out_dir: str, world: int) -> None:
    """Phase 11 on one of ``world`` ranks sharing the card through gloo, on
    the model axis alone: whisper-tiny's float32 gate on (1, 4), its heads
    and its caches' sequences (self and cross attention) cut over "model";
    qwen3-moe-235b-a22b's float32 gate on (1, 8), full width at
    ``QWEN3_LAYERS`` layers, its 64 query heads whole on each rank, its 4 kv
    heads cut inside, its cache's sequence over "model" (K2 with its row
    lse on every rank), its experts 16 a rank, each rank's shards drawn
    leaf by leaf (``leafwise_params``).  Each rank writes its report."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api

    t_start = time.perf_counter()
    mesh = make_local_mesh(1, world)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats()
    if world == 4:
        cfg = f32(get("whisper-tiny").config)
        name = f"{cfg.name} (1, 4) float32"
        r = gate_run(cfg, mesh, name, lambda: api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev))
    else:
        cfg = f32(get("qwen3-moe-235b-a22b").config, QWEN3_LAYERS)
        name = f"{cfg.name} (1, {world}) float32, {cfg.num_layers} layers"
        specs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
        r = gate_run(cfg, mesh, name, lambda: leafwise_params(cfg, dev),
                     local_fn=lambda: leafwise_params(cfg, dev, mesh, specs))
    report = {"rank": rank, "launches": r.pop("launches"), name: r,
              "seconds": time.perf_counter() - t_start,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def sharded_rank(rank: int, out_dir: str) -> None:
    """Phase 11 on one of the ranks (``repro_torch.launch.mesh.spawn``).
    Rank 0 runs each single-card oracle while the other waits, then both
    run the sharded path; rank 0 holds the results and raises on a
    mismatch.  Each rank writes its launches and seconds to ``out_dir``."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import shardctx
    from repro_torch.configs.registry import get
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api

    t_start = time.perf_counter()
    tp = make_local_mesh(1, 2)
    dp = make_local_mesh(2, 1)
    dev = tp.device
    launches = dict.fromkeys(("flash_attention", "flash_decode", "wkv6", "flash_attention_bwd",
                              "grad_sumsq", "adamw_update"), 0)
    report = {"rank": rank}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # deepseek-7b at full width and SHARDED_LAYERS layers, bf16, (1, 2)
    cfg = get("deepseek-7b").config.replace(num_layers=SHARDED_LAYERS)
    prompts, _ = deepseek_inputs(cfg)
    torch.cuda.reset_peak_memory_stats()
    run = sharded_engine_run(cfg, tp, prompts, lambda: api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), split=True)
    eng = run.pop("engine")
    add(run["launches"])
    steps_run = SHARDED_NEW - 1
    want_k = {"flash_attention": cfg.num_layers, "flash_decode": cfg.num_layers * steps_run}
    k = run["launches"]
    log(f"[sharded] rank {rank} {cfg.name} (1, 2) bf16: K1 {k['flash_attention']} (layers x "
        f"prefills = {want_k['flash_attention']}), K2 {k['flash_decode']} (layers x steps = "
        f"{want_k['flash_decode']}); generate {run['mesh_s']:.3f} s, collectives of the "
        f"generate {run['collectives']}")
    if any(k[n] != v for n, v in want_k.items()):
        raise SystemExit(f"rank {rank}: K1/K2 launches {k} on the sharded path, not {want_k}")
    # one decode step's collectives on this rank
    tok = run["tokens"][:, -1].to(dev)
    pos = torch.full((prompts.shape[0],), prompts.shape[1] + steps_run, device=dev)
    with shardctx.use_mesh(tp):
        shardctx.reset_counts()
        api.decode_step(eng.params, eng._cache, tok, pos, cfg)
        per_step = shardctx.counts()
    n = tp.shape["model"]
    b = prompts.shape[0]
    ring = (n - 1) / n
    plan = {"all-reduce": (2 * cfg.num_layers + 1,
                           (2 * cfg.num_layers + 1) * 2.0 * (b * cfg.d_model * 4) * ring),
            "all-gather": (1, b * cfg.vocab_size * 4 * ring)}
    log(f"[sharded] rank {rank} {cfg.name} (1, 2): one decode step (batch {b}) moves "
        f"{per_step}; plan_shards' formula at this config: {plan}; bytes per rank "
        f"{sum(v[1] for v in per_step.values()):.0f} against "
        f"{sum(v[1] for v in plan.values()):.0f}")
    if per_step != plan:
        raise SystemExit(f"rank {rank}: one decode step's collectives {per_step} differ from "
                         f"plan_shards' {plan}")
    report["deepseek"] = {"mesh_s": run["mesh_s"], "collectives": per_step,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        held = hold_engine_run(f"{cfg.name} (1, 2) bf16", run, row_tol=LOGITS_REL_TOL,
                               tokens_equal=False)
        report["deepseek"].update(held, single_s=run["single_s"])
        log(f"[sharded] {cfg.name} tokens, sharded: {run['tokens'].tolist()}")
        log(f"[sharded] {cfg.name} tokens, single card: {run['want'].tolist()}")
    parts = [report["deepseek"]["parts"] if rank == 0 else None]
    dist.broadcast_object_list(parts, src=0)
    margins = parting_margins(eng, prompts, run["tokens"], run["tokens"] if rank else run["want"],
                              parts[0])
    if rank == 0 and margins:
        log(f"[sharded] {cfg.name}: where the tokens part (row, step, the sharded engine's "
            f"logit of its token less that of the single card's): {margins}")
    # the same ranks' prefill with the reference's sequence parallelism
    t0 = time.perf_counter()
    sp = seq_parallel_prefills(cfg, tp, eng.params, {"tokens": prompts.to(dev)},
                               f"{cfg.name} (1, 2) bf16")
    sp.pop("logits")
    if sp["launches"]["flash_attention"] != cfg.num_layers:
        raise SystemExit(f"rank {rank}: K1 launched {sp['launches']['flash_attention']} times "
                         f"in the cut prefill, not {cfg.num_layers}")
    if sp["worst_row"] > ROW_REL_TOL:
        raise SystemExit(f"rank {rank}: the cut prefill's logits part from the flag-less "
                         f"run's: worst row {sp['worst_row']:.3e}")
    add(sp["launches"])
    sp["wall_s"] = time.perf_counter() - t0
    report["deepseek_sp"] = sp
    del eng, run
    torch.cuda.empty_cache()

    # the float32 gates at 2 layers, full width
    gates = []
    for arch, mesh, mname in (("deepseek-7b", tp, "(1, 2)"), ("deepseek-7b", dp, "(2, 1)"),
                              ("granite-moe-3b-a800m", tp, "(1, 2)"),
                              ("rwkv6-1.6b", tp, "(1, 2)")):
        full = get(arch).config
        gcfg = full.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
        gprompts = deepseek_inputs(gcfg)[0]

        def params_fn(gcfg=gcfg):
            p = api.init_params(gcfg, torch.Generator(device=dev).manual_seed(0), dev)
            if gcfg.family == "ssm":
                redraw_wo(p, gcfg, dev)
            return p

        run = sharded_engine_run(gcfg, mesh, gprompts, params_fn)
        run.pop("engine")
        add(run["launches"])
        log(f"[sharded] rank {rank} {arch} {mname} float32, 2 layers: launches "
            f"{run['launches']}; generate {run['mesh_s']:.3f} s")
        kernel = "wkv6" if gcfg.family == "ssm" else "flash_decode"
        if not run["launches"][kernel]:
            raise SystemExit(f"{arch} {mname}: {kernel} never launched on the sharded path")
        if rank == 0:
            held = hold_engine_run(f"{arch} {mname} float32, 2 layers", run,
                                   rel_tol=SHARDED_REL_TOL, tokens_equal=True)
            gates.append({"arch": arch, "mesh": mname, **held})
        del run
        torch.cuda.empty_cache()
    report["gates"] = gates
    t0 = time.perf_counter()
    report["sp_gates"], more = seq_parallel_gates(rank, tp)
    add(more)
    report["sp_gates_s"] = time.perf_counter() - t0

    # one AdamW step of deepseek-7b at 2 layers, float32
    tcfg = get("deepseek-7b").config.replace(num_layers=2, param_dtype="float32",
                                             compute_dtype="float32")
    want = single_train_step(tcfg, dev) if rank == 0 else None
    dist.barrier()
    trains = {}
    for name, mesh, fsdp in (("(2, 1) data parallel", dp, False), ("(2, 1) FSDP", dp, True),
                             ("(1, 2) tensor parallel", tp, False)):
        trains[name] = r = sharded_train_check(tcfg, mesh, name, fsdp, want,
                                               keep=mesh is tp)
        add(r["launches"])
    t0 = time.perf_counter()
    name = "(1, 2) sequence parallel"
    trains[name] = r = sharded_train_check(
        tcfg, tp, name, False, want, seq_parallel=True,
        against=trains["(1, 2) tensor parallel"].pop("params", None))
    add(r["launches"])
    r["wall_s"] = time.perf_counter() - t0
    report["train"] = trains
    report["f1_s"] = time.perf_counter() - t_start
    del want
    report["layouts"], more = new_layouts_rank(rank, tp, dp)
    add(more)
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_start
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def sharded_phase() -> dict:
    """Phase 11: the sharded paths on ``SHARDED_WORLD`` ranks placed on the
    cards present (NCCL with a card a rank when there are enough, gloo when
    they share one; the backend printed), then on 4 and 8 ranks
    (``wide_rank``).  -> rank 0's reports and the kernel launches summed
    over the ranks."""
    from repro_torch.launch.mesh import backend_for, spawn

    launches, reports, walls = {}, {}, {}
    log(f"[sharded] the bf16 runs of deepseek-7b and recurrentgemma-9b at full width take "
        f"{SHARDED_LAYERS} layers (SHARDED_LAYERS)")
    for world, fn, args in ((SHARDED_WORLD, sharded_rank, ()), (4, wide_rank, (4,)),
                            (8, wide_rank, (8,))):
        backend, _ = backend_for(world, "cuda")
        log(f"[sharded] world={world} cards={torch.cuda.device_count()} backend={backend}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            spawn(fn, world, (tmp, *args), device="cuda", timeout_s=600)
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
        walls[world] = time.perf_counter() - t0
        for rep in ranks:
            for k, n in rep["launches"].items():
                launches[k] = launches.get(k, 0) + n
            log(f"[sharded] world {world} rank {rep['rank']}: {rep['seconds']:.1f} s in the "
                f"rank, peak allocated {rep['peak_gib']:.2f} GiB; launches {rep['launches']}")
        if world == SHARDED_WORLD:
            log(f"[sharded] deepseek-7b (1, 2) bf16 peak allocated: "
                + ", ".join(f"rank {rep['rank']} {rep['deepseek']['peak_gib']:.2f} GiB"
                            for rep in ranks))
            for name, entry in ranks[0]["layouts"].items():
                peaks = [rep["layouts"][name].get("peak_gib") for rep in ranks]
                if peaks[0] is not None:
                    log(f"[sharded] {name}: peak allocated per rank "
                        + ", ".join(f"{p:.2f} GiB" for p in peaks))
                if "wall_s" in entry:
                    log(f"[sharded] {name}: {entry['wall_s']:.1f} s of the phase")
            log(f"[sharded] the F1 runs before them: {ranks[0]['f1_s']:.1f} s")
            r0 = ranks[0]
            log(f"[sharded] sequence parallelism: deepseek-7b bf16 prefills "
                f"{r0['deepseek_sp']['wall_s']:.1f} s, the float32 gates "
                f"{r0['sp_gates_s']:.1f} s, the AdamW step "
                f"{r0['train']['(1, 2) sequence parallel']['wall_s']:.1f} s; deepseek-7b's "
                f"cut prefill bit-equal to the flag-less run's: "
                f"{r0['deepseek_sp']['bit_equal']}, link bytes "
                f"{r0['deepseek_sp']['link_ratio']:.4f} of the flag-less")
        reports[world] = ranks[0]
        log(f"[sharded] phase 11, {world} ranks: {walls[world]:.1f} s, spawned and joined")
    log(f"[sharded] phase 11: {sum(walls.values()):.1f} s")
    return {"reports": reports, "launches": launches, "wall_s": sum(walls.values())}


def bootstrap_line() -> None:
    """The seconds of ``import torch`` and of the first CUDA context in a
    fresh process: the torch counterparts of the cold BOOTSTRAP that the
    simulator models as a constant (1.0 s for modern handlers, 1.2 s for
    the paper's MXNet import)."""
    code = ("import time; t0 = time.perf_counter(); import torch; "
            "t1 = time.perf_counter(); torch.zeros(1, device='cuda'); "
            "torch.cuda.synchronize(); t2 = time.perf_counter(); "
            "print(t1 - t0, t2 - t1)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.split()
    log(f"[bootstrap] a fresh process: import torch {float(out[0]):.3f} s, first CUDA "
        f"context (one tensor on the card) {float(out[1]):.3f} s")


def cnn_phase(dev) -> dict:
    """Phase 5: the paper's three CNN payloads at full size (224 px,
    float32, seeded weights, every folded BatchNorm's scale and bias redrawn
    from U(0.5, 1.5) and N(0, 0.1) in place of the init's 1 and 0): batch 1
    (the paper's Lambda request) and batch 4 of random images on the card
    against the CPU on the same weights, then
    the first call's and the warm forward's time, the device time and
    kernel launches of a forward, and its bound; then the same forward
    captured into a ``ForwardGraph`` and replayed, its logits against the
    uncaptured forward's, its first call (warm-up, capture and first
    replay) and its warm time, device time and host launch calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import PAPER_MODELS
    from repro_torch.models import cnn
    from repro_torch.models.common import param_bytes
    from repro_torch.serving.graphs import ForwardGraph

    out = {}
    images = torch.randn((4, 3, 224, 224), generator=torch.Generator().manual_seed(10))
    for name, spec in PAPER_MODELS.items():
        cfg = spec.config
        gen = torch.Generator(device=dev).manual_seed(0)
        params = redraw_bn(cnn.init_params(cfg, gen, dev), gen)
        cpu_params = tree_map(torch.Tensor.cpu, params)
        mb = param_bytes(params) / 1e6
        lo, hi = CNN_PAPER_MB[name][1:]
        log(f"[cnn] {name} ({cfg.name}): {mb:.2f} MB of float32 parameters (the paper: "
            f"{CNN_PAPER_MB[name][0]} MB; accepted {lo}-{hi})")
        if not lo <= mb <= hi:
            raise SystemExit(f"{name}: {mb:.2f} MB of parameters, outside {lo}-{hi}")
        x1 = images[:1].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnn.forward(params, x1, cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        row = {"first_ms": first_ms, "mb": mb}
        for b in (1, 4):
            x = images[:b].to(dev)
            got = cnn.forward(params, x, cfg).cpu()
            want = cnn.forward(cpu_params, images[:b], cfg)
            rel = ((got - want).norm() / want.norm()).item()
            same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
            # the per-image part: the logits less their batch mean
            centred, want_centred = got - got.mean(0), want - want.mean(0)
            share = (want_centred.norm() / want.norm()).item()
            crel = ((centred - want_centred).norm() / want_centred.norm()).item() if b > 1 else 0.0
            log(f"[cnn] {name} batch {b} 224 px: card vs CPU logits rel_l2={rel:.3e} "
                f"(tol {CNN_REL_TOL:g}) max_abs={(got - want).abs().max().item():.3e} "
                f"top-1 {'equal' if same else 'DIFFERS'}: {got.argmax(-1).tolist()}"
                + (f"; per-image part {share:.3e} of the logits (at least "
                   f"{CNN_MIN_PER_IMAGE_SHARE:g}), its rel_l2={crel:.3e} (tol "
                   f"{CNN_CENTRED_TOL:g})" if b > 1 else ""))
            if not torch.isfinite(got).all() or rel > CNN_REL_TOL or not same or (
                    b > 1 and (share < CNN_MIN_PER_IMAGE_SHARE or crel > CNN_CENTRED_TOL)):
                raise SystemExit(f"{name} batch {b}: the card's forward disagrees with the CPU's")
            graph = ForwardGraph(x.shape, cfg.num_classes, dev,
                                 lambda images: cnn.forward(params, images, cfg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.capture()
            replayed = graph.run(x).cpu()
            if b == 1:
                row["first_replayed_ms"] = (time.perf_counter() - t0) * 1e3
            rrel = ((replayed - got).norm() / got.norm()).item()
            rcrel = ((replayed - replayed.mean(0) - centred).norm()
                     / centred.norm()).item() if b > 1 else 0.0
            log(f"[cnn] {name} batch {b}: replayed vs uncaptured forward on the card "
                f"rel_l2={rrel:.3e} (tol {CNN_REL_TOL:g}) max_abs="
                f"{(replayed - got).abs().max().item():.3e}"
                + (f", per-image part rel_l2={rcrel:.3e} (tol {CNN_CENTRED_TOL:g})"
                   if b > 1 else ""))
            if not graph.captured or not torch.isfinite(replayed).all() or \
                    rrel > CNN_REL_TOL or rcrel > CNN_CENTRED_TOL:
                raise SystemExit(f"{name} batch {b}: the replayed forward disagrees with the "
                                 "uncaptured one")

            def warm(fn):
                walls = []
                for _ in range(20):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                return float(np.median(walls))

            with FlopCounterMode(display=False) as fc:
                cnn.forward(params, x, cfg)
            flops = fc.get_total_flops()
            # the weights and images read once, the logits written once
            nbytes = param_bytes(params) + x.numel() * 4 + b * cfg.num_classes * 4
            eager = profiled(
                f"cnn {name} b{b}", lambda: None,
                lambda _: [cnn.forward(params, x, cfg) for _ in range(10)], 10,
                nbytes, flops, dtype=torch.float32, top=5 if b == 1 else 0)
            graphed = profiled(
                f"cnn {name} b{b} replayed", lambda: None,
                lambda _: [graph.run(x) for _ in range(10)], 10,
                nbytes, flops, dtype=torch.float32, top=0)
            bound_ms, bound_by = bound(nbytes, flops, torch.float32)
            row[b] = {"warm_ms": warm(lambda: cnn.forward(params, x, cfg)),
                      "device_ms": eager["device"], "launches": eager["launches"],
                      "calls": eager["calls"], "replayed_ms": warm(lambda: graph.run(x)),
                      "replayed_device_ms": graphed["device"],
                      "replayed_calls": graphed["calls"], "replayed_rel": rrel,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "gflop": flops / 1e9, "rel": rel, "centred_rel": crel}
            log(f"[cnn] {name} batch {b}: first call {first_ms:.3f} ms (batch 1), warm "
                f"{row[b]['warm_ms']:.3f} ms (median of 20), device {eager['device']:.4f} ms "
                f"in {eager['launches']:.0f} launches; replayed warm {row[b]['replayed_ms']:.3f} "
                f"ms, device {graphed['device']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
            del graph
        out[name] = row
        del params, cpu_params
    return out


def calibration_phase(dev) -> dict:
    """Phase 8: the port's calibration of eight models at full width on the
    card, into a temporary cache file, every launch counter set to 0 before
    each model and read after it: K1 and K2 must launch while deepseek-7b
    and granite-moe-3b-a800m are measured (each with a batch curve) and K3
    while rwkv6-1.6b is; recurrentgemma-9b and whisper-tiny run no kernel
    and take no batch curve, as in the reference.  llava-next-mistral-7b is
    not calibrated: the reference's calibration of a vlm fails at its batch
    curve, and the port's follows it.  Then the platform, scenario and
    replay steps on that cache; returns the kernels' launches in the
    replay, a path of its own."""
    from repro_torch.core import calibration
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log("[calibration] llava-next-mistral-7b is not calibrated: the reference's "
        "calibration takes a vlm's batch curve through its ContinuousServer "
        "(repro/core/calibration.py:266-267), whose admission hands the vlm prefill no "
        "patch embeddings (repro/serving/continuous.py:92-95 against "
        "repro/models/vlm.py:60-61) and raises KeyError; the port's does the same")
    measure, launches = calibration.measure_model, {}

    def counted(name, **kw):
        flash.launches = fd.launches = wkv.launches = 0
        entry = measure(name, **kw)
        launches[name] = {"flash_attention": flash.launches, "flash_decode": fd.launches,
                          "wkv6": wkv.launches}
        return entry

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "calibration_torch.json")
        t0 = time.perf_counter()
        with mock.patch.object(calibration, "measure_model", counted):
            cache = calibration.calibrate(path, force=True, models=CALIBRATED)
        wall = time.perf_counter() - t0
        if calibration.load_cache(path) != cache:
            raise SystemExit("calibration: the cache file does not load back as written")
        platform_step(path)
        scenario_step(path)
        replay = replay_step(path)
    log(f"[calibration] {len(cache['models'])} models in {wall:.1f} s; host "
        f"{json.dumps(cache['host'])}")
    for name in CALIBRATED:
        entry = cache["models"][name]
        log(f"[calibration] {name}: {json.dumps(entry)}; launches {launches[name]}")
        want = CNN_ENTRY if entry.get("kind") == "cnn" else LLM_ENTRY
        times = [v for k, v in entry.items() if k.endswith("_s")]
        if set(entry) != want or not all(v > 0 and math.isfinite(v) for v in times):
            raise SystemExit(f"calibration entry {name}: fields {sorted(entry)} or times "
                             f"{times} are not those of the v2 schema")
    want_points = {"deepseek-7b": 3, "granite-moe-3b-a800m": 3, "rwkv6-1.6b": 0,
                   "recurrentgemma-9b": 0, "whisper-tiny": 0}
    curves = {n: len(cache["models"][n]["batch_curve"]) for n in want_points}
    if curves != want_points:
        raise SystemExit(f"calibration: batch curves of {curves} points")
    ds, gr, rw = (launches[n] for n in ("deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b"))
    if not (ds["flash_attention"] and ds["flash_decode"] and gr["flash_attention"]
            and gr["flash_decode"] and rw["wkv6"]):
        raise SystemExit(f"calibration: a kernel of the LLM paths never launched: {launches}")
    for name in CALIBRATED:
        h = (calibration.paper_handler(name, calibrated=cache)
             if name in calibration.PAPER_MODELS else
             calibration.modern_handler(name, calibrated=cache))
        log(f"[calibration] handler {h}")
    log(f"[memory] calibration peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return replay


# the platform step: the paper's CNNs on Lambda at its 1024 MB knee, and
# deepseek-7b on a GPU-serverless host with the whole card's memory
PLATFORM_CNN_MB, PLATFORM_LLM_MB = 1024, 16384
PLATFORM_MAX_S = 15.0
# the identity a zero-jitter cold start keeps, in seconds
PLATFORM_TOL_S = 1e-9


# the scenario step: every named scenario whose fleet the card's cache holds,
# at scale 1.0; host time only
SCENARIO_MAX_S = 120.0
# the one scenario whose model no single card holds, and its advisor's SLA
SCENARIO_LEFT_OUT = "sharded_110b"
ADVISOR_P95_S = 0.6


def _row(result) -> dict:
    """An ``ExperimentResult``'s ``run_stack`` row (its spec, fleet, trace
    length, effective stack and verdict dropped)."""
    drop = {"spec", "n_requests", "fleet", "effective_stack", "verdict"}
    return {k: v for k, v in result.to_dict().items() if k not in drop}


def scenario_step(path: str) -> None:
    """The port's named scenarios on the cache phase 8 just wrote, at scale
    1.0, each through ``ExperimentSpec(name, winner, versus="baseline")``
    (and ``versus=rival`` where the scenario names one) on a platform built
    with ``calibrated=`` that cache, so that nothing is read, measured or
    estimated from anything but the card's entries (``measure_model`` fails
    if called).  ``sharded_110b`` is not run: no single card holds
    qwen1.5-110b at full width, so no cache holds its entry; the reason is
    printed with the model's size.  Checks: every request of each trace has
    a record and every time is finite; a second run of the same specs gives
    equal rows; ``run_specs`` with two workers gives the rows of one worker
    and of ``ExperimentSpec.run``; on ``gpu_serverless`` (deepseek-7b,
    measured through K1 and K2) ``adaptive`` beats ``baseline`` on cold rate
    and p95.  The other verdicts are findings, printed and not gated.  Then
    the memory advisor for each CNN on its card entry, over a 25-request
    warm burst against a 0.6 s p95 across the paper's tiers."""
    from repro_torch.configs.registry import get
    from repro_torch.core import advisor, calibration, scenarios, sla, workload
    from repro_torch.core.cluster import policies
    from repro_torch.core.function import PAPER_TIERS
    from repro_torch.core.platform import ServerlessPlatform
    from repro_torch.core.stack import ExperimentSpec, run_specs

    def refuse(name, **kw):
        raise SystemExit(f"scenario: {name} was measured; the step must measure nothing")

    t0 = time.perf_counter()
    with mock.patch.object(calibration, "measure_model", refuse):
        cache = calibration.load_cache(path, device="cuda")
        if cache is None:
            raise SystemExit(f"scenario: the cache at {path} does not load")
        default = Path(calibration.default_cal_path())
        measured = policies._measured_models()
        log(f"[scenario] the scaling estimates' measured entries: {sorted(measured)} from "
            f"{default} ({'present' if default.exists() else 'absent'}); every handler "
            f"comes from the cache phase 8 wrote")
        held, specs, skipped = set(cache["models"]), {}, []
        for name in scenarios.names():
            sc = scenarios.get(name)
            missing = sorted({f.model for f in sc.functions} - held)
            if missing:
                skipped.append(name)
                cfg = get(missing[0]).config
                n = cfg.param_count()
                gb = n * torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size() / 1e9
                card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
                log(f"[scenario] {name}: not run; its fleet needs {missing}, which the cache "
                    f"does not hold: {missing[0]} at full width has {n / 1e9:.2f} B parameters, "
                    f"{gb:.1f} GB in {cfg.param_dtype}, over this card's {card_gb:.1f} GB, so "
                    f"no single card measures it")
                continue
            specs[name] = [ExperimentSpec(name, sc.expected_winner, versus=v)
                           for v in ["baseline"] + ([sc.rival] if sc.rival else [])]
        if skipped != [SCENARIO_LEFT_OUT]:
            raise SystemExit(f"scenario: {skipped} not run; only {SCENARIO_LEFT_OUT} may be")

        def run_all() -> dict:
            out = {}
            for name, runs in specs.items():
                plat = ServerlessPlatform(seed=0, calibrated=cache)
                out[name] = [spec.run(plat) for spec in runs]
            return out

        t1 = time.perf_counter()
        results = run_all()
        first_s = time.perf_counter() - t1
        for name, runs in results.items():
            for r in runs:
                o = r.verdict["versus_row"]
                log(f"[scenario] {r.summary_line()}; n_requests {r.n_requests}, fleet of "
                    f"{len(r.fleet)}, SLA {r.sla} violations {r.sla_violations}; "
                    f"unrounded: cold rate {r.cold_rate!r}, p95 {r.p95_s!r} s, $/1k "
                    f"{r.cost_per_1k!r}; {r.verdict['versus']}: cold rate "
                    f"{o['cold_rate']!r}, p95 {o['p95_s']!r} s, $/1k {o['cost_per_1k']!r}, "
                    f"SLA {'ok' if o['sla_ok'] else 'FAIL'}")
                for row in (_row(r), r.verdict["versus_row"]):
                    times = [row[k] for k in ("p50_s", "p95_s", "p99_s", "cost_per_1k",
                                              "mitigation_per_1k")]
                    if row["n"] != r.n_requests or not all(math.isfinite(x) for x in times):
                        raise SystemExit(f"scenario: {name} served {row['n']} of "
                                         f"{r.n_requests} requests, or a time is not "
                                         f"finite: {times}")
        again = run_all()
        if {n: [r.to_dict() for r in v] for n, v in again.items()} != \
                {n: [r.to_dict() for r in v] for n, v in results.items()}:
            raise SystemExit("scenario: a second run of the same specs gave other rows")
        units, want = [], []
        for name, runs in results.items():
            units.append(ExperimentSpec(name, runs[0].spec.stack))
            want.append(_row(runs[0]))
            for r in runs:
                units.append(ExperimentSpec(name, r.verdict["versus"]))
                want.append(r.verdict["versus_row"])
        t1 = time.perf_counter()
        serial = run_specs(units, calibrated=cache)
        serial_s = time.perf_counter() - t1
        how = "forked" if threading.active_count() == 1 else "spawned"
        t1 = time.perf_counter()
        parallel = run_specs(units, jobs=2, calibrated=cache)
        parallel_s = time.perf_counter() - t1
        if serial != want:
            raise SystemExit("scenario: run_specs gave other rows than ExperimentSpec.run")
        if parallel != serial:
            raise SystemExit("scenario: run_specs with two workers gave other rows than one")
        log(f"[scenario] {len(units)} work units: run_specs serial {serial_s:.2f} s, two "
            f"workers ({how}) {parallel_s:.2f} s, rows equal to each other, to "
            f"ExperimentSpec.run's and to a repeat run's")
        gpu = results["gpu_serverless"][0]
        base = gpu.verdict["versus_row"]
        log(f"[scenario] gpu_serverless on the card's deepseek-7b entry: adaptive cold rate "
            f"{gpu.cold_rate!r} p95 {gpu.p95_s!r} s against baseline {base['cold_rate']!r} "
            f"{base['p95_s']!r} s")
        if not (gpu.cold_rate < base["cold_rate"] and gpu.p95_s < base["p95_s"]):
            raise SystemExit("scenario: gpu_serverless' adaptive does not beat baseline on "
                             "cold rate and p95 on the card's numbers")
        verdicts = {f"{r.spec.scenario} vs {r.verdict['versus']}":
                    "WIN" if r.verdict["win"] else "NO-WIN"
                    for runs in results.values() for r in runs}
        log(f"[scenario] verdicts (findings, not gated): {json.dumps(verdicts)}")
        plat = ServerlessPlatform(seed=0, calibrated=cache)
        grade = sla.SLA("x", p95_s=ADVISOR_P95_S)
        for name in calibration.PAPER_MODELS:
            h = plat.deploy_model(name, PLATFORM_CNN_MB).handler
            best, reports, ok = advisor.recommend(h, workload.warm_burst(n=25), grade,
                                                  tiers=PAPER_TIERS, seed=0)
            if best is None:
                raise SystemExit(f"scenario: the advisor found no feasible tier for {name}")
            log(f"[advisor] {name} (warm exec {h.base_cpu_seconds!r} s, peak "
                f"{h.peak_memory_mb} MB): recommends {best.memory_mb} MB, SLA p95 <= "
                f"{ADVISOR_P95_S} s {'met' if ok else 'NOT met (lowest p99 instead)'}; "
                f"mean {best.mean_response_s!r} s, p99 {best.p99_s!r} s, cost "
                f"{best.total_cost!r}; {sum(r.feasible for r in reports)} of "
                f"{len(reports)} tiers feasible, {sum(r.sla_ok for r in reports)} meet it")
    wall = time.perf_counter() - t0
    log(f"[scenario] step took {wall:.2f} s of host time ({len(specs)} scenarios, first "
        f"pass {first_s:.2f} s); nothing measured")
    if wall > SCENARIO_MAX_S:
        raise SystemExit(f"scenario: the step took {wall:.1f} s, over {SCENARIO_MAX_S} s")


# the replay step: gpu_serverless' winner over about 200 requests, a few of
# them cold, and baseline over about 40, about half of them cold
REPLAY_RUNS = (("adaptive", 0.5), ("baseline", 0.1))
REPLAY_MAX_S = 150.0


def replay_step(path: str) -> dict:
    """The sim-to-real replay (``repro_torch.core.replay_real``) on the cache
    phase 8 just wrote: ``gpu_serverless``' trace, time-scaled, served by the
    real ``ContinuousServer`` of deepseek-7b at full width (K1 in each
    admission, K2 in each decode step; the first serve of each container
    captures both graphs) and held to the simulator on the card's entry,
    under ``adaptive`` at scale 0.5 and ``baseline`` at scale 0.1.
    ``measure_model`` fails if called.  Each run's container class is
    watched: at each cold no other container may hold a server, and the
    card's allocated memory after the last cold may exceed that after the
    first by no more than one server's footprint (the first cold's
    allocation over the run's start).  Checks: both reports within the
    reference's tolerances, every request served once with a finite wall,
    K1 and K2 launched in each run, the memory back under one footprint
    above the start after each run.  Returns the launches of both runs."""
    from repro_torch.core import calibration, replay_real
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv

    def refuse(name, **kw):
        raise SystemExit(f"replay: {name} was measured; the cache phase 8 wrote must hold it")

    card = card_line()
    t0 = time.perf_counter()
    launches = {"flash_attention": 0, "flash_decode": 0, "wkv6": 0}
    for stack, scale in REPLAY_RUNS:
        made, mem = [], []
        base = torch.cuda.memory_allocated()

        class Watched(replay_real._RealContainer):
            def __init__(self, *a, **kw):
                if any(c.server is not None for c in made):
                    raise SystemExit("replay: a retired container still holds its server")
                super().__init__(*a, **kw)
                self.walls = []
                made.append(self)

            def serve(self, rid, prompt, n_new):
                wall = super().serve(rid, prompt, n_new)
                self.walls.append(wall)
                if len(self.walls) == 1:
                    mem.append(torch.cuda.memory_allocated())
                return wall

        flash.launches = fd.launches = wkv.launches = 0
        t1 = time.perf_counter()
        with mock.patch.object(calibration, "measure_model", refuse), \
                mock.patch.object(replay_real, "_RealContainer", Watched):
            rep = replay_real.replay("gpu_serverless", stack_name=stack, scale=scale,
                                     path=path, device="cuda")
        run_s = time.perf_counter() - t1
        ran = {"flash_attention": flash.launches, "flash_decode": fd.launches,
               "wkv6": wkv.launches}
        after = torch.cuda.memory_allocated()
        # each capture's warm-up runs on a new side stream, and cuBLAS keeps a
        # workspace for every stream it has run on: what stays after the run
        # (freed here, so that the next run starts without them)
        torch._C._cuda_clearCublasWorkspaces()
        cleared = torch.cuda.memory_allocated()
        for name, n in ran.items():
            launches[name] += n
        what = f"[replay] gpu_serverless, deepseek-7b full width, {stack} at scale {scale}"
        log(f"{what}: {rep['n_requests']} requests in {run_s:.2f} s; colds sim "
            f"{rep['sim']['cold_starts']} real {rep['real']['cold_starts']}; virtual phases "
            f"{json.dumps(rep['virtual_phases'])}; within tolerance "
            f"{rep['within_tolerance']} ({card})")
        for name, m in rep["metrics"].items():
            log(f"{what}: {name} sim {m['sim']!r} real {m['real']!r} abs err "
                f"{m['abs_err']!r} rel err {m['rel_err']!r} "
                f"{'ok' if m['within'] else 'OUT OF TOLERANCE'} ({card})")
        inits = sorted(c.init_wall_s for c in made)
        firsts = sorted(c.walls[0] for c in made)
        warms = sorted(w for c in made for w in c.walls[1:])
        walls = [w for c in made for w in c.walls]
        footprint = mem[0] - base
        log(f"{what}: {len(made)} real colds, construction median "
            f"{inits[len(inits) // 2]:.4f} s max {inits[-1]:.4f} s, first serve (the "
            f"graphs' capture) median {firsts[len(firsts) // 2]:.4f} s max {firsts[-1]:.4f} s; "
            f"{len(warms)} warm serves, median "
            + ("none" if not warms else
               f"{warms[len(warms) // 2]:.4f} s p95 "
               f"{warms[min(len(warms) - 1, round(0.95 * (len(warms) - 1)))]:.4f} s")
            + f" ({card})")
        log(f"{what}: launches {ran}; allocated {base / 2**30:.2f} GiB at the run's start, "
            f"{mem[0] / 2**30:.2f} after the first cold, {mem[-1] / 2**30:.2f} after the last, "
            f"{after / 2**30:.2f} after the run, {cleared / 2**30:.2f} with cuBLAS's "
            f"workspaces freed; one server {footprint / 2**30:.2f} GiB ({card})")
        if not rep["within_tolerance"]:
            raise SystemExit(f"replay: {stack} at scale {scale} is out of the reference's "
                             f"tolerances: {json.dumps(rep['metrics'])}")
        finite = [m[k] for m in rep["metrics"].values() for k in ("sim", "real", "rel_err")]
        if not (len(walls) == rep["n_requests"] == rep["sim"]["n"]
                and all(math.isfinite(x) for x in walls + finite)):
            raise SystemExit(f"replay: {len(walls)} serves for {rep['n_requests']} requests "
                             f"({rep['sim']['n']} in the trace), or a time is not finite")
        if not (ran["flash_attention"] and ran["flash_decode"]):
            raise SystemExit(f"replay: K1 or K2 never launched: {ran}")
        if mem[-1] - mem[0] > footprint or after - base > footprint:
            raise SystemExit(f"replay: retired servers stay on the card: {mem[-1] - mem[0]} B "
                             f"more after the last cold than after the first, {after - base} B "
                             f"after the run, one server {footprint} B")
    wall = time.perf_counter() - t0
    log(f"[replay] step took {wall:.2f} s; launches {launches}; nothing measured ({card})")
    if wall > REPLAY_MAX_S:
        raise SystemExit(f"replay: the step took {wall:.1f} s, over {REPLAY_MAX_S} s")
    return launches


def _report_line(name: str, what: str, rep, sla_eval: dict) -> str:
    def stats(s):
        return (f"n {s.n} mean {s.mean_response_s:.4f} p95 {s.p95_s:.4f} "
                f"p99 {s.p99_s:.4f} s")
    return (f"[platform] {name} {what}: all {stats(rep.summary)}; warm {stats(rep.warm)}; "
            f"cold {stats(rep.cold)}; cold starts {rep.cold_starts}; bimodality "
            f"{json.dumps(rep.bimodality)}; SLA {sla_eval['sla']} ok={sla_eval['ok']} "
            f"violations {sorted(k for k, v in sla_eval['violations'].items() if v)}")


def platform_step(path: str) -> None:
    """The port's serverless platform on the cache phase 8 just wrote: the
    paper's question (cold against warm response, SLA percentiles) answered
    from the card's own measurements.  ``measure_model`` is replaced by a
    function that fails, so the step measures nothing and adds host time
    only.  The paper's three experiments for each function
    (``run_cold_experiment``, ``run_warm_experiment``,
    ``run_scalability_experiment``) and one ``invoke_fleet`` of the four;
    each report printed and graded by ``bimodality_report`` and an SLA
    (``INTERACTIVE`` for the CNNs, ``GPU_INTERACTIVE`` for deepseek-7b).
    On ``modal_gpu`` deepseek-7b's cold start outlasts the warm
    experiment's 5 s priming gap, so that burst is served cold, as the
    reference's platform serves it; its warm response is read from a burst
    primed a minute ahead.  Checks: 5 cold starts in each cold experiment,
    none in a CNN's warm burst or in deepseek-7b's primed burst, every time
    finite, each cold mean above its warm mean, deepseek-7b refused on
    ``lambda``, and at jitter 0 deepseek-7b's first cold response equal to
    its cold-start breakdown plus its warm response."""
    from repro_torch.core import calibration, container, sla, workload
    from repro_torch.core.platform import ServerlessPlatform

    def refuse(name, **kw):
        raise SystemExit(f"platform: {name} was measured; the cache phase 8 wrote must hold it")

    t0 = time.perf_counter()
    with mock.patch.object(calibration, "measure_model", refuse):
        plat = ServerlessPlatform(seed=0, device="cuda", calibration_path=path)
        specs = {n: plat.deploy_model(n, PLATFORM_CNN_MB) for n in calibration.PAPER_MODELS}
        try:
            plat.deploy_model("deepseek-7b", 1536)
        except ValueError as e:
            log(f"[platform] deepseek-7b on lambda at 1536 MB refused: {e}")
        else:
            raise SystemExit("platform: deepseek-7b's package was deployed on lambda")
        llm = "deepseek-7b"
        specs[llm] = plat.deploy_model(llm, PLATFORM_LLM_MB, provider="modal_gpu")
        primed = [workload.Request(0, 0.0, "prime")] + [
            workload.Request(1 + i, 60.0 + i, "warm") for i in range(25)]
        finite, ratios = [], {}
        for name, spec in specs.items():
            grade = sla.GPU_INTERACTIVE if name == llm else sla.INTERACTIVE
            h = spec.handler
            bd = container.cold_start_breakdown(spec)
            log(f"[platform] {spec.name} on {spec.provider}: warm exec "
                f"{h.base_cpu_seconds:.6f} s, package {h.package_mb:.1f} MB, load work "
                f"{h.load_cpu_seconds:.3f} s, batch curve {list(h.batch_curve)}; cold start "
                f"provision {bd.provision_s:.3f} + bootstrap {bd.bootstrap_s:.3f} + load "
                f"{bd.load_s:.3f} = {bd.total_s:.3f} s")
            reps = {}
            for what, run, trace in (("cold", plat.run_cold_experiment, workload.cold_probe()),
                                     ("warm", plat.run_warm_experiment, workload.warm_burst()),
                                     ("scalability", plat.run_scalability_experiment,
                                      workload.step_ramp())):
                reps[what] = rep = run(spec)
                recs, _ = plat.invoke(spec, trace)
                log(_report_line(spec.name, what, rep, grade.evaluate(recs)))
                finite += [rep.summary.mean_response_s, rep.summary.p95_s, rep.summary.p99_s]
            if reps["cold"].cold_starts != 5 or reps["cold"].cold.n != 5:
                raise SystemExit(f"platform: {spec.name}'s cold probe gave "
                                 f"{reps['cold'].cold_starts} cold starts, not 5")
            warm = reps["warm"]
            if name == llm:
                recs, sim = plat.invoke(spec, primed)
                warm = plat.report(spec, recs, sim)
                log(_report_line(spec.name, "warm, primed 60 s ahead", warm,
                                 grade.evaluate(recs)))
            if warm.summary.n_cold or not warm.warm.n:
                raise SystemExit(f"platform: {spec.name}'s warm burst had "
                                 f"{warm.summary.n_cold} cold responses")
            cold_mean, warm_mean = reps["cold"].cold.mean_response_s, warm.warm.mean_response_s
            if not cold_mean > warm_mean:
                raise SystemExit(f"platform: {spec.name} cold mean {cold_mean} is not above "
                                 f"its warm mean {warm_mean}")
            ratios[spec.name] = cold_mean / warm_mean
            log(f"[platform] {spec.name}: cold/warm mean response {cold_mean:.4f} / "
                f"{warm_mean:.4f} s = x{ratios[spec.name]:.2f}")
        names = sorted(s.name for s in specs.values())
        fleet_trace = workload.multi_function_trace(
            {n: (0.05 if n.startswith(llm) else 0.5) for n in names}, duration_s=1800.0,
            seed=0)
        recs, sim = plat.invoke_fleet(fleet_trace)
        for spec in specs.values():
            mine = [r for r in recs if r.fn == spec.name]
            grade = sla.GPU_INTERACTIVE if spec.handler.name == llm else sla.INTERACTIVE
            rep = plat.report(spec, mine, sim)
            log(_report_line(spec.name, "in the fleet", rep, grade.evaluate(mine)))
            finite += [rep.summary.mean_response_s, rep.summary.p95_s, rep.summary.p99_s]
        if len(recs) != len(fleet_trace) or not all(math.isfinite(x) for x in finite):
            raise SystemExit(f"platform: {len(recs)} of {len(fleet_trace)} fleet requests "
                             f"served, or a time is not finite")
        exact = ServerlessPlatform(seed=0, device="cuda", calibration_path=path)
        spec = exact.deploy_model(llm, PLATFORM_LLM_MB, provider="modal_gpu")
        cold = exact.invoke(spec, workload.cold_probe(), jitter=0.0)[0][0]
        warm = exact.invoke(spec, primed, jitter=0.0)[0][0]
        total = container.cold_start_breakdown(spec).total_s
        err = abs(cold.response_s - (total + warm.response_s))
        log(f"[platform] {spec.name} at jitter 0: first cold response {cold.response_s:.9f} s "
            f"= cold start {total:.9f} + warm response {warm.response_s:.9f} s "
            f"(off by {err:.3g} s)")
        if not (cold.cold and not warm.cold and err <= PLATFORM_TOL_S):
            raise SystemExit(f"platform: {spec.name}'s zero-jitter cold response is off its "
                             f"breakdown plus its warm response by {err} s")
    wall = time.perf_counter() - t0
    log(f"[platform] step took {wall:.2f} s of host time; nothing measured; cold/warm "
        f"{json.dumps(ratios)}")
    if wall > PLATFORM_MAX_S:
        raise SystemExit(f"platform: the step took {wall:.1f} s, over {PLATFORM_MAX_S} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.decode import flash_decode as fd
    from repro_torch.kernels.rwkv import wkv
    from repro_torch.serving.engine import InferenceEngine

    dev = torch.device("cuda")
    laps = {}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now
        log(f"[phase] {what}: {laps[what]:.1f} s")

    card = card_line()
    print(card, flush=True)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}")
    bootstrap_line()

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {sorted(logs) or 'up to date'} in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    lap("1-2 card, bootstrap and build")
    main_err = kernel_checks(dev)
    main_err.update(bwd_kernel_checks(dev))
    optim_kernel_checks(dev)
    lap("3 kernel checks")

    cfg = get("deepseek-7b").config
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, seed=0, max_cache=256)
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{eng.stats()['params'] / 1e9:.3f} B params {cfg.param_dtype}, "
        f"seeded init {time.perf_counter() - t0:.1f} s")
    logits_check(eng, cfg, dev)
    prompts, reqs = deepseek_inputs(cfg)
    want = uncaptured_tokens(eng, prompts, reqs)

    flash.launches = fd.launches = wkv.launches = 0
    e2e = {cfg.name: main_path(eng, cfg, want, prompts, reqs)}
    launches = kernel_counts(cfg, e2e[cfg.name])
    lap("4 deepseek-7b")

    rcfg = get("rwkv6-1.6b").config
    reng = rwkv_engine(rcfg, dev)
    rwkv_logits_check(reng.params, rcfg, dev)
    rwkv_logits_check(tree_map(torch.Tensor.float, reng.params),
                      rcfg.replace(param_dtype="float32", compute_dtype="float32"), dev)
    rwant = rwkv_uncaptured_tokens(reng)
    flash.launches = fd.launches = wkv.launches = 0
    e2e[rcfg.name] = rwkv_e2e = rwkv_main_path(reng, rcfg, rwant)
    launches["wkv6"] = wkv.launches
    k3_want = rcfg.num_layers * (rwkv_e2e["prefills"] + rwkv_e2e["steps"])
    log(f"[kernels] launches on the {rcfg.name} path: wkv6 {wkv.launches}, "
        f"flash_attention {flash.launches}, flash_decode {fd.launches}; "
        f"{rcfg.num_layers} layers x ({rwkv_e2e['prefills']} prefills + "
        f"{rwkv_e2e['steps']} decode steps) = {k3_want}")
    if wkv.launches == 0:
        raise SystemExit(f"K3 never launched on the {rcfg.name} path")
    if wkv.launches != k3_want:
        raise SystemExit(f"K3 launched {wkv.launches} times, not layers x (prefills + "
                         f"steps) {k3_want}")
    lap("4 rwkv6-1.6b")

    gcfg = get("granite-moe-3b-a800m").config
    geng = granite_engine(gcfg, dev)
    f32 = gcfg.replace(param_dtype="float32", compute_dtype="float32")
    moe_logits_check(tree_map(torch.Tensor.float, geng.params), f32, dev)
    torch.cuda.empty_cache()
    moe_logits_check(geng.params, gcfg, dev)
    gprompts, greqs = deepseek_inputs(gcfg)
    gwant = uncaptured_tokens(geng, gprompts, greqs)
    flash.launches = fd.launches = wkv.launches = 0
    e2e[gcfg.name] = main_path(geng, gcfg, gwant, gprompts, greqs)
    for name, n in kernel_counts(gcfg, e2e[gcfg.name]).items():
        launches[name] += n
    log(f"[memory] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lap("4 granite-moe-3b-a800m")

    cnns = cnn_phase(dev)
    lap("5 CNNs")
    times = timings(dev)
    times.update(bwd_timings(dev))
    lap("6 kernel timings")
    plans = times.pop("wkv6 plans")
    log("[time] wkv6 device / event ms by split plan (CTAs per head, columns, lanes), the "
        "first split_plan's: " + "; ".join(f"{k} {fmt_ms(d)} / {e:.4f}"
                                            for k, (d, e) in plans.items()))
    for name, t in times.items():
        bound_ms, bound_by = t["bound"]
        library = ("none" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} ms (device {fmt_ms(t['library_device_ms'])})")
        log(f"[time] {name} at {t['shape']}: {t['ms']:.4f} ms (device {fmt_ms(t['device_ms'])}); "
            f"bound {bound_ms:.4f} ms ({bound_by}); plain {t['plain_ms']:.4f} ms (device "
            f"{fmt_ms(t['plain_device_ms'])}); library {library}")
        if "host_us" in t:
            log(f"[time] {name} wrapper: {t['host_us']:.1f} us of host time per call")
        if "lse_ms" in t:
            log(f"[time] {name} with the row lse: {t['lse_ms']:.4f} ms (device "
                f"{fmt_ms(t['lse_device_ms'])}), without {t['ms']:.4f} ms (device "
                f"{fmt_ms(t['device_ms'])}) ({card})")
    prefills, steps = {}, {}
    prefills[cfg.name], steps[cfg.name] = breakdown(eng, cfg, dev)
    dryrun_bounds(cfg, prefills[cfg.name], steps[cfg.name], card)
    del eng
    prefills[rcfg.name], steps[rcfg.name] = rwkv_breakdown(reng, rcfg, dev)
    del reng
    prefills[gcfg.name], steps[gcfg.name] = moe_breakdown(geng, gcfg, dev)
    del geng
    lap("7 breakdowns of deepseek-7b, rwkv6-1.6b, granite")
    mcfg = get("mistral-nemo-12b").config.replace(num_layers=MISTRAL_LAYERS)
    e2e[mcfg.name], mlaunches, prefills[mcfg.name], steps[mcfg.name] = mistral_phase(mcfg, dev)
    for name, n in mlaunches.items():
        launches[name] += n
    lap("4+7 mistral-nemo-12b")
    lcfg = get("llava-next-mistral-7b").config
    e2e[lcfg.name], llaunches, prefills[lcfg.name], steps[lcfg.name] = llava_phase(lcfg, dev)
    for name, n in llaunches.items():
        launches[name] += n
    lap("4+7 llava-next-mistral-7b")
    hcfg = get("recurrentgemma-9b").config.replace(num_layers=HYBRID_LAYERS)
    hruns, prefills[hcfg.name], steps[hcfg.name] = hybrid_phase(hcfg, dev)
    e2e.update(hruns)
    lap("4+7 recurrentgemma-9b")
    wcfg = get("whisper-tiny").config
    e2e[wcfg.name], prefills[wcfg.name], steps[wcfg.name] = whisper_phase(wcfg, dev)
    lap("4+7 whisper-tiny")
    for name, n in calibration_phase(dev).items():
        launches[name] += n
    lap("8 calibration, platform, scenarios and replay")
    train_runs, tlaunches, otimes, oerrs = train_phase(dev)
    lap("10 training")
    for name, n in tlaunches.items():
        launches[name] = launches.get(name, 0) + n
    sharded = sharded_phase()
    lap("11 sharded")
    for name, n in sharded["launches"].items():
        launches[name] = launches.get(name, 0) + n
    times.update(otimes)
    main_err.update(oerrs)
    for name, t in otimes.items():
        bound_ms, bound_by = t["bound"]
        log(f"[time] {name} at {t['shape']}: {t['ms']:.4f} ms (device {fmt_ms(t['device_ms'])}); "
            f"bound {bound_ms:.4f} ms ({bound_by}); plain {t['plain_ms']:.4f} ms (device "
            f"{fmt_ms(t['plain_device_ms'])}); library {t['library_ms']:.4f} ms (device "
            f"{fmt_ms(t['library_device_ms'])})")
    k5 = otimes["adamw_update"]
    rates = [("K5 adamw_update, 22 B a param", k5["rate_tbs"]),
             ("torch.optim.AdamW(fused=True), bf16 moments, 14 B a param",
              k5["library_rate_tbs"])]
    log("[time] rates over device time, each row's own bytes: " + "; ".join(
        f"{what} {'not measured' if r is None else format(r, '.3f') + ' TB/s'}"
        for what, r in rates) + f"; torch._fused_adamw_ on float32 moments beside bf16 params: "
        f"{k5['library_f32']} ({card})")

    meta = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/attention/flash.py:69"),
            "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                             "src/repro/kernels/decode/flash_decode.py:62"),
            "wkv6": ("src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/rwkv/wkv.py:57"),
            # no TPU kernel: the reference differentiates its plain attention and
            # wkv_ref through XLA; the forward kernels they are the backward of
            "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/attention/flash.py:69"),
            "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                         "src/repro/kernels/rwkv/wkv.py:57"),
            # no TPU kernel either: XLA fuses the reference's jitted AdamW,
            # its global norm and its update
            "grad_sumsq": ("src/repro_torch/csrc/adamw.cu", "src/repro/train/optimizer.py:30"),
            "adamw_update": ("src/repro_torch/csrc/adamw.cu",
                             "src/repro/train/optimizer.py:53")}
    rows = []
    for name, (source, replaces) in meta.items():
        t = times[name]
        bound_ms, bound_by = t["bound"]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": main_err[name], "ms": t["ms"],
                     "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": t["library_ms"],
                     "library_device_ms": t["library_device_ms"]})
    log(f"[kernels] launches summed over the deepseek-7b, rwkv6-1.6b, granite-moe-3b-a800m, "
        f"mistral-nemo-12b and llava-next-mistral-7b paths, the replay, the training runs and "
        f"the gate's kernel paths: {launches}")
    # the replayed step before K5 kept its loads in flight (PERF.md section 5)
    before_k5 = {"deepseek-7b": (223.3, 223.6, 1.001, 55.75, 9172),
                 "rwkv6-1.6b": (148.0, 148.4, 1.002, 19.31, 13836)}
    for name, model in train_runs.items():
        for mode in ("replayed", "uncaptured"):
            r = model[mode]
            k45 = ", ".join(f"{k} {r['by_kernel'][k]:.3f} ms" for k in ("K4", "K5")
                            if k in r["by_kernel"])
            log(f"[train] {name} full width, {mode}: losses "
                f"{' '.join(f'{x:.4f}' for x in r['losses'])}; median step wall "
                f"{r['wall_ms']:.1f} ms (bound {r['bound_ms']:.1f}), {r['tokens_per_s']:.0f} "
                f"tokens/s, device {fmt_ms(r['device_ms'])} a traced step (busy "
                f"{'not measured' if r['busy'] is None else format(r['busy'], '.3f')}; {k45}), "
                f"peak allocated {r['peak_gib']:.2f} GiB, reserved {r['reserved_gib']:.2f} GiB; "
                "the replayed step before K5's redesign: wall {:.1f} ms, device {:.1f} ms, busy "
                "{:.3f}, peak {:.2f} GiB, {} tokens/s ({})".format(*before_k5[name], card))
    for name, r in e2e.items():
        log(f"[engine] {name} full width: prefill {r['prefill_ms']:.3f} ms (replayed; "
            f"logits within {r['prefill_err']:.3e} of the uncaptured prefill's), "
            f"decode {r['decode_tok_s']:.1f} tok/s ({card})")
        if "server_tok_s" in r:
            log(f"[server] {name} full width: {r['server_tok_s']:.1f} tok/s; drain "
                + "; ".join(f"{k} {sp['wall_s']:.3f} s, admission {sp['admit_s']:.3f} s in "
                            f"{sp['rounds']} rounds" for k, sp in r["split"].items())
                + f" ({card})")
    for name, timed in prefills.items():
        r, u = timed["replayed"], timed["uncaptured"]
        busy = r["device"] / r["wall"]
        log(f"[graph] {name} prefill, replayed: host wall {r['wall']:.3f} ms, device "
            f"{r['device']:.4f} ms, busy {busy:.3f} ({'at least' if busy >= 0.85 else 'BELOW'} "
            f"0.85), {r['calls']:.1f} host launch calls of which {r['graphs']:.1f} graph "
            f"launches; uncaptured: {u['wall']:.3f} ms, {u['device']:.4f} ms, busy "
            f"{u['device'] / u['wall']:.3f}, {u['calls']:.1f} calls ({card})")
    for name, (wall, dev_ms, calls, pwall, pdev, pcalls) in steps.items():
        log(f"[graph] {name} decode step, replayed: host wall {wall:.3f} ms, device "
            f"{dev_ms:.4f} ms, busy {dev_ms / wall:.3f}, {calls:.1f} host launch calls; "
            f"uncaptured: {pwall:.3f} ms, {pdev:.4f} ms, busy {pdev / pwall:.3f}, "
            f"{pcalls:.1f} calls ({card})")
    for name, r in cnns.items():
        log(f"[cnn] {name} 224 px: first call {r['first_ms']:.3f} ms, captured "
            f"{r['first_replayed_ms']:.3f} ms (warm-up, capture, first replay); " + "; ".join(
                f"batch {b} warm replayed {r[b]['replayed_ms']:.3f} ms (device "
                f"{r[b]['replayed_device_ms']:.4f}, {r[b]['replayed_calls']:.1f} calls), "
                f"uncaptured {r[b]['warm_ms']:.3f} ms (device {r[b]['device_ms']:.4f}, "
                f"{r[b]['calls']:.1f} calls), bound {r[b]['bound_ms']:.4f}" for b in (1, 4))
            + f" ({card})")
    log(f"[phase] seconds by phase, this process ({card}): {json.dumps(laps)}; "
        f"{sum(laps.values()):.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
