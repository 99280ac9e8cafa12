#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Phases:
  1. print the card (nvidia-smi name and power limit) and the torch, CUDA
     and nvcc versions;
  2. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all at once), printing registers and spills;
  3. hold each kernel against its plain PyTorch version on the card, at
     the paths' shapes and at a large batch, at every precision: the fused
     Newton scan over a real topology group's whole 300-step transient and
     over 4,099 tiled lanes (a 40-step window), the one-step entry on one
     step; Gauss-Jordan at B = 1, 64 and 4096 for N = 13 (the path's read
     column) and 32 (warp kernel) and N = 33 (block kernel), and at
     N = 130 in float32 and float64, each case checking which kernel
     launched; the array step at 128x128, 512x512, 64x130 (three
     block_c) and 64x2200, printing each launch's geometry (a thread-block
     cluster per column block, or none at 64x2200), each launched twice
     and held to the same bits; flash attention at the serving path's
     prefill shapes and at ragged, offset, kv_len < Skv, G = 1 and G = 7
     shapes, at the moe and hybrid serves' shapes (zamba2's hd = 80 at
     B = 2, S = 128-1024; mixtral's hd = 128 at S = 5120 with its
     4096-token window) and at head_dims padded inside the launch (8, 24,
     72, 256) with and without a window, q_offset > 0 and kv_len < Skv,
     non-causal at whisper's encoder shape (1500 x 1500 frames, two
     chunks of 1024 + 476 keys) and its cross-attention from each prompt
     length to the frames, with kv_len < Skv and Sq != Skv, and at the
     audio and vlm serves' causal shapes (bfloat16 through the
     tensor-core kernel, float32 through the float32 kernel, the
     non-causal launches counted apart), and that a key tile outside
     every query's window is skipped (the tensor-core kernel at a 64-key
     window against none); decode attention at the benchmark cell's shape
     (16 slots, a 12,336-row window, mixtral's heads) at full and at a
     mixed fill, each slot within 2^-6 of its largest plain output;
  4. drive the lattice path, `characterize` over the default 96-point
     design lattice, with the launch counters set to 0 just before it;
     check that each topology group's transient was one launch of the
     fused Newton scan kernel (and the one-step entry none), and that
     t_cell matches the port's own CPU run;
  5. time the warm lattice path;
  6. drive the compile path, `compile_bank(simulate=True, solver="pallas")`
     for gc2t_nn/np/osos at 16x64 and 128x128 plus one sram6t bank, each
     with the counters set to 0 just before it; check that every Newton
     iteration went through the Gauss-Jordan warp kernel, that t_cell matches
     the port's CPU run and the card's "jnp" run, that "jnp" hits the
     16x64 anchors, and that the retention computed on the card matches
     the CPU run; then the 64-lane `run_batch` vt0 sweep, counted and held
     to the CPU run;
  7. drive the array path, a 200-step selected-row write of a 512x512
     gain-cell array through the array-step kernel, counted, with the
     write-physics checks and the CPU plain run;
  8. drive the match path, the paper's Fig-10 flow through the query
     API: `Session(device="cuda").run(MatchQuery(...))` with the six
     demands of benchmarks/bench_codesign.py and the default transient
     sweep (96 points, 300 steps, f64, solver "pallas"), with the counters
     set to 0 just before it: one scan launch per topology group, no
     one-step launch, one analytic batch, one transient run and one shmoo
     in the executor's statistics; the result held to the port's CPU run
     of the same query (on phase 4's CPU characterization): analytic
     fields 1e-12, retention fields 2e-6, t_cell 1e-9, the shmoo grid,
     banks_needed and each row's bank equal (a verdict may differ only
     within tolerance of its threshold, with its margin printed); a fresh
     session on an artifact store another session wrote launches nothing
     and gives equal results; the same query again is a result-cache hit
     with no launch; `CompileQuery(simulate=True, solver="pallas")` at
     gc2t_nn 16x64 takes 1800 Gauss-Jordan launches and equals phase 6's
     report; then the warm walls (median of 5) of the match, of the
     analytic 96-point `SweepQuery()` and of the 4 x 96 vdd lattice;
  9. drive the layout path, `Session(device="cuda").run(SweepQuery(
     fidelity="layout"))` over the default 96-point lattice (300 steps,
     f64, solver "pallas"), with the counters set to 0 just before it:
     one scan launch per topology group and no one-step launch, 96
     geometry verifications, every report clean (DRC, LVS, extraction
     bit-identical) and equal to the port's CPU run of the same query,
     t_cell within 1e-9 of that run and above phase 4's hand-modeled
     t_cell at every point (the gap's minimum and maximum printed); a
     fresh session on the store the first wrote rebuilds no geometry and
     launches nothing; `timing.analyze(parasitics="extracted")` at
     gc2t_nn 16x64 equals the sweeps' analytic estimate; the warm wall of
     the layout sweep (median of 5, a fresh session each run) split into
     geometry verification on the host and the transient tier; then the
     sparse-LU engine, `SweepQuery(fidelity="transient",
     solver="sparse")` over the same lattice once: no scan launch,
     t_cell within 1e-9 of phase 4's (the gap printed per topology) and
     of the port's CPU run of the same query, its wall, and one step and
     one Newton iteration of one group under a dispatch counter (every
     operation on the card but the lifts of host inputs; torch
     operations per iteration);
 10. drive the gradient path: `t_cell_grad_fn(solver="pallas")` under
     `torch.autograd.grad` on the card for each of the six topology
     groups (its 32x64 config, 16 points: the nominal point, the base
     point of tests/test_grad_dse.py and its +/-1e-4 relative steps per
     knob, and 8 seeded points inside dse_opt.DEFAULT_BOUNDS), with the
     counters set to 0 just before each: one scan launch forward, none
     backward, no one-step launch; every point valid; t_cell within 1e-9
     and the gradients within 1e-7 of the port's CPU run, the nominal
     t_cell within 1e-9 of `characterize` on the card, the gradient at
     the base point within 1e-4 of the batch's central differences; the
     sparse-LU engine on gc2t_np (8 rows) within 1e-9 (t_cell) and 1e-6
     (gradients) of the fused engine, with no scan launch; the warm walls
     of each forward and backward and the backward's torch operations per
     step; then `Session(device="cuda").run(OptimizeQuery(...))` for the
     README's query and benchmarks/bench_optimize.py's full-mode flow (a
     4-rung coarse screen of its 36-config lattice, 60 Adam steps on the
     winner): verdicts equal to the CPU session's, knobs and objective
     within 1e-6, a fresh session on the store the first wrote optimizes
     and evaluates nothing, the same query again is a result-cache hit,
     and the warm walls;
 11. drive the serving path: `llama3.2-1b` at full width in bf16 with
     seeded weights, 16 requests (prompts of 128-1024 tokens, 64 new
     tokens each, half greedy, half top-k sampled) through
     `ServeEngine(n_slots=8, window=2048, decode_chunk=8)`, counted: every
     prefill attention of every layer goes through the bf16 tensor-core
     flash-attention kernel; every request emits its budget; greedy streams
     equal host
     mode's; a warm device-mode serve is timed (wall, and its own prefill
     and decode spans by CUDA events); prefill logits through the kernel
     match the plain flash version at each of the serve's prefill shapes;
     then, the bf16 model freed, the same serve of `llama3.2-1b` at full
     width and depth in float32 (TF32 off), counted: every prefill
     attention goes through the float32 flash-attention kernel and none
     through the tensor-core one; every request emits its budget; a warm
     serve is timed (wall, prefill and decode spans) and one more is run
     under the profiler for the float32 kernel's device ms per serve;
     prefill logits through the kernel match the plain flash version at
     each prefill shape within the float32 kernel limit of the largest
     logit; then 2-layer full-width float32 greedy streams on the card
     against the CPU, counted: every prefill attention goes through the
     float32 flash-attention kernel; the bf16 serve of llama3.2-1b
     again with an int8 KV cache (same weights, prefill logits equal to
     the bf16 model's, counted, every request its budget, wall and decode
     rate beside the bf16 serve's);
 11b. drive the moe and hybrid serves, each counted with the counters at
     0 just before it: mixtral-8x7b at its published widths, depth cut to
     8 of 32 layers (bf16, ring cache of its 4096-token window), 16
     requests of 256-5120 prompt tokens: 8 tensor-core flash launches per
     prefill dispatch, those past the window counted apart, every request
     its budget, one decode-attention launch per layer and decode step
     (as in every family's counted serve), prefill logits kernel vs plain
     flash at 1024 and 5120 tokens, walls and spans; zamba2-2.7b at full
     width and depth (bf16, 2,422,532,000 weights), 16 requests of
     128-1024 tokens: 9 hd = 80 tensor-core launches per prefill
     dispatch, budgets, logits, walls;
     then reduced mixtral (prompts past its window), zamba2 and int8-KV
     llama in float32 on the card against the CPU: greedy streams equal
     (device and host mode), prefill logits within 2e-5 of the largest;
 11c. drive the ssm, audio and vlm serves, each at full width and depth
     in bf16 with seeded weights (the reference's weight count), counted
     with the counters at 0 just before it, the 16-request workload with
     64 new tokens each (half greedy, half top-k), every request its
     budget, greedy streams equal host mode's, warm wall and prefill /
     decode spans: xlstm-1.3b (prompts of 64-512 tokens; no flash launch;
     torch operations per prefill dispatch, in its sLSTM scan, and per
     decode step); whisper-large-v3 (prompts of 32-192 tokens within its
     448-token decoder context: 96 tensor-core launches per prefill
     dispatch, 64 of them non-causal; prefill logits kernel vs plain on
     seeded frames held on its first 4 encoder and 4 decoder layers, the
     full-depth gaps printed beside two plain schedules' gap);
     internvl2-1b (prompts of 128-1024 tokens after 256 patches, window
     2048: 24 launches per dispatch, pos and context at prompt + 256,
     prefill logits kernel vs plain on seeded patches held on its first
     4 layers, the full-depth gaps printed likewise); then reduced
     xlstm, whisper (8 frames, the float32 kernel non-causal) and
     internvl2 in float32 on the card against the CPU (streams equal in
     device and host mode, logits within 2e-5), and `CoDesignQuery` over
     the three archs (held to the CPU session, store replay, warm wall);
 11d. the training path: the flash-attention autograd Function (forward
     the kernel, counted; backward plain torch) against autograd through
     the plain version at llama's training shape (B = 1, S = 4096),
     whisper's cross shape (non-causal, 128 x 1500) and mixtral's
     windowed one (B = 1, hd = 128, window 4096, S = 5120), bf16 and
     float32; a direct kernel launch with inputs that require grad
     raises; every arch's reduced float32 config, loss and every
     gradient leaf on the card against the port's CPU run; the reduced
     llama trainer on the card, 12 steps uninterrupted against preempted
     at step 7, its step-7 checkpoint removed and resumed from step 6,
     final states bit-identical, the trajectory held to the CPU run, the
     card's checkpoint restored on the CPU equal; full-width llama3.2-1b
     (bf16 over float32 master, AdamW, cosine, remat "full", train_4k's
     4,096 tokens at a global batch of 8 in 2 microbatches) trained 8
     steps with the counters at 0 just before it: 64 tensor-core flash
     launches and no float32 one a step, the loss finite and lower at
     the last step than at the first, the norm of each step on the
     master, an async checkpoint at the last step (waited for); its warm
     step wall, tokens/s, model-FLOPs share of the
     bf16 peak, peak memory and telemetry profile; one more step under
     the profiler (idle share, the Function's forward and backward
     device ms); `launch.serve --ckpt-dir` on its checkpoint, 4 greedy
     streams equal to a `Model` holding the trained params'; the forward
     kernel at llama's training shape (B = 4) and the Function's
     backward beside SDPA's;
 11e. the mesh layer (at most 150 s, its wall printed): dry-run cells on
     fake tensors over a fake process group (`launch.dryrun.run_cell`:
     llama3.2-1b train_4k, prefill_32k and decode_32k on 16x16, qwen2-0.5b
     prefill_32k on 2x16x16, its sequence-parallel flash, and on 16x16
     arctic-480b decode_32k (the MoE's small-T path), mixtral-8x7b
     prefill_32k (tensor-parallel on d_ff), zamba2-2.7b and xlstm-1.3b
     decode_32k, whisper-large-v3 and internvl2-1b prefill_32k), each record's
     roofline row and peak GiB per device printed, flops x chips at least
     MODEL_FLOPS, no unknown trip count, 256 and 512 chips; then on a real
     one-rank nccl group over the card, a (1, 1) DeviceMesh, full-width
     llama3.2-1b's bundles at the 16x16 mesh's per-device batches: prefill
     (B = 2, S = 32,768: 16 tensor-core flash launches), decode (B = 8,
     W = 32,768) and a train step (2 layers, B = 2, S = 4,096: 4 flash
     launches), each run under the analyzer and held to its fake-tensor
     twin (flops, dots and bytes equal exactly) and to the same step
     without a mesh (logits within 3e-2 of the largest; the train step
     from step 100, past the warmup: its loss within 1e-5, its gradient
     norm and the norm of its step on the master within 2^-8, the
     updated first moment within 2^-5 of each leaf's largest), the fake
     run's peak estimate
     printed beside `torch.cuda.max_memory_allocated`; the tensor-core
     flash kernel against the plain version at the prefill's per-layer
     shape (B = 2, S = 32,768; one launch, outside the steps' counts),
     the whole output within `flash_limit` and the last 1,024 query rows
     within the limit of their own largest, which the plain tail without
     the last 64 keys must exceed; then each other family's bundles
     (`MESH_FAMILY_BUNDLES`: mixtral at 4 layers, prefill B = 2,
     S = 32,768 on the expert-parallel path and decode B = 8 in its
     4,096-row ring on the small-T path, held to the step without a mesh
     at capacity C = T; zamba2's first group prefill at S = 8,192;
     full-depth xlstm decode and one group's prefill at S = 512;
     whisper 4 + 4 layers over 1,500 frames and a 448-token prompt;
     internvl2 4 layers at S = 32,768 with its 256 patches), each held to
     its fake twin and to the step without a mesh on the same weights
     (the mesh model's tensors), with its flash launches (4, 0, 1, 0, 0,
     12 of them 8 non-causal, 4), and one mixtral train step (1 layer,
     B = 2, S = 4,096, from step 100) held as llama's; every real step's
     analyzer peak within 10% of the allocator's increase over the step;
     the group closed in a `finally`;
 11f. the Trainer on a mesh (at most 150 s, its wall printed): on a
     one-rank nccl group's (1, 1) mesh over the card, `Trainer(cfg, mesh,
     shape, tcfg)` on phase 11d's cell and schedule with the counters at
     0 just before it, preempted after 3 steps (its checkpoint from the
     mesh at full depth, timed): each mesh step against the step
     without a mesh from the same state (uncounted), its loss within 1e-5,
     its gradient norm and the norm of its step on the master within
     2^-8, and the trajectory against phase 11d's run within 2^-8 (bf16
     gradients summed in another order part the two after the first
     update), 64 tensor-core flash launches a step and no float32 one,
     the master DTensors; the step walls and a mesh step's peak memory
     beside phase 11d's; then at 2 layers, full width, one mesh step and
     its checkpoint from the mesh restored without a mesh, saved from
     there and restored onto the mesh: every leaf bit-equal, placed as
     the mesh's rules say, each manifest naming its writer's mesh, the
     save and restore seconds; the group closed in a `finally`;
 12. drive co-design, the runtime loop, the compile service and the
     fleet, each with the counters at 0 just before it:
     `Session(device="cuda").run(CoDesignQuery(...))` for the four dense
     archs of benchmarks/bench_fleet.py at decode_32k, for mixtral-8x7b
     with zamba2-2.7b at decode_32k and for the README's quickstart (no kernel launch, one vdd lattice and one
     co-design cube each; held to the CPU session's report; a fresh
     session on the store the first wrote evaluates nothing; warm walls);
     `llama3.2-1b` at full width in bf16 behind a `TelemetryCollector`
     (virtual clock) replaying benchmarks/bench_runtime.py's three
     scenarios through `run_scenario` (every prefill attention through
     the tensor-core flash kernel, every request its budget),
     `codesign_measured` on the card held to the CPU session on the same
     windows, `diff_profiles` against the analytic profiles, and the vdd
     governor over the card's lattice with decisions equal to the CPU's
     and its energy beside `replay_fixed`'s; `CompileService(device=
     "cuda")` on bench_fleet.py's smoke mix plus a transient sweep of the
     default lattice and a simulated gc2t_nn 16x64 compile (solver
     "pallas"): one scan launch per topology group, 1800 Gauss-Jordan
     warp launches, every response held to the CPU service's, the wave
     statistics and walls; `Fleet(device="cuda")` with 2 workers and
     with 1 on the same lines: not degraded, every worker's pid among the
     card's compute processes while it runs, every worker served and
     left its stats, the scan and Gauss-Jordan launches across workers
     those of one service, no duplicate evaluation, responses equal to
     the in-process service's, walls and one worker's cold start; then
     bench_fleet.py's chaos spec on 2 workers (a worker killed after its
     second publish, torn, corrupt and failing evaluations, a poison
     request): every request resolves, the poison request is
     quarantined, the rest equal the clean run's; then the sparse-LU
     sweep of 8 gc2t_np points and a simulated compile, each twice,
     compared bit for bit (ROADMAP Queue 3 F1);
 13. time the fused Newton scan kernel (per launch and per step, by CUDA
     events and the profiler's device time), its plain version, its bound
     and its dependent chain, and the one-step entry; the Gauss-Jordan
     kernels (warp kernel at B = 1 and 4096, N = 13, with its dependent
     chain and the wrapper's host time per call; block kernel at B = 16,
     N = 130), the array step at 128x128 and 512x512 (with its SFU
     floor), the array path's warm 200-step write, and both
     flash-attention kernels (CUDA events and the profiler's device time;
     the tensor-core kernel at the serve's four prefill shapes, the
     float32 kernel at the same four and at the 2-layer float32 serve's
     two, both at the hybrid serve's four and the moe serve's windowed
     one, SDPA there with an explicit window mask, both at whisper's
     non-causal encoder and cross shapes, SDPA with is_causal=False, and
     at internvl2's four), the decode-attention kernel at the cell's
     shape, full and mixed fill, against its byte bound (SDPA with a mask
     of the filled rows beside it), their plain versions,
     their bounds and the library calls (`torch.linalg.solve_ex` and
     `torch.linalg.solve`; `scaled_dot_product_attention` in the same
     call), and the warm compile and `run_batch` walls; then one warm
     match under the profiler: the device's idle share and the share of
     device time in the scan launches; one warm layout sweep under the
     profiler: the device's idle share; one warm gradient call (forward
     and backward) under the profiler: the device's idle share and the
     scan kernel's device ms in it;
 14. print a {"kernels": [...]} JSON line (the scan row also carries the
     gradient path's launches; every row carries phase 12's, by part; the
     flash rows carry phase 11b's, 11c's, 11d's, 11e's and 11f's, the
     non-causal launches and errors apart, and their times at the new
     shapes, the training shape and the Function's backward with its
     bound), the
     smoke's total wall, the card line, and as the last line {"ok": true,
     "device": {...}}.

Any failure exits nonzero before the last line is printed. Without a CUDA
device, or outside a checkout of the repository, it fails at once.

Run from the root of the repository: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# tolerances of the kernel against its plain version (max |dv| in volts):
# f64 is round-off of one Newton solve through cond(J) ~ 1e6; mixed and f32
# store the state in float32, whose spacing near 1 V is 1.2e-7 V
KERNEL_ATOL = {"f64": 1e-10, "mixed": 1e-5, "f32": 1e-3}
T_CELL_RTOL_F64 = 1e-9      # card vs the port's CPU run, f64
# mixed vs f64 on the card. The mixed contract's 1.5e-6 was measured on 64
# jittered lanes of one topology; on the default lattice the mixed engine
# of the reference itself deviates by 2.8e-6 (gc2t_osos 32x128, see
# tests/test_torch_char_batch.py), so the limit is widened to 3e-6
T_CELL_RTOL_MIXED = 3e-6
# t_cell (ps) of the reference at 16x64, n_steps=300, n_seg=8, f64
ANCHORS_PS = {"gc2t_nn": 47.82, "gc2t_np": 24.10, "gc2t_osos": 1155.27}
ANCHOR_ATOL_PS = 0.01       # the anchors carry two decimals
BIG_BATCH = 4100            # >= 4096 lanes, not a multiple of the block (128)
N_STEPS = 300               # characterize's default n_steps
# the scan kernel vs its plain version over a whole trajectory (volts).
# f64: each step's Newton solve agrees as the one-step check does, and the
# kernel's KCoh @ v sum may differ from the einsum's order by an ulp; the
# circuits are stable, so that stays round-off (1e-9 leaves 1e3x margin
# over a 300-step run). mixed and f32 store the state in float32
# (spacing 6e-8..1.2e-7 V near 1 V): one flipped rounding moves a node by
# an ulp and later steps carry it, so the limits are the one-step
# check's; f32 also solves in float32 through cond(J) ~ 1e6
SCAN_ATOL = {"f64": 1e-9, "mixed": 1e-5, "f32": 1e-3}
# the tiled scan check: lanes (odd, so not a multiple of the block's 4
# lanes) and the window of steps it runs, cut from 300 to 40 so that the
# plain run stays short; the read wordline fires inside the window
SCAN_BIG_BATCH = 4099
SCAN_WINDOW = (20, 60)
SEED = 0

# -- the compile path (Gauss-Jordan kernel) and the array path (array step)
COMPILE_CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos")
COMPILE_SIZES = ((16, 64), (128, 128))
READ_STEPS = 300            # timing.simulate_read's default n_steps
# pallas t_cell on the card against the port's CPU run and the card's jnp
# run: tests/test_torch_compiler.py holds the port's pallas run to 5e-8
# of the reference's, whose own pallas-vs-jnp gap on this path is at most
# 1.7e-8 (CPU, gc2t_nn/np/osos at 16x64 and 64x16)
T_CELL_RTOL_PALLAS = 5e-8
BATCH_LANES, BATCH_STEPS = 64, 120      # benchmarks/figures.py vt0 sweep
TRACE_ATOL_PALLAS = 1e-6    # volts, tests/test_torch_dense_transient.py
# Gauss-Jordan kernel vs its plain version: the same float32 operations
# in the same order, each rounded on its own, so they should agree bit
# for bit; the limit (relative to max|x|) allows a few float32 ulp
GJ_RTOL = 1e-6
GJ_ORACLE_TOL = 2e-5        # against torch.linalg.solve, as the reference
GJ_BIG_BATCH = 4096
# checked batches and sizes: 1 is the compile's, 64 run_batch's; N = 13
# is the path's read column (warp kernel), 32 the widest warp system, 33
# the narrowest block system (and N = 130 below, B = 16)
GJ_BATCHES = (1, 64, GJ_BIG_BATCH)
GJ_SIZES = (13, 32, 33)
# array step vs its plain version, one step (volts): the same float32
# arithmetic, but sequential column sums and the card's expf/log1pf; the
# rail's difference quotient over dv = 1e-4 magnifies sum-order round-off
# (3.4e-5 V on the CPU between two summation orders,
# tests/test_torch_gc_array_step.py)
GC_ATOL_SN, GC_ATOL_BL = 2e-6, 2e-4
GC_ATOL_ORACLE = 1e-3       # vs the oracle (rail dv 1e-3), the reference's
# (R, C, block_c): block_c None is the default (128; at most 8 columns
# per block, so any block_c >= 8 launches the same). At 132 SMs 128x128,
# 512x512 and 64x130 split each column's rows over a thread-block
# cluster; 64x2200 fills the card with column blocks alone (no cluster);
# C = 130 and 2200 are not multiples of the block; block_c = 1 gives
# blocks of one column. Each case launches twice and the two outputs must
# be bit-identical
GC_CHECKS = ((128, 128, None), (512, 512, None), (64, 130, None),
             (64, 130, 16), (64, 130, 1), (64, 2200, None))
# SFU results per clock and SM (sm_90), for the array step's floor of
# 64 transcendental calls (32 expf, 32 log1pf) per cell
SFU_PER_CLK_SM = 16
GC_TRANSCENDENTALS = 64
# retention (float32) on the card vs the CPU run, relative: the CPU parity
# test's limit against the reference (tests/test_torch_compiler.py)
RET_RTOL = 2e-6
WRITE_STEPS, WRITE_ATOL = 200, 1e-4     # 200-step write, card vs CPU

# -- the match path: `Session.run(MatchQuery)`, the paper's Fig-10 flow
# the six demands of benchmarks/bench_codesign.py (name, level, read Hz,
# lifetime s, capacity bits): native-retention passes, refresh-only
# passes, frequency-infeasible, capacity-driven sizing
MATCH_DEMANDS = (("act-l1", "L1", 3.0e8, 2.0e-6, 0),
                 ("act-l1-fast", "L1", 1.2e9, 5.0e-7, 0),
                 ("kv-l2", "L2", 8.0e8, 1.0e-3, 1 << 20),
                 ("stream-l2", "L2", 2.5e9, 1.0e-5, 0),
                 ("weights-l2", "L2", 2.0e8, 3600.0, 1 << 22),
                 ("hopeless", "L2", 5.0e10, 1.0, 0))
# the match's analytic fields, card vs CPU, relative: float64 +, x, / by
# tensors and exact ceil and powers of 4, so bit equality is expected;
# the retention-dependent ones (float32 on the device) take RET_RTOL and
# t_cell T_CELL_RTOL_F64
MATCH_RTOL = 1e-12
MATCH_ANALYTIC = ("area_um2", "f_max_hz", "read_bw_bps", "write_bw_bps",
                  "eff_bw_bps", "leakage_w", "t_read_s", "t_write_s")
MATCH_RETENTION = ("retention_s", "refresh_w", "standby_w")
MATCH_REPS = 5              # warm walls: the median of this many runs
VDD_LADDER = (0.7, 0.85, 1.0, 1.15)

# -- the layout path (`SweepQuery(fidelity="layout")`) and the sparse engine
LAYOUT_REPS = 5             # warm walls: the median of this many runs
# layout-extracted vs hand-modeled t_cell, relative gap: positive at every
# point (extraction adds rail rows, strip jogs and the via stack to the
# read column); the reference measured 2.9-7.3% at 16x64 (CHANGES.md)
# the sparse-LU engine on the card vs the fused engine (phase 4), t_cell
# relative. The reference's engine contracts (sparse vs dense 6e-12, fused
# vs dense 7e-12, benchmarks/bench_transient.py) hold on gc2t_nn 32x32; each
# engine freezes a lane once its Newton update is under 1e-6 V, so two
# engines' traces differ by up to that, and a slow read's crossing turns
# it into time: on gc2t_osos 16x16 the reference's own sparse and fused
# engines differ by 3.4e-10 (tests/test_torch_sparse.py). So the sparse
# run is held to the fused one at the lattice's t_cell limit, 1e-9, with
# the gap printed per topology, and to the port's CPU sparse run at 1e-9
SPARSE_RTOL = 1e-9

# H100 SXM data-sheet peaks: HBM bytes/s, FP64 and FP32 non-tensor FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def newton_iter_flops(n: int, n_dev: int) -> int:
    """Floating-point operations of one fused Newton iteration of one
    lane, counted from the kernel's source (exp, log1p and division count
    one each): the channel model once per device in its conducting
    direction (~65) plus signs and gate leak, t = K F, the k x k assembly,
    the closed-form solve, and the update."""
    k = 3 * n_dev
    channel = n_dev * (65 + 10)
    t = n * (3 + 4 * n_dev)
    assemble = n_dev * (k * 18 + 15)
    solve = 56 if n_dev == 1 else 247
    update = n * (2 * k + 4)
    return channel + t + assemble + solve + update


def lane_iterations(spec, pre, Krhs, params, v0, iters, tol) -> tuple:
    """(Newton iterations each lane runs before it converges (the kernel
    leaves the loop there), the solution), from the plain iteration on
    the same inputs."""
    from repro_torch.kernels.batched_solve.newton import make_fused_iter
    it = make_fused_iter(spec, tol)
    done = torch.zeros(v0.shape[0], dtype=torch.bool, device=v0.device)
    count = torch.zeros(v0.shape[0], dtype=torch.long, device=v0.device)
    v = v0
    for _ in range(iters):
        count += (~done).long()
        v, done = it(pre, Krhs, params, v, done)
    return count.cpu().numpy(), v


def scan_lane_iterations(spec, pre, Ksrc, params, v0, iters, tol):
    """(B, T) Newton iterations of each lane at each step of the scan,
    from the plain iteration on the same inputs."""
    _, cdt = spec.dtypes
    counts, v = [], v0
    for step in range(Ksrc.shape[0]):
        Krhs = torch.einsum("bij,bj->bi", pre["KCoh"], v.to(cdt)) \
            + Ksrc[step]
        c, v = lane_iterations(spec, pre, Krhs, params, v, iters, tol)
        counts.append(c)
    return np.stack(counts, axis=1)


def fused_bound(spec, B, lane_iters) -> tuple:
    """(bound_ms, bound_by): the least time for one launch at these
    inputs, from the bytes it must move (each input read once, the output
    written once) and the operations its lanes need."""
    sdt, cdt = spec.dtypes
    n, nd, k = spec.n, spec.n_dev, spec.k
    s, c = torch.finfo(sdt).bits // 8, torch.finfo(cdt).bits // 8
    nbytes = B * (n * c + n * s + 8 * nd * s + n * k * c + nd * 3 * k * c
                  + 2 * n * nd * c + n * s)
    flops = int(lane_iters.sum()) * newton_iter_flops(n, nd)
    return bound_of(nbytes, flops, PEAK_FLOPS[cdt])


def scan_bound(spec, B, T, lane_iters) -> tuple:
    """(bound_ms, bound_by) of one scan launch: Ksrc, KCoh, the step
    operands (KU, Sb, KPa, KPg, params, v0) each read once and vs written
    once; the lanes' real Newton iterations (lane_iters (B, T)) times
    `newton_iter_flops`, plus the 2 n^2 of KCoh @ v per lane and step."""
    sdt, cdt = spec.dtypes
    n, nd, k = spec.n, spec.n_dev, spec.k
    s, c = torch.finfo(sdt).bits // 8, torch.finfo(cdt).bits // 8
    nbytes = (T * B * n * c + B * n * n * c
              + B * (n * k * c + nd * 3 * k * c + 2 * n * nd * c
                     + 8 * nd * s + n * s)
              + B * T * n * s)
    flops = (int(lane_iters.sum()) * newton_iter_flops(n, nd)
             + B * T * 2 * n * n)
    return bound_of(nbytes, flops, PEAK_FLOPS[cdt])


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_inputs(group, banks, precision, device):
    """Real fused-Newton inputs of one topology group of the lattice, as
    `Transient._run_lattice_fused` forms them: the `precompute`
    constants, the source term K @ src of all 300 steps (T, B, n), the
    device parameters and the precharge start state."""
    from repro_torch.core.spice.char_batch import group_inputs
    from repro_torch.kernels.batched_solve import newton as nwt
    from repro_torch.kernels.batched_solve.sparse import pack_params
    inp = group_inputs(group, banks, n_seg=8, n_steps=N_STEPS,
                       precision=precision, device=device)
    tr = inp["tr"]
    spec = tr.spec
    sdt, _ = spec.dtypes
    te, wt, wv = (torch.as_tensor(inp[k], dtype=torch.float64,
                                  device=device)
                  for k in ("t_end", "wt", "wv"))
    pre = nwt.precompute(spec, inp["over"]["G"], inp["over"]["C"],
                         te / N_STEPS)
    Ksrc = torch.einsum("bij,btj->tbi", pre["K"],
                        tr.src_sequence(te, wt, wv, N_STEPS)).contiguous()
    B = te.shape[0]
    v0 = inp["v0"].to(sdt).expand(B, spec.n).contiguous()
    params = pack_params(tr.system.dev, B, sdt)
    return spec, pre, Ksrc, params, v0, tr.iters, tr.tol


def step_inputs(group, banks, precision, device):
    """The Newton problem of one time step after the read wordline fires,
    started from the precharge state, with the group's constants."""
    spec, pre, Ksrc, params, v0, iters, tol = scan_inputs(
        group, banks, precision, device)
    _, cdt = spec.dtypes
    step = 30       # the wordline fires at 6% of the run
    Krhs = (torch.einsum("bij,bj->bi", pre["KCoh"], v0.to(cdt))
            + Ksrc[step]).contiguous()
    return spec, pre, Krhs, params, v0, iters, tol


def tile_lanes(pre, Krhs, params, v0, B_big, gen):
    """A batch of B_big lanes cycling through the group's lanes, with
    each lane's start state jittered by up to 20 mV. Krhs is indexed by
    lane on its first axis."""
    idx = torch.arange(B_big, device=v0.device) % v0.shape[0]
    pre_b = {k: x[idx].contiguous() for k, x in pre.items()
             if k in ("KU", "Sb", "KPa", "KPg", "KCoh")}
    jitter = (torch.rand(v0[idx].shape, generator=gen, device=v0.device,
                         dtype=torch.float64) - 0.5) * 0.04
    v0_b = (v0[idx].double() + jitter).to(v0.dtype).contiguous()
    return pre_b, Krhs[idx].contiguous(), params[idx].contiguous(), v0_b


def gj_work(B: int, N: int, itemsize: int) -> tuple:
    """(bytes, float32 operations) of one Gauss-Jordan launch, counted
    from csrc/gauss_jordan.cu: J and r read once, x written once; per
    pivot one reciprocal, N - 1 factors, a 2-operation update of the
    (N - 1) x N other entries of J and of the N - 1 other entries of r;
    N final divisions."""
    nbytes = B * (N * N + 2 * N) * itemsize
    per_pivot = 1 + (N - 1) + 2 * (N - 1) * N + 2 * (N - 1)
    return nbytes, B * (N * per_pivot + N)


def gc_work(R: int, C: int) -> tuple:
    """(bytes, float32 operations) of one array-step launch, counted from
    csrc/gc_array_step.cu (expf and log1pf count one each): v_sn in and
    out, the rails, wbl and the row drives once; per cell and sweep three
    Newton iterations of two channel evaluations (~37 operations each)
    plus 14, and two channel evaluations plus 2 for the rail sums; ~15
    per column and sweep for the rail update."""
    nbytes = 4 * (2 * R * C + 3 * C + 2 * R)
    per_cell = 2 * (3 * (2 * 37 + 14) + (2 * 37 + 2))
    return nbytes, R * C * per_cell + C * 2 * 15


def bound_of(nbytes: int, flops: int, peak: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(fn, kernel_name: str, reps: int = 50, tries: int = 3):
    """Mean device time (ms) of the kernels whose name holds
    `kernel_name`, per launch, from torch.profiler over `reps` calls;
    None where `tries` profiler sessions record no device time for it
    (one session in an earlier run came back without the kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA \
                    or kernel_name not in ev.key:
                continue
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
            count += ev.count
        if count and total_us > 0:
            return total_us / count / 1e3
    return None


def read_column_systems(dev, B: int, seed: int = SEED):
    """Newton systems of the compile path's transient read: the Jacobian
    `jacobian(v, h)` and residual of the 16x64 gc2t_nn read column
    (N = 13, float64), at the precharge state for B = 1 and at B states
    jittered by up to 50 mV otherwise, with the four drive waveforms at
    random levels between the rails."""
    from repro_torch.core import timing
    from repro_torch.core.bank import BankConfig, build_bank
    bank = build_bank(BankConfig(16, 64, cell="gc2t_nn"))
    ckt, _ = timing.read_netlist(bank)
    system = ckt.build(device=dev)
    rng = np.random.default_rng(seed)
    jitter = 0.0 if B == 1 else rng.uniform(-0.05, 0.05, (B, system.n))
    v = torch.as_tensor(1.1 + jitter, dtype=torch.float64,
                        device=dev).expand(B, system.n).contiguous()
    h = torch.full((B,), 2e-12, dtype=torch.float64, device=dev)
    waves = torch.as_tensor(rng.uniform(0, 1.1, (B, 4)),
                            dtype=torch.float64, device=dev)
    J, r = system.newton_system(v, v, h, waves)
    return J.contiguous(), r.contiguous()


def dd_systems(dev, B: int, N: int, dtype=torch.float64, seed: int = SEED):
    """B diagonally dominant systems of size N, seeded."""
    rng = np.random.default_rng(seed + N)
    A = rng.standard_normal((B, N, N)) * 0.1
    A += np.eye(N)[None] * (np.abs(A).sum(-1).max() + 1.0)
    return (torch.as_tensor(A, dtype=dtype, device=dev),
            torch.as_tensor(rng.standard_normal((B, N)), dtype=dtype,
                            device=dev))


def check_gauss_jordan(dev) -> dict:
    """Gauss-Jordan kernels against their plain version (and the LU oracle
    at N = 130) on the card: B in GJ_BATCHES at N in GJ_SIZES (the path's
    read-column systems at N = 13), and B = 16 at N = 130 in float32 and
    float64; each case checks that `route` picked the kernel that
    launched. Returns the largest |x_kernel - x_plain| by kernel ("warp",
    "block"); raises on a failed check."""
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain,
                                                          route)
    from repro_torch.kernels.batched_solve.ref import batched_solve_ref
    cases = {}
    for N in GJ_SIZES:
        for B in GJ_BATCHES:
            cases[f"B={B} N={N} f64"] = (read_column_systems(dev, B)
                                         if N == 13 else dd_systems(dev, B, N))
    for dt in (torch.float32, torch.float64):
        cases[f"B=16 N=130 {str(dt)[6:]}"] = dd_systems(dev, 16, 130, dt)
    worst = {"warp": 0.0, "block": 0.0}
    for label, (J, r) in cases.items():
        kind = route(r.shape[-1])
        counts = (batched_solve.warp_launches, batched_solve.block_launches)
        got = batched_solve(J, r)
        launched = (batched_solve.warp_launches - counts[0],
                    batched_solve.block_launches - counts[1])
        want = gauss_jordan_plain(J, r)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        ok = (got.dtype == r.dtype and bool(torch.isfinite(got).all())
              and err <= GJ_RTOL * scale
              and launched == ((1, 0) if kind == "warp" else (0, 1)))
        msg = (f"check gauss_jordan {label} ({kind} kernel, launches "
               f"warp/block {launched}): max|dx| vs plain {err!r} (limit "
               f"{GJ_RTOL} x {scale!r})")
        if r.shape[-1] == 130:
            oracle = float((got.double() - batched_solve_ref(
                J.double(), r.double())).abs().max())
            ok = ok and oracle <= GJ_ORACLE_TOL
            msg += (f", vs torch.linalg.solve {oracle!r} (limit "
                    f"{GJ_ORACLE_TOL})")
        log(f"{msg} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"gauss_jordan check {label} failed")
        worst[kind] = max(worst[kind], err)
    return worst


def array_inputs(R: int, C: int, dev, seed: int = SEED):
    rng = np.random.default_rng(seed + R + C)
    f32 = dict(dtype=torch.float32, device=dev)
    wwl = torch.zeros((R,), **f32)
    wwl[R // 2] = 1.1
    return (torch.as_tensor(rng.uniform(0, 0.9, (R, C)), **f32),
            torch.as_tensor(rng.uniform(0, 1.1, (C,)), **f32), wwl,
            torch.as_tensor(rng.uniform(0, 1.1, (C,)), **f32),
            torch.full((R,), 1.1, **f32))


def check_gc_array_step(dev) -> float:
    """Array-step kernel against its plain version and the oracle on the
    card at 128x128 (16 Kb), 512x512 (256 Kb), C = 130 and C = 2200
    (`GC_CHECKS`), printing each launch's geometry; a second launch must
    give the same bits. Returns the largest |dv| against the plain
    version."""
    from repro_torch.kernels.gc_array_step import ops
    from repro_torch.kernels.gc_array_step.kernel import step_plain
    p = ops.cell_params("gc2t_nn")
    worst = 0.0
    for R, C, bc in GC_CHECKS:
        args = array_inputs(R, C, dev)
        kw = {} if bc is None else {"block_c": bc}
        sn, bl = ops.gc_array_step(*args, 2e-11, p, **kw)
        geom = ops.gc_array_step.last_geometry
        sn2, bl2 = ops.gc_array_step(*args, 2e-11, p, **kw)
        p_sn, p_bl = step_plain(*args, 2e-11, p)
        o_sn, o_bl = ops.gc_array_step_ref(*args, 2e-11, p)
        torch.cuda.synchronize()
        same = bool(torch.equal(sn, sn2) and torch.equal(bl, bl2))
        e_sn = float((sn - p_sn).abs().max())
        e_bl = float((bl - p_bl).abs().max())
        e_or = max(float((sn - o_sn).abs().max()),
                   float((bl - o_bl).abs().max()))
        ok = (e_sn <= GC_ATOL_SN and e_bl <= GC_ATOL_BL and same
              and e_or <= GC_ATOL_ORACLE and bool(torch.isfinite(sn).all()))
        log(f"check gc_array_step {R}x{C} block_c {bc or 'default'} "
            f"({geom.cols} columns x {geom.row_groups} row groups per "
            f"block, cluster {geom.cluster}, {geom.blocks} blocks): "
            f"max|dv| vs plain SN {e_sn!r} V (limit {GC_ATOL_SN}), rail "
            f"{e_bl!r} V (limit {GC_ATOL_BL}); vs oracle {e_or!r} V (limit "
            f"{GC_ATOL_ORACLE}); two launches bit-identical {same} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"gc_array_step check {R}x{C} failed")
        worst = max(worst, e_sn, e_bl)
    return worst


def compile_path(dev) -> dict:
    """The compile path, counted: each compile runs with the Gauss-Jordan
    counter set to 0 just before it and read just after."""
    from repro_torch.core.bank import BankConfig
    from repro_torch.core.compiler import compile_bank
    from repro_torch.core.spice.transient import NEWTON_ITERS
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    per_compile = READ_STEPS * NEWTON_ITERS
    out = {"launches": 0, "first_s": {}, "t_cell": {}, "retention": {},
           "summary": {}}
    for cell in COMPILE_CELLS:
        for ws, nw in COMPILE_SIZES:
            cfg = BankConfig(ws, nw, cell=cell)
            batched_solve.launches = 0
            batched_solve.warp_launches = 0
            batched_solve.block_launches = 0
            fused.fused_newton.launches = 0
            fused.fused_newton_scan.launches = 0
            t0 = time.perf_counter()
            rep = compile_bank(cfg, simulate=True, solver="pallas",
                               device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = batched_solve.launches
            t = rep.t_cell_sim_s
            log(f"compile path: {cell} {ws}x{nw} pallas on the card in "
                f"{wall:.2f} s (first call), gauss_jordan launches {n} "
                f"(expected {per_compile}; warp kernel "
                f"{batched_solve.warp_launches}, block kernel "
                f"{batched_solve.block_launches}), t_cell_sim {t!r} s")
            if n != per_compile or batched_solve.warp_launches != n \
                    or fused.fused_newton.launches != 0 \
                    or fused.fused_newton_scan.launches != 0:
                raise RuntimeError("compile path launch count")
            if not (t is not None and math.isfinite(t) and t > 0):
                raise RuntimeError("t_cell_sim not finite and positive")
            out["launches"] += n
            out["first_s"][(cell, ws, nw)] = wall
            out["t_cell"][(cell, ws, nw)] = t
            out["retention"][(cell, ws, nw)] = rep.retention.as_dict()
            out["summary"][(cell, ws, nw)] = rep.summary()
    batched_solve.launches = 0
    rep = compile_bank(BankConfig(16, 16, cell="sram6t"), simulate=True,
                       solver="pallas", device="cuda")
    log(f"compile path: sram6t 16x16 (no transient) f_max "
        f"{rep.timing.f_max_hz!r} Hz, gauss_jordan launches "
        f"{batched_solve.launches}")
    if rep.t_cell_sim_s is not None or batched_solve.launches != 0:
        raise RuntimeError("sram6t compile ran a transient")
    for (cell, ws, nw), t_card in out["t_cell"].items():
        cpu = compile_bank(BankConfig(ws, nw, cell=cell), simulate=True,
                           solver="pallas", device="cpu")
        t_cpu = cpu.t_cell_sim_s
        rel = abs(t_card - t_cpu) / abs(t_cpu)
        ret_card = out["retention"][(cell, ws, nw)]
        rel_ret = max(abs(ret_card[k] - getattr(cpu.retention, k))
                      / abs(getattr(cpu.retention, k))
                      for k in ("t_ret_s", "i_leak0_a"))
        line = (f"t_cell {cell} {ws}x{nw} pallas card vs CPU: rel {rel!r} "
                f"(limit {T_CELL_RTOL_PALLAS}); retention card vs CPU: rel "
                f"{rel_ret!r} (limit {RET_RTOL}), t_ret "
                f"{ret_card['t_ret_s']!r} s")
        if rel_ret > RET_RTOL:
            log(line + " FAILED")
            raise RuntimeError("compile path retention card vs CPU")
        if (ws, nw) == (16, 64):
            batched_solve.launches = 0
            t_jnp = compile_bank(BankConfig(ws, nw, cell=cell),
                                 simulate=True, solver="jnp",
                                 device="cuda").t_cell_sim_s
            anchor = ANCHORS_PS[cell]
            rel_j = abs(t_card - t_jnp) / abs(t_jnp)
            line += (f"; vs card jnp: rel {rel_j!r}; jnp {t_jnp * 1e12!r} ps "
                     f"(anchor {anchor} ps)")
            if (rel_j > T_CELL_RTOL_PALLAS or batched_solve.launches != 0
                    or abs(t_jnp * 1e12 - anchor) > ANCHOR_ATOL_PS):
                log(line + " FAILED")
                raise RuntimeError("compile path jnp parity or anchor")
        log(line)
        if rel > T_CELL_RTOL_PALLAS:
            raise RuntimeError("compile path card vs CPU parity")
    return out


def batch_sweep_inputs(device):
    """The 64-lane vt0 sweep of a 32x32 gc2t_nn read column
    (benchmarks/figures.py, beyond_batched_spice_throughput)."""
    from repro_torch.core import timing
    from repro_torch.core.bank import BankConfig, build_bank
    from repro_torch.core.spice.transient import Transient
    ckt, meta = timing.read_netlist(build_bank(BankConfig(32, 32,
                                                          "gc2t_nn")))
    system = ckt.build(device=device)
    waves = [([0.0, 1e-10, 1.2e-10], [1.1, 1.1, 0.0]),
             ([0.0, 8e-11, 1e-10], [0.0, 0.0, 1.1]),
             ([0.0, 1.0], [meta["v_sn"], meta["v_sn"]]),
             ([0.0, 1.0], [1.1, 1.1])]
    n_dev = len(system.didx["g"])
    vts = torch.linspace(0.30, 0.60, BATCH_LANES, dtype=torch.float64,
                         device=device)[:, None].expand(
        BATCH_LANES, n_dev).contiguous()
    return Transient(system, solver="pallas"), waves, {"vt0": vts}


def batch_path() -> int:
    """`run_batch` of the vt0 sweep on the card, counted, against the
    port's CPU run."""
    from repro_torch.core.spice.transient import NEWTON_ITERS
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    tr, waves, over = batch_sweep_inputs("cuda")
    batched_solve.launches = 0
    batched_solve.warp_launches = 0
    t0 = time.perf_counter()
    out = tr.run_batch(waves, 1e-9, BATCH_STEPS, over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = batched_solve.launches
    tr_cpu, _, over_cpu = batch_sweep_inputs("cpu")
    ref = tr_cpu.run_batch(waves, 1e-9, BATCH_STEPS, over_cpu)
    err = float((out["all"].cpu() - ref["all"]).abs().max())
    ok = (n == BATCH_STEPS * NEWTON_ITERS and err <= TRACE_ATOL_PALLAS
          and batched_solve.warp_launches == n
          and bool(torch.isfinite(out["all"]).all()))
    log(f"run_batch path: {BATCH_LANES} lanes x {BATCH_STEPS} steps pallas "
        f"on the card in {wall:.2f} s (first call), gauss_jordan launches "
        f"{n} (expected {BATCH_STEPS * NEWTON_ITERS}; warp kernel "
        f"{batched_solve.warp_launches}); max|dv| vs CPU "
        f"{err!r} V (limit {TRACE_ATOL_PALLAS}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("run_batch path")
    return n


def write_inputs(R, C, device):
    f32 = dict(dtype=torch.float32, device=device)
    wwl = torch.zeros((R,), **f32)
    wwl[3] = 1.1
    return (torch.zeros((R, C), **f32), torch.full((C,), 1.1, **f32), wwl,
            torch.full((C,), 1.1, **f32), torch.full((R,), 1.1, **f32))


def write_path() -> int:
    """A 200-step selected-row write of a 512x512 array through the
    array-step kernel, counted, with the write-physics checks of
    tests/test_kernels.py and the CPU plain run. All columns get the same
    drive and columns couple only through their own rail, so the CPU runs
    four of the 512 columns (one step of 512x512 in plain torch takes
    over a second on the host) and every card column is held to them."""
    from repro_torch.kernels.gc_array_step import ops
    p = ops.cell_params("gc2t_nn")
    v_sn, v_bl, wwl, wbl, rwl = write_inputs(512, 512, "cuda")
    ops.gc_array_step.launches = 0
    for _ in range(WRITE_STEPS):
        v_sn, v_bl = ops.gc_array_step(v_sn, v_bl, wwl, wbl, rwl, 1e-11, p)
    torch.cuda.synchronize()
    n = ops.gc_array_step.launches
    c_sn, c_bl, c_wwl, c_wbl, c_rwl = write_inputs(512, 4, "cpu")
    for _ in range(WRITE_STEPS):
        c_sn, c_bl = ops.gc_array_step(c_sn, c_bl, c_wwl, c_wbl, c_rwl,
                                       1e-11, p)
    err = max(float((v_sn.cpu() - c_sn[:, :1]).abs().max()),
              float((v_bl.cpu() - c_bl[:1]).abs().max()))
    sel, parked = float(v_sn[3, 0]), float(v_sn[5].abs().max())
    ok = (n == WRITE_STEPS and 0.6 < sel < 1.0 and parked < 0.05
          and err <= WRITE_ATOL)
    geom = ops.gc_array_step.last_geometry
    log(f"array path: {WRITE_STEPS}-step write of 512x512 on the card, "
        f"gc_array_step launches {n} ({geom.cols} columns x "
        f"{geom.row_groups} row groups per block, cluster {geom.cluster}, "
        f"{geom.blocks} blocks); selected SN {sel!r} V (0.6..1.0), "
        f"parked row max {parked!r} V (< 0.05); max|dv| vs CPU plain "
        f"{err!r} V (limit {WRITE_ATOL}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("array path")
    return n


def rel_err(got: float, want: float) -> float:
    """|got - want| / |want|; 0 where they are equal (infinities too)."""
    if got == want:
        return 0.0
    return abs(got - want) / abs(want) if want else math.inf


def match_query():
    from repro_torch.api import MatchQuery
    from repro_torch.core.dse import Demand
    return MatchQuery(tuple(Demand(*d) for d in MATCH_DEMANDS))


def reset_scan_counts() -> None:
    from repro_torch.kernels.batched_solve import fused
    fused.fused_newton.launches = 0
    fused.fused_newton_scan.launches = 0


def verdict_margin(dp, d) -> tuple:
    """The relative distance of each quantity `dse.feasible` compares to
    its threshold, with the tolerance it is held to card vs CPU."""
    out = [(rel_err(dp.f_max_hz, d.read_freq_hz), MATCH_RTOL)]
    if dp.retention_s > 0:
        out.append((rel_err(dp.retention_s, d.lifetime_s), RET_RTOL))
        out.append((rel_err(dp.cfg.num_words / dp.retention_s,
                            0.1 * dp.f_max_hz), RET_RTOL))
    return min(out)


def hold_match(got, want, q) -> dict:
    """The card's match result against the CPU's: the lattice's fields,
    t_cell, the shmoo grid, banks_needed and every row's chosen bank.
    A verdict may differ only where its deciding quantity lies within its
    tolerance of the threshold; that demand's sizing may then differ."""
    worst = {"analytic": 0.0, "retention": 0.0, "t_cell": 0.0}
    for g, w in zip(got.table.points, want.table.points):
        if g.cfg != w.cfg or g.swing_ok != w.swing_ok:
            raise RuntimeError(f"match path: point {w.cfg} differs")
        for f in MATCH_ANALYTIC:
            worst["analytic"] = max(worst["analytic"],
                                    rel_err(getattr(g, f), getattr(w, f)))
        for f in MATCH_RETENTION:
            worst["retention"] = max(worst["retention"],
                                     rel_err(getattr(g, f), getattr(w, f)))
    for g, w in zip(got.table.transient, want.table.transient):
        worst["t_cell"] = max(worst["t_cell"], rel_err(g.t_cell_s,
                                                       w.t_cell_s))
    log(f"match card vs CPU: analytic fields max rel {worst['analytic']!r} "
        f"(limit {MATCH_RTOL}), retention fields {worst['retention']!r} "
        f"(limit {RET_RTOL}), t_cell {worst['t_cell']!r} (limit "
        f"{T_CELL_RTOL_F64})")
    if worst["analytic"] > MATCH_RTOL or worst["retention"] > RET_RTOL \
            or worst["t_cell"] > T_CELL_RTOL_F64:
        raise RuntimeError("match path card vs CPU fields")
    points = {f"{p.cfg.cell}/{p.cfg.word_size}x{p.cfg.num_words}"
              + ("+ls" if p.cfg.wwlls else ""): p for p in want.table}
    demands = {f"{d.level}:{d.name}": d for d in q.demands}
    flipped = set()
    for dk, row in want.grid.items():
        for pk, verdict in row.items():
            if got.grid[dk][pk] == verdict:
                continue
            margin, tol = verdict_margin(points[pk], demands[dk])
            log(f"match verdict {dk} x {pk}: card {got.grid[dk][pk]}, CPU "
                f"{verdict}, margin {margin!r} (tolerance {tol})")
            if margin > tol:
                raise RuntimeError("match path verdict differs")
            flipped.add(dk)
    for g, w in zip(got.rows, want.rows):
        if w["demand"] in flipped:
            continue
        gb, wb = g["bank"], w["bank"]
        same = (g["banks_needed"] == w["banks_needed"]
                and g["n_feasible"] == w["n_feasible"]
                and g["macro_feasible"] == w["macro_feasible"]
                and (gb is None) == (wb is None)
                and (gb is None or all(gb[k] == wb[k] for k in (
                    "cell", "word_size", "num_words", "wwlls"))))
        if not same or got.banks_needed[w["demand"]] != \
                want.banks_needed[w["demand"]]:
            raise RuntimeError(f"match path row {w['demand']} differs")
    log(f"match card vs CPU: " + (
        f"verdicts of {len(flipped)} demand(s) differ, each within "
        f"tolerance of its threshold" if flipped else
        "grid, banks_needed and rows equal")
        + f"; banks_needed {got.banks_needed}; pass rate "
        f"{got.pass_rate!r}")
    return worst


def match_path(cfgs, cpu_chars, n_groups, compiled, card) -> dict:
    """The match path through the query API, counted: one cold
    `MatchQuery` on the card, held to the port's CPU run of the same
    query (on phase 4's CPU characterization); a store round trip and a
    result-cache hit with no launch; a `CompileQuery` held to phase 6's
    report."""
    from repro_torch.api import CompileQuery, Session
    from repro_torch.core.bank import BankConfig
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    q = match_query()
    sess = Session(device="cuda")
    reset_scan_counts()
    t0 = time.perf_counter()
    got = sess.run(q)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fused.fused_newton_scan.launches
    st = dict(sess.executor.stats)
    log(f"match path: MatchQuery({len(q.demands)} demands, default "
        f"transient sweep of {len(got.table)} points) on the card in "
        f"{first_s:.2f} s (cold session), fused_newton_scan launches "
        f"{launches}, one-step launches {fused.fused_newton.launches}; "
        f"executor stats {st}")
    if launches != n_groups or fused.fused_newton.launches != 0 \
            or st.get("eval_batch_calls") != 1 \
            or st.get("char_calls") != 1 or st.get("shmoo_calls") != 1:
        raise RuntimeError("match path launch count or executor stats")
    # the CPU run of the same query takes phase 4's CPU characterization
    # as its session's transient cache, so its transient node runs nothing
    cpu = Session(device="cpu")
    mode = (q.sweep.sim_steps, q.sweep.solver, q.sweep.precision,
            "modeled")
    for cfg, ch in zip(cfgs, cpu_chars):
        cpu._tchars[(cpu._key(cfg),) + mode] = ch
    want = cpu.run(q)
    if cpu.executor.stats["char_calls"] != 0:
        raise RuntimeError("match path: the CPU run characterized again")
    worst = hold_match(got, want, q)

    # the artifact store: a fresh session on a store written by another
    # launches nothing and gives equal results; then a result-cache hit
    store = ROOT / "build" / "smoke_store"
    shutil.rmtree(store, ignore_errors=True)
    try:
        reset_scan_counts()
        first = Session(store=store, device="cuda").run(q)
        n_first = fused.fused_newton_scan.launches
        reset_scan_counts()
        second_s = Session(store=store, device="cuda")
        second = second_s.run(q)
        n_second = fused.fused_newton_scan.launches
    finally:
        shutil.rmtree(store, ignore_errors=True)
    same = (second.as_dict() == first.as_dict()
            and second.table.as_dict() == first.table.as_dict())
    log(f"match path store: first session {n_first} scan launches, second "
        f"session on the same store {n_second} (store hits "
        f"{second_s.executor.stats['store_hits']}), results equal {same}; "
        f"equal to the cold run {first.as_dict() == got.as_dict()}")
    if n_second != 0 or not same:
        raise RuntimeError("match path store round trip")
    reset_scan_counts()
    hits = sess.executor.stats["result_cache_hits"]
    again = sess.run(q)
    log(f"match path: the same query again in the first session: "
        f"{fused.fused_newton_scan.launches} scan launches, result-cache "
        f"hits {hits} -> {sess.executor.stats['result_cache_hits']}, same "
        f"object {again is got}")
    if again is not got or fused.fused_newton_scan.launches != 0:
        raise RuntimeError("match path result cache")

    # a compile through the API, against phase 6's compile_bank report
    key = ("gc2t_nn", 16, 64)
    batched_solve.launches = 0
    rep = Session(device="cuda").run(CompileQuery(
        BankConfig(key[1], key[2], cell=key[0]), simulate=True,
        solver="pallas"))
    torch.cuda.synchronize()
    n_gj = batched_solve.launches
    equal = rep.summary() == compiled["summary"][key]
    log(f"match path: CompileQuery {key[0]} {key[1]}x{key[2]} pallas on the "
        f"card: gauss_jordan launches {n_gj} (expected "
        f"{compiled['launches'] // len(compiled['t_cell'])}), report equal "
        f"to compile_bank's {equal}")
    if not equal or n_gj != compiled["launches"] // len(compiled["t_cell"]):
        raise RuntimeError("match path CompileQuery")
    return {"launches": launches, "first_s": first_s, "worst": worst}


def time_match(cfgs, card) -> dict:
    """Warm walls (kernels built, caches warm, a fresh session each run):
    the match, the analytic 96-point sweep and the 4 x 96 vdd lattice."""
    from repro_torch.api import Session, SweepQuery
    from repro_torch.core.dse_batch import evaluate_vdd_lattice
    q = match_query()
    evaluate_vdd_lattice(cfgs, VDD_LADDER, device="cuda")
    runs = {"match": lambda: Session(device="cuda").run(q),
            "analytic sweep": lambda: Session(device="cuda").run(
                SweepQuery()),
            "vdd lattice 4 x 96": lambda: evaluate_vdd_lattice(
                cfgs, VDD_LADDER, device="cuda")}
    out = {}
    for label, fn in runs.items():
        walls = []
        for _ in range(MATCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[label] = statistics.median(walls)
        log(f"time {label} warm: {', '.join(repr(w) for w in walls)} s, "
            f"median {out[label]!r} s [{card}]")
    return out


def profile_run(fn) -> dict:
    """One warm call of `fn` under torch.profiler: the wall under the
    profiler, the device busy time (kernels by name, device-side events
    only), its count of device operations, and the scan launches'
    share."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = scan_ms = 0.0
    scans = ops = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        busy_ms += ms
        ops += ev.count
        if "fused_newton_kernel" in ev.key:
            scan_ms += ms
            scans += ev.count
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_ops": ops,
            "idle_share": 1.0 - busy_ms / wall_ms, "scan_ms": scan_ms,
            "scan_share": scan_ms / busy_ms if busy_ms else None,
            "scan_launches": scans}


def profile_query(q, label, n_groups, card) -> dict:
    """One warm run of query `q` in a fresh session under torch.profiler:
    device busy time over the wall time under the profiler, and the
    share of it in the scan launches."""
    from repro_torch.api import Session
    out = profile_run(lambda: Session(device="cuda").run(q))
    log(f"profile {label} (warm, fresh session): wall {out['wall_ms']!r} ms "
        f"under the profiler, device busy {out['busy_ms']!r} ms, idle share "
        f"{out['idle_share']!r}; {out['scan_launches']} scan launches "
        f"{out['scan_ms']!r} ms, {out['scan_share']!r} of device time "
        f"[{card}]")
    if out["busy_ms"] <= 0 or out["scan_launches"] != n_groups:
        raise RuntimeError(f"profile {label}: no device time or scan "
                           f"launches")
    return out


def layout_query():
    from repro_torch.api import SweepQuery
    return SweepQuery(fidelity="layout")


def layout_path(cfgs, gpu_chars, n_groups) -> dict:
    """The layout path through the query API, counted: the default
    96-point layout sweep on the card (300 steps, f64, solver "pallas"),
    held to the port's CPU run of the same query (geometry reports equal,
    t_cell 1e-9) and to phase 4's hand-modeled t_cell (extracted above
    modeled at every point); a fresh session on the store another wrote
    replays it with no geometry rebuild and no launch;
    `timing.analyze(parasitics="extracted")` at gc2t_nn 16x64."""
    from repro_torch.api import Session
    from repro_torch.core import timing
    from repro_torch.core.bank import BankConfig, build_bank
    from repro_torch.kernels.batched_solve import fused
    q = layout_query()
    store = ROOT / "build" / "smoke_layout_store"
    shutil.rmtree(store, ignore_errors=True)
    try:
        sess = Session(store=store, device="cuda")
        reset_scan_counts()
        t0 = time.perf_counter()
        got = sess.run(q)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = fused.fused_newton_scan.launches
        steps = fused.fused_newton.launches
        st = dict(sess.executor.stats)
        log(f"layout path: SweepQuery(fidelity='layout') over "
            f"{len(got)} points on the card in {first_s:.2f} s (cold "
            f"session), fused_newton_scan launches {launches}, one-step "
            f"launches {steps}; executor stats {st}")
        summary = got.geometry_summary()
        log(f"layout path geometry: {summary}")
        if launches != n_groups or steps != 0 \
                or st.get("geom_verifies") != len(cfgs) \
                or st.get("char_calls") != 1:
            raise RuntimeError("layout path launch count or executor stats")
        if not (summary["all_clean"] and summary["n_verified"] == len(cfgs)
                and summary["n_drc_clean"] == len(cfgs)
                and summary["n_lvs_ok"] == len(cfgs)
                and summary["n_extract_bit_identical"] == len(cfgs)):
            raise RuntimeError("layout path: a geometry report is not clean")

        # the port's CPU run of the same query
        t0 = time.perf_counter()
        cpu = Session(device="cpu").run(q)
        cpu_s = time.perf_counter() - t0
        t_card = np.array([c.t_cell_s for c in got.transient])
        t_cpu = np.array([c.t_cell_s for c in cpu.transient])
        t_mod = np.array([c.t_cell_s for c in gpu_chars])
        same_geom = got.geometry == cpu.geometry
        rel = float(np.max(np.abs(t_card - t_cpu) / np.abs(t_cpu)))
        gap = (t_card - t_mod) / t_mod
        log(f"layout card vs CPU (CPU run {cpu_s:.2f} s): geometry reports "
            f"equal {same_geom}; t_cell max rel {rel!r} (limit "
            f"{T_CELL_RTOL_F64}); extracted over modeled t_cell: min "
            f"{float(gap.min())!r}, max {float(gap.max())!r}")
        if not (np.isfinite(t_card).all() and (t_card > 0).all()) \
                or not same_geom or rel > T_CELL_RTOL_F64 \
                or not (gap > 0).all():
            raise RuntimeError("layout path card vs CPU or vs modeled")

        # a fresh session on the store replays it
        reset_scan_counts()
        s2 = Session(store=store, device="cuda")
        again = s2.run(q)
        st2 = dict(s2.executor.stats)
        n2 = fused.fused_newton_scan.launches
        equal = (again.geometry == got.geometry
                 and [c.t_cell_s for c in again.transient] == list(t_card)
                 and again.as_dict() == got.as_dict())
        log(f"layout path store: second session {n2} scan launches, "
            f"geometry verifies {st2.get('geom_verifies', 0)}, char calls "
            f"{st2.get('char_calls', 0)}, store hits "
            f"{st2.get('store_hits', 0)}; results equal {equal}")
        if n2 != 0 or st2.get("geom_verifies", 0) != 0 \
                or st2.get("char_calls", 0) != 0 or not equal:
            raise RuntimeError("layout path store replay")
    finally:
        shutil.rmtree(store, ignore_errors=True)

    # the analytic timing closure with extracted parasitics (host float64
    # in both runs): its t_cell is the layout sweep's analytic estimate
    cfg = BankConfig(16, 64, cell="gc2t_nn")
    i = cfgs.index(cfg)
    te = timing.analyze(build_bank(cfg), parasitics="extracted")
    tm = timing.analyze(build_bank(cfg))
    an_card = got.transient[i].t_cell_analytic_s
    an_cpu = cpu.transient[i].t_cell_analytic_s
    log(f"timing.analyze gc2t_nn 16x64 extracted: t_cell {te.t_cell_s!r} s "
        f"(the card sweep's analytic estimate {an_card!r}, the CPU "
        f"sweep's {an_cpu!r}), t_wl {te.t_wl_s!r} s, stages "
        f"{te.delay_stages}, f_max {te.f_max_hz!r} Hz; modeled t_cell "
        f"{tm.t_cell_s!r} s, stages {tm.delay_stages}")
    if not (te.t_cell_s == an_card == an_cpu and te.t_cell_s > tm.t_cell_s
            and te.t_wl_s > tm.t_wl_s
            and te.delay_stages >= tm.delay_stages):
        raise RuntimeError("timing.analyze(parasitics='extracted')")
    return {"launches": launches, "first_s": first_s, "rel": rel,
            "gap": (float(gap.min()), float(gap.max()))}


def time_layout(card) -> dict:
    """Warm wall of the layout sweep (a fresh session each run) and, in
    the same runs, its split: the executor's geometry verification on
    the host (its `verify_bank` calls) and its transient tier (its
    `characterize` call, which ends in a copy to the host), each timed
    by wrapping the function the executor calls."""
    from repro_torch.api import Session
    from repro_torch.core.spice import char_batch
    from repro_torch.geom import verify
    q = layout_query()
    spans = {"geometry verification": 0.0, "transient tier": 0.0}

    def timed(mod, name, label):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[label] += time.perf_counter() - t0
        return fn, wrapper

    patches = [(verify, "verify_bank", "geometry verification"),
               (char_batch, "characterize", "transient tier")]
    runs = {"layout sweep": [], "geometry verification": [],
            "transient tier": []}
    originals = []
    try:
        for mod, name, label in patches:
            fn, wrapper = timed(mod, name, label)
            originals.append((mod, name, fn))
            setattr(mod, name, wrapper)
        for _ in range(LAYOUT_REPS):
            for k in spans:
                spans[k] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Session(device="cuda").run(q)
            torch.cuda.synchronize()
            runs["layout sweep"].append(time.perf_counter() - t0)
            for k, v in spans.items():
                runs[k].append(v)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    out = {k: statistics.median(v) for k, v in runs.items()}
    for label, walls in runs.items():
        log(f"time {label} warm: {', '.join(repr(w) for w in walls)} s, "
            f"median {out[label]!r} s [{card}]")
    shares = [(g / w, t / w) for w, g, t in zip(*runs.values())]
    rest = statistics.median(w - g - t for w, g, t in zip(*runs.values()))
    log(f"time layout sweep split, per run (geometry, transient) shares of "
        f"the wall: {shares!r}; the rest (planning, analytic tier, the "
        f"executor) median {rest!r} s [{card}]")
    if not all(g > 0 and t > 0 for g, t in shares):
        raise RuntimeError("layout split: a span was not timed")
    return out


class OpCount:
    """Counts the torch operations dispatched inside a `with` block and
    the device types of the tensors they return. `aten.lift_fresh` (host
    data, a numpy array or a list, entering torch before its copy to the
    card) is counted apart, in `lifts`."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        counter = self
        self.n, self.lifts, self.devices = 0, 0, set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is torch.ops.aten.lift_fresh.default:
                    counter.lifts += 1
                    return out
                counter.n += 1
                counter.devices.update(
                    t.device.type for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor))
                return out

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def sparse_path(cfgs, gpu_chars, card) -> dict:
    """The sparse-LU engine on the card: `SweepQuery(fidelity=
    "transient", solver="sparse")` over the 96-point lattice once, counted
    (no scan launch), t_cell held to phase 4's fused-engine run and to
    the port's CPU run; then one step of one topology group under a
    dispatch counter: every operation but the lifts of host inputs
    returns CUDA tensors; and the torch operations per Newton
    iteration."""
    from repro_torch.api import Session, SweepQuery
    from repro_torch.core.bank import build_bank
    from repro_torch.core.dse_batch import group_by_topology
    from repro_torch.core.spice.char_batch import group_inputs
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve import sparse as sps
    q = SweepQuery(fidelity="transient", solver="sparse")
    reset_scan_counts()
    sess = Session(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sess.run(q)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fused.fused_newton_scan.launches + fused.fused_newton.launches
    t_sp = np.array([c.t_cell_s for c in got.transient])
    t_fu = np.array([c.t_cell_s for c in gpu_chars])
    gap = np.abs(t_sp - t_fu) / np.abs(t_fu)
    rel = float(gap.max())
    log(f"sparse path: SweepQuery(solver='sparse') over {len(got)} points "
        f"on the card in {wall_s!r} s (one run, the whole lattice), fused "
        f"Newton launches {launches}; executor stats "
        f"{dict(sess.executor.stats)}; t_cell vs phase 4's fused engine "
        f"max rel {rel!r} (limit {SPARSE_RTOL}) [{card}]")
    for idx in group_by_topology(cfgs).values():
        c = cfgs[idx[0]]
        log(f"  sparse vs fused, {c.cell} wwlls={c.wwlls} "
            f"write_vt={c.write_vt}: max rel {float(gap[idx].max())!r}")
    t0 = time.perf_counter()
    cpu = Session(device="cpu").run(q)
    cpu_s = time.perf_counter() - t0
    t_cpu = np.array([c.t_cell_s for c in cpu.transient])
    rel_cpu = float(np.max(np.abs(t_sp - t_cpu) / np.abs(t_cpu)))
    log(f"sparse path card vs CPU (CPU run {cpu_s:.2f} s): t_cell max rel "
        f"{rel_cpu!r} (limit {T_CELL_RTOL_F64})")
    if launches != 0 or not (np.isfinite(t_sp).all() and (t_sp > 0).all()) \
            or rel > SPARSE_RTOL or rel_cpu > T_CELL_RTOL_F64:
        raise RuntimeError("sparse path launches or t_cell")

    # one group's first step, and one Newton iteration, under the counter
    idx = next(iter(group_by_topology(cfgs).values()))
    group = [cfgs[i] for i in idx]
    inp = group_inputs(group, [build_bank(c) for c in group], n_seg=8,
                       n_steps=N_STEPS, solver="sparse", device="cuda")
    tr = inp["tr"]
    with OpCount() as step_ops:
        res = tr.run_lattice(inp["wt"], inp["wv"], inp["t_end"], 1,
                             over_batches=inp["over"], v0=inp["v0"])
    spec = tr.spec
    sdt, cdt = spec.dtypes
    B = inp["over"]["G"].shape[0]
    h = torch.as_tensor(inp["t_end"], dtype=torch.float64,
                        device="cuda") / N_STEPS
    gn = spec.sp.project_dense(inp["over"]["G"])
    cn = spec.sp.project_dense(inp["over"]["C"])
    j_const = sps.j_constant(spec, gn, cn, h)
    v = inp["v0"].to(sdt).expand(B, spec.sp.n)
    rhs = sps.coo_matvec(spec.sp, (cn / h[:, None]).to(cdt), v.to(cdt))
    params = sps.pack_params(tr.system.dev, B, cdt)
    done = torch.zeros((B,), dtype=torch.bool, device="cuda")
    it = sps.make_newton_iter(spec, tr.tol)
    with OpCount() as iter_ops:
        it(j_const, rhs, params, v, done)
    log(f"sparse path ops: one step of a {B}-lane group {step_ops.n} torch "
        f"operations (devices {sorted(step_ops.devices)}; {step_ops.lifts} "
        f"host arrays lifted into torch for the copy), one Newton "
        f"iteration {iter_ops.n} (devices {sorted(iter_ops.devices)}); "
        f"n = {spec.sp.n}, nnz = {spec.sp.nnz}, fill-in "
        f"{spec.sched.nnz_f - spec.sched.nnz}")
    if step_ops.devices != {"cuda"} or iter_ops.devices != {"cuda"} \
            or not bool(torch.isfinite(res["all"]).all()):
        raise RuntimeError("sparse path: an operation left the card")
    return {"wall_s": wall_s, "rel": rel, "rel_cpu": rel_cpu,
            "iter_ops": iter_ops.n, "step_ops": step_ops.n}


# -- the gradient path: `t_cell_grad_fn` under autograd and OptimizeQuery
GRAD_SIZE = (32, 64)        # word_size, num_words of each topology's config
GRAD_KNOBS = ("vdd_scale", "w_read_scale", "bl_wire_scale")
# tests/test_grad_dse.py's base point, relative central-difference step
# and acceptance threshold (its `_rel_err`)
GRAD_BASE = np.array([0.97, 1.05, 0.92])
GRAD_EPS = 1e-4
GRAD_FD_TOL = 1e-4
# eight seeded points inside dse_opt.DEFAULT_BOUNDS, vdd_scale from 0.95:
# the stop time is pinned at the nominal point, and below ~0.9 the slow
# topologies' reads do not cross before it (gc2t_osos at 0.86)
GRAD_SEEDED = 8
GRAD_LO, GRAD_HI = (0.95, 0.5, 0.5), (1.25, 2.0, 2.0)
# card vs the port's CPU run: t_cell at the lattice's limit; gradients
# relative to each knob's largest (the same float64 algebra; the
# backward's sums run in other orders on the card)
GRAD_RTOL_T = T_CELL_RTOL_F64
GRAD_RTOL = 1e-7
# the sparse-LU engine's gradients vs the fused engine's on one batch:
# the engines' roots differ by up to their 1e-6 V freeze (SPARSE_RTOL),
# and the adjoints start from those roots
SPARSE_GRAD_RTOL = 1e-6
GRAD_REPS = 5               # warm walls: the median of this many runs
# OptimizeQuery: the README's query, and benchmarks/bench_optimize.py's
# full-mode flow (36-config lattice, its demand, a coarse 4-rung screen,
# 60 Adam steps on the winner); card vs CPU knobs and objective
README_OPTIMIZE = dict(cell="gc2t_np", target_freq_hz=5e8, target_ret_s=5e-5,
                       knobs=("vdd_scale", "w_read_scale"))
BENCH_LATTICE = dict(cells=("gc2t_nn", "gc2t_np", "gc2t_osos"),
                     word_sizes=(16, 32), num_words=(32, 64, 128),
                     wwlls=(False, True))
BENCH_DEMAND = dict(target_freq_hz=2e8, target_ret_s=5e-5)
BENCH_STEPS = 60
OPT_RTOL = 1e-6
OPT_VERDICTS = ("met", "seed_met", "fell_back", "improved")


def grad_rows() -> np.ndarray:
    """(16, 3) knob rows: the nominal point, the base point, the base
    point +/- GRAD_EPS relative per knob, and GRAD_SEEDED seeded points."""
    h = GRAD_EPS * GRAD_BASE
    rows = [np.ones(3), GRAD_BASE]
    for j in range(3):
        for s in (+1, -1):
            p = GRAD_BASE.copy()
            p[j] += s * h[j]
            rows.append(p)
    lo, hi = np.array(GRAD_LO), np.array(GRAD_HI)
    rows += list(lo + (hi - lo) * np.random.default_rng(SEED).uniform(
        size=(GRAD_SEEDED, 3)))
    return np.stack(rows)


def fd_rel_err(ad, fd, out_mag, x_mag) -> float:
    """tests/test_grad_dse.py's `_rel_err`: |ad - fd| relative to the
    gradient scale, floored at 1e-7 |f| / |x| (numerically zero at this
    step size)."""
    floor = 1e-7 * (abs(out_mag) / max(x_mag, 1e-30) + 1e-300)
    return abs(ad - fd) / max(abs(ad), abs(fd), floor)


def grad_configs(cfgs) -> list:
    """The GRAD_SIZE config of each topology group of the lattice."""
    from repro_torch.core.dse_batch import group_by_topology
    return [next(cfgs[i] for i in idx if (cfgs[i].word_size,
                                          cfgs[i].num_words) == GRAD_SIZE)
            for idx in group_by_topology(cfgs).values()]


def t_cell_grads(cfg, X, device, solver="pallas"):
    """t_cell (B,), valid (B,) and d(sum t_cell)/d(knobs) (B, 3) of
    `t_cell_grad_fn` at knob rows X, as numpy; and the scan launches
    of the forward and of the backward."""
    from repro_torch.core.spice.char_batch import t_cell_grad_fn
    from repro_torch.kernels.batched_solve import fused
    fn = t_cell_grad_fn(cfg, solver=solver, device=device)
    x = torch.tensor(X, dtype=torch.float64, device=device,
                     requires_grad=True)
    before = fused.fused_newton_scan.launches
    t, valid = fn({k: x[:, j] for j, k in enumerate(GRAD_KNOBS)})
    fwd = fused.fused_newton_scan.launches - before
    (g,) = torch.autograd.grad(t.sum(), x)
    bwd = fused.fused_newton_scan.launches - before - fwd
    return (t.detach().cpu().numpy(), valid.cpu().numpy(), g.cpu().numpy(),
            fwd, bwd)


def col_rel(got, want) -> float:
    """max |got - want| relative to each column's largest |want|."""
    scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
    return float((np.abs(got - want) / scale).max())


def grad_path(cfgs, card) -> dict:
    """`t_cell_grad_fn(solver="pallas")` under `torch.autograd.grad` on the
    card, per topology group (its 32x64 config, the 16 rows of
    `grad_rows`), counted: one scan launch forward, none backward, no
    one-step launch; every point valid; t_cell and the gradients held to
    the port's CPU run, the nominal t_cell to `characterize` on the card,
    the gradient at the base point to the batch's central differences.
    Then the warm walls of each forward and backward (median of
    GRAD_REPS), and the backward's torch operations per step under the
    dispatch counter."""
    from repro_torch.core.spice.char_batch import (characterize,
                                                   t_cell_grad_fn)
    from repro_torch.kernels.batched_solve import fused
    X = grad_rows()
    h = GRAD_EPS * GRAD_BASE
    launches, worst, per_cfg = 0, {"t": 0.0, "g": 0.0, "nominal": 0.0,
                                   "fd": 0.0}, {}
    for cfg in grad_configs(cfgs):
        reset_scan_counts()
        t, valid, g, fwd, bwd = t_cell_grads(cfg, X, "cuda")
        one_step = fused.fused_newton.launches
        launches += fwd
        t_h, valid_h, g_h, _, _ = t_cell_grads(cfg, X, "cpu")
        nominal = characterize([cfg], device="cuda")[0].t_cell_s
        rel_t = float(np.max(np.abs(t - t_h) / np.abs(t_h)))
        rel_g = col_rel(g, g_h)
        rel_nom = float(abs(t[0] - nominal) / nominal)
        fd = []
        for j in range(3):
            d = (t[2 + 2 * j] - t[3 + 2 * j]) / (2 * h[j])
            fd.append(fd_rel_err(g[1, j], d, t[1], GRAD_BASE[j]))
        label = f"{cfg.cell} {cfg.word_size}x{cfg.num_words} " \
                f"wwlls={cfg.wwlls}"
        log(f"grad path {label}: {len(X)} points, scan launches forward "
            f"{fwd} backward {bwd}, one-step launches {one_step}; valid "
            f"{int(valid.sum())}/{len(X)}; t_cell card vs CPU max rel "
            f"{rel_t!r} (limit {GRAD_RTOL_T}), nominal vs characterize "
            f"{rel_nom!r} (limit {GRAD_RTOL_T}); gradients card vs CPU max "
            f"rel {rel_g!r} (limit {GRAD_RTOL}); at the base point "
            f"d t_cell/d({', '.join(GRAD_KNOBS)}) = "
            f"{[float(x) for x in g[1]]!r} s, vs central differences "
            f"{[float(x) for x in fd]!r} (limit {GRAD_FD_TOL})")
        if fwd != 1 or bwd != 0 or one_step != 0 or not valid.all() \
                or not valid_h.all() or rel_t > GRAD_RTOL_T \
                or rel_nom > GRAD_RTOL_T or rel_g > GRAD_RTOL \
                or max(fd) >= GRAD_FD_TOL or not np.isfinite(g).all():
            raise RuntimeError(f"grad path {label}")
        for k, v in (("t", rel_t), ("g", rel_g), ("nominal", rel_nom),
                     ("fd", max(fd))):
            worst[k] = max(worst[k], v)
        per_cfg[label] = (cfg, t, g)

    # the sparse-LU engine on gc2t_np, the reference test's 8 rows
    label, (cfg, t_f, g_f) = next((k, v) for k, v in per_cfg.items()
                                  if v[0].cell == "gc2t_np"
                                  and not v[0].wwlls)
    reset_scan_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_s, valid_s, g_s, fwd_s, bwd_s = t_cell_grads(cfg, X[:8], "cuda",
                                                   solver="sparse")
    sparse_s = time.perf_counter() - t0
    rel_st = float(np.max(np.abs(t_s - t_f[:8]) / np.abs(t_f[:8])))
    rel_sg = col_rel(g_s, g_f[:8])
    log(f"grad path sparse {label}: 8 points in {sparse_s!r} s (forward "
        f"and backward, plain torch), scan launches {fwd_s + bwd_s}; t_cell "
        f"vs the fused engine max rel {rel_st!r} (limit {GRAD_RTOL_T}), "
        f"gradients {rel_sg!r} (limit {SPARSE_GRAD_RTOL}) [{card}]")
    if fwd_s + bwd_s != 0 or not valid_s.all() or rel_st > GRAD_RTOL_T \
            or rel_sg > SPARSE_GRAD_RTOL:
        raise RuntimeError("grad path: sparse engine")

    # warm walls, per topology: the forward and the backward, each timed
    # to a synchronized card
    walls = {}
    for label, (cfg, _, _) in per_cfg.items():
        fn = t_cell_grad_fn(cfg, device="cuda")
        fw, bw = [], []
        for _ in range(GRAD_REPS):
            x = torch.tensor(X, device="cuda", requires_grad=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t, _ = fn({k: x[:, j] for j, k in enumerate(GRAD_KNOBS)})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.grad(t.sum(), x)
            torch.cuda.synchronize()
            fw.append(t1 - t0)
            bw.append(time.perf_counter() - t1)
        walls[label] = (statistics.median(fw), statistics.median(bw))
        log(f"time grad {label} warm ({len(X)} points, {N_STEPS} steps): "
            f"forward {', '.join(repr(w) for w in fw)} s, median "
            f"{walls[label][0]!r} s; backward "
            f"{', '.join(repr(w) for w in bw)} s, median "
            f"{walls[label][1]!r} s [{card}]")
    # the backward of one topology under the dispatch counter
    cfg = next(iter(per_cfg.values()))[0]
    fn = t_cell_grad_fn(cfg, device="cuda")
    x = torch.tensor(X, device="cuda", requires_grad=True)
    t, _ = fn({k: x[:, j] for j, k in enumerate(GRAD_KNOBS)})
    with OpCount() as ops:
        torch.autograd.grad(t.sum(), x)
    log(f"grad path ops: one backward of {len(X)} points over {N_STEPS} "
        f"steps, {ops.n} torch operations ({ops.n / N_STEPS!r} per step; "
        f"devices {sorted(ops.devices)})")
    if ops.n and ops.devices != {"cuda"}:
        raise RuntimeError("grad path: a backward operation left the card")
    return {"launches": launches, "worst": worst, "walls": walls,
            "sparse_s": sparse_s, "ops": ops.n}


def bench_winner(device) -> tuple:
    """benchmarks/bench_optimize.py's coarse screen: the feasible argmin
    of standby power over (VDD_LADDER x its 36-config lattice)."""
    from repro_torch.core import dse_batch
    from repro_torch.core.dse import lattice_configs
    cfgs = lattice_configs(**BENCH_LATTICE)
    lat = dse_batch.evaluate_vdd_lattice(cfgs, VDD_LADDER, device=device)
    feas = dse_batch.feasible_grid(
        lat.f_max_hz, lat.retention_s, lat.swing_ok, lat.num_words,
        np.array([BENCH_DEMAND["target_freq_hz"]]),
        np.array([BENCH_DEMAND["target_ret_s"]]), device=device)[:, :, 0]
    obj = np.where(feas, lat.standby_w, np.inf)
    v, p = np.unravel_index(int(np.argmin(obj)), obj.shape)
    return cfgs[int(p)], float(obj[v, p])


def optimize_queries(device) -> dict:
    from repro_torch.api import OptimizeQuery
    win, _ = bench_winner(device)
    return {"README": OptimizeQuery(**README_OPTIMIZE),
            "bench_optimize": OptimizeQuery(
                cell=win.cell, word_size=win.word_size,
                num_words=win.num_words, write_vt=win.write_vt,
                wwlls=win.wwlls, knobs=("vdd_scale",), steps=BENCH_STEPS,
                seed_vdd_scales=VDD_LADDER, **BENCH_DEMAND)}


def optimize_path(card) -> dict:
    """`Session(device="cuda").run(OptimizeQuery(...))` for the README's
    query and bench_optimize's flow, held to the port's CPU session
    (verdicts equal, knobs and objective OPT_RTOL); a fresh session on
    the store the first wrote optimizes and evaluates nothing; the same
    query again is a result-cache hit. Then the warm walls (median of
    GRAD_REPS, a fresh session each run)."""
    from repro_torch.api import Session
    queries = optimize_queries("cuda")
    cpu_queries = optimize_queries("cpu")
    out = {}
    for label, q in queries.items():
        if cpu_queries[label] != q:
            raise RuntimeError(f"optimize {label}: the CPU screen picked "
                               f"another config")
        store = ROOT / "build" / "smoke_opt_store"
        shutil.rmtree(store, ignore_errors=True)
        try:
            s = Session(store=store, device="cuda")
            got = s.run(q)
            host = Session(device="cpu").run(q).as_dict()
            fresh = Session(store=store, device="cuda")
            again = fresh.run(q)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        d = got.as_dict()
        same = [k for k in OPT_VERDICTS if d[k] == host[k]]
        rel_k = max(rel_err(d["knobs"][k], host["knobs"][k])
                    for k in host["knobs"])
        rel_o = rel_err(d["objective_value"], host["objective_value"])
        hit = s.run(q) is got
        replay = (again.as_dict() == d
                  and fresh.executor.stats["optimize_calls"] == 0
                  and fresh.executor.stats["vdd_evals"] == 0)
        log(f"optimize {label}: {q.cell} {q.word_size}x{q.num_words} "
            f"wwlls={q.wwlls} knobs {q.knobs}, {q.steps} steps: met "
            f"{d['met']}, seed_met {d['seed_met']}, fell_back "
            f"{d['fell_back']}, improved {d['improved']} (equal to the CPU "
            f"run: {len(same) == len(OPT_VERDICTS)}); knobs {d['knobs']}, "
            f"{d['objective']} {d['objective_value']!r} (seed "
            f"{d['seed_objective_value']!r}); card vs CPU knobs max rel "
            f"{rel_k!r}, objective {rel_o!r} (limit {OPT_RTOL}); store "
            f"replay computes nothing {replay} "
            f"({dict(fresh.executor.stats)}); result-cache hit {hit}")
        if len(same) != len(OPT_VERDICTS) or rel_k > OPT_RTOL \
                or rel_o > OPT_RTOL or not replay or not hit:
            raise RuntimeError(f"optimize {label}")
        walls = []
        for _ in range(GRAD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Session(device="cuda").run(q)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[label] = statistics.median(walls)
        log(f"time optimize {label} warm (fresh session): "
            f"{', '.join(repr(w) for w in walls)} s, median "
            f"{out[label]!r} s [{card}]")
    return out


def profile_grad(cfgs, card) -> dict:
    """One warm forward + backward of `t_cell_grad_fn` (the first
    topology group's 32x64 config, 16 points) under torch.profiler: the
    device's idle share, and the scan kernel's device ms inside it."""
    from repro_torch.core.spice.char_batch import t_cell_grad_fn
    cfg = grad_configs(cfgs)[0]
    fn = t_cell_grad_fn(cfg, device="cuda")
    X = grad_rows()

    def run():
        x = torch.tensor(X, device="cuda", requires_grad=True)
        t, _ = fn({k: x[:, j] for j, k in enumerate(GRAD_KNOBS)})
        torch.autograd.grad(t.sum(), x)

    out = profile_run(run)
    log(f"profile grad {cfg.cell} {cfg.word_size}x{cfg.num_words} "
        f"wwlls={cfg.wwlls} (warm forward + backward, {len(X)} points): "
        f"wall {out['wall_ms']!r} ms under the profiler, device busy "
        f"{out['busy_ms']!r} ms over {out['device_ops']} device operations, "
        f"idle share {out['idle_share']!r}; {out['scan_launches']} scan "
        f"launch(es) {out['scan_ms']!r} ms [{card}]")
    if out["busy_ms"] <= 0 or out["scan_launches"] != 1:
        raise RuntimeError("profile grad: no device time or scan launch")
    return out


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of `fn` over `calls` calls with no
    synchronize inside: the wrapper's own cost while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def time_gauss_jordan(dev, card, J, r, label, kernel_name, chain=None):
    """Events, device time, plain version, solve_ex/solve and the
    wrapper's host time of one Gauss-Jordan shape, in turns (plain,
    kernel, kernel, plain)."""
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain)
    B, N = r.shape
    kern = lambda: batched_solve(J, r)
    plain = lambda: gauss_jordan_plain(J, r)
    # solve_ex: the library call the port's "jnp" stepper makes; it does
    # not check for errors, so it does not wait on the device as
    # torch.linalg.solve does
    lib = lambda: torch.linalg.solve_ex(J, r[..., None])
    lib_sync = lambda: torch.linalg.solve(J, r[..., None])
    p1, k1 = time_ms(plain, 20), time_ms(kern, 500)
    l1, s1 = time_ms(lib, 200), time_ms(lib_sync, 200)
    k2, p2 = time_ms(kern, 500), time_ms(plain, 20)
    l2 = time_ms(lib, 200)
    wrap = host_us(kern)
    d = device_ms(kern, kernel_name)
    bound, by = bound_of(*gj_work(B, N, r.element_size()),
                         PEAK_FLOPS[torch.float32])
    out = dict(ms=(k1 + k2) / 2, device_ms=d, plain_ms=(p1 + p2) / 2,
               library_ms=(l1 + l2) / 2, bound_ms=bound, bound_by=by,
               host_us=wrap, chain_ms=chain)
    log(f"time gauss_jordan {label}: kernel {k1!r} / {k2!r} ms, device "
        f"{d!r} ms, wrapper host {wrap!r} us per call (1000 calls, no "
        f"sync), plain {p1!r} / {p2!r} ms, torch.linalg.solve_ex {l1!r} / "
        f"{l2!r} ms, torch.linalg.solve {s1!r} ms, bound {bound!r} ms "
        f"({by}), dependent chain {chain!r} ms [{card}]")
    return out


def time_new_kernels(dev, card) -> dict:
    """Events, profiler device time, plain version, bound, floor and
    library call of the Gauss-Jordan and array-step kernels at the paths'
    shapes, in turns (plain, kernel, kernel, plain). The Gauss-Jordan
    dependent chain: N pivots at the time of one, the slope of a single
    system's device time between N = 2 and N = 16 (the same warp kernel
    of width 16). The array step's SFU floor: 64 transcendental calls
    per cell at 16 results per clock and SM at the maximum SM clock."""
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.kernels.gc_array_step import ops
    from repro_torch.kernels.gc_array_step.kernel import step_plain
    out = {}
    d_n = {}
    for n in (2, 16):
        J, r = dd_systems(dev, 1, n)
        d_n[n] = device_ms(lambda: batched_solve(J, r),
                           "gauss_jordan_warp_kernel")
    t_pivot = (d_n[16] - d_n[2]) / 14
    log(f"time gauss_jordan warp kernel B=1 f64: device {d_n[2]!r} ms at "
        f"N=2, {d_n[16]!r} ms at N=16: {t_pivot!r} ms per pivot [{card}]")
    for B in (1, GJ_BIG_BATCH):
        J, r = read_column_systems(dev, B)
        out[f"gauss_jordan B={B}"] = time_gauss_jordan(
            dev, card, J, r, f"B={B} N=13 f64 (warp kernel)",
            "gauss_jordan_warp_kernel", chain=13 * t_pivot)
    J, r = dd_systems(dev, 16, 130)
    out["gauss_jordan block"] = time_gauss_jordan(
        dev, card, J, r, "B=16 N=130 f64 (block kernel)",
        "gauss_jordan_kernel")
    p = ops.cell_params("gc2t_nn")
    sfu_rate = (torch.cuda.get_device_properties(dev).multi_processor_count
                * SFU_PER_CLK_SM * max_sm_clock_hz())
    for R in (128, 512):
        args = array_inputs(R, R, dev)
        kern = lambda: ops.gc_array_step(*args, 1e-11, p)
        plain = lambda: step_plain(*args, 1e-11, p)
        p1, k1 = time_ms(plain, 5), time_ms(kern, 20)
        k2, p2 = time_ms(kern, 20), time_ms(plain, 5)
        geom = ops.gc_array_step.last_geometry
        d = device_ms(kern, "gc_array_step_kernel", reps=10)
        bound, by = bound_of(*gc_work(R, R), PEAK_FLOPS[torch.float32])
        sfu = GC_TRANSCENDENTALS * R * R / sfu_rate * 1e3
        out[f"gc_array_step {R}x{R}"] = dict(
            ms=(k1 + k2) / 2, device_ms=d, plain_ms=(p1 + p2) / 2,
            library_ms=None, bound_ms=bound, bound_by=by, sfu_ms=sfu)
        log(f"time gc_array_step {R}x{R} ({geom.cols} columns x "
            f"{geom.row_groups} row groups, cluster {geom.cluster}, "
            f"{geom.blocks} blocks): kernel {k1!r} / {k2!r} ms, device "
            f"{d!r} ms, plain {p1!r} / {p2!r} ms, bound {bound!r} ms ({by}), "
            f"SFU floor {sfu!r} ms [{card}]")
    # the write path's 200 steps, warm, by events
    v_sn, v_bl, wwl, wbl, rwl = write_inputs(512, 512, dev)

    def write():
        sn, bl = v_sn, v_bl
        for _ in range(WRITE_STEPS):
            sn, bl = ops.gc_array_step(sn, bl, wwl, wbl, rwl, 1e-11, p)
    walls = [time_ms(write, 1, warm=1) for _ in range(3)]
    log(f"time array write {WRITE_STEPS} steps 512x512 warm (events): "
        f"{', '.join(repr(w) for w in walls)} ms [{card}]")
    return out


def time_paths(card) -> None:
    """Warm wall time of each counted compile and of the run_batch
    sweep."""
    from repro_torch.core.bank import BankConfig
    from repro_torch.core.compiler import compile_bank
    for cell in COMPILE_CELLS:
        for ws, nw in COMPILE_SIZES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compile_bank(BankConfig(ws, nw, cell=cell), simulate=True,
                         solver="pallas", device="cuda")
            torch.cuda.synchronize()
            log(f"time compile_bank {cell} {ws}x{nw} pallas warm: "
                f"{time.perf_counter() - t0!r} s [{card}]")
    tr, waves, over = batch_sweep_inputs("cuda")
    tr.run_batch(waves, 1e-9, BATCH_STEPS, over)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_batch(waves, 1e-9, BATCH_STEPS, over)
    torch.cuda.synchronize()
    log(f"time run_batch {BATCH_LANES} lanes x {BATCH_STEPS} steps pallas "
        f"warm: {time.perf_counter() - t0!r} s [{card}]")


# -- the serving path (flash-attention kernel)
SERVE_ARCH = "llama3.2-1b"
SERVE_SLOTS, SERVE_WINDOW, SERVE_CHUNK = 8, 2048, 8
SERVE_LENS = (128, 256, 512, 1024)      # four requests of each
SERVE_MAX_NEW = 64
# (B, Sq, Skv, H, K, hd, q_offset, kv_len): first the four prefill shapes
# the serve launches (each admission group holds the two prompts of one
# length, so B = 2 and Sq = Skv = the prompt length; timed), then B = 4 at
# S = 512 and B = 1 at S = 1024, a ragged Sq, a q_offset slice,
# kv_len < Skv, G = 1, G = 7 (qwen2-0.5b) and hd = 128 (llama3.2-3b)
SERVE_FLASH_SHAPES = tuple((2, n, n, 32, 8, 64, 0, None) for n in SERVE_LENS)
FLASH_SHAPES = SERVE_FLASH_SHAPES + (
    (4, 512, 512, 32, 8, 64, 0, None),
    (1, 1024, 1024, 32, 8, 64, 0, None),
    (2, 100, 100, 32, 8, 64, 0, None),
    (2, 32, 128, 4, 1, 16, 96, None),
    (1, 96, 128, 8, 2, 32, 0, 77),
    (2, 64, 64, 8, 8, 64, 0, None),
    (2, 200, 200, 14, 2, 64, 0, None),
    (2, 80, 80, 24, 8, 128, 0, None))
# the running max refreshed every chunk_kv keys, several chunks per row
# (the serve's prompts fit one 1024-key chunk): (shape, chunk_kv)
FLASH_CHUNKED = (((1, 300, 300, 8, 2, 64, 0, 250), 32),
                 ((1, 300, 300, 8, 2, 64, 0, 250), 40))
# the shapes the moe and hybrid serves launch, (B, Sq, Skv, H, K, hd,
# q_offset, kv_len, window): zamba2-2.7b's prefills (B = 2, hd = 80, H = K
# = 32) at its serve's four prompt lengths, and mixtral-8x7b's windowed
# prefill (hd = 128, H = 32, K = 8, a 5120-token prompt longer than its
# 4096-token window)
HYBRID_LENS = (128, 256, 512, 1024)
MOE_LENS = (256, 1024, 2048, 5120)
MOE_WINDOW = 4096
HYBRID_FLASH_SHAPES = tuple((2, n, n, 32, 32, 80, 0, None, 0)
                            for n in HYBRID_LENS)
MOE_FLASH_SHAPE = (2, 5120, 5120, 32, 8, 128, 0, None, MOE_WINDOW)
# head_dims padded inside the launch (8, 24, 72, 256), each with and
# without a window, with q_offset > 0 and kv_len < Skv; every row keeps a
# key in its window (a row with none is undefined), and chunk_kv 40 ends
# chunks inside key tiles
FLASH_NEW_CASES = tuple((shape, 1024) for shape in HYBRID_FLASH_SHAPES
                        + (MOE_FLASH_SHAPE,)) + (
    ((2, 300, 300, 8, 2, 8, 0, None, 0), 1024),
    ((2, 300, 300, 8, 2, 8, 20, 290, 100), 40),
    ((1, 200, 240, 8, 2, 24, 40, 230, 0), 40),
    ((1, 200, 240, 8, 2, 24, 40, 230, 64), 1024),
    ((2, 150, 180, 4, 4, 72, 20, 170, 0), 1024),
    ((2, 150, 180, 4, 4, 72, 20, 170, 33), 40),
    ((1, 256, 300, 4, 2, 256, 30, 290, 0), 1024),
    ((1, 256, 300, 4, 2, 256, 30, 290, 64), 40))
# the shapes the ssm, audio and vlm serves launch, (B, Sq, Skv, H, K, hd,
# q_offset, kv_len, window, causal): whisper-large-v3's prefills (B = 2,
# H = K = 20, hd = 64), its encoder self-attention over the 1500 frames
# and its cross-attention from each prompt length to them, both
# non-causal, and its decoder's causal self-attention; internvl2-1b's
# causal prefills over 256 patches and the prompt (H = 14, K = 2, G = 7);
# xlstm-1.3b launches none
XLSTM_LENS = (64, 128, 256, 512)
WHISPER_LENS = (32, 64, 128, 192)
# the decoder context of the published model (max_target_positions in
# openai/whisper-large-v3's config): prompt + 64 new tokens stay within it
WHISPER_CONTEXT = 448
WHISPER_FRAMES = 1500
VLM_LENS = (128, 256, 512, 1024)
VLM_PATCHES, VLM_WINDOW = 256, 2048
WHISPER_ENC_SHAPE = (2, WHISPER_FRAMES, WHISPER_FRAMES, 20, 20, 64, 0, None,
                     0, False)
WHISPER_CROSS_SHAPES = tuple((2, n, WHISPER_FRAMES, 20, 20, 64, 0, None, 0,
                              False) for n in WHISPER_LENS)
WHISPER_DEC_SHAPES = tuple((2, n, n, 20, 20, 64, 0, None, 0)
                           for n in WHISPER_LENS)
VLM_FLASH_SHAPES = tuple((2, VLM_PATCHES + n, VLM_PATCHES + n, 14, 2, 64, 0,
                          None, 0) for n in VLM_LENS)
# the first non-causal launches: the whisper shapes, and ragged ones
# (kv_len < Skv at the encoder shape; Sq != Skv with G = 4), at the
# model's chunk_kv (1500 keys run as 1024 + 476) and at one that ends
# inside a key tile
FLASH_NONCAUSAL_CASES = ((WHISPER_ENC_SHAPE, 1024),) + tuple(
    (shape, 1024) for shape in WHISPER_CROSS_SHAPES) + (
    ((2, WHISPER_FRAMES, WHISPER_FRAMES, 20, 20, 64, 0, 1391, 0, False), 1024),
    ((1, 100, 300, 8, 2, 64, 0, 250, 0, False), 40),
    ((2, 24, 150, 4, 4, 16, 0, None, 0, False), 64))
FLASH_11C_CASES = FLASH_NONCAUSAL_CASES + tuple(
    (shape, 1024) for shape in WHISPER_DEC_SHAPES + VLM_FLASH_SHAPES)
# the skip check: the bf16 kernel at mixtral's prefill shape with a
# 64-key window must take under this share of its time with none (it
# visits ~2 of 80 key tiles a row tile)
SKIP_WINDOW, SKIP_MAX_SHARE = 64, 0.25
# kernel vs plain: the reference's own limits (tests/test_kernels.py);
# bfloat16 also within FLASH_BF16_RTOL (4 units of bfloat16's 2^-8
# rounding) of the plain output's largest magnitude. That matters where
# many keys average the values down: at whisper's non-causal shapes
# (~1500 keys a query) max|o| is 0.20-0.66, below 3e-2 absolute a
# kernel could drop a tail key unseen; each non-causal case checks that
# the plain version without its last key lies outside the limit
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
FLASH_BF16_RTOL = 2.0 ** -6
# decode attention (csrc/decode_attention.cu) at the benchmark cell's
# shape: mixtral-8x7b's heads (K = 8, G = 4, hd = 128), 16 slots, the
# 12,336-row window of 12,288-token prompts and 48 new tokens; at full fill
# (every slot's window filled) and at a mixed fill (idle slots, 1k-12k
# rows, past the window); the check holds each slot within DECODE_BF16_RTOL
# of its largest plain output (FLASH_BF16_RTOL's 4 units of bf16
# rounding: a long slot's output averages down to a few hundredths)
DECODE_CELL = (16, 12336, 8, 128, 4)            # B, W, K, hd, G
DECODE_FILLS = {
    "full fill": (12335,) * 16,
    "mixed fill": (0, 1023, 3071, 12335, 0, 0, 16, 255, 256, 257, 4000,
                   12400, 5000, 0, 8191, 2047)}
DECODE_BF16_RTOL = 2.0 ** -6
# prefill logits through the kernel vs through the plain flash version,
# both bf16 on the card, relative to the logits' largest magnitude: the
# bf16 tolerance of the reference's kernel test
LOGITS_RTOL = 3e-2
CPU_LAYERS, CPU_PROMPTS, CPU_NEW = 2, 2, 16     # card vs CPU, float32
CPU_LENS = (96, 200)        # its prompts: two admission groups of B = 1
# the float32 kernel's shapes in that serve (timed, beside the full-width
# float32 serve's, which are SERVE_FLASH_SHAPES)
F32_FLASH_SHAPES = tuple((1, n, n, 32, 8, 64, 0, None) for n in CPU_LENS)
# every prefill shape is launched this often in one serve: two admission
# groups of each length, one launch per layer
SERVE_LAUNCHES_PER_SHAPE = 2 * 16
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak


def flash_inputs(shape, dtype, dev):
    B, Sq, Skv, H, K, hd = shape[:6]
    rng = np.random.default_rng(SEED + Sq + Skv + H + hd)
    return tuple(torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                 device=dev)
                 for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))


def flash_args(shape) -> tuple:
    """(q_offset, kv_len, window, causal) of a shape tuple, window 0 and
    causal True when it has none."""
    return (shape[6], shape[7], shape[8] if len(shape) > 8 else 0,
            shape[9] if len(shape) > 9 else True)


def flash_work(shape, itemsize: int) -> tuple:
    """(bytes, operations) of one flash-attention launch: Q, K and V read
    once and O written once; 4 * hd operations (QK and PV multiply-adds)
    per head and unmasked (query, key) pair: below kv_len, at or before
    the query when causal (a non-causal launch counts Sq * kv_len pairs),
    and inside the window when there is one."""
    B, Sq, Skv, H, K, hd = shape[:6]
    off, kv_len, window, causal = flash_args(shape)
    kv_len = Skv if kv_len is None else kv_len
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Skv * K * hd)
    pairs = sum(max(0, (min(kv_len, off + i + 1) if causal else kv_len)
                    - (max(0, off + i - window + 1) if window else 0))
                for i in range(Sq))
    return nbytes, 4 * B * H * hd * pairs


def flash_counts(noncausal: bool = False) -> dict:
    """Launches so far of each flash-attention kernel, by the dtype it
    serves; with `noncausal`, only those with causal = 0."""
    from repro_torch.kernels.flash_attention import kernel
    key = "noncausal_launches" if noncausal else "launches"
    return {torch.bfloat16: getattr(kernel.flash_attention_tc, key),
            torch.float32: getattr(kernel.flash_attention_f32, key)}


def decode_launches() -> int:
    """Launches so far of the decode-attention kernel."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    return decode_attention.launches


def decode_per_step(cfg) -> int:
    """Decode-attention launches of one decode step: one per attention
    layer's self-attention over the cache (hybrid: one per application of
    the shared block; audio: its decoder layers, whose cross-attention is
    plain torch; ssm: none)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def flash_limit(dtype, want) -> float:
    """The limit of |kernel - plain| for the plain output `want`:
    FLASH_ATOL, and for bfloat16 at most FLASH_BF16_RTOL * max|want|."""
    if dtype != torch.bfloat16:
        return FLASH_ATOL[dtype]
    return min(FLASH_ATOL[dtype],
               FLASH_BF16_RTOL * float(want.float().abs().max()))


def check_flash_attention(dev) -> dict:
    """Both flash-attention kernels against the plain version on the card
    at `FLASH_SHAPES`, `FLASH_CHUNKED`, `FLASH_NEW_CASES` (the moe and
    hybrid serves' shapes, padded head_dims, windows) and `FLASH_11C_CASES`
    (the audio and vlm serves' shapes, non-causal first): bfloat16 through
    the tensor-core kernel, float32 through the float32 kernel, each call
    launching the kernel of its dtype once (counted as non-causal iff the
    case is) and the other not at all, within `flash_limit`, which a
    non-causal case's plain version without its last key must exceed;
    then the skip check. Returns the
    largest error by dtype, and by dtype over the non-causal cases under
    the key (dtype, "noncausal")."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    worst = {}
    cases = ([(shape, 1024) for shape in FLASH_SHAPES] + list(FLASH_CHUNKED)
             + list(FLASH_NEW_CASES) + list(FLASH_11C_CASES))
    for dtype in FLASH_ATOL:
        other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
        name = ("flash_attention_tc" if dtype == torch.bfloat16
                else "flash_attention")
        worst[dtype] = worst[dtype, "noncausal"] = 0.0
        for shape, chunk_kv in cases:
            q, k, v = flash_inputs(shape, dtype, dev)
            off, kv_len, window, causal = flash_args(shape)
            before = flash_counts()
            nc_before = flash_counts(noncausal=True)
            got = flash_attention_fwd(q, k, v, off, kv_len=kv_len,
                                      window=window, chunk_kv=chunk_kv,
                                      causal=causal)
            after = flash_counts()
            nc_after = flash_counts(noncausal=True)
            want = flash_attention_plain(q, k, v, q_offset=off,
                                         kv_len=kv_len, window=window,
                                         chunk_kv=chunk_kv, causal=causal)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            atol = flash_limit(dtype, want)
            moved, note = None, ""
            if not causal:
                short = flash_attention_plain(
                    q, k, v, q_offset=off, kv_len=(kv_len or shape[2]) - 1,
                    window=window, chunk_kv=chunk_kv, causal=False)
                moved = float((short.float() - want.float()).abs().max())
                note = (f" (non-causal; the last key left out moves the "
                        f"plain output by {moved!r})")
            routed = (after[dtype] == before[dtype] + 1
                      and after[other] == before[other]
                      and nc_after[dtype] - nc_before[dtype] == (not causal))
            ok = (routed and got.dtype == dtype
                  and bool(torch.isfinite(got).all()) and err <= atol
                  and (moved is None or moved > atol))
            log(f"check {name} {str(dtype)[6:]} (B, Sq, Skv, H, K, hd, "
                f"q_offset, kv_len[, window[, causal]]) = {shape}, chunk_kv "
                f"{chunk_kv}: max|do| "
                f"vs plain {err!r} (limit {atol!r}), "
                f"{'one launch' if routed else 'WRONG KERNEL'}"
                f"{note} "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"flash_attention check {shape} failed")
            worst[dtype] = max(worst[dtype], err)
            if not causal:
                worst[dtype, "noncausal"] = max(worst[dtype, "noncausal"],
                                                err)
    # a key tile wholly before every query's window is skipped: at
    # mixtral's prefill shape a 64-key window leaves ~2 of 80 tiles a row
    q, k, v = flash_inputs(MOE_FLASH_SHAPE, torch.bfloat16, dev)
    full = time_ms(lambda: flash_attention_fwd(q, k, v), 10)
    narrow = time_ms(lambda: flash_attention_fwd(q, k, v,
                                                 window=SKIP_WINDOW), 10)
    ok = narrow <= SKIP_MAX_SHARE * full
    log(f"check flash_attention_tc tile skipping at {MOE_FLASH_SHAPE[:6]}: "
        f"window {SKIP_WINDOW} {narrow!r} ms against no window {full!r} ms "
        f"(share {narrow / full!r}, limit {SKIP_MAX_SHARE}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("flash_attention_tc does not skip tiles outside "
                           "the window")
    return worst


def decode_inputs(positions, dev, shape=DECODE_CELL):
    """q (B, 1, H, hd) and the caches (B, W, K, hd) in bf16, every row
    drawn (rows past a fill hold values the kernel must not read), and
    pos (B,) int32 on the card."""
    B, W, K, hd, G = shape
    rng = np.random.default_rng(SEED + W)
    q = torch.as_tensor(rng.standard_normal((B, 1, K * G, hd)),
                        dtype=torch.bfloat16, device=dev)
    ck, cv = (torch.as_tensor(rng.standard_normal((B, W, K, hd)),
                              dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    return q, ck, cv, torch.tensor(positions, dtype=torch.int32, device=dev)


def decode_bytes(q, ck, pos) -> int:
    """The least bytes one decode-attention call moves: every filled row's
    K and V once (filled rows x K x hd x 2 x itemsize), q read and o
    written."""
    from repro_torch.kernels.decode_attention.kernel import filled_rows
    W, K, hd = ck.shape[1:]
    rows = int(filled_rows(pos, W).sum())
    return (rows * K * hd * 2 * ck.element_size()
            + 2 * q.numel() * q.element_size())


def check_decode_attention(dev) -> float:
    """The decode-attention kernel against its plain version on the card
    at the cell's shape, full and mixed fill: one launch a call, each slot
    within DECODE_BF16_RTOL of its largest plain output. Returns the
    largest error."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention, decode_attention_plain)
    worst = 0.0
    for label, positions in DECODE_FILLS.items():
        q, ck, cv, pos = decode_inputs(positions, dev)
        before = decode_attention.launches
        got = decode_attention(q, ck, cv, pos)
        launched = decode_attention.launches - before
        want = decode_attention_plain(q, ck, cv, pos)
        torch.cuda.synchronize()
        B = q.shape[0]
        gap = (got.float() - want.float()).abs().reshape(B, -1).amax(1)
        limit = DECODE_BF16_RTOL * want.float().abs().reshape(B, -1).amax(1)
        ok = (launched == 1 and bool(torch.isfinite(got).all())
              and bool((gap <= limit).all()))
        log(f"check decode_attention bf16 {label} (B, W, K, hd, G) = "
            f"{DECODE_CELL}: max|do| vs plain {float(gap.max())!r}, worst "
            f"slot at {float((gap / limit).max())!r} of its limit (limits "
            f"{float(limit.min())!r}..{float(limit.max())!r}), launches "
            f"{launched} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"decode_attention check {label} failed")
        worst = max(worst, float(gap.max()))
    return worst


def time_decode_attention(dev, card) -> dict:
    """The decode-attention kernel at the cell's shape, full and mixed
    fill: CUDA events (plain, kernel, SDPA, kernel, plain, SDPA in turns),
    profiler device time (the split kernel and, past one split, the
    combine), the byte bound at 3.35 TB/s and its share of the device
    time, the plain version and, as `library_ms`, SDPA with a mask of the
    filled rows (the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention, decode_attention_plain, filled_rows)
    out = {}
    for label, positions in DECODE_FILLS.items():
        q, ck, cv, pos = decode_inputs(positions, dev)
        W = ck.shape[1]
        kern = lambda: decode_attention(q, ck, cv, pos)
        plain = lambda: decode_attention_plain(q, ck, cv, pos)
        qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
        mask = (torch.arange(W, device=dev)[None]
                < filled_rows(pos, W)[:, None])[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        p1, k1, l1 = time_ms(plain, 5), time_ms(kern, 50), time_ms(lib, 10)
        k2, p2, l2 = time_ms(kern, 50), time_ms(plain, 5), time_ms(lib, 10)
        split = device_ms(kern, "decode_attention_kernel", reps=20)
        combine = device_ms(kern, "decode_attention_combine", reps=20)
        d = None if split is None or combine is None else split + combine
        nbytes = decode_bytes(q, ck, pos)
        bound = nbytes / HBM_BYTES_S * 1e3
        ms = (k1 + k2) / 2
        out[label] = dict(ms=ms, device_ms=d, split_ms=split,
                          combine_ms=combine, plain_ms=(p1 + p2) / 2,
                          library_ms=(l1 + l2) / 2, bound_ms=bound,
                          bound_by="bytes", bytes=nbytes,
                          roofline=None if d is None else bound / d)
        log(f"time decode_attention bf16 {label} (B, W, K, hd, G) = "
            f"{DECODE_CELL}, {int(filled_rows(pos, W).sum())} filled rows: "
            f"kernel {k1!r} / {k2!r} ms, device {d!r} ms (split {split!r}, "
            f"combine {combine!r}), plain {p1!r} / {p2!r} ms, "
            f"scaled_dot_product_attention {l1!r} / {l2!r} ms, bound "
            f"{bound!r} ms ({nbytes} bytes at 3.35 TB/s), "
            f"{out[label]['roofline']!r} of it [{card}]")
    return out


def serve_requests(vocab: int, lens=SERVE_LENS):
    """The serve workload: 16 requests, four of each prompt length in
    `lens` (seeded random tokens), 64 new tokens each; odd rids sample at
    temperature 0.7 with top_k 40, even rids are greedy."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(4 * len(lens)):
        n = lens[i % len(lens)]
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
            max_new_tokens=SERVE_MAX_NEW, temperature=0.7 if i % 2 else 0.0,
            top_k=40))
    return reqs


def counted() -> dict:
    """Every kernel wrapper's launch counter, by name."""
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.gc_array_step import ops
    return {"fused_newton": fused.fused_newton,
            "fused_newton_scan": fused.fused_newton_scan,
            "gauss_jordan": batched_solve,
            "gc_array_step": ops.gc_array_step,
            "flash_attention_tc": kernel.flash_attention_tc,
            "flash_attention_f32": kernel.flash_attention_f32,
            "decode_attention": decode_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0
        if hasattr(fn, "noncausal_launches"):
            fn.noncausal_launches = 0


def run_engine(model, cfg, mode: str, lens=SERVE_LENS, window=SERVE_WINDOW):
    """Serve the workload (prompts of `lens`) once; returns (engine, {rid:
    tokens}, wall s)."""
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, model, n_slots=SERVE_SLOTS, window=window,
                      mode=mode, decode_chunk=SERVE_CHUNK, seed=SEED)
    for r in serve_requests(cfg.vocab_size, lens):
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, _ = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, {r.rid: list(r.out_tokens) for r in done}, wall


class PhaseEvents:
    """Records a pair of CUDA events around each `Model.prefill` and
    `Model.decode_loop` call of a serve, without synchronizing, so that
    the serve's own prefill and decode spans can be read on the device's
    clock after it (idle gaps inside a call, while the device waits for
    the host to enqueue, count to that call's phase)."""

    def __init__(self, model):
        self.model = model
        self.pairs = {"prefill": [], "decode_loop": []}
        # per prefill dispatch: (B, S, tensor-core and float32 flash
        # launches it made, and of those the non-causal ones, both kernels)
        self.prefills = []
        # per decode chunk: (steps, decode-attention launches it made)
        self.decodes = []

    def __enter__(self):
        for name, pairs in self.pairs.items():
            fn = getattr(self.model, name)

            def timed(*args, _fn=fn, _pairs=pairs, _name=name, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                before = flash_counts()
                nc_before = sum(flash_counts(noncausal=True).values())
                da_before = decode_launches()
                start.record()
                out = _fn(*args, **kwargs)
                end.record()
                _pairs.append((start, end))
                if _name == "decode_loop":
                    self.decodes.append((kwargs["n_tokens"],
                                         decode_launches() - da_before))
                if _name == "prefill":
                    after = flash_counts()
                    B, S = args[0]["tokens"].shape
                    self.prefills.append(
                        (B, S, after[torch.bfloat16] - before[torch.bfloat16],
                         after[torch.float32] - before[torch.float32],
                         sum(flash_counts(noncausal=True).values())
                         - nc_before))
                return out
            setattr(self.model, name, timed)
        return self

    def __exit__(self, *exc):
        for name in self.pairs:
            delattr(self.model, name)

    def ms(self, name: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs[name])


def frontend_batch(cfg, B: int, dev, seed: int) -> dict:
    """Seeded standard-normal inputs of the stub frontends, in the working
    dtype: the audio family's frames (B, enc_frames, d), the vlm family's
    patches (B, n_patches, d) (tests/test_smoke_archs.py's make_batch
    draws them so); none for the other families. The engine feeds zeros,
    which would make every encoder row alike."""
    from repro_torch.models.common import dtype_of
    name, n = {"audio": ("frames", cfg.enc_frames),
               "vlm": ("patches", cfg.n_patches)}.get(cfg.family, (None, 0))
    if name is None:
        return {}
    rng = np.random.default_rng(seed)
    return {name: torch.as_tensor(rng.standard_normal((B, n, cfg.d_model)),
                                  dtype=dtype_of(cfg), device=dev)}


def prefill_logits_vs_plain(model, cfg, dev, n: int,
                            window=SERVE_WINDOW) -> tuple:
    """Prefill logits of two n-token prompts (one admission group of the
    serve, with seeded frames or patches for the audio and vlm families)
    through the kernel and through the plain flash version, on the
    card."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import attention
    rng = np.random.default_rng(SEED + n)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, n)),
                           dtype=torch.int32, device=dev)
    batch = {"tokens": toks, **frontend_batch(cfg, 2, dev, SEED + 7 * n)}
    got, _, _ = model.prefill(batch, W=window)
    kernel_path = attention.flash_attention
    attention.flash_attention = (
        lambda q, k, v, **kw: flash_attention_plain(q, k, v, **kw))
    try:
        want, _, _ = model.prefill(batch, W=window)
    finally:
        attention.flash_attention = kernel_path
    torch.cuda.synchronize()
    return (float((got - want).abs().max()), float(want.abs().max()),
            bool(torch.isfinite(got).all()))


def serve_path(model, cfg, dev, card) -> dict:
    """The serving path at full width, counted: `llama3.2-1b` in bf16 with
    seeded weights, 16 requests through `ServeEngine` in device mode with
    the launch counters set to 0 just before the run and read just after;
    then the same workload in host mode (which also warms the timed run),
    once more in device mode with its prefill and decode spans timed by
    `PhaseEvents`, and the prefill logits through the kernel against the
    plain flash version at each of the serve's prefill shapes. Every
    prefill attention of the counted run goes through the bf16 tensor-core
    kernel, none through the float32 one."""
    reset_counts()
    eng, streams, wall = run_engine(model, cfg, "device")
    counts = flash_counts()
    launches, f32_launches = counts[torch.bfloat16], counts[torch.float32]
    prefills = eng.admit_syncs
    want = cfg.n_layers * prefills
    ok = (launches == want and f32_launches == 0
          and len(streams) == 4 * len(SERVE_LENS)
          and all(len(t) == SERVE_MAX_NEW for t in streams.values())
          and all(0 <= x < cfg.vocab_size for t in streams.values()
                  for x in t))
    log(f"serve path: {len(streams)} requests, "
        f"{sum(map(len, streams.values()))} tokens in {wall:.2f} s (first "
        f"run), {prefills} prefill dispatches, {eng.host_syncs} host syncs, "
        f"flash_attention_tc launches {launches} (expected {want}), float32 "
        f"flash_attention launches {f32_launches} (expected 0) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("serve path counts or budgets")
    _, host, _ = run_engine(model, cfg, "host")
    greedy = [rid for rid in streams if rid % 2 == 0]
    same = all(streams[rid] == host[rid] for rid in greedy)
    log(f"serve path: greedy streams device vs host mode on the card: "
        f"{'equal' if same else 'DIFFER'} ({len(greedy)} streams)")
    if not same:
        raise RuntimeError("serve path device vs host greedy streams")

    # the warm serve, timed: wall on the host's clock, and the prefill and
    # decode rates from this serve's own spans
    with PhaseEvents(model) as phases:
        eng, timed, wall = run_engine(model, cfg, "device")
    pre_ms, dec_ms = phases.ms("prefill"), phases.ms("decode_loop")
    n_prompt = sum(len(r.prompt) for r in serve_requests(cfg.vocab_size))
    n_new = sum(map(len, timed.values()))
    n_decoded = n_new - len(timed)        # the first tokens come of prefill
    if timed != streams:
        raise RuntimeError("the timed serve's streams differ from the "
                           "counted run's")
    times = dict(wall_s=wall, host_syncs=eng.host_syncs, tokens=n_new,
                 prefill_ms=pre_ms, decode_ms=dec_ms,
                 prefill_tok_s=n_prompt / (pre_ms / 1e3),
                 decode_tok_s=n_decoded / (dec_ms / 1e3))
    log(f"time serve {cfg.name} bf16 warm: {len(timed)} requests, "
        f"{n_prompt} prompt + {n_new} generated tokens in {wall!r} s "
        f"({n_new / wall!r} generated tok/s), {eng.host_syncs} host syncs; "
        f"prefill spans {pre_ms!r} ms over {len(phases.pairs['prefill'])} "
        f"dispatches ({times['prefill_tok_s']!r} prompt tok/s); decode "
        f"spans {dec_ms!r} ms over {len(phases.pairs['decode_loop'])} "
        f"chunks ({times['decode_tok_s']!r} tok/s for the {n_decoded} "
        f"tokens emitted by decode) [{card}]")

    check_prefill_logits(model, cfg, dev, LOGITS_RTOL, "bf16")
    return {"launches": launches, "prefills": prefills,
            "n_layers": cfg.n_layers, "times": times}


def check_prefill_logits(model, cfg, dev, rtol: float, label: str,
                         lens=SERVE_LENS, window=SERVE_WINDOW) -> float:
    """Prefill logits through the kernel against the plain flash version
    at each of `lens`, within `rtol` of the largest logit; returns the
    largest relative error."""
    worst = 0.0
    for n in lens:
        err, scale, finite = prefill_logits_vs_plain(model, cfg, dev, n,
                                                     window)
        ok = finite and err <= rtol * scale
        log(f"serve path {label}: prefill logits (2 x {n} tokens) kernel vs "
            f"plain flash on the card: max|d| {err!r} (limit {rtol} x "
            f"{scale!r}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"serve path {label} prefill logits at {n} "
                               f"tokens")
        worst = max(worst, err / scale)
    return worst


def serve_kernel_ms(model, cfg, kernel_name: str) -> tuple:
    """One more device-mode serve of the workload under the profiler:
    (summed device ms, count) of the kernels whose name holds
    `kernel_name`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_engine(model, cfg, "device")
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and kernel_name in ev.key:
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
            count += ev.count
    return total_us / 1e3, count


def serve_path_f32(dev, card) -> dict:
    """The float32 serving path at full width, counted: `llama3.2-1b` at
    its 16 layers and published widths in float32 with seeded weights
    (TF32 off), the bf16 serve's 16 requests through the same
    `ServeEngine` in device mode, with the launch counters set to 0 just
    before the run and read just after: every prefill attention goes
    through the float32 flash-attention kernel, none through the
    tensor-core one, and every request emits its budget. Then a warm serve
    timed (wall, and its prefill and decode spans by `PhaseEvents`), one
    more under the profiler for the float32 kernel's device ms per serve,
    and the prefill logits through the kernel against the plain flash
    version at each prefill shape, within the float32 kernel limit of the
    largest logit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="float32")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    log(f"serve path float32: {cfg.name} {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}, {model.param_count()} weights, seeded "
        f"init on the card in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    eng, streams, wall = run_engine(model, cfg, "device")
    counts = flash_counts()
    launches, tc_launches = counts[torch.float32], counts[torch.bfloat16]
    prefills = eng.admit_syncs
    want = cfg.n_layers * prefills
    ok = (launches == want and tc_launches == 0
          and len(streams) == 4 * len(SERVE_LENS)
          and all(len(t) == SERVE_MAX_NEW for t in streams.values())
          and all(0 <= x < cfg.vocab_size for t in streams.values()
                  for x in t))
    log(f"serve path float32: {len(streams)} requests, "
        f"{sum(map(len, streams.values()))} tokens in {wall:.2f} s (first "
        f"run), {prefills} prefill dispatches, float32 flash_attention "
        f"launches {launches} (expected {want}), flash_attention_tc "
        f"launches {tc_launches} (expected 0) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("float32 serve path counts or budgets")

    with PhaseEvents(model) as phases:
        eng, timed, wall = run_engine(model, cfg, "device")
    pre_ms, dec_ms = phases.ms("prefill"), phases.ms("decode_loop")
    if timed != streams:
        raise RuntimeError("the timed float32 serve's streams differ from "
                           "the counted run's")
    flash_ms, flash_n = serve_kernel_ms(model, cfg, "flash_attention_kernel")
    n_prompt = sum(len(r.prompt) for r in serve_requests(cfg.vocab_size))
    n_new = sum(map(len, timed.values()))
    n_decoded = n_new - len(timed)
    times = dict(wall_s=wall, tokens=n_new, prefill_ms=pre_ms,
                 decode_ms=dec_ms, prefill_tok_s=n_prompt / (pre_ms / 1e3),
                 decode_tok_s=n_decoded / (dec_ms / 1e3),
                 flash_device_ms=flash_ms if flash_n == want else None)
    log(f"time serve {cfg.name} float32 warm: {len(timed)} requests, "
        f"{n_prompt} prompt + {n_new} generated tokens in {wall!r} s "
        f"({n_new / wall!r} generated tok/s); prefill spans {pre_ms!r} ms "
        f"({times['prefill_tok_s']!r} prompt tok/s); decode spans "
        f"{dec_ms!r} ms ({times['decode_tok_s']!r} tok/s); float32 flash "
        f"kernel device time {flash_ms!r} ms over {flash_n} launches per "
        f"serve (profiler; expected {want} launches) [{card}]")
    worst = check_prefill_logits(model, cfg, dev, FLASH_ATOL[torch.float32],
                                 "float32")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "prefills": prefills,
            "n_layers": cfg.n_layers, "times": times, "logits_rel": worst}


def serve_cpu_parity(dev) -> int:
    """`llama3.2-1b` widths at float32 with 2 layers: weights made on the
    CPU and moved to the card; greedy streams of 2 prompts x 16 tokens on
    the card must equal the CPU run's. TF32 is off for the card's float32
    products. The card's run is counted: every prefill attention goes
    through the float32 flash-attention kernel. Returns its launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=CPU_LAYERS,
                              dtype="float32")
    cpu = Model(cfg, device="cpu", seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in CPU_LENS]
    card = copy.deepcopy(cpu).to(dev)
    streams = []
    for model in (cpu, card):
        eng = ServeEngine(cfg, model, n_slots=CPU_PROMPTS, window=256,
                          decode_chunk=SERVE_CHUNK, seed=SEED)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=CPU_NEW))
        if model is card:
            reset_counts()
        done, _ = eng.run()
        streams.append({r.rid: r.out_tokens for r in done})
    counts = flash_counts()
    launches, tc_launches = counts[torch.float32], counts[torch.bfloat16]
    want = CPU_LAYERS * eng.admit_syncs
    same = streams[0] == streams[1] and all(
        len(t) == CPU_NEW for t in streams[0].values())
    log(f"serve card vs CPU: {cfg.name} widths, {CPU_LAYERS} layers, float32,"
        f" {CPU_PROMPTS} prompts x {CPU_NEW} greedy tokens: "
        f"{'equal' if same else 'DIFFER'}; float32 flash_attention launches "
        f"{launches} (expected {want}), flash_attention_tc launches "
        f"{tc_launches} (expected 0)")
    if not same:
        raise RuntimeError("serve card vs CPU greedy streams")
    if launches != want or tc_launches != 0:
        raise RuntimeError("serve card vs CPU flash launch counts")
    return launches


# -- the moe and hybrid families and the int8 KV cache
# mixtral-8x7b at its published widths, its depth cut to 8 of 32 layers
# (~11.9e9 seeded bf16 weights, ~24 GB; all 32 would be ~93 GB, more than
# the card holds); its ring cache is its 4096-token window
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_LOGITS_LENS = (1024, 5120)      # one group inside the window, one past
# zamba2-2.7b at full width and depth (54 Mamba2 layers, 9 applications
# of the shared attention block): 2,422,532,000 weights, the reference's
# param_count()
HYBRID_ARCH, HYBRID_WINDOW = "zamba2-2.7b", 2048
HYBRID_WEIGHTS = 2_422_532_000
# card vs CPU at the reduced configs in float32 (hd = 16): (arch, config
# overrides, prompt lengths); reduced mixtral's window is 32, so its
# 40-token prompts seed the ring with S > W and decode wraps it
FAMILY_CPU_CASES = (("mixtral-8x7b", {}, (40, 40, 36)),
                    ("zamba2-2.7b", {}, (24, 24, 40)),
                    ("llama3.2-1b", {"kv_dtype": "int8"}, (12, 12, 20)))
FAMILY_CPU_NEW = 16
FAMILY_LOGITS_RTOL = 2e-5   # card vs CPU prefill logits, float32


def flash_per_dispatch(cfg) -> int:
    """Flash launches of one prefill dispatch: one per attention layer
    (hybrid: one per application of the shared block; audio: one per
    encoder layer and two per decoder layer, its self-attention and its
    cross-attention; ssm: none)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def noncausal_per_dispatch(cfg) -> int:
    """Of those, the non-causal launches: the audio family's encoder
    layers and cross-attentions."""
    return (cfg.n_enc_layers + cfg.n_layers if cfg.family == "audio"
            else 0)


def serve_family(model, cfg, lens, window, label, card,
                 host: bool = False) -> dict:
    """One serve at full width, counted: the 16-request workload with
    prompts of `lens` through `ServeEngine(n_slots=8, window, decode_chunk=
    8)` in device mode, with the launch counters set to 0 just before the
    run and read just after: every prefill dispatch launches
    `flash_per_dispatch(cfg)` tensor-core kernels, of them
    `noncausal_per_dispatch(cfg)` non-causal, and no float32 one, and
    every request emits its budget; the launches of dispatches whose
    prompts are longer than the sliding window are counted apart. With
    `host`, the greedy streams equal a host-mode serve's. Then a warm
    serve timed (wall, prefill and decode spans by `PhaseEvents`), with
    the counted run's streams."""
    per, per_nc = flash_per_dispatch(cfg), noncausal_per_dispatch(cfg)
    per_step = decode_per_step(cfg)
    reset_counts()
    with PhaseEvents(model) as counted_run:
        eng, streams, first = run_engine(model, cfg, "device", lens, window)
    counts = flash_counts()
    nc = flash_counts(noncausal=True)
    prefills = eng.admit_syncs
    W = cfg.sliding_window
    windowed = sum(tc for _, S, tc, _, _ in counted_run.prefills
                   if W and S > W)
    n_long = sum(1 for _, S, _, _, _ in counted_run.prefills if W and S > W)
    steps = sum(n for n, _ in counted_run.decodes)
    decoded = sum(d for _, d in counted_run.decodes)
    ok = (counts[torch.bfloat16] == per * prefills
          and steps > 0 and all(d == per_step * n
                                for n, d in counted_run.decodes)
          and counts[torch.float32] == 0
          and nc[torch.bfloat16] == per_nc * prefills
          and len(counted_run.prefills) == prefills
          and all(tc == per and f32 == 0 and n == per_nc
                  for _, _, tc, f32, n in counted_run.prefills)
          and windowed == per * n_long and (n_long > 0) == (W > 0)
          and len(streams) == 4 * len(lens)
          and all(len(t) == SERVE_MAX_NEW for t in streams.values())
          and all(0 <= x < cfg.vocab_size for t in streams.values()
                  for x in t))
    log(f"serve path {label}: {cfg.name}, {len(streams)} requests (prompts "
        f"{lens}), {sum(map(len, streams.values()))} tokens in {first:.2f} "
        f"s (first run), {prefills} prefill dispatches (B, S) "
        f"{[(b, n) for b, n, _, _, _ in counted_run.prefills]}, "
        f"flash_attention_tc launches {counts[torch.bfloat16]} (expected "
        f"{per} x {prefills})"
        + (f", of which non-causal {nc[torch.bfloat16]} (expected {per_nc} "
           f"x {prefills}) and causal {counts[torch.bfloat16] - nc[torch.bfloat16]}"
           if per_nc else "")
        + (f", of which past the {W}-token window {windowed} (expected "
           f"{per} x {n_long})" if W else "")
        + f", float32 flash_attention launches {counts[torch.float32]} "
        f"(expected 0), decode_attention launches {decoded} over {steps} "
        f"decode steps in {len(counted_run.decodes)} chunks "
        f"({decoded / steps!r} a step, expected {per_step}), every request "
        f"{SERVE_MAX_NEW} tokens {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"serve path {label} counts or budgets")
    if host:
        _, hosted, _ = run_engine(model, cfg, "host", lens, window)
        greedy = [rid for rid in streams if rid % 2 == 0]
        same = all(streams[rid] == hosted[rid] for rid in greedy)
        log(f"serve path {label}: greedy streams device vs host mode on the "
            f"card: {'equal' if same else 'DIFFER'} ({len(greedy)} streams)")
        if not same:
            raise RuntimeError(f"serve path {label} device vs host greedy "
                               f"streams")
    with PhaseEvents(model) as phases:
        eng, timed, wall = run_engine(model, cfg, "device", lens, window)
    if timed != streams:
        raise RuntimeError(f"the timed {label} serve's streams differ from "
                           f"the counted run's")
    pre_ms, dec_ms = phases.ms("prefill"), phases.ms("decode_loop")
    n_prompt = sum(len(r.prompt) for r in serve_requests(cfg.vocab_size,
                                                         lens))
    n_new = sum(map(len, timed.values()))
    n_decoded = n_new - len(timed)
    times = dict(wall_s=wall, tokens=n_new, host_syncs=eng.host_syncs,
                 prefill_ms=pre_ms, decode_ms=dec_ms,
                 prefill_tok_s=n_prompt / (pre_ms / 1e3),
                 decode_tok_s=n_decoded / (dec_ms / 1e3))
    log(f"time serve {cfg.name} {label} warm: {len(timed)} requests, "
        f"{n_prompt} prompt + {n_new} generated tokens in {wall!r} s "
        f"({n_new / wall!r} generated tok/s), {eng.host_syncs} host syncs; "
        f"prefill spans {pre_ms!r} ms over {len(phases.pairs['prefill'])} "
        f"dispatches ({times['prefill_tok_s']!r} prompt tok/s); decode "
        f"spans {dec_ms!r} ms over {len(phases.pairs['decode_loop'])} "
        f"chunks ({times['decode_tok_s']!r} tok/s for the {n_decoded} "
        f"tokens emitted by decode) [{card}]")
    return {"launches": counts[torch.bfloat16], "prefills": prefills,
            "per_dispatch": per, "windowed": windowed,
            "noncausal": nc[torch.bfloat16], "times": times,
            "decode_launches": decoded, "decode_steps": steps}


def int8_path(model, cfg, dev, card, bf16_times) -> dict:
    """The bf16 llama3.2-1b serve again with `kv_dtype="int8"`: the same
    seeded weights; prefill logits equal to the bf16 model's at each
    prompt length (the cache is quantized after prefill); then the serve,
    counted and timed as `serve_family` does, its wall and decode rate
    beside the bf16 serve's."""
    from repro_torch.models.model import Model
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    model8 = Model(cfg8, device=dev, seed=SEED)
    same_w = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                   model8.parameters()))
    equal = []
    for n in SERVE_LENS:
        rng = np.random.default_rng(SEED + n)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, n)),
                               dtype=torch.int32, device=dev)
        want, _, _ = model.prefill({"tokens": toks}, W=SERVE_WINDOW)
        got, cache, _ = model8.prefill({"tokens": toks}, W=SERVE_WINDOW)
        equal.append(bool(torch.equal(got, want))
                     and cache["k"].dtype == torch.int8
                     and cache["ksc"].dtype == torch.bfloat16)
    log(f"serve path int8: {cfg.name} with kv_dtype int8, same weights "
        f"{same_w}; prefill logits equal to the bf16 model's at "
        f"{SERVE_LENS}: {equal}; int8 cache with bf16 scales")
    if not (same_w and all(equal)):
        raise RuntimeError("int8 serve path prefill logits")
    served = serve_family(model8, cfg8, SERVE_LENS, SERVE_WINDOW, "int8",
                          card)
    t = served["times"]
    log(f"time serve {cfg.name} int8 KV against bf16 KV (warm, the same "
        f"workload): wall {t['wall_s']!r} s against {bf16_times['wall_s']!r}"
        f" s; decode {t['decode_tok_s']!r} tok/s against "
        f"{bf16_times['decode_tok_s']!r} tok/s [{card}]")
    del model8
    torch.cuda.empty_cache()
    return served


def moe_path(dev, card) -> dict:
    """The moe serve: mixtral-8x7b at its published widths, depth cut to
    `MOE_LAYERS`, bf16 seeded weights, the 16 requests of `MOE_LENS`
    (the 5120-token prompts put the window mask into the prefill kernel,
    seed the ring with S > W and decode past its wrap) through
    `serve_family`; then prefill logits through the kernel against the
    plain flash version at `MOE_LOGITS_LENS`."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    log(f"serve path moe: {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
        f"{cfg.hd()}, d_ff {cfg.d_ff}, {cfg.n_experts} experts top "
        f"{cfg.top_k}, window {cfg.sliding_window}), depth cut to "
        f"{cfg.n_layers} of {full.n_layers} layers: {model.param_count()} "
        f"bf16 weights ({model.param_count(active_only=True)} active), "
        f"seeded init on the card in {time.perf_counter() - t0:.2f} s")
    served = serve_family(model, cfg, MOE_LENS, MOE_WINDOW, "moe", card)
    served["logits_rel"] = check_prefill_logits(
        model, cfg, dev, LOGITS_RTOL, "moe bf16", lens=MOE_LOGITS_LENS,
        window=MOE_WINDOW)
    del model
    torch.cuda.empty_cache()
    return served


def plain_schedules_gap(model, dev, n: int, window: int) -> tuple:
    """Prefill logits of two n-token prompts through the plain flash
    version at its default schedule and at chunk_kv 64, on the card:
    (max |difference|, largest logit). Both are the same function; what
    separates them is bf16 rounding, as it separates kernel and plain."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import attention
    rng = np.random.default_rng(SEED + n)
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (2, n)),
                           dtype=torch.int32, device=dev)
    batch = {"tokens": toks,
             **frontend_batch(model.cfg, 2, dev, SEED + 7 * n)}
    kernel_path = attention.flash_attention
    outs = []
    try:
        for chunk_kv in (1024, 64):
            attention.flash_attention = (
                lambda q, k, v, _c=chunk_kv, **kw: flash_attention_plain(
                    q, k, v, **{**kw, "chunk_kv": _c}))
            outs.append(model.prefill(batch, W=window)[0])
    finally:
        attention.flash_attention = kernel_path
    return (float((outs[0] - outs[1]).abs().max()),
            float(outs[0].abs().max()))


def hybrid_path(dev, card) -> dict:
    """The hybrid serve: zamba2-2.7b at full width and depth, bf16 seeded
    weights (the reference's weight count), the 16 requests of
    `HYBRID_LENS` through `serve_family` (9 hd = 80 flash launches per
    prefill dispatch). Then prefill logits through the kernel against the
    plain flash version at each prompt length, on the model cut to its
    first group (6 Mamba2 layers and one application of the shared
    block): with seeded random weights the 54-layer stack amplifies bf16
    rounding, so at full depth even two schedules of the plain version
    part by a fifth of the largest logit; the full-depth gaps, kernel vs
    plain and plain vs plain, are printed beside each other."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    n = model.param_count()
    log(f"serve path hybrid: {cfg.name} at full width and depth ({cfg.n_layers}"
        f" Mamba2 layers, the shared attention block after every "
        f"{cfg.attn_every}, hd {cfg.hd()}): {n} bf16 weights (expected "
        f"{HYBRID_WEIGHTS}), seeded init on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n != HYBRID_WEIGHTS:
        raise RuntimeError("hybrid weight count")
    served = serve_family(model, cfg, HYBRID_LENS, HYBRID_WINDOW, "hybrid",
                          card)
    n = HYBRID_LENS[-1]
    err, scale, _ = prefill_logits_vs_plain(model, cfg, dev, n,
                                            HYBRID_WINDOW)
    floor, _ = plain_schedules_gap(model, dev, n, HYBRID_WINDOW)
    log(f"serve path hybrid bf16, all {cfg.n_layers} layers, 2 x {n} "
        f"tokens: prefill logits kernel vs plain flash max|d| {err!r}, "
        f"plain (chunk_kv 1024) vs plain (chunk_kv 64) {floor!r}, largest "
        f"logit {scale!r} (not checked: the seeded stack amplifies bf16 "
        f"rounding)")
    del model
    torch.cuda.empty_cache()
    shallow_cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
    shallow = Model(shallow_cfg, device=dev, seed=SEED)
    served["logits_rel"] = check_prefill_logits(
        shallow, shallow_cfg, dev, LOGITS_RTOL,
        f"hybrid bf16 (first group: {shallow_cfg.n_layers} Mamba2 layers "
        f"and the shared block)", lens=HYBRID_LENS, window=HYBRID_WINDOW)
    served["full_depth_gaps"] = (err, floor, scale)
    del shallow
    torch.cuda.empty_cache()
    return served


def family_cpu_parity(dev, cases=FAMILY_CPU_CASES) -> int:
    """Card against CPU at the reduced configs in float32 (TF32 off):
    mixtral (prompts longer than its window), zamba2 and llama with an
    int8 cache, or `cases`. Weights made on the CPU and copied to the
    card; prefill logits of the first admission group (with seeded frames
    or patches for the audio and vlm families) within
    `FAMILY_LOGITS_RTOL` of the largest; greedy streams equal on the card
    in device and host mode and on the CPU; the card's device-mode run
    counted (every prefill attention through the float32 kernel, the
    audio family's encoder and cross-attention non-causal). Returns its
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = 0
    for arch, over, lens in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **over)
        cpu = Model(cfg, device="cpu", seed=SEED)
        card = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(SEED + 3)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        toks = np.stack(prompts[:2])
        extra = frontend_batch(cfg, 2, "cpu", SEED + 5)
        want, _, _ = cpu.prefill({"tokens": torch.as_tensor(toks), **extra},
                                 W=64)
        got, _, _ = card.prefill(
            {"tokens": torch.as_tensor(toks, device=dev),
             **{k: t.to(dev) for k, t in extra.items()}}, W=64)
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        streams = []
        for model, mode in ((card, "device"), (card, "host"),
                            (cpu, "device")):
            eng = ServeEngine(cfg, model, n_slots=2, window=64, mode=mode,
                              decode_chunk=SERVE_CHUNK, seed=SEED)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p,
                                   max_new_tokens=FAMILY_CPU_NEW))
            counting = model is card and mode == "device"
            if counting:
                reset_counts()
            done, _ = eng.run()
            if counting:
                counts = flash_counts()
                nc = flash_counts(noncausal=True)[torch.float32]
                want_n = flash_per_dispatch(cfg) * eng.admit_syncs
                want_nc = noncausal_per_dispatch(cfg) * eng.admit_syncs
            streams.append({r.rid: r.out_tokens for r in done})
        same = (streams[0] == streams[1] == streams[2]
                and all(len(t) == FAMILY_CPU_NEW for t in streams[0].values()))
        ok = (same and err <= FAMILY_LOGITS_RTOL * scale
              and counts[torch.float32] == want_n and nc == want_nc
              and counts[torch.bfloat16] == 0)
        log(f"serve card vs CPU: {cfg.name} ({cfg.family}"
            f"{', int8 KV' if cfg.kv_dtype == 'int8' else ''}"
            f"{f', window {cfg.sliding_window}' if cfg.sliding_window else ''}"
            f"), float32, prompts {lens} x {FAMILY_CPU_NEW} greedy tokens: "
            f"card device = card host = CPU {same}; prefill logits max|d| "
            f"{err!r} (limit {FAMILY_LOGITS_RTOL} x {scale!r}); float32 "
            f"flash_attention launches {counts[torch.float32]} (expected "
            f"{want_n}; non-causal {nc}, expected {want_nc}), "
            f"flash_attention_tc {counts[torch.bfloat16]} "
            f"(expected 0) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"card vs CPU {cfg.name}")
        total += counts[torch.float32]
    return total


# -- the ssm, audio and vlm families (phase 11c), each at full width and
# depth in bf16 with seeded weights, the reference's param_count()
XLSTM_ARCH, XLSTM_WEIGHTS = "xlstm-1.3b", 2_197_576_016
WHISPER_ARCH, WHISPER_WEIGHTS = "whisper-large-v3", 2_020_628_480
VLM_ARCH, VLM_WEIGHTS = "internvl2-1b", 493_780_992
# whisper's and internvl2's prefill logits, kernel vs plain, are held on
# their first 4 layers (whisper: 4 encoder and 4 decoder layers): at full
# depth the seeded stacks amplify bf16 rounding up to the 3e-2 limit or
# past it, so two plain schedules part by 0.149-0.160 of a 3.97-4.54
# whisper logit (kernel vs plain 0.142-0.156) and by 0.092 of a 2.71
# internvl2 logit (kernel vs plain 0.070-0.077 of 2.73-2.87), on NVIDIA
# H100 80GB HBM3; at 4 + 4 whisper layers plain vs plain is 0.038-0.040
# of 4.17-4.32 (kernel vs plain 0.035-0.042). The full-depth gaps and the
# cut's plain gap are printed every run
WHISPER_CUT = VLM_CUT = 4
# card vs CPU at the reduced configs in float32: xlstm (prompts of one
# mLSTM chunk), whisper (8 frames: its encoder and cross-attention run the
# float32 kernel non-causal), internvl2 (4 patches before each prompt)
FAMILY_11C_CPU_CASES = (("xlstm-1.3b", {}, (24, 24, 40)),
                        ("whisper-large-v3", {}, (12, 12, 20)),
                        ("internvl2-1b", {}, (12, 12, 20)))


def load_family(arch: str, dev, weights: int, label: str):
    """`arch` at full width and depth in bf16 with seeded weights on the
    card, its weight count held to `weights` (the reference's)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    n = model.param_count()
    log(f"serve path {label}: {cfg.name} at full width and depth "
        f"({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_frames} "
           f"frames" if cfg.n_enc_layers else "")
        + (f", {cfg.n_patches} patches" if cfg.n_patches else "")
        + f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"hd {cfg.hd()}): {n} bf16 weights (expected {weights}), seeded "
        f"init on the card in {time.perf_counter() - t0:.2f} s")
    if n != weights:
        raise RuntimeError(f"{label} weight count")
    return cfg, model


def xlstm_ops(model, cfg, dev, card) -> dict:
    """Torch operations, under the dispatch counter, of one prefill
    dispatch (B = 2) at the shortest and longest prompt, of its sLSTM
    layers alone, and of one decode step of the serve's 8 slots."""
    from repro_torch.models import xlstm
    prefill = {}
    for n in (XLSTM_LENS[0], XLSTM_LENS[-1]):
        toks = torch.zeros((2, n), dtype=torch.int32, device=dev)
        with OpCount() as ops:
            model.prefill({"tokens": toks})
        h = torch.zeros((2, n, cfg.d_model), dtype=model.embed.dtype,
                        device=dev)
        with OpCount() as s_ops:
            xlstm.s_apply(model.slstm[0], h, cfg)
        prefill[n] = (ops.n, s_ops.n * len(model.slstm))
        if ops.devices != {"cuda"}:
            raise RuntimeError("xlstm prefill: an operation left the card")
    cache = model.init_cache(SERVE_SLOTS, SERVE_WINDOW)
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.full((SERVE_SLOTS,), 8, dtype=torch.int32, device=dev)
    with OpCount() as ops:
        model.decode_step(cache, tok, pos)
    torch.cuda.synchronize()
    log(f"xlstm ops: one prefill dispatch (B = 2) "
        + ", ".join(f"at S = {n}: {a} torch operations, {b} of them in the "
                    f"{len(model.slstm)} sLSTM layers' serial scan "
                    f"({b / (len(model.slstm) * n)!r} per layer and step)"
                    for n, (a, b) in prefill.items())
        + f"; one decode step of {SERVE_SLOTS} slots: {ops.n} torch "
        f"operations [{card}]")
    return {"prefill": prefill, "decode_step": ops.n}


def xlstm_path(dev, card) -> dict:
    """The ssm serve: xlstm-1.3b at full width and depth (42 mLSTM and 6
    sLSTM layers, bf16), the 16 requests of `XLSTM_LENS` through
    `serve_family` with host mode's greedy streams: no flash launch, every
    request its budget; then the torch operations per prefill dispatch
    and per decode step."""
    cfg, model = load_family(XLSTM_ARCH, dev, XLSTM_WEIGHTS, "ssm")
    served = serve_family(model, cfg, XLSTM_LENS, SERVE_WINDOW, "ssm", card,
                          host=True)
    served["ops"] = xlstm_ops(model, cfg, dev, card)
    del model
    torch.cuda.empty_cache()
    return served


def whisper_path(dev, card) -> dict:
    """The audio serve: whisper-large-v3 at full width and depth (32
    encoder layers over 1500 frames, 32 decoder layers, bf16), the 16
    requests of `WHISPER_LENS` (prompt + 64 new tokens within its
    448-token decoder context, the cache window) through `serve_family`
    with host mode's greedy streams: 96 tensor-core flash launches per
    prefill dispatch, 64 of them non-causal. Then prefill logits on
    seeded frames through the kernel against the plain flash version at
    each prompt length, on the model cut to its first `WHISPER_CUT`
    encoder and decoder layers: with seeded random weights the 64-layer
    stack amplifies bf16 rounding, so at full depth even two schedules of
    the plain version part by more than the limit; the full-depth gaps,
    kernel vs plain and plain vs plain, are printed beside each other."""
    cfg, model = load_family(WHISPER_ARCH, dev, WHISPER_WEIGHTS, "audio")
    served = serve_family(model, cfg, WHISPER_LENS, WHISPER_CONTEXT,
                          "audio", card, host=True)
    served["full_depth_gaps"] = full_depth_gaps(
        model, cfg, dev, WHISPER_LENS, WHISPER_CONTEXT,
        f"audio bf16, all {cfg.n_enc_layers} + {cfg.n_layers} layers",
        "seeded frames")
    del model
    torch.cuda.empty_cache()
    served["logits_rel"] = check_on_cut(
        dataclasses.replace(cfg, n_layers=WHISPER_CUT,
                            n_enc_layers=WHISPER_CUT), dev, WHISPER_LENS,
        WHISPER_CONTEXT, f"audio bf16 (first {WHISPER_CUT} encoder and "
        f"{WHISPER_CUT} decoder layers, seeded frames)")
    return served


def full_depth_gaps(model, cfg, dev, lens, window, label: str,
                    inputs: str) -> list:
    """At each prompt length of `lens`: prefill logits through the kernel
    against the plain flash version, and two schedules of the plain
    version against each other, printed and not checked (a seeded deep
    stack amplifies bf16 rounding); the logits must be finite. Returns
    (kernel vs plain, plain vs plain, largest logit) per length."""
    gaps = []
    for n in lens:
        err, scale, finite = prefill_logits_vs_plain(model, cfg, dev, n,
                                                     window)
        floor, _ = plain_schedules_gap(model, dev, n, window)
        log(f"serve path {label}, 2 x {n} tokens on {inputs}: prefill "
            f"logits kernel vs plain flash max|d| {err!r}, plain (chunk_kv "
            f"1024) vs plain (chunk_kv 64) {floor!r}, largest logit "
            f"{scale!r} (not checked: the seeded stack amplifies bf16 "
            f"rounding)")
        if not finite:
            raise RuntimeError(f"{label} prefill logits at {n} tokens are "
                               f"not finite")
        gaps.append((err, floor, scale))
    return gaps


def check_on_cut(cut, dev, lens, window, label: str) -> float:
    """The model of config `cut` (a shallow cut of a full-width config,
    seeded as the full one): prefill logits through the kernel against
    the plain flash version within `LOGITS_RTOL` of the largest at each
    of `lens`, with the two plain schedules' gap printed beside them.
    Returns the largest relative error."""
    from repro_torch.models.model import Model
    shallow = Model(cut, device=dev, seed=SEED)
    worst = check_prefill_logits(shallow, cut, dev, LOGITS_RTOL, label,
                                 lens=lens, window=window)
    for n in lens:
        floor, scale = plain_schedules_gap(shallow, dev, n, window)
        log(f"serve path {label}: prefill logits (2 x {n} tokens) plain "
            f"(chunk_kv 1024) vs plain (chunk_kv 64) max|d| {floor!r}, "
            f"largest logit {scale!r}: the rounding floor of the check")
    del shallow
    torch.cuda.empty_cache()
    return worst


def vlm_path(dev, card) -> dict:
    """The vlm serve: internvl2-1b at full width and depth (24 layers,
    bf16, tied embeddings), the 16 requests of `VLM_LENS` after its 256
    patches (window 2048) through `serve_family` with host mode's greedy
    streams: 24 tensor-core flash launches per prefill dispatch (G = 7),
    every slot's pos and context at prompt + 256 after admission. Then
    prefill logits on seeded patches through the kernel against the plain
    flash version at each prompt length, on the model cut to its first
    `VLM_CUT` layers: at full depth two schedules of the plain version
    part by more than the limit allows a kernel; the full-depth gaps are
    printed beside each other, as whisper's."""
    from repro_torch.serving import ServeEngine
    cfg, model = load_family(VLM_ARCH, dev, VLM_WEIGHTS, "vlm")
    served = serve_family(model, cfg, VLM_LENS, VLM_WINDOW, "vlm", card,
                          host=True)
    eng = ServeEngine(cfg, model, n_slots=SERVE_SLOTS, window=VLM_WINDOW,
                      decode_chunk=SERVE_CHUNK, seed=SEED)
    reqs = serve_requests(cfg.vocab_size, VLM_LENS)[:SERVE_SLOTS]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    want = [len(r.prompt) + cfg.n_patches for r in reqs]
    ok = eng.pos.tolist() == eng._ctx == want
    log(f"serve path vlm: after admission pos {eng.pos.tolist()} and context "
        f"rows {eng._ctx} (expected prompt + {cfg.n_patches} patches: "
        f"{want}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("vlm positions")
    del eng
    served["full_depth_gaps"] = full_depth_gaps(
        model, cfg, dev, VLM_LENS, VLM_WINDOW,
        f"vlm bf16, all {cfg.n_layers} layers",
        f"{cfg.n_patches} seeded patches")
    del model
    torch.cuda.empty_cache()
    served["logits_rel"] = check_on_cut(
        dataclasses.replace(cfg, n_layers=VLM_CUT), dev, VLM_LENS,
        VLM_WINDOW, f"vlm bf16 (first {VLM_CUT} layers, seeded patches)")
    return served


def time_flash_shapes(dev, card, shapes, dtype, kernel_name) -> dict:
    """One flash-attention kernel at `shapes` in `dtype`: CUDA events
    (plain, kernel, SDPA, kernel, plain, SDPA in turns) and profiler device
    time, the bound, the achieved rate (the bound's operations over the
    events time); and their mean over the shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FLOPS[dtype]
    itemsize = torch.finfo(dtype).bits // 8
    out = {}
    for shape in shapes:
        q, k, v = flash_inputs(shape, dtype, dev)
        _, _, window, causal = flash_args(shape)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kern = lambda: flash_attention_fwd(q, k, v, window=window,
                                           causal=causal)
        plain = lambda: flash_attention_plain(q, k, v, window=window,
                                              causal=causal)
        if window:
            # SDPA with an explicit (Sq, Skv) mask: causal and windowed
            i = torch.arange(shape[1], device=dev)[:, None]
            j = torch.arange(shape[2], device=dev)[None, :]
            mask = (j <= i) & (i - j < window)
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        p1, k1, l1 = time_ms(plain, 10), time_ms(kern, 50), time_ms(lib, 50)
        k2, p2, l2 = time_ms(kern, 50), time_ms(plain, 10), time_ms(lib, 50)
        d = device_ms(kern, kernel_name, reps=20)
        nbytes, flops = flash_work(shape, itemsize)
        bound, by = bound_of(nbytes, flops, peak)
        label = f"B={shape[0]} S={shape[1]}" + (
            f" Skv={shape[2]}" if shape[2] != shape[1] else "") + (
            f" hd={shape[5]}" if shape[5] != 64 else "") + (
            f" window={window}" if window else "") + (
            "" if causal else " non-causal")
        ms = (k1 + k2) / 2
        out[label] = dict(ms=ms, device_ms=d, plain_ms=(p1 + p2) / 2,
                          library_ms=(l1 + l2) / 2, bound_ms=bound,
                          bound_by=by, tflops=flops / (ms * 1e-3) / 1e12)
        log(f"time {kernel_name} {str(dtype)[6:]} {label} H={shape[3]} "
            f"K={shape[4]} hd={shape[5]}: kernel {k1!r} / {k2!r} ms, device "
            f"{d!r} ms, plain {p1!r} / {p2!r} ms, "
            f"scaled_dot_product_attention {l1!r} / {l2!r} ms (kernel / SDPA "
            f"{ms / out[label]['library_ms']!r}), bound {bound!r} ms ({by}), "
            f"{out[label]['tflops']!r} TFLOP/s [{card}]")
    rows = list(out.values())
    mix = {key: (None if any(r[key] is None for r in rows)
                 else statistics.fmean(r[key] for r in rows))
           for key in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms", "tflops")}
    by = [r["bound_by"] for r in rows]
    mix["bound_by"] = max(set(by), key=by.count)
    out["mix"] = mix
    log(f"time {kernel_name} {str(dtype)[6:]}, mean over "
        f"{[s[1] for s in shapes]}: kernel {mix['ms']!r} ms, device "
        f"{mix['device_ms']!r} ms, plain {mix['plain_ms']!r} ms, "
        f"scaled_dot_product_attention {mix['library_ms']!r} ms (kernel / "
        f"SDPA {mix['ms'] / mix['library_ms']!r}), bound {mix['bound_ms']!r}"
        f" ms (mostly {mix['bound_by']}) [{card}]")
    return out


def time_flash(dev, card) -> dict:
    """The tensor-core kernel at the serve's four prefill shapes, the
    float32 kernel at the same four (the full-width float32 serve's) and at
    the 2-layer float32 serve's two; both kernels at the hybrid serve's
    four (zamba2, hd = 80), at the moe serve's windowed shape (mixtral,
    window 4096), at the audio serve's non-causal ones (whisper's encoder
    and its cross-attention from the four prompt lengths, SDPA with
    is_causal=False) and at the vlm serve's four (internvl2, G = 7); each
    mean is over the shapes."""
    new = {}
    for dtype, key, name in ((torch.bfloat16, "tc", "flash_attention_tc_kernel"),
                             (torch.float32, "f32", "flash_attention_kernel")):
        new[f"{key}_hybrid"] = time_flash_shapes(
            dev, card, HYBRID_FLASH_SHAPES, dtype, name)
        new[f"{key}_moe"] = time_flash_shapes(
            dev, card, (MOE_FLASH_SHAPE,), dtype, name)
        new[f"{key}_audio"] = time_flash_shapes(
            dev, card, (WHISPER_ENC_SHAPE,) + WHISPER_CROSS_SHAPES, dtype,
            name)
        new[f"{key}_vlm"] = time_flash_shapes(
            dev, card, VLM_FLASH_SHAPES, dtype, name)
    return {**new,
            "tc": time_flash_shapes(dev, card, SERVE_FLASH_SHAPES,
                                    torch.bfloat16,
                                    "flash_attention_tc_kernel"),
            "f32": time_flash_shapes(dev, card, SERVE_FLASH_SHAPES,
                                     torch.float32,
                                     "flash_attention_kernel"),
            "f32_parity": time_flash_shapes(dev, card, F32_FLASH_SHAPES,
                                            torch.float32,
                                            "flash_attention_kernel")}


def time_scan(dev, group, banks, card) -> dict:
    """The scan kernel on a real topology group (B = 16, T = 300, f64):
    per launch and per step by CUDA events and by the profiler's device
    time, the plain version, the bound, and the dependent chain: the
    time of one Newton iteration (the kernel run with tol = 0, so every
    lane runs every iteration of every step) times the iterations of the
    slowest lane, which sets the time of a launch at this batch. Then
    the same at SCAN_BIG_BATCH tiled lanes over the 40-step window."""
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.fused import \
        fused_newton_scan_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    spec, pre, Ksrc, params, v0, iters, tol = scan_inputs(group, banks,
                                                          "f64", dev)
    lo, hi = SCAN_WINDOW
    big = tile_lanes(pre, Ksrc[lo:hi].transpose(0, 1), params, v0,
                     SCAN_BIG_BATCH, gen)
    cases = {f"B={v0.shape[0]} T={N_STEPS}": (pre, Ksrc, params, v0),
             f"B={SCAN_BIG_BATCH} T={hi - lo}":
                 (big[0], big[1].transpose(0, 1).contiguous(), big[2],
                  big[3])}
    out = {}
    for label, (p, ks, pa, v) in cases.items():
        T = ks.shape[0]
        kern = lambda tol_=tol: fused.fused_newton_scan(
            spec, p, ks, pa, v, iters=iters, tol=tol_)
        plain = lambda: fused_newton_scan_plain(spec, p, ks, pa, v, iters,
                                                tol)
        # plain, kernel, kernel, plain
        p1 = time_ms(plain, 1, warm=1)
        k1 = time_ms(kern, 20)
        k2 = time_ms(kern, 20)
        p2 = time_ms(plain, 1, warm=0)
        d = device_ms(kern, "fused_newton_kernel", reps=10)
        full = time_ms(lambda: kern(0.0), 10)
        lane_iters = scan_lane_iterations(spec, p, ks, pa, v, iters, tol)
        bound, by = scan_bound(spec, v.shape[0], T, lane_iters)
        per_lane = lane_iters.sum(axis=1)
        t_iter = full / (T * iters)
        chain = int(per_lane.max()) * t_iter
        out[label] = dict(ms=(k1 + k2) / 2, device_ms=d,
                          plain_ms=(p1 + p2) / 2, bound_ms=bound,
                          bound_by=by, chain_ms=chain)
        log(f"time fused_newton_scan f64 {label}: kernel {k1!r} / {k2!r} ms "
            f"per launch ({(k1 + k2) / 2 / T!r} ms per step), device {d!r} "
            f"ms, plain {p1!r} / {p2!r} ms, bound {bound!r} ms ({by}); "
            f"Newton iterations per lane and step: mean "
            f"{float(lane_iters.mean())!r}, slowest lane "
            f"{int(per_lane.max())} in {T} steps; all {iters} iterations "
            f"every step: {full!r} ms, {t_iter!r} ms per iteration; "
            f"dependent chain {chain!r} ms [{card}]")
    return out[f"B={v0.shape[0]} T={N_STEPS}"]


# -- co-design, the measured runtime loop, the compile service and the fleet
# the four dense archs of benchmarks/bench_fleet.py's full workload; the
# README's co-design quickstart takes the first two (default lattice and
# vdd ladder in both queries)
# -- the training path (phase 11d): Model.loss under autograd, the flash
# kernel's Function, the trainer and its checkpoints, serve from them
TRAIN_ARCH = "llama3.2-1b"
TRAIN_SEQ = 4096                # train_4k's sequence
TRAIN_BATCH = 8                 # train_4k's global batch of 256, cut to 8
TRAIN_MICRO = 2                 # microbatches of 4
TRAIN_STEPS = 8
# one async checkpoint, at the last step (waited for): the mid-run one
# went for phase 11f's budget (the reduced trainer keeps one mid-run)
TRAIN_CKPT_EVERY = 8
TRAIN_WEIGHTS = 1_235_814_400
# flash launches of one full-width step: microbatches x layers x 2 (the
# forward, and remat="full"'s recompute in the backward)
TRAIN_LAUNCHES_PER_STEP = TRAIN_MICRO * 16 * 2
TRAIN_FLASH_SHAPE = (4, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64, 0, None)
# the backward's operations over the forward's: five (query, key) products
# of 2 * hd operations a visible pair (Q K^T, dV, dO V^T, dQ, dK) against
# the forward's two
FLASH_BWD_FACTOR = 2.5
# the Function against autograd through the plain version on the card:
# llama's training shape at B = 1, whisper's cross-attention (non-causal,
# 128 queries to 1500 frames), mixtral's windowed shape at B = 1
FUNC_SHAPES = ((1, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64, 0, None, 0, True),
               (2, 128, 1500, 20, 20, 64, 0, None, 0, False),
               (1, 5120, 5120, 32, 8, 128, 0, None, 4096, True))
# gradient limits, relative to each input's largest gradient: float32,
# the same tiles and algebra with sums in other orders (the CPU test
# against jax.grad measured 6.6e-7 at 1e-5); bfloat16, the kernel's
# output against the plain one (within 2^-6, FLASH_BF16_RTOL) enters
# D = rowsum(dO * O), and autograd through the plain version rounds the
# gradient of p to bf16 where the backward keeps float32, so one part in
# 32
FUNC_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}
# reduced configs, card vs CPU, float32: the CPU parity limits
# (tests/test_torch_training.py) of the loss and each gradient leaf
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
REDUCED_SHAPE = (64, 4)         # (seq_len, global_batch), the CPU tests'
REDUCED_STEPS, REDUCED_PREEMPT, REDUCED_CKPT_EVERY = 12, 7, 6
# the reduced trainer's trajectory, card vs CPU: losses relative, final
# parameters relative to each leaf's largest (AdamW's eps 1e-8 bounds
# what a gradient that float32 rounding flips can move)
TRAJ_LOSS_RTOL, TRAJ_PARAM_RTOL = 1e-5, 1e-4
TRAIN_SERVE_REQUESTS, TRAIN_SERVE_NEW = 4, 16


def check_flash_function(dev) -> dict:
    """The flash Function's dq, dk, dv on the card (forward: the kernel of
    the dtype, counted; backward: plain torch) against autograd through
    `flash_attention_plain` on the same inputs, at `FUNC_SHAPES`, in
    bfloat16 and float32. Returns the largest relative error by dtype and
    the forward launches by dtype."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    worst = {}
    launched = {torch.bfloat16: 0, torch.float32: 0}
    for dtype in (torch.bfloat16, torch.float32):
        worst[dtype] = 0.0
        for shape in FUNC_SHAPES:
            q, k, v = flash_inputs(shape, dtype, dev)
            off, kv_len, window, causal = flash_args(shape)
            gen = torch.Generator(device=dev).manual_seed(SEED + shape[1])
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            ins = [x.clone().requires_grad_() for x in (q, k, v)]
            before = flash_counts()
            o = fa_ops.flash_attention(*ins, off, bq=512, bkv=1024,
                                       causal=causal, window=window)
            after = flash_counts()
            has_fn = o.grad_fn is not None
            got = torch.autograd.grad(o, ins, do)
            launched[dtype] += after[dtype] - before[dtype]
            ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
            o_ref = flash_attention_plain(*ref_in, q_offset=off,
                                          window=window, causal=causal)
            want = torch.autograd.grad(o_ref, ref_in, do)
            torch.cuda.synchronize()
            errs = [float((g.float() - w.float()).abs().max()
                          / w.float().abs().max()) for g, w in zip(got, want)]
            ok = (has_fn and after[dtype] == before[dtype] + 1
                  and all(bool(torch.isfinite(g).all()) for g in got)
                  and max(errs) <= FUNC_RTOL[dtype])
            log(f"check flash Function backward {str(dtype)[6:]} (B, Sq, "
                f"Skv, H, K, hd, q_offset, kv_len, window, causal) = "
                f"{shape}: dq, dk, dv vs autograd through the plain version "
                f"{errs!r} of the largest (limit {FUNC_RTOL[dtype]!r}), "
                f"grad_fn {type(o.grad_fn).__name__}, forward launches "
                f"{after[dtype] - before[dtype]} {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"flash Function check {shape} failed")
            worst[dtype] = max(worst[dtype], max(errs))
            del q, k, v, do, ins, o, got, ref_in, o_ref, want
            torch.cuda.empty_cache()
    # a direct launch with inputs that require grad raises
    from repro_torch.kernels.flash_attention import kernel
    q, k, v = flash_inputs((1, 64, 64, 4, 2, 64), torch.bfloat16, dev)
    kern, args = kernel.route(q, k, v)
    try:
        kern(q.requires_grad_(), k, v, args)
        raised = False
    except RuntimeError:
        raised = True
    log(f"check a direct flash_attention_tc launch with q requiring grad "
        f"raises: {raised} {'ok' if raised else 'FAILED'}")
    if not raised:
        raise RuntimeError("a direct kernel launch returned a detached "
                           "tensor")
    return {"worst": worst, "launches": launched}


def time_flash_backward(dev, card) -> dict:
    """At llama's training shape (B = 4, S = 4096, bf16): the forward
    kernel (time_flash_shapes: events, device, plain, SDPA, bound), then
    the backward alone, the Function's (plain torch, tiled) against
    SDPA's, each by CUDA events over `autograd.grad` on one saved graph."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    fwd = time_flash_shapes(dev, card, (TRAIN_FLASH_SHAPE,), torch.bfloat16,
                            "flash_attention_tc_kernel")
    q, k, v = (x.requires_grad_() for x in flash_inputs(
        TRAIN_FLASH_SHAPE, torch.bfloat16, dev))
    do = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    o = fa_ops.flash_attention(q, k, v, bq=512, bkv=1024)
    ours = lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    do_t = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                      retain_graph=True)
    b1, l1 = time_ms(ours, 3, warm=1), time_ms(lib, 10)
    b2, l2 = time_ms(ours, 3, warm=1), time_ms(lib, 10)
    # the bound counts the products attention's backward needs; the
    # Function's first pass, which recomputes Q K^T for the running max
    # and row sum (the forward saves no logsumexp), is its own cost
    bound = FLASH_BWD_FACTOR * flash_work(TRAIN_FLASH_SHAPE, 2)[1] \
        / BF16_FLOPS * 1e3
    out = {"fwd": fwd["mix"], "bwd_ms": (b1 + b2) / 2,
           "sdpa_bwd_ms": (l1 + l2) / 2, "bwd_bound_ms": bound}
    log(f"time flash Function backward bf16 {TRAIN_FLASH_SHAPE[:6]}: "
        f"{b1!r} / {b2!r} ms (plain torch, tiled), bound {bound!r} ms "
        f"(operations: {FLASH_BWD_FACTOR} x the forward's causal ones at "
        f"989 TFLOP/s bf16), "
        f"scaled_dot_product_attention backward {l1!r} / {l2!r} ms "
        f"(library reference, not a port; ours / SDPA "
        f"{out['bwd_ms'] / out['sdpa_bwd_ms']!r}) [{card}]")
    del q, k, v, o, o_lib, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def reduced_grads(cfg, tree, batch, dev):
    """(loss, {path: grad}) of `Model.loss` for the stacked float32 tree
    and batch (numpy), on `dev`."""
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    t = tree_map(lambda a: a.to(dev).requires_grad_(), tree)
    loss, _ = Model(cfg, device="meta").loss(
        {k: torch.as_tensor(x, device=dev) for k, x in batch.items()},
        params=t)
    loss.backward()
    return float(loss.detach()), {p: x.grad.cpu()
                                  for p, x in tree_leaves(t, paths=True)}


def reduced_models_card_vs_cpu(dev) -> int:
    """Every arch's reduced float32 config: the loss and every gradient
    leaf on the card against the port's CPU run of the same weights and
    batch. Returns the float32 flash launches (the card's forwards)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model, param_tree
    S, B = REDUCED_SHAPE
    before = flash_counts()[torch.float32]
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tree = param_tree(Model(cfg, device="cpu", seed=SEED))
        batch = SyntheticLMData(cfg.vocab_size, S, B, family=cfg.family,
                                d_model=cfg.d_model,
                                enc_frames=cfg.enc_frames,
                                n_patches=cfg.n_patches).batch_at(0)
        l_card, g_card = reduced_grads(cfg, tree, batch, dev)
        l_cpu, g_cpu = reduced_grads(cfg, tree, batch, "cpu")
        rel = {p: float((g_card[p] - g_cpu[p]).abs().max()
                        / g_cpu[p].abs().max()) for p in g_cpu}
        worst = max(rel, key=rel.get)
        finite = all(bool(torch.isfinite(g).all()) and float(g.abs().max())
                     > 0 for g in g_card.values())
        lrel = abs(l_card - l_cpu) / abs(l_cpu)
        ok = finite and lrel <= TRAIN_LOSS_RTOL \
            and rel[worst] <= TRAIN_GRAD_RTOL
        log(f"check reduced {arch} loss and gradients, card vs CPU: loss "
            f"{l_card!r} vs {l_cpu!r} (rel {lrel!r}, limit "
            f"{TRAIN_LOSS_RTOL}), worst gradient leaf {worst} {rel[worst]!r}"
            f" of its largest (limit {TRAIN_GRAD_RTOL}), every gradient "
            f"finite and nonzero: {finite} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"reduced {arch} card vs CPU failed")
    return flash_counts()[torch.float32] - before


def reduced_trainer(dev, root) -> dict:
    """Reduced llama trained for 12 steps on the card uninterrupted, and
    again preempted at step 7, its step-7 checkpoint removed and resumed
    from step 6: the final states bit for bit; the trajectory against the
    CPU run; the card's checkpoint restored on the CPU, equal."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.training import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              dtype="float32")
    shape = ShapeConfig("reduced_train", *REDUCED_SHAPE, "train")

    def trainer(d, device, **kw):
        tr = Trainer(cfg, None, shape, TrainConfig(
            total_steps=REDUCED_STEPS, ckpt_every=REDUCED_CKPT_EVERY,
            ckpt_dir=str(root / d), log_every=100, log_fn=lambda *a: None,
            device=device, **kw))
        # every run starts from the CPU init (a CUDA generator draws
        # other numbers)
        tr.init_state = lambda: tree_map(lambda t: t.to(device), init)
        return tr

    from repro_torch.launch.steps import build_train
    from repro_torch.models.model import Model
    init = build_train(cfg).init_state(Model(cfg, device="cpu", seed=0))

    st_a, hist_a = trainer("a", dev).run()
    trainer("b", dev, preempt_at=REDUCED_PREEMPT).run()
    shutil.rmtree(root / "b" / f"step_{REDUCED_PREEMPT:09d}")
    resumed = trainer("b", dev)
    st_b, hist_b = resumed.run()
    same = all(torch.equal(x, y) for x, y in
               zip(tree_leaves(st_a), tree_leaves(st_b)))
    same_losses = all(h["loss"] == {g["step"]: g["loss"] for g in hist_a}[
        h["step"]] for h in hist_b)
    st_c, hist_c = trainer("c", "cpu").run()
    lrel = max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
               for a, c in zip(hist_a, hist_c))
    prel = max(float((x.cpu() - y).abs().max() / y.abs().max())
               for x, y in zip(tree_leaves(st_a["params"]),
                               tree_leaves(st_c["params"])))
    step = latest_step(str(root / "a"))
    on_cpu = restore_checkpoint(str(root / "a"), step,
                                resumed.bundle.state_like(), device="cpu")
    restored = all(torch.equal(x, y.cpu()) for x, y in
                   zip(tree_leaves(on_cpu), tree_leaves(st_a)))
    ok = (same and same_losses and resumed.stats["restored_step"] == 6
          and lrel <= TRAJ_LOSS_RTOL and prel <= TRAJ_PARAM_RTOL
          and restored and len(hist_a) == REDUCED_STEPS)
    log(f"check reduced {TRAIN_ARCH} trainer on the card: {REDUCED_STEPS} "
        f"steps uninterrupted vs preempted at {REDUCED_PREEMPT} and resumed "
        f"from step {resumed.stats['restored_step']}: final states bit-"
        f"identical {same}, overlapping losses equal {same_losses}; "
        f"trajectory vs the CPU run: losses {lrel!r} (limit "
        f"{TRAJ_LOSS_RTOL}), final parameters {prel!r} of each leaf's "
        f"largest (limit {TRAJ_PARAM_RTOL}); step-{step} checkpoint "
        f"restored on the CPU equal {restored}; losses "
        f"{[h['loss'] for h in hist_a]!r} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("reduced trainer check failed")
    return {"steps": len(hist_a)}


def step_norm(new, old) -> float:
    """The l2 norm of new - old over every leaf of two parameter trees
    (float32 sums; a DTensor's gathered)."""
    from repro_torch.optim.optimizers import tree_leaves
    total = 0.0
    for n, o in zip(tree_leaves(new), tree_leaves(old)):
        sq = ((n - o) ** 2).sum()
        total += float(sq.full_tensor() if hasattr(sq, "full_tensor")
                       else sq)
    return math.sqrt(total)


def instrument_trainer(tr) -> dict:
    """Wrap a Trainer's step and checkpoint calls: returns lists of the
    flash launches of each step by dtype ("launches"), the norm of each
    step on the master ("norms"), each step's wall to its synchronize
    ("walls"), the allocator's peak up to the end of each step ("peaks";
    the norm's temporaries are left out: the peak is reset after it) and
    the checkpoint calls as (kind, step, s in the loop; an async save's
    is its host copy) ("saves")."""
    got = {k: [] for k in ("launches", "norms", "walls", "peaks", "saves")}
    step_fn = tr.step_fn

    def counted_step(state, batch):
        before = flash_counts()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        got["walls"].append(time.perf_counter() - t0)
        got["peaks"].append(torch.cuda.max_memory_allocated())
        after = flash_counts()
        got["launches"].append({d: after[d] - before[d] for d in after})
        got["norms"].append(step_norm(out[0]["params"], state["params"]))
        torch.cuda.reset_peak_memory_stats()
        return out
    tr.step_fn = counted_step
    for name in ("save", "save_async"):
        def timed_save(step, tree, _fn=getattr(tr.ckpt, name), _name=name):
            t0 = time.perf_counter()
            _fn(step, tree)
            got["saves"].append((_name, step, time.perf_counter() - t0))
        setattr(tr.ckpt, name, timed_save)
    return got


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave every launch counter as it was
    (a comparison's, not a path's)."""
    fns = counted().values()
    saved = [(fn.launches, getattr(fn, "noncausal_launches", None))
             for fn in fns]
    try:
        yield
    finally:
        for fn, (n, nc) in zip(fns, saved):
            fn.launches = n
            if nc is not None:
                fn.noncausal_launches = nc


def profile_train_step(step_fn, state, batch) -> dict:
    """One warm train step under torch.profiler: the wall, the device
    busy time (device-side events), the idle share, and the flash
    Function's forward (the kernel's device time) and backward (the
    device time under its autograd node) in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = fwd = 0.0
    bwd, kernels = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += dev_us / 1e3
            kernels.append((dev_us / 1e3, ev.count, ev.key[:60]))
            if "flash_attention_tc_kernel" in ev.key:
                fwd += dev_us / 1e3
        elif "FlashAttentionBackward" in ev.key:
            bwd.append(getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0.0)) / 1e3)
    del out
    return {"top": sorted(kernels, reverse=True)[:8],
            "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "flash_fwd_ms": fwd,
            "flash_bwd_ms": max(bwd) if bwd else None}


def train_full_width(dev, root, card) -> dict:
    """llama3.2-1b at full width and depth, bf16 over float32 master
    params, AdamW, cosine, remat "full", train_4k's 4,096 tokens at a
    global batch of 8 in 2 microbatches: 8 steps with an async
    checkpoint at the last (waited for), the flash launches and the norm
    on the master of each step recorded (the counts set to 0 just before
    the run), the loss
    finite at every step and lower at the last than at the first; its
    warm step wall, tokens/s, model-FLOPs share, peak memory, telemetry
    profile; one more step under the profiler."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.runtime import TelemetryCollector
    from repro_torch.runtime.profile import measured_profile
    from repro_torch.training import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k_b8", TRAIN_SEQ, TRAIN_BATCH, "train")
    col = TelemetryCollector()
    tr = Trainer(cfg, None, shape, TrainConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        ckpt_dir=str(root / "full"), keep_last=2, log_every=1,
        microbatches=TRAIN_MICRO, telemetry=col, device="cuda",
        log_fn=lambda m: log(f"  train {TRAIN_ARCH}: {m}")))
    step_fn = tr.step_fn
    got = instrument_trainer(tr)
    per_step, saves = got["launches"], got["saves"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    state, hist = tr.run()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = max(got["peaks"] + [torch.cuda.max_memory_allocated(dev)])
    losses = [h["loss"] for h in hist]
    walls = [h["time_s"] for h in hist[1:]]
    wall = statistics.median(walls)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * TRAIN_WEIGHTS * tokens / (wall * BF16_FLOPS)
    prof = measured_profile(col.snapshot(), cfg)
    ok = (len(hist) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(c[torch.bfloat16] == TRAIN_LAUNCHES_PER_STEP
                  and c[torch.float32] == 0 for c in per_step)
          and counts["flash_attention_tc"] == TRAIN_STEPS
          * TRAIN_LAUNCHES_PER_STEP and counts["flash_attention_f32"] == 0)
    log(f"train path: {TRAIN_ARCH} full width ({tr.bundle.model.param_count()}"
        f" weights), bf16 over float32 master, AdamW, cosine, remat "
        f"{cfg.remat}, S={TRAIN_SEQ}, global batch {TRAIN_BATCH} in "
        f"{TRAIN_MICRO} microbatches, {TRAIN_STEPS} steps in {run_s!r} s "
        f"(checkpoints included); losses {losses!r}; tensor-core flash "
        f"launches per step {[c[torch.bfloat16] for c in per_step]} "
        f"(expected {TRAIN_LAUNCHES_PER_STEP}), float32 "
        f"{[c[torch.float32] for c in per_step]}; launch counters "
        f"{counts}; checkpoint calls (kind, step, s in the loop; an async "
        f"save's is its host copy) {saves!r} {'ok' if ok else 'FAILED'}")
    log(f"time train step {TRAIN_ARCH}: warm step walls {walls!r} s, median "
        f"{wall!r} s, {tokens / wall!r} tokens/s, model-FLOPs share of the "
        f"bf16 dense peak 6*N*tokens/(wall*989 TFLOP/s) {mfu!r}, "
        f"torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30!r} GiB) [{card}]")
    log(f"train telemetry measured_profile (kind {prof.kind}): "
        f"{dataclasses.asdict(prof)}")
    if not ok:
        raise RuntimeError("full-width train path failed")
    # one more step under the profiler, on the final state
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as steps_mod
    batch = steps_mod.to_device(SyntheticLMData(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch_at(TRAIN_STEPS), dev)
    prof_step = profile_train_step(step_fn, state, batch)
    log(f"profile train step {TRAIN_ARCH}: wall {prof_step['wall_ms']!r} ms "
        f"under the profiler, device busy {prof_step['busy_ms']!r} ms, idle "
        f"share {prof_step['idle_share']!r}; flash Function forward "
        f"(kernel) {prof_step['flash_fwd_ms']!r} ms, backward (plain torch) "
        f"{prof_step['flash_bwd_ms']!r} ms of device time; the device "
        f"kernels with the most time (ms, calls, name): "
        f"{prof_step['top']!r} [{card}]")
    params = state["params"]
    del state, batch, tr
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention_tc"], "per_step":
            TRAIN_LAUNCHES_PER_STEP, "wall": wall, "mfu": mfu, "peak": peak,
            "profile": prof_step, "params": params, "cfg": cfg,
            "losses": losses, "history": hist, "norms": got["norms"]}


def serve_from_checkpoint(dev, root, trained) -> None:
    """`launch.serve --ckpt-dir` on the full-width run's checkpoint, 4
    greedy requests, against a `Model` holding the trained params (the
    final state's master cast to each weight's working dtype) serving the
    same requests: equal streams."""
    from repro_torch import interop
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import serve
    from repro_torch.serving import Request, ServeEngine
    cfg = trained["cfg"]
    out = root / "serve_ckpt.jsonl"
    argv = ["--arch", TRAIN_ARCH, "--ckpt-dir", str(root / "full"),
            "--requests", str(TRAIN_SERVE_REQUESTS), "--max-new",
            str(TRAIN_SERVE_NEW), "--greedy", "--output", str(out)]
    rc = serve.main(argv)
    got = {r["rid"]: r["tokens"] for r in map(json.loads,
                                               out.read_text().splitlines())}
    torch.cuda.empty_cache()
    dtypes = interop.param_dtypes(cfg)
    cast = interop.tree_map(lambda t, d: t.to(d), trained["params"], dtypes)
    model = interop.model_params_from_numpy(cfg, cast, device=dev)
    del cast
    eng = ServeEngine(cfg, model, n_slots=4, window=1024, mode="device",
                      decode_chunk=8)
    rng = np.random.default_rng(0)
    for i in range(TRAIN_SERVE_REQUESTS):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, rng.integers(4, 32)).astype(np.int32),
            max_new_tokens=TRAIN_SERVE_NEW, temperature=0.0))
    done, _ = eng.run()
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    ok = rc == 0 and got == want and len(got) == TRAIN_SERVE_REQUESTS
    log(f"check serve --ckpt-dir (step {latest_step(str(root / 'full'))}) "
        f"{TRAIN_SERVE_REQUESTS} greedy requests vs a Model holding the "
        f"trained params: streams equal {got == want} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("serve from the checkpoint failed")
    del model, eng
    torch.cuda.empty_cache()


def train_path(dev, card) -> dict:
    """Phase 11d: the flash Function's gradients, the reduced models and
    trainer card vs CPU, the full-width train run, serve from its
    checkpoint, and the Function's backward timing."""
    root = ROOT / "build" / "smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    usage = shutil.disk_usage(root)
    log(f"train path: checkpoints under {root}, {usage.free / 2**30!r} GiB "
        f"free on its disk")
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out
    func = timed("function checks", check_flash_function, dev)
    reduced_f32 = timed("reduced card vs CPU", reduced_models_card_vs_cpu,
                        dev)
    timed("reduced trainer", reduced_trainer, dev, root)
    full = timed("full width", train_full_width, dev, root, card)
    timed("serve from checkpoint", serve_from_checkpoint, dev, root, full)
    full.pop("params")
    times = timed("backward timing", time_flash_backward, dev, card)
    shutil.rmtree(root, ignore_errors=True)
    log(f"train path walls (s): {walls!r}")
    return {**full, "func": func, "reduced_f32_launches": reduced_f32,
            "times": times}


# phase 11e: the dry-run cells (arch, shape, multi-pod) and the mesh step
# on the card at the 16x16 mesh's per-device batches
MESH_CELLS = (("llama3.2-1b", "train_4k", False),
              ("llama3.2-1b", "prefill_32k", False),
              ("llama3.2-1b", "decode_32k", False),
              ("qwen2-0.5b", "prefill_32k", True),
              # one cell per family of the MoE, hybrid, ssm, audio and
              # vlm mesh paths: arctic's small-T path (2-D weights),
              # mixtral tensor-parallel on d_ff with its window, whisper's
              # encoder with replicated heads, internvl2's
              # sequence-parallel flash at G = 7
              ("arctic-480b", "decode_32k", False),
              ("mixtral-8x7b", "prefill_32k", False),
              ("zamba2-2.7b", "decode_32k", False),
              ("xlstm-1.3b", "decode_32k", False),
              ("whisper-large-v3", "prefill_32k", False),
              ("internvl2-1b", "prefill_32k", False))
MESH_ARCH = "llama3.2-1b"
MESH_PREFILL = (2, 32768)       # prefill_32k: 32 / 16 data ranks
MESH_DECODE = (8, 32768)        # decode_32k: 128 / 16, its window
MESH_TRAIN = (2, 4096, 2)       # B, S, layers (full width)
MESH_LOGITS_RTOL = 3e-2         # of the largest logit, the bf16 limit
MESH_LOSS_RTOL = 1e-5
# the train step starts past the warmup (1% of build_train's 10,000
# steps), so its lr is the peak and the master moves
MESH_TRAIN_STEP = 100
# the train step against the step without a mesh, in bf16: the gradients
# are bf16 products that cuBLAS may sum in another order under DTensor
# (the loss is equal), so the gradient norm is held within one bf16 unit,
# the first moment (0.1 x the clipped gradient) within FUNC_RTOL's one
# part in 32 of each leaf's largest, and the master's step by its norm
# within one bf16 unit: from zero moments AdamW's step is ~lr x the
# gradient's sign, so an element whose gradient lies within rounding of 0
# moves the other way (the elementwise master is printed, not checked;
# 0.019 of a leaf's largest in the phase's first run on the card)
MESH_GRAD_RTOL = 2.0 ** -8
MESH_PHASE_S = 150.0            # the phase's budget
# the analyzer's exact peak of the storages a real step allocates (ops
# it sees) against the allocator's increase over the step
# (max_memory_allocated less the bytes held before it), of the increase
MESH_PEAK_RTOL = 0.10
# the other families' bundles on the card's (1, 1) mesh, at the 16x16
# mesh's per-device batches: (label, arch, config overrides, kind, B,
# S or W, tensor-core flash launches, of them non-causal). mixtral at 4
# of 32 layers (4 x 1.41e9 expert weights; the step without a mesh
# shares the mesh model's tensors), zamba2's first group (6 Mamba2 layers
# and the shared block), xlstm at full depth (decode) and one group of 7
# mLSTM + 1 sLSTM layers (prefill), whisper 4 + 4 layers and internvl2 4
# layers (their logits checks' cuts); whisper's prompt is its published
# decoder context. zamba2's prompt is cut from 32,768 to 8,192 tokens and
# xlstm's from 1,024 to 512, for the phase's budget: their fake twins
# step the Mamba2 chunks and the sLSTM one at a time on fake tensors
# (26.6 s and 16.1 s at the longer prompts on the card's host)
MESH_FAMILY_BUNDLES = (
    ("moe prefill", "mixtral-8x7b", {"n_layers": 4}, "prefill", 2, 32768,
     4, 0),
    ("moe decode", "mixtral-8x7b", {"n_layers": 4}, "decode", 8, 4096,
     0, 0),
    ("hybrid prefill", "zamba2-2.7b", {"n_layers": 6}, "prefill", 2, 8192,
     1, 0),
    ("ssm decode", "xlstm-1.3b", {}, "decode", 8, 1024, 0, 0),
    ("ssm prefill", "xlstm-1.3b", {"n_layers": 8}, "prefill", 2, 512,
     0, 0),
    ("audio prefill", "whisper-large-v3", {"n_layers": 4,
                                           "n_enc_layers": 4},
     "prefill", 2, 448, 12, 8),
    ("vlm prefill", "internvl2-1b", {"n_layers": 4}, "prefill", 2, 32768,
     4, 0))
# the moe train step: mixtral at full width, 1 layer (a layer's float32
# master and two AdamW moments are 16.9 GB; the state, the step's new
# state and the plain step's first moment of 2 layers do not fit the
# card's 80 GB), B = 2, S = 4,096, from MESH_TRAIN_STEP: T = 8,192 tokens
# take the expert-parallel path under local_map, forward and backward
MESH_MOE_TRAIN = (2, 4096, 1)
# the tensor-core flash kernel against the plain version at the mesh
# prefill's per-layer shape; the last MESH_FLASH_TAIL query rows (each
# sees at least 31,745 keys, max|o| ~0.05 against ~4 in the first rows)
# are also held to the limit of their own largest, and the control leaves
# out the last MESH_FLASH_DROP keys (one of the kernel's key tiles): a
# single key moves a late row by ~3e-4, under that limit (8.0e-4 on the
# CPU at this seed; 64 keys move it by 5.0e-3)
MESH_FLASH_SHAPE = (2, 32768, 32768, 32, 8, 64, 0, None)
MESH_FLASH_TAIL = 1024
MESH_FLASH_DROP = 64


def dry_run_cells() -> dict:
    """The dry-run cells of `MESH_CELLS` on fake tensors; raises if a
    cell's flops x chips fall short of MODEL_FLOPS, a trip count is
    unknown, or the chips are not 256 / 512."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape, multi_pod in MESH_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod)
        wall = time.perf_counter() - t0
        an, rl = rec["hlo_analysis"], rec["roofline"]
        chips = round(rl["hlo_flops_global"] / an["flops"])
        ok = (an["flops"] * chips >= rl["model_flops"]
              and an["unknown_trip_counts"] == 0
              and chips == (512 if multi_pod else 256))
        log(f"dry run {arch} {shape} {rec['mesh']} ({chips} chips): "
            f"compute {rl['compute_s']!r} s, memory {rl['memory_s']!r} s, "
            f"collective {rl['collective_s']!r} s, bottleneck "
            f"{rl['bottleneck']}, MODEL_FLOPS {rl['model_flops']!r}, "
            f"flops/dev {an['flops']!r} (x chips / MODEL_FLOPS "
            f"{an['flops'] * chips / rl['model_flops']!r}), MFU bound "
            f"{rl['mfu']!r}, peak {rec['peak_bytes_per_device'] / 2**30!r} "
            f"GiB/dev, wire {an['collective_wire_bytes']!r} B/dev "
            f"{an['collective_by_type']!r}, dots {an['dot_count']}, lower "
            f"{rec['lower_s']} s, fake run {rec['compile_s']} s, cell "
            f"{wall:.1f} s (fake tensors, no device memory) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"dry-run cell {arch} {shape} failed")
        out[(arch, shape, rec["mesh"])] = rec
    return out


def mesh_step(cfg, mesh, shape, make_args, label: str) -> dict:
    """The bundle of `shape` on the card's (1, 1) mesh, run once under the
    analyzer with the flash counters read around it, and the same bundle
    run on fake tensors; raises unless flops, dots and bytes are equal."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_analysis, steps
    b = steps.build(cfg, mesh, shape, seed=SEED)
    args = make_args(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before, before_nc = flash_counts(), flash_counts(noncausal=True)
    t0 = time.perf_counter()
    real, out, real_live = hlo_analysis.analyze(b.fn, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after, after_nc = flash_counts(), flash_counts(noncausal=True)
    peak = torch.cuda.max_memory_allocated()
    with FakeTensorMode():
        bf = steps.build(cfg, mesh, shape, seed=SEED)
        fargs = bf.inputs()
        t0 = time.perf_counter()
        fake, _, temp = hlo_analysis.analyze(bf.fn, *fargs)
        fake_s = time.perf_counter() - t0
        est = steps.local_bytes([list(fargs), bf.weights()]) + temp
    same = all(real[k] == fake[k] for k in ("flops", "dot_count",
                                            "mem_bytes"))
    grew = peak - held
    gap = abs(real_live - grew) / max(grew, 1)
    log(f"mesh {label}: real run {wall:.2f} s, flops {real['flops']!r} / "
        f"fake {fake['flops']!r}, dots {real['dot_count']} / "
        f"{fake['dot_count']}, mem_bytes {real['mem_bytes']!r} / "
        f"{fake['mem_bytes']!r}, collectives {real['collective_count']} "
        f"{'equal' if same else 'DIFFER'}; fake run {fake_s:.2f} s; peak "
        f"(fake: arguments + temp) {est / 2**30!r} GiB, "
        f"torch.cuda.max_memory_allocated {peak / 2**30!r} GiB ("
        f"{held / 2**30!r} GiB held before the step: the arguments, and "
        f"the models and inputs of the comparison), so the step added "
        f"{grew / 2**30!r} GiB; the analyzer's peak of the real run's "
        f"storages {real_live / 2**30!r} GiB, off by {gap!r} of it (limit "
        f"{MESH_PEAK_RTOL}) {'ok' if gap <= MESH_PEAK_RTOL else 'FAILED'}")
    if not same:
        raise RuntimeError(f"mesh {label}: real and fake counts differ")
    if gap > MESH_PEAK_RTOL:
        raise RuntimeError(f"mesh {label}: the analyzer's peak is off the "
                           f"allocator's")
    return {"out": out, "bundle": b, "peak_gap": gap,
            "launches": {str(k)[6:]: after[k] - before[k] for k in after},
            "noncausal": sum(after_nc[k] - before_nc[k] for k in after_nc)}


def check_mesh_flash(dev) -> float:
    """The wrapper on seeded q, k, v at `MESH_FLASH_SHAPE` (one launch,
    counted here, outside the mesh steps' counts) against
    `flash_attention_plain` on the same inputs: the whole output within
    `flash_limit`, the tail rows within the limit of their own largest,
    which the plain tail without the last `MESH_FLASH_DROP` keys must
    exceed. Returns the largest error."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    q, k, v = flash_inputs(MESH_FLASH_SHAPE, torch.bfloat16, dev)
    S, T = MESH_FLASH_SHAPE[1], MESH_FLASH_TAIL
    before = flash_counts()
    got = flash_attention_fwd(q, k, v)
    after = flash_counts()
    want = flash_attention_plain(q, k, v)
    short = flash_attention_plain(q[:, -T:], k, v, q_offset=S - T,
                                  kv_len=S - MESH_FLASH_DROP)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tail = float((got[:, -T:].float() - want[:, -T:].float()).abs().max())
    atol = flash_limit(torch.bfloat16, want)
    tail_atol = flash_limit(torch.bfloat16, want[:, -T:])
    moved = float((short.float() - want[:, -T:].float()).abs().max())
    routed = (after[torch.bfloat16] == before[torch.bfloat16] + 1
              and after[torch.float32] == before[torch.float32])
    ok = (routed and bool(torch.isfinite(got).all()) and err <= atol
          and tail <= tail_atol < moved)
    log(f"check flash_attention_tc bf16 at the mesh prefill's shape "
        f"{MESH_FLASH_SHAPE[:6]}: max|do| vs plain {err!r} (limit "
        f"{atol!r}); the last {T} query rows {tail!r} (limit {tail_atol!r}"
        f", the plain tail without the last {MESH_FLASH_DROP} keys moves "
        f"by {moved!r}), {'one launch' if routed else 'WRONG KERNEL'} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("flash_attention check at the mesh prefill's "
                           "shape failed")
    return err


def unmeshed(model):
    """The same model without a mesh, sharing the (1, 1) mesh model's
    local tensors (each is its whole weight): no copy on the card."""
    from repro_torch.models.model import Model
    plain = Model(model.cfg, device="meta")
    plain.load_state_dict({k: v.to_local() for k, v in
                           model.state_dict().items()}, assign=True)
    return plain


class moe_capacity_t:
    """The unsharded MoE FFN with capacity C = T, as the mesh's small-T
    path applies it (dropless), for the duration of the block."""

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = orig = moe._moe_local
        moe._moe_local = lambda x, *a, **kw: orig(
            x, *a, **{**kw, "capacity": x.shape[0]})

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._moe_local = self.orig


def rel_max(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def family_bundle(dev, mesh, gen, label, arch, over, kind, B, S, want_fa,
                  want_nc) -> dict:
    """One bundle of `MESH_FAMILY_BUNDLES` through `mesh_step`, then the
    same step without a mesh on the same inputs and weights: prefill
    logits, or decode logits and the whole written cache, within
    `MESH_LOGITS_RTOL` of the largest, and the bundle's flash launches.
    The moe decode takes the small-T path, so the step without a mesh
    runs with capacity C = T."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch), **over)
    ins = {}

    def make_args(b):
        n_tok = S - cfg.n_patches if cfg.family == "vlm" else S
        if kind == "prefill":
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (B, n_tok), generator=gen, device=dev,
                dtype=torch.int32)}
            batch.update({k: v.float() for k, v in frontend_batch(
                cfg, B, dev, SEED).items()})
            ins["args"] = (batch,)
            return b.shard(batch)
        if cfg.family == "ssm":        # the states of a 64-token prompt
            tokens = torch.randint(0, cfg.vocab_size, (B, 64), generator=gen,
                                   device=dev, dtype=torch.int32)
            cache = unmeshed(b.model).prefill({"tokens": tokens})[1]
        else:
            shapes = b.model.init_cache(B, S, device="meta")
            cache = {k: torch.randn(v.shape, generator=gen, device=dev,
                                    dtype=torch.float32).to(v.dtype)
                     for k, v in shapes.items()}
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=dev, dtype=torch.int32)
        pos = torch.randint(S // 2, S, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        ins["args"] = (cache, tok, pos)
        return b.shard({k: v.clone() for k, v in cache.items()}, tok, pos)

    small_t = (cfg.family == "moe" and B * (1 if kind == "decode" else S)
               <= moe.SMALL_T)
    r = mesh_step(cfg, mesh, ShapeConfig(label, S, B, kind), make_args,
                  f"{label} {cfg.name} ({cfg.n_layers} layers"
                  + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers
                     else "") + f") B={B} {'S' if kind == 'prefill' else 'W'}"
                  f"={S}")
    plain = unmeshed(r["bundle"].model)
    with moe_capacity_t() if small_t else contextlib.nullcontext():
        if kind == "prefill":
            want = plain.prefill(*ins["args"])[0]
            errs = {"logits": rel_max(r["out"][0], want)}
        else:
            cache, tok, pos = ins["args"]
            want, want_cache = plain.decode_step(cache, tok, pos)
            got, got_cache = r["out"]
            errs = {"logits": rel_max(got, want)}
            errs.update({k: rel_max(got_cache[k], want_cache[k])
                         for k in want_cache})
    launches, noncausal = r["launches"], r["noncausal"]
    del r, plain, ins
    torch.cuda.empty_cache()
    fa_ok = (launches == {"bfloat16": want_fa, "float32": 0}
             and noncausal == want_nc)
    ok = max(errs.values()) <= MESH_LOGITS_RTOL and fa_ok
    log(f"check mesh {label} {cfg.name}: vs no mesh "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } of each "
        f"largest (limit {MESH_LOGITS_RTOL}){', capacity C = T (small-T)' if small_t else ''}"
        f", flash launches {launches}, {noncausal} non-causal (want "
        f"{want_fa} bf16, {want_nc} non-causal) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"mesh {label} check failed")
    return launches


def mesh_moe_train(dev, mesh, gen) -> dict:
    """One train step of full-width mixtral (`MESH_MOE_TRAIN`) on the
    (1, 1) mesh from `MESH_TRAIN_STEP`, held as the dense train step:
    loss within MESH_LOSS_RTOL, gradient norm and the master's step norm
    within MESH_GRAD_RTOL, the first moment within FUNC_RTOL's bf16 limit
    of each leaf's largest. The plain step's new state is cut to its
    first moment and step norm, and the state to its placed copy, before
    the mesh step runs (memory)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves
    B, S, L = MESH_MOE_TRAIN
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=L)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    model = Model(cfg, device=dev, seed=SEED)
    tb = steps.build_train(cfg)
    state = tb.init_state(model)
    del model
    state["step"].fill_(MESH_TRAIN_STEP)
    new0, met0 = tb.step(state, batch)
    step0 = math.sqrt(sum(float(((w - s0) ** 2).sum()) for w, s0 in zip(
        tree_leaves(new0["params"]), tree_leaves(state["params"]))))
    mu0 = new0["opt"]["mu"]
    del new0, tb
    torch.cuda.empty_cache()
    placed = {}

    def make_args(b):
        # the placed state (a copy) stands in for the state from here on
        placed["args"] = b.shard(state, batch)
        state.clear()
        torch.cuda.empty_cache()
        return placed["args"]
    r = mesh_step(cfg, mesh, ShapeConfig("mesh_train", S, B, "train"),
                  make_args, f"moe train {cfg.name} B={B} S={S} {L} layer")
    new, met = r["out"]
    loss_rel, norm_rel = (abs(float(met[k].full_tensor()) - float(met0[k]))
                          / abs(float(met0[k])) for k in ("loss", "grad_norm"))
    mu_rel = max(rel_max(g, w) for g, w in zip(tree_leaves(new["opt"]["mu"]),
                                               tree_leaves(mu0)))
    old = placed["args"][0]["params"]
    step = math.sqrt(sum(float(((g.full_tensor() - s0.full_tensor()) ** 2)
                               .sum()) for g, s0 in zip(tree_leaves(
                                   new["params"]), tree_leaves(old))))
    lr, aux = float(met0["lr"]), float(met0["aux"])
    launches = r["launches"]
    want = {"bfloat16": 2 * L, "float32": 0}        # forward, remat
    del r, new, met, mu0, old, placed
    torch.cuda.empty_cache()
    ok = (loss_rel <= MESH_LOSS_RTOL and norm_rel <= MESH_GRAD_RTOL
          and mu_rel <= FUNC_RTOL[torch.bfloat16] and lr > 0 and aux > 0
          and step0 > 0 and abs(step / step0 - 1) <= MESH_GRAD_RTOL
          and launches == want)
    log(f"check mesh moe train from step {MESH_TRAIN_STEP} (lr {lr!r}, aux "
        f"{aux!r}) vs no mesh: loss {loss_rel!r} (limit {MESH_LOSS_RTOL}), "
        f"grad_norm {norm_rel!r} (limit {MESH_GRAD_RTOL}), first moment "
        f"{mu_rel!r} of each leaf's largest (limit "
        f"{FUNC_RTOL[torch.bfloat16]}), the master's step norm {step!r} vs "
        f"{step0!r} (limit {MESH_GRAD_RTOL} relative), flash launches "
        f"{launches} (want {want}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("mesh moe train check failed")
    return launches


def mesh_path(dev, card) -> dict:
    """Phase 11e: the dry-run cells, then the mesh step on the card (see
    the module docstring). Returns the tensor-core flash launches of the
    mesh steps by kind."""
    import dataclasses as dc
    import socket

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves
    t_phase = time.perf_counter()
    dry_run_cells()
    cfg = get_config(MESH_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    M.open_group(1, backend="nccl" if dev.type == "cuda" else "gloo",
                 init_method=f"tcp://localhost:{port}")
    launches = {}
    try:
        mesh = M.make_test_mesh(1, 1, device_type=dev.type)
        plain = Model(cfg, device=dev, seed=SEED)
        # prefill
        B, S = MESH_PREFILL
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev, dtype=torch.int32)
        r = mesh_step(cfg, mesh, ShapeConfig("mesh_prefill", S, B, "prefill"),
                      lambda b: b.shard({"tokens": tokens}), f"prefill B={B} "
                      f"S={S}")
        want = plain.prefill({"tokens": tokens})[0]
        got = r["out"][0].full_tensor()
        err = float((got - want).abs().max() / want.abs().max())
        launches["prefill"] = r["launches"]
        del r, got, want
        torch.cuda.empty_cache()
        ok = err <= MESH_LOGITS_RTOL and launches["prefill"] == {
            "bfloat16": cfg.n_layers, "float32": 0}
        log(f"check mesh prefill: logits vs no mesh {err!r} of the largest "
            f"(limit {MESH_LOGITS_RTOL}), flash launches "
            f"{launches['prefill']} (want {cfg.n_layers} bf16) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("mesh prefill check failed")
        # the kernel at that prefill's shape against the plain version (the
        # step without a mesh launches the same kernel)
        flash_err = check_mesh_flash(dev)
        torch.cuda.empty_cache()
        # decode from a seeded cache
        B, W = MESH_DECODE
        cache = {k: torch.randn((cfg.n_layers, B, W, cfg.n_kv_heads,
                                 cfg.hd()), generator=gen, device=dev,
                                dtype=torch.bfloat16) for k in ("k", "v")}
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=dev, dtype=torch.int32)
        pos = torch.randint(W // 2, W, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        r = mesh_step(cfg, mesh, ShapeConfig("mesh_decode", W, B, "decode"),
                      lambda b: b.shard({k: v.clone() for k, v in
                                         cache.items()}, tok, pos),
                      f"decode B={B} W={W}")
        want, want_cache = plain.decode_step(cache, tok, pos)
        got, got_cache = r["out"]
        err = float((got.full_tensor() - want).abs().max()
                    / want.abs().max())
        rows = max(float((got_cache[k].full_tensor() - want_cache[k]).abs()
                         .max() / want_cache[k].abs().max())
                   for k in ("k", "v"))
        launches["decode"] = r["launches"]
        del r, got, got_cache, want, want_cache, cache
        torch.cuda.empty_cache()
        ok = max(err, rows) <= MESH_LOGITS_RTOL and launches[
            "decode"] == {"bfloat16": 0, "float32": 0}
        log(f"check mesh decode: logits vs no mesh {err!r} of the largest, "
            f"the written caches {rows!r} of their largest (limit "
            f"{MESH_LOGITS_RTOL}), flash launches {launches['decode']} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("mesh decode check failed")
        del plain
        torch.cuda.empty_cache()
        # one train step at full width, 2 layers
        B, S, L = MESH_TRAIN
        cfg2 = dc.replace(cfg, n_layers=L)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                  device=dev, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        model2 = Model(cfg2, device=dev, seed=SEED)
        tb = steps.build_train(cfg2)
        state = tb.init_state(model2)
        state["step"].fill_(MESH_TRAIN_STEP)
        new0, met0 = tb.step(state, batch)
        r = mesh_step(cfg2, mesh, ShapeConfig("mesh_train", S, B, "train"),
                      lambda b: b.shard(state, batch),
                      f"train B={B} S={S} {L} layers")
        new, met = r["out"]
        loss_rel, norm_rel = (abs(float(met[k].full_tensor())
                                  - float(met0[k])) / abs(float(met0[k]))
                              for k in ("loss", "grad_norm"))
        mu_rel = max(float((g.full_tensor() - w).abs().max()
                           / w.abs().max())
                     for g, w in zip(tree_leaves(new["opt"]["mu"]),
                                     tree_leaves(new0["opt"]["mu"])))
        pairs = list(zip(tree_leaves(new["params"]),
                         tree_leaves(new0["params"]),
                         tree_leaves(state["params"])))
        # the norm of each step over the whole master, and (printed) the
        # largest elementwise gap of a leaf, of its largest
        step = math.sqrt(sum(float(((g.full_tensor() - s0) ** 2).sum())
                             for g, _, s0 in pairs))
        step0 = math.sqrt(sum(float(((w - s0) ** 2).sum())
                              for _, w, s0 in pairs))
        prel = max(float((g.full_tensor() - w).abs().max()
                         / w.abs().max()) for g, w, _ in pairs)
        lr = float(met0["lr"])
        launches["train"] = r["launches"]
        want_launches = {"bfloat16": 2 * L, "float32": 0}  # fwd, remat
        del r, model2, tb, met0, new0, new, met, state, pairs
        torch.cuda.empty_cache()
        ok = (loss_rel <= MESH_LOSS_RTOL and norm_rel <= MESH_GRAD_RTOL
              and mu_rel <= FUNC_RTOL[torch.bfloat16] and lr > 0
              and step0 > 0 and abs(step / step0 - 1) <= MESH_GRAD_RTOL
              and launches["train"] == want_launches)
        log(f"check mesh train from step {MESH_TRAIN_STEP} (lr {lr!r}) vs "
            f"no mesh: loss {loss_rel!r} (limit {MESH_LOSS_RTOL}), "
            f"grad_norm {norm_rel!r} (limit {MESH_GRAD_RTOL}), first "
            f"moment {mu_rel!r} of each leaf's largest (limit "
            f"{FUNC_RTOL[torch.bfloat16]}), the master's step norm {step!r} "
            f"vs {step0!r} (limit {MESH_GRAD_RTOL} relative; the master "
            f"elementwise {prel!r} of each leaf's largest, not checked), "
            f"flash launches {launches['train']} (want {want_launches}) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("mesh train check failed")
        # the moe, hybrid, ssm, audio and vlm families' bundles, and the
        # moe train step (its local_map backward)
        for bundle in MESH_FAMILY_BUNDLES:
            launches[bundle[0]] = family_bundle(dev, mesh, gen, *bundle)
        launches["moe train"] = mesh_moe_train(dev, mesh, gen)
    finally:
        M.close_group()
    wall = time.perf_counter() - t_phase
    log(f"mesh phase wall {wall!r} s (budget {MESH_PHASE_S} s"
        f"{'' if wall <= MESH_PHASE_S else ', OVER'}) [{card}]")
    return {"launches": {k: v["bfloat16"] for k, v in launches.items()},
            "flash_err": flash_err}


# phase 11f: the Trainer on the card's (1, 1) mesh, phase 11d's cell
# (full-width llama3.2-1b, train_4k's 4,096 tokens at a global batch of 8
# in 2 microbatches, its 8-step schedule) preempted after its first
# MESH_TRAINER_STEPS steps (a full-depth checkpoint from the mesh), each
# step held to phase 11d's run without a mesh at phase 11e's limits; the
# checkpoint round trip at MESH_ROUNDTRIP_LAYERS layers, full width (the
# ~4.6 GB state of one step), mesh -> no mesh -> mesh, bit for bit
MESH_TRAINER_STEPS = 3
MESH_ROUNDTRIP_LAYERS = 2
MESH_TRAINER_PHASE_S = 150.0


def open_card_group(dev) -> None:
    """A one-rank default group over the card (nccl) on a free port."""
    import socket

    from repro_torch.launch import mesh as M
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    M.open_group(1, backend="nccl" if dev.type == "cuda" else "gloo",
                 init_method=f"tcp://localhost:{port}")


def mesh_trainer_steps(dev, mesh, root, card, trained) -> dict:
    """`Trainer(cfg, mesh, ...)` on phase 11d's cell and schedule, counted
    (the counters at 0 just before it), preempted after
    MESH_TRAINER_STEPS steps. Before each mesh step the step without a
    mesh runs on the same state and batch (uncounted; on the card's
    one-rank mesh a DTensor's local tensor is the whole): the mesh step's
    loss, gradient norm and step norm on the master are held to it at
    phase 11e's limits. The trajectory is held to phase 11d's run, whose
    states part from the mesh run's after the first update by bf16
    products summed in another order, within one bf16 unit. A step's
    peak memory is the allocator's peak over the mesh step alone."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import is_dtensor
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.training import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k_b8", TRAIN_SEQ, TRAIN_BATCH, "train")
    tr = Trainer(cfg, mesh, shape, TrainConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        ckpt_dir=str(root / "full"), keep_last=1, log_every=1,
        microbatches=TRAIN_MICRO, device=dev.type,
        preempt_at=MESH_TRAINER_STEPS,
        log_fn=lambda m: log(f"  mesh train {TRAIN_ARCH}: {m}")))
    got = instrument_trainer(tr)
    per_step, norms, saves = got["launches"], got["norms"], got["saves"]
    plain = build_train(cfg, microbatches=TRAIN_MICRO,
                        total_steps=TRAIN_STEPS)
    mesh_step, same = tr.step_fn, []

    def checked_step(state, batch):
        local = lambda t: t.to_local() if is_dtensor(t) else t  # noqa: E731
        with uncounted():
            s0 = tree_map(local, state)
            new0, met0 = plain.step(s0, tree_map(local, batch))
            same.append({"loss": float(met0["loss"]),
                         "grad_norm": float(met0["grad_norm"]),
                         "norm": step_norm(new0["params"], s0["params"])})
            del s0, new0, met0
        torch.cuda.reset_peak_memory_stats(dev)
        return mesh_step(state, batch)
    tr.step_fn = checked_step
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    state, hist = tr.run()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    peak, walls = max(got["peaks"]), got["walls"]
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)  # noqa: E731
    same_rel = {k: [rel(a, b[k]) for a, b in zip(
        [h[k] for h in hist] if k != "norm" else norms, same)]
        for k in ("loss", "grad_norm", "norm")}
    ref = trained["history"][:MESH_TRAINER_STEPS]
    traj = {k: [rel(h[k], r[k]) for h, r in zip(hist, ref)]
            for k in ("loss", "grad_norm")}
    traj["norm"] = [rel(a, b) for a, b in zip(norms, trained["norms"])]
    meshed = all(is_dtensor(t) for t in tree_leaves(state["params"]))
    want = MESH_TRAINER_STEPS * TRAIN_LAUNCHES_PER_STEP
    ok = ([h["step"] for h in hist] == list(range(MESH_TRAINER_STEPS))
          and len(same) == MESH_TRAINER_STEPS
          and all(math.isfinite(h["loss"]) for h in hist)
          and max(same_rel["loss"]) <= MESH_LOSS_RTOL
          and max(same_rel["grad_norm"] + same_rel["norm"])
          <= MESH_GRAD_RTOL
          and max(max(v) for v in traj.values()) <= MESH_GRAD_RTOL
          and meshed and tr._preempted
          and latest_step(str(root / "full")) == MESH_TRAINER_STEPS
          and all(c[torch.bfloat16] == TRAIN_LAUNCHES_PER_STEP
                  and c[torch.float32] == 0 for c in per_step)
          and counts["flash_attention_tc"] == want
          and counts["flash_attention_f32"] == 0)
    log(f"check mesh trainer: {TRAIN_ARCH} full width on the card's (1, 1) "
        f"mesh, {MESH_TRAINER_STEPS} steps of the {TRAIN_STEPS}-step "
        f"schedule then the preemption checkpoint, in {run_s!r} s; each "
        f"mesh step vs the step without a mesh from the same state: loss "
        f"{same_rel['loss']!r} (limit {MESH_LOSS_RTOL}), grad_norm "
        f"{same_rel['grad_norm']!r}, the master's step norm "
        f"{same_rel['norm']!r} (limit {MESH_GRAD_RTOL}); the trajectory vs "
        f"phase 11d's run: loss {traj['loss']!r}, grad_norm "
        f"{traj['grad_norm']!r}, step norm {norms!r} vs "
        f"{trained['norms'][:MESH_TRAINER_STEPS]!r}: {traj['norm']!r} "
        f"(limit {MESH_GRAD_RTOL}); the master DTensors {meshed}; "
        f"tensor-core flash launches per step "
        f"{[c[torch.bfloat16] for c in per_step]} (expected "
        f"{TRAIN_LAUNCHES_PER_STEP}), float32 "
        f"{[c[torch.float32] for c in per_step]}; launch counters {counts}; "
        f"checkpoint calls (kind, step, s) {saves!r} "
        f"{'ok' if ok else 'FAILED'}")
    log(f"time mesh train step {TRAIN_ARCH}: step walls to a synchronize "
        f"{walls!r} s, in the loop {[h['time_s'] for h in hist]!r} s (each "
        f"with its step without a mesh; phase 11d's loop without a mesh: "
        f"median {trained['wall']!r} s), a mesh step's peak "
        f"torch.cuda.max_memory_allocated {peak} bytes ({peak / 2**30!r} "
        f"GiB; phase 11d's run {trained['peak'] / 2**30!r} GiB), the "
        f"full-depth checkpoint from the mesh {saves[-1][2]!r} s [{card}]")
    if not ok:
        raise RuntimeError("mesh trainer check failed")
    del state, tr
    shutil.rmtree(root / "full", ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention_tc"], "walls": walls[1:],
            "peak": peak, "save_s": saves[-1][2]}


def mesh_checkpoint_round_trip(dev, mesh, root, card) -> dict:
    """llama3.2-1b at MESH_ROUNDTRIP_LAYERS layers, full width: one step of
    `Trainer(cfg, mesh, ...)` and its final checkpoint from the mesh,
    restored without a mesh, that saved without a mesh and restored onto
    the mesh: every leaf bit-equal, placed as the mesh's rules say, each
    manifest naming its writer's mesh; save and restore seconds."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_train
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.training import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=MESH_ROUNDTRIP_LAYERS)
    shape = ShapeConfig("train_4k_b8", TRAIN_SEQ, TRAIN_BATCH, "train")
    tr = Trainer(cfg, mesh, shape, TrainConfig(
        total_steps=1, ckpt_every=TRAIN_STEPS, ckpt_dir=str(root / "rt_mesh"),
        keep_last=1, log_every=100, microbatches=TRAIN_MICRO,
        device=dev.type, log_fn=lambda *a: None))
    got = instrument_trainer(tr)
    on_mesh, _ = tr.run()
    secs = {"save from the mesh": got["saves"][-1][2]}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out
    plain = timed("restore without a mesh", restore_checkpoint,
                  str(root / "rt_mesh"), 1, build_train(cfg).state_like(),
                  device=dev)
    timed("save without a mesh", save_checkpoint, str(root / "rt_plain"), 1,
          plain)
    back = timed("restore onto the mesh", restore_checkpoint,
                 str(root / "rt_plain"), 1, tr.bundle.in_specs[0], mesh=mesh,
                 shardings=tr.bundle.in_placements[0])
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731,E501
    differ = [p for (p, a), b, c in zip(tree_leaves(on_mesh, paths=True),
                                        tree_leaves(plain),
                                        tree_leaves(back))
              if not (torch.equal(full(a), b) and torch.equal(full(c), b)
                      and full(a).dtype == b.dtype == full(c).dtype)]
    want = dict(tree_leaves(tr.bundle.in_placements[0], paths=True,
                            leaf=lambda x: x is None
                            or isinstance(x, tuple)))
    misplaced = [p for p, t in tree_leaves(back, paths=True)
                 if tuple(getattr(t, "placements", ())) != tuple(
                     want[p] or ())]
    manifests = [json.loads((root / d / f"step_{1:09d}" / "manifest.json")
                            .read_text()).get("mesh")
                 for d in ("rt_mesh", "rt_plain")]
    n = sum(t.numel() * t.element_size() for t in tree_leaves(plain))
    ok = (not differ and not misplaced
          and manifests == [{"shape": [1, 1], "axis_names": ["data",
                                                            "model"]}, None])
    log(f"check mesh checkpoint round trip: {TRAIN_ARCH} {MESH_ROUNDTRIP_LAYERS}"
        f" layers full width ({n} bytes of state, {len(tree_leaves(plain))} "
        f"leaves) mesh -> no mesh -> mesh: leaves that differ {differ}, "
        f"misplaced {misplaced}, manifests' meshes {manifests}; seconds "
        f"{secs!r} [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("mesh checkpoint round trip failed")
    del on_mesh, plain, back, tr
    torch.cuda.empty_cache()
    return {"secs": secs, "bytes": n}


def mesh_train_path(dev, card, trained) -> dict:
    """Phase 11f: the Trainer on a one-rank nccl group's (1, 1) mesh over
    the card, and its checkpoints across meshes (see the module
    docstring)."""
    from repro_torch.launch import mesh as M
    t_phase = time.perf_counter()
    root = ROOT / "build" / "smoke_mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    open_card_group(dev)
    try:
        mesh = M.make_test_mesh(1, 1, device_type=dev.type)
        steps = mesh_trainer_steps(dev, mesh, root, card, trained)
        trip = mesh_checkpoint_round_trip(dev, mesh, root, card)
    finally:
        M.close_group()
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"mesh trainer phase wall {wall!r} s (budget {MESH_TRAINER_PHASE_S} "
        f"s{'' if wall <= MESH_TRAINER_PHASE_S else ', OVER'}) [{card}]")
    return {**steps, "round_trip": trip}


CODESIGN_ARCHS = ("qwen2-0.5b", "llama3.2-1b", "llama3.2-3b", "minicpm-2b")
README_ARCHS = CODESIGN_ARCHS[:2]
CODESIGN_SHAPE = "decode_32k"
CODESIGN_REPS = 5           # warm walls: the median of this many runs
# benchmarks/bench_runtime.py: virtual step time, vdd ladder, the governed
# macro (gc2t_np 64x64) and the co-design sweep of measured windows; its
# three scenarios in full mode (two chat cycles) come from
# runtime_scenarios(), replayed with its seed
RUNTIME_STEP_S = 1e-6
RUNTIME_LADDER = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1)
RUNTIME_SEED = 17
GOVERNED = dict(cells=("gc2t_np",), word_sizes=(64,), num_words=(64,),
                wwlls=(False,))
MEASURED_CELLS = ("gc2t_np", "gc2t_nn")
# retention on that ladder, card vs CPU: RET_RTOL at every rung from
# vdd x0.6 up; at x0.5 the float32 decay is ill-conditioned (the
# reference's own retention moves by more than 1e-5 there between its
# x64 and plain runs, and the port's CPU run sits up to 1e-5 from its
# plain run: tests/test_torch_runtime.py), so that rung, and the measured
# reports and governor decisions whose choices range over it, take 1e-4
LOW_RUNG = 0.5
LOW_RUNG_RET_RTOL = 1e-4
# card vs CPU (and fleet vs in-process service), by field class: the
# retention-dependent fields (float32 retention on the device) take
# RET_RTOL, the rest of the float64 algebra MATCH_RTOL, a transient
# sweep's t_cell T_CELL_RTOL_F64 and a compile's T_CELL_RTOL_PALLAS (the
# analytic-vs-simulated deviations the same, absolute over 1 + dev)
RET_KEYS = frozenset({"retention_s", "refresh_w", "standby_w",
                      "energy_per_inference_j",
                      "total_energy_per_inference_j", "refresh_interval_s",
                      "e_refresh_j", "retention"})
DEV_KEYS = frozenset({"rel_dev", "max_rel_dev", "mean_rel_dev",
                      "analytic_vs_sim_dev"})
FLEET_WORKERS = 2
# device memory of one worker's CUDA context, at least: nvidia-smi's
# compute processes grew by ~2.3 GiB a worker (context, torch's kernels,
# the two kernel libraries) on NVIDIA H100 80GB HBM3
CONTEXT_MIB = 256
FLEET_READY_S = 120.0       # cold start of every worker, at most
FLEET_RUN_S = 300.0         # Fleet.run's limit
COMPILE_LAUNCHES = 6 * READ_STEPS     # one compile's Gauss-Jordan launches
# Queue 3 F1: repeated runs on the card, compared bit for bit: an 8-point
# gc2t_np sweep through the sparse-LU engine (one topology group) and the
# compile flow's simulated read (dense stamps)
F1_SWEEP = dict(cells=("gc2t_np",), word_sizes=(16, 32),
                num_words=(16, 32, 64, 128), wwlls=(False,),
                fidelity="transient", solver="sparse")


def as_json(obj):
    return json.loads(json.dumps(obj, default=str))


def json_worst(got, want, t_cell_rtol, key="", ret=False, worst=None):
    """Walk two JSON results: raise on any difference of structure, flag,
    count, name or choice, and return the largest error of each float
    class (RET_KEYS, and everything under "retention", are retention;
    see the limits above)."""
    if worst is None:
        worst = {"analytic": 0.0, "retention": 0.0, "t_cell": 0.0}
    ret = ret or key in RET_KEYS
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise RuntimeError(f"{key}: keys differ")
        for k in want:
            json_worst(got[k], want[k], t_cell_rtol, k, ret, worst)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise RuntimeError(f"{key}: lengths differ")
        for g, w in zip(got, want):
            json_worst(g, w, t_cell_rtol, key, ret, worst)
    elif isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            if not (math.isnan(want) and math.isnan(got)):
                raise RuntimeError(f"{key}: {got!r} != {want!r}")
        elif key in DEV_KEYS:
            worst["t_cell"] = max(worst["t_cell"],
                                  abs(got - want) / (1 + abs(want)))
        else:
            cls = "t_cell" if key == "t_cell_sim_s" else \
                "retention" if ret else "analytic"
            worst[cls] = max(worst[cls], rel_err(got, want))
    elif got != want:
        raise RuntimeError(f"{key}: {got!r} != {want!r}")
    return worst


def hold_json(label, got, want, t_cell_rtol=T_CELL_RTOL_F64,
              ret_rtol=RET_RTOL) -> dict:
    """`got` (the card's) against `want` within the limits above."""
    worst = json_worst(as_json(got), as_json(want), t_cell_rtol)
    limits = {"analytic": MATCH_RTOL, "retention": ret_rtol,
              "t_cell": t_cell_rtol}
    if any(worst[k] > limits[k] for k in worst):
        raise RuntimeError(f"{label}: {worst} over {limits}")
    return worst


def hold_responses(label, got, want, reqs) -> dict:
    """Service responses by id: `ok` and errors equal, results within the
    limits (a compile's t_cell at T_CELL_RTOL_PALLAS); the transport
    bookkeeping (waves, walls, attempts) is not compared."""
    kinds = {r["id"]: r["query"]["type"] for r in reqs}
    got = {r["id"]: r for r in got}
    want = {r["id"]: r for r in want}
    if got.keys() != want.keys():
        raise RuntimeError(f"{label}: request ids differ")
    worst = {"analytic": 0.0, "retention": 0.0, "t_cell": 0.0}
    for rid, w in want.items():
        g = got[rid]
        if (g["ok"], g.get("error")) != (w["ok"], w.get("error")):
            raise RuntimeError(f"{label} {rid}: ok/error {g['ok']} "
                               f"{g.get('error')!r} vs {w['ok']} "
                               f"{w.get('error')!r}")
        if w["ok"]:
            tol = T_CELL_RTOL_PALLAS if kinds[rid] == "compile" \
                else T_CELL_RTOL_F64
            try:
                one = hold_json(f"{label} {rid}", g["result"], w["result"],
                                tol)
            except RuntimeError as e:
                raise RuntimeError(f"{label} {rid}: {e}") from e
            worst = {k: max(worst[k], one[k]) for k in worst}
    return worst


def codesign_path(card, labels=("dense archs", "moe and hybrid archs",
                                 "README quickstart")) -> None:
    """`CoDesignQuery` through `Session(device="cuda")`, the queries of
    `labels`: the dense archs, mixtral-8x7b with zamba2-2.7b, the README's
    quickstart, or xlstm-1.3b with whisper-large-v3 and internvl2-1b, each
    in a fresh session with the counters at 0: no kernel launch, one vdd
    evaluation and one cube; held to the CPU session's report; a fresh
    session on the store the first wrote evaluates nothing; the warm
    wall."""
    from repro_torch.api import CoDesignQuery, Session
    from repro_torch.workloads import profile_arch
    archs = {"dense archs": CODESIGN_ARCHS,
             "moe and hybrid archs": (MOE_ARCH, HYBRID_ARCH),
             "README quickstart": README_ARCHS,
             "ssm, audio and vlm archs": (XLSTM_ARCH, WHISPER_ARCH,
                                          VLM_ARCH)}
    queries = {label: CoDesignQuery(
        tuple(profile_arch(a, CODESIGN_SHAPE) for a in archs[label]),
        **({"vdd_scales": VDD_LADDER} if label == "README quickstart"
           else {})) for label in labels}
    store = ROOT / "build" / "smoke_codesign_store"
    for label, q in queries.items():
        sess = Session(device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        rep = sess.run(q)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        n = launch_counts()
        st = dict(sess.executor.stats)
        picks = [f"{p['workload']} {lvl}: " + (
            f"{e['bank']['cell']} {e['bank']['word_size']}x"
            f"{e['bank']['num_words']} at vdd x{e['vdd_scale']} x "
            f"{e['banks_needed']} banks" if e["feasible"] else "infeasible")
            for p in rep for lvl, e in p["levels"].items()]
        log(f"codesign {label}: {len(q.profiles)} profiles x "
            f"{len(q.vdd_scales)} rungs x {rep.as_dict()['n_configs']} "
            f"configs on the card in {cold:.3f} s (fresh session), launches "
            f"{n}, executor stats {st}; " + "; ".join(picks))
        if any(n.values()) or st.get("cube_calls") != 1 \
                or st.get("vdd_evals") != 1:
            raise RuntimeError(f"codesign {label}: launches or stats")
        worst = hold_json(f"codesign {label}", rep.as_dict(),
                          Session(device="cpu").run(q).as_dict())
        log(f"codesign {label} card vs CPU: choices, verdicts and banks "
            f"equal; analytic fields max rel {worst['analytic']!r} (limit "
            f"{MATCH_RTOL}), retention-dependent {worst['retention']!r} "
            f"(limit {RET_RTOL})")
        shutil.rmtree(store, ignore_errors=True)
        try:
            first = Session(store=store, device="cuda").run(q)
            fresh = Session(store=store, device="cuda")
            again = fresh.run(q)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        fst = dict(fresh.executor.stats)
        same = as_json(again.as_dict()) == as_json(first.as_dict())
        log(f"codesign {label} store: a fresh session on the store evaluates "
            f"{fst.get('vdd_evals', 0)} vdd lattices and "
            f"{fst.get('eval_batch_calls', 0)} batches (store hits "
            f"{fst.get('store_hits', 0)}), report equal {same}")
        if fst.get("vdd_evals", 0) or fst.get("eval_batch_calls", 0) \
                or not same:
            raise RuntimeError(f"codesign {label}: store replay")
        walls = []
        for _ in range(CODESIGN_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Session(device="cuda").run(q)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"time codesign {label} warm (fresh session): "
            f"{', '.join(repr(w) for w in walls)} s, median "
            f"{statistics.median(walls)!r} s [{card}]")


def runtime_scenarios():
    """benchmarks/bench_runtime.py's scenarios, full mode."""
    from repro_torch.runtime import Phase, Scenario
    chat = []
    for c in range(2):
        chat += [Phase(f"burst{c}", 4, 24, 24, 7),
                 Phase(f"quiet{c}a", 1, 6, 8, 8),
                 Phase(f"quiet{c}b", 0, 0, 0, 8)]
    return [Scenario("chat_burst", tuple(chat)),
            Scenario("batch_offline", (Phase("fill", 8, 32, 28, 7),
                                       Phase("steady", 0, 0, 0, 7),
                                       Phase("drain", 0, 0, 0, 4),
                                       Phase("drain2", 0, 0, 0, 4))),
            Scenario("long_context", (Phase("admit", 2, 40, 20, 6),
                                      Phase("steady", 2, 40, 20, 6),
                                      Phase("tail", 1, 40, 12, 6)))]


def runtime_path(dev, card) -> dict:
    """The measured loop at full width: `llama3.2-1b` in bf16 with seeded
    weights behind a `TelemetryCollector` on a virtual clock, the three
    scenarios replayed through `run_scenario` with the counters at 0:
    every prefill attention through the tensor-core flash kernel, every
    request its budget. Then `codesign_measured` on the card against the
    CPU session on the same windows, each window's profile against the
    analytic one, and the vdd governor over the card's lattice against the
    CPU's, beside every fixed rung."""
    from repro_torch.api import Session, SweepQuery
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime import (GovernorPolicy, TelemetryCollector,
                                     VddGovernor, diff_profiles,
                                     measured_profile, replay_fixed,
                                     run_scenario, traffic_from_window)
    from repro_torch.serving import ServeEngine
    from repro_torch.workloads import profile_config
    cfg = get_config(SERVE_ARCH)
    model = Model(cfg, device=dev, seed=SEED)
    col = TelemetryCollector(step_time_s=RUNTIME_STEP_S)
    eng = ServeEngine(cfg, model, n_slots=SERVE_SLOTS, window=SERVE_WINDOW,
                      decode_chunk=SERVE_CHUNK, seed=SEED, telemetry=col)
    windows, rid, served = {}, 0, 0
    reset_counts()
    t0 = time.perf_counter()
    for sc in runtime_scenarios():
        eng.done = []
        windows[sc.name] = run_scenario(eng, sc, seed=RUNTIME_SEED,
                                        collector=col, rid_base=rid)
        n_req = sum(ph.n_requests for ph in sc.phases)
        rid += n_req
        served += len(eng.done)
        if len(eng.done) != n_req or any(
                len(r.out_tokens) != r.max_new_tokens for r in eng.done):
            raise RuntimeError(f"runtime replay {sc.name}: budgets")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()
    want = cfg.n_layers * eng.admit_syncs
    decoded = n["decode_attention"]
    log(f"runtime replay: {cfg.name} {cfg.dtype} full width, {served} "
        f"requests over {sum(map(len, windows.values()))} windows of 3 "
        f"scenarios in "
        f"{wall:.2f} s, every request its budget; {eng.admit_syncs} prefill "
        f"dispatches, launches {n} (flash_attention_tc expected {want}, "
        f"decode_attention {cfg.n_layers} a decode step)")
    if n["flash_attention_tc"] != want or decoded <= 0 \
            or decoded % cfg.n_layers or sum(n.values()) != want + decoded:
        raise RuntimeError("runtime replay flash launches")
    tc_launches = n["flash_attention_tc"]
    del eng, model
    torch.cuda.empty_cache()

    wins = [w for ws in windows.values() for w in ws if w.decode_steps > 0]
    kw = dict(sweep=SweepQuery(cells=MEASURED_CELLS),
              vdd_scales=RUNTIME_LADDER, step_time_s=RUNTIME_STEP_S)
    sessions = [Session(device=d) for d in ("cuda", "cpu")]
    card_rep, cpu_rep = (s.codesign_measured(wins, cfg, **kw)
                         for s in sessions)
    ret = [s.vdd_lattice(kw["sweep"], RUNTIME_LADDER).retention_s
           for s in sessions]
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.where(ret[0] == ret[1], 0.0,
                       np.abs(ret[0] - ret[1]) / np.abs(ret[1]))
    per_rung = dict(zip(RUNTIME_LADDER, gap.max(axis=1).tolist()))
    log(f"measured lattice ({len(card_rep.lattice.cfgs)} configs x "
        f"{len(RUNTIME_LADDER)} rungs): retention card vs CPU, max rel per "
        f"rung {per_rung} (limit {LOW_RUNG_RET_RTOL} at x{LOW_RUNG}, "
        f"{RET_RTOL} above)")
    if any(e > (LOW_RUNG_RET_RTOL if v <= LOW_RUNG else RET_RTOL)
           for v, e in per_rung.items()):
        raise RuntimeError("measured lattice retention card vs CPU")
    worst = hold_json("codesign_measured", card_rep.as_dict(),
                      cpu_rep.as_dict(), ret_rtol=LOW_RUNG_RET_RTOL)
    log(f"codesign_measured: {len(card_rep.plans)} measured windows, all "
        f"feasible {card_rep.all_feasible}; card vs CPU equal choices, "
        f"analytic max rel {worst['analytic']!r}, retention-dependent "
        f"{worst['retention']!r}")
    for i, w in enumerate(wins):
        B = max(1, round(w.mean_batch))
        S = max(1, round(w.mean_kv_rows / B))
        dev_ = diff_profiles(
            measured_profile(w, cfg, shape=f"win{i}",
                             step_time_s=RUNTIME_STEP_S),
            profile_config(cfg, ShapeConfig(f"win{i}", S, B, "decode"),
                           n_devices=1, step_time_s=RUNTIME_STEP_S))
        log(f"  diff_profiles win{i} vs analytic decode (B={B}, S={S}): "
            f"{dev_}")

    lats = [Session(device=d).vdd_lattice(SweepQuery(**GOVERNED),
                                          RUNTIME_LADDER)
            for d in ("cuda", "cpu")]
    policy = GovernorPolicy()
    traffics = {k: [traffic_from_window(w, cfg) for w in ws]
                for k, ws in windows.items()}
    peak = max(t.read_hz for ts in traffics.values() for t in ts)
    n_banks = math.ceil(policy.headroom * peak
                        / float(lats[0].f_max_hz[-1, 0]))
    gov_total, fixed = 0.0, [0.0] * len(RUNTIME_LADDER)
    for name, ts in traffics.items():
        govs = [VddGovernor(lat, 0, n_banks, policy) for lat in lats]
        for gov in govs:
            for t in ts:
                gov.observe(t)
        hold_json(f"governor {name}",
                  [dataclasses.asdict(d) for d in govs[0].decisions],
                  [dataclasses.asdict(d) for d in govs[1].decisions],
                  ret_rtol=LOW_RUNG_RET_RTOL)
        gov_total += govs[0].total_energy_j
        for vi in range(len(RUNTIME_LADDER)):
            fixed[vi] += replay_fixed(lats[0], 0, n_banks, ts, vi, policy)
        log(f"  governor {name}: rungs "
            f"{[d.vdd_scale for d in govs[0].decisions]}, "
            f"{sum(d.switched for d in govs[0].decisions)} switches, "
            f"{govs[0].total_energy_j!r} J; decisions equal to the CPU's")
    log(f"governor: gc2t_np 64x64 x {n_banks} banks, total "
        f"{gov_total!r} J; fixed rungs "
        + ", ".join(f"vdd x{v}: {e!r} J" for v, e in zip(RUNTIME_LADDER,
                                                        fixed)))
    return {"launches": tc_launches}


def service_requests() -> list:
    """benchmarks/bench_fleet.py's smoke workload (4 tenants: sweep, match,
    codesign and unique per tenant, then the poison request), plus one
    transient sweep of the default lattice and one simulated compile, both
    with solver "pallas"."""
    nw, archs = (16, 32, 64), CODESIGN_ARCHS[:2]
    shared = {"cells": ["gc2t_nn", "gc2t_osos"], "word_sizes": [16, 32],
              "num_words": list(nw)}
    reqs = []
    for i in range(4):
        t = f"t{i}"
        reqs += [
            {"id": f"{t}-sweep", "tenant": t, "query": {
                "type": "sweep", "cells": shared["cells"],
                "word_sizes": shared["word_sizes"],
                "num_words": list(nw[:2 + i % max(1, len(nw) - 2)])}},
            {"id": f"{t}-match", "tenant": t, "query": {
                "type": "match", "demands": [
                    {"name": f"{t}-act", "level": "L1",
                     "read_freq_hz": 2.0e8 * (1 + i), "lifetime_s": 2.0e-6},
                    {"name": f"{t}-kv", "level": "L2",
                     "read_freq_hz": 4.0e8 * (1 + i), "lifetime_s": 1.0e-3,
                     "capacity_bits": 1 << 20}],
                "sweep": shared}},
            {"id": f"{t}-codesign", "tenant": t, "query": {
                "type": "codesign",
                "profiles": [{"arch": archs[i % len(archs)],
                              "shape": CODESIGN_SHAPE}],
                "vdd_scales": [0.85, 1.0], "sweep": shared}},
            {"id": f"{t}-unique", "tenant": t, "query": {
                "type": "sweep", "cells": ["gc2t_nn"], "word_sizes": [8],
                "num_words": [nw[i % len(nw)]], "write_vts": [None],
                "wwlls": [i % 2 == 1]}}]
    reqs.append({"id": "POISON-req", "tenant": "chaos", "query": {
        "type": "sweep", "cells": ["gc2t_nn"], "word_sizes": [8],
        "num_words": [16]}})
    reqs.append({"id": "transient", "tenant": "t0", "query": {
        "type": "sweep", "fidelity": "transient", "solver": "pallas"}})
    reqs.append({"id": "compile", "tenant": "t1", "query": {
        "type": "compile", "simulate": True, "solver": "pallas",
        "cfg": {"word_size": 16, "num_words": 64, "cell": "gc2t_nn"}}})
    return reqs


def serve_lines(svc, reqs) -> list:
    return [json.loads(line)
            for line in svc.serve_lines(json.dumps(r) for r in reqs)]


def service_path(cfgs, cpu_chars, n_groups, card) -> dict:
    """`CompileService(device="cuda")` on the request mix in one wave, the
    counters at 0: one scan launch per topology group (the transient
    sweep) and one compile's Gauss-Jordan launches, all warp; every
    response held to the port's CPU service on the same lines (its
    transient cache seeded with phase 4's CPU characterization); the wave
    statistics and the wall, cold and warm."""
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.launch.compile_service import (CompileService,
                                                    parse_query)
    reqs = service_requests()
    svc = CompileService(device="cuda", wave_size=len(reqs))
    reset_counts()
    batched_solve.warp_launches = batched_solve.block_launches = 0
    t0 = time.perf_counter()
    got = serve_lines(svc, reqs)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    n = launch_counts()
    warp = batched_solve.warp_launches
    st = svc.stats()
    log(f"service: {len(reqs)} requests of {len(st['tenants'])} tenants on "
        f"the card in {st['waves']} wave(s), {cold:.2f} s (cold session), "
        f"{sum(r['ok'] for r in got)} ok; launches {n} (scan expected "
        f"{n_groups}, Gauss-Jordan {COMPILE_LAUNCHES}, of them warp {warp}); "
        f"executor stats {st['executor']}")
    if n["fused_newton_scan"] != n_groups or n["fused_newton"] != 0 \
            or n["gauss_jordan"] != COMPILE_LAUNCHES \
            or warp != COMPILE_LAUNCHES or st["waves"] != 1:
        raise RuntimeError("service launch counts")
    cpu = CompileService(device="cpu", wave_size=len(reqs))
    tq = parse_query(next(r["query"] for r in reqs
                          if r["id"] == "transient"))
    mode = (tq.sim_steps, tq.solver, tq.precision, "modeled")
    for cfg, ch in zip(cfgs, cpu_chars):
        cpu.session._tchars[(cpu.session._key(cfg),) + mode] = ch
    worst = hold_responses("service", got, serve_lines(cpu, reqs), reqs)
    log(f"service card vs CPU: ok flags and errors equal; analytic max rel "
        f"{worst['analytic']!r} (limit {MATCH_RTOL}), retention "
        f"{worst['retention']!r} (limit {RET_RTOL}), t_cell "
        f"{worst['t_cell']!r} (limits {T_CELL_RTOL_F64} sweep, "
        f"{T_CELL_RTOL_PALLAS} compile)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = serve_lines(CompileService(device="cuda", wave_size=len(reqs)),
                        reqs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"time service mix warm (fresh service): {warm!r} s, wave wall "
        f"{again[-1]['wave_wall_s']!r} s [{card}]")
    return {"responses": got, "reqs": reqs, "scan": n["fused_newton_scan"],
            "gauss_jordan": n["gauss_jordan"]}


def compute_apps() -> dict:
    """The card's compute processes as nvidia-smi lists them: pid -> MiB
    of device memory (summed where a pid appears more than once)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    apps = {}
    for line in out.splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = apps.get(int(pid), 0) + float(mib or 0)
    return apps


def fleet_run(reqs, n_workers: int, label: str, faults=None) -> dict:
    """One `Fleet(device="cuda")` run over a fresh spool and store: wait
    for every worker's cold start, read the card's compute processes, run
    the requests (timed), stop the workers."""
    from repro_torch.launch.fleet import Fleet
    base = ROOT / "build" / "smoke_fleet" / label
    shutil.rmtree(base, ignore_errors=True)
    before = compute_apps()
    try:
        with Fleet(str(base / "spool"), str(base / "store"),
                   n_workers=n_workers, device="cuda",
                   wave_size=max(8, len(reqs) // n_workers + 1),
                   deadline_s=120.0, max_attempts=n_workers + 3,
                   backoff_s=0.2, lease_ttl_s=2.0,
                   fault_specs=faults) as fleet:
            deadline = time.monotonic() + FLEET_READY_S
            while len(fleet.ready()) < n_workers \
                    and time.monotonic() < deadline \
                    and all(w.proc is not None and w.proc.poll() is None
                            for w in fleet.workers):
                time.sleep(0.1)
            ready = fleet.ready()
            apps = compute_apps()
            log(f"fleet {label}: the card's compute processes (pid: MiB) "
                f"before the workers {before}, with them ready {apps}")
            t0 = time.perf_counter()
            resp = fleet.run(reqs, timeout_s=FLEET_RUN_S)
            wall = time.perf_counter() - t0
        evals = fleet.eval_summary()
        stats = fleet.stats()
    finally:
        logs = base / "spool" / "logs"
        tails = {p.name: p.read_text()[-2000:] for p in logs.glob("*.log")} \
            if logs.exists() else {}
        shutil.rmtree(base, ignore_errors=True)
    return {"fleet": fleet, "ready": ready, "before": before, "apps": apps,
            "resp": resp,
            "wall": wall, "evals": evals, "stats": stats, "logs": tails}


def workers_on_card(run, n_workers: int) -> tuple:
    """Whether nvidia-smi shows every worker's CUDA context while the
    workers run: each worker's pid among the card's compute processes.
    Where nvidia-smi reports the processes of another pid namespace
    (this process's own pid, which holds a context, is not listed
    either), a worker cannot be found by pid; then the compute processes'
    device memory must have grown by a context per worker since before
    the workers started. Returns (ok, how)."""
    pids = [r["pid"] for r in run["ready"].values()]
    if os.getpid() in run["before"] or any(p in run["apps"] for p in pids):
        return all(p in run["apps"] for p in pids), "worker pids listed"
    grown = sum(run["apps"].values()) - sum(run["before"].values())
    return (grown >= n_workers * CONTEXT_MIB,
            f"pids of another namespace listed ({sorted(run['apps'])}, this "
            f"process {os.getpid()} absent): device memory of the compute "
            f"processes grew {grown!r} MiB with the workers (at least "
            f"{CONTEXT_MIB} MiB a context)")


def check_clean_fleet(run, n_workers: int, n_groups: int) -> None:
    """No degradation: every worker spawned, stayed alive, started CUDA
    (`workers_on_card`), served at least one request and left its stats;
    across workers one scan launch per group and one compile's
    Gauss-Jordan launches; no duplicate evaluation."""
    fleet, stats = run["fleet"], run["stats"]
    on_card, how = workers_on_card(run, n_workers)
    wids = [f"w{i}" for i in range(n_workers)]
    served = {w: sum(t["requests"] for t in stats["workers"].get(w, {}).get(
        "service", {}).get("tenants", {}).values()) for w in wids}
    launches = {k: sum(s.get("launches", {}).get(k, 0)
                       for s in stats["workers"].values())
                for k in ("fused_newton_scan", "gauss_jordan")}
    ok = (not fleet.degraded and all(
        fleet.counters[k] == 0 for k in ("spawn_failures", "worker_deaths",
                                         "degraded_runs", "run_timeouts"))
          and sorted(run["ready"]) == wids
          and on_card
          and all(r["device"] == "cuda" and "cuda_context_s" in
                  r["cold_start"] for r in run["ready"].values())
          and all(served[w] >= 1 for w in wids)
          and launches == {"fused_newton_scan": n_groups,
                           "gauss_jordan": COMPILE_LAUNCHES}
          and run["evals"]["duplicates"] == {})
    log(f"fleet {n_workers} worker(s): degraded {fleet.degraded}, counters "
        f"{dict(fleet.counters)}, worker pids "
        f"{ {w: r['pid'] for w, r in run['ready'].items()} } on the card "
        f"{on_card} ({how}), requests served {served}, "
        f"launches across workers {launches}, evaluations "
        f"{run['evals']['by_reason']} over {run['evals']['unique_keys']} keys,"
        f" duplicates {run['evals']['duplicates']} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        for name, tail in run["logs"].items():
            log(f"--- {name} ---\n{tail}")
        raise RuntimeError("fleet degraded or not on the card")


def fleet_path(service, n_groups, card) -> dict:
    """The fleet on the card over the service's lines: 2 workers (clean),
    held to the in-process service's responses; 1 worker for the wall;
    then bench_fleet.py's chaos spec on 2 workers: every request
    resolves, the poison request is quarantined, the rest equal the clean
    run's."""
    reqs = service["reqs"]
    runs = {}
    for n_workers in (FLEET_WORKERS, 1):
        run = runs[n_workers] = fleet_run(reqs, n_workers,
                                          f"clean{n_workers}")
        check_clean_fleet(run, n_workers, n_groups)
        worst = hold_responses(f"fleet {n_workers}", run["resp"],
                               service["responses"], reqs)
        log(f"fleet {n_workers} worker(s) vs the in-process service on the "
            f"card: ok flags and errors equal, max rel {worst}")
        for wid, r in sorted(run["ready"].items()):
            log(f"fleet {n_workers} worker(s) {wid} cold start: spawn to "
                f"ready {r['spawn_to_ready_s']!r} s, of it "
                f"{r['cold_start']} [{card}]")
        log(f"time fleet {n_workers} worker(s) run ({len(reqs)} requests, "
            f"workers warm): {run['wall']!r} s [{card}]")
    chaos = {"w0": "seed=7,salt=w0,die_after_puts=2,poison=POISON",
             "inline": "poison=POISON"}
    for i in range(1, FLEET_WORKERS):
        chaos[f"w{i}"] = (f"seed=7,salt=w{i},tear_rate=0.4,corrupt_rate=0.3,"
                          f"eval_fail_rate=0.3,eval_slow_rate=0.3,"
                          f"slow_s=0.05,poison=POISON")
    run = fleet_run(reqs, FLEET_WORKERS, "chaos", chaos)
    by_id = {r["id"]: r for r in run["resp"] if r is not None}
    poison = by_id.get("POISON-req", {})
    rest = [r for rid, r in by_id.items() if rid != "POISON-req"]
    ok = (len(by_id) == len(reqs) and not poison.get("ok", True)
          and poison.get("quarantined")
          and poison.get("attempts") == FLEET_WORKERS + 3
          and run["stats"].get("worker_deaths", 0) >= 1
          and run["stats"].get("retries", 0) > 0
          and run["evals"]["duplicates"] == {})
    clean = [r for r in runs[FLEET_WORKERS]["resp"]
             if r["id"] != "POISON-req"]
    counters = {k: v for k, v in run["stats"].items()
                if k not in ("workers", "evals")}
    log(f"fleet chaos ({FLEET_WORKERS} workers): {len(by_id)} of {len(reqs)} "
        f"resolved, poison quarantined {poison.get('quarantined')} after "
        f"{poison.get('attempts')} attempts, stats {counters}, worker faults "
        f"{ {w: s.get('faults') for w, s in run['stats']['workers'].items()} }"
        f", duplicates {run['evals']['duplicates']}, wall {run['wall']!r} s "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("fleet chaos")
    hold_responses("fleet chaos vs clean", rest, clean,
                   [r for r in reqs if r["id"] != "POISON-req"])
    log("fleet chaos: every other response equals the clean run's")
    return {w: {k: sum(s.get("launches", {}).get(k, 0)
                       for s in r["stats"]["workers"].values())
                for k in ("fused_newton_scan", "gauss_jordan")}
            for w, r in runs.items()}


def repeatability() -> None:
    """Queue 3 F1: the sparse-LU sweep and a simulated compile, each run
    twice on the card in fresh sessions, compared bit for bit."""
    from repro_torch.api import Session, SweepQuery
    from repro_torch.core.bank import BankConfig
    from repro_torch.core.compiler import compile_bank
    q = SweepQuery(**F1_SWEEP)
    t = [[c.t_cell_s for c in Session(device="cuda").run(q).transient]
         for _ in range(2)]
    c = [compile_bank(BankConfig(16, 64, cell="gc2t_nn"), simulate=True,
                      solver="pallas", device="cuda").summary()
         for _ in range(2)]
    gap = max(rel_err(a, b) for a, b in zip(*t))
    log(f"repeat (Queue 3 F1): sparse sweep of {len(t[0])} gc2t_np points "
        f"twice: t_cell bit-identical {t[0] == t[1]} (max rel gap {gap!r}); "
        f"compile_bank gc2t_nn 16x64 simulate pallas twice: report "
        f"identical {c[0] == c[1]} (t_cell_sim {c[0]['t_cell_sim_s']!r} / "
        f"{c[1]['t_cell_sim_s']!r})")
    if t[0] != t[1] or c[0] != c[1]:
        raise RuntimeError("repeated runs on the card differ")


def codesign_fleet_phase(dev, cfgs, cpu_chars, n_groups, card) -> dict:
    """Phase 12: co-design, the measured loop, the service and the fleet,
    and the repeatability check."""
    codesign_path(card)
    replay = runtime_path(dev, card)
    service = service_path(cfgs, cpu_chars, n_groups, card)
    fleet = fleet_path(service, n_groups, card)
    repeatability()
    return {"replay": replay["launches"], "service": service,
            "fleet": fleet}


def main() -> int:
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.bank import BankConfig, build_bank
    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.dse_batch import group_by_topology
    from repro_torch.core.spice.char_batch import characterize
    from repro_torch.kernels import build
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.fused import \
        fused_newton_scan_plain
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.kernels.batched_solve.newton import newton_solve_fixed

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    marks = []

    def phase(name: str) -> None:
        """Start phase `name`, logging the wall of the one before it."""
        now = time.perf_counter()
        if marks:
            log(f"phase {marks[-1][0]} wall: {now - marks[-1][1]!r} s")
        marks.append((name, now))

    phase("1")
    # -- 1. card and toolchain
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.strip().splitlines()[-1]}")

    phase("2")
    # -- 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"build: {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    if sorted(paths) != sorted(build.SOURCES):
        log(f"FAILED: built {sorted(paths)}")
        return 1
    for kname, path in paths.items():
        logf = path.with_suffix(".log")
        for line in (logf.read_text().splitlines() if logf.exists() else []):
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                log(f"  {kname}: {entry}")
            elif "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    phase("3")
    # -- 3. kernels against their plain versions on the card
    cfgs = lattice_configs()
    groups = list(group_by_topology(cfgs).values())
    group = [cfgs[i] for i in groups[0]]
    banks = [build_bank(c) for c in group]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err, scan_err = {}, {}
    fused.fused_newton.launches = 0
    for precision, atol in SCAN_ATOL.items():
        spec, pre, Ksrc, params, v0, iters, tol = scan_inputs(
            group, banks, precision, dev)
        lo, hi = SCAN_WINDOW
        pre_b, Ksrc_b, params_b, v0_b = tile_lanes(
            pre, Ksrc[lo:hi].transpose(0, 1), params, v0, SCAN_BIG_BATCH,
            gen)
        Ksrc_b = Ksrc_b.transpose(0, 1).contiguous()
        for label, (p, ks, pa, v) in (
                (f"B={v0.shape[0]} T={N_STEPS}", (pre, Ksrc, params, v0)),
                (f"B={SCAN_BIG_BATCH} T={hi - lo} (steps {lo}..{hi - 1})",
                 (pre_b, Ksrc_b, params_b, v0_b))):
            before = fused.fused_newton_scan.launches
            got = fused.fused_newton_scan(spec, p, ks, pa, v, iters=iters,
                                          tol=tol)
            launched = fused.fused_newton_scan.launches - before
            want = fused_newton_scan_plain(spec, p, ks, pa, v, iters, tol)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            moved = float((want[:, -1].double() - v.double()).abs().max())
            ok = (err <= atol and launched == 1
                  and got.shape == want.shape
                  and bool(torch.isfinite(got).all()))
            log(f"check fused_newton_scan {precision} {label}: max|dv| over "
                f"the trajectory {err!r} V (limit {atol}; the plain run "
                f"moves a node by {moved!r} V), launches {launched} "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                return 1
            if precision == "f64":
                scan_err[label] = err
    for precision, atol in KERNEL_ATOL.items():
        spec, pre, Krhs, params, v0, iters, tol = step_inputs(
            group, banks, precision, dev)
        big = tile_lanes(pre, Krhs, params, v0, BIG_BATCH, gen)
        for label, (p, kr, pa, v) in (("B=16", (pre, Krhs, params, v0)),
                                      (f"B={BIG_BATCH}", big)):
            got = fused.fused_newton(spec, p, kr, pa, v, iters=iters, tol=tol)
            want = newton_solve_fixed(spec, p, kr, pa, v, iters, tol)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            ok = err <= atol and bool(torch.isfinite(got).all())
            log(f"check fused_newton {precision} {label}: max|dv| {err!r} V "
                f"(limit {atol}) {'ok' if ok else 'FAILED'}")
            if not ok:
                return 1
            if precision == "f64":
                max_err[label] = err
    step_launches = fused.fused_newton.launches
    batched_solve.block_launches = 0
    gj_err = check_gauss_jordan(dev)
    gj_block_launches = batched_solve.block_launches
    gc_err = check_gc_array_step(dev)
    fa_err = check_flash_attention(dev)
    da_err = check_decode_attention(dev)

    phase("4")
    # -- 4. the main path, counted
    n_groups = len(groups)
    fused.fused_newton.launches = 0
    fused.fused_newton_scan.launches = 0
    t0 = time.perf_counter()
    gpu = characterize(cfgs, device="cuda")
    first_s = time.perf_counter() - t0
    launches = fused.fused_newton_scan.launches
    log(f"main path: characterize({len(cfgs)} points, {n_groups} groups) on "
        f"the card in {first_s:.2f} s (first call), fused_newton_scan "
        f"launches {launches}, one-step fused_newton launches "
        f"{fused.fused_newton.launches}")
    if launches != n_groups or fused.fused_newton.launches != 0:
        log(f"FAILED: expected {n_groups} scan launches (one per topology "
            f"group) and no one-step launch")
        return 1
    cpu = characterize(cfgs, device="cpu")
    mixed = characterize(cfgs, device="cuda", precision="mixed")
    t_gpu = np.array([r.t_cell_s for r in gpu])
    t_cpu = np.array([r.t_cell_s for r in cpu])
    t_mix = np.array([r.t_cell_s for r in mixed])
    if not (len(t_gpu) == len(cfgs) and np.isfinite(t_gpu).all()
            and (t_gpu > 0).all()):
        log("FAILED: t_cell not finite and positive for every point")
        return 1
    rel_cpu = float(np.max(np.abs(t_gpu - t_cpu) / np.abs(t_cpu)))
    rel_mix = float(np.max(np.abs(t_mix - t_gpu) / np.abs(t_gpu)))
    log(f"t_cell card vs CPU (f64): max rel {rel_cpu!r} (limit "
        f"{T_CELL_RTOL_F64})")
    log(f"t_cell mixed vs f64 (card): max rel {rel_mix!r} (limit "
        f"{T_CELL_RTOL_MIXED})")
    if rel_cpu > T_CELL_RTOL_F64 or rel_mix > T_CELL_RTOL_MIXED:
        log("FAILED: t_cell parity")
        return 1
    for cell, anchor in ANCHORS_PS.items():
        i = cfgs.index(BankConfig(16, 64, cell=cell))
        got_ps = t_gpu[i] * 1e12
        log(f"anchor {cell} 16x64: {got_ps!r} ps (reference {anchor} ps)")
        if abs(got_ps - anchor) > ANCHOR_ATOL_PS:
            log("FAILED: anchor")
            return 1

    phase("5")
    # -- 5. the warm lattice wall (the kernels are timed in phase 12:
    # kernel launches run slower after a profiler session)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        characterize(cfgs, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"time characterize 96 points f64 warm: "
        f"{', '.join(repr(w) for w in walls)} s, median "
        f"{statistics.median(walls)!r} s [{card}]")

    phase("6")
    # -- 6. the compile path and the run_batch sweep, counted
    compiled = compile_path(dev)
    batch_launches = batch_path()

    phase("7")
    # -- 7. the array path, counted
    write_launches = write_path()

    phase("8")
    # -- 8. the match path through the query API, counted, held to the
    # CPU, then its warm walls (before any profiler session)
    matched = match_path(cfgs, cpu, n_groups, compiled, card)
    time_match(cfgs, card)

    phase("9")
    # -- 9. the layout path (counted, held to the CPU and to phase 4's
    # modeled t_cell, replayed from a store), its warm walls and split;
    # then the sparse-LU engine over the same lattice
    layout_path(cfgs, gpu, n_groups)
    time_layout(card)
    sparse_path(cfgs, gpu, card)

    phase("10")
    # -- 10. the gradient path: t_cell_grad_fn under autograd on the card
    # (counted, held to the CPU, central differences, the sparse engine),
    # then OptimizeQuery through the query API; walls and op counts
    grads = grad_path(cfgs, card)
    if grads["launches"] != n_groups:
        log(f"FAILED: gradient path scan launches {grads['launches']}")
        return 1
    optimize_path(card)

    phase("11")
    # -- 11. the serving path at full width, counted, and the card against
    # the CPU at full width and reduced depth
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    log(f"serve path: {cfg.name} {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {model.param_count()} weights, "
        f"seeded init on the card in {time.perf_counter() - t0:.2f} s")
    served = serve_path(model, cfg, dev, card)
    served_int8 = int8_path(model, cfg, dev, card, served["times"])
    del model
    torch.cuda.empty_cache()
    served_f32 = serve_path_f32(dev, card)
    parity_launches = serve_cpu_parity(dev)

    phase("11b")
    # -- 11b. the moe and hybrid families at full width, counted, and the
    # reduced configs on the card against the CPU
    served_moe = moe_path(dev, card)
    served_hybrid = hybrid_path(dev, card)
    family_launches = family_cpu_parity(dev)

    phase("11c")
    # -- 11c. the ssm, audio and vlm families at full width, counted, the
    # reduced configs on the card against the CPU, and co-design over them
    served_ssm = xlstm_path(dev, card)
    served_audio = whisper_path(dev, card)
    served_vlm = vlm_path(dev, card)
    family_11c_launches = family_cpu_parity(dev, FAMILY_11C_CPU_CASES)
    codesign_path(card, labels=("ssm, audio and vlm archs",))

    phase("11d")
    # -- 11d. the training path: the flash Function's gradients against
    # autograd through the plain version, every reduced arch's loss and
    # gradients card vs CPU, the reduced trainer's bit-identical restart,
    # full-width llama3.2-1b trained 8 steps (counted) with its
    # checkpoints, serve from the checkpoint, the backward's timing
    trained = train_path(dev, card)

    phase("11e")
    # -- 11e. the mesh layer: dry-run cells on fake tensors, then the mesh
    # step on a one-rank group over the card, each held to its fake twin
    # and to the step without a mesh
    meshed = mesh_path(dev, card)

    phase("11f")
    # -- 11f. the Trainer on the card's (1, 1) mesh: phase 11d's cell for
    # 3 steps (counted) held to 11d's run without a mesh, its preemption
    # checkpoint, and a 2-layer checkpoint round trip across meshes
    meshed_train = mesh_train_path(dev, card, trained)

    phase("12")
    # -- 12. co-design, the measured loop at full width, the compile
    # service and the fleet on the card, each counted and held to the CPU;
    # then the repeatability of the sparse sweep and the compile
    codesigned = codesign_fleet_phase(dev, cfgs, cpu, n_groups, card)

    phase("13")
    # -- 13. timing of the new paths and kernels, on the card (the walls
    # first: kernel launches run slower after a profiler session)
    time_paths(card)
    scan_t = time_scan(dev, group, banks, card)
    spec, pre, Krhs, params, v0, iters, tol = step_inputs(group, banks, "f64",
                                                          dev)
    cases = {"B=16": (pre, Krhs, params, v0),
             f"B={BIG_BATCH}": tile_lanes(pre, Krhs, params, v0, BIG_BATCH,
                                          gen)}
    timings = {}
    for label, (p, kr, pa, v) in cases.items():
        kern = lambda: fused.fused_newton(spec, p, kr, pa, v, iters=iters,
                                          tol=tol)
        plain = lambda: newton_solve_fixed(spec, p, kr, pa, v, iters, tol)
        # plain, kernel, kernel, plain
        p1 = time_ms(plain, 20)
        k1 = time_ms(kern, 500)
        k2 = time_ms(kern, 500)
        p2 = time_ms(plain, 20)
        bound, bound_by = fused_bound(
            spec, v.shape[0],
            lane_iterations(spec, p, kr, pa, v, iters, tol)[0])
        d = device_ms(kern, "fused_newton_kernel")
        timings[label] = dict(ms=(k1 + k2) / 2, device_ms=d,
                              plain_ms=(p1 + p2) / 2, bound_ms=bound,
                              bound_by=bound_by)
        log(f"time fused_newton f64 {label}: kernel {k1!r} / {k2!r} ms, "
            f"device {d!r} ms, plain {p1!r} / {p2!r} ms, bound {bound!r} ms "
            f"({bound_by}) [{card}]")
    new_times = time_new_kernels(dev, card)
    fa_times = time_flash(dev, card)
    da_times = time_decode_attention(dev, card)
    profile_query(match_query(), "match", n_groups, card)
    profile_query(layout_query(), "layout sweep", n_groups, card)
    profile_grad(cfgs, card)

    phase("14")
    # -- 14. summary lines
    t16 = timings["B=16"]
    fleet_launches = codesigned["fleet"]
    phase12 = {
        "fused_newton_scan": {
            "service": codesigned["service"]["scan"],
            **{f"fleet_{w}": n["fused_newton_scan"]
               for w, n in fleet_launches.items()}},
        "gauss_jordan_warp": {
            "service": codesigned["service"]["gauss_jordan"],
            **{f"fleet_{w}": n["gauss_jordan"]
               for w, n in fleet_launches.items()}},
        "flash_attention_tc": {"replay": codesigned["replay"]}}
    gj = new_times["gauss_jordan B=1"]
    gj_block = new_times["gauss_jordan block"]
    gc = new_times["gc_array_step 512x512"]
    fa, f32 = fa_times["tc"]["mix"], fa_times["f32"]["mix"]
    kernels = [{
        "name": "fused_newton_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_newton.cu",
        "replaces": "src/repro/kernels/batched_solve/fused.py:59",
        "launches": launches, "max_abs_err": max(scan_err.values()),
        "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
        "bound_ms": scan_t["bound_ms"], "bound_by": scan_t["bound_by"],
        "library_ms": None,
        # the gradient path's forwards (phase 10), one per topology group
        "grad_launches": grads["launches"]}, {
        # the one-step entry: the main path runs it 0 times, so its
        # launches are those of the phase-3 checks
        "name": "fused_newton", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_newton.cu",
        "replaces": "src/repro/kernels/batched_solve/fused.py:37",
        "launches": step_launches, "max_abs_err": max(max_err.values()),
        "ms": t16["ms"], "plain_ms": t16["plain_ms"],
        "bound_ms": t16["bound_ms"], "bound_by": t16["bound_by"],
        "library_ms": None}, {
        # the warp kernel: every solve of the compile path (N = 13)
        "name": "gauss_jordan_warp", "route": "cuda",
        "source": "src/repro_torch/csrc/gauss_jordan.cu",
        "replaces": "src/repro/kernels/batched_solve/kernel.py:31",
        "launches": compiled["launches"], "max_abs_err": gj_err["warp"],
        "ms": gj["ms"], "plain_ms": gj["plain_ms"],
        "bound_ms": gj["bound_ms"], "bound_by": gj["bound_by"],
        "library_ms": gj["library_ms"]}, {
        # the block kernel (32 < N <= 240): the paths run none, so its
        # launches are those of the phase-3 checks
        "name": "gauss_jordan", "route": "cuda",
        "source": "src/repro_torch/csrc/gauss_jordan.cu",
        "replaces": "src/repro/kernels/batched_solve/kernel.py:31",
        "launches": gj_block_launches, "max_abs_err": gj_err["block"],
        "ms": gj_block["ms"], "plain_ms": gj_block["plain_ms"],
        "bound_ms": gj_block["bound_ms"], "bound_by": gj_block["bound_by"],
        "library_ms": gj_block["library_ms"]}, {
        "name": "gc_array_step", "route": "cuda",
        "source": "src/repro_torch/csrc/gc_array_step.cu",
        "replaces": "src/repro/kernels/gc_array_step/kernel.py:37",
        "launches": write_launches, "max_abs_err": gc_err,
        "ms": gc["ms"], "plain_ms": gc["plain_ms"],
        "bound_ms": gc["bound_ms"], "bound_by": gc["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": served_f32["launches"],
        "max_abs_err": fa_err[torch.float32],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"]}, {
        "name": "flash_attention_tc", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": served["launches"], "max_abs_err": fa_err[torch.bfloat16],
        "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"]}, {
        # the moe serve's decode steps (phase 11b), timed at the benchmark
        # cell's shape at full fill (the mixed fill beside it)
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": None,
        "launches": served_moe["decode_launches"], "max_abs_err": da_err,
        **{f: da_times["full fill"][f] for f in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "mixed_fill": da_times["mixed fill"]}]
    # every row gains phase 12's launches by part (empty for a kernel the
    # phase does not launch; the fleet's are summed over its workers)
    for k in kernels:
        k["phase12_launches"] = phase12.get(k["name"], {})
    # the flash rows gain the launches of the moe, hybrid and int8 serves
    # (phase 11b; the tensor-core kernel's) and of the reduced card-vs-CPU
    # runs (the float32 kernel's), and their times at the new shapes
    rows = {k["name"]: k for k in kernels}
    rows["flash_attention_tc"].update(
        moe_launches=served_moe["launches"],
        moe_windowed_launches=served_moe["windowed"],
        hybrid_launches=served_hybrid["launches"],
        int8_launches=served_int8["launches"],
        # phase 11c: whisper's (64 of 96 a dispatch non-causal),
        # internvl2's, and xlstm's none
        audio_launches=served_audio["launches"],
        audio_noncausal_launches=served_audio["noncausal"],
        vlm_launches=served_vlm["launches"],
        ssm_launches=served_ssm["launches"],
        max_abs_err_noncausal=fa_err[torch.bfloat16, "noncausal"])
    # phase 11d: the training launches (64 a full-width step, forward
    # and remat recompute), the Function's gradient checks, the forward
    # at llama's training shape and the Function's backward beside
    # SDPA's (a library reference, not a port)
    tf = trained["times"]["fwd"]
    rows["flash_attention_tc"].update(
        train_launches=trained["launches"],
        train_launches_per_step=trained["per_step"],
        train_grad_max_rel_err=trained["func"]["worst"][torch.bfloat16],
        train_shape={f: tf[f] for f in ("ms", "device_ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")},
        train_function_bwd_ms=trained["times"]["bwd_ms"],
        train_function_bwd_bound_ms=trained["times"]["bwd_bound_ms"],
        train_sdpa_bwd_ms=trained["times"]["sdpa_bwd_ms"],
        train_step_device_fwd_ms=trained["profile"]["flash_fwd_ms"],
        train_step_device_bwd_ms=trained["profile"]["flash_bwd_ms"])
    # phase 11e: the mesh steps' launches (llama's prefill 16, decode 0,
    # a 2-layer train step 4; the other families' bundles by label)
    rows["flash_attention_tc"].update(
        mesh_launches=meshed["launches"],
        mesh_prefill_shape_max_abs_err=meshed["flash_err"])
    # phase 11f: the mesh Trainer's launches (64 a full-width step)
    rows["flash_attention_tc"].update(
        mesh_trainer_launches=meshed_train["launches"],
        mesh_trainer_launches_per_step=TRAIN_LAUNCHES_PER_STEP)
    rows["flash_attention"].update(
        train_reduced_launches=trained["reduced_f32_launches"],
        train_grad_max_rel_err=trained["func"]["worst"][torch.float32])
    rows["flash_attention"].update(
        family_cpu_parity_launches=family_launches,
        family_11c_cpu_parity_launches=family_11c_launches,
        max_abs_err_noncausal=fa_err[torch.float32, "noncausal"])
    for key, row in (("tc", "flash_attention_tc"),
                     ("f32", "flash_attention")):
        rows[row]["new_shapes"] = {
            f"{part} {label}": {f: t[f] for f in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}
            for part in ("hybrid", "moe", "audio", "vlm")
            for label, t in fa_times[f"{key}_{part}"].items()
            if label != "mix"}
    if any(k["launches"] <= 0 for k in kernels) or batch_launches <= 0 \
            or parity_launches <= 0 or matched["launches"] <= 0 or any(
                s["launches"] != s["n_layers"] * s["prefills"]
                for s in (served, served_f32)) or any(
                s["launches"] != s["per_dispatch"] * s["prefills"]
                or s["launches"] <= 0
                for s in (served_moe, served_hybrid, served_int8,
                          served_audio, served_vlm)) \
            or served_moe["windowed"] <= 0 or family_launches <= 0 \
            or served_ssm["launches"] != 0 or family_11c_launches <= 0 \
            or served_audio["noncausal"] != 64 * served_audio["prefills"] \
            or trained["launches"] != TRAIN_STEPS * TRAIN_LAUNCHES_PER_STEP \
            or trained["reduced_f32_launches"] <= 0 \
            or meshed["launches"]["prefill"] <= 0 \
            or meshed["launches"]["train"] <= 0 \
            or meshed_train["launches"] != MESH_TRAINER_STEPS \
            * TRAIN_LAUNCHES_PER_STEP:
        log("FAILED: a kernel of a path was never launched")
        return 1
    log(f"smoke total wall: {time.perf_counter() - t_smoke!r} s [{card}]")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
