#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Phases:
  1. print the card (nvidia-smi name and power limit) and the torch, CUDA
     and nvcc versions;
  2. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all at once), printing registers and spills;
  3. hold each kernel against its plain PyTorch version on the card, at
     the paths' shapes and at a large batch, at every precision;
  4. drive the lattice path, `characterize` over the default 96-point
     design lattice, with the launch counters set to 0 just before it;
     check that every step went through the fused Newton kernel and that
     t_cell matches the port's own CPU run;
  5. time the fused Newton kernel, its plain version and the warm lattice
     path;
  6. drive the compile path, `compile_bank(simulate=True, solver="pallas")`
     for gc2t_nn/np/osos at 16x64 and 128x128 plus one sram6t bank, each
     with the counters set to 0 just before it; check that every Newton
     iteration went through the Gauss-Jordan kernel, that t_cell matches
     the port's CPU run and the card's "jnp" run, that "jnp" hits the
     16x64 anchors, and that the retention computed on the card matches
     the CPU run; then the 64-lane `run_batch` vt0 sweep, counted and held
     to the CPU run;
  7. drive the array path, a 200-step selected-row write of a 512x512
     gain-cell array through the array-step kernel, counted, with the
     write-physics checks and the CPU plain run;
  8. time the Gauss-Jordan and array-step kernels (CUDA events and the
     profiler's device time), their plain versions, their bounds and
     `torch.linalg.solve_ex` (and `torch.linalg.solve`, which also syncs
     with the host), and the warm compile and `run_batch` walls;
  9. print a {"kernels": [...]} JSON line, the card line, and as the last
     line {"ok": true, "device": {...}}.

Any failure exits nonzero before the last line is printed. Without a CUDA
device, or outside a checkout of the repository, it fails at once.

Run from the root of the repository: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
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
# array step vs its plain version, one step (volts): the same float32
# arithmetic, but sequential column sums and the card's expf/log1pf; the
# rail's difference quotient over dv = 1e-4 magnifies sum-order round-off
# (3.4e-5 V on the CPU between two summation orders,
# tests/test_torch_gc_array_step.py)
GC_ATOL_SN, GC_ATOL_BL = 2e-6, 2e-4
GC_ATOL_ORACLE = 1e-3       # vs the oracle (rail dv 1e-3), the reference's
# (R, C, block_c): block_c None is the default, 32 columns per block (any
# block_c >= 32 launches the same); C = 130 is not a multiple of it, and
# block_c = 16 gives blocks of 16 columns
GC_CHECKS = ((128, 128, None), (512, 512, None), (64, 130, None),
             (64, 130, 16))
# retention (float32) on the card vs the CPU run, relative: the CPU parity
# test's limit against the reference (tests/test_torch_compiler.py)
RET_RTOL = 2e-6
WRITE_STEPS, WRITE_ATOL = 200, 1e-4     # 200-step write, card vs CPU

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
    one each): channel model twice per device (~65 each) plus selection
    and gate leak, t = K F, the k x k assembly, the closed-form solve,
    and the update."""
    k = 3 * n_dev
    channel = n_dev * (2 * 65 + 10)
    t = n * (3 + 4 * n_dev)
    assemble = n_dev * (k * 18 + 15)
    solve = 56 if n_dev == 1 else 247
    update = n * (2 * k + 4)
    return channel + t + assemble + solve + update


def lane_iterations(spec, pre, Krhs, params, v0, iters, tol) -> np.ndarray:
    """Newton iterations each lane runs before it converges (the kernel
    leaves the loop there), from the plain iteration on the same inputs."""
    from repro_torch.kernels.batched_solve.newton import make_fused_iter
    it = make_fused_iter(spec, tol)
    done = torch.zeros(v0.shape[0], dtype=torch.bool, device=v0.device)
    count = torch.zeros(v0.shape[0], dtype=torch.long, device=v0.device)
    v = v0
    for _ in range(iters):
        count += (~done).long()
        v, done = it(pre, Krhs, params, v, done)
    return count.cpu().numpy()


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
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[cdt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def step_inputs(group, banks, precision, device):
    """Real fused-Newton inputs from one topology group of the lattice:
    the `precompute` constants and the Newton problem of one time step
    after the read wordline fires, started from the precharge state."""
    from repro_torch.core.spice.char_batch import group_inputs
    from repro_torch.kernels.batched_solve import newton as nwt
    from repro_torch.kernels.batched_solve.sparse import pack_params
    n_steps = 300
    inp = group_inputs(group, banks, n_seg=8, n_steps=n_steps,
                       precision=precision, device=device)
    tr = inp["tr"]
    spec = tr.spec
    sdt, cdt = spec.dtypes
    te = torch.as_tensor(inp["t_end"], dtype=torch.float64, device=device)
    wt = torch.as_tensor(inp["wt"], dtype=torch.float64, device=device)
    wv = torch.as_tensor(inp["wv"], dtype=torch.float64, device=device)
    pre = nwt.precompute(spec, inp["over"]["G"], inp["over"]["C"],
                         te / n_steps)
    step = 30       # the wordline fires at 6% of the run
    src = tr.src_sequence(te, wt, wv, n_steps)[:, step]
    B = te.shape[0]
    v0 = inp["v0"].to(sdt).expand(B, spec.n).contiguous()
    Krhs = (torch.einsum("bij,bj->bi", pre["KCoh"], v0.to(cdt))
            + torch.einsum("bij,bj->bi", pre["K"], src)).contiguous()
    params = pack_params(tr.system.dev, B, sdt)
    return spec, pre, Krhs, params, v0, tr.iters, tr.tol


def tile_lanes(pre, Krhs, params, v0, B_big, gen):
    """A batch of B_big lanes cycling through the group's lanes, with
    each lane's start state jittered by up to 20 mV."""
    idx = torch.arange(B_big, device=v0.device) % v0.shape[0]
    pre_b = {k: x[idx].contiguous() for k, x in pre.items()
             if k in ("KU", "Sb", "KPa", "KPg")}
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


def check_gauss_jordan(dev) -> float:
    """Gauss-Jordan kernel against its plain version (and the LU oracle)
    on the card: the path's shape, a large batch, N = 130 in float32 and
    float64. Returns the largest |x_kernel - x_plain|; raises on a
    failed check."""
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain)
    from repro_torch.kernels.batched_solve.ref import batched_solve_ref
    rng = np.random.default_rng(SEED)
    A = rng.standard_normal((16, 130, 130)) * 0.1
    A += np.eye(130)[None] * (np.abs(A).sum(-1).max() + 1.0)
    rhs = rng.standard_normal((16, 130))
    cases = {"path B=1 N=13 f64": read_column_systems(dev, 1),
             f"B={GJ_BIG_BATCH} N=13 f64":
                 read_column_systems(dev, GJ_BIG_BATCH)}
    for dt in (torch.float32, torch.float64):
        cases[f"B=16 N=130 {str(dt)[6:]}"] = (
            torch.as_tensor(A, dtype=dt, device=dev),
            torch.as_tensor(rhs, dtype=dt, device=dev))
    worst = 0.0
    for label, (J, r) in cases.items():
        got = batched_solve(J, r)
        want = gauss_jordan_plain(J, r)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        ok = (got.dtype == r.dtype and bool(torch.isfinite(got).all())
              and err <= GJ_RTOL * scale)
        msg = (f"check gauss_jordan {label}: max|dx| vs plain {err!r} "
               f"(limit {GJ_RTOL} x {scale!r})")
        if r.shape[-1] == 130:
            oracle = float((got.double() - batched_solve_ref(
                J.double(), r.double())).abs().max())
            ok = ok and oracle <= GJ_ORACLE_TOL
            msg += f", vs torch.linalg.solve {oracle!r} (limit {GJ_ORACLE_TOL})"
        log(f"{msg} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"gauss_jordan check {label} failed")
        worst = max(worst, err)
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
    card at 128x128 (16 Kb), 512x512 (256 Kb) and C = 130 (`GC_CHECKS`).
    Returns the largest |dv| against the plain version."""
    from repro_torch.kernels.gc_array_step import ops
    from repro_torch.kernels.gc_array_step.kernel import step_plain
    p = ops.cell_params("gc2t_nn")
    worst = 0.0
    for R, C, bc in GC_CHECKS:
        args = array_inputs(R, C, dev)
        kw = {} if bc is None else {"block_c": bc}
        sn, bl = ops.gc_array_step(*args, 2e-11, p, **kw)
        p_sn, p_bl = step_plain(*args, 2e-11, p)
        o_sn, o_bl = ops.gc_array_step_ref(*args, 2e-11, p)
        torch.cuda.synchronize()
        e_sn = float((sn - p_sn).abs().max())
        e_bl = float((bl - p_bl).abs().max())
        e_or = max(float((sn - o_sn).abs().max()),
                   float((bl - o_bl).abs().max()))
        ok = (e_sn <= GC_ATOL_SN and e_bl <= GC_ATOL_BL
              and e_or <= GC_ATOL_ORACLE and bool(torch.isfinite(sn).all()))
        log(f"check gc_array_step {R}x{C} block_c {bc or 'default'}: "
            f"max|dv| vs plain SN "
            f"{e_sn!r} V (limit {GC_ATOL_SN}), rail {e_bl!r} V (limit "
            f"{GC_ATOL_BL}); vs oracle {e_or!r} V (limit {GC_ATOL_ORACLE}) "
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
    out = {"launches": 0, "first_s": {}, "t_cell": {}, "retention": {}}
    for cell in COMPILE_CELLS:
        for ws, nw in COMPILE_SIZES:
            cfg = BankConfig(ws, nw, cell=cell)
            batched_solve.launches = 0
            fused.fused_newton.launches = 0
            t0 = time.perf_counter()
            rep = compile_bank(cfg, simulate=True, solver="pallas",
                               device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = batched_solve.launches
            t = rep.t_cell_sim_s
            log(f"compile path: {cell} {ws}x{nw} pallas on the card in "
                f"{wall:.2f} s (first call), gauss_jordan launches {n} "
                f"(expected {per_compile}), t_cell_sim {t!r} s")
            if n != per_compile or fused.fused_newton.launches != 0:
                raise RuntimeError("compile path launch count")
            if not (t is not None and math.isfinite(t) and t > 0):
                raise RuntimeError("t_cell_sim not finite and positive")
            out["launches"] += n
            out["first_s"][(cell, ws, nw)] = wall
            out["t_cell"][(cell, ws, nw)] = t
            out["retention"][(cell, ws, nw)] = rep.retention.as_dict()
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
    t0 = time.perf_counter()
    out = tr.run_batch(waves, 1e-9, BATCH_STEPS, over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = batched_solve.launches
    tr_cpu, _, over_cpu = batch_sweep_inputs("cpu")
    ref = tr_cpu.run_batch(waves, 1e-9, BATCH_STEPS, over_cpu)
    err = float((out["all"].cpu() - ref["all"]).abs().max())
    ok = (n == BATCH_STEPS * NEWTON_ITERS and err <= TRACE_ATOL_PALLAS
          and bool(torch.isfinite(out["all"]).all()))
    log(f"run_batch path: {BATCH_LANES} lanes x {BATCH_STEPS} steps pallas "
        f"on the card in {wall:.2f} s (first call), gauss_jordan launches "
        f"{n} (expected {BATCH_STEPS * NEWTON_ITERS}); max|dv| vs CPU "
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
    log(f"array path: {WRITE_STEPS}-step write of 512x512 on the card, "
        f"gc_array_step launches {n}; selected SN {sel!r} V (0.6..1.0), "
        f"parked row max {parked!r} V (< 0.05); max|dv| vs CPU plain "
        f"{err!r} V (limit {WRITE_ATOL}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("array path")
    return n


def time_new_kernels(dev, card) -> dict:
    """Events, profiler device time, plain version, bound and library
    call of the Gauss-Jordan and array-step kernels at the paths'
    shapes, in turns (plain, kernel, kernel, plain)."""
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain)
    from repro_torch.kernels.gc_array_step import ops
    from repro_torch.kernels.gc_array_step.kernel import step_plain
    out = {}
    for B in (1, GJ_BIG_BATCH):
        J, r = read_column_systems(dev, B)
        kern = lambda: batched_solve(J, r)
        plain = lambda: gauss_jordan_plain(J, r)
        # solve_ex: the library call the port's "jnp" stepper makes; it
        # does not check for errors, so it does not wait on the device as
        # torch.linalg.solve does
        lib = lambda: torch.linalg.solve_ex(J, r[..., None])
        lib_sync = lambda: torch.linalg.solve(J, r[..., None])
        p1, k1 = time_ms(plain, 20), time_ms(kern, 500)
        l1, s1 = time_ms(lib, 200), time_ms(lib_sync, 200)
        k2, p2 = time_ms(kern, 500), time_ms(plain, 20)
        l2 = time_ms(lib, 200)
        d = device_ms(kern, "gauss_jordan_kernel")
        bound, by = bound_of(*gj_work(B, r.shape[-1], 8),
                             PEAK_FLOPS[torch.float32])
        out[f"gauss_jordan B={B}"] = dict(
            ms=(k1 + k2) / 2, device_ms=d, plain_ms=(p1 + p2) / 2,
            library_ms=(l1 + l2) / 2, bound_ms=bound, bound_by=by)
        log(f"time gauss_jordan B={B} N=13 f64: kernel {k1!r} / {k2!r} ms, "
            f"device {d!r} ms, plain {p1!r} / {p2!r} ms, "
            f"torch.linalg.solve_ex {l1!r} / {l2!r} ms, torch.linalg.solve "
            f"{s1!r} ms, bound {bound!r} ms ({by}) [{card}]")
    p = ops.cell_params("gc2t_nn")
    for R in (128, 512):
        args = array_inputs(R, R, dev)
        kern = lambda: ops.gc_array_step(*args, 1e-11, p)
        plain = lambda: step_plain(*args, 1e-11, p)
        p1, k1 = time_ms(plain, 5), time_ms(kern, 20)
        k2, p2 = time_ms(kern, 20), time_ms(plain, 5)
        d = device_ms(kern, "gc_array_step_kernel", reps=10)
        bound, by = bound_of(*gc_work(R, R), PEAK_FLOPS[torch.float32])
        out[f"gc_array_step {R}x{R}"] = dict(
            ms=(k1 + k2) / 2, device_ms=d, plain_ms=(p1 + p2) / 2,
            library_ms=None, bound_ms=bound, bound_by=by)
        log(f"time gc_array_step {R}x{R}: kernel {k1!r} / {k2!r} ms, "
            f"device {d!r} ms, plain {p1!r} / {p2!r} ms, bound {bound!r} ms "
            f"({by}) [{card}]")
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


def main() -> int:
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
    from repro_torch.kernels.batched_solve.newton import newton_solve_fixed

    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # -- 1. card and toolchain
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.strip().splitlines()[-1]}")

    # -- 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"build: {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    if sorted(paths) != sorted(build.SOURCES) or len(paths) != 3:
        log(f"FAILED: built {sorted(paths)}")
        return 1
    for kname, path in paths.items():
        logf = path.with_suffix(".log")
        for line in (logf.read_text().splitlines() if logf.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    # -- 3. kernels against their plain versions on the card
    cfgs = lattice_configs()
    groups = list(group_by_topology(cfgs).values())
    group = [cfgs[i] for i in groups[0]]
    banks = [build_bank(c) for c in group]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {}
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
    gj_err = check_gauss_jordan(dev)
    gc_err = check_gc_array_step(dev)

    # -- 4. the main path, counted
    n_groups = len(groups)
    n_steps = 300
    fused.fused_newton.launches = 0
    t0 = time.perf_counter()
    gpu = characterize(cfgs, device="cuda")
    first_s = time.perf_counter() - t0
    launches = fused.fused_newton.launches
    log(f"main path: characterize({len(cfgs)} points, {n_groups} groups) on "
        f"the card in {first_s:.2f} s (first call), fused_newton launches "
        f"{launches}")
    if launches != n_groups * n_steps:
        log(f"FAILED: expected {n_groups * n_steps} launches")
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

    # -- 5. timing, on the card
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
            spec, v.shape[0], lane_iterations(spec, p, kr, pa, v, iters, tol))
        timings[label] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                              bound_ms=bound, bound_by=bound_by)
        log(f"time fused_newton f64 {label}: kernel {k1!r} / {k2!r} ms, "
            f"plain {p1!r} / {p2!r} ms, bound {bound!r} ms ({bound_by}) "
            f"[{card}]")
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

    # -- 6. the compile path and the run_batch sweep, counted
    compiled = compile_path(dev)
    batch_launches = batch_path()

    # -- 7. the array path, counted
    write_launches = write_path()

    # -- 8. timing of the new paths and kernels, on the card (the walls
    # first: kernel launches run slower after a profiler session)
    time_paths(card)
    new_times = time_new_kernels(dev, card)

    # -- 9. summary lines
    t16 = timings["B=16"]
    gj = new_times["gauss_jordan B=1"]
    gc = new_times["gc_array_step 512x512"]
    kernels = [{
        "name": "fused_newton", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_newton.cu",
        "replaces": "src/repro/kernels/batched_solve/fused.py:37",
        "launches": launches, "max_abs_err": max(max_err.values()),
        "ms": t16["ms"], "plain_ms": t16["plain_ms"],
        "bound_ms": t16["bound_ms"], "bound_by": t16["bound_by"],
        "library_ms": None}, {
        "name": "gauss_jordan", "route": "cuda",
        "source": "src/repro_torch/csrc/gauss_jordan.cu",
        "replaces": "src/repro/kernels/batched_solve/kernel.py:31",
        "launches": compiled["launches"], "max_abs_err": gj_err,
        "ms": gj["ms"], "plain_ms": gj["plain_ms"],
        "bound_ms": gj["bound_ms"], "bound_by": gj["bound_by"],
        "library_ms": gj["library_ms"]}, {
        "name": "gc_array_step", "route": "cuda",
        "source": "src/repro_torch/csrc/gc_array_step.cu",
        "replaces": "src/repro/kernels/gc_array_step/kernel.py:37",
        "launches": write_launches, "max_abs_err": gc_err,
        "ms": gc["ms"], "plain_ms": gc["plain_ms"],
        "bound_ms": gc["bound_ms"], "bound_by": gc["bound_by"],
        "library_ms": None}]
    if any(k["launches"] <= 0 for k in kernels) or batch_launches <= 0:
        log("FAILED: a kernel of a path was never launched")
        return 1
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
