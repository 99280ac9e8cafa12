#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Phases:
  1. print the card (nvidia-smi name and power limit) and the torch, CUDA
     and nvcc versions;
  2. build every CUDA kernel of the port from the sources in this checkout;
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at a large batch, at every precision;
  4. drive the main path, `characterize` over the default 96-point design
     lattice, with the launch counters set to 0 just before it; check that
     every step went through the kernel and that t_cell matches the
     port's own CPU run;
  5. time the kernels, their plain versions and the warm main path;
  6. print a {"kernels": [...]} JSON line, the card line, and as the last
     line {"ok": true, "device": {...}}.

Any failure exits nonzero before the last line is printed. Without a CUDA
device, or outside a checkout of the repository, it fails at once.

Run from the root of the repository: python3 chip_smoke.py
"""
from __future__ import annotations

import json
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

    # -- 6. summary lines
    t16 = timings["B=16"]
    kernels = [{
        "name": "fused_newton", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_newton.cu",
        "replaces": "src/repro/kernels/batched_solve/fused.py:37",
        "launches": launches, "max_abs_err": max(max_err.values()),
        "ms": t16["ms"], "plain_ms": t16["plain_ms"],
        "bound_ms": t16["bound_ms"], "bound_by": t16["bound_by"],
        "library_ms": None}]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
