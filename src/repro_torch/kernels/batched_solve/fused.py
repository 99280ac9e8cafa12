"""The fused Woodbury-Newton transient as one CUDA kernel over the lattice
batch axis (`csrc/fused_newton.cu`).

Replaces the Pallas kernel `repro.kernels.batched_solve.fused.fused_newton`
(`fused.py:59`, body `_newton_kernel`, `:37`) together with the `lax.scan`
over time steps that calls it once per step
(`repro/core/spice/transient.py:386-395`, in `_fused_fn`). Two entries
share one kernel template:

- `fused_newton_scan`: a topology group's whole transient in one launch.
  For every step it forms Krhs = KCoh @ v + Ksrc[step] and runs the
  complete fixed-length Woodbury-Newton loop (gather the terminal
  voltages, evaluate the channel model and its partials, assemble and
  solve the (3 n_dev)^2 capacitance system in closed form, apply the
  masked update), then stores v. One warp carries one lane: node row i in
  thread i, values exchanged through a per-warp row of shared memory,
  each device's channel on a pair of threads, the nine divisions of a
  3x3 inverse one per thread, convergence by a warp vote. No (B, n, n)
  operand but KCoh enters the kernel; the constant Jacobian part arrives
  through its prefactored inverse (see `newton.py`).
- `fused_newton`: one step's Newton solve from a given Krhs, the
  counterpart of the Pallas kernel itself.

What bounds the scan on an H100 is each lane's dependent chain: T steps
of a few serial FP64 Newton iterations. Its bytes (~3 KB of constants a
lane, ~100 bytes a step) and operations (~1e3 a lane and iteration) are
far below what the card moves in that time; the time loop runs inside
the kernel so that no launch or host operation sits between steps.

Each wrapper launches the kernel for CUDA tensors and raises if the build
or the launch fails. For CPU tensors they run the plain versions:
`fused_newton_scan_plain`, the step loop with the early-exit
`newton.newton_solve` per step, and `newton.newton_solve_fixed`, the same
fixed-length control flow as the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched_solve.newton import (FusedSpec,
                                                      newton_solve,
                                                      newton_solve_fixed)
from repro_torch.kernels.batched_solve.sparse import N_PARAMS

N_MAX = 32          # largest node count the kernel takes (csrc N_MAX)
KERNEL_DEVICES = (1, 2)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    lib = build.load("fused_newton")
    if lib.fused_newton_launch.argtypes is None:
        lib.fused_newton_launch.argtypes = [
            _INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_double,
            _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
            ctypes.POINTER(_INT), _PTR]
        lib.fused_newton_launch.restype = _INT
        lib.fused_newton_scan_launch.argtypes = [
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_double,
            _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
            ctypes.POINTER(_INT), _PTR]
        lib.fused_newton_scan_launch.restype = _INT
        lib.fused_newton_error.argtypes = [_INT]
        lib.fused_newton_error.restype = ctypes.c_char_p
    return lib


def _check(name, x, shape, dtype, device):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_lane_operands(spec: FusedSpec, pre, params, v0):
    """Checks the operands both entries share; returns (B, n)."""
    B, n = v0.shape
    n_dev, k = spec.n_dev, spec.k
    if n_dev not in KERNEL_DEVICES:
        raise ValueError(f"fused_newton kernel takes n_dev in "
                         f"{KERNEL_DEVICES}, got {n_dev}")
    if not 1 <= n <= N_MAX or n != spec.n:
        raise ValueError(f"fused_newton kernel takes 1 <= n <= {N_MAX} "
                         f"matching the spec (n={spec.n}), got {n}")
    if B < 1:
        raise ValueError("fused_newton needs at least one lane")
    sdt, cdt = spec.dtypes
    dev = v0.device
    _check("v0", v0, (B, n), sdt, dev)
    _check("params", params, (B, N_PARAMS, n_dev), sdt, dev)
    _check("KU", pre["KU"], (B, n, k), cdt, dev)
    _check("Sb", pre["Sb"], (B, n_dev, 3, k), cdt, dev)
    _check("KPa", pre["KPa"], (B, n, n_dev), cdt, dev)
    _check("KPg", pre["KPg"], (B, n, n_dev), cdt, dev)
    return B, n


def _terminals(spec: FusedSpec):
    term = spec.terminals.reshape(-1)
    return (_INT * len(term))(*(int(x) for x in term))


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fused_newton_error(rc).decode())


def fused_newton(spec: FusedSpec, pre, Krhs, params, v0, *,
                 iters: int, tol: float):
    """One timestep's Newton solve -> v (B, n).

    pre: dict from `newton.precompute` (only KU/Sb/KPa/KPg enter the
    kernel; K/KCoh are per-step hoists handled by the caller).
    Krhs (B, n) compute dtype, params (B, N_PARAMS, n_dev) and v0 (B, n)
    store dtype, per `spec.precision`. Counts each kernel launch in
    `fused_newton.launches`."""
    if not v0.is_cuda:
        return newton_solve_fixed(spec, pre, Krhs, params, v0, iters, tol)
    if v0.device.index != torch.cuda.current_device():
        with torch.cuda.device(v0.device):
            return fused_newton(spec, pre, Krhs, params, v0, iters=iters,
                                tol=tol)
    B, n = _check_lane_operands(spec, pre, params, v0)
    sdt, cdt = spec.dtypes
    _check("Krhs", Krhs, (B, n), cdt, v0.device)
    lib = _lib()
    out = torch.empty_like(v0)
    rc = lib.fused_newton_launch(
        int(sdt == torch.float64), int(cdt == torch.float64), spec.n_dev,
        B, n, int(iters), float(tol), Krhs.data_ptr(), v0.data_ptr(),
        params.data_ptr(), pre["KU"].data_ptr(), pre["Sb"].data_ptr(),
        pre["KPa"].data_ptr(), pre["KPg"].data_ptr(), out.data_ptr(),
        _terminals(spec), build.raw_stream(v0.device.index))
    _raise_on(lib, rc, "fused_newton")
    fused_newton.launches += 1
    return out


fused_newton.launches = 0


def fused_newton_scan_plain(spec: FusedSpec, pre, Ksrc, params, v0,
                            iters: int, tol: float):
    """The scan in plain torch: per step the rhs hoist
    Krhs = KCoh @ v + Ksrc[step] and the early-exit Newton solve, whose
    result equals the fixed-length loop the kernel runs. Any device."""
    _, cdt = spec.dtypes
    B, n = v0.shape
    vs = torch.empty((B, Ksrc.shape[0], n), dtype=v0.dtype,
                     device=v0.device)
    v = v0
    for step in range(Ksrc.shape[0]):
        Krhs = torch.einsum("bij,bj->bi", pre["KCoh"], v.to(cdt)) \
            + Ksrc[step]
        v, _ = newton_solve(spec, pre, Krhs, params, v, iters, tol)
        vs[:, step] = v
    return vs


def fused_newton_scan(spec: FusedSpec, pre, Ksrc, params, v0, *,
                      iters: int, tol: float):
    """A whole transient of T backward-Euler steps -> vs (B, T, n).

    pre: dict from `newton.precompute` (KCoh, KU, Sb, KPa, KPg enter the
    kernel); Ksrc (T, B, n) the source term K @ src of every step,
    step-major, in the compute dtype; params (B, N_PARAMS, n_dev) and the
    start state v0 (B, n) in the store dtype, per `spec.precision`.
    Counts each kernel launch in `fused_newton_scan.launches`."""
    if not v0.is_cuda:
        return fused_newton_scan_plain(spec, pre, Ksrc, params, v0, iters,
                                       tol)
    if v0.device.index != torch.cuda.current_device():
        with torch.cuda.device(v0.device):
            return fused_newton_scan(spec, pre, Ksrc, params, v0,
                                     iters=iters, tol=tol)
    B, n = _check_lane_operands(spec, pre, params, v0)
    sdt, cdt = spec.dtypes
    T = Ksrc.shape[0] if Ksrc.dim() == 3 else 0
    if T < 1:
        raise ValueError(f"Ksrc: shape {tuple(Ksrc.shape)}, expected "
                         f"(T, {B}, {n}) with T >= 1")
    _check("Ksrc", Ksrc, (T, B, n), cdt, v0.device)
    _check("KCoh", pre["KCoh"], (B, n, n), cdt, v0.device)
    lib = _lib()
    vs = torch.empty((B, T, n), dtype=sdt, device=v0.device)
    rc = lib.fused_newton_scan_launch(
        int(sdt == torch.float64), int(cdt == torch.float64), spec.n_dev,
        B, T, n, int(iters), float(tol), Ksrc.data_ptr(),
        pre["KCoh"].data_ptr(), v0.data_ptr(), params.data_ptr(),
        pre["KU"].data_ptr(), pre["Sb"].data_ptr(),
        pre["KPa"].data_ptr(), pre["KPg"].data_ptr(), vs.data_ptr(),
        _terminals(spec), build.raw_stream(v0.device.index))
    _raise_on(lib, rc, "fused_newton_scan")
    fused_newton_scan.launches += 1
    return vs


fused_newton_scan.launches = 0
