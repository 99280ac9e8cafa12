"""The whole Newton solve of one backward-Euler timestep as one CUDA
kernel over the lattice batch axis (`csrc/fused_newton.cu`).

Replaces the Pallas kernel `repro.kernels.batched_solve.fused.fused_newton`
(`_newton_kernel`). One thread runs one lane's complete fixed-length
Woodbury-Newton loop: gather the terminal voltages, evaluate the channel
model and its partials once, assemble and solve the (3 n_dev)^2
capacitance system in closed form, apply the masked update. No (B, n, n)
operand enters the kernel; the constant Jacobian part arrives through
its prefactored inverse (see `newton.py`).

What bounds it on an H100: per lane about 1.7 KB read and ~1e3 FP64
operations per iteration, so at the main path's 16 lanes one launch
costs far more than its work; the 300-step transient loop is
launch-bound. Fusing the time loop into the kernel or capturing it in a
CUDA graph is later work.

`fused_newton` launches the kernel for CUDA tensors and raises if the
build or the launch fails. For CPU tensors it runs the plain
`newton.newton_solve_fixed`, the same fixed-length control flow.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched_solve.newton import (FusedSpec,
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
    _check("Krhs", Krhs, (B, n), cdt, dev)
    _check("params", params, (B, N_PARAMS, n_dev), sdt, dev)
    _check("KU", pre["KU"], (B, n, k), cdt, dev)
    _check("Sb", pre["Sb"], (B, n_dev, 3, k), cdt, dev)
    _check("KPa", pre["KPa"], (B, n, n_dev), cdt, dev)
    _check("KPg", pre["KPg"], (B, n, n_dev), cdt, dev)
    lib = _lib()
    out = torch.empty_like(v0)
    term = spec.terminals.reshape(-1)
    term_c = (_INT * len(term))(*(int(x) for x in term))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_newton_launch(
            int(sdt == torch.float64), int(cdt == torch.float64), n_dev, B,
            n, int(iters), float(tol), Krhs.data_ptr(), v0.data_ptr(),
            params.data_ptr(), pre["KU"].data_ptr(), pre["Sb"].data_ptr(),
            pre["KPa"].data_ptr(), pre["KPg"].data_ptr(), out.data_ptr(),
            term_c, stream)
    if rc != 0:
        raise RuntimeError("fused_newton kernel launch failed: "
                           + lib.fused_newton_error(rc).decode())
    fused_newton.launches += 1
    return out


fused_newton.launches = 0
