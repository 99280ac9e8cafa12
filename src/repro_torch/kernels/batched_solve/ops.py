"""Public entry of the batched MNA solvers.

`fused_newton_scan`: the fused Woodbury-Newton engine's whole transient
(newton.py / fused.py), every step's rhs hoist and Newton solve; a CUDA
tensor launches the hand-written kernel once (or raises), a CPU tensor
runs the plain step loop (`fused.fused_newton_scan_plain`).
`fused_newton_step`: one timestep's solve; a CUDA tensor launches the
same kernel for one step (or raises); a CPU tensor runs the plain
early-exit `newton.newton_solve`, whose result is identical to the
fixed-length loop the kernel runs. Forward only: the implicit-function
backward of the reference (`fixed_point_adjoint`) comes with
differentiable DSE.

Dense Gauss-Jordan (`solve`, `solve1`, `batched_solve`): float32
per-iteration dense solves of the scalar transient stepper
(`make_stepper(solver="pallas")`), whatever the input dtype, the result
cast back. A CUDA tensor launches `csrc/gauss_jordan.cu` (or raises); a
CPU tensor runs its plain twin (`kernel.gauss_jordan_plain`).
"""
from __future__ import annotations

from repro_torch.kernels.batched_solve import newton as _newton
from repro_torch.kernels.batched_solve.fused import (  # noqa: F401
    fused_newton, fused_newton_scan)
from repro_torch.kernels.batched_solve.kernel import batched_solve


def fused_newton_step(spec, pre, Krhs, params, v0, *, iters, tol):
    """One timestep's fused Newton solve -> v (B, n)."""
    if v0.is_cuda:
        return fused_newton(spec, pre, Krhs, params, v0, iters=iters, tol=tol)
    v, _ = _newton.newton_solve(spec, pre, Krhs, params, v0, iters, tol)
    return v


def solve1(J, r):
    """Single system (N, N) @ x = (N,)."""
    return batched_solve(J[None], r[None], block_b=1)[0]


def solve(J, r, block_b: int = 8):
    """Shape-dispatching entry: (N, N) or (B, N, N) systems. The kernel
    computes in float32 whatever the input dtype; the float64 transient
    anchor uses the "jnp" solver."""
    if J.ndim == 2:
        return solve1(J, r)
    return batched_solve(J, r, block_b=block_b)
