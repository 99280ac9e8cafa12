"""Public entry of the batched MNA solvers.

`fused_newton_step`: the fused Woodbury-Newton engine's whole-timestep
solve (newton.py / fused.py). A CUDA tensor launches the hand-written
kernel (or raises); a CPU tensor runs the plain early-exit
`newton.newton_solve`, whose result is identical to the fixed-length
loop the kernel runs. Forward only: the implicit-function backward of the
reference (`fixed_point_adjoint`) comes with differentiable DSE.

The dense Gauss-Jordan solver (`solve`, `solve1`, `batched_solve`) is not
ported yet.
"""
from __future__ import annotations

from repro_torch._deferred import deferred
from repro_torch.kernels.batched_solve import newton as _newton
from repro_torch.kernels.batched_solve.fused import fused_newton


def fused_newton_step(spec, pre, Krhs, params, v0, *, iters, tol):
    """One timestep's fused Newton solve -> v (B, n)."""
    if v0.is_cuda:
        return fused_newton(spec, pre, Krhs, params, v0, iters=iters, tol=tol)
    v, _ = _newton.newton_solve(spec, pre, Krhs, params, v0, iters, tol)
    return v


_GJ = "Queue 2 item 2 (batched_solve Gauss-Jordan kernel)"
batched_solve = deferred("ops.batched_solve", _GJ)
solve1 = deferred("ops.solve1", _GJ)
solve = deferred("ops.solve", _GJ)
