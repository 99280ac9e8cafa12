"""Public entry of the batched MNA solvers.

`fused_newton_scan`: the fused Woodbury-Newton engine's whole transient
(newton.py / fused.py), every step's rhs hoist and Newton solve; a CUDA
tensor launches the hand-written kernel once (or raises), a CPU tensor
runs the plain step loop (`fused.fused_newton_scan_plain`).
`fused_newton_step`: one timestep's solve; a CUDA tensor launches the
same kernel for one step (or raises); a CPU tensor runs the plain
early-exit `newton.newton_solve`, whose result is identical to the
fixed-length loop the kernel runs.

Both are `torch.autograd.Function`s. Neither the kernel nor the
early-exit loop is differentiated: the converged root is an implicit
function of the data inputs, so the backward is the reference's
implicit-function adjoint (`newton.fixed_point_adjoint`), in plain torch
on the tensors' own device. For the scan it runs in reverse time over
the saved trajectory vs: at step t, lam_t = M_t^-T (vbar_t + carry),
then theta_bar from the VJP of `newton.residual` at v_t, then the rhs
hoist Krhs_t = KCoh @ v_{t-1} + Ksrc[t], which gives Ksrc_bar[t] =
Krhs_bar_t, KCoh_bar += Krhs_bar_t (x) v_{t-1} and carry =
KCoh^T Krhs_bar_t (the reference's `lax.scan` over its `custom_vjp`
step computes the same gradient). Only the lam recurrence runs in time
order; every M_t^-T (`newton.adjoint_operator`) and the residual VJPs
are evaluated for all steps at once. The Function takes KCoh, KU, Sb,
KPa and KPg as separate arguments, since autograd tracks only tensors
passed as arguments. The initial state v0 gets the cotangent of its
role in Krhs_0; as step 0's Newton guess it has none. KU and Sb get
zero gradients: the root does not depend on them.

Dense Gauss-Jordan (`solve`, `solve1`, `batched_solve`): float32
per-iteration dense solves of the scalar transient stepper
(`make_stepper(solver="pallas")`), whatever the input dtype, the result
cast back. A CUDA tensor launches `csrc/gauss_jordan.cu` (or raises); a
CPU tensor runs its plain twin (`kernel.gauss_jordan_plain`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.batched_solve import fused as _fused
from repro_torch.kernels.batched_solve import newton as _newton
from repro_torch.kernels.batched_solve.fused import fused_newton  # noqa: F401
from repro_torch.kernels.batched_solve.kernel import batched_solve

_SCAN_PRE = ("KCoh", "KU", "Sb", "KPa", "KPg")
_STEP_PRE = ("KU", "Sb", "KPa", "KPg")


class _FusedStep(torch.autograd.Function):
    """One timestep's solve; backward = `newton.fixed_point_adjoint`."""

    @staticmethod
    def forward(ctx, spec, iters, tol, KU, Sb, KPa, KPg, Krhs, params, v0):
        pre = dict(zip(_STEP_PRE, (KU, Sb, KPa, KPg)))
        if v0.is_cuda:
            v = _fused.fused_newton(spec, pre, Krhs, params, v0,
                                    iters=iters, tol=tol)
        else:
            v, _ = _newton.newton_solve(spec, pre, Krhs, params, v0, iters,
                                        tol)
        ctx.spec = spec
        ctx.save_for_backward(KU, Sb, KPa, KPg, Krhs, params, v)
        return v

    @staticmethod
    def backward(ctx, v_bar):
        KU, Sb, KPa, KPg, Krhs, params, v = ctx.saved_tensors
        pre = dict(zip(_STEP_PRE, (KU, Sb, KPa, KPg)))
        pre_bar, krhs_bar, params_bar = _newton.fixed_point_adjoint(
            ctx.spec, pre, Krhs, params, v, v_bar)
        return (None, None, None, pre_bar["KU"], pre_bar["Sb"],
                pre_bar["KPa"], pre_bar["KPg"], krhs_bar, params_bar, None)


class _FusedScan(torch.autograd.Function):
    """A whole transient; backward = the per-step adjoint in reverse
    time over the saved trajectory (module docstring)."""

    @staticmethod
    def forward(ctx, spec, iters, tol, KCoh, KU, Sb, KPa, KPg, Ksrc, params,
                v0):
        pre = dict(zip(_SCAN_PRE, (KCoh, KU, Sb, KPa, KPg)))
        vs = _fused.fused_newton_scan(spec, pre, Ksrc, params, v0,
                                      iters=iters, tol=tol)
        ctx.spec = spec
        ctx.save_for_backward(KCoh, KU, Sb, KPa, KPg, params, v0, vs)
        return vs

    @staticmethod
    def backward(ctx, vs_bar):
        KCoh, KU, Sb, KPa, KPg, params, v0, vs = ctx.saved_tensors
        spec = ctx.spec
        sdt, cdt = spec.dtypes
        B, T, n = vs.shape
        roots = vs.transpose(0, 1).reshape(T * B, n)     # step-major lanes

        def per_step(x):
            return x.expand(T, *x.shape).reshape(T * B, *x.shape[1:])

        # M_t^-T at every root, then the recurrence in reverse time:
        # lam_t = M_t^-T (vbar_t + carry), carry = KCoh^T lam_t
        W = _newton.adjoint_operator(
            spec, {"KU": per_step(KU), "Sb": per_step(Sb)},
            per_step(params), roots).reshape(T, B, n, n)
        KCoh_T = KCoh.transpose(1, 2)
        carry = vs.new_zeros((B, n))
        lams = [None] * T
        for t in range(T - 1, -1, -1):
            u = (vs_bar[:, t] + carry).to(cdt)
            lam = torch.bmm(W[t], u[..., None])
            lams[t] = lam[..., 0]
            carry = torch.bmm(KCoh_T, lam)[..., 0].to(sdt)
        Lam = torch.stack(lams)                          # (T, B, n)
        # Ksrc_bar[t] = Krhs_bar_t = lam_t; KCoh_bar = sum_t lam_t (x)
        # v_{t-1}; v0's cotangent is the last carry (step 0's rhs hoist)
        v_prev = torch.cat([v0[None], vs.transpose(0, 1)[:-1]]).to(cdt)
        KCoh_bar = torch.einsum("tbi,tbj->bij", Lam, v_prev)
        # F is linear in Krhs, so its value enters no cotangent below
        pre_bar, _, params_bar = _newton.residual_vjp(
            spec, {"KPa": per_step(KPa), "KPg": per_step(KPg)},
            roots.new_zeros((T * B, n), dtype=cdt), per_step(params),
            roots, Lam.reshape(T * B, n))

        def over_steps(g, like):
            return g.reshape(T, *like.shape).sum(0)

        return (None, None, None, KCoh_bar, None, None,
                over_steps(pre_bar["KPa"], KPa),
                over_steps(pre_bar["KPg"], KPg), Lam,
                over_steps(params_bar, params), carry)


def fused_newton_step(spec, pre, Krhs, params, v0, *, iters, tol):
    """One timestep's fused Newton solve -> v (B, n), differentiable with
    respect to pre's KU/Sb/KPa/KPg, Krhs and params."""
    return _FusedStep.apply(spec, iters, tol,
                            *(pre[k] for k in _STEP_PRE), Krhs, params, v0)


def fused_newton_scan(spec, pre, Ksrc, params, v0, *, iters, tol):
    """A whole transient of T backward-Euler steps -> vs (B, T, n)
    (`fused.fused_newton_scan`, which counts the kernel's launches),
    differentiable with respect to pre's KCoh/KU/Sb/KPa/KPg, Ksrc,
    params and v0."""
    return _FusedScan.apply(spec, iters, tol,
                            *(pre[k] for k in _SCAN_PRE), Ksrc, params, v0)


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
