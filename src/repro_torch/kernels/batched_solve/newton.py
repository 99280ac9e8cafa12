"""Fused low-rank Newton engine: the per-iteration body behind
`solver="pallas"`, in plain torch.

Two structural facts of the batched transient runs make the Newton step
cheap:

  1. the timestep h = t_end / n_steps is constant per lattice point, so
     the linear part of the Jacobian J0 = G + C/h + gmin is constant
     across the whole run; K = J0^-1 is formed once per run;
  2. the only entries that change between iterations are the per-device
     3x3 conductance stamps: J = J0 + Um @ D @ Vm with Um/Vm constant
     0/1 incidence matrices of the device terminals and D the
     block-diagonal (3 n_dev x 3 n_dev) matrix of channel partials, a
     rank 3*n_dev update.

The Newton step then collapses via the Woodbury identity

    dv = J^-1 F = t - KU @ (I + D S)^-1 D (Vm @ t),
    t  = K F = v - K rhs + (K Pa) i_ab + (K Pg) i_g

where S = Vm K Um, KU = K Um and K Pa / K Pg are hoisted out of the
iteration, and K rhs is hoisted out to once per timestep. D is rank 2
per device: D_d = s_a (x) d3 + s_g (x) gg*e_g with s_a = (1,-1,0),
s_g = (-1/2,-1/2,1) over KCL rows (a,b,g), d3 the channel partials and
e_g = (1,-1/2,-1/2) the gate-leak row, so (I+DS) assembles from two
outer products per device.

The same iteration runs three ways: under an early-exit loop
(`newton_solve`, the CPU path), under a fixed-length loop
(`newton_solve_fixed`), and inside the CUDA kernel
(`csrc/fused_newton.cu`, one warp per lane). Per-lane freeze (`done`
mask) makes the first two identical bit for bit: a converged lane stops
changing, so an early-exited loop and a run-to-the-cap loop agree.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.spice.mna import (G_MIN, channel_current_and_grads,
                                        channel_current_raw)
from repro_torch.kernels.batched_solve.sparse import (PARAM_FIELDS, PRECISIONS,
                                                      pack_params)

__all__ = ["FusedSpec", "build_fused_spec", "precompute", "make_fused_iter",
           "newton_solve", "newton_solve_fixed", "pack_params",
           "residual", "fixed_point_adjoint", "adjoint_operator",
           "residual_vjp"]


@dataclass(frozen=True, eq=False)
class FusedSpec:
    """Static structure of one topology group for the fused engine:
    terminal incidence matrices and gather maps (host numpy)."""
    n: int
    n_dev: int
    um: np.ndarray          # (n, k) KCL row incidence, cols per device (a,b,g)
    vm: np.ndarray          # (k, n) terminal voltage rows, per device (g,a,b)
    pa: np.ndarray          # (n, n_dev) channel-current KCL incidence
    pg: np.ndarray          # (n, n_dev) gate-leak KCL incidence
    g_safe: np.ndarray      # terminal gather indices, ground -> n (pad row)
    a_safe: np.ndarray
    b_safe: np.ndarray
    precision: str = "f64"

    @property
    def k(self) -> int:
        return 3 * self.n_dev

    @property
    def dtypes(self) -> tuple:
        return PRECISIONS[self.precision]

    @property
    def terminals(self) -> np.ndarray:
        """(3, n_dev) int32 node index of each device's (g, a, b)
        terminal, -1 for ground: the layout the CUDA kernel takes."""
        safe = np.stack([self.g_safe, self.a_safe, self.b_safe])
        return np.where(safe < self.n, safe, -1).astype(np.int32)


def build_fused_spec(system, precision: str = "f64") -> FusedSpec:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"({' | '.join(PRECISIONS)})")
    n = system.n
    didx_g = np.asarray(system.didx["g"])
    didx_a = np.asarray(system.didx["a"])
    didx_b = np.asarray(system.didx["b"])
    n_dev = len(didx_g)
    k = 3 * n_dev
    um = np.zeros((n, k))
    vm = np.zeros((k, n))
    pa = np.zeros((n, n_dev))
    pg = np.zeros((n, n_dev))
    for d in range(n_dev):
        a, b, g = int(didx_a[d]), int(didx_b[d]), int(didx_g[d])
        if a >= 0:
            pa[a, d] += 1.0
            pg[a, d] -= 0.5
        if b >= 0:
            pa[b, d] -= 1.0
            pg[b, d] -= 0.5
        if g >= 0:
            pg[g, d] += 1.0
        for j, node in enumerate((a, b, g)):    # Um columns: rows of D
            if node >= 0:
                um[node, 3 * d + j] = 1.0
        for j, node in enumerate((g, a, b)):    # Vm rows: cols of D
            if node >= 0:
                vm[3 * d + j, node] = 1.0
    return FusedSpec(
        n=n, n_dev=n_dev, um=um, vm=vm, pa=pa, pg=pg,
        g_safe=np.where(didx_g >= 0, didx_g, n),
        a_safe=np.where(didx_a >= 0, didx_a, n),
        b_safe=np.where(didx_b >= 0, didx_b, n),
        precision=precision)


def precompute(spec: FusedSpec, G_b, C_b, h):
    """Per-run constants of the Woodbury iteration. G_b/C_b (B, n, n)
    dense linear stamps, h (B,) per-point step, all on one device.

    Returns a dict: K (B,n,n) inverse of the constant Jacobian part,
    KU (B,n,k), Sb (B,n_dev,3,k) = Vm K Um in device blocks, KPa/KPg
    (B,n,n_dev) = K @ terminal incidence, KCoh (B,n,n) = K C / h (for
    the per-step rhs hoist K rhs = KCoh @ v_prev + K src)."""
    _, cdt = spec.dtypes
    n = spec.n
    G_b = torch.as_tensor(G_b, dtype=cdt)
    dev = G_b.device
    C_b = torch.as_tensor(C_b, dtype=cdt, device=dev)
    h = torch.as_tensor(h, dtype=cdt, device=dev)

    def const(a):
        return torch.as_tensor(a, dtype=cdt, device=dev)

    J0 = G_b + C_b / h[:, None, None] \
        + G_MIN * torch.eye(n, dtype=cdt, device=dev)
    K = torch.linalg.inv(J0)
    KU = torch.einsum("bij,jk->bik", K, const(spec.um))
    Sb = torch.einsum("ki,bij->bkj", const(spec.vm), KU)
    if spec.n_dev:
        Sb = Sb.reshape(-1, spec.n_dev, 3, spec.k)
    return {
        "K": K,
        "KU": KU.contiguous(),
        "Sb": Sb.contiguous(),
        "KPa": torch.einsum("bij,jd->bid", K, const(spec.pa)).contiguous(),
        "KPg": torch.einsum("bij,jd->bid", K, const(spec.pg)).contiguous(),
        "KCoh": torch.einsum("bij,bjk->bik", K, C_b) / h[:, None, None],
    }


def _cross(a, b):
    """Cross product over the last axis, written out (the CUDA kernel
    uses the same three expressions)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _inv3(M):
    """Closed-form batched 3x3 inverse: column j of the adjugate is the
    cross product of the other two rows."""
    r0 = _cross(M[..., 1, :], M[..., 2, :])
    r1 = _cross(M[..., 2, :], M[..., 0, :])
    r2 = _cross(M[..., 0, :], M[..., 1, :])
    det = (M[..., 0, :] * r0).sum(-1)
    return torch.stack([r0, r1, r2], dim=-1) / det[..., None, None]


def _mv(M, x):
    return torch.einsum("bij,bj->bi", M, x)


def _solve_small(A, b, n_dev: int):
    """w = A^-1 b for the (B, k, k) Woodbury capacitance matrix
    A = I + D S: a 3x3 adjugate for n_dev = 1, a block Schur complement
    for n_dev = 2, unpivoted elimination above (A is a small
    perturbation of the identity in these circuits)."""
    if n_dev == 1:
        return _mv(_inv3(A), b)
    if n_dev == 2:
        P, Q = A[:, :3, :3], A[:, :3, 3:]
        R, T = A[:, 3:, :3], A[:, 3:, 3:]
        Pi = _inv3(P)
        X = torch.einsum("bij,bjk->bik", Pi, Q)
        y1 = _mv(Pi, b[:, :3])
        x2 = _mv(_inv3(T - torch.einsum("bij,bjk->bik", R, X)),
                 b[:, 3:] - _mv(R, y1))
        x1 = y1 - _mv(X, x2)
        return torch.cat([x1, x2], dim=1)
    k = 3 * n_dev
    A = A.clone()
    b = b.clone()
    for i in range(k):
        f = A[:, i + 1:, i] / A[:, i, i:i + 1]
        A[:, i + 1:, i:] -= f[:, :, None] * A[:, i:i + 1, i:]
        b[:, i + 1:] -= f * b[:, i:i + 1]
    x = torch.zeros_like(b)
    for i in range(k - 1, -1, -1):
        s = b[:, i] - (A[:, i, i + 1:] * x[:, i + 1:]).sum(1)
        x[:, i] = s / A[:, i, i]
    return x


def _gather(x, idx):
    """(B, n) -> (B, n_dev) terminal values; index n (ground) reads the
    zero pad column."""
    xp = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
    return xp[:, idx]


def make_fused_iter(spec: FusedSpec, tol: float):
    """Returns iter_fn(pre, Krhs, params, v, done) -> (v, done): one
    fused Woodbury-Newton step. `pre` from `precompute`, Krhs (B, n) the
    per-timestep hoist K @ rhs, params (B, N_PARAMS, n_dev) from
    `pack_params`, v (B, n) store-dtype state, done (B,) freeze mask.
    The update is applied in the iteration where a lane converges and
    frozen after it."""
    sdt, cdt = spec.dtypes
    n_dev, k = spec.n_dev, spec.k
    safe = np.stack([spec.g_safe, spec.a_safe, spec.b_safe])
    on_device = {}      # gather indices per device, copied there once

    def indices(device):
        if device not in on_device:
            on_device[device] = torch.as_tensor(safe, dtype=torch.long,
                                                device=device).unbind(0)
        return on_device[device]

    def iter_fn(pre, Krhs, params, v, done):
        B = v.shape[0]
        vc = v.to(cdt)
        if n_dev == 0:      # linear circuit: one exact solve
            dv = vc - Krhs.to(cdt)
            v_next = torch.where(done[:, None], v, (vc - dv).to(sdt))
            return v_next, done | torch.ones_like(done)
        g_i, a_i, b_i = indices(v.device)
        vg, va, vb = _gather(vc, g_i), _gather(vc, a_i), _gather(vc, b_i)
        p = params.to(cdt)
        i_ab, di_dvg, di_dva, di_dvb = channel_current_and_grads(
            *(p[:, i] for i in range(len(PARAM_FIELDS))), vg, va, vb)
        gg = p[:, len(PARAM_FIELDS)]
        i_g = gg * (vg - 0.5 * (va + vb))
        d3 = torch.stack([di_dvg, di_dva, di_dvb], dim=2)  # (B, n_dev, 3)
        Sb = pre["Sb"].to(cdt)
        t = (vc - Krhs.to(cdt)
             + torch.einsum("bid,bd->bi", pre["KPa"].to(cdt), i_ab)
             + torch.einsum("bid,bd->bi", pre["KPg"].to(cdt), i_g))
        # Vm @ t rows are one-hot terminal picks (g, a, b) per device
        g3 = torch.stack([_gather(t, g_i), _gather(t, a_i),
                          _gather(t, b_i)], dim=2)          # (B, n_dev, 3)
        # D = s_a (x) d3 + s_g (x) gg*e_g per device block (rank 2);
        # e_g = (1, -1/2, -1/2) over Sb's terminal axis (g, a, b)
        d3S = torch.einsum("bdj,bdjk->bdk", d3, Sb)         # (B, n_dev, k)
        egS = (Sb[:, :, 0] - 0.5 * Sb[:, :, 1] - 0.5 * Sb[:, :, 2]) \
            * gg[:, :, None]
        # rows (a, b, g): s_a = (1, -1, 0), s_g = (-1/2, -1/2, 1)
        DS = torch.stack([d3S - 0.5 * egS, -d3S - 0.5 * egS, egS],
                         dim=2).reshape(B, k, k)
        A = torch.eye(k, dtype=cdt, device=v.device)[None] + DS
        d3g = (d3 * g3).sum(-1)
        egg = (g3[:, :, 0] - 0.5 * g3[:, :, 1] - 0.5 * g3[:, :, 2]) * gg
        b_k = torch.stack([d3g - 0.5 * egg, -d3g - 0.5 * egg, egg],
                          dim=2).reshape(B, k)
        w = _solve_small(A, b_k, n_dev)
        dv = t - torch.einsum("bnk,bk->bn", pre["KU"].to(cdt), w)
        conv = dv.abs().amax(dim=1) < tol
        v_next = torch.where(done[:, None], v, (vc - dv).to(sdt))
        return v_next, done | conv

    return iter_fn


def newton_solve(spec: FusedSpec, pre, Krhs, params, v0,
                 iters: int, tol: float):
    """Fused iteration under a loop that exits once every lane has
    converged. Returns (v, iterations run). Per-lane freeze makes the
    result identical to `newton_solve_fixed`."""
    it = make_fused_iter(spec, tol)
    v = v0
    done = torch.zeros(v0.shape[0], dtype=torch.bool, device=v0.device)
    n_it = 0
    while n_it < iters and not bool(done.all()):
        v, done = it(pre, Krhs, params, v, done)
        n_it += 1
    return v, n_it


def newton_solve_fixed(spec: FusedSpec, pre, Krhs, params, v0,
                       iters: int, tol: float):
    """Fixed-iteration variant (no early exit): the control flow the
    CUDA kernel runs, and its plain reference."""
    it = make_fused_iter(spec, tol)
    v = v0
    done = torch.zeros(v0.shape[0], dtype=torch.bool, device=v0.device)
    for _ in range(iters):
        v, done = it(pre, Krhs, params, v, done)
    return v


def _gather_safe(x, idx):
    """(B, n) -> (B, n_dev) terminal values via a padded gather; ground
    terminals (index n) read the zero pad column. `idx` is a host index
    array (the spec's `*_safe` maps) or a long tensor."""
    return _gather(x, torch.as_tensor(idx, dtype=torch.long,
                                      device=x.device))


def residual(spec: FusedSpec, pre, Krhs, params, v):
    """Preconditioned backward-Euler residual F(v) = v - K rhs
    + (K Pa) i_ab(v) + (K Pg) i_g(v), whose root is the converged Newton
    state (the iteration's update is dv = M^-1 F, so dv = 0 iff F = 0).
    Elementwise torch with no freeze masks or loops: the
    implicit-function adjoint differentiates this function with respect
    to the data inputs, never the loop that located the root. The casts
    to the compute dtype happen inside, so autograd hands back cotangents
    in the caller's dtypes (params stays float32 under "mixed")."""
    _, cdt = spec.dtypes
    vc = v.to(cdt)
    out = vc - Krhs.to(cdt)
    if spec.n_dev == 0:
        return out
    vg = _gather_safe(vc, spec.g_safe)
    va = _gather_safe(vc, spec.a_safe)
    vb = _gather_safe(vc, spec.b_safe)
    p = params.to(cdt)
    i_ab = channel_current_raw(
        *(p[:, i] for i in range(len(PARAM_FIELDS))), vg, va, vb)
    gg = p[:, len(PARAM_FIELDS)]
    i_g = gg * (vg - 0.5 * (va + vb))
    return (out
            + torch.einsum("bid,bd->bi", pre["KPa"].to(cdt), i_ab)
            + torch.einsum("bid,bd->bi", pre["KPg"].to(cdt), i_g))


def _adjoint_lam(spec: FusedSpec, pre, params, v_star, v_bar):
    """lam = M^-T v_bar with M = dF/dv = I + KU D Vm at the root v_star:
    one Woodbury solve against the transposed capacitance matrix,

        M^-T = I - Vm^T D^T A^-T KU^T,        A = I + D S,

    where A is the (B, k, k) matrix `make_fused_iter` builds, assembled
    here at v_star. Returns lam (B, n) in the compute dtype."""
    _, cdt = spec.dtypes
    n_dev, k = spec.n_dev, spec.k
    vb_c = v_bar.to(cdt)
    if n_dev == 0:
        return vb_c
    B = v_star.shape[0]
    vc = v_star.to(cdt)
    safe = [torch.as_tensor(s, dtype=torch.long, device=vc.device)
            for s in (spec.g_safe, spec.a_safe, spec.b_safe)]
    vg, va, vb = (_gather(vc, s) for s in safe)
    p = params.to(cdt)
    _, di_dvg, di_dva, di_dvb = channel_current_and_grads(
        *(p[:, i] for i in range(len(PARAM_FIELDS))), vg, va, vb)
    gg = p[:, len(PARAM_FIELDS)]
    d3 = torch.stack([di_dvg, di_dva, di_dvb], dim=2)      # (B, n_dev, 3)
    Sb = pre["Sb"].to(cdt)
    d3S = torch.einsum("bdj,bdjk->bdk", d3, Sb)
    egS = (Sb[:, :, 0] - 0.5 * Sb[:, :, 1] - 0.5 * Sb[:, :, 2]) \
        * gg[:, :, None]
    DS = torch.stack([d3S - 0.5 * egS, -d3S - 0.5 * egS, egS],
                     dim=2).reshape(B, k, k)
    A = torch.eye(k, dtype=cdt, device=vc.device)[None] + DS
    # lam = vbar - Vm^T D^T (A^T)^-1 KU^T vbar
    y = torch.einsum("bnk,bn->bk", pre["KU"].to(cdt), vb_c)
    u = _solve_small(A.transpose(1, 2), y, n_dev)
    u3 = u.reshape(B, n_dev, 3)            # rows (a, b, g) of Um columns
    sau = u3[:, :, 0] - u3[:, :, 1]                          # s_a . u
    sgu = u3[:, :, 2] - 0.5 * (u3[:, :, 0] + u3[:, :, 1])    # s_g . u
    # D^T u over D's column order (g, a, b):
    #   d3 * (s_a . u) + gg * e_g * (s_g . u)
    ggs = gg * sgu
    dtu = d3 * sau[:, :, None] \
        + torch.stack([ggs, -0.5 * ggs, -0.5 * ggs], dim=2)
    corr = vc.new_zeros((B, spec.n + 1))
    for j, s in enumerate(safe):
        corr = corr.index_add(1, s, dtu[:, :, j])
    return vb_c - corr[:, :spec.n]


def adjoint_operator(spec: FusedSpec, pre, params, v_star):
    """W (B, n, n) = M^-T at the root v_star, so that the adjoint of a
    cotangent v_bar is lam = W @ v_bar: the Woodbury solve of
    `_adjoint_lam` applied to the n unit vectors, one replicated lane
    each. The scan's backward forms W for every step at once, leaving
    only a matrix-vector recurrence to run in time order."""
    _, cdt = spec.dtypes
    B, n = v_star.shape
    rep = lambda x: x.repeat_interleave(n, dim=0)   # noqa: E731
    eye = torch.eye(n, dtype=cdt, device=v_star.device).repeat(B, 1)
    lam = _adjoint_lam(spec, {"KU": rep(pre["KU"]), "Sb": rep(pre["Sb"])},
                       rep(params), rep(v_star), eye)
    return lam.reshape(B, n, n).transpose(1, 2)


def residual_vjp(spec: FusedSpec, pre, Krhs, params, v_star, lam):
    """theta_bar = -(dF/dtheta)^T lam at the root: one autograd VJP of
    `residual` with respect to (pre, Krhs, params), v_star held fixed.
    Returns (pre_bar dict over pre's keys, Krhs_bar, params_bar); a
    pre entry the residual does not read gets zeros."""
    with torch.enable_grad():
        pre_l = {k: x.detach().requires_grad_() for k, x in pre.items()}
        krhs_l = Krhs.detach().requires_grad_()
        par_l = params.detach().requires_grad_()
        F = residual(spec, pre_l, krhs_l, par_l, v_star.detach())
        leaves = list(pre_l.values()) + [krhs_l, par_l]
        grads = torch.autograd.grad(F, leaves, grad_outputs=-lam,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return dict(zip(pre_l, grads[:len(pre_l)])), grads[-2], grads[-1]


def fixed_point_adjoint(spec: FusedSpec, pre, Krhs, params, v_star, v_bar):
    """Implicit-function VJP through the converged Newton solve.

    At the fixed point F(v*, theta) = 0 (theta = the data inputs pre /
    Krhs / params), the implicit function theorem gives
    dv*/dtheta = -M^-1 dF/dtheta with M = dF/dv = I + KU D Vm, the same
    rank-k structure the forward iteration inverts. The adjoint
    lam = M^-T vbar costs one Woodbury solve against the transposed
    capacitance matrix (`_adjoint_lam`), and theta_bar = -(dF/dtheta)^T
    lam is one VJP of `residual` at the root (`residual_vjp`). Returns
    (pre_bar, Krhs_bar, params_bar). The v0 cotangent is zero: the root
    does not depend on the initial guess, which makes the VJP independent
    of the iteration count past convergence."""
    lam = _adjoint_lam(spec, pre, params, v_star, v_bar)
    return residual_vjp(spec, pre, Krhs, params, v_star, lam)
