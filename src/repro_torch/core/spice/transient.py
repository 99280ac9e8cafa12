"""Transient solver for design lattices: backward Euler, one fused
Woodbury-Newton solve per time step, a batch axis over design points.

Only the fused lattice engine (`solver="pallas"` in the reference) is
ported: `Transient.run_lattice` precomputes everything constant over the
run (h is fixed per point, so the linear Jacobian part never changes),
then loops over the time steps in Python, one
`ops.fused_newton_step` per step. On CUDA tensors that step is the
hand-written kernel of `kernels/batched_solve/fused.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._deferred import deferred
from repro_torch.core.spice.mna import G_BIG, MNASystem
from repro_torch.kernels.batched_solve import newton as nwt
from repro_torch.kernels.batched_solve import ops as solve_ops
from repro_torch.kernels.batched_solve.sparse import PARAM_FIELDS, pack_params

NEWTON_ITERS = 6
NEWTON_TOL = 1e-6       # volts; max|dv| under this ends the Newton loop

_DENSE = "Queue 1 item 5 (dense transient stepper)"
make_stepper = deferred("transient.make_stepper", _DENSE)


def interp(x, xp, fp):
    """Piecewise-linear lookup, the reference's `jnp.interp` batched:
    x (..., T) query points, xp/fp (..., K) knots and values with equal
    leading dims. Clamps to fp's end values outside [xp[0], xp[-1]];
    repeated knots (edge padding) give a zero-width segment that returns
    its left value instead of dividing by zero."""
    K = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = i.clamp(1, K - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def crossing_time(t, v, target, rising: bool):
    """First threshold crossing of a trace, linearly interpolated between
    the bracketing time steps. t, v: (..., T), vectorized over leading
    batch dims.

    Returns (t_cross, valid): t_cross is +inf where the trace never
    reaches the target (valid False): the final sample must be past the
    target and the crossing must not be at step 0."""
    mask = (v >= target) if rising else (v <= target)
    ok = mask[..., -1]
    hit = torch.argmax(mask.to(torch.int8), dim=-1)   # first True
    pos = hit.clamp_min(1)[..., None]
    tb = torch.broadcast_to(t, v.shape)
    v1 = v.gather(-1, pos)[..., 0]
    v0 = v.gather(-1, pos - 1)[..., 0]
    t1 = tb.gather(-1, pos)[..., 0]
    t0 = tb.gather(-1, pos - 1)[..., 0]
    dv = v1 - v0
    frac = ((target - v0) / torch.where(dv == 0.0, 1.0, dv)).clamp(0.0, 1.0)
    valid = ok & (hit > 0)
    return torch.where(valid, t0 + frac * (t1 - t0),
                       torch.full_like(t0, float("inf"))), valid


class Transient:
    """Whole-lattice transient of one MNA system on the fused
    Woodbury-Newton engine (the reference's solver="pallas").

    precision: "f64" | "mixed" (f32 carried state/traces, f64 model +
    solve) | "f32" (screening only)."""

    def __init__(self, system: MNASystem, solver: str = "pallas",
                 iters: int = NEWTON_ITERS, tol: float = NEWTON_TOL,
                 precision: str = "f64"):
        if solver != "pallas":
            item = ("Queue 1 item 4 (sparse-LU engine)" if solver == "sparse"
                    else _DENSE)
            raise NotImplementedError(
                f"Transient(solver={solver!r}) is not ported to repro_torch "
                f"yet (ROADMAP {item}); use solver='pallas'")
        self.system = system
        self.solver = solver
        self.precision = precision
        self.iters = iters
        self.tol = tol
        self.spec = nwt.build_fused_spec(system, precision)

    run = deferred("Transient.run", _DENSE)
    run_batch = deferred("Transient.run_batch", _DENSE)
    pack_waves = deferred("Transient.pack_waves", _DENSE)

    @property
    def device(self) -> torch.device:
        return self.system.G.device

    def run_lattice(self, wt, wv, t_end, n_steps, over_batches=None,
                    v0=None):
        """Whole-lattice transient over per-point waveforms, stop times
        and matrix overrides.

        wt/wv: (B, n_waves, k) packed waveforms; t_end: (B,) stop times
        (h varies per point); over_batches: {"G"/"C": (B, n, n)} linear
        matrices carrying per-point wire parasitics, plus optional
        per-point device-parameter batches (PARAM_FIELDS names + "ig").
        v0: (n,) shared initial state. Inputs move to the system's
        device. Returns {"all": (B, T, n), "t": (B, T), probes: (B, T)}.
        """
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        t_end = torch.as_tensor(t_end, **f64)
        B = t_end.shape[0]
        n = self.system.n
        if v0 is None:
            v0 = torch.zeros((n,), **f64)
        over_batches = dict(over_batches or {})
        dev_allowed = set(PARAM_FIELDS) | {"ig"}
        bad = set(over_batches) - {"G", "C"} - dev_allowed
        if bad:
            raise ValueError(
                "lattice runs support only G/C and device-parameter "
                f"overrides, got {sorted(bad)}")
        G_b = torch.as_tensor(over_batches.get(
            "G", self.system.G.expand(B, n, n)), **f64)
        C_b = torch.as_tensor(over_batches.get(
            "C", self.system.C.expand(B, n, n)), **f64)
        dev_over = {k: torch.as_tensor(v, device=dev)
                    for k, v in over_batches.items() if k in dev_allowed}
        vs = self._run_lattice_fused(
            t_end, torch.as_tensor(wt, **f64), torch.as_tensor(wv, **f64),
            int(n_steps), torch.as_tensor(v0, device=dev), G_b, C_b,
            dev_over)
        out = {"all": vs,
               "t": torch.arange(1, n_steps + 1, **f64)[None, :]
               * (t_end[:, None] / n_steps)}
        for label, node in self.system.probes.items():
            out[label] = vs[:, :, node - 1]
        return out

    def src_sequence(self, te, wt, wv, n_steps):
        """Norton source injections (B, T, n) for every step up front:
        the waveforms are known for the whole run, so the sequence
        assembles in one pass outside the step loop. Repeated source
        nodes accumulate."""
        _, cdt = self.spec.dtypes
        B = te.shape[0]
        h = te / n_steps
        ts = (torch.arange(n_steps, dtype=te.dtype, device=te.device)
              + 1.0)[None, :] * h[:, None]                   # (B, T)
        n_waves = wt.shape[1]
        wvals = interp(ts[:, None, :].expand(B, n_waves, n_steps), wt, wv)
        src_node = torch.as_tensor(self.system.src_node, dtype=torch.long,
                                   device=te.device)
        src_wave = torch.as_tensor(self.system.src_wave, dtype=torch.long,
                                   device=te.device)
        inj = (G_BIG * wvals[:, src_wave, :]).transpose(1, 2).to(cdt)
        return torch.zeros((B, n_steps, self.system.n), dtype=cdt,
                           device=te.device).index_add_(2, src_node, inj)

    def _run_lattice_fused(self, te, wt, wv, n_steps, v0, G_b, C_b,
                           dev_over):
        spec = self.spec
        sdt, cdt = spec.dtypes
        B, n = te.shape[0], spec.n
        h = te / n_steps
        pre = nwt.precompute(spec, G_b, C_b, h)
        # K @ rhs hoist: rhs = (C/h) v_prev + src, so
        # K rhs = KCoh @ v_prev + (K @ src); the source term for all
        # steps in one product outside the loop, step-major
        Ksrc = torch.einsum("bij,btj->tbi", pre["K"],
                            self.src_sequence(te, wt, wv, n_steps))
        Ksrc = Ksrc.contiguous()
        params = pack_params(self.system.dev, B, sdt, dev_over)
        v = v0.to(sdt).expand(B, n).contiguous()
        vs = torch.empty((B, n_steps, n), dtype=sdt, device=te.device)
        for step in range(n_steps):
            Krhs = torch.einsum("bij,bj->bi", pre["KCoh"], v.to(cdt)) \
                + Ksrc[step]
            v = solve_ops.fused_newton_step(spec, pre, Krhs, params, v,
                                            iters=self.iters, tol=self.tol)
            vs[:, step] = v
        return vs
