"""Transient solver: backward Euler + Newton, a Python loop over time
steps, a leading lane axis over design points.

Two engines, as in the reference:

  * the dense stepper (`make_stepper`), behind `Transient.run`,
    `run_batch` and `run_lattice(solver="jnp")`: every Newton iteration
    stamps the analytic Jacobian (`MNASystem.jacobian`) and solves it,
    with `torch.linalg.solve` (solver="jnp") or the float32 Gauss-Jordan
    solve of `kernels/batched_solve` (solver="pallas"; on CUDA tensors
    one launch of `csrc/gauss_jordan.cu` per iteration);
  * the fused Woodbury-Newton engine behind `run_lattice(solver="pallas")`:
    everything constant over the run (h is fixed per point, so the
    linear Jacobian part never changes) is precomputed, then one
    `ops.fused_newton_step` per step; on CUDA tensors that step is the
    kernel of `kernels/batched_solve/fused.py`.

The reference's early-exit Newton loop (a `while_loop` under vmap, which
freezes converged lanes) becomes a fixed-length loop with a per-lane
`done` mask: a lane's update still applies in the iteration where it
converges and is frozen after, so each lane gets exactly its early-exit
result, and the loop never waits on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spice.mna import G_BIG, MNASystem
from repro_torch.kernels.batched_solve import newton as nwt
from repro_torch.kernels.batched_solve import ops as solve_ops
from repro_torch.kernels.batched_solve.sparse import PARAM_FIELDS, pack_params

NEWTON_ITERS = 6
NEWTON_TOL = 1e-6       # volts; max|dv| under this ends the Newton loop
SOLVERS = ("jnp", "pallas")
NEWTON_MODES = ("full", "jacfwd", "modified")


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


def wave_value(times, values, t):
    """Piecewise-linear waveform lookup. times/values: (..., k); t
    broadcasts against their leading dims."""
    t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
    lead = torch.broadcast_shapes(times.shape[:-1], t.shape)
    k = times.shape[-1]
    return interp(t.expand(lead)[..., None], times.expand(lead + (k,)),
                  values.expand(lead + (k,)))[..., 0]


def _dense_solve(J, r):
    """LAPACK-style LU solve with partial pivoting (the reference's
    `jnp.linalg.solve`); `solve_ex` skips the error check, which would
    wait on the device every call."""
    return torch.linalg.solve_ex(J, r[..., None])[0][..., 0]


def make_stepper(system: MNASystem, solver_name: str = "jnp",
                 newton: str = "full", iters: int = NEWTON_ITERS,
                 tol: float = NEWTON_TOL, with_aux: bool = False):
    """Returns step(v, t, h, wave_times, wave_values, dev_over) -> v_next.

    v: (..., n), one row per lane; t, h: scalars or (...,) per lane;
    wave_times/wave_values: (n_waves, k) or (..., n_waves, k); dev_over:
    {name: per-lane override} for `MNASystem.with_params` (device
    parameters (..., n_dev), or "G"/"C" (..., n, n)).

    newton="full":     analytic-Jacobian Newton, re-stamped and solved
                       every iteration; a lane stops changing once
                       max|dv| < tol (its early-exit result)
    newton="jacfwd":   fixed iterations with the autodiff Jacobian
                       (`torch.func.jacfwd`), the parity reference of the
                       analytic stamps
    newton="modified": one `lu_factor` of the step's first Jacobian, then
                       `iters` chord iterations with `lu_solve`

    solver_name "jnp" solves with `torch.linalg.solve`; "pallas" with the
    float32 Gauss-Jordan solve (`ops.solve`). "modified" always uses LU,
    as the reference does. with_aux=True (full mode only) makes step
    return (v_next, n_iters) with each lane's iteration count.
    """
    if with_aux and newton != "full":
        raise ValueError("with_aux is only supported for newton='full'")
    if newton not in NEWTON_MODES:
        raise ValueError(f"newton must be one of {NEWTON_MODES}, got "
                         f"{newton!r}")
    if solver_name not in SOLVERS:
        raise ValueError(f"dense stepper solvers are {SOLVERS}, got "
                         f"{solver_name!r}")
    solver = solve_ops.solve if solver_name == "pallas" else _dense_solve

    def step(v, t, h, wave_times, wave_values, dev_over):
        sys = system.with_params(**dev_over) if dev_over else system
        t = torch.as_tensor(t, dtype=v.dtype, device=v.device)
        wv = wave_value(wave_times, wave_values, t[..., None])

        def res(vv):
            return sys.residual(vv, v, h, wv)

        if newton == "modified":
            LU, piv = torch.linalg.lu_factor(sys.jacobian(v, h))
            vv = v
            for _ in range(iters):
                vv = vv - torch.linalg.lu_solve(LU, piv, res(vv)[..., None])[
                    ..., 0]
            return vv

        if newton == "jacfwd":
            # lanes are independent, so one tangent e_j on every lane at
            # once gives column j of each lane's Jacobian
            vv = v
            zero = v.new_zeros(v.shape[-1])
            for _ in range(iters):
                r = res(vv)
                J = torch.func.jacfwd(lambda u, vv=vv: res(vv + u))(zero)
                vv = vv - solver(J, r)
            return vv

        done = torch.zeros(v.shape[:-1], dtype=torch.bool, device=v.device)
        n_it = torch.zeros(v.shape[:-1], dtype=torch.long, device=v.device)
        vv = v
        for _ in range(iters):
            dv = solver(*sys.newton_system(vv, v, h, wv))
            if with_aux:
                n_it = n_it + (~done).long()
            vv = torch.where(done[..., None], vv, vv - dv)
            done = done | (dv.abs().amax(dim=-1) < tol)
            # on the host the loop may stop once every lane is frozen (the
            # result is the same); on the card it runs to the cap and
            # never waits for the device
            if not vv.is_cuda and bool(done.all()):
                break
        return (vv, n_it) if with_aux else vv

    return step


class Transient:
    """Backward-Euler transient of one MNA system (float64).

    solver: "jnp" (the dense stepper with `torch.linalg.solve`
    everywhere) or "pallas" (`run`/`run_batch` use the dense stepper with
    the float32 Gauss-Jordan solve; `run_lattice` uses the fused
    Woodbury-Newton engine). "sparse" (the symbolic-LU engine) is not
    ported yet.

    precision (fused lattice engine only): "f64" | "mixed" (f32 carried
    state/traces, f64 model + solve) | "f32" (screening only)."""

    def __init__(self, system: MNASystem, solver: str = "jnp",
                 newton: str = "full", iters: int = NEWTON_ITERS,
                 tol: float = NEWTON_TOL, precision: str = "f64"):
        if solver == "sparse":
            raise NotImplementedError(
                "Transient(solver='sparse') is not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 4 (sparse-LU engine)); use "
                "solver='jnp' or 'pallas'")
        if solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got "
                             f"{solver!r}")
        self.system = system
        self.solver = solver
        self.precision = precision
        self.iters = iters
        self.tol = tol
        self._step = make_stepper(system, solver, newton=newton,
                                  iters=iters, tol=tol)
        self._wave_cache = {}
        self.spec = (nwt.build_fused_spec(system, precision)
                     if solver == "pallas" else None)

    @property
    def device(self) -> torch.device:
        return self.system.G.device

    def _f64(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def pack_waves(self, waves):
        """Edge-pad and stack piecewise-linear waveforms into (n_waves, k)
        float64 tensors on the system's device; memoized by content and
        dtype, so repeated runs with the same waveforms skip the padding
        and the host-to-device copy."""
        dtype = torch.float64
        key = (str(dtype),) + tuple(
            (tuple(float(x) for x in t), tuple(float(x) for x in v))
            for t, v in waves)
        hit = self._wave_cache.get(key)
        if hit is not None:
            return hit
        k = max(len(t) for t, _ in waves)

        def pad(a):
            a = [float(x) for x in a]
            return a + [a[-1]] * (k - len(a))

        packed = self._wave_cache[key] = (
            self._f64([pad(t) for t, _ in waves]),
            self._f64([pad(v) for _, v in waves]))
        return packed

    def _run_dense(self, t_end, wt, wv, n_steps, v0, dev_over):
        """Dense-stepper run of B lanes: t_end (B,), wt/wv (B, n_waves,
        k), v0 (n,) or (B, n), dev_over {name: (B, ...)} -> (B, T, n)."""
        B, n = t_end.shape[0], self.system.n
        h = t_end / n_steps
        v = self._f64(v0).expand(B, n)
        vs = torch.empty((B, n_steps, n), dtype=torch.float64,
                         device=self.device)
        for i in range(n_steps):
            v = self._step(v, (i + 1.0) * h, h, wt, wv, dev_over)
            vs[:, i] = v
        return vs

    def _probes(self, out, vs):
        for label, node in self.system.probes.items():
            out[label] = vs[..., node - 1]
        return out

    def run(self, waves, t_end, n_steps=400, v0=None, dev_over=None):
        """One lane: {"all": (T, n), "t": (T,), probes: (T,)}."""
        wt, wv = self.pack_waves(waves)
        if v0 is None:
            v0 = torch.zeros((self.system.n,))
        over = {k: torch.as_tensor(x, device=self.device)[None]
                for k, x in (dev_over or {}).items()}
        t_end = self._f64(t_end)
        vs = self._run_dense(t_end[None], wt[None], wv[None], int(n_steps),
                             v0, over)[0]
        out = {"all": vs, "t": torch.arange(
            1, n_steps + 1, dtype=torch.float64, device=self.device)
            * (t_end / n_steps)}
        return self._probes(out, vs)

    def run_batch(self, waves, t_end, n_steps, dev_batches: dict, v0=None):
        """A batch of device-parameter overrides, {param: (B, n_dev)}, one
        lane each: {"all": (B, T, n), "t": (T,), probes: (B, T)}."""
        wt, wv = self.pack_waves(waves)
        if v0 is None:
            v0 = torch.zeros((self.system.n,))
        over = {k: torch.as_tensor(x, device=self.device)
                for k, x in dev_batches.items()}
        B = next(iter(over.values())).shape[0]
        t_end = self._f64(t_end)
        vs = self._run_dense(t_end.expand(B), wt[None], wv[None],
                             int(n_steps), v0, over)
        out = {"all": vs, "t": torch.arange(
            1, n_steps + 1, dtype=torch.float64, device=self.device)
            * (t_end / n_steps)}
        return self._probes(out, vs)

    def run_lattice(self, wt, wv, t_end, n_steps, over_batches=None,
                    v0=None):
        """Whole-lattice transient over per-point waveforms, stop times
        and overrides.

        wt/wv: (B, n_waves, k) packed waveforms; t_end: (B,) stop times
        (h varies per point); over_batches: {name: (B, ...)}, which may
        hold "G"/"C" (B, n, n) linear matrices carrying per-point wire
        parasitics. v0: (n,) shared initial state. Inputs move to the
        system's device. Returns {"all": (B, T, n), "t": (B, T), probes:
        (B, T)}.

        With solver="pallas" the run goes to the fused engine, which
        takes only "G"/"C" and device-parameter batches (PARAM_FIELDS
        names + "ig"); solver="jnp" vmaps the dense stepper per point.
        """
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        t_end = torch.as_tensor(t_end, **f64)
        B = t_end.shape[0]
        n = self.system.n
        if v0 is None:
            v0 = torch.zeros((n,), **f64)
        over_batches = dict(over_batches or {})
        if self.solver == "jnp":
            over = {k: torch.as_tensor(x, device=dev)
                    for k, x in over_batches.items()}
            vs = self._run_dense(t_end, torch.as_tensor(wt, **f64),
                                 torch.as_tensor(wv, **f64), int(n_steps),
                                 v0, over)
        else:
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
                t_end, torch.as_tensor(wt, **f64),
                torch.as_tensor(wv, **f64), int(n_steps),
                torch.as_tensor(v0, device=dev), G_b, C_b, dev_over)
        out = {"all": vs,
               "t": torch.arange(1, n_steps + 1, **f64)[None, :]
               * (t_end[:, None] / n_steps)}
        return self._probes(out, vs)

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
