"""Fixed-pattern sparse-Newton engine: symbolic LU plus the re-stamp /
factor / solve / update iteration, and the precision policy and
device-parameter packing shared by the lattice engines.

The MNA Newton system J dv = F(v) of one topology group has a fixed
sparsity pattern across the whole design lattice (`MNASparsity`, from
core.spice.mna): the incidence stamps pin where G/C/device conductances
land, only the values vary per point. This module turns that pattern into
a solver:

  * `lu_schedule` runs the symbolic factorization once on the host:
    natural pivot order (the gmin + C/h + G_BIG diagonal stamps make J
    strictly diagonally dominant), fill-in positions appended after the
    pattern entries. The RBL-ladder netlists factor with zero fill.
  * `factor` / `solve_factored` replay that schedule on (B, nnz) value
    tensors: every step is a gather / multiply / scatter over the batch
    axis with index tensors built once per device.
  * `make_newton_iter` is one Newton iteration: gather device terminal
    voltages, evaluate the channel model once for current and 3x3 stamps
    (`channel_current_and_grads`), scatter the nine entries onto the
    constant part of the pattern, factor, solve, masked update.

The reference runs this engine as plain XLA (its Pallas `sparse_newton`
kernel was never written), so the port is plain torch on the tensors'
device: on the card a chain of small launches, no kernel of its own.

The reference's `newton_solve` leaves its while_loop once every lane is
done. Converged lanes freeze, so iterations past that point change
nothing; the port runs exactly `iters` masked iterations with no host
synchronization, and gets the same values bit for bit.

Precision policy: `store_dtype` is the dtype of the carried state and
traces, `compute_dtype` that of the residual accumulation, Jacobian
stamps and the factor/solve. "mixed" = float32 storage with float64
compute, safe because Newton re-evaluates the residual from the stored
state each iteration; "f32" is screening-only (cond(J) ~ 1e6 amplifies
solve round-off).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spice.mna import (G_MIN, MNASparsity,
                                        channel_current_and_grads,
                                        channel_current_raw)

#: storage/compute dtypes per precision mode
PRECISIONS: Dict[str, tuple] = {
    "f64": (torch.float64, torch.float64),
    "mixed": (torch.float32, torch.float64),
    "f32": (torch.float32, torch.float32),
}

#: device parameter pack order (gg = gate-leak conductance ig*w/1.1 is
#: appended as the 8th row by `pack_params`)
PARAM_FIELDS = ("pol", "vt0", "n", "kp", "lam", "w", "l")
N_PARAMS = len(PARAM_FIELDS) + 1


def pack_params(dev: dict, B: int, dtype, overrides=None) -> torch.Tensor:
    """Device parameter dict -> (B, N_PARAMS, n_dev) operand block
    (PARAM_FIELDS rows + the gate-leak conductance gg as the last row),
    broadcast over the batch, on the device of `dev`'s tensors.

    `overrides` maps PARAM_FIELDS names (plus "ig") to per-point values
    (scalar, (B, 1) or (B, n_dev)); gg is recomputed from the possibly
    overridden w/ig."""
    n_dev = int(dev["pol"].shape[-1])
    device = dev["pol"].device
    over = dict(overrides or {})
    bad = set(over) - set(PARAM_FIELDS) - {"ig"}
    if bad:
        raise ValueError(f"unknown device-param overrides {sorted(bad)} "
                         f"(allowed: {PARAM_FIELDS + ('ig',)})")

    def val(k):
        return torch.as_tensor(over[k] if k in over else dev[k],
                               dtype=dtype, device=device)

    cols = [val(k) for k in PARAM_FIELDS]
    cols.append(val("ig") * val("w") / 1.1)
    return torch.stack([c.expand(B, n_dev) for c in cols], dim=1) \
        .contiguous()


# ---------------------------------------------------------------------------
# symbolic factorization (host numpy)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Step:
    """Elimination step of pivot k: static index maps into the filled
    value vector."""
    k: int
    dpos: int                  # position of (k, k)
    colk: np.ndarray           # positions of (i, k), i in rows (L column)
    rowk: np.ndarray           # positions of (k, j), j in cols (U row)
    upd: np.ndarray            # (len(rows), len(cols)) positions of (i, j)
    rows: np.ndarray           # row indices i > k with (i, k) present
    cols: np.ndarray           # col indices j > k with (k, j) present


@dataclass(frozen=True, eq=False)
class LUSchedule:
    """Host-side symbolic LU of one sparsity pattern. `nnz` counts the
    pattern entries, `nnz_f` includes fill-in appended after them (the
    numeric steps zero-pad their value tensors to nnz_f). `entries` is
    the (nnz_f, 2) list of (row, col) coordinates in value-vector order,
    which `transpose_perm` maps to solve against J^T. eq=False: identity
    hashing, so schedules key caches directly."""
    n: int
    nnz: int
    nnz_f: int
    steps: Tuple[_Step, ...]
    entries: Optional[np.ndarray] = None
    # index tensors of the steps per torch device (`_step_indices`)
    device_maps: dict = field(default_factory=dict, repr=False)


def lu_schedule(sp: MNASparsity) -> LUSchedule:
    """Symbolic Gaussian elimination in natural order (unpivoted: J is
    strictly diagonally dominant). Deterministic: fill entries append in
    discovery order."""
    n = sp.n
    entries = [(int(i), int(j)) for i, j in zip(sp.rows, sp.cols)]
    patf = set(entries)
    for k in range(n):
        rows_k = [i for i in range(k + 1, n) if (i, k) in patf]
        cols_k = [j for j in range(k + 1, n) if (k, j) in patf]
        for i in rows_k:
            for j in cols_k:
                if (i, j) not in patf:
                    patf.add((i, j))
                    entries.append((i, j))
    pos = {e: p for p, e in enumerate(entries)}
    steps = []
    for k in range(n):
        rows_k = [i for i in range(k + 1, n) if (i, k) in patf]
        cols_k = [j for j in range(k + 1, n) if (k, j) in patf]
        steps.append(_Step(
            k=k, dpos=pos[(k, k)],
            colk=np.array([pos[(i, k)] for i in rows_k], np.int32),
            rowk=np.array([pos[(k, j)] for j in cols_k], np.int32),
            upd=np.array([[pos[(i, j)] for j in cols_k] for i in rows_k],
                         np.int32).reshape(len(rows_k), len(cols_k)),
            rows=np.array(rows_k, np.int32),
            cols=np.array(cols_k, np.int32)))
    return LUSchedule(n=n, nnz=sp.nnz, nnz_f=len(entries),
                      steps=tuple(steps),
                      entries=np.array(entries, np.int32).reshape(-1, 2))


_TPERM_CACHE: Dict[int, tuple] = {}


def transpose_perm(sched: LUSchedule) -> np.ndarray:
    """Entry permutation mapping a (B, nnz_f) value vector of J onto the
    value vector of J^T over the same schedule: perm[p] = position of
    (j, i) for entry p = (i, j). Valid because MNA patterns are
    structurally symmetric, which elimination preserves, so
    `factor(sched, jvals[:, perm])` is an LU of J^T. Cached per schedule
    identity."""
    got = _TPERM_CACHE.get(id(sched))
    if got is not None and got[0] is sched:
        return got[1]
    if sched.entries is None:
        raise ValueError("schedule lacks entry coordinates "
                         "(rebuild via lu_schedule)")
    pos = {(int(i), int(j)): p
           for p, (i, j) in enumerate(sched.entries)}
    perm = np.empty(sched.nnz_f, np.int32)
    for p, (i, j) in enumerate(sched.entries):
        q = pos.get((int(j), int(i)))
        if q is None:
            raise ValueError(
                f"sparsity pattern is not structurally symmetric at "
                f"({int(i)}, {int(j)}): transpose solve unavailable")
        perm[p] = q
    _TPERM_CACHE[id(sched)] = (sched, perm)
    return perm


def _transpose_index(sched: LUSchedule, device) -> torch.Tensor:
    """`transpose_perm` as a long tensor on `device`, kept in
    `sched.device_maps`."""
    key = ("transpose", str(device))
    got = sched.device_maps.get(key)
    if got is None:
        got = sched.device_maps[key] = torch.as_tensor(
            transpose_perm(sched), dtype=torch.long, device=device)
    return got


def _indices(obj, device, build):
    """The index tensors `build` makes from `obj`'s host maps, on
    `device`, kept in `obj.device_maps` (one entry per device)."""
    key = str(device)
    got = obj.device_maps.get(key)
    if got is None:
        got = obj.device_maps[key] = build(
            lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                      device=device))
    return got


def _step_indices(sched: LUSchedule, device):
    """Per step: (k, dpos, colk, rowk, upd, rows, cols) with the index
    maps as long tensors on `device` (None where the step has none)."""
    def build(t):
        return tuple(
            (st.k, st.dpos,
             t(st.colk) if len(st.rows) else None,
             t(st.rowk) if len(st.cols) else None,
             t(st.upd) if len(st.rows) and len(st.cols) else None,
             t(st.rows) if len(st.rows) else None,
             t(st.cols) if len(st.cols) else None)
            for st in sched.steps)
    return _indices(sched, device, build)


# ---------------------------------------------------------------------------
# numeric steps over (B, nnz) value tensors
# ---------------------------------------------------------------------------

def factor(sched: LUSchedule, vals: torch.Tensor) -> torch.Tensor:
    """In-pattern LU of (B, nnz_f) values (unrolled static schedule).
    L factors overwrite the (i, k) entries, U stays in place. Returns a
    new tensor."""
    vals = vals.clone()
    for k, dpos, colk, rowk, upd, _, _ in _step_indices(sched, vals.device):
        if colk is None:
            continue
        f = vals[:, colk] / vals[:, dpos:dpos + 1]
        vals[:, colk] = f
        if upd is not None:
            vals[:, upd] += -f[:, :, None] * vals[:, rowk][:, None, :]
    return vals


def solve_factored(sched: LUSchedule, lu: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """Forward + back substitution: lu (B, nnz_f), r (B, n) -> x."""
    steps = _step_indices(sched, r.device)
    y = r.clone()
    for k, _, colk, _, _, rows, _ in steps:
        if rows is not None:
            y[:, rows] += -lu[:, colk] * y[:, k:k + 1]
    x = y
    for k, dpos, _, rowk, _, _, cols in reversed(steps):
        s = x[:, k]
        if cols is not None:
            s = s - torch.sum(lu[:, rowk] * x[:, cols], dim=1)
        x[:, k] = s / lu[:, dpos]
    return x


def factor_solve(sched: LUSchedule, vals, r):
    return solve_factored(sched, factor(sched, vals), r)


def _row_table(sp: MNASparsity) -> np.ndarray:
    """(n, m) pattern positions of each row's entries in pattern order,
    padded with nnz (the zero column `coo_matvec` appends): m is the
    largest count of entries in a row."""
    per_row = [np.nonzero(np.asarray(sp.rows) == i)[0] for i in range(sp.n)]
    m = max(len(p) for p in per_row)
    return np.stack([np.pad(p, (0, m - len(p)), constant_values=sp.nnz)
                     for p in per_row])


def _pattern_indices(sp: MNASparsity, device):
    return _indices(sp, device, lambda t: {
        "rows": t(sp.rows), "cols": t(sp.cols),
        "diag": t(sp.diag_pos), "row_tab": t(_row_table(sp))})


def coo_matvec(sp: MNASparsity, vals, v):
    """y = A @ v with A given as (B, nnz) pattern values, v (B, n).

    On the CPU `index_add_` adds each row's products in pattern order. On
    CUDA it adds them with atomics, whose order (and so the rounding of
    a row with several entries) changes from run to run, so there each
    row's products are gathered and added in the same pattern order:
    equal to the CPU's sums, and the same in every run."""
    ix = _pattern_indices(sp, v.device)
    prod = vals[:, :sp.nnz] * v[:, ix["cols"]]
    if v.device.type != "cuda":
        return torch.zeros_like(v).index_add_(1, ix["rows"], prod)
    return ordered_row_sums(ix["row_tab"], prod)


def ordered_row_sums(row_tab, prod):
    """(B, n) sums of the (B, nnz) products per row, each row's terms
    added one after another in pattern order (`_row_table`)."""
    terms = torch.cat([prod, prod.new_zeros(prod.shape[0], 1)],
                      dim=1)[:, row_tab]
    y = terms[..., 0]
    for j in range(1, terms.shape[-1]):
        y = y + terms[..., j]
    return y


# ---------------------------------------------------------------------------
# the Newton iteration
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class NewtonSpec:
    """Everything static the iteration needs: the pattern, its symbolic
    LU, the device terminal index maps and the precision policy. Built
    once per (topology, precision) by `build_spec`. eq=False: identity
    hashing, so the spec keys caches."""
    sp: MNASparsity
    sched: LUSchedule
    didx_g: np.ndarray
    didx_a: np.ndarray
    didx_b: np.ndarray
    precision: str = "f64"
    # index tensors of the device terms per torch device (`_spec_indices`)
    device_maps: dict = field(default_factory=dict, repr=False)

    @property
    def n_dev(self) -> int:
        return len(self.didx_g)

    @property
    def dtypes(self) -> tuple:
        return PRECISIONS[self.precision]


def build_spec(system, sparsity: Optional[MNASparsity] = None,
               precision: str = "f64") -> NewtonSpec:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"({' | '.join(PRECISIONS)})")
    sp = sparsity if sparsity is not None \
        else MNASparsity.from_system(system)
    return NewtonSpec(sp, lu_schedule(sp), np.asarray(system.didx["g"]),
                      np.asarray(system.didx["a"]),
                      np.asarray(system.didx["b"]), precision)


def _spec_indices(spec: NewtonSpec, device):
    """Index tensors of the device terms on `device`: the ground-padded
    terminal gather (ground reads the zero slot n), and the kept
    (non-ground) entries of the KCL currents (rows a, b, g) and of the
    nine stamp entries, with their targets. Dropping a ground entry
    equals the reference's adding 0.0 to a dummy slot."""
    sp = spec.sp

    def build(t):
        term = np.concatenate([spec.didx_g, spec.didx_a, spec.didx_b])
        cur = np.concatenate([spec.didx_a, spec.didx_b, spec.didx_g])
        dev = sp.dev_pos.ravel()
        return {"term": t(np.where(term >= 0, term, sp.n)),
                "cur_keep": t(np.nonzero(cur >= 0)[0]),
                "cur_at": t(cur[cur >= 0]),
                "jac_keep": t(np.nonzero(dev >= 0)[0]),
                "jac_at": t(dev[dev >= 0])}
    return _indices(spec, device, build)


def _device_terms(spec: NewtonSpec, params, vc, want_current: bool,
                  want_jac: bool):
    """(KCL currents (B, 3 n_dev) in rows a, b, g order or None, stamp
    values (B, 9 n_dev) in `device_jacobian` order or None), with the
    channel model evaluated once, in vc's dtype."""
    ix = _spec_indices(spec, vc.device)
    n_dev = spec.n_dev
    B = vc.shape[0]
    vpad = torch.cat([vc, vc.new_zeros((B, 1))], dim=1)
    vg, va, vb = vpad[:, ix["term"]].split(n_dev, dim=1)
    p = params.to(vc.dtype)
    args = tuple(p[:, i] for i in range(len(PARAM_FIELDS))) + (vg, va, vb)
    gg = p[:, len(PARAM_FIELDS)]
    if want_jac:
        i_ab, di_dvg, di_dva, di_dvb = channel_current_and_grads(*args)
    else:
        i_ab = channel_current_raw(*args)
    cur = jac = None
    if want_current:
        i_g = gg * (vg - 0.5 * (va + vb))
        cur = torch.cat([i_ab - 0.5 * i_g, -i_ab - 0.5 * i_g, i_g], dim=1)
    if want_jac:
        jac = torch.cat([
            di_dvg - 0.5 * gg, di_dva + 0.25 * gg, di_dvb + 0.25 * gg,
            -di_dvg - 0.5 * gg, -di_dva + 0.25 * gg, -di_dvb + 0.25 * gg,
            gg, -0.5 * gg, -0.5 * gg], dim=1)
    return cur, jac


def _add_currents(spec, r, cur):
    ix = _spec_indices(spec, r.device)
    return r.index_add(1, ix["cur_at"], cur[:, ix["cur_keep"]])


def _add_stamps(spec, jc, jac):
    ix = _spec_indices(spec, jc.device)
    return jc.index_add(1, ix["jac_at"], jac[:, ix["jac_keep"]])


def _pad_fill(sched: LUSchedule, jvals):
    if sched.nnz_f > sched.nnz:   # zero-pad for fill-in entries
        jvals = torch.cat([jvals, jvals.new_zeros(
            (jvals.shape[0], sched.nnz_f - sched.nnz))], dim=1)
    return jvals


def make_newton_iter(spec: NewtonSpec, tol: float):
    """Returns iter_fn(j_const, rhs, params, v, done) -> (v, done): one
    re-stamp + factor + solve + masked-update iteration.

      j_const  (B, nnz)   G + G_BIG + gmin + C/h pattern values
                          (constant across a timestep's iterations)
      rhs      (B, n)     (C/h) @ v_prev + Norton source injections
      params   (B, N_PARAMS, n_dev)  from `pack_params`
      v        (B, n)     state (store dtype)
      done     (B,)       per-lane convergence mask; converged lanes
                          freeze
    """
    sdt, cdt = spec.dtypes
    sp, sched = spec.sp, spec.sched

    def iter_fn(j_const, rhs, params, v, done):
        vc = v.to(cdt)
        jc = j_const.to(cdt)
        r = coo_matvec(sp, jc, vc) - rhs.to(cdt)
        if spec.n_dev:
            cur, jac = _device_terms(spec, params, vc, True, True)
            r = _add_currents(spec, r, cur)
            jvals = _add_stamps(spec, jc, jac)
        else:
            jvals = jc
        dv = factor_solve(sched, _pad_fill(sched, jvals), r)
        conv = dv.abs().amax(dim=1) < tol
        v_next = torch.where(done[:, None], v, (vc - dv).to(sdt))
        return v_next, done | conv

    return iter_fn


def newton_solve(spec: NewtonSpec, j_const, rhs, params, v0,
                 iters: int, tol: float):
    """Run `iters` masked iterations -> (v, n_it). Each lane freezes once
    it converges, so the result equals the reference's early-exit loop
    bit for bit; n_it (a 0-d tensor on the device) is the number of
    iterations that loop would run: the first at which every lane was
    done, or `iters`. Nothing here waits on the device."""
    it = make_newton_iter(spec, tol)
    done = torch.zeros((v0.shape[0],), dtype=torch.bool, device=v0.device)
    n_it = torch.zeros((), dtype=torch.long, device=v0.device)
    v = v0
    for _ in range(iters):
        n_it = n_it + (~done.all()).long()
        v, done = it(j_const, rhs, params, v, done)
    return v, n_it


def sparse_residual(spec: NewtonSpec, j_const, rhs, params, v):
    """BE residual r(v) = J0 v - rhs + device KCL currents, whose root
    is the converged Newton state."""
    _, cdt = spec.dtypes
    vc = v.to(cdt)
    r = coo_matvec(spec.sp, j_const.to(cdt), vc) - rhs.to(cdt)
    if not spec.n_dev:
        return r
    cur, _ = _device_terms(spec, params, vc, True, False)
    return _add_currents(spec, r, cur)


def _jac_vals(spec: NewtonSpec, j_const, params, v):
    """The (B, nnz_f) Newton Jacobian values J(v): constant part + device
    stamps at v, fill entries zero-padded."""
    _, cdt = spec.dtypes
    jc = j_const.to(cdt)
    if spec.n_dev:
        _, jac = _device_terms(spec, params, v.to(cdt), False, True)
        jc = _add_stamps(spec, jc, jac)
    return _pad_fill(spec.sched, jc)


class _NewtonSolveImplicit(torch.autograd.Function):
    """Forward: `newton_solve`. Backward: one transposed symbolic-LU
    solve at the root, by the implicit function theorem,

        lam = J(v*)^-T vbar,   theta_bar = -(dF/dtheta)^T lam,

    through `transpose_perm` on the same schedule, then one VJP of
    `sparse_residual` at the root, in plain torch on the tensors'
    device. The v0 cotangent is zero: the root does not depend on the
    initial guess."""

    @staticmethod
    def forward(ctx, spec, iters, tol, j_const, rhs, params, v0):
        v = newton_solve(spec, j_const, rhs, params, v0, iters, tol)[0]
        ctx.spec = spec
        ctx.save_for_backward(j_const, rhs, params, v)
        return v

    @staticmethod
    def backward(ctx, v_bar):
        j_const, rhs, params, v_star = ctx.saved_tensors
        spec = ctx.spec
        _, cdt = spec.dtypes
        jvals = _jac_vals(spec, j_const, params, v_star)
        perm = _transpose_index(spec.sched, v_star.device)
        lam = factor_solve(spec.sched, jvals[:, perm], v_bar.to(cdt))
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_()
                      for x in (j_const, rhs, params)]
            F = sparse_residual(spec, *leaves, v_star.detach())
            grads = torch.autograd.grad(F, leaves, grad_outputs=-lam)
        return (None, None, None) + tuple(grads) + (None,)


def newton_solve_implicit(spec: NewtonSpec, iters: int, tol: float,
                          j_const, rhs, params, v0):
    """The sparse-Newton solve of one step, differentiable: the root of
    `sparse_residual`, with the implicit-function VJP of the reference
    (one extra factor and solve against J^T instead of a differentiated
    unroll, independent of the iteration count past convergence)."""
    return _NewtonSolveImplicit.apply(spec, iters, tol, j_const, rhs,
                                      params, v0)


def j_constant(spec: NewtonSpec, gn, cn, h):
    """The iteration-constant pattern values G + gmin + C/h for a run:
    gn/cn (B, nnz) linear-element values (sources folded into gn), h (B,)
    per-point step size. Kept in the compute dtype: under the mixed
    contract only the carried state/traces drop to float32."""
    _, cdt = spec.dtypes
    j = gn + cn / h[:, None]
    j[:, _pattern_indices(spec.sp, j.device)["diag"]] += G_MIN
    return j.to(cdt)
