"""Port parity: the sparse-LU engine of `repro_torch` (`MNASparsity`,
`kernels/batched_solve/sparse.py`, `Transient(solver="sparse")`) against
the JAX reference and the port's dense engine, on the CPU.

Limits:
  * pattern maps, LU schedules and transpose permutations are host numpy
    in both packages: equal exactly;
  * one Newton iteration, the residual and the Jacobian values: 1e-12
    relative to the reference under x64 (float64 round-off through
    cond(J) ~ 1e6 stays far below it);
  * lattice traces within 1e-6 V of the dense "jnp" engine, the
    reference's own limit (tests/test_fused_newton.py);
  * t_cell within 6e-12 relative of the dense engine at f64 on the
    reference's engine benchmark inputs (benchmarks/bench_transient.py,
    16 jittered lanes of gc2t_nn 32x32, 300 steps): the reference's
    sparse-vs-dense contract;
  * t_cell within 1e-9 relative of the reference's sparse engine (the
    lattice limit of tests/test_torch_char_batch.py).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import dse as ref_dse  # noqa: E402
from repro.core import timing as ref_timing  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core.bank import build_bank as ref_build_bank  # noqa: E402
from repro.core.spice import char_batch as ref_cb  # noqa: E402
from repro.core.spice.mna import MNASparsity as RefMNASparsity  # noqa: E402
from repro.kernels.batched_solve import sparse as ref_sps  # noqa: E402
from repro_torch.core import dse, timing  # noqa: E402
from repro_torch.core.bank import BankConfig, build_bank  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.core.spice.mna import MNASparsity  # noqa: E402
from repro_torch.core.spice.transient import (Transient,  # noqa: E402
                                              crossing_time)
from repro_torch.kernels.batched_solve import sparse as sps  # noqa: E402

CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos")
RTOL_STEP = 1e-12
ATOL_TRACE = 1e-6
RTOL_SPARSE_VS_DENSE = 6e-12
RTOL_T_CELL = 1e-9
SP_FIELDS = ("rows", "cols", "diag_pos", "dev_pos", "res_proj", "cap_proj",
             "src_nnz")
STEP_FIELDS = ("colk", "rowk", "upd", "rows", "cols")
f64 = dict(dtype=torch.float64)


def _circuits(cell, ws=16, nw=64):
    ref_ckt, _ = ref_timing.read_netlist(
        ref_build_bank(RefBankConfig(ws, nw, cell)))
    ckt, meta = timing.read_netlist(build_bank(BankConfig(ws, nw, cell)))
    return ref_ckt, ckt, meta


def _assert_sparsity_equal(got, want, fields=SP_FIELDS):
    assert got.n == want.n and got.nnz == want.nnz
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        else:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("cell", CELLS)
def test_build_sparsity_matches_reference(cell):
    ref_ckt, ckt, _ = _circuits(cell)
    _assert_sparsity_equal(ckt.build_sparsity(), ref_ckt.build_sparsity())
    system = ckt.build(device="cpu")
    with jax.enable_x64(True):
        ref_system = ref_ckt.build()
        want = RefMNASparsity.from_system(ref_system)
        want_G = np.asarray(want.project_dense(ref_system.G))
    got = MNASparsity.from_system(system)
    _assert_sparsity_equal(got, want)
    np.testing.assert_array_equal(got.project_dense(system.G).numpy(),
                                  want_G)
    assert got.pos() == want.pos()


@pytest.mark.parametrize("cell", CELLS)
def test_lu_schedule_matches_reference(cell):
    ref_ckt, ckt, _ = _circuits(cell)
    got = sps.lu_schedule(ckt.build_sparsity())
    want = ref_sps.lu_schedule(ref_ckt.build_sparsity())
    assert (got.n, got.nnz, got.nnz_f) == (want.n, want.nnz, want.nnz_f)
    np.testing.assert_array_equal(got.entries, want.entries)
    assert len(got.steps) == len(want.steps)
    for g, w in zip(got.steps, want.steps):
        assert (g.k, g.dpos) == (w.k, w.dpos)
        for f in STEP_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
    np.testing.assert_array_equal(sps.transpose_perm(got),
                                  ref_sps.transpose_perm(want))


def _pattern_values(sp, B, seed=0):
    """Seeded (B, nnz) values on a pattern, strictly diagonally dominant
    (the property J's gmin + C/h + G_BIG diagonal gives)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1.0, 1.0, (B, sp.nnz))
    vals[:, sp.diag_pos] = 20.0 + rng.uniform(0.0, 1.0, (B, sp.n))
    return vals


def test_factor_solve_and_matvec_match_dense_and_reference():
    ref_ckt, ckt, _ = _circuits("gc2t_osos")
    sp = ckt.build_sparsity()
    sched = sps.lu_schedule(sp)
    rsp = ref_ckt.build_sparsity()
    rsched = ref_sps.lu_schedule(rsp)
    B = 5
    vals = _pattern_values(sp, B)
    r = np.random.default_rng(1).uniform(-1.0, 1.0, (B, sp.n))
    dense = np.zeros((B, sp.n, sp.n))
    dense[:, sp.rows, sp.cols] = vals
    pad = np.zeros((B, sched.nnz_f - sched.nnz))
    x = sps.factor_solve(sched, torch.as_tensor(np.hstack([vals, pad])),
                         torch.as_tensor(r))
    np.testing.assert_allclose(x.numpy(),
                               np.linalg.solve(dense, r[..., None])[..., 0],
                               rtol=1e-12, atol=1e-15)
    y = sps.coo_matvec(sp, torch.as_tensor(vals), torch.as_tensor(r))
    np.testing.assert_allclose(y.numpy(), np.einsum("bij,bj->bi", dense, r),
                               rtol=1e-12, atol=1e-15)
    with jax.enable_x64(True):
        rx = ref_sps.factor_solve(rsched, jnp.asarray(np.hstack([vals, pad])),
                                  jnp.asarray(r))
        ry = ref_sps.coo_matvec(rsp, jnp.asarray(vals), jnp.asarray(r))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("cell", CELLS)
def test_ordered_row_sums_equal_index_add(cell):
    """The fixed-order sum `coo_matvec` runs on CUDA tensors (ROADMAP
    Queue 3 F1) adds each row's products in pattern order, as the CPU's
    `index_add_` does: bit for bit, on rows of up to four entries."""
    _, ckt, _ = _circuits(cell)
    sp = ckt.build_sparsity()
    tab = sps._row_table(sp)
    assert tab.shape[0] == sp.n and tab.shape[1] >= 4
    for i in range(sp.n):
        got = tab[i][tab[i] < sp.nnz]
        np.testing.assert_array_equal(got, np.nonzero(sp.rows == i)[0])
    B = 7
    vals = torch.as_tensor(_pattern_values(sp, B))
    v = torch.as_tensor(np.random.default_rng(3).uniform(-1.0, 1.0,
                                                         (B, sp.n)))
    prod = vals * v[:, torch.as_tensor(sp.cols)]
    want = torch.zeros_like(v).index_add_(1, torch.as_tensor(sp.rows), prod)
    got = sps.ordered_row_sums(torch.as_tensor(tab), prod)
    assert torch.equal(got, want)
    assert torch.equal(sps.coo_matvec(sp, vals, v), want)


def _lattice_inputs(B=3, cell="gc2t_nn", ws=16, nw=16, seed=42,
                    per_lane_t0=False):
    """One topology's run_lattice inputs with per-lane R/C and stop-time
    jitter, from the port's netlist: the recipe of the reference's
    tests/test_fused_newton.py (one waveform for every lane), or with
    per_lane_t0 that of benchmarks/bench_transient.py (each lane's
    precharge release at its own stop time's T0_FRACTION)."""
    bank = build_bank(BankConfig(ws, nw, cell))
    ckt, meta = timing.read_netlist(bank)
    res_stamps, cap_stamps, src_G = ckt.build_stamps()
    rng = np.random.default_rng(seed)
    g = np.asarray([g for _, _, g in ckt.res])
    c = np.asarray([c for _, _, c in ckt.caps])
    g_b = g[None] * (1 + 0.1 * rng.uniform(-1, 1, (B, len(g))))
    c_b = c[None] * (1 + 0.1 * rng.uniform(-1, 1, (B, len(c))))
    t_an, _ = timing.cell_read_time(bank)
    t_end1 = max(timing.T_END_OVER_ANALYTIC * t_an, timing.T_END_MIN_S)
    t_end = t_end1 * (1 + 0.1 * rng.uniform(-1, 1, B))
    t0 = timing.T0_FRACTION * (t_end if per_lane_t0 else np.full(B, t_end1))
    wt = wv = None
    for p in range(B):
        waves, v_pre = timing.read_stimulus(bank.cell, bank.cfg.tech,
                                            meta["v_sn"], t0[p])
        if wt is None:
            k = max(len(t) for t, _ in waves)
            wt = np.zeros((B, len(waves), k))
            wv = np.zeros((B, len(waves), k))
        for w, (t, v) in enumerate(waves):
            wt[p, w] = t + [t[-1]] * (k - len(t))
            wv[p, w] = v + [v[-1]] * (k - len(v))
    return ckt.build(device="cpu"), bank, dict(
        wt=wt, wv=wv, t_end=t_end, t0=t0, v_pre=v_pre,
        G_b=src_G[None] + np.einsum("br,rij->bij", g_b, res_stamps),
        C_b=np.einsum("bc,cij->bij", c_b, cap_stamps))


def _run(system, inp, solver, precision="f64", n_steps=60):
    tr = Transient(system, solver=solver, precision=precision)
    return tr.run_lattice(inp["wt"], inp["wv"], inp["t_end"], n_steps,
                          over_batches={"G": inp["G_b"], "C": inp["C_b"]},
                          v0=torch.full((system.n,), inp["v_pre"], **f64))


def _t_cell(res, bank, inp):
    swing = bank.cfg.tech.v_sense_se
    target = inp["v_pre"] + (swing if bank.cell.predischarge else -swing)
    tc, valid = crossing_time(res["t"], res["rbl_near"].double(), target,
                              rising=bank.cell.predischarge)
    assert bool(valid.all())
    return tc.numpy() - inp["t0"]


def _step_operands(precision):
    """The first backward-Euler step's operands of a jittered lattice:
    (system, spec, j_const, rhs, params, v0)."""
    system, _, inp = _lattice_inputs()
    tr = Transient(system, solver="sparse", precision=precision)
    spec = tr.spec
    sdt, cdt = spec.dtypes
    n_steps = 60
    te = torch.as_tensor(inp["t_end"], **f64)
    h = te / n_steps
    gn = spec.sp.project_dense(torch.as_tensor(inp["G_b"], dtype=cdt))
    cn = spec.sp.project_dense(torch.as_tensor(inp["C_b"], dtype=cdt))
    j_const = sps.j_constant(spec, gn, cn, h)
    src = tr.src_sequence(te, torch.as_tensor(inp["wt"], **f64),
                          torch.as_tensor(inp["wv"], **f64), n_steps)
    B = te.shape[0]
    v0 = torch.full((B, system.n), inp["v_pre"], dtype=sdt)
    rhs = sps.coo_matvec(spec.sp, (cn / h[:, None]).to(cdt), v0.to(cdt)) \
        + src[:, 0]
    params = sps.pack_params(system.dev, B, cdt)
    return system, spec, dict(j_const=j_const, rhs=rhs, params=params,
                              v0=v0, gn=gn, cn=cn, h=h)


def _ref_spec(precision):
    ref_ckt, _, _ = _circuits("gc2t_nn", 16, 16)
    ref_system = ref_ckt.build()
    return ref_sps.build_spec(ref_system,
                              RefMNASparsity.from_system(ref_system),
                              precision)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_newton_iteration_matches_reference(precision):
    """One iteration, the residual, the Jacobian values and j_constant
    on the same operands, against the reference's."""
    _, spec, op = _step_operands(precision)
    done = torch.zeros((op["v0"].shape[0],), dtype=torch.bool)
    v1, done1 = sps.make_newton_iter(spec, 1e-6)(
        op["j_const"], op["rhs"], op["params"], op["v0"], done)
    res = sps.sparse_residual(spec, op["j_const"], op["rhs"], op["params"],
                              v1)
    jv = sps._jac_vals(spec, op["j_const"], op["params"], v1)
    with jax.enable_x64(True):
        a = {k: jnp.asarray(v.numpy()) for k, v in op.items()}
        rspec = _ref_spec(precision)
        rj = ref_sps.j_constant(rspec, a["gn"], a["cn"], a["h"])
        rv1, rdone1 = ref_sps.make_newton_iter(rspec, 1e-6)(
            a["j_const"], a["rhs"], a["params"], a["v0"],
            jnp.zeros((op["v0"].shape[0],), bool))
        rres = ref_sps.sparse_residual(rspec, a["j_const"], a["rhs"],
                                       a["params"], jnp.asarray(v1.numpy()))
        rjv = ref_sps._jac_vals(rspec, a["j_const"], a["params"],
                                jnp.asarray(v1.numpy()))
        rv1, rdone1, rj, rres, rjv = map(np.asarray,
                                         (rv1, rdone1, rj, rres, rjv))
    np.testing.assert_allclose(op["j_const"].numpy(), rj, rtol=RTOL_STEP)
    assert v1.dtype == (torch.float32 if precision == "mixed"
                        else torch.float64)
    np.testing.assert_allclose(v1.numpy(), rv1, rtol=RTOL_STEP)
    np.testing.assert_array_equal(done1.numpy(), rdone1)
    np.testing.assert_allclose(res.numpy(), rres, rtol=RTOL_STEP,
                               atol=RTOL_STEP * float(np.abs(rres).max()))
    np.testing.assert_allclose(jv.numpy(), rjv, rtol=RTOL_STEP,
                               atol=RTOL_STEP * float(np.abs(rjv).max()))


def test_fixed_count_loop_equals_early_exit():
    """The port's `iters` masked iterations equal, bit for bit, a loop
    that stops once every lane is done; its iteration count is that
    loop's, and the reference's."""
    _, spec, op = _step_operands("f64")
    args = (op["j_const"], op["rhs"], op["params"])
    v, n_it = sps.newton_solve(spec, *args, op["v0"], 6, 1e-6)
    it = sps.make_newton_iter(spec, 1e-6)
    w, done = op["v0"], torch.zeros((op["v0"].shape[0],), dtype=torch.bool)
    n_early = 0
    while n_early < 6 and not bool(done.all()):
        w, done = it(*args, w, done)
        n_early += 1
    assert torch.equal(v, w)
    assert n_it.dim() == 0 and int(n_it) == n_early and 1 < n_early < 6
    with jax.enable_x64(True):
        a = [jnp.asarray(x.numpy()) for x in args + (op["v0"],)]
        rv, rn = ref_sps.newton_solve(_ref_spec("f64"), *a, 6, 1e-6)
        rv, rn = np.asarray(rv), int(rn)
    assert rn == n_early
    np.testing.assert_allclose(v.numpy(), rv, rtol=RTOL_STEP)


def test_newton_solve_implicit_backward_is_deferred():
    """The backward, deferred until item 11, is the implicit-function
    VJP: with F = J0 v - rhs + currents, d v*/d rhs = J(v*)^-1, so the
    gradient of sum(v*) with respect to rhs is J(v*)^-T 1 (J from
    autograd of `sparse_residual` at the root)."""
    _, spec, op = _step_operands("f64")
    rhs = op["rhs"].clone().requires_grad_(True)
    v = sps.newton_solve_implicit(spec, 30, 1e-6, op["j_const"], rhs,
                                  op["params"], op["v0"])
    assert torch.equal(v.detach(), sps.newton_solve(
        spec, op["j_const"], op["rhs"], op["params"], op["v0"], 30,
        1e-6)[0])
    (g,) = torch.autograd.grad(v.sum(), rhs)
    J = torch.func.vmap(torch.func.jacrev(
        lambda x, jc, r, p: sps.sparse_residual(
            spec, jc[None], r[None], p[None], x[None])[0]))(
        v.detach(), op["j_const"], op["rhs"], op["params"])
    want = torch.linalg.solve(J.transpose(1, 2), torch.ones_like(g))
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np"])
def test_sparse_lattice_matches_dense(cell):
    system, _, inp = _lattice_inputs(cell=cell)
    ref = _run(system, inp, "jnp")
    got = _run(system, inp, "sparse")
    assert got["all"].dtype == torch.float64
    dev = float((got["all"] - ref["all"]).abs().max())
    assert dev <= ATOL_TRACE, dev


def test_sparse_t_cell_matches_dense_engine():
    system, bank, inp = _lattice_inputs(B=16, ws=32, nw=32, seed=0,
                                        per_lane_t0=True)
    dense = _t_cell(_run(system, inp, "jnp", n_steps=300), bank, inp)
    got = _t_cell(_run(system, inp, "sparse", n_steps=300), bank, inp)
    rel = float(np.max(np.abs(got - dense) / dense))
    assert rel <= RTOL_SPARSE_VS_DENSE, rel


def test_sparse_mixed_precision_stores_float32():
    system, bank, inp = _lattice_inputs()
    ref = _run(system, inp, "sparse")
    got = _run(system, inp, "sparse", precision="mixed")
    assert got["all"].dtype == torch.float32
    rel = np.abs(_t_cell(got, bank, inp) - _t_cell(ref, bank, inp)) \
        / _t_cell(ref, bank, inp)
    assert float(rel.max()) <= 0.01


def test_characterize_sparse_matches_reference():
    """The sparse and the fused engine, each within 1e-9 of the
    reference's. Each engine freezes a lane once its Newton update is
    under 1e-6 V, so the two engines' t_cell differ by more than round-off
    where a read is slow: on gc2t_osos 16x16 the reference's own sparse
    and fused engines differ by 3.4e-10, and the port's by as much."""
    lattice = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16,),
                   num_words=(16,), wwlls=(False,))
    t_cell = {}
    for solver in ("sparse", "pallas"):
        want = ref_cb.characterize(ref_dse.lattice_configs(**lattice),
                                   solver=solver)
        got = char_batch.characterize(dse.lattice_configs(**lattice),
                                      solver=solver, device="cpu")
        assert len(got) == len(want) == 2
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g.t_cell_s, w.t_cell_s,
                                       rtol=RTOL_T_CELL)
            assert (g.swing_ok, g.n_steps) == (w.swing_ok, w.n_steps)
        t_cell[solver] = [np.array([c.t_cell_s for c in x])
                          for x in (got, want)]
    gaps = [np.abs(sp - fu) / fu
            for sp, fu in zip(t_cell["sparse"], t_cell["pallas"])]
    np.testing.assert_allclose(gaps[0], gaps[1], rtol=0,
                               atol=2 * RTOL_T_CELL)
