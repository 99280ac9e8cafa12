"""Port parity of the differentiable DSE path (`repro_torch.core.dse_grad`,
`char_batch.t_cell_grad_fn`, the implicit-function adjoints of the
Newton engines) against the JAX reference under x64, plus the port's
own finite-difference checks.

Limits:
  * the analytic evaluator's outputs: 1e-12 relative to the reference
    (the same float64 algebra); its Jacobian 1e-10 relative to
    `jax.jacrev` (atol 1e-16 of the Jacobian's scale, as the reference
    compares its own forward and reverse modes), and within 1e-4 of
    central differences (the reference's `_rel_err` with relative steps
    of 1e-4);
  * `quantized=True` against the port's `dse.evaluate`: the timing and
    bandwidth fields 1e-12; retention, refresh and standby power 2e-6,
    because the port's `dse.evaluate` integrates retention in float32
    like the reference's compile flow (tests/test_torch_dse.py), while
    the differentiable evaluator runs it in float64; those three are
    held to the reference's `dse.evaluate` under x64 at 1e-12;
  * `newton.residual` and `fixed_point_adjoint`: 1e-12 of each block's
    scale at f64;
  * transient gradients: t_cell 1e-9 of the reference, gradients 1e-7
    of its `jax.grad` and 1e-4 of central differences.
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
from repro.core import dse_grad as ref_dse_grad  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core.spice import char_batch as ref_char_batch  # noqa: E402
from repro.core.spice import transient as ref_tr  # noqa: E402
from repro.core.spice.mna import G_BIG  # noqa: E402
from repro.kernels.batched_solve import newton as ref_nwt  # noqa: E402
from repro.kernels.batched_solve import sparse as ref_sps  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dse, dse_grad, timing  # noqa: E402
from repro_torch.core.bank import BankConfig, build_bank  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.core.spice import transient as pt_tr  # noqa: E402
from repro_torch.kernels.batched_solve import newton as nwt  # noqa: E402
from repro_torch.kernels.batched_solve import ops  # noqa: E402
from test_torch_fused_newton import (_lattice_case,  # noqa: E402
                                     _scan_operands, _spec_fields)

KNOBS, OUTPUTS = dse_grad.KNOBS, dse_grad.OUTPUTS
EPS_REL = 1e-4      # central-difference relative step
TOL_REL = 1e-4      # the reference's contract
RTOL = 1e-12
RTOL_RETENTION = 2e-6
RTOL_T_CELL = 1e-9
RTOL_GRAD = 1e-7
BASE = {"vdd_scale": 0.95, "w_read_scale": 1.10,
        "w_write_scale": 0.90, "bl_wire_scale": 1.05}
CASES = [("gc2t_nn", False), ("gc2t_np", True), ("gc2t_osos", False)]
RET_FIELDS = ("retention_s", "refresh_w", "standby_w")
TIMING_FIELDS = ("t_read_s", "t_write_s", "f_max_hz", "leakage_w",
                 "read_bw_bps", "eff_bw_bps")


def _rel_err(ad, fd, out_mag, x_mag):
    """|ad - fd| relative to the gradient scale (the reference's
    `_rel_err`): gradients below 1e-7 |f| / |x| are numerically zero at
    this step size and compare against that floor."""
    floor = 1e-7 * (abs(out_mag) / max(x_mag, 1e-30) + 1e-300)
    return abs(ad - fd) / max(abs(ad), abs(fd), floor)


def _port_vec_fn(cfg):
    fn = dse_grad.evaluate_grad_fn(cfg, device="cpu")

    def vec_fn(x):
        out = fn({k: x[i:i + 1] for i, k in enumerate(KNOBS)})
        return torch.stack([out[o][0] for o in OUTPUTS])

    return vec_fn


def _ref_vec_fn(cfg):
    fn = ref_dse_grad.evaluate_grad_fn(cfg)

    def vec_fn(x):
        out = fn({k: x[i][None] for i, k in enumerate(KNOBS)})
        return jnp.stack([out[o][0] for o in OUTPUTS])

    return vec_fn


# ---------------------------------------------------------------------------
# 1. the analytic evaluator
# ---------------------------------------------------------------------------

def test_names_match_reference():
    assert KNOBS == ref_dse_grad.KNOBS
    assert OUTPUTS == ref_dse_grad.OUTPUTS


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cell,wwlls", CASES)
def test_evaluate_grad_fn_matches_reference(cell, wwlls, quantized):
    knobs = np.array([[BASE[k] for k in KNOBS], [1.0] * 4, [1.2, 0.7, 1.6,
                                                             0.6]])
    with jax.enable_x64(True):
        want = ref_dse_grad.evaluate_grad_fn(
            RefBankConfig(32, 64, cell=cell, wwlls=wwlls),
            quantized=quantized)(
            {k: jnp.asarray(knobs[:, i]) for i, k in enumerate(KNOBS)})
        want = {k: np.asarray(v) for k, v in want.items()}
    got = dse_grad.evaluate_grad(
        BankConfig(32, 64, cell=cell, wwlls=wwlls),
        {k: torch.tensor(knobs[:, i]) for i, k in enumerate(KNOBS)},
        quantized=quantized, device="cpu")
    assert set(got) == set(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == torch.float64 and got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("cell,wwlls", CASES)
def test_jacobian_matches_reference_and_central_differences(cell, wwlls):
    x0 = np.array([BASE[k] for k in KNOBS])
    with jax.enable_x64(True):
        want = np.asarray(jax.jacrev(_ref_vec_fn(
            RefBankConfig(32, 64, cell=cell, wwlls=wwlls)))(jnp.asarray(x0)))
    vec_fn = _port_vec_fn(BankConfig(32, 64, cell=cell, wwlls=wwlls))
    jac = torch.func.jacrev(vec_fn)(torch.tensor(x0)).numpy()
    assert jac.shape == (len(OUTPUTS), len(KNOBS))
    np.testing.assert_allclose(jac, want, rtol=1e-10,
                               atol=1e-16 * float(np.abs(want).max()))
    with torch.no_grad():
        y0 = vec_fn(torch.tensor(x0)).numpy()
        for j, knob in enumerate(KNOBS):
            h = EPS_REL * x0[j]
            xp, xm = x0.copy(), x0.copy()
            xp[j] += h
            xm[j] -= h
            fd = (vec_fn(torch.tensor(xp)) - vec_fn(torch.tensor(xm))) \
                .numpy() / (2 * h)
            for i, out in enumerate(OUTPUTS):
                err = _rel_err(jac[i, j], fd[i], y0[i], x0[j])
                assert err < TOL_REL, (out, knob, jac[i, j], fd[i], err)


@pytest.mark.parametrize("cell,wwlls", [("gc2t_nn", False),
                                        ("gc2t_np", False),
                                        ("gc2t_osos", True)])
def test_quantized_matches_evaluate(cell, wwlls):
    fn = dse_grad.evaluate_grad_fn(BankConfig(32, 64, cell=cell,
                                              wwlls=wwlls),
                                   quantized=True, device="cpu")
    for vs in (0.8, 1.0, 1.15):
        out = fn({"vdd_scale": torch.tensor([vs], dtype=torch.float64)})
        got = {k: float(v[0]) for k, v in out.items()}
        pt = dse.evaluate(BankConfig(32, 64, cell=cell, wwlls=wwlls),
                          vdd_scale=vs, device="cpu")
        for f in TIMING_FIELDS:
            assert got[f] == pytest.approx(getattr(pt, f), rel=RTOL, abs=0), \
                (vs, f)
        for f in RET_FIELDS:
            assert got[f] == pytest.approx(getattr(pt, f),
                                           rel=RTOL_RETENTION), (vs, f)
        with jax.enable_x64(True):
            ref = ref_dse.evaluate(RefBankConfig(32, 64, cell=cell,
                                                 wwlls=wwlls), vdd_scale=vs)
        for f in RET_FIELDS:
            assert got[f] == pytest.approx(getattr(ref, f), rel=RTOL,
                                           abs=0), (vs, f)


def test_second_order_gradgradcheck():
    """The VJP of the VJP is right too: standby power along vdd_scale at
    0.93, second order (the reference's `check_grads(order=2)`)."""
    fn = dse_grad.evaluate_grad_fn(BankConfig(32, 64, cell="gc2t_np"),
                                   device="cpu")

    def f(vs):
        return fn({"vdd_scale": vs[None]})["standby_w"]

    x = torch.tensor(0.93, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-12,
                                    rtol=1e-3)
    assert torch.autograd.gradgradcheck(f, (x,), eps=1e-6, atol=1e-12,
                                        rtol=1e-3)


# ---------------------------------------------------------------------------
# 2. the fixed-point adjoint of the fused engine
# ---------------------------------------------------------------------------

def _adjoint_case(cell, precision, seed=3):
    """One converged step of `_lattice_case`'s 16x64 lattice: the
    reference's operands as numpy, the root from its early-exit solve, a
    seeded cotangent, and the reference's residual and VJP there."""
    ckt, inp = _lattice_case(cell)
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        system = ckt.build()
        spec = ref_nwt.build_fused_spec(system, precision)
        sdt, cdt = spec.dtypes
        B = inp["t_end"].shape[0]
        pre = ref_nwt.precompute(spec, inp["G_b"], inp["C_b"],
                                 inp["t_end"] / 60)
        src = np.zeros((B, system.n))
        src[:, system.src_node] = G_BIG * rng.uniform(
            0, 1.1, (B, len(system.src_node)))
        v0 = jnp.asarray(inp["v_pre"] + 0.02 * rng.uniform(
            -1, 1, (B, system.n)), sdt)
        Krhs = jnp.einsum("bij,bj->bi", pre["KCoh"], v0.astype(cdt)) \
            + jnp.einsum("bij,bj->bi", pre["K"], jnp.asarray(src, cdt))
        params = ref_sps.pack_params(system.dev, B, sdt)
        v_star, _ = ref_nwt.newton_solve(spec, pre, Krhs, params, v0, 30,
                                         1e-6)
        v_bar = jnp.asarray(rng.normal(size=(B, system.n)), sdt)
        F = ref_nwt.residual(spec, pre, Krhs, params, v_star)
        pre_bar, krhs_bar, p_bar = ref_nwt.fixed_point_adjoint(
            spec, pre, Krhs, params, v_star, v_bar)
        np_ = lambda x: np.asarray(x)  # noqa: E731
        want = {"F": np_(F), "Krhs": np_(krhs_bar), "params": np_(p_bar),
                **{k: np_(v) for k, v in pre_bar.items()}}
    pspec, ppre, pKrhs, pparams, pv = interop.fused_inputs_from_numpy(
        _spec_fields(spec), {k: np.asarray(v) for k, v in pre.items()},
        np.asarray(Krhs), np.asarray(params), np.asarray(v_star),
        device="cpu", precision=precision)
    pbar = torch.tensor(np.asarray(v_bar), dtype=pv.dtype)
    return (pspec, ppre, pKrhs, pparams, pv, pbar), want


@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "gc2t_osos"])
def test_residual_and_adjoint_match_reference(cell):
    (spec, pre, Krhs, params, v, v_bar), want = _adjoint_case(cell, "f64")
    F = nwt.residual(spec, pre, Krhs, params, v)
    # the root: the residual is round-off of its terms
    assert float(F.abs().max()) < 1e-9
    np.testing.assert_allclose(F.numpy(), want["F"], rtol=0,
                               atol=1e-12 * float(Krhs.abs().max()))
    pre_bar, krhs_bar, p_bar = nwt.fixed_point_adjoint(
        spec, pre, Krhs, params, v, v_bar)
    assert set(pre_bar) == set(pre)
    got = {"Krhs": krhs_bar, "params": p_bar, **pre_bar}
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape and g.dtype == torch.float64, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-12 * float(np.abs(w).max())
                                   + 1e-300, err_msg=k)
    for k in ("K", "KU", "Sb", "KCoh"):     # the root ignores these
        assert not pre_bar[k].any(), k


def test_adjoint_cotangent_dtypes_under_mixed():
    """Under "mixed" the cotangents come back in the caller's dtypes:
    pre and Krhs float64, params and the state float32; the result
    still follows the reference's."""
    (spec, pre, Krhs, params, v, v_bar), want = _adjoint_case("gc2t_np",
                                                              "mixed")
    assert params.dtype == v.dtype == torch.float32
    pre_bar, krhs_bar, p_bar = nwt.fixed_point_adjoint(
        spec, pre, Krhs, params, v, v_bar)
    assert krhs_bar.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in pre_bar.values())
    assert p_bar.dtype == torch.float32
    for k, g in (("Krhs", krhs_bar), ("params", p_bar),
                 ("KPa", pre_bar["KPa"])):
        w = want[k]
        assert g.numpy().dtype == w.dtype, k
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


def test_adjoint_operator_applies_the_woodbury_solve():
    """`adjoint_operator` (M^-T for every lane, used by the scan's
    backward) applied to a cotangent equals `_adjoint_lam`, and
    M^T (M^-T x) = x with M = dF/dv from autograd."""
    (spec, pre, Krhs, params, v, v_bar), _ = _adjoint_case("gc2t_nn", "f64")
    W = nwt.adjoint_operator(spec, pre, params, v)
    lam = nwt._adjoint_lam(spec, pre, params, v, v_bar)
    np.testing.assert_allclose(torch.einsum("bij,bj->bi", W, v_bar).numpy(),
                               lam.numpy(), rtol=0,
                               atol=1e-12 * float(lam.abs().max()))
    M = torch.func.vmap(torch.func.jacrev(
        lambda x, p, kr, pa, pg: nwt.residual(
            spec, {"KPa": pa[None], "KPg": pg[None]}, kr[None], p[None],
            x[None])[0]))(v, params, Krhs, pre["KPa"], pre["KPg"])
    back = torch.einsum("bji,bj->bi", M, lam)
    np.testing.assert_allclose(back.numpy(), v_bar.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_scan_backward_equals_stepping_the_step_function(precision):
    """The scan's backward (every M_t^-T at once, then the lam
    recurrence in reverse time) equals autograd through a Python loop of
    the one-step Function, whose backward is `fixed_point_adjoint` per
    step, as the reference's scan over its custom_vjp step: every
    cotangent (KCoh, KPa, KPg, Ksrc, params, v0) to 1e-12 of its scale
    at f64 and 1e-6 under "mixed", in the inputs' dtypes."""
    spec, pre, Ksrc, params, v0 = _scan_operands("gc2t_np", precision)
    _, cdt = spec.dtypes
    T = Ksrc.shape[0]
    w = torch.tensor(np.random.default_rng(1).normal(size=(v0.shape[0], T,
                                                           spec.n)))
    names = ("KCoh", "KPa", "KPg")

    def leaves():
        out = {k: pre[k].clone().requires_grad_() for k in names}
        out.update(Ksrc=Ksrc.clone().requires_grad_(),
                   params=params.clone().requires_grad_(),
                   v0=v0.clone().requires_grad_())
        return out

    a = leaves()
    p = dict(pre, **{k: a[k] for k in names})
    vs = ops.fused_newton_scan(spec, p, a["Ksrc"], a["params"], a["v0"],
                               iters=6, tol=1e-6)
    got = torch.autograd.grad((vs.double() * w).sum(), list(a.values()))
    b = leaves()
    p = dict(pre, **{k: b[k] for k in names})
    v, steps = b["v0"], []
    for t in range(T):
        Krhs = torch.einsum("bij,bj->bi", p["KCoh"], v.to(cdt)) \
            + b["Ksrc"][t]
        v = ops.fused_newton_step(spec, p, Krhs, b["params"], v, iters=6,
                                  tol=1e-6)
        steps.append(v)
    assert torch.equal(torch.stack(steps, dim=1), vs.detach())
    want = torch.autograd.grad((torch.stack(steps, dim=1).double() * w)
                               .sum(), list(b.values()))
    tol = {"f64": 1e-12, "mixed": 1e-6}[precision]
    for k, g, wg in zip(a, got, want):
        assert g.dtype == a[k].dtype == wg.dtype, k
        assert float(wg.abs().max()) > 0, k
        np.testing.assert_allclose(g.double().numpy(), wg.double().numpy(),
                                   rtol=0, atol=tol * float(wg.abs().max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 3. whole transients: iteration independence and t_cell gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["pallas", "sparse"])
def test_fixed_point_vjp_independent_of_newton_iters(solver):
    """Past convergence the implicit-function adjoint depends only on
    the fixed point: doubling the Newton budget reproduces the port's
    gradient bit for bit, and it is the reference's within 1e-9."""
    ckt, inp = _lattice_case("gc2t_nn", B=2)
    with jax.enable_x64(True):
        system = ckt.build()
        v0 = jnp.full((system.n,), inp["v_pre"])

        def ref_loss(scale):
            tr = ref_tr.Transient(system, solver=solver, iters=30)
            res = tr.run_lattice(
                inp["wt"], inp["wv"], inp["t_end"], 40,
                over_batches={"G": jnp.asarray(inp["G_b"]) * scale,
                              "C": jnp.asarray(inp["C_b"])}, v0=v0)
            return jnp.sum(res["all"][:, -1, :] ** 2)

        want = float(jax.grad(ref_loss)(jnp.asarray(1.0)))
    psys = timing.read_netlist(build_bank(BankConfig(16, 64, "gc2t_nn")))[0] \
        .build(device="cpu")

    def grad(iters):
        tr = pt_tr.Transient(psys, solver=solver, iters=iters)
        x = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        res = tr.run_lattice(
            inp["wt"], inp["wv"], inp["t_end"], 40,
            over_batches={"G": torch.tensor(inp["G_b"]) * x,
                          "C": torch.tensor(inp["C_b"])},
            v0=torch.full((psys.n,), inp["v_pre"], dtype=torch.float64))
        (g,) = torch.autograd.grad((res["all"][:, -1, :] ** 2).sum(), x)
        return float(g)

    g30, g60 = grad(30), grad(60)
    assert g30 == g60, (g30, g60)
    assert np.isfinite(g30) and g30 != 0.0
    assert g30 == pytest.approx(want, rel=RTOL_T_CELL)


T_KNOBS = ("vdd_scale", "w_read_scale", "bl_wire_scale")
T_BASE = np.array([0.97, 1.05, 0.92])


def t_cell_rows() -> np.ndarray:
    """The reference test's 8-row batch: the nominal point, the base
    point, and the base point +/- a 1e-4 relative step per knob."""
    h = EPS_REL * T_BASE
    rows = [np.ones(3), T_BASE]
    for j in range(3):
        for s in (+1, -1):
            p = T_BASE.copy()
            p[j] += s * h[j]
            rows.append(p)
    return np.stack(rows)


@pytest.mark.parametrize("solver", ["pallas", "sparse"])
def test_t_cell_grad_fn_matches_reference(solver):
    X = t_cell_rows()
    with jax.enable_x64(True):
        rfn = ref_char_batch.t_cell_grad_fn(
            RefBankConfig(16, 16, cell="gc2t_np"), solver=solver)
        want_t, want_valid = rfn({k: jnp.asarray(X[:, j])
                                  for j, k in enumerate(T_KNOBS)})
        want_g = np.asarray(jax.grad(
            lambda x: jnp.sum(rfn({k: x[:, j] for j, k in
                                   enumerate(T_KNOBS)})[0]))(
            jnp.asarray(X[:2])))
    cfg = BankConfig(16, 16, cell="gc2t_np")
    fn = char_batch.t_cell_grad_fn(cfg, solver=solver, device="cpu")
    x = torch.tensor(X, requires_grad=True)
    t, valid = fn({k: x[:, j] for j, k in enumerate(T_KNOBS)})
    assert valid.all() and np.asarray(want_valid).all()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(want_t),
                               rtol=RTOL_T_CELL)
    t_cell = t.detach().numpy()
    nominal = char_batch.characterize([cfg], solver=solver, device="cpu")[0]
    assert t[0].item() == pytest.approx(nominal.t_cell_s, rel=RTOL_T_CELL)
    (g,) = torch.autograd.grad(t[:2].sum(), x)
    g = g[:2].numpy()
    np.testing.assert_allclose(g, want_g, rtol=RTOL_GRAD, atol=0)
    t = t_cell
    h = EPS_REL * T_BASE
    for j, name in enumerate(T_KNOBS):
        fd = (t[2 + 2 * j] - t[3 + 2 * j]) / (2 * h[j])
        err = _rel_err(g[1, j], fd, t[1], T_BASE[j])
        assert err < TOL_REL, (solver, name, g[1, j], fd, err)
