"""Port parity: the fused Woodbury-Newton engine of `repro_torch` against
the reference's Pallas kernel in interpret mode and its fused lattice run,
plus the port's own invariants (early exit == fixed length, CPU dispatch,
the scan entry == stepping the step entry, interpolation and crossing
extraction)."""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import timing as ref_timing  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core.bank import build_bank as ref_build_bank  # noqa: E402
from repro.core.spice import transient as ref_tr  # noqa: E402
from repro.core.spice.mna import G_BIG  # noqa: E402
from repro.kernels.batched_solve import newton as ref_nwt  # noqa: E402
from repro.kernels.batched_solve import sparse as ref_sps  # noqa: E402
from repro.kernels.batched_solve.fused import fused_newton as ref_kernel  # noqa: E402,E501
from repro_torch import interop  # noqa: E402
from repro_torch.core.spice import transient as pt_tr  # noqa: E402
from repro_torch.kernels.batched_solve import newton as nwt  # noqa: E402
from repro_torch.kernels.batched_solve import ops  # noqa: E402
from repro_torch.kernels.batched_solve.fused import (  # noqa: E402
    fused_newton, fused_newton_scan)

B = 5            # not a multiple of the reference kernel's block_b (8)
ITERS, TOL = 6, 1e-6
ATOL = {"f64": 1e-12, "mixed": 1e-6, "f32": 1e-4}
CELLS = ("gc2t_nn", "gc2t_np")


def _ref_step(cell, precision, seed=7):
    """Reference operands of one Newton solve: per-lane jittered R/C of a
    16x64 read netlist, `precompute`, and the step after the read
    wordline fires, started from the precharge state plus jitter."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        bank = ref_build_bank(RefBankConfig(16, 64, cell))
        ckt, meta = ref_timing.read_netlist(bank)
        res_st, cap_st, src_G = ckt.build_stamps()
        system = ckt.build()
        g = np.array([g for _, _, g in ckt.res])
        c = np.array([c for _, _, c in ckt.caps])
        G_b = src_G[None] + np.einsum(
            "br,rij->bij", g * (1 + 0.1 * rng.uniform(-1, 1, (B, len(g)))),
            res_st)
        C_b = np.einsum(
            "bc,cij->bij", c * (1 + 0.1 * rng.uniform(-1, 1, (B, len(c)))),
            cap_st)
        h = rng.uniform(1e-12, 3e-12, B)
        spec = ref_nwt.build_fused_spec(system, precision)
        sdt, cdt = spec.dtypes
        pre = ref_nwt.precompute(spec, G_b, C_b, h)
        t0 = 1e-11
        waves, v_pre = ref_timing.read_stimulus(bank.cell, bank.cfg.tech,
                                                meta["v_sn"], t0)
        wv = np.array([np.interp(2 * t0, t, v) for t, v in waves])
        src = np.zeros((B, system.n))
        np.add.at(src, (slice(None), system.src_node),
                  1e2 * wv[system.src_wave])
        v0 = v_pre + 0.02 * rng.uniform(-1, 1, (B, system.n))
        v0 = jnp.asarray(v0, sdt)
        Krhs = jnp.einsum("bij,bj->bi", pre["KCoh"], v0.astype(cdt)) \
            + jnp.einsum("bij,bj->bi", pre["K"], jnp.asarray(src, cdt))
        params = ref_sps.pack_params(system.dev, B, sdt)
        out = ref_kernel(spec, pre, Krhs, params, v0, iters=ITERS, tol=TOL,
                         interpret=True)
        arrays = {"pre": {k: np.asarray(v) for k, v in pre.items()},
                  "Krhs": np.asarray(Krhs), "params": np.asarray(params),
                  "v0": np.asarray(v0), "out": np.asarray(out),
                  "G_b": G_b, "C_b": C_b, "h": h}
    return spec, system, arrays


def _spec_fields(spec):
    """The reference FusedSpec's fields as a plain dict."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if f.name != "precision"}


def _port_step(spec, a, precision):
    return interop.fused_inputs_from_numpy(
        _spec_fields(spec), a["pre"], a["Krhs"], a["params"], a["v0"],
        device="cpu", precision=precision)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", list(ATOL))
def test_fixed_loop_matches_reference_kernel(precision, cell):
    spec, _, a = _ref_step(cell, precision)
    pspec, pre, Krhs, params, v0 = _port_step(spec, a, precision)
    got = nwt.newton_solve_fixed(pspec, pre, Krhs, params, v0, ITERS, TOL)
    assert got.dtype == v0.dtype and got.shape == (B, spec.n)
    np.testing.assert_allclose(got.numpy(), a["out"], rtol=0,
                               atol=ATOL[precision])
    # the solve really moved the state
    assert float(np.abs(a["out"] - a["v0"]).max()) > 0.1


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", list(ATOL))
def test_early_exit_equals_fixed_length(precision, cell):
    """Per-lane freeze: the early-exit loop and the fixed-length loop (the
    kernel's control flow) agree bit for bit, including the iteration in
    which a lane converges."""
    spec, _, a = _ref_step(cell, precision, seed=11)
    pspec, pre, Krhs, params, v0 = _port_step(spec, a, precision)
    for tol in (TOL, 1e-9, 1e-3):
        fixed = nwt.newton_solve_fixed(pspec, pre, Krhs, params, v0,
                                       ITERS, tol)
        early, n_it = nwt.newton_solve(pspec, pre, Krhs, params, v0,
                                       ITERS, tol)
        assert torch.equal(fixed, early), tol
        assert 1 <= n_it <= ITERS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", list(ATOL))
def test_precompute_and_spec_match_reference(precision, cell):
    spec, system, a = _ref_step(cell, precision)
    from repro_torch.core import timing
    from repro_torch.core.bank import BankConfig, build_bank
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, cell)))
    pspec = nwt.build_fused_spec(ckt.build(device="cpu"), precision)
    for f in _spec_fields(spec):
        np.testing.assert_array_equal(getattr(pspec, f), getattr(spec, f))
    pre = nwt.precompute(pspec, torch.as_tensor(a["G_b"]),
                         torch.as_tensor(a["C_b"]), torch.as_tensor(a["h"]))
    # K = J0^-1 of a cond ~ 1e6 matrix from another LAPACK: agreement
    # to round-off times the condition number, relative to each block
    rtol = 1e-9 if precision != "f32" else 1e-2
    for k, want in a["pre"].items():
        got = pre[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rtol * float(np.abs(want).max()),
                                   err_msg=k)


def test_cpu_dispatch_runs_plain_versions_without_launching():
    spec, _, a = _ref_step("gc2t_nn", "f64")
    pspec, pre, Krhs, params, v0 = _port_step(spec, a, "f64")
    before = fused_newton.launches
    v_k = fused_newton(pspec, pre, Krhs, params, v0, iters=ITERS, tol=TOL)
    v_s = ops.fused_newton_step(pspec, pre, Krhs, params, v0, iters=ITERS,
                                tol=TOL)
    assert fused_newton.launches == before
    assert torch.equal(v_k, nwt.newton_solve_fixed(pspec, pre, Krhs, params,
                                                   v0, ITERS, TOL))
    assert torch.equal(v_s, v_k)


def _scan_operands(cell, precision, T=12, seed=5):
    """The inputs of a T-step scan: the operands of `_ref_step` plus a
    source term K @ src per step, from numpy-seeded Norton injections
    at the source nodes that ramp over the run."""
    spec, system, a = _ref_step(cell, precision, seed=seed)
    pspec, pre, _, params, v0 = _port_step(spec, a, precision)
    _, cdt = pspec.dtypes
    rng = np.random.default_rng(seed)
    src = np.zeros((T, B, spec.n))
    levels = rng.uniform(0, 1.1, (B, len(system.src_node)))
    for t in range(T):
        src[t][:, system.src_node] = G_BIG * levels * min(1.0, t / 4)
    Ksrc = torch.einsum("bij,tbj->tbi", pre["K"],
                        torch.as_tensor(src, dtype=cdt)).contiguous()
    return pspec, pre, Ksrc, params, v0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", list(ATOL))
def test_scan_on_cpu_equals_stepping_the_step_entry(precision, cell):
    """`fused_newton_scan` on CPU tensors is the step loop that
    `Transient` ran before the scan entry existed: the KCoh @ v hoist and
    one `ops.fused_newton_step` per step, bit for bit, with no launch."""
    pspec, pre, Ksrc, params, v0 = _scan_operands(cell, precision)
    _, cdt = pspec.dtypes
    before = (fused_newton.launches, fused_newton_scan.launches)
    got = ops.fused_newton_scan(pspec, pre, Ksrc, params, v0, iters=ITERS,
                                tol=TOL)
    v = v0
    want = []
    for step in range(Ksrc.shape[0]):
        Krhs = torch.einsum("bij,bj->bi", pre["KCoh"], v.to(cdt)) \
            + Ksrc[step]
        v = ops.fused_newton_step(pspec, pre, Krhs, params, v, iters=ITERS,
                                  tol=TOL)
        want.append(v)
    assert (fused_newton.launches, fused_newton_scan.launches) == before
    assert got.shape == (B, Ksrc.shape[0], pspec.n) and got.dtype == v0.dtype
    assert torch.equal(got, torch.stack(want, dim=1))
    assert float((got[:, -1] - v0).abs().max()) > 0.1


# port vs reference fused lattice trajectory (CPU, the reference's own
# early-exit XLA engine, as its tests run it). f64: both are float64
# solves of one system whose inverses come from two LAPACKs (cond ~1e6),
# so they agree to round-off growth over the run; mixed: the state is
# stored in float32 (spacing 6e-8 V near 1 V), so a last-bit difference
# in the f64 Newton update can round a node the other way in a step
LATTICE_ATOL = {"f64": 1e-9, "mixed": 1e-6}
LATTICE_CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos")


def _lattice_case(cell, B=3, seed=42):
    """One topology's run_lattice inputs at 16x64 with per-lane R/C and
    stop-time jitter (the char_batch assembly in miniature), as numpy."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        bank = ref_build_bank(RefBankConfig(16, 64, cell))
        ckt, meta = ref_timing.read_netlist(bank)
        res_st, cap_st, src_G = ckt.build_stamps()
        g = np.asarray([g for _, _, g in ckt.res])
        c = np.asarray([c for _, _, c in ckt.caps])
        G_b = src_G[None] + np.einsum(
            "br,rij->bij", g * (1 + 0.1 * rng.uniform(-1, 1, (B, len(g)))),
            res_st)
        C_b = np.einsum(
            "bc,cij->bij", c * (1 + 0.1 * rng.uniform(-1, 1, (B, len(c)))),
            cap_st)
        t_an, _ = ref_timing.cell_read_time(bank)
        t_end1 = max(ref_timing.T_END_OVER_ANALYTIC * t_an,
                     ref_timing.T_END_MIN_S)
        t_end = t_end1 * (1 + 0.1 * rng.uniform(-1, 1, B))
        waves, v_pre = ref_timing.read_stimulus(
            bank.cell, bank.cfg.tech, meta["v_sn"],
            ref_timing.T0_FRACTION * t_end1)
    k = max(len(t) for t, _ in waves)
    wt = np.zeros((B, len(waves), k))
    wv = np.zeros((B, len(waves), k))
    for w, (t, v) in enumerate(waves):
        wt[:, w] = t + [t[-1]] * (k - len(t))
        wv[:, w] = v + [v[-1]] * (k - len(v))
    return ckt, dict(wt=wt, wv=wv, t_end=t_end, G_b=G_b, C_b=C_b,
                     v_pre=float(v_pre))


@pytest.mark.parametrize("cell", LATTICE_CELLS)
@pytest.mark.parametrize("precision", list(LATTICE_ATOL))
def test_run_lattice_matches_reference_fused(precision, cell):
    """`Transient(solver="pallas").run_lattice`, whose step loop is now
    the scan entry, against the reference's fused run_lattice over the
    whole trajectory, at 16x64 with 60 steps (the precharge releases at
    step 3; the read bitline then moves by over 0.5 V)."""
    n_steps = 60
    ckt, inp = _lattice_case(cell)
    over = {"G": inp["G_b"], "C": inp["C_b"]}
    with jax.enable_x64(True):
        system = ckt.build()
        v0 = jnp.full((system.n,), inp["v_pre"])
        want = ref_tr.Transient(system, solver="pallas",
                                precision=precision).run_lattice(
            inp["wt"], inp["wv"], inp["t_end"], n_steps,
            over_batches=over, v0=v0)
        want = {k: np.asarray(v) for k, v in want.items()}
    from repro_torch.core import timing
    from repro_torch.core.bank import BankConfig, build_bank
    pckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, cell)))
    tr = pt_tr.Transient(pckt.build(device="cpu"), solver="pallas",
                         precision=precision)
    before = fused_newton_scan.launches
    got = tr.run_lattice(inp["wt"], inp["wv"], inp["t_end"], n_steps,
                         over_batches=over,
                         v0=torch.full((system.n,), inp["v_pre"],
                                       dtype=torch.float64))
    assert fused_newton_scan.launches == before
    assert got["all"].dtype == {"f64": torch.float64,
                                "mixed": torch.float32}[precision]
    assert got["all"].shape == want["all"].shape
    err = float(np.abs(got["all"].double().numpy()
                       - want["all"].astype(np.float64)).max())
    assert err <= LATTICE_ATOL[precision], err
    swing = float(np.abs(want["rbl_near"][:, -1]
                         - want["rbl_near"][:, 0]).max())
    assert swing > 0.5
    np.testing.assert_allclose(got["t"].numpy(), want["t"], rtol=1e-15)


def test_terminal_map_marks_ground():
    spec, _, _ = _ref_step("gc2t_np", "f64")
    pspec = interop.fused_inputs_from_numpy(
        _spec_fields(spec), {}, np.zeros((1, spec.n)),
        np.zeros((1, 8, spec.n_dev)), np.zeros((1, spec.n)), device="cpu")[0]
    term = pspec.terminals
    assert term.shape == (3, spec.n_dev) and term.dtype == np.int32
    assert (term == -1).sum() == 1          # the predischarge source at 0 V
    for row, safe in zip(term, (spec.g_safe, spec.a_safe, spec.b_safe)):
        np.testing.assert_array_equal(np.where(row < 0, spec.n, row), safe)


@pytest.mark.parametrize("seed", range(3))
def test_interp_matches_jnp_interp(seed):
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.uniform(0, 1, (4, 5)), axis=1)
    xp[:, 3:] = xp[:, 2:3]              # edge-repeated knots
    xp[0, 1] = xp[0, 0]                 # a repeated knot inside
    fp = rng.uniform(-1, 1, (4, 5))
    x = rng.uniform(-0.2, 1.2, (4, 50))
    x[:, :5] = xp                       # exactly on the knots
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jnp.interp(jnp.asarray(x[i]),
                                               jnp.asarray(xp[i]),
                                               jnp.asarray(fp[i])))
                         for i in range(4)])
    got = pt_tr.interp(torch.as_tensor(x), torch.as_tensor(xp),
                       torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("rising", [True, False])
def test_crossing_time_matches_reference(rising):
    rng = np.random.default_rng(3)
    T = 40
    t = np.arange(1, T + 1) * 1e-12
    v = np.cumsum(rng.uniform(0, 0.01, (6, T)), axis=1)
    if not rising:
        v = 1.0 - v
    v[1] = v[1, 0]                       # flat trace: dv == 0
    v[2, 0] = 0.5 if rising else 0.5     # crossing at step 0
    v[3] = 0.0 if rising else 1.0        # never crosses
    target = 0.1 if rising else 0.9
    with jax.enable_x64(True):
        tw, vw = ref_tr.crossing_time(jnp.asarray(t), jnp.asarray(v), target,
                                      rising)
        tw, vw = np.asarray(tw), np.asarray(vw)
    tg, vg = pt_tr.crossing_time(torch.as_tensor(t), torch.as_tensor(v),
                                 target, rising)
    np.testing.assert_array_equal(vg.numpy(), vw)
    np.testing.assert_allclose(tg.numpy(), tw, rtol=1e-15)
