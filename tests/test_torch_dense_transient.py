"""Port parity: the dense MNA methods, the dense Newton stepper and the
scalar/batched transient runs of `repro_torch` against the JAX reference,
on the identical circuit (carried across by `interop.mna_system_from_numpy`).
The reference runs under x64 (float64), as its `simulate_read` does; its
Pallas Gauss-Jordan solve runs in interpret mode."""
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
from repro.core.spice import transient as ref_tr  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.core.spice import transient as tr  # noqa: E402
from repro_torch.kernels.batched_solve import kernel as gj  # noqa: E402

CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos")
RTOL_MNA = 1e-12        # float64 residual, currents and stamps
ATOL_TRACE = 1e-9       # volts, dense float64 traces
# solver="pallas": both packages solve each Newton system in float32
# (Gauss-Jordan) against a float64 residual. The reference's own
# pallas-vs-jnp gap of simulate_read's t_cell, measured on the CPU over
# gc2t_nn/np/osos at 16x64 and 64x16, is at most 1.7e-8 relative
# (gc2t_osos 64x16); Newton stops at max|dv| < 1e-6 V, so a trace may
# move by up to that tolerance where the float32 round-off differs
ATOL_TRACE_PALLAS = 1e-6


def _systems(cell, ws=16, nw=64):
    """(reference system, port system, reference meta) of the read
    column; build under x64 so the reference's arrays are float64."""
    with jax.enable_x64(True):
        ckt, meta = ref_timing.read_netlist(
            ref_build_bank(RefBankConfig(ws, nw, cell)))
        ref = ckt.build()
    port = interop.mna_system_from_numpy(
        np.asarray(ref.G), np.asarray(ref.C),
        {k: np.asarray(v) for k, v in ref.dev.items()}, ref.didx,
        ref.src_node, ref.src_wave, ref.n, ref.probes, ref.names,
        device="cpu")
    return ref, port, meta


def _waves(meta, t0=1e-10):
    return [([0.0, t0, t0 * 1.2], [1.1, 1.1, 0.0]),
            ([0.0, t0 * 0.8, t0], [0.0, 0.0, 1.1]),
            ([0.0, 1.0], [meta["v_sn"], meta["v_sn"]]),
            ([0.0, 1.0], [1.1, 1.1])]


def _close(got, want, rtol=RTOL_MNA):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("cell", CELLS)
def test_mna_dense_terms_match_reference(cell):
    ref, port, _ = _systems(cell)
    rng = np.random.default_rng(7)
    B = 4
    v = rng.uniform(0, 1.1, (B, ref.n))
    v_prev = rng.uniform(0, 1.1, (B, ref.n))
    wave = rng.uniform(0, 1.1, (B, 4))
    h = rng.uniform(1e-12, 4e-12, B)
    vt0 = rng.uniform(0.3, 0.6, (B, len(ref.didx["g"])))
    G2 = np.asarray(ref.G) * (1 + 0.1 * rng.uniform(size=(B, 1, 1)))
    t = torch.tensor
    got_i = port.device_currents(t(v))
    got_J = port.jacobian(t(v), t(h))
    got_r = port.residual(t(v), t(v_prev), t(h), t(wave))
    over = port.with_params(vt0=t(vt0), G=t(G2))
    got_over = over.residual(t(v), t(v_prev), t(h), t(wave))
    J_ns, r_ns = port.newton_system(t(v), t(v_prev), t(h), t(wave))
    assert torch.equal(J_ns, got_J) and torch.equal(r_ns, got_r)
    with jax.enable_x64(True):
        for b in range(B):
            vb = jnp.asarray(v[b])
            _close(got_i[b], ref.device_currents(vb))
            _close(port.device_jacobian(t(v))[b], ref.device_jacobian(vb))
            _close(got_J[b], ref.jacobian(vb, h[b]))
            _close(got_r[b], ref.residual(vb, jnp.asarray(v_prev[b]), h[b],
                                          jnp.asarray(wave[b])))
            _close(port.source_currents(t(wave))[b],
                   ref.source_currents(jnp.asarray(wave[b])))
            for k in ("g", "a", "b"):     # ground reads 0 V
                np.testing.assert_array_equal(
                    port._v_of(t(v), ref.didx[k])[b],
                    np.asarray(ref._v_of(vb, ref.didx[k])))
            ref_over = ref.with_params(vt0=vt0[b], G=G2[b])
            _close(got_over[b], ref_over.residual(
                vb, jnp.asarray(v_prev[b]), h[b], jnp.asarray(wave[b])))


@pytest.mark.parametrize("cell", CELLS)
def test_analytic_jacobian_matches_jacfwd(cell):
    _, port, _ = _systems(cell)
    rng = np.random.default_rng(8)
    v = torch.tensor(rng.uniform(0, 1.1, (3, port.n)))
    v_prev = torch.tensor(rng.uniform(0, 1.1, (3, port.n)))
    wave = torch.tensor(rng.uniform(0, 1.1, (3, 4)))
    h = torch.tensor([1e-12, 2e-12, 3e-12], dtype=torch.float64)
    auto = torch.func.jacfwd(
        lambda u: port.residual(v + u, v_prev, h, wave))(
        torch.zeros(port.n, dtype=torch.float64))
    _close(port.jacobian(v, h), auto.detach(), rtol=1e-10)


def test_wave_value_matches_jnp_interp():
    times = np.array([[0.0, 1e-10, 1.2e-10], [0.0, 5e-11, 5e-11]])
    values = np.array([[1.1, 1.1, 0.0], [0.0, 1.1, 1.1]])
    ts = np.array([-1e-11, 0.0, 3e-11, 5e-11, 1.1e-10, 1.2e-10, 2e-10])
    with jax.enable_x64(True):
        want = np.array([[float(ref_tr.wave_value(jnp.asarray(times[w]),
                                                  jnp.asarray(values[w]), x))
                          for w in range(2)] for x in ts])
    got = tr.wave_value(torch.tensor(times), torch.tensor(values),
                        torch.tensor(ts)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)


def _trajectory_state(ref, meta, n_steps=36, h=3e-12):
    """A state on the read transient just after the wordline fires (the
    reference's own run), so every Newton lane starts near its root."""
    with jax.enable_x64(True):
        out = ref_tr.Transient(ref).run(_waves(meta), n_steps * h,
                                        n_steps=n_steps,
                                        v0=jnp.full((ref.n,), 1.1))
    return np.asarray(out["all"][-1]), (n_steps + 1) * h, h


@pytest.mark.parametrize("newton", ["full", "jacfwd", "modified"])
@pytest.mark.parametrize("solver", ["jnp", "pallas"])
def test_stepper_matches_reference(newton, solver):
    ref, port, meta = _systems("gc2t_nn")
    rng = np.random.default_rng(9)
    B = 3
    v_start, t_now, h = _trajectory_state(ref, meta)
    v = v_start + rng.uniform(-0.01, 0.01, (B, ref.n))
    vt0 = np.asarray(ref.dev["vt0"]) + rng.uniform(-0.02, 0.02,
                                                   (B, len(ref.didx["g"])))
    waves = _waves(meta)
    with jax.enable_x64(True):
        wt, wv = ref_tr.Transient(ref).pack_waves(waves)
        step = ref_tr.make_stepper(ref, solver, newton=newton)
        want = np.stack([np.asarray(step(
            jnp.asarray(v[b]), t_now, h, wt, wv, {"vt0": jnp.asarray(vt0[b])}))
            for b in range(B)])
    pwt, pwv = tr.Transient(port).pack_waves(waves)
    got = tr.make_stepper(port, solver, newton=newton)(
        torch.tensor(v), t_now, h, pwt, pwv, {"vt0": torch.tensor(vt0)})
    atol = ATOL_TRACE if solver == "jnp" else ATOL_TRACE_PALLAS
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_full_newton_freezes_each_lane_at_its_early_exit():
    """The fixed-length masked loop gives every lane its own early-exit
    result and iteration count, whatever the other lanes do."""
    ref, port, meta = _systems("gc2t_nn")
    v_start, t_now, h = _trajectory_state(ref, meta)
    waves = _waves(meta)
    with jax.enable_x64(True):
        wt, wv = ref_tr.Transient(ref).pack_waves(waves)
        step = ref_tr.make_stepper(ref, "jnp", with_aux=True)
        v_sol = np.asarray(step(jnp.asarray(v_start), t_now, h, wt, wv,
                                {})[0])
        # lanes of 2, 3 and 4 Newton iterations in the reference
        v = np.stack([v_sol, v_start, v_start, v_start + 0.5])
        ts = np.array([t_now, t_now, 5e-11, 2e-10])
        want = [step(jnp.asarray(v[b]), ts[b], h, wt, wv, {})
                for b in range(len(v))]
    pwt, pwv = tr.Transient(port).pack_waves(waves)
    for solver in ("jnp", "pallas"):
        step = tr.make_stepper(port, solver, with_aux=True)
        got, n_it = step(torch.tensor(v), torch.tensor(ts), h, pwt, pwv, {})
        assert n_it.tolist() == [int(n) for _, n in want]
        atol = ATOL_TRACE if solver == "jnp" else ATOL_TRACE_PALLAS
        np.testing.assert_allclose(got.numpy(), np.stack(
            [np.asarray(x) for x, _ in want]), rtol=0, atol=atol)
    assert len(set(n_it.tolist())) == 3
    for b in range(len(v)):      # pallas: each lane alone, bit for bit
        one, n_one = step(torch.tensor(v[b:b + 1]), torch.tensor(ts[b:b + 1]),
                          h, pwt, pwv, {})
        assert torch.equal(one[0], got[b]) and int(n_one[0]) == n_it[b]
    with pytest.raises(ValueError):
        tr.make_stepper(port, "jnp", newton="jacfwd", with_aux=True)


@pytest.mark.parametrize("solver", ["jnp", "pallas"])
@pytest.mark.parametrize("cell", CELLS)
def test_run_matches_reference(cell, solver):
    ref, port, meta = _systems(cell)
    waves = _waves(meta)
    v0 = np.full(ref.n, 0.0 if cell == "gc2t_np" else 1.1)
    with jax.enable_x64(True):
        want = ref_tr.Transient(ref, solver=solver).run(
            waves, 3e-10, n_steps=100, v0=jnp.asarray(v0))
    launches = gj.batched_solve.launches
    got = tr.Transient(port, solver=solver).run(waves, 3e-10, n_steps=100,
                                                v0=torch.tensor(v0))
    assert gj.batched_solve.launches == launches   # CPU: plain version
    atol = ATOL_TRACE if solver == "jnp" else ATOL_TRACE_PALLAS
    assert got["all"].shape == (100, ref.n)
    np.testing.assert_allclose(got["all"].numpy(), np.asarray(want["all"]),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(got["t"].numpy(), np.asarray(want["t"]))
    for label in ref.probes:
        np.testing.assert_array_equal(got[label].numpy(),
                                      got["all"][:, ref.probes[label] - 1])


@pytest.mark.parametrize("solver", ["jnp", "pallas"])
def test_run_batch_matches_reference_and_single_runs(solver):
    """The vt0 sweep of the batched-SPICE benchmark (32x32 gc2t_nn,
    benchmarks/figures.py), cut to 8 lanes and 60 steps."""
    ref, port, meta = _systems("gc2t_nn", 32, 32)
    waves = _waves(meta)
    B, n_dev = 8, len(ref.didx["g"])
    vts = np.tile(np.linspace(0.30, 0.60, B)[:, None], (1, n_dev))
    with jax.enable_x64(True):
        want = ref_tr.Transient(ref, solver=solver).run_batch(
            waves, 1e-9, 60, {"vt0": jnp.asarray(vts)})
    ptr = tr.Transient(port, solver=solver)
    got = ptr.run_batch(waves, 1e-9, 60, {"vt0": torch.tensor(vts)})
    atol = ATOL_TRACE if solver == "jnp" else ATOL_TRACE_PALLAS
    np.testing.assert_allclose(got["all"].numpy(), np.asarray(want["all"]),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(got["t"].numpy(), np.asarray(want["t"]))
    one = ptr.run(waves, 1e-9, 60, dev_over={"vt0": torch.tensor(vts[2])})
    np.testing.assert_allclose(one["all"].numpy(), got["all"][2].numpy(),
                               rtol=0, atol=1e-13)


def test_run_lattice_dense_matches_reference():
    ref, port, meta = _systems("gc2t_np")
    rng = np.random.default_rng(11)
    B = 3
    t_end = np.array([2e-10, 3e-10, 4e-10])
    wt = np.zeros((B, 4, 3))
    wv = np.zeros((B, 4, 3))
    for b in range(B):
        for w, (x, y) in enumerate(_waves(meta, t0=0.05 * t_end[b])):
            wt[b, w] = x + [x[-1]] * (3 - len(x))
            wv[b, w] = y + [y[-1]] * (3 - len(y))
    C = np.asarray(ref.C) * (1 + 0.2 * rng.uniform(size=(B, 1, 1)))
    with jax.enable_x64(True):
        want = ref_tr.Transient(ref).run_lattice(
            jnp.asarray(wt), jnp.asarray(wv), jnp.asarray(t_end), 80,
            over_batches={"C": jnp.asarray(C)})
    got = tr.Transient(port).run_lattice(wt, wv, t_end, 80,
                                         over_batches={"C": C})
    np.testing.assert_allclose(got["all"].numpy(), np.asarray(want["all"]),
                               rtol=0, atol=ATOL_TRACE)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               rtol=1e-15)


def test_characterize_jnp_matches_reference():
    lattice = dict(cells=("gc2t_nn",), word_sizes=(16, 32), num_words=(16,),
                   wwlls=(False,))
    want = ref_cb.characterize(ref_dse.lattice_configs(**lattice),
                               solver="jnp")
    got = char_batch.characterize(dse.lattice_configs(**lattice),
                                  solver="jnp", device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.t_cell_s, w.t_cell_s, rtol=1e-9)
        assert g.swing_ok == w.swing_ok


def test_transient_solver_names():
    _, port, _ = _systems("gc2t_nn")
    assert tr.Transient(port).solver == "jnp"
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tr.Transient(port, solver="sparse")
    with pytest.raises(ValueError):
        tr.Transient(port, solver="bogus")
    with pytest.raises(ValueError):
        tr.make_stepper(port, "jnp", newton="bogus")
    t = tr.Transient(port)
    waves = [([0.0, 1.0], [1.1, 1.1])]
    packed = t.pack_waves(waves)
    assert t.pack_waves([([0, 1], [1.1, 1.1])]) is packed
    assert packed[0].dtype == torch.float64
