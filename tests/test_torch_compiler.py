"""Port parity: the bank compile flow of `repro_torch` (analytic timing,
retention, power, netlist export and the transient read) against the JAX
reference, field by field through `Report.summary()`.

Precision follows the reference as its compile flow runs:
  * timing and power are float64 host algebra; the reference evaluates
    its device currents in float64 only under x64, so it is called under
    x64 here and held to 1e-12 relative;
  * retention runs in float32 in the reference's compile flow (outside
    x64, float32 device constants), and the port keeps float32; the two
    differ by float32 round-off of exp/log1p, the linspace and the order
    of the 4000-term trapezoid sum, measured at most 2.8e-7 relative on
    t_ret and 3.0e-7 on i_leak0 (gc3t), so the limit is 2e-6. The refresh
    power is proportional to 1/t_ret and takes the same limit;
  * the transient read runs in float64 in both; with solver="jnp" t_cell
    is held to 1e-9 relative. With solver="pallas" each Newton solve is
    float32 Gauss-Jordan against a float64 residual: the reference's own
    pallas-vs-jnp gap on this path, measured on the CPU for gc2t_nn/np/
    osos at 16x64 and 64x16, is at most 1.7e-8 relative, and the port's
    pallas run is held to 5e-8 of the reference's pallas run.
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import bank as ref_bank  # noqa: E402
from repro.core import cells as ref_cells  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import power as ref_power  # noqa: E402
from repro.core import retention as ref_retention  # noqa: E402
from repro.core import techfile as ref_techfile  # noqa: E402
from repro.core import timing as ref_timing  # noqa: E402
from repro_torch.core import bank, cells, compiler, power, retention  # noqa: E402,E501
from repro_torch.core import techfile, timing  # noqa: E402

RTOL_ANALYTIC = 1e-12
RTOL_RETENTION = 2e-6
RTOL_SIM_JNP = 1e-9
RTOL_SIM_PALLAS = 5e-8
CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t", "gc2t_hyb", "sram6t")
CONFIGS = [dict(word_size=ws, num_words=nw, cell=c, wwlls=ll)
           for c in CELLS for ws, nw in ((16, 64), (64, 16), (32, 128))
           for ll in (False, True)][::2]
RET_FIELDS = ("retention", "power.refresh_w")


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def _assert_summary(got: dict, want: dict, rtol_of):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k, wv in w.items():
        gv = g[k]
        if isinstance(wv, float) and not isinstance(wv, bool):
            np.testing.assert_allclose(gv, wv, rtol=rtol_of(k), atol=0,
                                       err_msg=k)
        else:
            assert gv == wv, k


def _rtol(key):
    if key.startswith(RET_FIELDS):
        return RTOL_RETENTION
    return RTOL_ANALYTIC


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_timing_and_power_match_reference(kw):
    rb = ref_bank.build_bank(ref_bank.BankConfig(**kw))
    b = bank.build_bank(bank.BankConfig(**kw))
    with jax.enable_x64(True):
        want = ref_timing.analyze(rb)
        want_p = ref_power.analyze(rb, want.f_max_hz, t_ret_s=1e-6)
        want_p9 = ref_power.analyze(rb, 1e9, vdd_scale=0.9)
        want_w = ref_timing.write_time(rb)
    got = timing.analyze(b)
    assert b.delay_stages == rb.delay_stages == got.delay_stages
    _assert_summary(got.as_dict(), want.as_dict(), lambda k: RTOL_ANALYTIC)
    _assert_summary(power.analyze(b, got.f_max_hz, t_ret_s=1e-6).as_dict(),
                    want_p.as_dict(), lambda k: RTOL_ANALYTIC)
    _assert_summary(power.analyze(b, 1e9, vdd_scale=0.9).as_dict(),
                    want_p9.as_dict(), lambda k: RTOL_ANALYTIC)
    np.testing.assert_allclose(timing.write_time(b), want_w,
                               rtol=RTOL_ANALYTIC)


def test_delay_chain_and_vdd_views_match_reference():
    tech, ref_tech = techfile.SYN40, ref_techfile.SYN40
    for analog in (1e-11, 3e-10, 2e-9, 5e-8):
        assert timing.chain_unit(analog, tech.stage_delay_s) == \
            ref_timing.chain_unit(analog, ref_tech.stage_delay_s)
        assert timing.size_delay_chain(analog, tech) == \
            ref_timing.size_delay_chain(analog, ref_tech)
    b = bank.build_bank(bank.BankConfig(16, 64))
    assert timing.bank_at_vdd(b, 1.0) is b
    hot = timing.bank_at_vdd(b, 1.2)
    rhot = ref_timing.bank_at_vdd(
        ref_bank.build_bank(ref_bank.BankConfig(16, 64)), 1.2)
    assert dataclasses.asdict(hot.cfg.tech) == dataclasses.asdict(
        rhot.cfg.tech)
    with jax.enable_x64(True):
        want = ref_timing.analyze(
            ref_bank.build_bank(ref_bank.BankConfig(16, 64)), vdd_scale=0.9)
    got = timing.analyze(bank.build_bank(bank.BankConfig(16, 64)),
                         vdd_scale=0.9)
    _assert_summary(got.as_dict(), want.as_dict(), lambda k: RTOL_ANALYTIC)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        timing.analyze(b, parasitics="extracted")
    with pytest.raises(ValueError):
        timing.analyze(b, parasitics="bogus")


@pytest.mark.parametrize("name", ["gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t",
                                  "gc2t_hyb"])
def test_retention_matches_reference(name):
    cell, ref_cell = cells.CELLS[name], ref_cells.CELLS[name]
    tech, ref_tech = techfile.SYN40, ref_techfile.SYN40
    for kw in ({}, {"wwlls": True}, {"vdd_scale": 0.9}):
        want = ref_retention.analyze(ref_cell, ref_tech, **kw)
        got = retention.analyze(cell, tech, **kw, device="cpu")
        assert got.v_sn0 == want.v_sn0 and got.v_margin == want.v_margin
        np.testing.assert_allclose(got.t_ret_s, want.t_ret_s,
                                   rtol=RTOL_RETENTION)
        np.testing.assert_allclose(got.i_leak0_a, want.i_leak0_a,
                                   rtol=RTOL_RETENTION)
    vts = np.linspace(0.3, 0.6, 7)
    np.testing.assert_allclose(
        retention.retention_vs_vt(cell, tech, vts, device="cpu"),
        ref_retention.retention_vs_vt(ref_cell, ref_tech, vts),
        rtol=RTOL_RETENTION)
    t, v = retention.sn_decay_trace(cell, tech, 1e-3, device="cpu")
    rt, rv = ref_retention.sn_decay_trace(ref_cell, ref_tech, 1e-3)
    assert t.dtype == rt.dtype == v.dtype == np.float32
    # log-spaced times through float32 pow: a few ulp of t
    np.testing.assert_allclose(t, rt, rtol=1e-5)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-5)
    fn, ref_fn = retention.leak_fn(cell, tech, "cpu"), ref_retention.leak_fn(
        ref_cell, ref_tech)
    vs = np.linspace(0.0, 1.1, 23, dtype=np.float32)
    np.testing.assert_allclose(fn(vs).numpy(), np.asarray(ref_fn(vs)),
                               rtol=RTOL_RETENTION)


@pytest.mark.parametrize("cell", CELLS)
def test_compile_bank_matches_reference(cell, tmp_path):
    kw = dict(word_size=16, num_words=64, cell=cell)
    want_plain = ref_compiler.compile_bank(ref_bank.BankConfig(**kw))
    with jax.enable_x64(True):
        want = ref_compiler.compile_bank(ref_bank.BankConfig(**kw))
    got = compiler.compile_bank(bank.BankConfig(**kw), device="cpu")
    g = got.summary()
    w = want.summary()
    if "retention" in w:    # as the reference's compile flow runs it
        w["retention"] = want_plain.summary()["retention"]
        w["power"]["refresh_w"] = want_plain.summary()["power"]["refresh_w"]
    _assert_summary(g, w, _rtol)
    assert got.netlists == want.netlists
    assert got.as_dict() == g
    out = got.write(str(tmp_path / "rep"))
    report = json.loads((tmp_path / "rep" / "report.json").read_text())
    assert report == json.loads(json.dumps(g))
    assert json.loads((tmp_path / "rep" / "floorplan.json").read_text()) == \
        json.loads(json.dumps(want.bank.plan.manifest()))
    for name, text in want.netlists.items():
        assert (tmp_path / "rep" / f"{name}.sp").read_text() == text
    assert out == str(tmp_path / "rep")


def test_compile_bank_runs_retention_on_its_device(monkeypatch):
    """compile_bank hands its device to retention, as to the transient
    read, so a compile on the card keeps no stage on the host."""
    seen = []
    real = compiler.ret_mod.analyze

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(compiler.ret_mod, "analyze", spy)
    rep = compiler.compile_bank(bank.BankConfig(16, 16, cell="gc2t_nn"),
                                device="cpu")
    assert seen == ["cpu"] and rep.retention.t_ret_s > 0


@pytest.mark.parametrize("solver", ["jnp", "pallas"])
@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "gc2t_osos"])
def test_compile_bank_simulated_read_matches_reference(cell, solver):
    kw = dict(word_size=16, num_words=64, cell=cell)
    with jax.enable_x64(True):   # float64 analytic t_cell, as the port's
        want = ref_compiler.compile_bank(ref_bank.BankConfig(**kw),
                                         simulate=True, solver=solver)
    got = compiler.compile_bank(bank.BankConfig(**kw), simulate=True,
                                solver=solver, device="cpu")
    rtol = RTOL_SIM_JNP if solver == "jnp" else RTOL_SIM_PALLAS
    assert np.isfinite(got.t_cell_sim_s) and got.t_cell_sim_s > 0
    np.testing.assert_allclose(got.t_cell_sim_s, want.t_cell_sim_s,
                               rtol=rtol)
    np.testing.assert_allclose(got.summary()["analytic_vs_sim_dev"],
                               want.summary()["analytic_vs_sim_dev"],
                               rtol=10 * rtol)


@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "gc2t_osos"])
def test_reference_pallas_gap_bounds_the_limit(cell):
    """Where RTOL_SIM_PALLAS comes from: the reference's own gap between
    its float32-solve ("pallas") and float64-solve ("jnp") reads, at the
    64x16 shape where it is largest (1.7e-8 for gc2t_osos; at most
    7e-10 at 16x64), stays well inside the port's limit, and the port's
    pallas read keeps the same gap to its own jnp read."""
    rb = ref_bank.build_bank(ref_bank.BankConfig(64, 16, cell=cell))
    t_j, _ = ref_timing.simulate_read(rb, solver="jnp")
    t_p, _ = ref_timing.simulate_read(rb, solver="pallas")
    gap = abs(t_p - t_j) / t_j
    assert gap < 2e-8 < RTOL_SIM_PALLAS
    b = bank.build_bank(bank.BankConfig(64, 16, cell=cell))
    p_p, _ = timing.simulate_read(b, solver="pallas", device="cpu")
    np.testing.assert_allclose(p_p, t_p, rtol=RTOL_SIM_PALLAS)


def test_simulate_read_hits_the_lattice_anchors():
    """simulate_read builds the netlist and stimulus `characterize` runs,
    so at 16x64 it reproduces the lattice anchors (ROADMAP Queue 1
    item 7) to their two decimals."""
    anchors = {"gc2t_nn": 47.82, "gc2t_np": 24.10, "gc2t_osos": 1155.27}
    for cell, ps in anchors.items():
        t, res = timing.simulate_read(
            bank.build_bank(bank.BankConfig(16, 64, cell=cell)),
            device="cpu")
        assert abs(t * 1e12 - ps) < 0.01
        assert res["all"].shape == (300, res["all"].shape[1])


def test_gcram_compiler_is_deferred():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        compiler.GCRAMCompiler(bank.BankConfig())
    ckt, _ = timing.read_netlist(bank.build_bank(bank.BankConfig(16, 16)))
    ref_ckt, _ = ref_timing.read_netlist(
        ref_bank.build_bank(ref_bank.BankConfig(16, 16)))
    assert compiler.circuit_to_spice(ckt, "t") == \
        ref_compiler.circuit_to_spice(ref_ckt, "t")
