"""Port parity: the analytic DSE tier of `repro_torch` (`core/dse.py`,
`core/dse_batch.py`, `core/multibank.py`) against the JAX reference.

Precision, as `tests/test_torch_compiler.py` holds the compile flow:
  * timing and power are float64 algebra in the port; the reference
    evaluates its device currents in float64 only under x64, so it is
    called under x64 and every retention-independent field is held to
    1e-12 relative;
  * retention runs in float32 in the port and in the reference's own
    flows (outside x64). Under x64 the reference's retention moves by up
    to 1.8e-6 from its plain run (gc2t_nn at vdd_scale 0.85, where the
    decay takes 90 ns), so the retention-dependent fields (retention_s,
    refresh_w, standby_w) are held to the reference run outside x64 at
    2e-6, the compile flow's limit (measured at most 3.2e-7);
  * the batched evaluator equals the port's scalar `dse.evaluate` bit
    for bit on the CPU, the reference's own contract
    (`src/repro/core/dse_batch.py`, module docstring).
"""
import dataclasses
import warnings

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import dse as ref_dse  # noqa: E402
from repro.core import dse_batch as ref_dse_batch  # noqa: E402
from repro.core import multibank as ref_mb  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro_torch.core import dse, dse_batch, multibank  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402

RTOL_ANALYTIC = 1e-12
RTOL_RETENTION = 2e-6
CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t", "gc2t_hyb", "sram6t")
VDD_SCALES = (0.7, 0.85, 1.0, 1.15)
SIZES = ((16, 64, False), (64, 16, True), (32, 128, False))
ANALYTIC_FIELDS = ("area_um2", "f_max_hz", "read_bw_bps", "write_bw_bps",
                   "eff_bw_bps", "leakage_w", "t_read_s", "t_write_s")
RET_FIELDS = ("retention_s", "refresh_w")
POINT_FIELDS = ANALYTIC_FIELDS + RET_FIELDS + ("swing_ok", "vdd_scale")
# the six demands of benchmarks/bench_codesign.py: native-retention passes,
# refresh-only passes, frequency-infeasible, capacity-driven sizing
DEMANDS = [("act-l1", "L1", 3.0e8, 2.0e-6, 0),
           ("act-l1-fast", "L1", 1.2e9, 5.0e-7, 0),
           ("kv-l2", "L2", 8.0e8, 1.0e-3, 1 << 20),
           ("stream-l2", "L2", 2.5e9, 1.0e-5, 0),
           ("weights-l2", "L2", 2.0e8, 3600.0, 1 << 22),
           ("hopeless", "L2", 5.0e10, 1.0, 0)]
STEPS = [2.0e-3, 2.0e-3, 5.0e-3, 5.0e-3, 5.0e-3, 5.0e-3]
# bench_codesign's smoke lattice
SMOKE = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16, 32),
             num_words=(16, 32, 64))


def ref_lattice(cfgs, scales, *, x64: bool):
    """The reference's (vdd x lattice) table, under x64 or outside it.
    Its group constants are memoized process-wide with no regard to the
    x64 state, so the memo is emptied first."""
    ref_dse_batch._CONSTS_CACHE.clear()
    with jax.enable_x64(x64):
        return ref_dse_batch.evaluate_vdd_lattice(cfgs, scales)


def ref_mixed_lattice(cfgs, scales):
    """The reference's table as the port is held to it: x64, with the
    retention fields of its run outside x64."""
    plain = ref_lattice(cfgs, scales, x64=False)
    return dataclasses.replace(ref_lattice(cfgs, scales, x64=True),
                               retention_s=plain.retention_s,
                               refresh_w=plain.refresh_w)


def demands(mod):
    return [mod.Demand(*d) for d in DEMANDS]


def assert_point(got, want, plain):
    """`got` (port DesignPoint) against the reference under x64 (`want`)
    and, for the retention-dependent fields, outside x64 (`plain`)."""
    for f in ANALYTIC_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL_ANALYTIC, atol=0, err_msg=f)
    for f in RET_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(plain, f),
                                   rtol=RTOL_RETENTION, atol=0, err_msg=f)
    np.testing.assert_allclose(got.standby_w,
                               want.leakage_w + plain.refresh_w,
                               rtol=RTOL_RETENTION, atol=0)
    assert got.swing_ok == want.swing_ok
    assert got.vdd_scale == want.vdd_scale


@pytest.mark.parametrize("cell", CELLS)
def test_evaluate_matches_reference(cell):
    for ws, nw, ls in SIZES:
        cfg = BankConfig(ws, nw, cell=cell, wwlls=ls)
        ref_cfg = RefBankConfig(ws, nw, cell=cell, wwlls=ls)
        for v in VDD_SCALES:
            with jax.enable_x64(True):
                want = ref_dse.evaluate(ref_cfg, v)
            plain = ref_dse.evaluate(ref_cfg, v)
            got = dse.evaluate(cfg, v, device="cpu")
            assert_point(got, want, plain)
            assert got.as_dict().keys() == want.as_dict().keys()


def _assert_lattice(got, want, plain):
    assert got.shape == want.shape and got.vdd_scales == want.vdd_scales
    for f in ("f_max_hz", "t_read_s", "t_write_s", "leakage_w", "e_read_j",
              "e_write_j", "area_um2", "bits", "num_words"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL_ANALYTIC, atol=0, err_msg=f)
    for f in ("retention_s", "refresh_w"):
        np.testing.assert_allclose(getattr(got, f), getattr(plain, f),
                                   rtol=RTOL_RETENTION, atol=0, err_msg=f)
    np.testing.assert_array_equal(got.swing_ok, want.swing_ok)
    np.testing.assert_array_equal(got.is_gc, want.is_gc)


@pytest.mark.parametrize("lattice, scales", [
    (SMOKE, VDD_SCALES), ({}, (1.0,))], ids=["smoke-4vdd", "default-1vdd"])
def test_vdd_lattice_matches_reference(lattice, scales):
    cfgs = dse.lattice_configs(**lattice)
    ref_cfgs = ref_dse.lattice_configs(**lattice)
    want = ref_lattice(ref_cfgs, scales, x64=True)
    plain = ref_lattice(ref_cfgs, scales, x64=False)
    got = dse_batch.evaluate_vdd_lattice(cfgs, scales, device="cpu")
    _assert_lattice(got, want, plain)
    assert got.cfgs == cfgs
    # materialized points carry the same fields as the reference's
    for i in (0, len(cfgs) - 1):
        assert_point(got.point(len(scales) - 1, i),
                     want.point(len(scales) - 1, i),
                     plain.point(len(scales) - 1, i))


@pytest.mark.parametrize("vdd", VDD_SCALES)
def test_evaluate_batch_is_scalar_bit_for_bit(vdd):
    cfgs = dse.lattice_configs(cells=CELLS, word_sizes=(16, 64, 128),
                               num_words=(16, 128))
    batch = dse_batch.evaluate_batch(cfgs, vdd, device="cpu")
    for cfg, got in zip(cfgs, batch):
        want = dse.evaluate(cfg, vdd, device="cpu")
        assert got.cfg == cfg
        for f in POINT_FIELDS:
            assert getattr(got, f) == getattr(want, f), (cfg, f)


def test_constants_cache_is_keyed_by_device():
    cfgs = dse.lattice_configs(cells=("gc2t_np",), word_sizes=(16,),
                               num_words=(16,), wwlls=(False,))
    dse_batch.evaluate_batch(cfgs, 0.85, device="cpu")
    keys = [k for k in dse_batch._CONSTS_CACHE
            if k[0] == "gc2t_np" and k[-2] == 0.85]
    assert keys and all(k[-1] == "cpu" for k in keys)


@pytest.mark.parametrize("allow_refresh", [True, False])
def test_grids_equal_scalar_rules(allow_refresh):
    cfgs = dse.lattice_configs(cells=CELLS, word_sizes=(16, 128),
                               num_words=(16, 128))
    lat = dse_batch.evaluate_vdd_lattice(cfgs, VDD_SCALES, device="cpu")
    ds = demands(dse)
    feas = dse_batch.feasible_grid(
        lat.f_max_hz, lat.retention_s, lat.swing_ok, lat.num_words,
        [d.read_freq_hz for d in ds], [d.lifetime_s for d in ds],
        allow_refresh=allow_refresh, device="cpu")
    banks = dse_batch.banks_needed_grid(
        lat.f_max_hz, lat.retention_s, lat.swing_ok, lat.bits,
        lat.num_words, [d.read_freq_hz for d in ds],
        [d.lifetime_s for d in ds], [d.capacity_bits for d in ds],
        allow_refresh=allow_refresh, max_banks=64, device="cpu")
    assert feas.shape == banks.shape == (len(VDD_SCALES), len(cfgs), 6)
    assert feas.any() and not feas.all() and (banks == 65).any()
    for vi in range(len(VDD_SCALES)):
        points = [lat.point(vi, pi) for pi in range(len(cfgs))]
        for pi, dp in enumerate(points):
            for j, d in enumerate(ds):
                assert feas[vi, pi, j] == dse.feasible(
                    dp, d, allow_refresh=allow_refresh)
                assert banks[vi, pi, j] == multibank.banks_needed(
                    dp, d, capacity_bits=d.capacity_bits, max_banks=64,
                    allow_refresh=allow_refresh)
        assert dse_batch.shmoo_batch(points, ds, allow_refresh=allow_refresh,
                                     device="cpu") == \
            dse.shmoo(points, ds, allow_refresh=allow_refresh)


def test_codesign_metrics_matches_reference():
    """The cube on the same lattice arrays equals the reference's (pure
    function parity, 1e-12), and on each package's own lattice the
    verdicts agree and the energy (through standby, so retention) is
    within 2e-6 of the reference's cube on its x64 lattice with the
    retention fields of its plain one."""
    cfgs = dse.lattice_configs(**SMOKE)
    ref_cfgs = ref_dse.lattice_configs(**SMOKE)
    ref_lat = ref_lattice(ref_cfgs, VDD_SCALES, x64=True)
    want = ref_dse_batch.codesign_metrics(ref_lat, demands(ref_dse), STEPS)
    same = dse_batch.VddLattice(cfgs, ref_lat.vdd_scales, *(
        getattr(ref_lat, f.name) for f in
        dataclasses.fields(ref_lat)[2:]))
    got = dse_batch.codesign_metrics(same, demands(dse), STEPS, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL_ANALYTIC, atol=0)
    np.testing.assert_array_equal(got[3], want[3])
    want = ref_dse_batch.codesign_metrics(
        ref_mixed_lattice(ref_cfgs, VDD_SCALES), demands(ref_dse), STEPS)
    own = dse_batch.codesign_metrics(
        dse_batch.evaluate_vdd_lattice(cfgs, VDD_SCALES, device="cpu"),
        demands(dse), STEPS, device="cpu")
    for k in (0, 1, 3):
        np.testing.assert_array_equal(own[k], want[k])
    np.testing.assert_allclose(own[2], want[2], rtol=RTOL_RETENTION, atol=0)
    with pytest.raises(ValueError):
        dse_batch.codesign_metrics(same, demands(dse), STEPS[:2],
                                   device="cpu")


def test_pareto_multibank_and_shims_match_reference():
    cfgs = dse.lattice_configs(cells=("gc2t_nn", "sram6t"),
                               word_sizes=(16, 64), num_words=(16, 128))
    ref_cfgs = ref_dse.lattice_configs(cells=("gc2t_nn", "sram6t"),
                                       word_sizes=(16, 64),
                                       num_words=(16, 128))
    pts = dse_batch.evaluate_batch(cfgs, device="cpu")
    ref_lat = ref_mixed_lattice(ref_cfgs, (1.0,))
    ref_pts = [ref_lat.point(0, i) for i in range(len(ref_cfgs))]
    for keys in (("area_um2", "f_max_hz", "standby_w"),
                 ("t_read_s", "eff_bw_bps"), ("leakage_w",)):
        assert [dse.shmoo_key(p.cfg) for p in dse.pareto(pts, keys)] == \
            [ref_dse.shmoo_key(p.cfg) for p in ref_dse.pareto(ref_pts, keys)]
    assert dse.PARETO_MAXIMIZE == ref_dse.PARETO_MAXIMIZE
    for p, rp in zip(pts, ref_pts):
        for n in (1, 3, 8):
            got = multibank.compose_multibank(p, n).as_dict()
            want = ref_mb.compose_multibank(rp, n).as_dict()
            assert got.keys() == want.keys()
            for k, w in want.items():
                if isinstance(w, float):
                    np.testing.assert_allclose(got[k], w, rtol=RTOL_RETENTION
                                               if "refresh" in k
                                               or "retention" in k
                                               or "standby" in k
                                               else RTOL_ANALYTIC, atol=0)
                else:
                    assert got[k] == w, k
    with pytest.raises(ValueError):
        multibank.compose_multibank(dataclasses.replace(pts[0], t_read_s=0.0),
                                    2)
    d = dse.Demand("x", "L2", 1e12, 1e-9)
    assert multibank.banks_needed(dataclasses.replace(pts[0], swing_ok=False),
                                  d) == 1025
    assert multibank.banks_needed(pts[0], d, max_banks=4) == \
        ref_mb.banks_needed(ref_pts[0], ref_dse.Demand("x", "L2", 1e12, 1e-9),
                            max_banks=4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        swept = dse.sweep(cells=("gc2t_nn",), word_sizes=(16,),
                          num_words=(16, 32), device="cpu")
        macro = multibank.build_multibank(cfgs[0], 4, device="cpu")
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 2
    assert [p.f_max_hz for p in swept] == [
        dse.evaluate(c, device="cpu").f_max_hz for c in
        dse.lattice_configs(cells=("gc2t_nn",), word_sizes=(16,),
                            num_words=(16, 32))]
    assert macro.n_banks == 4 and macro.bank == pts[0]


def test_deferred_gradient_parts_name_item_11():
    """Item 11 has landed: the gradient parts run (their parity tests are
    tests/test_torch_grad_dse.py and tests/test_torch_optimize.py), and
    the knob and output names still match the reference."""
    from repro_torch.core import dse_grad
    from repro.core import dse_grad as ref_dse_grad
    assert dse_grad.KNOBS == ref_dse_grad.KNOBS
    assert dse_grad.OUTPUTS == ref_dse_grad.OUTPUTS
    assert dse.evaluate_grad is dse_grad.evaluate_grad
    out = dse.evaluate_grad(BankConfig(16, 16, cell="gc2t_nn"),
                            {"vdd_scale": torch.ones(2, dtype=torch.float64)},
                            device="cpu")
    assert set(out) == set(dse_grad.OUTPUTS)
    assert all(v.shape == (2,) for v in out.values())
