"""Port parity of the projected-Adam design optimizer
(`repro_torch.optim.dse_opt`, `optim.optimizers.adamw`) and of
`dse.grad_optimize` against the JAX reference, plus the reference's own
optimizer-contract tests run on the port (tests/test_optimize.py).

Limits:
  * `met`, `seed_met`, `fell_back` and `improved` equal; the knobs,
    the exact objective value and the loss history within 1e-6
    relative (the same float64 algebra under the same float32 Adam
    arithmetic; measured: equal bit for bit or within 2e-16);
  * the seed rung's objective within 2e-6: it comes from the vdd
    lattice, whose retention the port integrates in float32 (the
    reference's optimizer runs its seed lattice under x64;
    tests/test_torch_dse.py);
  * `grad_optimize` (float32 in both) within 1e-5.
"""
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
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.optim import dse_opt as ref_dse_opt  # noqa: E402
from repro_torch.core import dse, dse_batch  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402
from repro_torch.core.dse_grad import evaluate_grad_fn  # noqa: E402
from repro_torch.optim import dse_opt, optimizers  # noqa: E402
from tests._hyp import given, settings, strategies as st  # noqa: E402

CFG = BankConfig(32, 64, cell="gc2t_np")
REF_CFG = RefBankConfig(32, 64, cell="gc2t_np")
RTOL = 1e-6
RTOL_SEED = 2e-6
VERDICTS = ("met", "seed_met", "fell_back", "improved")
# three demands: both met, the refined point met from an unmet seed
# rung's ladder, and one no rung meets
DEMANDS = [dict(target_freq_hz=2e8, target_ret_s=5e-5),
           dict(target_freq_hz=5.5e8, target_ret_s=1e-6),
           dict(target_freq_hz=1e9, target_ret_s=1e-3)]


def ref_optimize(**kw):
    ref_dse_batch._CONSTS_CACHE.clear()
    out = ref_dse_opt.optimize(REF_CFG, **kw)
    ref_dse_batch._CONSTS_CACHE.clear()
    return out


def assert_opt(got: dict, want: dict):
    for k in VERDICTS:
        assert got[k] == want[k], k
    assert got.keys() == want.keys()
    for k in want["knobs"]:
        assert got["knobs"][k] == pytest.approx(want["knobs"][k], rel=RTOL)
    assert got["objective_value"] == pytest.approx(want["objective_value"],
                                                   rel=RTOL)
    assert got["seed_objective_value"] == pytest.approx(
        want["seed_objective_value"], rel=RTOL_SEED)
    assert got["seed_knobs"] == want["seed_knobs"]
    assert got["evals"] == want["evals"]
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=RTOL)
    for k, w in want["outputs"].items():
        assert got["outputs"][k] == pytest.approx(w, rel=RTOL), k


@pytest.mark.parametrize("demand", DEMANDS,
                         ids=lambda d: f"{d['target_freq_hz']:.2g}Hz")
def test_optimize_matches_reference(demand):
    kw = dict(demand, steps=8, seed_vdd_scales=(0.7, 1.0))
    want = ref_optimize(**kw).as_dict()
    got = dse_opt.optimize(CFG, device="cpu", **kw)
    assert got.cfg == CFG
    assert_opt(got.as_dict(), want)


def test_adamw_matches_reference_in_float32():
    """AdamW's float32 arithmetic on float64 parameters, step for step."""
    from repro.optim.optimizers import adamw as ref_adamw
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, 3)
    grads = rng.normal(size=(6, 3)) * np.array([1e-3, 1.0, 30.0])
    with jax.enable_x64(True):
        opt = ref_adamw(lambda s: 0.05, weight_decay=0.0)
        p = {"x": jax.numpy.asarray(x)}
        st_ = opt.init(p)
        want = []
        for s, g in enumerate(grads):
            p, st_, stats = opt.update({"x": jax.numpy.asarray(g)}, st_, p,
                                       jax.numpy.asarray(s))
            want.append((np.asarray(p["x"]), float(stats["grad_norm"])))
    opt = optimizers.adamw(lambda s: 0.05, weight_decay=0.0)
    p = {"x": torch.tensor(x)}
    st_ = opt.init(p)
    for s, g in enumerate(grads):
        p, st_, stats = opt.update({"x": torch.tensor(g)}, st_, p, s)
        assert p["x"].dtype == torch.float64
        assert st_["mu"]["x"].dtype == torch.float32
        np.testing.assert_allclose(p["x"].numpy(), want[s][0], rtol=1e-15)
        assert float(stats["grad_norm"]) == want[s][1]


def _exact_feasible(cfg, outputs, target_freq_hz, target_ret_s,
                    allow_refresh=True):
    """The dse.feasible rule, re-derived from quantized outputs."""
    if outputs["swing_margin_a"] <= 0 or \
            outputs["f_max_hz"] < target_freq_hz:
        return False
    if outputs["retention_s"] >= target_ret_s:
        return True
    if not allow_refresh or outputs["retention_s"] <= 0:
        return False
    return cfg.num_words / outputs["retention_s"] < \
        0.1 * outputs["f_max_hz"]


@settings(max_examples=5, deadline=None)
@given(st.floats(min_value=5e7, max_value=6e8),
       st.floats(min_value=1e-6, max_value=2e-4))
def test_optimizer_contract_feasible_and_never_regresses(freq, ret):
    r = dse_opt.optimize(CFG, target_freq_hz=freq, target_ret_s=ret,
                         steps=8, seed_vdd_scales=(0.7, 1.0), device="cpu")
    for k, v in r.knobs.items():
        lo, hi = dse_opt.DEFAULT_BOUNDS[k]
        assert lo - 1e-12 <= v <= hi + 1e-12
    if r.met == r.seed_met:
        assert r.objective_value <= r.seed_objective_value * (1 + 1e-12)
    if r.seed_met:
        assert r.met
    fn = evaluate_grad_fn(CFG, quantized=True, device="cpu")
    with torch.no_grad():
        out = {k: float(v[0]) for k, v in fn(
            {k: torch.tensor([v], dtype=torch.float64)
             for k, v in r.knobs.items()}).items()}
    assert _exact_feasible(CFG, out, freq, ret) == r.met
    if r.met:
        assert out[r.objective] == pytest.approx(r.objective_value,
                                                 rel=1e-9)


def test_multi_knob_beats_single_knob_run():
    """Width/wire knobs strictly enlarge the search space; at matched
    settings the multi-knob optimum is at least as good."""
    kw = dict(target_freq_hz=5e8, target_ret_s=5e-5, steps=40,
              device="cpu")
    r1 = dse_opt.optimize(CFG, knobs=("vdd_scale",), **kw)
    r4 = dse_opt.optimize(CFG, knobs=dse_opt.DEFAULT_BOUNDS, **kw)
    assert r1.met and r4.met
    assert r4.objective_value <= r1.objective_value * (1 + 1e-9)


def test_impossible_demand_reports_unmet_gracefully():
    kw = dict(target_freq_hz=1e14, target_ret_s=1e3, steps=4,
              seed_vdd_scales=(0.85, 1.0))
    r = dse_opt.optimize(CFG, device="cpu", **kw)
    assert not r.met and not r.seed_met
    assert np.isfinite(r.objective_value)
    assert_opt(r.as_dict(), ref_optimize(**kw).as_dict())


def _grid_optimum(mod_dse_batch, cfgs, vdd_scales, demand, **kw):
    """benchmarks/bench_optimize.py's feasible argmin over the
    (rungs x configs) grid: (best objective, rung, config index)."""
    lat = mod_dse_batch.evaluate_vdd_lattice(cfgs, list(vdd_scales), **kw)
    feas = mod_dse_batch.feasible_grid(
        lat.f_max_hz, lat.retention_s, lat.swing_ok, lat.num_words,
        np.array([demand["target_freq_hz"]]),
        np.array([demand["target_ret_s"]]), **kw)[:, :, 0]
    obj = np.where(feas, np.asarray(lat.standby_w), np.inf)
    v, p = np.unravel_index(int(np.argmin(obj)), obj.shape)
    return float(obj[v, p]), int(v), int(p)


def test_bench_optimize_smoke_flow_matches_reference():
    """The smoke flow of benchmarks/bench_optimize.py: a dense 24-rung
    grid and a 4-rung coarse screen over the 4-config lattice, then 12
    Adam steps on the coarse winner. The port picks the same configs and
    reaches the reference's optimum."""
    from benchmarks.bench_optimize import COARSE, DEMAND
    lattice = dict(cells=("gc2t_nn", "gc2t_np"), word_sizes=(32,),
                   num_words=(32, 64), wwlls=(False,))
    dense = np.linspace(0.62, 1.25, 24)
    ref_cfgs = ref_dse.lattice_configs(**lattice)
    cfgs = dse.lattice_configs(**lattice)
    ref_dse_batch._CONSTS_CACHE.clear()
    want = [_grid_optimum(ref_dse_batch, ref_cfgs, ladder, DEMAND)
            for ladder in (dense, COARSE)]
    got = [_grid_optimum(dse_batch, cfgs, ladder, DEMAND, device="cpu")
           for ladder in (dense, COARSE)]
    for (gb, gv, gp), (wb, wv, wp) in zip(got, want):
        assert (gv, gp) == (wv, wp)
        assert gb == pytest.approx(wb, rel=RTOL_SEED)
    cp = got[1][2]
    kw = dict(DEMAND, objective="standby_w", knobs=("vdd_scale",),
              steps=12, seed_vdd_scales=COARSE)
    r = dse_opt.optimize(cfgs[cp], device="cpu", **kw)
    ref_dse_batch._CONSTS_CACHE.clear()
    w = ref_dse_opt.optimize(ref_cfgs[cp], **kw)
    assert_opt(r.as_dict(), w.as_dict())
    assert r.met and r.objective_value <= got[0][0] * (1 + 1e-9)


def test_grad_optimize_matches_reference():
    want = ref_dse.grad_optimize("gc2t_nn", verbose=True)
    got = dse.grad_optimize("gc2t_nn", verbose=True, device="cpu")
    assert got.keys() == want.keys()
    for k in ("write_vt", "w_write_um", "wwl_boost", "retention_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["met"] == want["met"]
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5)


def test_optimize_query_validates_at_construction():
    from repro_torch.api import OptimizeQuery
    OptimizeQuery()
    for kw, match in ((dict(cell="nope"), "unknown cell"),
                      (dict(cell="sram6t"), "gain cells"),
                      (dict(knobs=("vdd_scale", "x")), "unknown knobs"),
                      (dict(knobs=()), ">= 1 knob"),
                      (dict(objective="area"), "unknown objective"),
                      (dict(steps=0), "steps/lr"),
                      (dict(target_ret_s=-1.0), "targets must be positive"),
                      (dict(seed_vdd_scales=()), "seed_vdd_scales"),
                      (dict(cell="gc2t_nn", write_vt="oshvt"),
                       "wrong device")):
        with pytest.raises(ValueError, match=match):
            OptimizeQuery(**kw)
    q = OptimizeQuery(knobs=["vdd_scale"], seed_vdd_scales=[0.8, 1.0])
    assert isinstance(q.knobs, tuple)
    assert hash(q) == hash(OptimizeQuery(knobs=("vdd_scale",),
                                         seed_vdd_scales=(0.8, 1.0)))


def test_optim_exports_the_ported_optimizers():
    """`repro_torch.optim` re-exports what `repro.optim` does; the
    training optimizers and schedules still name their item."""
    import repro.optim as ref_optim
    import repro_torch.optim as optim
    from repro_torch.optim import adamw, global_norm
    from repro_torch.optim.optimizers import adamw as adamw_def
    assert adamw is adamw_def and callable(global_norm)
    assert sorted(optim.__all__) == sorted(
        n for n in dir(ref_optim) if n in ("adamw", "adafactor",
                                           "make_optimizer", "global_norm",
                                           "make_schedule"))
    tree = {"a": torch.tensor([3.0, 4.0]), "b": [torch.tensor([12.0])]}
    assert float(global_norm(tree)) == pytest.approx(13.0)
    for name in ("adafactor", "make_optimizer", "make_schedule"):
        with pytest.raises(NotImplementedError, match="item 13"):
            getattr(optim, name)()
