"""Port parity: the query API of `repro_torch` (`api/`) against the JAX
reference's `repro.api`, on the CPU.

Limits (see tests/test_torch_dse.py and tests/test_torch_compiler.py for
their sources):
  * the reference runs under x64, and every retention-independent field
    of a design point is held to 1e-12 relative;
  * retention_s, refresh_w and standby_w to 2e-6 of the reference's
    lattice evaluated outside x64 (its own retention precision), with its
    group-constant memo emptied first;
  * transient t_cell to 1e-9 relative (f64 in both); a point's rel_dev
    = |t_an - t_sim| / t_sim then moves by at most (1 + rel_dev) * 1e-9;
  * the compile report at 16x64 with solver "pallas" as in
    tests/test_torch_compiler.py: t_cell_sim 5e-8, the analytic fields
    1e-12, retention 2e-6 of the plain reference;
  * shmoo grids, banks_needed, verdicts, counts and executor statistics
    equal.
"""
import dataclasses
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core import dse_batch as ref_dse_batch  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.workloads.profiler import Profile as RefProfile  # noqa: E402,E501
import repro_torch.api as api  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.core import compiler, dse, dse_batch  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402
from repro_torch.workloads import Profile  # noqa: E402

RTOL_ANALYTIC = 1e-12
RTOL_RETENTION = 2e-6
RTOL_T_CELL = 1e-9
RTOL_SIM_PALLAS = 5e-8
RET_KEYS = ("retention_s", "refresh_w", "standby_w")
LATTICE = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16, 32),
               num_words=(16, 32), wwlls=(False,))
SMALL = dict(cells=("gc2t_nn", "sram6t"), word_sizes=(16, 64),
             num_words=(16, 64))
# the six demands of benchmarks/bench_codesign.py
DEMANDS = [("act-l1", "L1", 3.0e8, 2.0e-6, 0),
           ("act-l1-fast", "L1", 1.2e9, 5.0e-7, 0),
           ("kv-l2", "L2", 8.0e8, 1.0e-3, 1 << 20),
           ("stream-l2", "L2", 2.5e9, 1.0e-5, 0),
           ("weights-l2", "L2", 2.0e8, 3600.0, 1 << 22),
           ("hopeless", "L2", 5.0e10, 1.0, 0)]


def demands(mod):
    return tuple(mod.Demand(*d) for d in DEMANDS)


def plain_retention(lattice: dict) -> dict:
    """(shmoo key) -> (retention_s, refresh_w) of the reference outside
    x64; its group-constant memo ignores the x64 state, so it is emptied
    before and after."""
    ref_dse_batch._CONSTS_CACHE.clear()
    cfgs = ref_dse.lattice_configs(**lattice)
    lat = ref_dse_batch.evaluate_vdd_lattice(cfgs, (1.0,))
    ref_dse_batch._CONSTS_CACHE.clear()
    return {ref_dse.shmoo_key(c): (lat.retention_s[0, i], lat.refresh_w[0, i])
            for i, c in enumerate(cfgs)}


def ref_run(queries, **kw):
    """The reference Session under x64 (memo emptied first)."""
    ref_dse_batch._CONSTS_CACHE.clear()
    with jax.enable_x64(True):
        s = ref_api.Session(**kw)
        out = s.run_many(queries)
    ref_dse_batch._CONSTS_CACHE.clear()
    return s, out


def assert_row(got: dict, want: dict, plain=None):
    """One DesignPoint.as_dict() row; `plain` = (retention_s, refresh_w)
    of the reference outside x64."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k in RET_KEYS and plain is not None:
            ret, refresh = plain
            w = {"retention_s": ret, "refresh_w": refresh,
                 "standby_w": want["leakage_w"] + refresh}[k]
            np.testing.assert_allclose(g, w, rtol=RTOL_RETENTION, atol=0,
                                       err_msg=k)
        elif isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=RTOL_ANALYTIC, atol=0,
                                       err_msg=k)
        else:
            assert g == w, k


def assert_table(got, want, plain):
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert_row(gp.as_dict(), wp.as_dict(), plain[dse.shmoo_key(gp.cfg)])


def assert_chars(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.t_cell_s, w.t_cell_s, rtol=RTOL_T_CELL)
        np.testing.assert_allclose(g.t_cell_analytic_s, w.t_cell_analytic_s,
                                   rtol=RTOL_ANALYTIC)
        np.testing.assert_allclose(g.t_end_s, w.t_end_s, rtol=RTOL_ANALYTIC)
        np.testing.assert_allclose(g.rel_dev, w.rel_dev, rtol=0,
                                   atol=(1 + w.rel_dev) * RTOL_T_CELL)
        assert (g.swing_ok, g.n_steps) == (w.swing_ok, w.n_steps)


@pytest.fixture(scope="module")
def match_runs():
    """The Fig-10 flow over an 8-point lattice at the default transient
    fidelity (300 steps, f64, solver "pallas"), in both packages."""
    sweep = dict(LATTICE, fidelity="transient")
    rs, (want,) = ref_run([ref_api.MatchQuery(
        demands(ref_dse), ref_api.SweepQuery(**sweep))])
    s = api.Session(device="cpu")
    got = s.run(api.MatchQuery(demands(dse), api.SweepQuery(**sweep)))
    return dict(got=got, want=want, session=s, ref_session=rs,
                plain=plain_retention(LATTICE))


def test_public_names_match_reference():
    assert sorted(api.__all__) == sorted(ref_api.__all__)
    for name in api.__all__:
        assert getattr(api, name).__name__ == \
            getattr(ref_api, name).__name__


def test_sweep_analytic_matches_reference():
    _, (want,) = ref_run([ref_api.SweepQuery()])
    got = api.Session(device="cpu").run(api.SweepQuery())
    assert isinstance(got, api.DesignTable) and len(got) == 96
    assert_table(got, want, plain_retention({}))
    assert got.best("f_max_hz").cfg == dse.lattice_configs()[
        [p.cfg for p in want].index(want.best("f_max_hz").cfg)]
    assert [p.cfg.cell for p in got.pareto()] == \
        [p.cfg.cell for p in want.pareto()]


def test_sweep_transient_matches_reference(match_runs):
    got, want = match_runs["got"].table, match_runs["want"].table
    assert isinstance(got, api.CalibratedTable) and len(got) == 8
    assert_table(got, want, match_runs["plain"])
    assert_chars(got.transient, want.transient)
    gc, wc = got.calibration(), want.calibration()
    assert gc.keys() == wc.keys()
    for k in ("n_points", "n_simulated", "n_swing_fail"):
        assert gc[k] == wc[k]
    for k in ("max_rel_dev", "mean_rel_dev"):
        np.testing.assert_allclose(gc[k], wc[k], rtol=0,
                                   atol=(1 + wc[k]) * RTOL_T_CELL)


def test_match_matches_reference(match_runs):
    got, want = match_runs["got"], match_runs["want"]
    assert got.grid == want.grid
    assert got.banks_needed == want.banks_needed
    assert got.pass_rate == want.pass_rate
    assert 0 < got.pass_rate < 1
    for g, w in zip(got.rows, want.rows):
        gb, wb = g.pop("bank"), w.pop("bank")
        assert g == w
        g["bank"], w["bank"] = gb, wb
        key = f"{wb['cell']}/{wb['word_size']}x{wb['num_words']}"
        assert_row(gb, wb, match_runs["plain"][key])
    assert dict(match_runs["session"].executor.stats) == \
        dict(match_runs["ref_session"].executor.stats)


def test_compile_query_matches_reference(tmp_path):
    cfg = dict(word_size=16, num_words=64, cell="gc2t_nn")
    _, (want,) = ref_run([ref_api.CompileQuery(
        RefBankConfig(**cfg), simulate=True, solver="pallas")])
    plain = ref_compiler.compile_bank(RefBankConfig(**cfg))
    s = api.Session(device="cpu")
    got = s.run(api.CompileQuery(BankConfig(**cfg), simulate=True,
                                 solver="pallas"))
    assert isinstance(got, api.CompileResult)
    np.testing.assert_allclose(got.t_cell_sim_s, want.t_cell_sim_s,
                               rtol=RTOL_SIM_PALLAS)
    for k, w in want.timing.as_dict().items():
        np.testing.assert_allclose(getattr(got.timing, k), w,
                                   rtol=RTOL_ANALYTIC, err_msg=k)
    for k, w in plain.retention.as_dict().items():
        np.testing.assert_allclose(getattr(got.retention, k), w,
                                   rtol=RTOL_RETENTION, err_msg=k)
    assert got.netlists == want.netlists
    # cached: the same object, no second compile
    assert s.compile(BankConfig(**cfg), simulate=True, solver="pallas") \
        is got
    assert s.executor.stats["compile_calls"] == 1
    with pytest.warns(DeprecationWarning):
        rep = compiler.GCRAMCompiler(BankConfig(16, 16)).compile(
            device="cpu")
    assert rep.timing.f_max_hz == compiler.compile_bank(
        BankConfig(16, 16), device="cpu").timing.f_max_hz
    assert got.write(str(tmp_path / "c")) == str(tmp_path / "c")


def _coalescing_queries(mod, dse_mod):
    return [mod.SweepQuery(**SMALL),
            mod.SweepQuery(cells=("gc2t_nn",), word_sizes=(16, 32),
                           num_words=(16,)),
            mod.MatchQuery(demands(dse_mod)[:3], mod.SweepQuery(**SMALL)),
            mod.SweepQuery(cells=("gc2t_np",), word_sizes=(16, 32),
                           num_words=(16,), wwlls=(False,),
                           fidelity="transient", sim_steps=30),
            mod.SweepQuery(cells=("gc2t_np",), word_sizes=(32, 64),
                           num_words=(16,), wwlls=(False,),
                           fidelity="transient", sim_steps=30),
            mod.SweepQuery(**SMALL, batched=False),
            mod.SweepQuery(**SMALL)]


def test_run_many_equals_sequential_and_reference_stats():
    qs = _coalescing_queries(api, dse)
    many = api.Session(device="cpu")
    got = many.run_many(qs)
    seq = api.Session(device="cpu")
    want = [seq.run(q) for q in qs]
    for g, w in zip(got, want):
        assert g.as_dict() == w.as_dict()
    assert got[0] is got[5] is got[6]          # one table per lattice
    st = dict(many.executor.stats)
    assert st["waves"] == 1 and st["char_calls"] == 1 \
        and st["eval_batch_calls"] == 1
    rs, ref = ref_run(_coalescing_queries(ref_api, ref_dse))
    assert st == dict(rs.executor.stats)
    plain = plain_retention(SMALL)
    plain.update(plain_retention(dict(cells=("gc2t_nn", "gc2t_np"),
                                      word_sizes=(16, 32, 64),
                                      num_words=(16,))))
    for g, w in zip(got, ref):
        if isinstance(w, ref_api.MatchResult):
            assert g.grid == w.grid and g.banks_needed == w.banks_needed
            continue
        assert_table(g, w, plain)
        if isinstance(w, ref_api.CalibratedTable):
            assert_chars(g.transient, w.transient)


def test_store_round_trip_recomputes_nothing(tmp_path):
    qs = [api.SweepQuery(**SMALL),
          api.SweepQuery(cells=("gc2t_nn",), word_sizes=(16,),
                         num_words=(16, 32), wwlls=(False,),
                         fidelity="transient", sim_steps=30)]
    first = api.Session(store=tmp_path / "store", device="cpu")
    want = first.run_many(qs)
    assert len(first.store) == 3                # points x2, transient
    second = api.Session(store=str(tmp_path / "store"), device="cpu")
    got = second.run_many(qs)
    st = second.executor.stats
    assert st["points_evaluated"] == 0 and st["char_calls"] == 0
    assert st["store_hits"] == 3
    for g, w in zip(got, want):
        assert g.as_dict() == w.as_dict()     # floats round-trip exactly
    # every stored field is host data: JSON of Python numbers only
    data = second.store.get(plan_mod._plan_sweep(second, qs[1]).nodes[1].key)
    assert all(not isinstance(v, torch.Tensor) for row in data
               for v in row.values())
    assert json.loads(json.dumps(data)) == data


def test_reference_store_is_not_read(tmp_path):
    q = dict(cells=("gc2t_nn",), word_sizes=(16,), num_words=(16, 32),
             wwlls=(False,))
    ref_run([ref_api.SweepQuery(**q)], store=str(tmp_path))
    s = api.Session(store=str(tmp_path), device="cpu")
    s.run(api.SweepQuery(**q))
    assert s.executor.stats["store_hits"] == 0
    assert s.executor.stats["points_evaluated"] == 2
    assert len(s.store) == 2                  # one artifact per package


def test_sweep_layout_matches_reference(tmp_path):
    """SweepQuery(fidelity="layout") through a stored session: geometry
    reports equal to the reference's exactly, the extracted transient
    t_cell within 1e-9, the analytic fields as in the other sweeps; a
    fresh session on the store replays it with no geometry rebuild and
    no transient run (the reference's test_layout_fidelity_end_to_end)."""
    kw = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16,),
              num_words=(64,), wwlls=(False,), sim_steps=200)
    _, (want,) = ref_run([ref_api.SweepQuery(fidelity="layout", **kw)])
    s = api.Session(store=str(tmp_path), device="cpu")
    got = s.run(api.SweepQuery(fidelity="layout", **kw))
    assert isinstance(got, api.LayoutTable) and len(got) == 2
    assert got.geometry == want.geometry
    assert got.geometry_summary() == want.geometry_summary()
    assert got.geometry_summary()["all_clean"]
    assert s.executor.stats["geom_verifies"] == 2
    lat = {k: v for k, v in kw.items() if k != "sim_steps"}
    assert_table(got, want, plain_retention(lat))
    assert_chars(got.transient, want.transient)
    d = got.as_dict()
    assert all("geometry" in row for row in d["rows"])
    json.dumps(d)
    s2 = api.Session(store=str(tmp_path), device="cpu")
    again = s2.run(api.SweepQuery(fidelity="layout", **kw))
    assert s2.executor.stats["geom_verifies"] == 0
    assert s2.executor.stats["char_calls"] == 0
    assert again.geometry == got.geometry
    assert [c.t_cell_s for c in again.transient] == \
        [c.t_cell_s for c in got.transient]


def test_sweep_sparse_matches_reference():
    """SweepQuery(solver="sparse"): t_cell within 1e-9 of the reference's
    sparse engine."""
    lat = dict(cells=("gc2t_nn",), word_sizes=(16,), num_words=(16, 64),
               wwlls=(False,))
    q = dict(lat, fidelity="transient", solver="sparse", sim_steps=200)
    _, (want,) = ref_run([ref_api.SweepQuery(**q)])
    s = api.Session(device="cpu")
    got = s.run(api.SweepQuery(**q))
    assert isinstance(got, api.CalibratedTable) and len(got) == 2
    assert_table(got, want, plain_retention(lat))
    assert_chars(got.transient, want.transient)
    assert s.executor.stats["char_calls"] == 1


def test_deferred_queries_name_their_item():
    s = api.Session(device="cpu")
    tiny = dict(cells=("gc2t_nn",), word_sizes=(16,), num_words=(16,),
                wwlls=(False,))
    prof = Profile("llama", "decode", "decode", 2e-3, 1e9, 1e8, 1e6, 1.0,
                   1e-3, 1e-6, 3e8, 8e8)
    # CoDesignQuery and codesign_measured (item 12) run now
    rep = s.run(api.CoDesignQuery((prof,), api.SweepQuery(**tiny)))
    assert isinstance(rep, api.CoDesignReport) and len(rep.plans) == 1
    from repro_torch.configs import get_config
    from repro_torch.runtime import TelemetryCollector
    col = TelemetryCollector(step_time_s=1e-6)
    col.on_chunk(4, 4, [10], 0)
    measured = s.codesign_measured([col.snapshot()],
                                   get_config("llama3.2-1b"),
                                   sweep=api.SweepQuery(**tiny))
    assert [p["workload"] for p in measured] == \
        ["measured:llama3.2-1b:win0"]
    # the layout tier (item 10), the sparse engine (item 4) and
    # OptimizeQuery (item 11) run too
    assert s.run(api.OptimizeQuery(steps=2)).raw["evals"]["grad_steps"] == 2
    for fidelity, solver in (("layout", "pallas"), ("transient", "sparse")):
        t = s.run(api.SweepQuery(**tiny, fidelity=fidelity, solver=solver,
                                 sim_steps=20))
        assert len(t) == 1 and t.transient[0].n_steps == 20
    with pytest.raises(ValueError):
        api.SweepQuery(fidelity="bogus")
    with pytest.raises(ValueError):
        api.OptimizeQuery(knobs=("bogus",))
    with pytest.raises(ValueError):
        api.MatchQuery(demands(dse)[:1] * 2)


# the README's quickstart query
README_OPTIMIZE = dict(cell="gc2t_np", target_freq_hz=5e8, target_ret_s=5e-5,
                       knobs=("vdd_scale", "w_read_scale"))


def test_optimize_query_matches_reference(tmp_path):
    """`OptimizeQuery` through the port's Session against the reference
    Session under x64 (limits as in tests/test_torch_optimize.py: the
    seed rung's objective 2e-6, everything else 1e-6 or equal); the
    result writes like the reference's; a fresh session on the store the
    first wrote optimizes and evaluates nothing and returns the same
    dict; the same query again is the same object."""
    rs, (want,) = ref_run([ref_api.OptimizeQuery(**README_OPTIMIZE)])
    want = want.as_dict()
    s = api.Session(device="cpu", store=str(tmp_path / "store"))
    got = s.run(api.OptimizeQuery(**README_OPTIMIZE))
    assert isinstance(got, api.OptimizeResult) and got.met
    d = got.as_dict()
    assert d.keys() == want.keys()
    for k, w in want.items():
        if k in ("knobs", "outputs"):
            for kk, ww in w.items():
                assert d[k][kk] == pytest.approx(ww, rel=1e-6), (k, kk)
        elif k == "loss_history":
            np.testing.assert_allclose(d[k], w, rtol=1e-6)
        elif k == "seed_objective_value":
            assert d[k] == pytest.approx(w, rel=2e-6)
        elif isinstance(w, float):
            assert d[k] == pytest.approx(w, rel=1e-6), k
        else:
            assert d[k] == w, k
    assert s.executor.stats["optimize_calls"] == 1
    assert s.executor.stats["vdd_evals"] == 1
    assert rs.executor.stats["optimize_calls"] == 1
    assert s.run(api.OptimizeQuery(**README_OPTIMIZE)) is got
    assert s.optimize(api.OptimizeQuery(**README_OPTIMIZE)) is got
    out = got.write(str(tmp_path / "out"))
    assert json.load(open(tmp_path / "out" / got.filename)) == \
        json.loads(json.dumps(d))
    assert out == str(tmp_path / "out")
    fresh = api.Session(device="cpu", store=str(tmp_path / "store"))
    again = fresh.run(api.OptimizeQuery(**README_OPTIMIZE))
    assert again.as_dict() == d
    assert fresh.executor.stats["optimize_calls"] == 0
    assert fresh.executor.stats["vdd_evals"] == 0
    assert fresh.executor.stats["store_hits"] == 2


def test_compose_codesign_and_vdd_lattice_match_reference():
    """`compose_codesign` (CoDesignQuery's compose step) on the
    reference's cube equals the reference's plan;
    `Session.vdd_lattice` runs the analytic vdd ladder."""
    fields = (("a", "s", "decode", 2e-3, 1e9, 1e8, 1e6, 1.0, 1e-3, 1e-6,
               3e8, 8e8),
              ("b", "t", "prefill", 5e-3, 1e9, 1e8, 1e6, 3600.0, 1.0, 1e-5,
               1.2e9, 5e10))
    ref_profs = tuple(RefProfile(*f) for f in fields)
    profs = tuple(Profile(*f) for f in fields)
    sweep = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16, 32),
                 num_words=(16, 64))
    rs, _ = ref_run([])
    with jax.enable_x64(True):
        rq = ref_api.CoDesignQuery(ref_profs, ref_api.SweepQuery(**sweep))
        rlat = rs.vdd_lattice(rq.sweep, rq.vdd_scales)
        ds = [d for p in ref_profs for d in p.demands()]
        steps = [p.step_time_s for p in ref_profs for _ in p.demands()]
        cube = ref_dse_batch.codesign_metrics(rlat, ds, steps)
        want = ref_api.plan.compose_codesign(rs, rq, rlat, cube)
    ref_dse_batch._CONSTS_CACHE.clear()
    s = api.Session(device="cpu")
    q = api.CoDesignQuery(profs, api.SweepQuery(**sweep))
    lat = dse_batch.VddLattice(
        q.sweep.configs(s.tech), rlat.vdd_scales,
        *(getattr(rlat, f.name) for f in dataclasses.fields(rlat)[2:]))
    got = plan_mod.compose_codesign(s, q, lat, cube)
    assert json.dumps(got.as_dict(), default=str) == \
        json.dumps(want.as_dict(), default=str)
    own = s.vdd_lattice(q.sweep, q.vdd_scales)
    assert own is s.vdd_lattice(q.sweep, q.vdd_scales)
    assert s.executor.stats["vdd_evals"] == 1
    np.testing.assert_allclose(own.f_max_hz, rlat.f_max_hz,
                               rtol=RTOL_ANALYTIC)


def test_session_device():
    if torch.cuda.is_available():
        assert api.Session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            api.Session()
    s = api.Session(device="cpu")
    pt = s.evaluate(BankConfig(16, 16))
    assert pt == dse.evaluate(BankConfig(16, 16), device="cpu")
    assert s.multibank(BankConfig(16, 16), 2).n_banks == 2


def test_lease_manager_claim_release_steal(tmp_path):
    import time
    owner = api.LeaseManager(tmp_path, owner="dead", ttl_s=0.15,
                             heartbeat=False)
    lease = owner.try_claim("points-k")
    assert lease is not None and not lease.stolen
    thief = api.LeaseManager(tmp_path, owner="thief", ttl_s=0.15,
                             heartbeat=False)
    assert thief.try_claim("points-k") is None        # still live
    lease.release()
    mine = thief.try_claim("points-k")                # released: claim
    assert mine is not None and not mine.stolen
    owner2 = api.LeaseManager(tmp_path, owner="late", ttl_s=0.15,
                              heartbeat=False)
    time.sleep(0.3)
    stolen = owner2.try_claim("points-k")             # expired: steal
    assert stolen is not None and stolen.stolen
    assert owner2.counts["steals"] == 1
    stolen.release()
    s = api.Session(store=tmp_path / "st", leases=True, device="cpu")
    assert isinstance(s.leases, api.LeaseManager)
    s.run(api.SweepQuery(cells=("gc2t_nn",), word_sizes=(16,),
                         num_words=(16,)))
    assert api.LeaseManager.duplicate_evals(str(tmp_path / "st")) == {}
    s.leases.close()
