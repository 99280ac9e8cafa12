"""Port parity: the runtime loop of `repro_torch` (telemetry windows of a
scripted replay, measured profiles, `Session.codesign_measured` and the
vdd governor) against the JAX reference, on the CPU.

The engines serve the reference's `_tiny` config (tests/test_runtime.py)
with the reference's weights carried into the port by
`interop.model_params_from_numpy`, so both replays see the same model.
Limits:
  * telemetry windows equal field by field (host counters on a virtual
    clock: the same integer steps and the same float products);
  * measured profiles 1e-12 relative (equal parameter counts, the same
    float64 arithmetic);
  * co-design reports and governor decisions as in
    tests/test_torch_codesign.py (`assert_json`): choices, rungs and
    verdicts equal, retention-independent floats 1e-12, refresh and
    retention terms 2e-6 of the reference run outside x64.
"""
import dataclasses
import math

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.api as ref_api  # noqa: E402
import repro.runtime as ref_rt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core import dse_batch as ref_dse_batch  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serving import ServeEngine as RefEngine  # noqa: E402
import repro_torch.api as api  # noqa: E402
import repro_torch.runtime as rt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core import dse_batch  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.workloads import profile_config  # noqa: E402
from test_torch_codesign import (as_json, assert_json,  # noqa: E402
                                 assert_report, ref_runs)

STEP_TIME_S = 1e-6
SCENARIO = (("burst", 4, 40, 16, 5), ("quiet", 1, 6, 8, 8))
# benchmarks/bench_runtime.py's three scenarios (one chat cycle)
BENCH_SCENARIOS = {
    "chat_burst": (("burst0", 4, 24, 24, 7), ("quiet0a", 1, 6, 8, 8),
                   ("quiet0b", 0, 0, 0, 8)),
    "batch_offline": (("fill", 8, 32, 28, 7), ("steady", 0, 0, 0, 7),
                      ("drain", 0, 0, 0, 4), ("drain2", 0, 0, 0, 4)),
    "long_context": (("admit", 2, 40, 20, 6), ("steady", 2, 40, 20, 6),
                     ("tail", 1, 40, 12, 6)),
}
LADDER = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1)
ENGINE = dict(n_slots=4, window=64, mode="device", decode_chunk=4)


def scenario(mod, name, phases):
    return mod.Scenario(name, tuple(mod.Phase(*p) for p in phases))


def _tiny(get):
    return dataclasses.replace(get("llama3.2-1b").reduced(),
                               dtype="float32", n_layers=2, d_model=32,
                               n_heads=4, n_kv_heads=4, head_dim=8,
                               d_ff=64)


@pytest.fixture(scope="module")
def tiny():
    ref_cfg = _tiny(ref_get_config)
    params = RefModel(ref_cfg).init(jax.random.key(0))
    cfg = _tiny(get_config)
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_cfg, params, cfg, model


def replay(mod, engine_cls, cfg, weights, scenarios, seed):
    """Each scenario replayed on one plain and one instrumented engine
    (both reused across scenarios, as benchmarks/bench_runtime.py does):
    (plain engine, instrumented engine, {scenario: windows})."""
    plain = engine_cls(cfg, weights, **ENGINE)
    col = mod.TelemetryCollector(step_time_s=STEP_TIME_S)
    inst = engine_cls(cfg, weights, telemetry=col, **ENGINE)
    wins, rid = {}, 0
    for name, phases in scenarios.items():
        sc = scenario(mod, name, phases)
        mod.run_scenario(plain, sc, seed=seed, rid_base=rid)
        wins[name] = mod.run_scenario(inst, sc, seed=seed, collector=col,
                                      rid_base=rid)
        rid += sum(p[1] for p in phases)
    return plain, inst, wins


@pytest.fixture(scope="module")
def replayed(tiny):
    """tests/test_runtime.py's scenario in both packages."""
    ref_cfg, params, cfg, model = tiny
    _, _, want = replay(ref_rt, RefEngine, ref_cfg, params,
                        {"mixed": SCENARIO}, 0)
    plain, inst, got = replay(rt, ServeEngine, cfg, model,
                              {"mixed": SCENARIO}, 0)
    return cfg, plain, inst, got["mixed"], ref_cfg, want["mixed"]


@pytest.fixture(scope="module")
def bench_windows(tiny):
    """benchmarks/bench_runtime.py's scenarios (seed 17) in both
    packages."""
    ref_cfg, params, cfg, model = tiny
    _, _, want = replay(ref_rt, RefEngine, ref_cfg, params, BENCH_SCENARIOS,
                        17)
    _, _, got = replay(rt, ServeEngine, cfg, model, BENCH_SCENARIOS, 17)
    return cfg, got, ref_cfg, want


def test_public_names_match_reference():
    assert sorted(rt.__all__) == sorted(ref_rt.__all__)


# ---------------------------------------------------------------------------
# telemetry windows
# ---------------------------------------------------------------------------

def test_windows_match_reference(replayed, bench_windows):
    _, _, _, got, _, want = replayed
    _, bgot, _, bwant = bench_windows
    for g, w in [(got, want)] + [(bgot[k], bwant[k]) for k in bwant]:
        assert len(g) == len(w)
        for gw, ww in zip(g, w):
            # the port has no `queue_waits_s`: nothing read it
            want = dataclasses.asdict(ww)
            want.pop("queue_waits_s")
            assert dataclasses.asdict(gw) == want
            assert (gw.duration_s, gw.mean_batch, gw.mean_kv_rows) == \
                (ww.duration_s, ww.mean_batch, ww.mean_kv_rows)


def test_telemetry_zero_extra_syncs_and_greedy_parity(replayed):
    _, plain, inst, _, _, _ = replayed
    assert (inst.host_syncs, inst.admit_syncs) == \
        (plain.host_syncs, plain.admit_syncs)
    ps = {r.rid: list(r.out_tokens) for r in plain.done}
    ws = {r.rid: list(r.out_tokens) for r in inst.done}
    assert len(ps) == 5 and ps == ws


def test_window_counters_exact(replayed):
    """tests/test_runtime.py's exact counters on the port's replay."""
    burst, quiet = replayed[3]
    assert burst.decode_steps == 16 and burst.decode_tokens == 60
    assert burst.n_submitted == burst.n_admitted == burst.n_retired == 4
    assert burst.prefill_tokens == 4 * 40
    assert burst.kv_lifetimes_s == pytest.approx((16 * STEP_TIME_S,) * 4)
    assert burst.duration_s == pytest.approx(20 * STEP_TIME_S)
    assert burst.mean_batch == pytest.approx(60 / 16)
    assert dict(burst.batch_hist) == {0: 4, 4: 16}
    assert burst.mean_kv_rows == pytest.approx(199.0)
    assert quiet.decode_steps == 8 and quiet.decode_tokens == 7
    assert quiet.n_admitted == 1 and quiet.prefill_tokens == 6
    assert quiet.kv_lifetimes_s == pytest.approx((8 * STEP_TIME_S,))
    assert dict(quiet.batch_hist)[0] >= 1


# ---------------------------------------------------------------------------
# measured profiles and co-design from them
# ---------------------------------------------------------------------------

def test_measured_profile_matches_reference(replayed, bench_windows):
    cfg, _, _, wins, ref_cfg, ref_wins = replayed
    _, bgot, _, bwant = bench_windows
    pairs = list(zip(wins, ref_wins)) + [
        (g, w) for k in bwant for g, w in zip(bgot[k], bwant[k])
        if w.decode_steps]
    for i, (g, w) in enumerate(pairs):
        for kw in ({}, {"step_time_s": 2e-3, "n_devices": 4,
                        "arch": "tiny", "shape": f"w{i}"}):
            got = rt.measured_profile(g, cfg, **kw)
            want = ref_rt.measured_profile(w, ref_cfg, **kw)
            assert_json(dataclasses.asdict(got), dataclasses.asdict(want))
    assert rt.kv_row_bytes(cfg) == ref_rt.kv_row_bytes(ref_cfg)
    assert rt.kv_stream_bytes(wins[0], cfg) == \
        ref_rt.kv_stream_bytes(ref_wins[0], ref_cfg)
    assert rt.DIFF_FIELDS == ref_rt.DIFF_FIELDS


def test_measured_profile_matches_analytic(replayed):
    """The burst window's measured profile lands within 15% of the
    analytic decode profile of the same (config, B=4, seq 48) shape on
    every diffed field, exactly on step time and weight stream, and the
    deviations equal the reference's."""
    cfg, _, _, wins, ref_cfg, ref_wins = replayed
    from repro.configs import ShapeConfig as RefShapeConfig
    from repro.workloads import profile_config as ref_profile_config
    mp = rt.measured_profile(wins[0], cfg)
    ap = profile_config(cfg, ShapeConfig("serve", 48, 4, "decode"),
                        n_devices=1, step_time_s=STEP_TIME_S)
    dev = rt.diff_profiles(mp, ap)
    assert set(dev) == set(rt.DIFF_FIELDS)
    assert dev["step_time_s"] == 0.0 and dev["weights_bytes"] == 0.0
    assert all(abs(v) < 0.15 for v in dev.values()), dev
    assert mp.kind == "decode"
    assert mp.kv_lifetime_s == pytest.approx(16 * STEP_TIME_S)
    l1, l2 = mp.demands()
    assert l1.level == "L1" and l2.level == "L2" and l2.read_freq_hz > 0
    want = ref_rt.diff_profiles(
        ref_rt.measured_profile(ref_wins[0], ref_cfg),
        ref_profile_config(ref_cfg, RefShapeConfig("serve", 48, 4, "decode"),
                           n_devices=1, step_time_s=STEP_TIME_S))
    assert_json(dev, want)


def test_measured_profile_rejects_bad_windows(tiny):
    cfg = tiny[2]
    col = rt.TelemetryCollector(step_time_s=STEP_TIME_S)
    with pytest.raises(ValueError, match="empty"):
        rt.measured_profile(col.snapshot(), cfg)
    col.on_chunk(4, 4, [10], 0)
    col.on_train_step(0, 256, 0.1)
    with pytest.raises(ValueError, match="mixes"):
        rt.measured_profile(col.snapshot(), cfg)


def test_codesign_measured_matches_reference(replayed):
    """`Session.codesign_measured` on the port's windows against the
    reference's on its own; a plain list of measured profiles is
    normalized to a hashable tuple, and the report is memoized."""
    cfg, _, _, wins, ref_cfg, ref_wins = replayed
    kw = dict(step_time_s=STEP_TIME_S)
    s = api.Session(device="cpu")
    got = s.codesign_measured(
        wins, cfg, sweep=api.SweepQuery(cells=("gc2t_np", "gc2t_nn")), **kw)
    wants = ref_runs(lambda: ref_api.Session().codesign_measured(
        ref_wins, ref_cfg,
        sweep=ref_api.SweepQuery(cells=("gc2t_np", "gc2t_nn")), **kw))
    assert len(got.plans) == 2 and got.all_feasible
    assert_report(got, wants)
    profiles = [rt.measured_profile(w, cfg, shape=f"win{i}", **kw)
                for i, w in enumerate(wins)]
    q = api.CoDesignQuery(profiles,
                          sweep=api.SweepQuery(cells=("gc2t_np", "gc2t_nn")))
    assert isinstance(q.profiles, tuple) and len(q.profiles) == 2
    hash(q)
    assert s.run(q) is got
    assert got[f"measured:{cfg.name}:win0"] is got.plans[0]
    assert s.executor.stats["vdd_evals"] == 1


# ---------------------------------------------------------------------------
# governor
# ---------------------------------------------------------------------------

GOV_CFGS = ((64, 64), (64, 256))
GOV_SCALES = (0.5, 0.7, 0.9, 1.1)


@pytest.fixture(scope="module")
def lattices():
    """tests/test_runtime.py's governed lattice (gc2t_np 64x64 and
    64x256 over four rungs): the port's, and the reference's under x64
    and outside it."""
    cfgs = [BankConfig(w, n, cell="gc2t_np") for w, n in GOV_CFGS]
    ref_cfgs = [RefBankConfig(w, n, cell="gc2t_np") for w, n in GOV_CFGS]
    got = dse_batch.evaluate_vdd_lattice(cfgs, GOV_SCALES, device="cpu")
    wants = ref_runs(lambda: ref_dse_batch.evaluate_vdd_lattice(
        ref_cfgs, GOV_SCALES))
    return got, wants


def govern(mod, lat, pi, n_banks, traffics, **kw):
    gov = mod.VddGovernor(lat, pi, n_banks, **kw)
    for t in traffics:
        gov.observe(mod.Traffic(*t))
    return gov


def assert_governed(lattices, pi, n_banks, traffics, policy=(), **kw):
    """The port's governor against the reference's two lattices on the
    same traffic windows (tuples of Traffic fields): every Decision, and
    the total energy. Returns the port's governor."""
    lat, (want_lat, plain_lat) = lattices
    got = govern(rt, lat, pi, n_banks, traffics,
                 policy=rt.GovernorPolicy(*policy), **kw)
    wants = [govern(ref_rt, w, pi, n_banks, traffics,
                    policy=ref_rt.GovernorPolicy(*policy), **kw)
             for w in (want_lat, plain_lat)]
    assert_json(as_json([dataclasses.asdict(d) for d in got.decisions]),
                *(as_json([dataclasses.asdict(d) for d in w.decisions])
                  for w in wants))
    np.testing.assert_allclose(got.total_energy_j, wants[1].total_energy_j,
                               rtol=2e-6)
    return got


def test_governor_up_down_dwell(lattices):
    """First window calibrates the boot rung; bursts up-switch
    immediately; quiet windows only down-switch after the dwell."""
    lat = lattices[0]
    cap0 = rt.VddGovernor(lat, 0, 2).capacity_hz(0)
    quiet = (cap0 / 4, 1e-6, 1e-5, cap0 / 4 * 1e-5)
    burst = (cap0 * 2, 1e-6, 1e-5, cap0 * 2 * 1e-5)
    gov = assert_governed(lattices, 0, 2,
                          [quiet, burst, quiet, quiet, quiet],
                          policy=(1.25, 1.6, 1))
    vis = [d.vi for d in gov.decisions]
    assert vis[0] == 0 and vis[1] > 0 and vis[2] == vis[1] and vis[3] == 0
    assert [d.switched for d in gov.decisions] == \
        [False, True, False, True, False]


def test_governor_hysteresis_band_no_flap(lattices):
    lat = lattices[0]
    pol = rt.GovernorPolicy(headroom=1.25, down_headroom=1.6)
    cap0 = rt.VddGovernor(lat, 0, 2).capacity_hz(0)
    edge = (cap0 / 1.4, 1e-6, 1e-5, cap0 / 1.4 * 1e-5)
    probe = rt.VddGovernor(lat, 0, 2, pol)
    assert probe.admissible(0, rt.Traffic(*edge), margin=pol.headroom)
    assert probe.capacity_hz(0) < pol.down_headroom * edge[0]
    gov = assert_governed(lattices, 0, 2, [edge] * 5, policy=(1.25, 1.6),
                          start_vi=1)
    assert all(d.vi == 1 for d in gov.decisions)
    assert not any(d.switched for d in gov.decisions)


def test_forbidden_retention_point(lattices):
    """gc2t_np 64x256 at vdd 0.5 fails the refresh rule: the rung is
    forbidden, and a fixed deployment there prices at +inf, in both
    packages."""
    lat, (_, plain_lat) = lattices
    pi = 1
    ret = float(lat.retention_s[0, pi])
    assert float(lat.num_words[pi]) / ret >= 0.1 * float(lat.f_max_hz[0, pi])
    long_lived = (1e3, 10 * ret, 1e-5, 1e-2)
    gov = rt.VddGovernor(lat, pi, 1)
    assert not gov.retention_covers(0, long_lived[1])
    assert not gov.admissible(0, rt.Traffic(*long_lived))
    assert gov.target(rt.Traffic(*long_lived)) != 0
    assert rt.replay_fixed(lat, pi, 1, [rt.Traffic(*long_lived)], 0) == \
        ref_rt.replay_fixed(plain_lat, pi, 1,
                            [ref_rt.Traffic(*long_lived)], 0) == math.inf
    assert rt.VddGovernor(lat, 0, 1).retention_covers(0, long_lived[1])
    assert_governed(lattices, pi, 1, [long_lived] * 2)


def test_energy_accounting(lattices):
    lat, (want_lat, plain_lat) = lattices
    gov = rt.VddGovernor(lat, 0, 3)
    ret = float(lat.retention_s[2, 0])
    short = rt.Traffic(1e6, ret / 2, 1e-4, 100.0)
    longl = rt.Traffic(1e6, ret * 10, 1e-4, 100.0)
    e_dyn, e_leak, e_ref = gov.energy_at(2, short)
    assert e_dyn == pytest.approx(100.0 * float(lat.e_read_j[2, 0]))
    assert e_leak == pytest.approx(3 * float(lat.leakage_w[2, 0]) * 1e-4)
    assert e_ref == 0.0
    _, _, e_ref2 = gov.energy_at(2, longl)
    assert e_ref2 == pytest.approx(3 * float(lat.refresh_w[2, 0]) * 1e-4)
    for t in (short, longl):
        got = gov.energy_at(2, t)
        want = ref_rt.VddGovernor(want_lat, 0, 3).energy_at(
            2, ref_rt.Traffic(*dataclasses.astuple(t)))
        plain = ref_rt.VddGovernor(plain_lat, 0, 3).energy_at(
            2, ref_rt.Traffic(*dataclasses.astuple(t)))
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
        np.testing.assert_allclose(got[2], plain[2], rtol=2e-6)


def test_refresh_interval_lengthens_as_vdd_drops(lattices):
    gov = rt.VddGovernor(lattices[0], 0, 1)
    ivals = [gov.refresh_interval_s(vi) for vi in range(4)]
    assert ivals[0] > ivals[-1] > 0


def test_traffic_from_window(replayed):
    cfg, _, _, wins, ref_cfg, ref_wins = replayed
    t = rt.traffic_from_window(wins[0], cfg)
    L = cfg.n_layers + cfg.n_enc_layers
    expect = L * wins[0].kv_row_steps * rt.kv_row_bytes(cfg) / 8.0
    assert t.accesses == pytest.approx(expect)
    assert t.read_hz == pytest.approx(expect / wins[0].duration_s)
    assert t.lifetime_s == pytest.approx(16 * STEP_TIME_S)
    for g, w in zip(wins, ref_wins):
        assert dataclasses.astuple(rt.traffic_from_window(g, cfg)) == \
            dataclasses.astuple(ref_rt.traffic_from_window(w, ref_cfg))


def test_bench_runtime_governor_matches_reference(bench_windows):
    """benchmarks/bench_runtime.py's governed macro (gc2t_np 64x64 over
    its seven-rung ladder, banks sized to the peak window) on the
    port's windows and lattice: every decision and every fixed rung's
    energy against the reference's on its own; the governor beats
    every fixed rung, as the benchmark requires."""
    cfg, got_wins, ref_cfg, want_wins = bench_windows
    sweep = dict(cells=("gc2t_np",), word_sizes=(64,), num_words=(64,),
                 wwlls=(False,))
    lat = api.Session(device="cpu").vdd_lattice(api.SweepQuery(**sweep),
                                                 LADDER)
    wants = ref_runs(lambda: ref_api.Session().vdd_lattice(
        ref_api.SweepQuery(**sweep), LADDER))
    traffics = {k: [dataclasses.astuple(rt.traffic_from_window(w, cfg))
                    for w in ws] for k, ws in got_wins.items()}
    for k, ws in want_wins.items():
        assert traffics[k] == [dataclasses.astuple(
            ref_rt.traffic_from_window(w, ref_cfg)) for w in ws]
    peak = max(t[0] for ts in traffics.values() for t in ts)
    n_banks = math.ceil(1.25 * peak / float(lat.f_max_hz[-1, 0]))
    gov_total, fixed_totals = 0.0, np.zeros(len(LADDER))
    for ts in traffics.values():
        gov = assert_governed((lat, wants), 0, n_banks, ts)
        gov_total += gov.total_energy_j
        for vi in range(len(LADDER)):
            got = rt.replay_fixed(lat, 0, n_banks,
                                  [rt.Traffic(*t) for t in ts], vi)
            want = ref_rt.replay_fixed(wants[1], 0, n_banks,
                                       [ref_rt.Traffic(*t) for t in ts], vi)
            assert math.isinf(got) == math.isinf(want)
            if not math.isinf(want):
                np.testing.assert_allclose(got, want, rtol=2e-6)
            fixed_totals[vi] += got
    assert (gov_total < fixed_totals).all()


def test_low_rung_retention_conditioning():
    """The measured co-design's lattice (gc2t_np and gc2t_nn over the
    bench's seven-rung ladder): float32 retention is ill-conditioned at
    vdd x0.5, where the reference's own x64 and plain runs differ by more
    than 1e-5 (less than 1e-6 on every other rung). The port's CPU run is
    held to the reference's plain run at 2e-6 from x0.6 up and at 1e-4
    at x0.5, the limits chip_smoke.py holds the card to."""
    from repro.core import dse as ref_dse
    from repro_torch.core import dse
    cells = ("gc2t_np", "gc2t_nn")
    want, plain = ref_runs(lambda: ref_dse_batch.evaluate_vdd_lattice(
        ref_dse.lattice_configs(cells=cells), LADDER))
    got = dse_batch.evaluate_vdd_lattice(dse.lattice_configs(cells=cells),
                                         LADDER, device="cpu")

    def rel(a, b):
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(a == b, 0.0,
                            np.abs(a - b) / np.abs(b)).max(axis=1)

    ref_spread = rel(want.retention_s, plain.retention_s)
    assert ref_spread[0] > 1e-5 and (ref_spread[1:] < 1e-6).all()
    port = rel(got.retention_s, plain.retention_s)
    assert port[0] < 1e-4 and (port[1:] < 2e-6).all(), port
