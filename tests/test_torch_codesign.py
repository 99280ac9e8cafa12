"""Port parity: the workload profiler (`repro_torch.workloads`,
`repro_torch.launch.roofline`) and `CoDesignQuery` through the port's
Session against the JAX reference, on the CPU.

Limits:
  * Profile fields and roofline terms 1e-12 relative (the same float64
    arithmetic on equal parameter counts), parameter counts equal;
  * reports (here, and in tests/test_torch_runtime.py and
    tests/test_torch_fleet.py through `assert_json`): the reference runs
    twice, its group-constant memo emptied around each run. Under x64 it
    gives every choice, count and verdict (equal) and every
    retention-independent float (1e-12 relative). Outside x64 it gives
    the retention-dependent fields (`RET_KEYS`: retention, refresh and
    standby power, and the energies that integrate standby power over a
    step) at 2e-6, as tests/test_torch_dse.py holds them: the port's
    retention is float32, like the reference's own flows, and under x64
    the reference's retention moves by up to 1.8e-6. A compile report's
    `retention` section is retention-dependent as a whole
    (tests/test_torch_compiler.py).
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

import repro.api as ref_api  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import dse_batch as ref_dse_batch  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.workloads import profiler as ref_prof  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402
from repro_torch.core.multibank import banks_needed  # noqa: E402
from repro_torch.core.techfile import SYN40  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.workloads import profiler as prof  # noqa: E402
from repro_torch.workloads import Profile, profile_arch  # noqa: E402

RTOL_ANALYTIC = 1e-12
RTOL_RETENTION = 2e-6
RET_KEYS = frozenset({"retention_s", "refresh_w", "standby_w",
                      "energy_per_inference_j",
                      "total_energy_per_inference_j", "refresh_interval_s",
                      "e_refresh_j", "energy_j", "retention"})
# the four dense archs of benchmarks/bench_fleet.py's full workload
DENSE_ARCHS = ("qwen2-0.5b", "llama3.2-1b", "llama3.2-3b", "minicpm-2b")
SMALL = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16, 32),
             num_words=(16, 32))
SCALES = (0.75, 1.0, 1.2)
# the README's co-design quickstart query (default 96-point lattice)
README_ARCHS = ("qwen2-0.5b", "llama3.2-1b")
# the moe and hybrid archs the model stack now builds (both subquadratic,
# so both also run long_500k)
MOE_HYBRID_ARCHS = ("mixtral-8x7b", "zamba2-2.7b")
# the ssm, audio and vlm archs (xlstm-1.3b is subquadratic, so it also
# runs long_500k)
SSM_AUDIO_VLM_ARCHS = ("xlstm-1.3b", "whisper-large-v3", "internvl2-1b")
README_SCALES = (0.7, 0.85, 1.0, 1.15)


def ref_runs(fn):
    """`fn()` of the reference under x64 and outside it, its
    group-constant memo (which ignores the x64 state) emptied around
    each run: (x64 result, plain result)."""
    out = []
    for x64 in (True, False):
        ref_dse_batch._CONSTS_CACHE.clear()
        try:
            with jax.enable_x64(x64):
                out.append(fn())
        finally:
            ref_dse_batch._CONSTS_CACHE.clear()
    return tuple(out)


def as_json(obj):
    return json.loads(json.dumps(obj, default=str))


def assert_json(got, want, plain=None, key="", ret=False):
    """`got` against the reference's `want` (under x64) and `plain`
    (outside x64; None where the two cannot differ), walking dicts and
    lists; `ret` marks a retention-dependent section. The limits are the
    module docstring's."""
    ret = ret or key in RET_KEYS
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), key
        for k in want:
            assert_json(got[k], want[k],
                        None if plain is None else plain[k], k, ret)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json(g, w, None if plain is None else plain[i], key,
                        ret)
    elif isinstance(want, float):
        if ret and plain is not None:
            np.testing.assert_allclose(got, plain, rtol=RTOL_RETENTION,
                                       atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL_ANALYTIC,
                                       atol=0, err_msg=key)
    else:
        assert got == want, key


def assert_report(got, wants):
    """A port report (`as_dict()`) against the reference's two runs."""
    want, plain = (as_json(w.as_dict()) for w in wants)
    assert_json(as_json(got.as_dict()), want, plain)


def ref_profiles(archs, shape="decode_32k"):
    return tuple(ref_prof.profile_arch(a, shape) for a in archs)


# ---------------------------------------------------------------------------
# roofline and profiler
# ---------------------------------------------------------------------------

def test_roofline_matches_reference():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == \
        (ref_rl.PEAK_FLOPS, ref_rl.HBM_BW, ref_rl.LINK_BW)
    for analysis in ({"flops": 3e14, "mem_bytes": 2e11,
                      "collective_wire_bytes": 1e9},
                     {"flops": 1e12, "mem_bytes": 9e11,
                      "collective_wire_bytes": 6e10},
                     {"flops": 0.0, "mem_bytes": 0.0,
                      "collective_wire_bytes": 0.0}):
        got = rl.derive(analysis, n_chips=256, model_flops=5e16).as_dict()
        want = ref_rl.derive(analysis, n_chips=256,
                             model_flops=5e16).as_dict()
        assert_json(got, want)
    for arch in DENSE_ARCHS:
        for name, shape in SHAPES.items():
            assert rl.model_flops_for(get_config(arch), shape) == \
                pytest.approx(ref_rl.model_flops_for(ref_get_config(arch),
                                                     REF_SHAPES[name]),
                              rel=RTOL_ANALYTIC)


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_HYBRID_ARCHS
                         + SSM_AUDIO_VLM_ARCHS)
def test_profiles_match_reference(arch):
    """Every shape of the grid: the parameter count (on the meta device,
    so nothing is allocated) equals the reference's, and every Profile
    field is within 1e-12."""
    n = RefModel(ref_get_config(arch)).param_count(active_only=True)
    assert rl.active_params(get_config(arch)) == n
    for shape in SHAPES:
        got, want = profile_arch(arch, shape), ref_prof.profile_arch(arch,
                                                                     shape)
        assert isinstance(got, Profile)
        assert_json(dataclasses.asdict(got), dataclasses.asdict(want))
        assert [dataclasses.astuple(d) for d in got.demands()] == \
            pytest.approx([dataclasses.astuple(d) for d in want.demands()],
                          rel=RTOL_ANALYTIC)
        stepped = prof.profile_config(get_config(arch), SHAPES[shape],
                                      n_devices=8, step_time_s=2e-3)
        assert_json(dataclasses.asdict(stepped), dataclasses.asdict(
            ref_prof.profile_config(ref_get_config(arch),
                                    REF_SHAPES[shape], n_devices=8,
                                    step_time_s=2e-3)))


def test_profiler_helpers_match_reference(tmp_path):
    for rates in ((1e15, 3e12), (2.5e13, 0.0), (0.0, 8e11)):
        assert prof.hierarchy_split(*rates) == \
            pytest.approx(ref_prof.hierarchy_split(*rates),
                          rel=RTOL_ANALYTIC)
    for arch in ("qwen2-0.5b", "minicpm-2b"):
        for name in SHAPES:
            assert prof._bytes_classes(get_config(arch), SHAPES[name]) == \
                pytest.approx(ref_prof._bytes_classes(
                    ref_get_config(arch), REF_SHAPES[name]),
                    rel=RTOL_ANALYTIC)
    # dry-run records: only the (arch, shape) pair of a *pod256.json
    # file is read
    for arch, shape in (("qwen2-0.5b", "decode_32k"),
                        ("llama3.2-1b", "train_4k")):
        (tmp_path / f"{arch}_{shape}_pod256.json").write_text(
            json.dumps({"arch": arch, "shape": shape, "step_s": 1.0}))
    (tmp_path / "ignored_pod8.json").write_text("{}")
    got = prof.profile_from_dryrun(str(tmp_path))
    want = ref_prof.profile_from_dryrun(str(tmp_path))
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    assert [dataclasses.astuple(d) for d in prof.demands_table(got)] == \
        [dataclasses.astuple(d) for d in ref_prof.demands_table(want)]


def test_profile_demands_units():
    """tests/test_codesign.py's unit contract on the port's Profile."""
    p = profile_arch("qwen2-0.5b", "decode_32k")
    ds = p.demands()
    assert [d.level for d in ds] == ["L1", "L2"]
    for d in ds:
        assert isinstance(d, dse.Demand)
        # per-bank read rates: positive, finite, and nowhere near the
        # AGGREGATE chip feed (> 1e14 req/s), i.e. split over banks
        assert 0 < d.read_freq_hz < 1e11
        assert 0 < d.lifetime_s < 1e6
        assert d.name == f"{p.arch}:{p.shape}"
    assert ds[1].read_freq_hz > ds[0].read_freq_hz   # shared L2 (Fig 9)
    assert ds[1].lifetime_s >= ds[0].lifetime_s
    assert hash(p) == hash(profile_arch("qwen2-0.5b", "decode_32k"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.l1_read_hz = 0.0


@pytest.mark.parametrize("arch", ["xlstm-1.3b"])
def test_nondense_arch_raises_naming_item_13(arch):
    """A non-dense arch profiles like the reference (its serving model is
    ported), and its training (item 13c, ported since; held to the
    reference in tests/test_torch_training_families.py) runs: a finite
    loss on the reduced config."""
    assert_json(dataclasses.asdict(profile_arch(arch, "decode_32k")),
                dataclasses.asdict(ref_prof.profile_arch(arch,
                                                         "decode_32k")))
    import torch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    loss, met = Model(cfg, device="cpu").loss({"tokens": tok,
                                               "labels": tok})
    assert bool(torch.isfinite(loss)) and float(met["aux"]) == 0.0


@pytest.mark.parametrize("arch,active,total", [
    ("mixtral-8x7b", 12_879_925_248, 46_702_792_704),
    ("zamba2-2.7b", 2_422_532_000, 2_422_532_000)])
def test_moe_and_hybrid_profiles(arch, active, total):
    """The active parameter count on the meta device is the reference's
    (`ModelConfig.active_param_count()`), and both archs profile at
    decode_32k and long_500k, equal to the reference's profiles."""
    cfg = get_config(arch)
    assert cfg.subquadratic
    assert rl.active_params(cfg) == active == \
        ref_get_config(arch).active_param_count()
    assert cfg.param_count() == total
    for shape in ("decode_32k", "long_500k"):
        assert_json(dataclasses.asdict(profile_arch(arch, shape)),
                    dataclasses.asdict(ref_prof.profile_arch(arch, shape)))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_codesign_query_over_moe_and_hybrid(shape):
    """`CoDesignQuery` over mixtral-8x7b and zamba2-2.7b through the
    port's Session against the reference's, on a small lattice."""
    s = api.Session(device="cpu")
    got = s.run(api.CoDesignQuery(
        tuple(profile_arch(a, shape) for a in MOE_HYBRID_ARCHS),
        api.SweepQuery(**SMALL), vdd_scales=SCALES))
    wants = ref_runs(lambda: ref_api.Session().run(ref_api.CoDesignQuery(
        ref_profiles(MOE_HYBRID_ARCHS, shape), ref_api.SweepQuery(**SMALL),
        vdd_scales=SCALES)))
    assert_report(got, wants)
    assert s.executor.stats["cube_calls"] == 1
    assert len(got.plans) == 2


@pytest.mark.parametrize("arch,active", [
    ("xlstm-1.3b", 2_197_576_016), ("whisper-large-v3", 2_020_628_480),
    ("internvl2-1b", 493_780_992)])
def test_ssm_audio_and_vlm_profiles(arch, active):
    """The parameter count on the meta device is the reference's, and
    each arch profiles at every shape of its grid (xlstm at long_500k
    too), equal to the reference's profiles."""
    cfg = get_config(arch)
    assert rl.active_params(cfg) == active == \
        ref_get_config(arch).active_param_count() == cfg.param_count()
    shapes = [s.name for s in cfg.shapes()]
    assert ("long_500k" in shapes) == (arch == "xlstm-1.3b")
    for shape in shapes:
        assert_json(dataclasses.asdict(profile_arch(arch, shape)),
                    dataclasses.asdict(ref_prof.profile_arch(arch, shape)))


def test_codesign_query_over_ssm_audio_and_vlm():
    """`CoDesignQuery` over xlstm-1.3b, whisper-large-v3 and internvl2-1b
    at decode_32k through the port's Session against the reference's, on
    a small lattice."""
    s = api.Session(device="cpu")
    got = s.run(api.CoDesignQuery(
        tuple(profile_arch(a, "decode_32k") for a in SSM_AUDIO_VLM_ARCHS),
        api.SweepQuery(**SMALL), vdd_scales=SCALES))
    wants = ref_runs(lambda: ref_api.Session().run(ref_api.CoDesignQuery(
        ref_profiles(SSM_AUDIO_VLM_ARCHS), ref_api.SweepQuery(**SMALL),
        vdd_scales=SCALES)))
    assert_report(got, wants)
    assert s.executor.stats["cube_calls"] == 1
    assert len(got.plans) == 3


def test_plan_memory_matches_reference():
    """`plan_memory` on a profile, over the default lattice swept on the
    CPU, against the reference's over its own default sweep."""
    got = prof.plan_memory(profile_arch("llama3.2-1b", "decode_32k"),
                           device="cpu")
    wants = ref_runs(lambda: ref_prof.plan_memory(
        ref_prof.profile_arch("llama3.2-1b", "decode_32k")))
    assert set(got) == {"activation_cache", "kv_state", "weight_memory"}
    assert_json(as_json(got), *(as_json(w) for w in wants))


# ---------------------------------------------------------------------------
# CoDesignQuery end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense_archs", "readme"])
def test_codesign_query_matches_reference(case):
    """`CoDesignQuery` through the port's Session against the
    reference's, on profiles each package made itself: the four dense
    archs at decode_32k over a small lattice, and the README's
    quickstart query over the default one."""
    if case == "readme":
        archs, sweep, scales = README_ARCHS, {}, README_SCALES
    else:
        archs, sweep, scales = DENSE_ARCHS, SMALL, SCALES
    s = api.Session(device="cpu")
    got = s.run(api.CoDesignQuery(tuple(profile_arch(a, "decode_32k")
                                        for a in archs),
                                  api.SweepQuery(**sweep),
                                  vdd_scales=scales))
    wants = ref_runs(lambda: ref_api.Session().run(ref_api.CoDesignQuery(
        ref_profiles(archs), ref_api.SweepQuery(**sweep),
        vdd_scales=scales)))
    assert isinstance(got, api.CoDesignReport)
    assert_report(got, wants)
    assert dict(s.executor.stats) == {"waves": 1, "queries": 1,
                                      "nodes_executed": 2, "vdd_evals": 1,
                                      "cube_calls": 1}
    assert any(p["feasible"] for p in got)


def test_codesign_query_end_to_end_and_memoized(tmp_path):
    """tests/test_codesign.py's end-to-end contract: the chosen (config,
    voltage) is macro-feasible per the port's scalar `dse.evaluate`;
    the same query is a result-cache hit; a fresh session on the store
    the first wrote evaluates nothing and reports the same."""
    profs = (profile_arch("qwen2-0.5b", "decode_32k"),)
    store = str(tmp_path / "store")
    s = api.Session(device="cpu", store=store)
    q = api.CoDesignQuery(profiles=profs, sweep=api.SweepQuery(**SMALL),
                          vdd_scales=SCALES)
    rep = s.run(q)
    assert s.run(api.CoDesignQuery(profiles=list(profs),
                                   sweep=api.SweepQuery(**SMALL),
                                   vdd_scales=SCALES)) is rep
    assert s.codesign(q) is rep
    plan = rep[f"{profs[0].arch}:{profs[0].shape}"]
    assert set(plan["levels"]) == {"L1", "L2"}
    n_feasible = 0
    for d, (lvl, e) in zip(profs[0].demands(), plan["levels"].items()):
        assert e["read_freq_hz"] == d.read_freq_hz
        if not e["feasible"]:
            continue
        n_feasible += 1
        b = e["bank"]
        dp = dse.evaluate(BankConfig(b["word_size"], b["num_words"],
                                     cell=b["cell"], wwlls=b["wwlls"],
                                     write_vt=b["write_vt"]),
                          vdd_scale=e["vdd_scale"], device="cpu")
        n = banks_needed(dp, d, capacity_bits=d.capacity_bits)
        assert e["banks_needed"] == n <= 1024
        assert e["macro_capacity_bits"] == n * dp.cfg.bits
        assert e["energy_per_inference_j"] > 0
        assert e["vdd_v"] == pytest.approx(SYN40.vdd * e["vdd_scale"])
    assert n_feasible >= 1
    d = rep.as_dict()
    assert d["n_workloads"] == 1 and d["vdd_scales"] == list(SCALES)
    fresh = api.Session(device="cpu", store=store)
    again = fresh.run(q)
    assert json.dumps(again.as_dict(), default=str) == \
        json.dumps(d, default=str)
    assert fresh.executor.stats["vdd_evals"] == 0
    assert fresh.executor.stats["store_hits"] == 1


def test_codesign_objective_and_validation():
    profs = (profile_arch("qwen2-0.5b", "decode_32k"),)
    s = api.Session(device="cpu")
    small = api.SweepQuery(**SMALL)
    e_rep = s.run(api.CoDesignQuery(profiles=profs, sweep=small,
                                    vdd_scales=SCALES, objective="energy"))
    a_rep = s.run(api.CoDesignQuery(profiles=profs, sweep=small,
                                    vdd_scales=SCALES, objective="area"))
    for rep in (e_rep, a_rep):
        for p in rep:
            for e in p["levels"].values():
                assert e["feasible"] == ("bank" in e)
    ep, apn = e_rep.plans[0], a_rep.plans[0]
    if ep["feasible"] and apn["feasible"]:
        assert apn["total_area_um2"] <= ep["total_area_um2"] + 1e-9
    with pytest.raises(ValueError):
        s.run(api.CoDesignQuery(profiles=profs, sweep=small,
                                objective="speed"))
    with pytest.raises(ValueError):
        s.run(api.CoDesignQuery(profiles=(), sweep=small))
    with pytest.raises(ValueError):
        s.run(api.CoDesignQuery(profiles=profs, sweep=dataclasses.replace(
            small, fidelity="transient")))
    # sweeps differing only in evaluation knobs share one cached lattice
    assert s.vdd_lattice(small, SCALES) is s.vdd_lattice(
        dataclasses.replace(small, batched=False, sim_steps=77), SCALES)
    assert s.executor.stats["vdd_evals"] == 1


def test_codesign_infeasible_demand_reported():
    """A profile with an impossible L2 demand still yields a plan row,
    flagged infeasible, as in the reference."""
    base = profile_arch("qwen2-0.5b", "decode_32k")
    hard = dataclasses.replace(base, l2_read_hz=1e15, kv_lifetime_s=1e6,
                               act_lifetime_s=1e6)
    rep = api.Session(device="cpu").run(api.CoDesignQuery(
        profiles=(hard,), sweep=api.SweepQuery(**SMALL), vdd_scales=SCALES,
        max_banks=4))
    plan = rep.plans[0]
    assert not plan["feasible"] and not rep.all_feasible
    assert not plan["levels"]["L2"]["feasible"]
    assert "bank" not in plan["levels"]["L2"]
    ref_hard = dataclasses.replace(
        ref_prof.profile_arch("qwen2-0.5b", "decode_32k"), l2_read_hz=1e15,
        kv_lifetime_s=1e6, act_lifetime_s=1e6)
    assert_report(rep, ref_runs(lambda: ref_api.Session().run(
        ref_api.CoDesignQuery(profiles=(ref_hard,),
                              sweep=ref_api.SweepQuery(**SMALL),
                              vdd_scales=SCALES, max_banks=4))))
