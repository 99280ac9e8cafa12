"""Port parity: the compile service (`repro_torch.launch.compile_service`),
the fault injector (`repro_torch.testing.faults`) and the fleet
(`repro_torch.launch.fleet`) against the JAX reference, on the CPU.

Service responses are held to the reference service's on the same
request lines: `ok` flags, errors and waves equal, results through
`assert_json` (tests/test_torch_codesign.py: retention-independent
fields 1e-12 of the reference under x64, retention-dependent ones 2e-6
of the reference outside it). Fault decisions are a pure SHA-256 roll
of (seed, salt, kind, key), so the port's equal the reference's. Fleet
workers are subprocesses started with `--device cpu`; every fleet run
has a time limit (`Fleet.run(timeout_s=)`, after which every unresolved
request is quarantined) and the test checks the wall against it.
"""
import json
import os
import threading
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import pytest  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.launch import compile_service as ref_cs  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.api import ArtifactStore, Session, SweepQuery  # noqa: E402
from repro_torch.api.leases import LeaseManager  # noqa: E402
from repro_torch.api.queries import Query  # noqa: E402
from repro_torch.core import dse_batch  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.launch import compile_service as cs  # noqa: E402
from repro_torch.launch.compile_service import CompileService  # noqa: E402
from repro_torch.launch.fleet import Fleet  # noqa: E402
from repro_torch.testing.faults import FaultInjector, FaultSpec  # noqa: E402,E501
from test_torch_codesign import as_json, assert_json, ref_runs  # noqa: E402

TINY = SweepQuery(cells=("gc2t_nn",), word_sizes=(8,), num_words=(16,),
                  write_vts=(None,), wwlls=(False,))
RUN_LIMIT_S = 120.0
# tests/test_executor.py's service requests
EXECUTOR_REQS = [
    {"id": "a", "tenant": "t1",
     "query": {"type": "sweep", "cells": ["gc2t_nn"],
               "word_sizes": [16, 32], "num_words": [16, 32]}},
    {"id": "b", "tenant": "t2",
     "query": {"type": "match",
               "demands": [{"name": "d", "level": "L1",
                            "read_freq_hz": 1e6, "lifetime_s": 1e-9}],
               "sweep": {"cells": ["gc2t_nn"], "word_sizes": [16, 32],
                         "num_words": [16, 32]}}},
    {"id": "c", "tenant": "t2", "query": {"type": "sweep",
                                          "fidelity": "spice"}},
    {"id": "d", "tenant": "t1", "query": {"type": "warp"}},
]


def _tiny_spec(num_words=16, ident="r0", tenant="t0"):
    return {"id": ident, "tenant": tenant, "query": {
        "type": "sweep", "cells": ["gc2t_nn"], "word_sizes": [8],
        "num_words": [num_words], "write_vts": [None], "wwlls": [False]}}


def fleet_mix():
    """benchmarks/bench_fleet.py's smoke workload (4 tenants: sweep,
    match, codesign and unique per tenant, then the poison request),
    with one compile request and the bad requests of tests/test_executor.py
    added."""
    nw, archs = (16, 32, 64), ["qwen2-0.5b", "llama3.2-1b"]
    shared = {"cells": ["gc2t_nn", "gc2t_osos"], "word_sizes": [16, 32],
              "num_words": list(nw)}
    reqs = []
    for i in range(4):
        t = f"t{i}"
        reqs.append({"id": f"{t}-sweep", "tenant": t, "query": {
            "type": "sweep", "cells": shared["cells"],
            "word_sizes": shared["word_sizes"],
            "num_words": list(nw[:2 + i % max(1, len(nw) - 2)])}})
        reqs.append({"id": f"{t}-match", "tenant": t, "query": {
            "type": "match",
            "demands": [
                {"name": f"{t}-act", "level": "L1",
                 "read_freq_hz": 2.0e8 * (1 + i), "lifetime_s": 2.0e-6},
                {"name": f"{t}-kv", "level": "L2",
                 "read_freq_hz": 4.0e8 * (1 + i), "lifetime_s": 1.0e-3,
                 "capacity_bits": 1 << 20}],
            "sweep": shared}})
        reqs.append({"id": f"{t}-codesign", "tenant": t, "query": {
            "type": "codesign",
            "profiles": [{"arch": archs[i % len(archs)],
                          "shape": "decode_32k"}],
            "vdd_scales": [0.85, 1.0], "sweep": shared}})
        reqs.append({"id": f"{t}-unique", "tenant": t, "query": {
            "type": "sweep", "cells": ["gc2t_nn"], "word_sizes": [8],
            "num_words": [nw[i % len(nw)]], "write_vts": [None],
            "wwlls": [i % 2 == 1]}})
    reqs.append({"id": "POISON-req", "tenant": "chaos", "query": {
        "type": "sweep", "cells": ["gc2t_nn"], "word_sizes": [8],
        "num_words": [16]}})
    reqs.append({"id": "compile", "tenant": "t0", "query": {
        "type": "compile", "cfg": {"word_size": 16, "num_words": 64,
                                   "cell": "gc2t_nn"}}})
    return reqs + EXECUTOR_REQS[2:]


def strip(resp):
    """A response without its transport bookkeeping (wave walls,
    attempts)."""
    return {k: v for k, v in resp.items()
            if k not in ("wave_wall_s", "attempts")}


def assert_responses(got, wants):
    """Port responses against the reference service's two runs, by id."""
    want, plain = ({r["id"]: strip(r) for r in w} for w in wants)
    got = {r["id"]: strip(r) for r in got}
    assert got.keys() == want.keys()
    for k in want:
        assert_json(as_json(got[k]), as_json(want[k]), as_json(plain[k]), k)


def serve(svc_cls, reqs, **kw):
    svc = svc_cls(wave_size=64, **kw)
    return [json.loads(line)
            for line in svc.serve_lines(json.dumps(r) for r in reqs)], svc


# ---------------------------------------------------------------------------
# the compile service
# ---------------------------------------------------------------------------

def test_compile_service_matches_reference():
    """The mixed multi-tenant workload through one wave of the port's
    service and of the reference's."""
    reqs = fleet_mix()
    got, svc = serve(CompileService, reqs, device="cpu")
    wants = ref_runs(lambda: serve(ref_cs.CompileService, reqs)[0])
    assert_responses(got, wants)
    ok = {r["id"]: r["ok"] for r in got}
    assert sum(ok.values()) == len(reqs) - 2
    assert not ok["c"] and not ok["d"]
    st = svc.stats()
    # one co-design cube per distinct profile (two archs)
    assert st["waves"] == 1 and st["executor"]["cube_calls"] == 2
    assert st["tenants"]["t2"] == {"requests": 5, "errors": 1}


def test_compile_service_waves_and_error_isolation():
    got, svc = serve(CompileService, EXECUTOR_REQS, device="cpu")
    out = {r["id"]: r for r in got}
    assert out["a"]["ok"] and out["a"]["result"]["n_points"] == 8
    assert out["b"]["ok"] and \
        out["b"]["result"]["banks_needed"]["L1:d"] == 1
    assert not out["c"]["ok"] and "fidelity" in out["c"]["error"]
    assert not out["d"]["ok"] and "unknown query type" in out["d"]["error"]
    assert all(r["wave"] == 0 for r in out.values())
    st = svc.stats()
    assert st["tenants"]["t2"] == {"requests": 2, "errors": 1}
    assert st["executor"]["queries"] == 2   # only the two valid plans
    assert_responses(got, ref_runs(
        lambda: serve(ref_cs.CompileService, EXECUTOR_REQS)[0]))


def test_compile_service_bad_json_line_and_device():
    svc = CompileService(wave_size=4, device="cpu")
    (resp,) = map(json.loads, svc.serve_lines(["{not json"]))
    assert not resp["ok"] and "bad request line" in resp["error"]
    assert svc.session.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown query type"):
        cs.parse_query({"type": "warp"})
    assert cs.parse_query(EXECUTOR_REQS[0]["query"]) == \
        SweepQuery(cells=("gc2t_nn",), word_sizes=(16, 32),
                   num_words=(16, 32))


@pytest.mark.parametrize("entry", ["service", "fleet"])
def test_cli_runs_on_the_cpu(tmp_path, entry):
    """Both launchers' CLIs with `--device cpu`: a request file in,
    response lines out, exit code 0."""
    from repro_torch.launch import fleet as fleet_mod
    src = tmp_path / "req.jsonl"
    src.write_text("\n".join(json.dumps(_tiny_spec(nw, f"r{i}"))
                             for i, nw in enumerate((16, 32))) + "\n")
    out = tmp_path / "resp.jsonl"
    argv = ["--input", str(src), "--output", str(out), "--device", "cpu"]
    if entry == "service":
        rc = cs.main(argv)
    else:
        rc = fleet_mod.main(argv + ["--spool", str(tmp_path / "spool"),
                                    "--store", str(tmp_path / "store"),
                                    "--workers", "1"])
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert rc == 0 and [r["id"] for r in resp] == ["r0", "r1"]
    assert all(r["ok"] and r["result"]["n_points"] == 1 for r in resp)


def test_drain_isolates_serialization_failure(monkeypatch):
    class _BadResult:
        def as_dict(self):
            raise RuntimeError("unserializable result")

    class _BadQuery(Query):
        def run(self, session):
            return _BadResult()

    real_parse = cs.parse_query
    monkeypatch.setattr(
        cs, "parse_query",
        lambda spec, tech: _BadQuery() if spec.get("type") == "boom"
        else real_parse(spec, tech))
    svc = CompileService(wave_size=8, device="cpu")
    svc.submit({"id": "bad", "query": {"type": "boom"}})
    svc.submit(_tiny_spec(ident="good"))
    out = {r["id"]: r for r in svc.drain()}
    assert out["good"]["ok"]
    assert not out["bad"]["ok"]
    assert "serialization" in out["bad"]["error"]
    assert out["bad"]["retryable"] is False


def test_serve_stream_drains_partial_waves():
    svc = CompileService(wave_size=64, device="cpu")

    def slow_producer():
        yield json.dumps(_tiny_spec(ident="first"))
        time.sleep(0.4)                 # far longer than the idle window
        yield json.dumps(_tiny_spec(ident="second"))

    t0 = time.time()
    lines = list(svc.serve_stream(slow_producer(), max_wait_s=0.05))
    assert [json.loads(line)["id"] for line in lines] == ["first", "second"]
    assert all(json.loads(line)["ok"] for line in lines)
    assert svc.waves == 2
    assert time.time() - t0 < 30


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------

SPECS = ("seed=7,salt=w0,die_after_puts=2,poison=POISON",
         "seed=7,salt=w1,tear_rate=0.4,corrupt_rate=0.3,eval_fail_rate=0.3,"
         "eval_slow_rate=0.3,slow_s=0.05,poison=POISON",
         "seed=3,tear_rate=1.0", "")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_decisions_equal_reference(spec):
    got, want = FaultSpec.parse(spec), ref_faults.FaultSpec.parse(spec)
    assert got.encode() == want.encode()
    assert FaultSpec.parse(got.encode()) == got
    assert got.any_faults() == want.any_faults()
    gi, wi = FaultInjector(got), ref_faults.FaultInjector(want)
    keys = [f"points-{i:04x}" for i in range(200)] + \
        [f"evaluate_batch:{i}" for i in range(50)]
    for kind, rate in (("tear", got.tear_rate),
                       ("corrupt", got.corrupt_rate),
                       ("fail", got.eval_fail_rate),
                       ("slow", got.eval_slow_rate), ("x", 0.5)):
        assert [gi._roll(kind, k) for k in keys] == \
            [wi._roll(kind, k) for k in keys]
        # twice: a transient fault fires at most once per (kind, key)
        for _ in range(2):
            assert [gi._fire_once(kind, k, rate) for k in keys] == \
                [wi._fire_once(kind, k, rate) for k in keys]
    req = {"id": "POISON-req"}
    for inj in (gi, wi):
        if "poison" in spec:
            with pytest.raises(RuntimeError, match="poison"):
                inj.check_request(req)
        else:
            inj.check_request(req)
    with pytest.raises(ValueError):
        FaultSpec.parse("bogus=1")


def _faults_until_success(injector_cls, spec_cls, session_cls, sweep_cls,
                          target):
    """Run one query under an injector whose every evaluation fails once:
    the InjectedFault messages the query raised, in order, until it
    succeeds, and the number of faults fired."""
    tiny = dict(cells=("gc2t_nn",), word_sizes=(16,), num_words=(16,),
                wwlls=(False,))
    seen = []
    with injector_cls(spec_cls(eval_fail_rate=1.0)).install(
            evals=True) as inj:
        s = session_cls(device="cpu") if session_cls is Session \
            else session_cls()
        if target == "evaluate_vdd_lattice":
            run = lambda: s.vdd_lattice(sweep_cls(**tiny), (0.9, 1.0))
        elif target == "characterize":
            run = lambda: s.run(sweep_cls(**tiny, fidelity="transient",
                                          sim_steps=20))
        else:
            run = lambda: s.run(sweep_cls(**tiny))
        for _ in range(5):
            try:
                run()
                break
            except RuntimeError as e:
                seen.append(str(e))
    return seen, inj.counts["eval_faults"]


@pytest.mark.parametrize("target", ["evaluate_batch", "evaluate_vdd_lattice",
                                    "characterize"])
def test_armed_injector_fires_inside_the_port(target):
    """With evals armed the injector patches the port's modules, and the
    executor calls them through those modules: each evaluation the query
    reaches fails once (evaluate_batch reaches evaluate_vdd_lattice, a
    transient sweep both and then characterize), the query's future
    carries the InjectedFault, and a retry after the last one succeeds.
    In a transient sweep the characterization fails in the first wave
    too, behind the points node's error. The faults, keys included, are
    the reference's on the same query."""
    got, fired = _faults_until_success(FaultInjector, FaultSpec, Session,
                                       SweepQuery, target)
    want = ref_runs(lambda: _faults_until_success(
        ref_faults.FaultInjector, ref_faults.FaultSpec, ref_api.Session,
        ref_api.SweepQuery, target))[0]
    assert (got, fired) == want
    assert [m.split()[1] for m in got] == {
        "evaluate_batch": ["evaluate_batch", "evaluate_vdd_lattice"],
        "evaluate_vdd_lattice": ["evaluate_vdd_lattice"],
        "characterize": ["evaluate_batch", "evaluate_vdd_lattice"]}[target]
    assert fired == len(got) + (target == "characterize")
    assert dse_batch.evaluate_batch.__module__ == dse_batch.__name__
    assert char_batch.characterize.__module__ == char_batch.__name__


def test_store_detects_torn_write_and_corruption(tmp_path):
    store = ArtifactStore(str(tmp_path))
    with FaultInjector(FaultSpec(tear_rate=1.0)).install(store=store) as inj:
        store.put("points-abc", {"rows": [1.5, 2.5]})
        assert inj.counts["torn_writes"] == 1
    assert store.get("points-abc") is None          # miss, not garbage
    assert store.corrupt == 1
    store.put("points-abc", {"rows": [1.5, 2.5]})   # recompute repairs
    with FaultInjector(FaultSpec(corrupt_rate=1.0)).install(store=store) \
            as inj:
        assert store.get("points-abc") is None
        assert inj.counts["corrupted_reads"] == 1
    assert store.corrupt == 2 and not store.has("points-abc")


def test_executor_heals_torn_artifact(tmp_path):
    d = str(tmp_path)
    store = ArtifactStore(d)
    with FaultInjector(FaultSpec(tear_rate=1.0)).install(store=store):
        t1 = Session(store=store, device="cpu",
                     leases=LeaseManager(d, heartbeat=False)).run(TINY)
    s2 = Session(store=d, leases=True, device="cpu")
    t2 = s2.run(TINY)                   # torn artifact -> heal recompute
    assert s2.store.corrupt == 1
    log = LeaseManager.read_eval_log(d)
    assert sum(c.get("heal", 0) for c in log.values()) == 1
    assert LeaseManager.duplicate_evals(d) == {}
    for a, b in zip(t1.points, t2.points):
        assert a.t_read_s == b.t_read_s and a.area_um2 == b.area_um2


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def run_fleet(tmp_path, reqs, **kw):
    kw.setdefault("device", "cpu")
    t0 = time.monotonic()
    with Fleet(str(tmp_path / "spool"), str(tmp_path / "store"),
               **kw) as fleet:
        resp = fleet.run(reqs, timeout_s=RUN_LIMIT_S)
        ready = fleet.ready()
    assert time.monotonic() - t0 < RUN_LIMIT_S + 30
    assert fleet.counters["run_timeouts"] == 0
    return fleet, resp, ready


def test_fleet_degrades_to_inline_when_spawn_fails(tmp_path):
    fleet, resp, ready = run_fleet(
        tmp_path, [_tiny_spec(ident="a"), _tiny_spec(ident="b")],
        n_workers=2, python="/nonexistent/python", max_attempts=2)
    assert fleet.degraded and ready == {}
    assert all(r["ok"] for r in resp)
    assert [r["id"] for r in resp] == ["a", "b"]
    assert fleet.counters["spawn_failures"] == 2
    assert fleet._inline_svc.session.device.type == "cpu"
    assert LeaseManager.duplicate_evals(str(tmp_path / "store")) == {}


def test_fleet_quarantines_poison_inline(tmp_path):
    _, (poison, fine), _ = run_fleet(
        tmp_path, [_tiny_spec(ident="POISON-1"), _tiny_spec(ident="fine")],
        n_workers=1, python="/nonexistent/python", max_attempts=3,
        backoff_s=0.01, fault_specs={"inline": "poison=POISON"})
    assert not poison["ok"] and poison["quarantined"]
    assert poison["attempts"] == 3
    assert fine["ok"] and "quarantined" not in fine


def test_fleet_rejects_invalid_query_without_retry(tmp_path):
    _, resp, _ = run_fleet(
        tmp_path, [{"id": "bad", "query": {"type": "nonsense"}}],
        n_workers=1, python="/nonexistent/python", max_attempts=5)
    assert not resp[0]["ok"] and resp[0]["attempts"] == 1
    assert "quarantined" not in resp[0]


def test_fleet_survives_worker_killed_mid_wave(tmp_path):
    """Two `--device cpu` workers, w0 hard-killed after its first
    publish: every response equals the in-process service's, with no
    duplicate evaluation; both workers reported their cold start."""
    reqs = [_tiny_spec(nw, f"r{i}", f"t{i % 2}")
            for i, nw in enumerate((16, 32, 16, 64, 32))]
    base = {r["id"]: r for r in serve(CompileService, reqs, device="cpu")[0]}
    fleet, resp, ready = run_fleet(
        tmp_path, reqs, n_workers=2, lease_ttl_s=2.0, backoff_s=0.2,
        max_attempts=5, deadline_s=120.0,
        fault_specs={"w0": "die_after_puts=1"})
    stats = fleet.stats()
    assert all(r["ok"] for r in resp) and not fleet.degraded
    assert stats["worker_deaths"] == 1 and stats["retries"] >= 1
    assert LeaseManager.duplicate_evals(str(tmp_path / "store")) == {}
    for r in resp:
        assert json.dumps(r["result"], sort_keys=True) == \
            json.dumps(base[r["id"]]["result"], sort_keys=True)
    assert set(ready) == {"w0", "w1"}
    for wid, rec in ready.items():
        assert rec["device"] == "cpu" and rec["pid"] > 0
        assert rec["spawn_to_ready_s"] >= rec["cold_start"]["torch_import_s"]
    assert "w1" in stats["workers"] and "w0" not in stats["workers"]


def test_fleet_chaos_matches_the_service(tmp_path):
    """bench_fleet.py's chaos run on the smoke mix: w0 dies after its
    second publish, w1 tears, corrupts, fails and stalls; the poison
    request is quarantined after max_attempts and every other response
    equals the single service's."""
    reqs = fleet_mix()
    base = {r["id"]: strip(r)
            for r in serve(CompileService, reqs, device="cpu")[0]}
    chaos = {"w0": "seed=7,salt=w0,die_after_puts=2,poison=POISON",
             "w1": "seed=7,salt=w1,tear_rate=0.4,corrupt_rate=0.3,"
                   "eval_fail_rate=0.3,eval_slow_rate=0.3,slow_s=0.05,"
                   "poison=POISON",
             "inline": "poison=POISON"}
    fleet, resp, _ = run_fleet(
        tmp_path, reqs, n_workers=2, wave_size=len(reqs) // 2 + 1,
        max_attempts=5, backoff_s=0.2, lease_ttl_s=2.0,
        fault_specs=chaos)
    by_id = {r["id"]: r for r in resp}
    poison = by_id.pop("POISON-req")
    assert not poison["ok"] and poison["quarantined"]
    assert poison["attempts"] == 5
    for k, r in by_id.items():
        b = dict(base[k])
        if b["ok"]:
            assert strip(r) | {"wave": b["wave"]} == b
        else:
            assert r["error"] == b["error"]
    stats = fleet.stats()
    assert stats["worker_deaths"] >= 1 and stats["retries"] > 0
    assert stats["evals"]["duplicates"] == {}


def test_lease_single_winner_under_threads(tmp_path):
    mgr = LeaseManager(tmp_path, ttl_s=30.0, heartbeat=False)
    wins, barrier = [], threading.Barrier(16)

    def race():
        barrier.wait()
        lease = mgr.try_claim("points-abc")
        if lease is not None:
            wins.append(lease)

    threads = [threading.Thread(target=race) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1
    assert os.path.isdir(tmp_path / "_leases")
