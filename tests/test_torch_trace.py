"""The port's program spans (`repro_torch.runtime.telemetry.span`) on a
tiny MoE serve on the CPU: nothing is recorded outside a profiler; under
`torch.profiler.profile` the serve path's spans appear with their parents
and counts, each is a profiler range whose start the registry's stamp
maps onto within 1 ms; greedy tokens and host syncs are the same with
spans on and off."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import CLOCK_OFFSET_NS, span, spans
from repro_torch.serving import Request, ServeEngine

PROMPT_LENS = (12, 12, 9, 12, 9)     # two admission groups, 5 requests
MAX_NEW, CHUNK = 6, 3

SERVE_SPANS = {"engine.admit", "model.prefill", "kv.pad", "kv.slot_write",
               "attn", "moe", "moe.route", "moe.dispatch", "moe.experts",
               "moe.combine", "model.decode_loop", "engine.reconcile"}


@pytest.fixture(scope="module")
def moe_model():
    torch.manual_seed(0)
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="float32", sliding_window=0)
    return cfg, Model(cfg, device="cpu", seed=0)


def _serve(cfg, model, mode="device"):
    eng = ServeEngine(cfg, model, n_slots=2, window=64, mode=mode,
                      decode_chunk=CHUNK, clock=time.perf_counter)
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPT_LENS):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=MAX_NEW))
    done, _ = eng.run()
    return {r.rid: list(r.out_tokens) for r in done}, eng.host_syncs


def _traced(cfg, model, mode="device"):
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _serve(cfg, model, mode)
    return got, spans(t0, time.perf_counter_ns()), prof


@pytest.fixture(scope="module")
def traced(moe_model):
    return _traced(*moe_model)


def test_outside_a_profiler_nothing_is_recorded(moe_model, monkeypatch):
    assert span("a") is span("b", rows=3) is telemetry._OFF
    with span("a") as s:
        assert s is telemetry._OFF

    def no_event(*a, **k):
        raise AssertionError("a span made a CUDA event outside a profiler")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    t0 = time.perf_counter_ns()
    _serve(*moe_model)
    assert spans(t0, time.perf_counter_ns()) == []


def test_serve_spans_nest_under_their_parents(moe_model, traced):
    cfg, _ = moe_model
    _, got, _ = traced
    assert {s.name for s in got} == SERVE_SPANS
    by_id = {s.id: s for s in got}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None
    want = {"engine.admit": {None}, "model.prefill": {"engine.admit"},
            "kv.pad": {"model.prefill"}, "kv.slot_write": {"engine.admit"},
            "attn": {"model.prefill", "model.decode_loop"},
            "moe": {"model.prefill", "model.decode_loop"},
            "moe.route": {"moe"}, "moe.dispatch": {"moe"},
            "moe.experts": {"moe"}, "moe.combine": {"moe"},
            "model.decode_loop": {None}, "engine.reconcile": {None}}
    for s in got:
        assert parent(s) in want[s.name], (s.name, parent(s))
        assert s.t0_ns <= s.t1_ns and s.device_s >= s.self_s >= -1e-12
    n = {k: sum(s.name == k for s in got) for k in SERVE_SPANS}
    assert n["model.prefill"] == n["engine.admit"] == n["kv.slot_write"]
    assert n["kv.pad"] == 2 * n["model.prefill"]          # K and V
    loops = [s for s in got if s.name == "model.decode_loop"]
    steps = sum(s.counts["steps"] for s in loops)
    assert all(s.counts == {"steps": CHUNK, "slots": 2} for s in loops)
    # one attention and one MoE FFN a layer, in every prefill and step
    assert n["attn"] == n["moe"] == cfg.n_layers * (n["model.prefill"]
                                                    + steps)
    for k in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert n[k] == n["moe"]


def test_admit_and_reconcile_carry_the_request_ids(traced):
    _, got, _ = traced
    admits = [s for s in got if s.name == "engine.admit"]
    rids = [r for s in admits for r in s.counts["rids"]]
    assert sorted(rids) == list(range(len(PROMPT_LENS)))
    for s in admits:
        B = len(s.counts["rids"])
        assert s.counts["B"] == B and s.counts["Bp"] == 1 << (B - 1) \
            .bit_length()
        assert s.counts["S"] == PROMPT_LENS[s.counts["rids"][0]]
    chunks = [s.counts["rids"] for s in got if s.name == "engine.reconcile"]
    assert chunks and all(chunks)
    assert set().union(*chunks) == set(range(len(PROMPT_LENS)))


def test_moe_counts_assignments_and_expert_rows(moe_model, traced):
    cfg, _ = moe_model
    _, got, _ = traced
    by_id = {s.id: s for s in got}
    for s in got:
        if s.name != "moe":
            continue
        T = s.counts["tokens"]
        C = max(1, math.ceil(T * cfg.top_k * cfg.capacity_factor
                             / cfg.n_experts))
        assert s.counts == {"tokens": T, "assignments": T * cfg.top_k,
                            "expert_rows": cfg.n_experts * C}
        up = by_id[s.parent]
        if up.name == "model.prefill":
            assert T == up.counts["rows"]
        else:
            assert T == up.counts["slots"]
    for s in got:
        if s.name == "model.prefill":
            adm = by_id[s.parent].counts
            assert s.counts == {"rows": adm["Bp"] * adm["S"]}


def test_each_span_is_a_profiler_range_on_its_clock(traced):
    _, got, prof = traced
    starts = {}
    for ev in prof.profiler.kineto_results.events():
        starts.setdefault(ev.name(), []).append(ev.start_ns())
    for s in got:
        at = s.t0_ns + CLOCK_OFFSET_NS
        assert s.name in starts, s.name
        assert min(abs(t - at) for t in starts[s.name]) < 1_000_000, s.name


@pytest.mark.parametrize("mode", ["device", "host"])
def test_greedy_tokens_and_syncs_equal_with_spans_on_and_off(moe_model,
                                                             mode):
    cfg, model = moe_model
    off = _serve(cfg, model, mode)
    on, got, _ = _traced(cfg, model, mode)
    assert on == off
    assert {"model.prefill", "kv.slot_write", "attn", "moe"} <= \
        {s.name for s in got}


def test_registry_reads_an_interval_with_self_times():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("outer", k=1):
            t_in = time.perf_counter_ns()
            with span("inner"):
                time.sleep(0.002)
            with span("inner"):
                time.sleep(0.002)
        t_end = time.perf_counter_ns()
    inside = spans(t_in, t_end)
    assert [s.name for s in inside] == ["inner", "inner"]
    whole = spans(t_in - 10**9, t_end)[-3:]
    outer = whole[0]
    assert [s.name for s in whole] == ["outer", "inner", "inner"]
    assert outer.counts == {"k": 1}
    assert all(s.parent == outer.id for s in whole[1:])
    kids = whole[1].device_s + whole[2].device_s
    assert kids >= 0.004
    assert outer.self_s == pytest.approx(outer.device_s - kids)


def test_registry_is_bounded_and_counts_what_it_drops(monkeypatch):
    import collections
    monkeypatch.setattr(telemetry, "_registry", collections.deque(maxlen=2))
    before = telemetry.spans_dropped()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with span(name):
                pass
    assert [s.name for s in spans()] == ["b", "c"]
    assert telemetry.spans_dropped() == before + 1
