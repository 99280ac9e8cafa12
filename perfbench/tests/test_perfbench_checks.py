"""The correctness check of every cell, at tiny widths on the CPU: a sound
run comes out correct, and the same run with the timed path broken
underneath comes out not correct, once for each fault the cell can have
(every token altered where it is produced, and a single one); the control
(the reference in fp8 in the program's place) fails the trimmed mean."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness import traffic as tr
from perfbench.harness.cli import run_cell
from perfbench.harness.common import benchmark, find_cell
from perfbench.tests import tiny
from perfbench.tools import control

CPU = torch.device("cpu")
SERVE = [w["name"] for w in benchmark()["workloads"]
         if find_cell(w["name"]).traffic["kind"] == "serve"]
SEED = 2**31 + 11
SECONDS = 0.8


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, seed=SEED, trace=0):
    c, port = tiny.cell(name)
    return run_cell(c, seed, SECONDS, trace, CPU, port)


@pytest.mark.parametrize("name", SERVE)
def test_a_sound_run_is_correct(name):
    got = _run(name)
    r = got["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c.value <= c.limit for c in got["checks"])


@pytest.mark.parametrize("name", SERVE)
def test_a_traced_run_reports_per_layer_metrics(name):
    got = _run(name, trace=1)
    r = got["result"]
    assert r["correct"] and r["metrics"]
    assert "busy_s" in r["device"] and "breakdown" in r


@pytest.mark.parametrize("name", SERVE)
def test_a_token_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from repro_torch.serving import engine
    real = engine.sample_tokens

    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_tokens", altered)
    assert not _run(name)["result"]["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_a_single_altered_token_is_caught(name, monkeypatch):
    """The first token of the longest request (always in the sample) is
    made its row's least likely one; every other token is sound. The
    trimmed mean leaves that one gap out; the widest gap catches it."""
    from repro_torch.serving import engine
    c, _ = tiny.cell(name)
    reqs = tr.serve_schedule(c.traffic, SEED, SECONDS,
                             c.config["vocab_size"])
    target = max(range(len(reqs)), key=lambda i: len(reqs[i].prompt))
    real_admit, real_sample = engine.ServeEngine._admit_group, \
        engine.sample_tokens
    row = {}

    def admit(self, items):
        row["at"] = next((i for i, (_, r) in enumerate(items)
                          if r.rid == target), None)
        return real_admit(self, items)

    def sample(logits, *a, **k):
        tok = real_sample(logits, *a, **k)
        i = row.pop("at", None)
        if i is not None:
            tok = tok.clone()
            tok[i] = logits[i].argmin()
        return tok
    monkeypatch.setattr(engine.ServeEngine, "_admit_group", admit)
    monkeypatch.setattr(engine, "sample_tokens", sample)
    got = _run(name)
    checks = {ch.name: ch for ch in got["checks"]}
    assert not got["result"]["correct"]
    assert not checks["served_token_logit_gap"].ok
    assert checks["served_token_trimmed_mean_gap"].ok


@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22])
@pytest.mark.parametrize("name", SERVE)
def test_the_serve_control_reads_above_the_program(name, seed):
    c, port = tiny.cell(name)
    got = control.serve_readings(c, seed, SECONDS, CPU, port)
    lim = c.traffic["limits"]
    assert got["control"][1] > lim["trimmed_gap"] >= got["program"][1]
    assert got["program"][0] <= lim["gap"]


@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22])
@pytest.mark.parametrize("name", SERVE)
def test_every_token_altered_reads_above_both_limits(name, seed):
    c, port = tiny.cell(name)
    got = control.serve_readings(c, seed, SECONDS, CPU, port)
    lim = c.traffic["limits"]
    assert got["altered"][0] > lim["gap"]
    assert got["altered"][1] > lim["trimmed_gap"]
