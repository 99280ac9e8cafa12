"""The readers of the program's spans, on a tiny traced serve run on the
CPU: each of the seven reports a finite number, the expert-row use reads
k / E of the tiny dropless configuration, and a run without a trace
gives None for each."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.harness.cli import run_cell
from perfbench.harness.common import driver, reader
from perfbench.tests import tiny

CPU = torch.device("cpu")
CELL = "mixtral-8L.long-prompt"
SEED = 2**31 + 41
SECONDS = 0.8
SPAN_METRICS = ("attn.prefill_ms_per_ktok", "moe.prefill_ms_per_ktok",
                "moe.dispatch_share.prefill", "moe.expert_row_use.prefill",
                "kv.prefill_write_ms_per_ktok", "decode.attn_ms_per_step",
                "decode.moe_ms_per_step")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    torch.set_num_threads(2)
    c, port = tiny.cell(CELL)
    return run_cell(c, SEED, SECONDS, 1, CPU, port)["result"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_traced_run_reports_each_span_metric(traced, name):
    assert traced["correct"]
    m = traced["metrics"][name]
    assert math.isfinite(m["value"]) and m["value"] >= 0


def test_expert_row_use_reads_the_dropless_share(traced):
    # tiny: E = 4, k = 2, capacity_factor 2.0, so C = T and E x C = 2 T k
    assert traced["metrics"]["moe.expert_row_use.prefill"]["value"] == \
        pytest.approx(50.0, abs=1e-12)
    share = traced["metrics"]["moe.dispatch_share.prefill"]["value"]
    assert 0.0 < share < 100.0


def test_an_untraced_run_gives_none_for_each():
    c, port = tiny.cell(CELL)
    _, _, extra = driver(c.traffic["kind"]).run(c, SEED, 0.3, False, CPU,
                                                port)
    ctx = dict(extra["ctx"], cell=c.name)
    assert ctx["tracer"] is None
    for name in SPAN_METRICS:
        assert reader(name)(ctx) is None
