"""The readers of the program's spans, on a tiny traced serve run on the
CPU of every cell that reports them: each of the seven reports a finite
number, the expert-row use reads k / E of the tiny dropless configuration,
and a run without a trace gives None for each."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.harness.cli import run_cell
from perfbench.harness.common import benchmark, driver, find_cell, reader
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 41
SECONDS = 0.8
SPAN_METRICS = ("attn.prefill_ms_per_ktok", "moe.prefill_ms_per_ktok",
                "moe.dispatch_share.prefill", "moe.expert_row_use.prefill",
                "kv.prefill_write_ms_per_ktok", "decode.attn_ms_per_step",
                "decode.moe_ms_per_step")


def cells(*metrics):
    """The cells that report any of `metrics`."""
    names = [w["name"] for w in benchmark()["workloads"]]
    got = [n for n in names if {m["name"] for m in find_cell(n).per_layer}
           & set(metrics)]
    assert got, f"no cell reports {metrics}"
    return got


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """The result of a tiny traced run of a cell, one run a cell."""
    runs = {}

    def result(name):
        if name not in runs:
            c, port = tiny.cell(name)
            runs[name] = run_cell(c, SEED, SECONDS, 1, CPU, port)["result"]
        return runs[name]
    return result


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_traced_run_reports_each_span_metric(traced, name):
    for cell in cells(name):
        r = traced(cell)
        assert r["correct"]
        m = r["metrics"][name]
        assert math.isfinite(m["value"]) and m["value"] >= 0


def test_expert_row_use_reads_the_dropless_share(traced):
    # the tiny configurations are dropless (C = T), so E x C = T E and the
    # use reads T k / (T E)
    for cell in cells("moe.expert_row_use.prefill"):
        t = tiny.sizes(find_cell(cell).workload["config"])
        k, E = (t["config"][t["expert_keys"][x]] for x in ("k", "E"))
        assert traced(cell)["metrics"]["moe.expert_row_use.prefill"][
            "value"] == pytest.approx(100.0 * k / E, abs=1e-12)
    for cell in cells("moe.dispatch_share.prefill"):
        share = traced(cell)["metrics"]["moe.dispatch_share.prefill"]
        assert 0.0 < share["value"] < 100.0


def test_an_untraced_run_gives_none_for_each():
    for cell in cells(*SPAN_METRICS):
        c, port = tiny.cell(cell)
        _, _, extra = driver(c.traffic["kind"]).run(c, SEED, 0.3, False,
                                                    CPU, port)
        ctx = dict(extra["ctx"], cell=c.name)
        assert ctx["tracer"] is None
        for name in SPAN_METRICS:
            assert reader(name)(ctx) is None
