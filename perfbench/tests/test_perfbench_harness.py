"""CPU tests of the benchmark's harness: every name in BENCHMARK.json finds
its file, the traffic repeats for a seed, the frozen operation counts
reproduce known kernel bounds, and a run loads nothing of the JAX stack
or package."""
from __future__ import annotations

import ast
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import flops, traffic
from perfbench.harness.common import PERFBENCH, ROOT, benchmark, counts, \
    driver, find_cell, load_json, reader, reference

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_to_its_shape():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and all(
            NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = find_cell(cell)
    assert driver(c.traffic["kind"]).run
    assert reference(c.config).layout(c.config)
    assert counts(c.config).layer_matmul_params(c.config) > 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(reader(m["name"]))
        assert m["moves"] in names


def test_every_configuration_file_states_its_source_and_cuts():
    for c in benchmark()["configs"]:
        f = load_json(ROOT / c["file"])
        assert f["source"] == c["source"]
        assert set(c["reduced"]) <= set(f) and f["reference"]
        assert set(f["reduced"]) <= set(c["reduced"])


# Mixtral-8x7B-v0.1's config.json, the keys its file carries
MIXTRAL_PUBLISHED = {
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_hidden_layers": 32, "num_local_experts": 8,
    "num_experts_per_tok": 2, "vocab_size": 32000, "rms_norm_eps": 1e-05,
    "rope_theta": 1e6, "sliding_window": None,
    "max_position_embeddings": 32768, "hidden_act": "silu",
    "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
WIDTH = re.compile(r"(^hidden_size$|intermediate|latent|state|_dim$|_rank$|"
                   r"head_dim|expan|experts_per_tok)")


def test_the_mixtral_file_keeps_the_published_config():
    conf = [c for c in benchmark()["configs"]
            if c["name"] == "mixtral-8x7b-8L"][0]
    f = load_json(ROOT / conf["file"])
    changed = {k for k, v in MIXTRAL_PUBLISHED.items() if f[k] != v}
    assert changed == set(conf["reduced"]) == {"num_hidden_layers"}
    assert not any(WIDTH.search(k) for k in conf["reduced"])


def test_serve_traffic_repeats_for_a_seed():
    for w in benchmark()["workloads"]:
        cell = find_cell(w["name"])
        mix, vocab = cell.traffic, cell.config["vocab_size"]
        if mix["kind"] != "serve":
            continue
        a = traffic.serve_schedule(mix, 2**33 + 1, 50, vocab)
        b = traffic.serve_schedule(mix, 2**33 + 1, 50, vocab)
        c = traffic.serve_schedule(mix, 2**33 + 2, 50, vocab)
        assert len(a) == round(mix["rate_per_s"] * 50)
        assert all(np.array_equal(x.prompt, y.prompt) and x.due_s == y.due_s
                   and x.max_new == y.max_new for x, y in zip(a, b))
        # another seed: other token ids, the same sizes at the same times
        assert [len(x.prompt) for x in a] == [len(x.prompt) for x in c]
        assert [x.due_s for x in a] == [x.due_s for x in c]
        assert any(not np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, c))
        lens = [len(x.prompt) for x in a]
        assert min(lens) >= mix["prompt"]["min"] and max(lens) <= \
            mix["prompt"]["max"]


@pytest.mark.parametrize("args, bound_ms", [
    # mixtral's windowed prefill shape, B = 2, S = 5120, window 4096
    ((2, 5120, 5120, 32, 8, 128, 0, None, True, 4096), 0.41697),
    # llama3.2-1b's training shape, B = 4, S = 4096
    ((4, 4096, 4096, 32, 8, 64, 0, None, True, 0), 0.27800),
    # the dense serve's B = 2, S = 1024 (operations) and S = 128 (bytes)
    ((2, 1024, 1024, 32, 8, 64, 0, None, True, 0), 0.0086940),
    ((2, 128, 128, 32, 8, 64, 0, None, True, 0), 0.00078252),
])
def test_flash_bound_reproduces_known_launches(args, bound_ms):
    assert flops.flash_bound_s(*args) * 1e3 == pytest.approx(bound_ms,
                                                             rel=2e-5)


# the parent harness's counts of Mixtral-8x7B at 8 layers, when they were
# written out in `harness/flops.py`
MIXTRAL_PREFILL = {1024: 6529216413696.0, 3072: 19999441813504.0,
                   12288: 87418684309504.0}
MIXTRAL_DECODE = {1: 6571032576.0, 4096: 7107772416.0,
                  12336: 8187805696.0}


@pytest.mark.parametrize("S", sorted(MIXTRAL_PREFILL))
def test_mixtral_prefill_operations_are_unchanged(S):
    c = load_json(PERFBENCH / "configs" / "mixtral-8x7b-8L.json")
    assert flops.prefill_flops(c, 1, S) == MIXTRAL_PREFILL[S]


@pytest.mark.parametrize("context", sorted(MIXTRAL_DECODE))
def test_mixtral_decode_operations_are_unchanged(context):
    c = load_json(PERFBENCH / "configs" / "mixtral-8x7b-8L.json")
    assert flops.decode_flops(c, context) == MIXTRAL_DECODE[context]


def test_visible_pairs_count_the_mask():
    assert flops.visible_pairs(4, 4) == 10
    assert flops.visible_pairs(4, 4, causal=False) == 16
    assert flops.visible_pairs(5, 5, window=2) == 9
    assert flops.visible_pairs(2, 6, q_offset=4) == 11
    assert flops.visible_pairs(5120, 5120, window=4096) == 12_584_960


def test_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (path, m)


_DRY_RUN = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
from perfbench.tests import tiny
from perfbench.harness.cli import run_cell
from perfbench.harness.common import counts, forbidden_loaded, reference
for name in {cells!r}:
    c, port = tiny.cell(name)
    got = run_cell(c, 2**32 + 3, 0.5, 0, torch.device("cpu"), port)
    assert got["result"]["correct"], got
    reference(c.config), counts(c.config)
print(forbidden_loaded(), "repro_torch" in sys.modules)
"""


def test_a_cpu_dry_run_loads_no_jax_and_no_jax_package():
    cells = [w["name"] for w in benchmark()["workloads"]]
    code = _DRY_RUN.format(root=str(ROOT), src=str(ROOT / "src"),
                           cells=cells)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(PERFBENCH / "run.py"), "--workload",
         benchmark()["workloads"][0]["name"], "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_readers_leave_out_what_they_cannot_read():
    for m in benchmark()["per_layer"]:
        assert reader(m["name"])({"kind": "none"}) is None


def test_result_line_is_json_with_checks_last(capsys):
    from perfbench.harness.common import Check, emit
    import io
    out, err = io.StringIO(), io.StringIO()
    emit({"correct": True, "attempted": 1, "failed": 0, "metrics": {},
          "device": {}}, [Check("gap", 0.1, 0.2)], out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["checks"]["gap"] == {
        "value": 0.1, "limit": 0.2}
    assert err.getvalue().strip().splitlines()[-1].startswith("check gap")


def test_harness_modules_import_without_a_card():
    for m in ("perfbench.harness.cli", "perfbench.drivers.serve",
              "perfbench.tools.control"):
        importlib.import_module(m)
