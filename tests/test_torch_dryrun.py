"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's dry run: the same live cells, the reference's record keys
(less `xla_cost_analysis` and `hlo_bytes`, XLA's own, which have no
counterpart), the same `[ok]` / `[FAIL]` lines (a cell that fails, here
an unknown shape name, prints `[FAIL]` and the run goes on). Full-width
cells run on fake tensors over a fake process group of 256 ranks (no
memory is allocated), which is closed afterwards, also when the cell
fails: llama3.2-1b's and mixtral-8x7b's decode_32k (the MoE's small-T
path is off there: 8 experts do not fill a 'model' axis of 16) and
whisper-large-v3's through `main`. Every family's prefill, decode and
train bundle also runs reduced (d_model 64) on a fake (2, 2) mesh.
"""
import json
import os

import pytest
import torch.distributed as dist

# the reference's dryrun sets XLA_FLAGS to 512 host devices when imported
# (for its own process); put the variable back, so that JAX in this test
# process keeps the devices it would have (jax reads it at first use)
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch.launch import dryrun, mesh, report  # noqa: E402

# the keys of the reference's record (src/repro/launch/dryrun.py:run_cell)
REF_KEYS = {"arch", "shape", "mesh", "multi_pod", "kind", "baseline",
            "block_skip", "microbatches", "lower_s", "compile_s",
            "memory_analysis", "xla_cost_analysis", "hlo_analysis",
            "roofline", "hlo_bytes", "peak_bytes_per_device",
            "fits_16g_hbm"}
NO_COUNTERPART = {"xla_cost_analysis", "hlo_bytes"}


def test_live_cells_equal_the_reference():
    assert list(dryrun.live_cells()) == list(ref_dryrun.live_cells())


@pytest.fixture(scope="module")
def decode_cell():
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False)
    assert not dist.is_initialized()
    return rec


def test_record_has_the_reference_keys(decode_cell):
    rec = decode_cell
    assert set(rec) == REF_KEYS - NO_COUNTERPART
    assert set(rec["memory_analysis"]) == {
        "argument_bytes_per_device", "output_bytes_per_device",
        "temp_bytes_per_device", "alias_bytes_per_device"}
    assert set(rec["hlo_analysis"]) == {
        "flops", "mem_bytes", "collective_wire_bytes", "collective_by_type",
        "mem_by_shape_top", "collective_count", "dot_count",
        "unknown_trip_counts"}
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rec["block_skip"] is True      # the port always skips tiles
    json.dumps(rec)


def test_record_is_one_rank_of_256(decode_cell):
    an, rl = decode_cell["hlo_analysis"], decode_cell["roofline"]
    assert rl["hlo_flops_global"] == an["flops"] * 256
    assert an["flops"] * 256 >= rl["model_flops"]
    assert an["unknown_trip_counts"] == 0 and an["collective_count"] > 0
    ma = decode_cell["memory_analysis"]
    # the decode cache (donated) is part of the arguments
    assert 0 < ma["alias_bytes_per_device"] <= ma["argument_bytes_per_device"]
    assert decode_cell["peak_bytes_per_device"] == \
        ma["argument_bytes_per_device"] + ma["temp_bytes_per_device"]


def test_a_moe_cell_is_one_rank_of_256():
    """mixtral-8x7b decode_32k on 16x16: tensor-parallel on d_ff, the
    tokens split over 'data'."""
    stats = {}
    rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", False, stats=stats)
    assert not dist.is_initialized()
    an, rl = rec["hlo_analysis"], rec["roofline"]
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rl["hlo_flops_global"] == an["flops"] * 256
    assert an["flops"] * 256 >= rl["model_flops"]
    assert an["unknown_trip_counts"] == 0 and an["collective_count"] > 0
    assert an["collective_by_type"]["all-reduce"] > 0
    assert stats["alltoall_fallbacks"] == 0


def test_main_writes_records_report_renders_them(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "whisper-large-v3", "--shape",
                        "no_such_shape", "--out", out]) == 1
    assert "[FAIL] whisper-large-v3__no_such_shape__pod256" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "whisper-large-v3", "--shape",
                        "decode_32k", "--out", out]) == 0
    assert "[ok] whisper-large-v3__decode_32k__pod256" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert "[ok] qwen2-0.5b__decode_32k__pod256" in capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert "[skip] qwen2-0.5b__decode_32k__pod256 (exists)" in \
        capsys.readouterr().out
    recs = report.load(out)
    assert sorted(r["arch"] for r in recs) == ["qwen2-0.5b",
                                               "whisper-large-v3"]
    assert "| qwen2-0.5b | decode_32k | decode |" in \
        report.roofline_table(recs)


def test_a_group_is_never_left_open():
    with pytest.raises(RuntimeError):
        with mesh.fake_group(4):
            with pytest.raises(RuntimeError, match="open already"):
                mesh.open_group(4)
            mesh.make_test_mesh(4, 2)          # 8 ranks: the group has 4
    assert not dist.is_initialized()


def _placement_leaves(tree) -> list:
    """The placement tuples of a tree of them (dicts in sorted-key order,
    as `tree_leaves` walks the outputs; None leaves dropped)."""
    from torch.distributed.tensor import Placement
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and tree and all(
            isinstance(e, Placement) for e in tree):
        return [tuple(tree)]
    if isinstance(tree, (tuple, list)):
        return [x for e in tree for x in _placement_leaves(e)]
    return []


FAMILY_ARCHS = ("llama3.2-1b", "internvl2-1b", "mixtral-8x7b", "zamba2-2.7b",
                "xlstm-1.3b", "whisper-large-v3")


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_runs_reduced_on_a_fake_mesh(arch, kind):
    """One family each (dense, vlm, moe, hybrid, ssm, audio), reduced, on
    a fake (2, 2) mesh: the bundle runs on fake tensors under the
    analyzer, with matrix products, collectives and no unknown trip
    count, and its outputs carry the placements the bundle declares."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import hlo_analysis, steps
    from repro_torch.optim.optimizers import tree_leaves
    cfg = get_config(arch).reduced()
    with mesh.fake_group(4):
        m = mesh.make_test_mesh(2, 2)
        with FakeTensorMode():
            b = steps.build(cfg, m, ShapeConfig("mini", 64, 8, kind))
            an, out, peak = hlo_analysis.analyze(b.fn, *b.inputs())
            got = [tuple(t.placements) for t in tree_leaves(out)
                   if hasattr(t, "placements")]
            want = _placement_leaves(b.out_placements)
    assert not dist.is_initialized()
    assert an["dot_count"] > 0 and an["flops"] > 0 and peak > 0
    assert an["collective_count"] > 0 and an["unknown_trip_counts"] == 0
    assert got == want
