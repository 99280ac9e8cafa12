"""Port parity of the launch layer's metadata and analysis (`repro_torch.
launch.{mesh,sharding,hlo_analysis,report}`, `Model.param_specs` /
`cache_specs`, every family's `specs`) against the JAX reference on the
same inputs.

- Rule tables (`make_rules`) and spec trees (`logical_to_pspec` over
  `param_specs` and `cache_specs`) are pure metadata: held equal, leaf
  for leaf, for all ten archs at both production meshes, against the
  reference over `jax.sharding.AbstractMesh`.
- The analyzer (`hlo_analysis.Analyzer`, a dispatch mode over the port's
  eager step) against the reference's `analyze(text, 1)` of the
  unsharded step XLA compiles: flops within 5%, the reference test's own
  limit (`tests/test_launch.py::test_hlo_analyzer_trip_counts_and_dots`),
  and no unknown trip count. Prefill and decode agree exactly (the same
  products, the flash entry counted over its one 64 x 64 tile as the
  reference's blocked flash computes it); a train step is 2.6% (qwen2)
  and 2.4% (llama) above the reference: the port's flash backward
  (`flash_attention_bwd`) recomputes each tile's Q K^T once more, in a
  first pass for the row max and sum, where XLA's differentiation of the
  reference's tile loop computes it once. Bytes are not compared: the two
  programs materialize different buffers.
- `report`'s tables and `profile_from_dryrun` give the reference's
  results on the same records.

No test leaves a process group open: the fake group of a test is closed
in the `fake_group` context, and a check asserts it.
"""
import dataclasses
import glob
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh as RefAbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import hlo_analysis as ref_hlo  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.workloads import profiler as ref_profiler  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config  # noqa
from repro_torch.launch import hlo_analysis, report, sharding, steps  # noqa
from repro_torch.launch.mesh import AbstractMesh, fake_group, \
    make_test_mesh  # noqa: E402
from repro_torch.models.common import logical_to_pspec, to_placements  # noqa
from repro_torch.models.model import Model, param_tree  # noqa: E402
from repro_torch.workloads import profiler  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((8,), ("data",))]
FLOPS_RTOL = 0.05
B, S = 8, 64


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree, leaf=_is_axes, prefix=""):
    """{path: leaf} of a tree of dicts."""
    if leaf(tree) or not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, leaf, f"{prefix}/{k}"))
    return out


# ---------------------------------------------------------------------------
# pure metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch):
    ref = RefModel(ref_get_config(arch))
    port = Model(get_config(arch), device="meta")
    assert _flat(port.param_specs()) == _flat(ref.param_specs())
    assert _flat(port.cache_specs()) == _flat(ref.cache_specs())


@pytest.mark.parametrize("sizes,names", MESHES)
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("batch", [1, 128])
def test_make_rules_equal_the_reference(sizes, names, kind, batch):
    got = sharding.make_rules(AbstractMesh(sizes, names), batch_size=batch,
                              kind=kind)
    want = ref_sharding.make_rules(RefAbstractMesh(sizes, names),
                                   batch_size=batch, kind=kind)
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch):
    """Parameter and cache spec trees (divisibility fallback, first use
    of an axis) at both production meshes, train and decode rules."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    ref_m = RefModel(ref_cfg)
    shapes = jax.eval_shape(ref_m.init, jax.random.key(0))
    port_m = Model(cfg, device="meta")
    port_shapes = param_tree(port_m)
    W = port_m.kv_window(32768)
    ref_cache = jax.eval_shape(lambda: ref_m.init_cache(128, W))
    port_cache = port_m.init_cache(128, W, device="meta")
    for sizes, names in MESHES[:2]:
        for kind in ("train", "decode"):
            am = AbstractMesh(sizes, names)
            ram = RefAbstractMesh(sizes, names)
            rules = sharding.make_rules(am, batch_size=128, kind=kind)
            ref_rules = ref_sharding.make_rules(ram, batch_size=128,
                                                kind=kind)
            for specs, shp, rspecs, rshp in (
                    (port_m.param_specs(), port_shapes, ref_m.param_specs(),
                     shapes),
                    (port_m.cache_specs(), port_cache, ref_m.cache_specs(),
                     ref_cache)):
                got = _flat(sharding.spec_tree(specs, shp, rules, am),
                            leaf=sharding._is_spec)
                want = _flat(ref_sharding.spec_tree(rspecs, rshp, ref_rules,
                                                    ram),
                             leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec))
                assert got == {k: tuple(v) for k, v in want.items()}, \
                    (sizes, kind)


def test_to_placements_and_the_divisibility_fallback():
    from torch.distributed.tensor import Replicate, Shard
    am = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = sharding.make_rules(am, batch_size=128)
    spec = logical_to_pspec(("batch", "seq", "heads"), rules,
                            shape=(64, 8, 14), mesh=am)
    assert spec == (("pod", "data"),)          # 14 heads do not divide 16
    assert to_placements(spec, am) == (Shard(0), Shard(0), Replicate())
    spec = logical_to_pspec(("batch", "seq", "heads"), rules,
                            shape=(64, 8, 32), mesh=am)
    assert to_placements(spec, am) == (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="axis order"):
        to_placements((("model", "data"),), am)


def test_is_dtensor():
    """The cached class tells a DTensor from a plain tensor and a
    parameter."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import is_dtensor
    assert not is_dtensor(torch.zeros(2))
    assert not is_dtensor(torch.nn.Parameter(torch.zeros(2)))
    with fake_group(1):
        x = DTensor.from_local(torch.zeros(2), make_test_mesh(1, 1),
                               (Replicate(),) * 2)
        assert is_dtensor(x) and is_dtensor(torch.nn.Parameter(x))
        assert not is_dtensor(x.to_local())
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the analyzer against the reference's
# ---------------------------------------------------------------------------

def _ref_analysis(arch, kind):
    cfg = ref_get_config(arch).reduced()
    m = RefModel(cfg)
    p = jax.eval_shape(m.init, jax.random.key(0))
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "prefill":
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = jax.ShapeDtypeStruct(
                (B, cfg.enc_frames, cfg.d_model), jnp.float32)
        if cfg.family == "vlm":
            toks = jax.ShapeDtypeStruct((B, S - cfg.n_patches), jnp.int32)
            extra["patches"] = jax.ShapeDtypeStruct(
                (B, cfg.n_patches, cfg.d_model), jnp.float32)
        f = jax.jit(lambda p, t, e: m.prefill(p, {"tokens": t, **e}))
        args = (p, toks, extra)
    elif kind == "decode":
        cache = jax.eval_shape(lambda: m.init_cache(B, m.kv_window(S)))
        f = jax.jit(m.decode_step)
        args = (p, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                jax.ShapeDtypeStruct((B,), jnp.int32))
    else:
        f = jax.jit(jax.value_and_grad(
            lambda p, t, l: m.loss(p, {"tokens": t, "labels": l}),
            has_aux=True))
        args = (p, toks, toks)
    return ref_hlo.analyze(f.lower(*args).compile().as_text(), 1)


def _port_analysis(arch, kind):
    from repro_torch.models import moe
    cfg = get_config(arch).reduced()
    small_t = moe.SMALL_T
    moe.SMALL_T = 0        # the capacity C, as the unsharded reference
    try:
        with fake_group(1):
            mesh = make_test_mesh(1, 1)
            with FakeTensorMode():
                b = steps.build(cfg, mesh, ShapeConfig("mini", S, B, kind))
                an, _, _ = hlo_analysis.analyze(b.fn, *b.inputs())
    finally:
        moe.SMALL_T = small_t
    assert not dist.is_initialized()
    return an


NEW_FAMILIES = ("internvl2-1b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-1.3b",
                "whisper-large-v3")


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("qwen2-0.5b", "llama3.2-1b")
    for k in ("prefill", "decode", "train")] + [
    (a, k) for a in NEW_FAMILIES for k in ("prefill", "decode")])
def test_analyzer_flops_match_the_reference(arch, kind):
    """The dense family as the module docstring says. The vlm, moe,
    hybrid, ssm and audio families' prefill and decode (the moe with
    `SMALL_T = 0`, so both take the capacity C) have the reference's
    flops exactly, and its dots but for xlstm's sLSTM: under a mesh its
    input product runs as one product a gate (`xlstm._mesh_scan`, the
    same flops), 3 dots more a sLSTM layer."""
    got, want = _port_analysis(arch, kind), _ref_analysis(arch, kind)
    assert got["unknown_trip_counts"] == 0
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_RTOL)
    if kind != "train":
        cfg = get_config(arch).reduced()
        extra = 3 * (cfg.n_layers // cfg.slstm_every) \
            if cfg.family == "ssm" else 0
        assert got["flops"] == want["flops"]
        assert got["dot_count"] == want["dot_count"] + extra
    assert set(got) == set(want)


def test_reference_targets():
    """The reduced qwen2 targets as the reference computes them today
    (flops, dot_count), so a change of the reference shows here."""
    got = [_ref_analysis("qwen2-0.5b", k) for k in ("prefill", "decode")]
    assert [(a["flops"], a["dot_count"]) for a in got] == \
        [(184811520, 37), (3145728, 37)]


def test_analyzer_counts_every_iteration_of_a_loop():
    """The counterpart of the reference's scan-of-matmul test: L sharded
    matrix products in a loop give L dots and L * 2*M*N*K flops, exactly,
    M, N, K the local shapes (x's rows over 'data', w's columns over
    'model')."""
    from torch.distributed.tensor import distribute_tensor
    L, d = 4, 64
    with fake_group(4):
        mesh = make_test_mesh(2, 2)
        with FakeTensorMode():
            ws = distribute_tensor(torch.empty(L, d, d), mesh, to_placements(
                (None, "data", "model"), mesh))
            x = distribute_tensor(torch.empty(8, d), mesh,
                                  to_placements(("data",), mesh))

            def step(ws, x):
                for i in range(L):
                    x = torch.tanh(x @ ws[i])
                return (x * x).sum()
            an, _, _ = hlo_analysis.analyze(step, ws, x)
    assert an["dot_count"] == L
    assert an["flops"] == L * 2 * (8 // 2) * d * (d // 2)
    assert an["collective_count"] > 0 and an["unknown_trip_counts"] == 0


def test_flash_entry_counted_once_over_its_visited_tiles():
    from repro_torch.kernels.flash_attention import kernel
    q = torch.empty(2, 1024, 4, 16)
    k = torch.empty(2, 1024, 2, 16)
    with FakeTensorMode():
        q, k = (torch.empty(t.shape) for t in (q, k))
        an, out, _ = hlo_analysis.analyze(
            kernel.flash_attention_fwd, q, k, k, chunk_q=256, chunk_kv=256)
    assert out.shape == q.shape
    tiles = 4 * 5 // 2                     # causal: tiles on and below the
    assert an["dot_count"] == 2 * tiles    # diagonal of 4 x 4
    assert an["flops"] == 4 * 2 * 4 * 16 * tiles * 256 * 256
    assert kernel.visited_work(1024, 1024, chunk_q=256,
                               chunk_kv=256) == (tiles * 256 * 256, tiles)


def test_flash_entry_takes_meta_tensors():
    from repro_torch.kernels.flash_attention import kernel
    q = torch.empty(1, 64, 4, 16, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 64, 2, 16, device="meta", dtype=torch.bfloat16)
    o = kernel.flash_attention_fwd(q, k, k)
    assert o.device.type == "meta" and o.shape == q.shape \
        and o.dtype == torch.bfloat16


def test_peak_live_bytes_is_exact():
    """200 tensors of 1 MiB, each freed before the next is made: the peak
    is 1 MiB to the byte, and 10 MiB when ten live at once (a fill
    included); a sweep every few operations would count dead ones."""
    base = torch.ones(1 << 18)                  # made before: not counted
    with hlo_analysis.Analyzer() as an:
        for _ in range(200):
            t = base * 2
            del t
    assert an.peak_live_bytes == 1 << 20
    with hlo_analysis.Analyzer() as an:
        ts = [base * 2 for _ in range(9)] + [torch.zeros(1 << 18)]
        del ts
        u = base + 1                            # noqa: F841
    assert an.peak_live_bytes == 10 << 20


def test_a_cpu_alltoall_counts_as_one_alltoall():
    """A Shard(0) -> Shard(1) redistribute on a CPU mesh runs DTensor's
    all-gather-plus-chunk fallback; the analyzer counts it as the one
    all-to-all of its input that an nccl group runs."""
    from torch.distributed.tensor import Shard, distribute_tensor
    with fake_group(4):
        mesh = make_test_mesh(4, 1)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 64), mesh,
                                  (Shard(0), Shard(0)))
            with hlo_analysis.Analyzer() as an:
                y = x.redistribute(mesh, (Shard(1), Shard(0)))
            assert y.to_local().shape == (8, 16)
    assert not dist.is_initialized()
    res = an.result()
    assert an.alltoall_fallbacks == 1 and res["collective_count"] == 1
    assert res["collective_by_type"] == {"all-to-all": 2 * 64 * 4 * 3 / 4}


def test_internal_torch_apis_the_port_uses():
    """Pins torch internals the dry run depends on."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert callable(FakeStore)
    assert hasattr(ShardingPropagator, hlo_analysis.SHAPE_INFERENCE)
    from torch.distributed.tensor.experimental import (  # noqa: F401
        implicit_replication, local_map)
    from torch.distributed.tensor import placement_types
    assert callable(placement_types.shard_dim_alltoall)


# ---------------------------------------------------------------------------
# report and profiles from records
# ---------------------------------------------------------------------------

def _record(arch, shape, mesh, kind, mfu, coll):
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
            "compile_s": 1.0,
            "roofline": {"compute_s": 1, "memory_s": 2,
                         "collective_s": coll, "bottleneck": "memory",
                         "model_flops": 1e12, "hlo_flops_global": 2e12,
                         "mfu": mfu, "step_time_s": 2.0,
                         "roofline_frac": 1.0},
            "hlo_analysis": {"flops": 1, "mem_bytes": 2,
                             "collective_wire_bytes": 3,
                             "collective_by_type": {"all-reduce": 3e6,
                                                    "all-gather": 5e7}},
            "memory_analysis": {"argument_bytes_per_device": 2 ** 30,
                                "temp_bytes_per_device": 3 * 2 ** 29},
            "peak_bytes_per_device": 5 * 2 ** 29, "fits_16g_hbm": True}


def _write_records(tmp_path):
    recs = [_record("llama3.2-1b", "train_4k", "16x16", "train", 0.25, 0.5),
            _record("qwen2-0.5b", "prefill_32k", "16x16", "prefill", 0.1,
                    1.5),
            _record("qwen2-0.5b", "prefill_32k", "2x16x16", "prefill",
                    0.05, 2.5)]
    for r in recs:
        pod = "pod512" if r["mesh"] == "2x16x16" else "pod256"
        with open(tmp_path / f"{r['arch']}__{r['shape']}__{pod}.json",
                  "w") as f:
            json.dump(r, f)


def test_report_equals_the_reference(tmp_path):
    _write_records(tmp_path)
    recs, ref_recs = report.load(str(tmp_path)), ref_report.load(
        str(tmp_path))
    assert recs == ref_recs
    assert report.summary(recs) == ref_report.summary(ref_recs)
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(recs, mesh) == \
            ref_report.roofline_table(ref_recs, mesh)
    assert report.dryrun_table(recs) == ref_report.dryrun_table(ref_recs)
    assert "| qwen2-0.5b | prefill_32k |" in report.roofline_table(recs)


def test_profile_from_dryrun_equals_the_reference(tmp_path):
    _write_records(tmp_path)
    assert len(glob.glob(str(tmp_path / "*pod256.json"))) == 2
    got = profiler.profile_from_dryrun(str(tmp_path))
    want = ref_profiler.profile_from_dryrun(str(tmp_path))
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
