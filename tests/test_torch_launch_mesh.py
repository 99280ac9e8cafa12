"""The mesh step on real ranks: two CPU processes (`torch.multiprocessing.
spawn`) on a gloo process group run the port's prefill, decode and train
bundles (`launch.steps.build`) on DeviceMeshes (1, 2) and (2, 1) and hold
them to the same model without a mesh, on every rank.

Reduced qwen2-0.5b and llama3.2-1b in float32, B = 8, S = 64: logits,
cache and pos of prefill, and logits and the written cache of a decode
step from that prefill's cache, within 1e-5 of the largest magnitude
(both run the same float32 operations; a sharded contraction sums its
partial products in another order), with a nonzero collective count
(the step really ran sharded). The reference cannot produce sharded
numbers to hold the port against (its steps raise ShardingTypeError on
JAX 0.9 at the embedding gather), so the unsharded port, itself held to
the reference by tests/test_torch_training.py and test_torch_models.py,
stands in. Also on (1, 2): the sequence-parallel flash (a 3-head
variant, whose heads do not divide the 'model' axis, at S = 256 so each
rank holds 128 queries). On both meshes, one train step of llama from a
state past the warmup (step 1, lr > 0, moments from step 0's gradient):
loss, gradient norm and both moments within 1e-5, the updated master
within 1e-4 of each leaf's largest, and the master moved by more than
twice that (so a step that leaves the state as it was fails). The
master's limit is the one chip_smoke.py holds a card-vs-CPU trajectory
to: where a gradient is ~1e-9 (near AdamW's eps of 1e-8), float32
rounding in another sum order changes it by its own size, and AdamW's
normalized step there by a share of lr (3e-4); measured 2.3e-5 on (1, 2),
at wv's element with a gradient of 7e-10, 7.4e-6 on (2, 1). On (2, 1) the batch splits over 'data', the weights
are gathered over it and the gradients reduce-scattered.

The ranks run in at most `LIMIT` seconds; past it the test kills them
and fails instead of hanging. Each rank closes its process group.
"""
import dataclasses
import json
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

LIMIT = 120.0
TOL = 1e-5
PARAM_TOL = 1e-4    # the updated master, of each leaf's largest
ARCHS = ("qwen2-0.5b", "llama3.2-1b")
MESHES = ((1, 2), (2, 1))
B, S = 8, 64


def _rel(got, want) -> float:
    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _serve_checks(cfg, mesh, S_, out, tag):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import Analyzer
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S_)),
                             dtype=torch.int32)
    ref = Model(cfg, device="cpu", seed=0)
    lg0, cache0, pos0 = ref.prefill({"tokens": tokens}, S_)
    b = steps.build(cfg, mesh, ShapeConfig("p", S_, B, "prefill"))
    paths = []
    mesh_flash = attention._mesh_flash

    def spy(*a, seqpar, **kw):
        paths.append(seqpar)
        return mesh_flash(*a, seqpar=seqpar, **kw)
    attention._mesh_flash = spy
    try:
        with Analyzer() as an:
            lg, cache, pos = b.fn(*b.shard({"tokens": tokens}))
    finally:
        attention._mesh_flash = mesh_flash
    out[f"{tag} prefill"] = {
        "logits": _rel(lg, lg0), "k": _rel(cache["k"], cache0["k"]),
        "v": _rel(cache["v"], cache0["v"]), "pos": _rel(pos, pos0),
        "collectives": an.result()["collective_count"]}
    out[f"{tag} seqpar"] = paths
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                          dtype=torch.int32)
    p = torch.as_tensor(rng.integers(S_ // 2, S_, (B,)), dtype=torch.int32)
    want_cache = {k: v.clone() for k, v in cache0.items()}
    lgd0, want_cache = ref.decode_step(want_cache, tok, p)
    d = steps.build(cfg, mesh, ShapeConfig("d", S_, B, "decode"))
    args = d.shard({k: v.clone() for k, v in cache0.items()}, tok, p)
    with Analyzer() as an:
        lgd, got_cache = d.fn(*args)
    out[f"{tag} decode"] = {
        "logits": _rel(lgd, lgd0), "k": _rel(got_cache["k"], want_cache["k"]),
        "v": _rel(got_cache["v"], want_cache["v"]),
        "collectives": an.result()["collective_count"]}


def _train_check(cfg, mesh, out, tag):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                dtype=torch.int32)
             for k in ("tokens", "labels")}
    model = Model(cfg, device="cpu", seed=0)
    plain = steps.build_train(cfg, total_steps=50)
    # step 0 has lr 0 (the warmup's first step): it fills the moments and
    # leaves the master; the checked step is step 1
    state, _ = plain.step(plain.init_state(model), batch)
    new0, met0 = plain.step(state, batch)
    b = steps.build(cfg, mesh, ShapeConfig("t", S, B, "train"),
                    total_steps=50)
    new, met = b.fn(*b.shard(state, batch))

    def worst(key):
        return max(_rel(g, w) for g, w in zip(tree_leaves(new[key]),
                                              tree_leaves(new0[key])))
    out[tag] = {
        "loss": _rel(met["loss"], met0["loss"]),
        "grad_norm": _rel(met["grad_norm"], met0["grad_norm"]),
        "params": worst("params"), "moments": worst("opt")}
    out[f"{tag} moved"] = {
        "lr": float(met0["lr"]),
        "params": max(_rel(w, s) for w, s in zip(
            tree_leaves(new0["params"]), tree_leaves(state["params"])))}


def _worker(rank, port, path):
    out = {}
    try:
        from repro_torch.configs import get_config
        from repro_torch.launch import mesh as M
        M.open_group(2, backend="gloo", rank=rank,
                     init_method=f"tcp://localhost:{port}")
        try:
            for arch in ARCHS:
                cfg = dataclasses.replace(get_config(arch).reduced(),
                                          dtype="float32")
                for sizes in MESHES:
                    mesh = M.make_test_mesh(*sizes)
                    _serve_checks(cfg, mesh, S, out, f"{arch} {sizes}")
            mesh = M.make_test_mesh(1, 2)
            cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                      dtype="float32", n_heads=3,
                                      n_kv_heads=1)
            _serve_checks(cfg, mesh, 256, out, "seqpar (1, 2)")
            cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                      dtype="float32")
            for sizes in MESHES:
                _train_check(cfg, M.make_test_mesh(*sizes), out,
                             f"llama3.2-1b {sizes} train")
        finally:
            M.close_group()
            out["closed"] = not torch.distributed.is_initialized()
    except Exception as e:                # reported to the parent test
        import traceback
        out["error"] = f"{e!r}\n{traceback.format_exc()}"
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh")
    ctx = mp.spawn(_worker, args=(_free_port(), str(path)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + LIMIT
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish in {LIMIT} s")
    out = [json.load(open(path / f"rank{r}.json")) for r in range(2)]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o['error']}"
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_close_their_group(results, rank):
    assert results[rank]["closed"]


@pytest.mark.parametrize("case", [f"{a} {m} {k}" for a in ARCHS
                                  for m in MESHES
                                  for k in ("prefill", "decode")]
                         + ["seqpar (1, 2) prefill", "seqpar (1, 2) decode"])
def test_mesh_step_equals_the_unsharded_model(results, case):
    for r in range(2):
        got = results[r][case]
        assert got["collectives"] > 0, (r, got)
        errs = {k: v for k, v in got.items() if k != "collectives"}
        assert max(errs.values()) <= TOL, (r, errs)


def test_attention_paths(results):
    """Every layer of the 3-head variant takes the sequence-parallel
    flash, and no layer of the others does."""
    for r in range(2):
        assert results[r]["seqpar (1, 2) seqpar"] == [True] * 4
        for a in ARCHS:
            for m in MESHES:
                assert results[r][f"{a} {m} seqpar"] == [False] * 4


def test_mesh_train_step_equals_the_unsharded_step(results):
    _check_train(results, (1, 2))


def test_mesh_train_step_on_the_data_axis(results):
    """The batch split over 'data', FSDP gathers, gradients
    reduce-scattered."""
    _check_train(results, (2, 1))


def _check_train(results, sizes):
    for r in range(2):
        got = dict(results[r][f"llama3.2-1b {sizes} train"])
        params = got.pop("params")
        assert max(got.values()) <= TOL and params <= PARAM_TOL, (r, got,
                                                                  params)
        moved = results[r][f"llama3.2-1b {sizes} train moved"]
        assert moved["lr"] > 0 and moved["params"] > 2 * PARAM_TOL, (r, moved)
