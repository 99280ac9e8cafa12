"""The trainer, its checkpoints and its launcher on a DeviceMesh: two CPU
processes (`torch.multiprocessing.spawn`) on a gloo process group, as
tests/test_torch_launch_mesh_families.py spawns them, at reduced
llama3.2-1b in float32 (S = 64, a global batch of 8 in 2 microbatches,
one thread a rank).

  * `Trainer(cfg, mesh, shape, tcfg)` on (2, 1) and (1, 2) for 3 steps
    against `Trainer(cfg, None, ...)` on the same seed, on every rank:
    each step's loss within 1e-5, and every leaf of the final state
    (master, moments, step) within 1e-5 of its largest; the mesh run's
    state is really split (a leaf whose shard is smaller than the leaf).
    The reference's mesh trainer raises ShardingTypeError on JAX 0.9
    (ROADMAP "Known issues"), so the no-mesh trainer, held to the
    reference by tests/test_torch_training.py and test_torch_checkpoint.py,
    stands in for it.
  * A checkpoint written on one mesh, or on none, restored onto each
    other one: every leaf bit-equal, placed as the target mesh's rules
    place it (each rank's shard equal to `distribute_tensor`'s); the
    manifest names the writer's mesh. The reference restores the port's
    mesh-written checkpoint, and the port restores, onto both meshes, a
    checkpoint that the reference's `save_checkpoint` wrote on its one
    CPU device: leaves equal.
  * A run on (2, 1) preempted at step 3 (on rank 1 only: the ranks agree
    before every step, so both checkpoint) and restarted to the end is
    bit-identical to the uninterrupted run; restarted on (1, 2) instead
    (the elastic restore), it ends within 1e-5 of it.
  * `launch.train`: `parse_mesh` against the reference's for "8", "4x2"
    and "2x2x2" (the reference's `jax.make_mesh` replaced by a recorder,
    so no JAX mesh larger than the host is built; the port's on a fake
    group of that size), a `--mesh` whose size is not the world size
    raises, and the launcher under `torchrun --nproc_per_node 2` trains
    on a 2x1 mesh and resumes on every rank as 'data'.

The ranks run in at most `LIMIT` seconds; past it the test kills them and
fails instead of hanging. Each rank closes its process group.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

# a guard against a hung rank: ~40 s alone, several times that on a host
# shared with other test workers
LIMIT = 300.0
TOL = 1e-5
ARCH = "llama3.2-1b"
S, B, MICRO, STEPS = 64, 8, 2, 3
MESHES = ((2, 1), (1, 2))
PREEMPT, PREEMPT_TOTAL = 3, 5
REF_STEP = 7
# (writer, reader) of the cross-mesh restores; None is no mesh
PAIRS = tuple((w, r) for w in MESHES + (None,) for r in MESHES + (None,)
              if w != r)


def _name(sizes) -> str:
    return "none" if sizes is None else "x".join(map(str, sizes))


def _cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")


def _shape():
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("reduced_train", S, B, "train")


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _key(path: str) -> str:
    return path.replace("/", "|")          # npz keys cannot hold '/'


def _tcfg(d, total_steps=STEPS, **kw):
    from repro_torch.training import TrainConfig
    return TrainConfig(total_steps=total_steps, ckpt_every=2, ckpt_dir=str(d),
                       log_every=100, log_fn=lambda *a: None, device="cpu",
                       microbatches=MICRO, **kw)


def _state_errs(got, want) -> dict:
    """{path: max|got - want| / max|want|} over the leaves."""
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    for (p, a), b in zip(tree_leaves(got, paths=True), tree_leaves(want)):
        a, b = _full(a).double(), _full(b).double()
        out[p] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    return out


def _bit_equal(got, want) -> list:
    """The paths whose leaves differ in dtype, shape or any bit."""
    from repro_torch.optim.optimizers import tree_leaves
    pairs = [(p, _full(a), _full(b)) for (p, a), b in
             zip(tree_leaves(got, paths=True), tree_leaves(want))]
    return [p for p, a, b in pairs
            if a.dtype != b.dtype or not torch.equal(a, b)]


def _misplaced(tree, placements, mesh) -> list:
    """The paths of DTensor leaves not placed as `placements` says, or
    whose shard is not `distribute_tensor`'s of the whole leaf."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim.optimizers import tree_leaves
    flat = dict(tree_leaves(tree, paths=True))
    bad = []
    for p, t in flat.items():
        pl = placements
        for k in p.split("/"):
            pl = pl[k] if pl is not None else None
        if pl is None:
            if hasattr(t, "full_tensor"):
                bad.append(p)
            continue
        if tuple(t.placements) != tuple(pl):
            bad.append(p)
            continue
        want = distribute_tensor(t.full_tensor(), mesh, pl,
                                 src_data_rank=None).to_local()
        if not torch.equal(t.to_local(), want):
            bad.append(p)
    return bad


def _split(tree) -> bool:
    """Whether some DTensor leaf's shard is smaller than the leaf."""
    from repro_torch.optim.optimizers import tree_leaves
    return any(hasattr(t, "to_local") and t.to_local().numel() < t.numel()
               for t in tree_leaves(tree))


def _trainers(path, rank, out):
    """3 steps without a mesh and on each mesh; returns the final states
    by mesh (None: no mesh)."""
    from repro_torch.launch import mesh as M
    from repro_torch.training import Trainer
    cfg, shape = _cfg(), _shape()
    st0, h0 = Trainer(cfg, None, shape, _tcfg(path / f"none{rank}")).run()
    states = {None: st0}
    for sizes in MESHES:
        mesh = M.make_test_mesh(*sizes)
        t0 = time.perf_counter()
        st, h = Trainer(cfg, mesh, shape, _tcfg(path / _name(sizes))).run()
        out[f"train {_name(sizes)}"] = {
            "steps": [x["step"] for x in h],
            "loss": max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                        for a, b in zip(h, h0)),
            "state": max(_state_errs(st, st0).values()),
            "split": _split(st), "wall": time.perf_counter() - t0}
        states[sizes] = st
    return states


def _like(sizes):
    """(like, shardings, mesh) of a restore onto `sizes` (None: the CPU)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    if sizes is None:
        return steps.build_train(_cfg()).state_like(), None, None
    mesh = M.make_test_mesh(*sizes)
    b = steps.build(_cfg(), mesh, _shape())
    return b.in_specs[0], b.in_placements[0], mesh


def _cross_restores(path, rank, states, out):
    """Each final state saved from its mesh (or none) and restored onto
    every other one."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    for w in states:
        # no mesh: each rank writes its own copy (a plain tree has no rank 0)
        d = path / (f"x_none{rank}" if w is None else f"x_{_name(w)}")
        save_checkpoint(str(d), STEPS, states[w])
        with open(d / f"step_{STEPS:09d}" / "manifest.json") as f:
            out[f"manifest {_name(w)}"] = json.load(f).get("mesh", "absent")
    for w, r in PAIRS:
        d = path / (f"x_none{rank}" if w is None else f"x_{_name(w)}")
        like, pl, mesh = _like(r)
        got = restore_checkpoint(str(d), STEPS, like, device="cpu",
                                 mesh=mesh, shardings=pl)
        out[f"restore {_name(w)} -> {_name(r)}"] = {
            "differ": _bit_equal(got, states[w]),
            "misplaced": [] if mesh is None else _misplaced(got, pl, mesh)}


def _uneven(path, rank, out):
    """Leaves whose split dimensions do not divide the ranks (5 and 7
    rows, a row of 1: shards of 3 and 2, 4 and 3, 1 and 0) restored onto
    each mesh, split on either dimension: placed as `distribute_tensor`
    places them, and equal to what was saved."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch import mesh as M
    gen = torch.Generator().manual_seed(0)      # the same on every rank
    tree = {"a": torch.randn((5, 3), generator=gen),
            "b": torch.randn((2, 7), generator=gen),
            "c": torch.randn((1, 4), generator=gen)}
    d = str(path / f"uneven{rank}")
    save_checkpoint(d, 0, tree)
    for sizes in MESHES:
        mesh = M.make_test_mesh(*sizes)
        split = [Shard(0), Replicate()] if sizes[0] == 2 else \
            [Replicate(), Shard(0)]
        for dim in (0, 1):
            pl = tuple(Shard(dim) if p.is_shard() else p for p in split)
            like = {k: torch.empty(t.shape, device="meta")
                    for k, t in tree.items()}
            got = restore_checkpoint(d, 0, like, mesh=mesh, shardings={
                k: pl for k in tree})
            out[f"uneven {_name(sizes)} dim {dim}"] = {
                "differ": _bit_equal(got, tree),
                "misplaced": _misplaced(got, {k: pl for k in tree}, mesh)}


def _preempted(path, rank, out):
    """(2, 1): uninterrupted, preempted at PREEMPT on rank 1 and resumed,
    and resumed on (1, 2) from the same step."""
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import mesh as M
    from repro_torch.training import Trainer
    cfg, shape = _cfg(), _shape()
    m21, m12 = M.make_test_mesh(2, 1), M.make_test_mesh(1, 2)
    tc = lambda d, **kw: _tcfg(path / d, PREEMPT_TOTAL, **kw)  # noqa: E731
    st_a, h_a = Trainer(cfg, m21, shape, tc("pa")).run()
    hook = {"preempt_at": PREEMPT} if rank == 1 else {}
    _, h_b0 = Trainer(cfg, m21, shape, tc("pb", **hook)).run()
    preempted_at = latest_step(str(path / "pb"))
    if rank == 0:
        shutil.copytree(path / "pb", path / "pc")
    torch.distributed.barrier()
    tr = Trainer(cfg, m21, shape, tc("pb"))
    st_b, h_b = tr.run()
    loss_a = {h["step"]: h["loss"] for h in h_a}
    out["preempt"] = {
        "steps before": [h["step"] for h in h_b0],
        "checkpointed": preempted_at, "restored": tr.stats["restored_step"],
        "steps after": [h["step"] for h in h_b],
        "differ": _bit_equal(st_b, st_a),
        "losses equal": all(h["loss"] == loss_a[h["step"]] for h in h_b)}
    tr = Trainer(cfg, m12, shape, tc("pc"))
    st_c, h_c = tr.run()
    out["elastic"] = {
        "restored": tr.stats["restored_step"],
        "steps after": [h["step"] for h in h_c],
        "loss": max(abs(h["loss"] - loss_a[h["step"]]) / abs(loss_a[
            h["step"]]) for h in h_c),
        "state": max(_state_errs(st_c, st_a).values())}


def _reference_written(path, out):
    """The reference's checkpoint restored onto each mesh."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.optim.optimizers import tree_leaves
    want = np.load(path / "ref_want.npz")
    for sizes in MESHES:
        like, pl, mesh = _like(sizes)
        got = restore_checkpoint(str(path / "ref"), REF_STEP, like,
                                 mesh=mesh, shardings=pl)
        flat = dict(tree_leaves(got, paths=True))
        out[f"reference -> {_name(sizes)}"] = {
            "leaves": sorted(flat) == sorted(k.replace("|", "/")
                                             for k in want.files),
            "differ": [p for p, t in flat.items() if not np.array_equal(
                _full(t).numpy(), want[_key(p)])
                or _full(t).numpy().dtype != want[_key(p)].dtype],
            "misplaced": _misplaced(got, pl, mesh), "split": _split(got)}


def _worker(rank, path):
    from pathlib import Path
    path = Path(path)
    out = {}
    try:
        torch.set_num_threads(1)
        from repro_torch.launch import mesh as M
        # a file store in the test's own directory: no port to race for
        # with another test's group
        M.open_group(2, backend="gloo", rank=rank,
                     init_method=f"file://{path}/store")
        try:
            states = _trainers(path, rank, out)
            _cross_restores(path, rank, states, out)
            _uneven(path, rank, out)
            _preempted(path, rank, out)
            _reference_written(path, out)
        finally:
            M.close_group()
            out["closed"] = not torch.distributed.is_initialized()
    except Exception as e:                # reported to the parent test
        import traceback
        out["error"] = f"{e!r}\n{traceback.format_exc()}"
    with open(path / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _jax():
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
        jax.experimental.enable_x64 = \
            lambda new_val=True: jax.enable_x64(new_val)
    return jax


def _write_reference_checkpoint(path):
    """The reference's reduced llama training state (float32 master, AdamW
    moments drawn from a seed, step REF_STEP), written by its
    `save_checkpoint`; the same leaves as numpy in ref_want.npz."""
    jax = _jax()
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint as ref_save
    from repro.configs import get_config as ref_get_config
    from repro.models.model import Model as RefModel
    from repro.optim import make_optimizer as ref_make_optimizer
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                                  dtype="float32")
    master = jax.tree.map(lambda x: x.astype(jnp.float32),
                          RefModel(ref_cfg).init(jax.random.key(1)))
    rng = np.random.default_rng(0)
    opt = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)),
        ref_make_optimizer(ref_cfg, lambda s: 1e-3).init(master))
    state = {"params": master, "opt": opt, "step": jnp.int32(REF_STEP)}
    ref_save(str(path / "ref"), REF_STEP, state)
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    np.savez(path / "ref_want.npz", **{
        "|".join(str(k.key) for k in p): np.asarray(x) for p, x in flat})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("training_mesh")
    _write_reference_checkpoint(path)
    ctx = mp.spawn(_worker, args=(str(path),), nprocs=2, join=False)
    deadline = time.monotonic() + LIMIT
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {LIMIT} s")
    out = []
    for r in range(2):
        o = json.load(open(path / f"rank{r}.json"))
        assert "error" not in o, f"rank {r}: {o['error']}"
        out.append(o)
    return path, out


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_close_their_group(results, rank):
    assert results[1][rank]["closed"]


@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_mesh_trainer_matches_the_trainer_without_a_mesh(results, sizes):
    for r in range(2):
        got = results[1][r][f"train {_name(sizes)}"]
        assert got["steps"] == list(range(STEPS)), (r, got)
        assert got["loss"] <= TOL and got["state"] <= TOL, (r, got)
        assert got["split"], (r, got)


@pytest.mark.parametrize("pair", PAIRS,
                         ids=[f"{_name(w)}->{_name(r)}" for w, r in PAIRS])
def test_checkpoint_restores_bit_equal_onto_another_mesh(results, pair):
    key = f"restore {_name(pair[0])} -> {_name(pair[1])}"
    for r in range(2):
        assert results[1][r][key] == {"differ": [], "misplaced": []}, r


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_restore_splits_uneven_leaves_as_distribute_tensor(results, sizes,
                                                           dim):
    key = f"uneven {_name(sizes)} dim {dim}"
    for r in range(2):
        assert results[1][r][key] == {"differ": [], "misplaced": []}, r


def test_manifest_records_the_writers_mesh(results):
    for r in range(2):
        got = results[1][r]
        assert got["manifest 2x1"] == {"shape": [2, 1],
                                       "axis_names": ["data", "model"]}
        assert got["manifest 1x2"] == {"shape": [1, 2],
                                       "axis_names": ["data", "model"]}
        assert got["manifest none"] is None


def test_preempted_mesh_run_restarts_bit_identical(results):
    for r in range(2):
        got = results[1][r]["preempt"]
        assert got["steps before"] == list(range(PREEMPT)), (r, got)
        assert got["checkpointed"] == PREEMPT == got["restored"], (r, got)
        assert got["steps after"] == list(range(PREEMPT, PREEMPT_TOTAL))
        assert got["differ"] == [] and got["losses equal"], (r, got)


def test_preempted_run_resumes_on_another_mesh(results):
    for r in range(2):
        got = results[1][r]["elastic"]
        assert got["restored"] == PREEMPT, (r, got)
        assert got["steps after"] == list(range(PREEMPT, PREEMPT_TOTAL))
        assert got["loss"] <= TOL and got["state"] <= TOL, (r, got)


@pytest.mark.parametrize("sizes", MESHES, ids=_name)
def test_reference_written_checkpoint_restores_onto_a_mesh(results, sizes):
    for r in range(2):
        got = results[1][r][f"reference -> {_name(sizes)}"]
        assert got == {"leaves": True, "differ": [], "misplaced": [],
                       "split": True}, (r, got)


def test_port_mesh_checkpoint_restores_in_the_reference(results):
    """The reference's `restore_checkpoint` reads the step the port wrote
    on (2, 1) (one npz from rank 0, the manifest's extra "mesh" key
    unread): equal to the port's own restore of it without a mesh."""
    jax = _jax()
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import tree_leaves
    d = str(results[0] / "x_2x1")
    mine = restore_checkpoint(d, STEPS, steps.build_train(
        _cfg()).state_like(), device="cpu")
    tree = {}                   # the nested dicts of the paths
    for p, t in tree_leaves(mine, paths=True):
        node = tree
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.zeros(0, t.numpy().dtype)
    got = ref_restore(d, STEPS, tree)
    flat = {"/".join(str(k.key) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(got)[0]}
    mine = dict(tree_leaves(mine, paths=True))
    assert sorted(flat) == sorted(mine)
    for p, t in mine.items():
        assert flat[p].dtype == t.numpy().dtype
        np.testing.assert_array_equal(flat[p], t.numpy())


@pytest.mark.parametrize("spec", ["8", "4x2", "2x2x2"])
def test_parse_mesh_matches_the_reference(spec, monkeypatch):
    jax = _jax()
    from repro.launch import train as ref_train
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    monkeypatch.setattr(jax, "make_mesh", lambda dims, names: (dims, names))
    want_dims, want_names = ref_train.parse_mesh(spec)
    with M.fake_group(int(np.prod(want_dims))):
        mesh = train.parse_mesh(spec)
        assert tuple(mesh.shape) == tuple(want_dims)
        assert tuple(mesh.mesh_dim_names) == tuple(want_names)
    assert train.mesh_shape(spec) == (tuple(want_dims), tuple(want_names))


def test_launcher_mesh_of_the_wrong_world_size_raises(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        train.main(["--arch", ARCH, "--reduced", "--mesh", "2x2",
                    "--device", "cpu", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    assert not torch.distributed.is_initialized()


def _torchrun(args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--reduced", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "run"), "--microbatches", str(MICRO), *args],
        env=env, capture_output=True, text=True, timeout=LIMIT)


def test_launcher_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2`: 3 steps on --mesh 2x1 (rank 0
    reports once), then the same command without --mesh resumes from
    step 3 on every rank as 'data' and trains to 5."""
    from repro_torch.checkpoint import latest_step
    run = _torchrun(["--mesh", "2x1", "--steps", "3"], tmp_path)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.count("done: step 2") == 1, run.stdout
    assert "on cpu, mesh {'data': 2, 'model': 1}" in run.stdout
    d = tmp_path / "run"
    assert latest_step(str(d)) == 3
    with open(d / f"step_{3:09d}" / "manifest.json") as f:
        assert json.load(f)["mesh"] == {"shape": [2, 1],
                                        "axis_names": ["data", "model"]}
    run = _torchrun(["--steps", "5"], tmp_path)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.count("done: step 4") == 1, run.stdout
    assert "on cpu, mesh {'data': 2}" in run.stdout
    assert "'restored_step': 3" in run.stdout
    assert latest_step(str(d)) == 5
