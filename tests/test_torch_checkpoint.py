"""The port's checkpoints and trainer: the reference's on-disk layout
(a checkpoint either package wrote restores in the other, both ways,
bit for bit), atomicity, retention and async saves; the port's versions
of the reference's trainer tests (tests/test_training.py: the loss falls,
a preempted and resumed run equals the uninterrupted one bit for bit,
the NaN guard, straggler counting, telemetry); and the launchers
(`launch.train --reduced --device cpu`, `launch.serve --ckpt-dir`)."""
import dataclasses
import glob
import json
import os
import signal

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402,E501
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import TelemetryCollector  # noqa: E402
from repro_torch.runtime.profile import measured_profile  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

SHAPE = ShapeConfig("tiny_train", 64, 4, "train")


def _tiny_cfg():
    return dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               name="tiny", n_layers=2, dtype="float32")


def _trainer(d, **kw):
    return Trainer(_tiny_cfg(), None, SHAPE, TrainConfig(
        ckpt_dir=str(d), log_every=100, log_fn=lambda *a: None,
        device="cpu", **kw))


# ---------------------------------------------------------------------------
# layout, atomicity, retention, async
# ---------------------------------------------------------------------------

def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"w": torch.arange(10.0), "b": {"x": torch.ones((3, 3))}}
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3):
        cm.save(s, tree)
    steps_ = sorted(int(p.split("_")[-1]) for p in
                    glob.glob(str(tmp_path / "step_*")))
    assert steps_ == [2, 3]
    assert latest_step(str(tmp_path)) == 3
    os.makedirs(tmp_path / "step_000000009")         # uncommitted
    os.makedirs(tmp_path / "step_000000010.tmp")
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), 9, tree)
    files = sorted(os.listdir(tmp_path / "step_000000003"))
    assert files == ["COMMIT", "manifest.json", "shard_00000.npz"]
    with open(tmp_path / "step_000000003" / "manifest.json") as f:
        man = json.load(f)
    assert [m["path"] for m in man["leaves"]] == ["b/x", "w"]
    assert man["step"] == 3 and man["version"] == 1


def test_async_checkpoint_copies_before_the_step_moves(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    w = torch.ones((64, 64))
    cm.save_async(5, {"w": w})
    w.add_(1.0)                 # the loop goes on changing its tensors
    cm.wait()
    assert latest_step(str(tmp_path)) == 5
    step, out = cm.restore_latest({"w": torch.empty((64, 64),
                                                    device="meta")})
    assert step == 5 and out["w"].device.type == "cpu"
    np.testing.assert_array_equal(out["w"].numpy(), np.ones((64, 64)))


def test_restore_reads_only_the_leaves_asked_for(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"mu": {"w": torch.zeros(2, 3)}},
             "step": torch.tensor(4, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 4, state)
    out = restore_checkpoint(str(tmp_path), 4,
                             {"params": {"w": torch.empty(
                                 (2, 3), dtype=torch.bfloat16)}})
    assert set(out) == {"params"} and out["params"]["w"].dtype \
        == torch.bfloat16
    assert out["params"]["w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 4, {"nope": torch.zeros(1)})


def _ref_state(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(1))
    master = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    opt = ref_make_optimizer(ref_cfg, lambda s: 1e-3)
    rng = np.random.default_rng(0)
    o = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), opt.init(master))
    return {"params": master, "opt": o, "step": jnp.int32(7)}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b"])
def test_reference_written_checkpoint_restores_in_the_port(tmp_path, arch):
    ref = _ref_state(arch)
    ref_save(str(tmp_path), 7, ref)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    like = steps.build_train(cfg).state_like()
    got = restore_checkpoint(str(tmp_path), 7, like, device="cpu")
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, ref),
                                          device="cpu")
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b"])
def test_port_written_checkpoint_restores_in_the_reference(tmp_path, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    bundle = steps.build_train(cfg)
    state = bundle.init_state(Model(cfg, device="cpu", seed=3))
    state["opt"] = interop.tree_map(lambda t: torch.randn_like(t),
                                    state["opt"])
    state["step"] = torch.tensor(9, dtype=torch.int32)
    save_checkpoint(str(tmp_path), 9, state)
    like = jax.tree.map(np.asarray, _ref_state(arch))
    got = ref_restore(str(tmp_path), 9, like)
    want = interop.train_state_to_numpy(state)
    for path, a in jax.tree_util.tree_flatten_with_path(got)[0]:
        b = want
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the trainer (the reference's tests/test_training.py, on the port)
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    _, hist = _trainer(tmp_path, total_steps=30, ckpt_every=100).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


def test_checkpoint_restart_bit_identical(tmp_path):
    mk = lambda d, **kw: _trainer(d, total_steps=12,  # noqa: E731
                                  ckpt_every=6, **kw)
    st_a, hist_a = mk(tmp_path / "a").run()
    mk(tmp_path / "b", preempt_at=7).run()
    assert latest_step(str(tmp_path / "b")) == 7
    tr = mk(tmp_path / "b")
    st_b, hist_b = tr.run()
    assert tr.stats["restored_step"] == 7
    for a, b in zip(tree_leaves(st_a), tree_leaves(st_b)):
        assert torch.equal(a, b)
    losses = {h["step"]: h["loss"] for h in hist_a}
    assert [h["step"] for h in hist_b] == list(range(7, 12))
    for h in hist_b:
        assert h["loss"] == losses[h["step"]]


def test_nan_guard_skips_update():
    cfg = _tiny_cfg()
    bundle = steps.build_train(cfg)
    state = bundle.init_state(Model(cfg, device="cpu", seed=0))
    state["params"]["embed"][0, 0] = float("inf")
    before = interop.train_state_to_numpy(state)
    bad = steps.to_device({"tokens": np.zeros((4, 64), np.int32),
                           "labels": np.zeros((4, 64), np.int32)}, "cpu")
    new, metrics = bundle.step(state, bad)
    assert not np.isfinite(float(metrics["loss"]))
    after = interop.train_state_to_numpy(new)
    for a, b in zip(tree_leaves(after["params"]),
                    tree_leaves(before["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(after["opt"]), tree_leaves(before["opt"])):
        np.testing.assert_array_equal(a, b)
    assert int(new["step"]) == 1


def test_bad_steps_are_counted_and_bounded(tmp_path):
    tr = _trainer(tmp_path, total_steps=5, ckpt_every=100, max_bad_steps=2)
    state = tr.init_state()
    state["params"]["final_norm"]["scale"][0] = float("nan")
    tr.init_state = lambda: state
    with pytest.raises(RuntimeError, match="too many bad steps"):
        tr.run()
    assert tr.stats["bad_steps"] == 3


def test_straggler_steps_are_counted(tmp_path, monkeypatch):
    import repro_torch.training.loop as loop
    clock = iter(np.cumsum([0.0] + [0.1, 0.0] * 7 + [5.0, 0.0]
                           + [0.1, 0.0] * 2).tolist())
    monkeypatch.setattr(loop.time, "time", lambda: next(clock))
    tr = _trainer(tmp_path, total_steps=10, ckpt_every=100)
    tr.run()
    assert tr.stats["straggler_steps"] == 1


@pytest.mark.parametrize("exit_by", ["end", "sigterm", "error"])
def test_run_restores_the_callers_sigterm_handler(tmp_path, exit_by):
    """A SIGTERM during run() checkpoints and exits, as the reference's
    trainer does; on every exit (the last step, a SIGTERM, a raise) the
    handler the caller had is back in place."""
    seen = []

    def mine(signum, frame):
        seen.append(signum)

    def log_fn(msg):
        if exit_by == "sigterm" and msg.startswith("step 0:"):
            os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.signal(signal.SIGTERM, mine)
    try:
        tr = _trainer(tmp_path, total_steps=3, ckpt_every=100,
                      max_bad_steps=0)
        tr.tcfg.log_every, tr.tcfg.log_fn = 1, log_fn
        if exit_by == "error":
            state = tr.init_state()
            state["params"]["final_norm"]["scale"][0] = float("nan")
            tr.init_state = lambda: state
            with pytest.raises(RuntimeError, match="too many bad steps"):
                tr.run()
        else:
            _, hist = tr.run()
            want = 1 if exit_by == "sigterm" else 3
            assert len(hist) == want and latest_step(str(tmp_path)) == want
        assert seen == [] and signal.getsignal(signal.SIGTERM) is mine
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_training_telemetry(tmp_path):
    col = TelemetryCollector()
    _trainer(tmp_path, total_steps=4, ckpt_every=100, telemetry=col).run()
    win = col.snapshot()
    assert win.train_steps == 4
    assert win.train_tokens == 4 * 64 * 4
    assert win.train_time_s > 0
    mp = measured_profile(win, _tiny_cfg())
    assert mp.kind == "train"


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_and_serve_launchers(tmp_path, capsys):
    d = str(tmp_path / "run")
    assert train.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                       "cpu", "--steps", "3", "--ckpt-every", "2",
                       "--ckpt-dir", d]) == 0
    assert "done: step 2" in capsys.readouterr().out
    assert latest_step(d) == 3
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              name="llama3.2-1b", dtype="float32")
    step, model = serve.model_from_checkpoint(cfg, d, device="cpu")
    state = restore_checkpoint(d, 3, steps.build_train(cfg).state_like(),
                               device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(interop.param_tree(model)),
                    tree_leaves(state["params"])):
        assert torch.equal(a, b)
    streams = tmp_path / "streams.jsonl"
    assert serve.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "4",
                       "--ckpt-dir", d, "--greedy", "--output",
                       str(streams)]) == 0
    out = capsys.readouterr().out
    assert "restored params from step 3" in out and "served 2 requests" in out
    lines = [json.loads(x) for x in streams.read_text().splitlines()]
    assert [r["rid"] for r in lines] == [0, 1]
    assert all(len(r["tokens"]) == 4 for r in lines)
