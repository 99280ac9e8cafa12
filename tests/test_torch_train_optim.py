"""Port parity: the training substrate under the model, against the JAX
reference on the same inputs: the synthetic data stream, the learning-rate
schedules, AdamW and Adafactor on a stacked parameter tree, gradient
compression, and the train step (`launch.steps.build_train`) against a
reference loop of `jax.value_and_grad(Model.loss)`, `make_optimizer`,
`make_schedule_for` and the NaN guard.

Limits, each with its reason:
- data batches and compression: bit for bit (numpy in both; the same
  float32 operations in the same order on whole arrays);
- schedules: 1e-7 absolute on learning rates of at most 3e-4 (float32 in
  both; exp and cos may differ by an ulp between XLA and torch);
- optimizers: 2e-6 of each leaf's largest magnitude over 5 steps: the
  same float32 algebra and the leaves summed in the same (sorted) order,
  but each leaf's sum of squares in the global norm reduces in another
  order (norms 2.7e-7 apart at most), the clip scale carries that into
  every leaf, and the 0-d leaf's first moment, a sum of gradients of
  both signs, cancels (measured 1.18e-6 there, 5.9e-7 for Adafactor);
- microbatches=2 against one batch: the same, 1e-6 relative on the
  metrics and 1e-5 of each leaf's largest magnitude on the state (two
  half-batch gradients summed differ from the whole batch's by float32
  sum order, which the second moment squares: 2.3e-6 measured on wk);
- train steps: the loss and metrics within 1e-5 relative, the parameters
  and moments within 1e-5 of each leaf's largest magnitude after 3 steps
  (the gradients differ by float32 sum order, up to 3e-6 of their
  largest, tests/test_torch_training.py).
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import make_batch_iterator as ref_batches  # noqa: E402
from repro.launch.steps import make_schedule_for as ref_schedule_for  # noqa: E402,E501
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import adafactor as ref_adafactor  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import schedules as ref_sched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLMData, make_batch_iterator  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import (adafactor, adamw, compression,  # noqa: E402
                               make_optimizer, schedules)

SHAPE = ShapeConfig("tiny_train", 64, 4, "train")


def _np(tree):
    return interop.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _t(tree):
    return interop.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _hold(got, want, rel, path=""):
    """Every leaf of `got` within rel of the leaf's largest |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _hold(got[k], want[k], rel, f"{path}/{k}")
        return
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, path
    lim = rel * max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() <= lim, (path, np.abs(g - w).max(), lim)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batches_equal_the_reference(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    shape = ShapeConfig("t", 48, 6, "train")
    for shard, start in ((0, 0), (1, 5)):
        _, got = make_batch_iterator(cfg, shape, seed=3, n_shards=2,
                                     shard=shard, start_step=start)
        _, want = ref_batches(ref_cfg, RefShape("t", 48, 6, "train"),
                              seed=3, n_shards=2, shard=shard,
                              start_step=start)
        for _ in range(2):
            g, w = next(got), next(want)
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    if cfg.family == "vlm":
        assert g["tokens"].shape == (3, 48 - cfg.n_patches)
        assert g["patches"].shape == (3, cfg.n_patches, cfg.d_model)


def test_data_pipeline_pure_and_sharded():
    ds = SyntheticLMData(vocab_size=100, seq_len=16, global_batch=8,
                         n_shards=2, shard=1)
    a = ds.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], ds.batch_at(5)["tokens"])
    ds0 = dataclasses.replace(ds, shard=0)
    assert not np.array_equal(ds0.batch_at(5)["tokens"], a["tokens"])
    assert not np.array_equal(ds.batch_at(6)["tokens"], a["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
    ("cosine", dict(peak_lr=1e-3, warmup_steps=1, total_steps=7,
                    min_ratio=0.2)),
    ("wsd", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
    ("wsd", dict(peak_lr=2e-3, warmup_steps=3, total_steps=50,
                 decay_frac=0.3, min_ratio=0.05))])
def test_schedules_match_the_reference(name, kw):
    fn = schedules.make_schedule(name, **kw)
    ref = ref_sched.make_schedule(name, **kw)
    for step in range(kw["total_steps"] + 5):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(ref(jnp.int32(step)))
        assert abs(float(got) - want) <= 1e-7, (step, float(got), want)
    assert float(fn(3)) == float(fn(torch.tensor(3)))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm-2b"])
def test_make_schedule_for_matches_the_reference(arch):
    got = steps.make_schedule_for(get_config(arch), 500)
    want = ref_schedule_for(ref_get_config(arch), 500)
    for step in (0, 2, 5, 100, 449, 450, 499, 500):
        assert abs(float(got(step)) - float(want(jnp.int32(step)))) <= 1e-7


# ---------------------------------------------------------------------------
# optimizers on a stacked tree
# ---------------------------------------------------------------------------

def _stacked_tree(seed):
    """A stacked tree with a (L, d) norm leaf, a factored >= 128 leaf
    (L, 128, 160), an unfactored matrix, a vector and a 0-d leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"blocks": {"n1": {"scale": 1 + 0.1 * f(3, 24)},
                       "w": 0.05 * f(3, 128, 160),
                       "b": f(3, 24, 40)},
            "embed": 0.02 * f(50, 24), "bias": f(7), "scalar": f()}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_match_the_reference(kind):
    sched = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20)
    if kind == "adamw":
        opt = adamw(schedules.make_schedule("cosine", **sched))
        ref = ref_adamw(ref_sched.make_schedule("cosine", **sched))
    else:
        opt = adafactor(schedules.make_schedule("cosine", **sched))
        ref = ref_adafactor(ref_sched.make_schedule("cosine", **sched))
    params = _stacked_tree(0)
    p_t, p_r = _t(params), jax.tree.map(jnp.asarray, params)
    s_t, s_r = opt.init(p_t), ref.init(p_r)
    if kind == "adafactor":
        assert set(s_t["v"]["blocks"]["w"]) == {"vr", "vc"}
        assert s_t["v"]["blocks"]["w"]["vr"].shape == (3, 128)
        assert set(s_t["v"]["blocks"]["b"]) == {"v"}
    for step in range(5):
        g = _stacked_tree(100 + step)
        p_t, s_t, st_t = opt.update(_t(g), s_t, p_t,
                                    torch.tensor(step, dtype=torch.int32))
        p_r, s_r, st_r = ref.update(jax.tree.map(jnp.asarray, g), s_r, p_r,
                                    jnp.int32(step))
        _hold(_np(p_t), jax.tree.map(np.asarray, p_r), 2e-6)
        _hold(_np(s_t), jax.tree.map(np.asarray, s_r), 2e-6)
        assert abs(float(st_t["grad_norm"]) - float(st_r["grad_norm"])) \
            <= 1e-6 * float(st_r["grad_norm"])


def test_adamw_decays_a_stacked_norm_leaf():
    """AdamW decays a leaf iff it has >= 2 dims: the stacked (L, d) norm
    scale is decayed, its per-layer (d,) slice would not be."""
    opt = adamw(lambda step: torch.tensor(1e-2), weight_decay=0.5)
    p = {"n": torch.ones((2, 4)), "v": torch.ones((4,))}
    g = {"n": torch.zeros((2, 4)), "v": torch.zeros((4,))}
    newp, _, _ = opt.update(g, opt.init(p), p, 0)
    assert float(newp["n"][0, 0]) == pytest.approx(1 - 1e-2 * 0.5)
    assert float(newp["v"][0]) == 1.0


def test_adafactor_clips_over_the_whole_stacked_leaf():
    """The RMS update clip takes its mean over every layer of a stacked
    leaf at once. Two steps (gradients under the global-norm clip): layer
    0 sees the same gradient twice, so its second update alone has RMS 1
    and is not clipped; layer 1's second gradient is 10 times its first,
    so its update is r = 10 / sqrt(beta + (1 - beta) 100); stacked, the
    leaf's RMS sqrt((1 + r^2) / 2) clips layer 0's update too."""
    opt = adafactor(lambda step: torch.tensor(1.0))
    g1 = torch.full((2, 4, 4), 0.01)
    g2 = g1.clone()
    g2[1] *= 10

    def second_update(sl):
        p = {"w": torch.zeros((2, 4, 4))[sl]}
        state = opt.init(p)
        p, state, _ = opt.update({"w": g1[sl]}, state, p, 0)
        before = p["w"].clone()
        p, state, _ = opt.update({"w": g2[sl]}, state, p, 1)
        return before - p["w"]

    beta = 1 - 2.0 ** -0.8
    r = 10 / (beta + (1 - beta) * 100) ** 0.5
    alone = second_update(slice(0, 1))
    stacked = second_update(slice(None))
    assert torch.allclose(alone, torch.ones_like(alone))
    want = 1 / ((1 + r * r) / 2) ** 0.5
    assert torch.allclose(stacked[0], torch.full((4, 4), want), rtol=1e-5)
    assert torch.allclose(stacked[1], torch.full((4, 4), r * want),
                          rtol=1e-5)


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "adamw"),
                                       ("arctic-480b", "adafactor")])
def test_make_optimizer_picks_the_configs(arch, kind):
    cfg = get_config(arch)
    opt = make_optimizer(cfg, lambda step: torch.tensor(1e-3))
    state = opt.init({"w": torch.zeros((3, 130, 130))})
    assert set(state) == ({"mu", "nu"} if kind == "adamw" else {"v"})
    ref = ref_make_optimizer(ref_get_config(arch), lambda step: 1e-3)
    assert set(ref.init({"w": jnp.zeros((3, 130, 130))})) == set(state)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compression_equals_the_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((130, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((2050,)).astype(np.float32)}}
    err_t = err_r = None
    for step in range(3):
        g = interop.tree_map(lambda x: x * np.float32(1 + 0.1 * step), tree)
        comp_t, err_t = compression.compress_grads(_t(g), err_t)
        comp_r, err_r = ref_comp.compress_grads(
            jax.tree.map(jnp.asarray, g), err_r)
        for path in (("a",), ("b", "c")):
            ct, cr = comp_t, comp_r
            et, er = err_t, err_r
            for k in path:
                ct, cr, et, er = ct[k], cr[k], et[k], er[k]
            np.testing.assert_array_equal(ct.q.numpy(), np.asarray(cr.q))
            np.testing.assert_array_equal(ct.scale.numpy(),
                                          np.asarray(cr.scale))
            assert ct.shape == tuple(cr.shape) and ct.n == cr.n
            np.testing.assert_array_equal(et.numpy(), np.asarray(er))
        dt = compression.decompress_grads(comp_t)
        dr = ref_comp.decompress_grads(comp_r)
        np.testing.assert_array_equal(dt["b"]["c"].numpy(),
                                      np.asarray(dr["b"]["c"]))
    assert compression.wire_bytes_ratio() == ref_comp.wire_bytes_ratio()


# ---------------------------------------------------------------------------
# the train step against a reference loop
# ---------------------------------------------------------------------------

def _ref_loop(ref_cfg, params, batches, total_steps):
    """The reference's train step semantics on one device: value_and_grad
    of the cast master, make_optimizer, make_schedule_for, the guard."""
    model = RefModel(ref_cfg)
    opt = ref_make_optimizer(ref_cfg, ref_schedule_for(ref_cfg, total_steps))
    master = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    state = {"params": master, "opt": opt.init(master), "step": jnp.int32(0)}

    @jax.jit
    def step(state, batch):
        def lossfn(m):
            p = jax.tree.map(lambda x, s: x.astype(s.dtype), m, params)
            return model.loss(p, batch)
        (loss, met), g = jax.value_and_grad(lossfn, has_aux=True)(
            state["params"])
        newp, newopt, st = opt.update(g, state["opt"], state["params"],
                                      state["step"])
        good = jnp.isfinite(loss) & jnp.isfinite(st["grad_norm"])
        sel = lambda a, b: jax.tree.map(  # noqa: E731
            lambda x, y: jnp.where(good, x, y), a, b)
        return ({"params": sel(newp, state["params"]),
                 "opt": sel(newopt, state["opt"]), "step": state["step"] + 1},
                {"loss": loss, "ce": met["ce"], "aux": met["aux"],
                 "grad_norm": st["grad_norm"], "lr": st["lr"]})

    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm-2b", "arctic-480b"])
def test_train_steps_match_a_reference_loop(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    ds = SyntheticLMData(cfg.vocab_size, 64, 4, family=cfg.family,
                         d_model=cfg.d_model)
    batches = [ds.batch_at(s) for s in range(3)]
    want, want_m = _ref_loop(ref_cfg, params, batches, 100)

    bundle = steps.build_train(cfg, total_steps=100)
    state = {"params": interop.tree_map(
                 lambda a: torch.tensor(np.asarray(a, np.float32)),
                 jax.tree.map(np.asarray, params))}
    state["opt"] = bundle.opt.init(state["params"])
    state["step"] = torch.zeros((), dtype=torch.int32)
    for b, wm in zip(batches, want_m):
        state, m = bundle.step(state, steps.to_device(b, "cpu"))
        for k, v in wm.items():
            assert abs(float(m[k]) - v) <= 1e-5 * max(abs(v), 1e-3), (k, v)
    got = interop.train_state_to_numpy(state)
    assert int(got["step"]) == 3 == int(want["step"])
    _hold(got["params"], want["params"], 1e-5)
    _hold(got["opt"], want["opt"], 1e-5)


def test_microbatches_equal_one_batch():
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              n_layers=2, dtype="float32")
    batch = steps.to_device(SyntheticLMData(
        cfg.vocab_size, 64, 4).batch_at(0), "cpu")
    from repro_torch.models.model import Model
    out = []
    for mb in (1, 2):
        bundle = steps.build_train(cfg, microbatches=mb, total_steps=50)
        state = bundle.init_state(Model(cfg, device="cpu", seed=0))
        for _ in range(2):
            state, m = bundle.step(state, batch)
        out.append((interop.train_state_to_numpy(state),
                    {k: float(v) for k, v in m.items()}))
    (s1, m1), (s2, m2) = out
    for k in m1:
        assert m2[k] == pytest.approx(m1[k], rel=1e-6, abs=1e-9)
    _hold(s2["params"], s1["params"], 1e-5)
    _hold(s2["opt"], s1["opt"], 1e-5)


def test_uneven_microbatches_raise():
    """A batch that does not split into the microbatches raises, as the
    reference's reshape does, and never trains on part of it."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              n_layers=1, dtype="float32")
    from repro_torch.models.model import Model
    bundle = steps.build_train(cfg, microbatches=3, total_steps=50)
    state = bundle.init_state(Model(cfg, device="cpu", seed=0))
    batch = steps.to_device(SyntheticLMData(
        cfg.vocab_size, 16, 4).batch_at(0), "cpu")
    with pytest.raises(ValueError, match="does not split into 3"):
        bundle.step(state, batch)


def test_batch_specs_match_the_pipeline():
    for arch in ("llama3.2-1b", "whisper-large-v3", "internvl2-1b"):
        cfg = get_config(arch).reduced()
        specs = steps.batch_specs(cfg, SHAPE)
        _, it = make_batch_iterator(cfg, SHAPE)
        b = next(it)
        assert set(specs) == set(b)
        for k, (shape, _) in specs.items():
            assert b[k].shape == shape
