"""Port parity: `Model.loss` and its gradients for every arch, and the
chunked cross-entropy under it, against the JAX reference's single-device
`jax.value_and_grad(Model(cfg, mesh=None).loss)` on the same weights and
batch (the reference's seeded init carried over by numpy as the stacked
tree the trainer optimizes).

Reduced configs at float32, S = 64, B = 2. Limits: the loss within 1e-5
relative; every gradient leaf within 1e-4 of the leaf's largest
magnitude (both packages run the same float32 operations and differ in
the order of float32 sums; measured at most 3.0e-6, on qwen2's w3), and
every gradient finite and not all zero.

One comparison is made at another chunk size, with its reason: the
reference's zamba2 gradient is NaN. Its Mamba2 chunk exponentiates the
masked (j > i) decays before masking them; at a chunk of 64 positions
those exponents reach past float32's range, exp gives inf, and the
masked zero's cotangent times inf is NaN through the whole backward (the
forward is unaffected). The port masks the exponent before exp (the same
forward, bit for bit). So zamba2 is held to the reference with both
packages' Mamba2 `CHUNK` set to 8, where no exponent overflows (as the
xLSTM tests set `xlstm.CHUNK`; the chunked form is exact at any chunk),
at the same limits (measured 5.2e-6), and the port at its own chunk must
be finite and agree with its chunk-8 run within 1e-4 (measured 9.0e-6).
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

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import common, ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
S, B = 64, 2


def _pair(arch, **kw):
    ref = dataclasses.replace(ref_get_config(arch).reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw)
    return ref, port


def _batch(cfg, seed=0):
    return RefData(cfg.vocab_size, S, B, family=cfg.family,
                   d_model=cfg.d_model, enc_frames=cfg.enc_frames,
                   n_patches=cfg.n_patches).batch_at(seed)


def _ref_grads(ref_cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(RefModel(ref_cfg).loss, has_aux=True))
    (loss, met), g = fn(params, batch)
    return float(loss), {k: float(v) for k, v in met.items()}, \
        jax.tree.map(np.asarray, g)


def _port_grads(cfg, params_np, batch, **loss_kw):
    tree = interop.tree_map(lambda a: torch.tensor(np.asarray(a))
                            .requires_grad_(), params_np)
    loss, met = Model(cfg, device="meta").loss(
        {k: torch.as_tensor(v) for k, v in batch.items()}, params=tree,
        **loss_kw)
    loss.backward()
    return float(loss.detach()), {k: float(v) for k, v in met.items()}, \
        interop.tree_map(lambda t: t.grad.numpy(), tree)


def _hold_grads(got, want, rel=GRAD_RTOL, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _hold_grads(got[k], want[k], rel, f"{path}/{k}")
        return
    assert got.shape == want.shape, path
    assert np.isfinite(got).all() and np.abs(got).max() > 0, path
    lim = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= lim, (path, np.abs(got - want).max(),
                                             lim)


# the recurrent and encoder-decoder families run in
# tests/test_torch_training_families.py, which imports `check_arch`
FAMILY_ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "whisper-large-v3")


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in FAMILY_ARCHS])
def test_loss_and_gradients_match_the_reference(arch):
    check_arch(arch)


def check_arch(arch):
    ref_cfg, cfg = _pair(arch)
    params = jax.tree.map(np.asarray,
                          RefModel(ref_cfg).init(jax.random.key(0)))
    batch = _batch(cfg)
    old = ssm.CHUNK, ref_ssm.CHUNK
    try:
        if cfg.family == "hybrid":          # see the module docstring
            ssm.CHUNK = ref_ssm.CHUNK = 8
        want_l, want_m, want_g = _ref_grads(ref_cfg, params, batch)
        got_l, got_m, got_g = _port_grads(cfg, params, batch)
    finally:
        ssm.CHUNK, ref_ssm.CHUNK = old
    assert abs(got_l - want_l) <= LOSS_RTOL * abs(want_l)
    for k in ("ce", "aux"):
        assert abs(got_m[k] - want_m[k]) <= LOSS_RTOL * max(abs(want_m[k]),
                                                            1.0)
    if cfg.family == "moe":
        assert got_m["aux"] > 0
    _hold_grads(got_g, want_g)
    if cfg.family == "hybrid":
        own_l, _, own_g = _port_grads(cfg, params, batch)
        assert abs(own_l - got_l) <= LOSS_RTOL * abs(got_l)
        _hold_grads(own_g, got_g)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_gradient(remat):
    _, cfg = _pair("mixtral-8x7b")
    params = jax.tree.map(np.asarray, RefModel(_pair("mixtral-8x7b")[0])
                          .init(jax.random.key(0)))
    batch = _batch(cfg)
    l0, _, g0 = _port_grads(cfg, params, batch)
    l1, _, g1 = _port_grads(dataclasses.replace(cfg, remat=remat), params,
                            batch)
    assert l1 == l0
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(a, b)


def test_loss_reads_the_modules_own_weights():
    ref_cfg, cfg = _pair("llama3.2-1b")
    params = jax.tree.map(np.asarray,
                          RefModel(ref_cfg).init(jax.random.key(0)))
    model = interop.model_params_from_numpy(cfg, params, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    own, _ = model.loss(batch)
    tree, _ = model.loss(batch, params=interop.param_tree(model))
    assert float(own) == float(tree)
    back = interop.model_params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (70, 16), (40, 512)])
def test_chunked_xent_matches_the_reference(S_, chunk):
    rng = np.random.default_rng(S_)
    h = rng.standard_normal((2, S_, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((24, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, S_)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    f = lambda h, w: ref_common.chunked_softmax_xent(  # noqa: E731
        h, w, labels, chunk=chunk)
    want, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = common.chunked_softmax_xent(ht, wt, torch.tensor(labels),
                                      chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for t, g in ((ht, gh), (wt, gw)):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()
    assert float(ht.grad[0, :5].abs().max()) == 0.0


def test_embedding_gradient_sums_repeated_tokens():
    w = torch.randn(10, 4, requires_grad=True)
    tok = torch.tensor([[1, 3, 1], [1, 0, 9]])
    g = torch.randn(2, 3, 4)
    common.embed(tok, w).backward(g)
    want = torch.zeros(10, 4)
    want.index_add_(0, tok.reshape(-1), g.reshape(-1, 4))
    assert torch.allclose(w.grad, want, atol=1e-6)
