"""Port parity: the dense model stack of `repro_torch` (common numerics,
the dense block, `Model.prefill` and `decode_step`) against the JAX
reference on the same weights, carried over by
`interop.model_params_from_numpy`.

Reduced configs at float32. The limit is 1e-5 absolute throughout: both
packages run the same float32 operations, and they differ by the order
of float32 sums in the matrix products and by the last-ulp behaviour of
rsqrt, pow, sin, cos and tanh (measured at most 3.1e-6 over every
comparison in this file).
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
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models import common, transformer as tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ATOL = 1e-5
ARCHS = ["llama3.2-1b", "qwen2-0.5b"]


def _configs(arch):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    port = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return ref, port


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(ref_cfg, cfg, ref_model, params, model) for one arch: the
    reference's seeded weights and the port's Model holding them."""
    ref_cfg, cfg = _configs(request.param)
    ref_model = RefModel(ref_cfg)
    params = ref_model.init(jax.random.key(0))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_cfg, cfg, ref_model, params, model


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_port_config_matches_reference():
    for arch in ARCHS:
        ref_cfg, cfg = _configs(arch)
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    full = get_config("llama3.2-1b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd(), full.d_ff, full.vocab_size) == (16, 2048, 32, 8, 64,
                                                       8192, 128256)
    assert full.param_count() == 1_235_814_400


@pytest.mark.parametrize("theta", [5e5, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    want = ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(common.rope(torch.tensor(x), torch.tensor(pos), theta), want)


def test_rms_norm():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    _close(common.rms_norm(torch.tensor(x), torch.tensor(scale)), want)


def test_layer_norm_and_activations():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 64).astype(np.float32)
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias))
    _close(common.layer_norm(torch.tensor(x), torch.tensor(scale),
                             torch.tensor(bias)), want)
    for name in ("silu", "gelu"):
        _close(common.act_fn(name)(torch.tensor(x)),
               ref_common.act_fn(name)(jnp.asarray(x)))


def test_untied_unembedding_prefill():
    ref_cfg, cfg = (dataclasses.replace(c, tie_embeddings=False)
                    for c in _configs("llama3.2-1b"))
    ref_model = RefModel(ref_cfg)
    params = ref_model.init(jax.random.key(1))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.arange(14, dtype=np.int32).reshape(2, 7) * 17 % cfg.vocab_size
    want, _, _ = ref_model.prefill(params, {"tokens": jnp.asarray(toks)})
    got, _, _ = model.prefill({"tokens": torch.tensor(toks)})
    _close(got, want)


def test_dense_block_prefill_and_decode(pair):
    ref_cfg, cfg, _, params, model = pair
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    rng = np.random.default_rng(3)
    B, S, W = 2, 10, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y_ref, (k_ref, v_ref) = ref_tfm.dense_block_prefill(
        bp, jnp.asarray(x), jnp.asarray(pos), ref_cfg)
    y, (k, v) = tfm.dense_block_prefill(model.blocks[0], torch.tensor(x),
                                        torch.tensor(pos), cfg)
    _close(y, y_ref)
    _close(k, k_ref)
    _close(v, v_ref)

    ck = np.zeros((B, W) + k.shape[2:], np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(k_ref), np.asarray(v_ref)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((B,), S, np.int32)
    y1_ref, ck_ref, cv_ref = ref_tfm.dense_block_decode(
        bp, jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(p1), ref_cfg)
    y1, ck_t, cv_t = tfm.dense_block_decode(
        model.blocks[0], torch.tensor(x1), torch.tensor(ck),
        torch.tensor(cv), torch.tensor(p1), cfg)
    _close(y1, y1_ref)
    _close(ck_t, ck_ref)
    _close(cv_t, cv_ref)


def test_model_prefill_and_decode_steps(pair):
    ref_cfg, cfg, ref_model, params, model = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    W = 24
    logits_ref, cache_ref, pos_ref = ref_model.prefill(
        params, {"tokens": jnp.asarray(toks)}, W=W)
    before = (kernel.flash_attention_tc.launches,
              kernel.flash_attention_f32.launches)
    logits, cache, pos = model.prefill({"tokens": torch.tensor(toks)}, W=W)
    assert (kernel.flash_attention_tc.launches,
            kernel.flash_attention_f32.launches) == before   # CPU: no launch
    assert logits.dtype == torch.float32 and logits.shape == (3,
                                                              cfg.vocab_size)
    _close(logits, logits_ref)
    for name in ("k", "v"):
        assert cache[name].shape == cache_ref[name].shape
        _close(cache[name], cache_ref[name])
    assert pos.tolist() == np.asarray(pos_ref).tolist()

    tok = np.argmax(np.asarray(logits_ref), -1).astype(np.int32)[:, None]
    for _ in range(3):
        logits_ref, cache_ref = ref_model.decode_step(
            params, cache_ref, jnp.asarray(tok), pos_ref)
        logits, cache = model.decode_step(cache, torch.tensor(tok), pos)
        _close(logits, logits_ref)
        for name in ("k", "v"):
            _close(cache[name], cache_ref[name])
        pos_ref, pos = pos_ref + 1, pos + 1
        tok = np.argmax(np.asarray(logits_ref), -1).astype(np.int32)[:, None]


def test_init_is_seeded_and_sized():
    _, cfg = _configs("qwen2-0.5b")
    a = Model(cfg, device="cpu", seed=3)
    b = Model(cfg, device="cpu", seed=3)
    c = Model(cfg, device="cpu", seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert a.param_count() == RefModel(_configs("qwen2-0.5b")[0]).param_count()
    assert float(a.embed.abs().max()) <= 3 * 0.02 + 1e-7   # truncated at 3σ
    assert torch.equal(a.blocks[0].attn.bq, torch.zeros_like(
        a.blocks[0].attn.bq))


@pytest.mark.parametrize("arch,over", [
    ("mixtral-8x7b", {}), ("zamba2-2.7b", {}), ("xlstm-1.3b", {}),
    ("whisper-large-v3", {}), ("internvl2-1b", {}),
    ("llama3.2-1b", {"kv_dtype": "int8"}),
    ("llama3.2-1b", {"sliding_window": 32})])
def test_deferred_families_raise(arch, over):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")
