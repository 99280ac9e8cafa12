"""Port parity: the model stack of `repro_torch` (common numerics, the
dense, encoder and cross-attention decoder blocks, `Model.prefill` and
`decode_step` for every family, the int8 KV cache and the sliding-window
ring) against the JAX reference on the same weights, carried over by
`interop.model_params_from_numpy`.

Reduced configs at float32. The limit is 1e-5 absolute throughout: both
packages run the same float32 operations, and they differ by the order
of float32 sums in the matrix products and by the last-ulp behaviour of
rsqrt, pow, sin, cos and tanh (measured at most 3.1e-6 over every
comparison in this file).

One limit is loosened, with its reason: the hybrid family's (zamba2)
logits are held at 2e-5. Its Mamba2 layers amplify the ulp-level
difference their input arrives with: fed the same input, a layer of the
port and of the reference agree within 1e-6 (tests/test_torch_ssm.py),
but after the first shared attention block the hidden states differ by
1.5e-6 and one Mamba2 layer later by 4.8e-6, so the prefill logits of
reduced zamba2 end 1.01e-5 apart (S = 24; measured).

The ssm family's (xlstm) cell and normalizer states in the cache, the
mLSTM's "mC" and "mN" and the sLSTM's "sc" and "sn", are held at 1e-6 of
their largest magnitude: each accumulates every prompt position's
float32 terms (the mLSTM's in BLAS's order here and in XLA's in the
reference), reaches up to 258 at S = 512, and parts by a few ulp of its
magnitude (measured 6.1e-5 on sn = 145, 4.2e-7 of it;
tests/test_torch_xlstm.py). Its logits, the stabilizers, the conv
history and the sLSTM's h keep 1e-5.
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
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ATOL = 1e-5
ATOL_HYBRID = 2e-5     # see the module docstring
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


def _close(got, want, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


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


@pytest.mark.parametrize("what", ["Model.loss", "chunked_softmax_xent",
                                  "serve --ckpt-dir"])
def test_deferred_families_raise(what, tmp_path):
    """What was deferred until training (Queue 1 item 13c) runs now:
    `Model.loss`, `chunked_softmax_xent` (held to the reference in
    tests/test_torch_training.py) and serve's `--ckpt-dir`, which serves
    the seeded weights when the directory holds no checkpoint."""
    _, cfg = _configs("llama3.2-1b")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    calls = {
        "Model.loss": lambda: Model(cfg, device="cpu").loss(
            {"tokens": tok, "labels": tok})[0],
        "chunked_softmax_xent": lambda: common.chunked_softmax_xent(
            torch.zeros((1, 2, 4)), torch.zeros((4, 8)),
            torch.zeros((1, 2), dtype=torch.int32)),
        "serve --ckpt-dir": lambda: torch.tensor(float(serve.main(
            ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
             "--requests", "1", "--max-new", "2",
             "--ckpt-dir", str(tmp_path)]))),
    }
    got = calls[what]()
    assert bool(torch.isfinite(got))
    if what == "chunked_softmax_xent":
        assert float(got) == pytest.approx(np.log(8))


# ---------------------------------------------------------------------------
# the moe and hybrid families, the int8 KV cache and the sliding-window ring
# ---------------------------------------------------------------------------

# (arch, config overrides): reduced mixtral (moe, a 32-row ring), zamba2
# (hybrid: 4 Mamba2 layers, the shared block after every 2), llama with
# an int8 cache, llama with a sliding window (a dense ring) and arctic
# (moe with its dense residual MLP)
FAMILY_CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "zamba2": ("zamba2-2.7b", {}),
    "llama-int8": ("llama3.2-1b", {"kv_dtype": "int8"}),
    "llama-ring": ("llama3.2-1b", {"sliding_window": 32}),
    "arctic": ("arctic-480b", {}),
    "xlstm": ("xlstm-1.3b", {}),
    "whisper": ("whisper-large-v3", {}),
    "internvl2": ("internvl2-1b", {}),
}


def _family_pair(name, seed=0):
    arch, over = FAMILY_CASES[name]
    ref_cfg, cfg = (dataclasses.replace(c, **over) for c in _configs(arch))
    ref_model = RefModel(ref_cfg)
    params = ref_model.init(jax.random.key(seed))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_cfg, cfg, ref_model, params, model


def _close_cache(cache, cache_ref, atol=ATOL):
    assert set(cache) == set(cache_ref)
    for name, want in cache_ref.items():
        got = cache[name]
        assert tuple(got.shape) == tuple(want.shape), name
        if got.dtype in (torch.int8, torch.bfloat16):
            # int8 values and bf16 scales: bit for bit
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        elif name in ("mC", "mN", "sc", "sn"):
            # sums over the prompt: see the module docstring
            _close(got, want, max(1.0, float(np.abs(want).max())) * 1e-6)
        else:
            _close(got, want, atol)


def _frontend(cfg, rng, B):
    """Seeded stub-frontend inputs of a family, as numpy: the audio
    family's frames (B, F, d), the vlm family's patches (B, P, d)."""
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    return {}


# (case, prompt length, cache window W): the rings hold 32 rows, so 20,
# 32 and 40 seed them at S < W, S = W and S > W; zamba2's 24 and 64 are
# one chunk of its Mamba2 scan each; xlstm's 2 (shorter than the conv
# history) and 40 are one chunk of its mLSTM, 512 two; whisper runs its
# 8 seeded frames, internvl2 its 4 seeded patches before the prompt
@pytest.mark.parametrize("name,S,W", [
    ("mixtral", 20, 64), ("mixtral", 32, 64), ("mixtral", 40, 64),
    ("llama-ring", 40, 64), ("zamba2", 24, 40), ("zamba2", 64, 80),
    ("llama-int8", 12, 24), ("arctic", 10, 16), ("xlstm", 2, 8),
    ("xlstm", 40, 48), ("xlstm", 512, 520), ("whisper", 9, 24),
    ("whisper", 1, 8), ("internvl2", 7, 16), ("internvl2", 12, 24)])
def test_family_prefill_and_decode_steps(name, S, W):
    """Prefill logits, cache and pos (the vlm family's counts its
    patches), then decode steps (past the ring's wrap for the windowed
    models), against the reference within 1e-5; int8 caches and their
    scales bit for bit."""
    ref_cfg, cfg, ref_model, params, model = _family_pair(name)
    atol = ATOL_HYBRID if cfg.family == "hybrid" else ATOL
    rng = np.random.default_rng(S + W)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    extra = _frontend(cfg, rng, 2)
    logits_ref, cache_ref, pos_ref = ref_model.prefill(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in extra.items()}}, W=W)
    logits, cache, pos = model.prefill(
        {"tokens": torch.tensor(toks),
         **{k: torch.tensor(v) for k, v in extra.items()}}, W=W)
    _close(logits, logits_ref, atol)
    _close_cache(cache, cache_ref, atol)
    assert pos.tolist() == np.asarray(pos_ref).tolist() == \
        [S + cfg.n_patches] * 2
    tok = np.argmax(np.asarray(logits_ref), -1).astype(np.int32)[:, None]
    for _ in range(4):
        logits_ref, cache_ref = ref_model.decode_step(
            params, cache_ref, jnp.asarray(tok), pos_ref)
        logits, cache = model.decode_step(cache, torch.tensor(tok), pos)
        _close(logits, logits_ref, atol)
        _close_cache(cache, cache_ref, atol)
        pos_ref, pos = pos_ref + 1, pos + 1
        tok = np.argmax(np.asarray(logits_ref), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal(dtype):
    """int8 values and bf16 scales equal the reference's bit for bit,
    including ties: rows whose largest magnitude is 127 have scale 1, so
    their halves round to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, 4, 16)).astype(np.float32) * 3
    x[0, 0, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                           -127, 0, 63.5, -63.5, 126.5, 0.25, 0.75, 1])
    x[0, 0, 1] = 0.0                                 # an all-zero row
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want_q, want_s = ref_attention.quantize_kv(jnp.asarray(x, jt))
    got_q, got_s = attention.quantize_kv(torch.tensor(x).to(tt))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s, np.float32))
    assert got_q[0, 0, 0, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("S", [5, 8, 13])
def test_seed_ring_cache(S):
    """The ring seeding at S < W, S = W and S > W (W = 8), bit for bit,
    also over a leading layer axis."""
    rng = np.random.default_rng(S)
    k = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    v = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    want = ref_attention.seed_ring_cache(jnp.asarray(k), jnp.asarray(v), 8)
    got = attention.seed_ring_cache(torch.tensor(k), torch.tensor(v), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stacked = attention.seed_ring_cache(torch.tensor(k)[None],
                                        torch.tensor(v)[None], 8)
    assert torch.equal(stacked[0][0], got[0])
    if S > 8:   # slot pos % 8 holds position pos of the last 8
        for p in range(S - 8, S):
            assert torch.equal(got[0][:, p % 8], torch.tensor(k)[:, p])


@pytest.mark.parametrize("ring,int8", [(True, False), (False, True)])
def test_attention_decode_ring_and_int8(ring, int8):
    """One decode step of attention against a ring cache (rows at pos < W
    and at pos >= W, so the slot wraps) or an int8 cache with scales."""
    _, cfg = _configs("llama3.2-1b")
    ref_cfg = _configs("llama3.2-1b")[0]
    params = RefModel(ref_cfg).init(jax.random.key(2))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    ap = jax.tree.map(lambda a: a[0], params["blocks"])["attn"]
    rng = np.random.default_rng(int(ring))
    B, W, K, hd = 3, 8, cfg.n_kv_heads, cfg.hd()
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([3, 8, 13], np.int32)
    ck = rng.standard_normal((B, W, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, W, K, hd)).astype(np.float32)
    if int8:
        kq, ks = ref_attention.quantize_kv(jnp.asarray(ck))
        vq, vs = ref_attention.quantize_kv(jnp.asarray(cv))
        want = ref_attention.decode(ap, jnp.asarray(x), kq, vq,
                                    jnp.asarray(pos), ref_cfg,
                                    scales=(ks, vs))
        t = lambda a: torch.tensor(np.asarray(a, np.float32))
        got = attention.decode(
            model.blocks[0].attn, torch.tensor(x), t(kq).to(torch.int8),
            t(vq).to(torch.int8), torch.tensor(pos), cfg,
            scales=(t(ks).bfloat16(), t(vs).bfloat16()))
        _close(got[0], want[0])
        for g, w in zip(got[1:3] + got[3], want[1:3] + want[3]):
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        return
    want = ref_attention.decode(ap, jnp.asarray(x), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(pos), ref_cfg,
                                ring=True)
    got = attention.decode(model.blocks[0].attn, torch.tensor(x),
                           torch.tensor(ck), torch.tensor(cv),
                           torch.tensor(pos), cfg, ring=True)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-2.7b",
                                  "arctic-480b", "xlstm-1.3b",
                                  "whisper-large-v3", "internvl2-1b"])
def test_full_width_parameter_counts(arch):
    """Counted on the meta device (shapes only): the reference's
    `param_count()` and `param_count(active_only=True)`, by its expert
    formula."""
    model = Model(get_config(arch), device="meta")
    ref = RefModel(ref_get_config(arch))
    assert model.param_count() == ref.param_count()
    assert model.param_count(active_only=True) == \
        ref.param_count(active_only=True)
    want = {"mixtral-8x7b": (46_702_792_704, 12_879_925_248),
            "zamba2-2.7b": (2_422_532_000, 2_422_532_000),
            "xlstm-1.3b": (2_197_576_016,) * 2,
            "whisper-large-v3": (2_020_628_480,) * 2,
            "internvl2-1b": (493_780_992,) * 2}
    if arch in want:
        assert (model.param_count(),
                model.param_count(active_only=True)) == want[arch]


# ---------------------------------------------------------------------------
# the audio family's pieces: sinusoidal positions, the encoder block, the
# cross-attention decoder block and cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(8, 64), (1500, 1280), (37, 6)])
def test_sinusoidal_positions(n, d):
    """The prefill table: numpy float64 cast to float32, bit for bit."""
    got = common.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_common.sinusoidal_positions(n, d)))


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_at(d):
    """The decode embedding, float32 on the device: against the
    reference, and against the prefill table at the same positions (they
    differ by float32 rounding of the angle, not by formula)."""
    pos = np.array([0, 1, 7, 30, 447], np.int32)
    got = common.sinusoid_at(torch.tensor(pos), d)
    assert got.shape == (5, 1, d) and got.dtype == torch.float32
    _close(got, ref_common.sinusoid_at(jnp.asarray(pos), d))
    table = common.sinusoidal_positions(448, d)[torch.tensor(pos).long()]
    np.testing.assert_allclose(got[:, 0].numpy(), table.numpy(), rtol=0,
                               atol=1e-4)


@pytest.fixture(scope="module")
def whisper():
    return _family_pair("whisper")


def test_enc_block_apply(whisper):
    """Bidirectional, unrotated: every frame sees every other."""
    ref_cfg, cfg, _, params, model = whisper
    bp = jax.tree.map(lambda a: a[1], params["enc"])
    x = np.random.default_rng(12).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    want = ref_tfm.enc_block_apply(bp, jnp.asarray(x), ref_cfg)
    got = tfm.enc_block_apply(model.enc[1], torch.tensor(x), cfg)
    _close(got, want)
    # non-causal: the first frame's output moves when the last frame does
    x2 = x.copy()
    x2[:, -1] = np.random.default_rng(15).standard_normal(
        (2, cfg.d_model)) * 3
    moved = tfm.enc_block_apply(model.enc[1], torch.tensor(x2), cfg)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_cross_attention_pieces(whisper):
    """cross_kv, cross_attend_train (a non-causal flash call) and
    cross_decode against the reference."""
    ref_cfg, cfg, _, params, model = whisper
    ap = jax.tree.map(lambda a: a[0], params["dec"])["xattn"]
    p = model.dec[0].xattn
    rng = np.random.default_rng(13)
    enc = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    xk_ref, xv_ref = ref_attention.cross_kv(ap, jnp.asarray(enc))
    xk, xv = attention.cross_kv(p, torch.tensor(enc))
    _close(xk, xk_ref)
    _close(xv, xv_ref)
    want = ref_attention.cross_attend_train(ap, jnp.asarray(x),
                                            (xk_ref, xv_ref), ref_cfg)
    _close(attention.cross_attend_train(p, torch.tensor(x), (xk, xv), cfg),
           want)
    want = ref_attention.cross_decode(ap, jnp.asarray(x[:, :1]), xk_ref,
                                      xv_ref)
    _close(attention.cross_decode(p, torch.tensor(x[:, :1]), xk, xv), want)


def test_xdec_block_apply_and_decode(whisper):
    """The decoder block's prefill (self-attention K/V and the encoder's
    cross K/V) and decode steps against a cache, without rotation."""
    ref_cfg, cfg, _, params, model = whisper
    bp = jax.tree.map(lambda a: a[1], params["dec"])
    blk = model.dec[1]
    rng = np.random.default_rng(14)
    B, S, W = 2, 6, 12
    enc = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y_ref, (k_ref, v_ref), (xk_ref, xv_ref) = ref_tfm.xdec_block_apply(
        bp, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(pos), ref_cfg)
    y, (k, v), (xk, xv) = tfm.xdec_block_apply(
        blk, torch.tensor(x), torch.tensor(enc), torch.tensor(pos), cfg)
    for g, w in ((y, y_ref), (k, k_ref), (v, v_ref), (xk, xk_ref),
                 (xv, xv_ref)):
        _close(g, w)
    ck = np.zeros((B, W) + tuple(k.shape[2:]), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(k_ref), np.asarray(v_ref)
    ck_ref, cv_ref = jnp.asarray(ck), jnp.asarray(cv)
    ck_t, cv_t = torch.tensor(ck), torch.tensor(cv)
    for step in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((B,), S + step, np.int32)
        y1_ref, ck_ref, cv_ref = ref_tfm.xdec_block_decode(
            bp, jnp.asarray(x1), ck_ref, cv_ref, xk_ref, xv_ref,
            jnp.asarray(p1), ref_cfg)
        y1, ck_t, cv_t = tfm.xdec_block_decode(
            blk, torch.tensor(x1), ck_t, cv_t, xk, xv, torch.tensor(p1), cfg)
        _close(y1, y1_ref)
        _close(ck_t, ck_ref)
        _close(cv_t, cv_ref)
