"""Port parity: the flash attention of `repro_torch` (its plain blocked
version, which CPU tensors take) against the reference's Pallas kernel
in interpret mode and against the reference model's blocked flash
attention (`repro.models.attention.flash_attention`).

Tolerances are the reference's own (tests/test_kernels.py): 2e-5 at
float32 and 3e-2 at bfloat16 against the Pallas kernel. Against the
model's flash attention at float32 the two compute the same chunked
online softmax and differ only in the order of float32 sums, measured
at most 7.2e-7 here, so the limit is 2e-6; at bfloat16 p is rounded to V's
dtype in both, and the limit is the reference's 3e-2.

Under autograd (`kernel.FlashAttention`, the forward plus a plain-torch
tiled backward) the gradients are held to `jax.grad` of the model's
flash attention within 1e-5 of each input's largest gradient at
float32: the same tiles and float32 algebra, the backward's sums in
another order (measured at most 6.6e-7). At bfloat16 the gradients are
held to the float32 run of the same values within 2^-6 of the largest
(measured 5.3e-3 on dq).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import ops as ref_fa_ops  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402,E501
from repro_torch.models import attention  # noqa: E402

ATOL_KERNEL_F32, ATOL_BF16 = 2e-5, 3e-2
ATOL_MODEL_F32 = 2e-6

# tests/test_kernels.py:94-100: (B, Sq, Skv, H, K, hd, causal, q_offset)
KERNEL_SHAPES = [
    (2, 64, 64, 4, 2, 16, True, 0),
    (1, 128, 128, 8, 8, 32, True, 0),
    (2, 32, 128, 4, 1, 16, True, 96),    # seq-parallel shard slice
    (1, 96, 128, 2, 2, 16, True, 0),     # non-divisible q
    (1, 128, 128, 4, 2, 64, False, 0),
]


def _qkv(seed, B, Sq, Skv, H, K, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(dtype),
            rng.standard_normal((B, Skv, K, hd)).astype(dtype),
            rng.standard_normal((B, Skv, K, hd)).astype(dtype))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def _launches():
    return (kernel.flash_attention_tc.launches,
            kernel.flash_attention_f32.launches)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,off", KERNEL_SHAPES)
def test_plain_matches_pallas_kernel(B, Sq, Skv, H, K, hd, causal, off):
    q, k, v = _qkv(Sq + Skv, B, Sq, Skv, H, K, hd)
    want = ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), off, bq=32, bkv=32,
                                      causal=causal)
    before = _launches()
    got = ops.flash_attention(_t(q), _t(k), _t(v), off, bq=32, bkv=32,
                              causal=causal)
    assert _launches() == before   # CPU: no launch
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_KERNEL_F32)
    oracle = attention_ref(_t(q), _t(k), _t(v), causal=causal, q_offset=off)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=ATOL_KERNEL_F32)


# the float32 serves' prefill shapes scaled down (B, S, H, K, hd): the
# full-width serve's B = 2 at S = 128 and 256, the 2-layer parity serve's
# B = 1 at S = 96 and 200, and hd = 128 (llama3.2-3b)
F32_SCHEDULE_CASES = [
    (2, 128, 8, 2, 64),
    (2, 256, 8, 2, 64),
    (1, 96, 8, 2, 64),
    (1, 200, 8, 2, 64),
    (2, 80, 6, 2, 128),
]


@pytest.mark.parametrize("B,S,H,K,hd", F32_SCHEDULE_CASES)
def test_plain_at_the_f32_kernel_schedule_matches_pallas(B, S, H, K, hd):
    """The float32 kernel refreshes its running max once per key tile of
    `F32_KEY_TILE` keys, as the Pallas kernel does once per block of bkv
    keys: the plain version run at that schedule matches the Pallas kernel
    at bkv = F32_KEY_TILE within the float32 limit, and the serve's own
    schedule (one 1024-key chunk) within the same limit."""
    tile = kernel.F32_KEY_TILE
    q, k, v = _qkv(B + S + hd, B, S, S, H, K, hd)
    want = ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), bq=tile, bkv=tile)
    got = kernel.flash_attention_plain(_t(q), _t(k), _t(v), chunk_q=tile,
                                       chunk_kv=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_KERNEL_F32)
    serve = kernel.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), serve.numpy(), rtol=0,
                               atol=ATOL_KERNEL_F32)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(7, 1, 64, 64, 4, 2, 32)
    bf = jnp.bfloat16
    want = ref_fa_ops.flash_attention(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                      jnp.asarray(v, bf), bq=32, bkv=32)
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), bq=32, bkv=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL_BF16)


# (B, Sq, Skv, H, K, hd, q_offset, kv_len, window, chunk_q, chunk_kv)
MODEL_CASES = [
    (2, 48, 48, 4, 2, 16, 0, None, 0, 16, 16),
    (1, 40, 40, 8, 2, 16, 0, None, 0, 512, 1024),   # model defaults
    (2, 32, 96, 4, 4, 16, 64, 80, 0, 16, 32),       # kv_len < Skv
    (1, 24, 64, 7, 1, 32, 0, 30, 0, 8, 16),         # G = 7, kv_len < Skv
    (1, 64, 64, 4, 2, 16, 0, None, 20, 16, 16),     # sliding window
    # the widths the kernels now take: zamba2's hd = 80, mixtral's
    # window (a prompt longer than it), and hd = 8, 24, 72, 256 with a
    # window, q_offset > 0 and kv_len < Skv
    (2, 40, 40, 4, 4, 80, 0, None, 0, 16, 16),
    (1, 72, 72, 8, 2, 16, 0, None, 32, 512, 1024),
    (1, 24, 64, 4, 2, 8, 32, 60, 40, 8, 16),
    (1, 30, 48, 4, 4, 24, 12, 44, 16, 16, 32),
    (2, 20, 40, 4, 2, 72, 16, None, 10, 16, 16),
    (1, 16, 40, 2, 1, 256, 20, 38, 24, 8, 16),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,off,kv_len,window,cq,ckv",
                         MODEL_CASES)
def test_plain_matches_model_flash(B, Sq, Skv, H, K, hd, off, kv_len, window,
                                   cq, ckv):
    q, k, v = _qkv(B * Sq + Skv, B, Sq, Skv, H, K, hd)
    want = ref_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=off, kv_len=kv_len, chunk_q=cq, chunk_kv=ckv)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=window, q_offset=off,
                                    kv_len=kv_len, chunk_q=cq, chunk_kv=ckv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_MODEL_F32)


def test_plain_matches_model_flash_bf16():
    q, k, v = _qkv(3, 2, 40, 40, 8, 2, 16)
    bf = jnp.bfloat16
    want = ref_attention.flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        chunk_q=16, chunk_kv=16)
    got = attention.flash_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        chunk_q=16, chunk_kv=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL_BF16)


# non-causal (whisper's encoder self-attention and cross-attention),
# scaled down: (B, Sq, Skv, H, K, hd, bkv of the Pallas kernel, chunk_kv
# of the plain version); the Pallas wrapper takes non-causal inputs only
# when its block divides Skv, the plain version at chunk_kv 256 runs
# Skv = 300 as 256 + 44 keys (as whisper's 1500 frames run as 1024 + 476)
NONCAUSAL_CASES = [
    (2, 300, 300, 4, 4, 16, 100, 256),      # encoder: Sq = Skv
    (2, 24, 150, 4, 4, 16, 50, 1024),       # cross: Sq != Skv
    (1, 24, 150, 8, 2, 32, 30, 64),         # cross, G = 4, 64 + 64 + 22
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,bkv,ckv", NONCAUSAL_CASES)
def test_plain_non_causal_matches_pallas_and_model(B, Sq, Skv, H, K, hd, bkv,
                                                   ckv):
    """causal=False: every query sees every key below kv_len. Against
    the Pallas kernel in interpret mode (float32 limit), the naive
    oracle, and the reference model's flash attention at the same chunks
    (2e-6), also with kv_len < Skv."""
    q, k, v = _qkv(Sq * Skv + hd, B, Sq, Skv, H, K, hd)
    got = kernel.flash_attention_plain(_t(q), _t(k), _t(v), causal=False,
                                       chunk_kv=ckv)
    want = ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), bq=bkv, bkv=bkv,
                                      causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_KERNEL_F32)
    oracle = attention_ref(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=ATOL_KERNEL_F32)
    for kv_len in (None, Skv - 7):
        model = ref_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
            kv_len=kv_len, chunk_kv=ckv)
        port = attention.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                         kv_len=kv_len, chunk_kv=ckv)
        np.testing.assert_allclose(port.numpy(), np.asarray(model), rtol=0,
                                   atol=ATOL_MODEL_F32)
    # bf16: p rounded to V's dtype in both
    bf = jnp.bfloat16
    model = ref_attention.flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        causal=False, chunk_kv=ckv)
    port = attention.flash_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        causal=False, chunk_kv=ckv)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(model, np.float32), rtol=0,
                               atol=ATOL_BF16)


def test_kv_len_masks_what_the_reference_wrapper_pads():
    """q_offset + Sq > Skv: the reference's Pallas wrapper pads KV with
    zero keys and leaves them unmasked; the port masks by kv_len, so its
    result equals the oracle on the real keys alone."""
    q, k, v = _qkv(11, 1, 32, 40, 4, 2, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), 16, bq=32, bkv=32)
    oracle = attention_ref(_t(q), _t(k), _t(v), q_offset=16)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=ATOL_KERNEL_F32)


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (_t(a) for a in _qkv(5, 1, 20, 20, 4, 2, 16))
    before = _launches()
    got = kernel.flash_attention_fwd(q, k, v, kv_len=15)
    assert _launches() == before
    want = kernel.flash_attention_plain(q, k, v, kv_len=15)
    assert torch.equal(got, want)


# -- the wrapper's checks and dtype routing (`kernel.route`), which decide
# on CPU tensors as they do on CUDA ones, without launching anything

@pytest.mark.parametrize("dtype,kern", [
    (torch.bfloat16, "flash_attention_tc"),
    (torch.float32, "flash_attention_f32")])
def test_route_picks_the_kernel_by_dtype(dtype, kern):
    q = torch.zeros((2, 12, 8, 64), dtype=dtype)
    k = torch.zeros((2, 20, 2, 64), dtype=dtype)
    got, args = kernel.route(q, k, k, 8, kv_len=17, chunk_kv=16)
    assert got is getattr(kernel, kern)
    assert args == (2, 12, 20, 8, 2, 64, 8, 17, 1, 0, 16)
    # kv_len defaults to Skv; a chunk longer than Skv is one chunk of Skv
    _, args = kernel.route(q, k, k, causal=False)
    assert args == (2, 12, 20, 8, 2, 64, 0, 20, 0, 0, 20)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 24, 72, 80, 128, 256])
def test_route_takes_every_head_dim_and_a_window(dtype, hd):
    """Every head_dim that is a multiple of 8 up to 256 and a sliding
    window pass the checks on CPU tensors (route does not look at the
    device), and the window reaches the kernel's arguments."""
    q = torch.zeros((1, 20, 8, hd), dtype=dtype)
    k = torch.zeros((1, 24, 2, hd), dtype=dtype)
    _, args = kernel.route(q, k, k, 4, window=16, kv_len=23)
    assert args == (1, 20, 24, 8, 2, hd, 4, 23, 1, 16, 24)


def _misaligned(dtype, shape):
    """A contiguous view that starts one element (2 or 4 bytes) into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case,error,match", [
    ("float64", TypeError, "float32 or bfloat16"),
    ("mixed dtypes", TypeError, "one dtype"),
    ("head_dim 44", ValueError, "head_dim"),
    ("kv_len > Skv", ValueError, "kv_len"),
    ("chunk_kv 0", ValueError, "chunk_kv"),
    ("non-contiguous", ValueError, "contiguous"),
    ("head_dim 264", ValueError, "head_dim"),
    ("negative window", ValueError, "window"),
    ("H not a multiple of K", ValueError, "heads per kv head"),
    ("misaligned bf16", ValueError, "aligned"),
    ("misaligned float32", ValueError, "aligned"),
])
def test_route_rejects_what_the_kernels_do_not_take(case, error, match):
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    v, kw = k, {}
    if case == "float64":
        q, k, v = q.double(), k.double(), k.double()
    elif case == "mixed dtypes":
        q = q.bfloat16()
    elif case == "head_dim 44":
        q, k, v = (x[..., :44].contiguous() for x in (q, k, k))
    elif case == "head_dim 264":
        q, k, v = (torch.zeros(x.shape[:3] + (264,)) for x in (q, k, k))
    elif case == "kv_len > Skv":
        kw = {"kv_len": 9}
    elif case == "chunk_kv 0":
        kw = {"chunk_kv": 0}
    elif case == "non-contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "negative window":
        kw = {"window": -1}
    elif case == "H not a multiple of K":
        q = torch.zeros((1, 8, 5, 64))
    elif case == "misaligned bf16":
        q = _misaligned(torch.bfloat16, (1, 8, 4, 64))
        k = v = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    elif case == "misaligned float32":
        k = v = _misaligned(torch.float32, (1, 8, 2, 64))
    with pytest.raises(error, match=match):
        kernel.route(q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 6])
def test_cpu_tensors_take_the_plain_version(dtype, window):
    """On CPU tensors flash_attention_fwd is flash_attention_plain, bit for
    bit, for either dtype, with a window, and launches nothing."""
    q, k, v = (_t(a, dtype) for a in _qkv(13, 2, 24, 24, 8, 2, 32))
    before = _launches()
    got = kernel.flash_attention_fwd(q, k, v, window=window, chunk_q=8,
                                     chunk_kv=16)
    assert _launches() == before
    want = kernel.flash_attention_plain(q, k, v, window=window, chunk_q=8,
                                        chunk_kv=16)
    assert got.dtype == dtype and torch.equal(got, want)


# (B, Sq, Skv, H, K, hd, causal, q_offset, window, chunk_q, chunk_kv):
# causal, non-causal (cross-attention, Skv != Sq), a window, G = 4, and
# sequences that are not multiples of the chunks
GRAD_CASES = [
    (2, 40, 40, 8, 2, 16, True, 0, 0, 16, 16),
    (1, 24, 50, 4, 4, 16, False, 0, 0, 8, 16),
    (2, 48, 48, 8, 2, 16, True, 0, 12, 16, 8),
    (1, 37, 37, 8, 2, 8, True, 0, 0, 16, 16),
    (1, 30, 45, 4, 1, 16, True, 15, 0, 8, 32),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,off,window,cq,ckv",
                         GRAD_CASES)
def test_function_gradients_match_the_model_flash(B, Sq, Skv, H, K, hd,
                                                  causal, off, window, cq,
                                                  ckv):
    q, k, v = _qkv(B + Sq + Skv, B, Sq, Skv, H, K, hd)
    do = np.random.default_rng(7).standard_normal((B, Sq, H, hd)).astype(
        np.float32)

    def f(q, k, v):
        o = ref_attention.flash_attention(q, k, v, causal=causal,
                                          window=window, q_offset=off,
                                          chunk_q=cq, chunk_kv=ckv)
        return jnp.sum(o * do)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    before = _launches()
    o = ops.flash_attention(qt, kt, vt, off, bq=cq, bkv=ckv, causal=causal,
                            window=window)
    assert "FlashAttention" in type(o.grad_fn).__name__
    o.backward(torch.tensor(do))
    assert _launches() == before
    for t, w in zip((qt, kt, vt), want):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,off,window,cq,ckv",
                         GRAD_CASES)
def test_function_gradients_bf16_match_the_model_flash(B, Sq, Skv, H, K, hd,
                                                       causal, off, window,
                                                       cq, ckv):
    """bf16 inputs, the port at the case's chunks against jax.grad of the
    reference's model flash with one q chunk on the same bf16 values.
    With one q chunk the reference's dV is one float32 product of the
    rounded p, rounded once to bf16 (with several it sums per-chunk dV in
    bf16), so dV must agree bit for bit but for rare rounding flips:
    within 1e-4 of its largest (measured <= 8.6e-9; with p left
    unrounded, 1.3e-3 to 5.0e-3). dQ and dK: the reference rounds dP and
    the per-tile partial sums to bf16, the port keeps float32 to the end,
    so within 2^-7 of the largest (measured <= 5.6e-3)."""
    q, k, v = _qkv(B + Sq + Skv, B, Sq, Skv, H, K, hd)
    do = np.random.default_rng(7).standard_normal((B, Sq, H, hd)).astype(
        np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    do_bf = bf(do).astype(jnp.float32)

    def f(q, k, v):
        o = ref_attention.flash_attention(q, k, v, causal=causal,
                                          window=window, q_offset=off,
                                          chunk_q=Sq, chunk_kv=ckv)
        return jnp.sum(o.astype(jnp.float32) * do_bf)
    want = jax.grad(f, argnums=(0, 1, 2))(bf(q), bf(k), bf(v))
    qt, kt, vt = (_t(a, torch.bfloat16).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, off, bq=cq, bkv=ckv, causal=causal,
                            window=window)
    assert "FlashAttention" in type(o.grad_fn).__name__
    o.backward(_t(do, torch.bfloat16))
    for t, w, rel in zip((qt, kt, vt), want, (2 ** -7, 2 ** -7, 1e-4)):
        assert t.grad.dtype == torch.bfloat16
        g, w = t.grad.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def test_function_backward_bf16_follows_float32():
    """bf16 inputs: the gradients of the forward's rounded weights, held
    to the float32 run of the same values within bf16's 2^-6 of the
    largest gradient."""
    q, k, v = _qkv(5, 1, 40, 40, 8, 2, 16)
    do = np.random.default_rng(8).standard_normal((1, 40, 8, 16))
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        ts = [_t(a, dt).requires_grad_() for a in (q, k, v)]
        o = ops.flash_attention(*ts, bq=16, bkv=16)
        o.backward(torch.tensor(do, dtype=dt))
        grads[dt] = [t.grad.float() for t in ts]
        assert all(t.grad.dtype == dt for t in ts)
    for a, b in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert float((a - b).abs().max()) <= 2 ** -6 * float(b.abs().max())


@pytest.mark.parametrize("kern", ["flash_attention_tc",
                                  "flash_attention_f32"])
def test_direct_kernel_call_with_grad_raises(kern):
    """The kernels write outside autograd: a direct launch with inputs
    that require grad under grad mode raises, never returns a detached
    tensor (checked before the launch, so on any device)."""
    dt = torch.bfloat16 if kern.endswith("tc") else torch.float32
    q, k, v = (_t(a, dt) for a in _qkv(1, 1, 8, 8, 4, 2, 16))
    args = (1, 8, 8, 4, 2, 16, 0, 8, 1, 0, 8)
    with pytest.raises(RuntimeError, match="outside autograd"):
        getattr(kernel, kern)(q.requires_grad_(), k, v, args)


def test_no_function_outside_autograd():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(2, 1, 8, 8, 4, 2, 16))
    with torch.no_grad():
        o = ops.flash_attention(q, k, v)
    assert o.grad_fn is None
    o = ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None
