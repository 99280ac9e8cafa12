"""Port parity: the xLSTM blocks of `repro_torch` (`models/xlstm.py`)
against the JAX reference's on the same weights and inputs: the
chunkwise mLSTM prefill with its returned conv history and state (one
chunk, several chunks with `CHUNK` set small on both modules, and two
chunks at the real `CHUNK`), mLSTM decode steps, and the sLSTM scan with
and without a carried state.

Reduced xlstm at float32 (d_model 64, 4 heads, Dq 16, Dv 32, inner 128).
Outputs, conv histories and the stabilizer m are held at the model
tests' 1e-5 (measured at most 1.7e-6 on outputs). The matrix and
normalizer states C and n are held at 1e-6 of their largest magnitude,
with its reason: each is a sum over every position of the prompt
(C up to 37 and n up to 56 in magnitude at S = 512), whose float32 terms
the port adds in BLAS's order and the reference in XLA's, so they part
by a few ulp of that magnitude (measured 1.9e-5 on n = 56, 3.4e-7 of
it, at S = 512; 1.5e-5 on n = 37 at S = 256, one chunk).
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

import repro.models.xlstm as ref_xlstm  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

ATOL = 1e-5
STATE_RTOL = 1e-6      # C and n, of their largest magnitude: see above


@pytest.fixture(scope="module")
def pair():
    """(ref_cfg, cfg, reference mLSTM and sLSTM params of layer 1 and 0,
    the port's modules holding them)."""
    ref_cfg = dataclasses.replace(ref_get_config("xlstm-1.3b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                              dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    mp = jax.tree.map(lambda a: a[1], params["mlstm"])
    sp = jax.tree.map(lambda a: a[0], params["slstm"])
    return ref_cfg, cfg, mp, sp, model.mlstm[1], model.slstm[0]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _close_state(got, want):
    """An mLSTM state (C, n, m): C and n at STATE_RTOL of their largest
    magnitude, m at ATOL."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        _close(g, w, STATE_RTOL * max(1.0, float(np.abs(w).max())))
    _close(got[2], want[2])


def _x(seed, B, S, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)) * scale).astype(np.float32)


def _state(rng, B, nh, hq, hv):
    """A carried mLSTM state: C, n and a finite stabilizer m."""
    return (rng.standard_normal((B, nh, hq, hv)).astype(np.float32) * 0.1,
            rng.standard_normal((B, nh, hq)).astype(np.float32) * 0.1,
            rng.uniform(-2.0, 2.0, (B, nh)).astype(np.float32))


def test_dims_and_parameters(pair):
    ref_cfg, cfg, mp, sp, m, s = pair
    assert xlstm.m_dims(cfg) == ref_xlstm.m_dims(ref_cfg)
    assert xlstm.s_dims(cfg) == ref_xlstm.s_dims(ref_cfg)
    for tree, mod in ((mp, m), (sp, s)):
        for name, a in tree.items():
            assert tuple(getattr(mod, name).shape) == a.shape, name
    assert m.w_if.dtype == m.b_if.dtype == s.b.dtype == torch.float32
    full = get_config("xlstm-1.3b")
    assert xlstm.m_dims(full) == (4096, 4, 512, 1024)
    assert xlstm.s_dims(full) == (4, 512, 2752)


@pytest.mark.parametrize("S", [1, 2, 3, 16, 200, 512])
def test_m_apply_matches_reference(pair, S):
    """Output, conv history and float32 state at the real CHUNK: one
    chunk up to S = 256 (S < 3 pads the conv history with zeros on the
    left), two at S = 512."""
    ref_cfg, cfg, mp, _, m, _ = pair
    x = _x(S, 2, S, cfg.d_model)
    y_ref, (h_ref, st_ref) = ref_xlstm.m_apply(mp, jnp.asarray(x), ref_cfg,
                                               return_state=True)
    y, (h, st) = xlstm.m_apply(m, torch.tensor(x), cfg, return_state=True)
    _close(y, y_ref)
    _close(h, h_ref)
    _close_state(st, st_ref)
    assert h.shape == (2, 3, 128)
    assert torch.equal(xlstm.m_apply(m, torch.tensor(x), cfg), y)


@pytest.mark.parametrize("chunk,S", [(8, 8), (8, 32), (16, 48)])
def test_m_apply_in_several_chunks(pair, chunk, S):
    """`CHUNK` set small on both modules (read at call time), from a
    carried state: every chunk after the first starts from the last one's
    state."""
    ref_cfg, cfg, mp, _, m, _ = pair
    inner, nh, hq, hv = xlstm.m_dims(cfg)
    x = _x(S + chunk, 2, S, cfg.d_model, scale=2.0)
    state = _state(np.random.default_rng(chunk), 2, nh, hq, hv)
    old = (ref_xlstm.CHUNK, xlstm.CHUNK)
    ref_xlstm.CHUNK = xlstm.CHUNK = chunk
    try:
        y_ref, (h_ref, st_ref) = ref_xlstm.m_apply(
            mp, jnp.asarray(x), ref_cfg,
            state=tuple(jnp.asarray(a) for a in state), return_state=True)
        y, (h, st) = xlstm.m_apply(
            m, torch.tensor(x), cfg,
            state=tuple(torch.tensor(a) for a in state), return_state=True)
        # a prompt longer than one chunk must be whole chunks, in both
        bad = np.zeros((1, chunk + 1, cfg.d_model), np.float32)
        with pytest.raises(AssertionError):
            ref_xlstm.m_apply(mp, jnp.asarray(bad), ref_cfg)
        with pytest.raises(AssertionError):
            xlstm.m_apply(m, torch.tensor(bad), cfg)
    finally:
        ref_xlstm.CHUNK, xlstm.CHUNK = old
    _close(y, y_ref)
    _close(h, h_ref)
    _close_state(st, st_ref)


def test_m_decode_steps_match_reference(pair):
    """Decode steps from a prefill's conv history and state: output,
    history and state at each step."""
    ref_cfg, cfg, mp, _, m, _ = pair
    x = _x(3, 3, 20, cfg.d_model)
    _, (h_ref, st_ref) = ref_xlstm.m_apply(mp, jnp.asarray(x), ref_cfg,
                                           return_state=True)
    _, (h, st) = xlstm.m_apply(m, torch.tensor(x), cfg, return_state=True)
    rng = np.random.default_rng(4)
    for _ in range(5):
        x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y_ref, h_ref, st_ref = ref_xlstm.m_decode(mp, jnp.asarray(x1), h_ref,
                                                  st_ref, ref_cfg)
        y, h, st = xlstm.m_decode(m, torch.tensor(x1), h, st, cfg)
        _close(y, y_ref)
        _close(h, h_ref)
        _close_state(st, st_ref)


def test_m_decode_from_the_empty_state(pair):
    """Decode from a zero history and the initial state (m = -1e30), as a
    cache fresh from `init_cache` holds it."""
    ref_cfg, cfg, mp, _, m, _ = pair
    inner, nh, hq, hv = xlstm.m_dims(cfg)
    x1 = _x(5, 2, 1, cfg.d_model)
    zeros = [np.zeros((2, 3, inner), np.float32),
             np.zeros((2, nh, hq, hv), np.float32),
             np.zeros((2, nh, hq), np.float32),
             np.full((2, nh), -1e30, np.float32)]
    want = ref_xlstm.m_decode(mp, jnp.asarray(x1), jnp.asarray(zeros[0]),
                              tuple(map(jnp.asarray, zeros[1:])), ref_cfg)
    got = xlstm.m_decode(m, torch.tensor(x1), torch.tensor(zeros[0]),
                         tuple(map(torch.tensor, zeros[1:])), cfg)
    _close(got[0], want[0])
    _close_state(got[2], want[2])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 12])
def test_s_apply_matches_reference(pair, carried, S):
    """The sLSTM scan from the initial state or from a carried one:
    output and the final (h, c, n, m)."""
    ref_cfg, cfg, _, sp, _, s = pair
    d = cfg.d_model
    x = _x(S + 10 * carried, 2, S, d)
    rng = np.random.default_rng(S)
    state = None
    if carried:
        state = (rng.standard_normal((2, d)).astype(np.float32) * 0.5,
                 rng.standard_normal((2, d)).astype(np.float32),
                 rng.uniform(0.5, 2.0, (2, d)).astype(np.float32),
                 rng.uniform(-1.0, 1.0, (2, d)).astype(np.float32))
    y_ref, st_ref = ref_xlstm.s_apply(
        sp, jnp.asarray(x), ref_cfg, return_state=True,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    y, st = xlstm.s_apply(
        s, torch.tensor(x), cfg, return_state=True,
        state=None if state is None else tuple(map(torch.tensor, state)))
    _close(y, y_ref)
    for got, want in zip(st, st_ref):
        assert got.dtype == torch.float32
        _close(got, want)


def test_s_decode_steps_match_reference(pair):
    ref_cfg, cfg, _, sp, _, s = pair
    x = _x(6, 3, 9, cfg.d_model)
    _, st_ref = ref_xlstm.s_apply(sp, jnp.asarray(x), ref_cfg,
                                  return_state=True)
    _, st = xlstm.s_apply(s, torch.tensor(x), cfg, return_state=True)
    rng = np.random.default_rng(6)
    for _ in range(4):
        x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y_ref, st_ref = ref_xlstm.s_decode(sp, jnp.asarray(x1), st_ref,
                                           ref_cfg)
        y, st = xlstm.s_decode(s, torch.tensor(x1), st, cfg)
        _close(y, y_ref)
        for got, want in zip(st, st_ref):
            _close(got, want)


def test_conv4_and_headnorm_match_reference(pair):
    ref_cfg, cfg, mp, _, m, _ = pair
    rng = np.random.default_rng(9)
    u = rng.standard_normal((2, 10, 128)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 128)).astype(np.float32)
    for init in (None, hist):
        want = ref_xlstm._conv4(jnp.asarray(u), mp["conv_w"], mp["conv_b"],
                                None if init is None else jnp.asarray(init))
        got = xlstm._conv4(torch.tensor(u), m.conv_w, m.conv_b,
                           None if init is None else torch.tensor(init))
        _close(got, want)
    h = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3
    gn = rng.uniform(0.5, 1.5, (4, 32)).astype(np.float32)
    got = xlstm._headnorm(torch.tensor(h), torch.tensor(gn), 1e-5)
    assert got.dtype == torch.float32
    _close(got, ref_xlstm._headnorm(jnp.asarray(h), jnp.asarray(gn), 1e-5))
