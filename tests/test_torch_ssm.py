"""Port parity: the Mamba2 (SSD) block of `repro_torch` (`models/ssm.py`)
against the JAX reference's on the same weights and inputs: the chunked
prefill with its returned state, the conv, and decode steps.

Reduced zamba2 at float32 (d_model 64, 8 heads of 16, state 16). The
limit is the model tests' 1e-5, but for two chunks (S = 512) 3e-5, with
its reason: each chunk's products sum 256 float32 terms, in BLAS's order
in the port and in XLA's in the reference, and the second chunk starts
from a state that carries the first one's rounding (measured 1.45e-5 on
outputs of magnitude 4, 3.6e-6 relative; one chunk stays under 1.5e-6).
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
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ATOL = {1: 1e-5, 2: 3e-5}      # by number of 256-position chunks


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_config("zamba2-2.7b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    model = interop.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    mp = jax.tree.map(lambda a: a[1], params["mamba"])
    return ref_cfg, cfg, mp, model.mamba[1]


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_dims_and_parameters(pair):
    ref_cfg, cfg, mp, p = pair
    assert ssm.dims(cfg) == ref_ssm.dims(ref_cfg)
    for name, a in mp.items():
        assert tuple(getattr(p, name).shape) == a.shape, name
    assert p.A_log.dtype == p.D.dtype == p.dt_bias.dtype == torch.float32


@pytest.mark.parametrize("S", [1, 3, 64, 256, 512])
def test_apply_with_state_matches_reference(pair, S):
    """Output, conv history and float32 state of the chunked prefill: one
    chunk at S <= 256 (S = 1 and 3 are shorter than the conv's k - 1 = 3
    rows of history, so it is left-padded with zeros), two at S = 512."""
    ref_cfg, cfg, mp, p = pair
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    y_ref, cs_ref, st_ref = ref_ssm.apply(mp, jnp.asarray(x), ref_cfg,
                                          return_state=True)
    y, cs, st = ssm.apply(p, torch.tensor(x), cfg, return_state=True)
    atol = ATOL[max(1, S // ssm.CHUNK)]
    _close(y, y_ref, atol)
    _close(cs, cs_ref)
    _close(st, st_ref, atol)
    assert st.dtype == torch.float32 and cs.shape == (2, 3, 160)


def test_apply_continues_from_a_state(pair):
    """Prefill in two calls (the second from the first one's conv history
    and state) against the reference doing the same."""
    ref_cfg, cfg, mp, p = pair
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    _, cs_ref, st_ref = ref_ssm.apply(mp, jnp.asarray(x[:, :24]), ref_cfg,
                                      return_state=True)
    # the reference continues from the pre-activation history it returns
    want = ref_ssm.apply(mp, jnp.asarray(x[:, 24:]), ref_cfg,
                         conv_state=cs_ref, ssm_state=st_ref)
    _, cs, st = ssm.apply(p, torch.tensor(x[:, :24]), cfg, return_state=True)
    got = ssm.apply(p, torch.tensor(x[:, 24:]), cfg, conv_state=cs,
                    ssm_state=st)
    _close(got, want)


def test_decode_steps_match_reference(pair):
    """Decode steps from a prefill's state, output and both states at
    each step."""
    ref_cfg, cfg, mp, p = pair
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    _, cs_ref, st_ref = ref_ssm.apply(mp, jnp.asarray(x), ref_cfg,
                                      return_state=True)
    _, cs, st = ssm.apply(p, torch.tensor(x), cfg, return_state=True)
    for step in range(5):
        x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y_ref, cs_ref, st_ref = ref_ssm.decode_step(mp, jnp.asarray(x1),
                                                    cs_ref, st_ref, ref_cfg)
        y, cs, st = ssm.decode_step(p, torch.tensor(x1), cs, st, cfg)
        _close(y, y_ref)
        _close(cs, cs_ref)
        _close(st, st_ref)


def test_causal_conv_matches_reference(pair):
    ref_cfg, cfg, mp, p = pair
    rng = np.random.default_rng(9)
    u = rng.standard_normal((2, 10, 160)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 160)).astype(np.float32)
    for init in (None, hist):
        want = ref_ssm._causal_conv(jnp.asarray(u), mp["conv_w"],
                                    mp["conv_b"],
                                    None if init is None
                                    else jnp.asarray(init))
        got = ssm._causal_conv(torch.tensor(u), p.conv_w, p.conv_b,
                               None if init is None else torch.tensor(init))
        _close(got, want)


def test_long_prompts_must_be_whole_chunks(pair):
    """A prompt longer than one chunk must be a multiple of it, in both
    packages (padding would run through the recurrence)."""
    ref_cfg, cfg, mp, p = pair
    x = np.zeros((1, 300, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        ref_ssm.apply(mp, jnp.asarray(x), ref_cfg)
    with pytest.raises(AssertionError):
        ssm.apply(p, torch.tensor(x), cfg)
