"""Port parity: the EKV channel model of `repro_torch` against the JAX
reference, over a random voltage grid, both polarities, float64."""
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

from repro.core.spice import devices as ref_dv  # noqa: E402
from repro.core.spice import mna as ref_mna  # noqa: E402
from repro.core.techfile import SYN40 as REF_SYN40  # noqa: E402
from repro_torch.core.spice import devices as pt_dv  # noqa: E402
from repro_torch.core.spice import mna as pt_mna  # noqa: E402
from repro_torch.core.techfile import SYN40  # noqa: E402

FLAVORS = sorted(SYN40.devices)
RTOL = 1e-12
N_PTS = 400


def _grid(seed, flavor):
    """Per-point device parameters of `flavor` with random widths and
    lengths, and random terminal voltages covering both conduction
    directions, cut-off and strong inversion."""
    rng = np.random.default_rng(seed)
    fl = SYN40.flavor(flavor)
    p = {"pol": np.full(N_PTS, float(fl.polarity)),
         "vt0": np.full(N_PTS, fl.vt0),
         "n": np.full(N_PTS, fl.n_slope),
         "kp": np.full(N_PTS, fl.k_prime),
         "lam": np.full(N_PTS, fl.lambda_),
         "w": rng.uniform(0.1, 1.5, N_PTS),
         "l": rng.uniform(0.0005, 0.1, N_PTS)}
    v = {k: rng.uniform(-0.3, 1.5, N_PTS) for k in ("vg", "va", "vb")}
    return p, v


def _ref(fn, p, v):
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(p[k]) for k in p),
                 *(jnp.asarray(v[k]) for k in v))
        return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                        else (out,))]


def _port(fn, p, v):
    out = fn(*(torch.as_tensor(p[k]) for k in p),
             *(torch.as_tensor(v[k]) for k in v))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _close(got, want):
    """rtol 1e-12; the floor at 1e-12 of each output's largest magnitude
    covers points where the current crosses zero (va ~ vb)."""
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("fn", ["channel_current_raw",
                                "channel_current_grads",
                                "channel_current_and_grads"])
def test_channel_model_matches_reference(fn, flavor):
    p, v = _grid(FLAVORS.index(flavor), flavor)
    _close(_port(getattr(pt_mna, fn), p, v), _ref(getattr(ref_mna, fn), p, v))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flavor_channel_current_matches_reference(flavor):
    rng = np.random.default_rng(100 + FLAVORS.index(flavor))
    vg, va, vb = (rng.uniform(-0.3, 1.5, N_PTS) for _ in range(3))
    with jax.enable_x64(True):
        want = np.asarray(ref_dv.channel_current(
            REF_SYN40.flavor(flavor), 0.16, 0.04, jnp.asarray(vg),
            jnp.asarray(va), jnp.asarray(vb)))
    got = pt_dv.channel_current(SYN40.flavor(flavor), 0.16, 0.04,
                                vg, va, vb).numpy()
    _close([got], [want])


@pytest.mark.parametrize("flavor", FLAVORS)
def test_scalar_device_helpers_match_reference(flavor):
    fl, rfl = SYN40.flavor(flavor), REF_SYN40.flavor(flavor)
    with jax.enable_x64(True):
        want = [ref_dv.i_off(rfl, 0.2, 0.04, 1.1),
                rfl.i_off_a_per_um(0.06, 1.1),
                float(ref_dv.i_gate(rfl, 0.2, 1.0, 0.3))]
    got = [pt_dv.i_off(fl, 0.2, 0.04, 1.1), fl.i_off_a_per_um(0.06, 1.1),
           pt_dv.i_gate(fl, 0.2, 1.0, 0.3)]
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_softplus_matches_logaddexp_beyond_torch_threshold():
    """torch.nn.functional.softplus returns x above 20; the reference
    (logaddexp(x, 0)) does not, and float64 parity needs its formula."""
    x = np.linspace(-60.0, 60.0, 2001)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
        want_sig = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = pt_dv.softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(pt_dv.sigmoid(torch.as_tensor(x)).numpy(),
                               want_sig, rtol=1e-15, atol=1e-300)
    assert dataclasses.asdict(SYN40.flavor("nmos_svt")) == \
        dataclasses.asdict(REF_SYN40.flavor("nmos_svt"))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_on_current_and_id_vg_curve_match_reference(flavor):
    """Fig 8(a)/(d)'s I-V sweep and the on-current, float64, both
    polarities, at two |Vds| and two lengths."""
    fl, rfl = SYN40.flavor(flavor), REF_SYN40.flavor(flavor)
    for vdd, l_um in ((1.1, 0.04), (0.8, 0.1)):
        with jax.enable_x64(True):
            want_on = ref_dv.on_current_per_um(rfl, vdd, l_um)
            rv, ri = ref_dv.id_vg_curve(rfl, vdd, l_um=l_um, w_um=0.3, n=61)
            rv, ri = np.asarray(rv), np.asarray(ri)
        got_on = pt_dv.on_current_per_um(fl, vdd, l_um)
        gv, gi = pt_dv.id_vg_curve(fl, vdd, l_um=l_um, w_um=0.3, n=61)
        assert isinstance(got_on, float) and got_on > 0
        np.testing.assert_allclose(got_on, want_on, rtol=RTOL)
        assert gv.dtype == gi.dtype == torch.float64 and gi.shape == (61,)
        np.testing.assert_allclose(gv.numpy(), rv, rtol=RTOL, atol=1e-15)
        _close([gi.numpy()], [ri])
        # |Id| grows with the gate drive
        assert (np.diff(gi.numpy()) > 0).all()

