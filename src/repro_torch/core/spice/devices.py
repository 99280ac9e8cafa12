"""EKV-style compact transistor model in torch.

    i = I_S * [ L2((Vgs_on - VT)/(2 n phi_t)) - L2((Vgs_on - VT - n Vds)/(2 n phi_t)) ]
        * (1 + lambda * Vds),       L2(x) = ln^2(1 + e^x)
    I_S = 2 n k' (W/L) phi_t^2

One smooth expression covers subthreshold through strong inversion and
saturation. Both polarities share the same magnitude function:
conventional current flows high->low terminal; NMOS gates on with vg
above the LOW terminal, PMOS with vg below the HIGH terminal.

All functions are elementwise over tensors. Python floats become float64
CPU tensors: the scalar callers (cell read currents, leakage) are host
algebra, as in the reference, which evaluates them under float64.
"""
from __future__ import annotations

import torch

from repro_torch.core.techfile import PHI_T, DeviceFlavor


def softplus(x):
    """ln(1 + e^x) as max(x, 0) + log1p(exp(-|x|)), the same formula as
    the reference's logaddexp(x, 0). `torch.nn.functional.softplus`
    switches to x above its threshold, which breaks float64 parity."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _l2(x):
    return softplus(x) ** 2  # ln^2(1+e^x)


def _i_mag_per_um(fl: DeviceFlavor, vg, v_hi, v_lo, l_um):
    """|I| per um width for current flowing v_hi -> v_lo (>= 0)."""
    vg, v_hi, v_lo = _t(vg), _t(v_hi), _t(v_lo)
    vds = v_hi - v_lo
    if fl.polarity > 0:
        vgs_on = vg - v_lo          # NMOS: source = low terminal
    else:
        vgs_on = v_hi - vg          # PMOS: source = high terminal
    n = fl.n_slope
    i_s = 2.0 * n * fl.k_prime * (1.0 / max(l_um, 1e-3)) * PHI_T ** 2
    a = (vgs_on - fl.vt0) / (2.0 * n * PHI_T)
    b = (vgs_on - fl.vt0 - n * vds) / (2.0 * n * PHI_T)
    return i_s * (_l2(a) - _l2(b)) * (1.0 + fl.lambda_ * vds)


def channel_current(fl: DeviceFlavor, w_um, l_um, vg, va, vb):
    """Signed conventional current a -> b through the channel (A)."""
    va, vb = _t(va), _t(vb)
    fwd = _i_mag_per_um(fl, vg, va, vb, l_um)
    rev = _i_mag_per_um(fl, vg, vb, va, l_um)
    return w_um * torch.where(va >= vb, fwd, -rev)


def i_gate(fl: DeviceFlavor, w_um, vg, vch):
    """Gate leakage (A), linear-in-bias toy model (sign: gate -> channel)."""
    return fl.i_gate_a_per_um * w_um * (vg - vch) / 1.1


def i_off(fl: DeviceFlavor, w_um, l_um, vdd):
    """Off-state leakage magnitude at Vgs_on=0, |Vds|=vdd (A)."""
    if fl.polarity > 0:
        return float(w_um * _i_mag_per_um(fl, 0.0, vdd, 0.0, l_um))
    return float(w_um * _i_mag_per_um(fl, vdd, vdd, 0.0, l_um))


def on_current_per_um(fl: DeviceFlavor, vdd, l_um=0.04):
    """|Id_sat| per um at Vgs_on = Vds = vdd."""
    if fl.polarity > 0:
        return float(_i_mag_per_um(fl, vdd, vdd, 0.0, l_um))
    return float(_i_mag_per_um(fl, 0.0, vdd, 0.0, l_um))


def id_vg_curve(fl: DeviceFlavor, vds: float, l_um=0.04, w_um=1.0, n=121):
    """Fig 8(a)/(d): |Id|-Vgs_on sweep at fixed |Vds| (float64 tensors)."""
    vgs = torch.linspace(0.0, 1.1, n, dtype=torch.float64)
    vg = vgs if fl.polarity > 0 else vds - vgs
    return vgs, channel_current(fl, w_um, l_um, vg, vds, 0.0).abs()
