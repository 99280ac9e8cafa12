"""Retention: SN decay through write-device subthreshold + read-gate
leakage, until the read margin is lost.

Retention is t(V_SN crosses V_margin) for the worst-case state: the
decaying '1' for NMOS-read cells, the rising '0' for PMOS-read.

Precision: float32 throughout, as the reference runs it in the compile
flow (outside x64, with float32 device constants in `leak_fn`). The same
algebra in float64 moves t_ret by about 1e-4 relative, so a float64 port
would not reproduce the reference's reports. The linspace and trapezoid
below repeat the reference's formulas (start*(1-s) + stop*s with an exact
endpoint; 0.5 * sum(dx * (y[1:] + y[:-1]))).

Every entry point takes `device` (the card unless the caller asks for
the CPU) and builds all of its tensors there; results come back as
Python floats or numpy arrays. Divisors are float32 tensors on that
device, never Python numbers: PyTorch's CUDA division by a host scalar
multiplies by the scalar's reciprocal, an ulp off a true division, and
the channel model's exponent would magnify that ulp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.cells import Bitcell
from repro_torch.core.spice.mna import channel_current_raw
from repro_torch.core.techfile import TechFile, with_vdd_scale

F32 = torch.float32


@dataclass
class Retention:
    """Retention analysis result. Units: `t_ret_s` seconds, voltages in
    volts, `i_leak0_a` (the SN leak at the freshly-written level) in
    amperes."""
    t_ret_s: float
    v_sn0: float
    v_margin: float
    i_leak0_a: float

    def as_dict(self):
        return self.__dict__.copy()


def _f32(x, device):
    return torch.as_tensor(x, dtype=F32, device=device)


def _linspace(start, stop, num: int, device):
    """float32 linspace along a new last axis; start/stop broadcast."""
    start, stop = torch.broadcast_tensors(_f32(start, device),
                                          _f32(stop, device))
    div = num - 1
    step = torch.arange(div, dtype=F32, device=device) / _f32(div, device)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def _trapezoid(y, x):
    return 0.5 * (torch.diff(x, dim=-1) * (y[..., 1:] + y[..., :-1])).sum(-1)


def _margin_voltage(cell: Bitcell, tech: TechFile) -> float:
    """SN level at which the '1' state is lost:
      NMOS read: below VT_read + 0.15 V the cell can no longer meet the
      sense swing;
      PMOS read: below VDD - |VT_read| - 0.15 V the read device starts
      conducting and a stored '1' mis-reads as '0'."""
    rf = cell.rf(tech)
    if cell.read_on_sn_low:
        return tech.vdd - rf.vt0 - 0.15
    return rf.vt0 + 0.15


def leak_fn(cell: Bitcell, tech: TechFile, device="cuda"):
    """Returns i_leak(v_sn) (A, discharging positive), float32 on
    `device`, as a function of the raw write-device params (vt0, w)."""
    wf, rf = cell.wf(tech), cell.rf(tech)
    pol = _f32(float(wf.polarity), device)
    vg = _f32(0.0 if wf.polarity > 0 else tech.vdd, device)
    l_w = _f32(cell.l_write, device)
    zero = _f32(0.0, device)
    v_ref = _f32(1.1, device)

    def fn(v_sn, vt0=wf.vt0, w=cell.w_write):
        # write device off: gate at 0 (NMOS) with WBL at 0 -> discharges SN
        v_sn = _f32(v_sn, device)
        i_w = channel_current_raw(pol, vt0, wf.n_slope, wf.k_prime,
                                  wf.lambda_, w, l_w, vg, v_sn, zero)
        i_g = rf.i_gate_a_per_um * cell.w_read * v_sn / v_ref
        return i_w.abs() + i_g

    return fn


def analyze(cell: Bitcell, tech: TechFile, *, wwlls=False, wwl_boost=0.55,
            n_steps=4000, vdd_scale: float = 1.0,
            device="cuda") -> Retention:
    """Log-time ODE integration of dV/dt = -I(V)/C_SN (decaying '1').

    `vdd_scale` evaluates the cell at a scaled operating voltage: the
    written SN level, the margin and the write-device leak all follow the
    scaled rail."""
    tech = with_vdd_scale(tech, vdd_scale)
    c_sn = cell.sn_cap(tech)
    v0 = cell.v_sn_written(tech, 1, wwlls=wwlls, wwl_boost=wwl_boost)
    v_m = _margin_voltage(cell, tech)
    fn = leak_fn(cell, tech, device)
    t = _cross_time(fn, c_sn, v0, v_m, n_steps, device)
    return Retention(float(t), v0, v_m, float(fn(v0)))


def _cross_time(i_of_v, c_sn, v0, v_margin, n_steps, device):
    """t = C * integral_{v_m}^{v0} dV / I(V)  (exact for dV/dt=-I/C)."""
    if v0 <= v_margin:
        return 0.0
    vs = _linspace(v_margin, v0, n_steps, device)
    inv_i = 1.0 / i_of_v(vs).clamp_min(1e-30)
    return float(c_sn * _trapezoid(inv_i, vs))


def retention_vs_vt(cell: Bitcell, tech: TechFile, vt_values, *,
                    wwlls=False, device="cuda") -> np.ndarray:
    """Retention as a function of the write device's VT, one lane per
    value."""
    c_sn = cell.sn_cap(tech)
    v_m = _margin_voltage(cell, tech)
    vt0 = _f32(np.asarray(vt_values, np.float32), device)
    v0 = torch.minimum(
        _f32(tech.vdd, device),
        tech.vdd + (0.55 if wwlls else 0.0) - vt0 + 0.12) \
        - cell.wwl_couple_ratio * tech.vdd
    fn = leak_fn(cell, tech, device)
    vs = _linspace(v_m, torch.maximum(v0, _f32(v_m + 1e-3, device)), 2000,
                   device)
    inv_i = 1.0 / fn(vs, vt0=vt0[:, None]).clamp_min(1e-30)
    return (c_sn * _trapezoid(inv_i, vs)).cpu().numpy()


def sn_decay_trace(cell: Bitcell, tech: TechFile, t_end, n=400, *,
                   wwlls=False, device="cuda"):
    """V_SN(t) by direct explicit integration over log-spaced times.
    Returns (t (n-1,), v_sn (n-1,)) as numpy float32."""
    c_sn = cell.sn_cap(tech)
    v0 = cell.v_sn_written(tech, 1, wwlls=wwlls)
    fn = leak_fn(cell, tech, device)
    exps = _linspace(math.log10(t_end) - 6, math.log10(t_end), n - 1, device)
    ts = torch.cat([torch.zeros((1,), dtype=F32, device=device),
                    10.0 ** exps])
    v = _f32(v0, device)
    c = _f32(c_sn, device)
    vs = []
    for dt in torch.diff(ts):
        v = (v - fn(v) / c * dt).clamp_min(0.0)
        vs.append(v)
    return ts[1:].cpu().numpy(), torch.stack(vs).cpu().numpy()
