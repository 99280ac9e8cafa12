"""Differentiable twin of `dse.evaluate` (the §VI gradient-based DSE).

`dse.evaluate` is the scalar reference: host float algebra, `float()`
casts, data-dependent branches, exact but opaque to autograd. This
module re-derives the SAME electrical algebra as a float64 torch program
over the CONTINUOUS design knobs, so that energy/delay/retention
gradients flow into the projected-Adam optimizer (`repro_torch.optim.
dse_opt`) behind `OptimizeQuery`:

  vdd_scale      array operating voltage multiplier (the paper's
                 on-the-fly retention knob; `with_vdd_scale` semantics)
  w_read_scale   read-device width multiplier
  w_write_scale  write-device width multiplier
  bl_wire_scale  bitline wire WIDTH multiplier (r ~ 1/s, c_wire ~ s)

Discrete structure (cell topology, array geometry, decoder stages,
wwlls) stays frozen per config: those axes belong to the grid seed.

Chain quantization: the control delay chain of `timing.analyze` (ceil
to stage units, unit coarsening) is piecewise-constant in the knobs, so
its gradient is zero almost everywhere. The default here is the smooth
surrogate t_chain = analog * CHAIN_MARGIN (the chain's lower envelope;
the true chain is within one stage unit above it). `quantized=True`
replicates the exact staircase for parity testing against
`dse.evaluate`; use it for verification, not for gradients.

Everything calls the shared formula kernels (`timing.elmore_delay`,
`timing.cell_swing_time`, the EKV `channel_current` family) and the
traced cell primitives (`cells.v_sn_written_t` &c): one algebra, two
evaluation modes. The retention integral runs in float64 here, as the
reference's does under x64 (`core.retention` keeps the compile flow's
float32).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.core import bank as bank_mod
from repro_torch.core import cells as cells_mod
from repro_torch.core import power as power_mod
from repro_torch.core import timing as timing_mod
from repro_torch.core.bank import BankConfig, build_bank
from repro_torch.core.retention import _margin_voltage
from repro_torch.core.spice import devices as dv
from repro_torch.core.spice.mna import channel_current_raw

KNOBS = ("vdd_scale", "w_read_scale", "w_write_scale", "bl_wire_scale")

#: Traced outputs of `evaluate_grad_fn` (all (B,) tensors).
#: `swing_margin_a` is the read-current margin i_read - 3*i_leak_total
#: whose sign is the `swing_ok` feasibility bit of the scalar evaluator.
OUTPUTS = ("t_read_s", "t_write_s", "t_cell_s", "t_wl_s", "f_max_hz",
           "retention_s", "leakage_w", "refresh_w", "standby_w",
           "e_read_j", "e_write_j", "read_bw_bps", "eff_bw_bps",
           "swing_margin_a", "swing_margin_rel")


def _linspace(start, stop, num: int):
    """`jnp.linspace(start, stop, num, axis=-1)` for tensor endpoints
    (which `torch.linspace` does not take), with jnp's formula:
    start * (1 - s) + stop * s for s = arange(num - 1) / (num - 1), the
    exact endpoint appended."""
    start, stop = torch.broadcast_tensors(start, stop)
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) \
        / torch.tensor(float(div), dtype=start.dtype, device=start.device)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def evaluate_grad_fn(cfg: BankConfig, *, quantized: bool = False,
                     n_ret_steps: int = 4000, device="cuda"
                     ) -> Callable[[Dict[str, torch.Tensor]],
                                   Dict[str, torch.Tensor]]:
    """Build the differentiable evaluator for one gain-cell config.

    Returns `fn(knobs) -> outputs`: `knobs` maps any subset of KNOBS to
    (B,) float64 tensors on `device` (missing knobs default to 1.0, the
    nominal design), and `outputs` maps every name in OUTPUTS to a (B,)
    float64 tensor there. `torch.autograd.grad` (or `torch.func.jacrev`)
    of any reduction of any output flows back to every knob.
    """
    bank = build_bank(cfg)
    if not bank.is_gc:
        raise ValueError(f"cell {cfg.cell!r}: the differentiable evaluator "
                         "models gain cells (SRAM has no retention/width "
                         "knobs on this path)")
    tech = cfg.tech
    cell = bank.cell
    wf, rf = cell.wf(tech), cell.rf(tech)
    rows, cols, ws = bank.rows, bank.cols, cfg.word_size
    f64 = dict(dtype=torch.float64, device=torch.device(device))

    # -- static geometry decomposed into knob-scaling classes
    # Python floats throughout: a numpy scalar times a tensor leaves autograd
    r_wl0, c_wl0 = (float(x) for x in bank_mod.wordline_rc(bank))
    c_wl_gate0 = cols * wf.cg_f_per_um * cell.w_write   # ~ w_write
    c_wl_wire = c_wl0 - c_wl_gate0                      # static (M2 wire)
    r_bl0, c_bl0 = (float(x) for x in bank_mod.bitline_rc(bank))
    c_bl_junc0 = rows * rf.cj_f_per_um * cell.w_read    # ~ w_read
    c_bl_wire0 = c_bl0 - c_bl_junc0                     # ~ bl wire width

    # -- static timing skeleton
    t_dec = timing_mod.decoder_delay(rows)
    t_colmux = 2 * timing_mod.FO4_S if bank.has_colmux else 0.0
    t_fixed = t_colmux + tech.sa_delay_s + timing_mod.REF_SETTLE_S
    swing = tech.v_sense_se
    bit = 0 if cell.read_on_sn_low else 1

    # -- static power skeleton (periphery area is geometry, not a knob)
    periph_leak = float(sum(bank.modules.values())
                        * power_mod.PERIPH_LEAK_W_PER_UM2)
    n_bits = cfg.bits

    vdd0 = tech.vdd
    w_r0, w_w0 = cell.w_read, cell.w_write
    # the raw channel model's device constants, as tensors on the device
    pol_w = torch.tensor(float(wf.polarity), **f64)
    l_w = torch.tensor(float(cell.l_write), **f64)
    zero0 = torch.zeros((), **f64)
    v_ref = torch.tensor(1.1, **f64)

    def fn(knobs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        bad = set(knobs) - set(KNOBS)
        if bad:
            raise ValueError(f"unknown knobs {sorted(bad)} "
                             f"(allowed: {KNOBS})")
        some = torch.as_tensor(next(iter(knobs.values())), **f64)
        one = torch.ones_like(some)

        def knob(name):
            return torch.as_tensor(knobs.get(name, one), **f64)

        s_v, s_wr, s_ww, s_bl = (knob(k) for k in KNOBS)

        vdd = vdd0 * s_v
        w_read = w_r0 * s_wr
        w_write = w_w0 * s_ww
        r_bl = r_bl0 / s_bl
        c_bl = c_bl_wire0 * s_bl + c_bl_junc0 * s_wr
        c_wl = c_wl_wire + c_wl_gate0 * s_ww

        # ---- timing (traced mirror of timing.analyze) ----
        t_wl = timing_mod.elmore_delay(timing_mod.WL_DRIVER_R_OHM,
                                       r_wl0, c_wl)
        v_sn = cells_mod.v_sn_written_t(cell, tech, bit, vdd,
                                        wwlls=cfg.wwlls,
                                        wwl_boost=cfg.wwl_boost)
        v_rbl0 = torch.zeros_like(vdd) if cell.predischarge else vdd
        v_rbl_mid = v_rbl0 + (0.5 * swing if cell.predischarge
                              else -0.5 * swing)
        i_rd = cells_mod.i_read_t(cell, tech, v_sn, v_rbl_mid, vdd, w_read)
        off_sn = cells_mod.v_sn_written_t(
            cell, tech, 1 if cell.read_on_sn_low else 0, vdd)
        leak = (rows - 1) * cells_mod.i_leak_rbl_t(cell, tech, off_sn,
                                                   vdd, w_read)
        i_net = (i_rd - leak).clamp_min(1e-12)
        swing_margin = i_rd - 3.0 * leak
        # scale-free variant in (-inf, 1]; > 0 iff the scalar swing_ok bit
        swing_margin_rel = 1.0 - 3.0 * leak / i_rd.clamp_min(1e-30)
        t_cell = timing_mod.cell_swing_time(
            swing, c_bl + timing_mod.SA_INPUT_C_F, i_net, r_bl)

        analog = t_wl + t_cell + t_fixed
        covered = analog * timing_mod.CHAIN_MARGIN
        if quantized:
            u0, cap = tech.stage_delay_s, timing_mod.CHAIN_MAX_STAGES
            gr = timing_mod.CHAIN_UNIT_GROWTH
            k = torch.ceil(torch.log(covered / (u0 * cap))
                           / math.log(gr)).clamp_min(0.0)
            unit = u0 * gr ** k
            t_chain = torch.ceil(covered / unit) * unit
        else:
            t_chain = covered  # smooth lower envelope of the staircase

        # write path: WBL elmore + SN settle through the write device
        t_bl_wr = timing_mod.elmore_delay(timing_mod.WBL_DRIVER_R_OHM,
                                          r_bl, c_bl)
        v_gate = vdd + (cfg.wwl_boost if cfg.wwlls else 0.0)
        i_on = dv.channel_current(wf, w_write, cell.l_write, v_gate, vdd,
                                  vdd * 0.45).abs()
        c_sn = cells_mod.sn_cap_t(cell, tech, w_read, w_write)
        t_sn = c_sn * 0.9 * vdd / i_on.clamp_min(1e-12)
        t_write_raw = t_wl + t_bl_wr + t_sn

        dff = tech.dff_delay_s
        t_read = dff + t_dec + t_chain + dff
        t_wr = dff + t_dec + torch.maximum(t_write_raw, 0.6 * t_chain)
        f = 1.0 / torch.maximum(t_read, t_wr)

        # ---- retention (traced mirror of retention.analyze) ----
        v0w = cells_mod.v_sn_written_t(cell, tech, 1, vdd,
                                       wwlls=cfg.wwlls,
                                       wwl_boost=cfg.wwl_boost)
        if cell.read_on_sn_low:
            v_m = vdd - rf.vt0 - 0.15
        else:
            v_m = torch.full_like(vdd, _margin_voltage(cell, tech))
        vs = _linspace(v_m, torch.maximum(v0w, v_m + 1e-3), n_ret_steps)
        vg_w = zero0 if wf.polarity > 0 else vdd[..., None]
        i_w = channel_current_raw(
            pol_w, wf.vt0, wf.n_slope, wf.k_prime, wf.lambda_,
            w_write[..., None], l_w, vg_w, vs, zero0).abs()
        i_g = rf.i_gate_a_per_um * w_read[..., None] * vs / v_ref
        inv_i = 1.0 / (i_w + i_g).clamp_min(1e-30)
        t_ret = torch.where(v0w > v_m, c_sn * torch.trapezoid(inv_i, vs),
                            torch.zeros_like(vdd))

        # ---- power (traced mirror of power.analyze, GC branch) ----
        bl_swing = 3.0 * swing
        e_read = (c_wl * vdd ** 2 + ws * c_bl * vdd * bl_swing
                  + ws * 8e-15 * vdd ** 2)
        e_write = (c_wl * vdd ** 2 + ws * c_bl * vdd ** 2
                   + ws * 6e-15 * vdd ** 2)
        if cfg.wwlls:
            e_write = e_write * 1.25
        # dead cell (t_ret == 0): refresh pinned to 0 like the scalar
        # evaluator; such points are infeasible regardless (dse.feasible
        # rejects retention_s <= 0), so the optimizer excludes them via
        # the retention constraint, not this term
        refresh = torch.where(t_ret > 0,
                              n_bits * (e_write / ws) / t_ret.clamp_min(1e-30),
                              torch.zeros_like(t_ret))
        leakage = torch.full_like(vdd, periph_leak)  # GC: no cell static path

        return {
            "t_read_s": t_read, "t_write_s": t_wr, "t_cell_s": t_cell,
            "t_wl_s": t_wl, "f_max_hz": f, "retention_s": t_ret,
            "leakage_w": leakage, "refresh_w": refresh,
            "standby_w": leakage + refresh,
            "e_read_j": e_read, "e_write_j": e_write,
            "read_bw_bps": f * ws, "eff_bw_bps": 2.0 * f * ws,
            "swing_margin_a": swing_margin,
            "swing_margin_rel": swing_margin_rel,
        }

    return fn


def evaluate_grad(cfg: BankConfig, knobs: Dict[str, torch.Tensor], *,
                  quantized: bool = False, device="cuda"
                  ) -> Dict[str, torch.Tensor]:
    """One-shot convenience over `evaluate_grad_fn` (builds the closure
    and applies it; use the _fn form inside optimization loops)."""
    return evaluate_grad_fn(cfg, quantized=quantized, device=device)(knobs)
