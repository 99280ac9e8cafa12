"""Power: leakage and dynamic (CV^2 f) per bank.

Leakage — the paper's C7 claim: a gain cell has NO static VDD->GND path,
so GCRAM bank leakage is peripheral-only + the (negligible) SN/RBL
subthreshold components, while SRAM leakage scales with the bit count.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import bank as bank_mod
from repro_torch.core.timing import bank_at_vdd

# peripheral leakage per um2 of module area (decoder/driver/SA transistors)
PERIPH_LEAK_W_PER_UM2 = 1.5e-9
ACTIVITY = 0.5


@dataclass
class Power:
    """All fields in watts (at the analyzed frequency/operating point)."""
    leakage_w: float
    cell_leakage_w: float          # the Fig 7c array comparison
    periph_leakage_w: float
    refresh_w: float               # GC-only standby cost (bits*E_wr/t_ret)
    dynamic_read_w_at_fmax: float
    dynamic_write_w_at_fmax: float

    def as_dict(self):
        return self.__dict__.copy()


def analyze(bank, f_hz: float, *, t_ret_s: float = None,
            vdd_scale: float = 1.0) -> Power:
    """Leakage, refresh and dynamic power of one bank at `f_hz`;
    `t_ret_s` (retention) sets the gain cell's refresh cost."""
    bank = bank_at_vdd(bank, vdd_scale)
    tech = bank.cfg.tech
    n_bits = bank.cfg.bits
    # GC cells: no VDD->GND path (WBL parks low; SN leak is the retention
    # current, pA-scale) -> cell_leak == 0; SRAM: three-path per cell.
    cell_leak = n_bits * bank.cell.cell_leakage(tech)
    periph_area = sum(bank.modules.values())
    periph_leak = periph_area * PERIPH_LEAK_W_PER_UM2
    leakage = cell_leak + periph_leak

    vdd = tech.vdd
    r_wl, c_wl = bank_mod.wordline_rc(bank)
    r_bl, c_bl = bank_mod.bitline_rc(bank)
    # read: one WL + word_size BLs swing (full for precharge, sense swing
    # for the SA-limited single-ended read), SA + DFF + clk tree
    bl_swing = tech.v_sense_se * 3 if bank.is_gc else vdd * 0.5
    e_read = (c_wl * vdd ** 2
              + bank.cfg.word_size * c_bl * vdd * bl_swing
              + bank.cfg.word_size * 8e-15 * vdd ** 2)
    e_write = (c_wl * vdd ** 2
               + bank.cfg.word_size * c_bl * vdd ** 2
               + bank.cfg.word_size * 6e-15 * vdd ** 2)
    if bank.cfg.wwlls:
        e_write *= 1.25  # boosted WWL swing
    refresh = 0.0
    if bank.is_gc and t_ret_s and t_ret_s > 0:
        e_write_bit = e_write / max(bank.cfg.word_size, 1)
        refresh = n_bits * e_write_bit / t_ret_s
    return Power(leakage, cell_leak, periph_leak, refresh,
                 e_read * f_hz * ACTIVITY, e_write * f_hz * ACTIVITY)
