"""Bank generator: user config -> organization + modules + floorplan +
critical-path netlists (the compiler's structural core, paper Fig 4).

Organization: cols = word_size * words_per_row; rows = num_words /
words_per_row. words_per_row is chosen to square the array (paper §V-C:
at word_size:num_words = 1:1 a column mux is required; at 4:1 the array
is naturally square and faster).

GCRAM banks are dual-port: Write_Port_Address (left), Read_Port_Address
(right), Write_Port_Data (bottom: write drivers + data DFFs),
Read_Port_Data (top: precharge OR predischarge + SA + out DFFs), two
control blocks + reference generator (single-ended sensing) and an
optional WWL level shifter column (second supply ring, paper Fig 6a/7a).
SRAM banks are single-port with differential sensing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core import layout
from repro_torch.core.cells import CELLS, Bitcell, Sram6T, with_write_vt
from repro_torch.core.techfile import TechFile, SYN40


@dataclass(frozen=True)
class BankConfig:
    word_size: int = 32
    num_words: int = 32
    cell: str = "gc2t_nn"             # cells.CELLS key
    write_vt: Optional[str] = None    # override write flavor (Fig 8c)
    wwlls: bool = False               # WWL level shifter + 2nd ring
    wwl_boost: float = 0.55
    tech: TechFile = SYN40

    @property
    def bits(self) -> int:
        return self.word_size * self.num_words


@dataclass
class Bank:
    cfg: BankConfig
    rows: int
    cols: int
    words_per_row: int
    has_colmux: bool
    is_gc: bool
    cell: object
    modules: Dict[str, float]         # name -> area um2
    plan: layout.Floorplan
    delay_stages: int = 0             # filled by timing

    @property
    def area_um2(self):
        return self.plan.bank_area_um2

    @property
    def array_area_um2(self):
        return self.plan.array_area_um2

    def summary(self) -> dict:
        return {
            "cell": self.cfg.cell, "word_size": self.cfg.word_size,
            "num_words": self.cfg.num_words, "bits": self.cfg.bits,
            "rows": self.rows, "cols": self.cols,
            "words_per_row": self.words_per_row,
            "wwlls": self.cfg.wwlls,
            "bank_area_um2": self.area_um2,
            "array_area_um2": self.array_area_um2,
            "array_efficiency": self.plan.array_efficiency,
            "modules_um2": dict(self.modules),
        }


def organize(word_size: int, num_words: int):
    """Square-ish array: pick words_per_row (power of two, <= 8).
    Ties break toward FEWER rows: per-row periphery (decoders, drivers)
    is the expensive direction for a dual-port bank."""
    best, best_key = 1, (float("inf"), float("inf"))
    for wpr in (1, 2, 4, 8):
        if num_words % wpr:
            continue
        rows = num_words // wpr
        cols = word_size * wpr
        ratio = max(rows, cols) / min(rows, cols)
        key = (ratio, rows)
        if key < best_key:
            best, best_key = wpr, key
    return best


def build_bank(cfg: BankConfig) -> Bank:
    tech = cfg.tech
    cell = CELLS[cfg.cell]
    if cfg.write_vt and isinstance(cell, Bitcell):
        cell = with_write_vt(cell, cfg.write_vt)
    is_gc = not isinstance(cell, Sram6T)

    wpr = organize(cfg.word_size, cfg.num_words)
    rows = cfg.num_words // wpr
    cols = cfg.word_size * wpr
    has_colmux = wpr > 1

    ma = lambda kind, n=1: layout.module_area_um2(tech, kind, n)
    n_addr_bits = max(1, int(math.log2(cfg.num_words)))
    mods: Dict[str, float] = {}

    if is_gc:
        # dual port: independent write/read address paths
        mods["w_decoder"] = ma("decoder_unit", rows)
        mods["w_wl_driver"] = ma("wl_driver", rows)
        mods["r_decoder"] = ma("decoder_unit", rows)
        mods["r_wl_driver"] = ma("wl_driver", rows)
        mods["addr_dff"] = ma("dff", 2 * n_addr_bits)
        if cfg.wwlls:
            mods["wwl_ls"] = ma("wwl_ls", rows)
        pre = "predischarge" if getattr(cell, "predischarge", False) \
            else "precharge"
        mods[pre] = ma(pre, cols)
        if has_colmux:
            mods["r_colmux"] = ma("colmux_unit", cols)
            mods["w_colmux"] = ma("colmux_unit", cols)
        mods["sense_amp"] = ma("sense_amp_se", cfg.word_size)
        mods["write_driver"] = ma("write_driver", cfg.word_size)
        mods["data_dff"] = ma("dff", 2 * cfg.word_size)  # in + out latches
        mods["refgen"] = ma("refgen")
        # two control FSMs + both delay chains (stage count from timing;
        # estimated here from array size, refined after timing.analyze)
        est_stages = 8 + rows // 16
        mods["ctrl"] = 2 * (ma("ctrl_base") + ma("delay_stage", est_stages))
        n_rings = 2 if cfg.wwlls else 1
        pf = layout.GC_PORT_FACTOR
        left = pf * (mods["w_decoder"] + mods["w_wl_driver"]
                     + mods.get("wwl_ls", 0.0))
        right = pf * (mods["r_decoder"] + mods["r_wl_driver"])
        top = pf * (mods[pre] + mods.get("r_colmux", 0.0)
                    + mods["sense_amp"] + ma("dff", cfg.word_size))
        bottom = pf * (mods["write_driver"] + mods.get("w_colmux", 0.0)
                       + ma("dff", cfg.word_size))
        corner = mods["refgen"] + mods["ctrl"] + pf * mods["addr_dff"]
    else:
        mods["decoder"] = ma("decoder_unit", rows)
        mods["wl_driver"] = ma("wl_driver", rows)
        mods["addr_dff"] = ma("dff", n_addr_bits)
        mods["precharge"] = ma("precharge", cols)
        if has_colmux:
            mods["colmux"] = ma("colmux_unit", cols)
        mods["sense_amp"] = ma("sense_amp", cfg.word_size)
        mods["write_driver"] = ma("write_driver_diff", cfg.word_size)
        mods["data_dff"] = ma("dff", 2 * cfg.word_size)
        mods["ctrl"] = ma("ctrl_base") + ma("delay_stage", 6 + rows // 32)
        n_rings = 1
        left = mods["decoder"] + mods["wl_driver"]
        right = 0.0
        top = mods["precharge"] + mods.get("colmux", 0.0) + \
            mods["sense_amp"] + ma("dff", cfg.word_size)
        bottom = mods["write_driver"] + ma("dff", cfg.word_size)
        corner = mods["ctrl"] + mods["addr_dff"]

    geom = cell.geom_key
    if is_gc and getattr(cell, "is_beol", False):
        plan = layout.packed_floorplan(
            tech, geom_key=geom, rows=rows, cols=cols,
            periph_um2=left + right + top + bottom + corner,
            n_rings=n_rings)
    else:
        plan = layout.floorplan(tech, geom_key=geom, rows=rows, cols=cols,
                                left_um2=left, right_um2=right, top_um2=top,
                                bottom_um2=bottom, corner_um2=corner,
                                n_rings=n_rings)
    return Bank(cfg, rows, cols, wpr, has_colmux, is_gc, cell, mods, plan)


# ---------------------------------------------------------------------------
# wire parasitics of the array (for timing + critical-path netlists)
# ---------------------------------------------------------------------------

def wordline_rc(bank: Bank):
    """Total R (ohm), C (F) of one wordline across all columns (M2) +
    gate loads."""
    tech = bank.cfg.tech
    cw, _ = layout.cell_wh_nm(tech, bank.cell.geom_key)
    length_um = bank.cols * cw * 1e-3
    r = tech.r_ohm_per_um["m2"] * length_um
    c_wire = tech.c_f_per_um["m2"] * length_um
    if bank.is_gc:
        wf = bank.cell.wf(tech)
        c_gates = bank.cols * wf.cg_f_per_um * bank.cell.w_write
    else:
        c_gates = bank.cols * tech.flavor("nmos_svt").cg_f_per_um * 0.14
    return r, c_wire + c_gates


def bitline_rc(bank: Bank):
    """Total R, C of one bitline across all rows (M3) + junction loads."""
    tech = bank.cfg.tech
    _, ch = layout.cell_wh_nm(tech, bank.cell.geom_key)
    length_um = bank.rows * ch * 1e-3
    r = tech.r_ohm_per_um["m3"] * length_um
    c_wire = tech.c_f_per_um["m3"] * length_um
    if bank.is_gc:
        rf = bank.cell.rf(tech)
        c_j = bank.rows * rf.cj_f_per_um * bank.cell.w_read
    else:
        c_j = bank.rows * tech.flavor("nmos_svt").cj_f_per_um * 0.14
    return r, c_wire + c_j
