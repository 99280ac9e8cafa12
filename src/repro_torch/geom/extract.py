"""Batched parasitic extraction: routed lengths -> RC ladders.

Two entry points, ONE arithmetic kernel:

  `extract_point(geom)`    scalar reference — reads the designed segment
                           lengths recorded on the ROUTED nets of one
                           `BankGeometry` (rbl_0 / wl_0 and the read
                           wordline) and runs the kernel on Python
                           floats;
  `extract_lattice(banks)` batched — recomputes the same designed
                           lengths closed-form (no geometry is built)
                           as struct-of-arrays numpy columns over the
                           whole design lattice and runs the SAME
                           kernel elementwise.

Both paths execute the identical sequence of IEEE-double operations, so
they are BIT-identical — asserted per config by `verify.verify_bank`
and `tools/check_geom.py`. That is the contract that lets the query
planner extract thousands of points without placing a single rectangle
while the per-point geometry path stays the auditable reference.

What is charged to the read column (vs the hand model in
`core.bank.bitline_rc`): the extracted bitline includes the rail-row
overhead of the placed array column (`layout.floorplan` inserts a
supply rail every 16 rows), the jog into the sense strip, and the
R/C of the via stack down to the SA input — the hand model stops at
`rows * cell_height`. The gap (a few percent, reported in
`results/bench_layout.json`) is exactly the fidelity the layout tier
adds. The write path (WWL/WBL) stays hand-modeled — see docs/layout.md.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import layout
from repro_torch.core.bank import Bank
from repro_torch.core.cells import Sram6T
from repro_torch.geom.grid import RuleDeck

RAIL_ROWS_PER = 16       # must match layout.floorplan's rail insertion
VIA_TIP_NM = 600.0       # packed (BEOL) bitline tip past the array edge:
#                          room for the via stack + the parity stagger
#                          that keeps landing pads DRC-clean at tight
#                          column pitches (see router._via_stack sites)
N_BL_VIAS_GC = 2         # m3 -> m1 stack at the SA end
N_BL_VIAS_SRAM = 4       # two m3 -> m1 stacks (SA end + write-driver end)


def is_packed(bank: Bank) -> bool:
    """BEOL (OS-OS) banks stack the array over the periphery."""
    return bank.is_gc and getattr(bank.cell, "is_beol", False)


def strip_nm(bank: Bank, name: str, dim: str) -> float:
    """Depth of a floorplan strip in nm, from the PLAN (um * 1000) — not
    from placed rect coordinate differences, so the router's net records
    and the closed-form lattice see the same float."""
    for mod in bank.plan.modules:
        if mod["name"] == name:
            return float(mod[dim]) * 1000.0
    return 0.0


def top_jog_nm(bank: Bank) -> float:
    """Read-bitline jog from the array edge to the sense strip: the
    placement margin + a quarter of the strip depth (pins sit in the
    inner quarter). Packed banks only need the via-stack tip."""
    if is_packed(bank):
        return VIA_TIP_NM
    return layout.BLOCK_MARGIN_NM + strip_nm(bank, "top_port_data", "h") / 4.0


def bot_jog_nm(bank: Bank) -> float:
    if is_packed(bank):
        return VIA_TIP_NM
    return layout.BLOCK_MARGIN_NM + \
        strip_nm(bank, "bottom_port_data", "h") / 4.0


def wwl_jog_nm(bank: Bank) -> float:
    """Write (or SRAM single) wordline jog into the LEFT strip."""
    if is_packed(bank):
        return 0.0
    return layout.BLOCK_MARGIN_NM + \
        strip_nm(bank, "left_port_address", "w") / 4.0


def rwl_jog_nm(bank: Bank) -> float:
    """Read wordline jog — RIGHT strip for dual-port GC, left for SRAM."""
    if is_packed(bank):
        return 0.0
    side = "right_port_address" if bank.is_gc else "left_port_address"
    return layout.BLOCK_MARGIN_NM + strip_nm(bank, side, "w") / 4.0


# -- designed-length closed forms (elementwise: scalars or arrays). The
# router sums its per-net segment records in the SAME association order,
# which is what makes record-sum == closed-form bitwise.

def col_span_nm(rows, ch_nm, track_nm):
    """Bitline span over the placed cell column: rows of cells plus a
    supply-rail row every RAIL_ROWS_PER (layout.floorplan's formula)."""
    return rows * ch_nm + (rows // RAIL_ROWS_PER + 1) * 2.0 * track_nm


def bl_length_nm(rows, ch_nm, track_nm, jog_nm):
    return col_span_nm(rows, ch_nm, track_nm) + jog_nm


def wl_length_nm(cols, cw_nm, jog_nm):
    return cols * cw_nm + jog_nm


def _junction_per_row(bank: Bank) -> float:
    """Per-row drain-junction load on the read bitline (same device
    algebra as core.bank.bitline_rc)."""
    if bank.is_gc:
        rf = bank.cell.rf(bank.cfg.tech)
        return rf.cj_f_per_um * bank.cell.w_read
    return bank.cfg.tech.flavor("nmos_svt").cj_f_per_um * 0.14


def _gate_per_col(bank: Bank) -> float:
    """Per-column gate load on the read wordline."""
    tech = bank.cfg.tech
    if bank.is_gc:
        return bank.cell.rf(tech).cg_f_per_um * bank.cell.w_read
    return tech.flavor("nmos_svt").cg_f_per_um * 0.14


def _column_rc_kernel(rows, cols, l_bl_nm, l_wl_nm, n_vias,
                      r3, c3, r2, c2, cj_row, cg_col, r_via, c_via):
    """The ONE extraction kernel (elementwise; scalar and batched paths
    both run exactly this sequence of IEEE-double ops)."""
    bl_um = l_bl_nm * 1e-3
    wl_um = l_wl_nm * 1e-3
    r_bl = r3 * bl_um + n_vias * r_via
    c_bl = c3 * bl_um + rows * cj_row + n_vias * c_via
    r_wl = r2 * wl_um
    c_wl = c2 * wl_um + cols * cg_col
    return {
        "bl_length_nm": l_bl_nm, "bl_r_ohm": r_bl, "bl_c_f": c_bl,
        "wl_length_nm": l_wl_nm, "wl_r_ohm": r_wl, "wl_c_f": c_wl,
        "n_vias": n_vias,
    }


def extract_lattice(banks: Sequence[Bank],
                    deck: Optional[RuleDeck] = None
                    ) -> Dict[str, np.ndarray]:
    """Batched extraction over a design lattice: struct-of-arrays in,
    struct-of-arrays out. No geometry is placed or routed — the designed
    lengths are recomputed closed-form, bit-identical to the per-point
    `extract_point` reference over routed geometry."""
    banks = list(banks)
    deck = deck or RuleDeck.from_tech(banks[0].cfg.tech)
    n = len(banks)
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    n_vias = np.empty(n, dtype=np.int64)
    fcols = {k: np.empty(n) for k in
             ("ch", "cw", "track", "jog_t", "jog_b", "jog_wl",
              "r3", "c3", "r2", "c2", "cj", "cg")}
    for i, b in enumerate(banks):
        tech = b.cfg.tech
        cw, ch = layout.cell_wh_nm(tech, b.cell.geom_key)
        rows[i], cols[i] = b.rows, b.cols
        n_vias[i] = N_BL_VIAS_GC if b.is_gc else N_BL_VIAS_SRAM
        fcols["ch"][i], fcols["cw"][i] = ch, cw
        fcols["track"][i] = tech.track
        fcols["jog_t"][i] = top_jog_nm(b)
        # GC read bitlines terminate at the array edge on the write side;
        # SRAM BL jogs into both strips
        fcols["jog_b"][i] = 0.0 if b.is_gc else bot_jog_nm(b)
        fcols["jog_wl"][i] = rwl_jog_nm(b)
        fcols["r3"][i] = tech.r_ohm_per_um["m3"]
        fcols["c3"][i] = tech.c_f_per_um["m3"]
        fcols["r2"][i] = tech.r_ohm_per_um["m2"]
        fcols["c2"][i] = tech.c_f_per_um["m2"]
        fcols["cj"][i] = _junction_per_row(b)
        fcols["cg"][i] = _gate_per_col(b)
    l_bl = bl_length_nm(rows, fcols["ch"], fcols["track"], fcols["jog_t"])
    l_bl = l_bl + fcols["jog_b"]
    l_wl = wl_length_nm(cols, fcols["cw"], fcols["jog_wl"])
    return _column_rc_kernel(rows, cols, l_bl, l_wl, n_vias,
                             fcols["r3"], fcols["c3"], fcols["r2"],
                             fcols["c2"], fcols["cj"], fcols["cg"],
                             deck.r_via_ohm, deck.c_via_f)


def extract_point(geom) -> Dict[str, float]:
    """Scalar extraction reference over ROUTED geometry: lengths come
    from the per-net designed-segment records the router laid down, not
    from a formula — so this catches a router that draws the wrong
    ladder, while staying bit-comparable to `extract_lattice`."""
    bank = geom.bank
    tech = bank.cfg.tech
    bl = geom.nets["rbl_0" if bank.is_gc else "bl_0"]
    wl = geom.nets["rwl_0" if bank.is_gc else "wl_0"]
    out = _column_rc_kernel(
        bank.rows, bank.cols, bl.length_nm(), wl.length_nm(), bl.n_vias,
        tech.r_ohm_per_um["m3"], tech.c_f_per_um["m3"],
        tech.r_ohm_per_um["m2"], tech.c_f_per_um["m2"],
        _junction_per_row(bank), _gate_per_col(bank),
        geom.deck.r_via_ohm, geom.deck.c_via_f)
    return {k: float(v) for k, v in out.items()}


def read_column_rc(bank: Bank, deck: Optional[RuleDeck] = None
                   ) -> Dict[str, float]:
    """Extracted read-column parasitics of one bank, closed-form (no
    geometry build) — the values `fidelity=\"layout\"` characterization
    and `timing.analyze(parasitics=\"extracted\")` consume."""
    lat = extract_lattice([bank], deck=deck)
    return {k: float(v[0]) for k, v in lat.items()}


def read_column_segments(bank: Bank, n_seg: int = 8,
                         deck: Optional[RuleDeck] = None) -> Dict[str, object]:
    """Uniform n_seg RC ladder of the extracted read bitline (the shape
    `timing.read_netlist` builds), plus the totals."""
    rc = read_column_rc(bank, deck=deck)
    return {
        "r_seg_ohm": np.full(n_seg, rc["bl_r_ohm"] / n_seg),
        "c_seg_f": np.full(n_seg, rc["bl_c_f"] / n_seg),
        **rc,
    }


def ladder_elmore_s(r_segs, c_segs, r_drv: float = 0.0,
                    c_load: float = 0.0) -> float:
    """Elmore delay of an RC ladder driven through r_drv with a lumped
    load at the far end (test/reporting helper)."""
    rs = np.cumsum(np.asarray(r_segs)) + r_drv
    return float(np.sum(rs * np.asarray(c_segs)) + rs[-1] * c_load)
