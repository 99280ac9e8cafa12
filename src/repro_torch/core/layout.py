"""Constructive layout/floorplan model: areas EMERGE from the rule deck
(poly pitches x routing tracks + explicit DRC margins + power rings) —
the thing GEMTOO's analytical model omits (paper §III-C).

Outputs: cell area, array area (with rail overhead), per-module
peripheral areas, and the bank floorplan (Fig 4/5): Write_Port_Address
left, Read_Port_Address right, Write_Port_Data bottom, Read_Port_Data
top, control corners, power ring(s) around everything.
A JSON-able manifest of module bounding boxes stands in for GDS (foundry
layers are NDA'd; DESIGN.md §2 assumption 3).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.core.techfile import TechFile

UM2_PER_NM2 = 1e-6

# peripheral-module footprints in (poly pitches, tracks) per instance.
# Calibrated against the paper's Fig 6 bank/array ratios (OpenRAM-class
# modules are routing-dominated and large; tests/test_core assert the
# resulting ratios).
MODULE_GEOM = {
    "wl_driver":     (5.0, 8.0),    # per row, logical-effort sized chain
    "decoder_unit":  (7.0, 8.0),    # per row (pre+final NAND)
    "precharge":     (2.0, 6.0),    # per column
    "predischarge":  (2.5, 6.0),    # per column (+EN inverter shared)
    "colmux_unit":   (2.0, 6.0),    # per column
    "sense_amp":     (11.0, 8.0),   # SRAM differential SA per data bit
    "sense_amp_se":  (22.0, 10.0),  # GC single-ended SA + reference rail
    "write_driver":  (9.0, 8.0),    # GC single-ended write driver
    "write_driver_diff": (11.0, 8.0),  # SRAM differential write driver
    "dff":           (8.0, 8.0),    # per bit (addr/data/control)
    "refgen":        (120.0, 16.0), # one per bank (GC single-ended read)
    "ctrl_base":     (90.0, 16.0),  # control FSM + clk gating
    "delay_stage":   (4.0, 8.0),    # per delay-chain stage
    "wwl_ls":        (7.0, 8.0),    # per-row WWL level shifter
}

RING_W_NM = 1200          # one power ring width (supply pair)
BLOCK_MARGIN_NM = 400     # DRC spacing between placed blocks
ROUTING_FACTOR = 2.2      # placed-module to routed-strip area overhead
GC_PORT_FACTOR = 1.2      # dual-port bus routing overhead on GC strips
PACK_FACTOR = 1.6         # packed (BEOL-under-array) floorplan: routing
                          # overhead without the strip whitespace


def cell_wh_nm(tech: TechFile, geom_key: str):
    """Drawn cell width/height in nm. The DRC margin is isotropic —
    sqrt(1+margin) on each dimension — so the w/h aspect ratio stays the
    drawn (poly pitches x tracks) ratio; the old form lumped the whole
    margin onto the width, which skewed wordline-vs-bitline lengths."""
    g = tech.cell_geoms[geom_key]
    s = (1.0 + g["margin"]) ** 0.5
    return (g["poly_pitches"] * tech.cpp * s, g["tracks"] * tech.track * s)


def cell_area_um2(tech: TechFile, geom_key: str) -> float:
    """Defined as the EXACT product of cell_wh_nm (tests assert
    w * h == area bitwise — one source of truth for cell footprint)."""
    w, h = cell_wh_nm(tech, geom_key)
    return w * h * UM2_PER_NM2


def module_area_um2(tech: TechFile, kind: str, n: int = 1) -> float:
    pp, tr = MODULE_GEOM[kind]
    return n * pp * tech.cpp * tr * tech.track * UM2_PER_NM2


@dataclass
class Floorplan:
    bank_w_um: float
    bank_h_um: float
    array_w_um: float
    array_h_um: float
    modules: List[dict] = field(default_factory=list)

    @property
    def bank_area_um2(self):
        return self.bank_w_um * self.bank_h_um

    @property
    def array_area_um2(self):
        return self.array_w_um * self.array_h_um

    @property
    def array_efficiency(self):
        return self.array_area_um2 / self.bank_area_um2

    def manifest(self) -> dict:
        return {"bank_w_um": self.bank_w_um, "bank_h_um": self.bank_h_um,
                "array_w_um": self.array_w_um, "array_h_um": self.array_h_um,
                "array_efficiency": self.array_efficiency,
                "modules": self.modules}


def packed_floorplan(tech: TechFile, *, geom_key: str, rows: int, cols: int,
                     periph_um2: float, n_rings: int) -> "Floorplan":
    """Monolithic-3D floorplan for BEOL cells (OS-OS): the bitcell array is
    fabricated between upper metal layers ON TOP of the Si periphery
    (paper §V-A/§V-B: "taking no Si area budget"), so the bank footprint
    is max(array, packed periphery) + power ring."""
    import math as _m
    cw, ch = cell_wh_nm(tech, geom_key)
    aw = cols * cw * 1e-3
    ah = (rows * ch + (rows // 16 + 1) * 2 * tech.track) * 1e-3
    core = max(aw * ah, periph_um2 * PACK_FACTOR)
    side = _m.sqrt(core)
    ring = n_rings * RING_W_NM * 1e-3
    bw = side + 2 * ring
    bh = side + 2 * ring
    mods = [
        {"name": "bitcell_array(BEOL, stacked)", "x": ring, "y": ring,
         "w": aw, "h": ah},
        {"name": "periphery(under array)", "x": ring, "y": ring,
         "w": side, "h": side},
        {"name": "power_rings", "x": 0, "y": 0, "w": bw, "h": bh,
         "rings": n_rings},
    ]
    return Floorplan(bw, bh, aw, ah, mods)


def floorplan(tech: TechFile, *, geom_key: str, rows: int, cols: int,
              left_um2: float, right_um2: float, top_um2: float,
              bottom_um2: float, corner_um2: float, n_rings: int,
              rail_rows_per: int = 16) -> Floorplan:
    """Place array + four peripheral strips + corner control + rings.

    rail_rows_per: a horizontal power-rail row is inserted every N cell
    rows (array overhead that shrinks RELATIVELY as banks grow — drives
    the paper's Fig 6(b,c) trend).
    """
    cw, ch = cell_wh_nm(tech, geom_key)
    rail_rows = rows // rail_rows_per + 1
    aw = cols * cw * 1e-3                                # um
    ah = (rows * ch + rail_rows * 2 * tech.track) * 1e-3
    m = BLOCK_MARGIN_NM * 1e-3

    rf = ROUTING_FACTOR
    lw = rf * left_um2 / ah if ah > 0 else 0.0           # strip widths
    rw = rf * right_um2 / ah if ah > 0 else 0.0
    th = rf * top_um2 / aw if aw > 0 else 0.0
    bh = rf * bottom_um2 / aw if aw > 0 else 0.0
    corner_um2 = rf * corner_um2

    core_w = lw + m + aw + m + rw
    core_h = th + m + ah + m + bh
    # corner blocks (control/refgen) fold into the larger dimension
    core_w += corner_um2 / max(core_h, 1e-9)
    ring = n_rings * RING_W_NM * 1e-3
    bw = core_w + 2 * ring
    bhgt = core_h + 2 * ring

    mods = [
        {"name": "bitcell_array", "x": ring + lw + m, "y": ring + bh + m,
         "w": aw, "h": ah},
        {"name": "left_port_address", "x": ring, "y": ring + bh + m,
         "w": lw, "h": ah},
        {"name": "right_port_address", "x": ring + lw + 2 * m + aw,
         "y": ring + bh + m, "w": rw, "h": ah},
        {"name": "top_port_data", "x": ring + lw + m, "y": ring + bh + 2 * m + ah,
         "w": aw, "h": th},
        {"name": "bottom_port_data", "x": ring + lw + m, "y": ring,
         "w": aw, "h": bh},
        {"name": "power_rings", "x": 0, "y": 0, "w": bw, "h": bhgt,
         "rings": n_rings},
    ]
    return Floorplan(bw, bhgt, aw, ah, mods)
