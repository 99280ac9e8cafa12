"""Bitcell library: 6T SRAM baseline + gain-cell variants.

Topology conventions (documented deviation from the paper noted in
DESIGN.md §2: the paper describes predischarge for all Si-Si reads; here
each config gets the electrically coherent scheme for its read device):

  gc2t_nn   write NMOS; read NMOS (gate=SN, source=RWL, drain=RBL).
            RWL idles at VDD and falls on read (ACTIVE-LOW — its falling
            edge couples SN down, the paper's §V-A problem). RBL
            precharged HIGH; SN='1' discharges it.
  gc2t_np   write NMOS; read PMOS. RWL idles 0, rises on read
            (ACTIVE-HIGH — rising edge boosts SN, recovering WWL-coupling
            droop). RBL PREDISCHARGED to 0; SN='0' charges it up
            (paper's predischarge + EN-inverter modification).
  gc2t_osos both OS NMOS (p-type OS too slow — paper §V-A); BEOL cell,
            precharge scheme like nn.
  gc3t      write NMOS + 2-NMOS read stack (decoupled read, better sense
            margin, more area).
  gc2t_hyb  OS write + Si PMOS read (paper §VI / ref [15]).
  sram6t    baseline: differential BL/BLb, shared-port.

Every cell exposes: device list (for leakage/netlists), SN capacitance,
post-write SN level, read current into/out of the RBL, coupling deltas.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core.spice import devices as dv
from repro_torch.core.techfile import DeviceFlavor, TechFile


@dataclass(frozen=True)
class Bitcell:
    name: str
    geom_key: str
    write_flavor: str
    read_flavor: str
    w_write: float = 0.12          # um
    w_read: float = 0.16
    l_write: float = 0.06          # longer L on the write device: retention
    l_read: float = 0.04
    rwl_active_high: bool = False  # np: True
    predischarge: bool = False     # np/hyb: RBL starts low, '0' charges it
    is_beol: bool = False          # OS cells take no FEOL area
    read_on_sn_low: bool = False   # PMOS read: conducts when SN low
    wwl_couple_ratio: float = 0.06 # C_couple/C_SN of WWL falling edge
    rwl_couple_ratio: float = 0.05

    # ---- derived electrical quantities ----
    def wf(self, tech: TechFile) -> DeviceFlavor:
        return tech.flavor(self.write_flavor)

    def rf(self, tech: TechFile) -> DeviceFlavor:
        return tech.flavor(self.read_flavor)

    def sn_cap(self, tech: TechFile) -> float:
        rf, wf = self.rf(tech), self.wf(tech)
        return (rf.cg_f_per_um * self.w_read + wf.cj_f_per_um * self.w_write
                + tech.sn_wire_cap_f)

    def v_sn_written(self, tech: TechFile, bit: int, *, wwlls=False,
                     wwl_boost=0.55, creep=0.12) -> float:
        """Post-write SN voltage incl. source-follower creep, WWL-coupling
        droop at WWL falloff and RWL-edge coupling at read idle level."""
        wf = self.wf(tech)
        vdd = tech.vdd
        if bit == 0:
            v = 0.0
        else:
            v_wwl = vdd + (wwl_boost if wwlls else 0.0)
            v = min(vdd, v_wwl - wf.vt0 + creep)
        v -= self.wwl_couple_ratio * vdd            # WWL falling edge
        if self.rwl_active_high:
            v += self.rwl_couple_ratio * vdd        # NP: RWL rise boosts SN
        return max(v, 0.0)

    def i_read(self, tech: TechFile, v_sn: float, v_rbl: float) -> float:
        """|I| the cell drives on the RBL at SN=v_sn, RBL=v_rbl (A)."""
        rf = self.rf(tech)
        vdd = tech.vdd
        if rf.polarity > 0:
            # NMOS read: active RWL=0; discharges RBL (precharged high)
            i = dv.channel_current(rf, self.w_read, self.l_read,
                                   v_sn, v_rbl, 0.0)
        else:
            # PMOS read: active RWL=vdd; charges RBL (predischarged low)
            i = dv.channel_current(rf, self.w_read, self.l_read,
                                   v_sn, vdd, v_rbl)
        return abs(float(i))

    def i_leak_rbl(self, tech: TechFile, unselected_v_sn: float) -> float:
        """Off-state RBL leakage of ONE unselected cell (A): limits rows
        per bitline (sense-margin erosion)."""
        rf = self.rf(tech)
        vdd = tech.vdd
        if rf.polarity > 0:
            # unselected: RWL=vdd -> vgs_on = v_sn - vdd < 0
            i = dv.channel_current(rf, self.w_read, self.l_read,
                                   unselected_v_sn, vdd * 0.9, vdd)
        else:
            i = dv.channel_current(rf, self.w_read, self.l_read,
                                   vdd, vdd * 0.1, 0.0)
        return abs(float(i))

    def i_sn_leak(self, tech: TechFile, v_sn: float) -> float:
        """Total SN leakage at v_sn: write-device subthreshold + read-gate
        leakage (paper §V-D: the retention mechanism)."""
        wf, rf = self.wf(tech), self.rf(tech)
        i_w = abs(float(dv.channel_current(wf, self.w_write, self.l_write,
                                           0.0 if wf.polarity > 0 else tech.vdd,
                                           v_sn, 0.0)))
        i_g = abs(float(dv.i_gate(rf, self.w_read, v_sn, tech.vdd / 2)))
        return i_w + i_g

    def cell_leakage(self, tech: TechFile) -> float:
        """Static VDD->GND leakage power of an idle cell (W). Gain cells
        have NO static path (paper C7) — only SRAM burns static power."""
        return 0.0


@dataclass(frozen=True)
class Sram6T:
    name: str = "sram6t"
    geom_key: str = "sram6t"
    w_pd: float = 0.20
    w_pu: float = 0.10
    w_ax: float = 0.14
    l: float = 0.04

    def sn_cap(self, tech):  # not used (static cell)
        return 0.0

    def i_read(self, tech: TechFile, v_sn=None, v_rbl=None) -> float:
        """Differential read current through access+pulldown at read onset."""
        nm = tech.flavor("nmos_svt")
        i_ax = dv.channel_current(nm, self.w_ax, self.l, tech.vdd,
                                  tech.vdd * 0.9, 0.0)
        return abs(float(i_ax)) * 0.7  # series pulldown derating

    def cell_leakage(self, tech: TechFile) -> float:
        """Idle VDD->GND leakage (W): one off pull-up + one off pull-down +
        access junctions; classic 6T three-path approximation."""
        nm, pm = tech.flavor("nmos_svt"), tech.flavor("pmos_svt")
        i = (dv.i_off(nm, self.w_pd, self.l, tech.vdd)
             + dv.i_off(pm, self.w_pu, self.l, tech.vdd)
             + dv.i_off(nm, self.w_ax, self.l, tech.vdd) * 0.5)
        return i * tech.vdd


CELLS = {
    "sram6t": Sram6T(),
    "gc2t_nn": Bitcell("gc2t_nn", "gc2t_nn", "nmos_svt", "nmos_svt"),
    "gc2t_np": Bitcell("gc2t_np", "gc2t_np", "nmos_svt", "pmos_svt",
                       rwl_active_high=True, predischarge=True,
                       read_on_sn_low=True),
    "gc2t_osos": Bitcell("gc2t_osos", "gc2t_osos", "os_n", "os_n",
                         w_write=0.10, w_read=0.20, is_beol=True,
                         wwl_couple_ratio=0.04),
    "gc3t": Bitcell("gc3t", "gc3t", "nmos_svt", "nmos_svt", w_read=0.20,
                    wwl_couple_ratio=0.03, rwl_couple_ratio=0.01),
    "gc2t_hyb": Bitcell("gc2t_hyb", "gc2t_hyb", "os_n", "pmos_svt",
                        rwl_active_high=True, predischarge=True,
                        read_on_sn_low=True),
}


def with_write_vt(cell: Bitcell, flavor: str) -> Bitcell:
    """VT-modulated variant (paper Fig 8c)."""
    return replace(cell, write_flavor=flavor,
                   name=f"{cell.name}:{flavor}")


# ---------------------------------------------------------------------------
# traced variants of the electrical primitives (core/dse_grad.py)
#
# The Bitcell methods above return Python floats and branch on scalar
# comparisons, which cuts autograd. These twins compute the same algebra
# in torch, with the continuous knobs (vdd, device widths) as float64
# tensors so gradients flow; the discrete cell attributes stay Python
# branches (static per cell).
# ---------------------------------------------------------------------------

def v_sn_written_t(cell: Bitcell, tech: TechFile, bit: int, vdd, *,
                   wwlls=False, wwl_boost=0.55, creep=0.12):
    """Traced twin of Bitcell.v_sn_written: the post-write SN level with
    the operating voltage `vdd` as a tensor."""
    wf = cell.wf(tech)
    vdd = torch.as_tensor(vdd, dtype=torch.float64)
    if bit == 0:
        v = torch.zeros_like(vdd)
    else:
        v_wwl = vdd + (wwl_boost if wwlls else 0.0)
        v = torch.minimum(vdd, v_wwl - wf.vt0 + creep)
    v = v - cell.wwl_couple_ratio * vdd
    if cell.rwl_active_high:
        v = v + cell.rwl_couple_ratio * vdd
    return v.clamp_min(0.0)


def i_read_t(cell: Bitcell, tech: TechFile, v_sn, v_rbl, vdd, w_read):
    """Traced twin of Bitcell.i_read: |I| onto the RBL, with vdd and the
    read-device width as tensors."""
    rf = cell.rf(tech)
    v_rbl = torch.as_tensor(v_rbl, dtype=torch.float64)
    if rf.polarity > 0:
        i = dv.channel_current(rf, w_read, cell.l_read, v_sn, v_rbl,
                               torch.zeros_like(v_rbl))
    else:
        i = dv.channel_current(rf, w_read, cell.l_read, v_sn, vdd, v_rbl)
    return i.abs()


def i_leak_rbl_t(cell: Bitcell, tech: TechFile, unselected_v_sn, vdd,
                 w_read):
    """Traced twin of Bitcell.i_leak_rbl (one unselected cell's off-state
    RBL leakage)."""
    rf = cell.rf(tech)
    vdd = torch.as_tensor(vdd, dtype=torch.float64)
    if rf.polarity > 0:
        i = dv.channel_current(rf, w_read, cell.l_read, unselected_v_sn,
                               vdd * 0.9, vdd)
    else:
        i = dv.channel_current(rf, w_read, cell.l_read, vdd, vdd * 0.1,
                               torch.zeros_like(vdd))
    return i.abs()


def sn_cap_t(cell: Bitcell, tech: TechFile, w_read, w_write):
    """Traced twin of Bitcell.sn_cap with both device widths as
    tensors."""
    rf, wf = cell.rf(tech), cell.wf(tech)
    return (rf.cg_f_per_um * w_read + wf.cj_f_per_um * w_write
            + tech.sn_wire_cap_f)
