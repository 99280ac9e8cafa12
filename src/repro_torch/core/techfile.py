"""Synthetic 40 nm technology deck ("syn40").

TSMC N40 SPICE models and design rules are NDA'd (the paper's own repo
withholds them too), so OpenGCRAM-JAX defines an OPEN deck with
public-ballpark constants and calibrates to the paper's reported RATIOS
(cell-area ratios, retention ranges, frequency orderings) rather than
absolute foundry numbers — see DESIGN.md §2 assumption 1.

Everything downstream (cells, bank, layout, timing, power, retention)
reads ONLY from this file, so porting to a different node is: write a new
TechFile (the paper's Fig 1(a) porting flow, step 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

PHI_T = 0.02585  # kT/q at 300 K


@dataclass(frozen=True)
class DeviceFlavor:
    """EKV-style compact-model parameters for one transistor flavor."""
    name: str
    polarity: int          # +1 NMOS, -1 PMOS
    vt0: float             # V
    ss_mv_dec: float       # subthreshold swing
    k_prime: float         # A/V^2 per square (mu*Cox/2 effective)
    lambda_: float         # channel-length modulation 1/V
    cg_f_per_um: float     # gate cap per um width
    cj_f_per_um: float     # junction cap per um width
    i_gate_a_per_um: float # gate leakage
    is_os: bool = False

    @property
    def n_slope(self) -> float:
        return self.ss_mv_dec / (1000.0 * PHI_T * 2.302585)

    def i_off_a_per_um(self, l_um: float, vdd: float) -> float:
        """Analytic off-current (Vgs_on=0, |Vds|=vdd) per um of width."""
        from repro_torch.core.spice.devices import i_off
        return i_off(self, 1.0, l_um, vdd)


@dataclass(frozen=True)
class TechFile:
    name: str = "syn40"
    vdd: float = 1.1
    temp_k: float = 300.0

    # ---- geometry (nm) ----
    cpp: int = 160                 # contacted poly pitch
    m1_pitch: int = 120
    m2_pitch: int = 140
    track: int = 120               # routing track height
    min_l_nm: int = 40

    # ---- wires ----
    r_ohm_per_um: Dict[str, float] = field(default_factory=lambda: {
        "m1": 2.2, "m2": 1.6, "m3": 1.2, "m4": 0.9})
    c_f_per_um: Dict[str, float] = field(default_factory=lambda: {
        "m1": 0.20e-15, "m2": 0.19e-15, "m3": 0.18e-15, "m4": 0.17e-15})

    # ---- bitcell geometry (poly pitches x routing tracks; DRC-margin
    #      constants emerge in layout.py) ----
    cell_geoms: Dict[str, dict] = field(default_factory=lambda: {
        # 6T SRAM with logic design rules (paper Fig 3c)
        "sram6t":   {"poly_pitches": 3.0, "tracks": 8.0, "margin": 0.00},
        # 2T Si-Si gain cell, logic rules: 2 CPP + dummy-WL/GND rail
        # spacing the paper notes could be merged (Fig 3a, 69% of 6T)
        "gc2t_nn":  {"poly_pitches": 2.0, "tracks": 8.0, "margin": 0.035},
        "gc2t_np":  {"poly_pitches": 2.0, "tracks": 8.0, "margin": 0.055},
        # 2T OS-OS: BEOL transistors between tight-pitch metals; FEOL
        # footprint is via landing + rail sharing only (Fig 3b, 11% of 6T)
        "gc2t_osos": {"poly_pitches": 1.0, "tracks": 2.6, "margin": 0.02},
        # 3T gain cell (separate read stack) and hybrid OS-Si
        "gc3t":     {"poly_pitches": 3.0, "tracks": 8.0, "margin": 0.02},
        "gc2t_hyb": {"poly_pitches": 1.6, "tracks": 8.0, "margin": 0.03},
    })

    # ---- storage-node parasitics (F) beyond read-gate cap ----
    sn_wire_cap_f: float = 0.12e-15

    # ---- sensing ----
    v_sense_se: float = 0.10       # single-ended RBL swing needed (V)
    v_sense_diff: float = 0.08     # differential SRAM BL swing
    sa_delay_s: float = 60e-12
    dff_delay_s: float = 70e-12
    stage_delay_s: float = 26e-12  # control delay-chain stage granularity

    # ---- devices ----
    devices: Dict[str, DeviceFlavor] = field(default_factory=lambda: {
        # silicon, three VT flavors (paper Fig 8c modulates write-NMOS VT)
        "nmos_lvt": DeviceFlavor("nmos_lvt", +1, 0.32, 95.0, 3.1e-4, 0.12,
                                 1.00e-15, 0.55e-15, 2.0e-15),
        "nmos_svt": DeviceFlavor("nmos_svt", +1, 0.42, 92.0, 2.9e-4, 0.10,
                                 1.00e-15, 0.55e-15, 1.0e-15),
        "nmos_hvt": DeviceFlavor("nmos_hvt", +1, 0.52, 90.0, 2.6e-4, 0.08,
                                 1.00e-15, 0.55e-15, 0.5e-15),
        "pmos_lvt": DeviceFlavor("pmos_lvt", -1, 0.34, 98.0, 1.5e-4, 0.14,
                                 1.05e-15, 0.60e-15, 1.0e-15),
        "pmos_svt": DeviceFlavor("pmos_svt", -1, 0.44, 95.0, 1.4e-4, 0.12,
                                 1.05e-15, 0.60e-15, 0.6e-15),
        "pmos_hvt": DeviceFlavor("pmos_hvt", -1, 0.54, 92.0, 1.2e-4, 0.10,
                                 1.05e-15, 0.60e-15, 0.3e-15),
        # oxide-semiconductor (ITO-like): low mobility, steep SS, ultra-low
        # leakage; TCAD-calibrated verilog-A analogue (paper §V-D). The
        # default flavor lands ms-range retention (Fig 8e); the hvt flavor
        # is the "VT/material engineering" point with >10 s retention.
        "os_n":     DeviceFlavor("os_n", +1, 0.45, 68.0, 6.0e-6, 0.05,
                                 0.80e-15, 0.25e-15, 1.0e-20, is_os=True),
        "os_n_hvt": DeviceFlavor("os_n_hvt", +1, 0.80, 66.0, 5.0e-6, 0.05,
                                 0.80e-15, 0.25e-15, 1.0e-21, is_os=True),
    })

    def flavor(self, name: str) -> DeviceFlavor:
        return self.devices[name]


SYN40 = TechFile()


# ---------------------------------------------------------------------------
# operating points (paper: retention is tuned "on-the-fly by changing the
# operating voltage")
# ---------------------------------------------------------------------------

# memoized so a given (deck, scale) pair always yields the SAME TechFile
# object: dse_batch.topology_key groups by id(cfg.tech), and session/point
# caches rely on stable identity across calls. Values keep a reference to
# the base deck so its id() cannot be recycled while the entry lives.
_VDD_SCALED: Dict[tuple, Tuple["TechFile", "TechFile"]] = {}


def with_vdd_scale(tech: TechFile, vdd_scale: float) -> TechFile:
    """The deck at a scaled operating voltage: identical devices, wires
    and geometry, `vdd` multiplied by `vdd_scale`. Everything downstream
    (written SN levels, read currents, retention leakage, dynamic CV^2
    energies) follows automatically because it reads only `tech.vdd`;
    voltage-independent periphery constants (sense swings, SA/DFF/stage
    delays) are deliberately left untouched — the VDD axis models the
    ARRAY operating point, not a resized periphery."""
    vdd_scale = float(vdd_scale)
    if vdd_scale == 1.0:
        return tech
    if vdd_scale <= 0.0:
        raise ValueError(f"vdd_scale must be > 0, got {vdd_scale}")
    key = (id(tech), vdd_scale)
    hit = _VDD_SCALED.get(key)
    if hit is None:
        scaled = dataclasses.replace(
            tech, name=f"{tech.name}@{vdd_scale:g}vdd",
            vdd=tech.vdd * vdd_scale)
        _VDD_SCALED[key] = hit = (scaled, tech)
    return hit[0]
