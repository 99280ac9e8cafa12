"""Timing: analytical (logical effort + Elmore) and transient-simulated
read/write paths of one bank.

Read critical path: clk->addr DFF -> decoder (logical-effort chain over
row fanout) -> WL RC (Elmore) -> cell drives RBL swing (I_read into
C_RBL) -> sense amp -> out DFF, plus the control delay-chain
quantization: the chain must cover the analog path with margin, and its
stage count jumps at array-size thresholds.

The transient path (`simulate_read`) builds the RBL column netlist
(driver, bitline RC ladder, active cell, SA load) and integrates it with
the dense stepper of `core.spice.transient`, in float64 on `device`;
`core.spice.char_batch.characterize` runs the same netlist and stimulus
over a whole lattice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.core import bank as bank_mod
from repro_torch.core.cells import Sram6T
from repro_torch.core.spice import devices as dv
from repro_torch.core.techfile import with_vdd_scale

FO4_S = 18e-12      # fanout-4 inverter delay in syn40
LE_BRANCH = 2.0     # logical-effort branching per decode stage
REF_SETTLE_S = 40e-12  # GC single-ended read: reference settle adder
WL_DRIVER_R_OHM = 2.5e3 / 4.0   # sized wordline driver
WBL_DRIVER_R_OHM = 800.0        # write-bitline driver
SA_INPUT_C_F = 2e-15            # SA input + mux junction on the RBL
CHAIN_MARGIN = 1.3              # control chain covers analog path by 30%
CHAIN_MAX_STAGES = 64           # before switching to a coarser unit
CHAIN_UNIT_GROWTH = 4.0


# -- pure formulas; elementwise, so they accept scalars or arrays

def elmore_delay(r_drv, r, c):
    """Driver-R + distributed-RC Elmore delay of one wire."""
    return 0.69 * (r_drv * c + 0.5 * r * c)


def cell_swing_time(dv_sense, c_bl, i_net, r_bl):
    """Sense-swing time: current derating (Vds droop over the swing) +
    distributed-RC Elmore of the bitline ladder; calibrated against the
    transient engine to <= 15% (the GEMTOO-class gap, asserted in tests)."""
    return dv_sense * c_bl / (0.75 * i_net) + 0.35 * r_bl * c_bl + 9e-12


def chain_unit(analog_s, unit_s):
    """Delay-chain stage granularity: very slow paths (OS reads) switch to
    a coarser unit, capping the chain at CHAIN_MAX_STAGES."""
    while analog_s * CHAIN_MARGIN / unit_s > CHAIN_MAX_STAGES:
        unit_s *= CHAIN_UNIT_GROWTH
    return unit_s


def bank_at_vdd(bank, vdd_scale: float):
    """A shallow view of `bank` whose config carries the vdd-scaled deck.
    Geometry, floorplan and wire RC are voltage-independent, so the copy
    shares them; only the electrical algebra sees the scaled rail."""
    if vdd_scale == 1.0:
        return bank
    cfg = dataclasses.replace(bank.cfg,
                              tech=with_vdd_scale(bank.cfg.tech, vdd_scale))
    return dataclasses.replace(bank, cfg=cfg)


@dataclass
class Timing:
    """All delays in seconds, `f_max_hz` in hertz."""
    t_read_s: float
    t_write_s: float
    t_wl_s: float
    t_cell_s: float
    t_dec_s: float
    delay_stages: int
    f_max_hz: float
    read_swing_ok: bool

    def as_dict(self):
        return self.__dict__.copy()


def decoder_delay(rows: int) -> float:
    """Logical-effort sized decode chain: delay ~ FO4 * stages, stages ~
    ln(fanout) with branching."""
    n_bits = max(1, int(math.ceil(math.log2(max(rows, 2)))))
    path_effort = rows * LE_BRANCH
    stages = max(2, int(round(math.log(max(path_effort, 2), 4))) + n_bits // 3)
    return stages * FO4_S


def wordline_delay(bank, rc=None) -> float:
    """`rc` (r_ohm, c_f) overrides the hand-modeled wordline RC — the
    hook the layout tier uses to drive this with EXTRACTED parasitics."""
    r, c = rc if rc is not None else bank_mod.wordline_rc(bank)
    return elmore_delay(WL_DRIVER_R_OHM, r, c)


def cell_read_time(bank, *, v_sn=None, rc=None) -> tuple:
    """Time for the cell to move RBL by the sense swing; returns
    (seconds, swing_ok). `rc` (r_ohm, c_f) overrides the hand-modeled
    read-bitline RC (extracted-parasitics hook, via totals included)."""
    tech = bank.cfg.tech
    r_bl, c_bl = rc if rc is not None else bank_mod.bitline_rc(bank)
    c_bl += SA_INPUT_C_F
    if isinstance(bank.cell, Sram6T):
        i = bank.cell.i_read(tech)
        dv_sense = tech.v_sense_diff
        leak = 0.0
    else:
        cell = bank.cell
        if v_sn is None:
            bit = 0 if cell.read_on_sn_low else 1
            v_sn = cell.v_sn_written(tech, bit, wwlls=bank.cfg.wwlls,
                                     wwl_boost=bank.cfg.wwl_boost)
        v_rbl0 = 0.0 if cell.predischarge else tech.vdd
        swing = tech.v_sense_se
        v_rbl_mid = v_rbl0 + (0.5 * swing if cell.predischarge else -0.5 * swing)
        i = cell.i_read(tech, v_sn, v_rbl_mid)
        # unselected leakers fight the read current
        off_sn = cell.v_sn_written(tech, 1 if cell.read_on_sn_low else 0)
        leak = (bank.rows - 1) * cell.i_leak_rbl(tech, off_sn)
        dv_sense = swing
    i_net = max(i - leak, 1e-12)
    ok = i > 3.0 * leak
    return cell_swing_time(dv_sense, c_bl, i_net, r_bl), ok


def write_time(bank) -> float:
    """WBL drive + WL + SN settle through the write device."""
    tech = bank.cfg.tech
    t_wl = wordline_delay(bank)
    r_bl, c_bl = bank_mod.bitline_rc(bank)
    t_bl = elmore_delay(WBL_DRIVER_R_OHM, r_bl, c_bl)
    if isinstance(bank.cell, Sram6T):
        return t_wl + t_bl + 2 * FO4_S
    cell = bank.cell
    wf = cell.wf(tech)
    v_gate = tech.vdd + (bank.cfg.wwl_boost if bank.cfg.wwlls else 0.0)
    i_on = abs(float(dv.channel_current(
        wf, cell.w_write, cell.l_write, v_gate, tech.vdd, tech.vdd * 0.45)))
    t_sn = cell.sn_cap(tech) * 0.9 * tech.vdd / max(i_on, 1e-12)
    return t_wl + t_bl + t_sn


def size_delay_chain(analog_s: float, tech) -> tuple:
    """Control delay-chain sizing: the chain must cover the analog read
    path with >= 30% margin, quantized to stages. Returns (stages,
    unit_s); chain delay is stages * unit_s."""
    unit = chain_unit(analog_s, tech.stage_delay_s)
    return int(math.ceil(analog_s * CHAIN_MARGIN / unit)), unit


def analyze(bank, *, vdd_scale: float = 1.0,
            parasitics: str = "modeled") -> Timing:
    """Analytic read/write timing closure of one bank, with the hand RC
    models of `core.bank`. Sets `bank.delay_stages`.

    parasitics="extracted" (layout-extracted read-column RC) waits for
    the layout tier."""
    if parasitics == "extracted":
        raise NotImplementedError(
            "timing.analyze(parasitics='extracted') is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 10 (layout tier))")
    if parasitics != "modeled":
        raise ValueError(f"parasitics must be 'modeled' or 'extracted', "
                         f"got {parasitics!r}")
    bank = bank_at_vdd(bank, vdd_scale)
    tech = bank.cfg.tech
    t_dec = decoder_delay(bank.rows)
    t_wl = wordline_delay(bank)
    t_cell, ok = cell_read_time(bank)
    t_colmux = 2 * FO4_S if bank.has_colmux else 0.0
    analog = t_wl + t_cell + t_colmux + tech.sa_delay_s
    if bank.is_gc:
        analog += REF_SETTLE_S  # single-ended sensing reference settle
    stages, unit = size_delay_chain(analog, tech)
    t_chain = stages * unit
    t_read = tech.dff_delay_s + t_dec + t_chain + tech.dff_delay_s
    t_wr = tech.dff_delay_s + t_dec + max(write_time(bank), t_chain * 0.6)
    bank.delay_stages = stages
    f = 1.0 / max(t_read, t_wr)
    return Timing(t_read, t_wr, t_wl, t_cell, t_dec, stages, f, ok)


# ---------------------------------------------------------------------------
# transient-simulated read path
# ---------------------------------------------------------------------------


T_END_MIN_S = 0.5e-9        # stop-time floor for the read transient
T_END_OVER_ANALYTIC = 6.0   # stop time as a multiple of the analytic t_cell
T0_FRACTION = 0.05          # precharge-release instant as fraction of t_end


def read_stimulus(cell, tech, v_sn: float, t0: float):
    """The four read-path drive waveforms (rwl activation, precharge/
    predischarge release, SN level, VDD rail) and the RBL idle level.

    SINGLE source of truth for the stimulus recipe: the scalar
    `simulate_read` and the batched `char_batch` pipeline both build
    their waves here, which is what anchors their 1% parity contract —
    edit timings/levels in one place only."""
    vdd = tech.vdd
    rwl_idle = vdd if not cell.rwl_active_high else 0.0
    rwl_act = 0.0 if not cell.rwl_active_high else vdd
    v_pre = 0.0 if cell.predischarge else vdd
    en_idle = 0.0 if not cell.predischarge else vdd
    en_off = vdd if not cell.predischarge else 0.0
    waves = [
        ([0.0, t0, t0 * 1.2], [rwl_idle, rwl_idle, rwl_act]),
        ([0.0, t0 * 0.8, t0], [en_idle, en_idle, en_off]),
        ([0.0, 1.0], [v_sn, v_sn]),
        ([0.0, 1.0], [vdd, vdd]),
    ]
    return waves, v_pre


def read_netlist(bank, n_seg: int = 8, rc=None):
    """RBL column: WL driver -> RC ladder -> active cell + lumped leakers
    -> SA cap. Returns (Circuit, metadata). `rc` (r_ohm, c_f) overrides
    the hand-modeled ladder totals with extracted ones; the element
    STRUCTURE is identical either way (via R/C folds uniformly into the
    ladder segments), so topology-grouped batching is unaffected."""
    from repro_torch.core.spice.mna import Circuit
    tech = bank.cfg.tech
    cell = bank.cell
    r_bl, c_bl = rc if rc is not None else bank_mod.bitline_rc(bank)
    ckt = Circuit()
    # RWL driver as a voltage source on the cell gate path; RBL ladder:
    ckt.vsrc("rwl", 0)
    pre_high = not cell.predischarge
    # precharge PMOS / predischarge NMOS gated by EN (wave 1) — the
    # paper's Read_Port_Data modification (§V-A): released at t0.
    ckt.vsrc("pre_en", 1)
    if pre_high:
        ckt.vsrc("vdd", 3)
        ckt.dev(tech.flavor("pmos_svt"), 1.2, 0.04, "pre_en", "vdd",
                "rbl_0", name="precharge")
    else:
        ckt.dev(tech.flavor("nmos_svt"), 1.2, 0.04, "pre_en", "rbl_0",
                "0", name="predischarge")
    for i in range(n_seg):
        a, b = f"rbl_{i}", f"rbl_{i+1}"
        ckt.r(a, b, r_bl / n_seg)
        ckt.c(b, "0", c_bl / n_seg)
    ckt.c("rbl_0", "0", 2e-15)  # SA input
    # active cell at the far end: read device gate=SN (source), RBL drain
    bit = 0 if cell.read_on_sn_low else 1
    v_sn = cell.v_sn_written(tech, bit, wwlls=bank.cfg.wwlls,
                             wwl_boost=bank.cfg.wwl_boost)
    ckt.vsrc("sn", 2)
    rf = cell.rf(tech)
    far = f"rbl_{n_seg}"
    ckt.dev(rf, cell.w_read, cell.l_read, "sn", far, "rwl", name="read_dev")
    ckt.probe("rbl_near", "rbl_0")
    ckt.probe("rbl_far", far)
    meta = {"v_sn": v_sn, "pre_high": pre_high, "vdd": tech.vdd}
    return ckt, meta


def simulate_read(bank, n_steps=300, t_end=None, solver="jnp",
                  device="cuda"):
    """Transient RBL swing; returns (t_cell_sim_seconds, traces).

    Integrates in float64 on `device`: the MNA Jacobian's G_BIG Norton
    rows put cond(J) around 1e6, so float32 Newton iterates carry ~1e-1
    relative noise. With solver="pallas" each Newton solve runs in
    float32 (the Gauss-Jordan kernel) against the float64 residual."""
    from repro_torch.core.spice.transient import Transient, crossing_time
    tech = bank.cfg.tech
    cell = bank.cell
    ckt, meta = read_netlist(bank)
    sys = ckt.build(device=device)
    tr = Transient(sys, solver=solver)
    t_an, _ = cell_read_time(bank)
    t_end = t_end or max(T_END_OVER_ANALYTIC * t_an, T_END_MIN_S)
    t0 = T0_FRACTION * t_end
    waves, v_pre = read_stimulus(cell, tech, meta["v_sn"], t0)
    res = tr.run(waves, t_end, n_steps=n_steps,
                 v0=torch.full((sys.n,), v_pre, dtype=torch.float64,
                               device=sys.device))
    swing = tech.v_sense_se
    target = v_pre + (swing if cell.predischarge else -swing)
    tc, valid = crossing_time(res["t"], res["rbl_near"], target,
                              rising=cell.predischarge)
    t_cell = float(tc) - t0 if bool(valid) else float("inf")
    return float(t_cell), res
