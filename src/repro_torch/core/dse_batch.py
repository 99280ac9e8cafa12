"""Batched (struct-of-arrays) lattice evaluator for design-space sweeps,
with an operating-voltage axis.

Port of `repro.core.dse_batch`. `dse.evaluate` is the scalar reference:
per config it rebuilds the bank, re-integrates retention and runs the
timing and power algebra on host floats. This module evaluates a whole
lattice at once:

  1. group configs by cell topology (cell, write-VT override, WWLLS,
     WWL boost, tech) so every group shares its cell electricals;
  2. compute the group-constant electricals ONCE per (group, vdd_scale)
     with the SAME scalar calls `dse.evaluate` makes (read/leak currents
     at the written SN level, the retention integral on `device`, the
     write SN settle);
  3. run the per-point analytic timing + power algebra over the group's
     struct-of-arrays (rows, wire RC, word size, ...) in float64 on
     `device`, reusing the formula kernels of `core.timing`: the
     per-voltage constants have shape (V, 1) and the structural arrays
     (1, P), so broadcasting takes the place of the reference's nested
     `jax.vmap` (geometry and wire RC are voltage-independent, so the
     structural arrays are shared across the whole voltage ladder).

Because the group constants come from the identical scalar calls and the
per-point algebra is the identical float64 expression tree, batched
results match `dse.evaluate` on the same device bit for bit. On CUDA
every divisor is a float64 tensor on the device: PyTorch's CUDA division
by a host scalar multiplies by its reciprocal, an ulp off a true
division.

On top of the (vdd x lattice) tables this module vectorizes the
workload-matching layer that `dse.feasible` / `multibank.banks_needed`
define scalarly: `feasible_grid`, `banks_needed_grid` and
`codesign_metrics` evaluate (vdd x lattice x demand) grids in a few
float64 tensor operations each. Results come back as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bank as bank_mod
from repro_torch.core import retention as ret_mod
from repro_torch.core import timing as timing_mod
from repro_torch.core.bank import BankConfig, build_bank
from repro_torch.core.dse import DesignPoint
from repro_torch.core.power import PERIPH_LEAK_W_PER_UM2
from repro_torch.core.spice import devices as dv
from repro_torch.core.techfile import with_vdd_scale

F64 = torch.float64


def pow2_bucket(n: int, floor: int = 4) -> int:
    """Smallest power-of-two >= n, floored at `floor`: the shared
    batch-bucketing rule, so batches of varying size land in a handful
    of shapes (`core.spice.char_batch` buckets its lattice lanes)."""
    return max(floor, 1 << max(0, n - 1).bit_length())


def pad_bucket(a: np.ndarray, bucket: int) -> np.ndarray:
    """Edge-repeat `a` along axis 0 up to `bucket` rows (no-op when
    already there). Padded rows are dropped by the caller's slice-back,
    so bucketing is value-transparent."""
    n = a.shape[0]
    if bucket <= n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], bucket - n, axis=0)],
                          axis=0)


def topology_key(cfg: BankConfig) -> tuple:
    """Cell-topology grouping key: configs sharing it have identical cell
    electricals and (for the transient pipeline) identical critical-path
    netlist STRUCTURE — only wire/structural values differ. Shared with
    `core.spice.char_batch`."""
    return (cfg.cell, cfg.write_vt, cfg.wwlls, cfg.wwl_boost, id(cfg.tech))


def group_by_topology(cfgs: Sequence[BankConfig]) -> Dict[tuple, List[int]]:
    """Indices of `cfgs` grouped by topology_key, preserving order."""
    groups: Dict[tuple, List[int]] = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(topology_key(cfg), []).append(i)
    return groups


def evaluate_batch(cfgs: Sequence[BankConfig], vdd_scale: float = 1.0,
                   device="cuda") -> List[DesignPoint]:
    """Evaluate every config (at one operating voltage) on `device`;
    returns DesignPoints in input order. Thin wrapper over the one-row
    (vdd x lattice) table so there is a single materialization path."""
    lat = evaluate_vdd_lattice(cfgs, (float(vdd_scale),), device=device)
    return [lat.point(0, i) for i in range(len(lat.cfgs))]


def _group_constants(cfg0: BankConfig, bank0, vdd_scale: float = 1.0,
                     device="cuda") -> dict:
    """Electricals that depend only on (cell topology, operating voltage)
    — computed with the same scalar calls the reference `dse.evaluate`
    path makes at that vdd_scale; the retention integral on `device`."""
    tech = with_vdd_scale(cfg0.tech, vdd_scale)
    cell = bank0.cell
    if bank0.is_gc:
        bit = 0 if cell.read_on_sn_low else 1
        v_sn = cell.v_sn_written(tech, bit, wwlls=cfg0.wwlls,
                                 wwl_boost=cfg0.wwl_boost)
        v_rbl0 = 0.0 if cell.predischarge else tech.vdd
        swing = tech.v_sense_se
        v_rbl_mid = v_rbl0 + (0.5 * swing if cell.predischarge
                              else -0.5 * swing)
        i_cell = cell.i_read(tech, v_sn, v_rbl_mid)
        off_sn = cell.v_sn_written(tech, 1 if cell.read_on_sn_low else 0)
        i_leak1 = cell.i_leak_rbl(tech, off_sn)
        t_ret = ret_mod.analyze(cell, tech, wwlls=cfg0.wwlls,
                                wwl_boost=cfg0.wwl_boost,
                                device=device).t_ret_s
        wf = cell.wf(tech)
        v_gate = tech.vdd + (cfg0.wwl_boost if cfg0.wwlls else 0.0)
        i_on = abs(float(dv.channel_current(
            wf, cell.w_write, cell.l_write, v_gate, tech.vdd,
            tech.vdd * 0.45)))
        return dict(i_cell=i_cell, i_leak1=i_leak1, dv_sense=swing,
                    t_ret=t_ret, vdd=tech.vdd,
                    t_sn=cell.sn_cap(tech) * 0.9 * tech.vdd
                    / max(i_on, 1e-12),
                    cell_leak_per_bit=0.0)
    return dict(i_cell=cell.i_read(tech), i_leak1=0.0,
                dv_sense=tech.v_sense_diff, t_ret=float("inf"), t_sn=0.0,
                vdd=tech.vdd, cell_leak_per_bit=cell.cell_leakage(tech))


# deterministic pure functions of (cell topology, deck, operating
# voltage, device): safe to memoize process-wide. The device is part of
# the key because retention runs in float32 on it, so a CPU evaluation
# never hands its constants to a later card run. Values keep the deck
# alive so the id() in the topology key cannot be recycled. Keying by
# deck IDENTITY means equal-but-distinct TechFile objects don't share
# entries: reuse one TechFile per deck, as Session does.
_CONSTS_CACHE: Dict[tuple, tuple] = {}


def _group_constants_cached(cfg0: BankConfig, bank0, vdd_scale: float,
                            device="cuda") -> dict:
    key = topology_key(cfg0) + (float(vdd_scale), str(torch.device(device)))
    hit = _CONSTS_CACHE.get(key)
    if hit is None:
        _CONSTS_CACHE[key] = hit = (
            _group_constants(cfg0, bank0, vdd_scale, device), cfg0.tech)
    return hit[0]


# delay-chain units tabulated: unit0 * growth**j for j < 64
_CHAIN_UNITS = 64


def _group_kernel(is_gc: bool, wwlls: bool, dv_sense: float, sa_s: float,
                  dff_s: float, unit0: float, device):
    """The timing/power point algebra of one (topology-shape,
    periphery-constant) family, as a function of float64 tensors that
    broadcast: per-voltage constants (V, 1), structural arrays (1, P)."""
    fo4 = timing_mod.FO4_S
    cap = float(timing_mod.CHAIN_MAX_STAGES)
    # the units `timing.chain_unit` steps through (unit *= growth), so
    # the chosen unit is the scalar loop's to the bit
    units = [unit0]
    for _ in range(_CHAIN_UNITS - 1):
        units.append(units[-1] * timing_mod.CHAIN_UNIT_GROWTH)
    units = torch.tensor(units, dtype=F64, device=device)
    one = torch.ones((), dtype=F64, device=device)

    def point(vdd, i_cell_v, i_leak1_v, t_ret_v, t_sn_v, clpb_v,
              rows_i, r_wl, c_wl, r_bl, c_bl, t_dec_i, ws_i, bits_i,
              periph_i, t_mux_i):
        # -- read path (timing.analyze, vectorized)
        t_wl = timing_mod.elmore_delay(timing_mod.WL_DRIVER_R_OHM, r_wl, c_wl)
        c_bl_read = c_bl + timing_mod.SA_INPUT_C_F
        leak = (rows_i - 1.0) * i_leak1_v
        i_net = torch.clamp_min(i_cell_v - leak, 1e-12)
        t_cell = timing_mod.cell_swing_time(dv_sense, c_bl_read, i_net, r_bl)
        analog = t_wl + t_cell + t_mux_i + sa_s
        if is_gc:
            analog = analog + timing_mod.REF_SETTLE_S
        # delay-chain unit coarsening: the smallest k with
        # analog*margin/unit_k <= cap, which is the number of tabulated
        # units the while loop of `timing.chain_unit` steps past (the
        # quotient falls with k). Counting them needs no log estimate,
        # so k is exact whatever the device's log would give.
        a_m = analog * timing_mod.CHAIN_MARGIN
        k = (a_m[..., None] / units > cap).sum(-1)
        unit = units[k]
        t_chain = torch.ceil(a_m / unit) * unit
        t_read = dff_s + t_dec_i + t_chain + dff_s
        # -- write path (timing.write_time, vectorized)
        t_bl = timing_mod.elmore_delay(timing_mod.WBL_DRIVER_R_OHM, r_bl,
                                       c_bl)
        t_wr_core = t_wl + t_bl + (t_sn_v if is_gc else 2 * fo4)
        t_write = dff_s + t_dec_i + torch.maximum(t_wr_core, t_chain * 0.6)
        f = one / torch.maximum(t_read, t_write)
        # -- standby power (power.analyze leakage + refresh, vectorized)
        leakage = bits_i * clpb_v + periph_i * PERIPH_LEAK_W_PER_UM2
        bl_swing = dv_sense * 3 if is_gc else vdd * 0.5
        e_read = (c_wl * vdd ** 2 + ws_i * c_bl * vdd * bl_swing
                  + ws_i * 8e-15 * vdd ** 2)
        e_write = (c_wl * vdd ** 2 + ws_i * c_bl * vdd ** 2
                   + ws_i * 6e-15 * vdd ** 2)
        if wwlls:
            e_write = e_write * 1.25
        if is_gc:
            alive = t_ret_v > 0.0
            safe_ret = torch.where(alive, t_ret_v, one)
            refresh = torch.where(
                alive,
                bits_i * (e_write / torch.clamp_min(ws_i, 1.0)) / safe_ret,
                torch.zeros_like(e_write))
        else:
            refresh = torch.zeros_like(e_write)
        return t_read, t_write, f, leakage, refresh, e_read, e_write

    return point


def _eval_group_arrays(cfgs: List[BankConfig], banks,
                       vdd_scales: Sequence[float], device="cuda") -> dict:
    """Core batched algebra for one topology group: (V, P) metric arrays
    from (V, 1) per-voltage constants x (1, P) structural arrays, float64
    on `device`. The reference pads the lattice axis to a power-of-two
    bucket so that its jitted program is reused across group sizes;
    eager torch compiles nothing per shape, so no padding here (the
    algebra is elementwise, so it would not change a value either)."""
    tech = cfgs[0].tech
    is_gc = banks[0].is_gc
    wwlls = cfgs[0].wwlls
    consts = [_group_constants_cached(cfgs[0], banks[0], v, device)
              for v in vdd_scales]
    dv_sense = consts[0]["dv_sense"]

    # struct-of-arrays: structural + wire quantities per point
    # (voltage-independent, shared across the whole vdd ladder)
    rows = np.array([b.rows for b in banks], np.float64)
    wl = np.array([bank_mod.wordline_rc(b) for b in banks], np.float64)
    bl = np.array([bank_mod.bitline_rc(b) for b in banks], np.float64)
    t_dec = np.array([timing_mod.decoder_delay(b.rows) for b in banks],
                     np.float64)
    ws = np.array([c.word_size for c in cfgs], np.float64)
    bits = np.array([c.bits for c in cfgs], np.float64)
    periph = np.array([sum(b.modules.values()) for b in banks], np.float64)
    t_mux = np.where([b.has_colmux for b in banks], 2 * timing_mod.FO4_S,
                     0.0)

    # per-voltage scalar constants
    i_cell = np.array([c["i_cell"] for c in consts], np.float64)
    i_leak1 = np.array([c["i_leak1"] for c in consts], np.float64)
    t_ret = np.array([c["t_ret"] for c in consts], np.float64)
    t_sn = np.array([c["t_sn"] for c in consts], np.float64)
    clpb = np.array([c["cell_leak_per_bit"] for c in consts], np.float64)
    vdd_v = np.array([c["vdd"] for c in consts], np.float64)

    swing_ok = (i_cell[:, None] > 3.0 * ((rows - 1.0) * i_leak1[:, None])) \
        if is_gc else np.broadcast_to(i_cell[:, None] > 0.0,
                                      (len(consts), len(banks))).copy()

    # one copy each way: (V, 1) constants, (1, P) structural arrays
    varrs = torch.as_tensor(np.stack([vdd_v, i_cell, i_leak1, t_ret, t_sn,
                                      clpb]), dtype=F64,
                            device=device)[:, :, None]
    parrs = torch.as_tensor(np.stack([rows, wl[:, 0], wl[:, 1], bl[:, 0],
                                      bl[:, 1], t_dec, ws, bits, periph,
                                      t_mux]), dtype=F64,
                            device=device)[:, None, :]
    kernel = _group_kernel(is_gc, wwlls, float(dv_sense), tech.sa_delay_s,
                           tech.dff_delay_s, tech.stage_delay_s, device)
    res = torch.stack(kernel(*varrs, *parrs)).cpu().numpy()
    out = dict(zip(("t_read", "t_write", "f", "leakage", "refresh",
                    "e_read", "e_write"), res))
    out.update(swing_ok=swing_ok, t_ret=t_ret,
               area=np.array([b.area_um2 for b in banks], np.float64),
               bits=bits, ws=ws,
               num_words=np.array([c.num_words for c in cfgs], np.float64))
    return out


# ---------------------------------------------------------------------------
# the (vdd x lattice) table — third lattice dimension for co-design
# ---------------------------------------------------------------------------

@dataclass
class VddLattice:
    """Struct-of-arrays metrics over (operating voltage x design lattice).

    All 2-D arrays are shaped (V, P) = (len(vdd_scales), len(cfgs)) and
    row v holds the lattice evaluated at `tech.vdd * vdd_scales[v]`,
    matching `dse.evaluate(cfg, vdd_scale)` bit for bit on the same
    device. Units follow DesignPoint: Hz, seconds, watts, um^2, bits;
    `e_read_j`/`e_write_j` are dynamic joules PER ACCESS of one word (the
    CV^2 terms of `power.analyze` without the frequency factor)."""
    cfgs: List[BankConfig]
    vdd_scales: Tuple[float, ...]
    f_max_hz: np.ndarray          # (V, P)
    t_read_s: np.ndarray
    t_write_s: np.ndarray
    retention_s: np.ndarray
    swing_ok: np.ndarray          # (V, P) bool
    leakage_w: np.ndarray
    refresh_w: np.ndarray
    e_read_j: np.ndarray
    e_write_j: np.ndarray
    area_um2: np.ndarray          # (P,)
    bits: np.ndarray              # (P,)
    num_words: np.ndarray         # (P,)
    is_gc: np.ndarray             # (P,) bool

    @property
    def shape(self) -> Tuple[int, int]:
        return self.f_max_hz.shape

    @property
    def standby_w(self) -> np.ndarray:
        return self.leakage_w + self.refresh_w

    def point(self, vi: int, pi: int) -> DesignPoint:
        """Materialize one (voltage, config) entry as a DesignPoint."""
        cfg = self.cfgs[pi]
        f, wsz = float(self.f_max_hz[vi, pi]), cfg.word_size
        rbw = wbw = f * wsz if self.is_gc[pi] else f * wsz / 2
        return DesignPoint(
            cfg, float(self.area_um2[pi]), f, rbw, wbw, rbw + wbw,
            float(self.leakage_w[vi, pi]), float(self.refresh_w[vi, pi]),
            float(self.retention_s[vi, pi]), bool(self.swing_ok[vi, pi]),
            float(self.t_read_s[vi, pi]), float(self.t_write_s[vi, pi]),
            float(self.vdd_scales[vi]))


def evaluate_vdd_lattice(cfgs: Sequence[BankConfig],
                         vdd_scales: Sequence[float],
                         device="cuda") -> VddLattice:
    """Evaluate the whole (vdd_scales x cfgs) grid on `device`, one
    broadcast program per cell topology; structural arrays are built
    once and shared across the voltage ladder."""
    cfgs = list(cfgs)
    vdd_scales = tuple(float(v) for v in vdd_scales)
    if not vdd_scales:
        raise ValueError("evaluate_vdd_lattice needs >= 1 vdd_scale")
    V, P = len(vdd_scales), len(cfgs)
    z = lambda: np.zeros((V, P), np.float64)  # noqa: E731
    out = dict(f_max_hz=z(), t_read_s=z(), t_write_s=z(), retention_s=z(),
               swing_ok=np.zeros((V, P), bool), leakage_w=z(),
               refresh_w=z(), e_read_j=z(), e_write_j=z())
    area = np.zeros(P)
    bits = np.zeros(P)
    nw = np.zeros(P)
    is_gc = np.zeros(P, bool)
    for idx in group_by_topology(cfgs).values():
        sub = [cfgs[i] for i in idx]
        banks = [build_bank(c) for c in sub]
        a = _eval_group_arrays(sub, banks, vdd_scales, device)
        cols = np.asarray(idx)
        for dst, src in (("f_max_hz", "f"), ("t_read_s", "t_read"),
                         ("t_write_s", "t_write"), ("leakage_w", "leakage"),
                         ("refresh_w", "refresh"), ("e_read_j", "e_read"),
                         ("e_write_j", "e_write"), ("swing_ok", "swing_ok")):
            out[dst][:, cols] = a[src]
        out["retention_s"][:, cols] = a["t_ret"][:, None]
        area[cols], bits[cols], nw[cols] = a["area"], a["bits"], \
            a["num_words"]
        is_gc[cols] = banks[0].is_gc
    return VddLattice(cfgs, vdd_scales, out["f_max_hz"], out["t_read_s"],
                      out["t_write_s"], out["retention_s"], out["swing_ok"],
                      out["leakage_w"], out["refresh_w"], out["e_read_j"],
                      out["e_write_j"], area, bits, nw, is_gc)


# ---------------------------------------------------------------------------
# vectorized workload matching: (vdd x lattice x demand) grids
# ---------------------------------------------------------------------------

def _f64(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64,
                           device=device)


def feasible_grid(f_max_hz, retention_s, swing_ok, num_words,
                  read_freq_hz, lifetime_s, *,
                  allow_refresh: bool = True, device="cuda") -> np.ndarray:
    """Vectorized `dse.feasible`: lattice metric arrays of any common
    broadcastable shape S (e.g. (P,) or (V, P)) against demand vectors of
    shape (D,) -> boolean mask of shape S + (D,). Same rule, same float64
    comparisons, bit for bit with the scalar reference."""
    f = _f64(f_max_hz, device)[..., None]
    ret = _f64(retention_s, device)[..., None]
    ok = torch.as_tensor(np.asarray(swing_ok, bool), device=device)[..., None]
    nw = _f64(num_words, device)[..., None]
    rf = _f64(read_freq_hz, device)
    lt = _f64(lifetime_s, device)
    meets_f = ok & (f >= rf)
    native = ret >= lt
    if allow_refresh:
        alive = ret > 0.0
        safe = torch.where(alive, ret, torch.ones_like(ret))
        refr = alive & (nw / safe < 0.1 * f)
        mask = meets_f & (native | refr)
    else:
        mask = meets_f & native
    return mask.cpu().numpy()


def banks_needed_grid(f_max_hz, retention_s, swing_ok, bits, num_words,
                      read_freq_hz, lifetime_s, capacity_bits=None, *,
                      allow_refresh: bool = True,
                      max_banks: int = 1024, device="cuda") -> np.ndarray:
    """Vectorized `multibank.banks_needed`: smallest interleaved-macro
    bank count per (lattice-entry, demand) covering both the aggregate
    read frequency and the capacity, with `max_banks + 1` as the
    infeasibility sentinel — identical to the scalar reference."""
    f = _f64(f_max_hz, device)[..., None]
    ret = _f64(retention_s, device)[..., None]
    ok = torch.as_tensor(np.asarray(swing_ok, bool), device=device)[..., None]
    nw = _f64(num_words, device)[..., None]
    bits_ = _f64(bits, device)[..., None]
    rf = _f64(read_freq_hz, device)
    lt = _f64(lifetime_s, device)
    cap = torch.zeros_like(rf) if capacity_bits is None \
        else _f64(capacity_bits, device)
    one = torch.ones((), dtype=F64, device=device)
    alive = ok & (f > 0.0)
    safe_f = torch.where(f > 0.0, f, one)
    n_freq = torch.ceil(rf / safe_f)
    n_cap = torch.where(cap > 0.0, torch.ceil(cap / bits_), one)
    n = torch.clamp_min(torch.maximum(n_freq, n_cap), 1.0)
    # per-bank retention feasibility at the interleaved (clamped) rate:
    # the frequency test passes by construction, so only the
    # native-retention / refresh rule remains
    native = ret >= lt
    if allow_refresh:
        safe_r = torch.where(ret > 0.0, ret, one)
        perbank = native | ((ret > 0.0) & (nw / safe_r < 0.1 * f))
    else:
        perbank = native
    n = torch.where(alive & perbank, n, torch.full_like(n, max_banks + 1))
    return n.cpu().numpy().astype(np.int64)


def shmoo_batch(points, demands, *, allow_refresh: bool = True,
                device="cuda") -> dict:
    """Drop-in replacement for `dse.shmoo` that evaluates the whole
    (points x demands) grid in one pass on `device`; same dict layout
    (and same duplicate-key overwrite semantics), python bools."""
    from repro_torch.core.dse import shmoo_key
    mask = feasible_grid(
        np.array([p.f_max_hz for p in points], np.float64),
        np.array([p.retention_s for p in points], np.float64),
        np.array([p.swing_ok for p in points], bool),
        np.array([p.cfg.num_words for p in points], np.float64),
        np.array([d.read_freq_hz for d in demands], np.float64),
        np.array([d.lifetime_s for d in demands], np.float64),
        allow_refresh=allow_refresh, device=device)
    grid = {}
    for j, d in enumerate(demands):
        row = {}
        for i, dp in enumerate(points):
            row[shmoo_key(dp.cfg)] = bool(mask[i, j])
        grid[f"{d.level}:{d.name}"] = row
    return grid


def codesign_metrics(lat: VddLattice, demands, step_time_s, *,
                     allow_refresh: bool = True, max_banks: int = 1024,
                     device="cuda"):
    """The co-design cube: for every (vdd, config, demand) return

      feas    (V, P, D) bool   — single-bank feasibility (dse.feasible)
      banks   (V, P, D) int    — interleaved-macro size (banks_needed)
      energy  (V, P, D) float  — joules per inference step: dynamic read
              energy for the demanded accesses (read_freq * step_time
              accesses x e_read_j) + the macro's standby (leakage +
              refresh) integrated over the step
      macro_ok (V, P, D) bool  — banks within max_banks AND the per-bank
              retention rule holds

    `demands` is a Demand sequence, `step_time_s` the per-demand
    inference step time (seconds, same length)."""
    rf = np.array([d.read_freq_hz for d in demands], np.float64)
    lt = np.array([d.lifetime_s for d in demands], np.float64)
    cap = np.array([d.capacity_bits for d in demands], np.float64)
    step = np.asarray(step_time_s, np.float64)
    if step.shape != rf.shape:
        raise ValueError(f"step_time_s {step.shape} != demands {rf.shape}")
    feas = feasible_grid(lat.f_max_hz, lat.retention_s, lat.swing_ok,
                         lat.num_words, rf, lt, allow_refresh=allow_refresh,
                         device=device)
    banks = banks_needed_grid(lat.f_max_hz, lat.retention_s, lat.swing_ok,
                              lat.bits, lat.num_words, rf, lt, cap,
                              allow_refresh=allow_refresh,
                              max_banks=max_banks, device=device)
    macro_ok = banks <= max_banks
    accesses = _f64(rf * step, device)                      # (D,)
    e_dyn = accesses * _f64(lat.e_read_j, device)[..., None]
    standby = _f64(lat.standby_w, device)[..., None]
    energy = e_dyn + _f64(banks, device) * standby * _f64(step, device)
    return feas, banks, energy.cpu().numpy(), macro_ok
