"""Design-space exploration primitives (paper §V-E).

Port of `repro.core.dse`. The user-facing entry point is the query API
in `repro_torch.api` (`Session` + `SweepQuery`/`MatchQuery`); this module
keeps the underlying models and reference implementations:

  * evaluate():   the SCALAR reference evaluator for one BankConfig —
                  the batched lattice evaluator (`core.dse_batch`)
                  matches it bit for bit on the same device
  * sweep():      DEPRECATED shim over Session().sweep(SweepQuery(...))
  * shmoo():      Fig 10 — feasibility of each bank config against each
                  workload's (read-frequency, lifetime) demand
  * pareto():     non-dominated set over caller-chosen metric keys

Timing and power are float64 host algebra; retention runs in float32 on
`device`, as in the compile flow (`core.retention`). The gradient-based
co-optimization: `grad_optimize` (float32 on `device`), and the
differentiable twin of `evaluate` (`evaluate_grad`, `evaluate_grad_fn`,
from `core.dse_grad`).
"""
from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass
from typing import List, Sequence

import torch

from repro_torch.core import power as power_mod
from repro_torch.core import retention as ret_mod
from repro_torch.core import timing as timing_mod
from repro_torch.core.bank import BankConfig, build_bank
from repro_torch.core.cells import CELLS
from repro_torch.core.spice.devices import sigmoid
from repro_torch.core.spice.mna import channel_current_raw
from repro_torch.core.techfile import SYN40


@dataclass
class DesignPoint:
    """One evaluated bank at one operating point.

    Units: `area_um2` um^2; `f_max_hz` Hz; bandwidths bits/s; powers
    watts; `retention_s` / `t_read_s` / `t_write_s` seconds. `vdd_scale`
    is the operating-voltage multiplier the point was evaluated at
    (tech.vdd * vdd_scale; 1.0 = the deck's nominal rail)."""
    cfg: BankConfig
    area_um2: float
    f_max_hz: float
    read_bw_bps: float
    write_bw_bps: float
    eff_bw_bps: float
    leakage_w: float
    refresh_w: float
    retention_s: float
    swing_ok: bool
    t_read_s: float = 0.0
    t_write_s: float = 0.0
    vdd_scale: float = 1.0

    @property
    def standby_w(self) -> float:
        """Total standby power (W): leakage + refresh (the paper's idle
        cost)."""
        return self.leakage_w + self.refresh_w

    def as_dict(self):
        d = {"cell": self.cfg.cell, "word_size": self.cfg.word_size,
             "num_words": self.cfg.num_words, "wwlls": self.cfg.wwlls,
             "write_vt": self.cfg.write_vt}
        for k in ("area_um2", "f_max_hz", "eff_bw_bps", "leakage_w",
                  "refresh_w", "retention_s", "swing_ok", "t_read_s",
                  "t_write_s", "standby_w", "vdd_scale"):
            d[k] = getattr(self, k)
        return d


def evaluate(cfg: BankConfig, vdd_scale: float = 1.0,
             device="cuda") -> DesignPoint:
    """Scalar reference evaluation of one config at one operating voltage
    (`vdd_scale` multiplies tech.vdd; geometry/floorplan are voltage-
    independent); retention runs on `device`. The batched evaluators in
    `core.dse_batch` match this function bit for bit."""
    bank = build_bank(cfg)
    t = timing_mod.analyze(bank, vdd_scale=vdd_scale)
    if bank.is_gc:
        r = ret_mod.analyze(bank.cell, cfg.tech, wwlls=cfg.wwlls,
                            wwl_boost=cfg.wwl_boost, vdd_scale=vdd_scale,
                            device=device)
        ret = r.t_ret_s
    else:
        ret = float("inf")
    p = power_mod.analyze(bank, t.f_max_hz,
                          t_ret_s=ret if bank.is_gc else None,
                          vdd_scale=vdd_scale)
    ws = cfg.word_size
    if bank.is_gc:
        # dual port: concurrent read + write at f_max
        rbw = t.f_max_hz * ws
        wbw = t.f_max_hz * ws
        ebw = rbw + wbw
    else:
        # shared port: effective bandwidth halves (paper C6)
        rbw = t.f_max_hz * ws / 2
        wbw = t.f_max_hz * ws / 2
        ebw = rbw + wbw
    return DesignPoint(cfg, bank.area_um2, t.f_max_hz, rbw, wbw, ebw,
                       p.leakage_w, p.refresh_w, ret, t.read_swing_ok,
                       t.t_read_s, t.t_write_s, vdd_scale)


def lattice_configs(cells=("gc2t_nn", "gc2t_np", "gc2t_osos"),
                    word_sizes=(16, 32, 64, 128),
                    num_words=(16, 32, 64, 128),
                    write_vts=(None,), wwlls=(False, True),
                    tech=SYN40) -> List[BankConfig]:
    """Expand a config lattice, skipping write-VT flavors that don't match
    the cell's device family (Si VT overrides on OS cells and vice versa)."""
    out = []
    for c, ws, nw, vt, ls in itertools.product(cells, word_sizes, num_words,
                                               write_vts, wwlls):
        wf = getattr(CELLS[c], "write_flavor", None)
        if vt is not None and (wf is None
                               or wf.startswith("os") != vt.startswith("os")):
            continue
        out.append(BankConfig(ws, nw, cell=c, write_vt=vt, wwlls=ls,
                              tech=tech))
    return out


def sweep(cells=("gc2t_nn", "gc2t_np", "gc2t_osos"),
          word_sizes=(16, 32, 64, 128), num_words=(16, 32, 64, 128),
          write_vts=(None,), wwlls=(False, True),
          device="cuda") -> List[DesignPoint]:
    """DEPRECATED: use repro_torch.api.Session().sweep(SweepQuery(...)).
    This shim routes through a session on `device`, so old call sites
    get the batched evaluator."""
    warnings.warn(
        "dse.sweep() is deprecated; use repro_torch.api.Session().sweep("
        "SweepQuery(...))", DeprecationWarning, stacklevel=2)
    from repro_torch.api import Session, SweepQuery
    q = SweepQuery(cells=tuple(cells), word_sizes=tuple(word_sizes),
                   num_words=tuple(num_words), write_vts=tuple(write_vts),
                   wwlls=tuple(wwlls))
    return list(Session(device=device).sweep(q).points)


# ---------------------------------------------------------------------------
# shmoo (Fig 10)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Demand:
    """One workload's cache demand (GainSight analogue).

    Units — read carefully, these are the contract of the whole matching
    flow:
      read_freq_hz   read-request rate in Hz arriving at ONE memory
                     instance of the profiled hierarchy (the workload
                     profiler has already split the chip's aggregate
                     traffic over its cores x banks instances — it is
                     NOT the whole-chip feed). Single-bank feasibility
                     (`feasible`) compares it directly against a bank's
                     `f_max_hz`; when one bank falls short,
                     `multibank.banks_needed` sizes an interleaved macro
                     whose AGGREGATE n * f_bank covers this same rate.
      lifetime_s     how long a datum must stay readable, in seconds.
      capacity_bits  macro capacity the demand needs (bits; 0 = don't
                     size for capacity).

    Frozen (hashable) so queries carrying Demands can key session caches.
    """
    name: str
    level: str                 # "L1" | "L2"
    read_freq_hz: float
    lifetime_s: float
    capacity_bits: int = 0


def feasible(dp: DesignPoint, d: Demand, *, allow_refresh=True) -> bool:
    """A bank works for a demand if it meets the read frequency and either
    natively retains data for the lifetime or (if allowed) refreshes at
    <10% bandwidth overhead (multi-banked designs absorb capacity).

    The refresh rule, exactly: with `allow_refresh=True` a bank whose
    `retention_s` falls short of `d.lifetime_s` still passes when
    `refresh_rate < 0.1 * f_max_hz`, where `refresh_rate = num_words /
    retention_s` is the row-rewrite rate (rows/s) needed to keep the
    array alive. `retention_s <= 0` (the cell cannot hold the margin at
    all, e.g. at a collapsed operating voltage) never passes, refresh or
    not. This is the SCALAR reference; `core.dse_batch.feasible_grid`
    evaluates the same rule over a whole (vdd x lattice x demand) grid,
    bit for bit."""
    if not dp.swing_ok or dp.f_max_hz < d.read_freq_hz:
        return False
    if dp.retention_s >= d.lifetime_s:
        return True
    if not allow_refresh or dp.retention_s <= 0:
        return False
    refresh_rate = dp.cfg.num_words / dp.retention_s  # rows/s to rewrite
    return refresh_rate < 0.1 * dp.f_max_hz


def shmoo_key(cfg: BankConfig) -> str:
    """Grid-column label of one config — single source of truth for the
    scalar `shmoo` and the batched `dse_batch.shmoo_batch`."""
    return f"{cfg.cell}/{cfg.word_size}x{cfg.num_words}" + \
        ("+ls" if cfg.wwlls else "")


def shmoo(points: List[DesignPoint], demands: List[Demand], *,
          allow_refresh: bool = True) -> dict:
    """Fig 10 grid: demand x bank-config -> pass/fail."""
    grid = {}
    for d in demands:
        row = {}
        for dp in points:
            row[shmoo_key(dp.cfg)] = feasible(dp, d,
                                              allow_refresh=allow_refresh)
        grid[f"{d.level}:{d.name}"] = row
    return grid


# metrics where bigger is better; everything else is minimized
PARETO_MAXIMIZE = frozenset({"f_max_hz", "read_bw_bps", "write_bw_bps",
                             "eff_bw_bps", "retention_s"})


def pareto(points: List[DesignPoint],
           keys: Sequence[str] = ("area_um2", "f_max_hz", "standby_w"),
           ) -> List[DesignPoint]:
    """Non-dominated set over the chosen metric `keys` (DesignPoint
    attribute names). Metrics in PARETO_MAXIMIZE are maximized, the rest
    minimized. Sort-based skyline filter: after a lexicographic sort any
    dominator of a point precedes it, so each candidate is compared only
    against the current front. Returns the front sorted by the first
    key; infeasible (swing-fail) points are excluded."""
    def metric(dp):
        return tuple(-getattr(dp, k) if k in PARETO_MAXIMIZE
                     else getattr(dp, k) for k in keys)

    def dominates(a, b):
        return all(x <= y for x, y in zip(a, b)) and \
            any(x < y for x, y in zip(a, b))

    ranked = sorted(((metric(dp), i, dp) for i, dp in enumerate(points)
                     if dp.swing_ok), key=lambda t: (t[0], t[1]))
    front, front_vals = [], []
    for m, _, dp in ranked:
        if not any(dominates(fv, m) for fv in front_vals):
            front.append(dp)
            front_vals.append(m)
    return front


# ---------------------------------------------------------------------------
# gradient-based co-optimization (paper §VI future work, realized)
# ---------------------------------------------------------------------------

# the differentiable twin of evaluate() lives in dse_grad; callers reach
# it as dse.evaluate_grad. The projected-Adam optimizer over it is
# repro_torch.optim.dse_opt (the OptimizeQuery engine).
from repro_torch.core.dse_grad import (evaluate_grad,  # noqa: E402,F401
                                       evaluate_grad_fn)


def grad_optimize(cell_name="gc2t_nn", *, target_ret_s=1e-4,
                  target_freq_hz=None, steps=300, lr=0.02, tech=SYN40,
                  verbose=False, device="cuda") -> dict:
    """Continuously optimize (write-VT, write width, WWL boost) to MEET a
    retention target while maximizing read current (speed) and minimizing
    cell area: gradient descent through the differentiable retention
    integral (`retention.leak_fn` with its vt0= and w= overrides) and the
    device model, in float32 on `device` as the reference runs it.
    Returns the optimized design and its retention at that point."""
    f32 = dict(dtype=torch.float32, device=torch.device(device))
    cell = CELLS[cell_name]
    wf = cell.wf(tech)
    c_sn_base = cell.sn_cap(tech)
    v_m = ret_mod._margin_voltage(cell, tech)
    vdd = tech.vdd
    fn = ret_mod.leak_fn(cell, tech, device)
    pol = torch.tensor(float(wf.polarity), **f32)
    l_w = torch.tensor(float(cell.l_write), **f32)
    log_target = torch.log(torch.tensor(target_ret_s, **f32))

    def unpack(theta):
        vt = 0.25 + 0.62 * sigmoid(theta[0])       # 0.25..0.87 V
        w_w = 0.06 + 0.32 * sigmoid(theta[1])      # 0.06..0.38 um
        boost = 0.8 * sigmoid(theta[2])            # 0..0.8 V
        return vt, w_w, boost

    def retention_of(vt, w_w, boost):
        c_sn = c_sn_base + wf.cj_f_per_um * (w_w - cell.w_write)
        v0 = torch.minimum(torch.tensor(vdd, **f32),
                           vdd + boost - vt + 0.12) \
            - cell.wwl_couple_ratio * vdd
        vs = ret_mod._linspace(v_m, torch.maximum(
            v0, torch.tensor(v_m + 1e-3, **f32)), 512, device)
        inv = 1.0 / fn(vs, vt0=vt, w=w_w).clamp_min(1e-30)
        return c_sn * torch.trapezoid(inv, vs)

    def speed_of(vt, w_w, boost):
        # write-limited component: on-current into SN at boosted gate
        i_on = channel_current_raw(
            pol, vt, wf.n_slope, wf.k_prime, wf.lambda_, w_w, l_w,
            vdd + boost, torch.tensor(vdd, **f32),
            torch.tensor(vdd * 0.45, **f32))
        return i_on.abs()

    def loss(theta):
        vt, w_w, boost = unpack(theta)
        ret = retention_of(vt, w_w, boost)
        spd = speed_of(vt, w_w, boost)
        area = w_w + 0.35 * boost            # normalized area proxy (ring)
        pen = torch.relu(log_target - torch.log(ret)) ** 2
        return 8.0 * pen - 0.5 * torch.log(spd) + 0.3 * area

    theta = torch.zeros((3,), **f32)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    hist = []
    for i in range(steps):
        x = theta.detach().requires_grad_()
        lval = loss(x)
        (g,) = torch.autograd.grad(lval, x)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        theta = theta - lr * m / (torch.sqrt(v) + 1e-8)
        if verbose and i % 50 == 0:
            hist.append(float(lval.detach()))
    with torch.no_grad():
        vt, w_w, boost = (float(x) for x in unpack(theta))
        ret = float(retention_of(*(torch.tensor(x, **f32)
                                   for x in (vt, w_w, boost))))
    return {"write_vt": vt, "w_write_um": w_w, "wwl_boost": boost,
            "retention_s": ret, "target_ret_s": target_ret_s,
            "met": ret >= target_ret_s * 0.95, "loss_history": hist}
