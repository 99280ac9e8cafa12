"""Projected-Adam design optimizer behind `OptimizeQuery`. Port of
`repro.optim.dse_opt`.

Turns "sweep and pick" into "optimize": the discrete vdd ladder
(`dse_batch.evaluate_vdd_lattice`) is demoted to a GLOBAL SEED, and the
continuous knobs (operating voltage, device widths, bitline wire width)
are refined by Adam (`repro_torch.optim.optimizers.adamw`) on the
differentiable evaluator (`core.dse_grad`), float64 on `device`;
`torch.autograd.grad` takes the place of the reference's
`jax.value_and_grad`.

Constraint handling: the `dse.feasible` demand rule is expressed as
smooth normalized margins g_i (>= 0 feasible) and enters the loss as
relu(-g)^2 penalties on top of a log objective; box bounds are enforced
by projection (clip after every Adam update; the moments live in the
clipped space, standard projected-gradient practice).

Never-regress guarantee: the final candidate is re-evaluated with the
EXACT quantized algebra (`evaluate_grad_fn(quantized=True)`, equal to
`dse.evaluate`) and the EXACT feasibility rule; if it does not beat the
best grid rung, the grid rung is returned. The optimizer can only
improve on the sweep it replaced.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dse_batch
from repro_torch.core.bank import BankConfig
from repro_torch.core.dse_grad import KNOBS, evaluate_grad_fn
from repro_torch.optim.optimizers import adamw

F64 = torch.float64

#: Box bounds of each knob (multipliers around the nominal design).
DEFAULT_BOUNDS: Dict[str, Tuple[float, float]] = {
    "vdd_scale": (0.6, 1.25),
    "w_read_scale": (0.5, 2.0),
    "w_write_scale": (0.5, 2.0),
    "bl_wire_scale": (0.5, 2.0),
}

#: Objectives (minimized). Any OUTPUTS key works; these are the
#: physically sensible ones.
OBJECTIVES = ("standby_w", "t_read_s", "e_read_j", "e_write_j")

PENALTY_WEIGHT = 25.0


@dataclass
class OptResult:
    """Outcome of one projected-Adam design optimization."""
    cfg: BankConfig
    knobs: Dict[str, float]           # optimized knob multipliers
    objective: str
    objective_value: float            # EXACT (quantized) value at `knobs`
    met: bool                         # exact dse.feasible at `knobs`
    outputs: Dict[str, float]         # exact quantized outputs at `knobs`
    seed_knobs: Dict[str, float]      # best grid rung the loop started at
    seed_objective_value: float
    seed_met: bool
    improved: bool                    # strictly beat the grid seed
    fell_back: bool                   # candidate regressed -> grid returned
    evals: Dict[str, int]             # lattice evals vs gradient steps
    history: List[Tuple[float, float]] = field(repr=False,
                                               default_factory=list)

    def as_dict(self) -> dict:
        return {"cell": self.cfg.cell, "word_size": self.cfg.word_size,
                "num_words": self.cfg.num_words, "wwlls": self.cfg.wwlls,
                "write_vt": self.cfg.write_vt,
                "knobs": dict(self.knobs), "objective": self.objective,
                "objective_value": self.objective_value, "met": self.met,
                "seed_knobs": dict(self.seed_knobs),
                "seed_objective_value": self.seed_objective_value,
                "seed_met": self.seed_met, "improved": self.improved,
                "fell_back": self.fell_back, "evals": dict(self.evals),
                "outputs": dict(self.outputs),
                "loss_history": [float(l) for l, _ in self.history]}


def _margins(out, idx, *, target_freq_hz, target_ret_s, allow_refresh,
             num_words):
    """Normalized feasibility margins (>= 0 feasible), differentiable.
    Mirrors dse.feasible: sense swing, read frequency, and retention met
    either natively or through the < 10%-bandwidth refresh rule."""
    f = out["f_max_hz"][idx]
    ret = out["retention_s"][idx]
    g_swing = out["swing_margin_rel"][idx]
    g_freq = f / target_freq_hz - 1.0
    g_native = ret / target_ret_s - 1.0
    if allow_refresh:
        # num_words/ret < 0.1*f  <=>  0.1*f*ret/num_words > 1
        g_refresh = 0.1 * f * ret / num_words - 1.0
        g_ret = torch.maximum(g_native, g_refresh)
    else:
        g_ret = g_native
    return (g_swing, g_freq, g_ret)


def _exact_check(out, idx, *, target_freq_hz, target_ret_s, allow_refresh,
                 num_words) -> bool:
    """EXACT dse.feasible on quantized outputs (float64 compares, same
    rule text: strict swing, f >= target, native-or-refresh)."""
    f = float(out["f_max_hz"][idx])
    ret = float(out["retention_s"][idx])
    ok = float(out["swing_margin_a"][idx]) > 0.0
    if not ok or f < target_freq_hz:
        return False
    if ret >= target_ret_s:
        return True
    if not allow_refresh or ret <= 0.0:
        return False
    return num_words / ret < 0.1 * f


def grid_seed(cfg: BankConfig, vdd_scales: Sequence[float], *,
              objective: str, target_freq_hz: float, target_ret_s: float,
              allow_refresh: bool = True, lat=None, device="cuda"):
    """Coarse-ladder global seed: evaluate the EXACT model at each rung,
    pick the best feasible one (fallback: least-infeasible by penalty).
    Returns (seed_knobs, seed_objective_value, seed_met, n_evals).

    `lat` short-circuits evaluation with a precomputed single-config
    VddLattice over `vdd_scales` (the planner's shared vdd_lattice node:
    session-cached and store-persisted)."""
    if lat is None:
        lat = dse_batch.evaluate_vdd_lattice([cfg], list(vdd_scales),
                                             device=device)
    if len(lat.cfgs) != 1 or tuple(lat.vdd_scales) != \
            tuple(float(v) for v in vdd_scales):
        raise ValueError("seed lattice does not match (cfg, vdd_scales)")
    obj = np.asarray(getattr(lat, objective))[:, 0]
    feas = dse_batch.feasible_grid(
        lat.f_max_hz, lat.retention_s, lat.swing_ok, lat.num_words,
        np.array([target_freq_hz]), np.array([target_ret_s]),
        allow_refresh=allow_refresh, device=device)[:, 0, 0]
    if feas.any():
        cand = np.where(feas, obj, np.inf)
        v = int(np.argmin(cand))
        met = True
    else:
        # least-violated rung: penalize missing frequency and retention
        f, ret = lat.f_max_hz[:, 0], lat.retention_s[:, 0]
        viol = (np.maximum(1.0 - f / target_freq_hz, 0.0) ** 2
                + np.maximum(1.0 - ret / max(target_ret_s, 1e-30), 0.0) ** 2
                + np.where(lat.swing_ok[:, 0], 0.0, 1.0))
        v = int(np.argmin(viol))
        met = False
    seed = {"vdd_scale": float(lat.vdd_scales[v])}
    return seed, float(obj[v]), met, len(lat.vdd_scales)


def optimize(cfg: BankConfig, *, target_freq_hz: float,
             target_ret_s: float, objective: str = "standby_w",
             knobs: Sequence[str] = ("vdd_scale",),
             steps: int = 60, lr: float = 0.05,
             bounds: Optional[Dict[str, Tuple[float, float]]] = None,
             seed_vdd_scales: Sequence[float] = (0.7, 0.85, 1.0, 1.15),
             allow_refresh: bool = True,
             penalty_weight: float = PENALTY_WEIGHT,
             constraint_margin: float = 0.04,
             max_verify: int = 6,
             seed_lattice=None, device="cuda") -> OptResult:
    """Gradient-refine the continuous knobs of one gain-cell config on
    `device`.

    Runs in float64. `knobs` picks which multipliers move (the rest stay
    1.0); `bounds` overrides DEFAULT_BOUNDS entries. The result's metrics
    are the EXACT quantized model's, directly comparable to
    `dse.evaluate` numbers, and never regress vs the grid seed.

    `constraint_margin` keeps the smooth-model optimum a few percent
    inside the feasible region: the surrogate drops the delay-chain
    staircase, so its frequency margin overestimates the exact model's
    by up to one stage unit; optimizing to the exact boundary would land
    infeasible on verification. The `max_verify` best trajectory points
    are then checked with the exact quantized algebra (each check is one
    lattice eval, counted in `evals["verify"]`) and the best
    exact-feasible one wins.
    """
    knobs = tuple(knobs)
    bad = set(knobs) - set(KNOBS)
    if bad:
        raise ValueError(f"unknown knobs {sorted(bad)} (allowed: {KNOBS})")
    if not knobs:
        raise ValueError("need at least one knob to optimize")
    dev = torch.device(device)
    bnds = dict(DEFAULT_BOUNDS)
    bnds.update(bounds or {})
    lo = torch.tensor([bnds[k][0] for k in knobs], dtype=F64, device=dev)
    hi = torch.tensor([bnds[k][1] for k in knobs], dtype=F64, device=dev)
    num_words = cfg.num_words
    targs = dict(target_freq_hz=target_freq_hz, target_ret_s=target_ret_s,
                 allow_refresh=allow_refresh, num_words=num_words)

    seed, seed_obj, seed_met, n_grid = grid_seed(
        cfg, seed_vdd_scales, objective=objective, lat=seed_lattice,
        device=dev, **{k: targs[k] for k in ("target_freq_hz",
                                             "target_ret_s",
                                             "allow_refresh")})

    fn_smooth = evaluate_grad_fn(cfg, device=dev)    # smooth chain surrogate
    fn_exact = evaluate_grad_fn(cfg, quantized=True, device=dev)

    def loss_fn(vec):
        kn = {k: vec[i:i + 1] for i, k in enumerate(knobs)}
        out = fn_smooth(kn)
        g = _margins(out, 0, **targs)
        pen = sum((constraint_margin - gi).clamp_min(0.0) ** 2 for gi in g)
        return (torch.log(out[objective][0].clamp_min(1e-300))
                + penalty_weight * pen)

    def value_and_grad(vec):
        x = vec.detach().requires_grad_()
        loss = loss_fn(x)
        (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), g

    x0 = [min(max(seed.get(k, 1.0), bnds[k][0]), bnds[k][1]) for k in knobs]
    vec = torch.tensor(x0, dtype=F64, device=dev)
    opt = adamw(lambda step: lr, weight_decay=0.0, max_grad_norm=1.0)
    state = opt.init({"x": vec})
    history: List[Tuple[float, float]] = []
    traj: List[Tuple[float, np.ndarray]] = []
    for s in range(steps):
        loss, g = value_and_grad(vec)
        loss = float(loss)
        if math.isfinite(loss):
            traj.append((loss, vec.cpu().numpy()))
        new, state, stats = opt.update({"x": g}, state, {"x": vec}, s)
        vec = torch.clamp(new["x"].to(F64), lo, hi)          # projection
        history.append((loss, float(stats["grad_norm"])))
    loss = float(value_and_grad(vec)[0])
    if math.isfinite(loss):
        traj.append((loss, vec.cpu().numpy()))

    # -- exact verification: check the best trajectory points (by
    # surrogate loss, deduplicated) with the quantized algebra and the
    # exact feasibility rule; keep the best exact-feasible one
    traj.sort(key=lambda lv: lv[0])
    seen: List[np.ndarray] = []
    cand_best = None   # (obj, met, knobs-dict)
    n_verify = 0
    for _, xv in traj:
        if any(np.allclose(xv, s_, rtol=0, atol=1e-4) for s_ in seen):
            continue
        seen.append(xv)
        cand = {k: float(xv[i]) for i, k in enumerate(knobs)}
        kn = {k: torch.tensor([v], dtype=F64, device=dev)
              for k, v in cand.items()}
        with torch.no_grad():
            out_c = fn_exact(kn)
        n_verify += 1
        c = (float(out_c[objective][0]), _exact_check(out_c, 0, **targs),
             cand)
        # feasible beats infeasible; then lower objective wins
        if cand_best is None or (c[1], -c[0]) > (cand_best[1],
                                                 -cand_best[0]):
            cand_best = c
        if n_verify >= max_verify:
            break
    cand_obj, cand_met, cand = cand_best

    # -- never-regress: fall back to the grid rung when the refined point
    # is infeasible-while-the-seed-was-feasible or worse
    regressed = (seed_met and not cand_met) or \
        (cand_met == seed_met and cand_obj > seed_obj)
    if regressed:
        final, final_obj, final_met = dict(seed), seed_obj, seed_met
    else:
        final, final_obj, final_met = cand, cand_obj, cand_met
    kn_f = {k: torch.tensor([v], dtype=F64, device=dev)
            for k, v in final.items()}
    with torch.no_grad():
        out_f = fn_exact(kn_f)
    outputs = {k: float(v[0]) for k, v in out_f.items()}

    for k in KNOBS:
        final.setdefault(k, 1.0)
    return OptResult(
        cfg=cfg, knobs=final, objective=objective,
        objective_value=final_obj, met=final_met, outputs=outputs,
        seed_knobs=dict(seed), seed_objective_value=seed_obj,
        seed_met=seed_met,
        improved=bool((final_met or not seed_met)
                      and final_obj < seed_obj),
        fell_back=bool(regressed),
        evals={"grid": n_grid, "grad_steps": steps, "verify": n_verify},
        history=history)
