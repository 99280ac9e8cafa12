"""Topology-grouped batched transient characterization of the read path.

Characterizes a whole design lattice in one transient run per cell
topology:

  1. group configs by cell topology (`dse_batch.topology_key`): within a
     group the critical-path netlist STRUCTURE (nodes, devices, sources)
     is identical; only the wire parasitics, stop time and wave timings
     differ with the array geometry;
  2. build ONE parametric netlist per group and lift the per-point
     values into parameter arrays: the linear elements assemble via
     unit-value incidence stamps (`Circuit.build_stamps`),
     G_b = src_G + g_b @ R_stamps and C_b = c_b @ C_stamps; per-point
     stop times and the precharge/wordline wave timings enter as (B, ...)
     arrays;
  3. integrate the whole group in one `Transient.run_lattice` on the
     fused Woodbury-Newton engine: the constant Jacobian part is
     inverted once per run and each Newton iteration applies a rank
     3*n_dev correction from the analytic device stamps; on the card
     the whole run is one launch of the CUDA scan kernel
     (`kernels/batched_solve/fused.py`);
  4. extract the sense-swing threshold crossing vectorized on the device
     (`transient.crossing_time`), interpolated between bracketing steps.

Everything runs in float64 unless `precision` asks otherwise: cond(J) ~
1e6 makes float32 Newton noise dominate the traces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import timing as timing_mod
from repro_torch.core.bank import BankConfig, build_bank
from repro_torch.core.dse_batch import (group_by_topology, pad_bucket,
                                        pow2_bucket, topology_key)
from repro_torch.core.spice.transient import Transient, crossing_time

_PIPE_CACHE_MAX = 32     # pipeline entries kept (FIFO eviction)


@dataclass
class TransientChar:
    """Transient read characterization of one design point."""
    cfg: BankConfig
    t_cell_s: float            # simulated sense-swing time (inf: no cross)
    t_cell_analytic_s: float   # analytic estimate (timing.cell_read_time)
    rel_dev: float             # |analytic - sim| / sim (the GEMTOO gap)
    swing_ok: bool             # trace reached the sense target
    t_end_s: float
    n_steps: int

    def as_dict(self) -> dict:
        return {"cell": self.cfg.cell, "word_size": self.cfg.word_size,
                "num_words": self.cfg.num_words, "wwlls": self.cfg.wwlls,
                "write_vt": self.cfg.write_vt,
                "t_cell_sim_s": self.t_cell_s,
                "t_cell_analytic_s": self.t_cell_analytic_s,
                "rel_dev": self.rel_dev, "swing_ok": self.swing_ok,
                "t_end_s": self.t_end_s, "n_steps": self.n_steps}


# (topology_key, n_seg, n_steps, solver, precision, device)
#   -> (system, Transient, stamps..., meta, tech)
_PIPE_CACHE: Dict[tuple, tuple] = {}


def _pipeline(bank0, key: tuple):
    """Template netlist + Transient + incidence stamps for one topology
    group (memoized). The key embeds id(tech) (via topology_key), so each
    entry also pins the TechFile object: without the strong reference, a
    collected tech's id could be reused by a different TechFile and
    silently hit the stale template."""
    hit = _PIPE_CACHE.get(key)
    if hit is not None:
        return hit[:-1]
    n_seg, n_steps, solver, precision, device = key[-5:]
    ckt, meta = timing_mod.read_netlist(bank0, n_seg=n_seg)
    res_stamps, cap_stamps, src_G = ckt.build_stamps()
    system = ckt.build(device=device)
    tr = Transient(system, solver=solver, precision=precision)
    out = (system, tr, res_stamps, cap_stamps, src_G, meta)
    while len(_PIPE_CACHE) >= _PIPE_CACHE_MAX:
        del _PIPE_CACHE[next(iter(_PIPE_CACHE))]
    _PIPE_CACHE[key] = out + (bank0.cfg.tech,)
    return out


def group_inputs(cfgs: List[BankConfig], banks, *, n_seg: int, n_steps: int,
                 solver: str = "pallas", precision: str = "f64",
                 parasitics: str = "modeled", device="cuda") -> dict:
    """Host assembly of one topology group: the `Transient` and the
    per-point run_lattice inputs, padded to a power-of-two bucket.

    parasitics="extracted" (the layout tier): one batched extraction
    over the group (`geom.extract.extract_lattice`) replaces the
    hand-modeled bitline ladder totals. The via R/C folds uniformly into
    the n_seg segments, so the element structure, and with it the
    pipeline entry, is the same as at "modeled".

    Returns a dict with "tr", "wt", "wv", "t_end" (padded, numpy),
    "over" ({"G", "C"} padded (Bp, n, n) float64 tensors on `device`),
    "v0" ((n,) tensor), plus "B", "t_end_raw", "t0", "t_an", "v_pre"
    for the crossing extraction."""
    bank0 = banks[0]
    tech = cfgs[0].tech
    cell = bank0.cell
    key = topology_key(cfgs[0]) + (n_seg, n_steps, solver, precision,
                                   str(torch.device(device)))
    system, tr, res_stamps, cap_stamps, src_G, meta = _pipeline(bank0, key)
    ext = None
    if parasitics == "extracted":
        from repro_torch.geom import extract as geom_extract
        ext = geom_extract.extract_lattice(banks)

    # the per-point netlist builder is the single source of truth for
    # element VALUES (ladder R/C, device caps, SA load); structure is
    # checked identical to the template
    g_vals = np.zeros((len(banks), len(res_stamps)))
    c_vals = np.zeros((len(banks), len(cap_stamps)))
    t_an = np.zeros((len(banks),))
    for p, bank in enumerate(banks):
        rc_p = (float(ext["bl_r_ohm"][p]), float(ext["bl_c_f"][p])) \
            if ext is not None else None
        ckt_p, _ = timing_mod.read_netlist(bank, n_seg=n_seg, rc=rc_p)
        if not (len(ckt_p.names) == len(system.names)
                and len(ckt_p.res) == len(res_stamps)
                and len(ckt_p.caps) == len(cap_stamps)):
            raise ValueError("topology group mismatch")
        g_vals[p] = [g for _, _, g in ckt_p.res]
        c_vals[p] = [c for _, _, c in ckt_p.caps]
        t_an[p] = timing_mod.cell_read_time(bank, rc=rc_p)[0]

    G_b = src_G[None] + np.einsum("br,rij->bij", g_vals, res_stamps)
    C_b = np.einsum("bc,cij->bij", c_vals, cap_stamps)

    # per-point stop time + waves from the same stimulus recipe as the
    # scalar reference (timing.read_stimulus), edge-padded to the longest
    # waveform
    t_end = np.maximum(timing_mod.T_END_OVER_ANALYTIC * t_an,
                       timing_mod.T_END_MIN_S)
    t0 = timing_mod.T0_FRACTION * t_end
    B = len(banks)
    wt = wv = None
    v_pre = 0.0
    for p in range(B):
        waves_p, v_pre = timing_mod.read_stimulus(cell, tech,
                                                  meta["v_sn"], t0[p])
        if wt is None:   # buffer dims derived from the stimulus itself
            k = max(len(t) for t, _ in waves_p)
            wt = np.zeros((B, len(waves_p), k))
            wv = np.zeros((B, len(waves_p), k))
        for w, (t, v) in enumerate(waves_p):
            wt[p, w] = t + [t[-1]] * (k - len(t))
            wv[p, w] = v + [v[-1]] * (k - len(v))

    # pad the batch to a power-of-two bucket (edge-repeat), as the
    # reference does; padded lanes are dropped after the run
    Bp = pow2_bucket(B)
    G_b, C_b, wt, wv, t_end_p = (pad_bucket(a, Bp)
                                 for a in (G_b, C_b, wt, wv, t_end))
    f64 = dict(dtype=torch.float64, device=device)
    return {"tr": tr, "wt": wt, "wv": wv, "t_end": t_end_p,
            "over": {"G": torch.as_tensor(G_b, **f64),
                     "C": torch.as_tensor(C_b, **f64)},
            "v0": torch.full((system.n,), v_pre, **f64),
            "B": B, "t_end_raw": t_end, "t0": t0, "t_an": t_an,
            "v_pre": v_pre}


def _characterize_group(cfgs: List[BankConfig], banks, *, n_seg: int,
                        n_steps: int, solver: str, precision: str = "f64",
                        parasitics: str = "modeled",
                        device="cuda") -> List[TransientChar]:
    inp = group_inputs(cfgs, banks, n_seg=n_seg, n_steps=n_steps,
                       solver=solver, precision=precision,
                       parasitics=parasitics, device=device)
    res = inp["tr"].run_lattice(inp["wt"], inp["wv"], inp["t_end"], n_steps,
                                over_batches=inp["over"], v0=inp["v0"])
    tech, cell = cfgs[0].tech, banks[0].cell
    swing = tech.v_sense_se
    target = inp["v_pre"] + (swing if cell.predischarge else -swing)
    tc, valid = crossing_time(res["t"], res["rbl_near"], target,
                              rising=cell.predischarge)
    B, t0, t_an = inp["B"], inp["t0"], inp["t_an"]
    tc = tc.cpu().numpy()[:B]
    valid = valid.cpu().numpy()[:B]
    t_cell = np.where(valid, tc - t0, np.inf)

    out = []
    for p, cfg in enumerate(cfgs):
        sim = float(t_cell[p])
        dev = abs(t_an[p] - sim) / sim if np.isfinite(sim) and sim > 0 \
            else float("inf")
        out.append(TransientChar(cfg, sim, float(t_an[p]), float(dev),
                                 bool(valid[p]), float(inp["t_end_raw"][p]),
                                 n_steps))
    return out


def t_cell_grad_fn(cfg: BankConfig, *, n_seg: int = 8, n_steps: int = 300,
                   solver: str = "pallas", precision: str = "f64",
                   device="cuda"):
    """Differentiable transient read characterization of ONE topology.

    Returns `fn(knobs) -> (t_cell_s (B,), valid (B,))` where `knobs` maps
    any subset of the continuous design knobs to (B,) float64 tensors on
    `device`:

      vdd_scale     array operating voltage multiplier (techfile
                    `with_vdd_scale` semantics: rails, written SN level
                    and stimulus levels scale; sense swing does not)
      w_read_scale  read-device width multiplier (device current + its
                    gate/junction caps + the bitline junction load)
      bl_wire_scale bitline wire WIDTH multiplier (ladder conductance
                    scales up, wire capacitance scales up)

    Every knob flows through the MNA assembly, the stimulus waves and the
    implicit-function VJP of the Newton solve, so `torch.autograd.grad`
    of any reduction of t_cell_s is one adjoint solve per timestep, not a
    differentiated unroll. With solver="pallas" the forward is one launch
    of the fused Newton scan kernel on the card. Discretization constants
    (t0, t_end, step count) are pinned at the NOMINAL design point: they
    are solver settings, not physics, and freezing them keeps the
    objective smooth. Gain cells only; solver "pallas" or "sparse" (the
    dense "jnp" path takes no device-parameter overrides).
    """
    if solver not in ("pallas", "sparse"):
        raise ValueError(f"solver {solver!r} not differentiable here "
                         "(use 'pallas' or 'sparse')")
    bank0 = build_bank(cfg)
    if not bank0.is_gc:
        raise ValueError(f"cell {cfg.cell!r} has no single-ended read "
                         "column to characterize")
    tech = cfg.tech
    cell = bank0.cell
    key = topology_key(cfg) + (n_seg, n_steps, solver, precision,
                               str(torch.device(device)))
    system, tr, res_stamps, cap_stamps, src_G, meta = _pipeline(bank0, key)
    dev = system.G.device
    f64 = dict(dtype=torch.float64, device=dev)

    # -- nominal element values + cap-class decomposition. read_netlist
    # appends, in order: 4 precharge-device caps (fixed w=1.2), n_seg
    # ladder caps (c_bl/n_seg each), the SA input cap, 4 read-device caps
    # (each proportional to w_read). Check that layout before relying on
    # it.
    ckt0, _ = timing_mod.read_netlist(bank0, n_seg=n_seg)
    g0 = np.array([g for _, _, g in ckt0.res])          # conductances
    c0 = np.array([c for _, _, c in ckt0.caps])
    assert len(g0) == n_seg and len(c0) == n_seg + 9, \
        "read_netlist element layout changed; update t_cell_grad_fn"
    from repro_torch.core import bank as bank_mod
    r_bl0, c_bl0 = bank_mod.bitline_rc(bank0)
    rf = cell.rf(tech)
    # Python floats: a numpy scalar times a tensor would leave autograd
    c_junc0 = float(bank0.rows * rf.cj_f_per_um * cell.w_read)  # ~ w_read
    c_wire0 = float(c_bl0) - c_junc0                     # ~ bl width
    np.testing.assert_allclose(g0, n_seg / r_bl0, rtol=1e-9)
    np.testing.assert_allclose(c0[4:4 + n_seg], c_bl0 / n_seg, rtol=1e-9)

    d_rd = next(i for i, d in enumerate(ckt0.devs) if d["name"] == "read_dev")
    w0 = [float(d["w"]) for d in ckt0.devs]

    # -- static discretization (from the nominal analytic estimate)
    t_an0 = timing_mod.cell_read_time(bank0)[0]
    t_end = max(timing_mod.T_END_OVER_ANALYTIC * t_an0,
                timing_mod.T_END_MIN_S)
    t0 = timing_mod.T0_FRACTION * t_end
    # wave TIME grids are static (the stimulus recipe of read_stimulus,
    # edge-padded to 3 knots); LEVELS are rebuilt per point below
    wt1 = torch.tensor([[0.0, t0, t0 * 1.2],
                        [0.0, t0 * 0.8, t0],
                        [0.0, 1.0, 1.0],
                        [0.0, 1.0, 1.0]], **f64)
    bit = 0 if cell.read_on_sn_low else 1
    swing = tech.v_sense_se
    n = system.n
    g0_t = torch.as_tensor(g0, **f64)
    c0_t = torch.as_tensor(c0, **f64)
    res_t = torch.as_tensor(res_stamps, **f64)
    cap_t = torch.as_tensor(cap_stamps, **f64)
    src_t = torch.as_tensor(src_G, **f64)
    n_seg_t = torch.tensor(float(n_seg), **f64)

    from repro_torch.core import cells as cells_mod

    def fn(knobs):
        some = torch.as_tensor(next(iter(knobs.values())))
        B = some.shape[0]
        one = torch.ones((B,), **f64)

        def knob(name):
            return torch.as_tensor(knobs.get(name, one), **f64)

        s_v, s_w, s_bl = (knob(k) for k in ("vdd_scale", "w_read_scale",
                                            "bl_wire_scale"))
        # linear elements: ladder conductance ~ wire width; ladder cap =
        # wire part ~ width + junction part ~ w_read; device caps of the
        # read transistor ~ w_read; precharge-device + SA caps fixed
        g_vals = g0_t[None, :] * s_bl[:, None]
        c_lad = (c_wire0 * s_bl + c_junc0 * s_w)[:, None] / n_seg_t
        c_vals = torch.cat([
            c0_t[:4].expand(B, 4),
            c_lad.expand(B, n_seg),
            c0_t[4 + n_seg].expand(B, 1),
            c0_t[None, 4 + n_seg + 1:] * s_w[:, None],
        ], dim=1)
        G_b = src_t[None] + torch.einsum("br,rij->bij", g_vals, res_t)
        C_b = torch.einsum("bc,cij->bij", c_vals, cap_t)

        # stimulus levels (same recipe as timing.read_stimulus)
        vdd = tech.vdd * s_v
        zero = torch.zeros_like(vdd)
        v_sn = cells_mod.v_sn_written_t(cell, tech, bit, vdd,
                                        wwlls=cfg.wwlls,
                                        wwl_boost=cfg.wwl_boost)
        rwl_idle = zero if cell.rwl_active_high else vdd
        rwl_act = vdd if cell.rwl_active_high else zero
        v_pre = zero if cell.predischarge else vdd
        en_idle = vdd if cell.predischarge else zero
        en_off = zero if cell.predischarge else vdd
        wv = torch.stack([
            torch.stack([rwl_idle, rwl_idle, rwl_act], dim=1),
            torch.stack([en_idle, en_idle, en_off], dim=1),
            torch.stack([v_sn, v_sn, v_sn], dim=1),
            torch.stack([vdd, vdd, vdd], dim=1),
        ], dim=1)
        wt = wt1[None].expand(B, 4, 3)

        w_b = torch.stack([w0[d] * s_w if d == d_rd
                           else torch.full((B,), w0[d], **f64)
                           for d in range(len(w0))], dim=1)
        v0 = v_pre[:, None].expand(B, n)
        res = tr.run_lattice(wt, wv, torch.full((B,), t_end, **f64),
                             n_steps,
                             over_batches={"G": G_b, "C": C_b, "w": w_b},
                             v0=v0)
        # per-point sense target via a trace shift (crossing_time takes a
        # scalar target)
        target = v_pre + (swing if cell.predischarge else -swing)
        tc, valid = crossing_time(res["t"], res["rbl_near"] - target[:, None],
                                  0.0, rising=cell.predischarge)
        return tc - t0, valid

    return fn


def characterize(cfgs: Sequence[BankConfig], *, n_steps: int = 300,
                 solver: str = "pallas", n_seg: int = 8,
                 precision: str = "f64", parasitics: str = "modeled",
                 device="cuda") -> List[Optional[TransientChar]]:
    """Batched transient read characterization of a config lattice.

    Returns one TransientChar per config, in input order; non-gain-cell
    configs (no single-ended read column to simulate) get None. One
    transient run per cell topology, on `device`.

    parasitics="extracted" (fidelity="layout") swaps the hand-modeled
    read-bitline ladder for the batched layout extraction
    (`geom.extract.extract_lattice`): one struct-of-arrays extraction per
    topology group, the same transient pipeline."""
    if parasitics not in ("modeled", "extracted"):
        raise ValueError(f"parasitics must be 'modeled' or 'extracted', "
                         f"got {parasitics!r}")
    cfgs = list(cfgs)
    out: List[Optional[TransientChar]] = [None] * len(cfgs)
    for idx in group_by_topology(cfgs).values():
        group = [cfgs[i] for i in idx]
        banks = [build_bank(c) for c in group]
        if not banks[0].is_gc:
            continue
        chars = _characterize_group(group, banks, n_seg=n_seg,
                                    n_steps=n_steps, solver=solver,
                                    precision=precision,
                                    parasitics=parasitics, device=device)
        for i, ch in zip(idx, chars):
            out[i] = ch
    return out
