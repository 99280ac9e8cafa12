"""Uniform Result hierarchy returned by Session queries. Port of
`repro.api.results`.

Every result exposes `.as_dict()` (JSON-ready) and `.write(outdir)`
(writes `<outdir>/<filename>`; CompileResult additionally emits its
netlists + floorplan, inherited from the compiler Report).
"""
from __future__ import annotations

import abc
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import dse
from repro_torch.core.compiler import Report
from repro_torch.core.dse import Demand, DesignPoint


class Result(abc.ABC):
    filename = "result.json"

    @abc.abstractmethod
    def as_dict(self) -> dict:
        ...

    def write(self, outdir: str) -> str:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, self.filename), "w") as f:
            json.dump(self.as_dict(), f, indent=1, default=str)
        return outdir


# the compiler Report already implements as_dict()/write(); register it
# so `isinstance(x, Result)` holds across the whole hierarchy
Result.register(Report)
CompileResult = Report


@dataclass
class DesignTable(Result):
    """Evaluated design lattice: a list of DesignPoints + query context."""
    points: List[DesignPoint]
    query: object = None
    filename = "design_table.json"

    def __len__(self):
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __getitem__(self, i):
        return self.points[i]

    def pareto(self, keys=("area_um2", "f_max_hz", "standby_w")):
        return DesignTable(dse.pareto(self.points, keys=keys), self.query)

    def feasible(self, demand: Demand, *, allow_refresh=True):
        return DesignTable(
            [p for p in self.points
             if dse.feasible(p, demand, allow_refresh=allow_refresh)],
            self.query)

    def best(self, key: str = "eff_bw_bps", *, minimize=None
             ) -> Optional[DesignPoint]:
        """Best feasible point by `key`. Direction follows the same
        convention as `pareto()` (dse.PARETO_MAXIMIZE members are
        maximized, everything else — area, power, delays — minimized);
        pass minimize=True/False to override."""
        ok = [p for p in self.points if p.swing_ok]
        if not ok:
            return None
        if minimize is None:
            minimize = key not in dse.PARETO_MAXIMIZE
        return (min if minimize else max)(ok, key=lambda p: getattr(p, key))

    def as_dict(self):
        return {"n_points": len(self.points),
                "rows": [p.as_dict() for p in self.points]}


@dataclass
class CalibratedTable(DesignTable):
    """A DesignTable whose gain-cell points also carry a transient
    (HSPICE-class) characterization of the read column — the result of
    `SweepQuery(fidelity="transient")`.

    `transient[i]` aligns with `points[i]`: a
    `repro_torch.core.spice.char_batch.TransientChar` (simulated sense-swing
    time, analytic estimate, relative deviation) or None for non-gain-cell
    configs. `calibration()` summarizes the analytic-vs-transient error —
    the per-lattice view of the paper's GEMTOO-gap claim."""
    transient: List[Optional[object]] = field(default_factory=list)
    filename = "calibration.json"

    def calibration(self) -> dict:
        devs = [c.rel_dev for c in self.transient
                if c is not None and c.swing_ok]
        return {
            "n_points": len(self.points),
            "n_simulated": sum(c is not None for c in self.transient),
            "n_swing_fail": sum(c is not None and not c.swing_ok
                                for c in self.transient),
            "max_rel_dev": max(devs) if devs else None,
            "mean_rel_dev": sum(devs) / len(devs) if devs else None,
        }

    def as_dict(self):
        rows = []
        for i, p in enumerate(self.points):
            # index (not zip) so a mis-sized transient list can never
            # silently truncate the point rows
            c = self.transient[i] if i < len(self.transient) else None
            row = p.as_dict()
            if c is not None:
                row["transient"] = c.as_dict()
            rows.append(row)
        return {"n_points": len(self.points),
                "calibration": self.calibration(), "rows": rows}


@dataclass
class LayoutTable(CalibratedTable):
    """A CalibratedTable whose transient characterization ran on
    LAYOUT-EXTRACTED parasitics — the result of
    `SweepQuery(fidelity="layout")`.

    `geometry[i]` aligns with `points[i]`: the
    `geom.verify.verify_bank` report of that config's placed +
    routed bank (manifest stats, DRC verdict, LVS-lite connectivity
    verdict, extracted read-column RC, scalar-vs-batched extraction
    bit-parity). `geometry_summary()` rolls the verdicts up — the
    all-clean gate `tools/check_geom.py` enforces in CI."""
    geometry: List[Optional[dict]] = field(default_factory=list)
    filename = "layout_table.json"

    def geometry_summary(self) -> dict:
        gs = [g for g in self.geometry if g is not None]
        return {
            "n_points": len(self.points),
            "n_verified": len(gs),
            "n_drc_clean": sum(bool(g.get("drc_clean")) for g in gs),
            "n_lvs_ok": sum(bool(g.get("lvs_ok")) for g in gs),
            "n_extract_bit_identical": sum(
                bool(g.get("extract_bit_identical")) for g in gs),
            "all_clean": all(
                g.get("drc_clean") and g.get("lvs_ok")
                and g.get("extract_bit_identical") for g in gs),
        }

    def as_dict(self):
        out = super().as_dict()
        for i, row in enumerate(out["rows"]):
            g = self.geometry[i] if i < len(self.geometry) else None
            if g is not None:
                row["geometry"] = g
        out["geometry_summary"] = self.geometry_summary()
        return out


@dataclass
class MatchResult(Result):
    """Shmoo of the lattice against workload demands + multibank sizing."""
    grid: Dict[str, Dict[str, bool]]
    rows: List[dict]                      # one summary row per demand
    banks_needed: Dict[str, int]
    table: DesignTable
    filename = "match.json"

    @property
    def pass_rate(self) -> float:
        cells = [v for row in self.grid.values() for v in row.values()]
        return sum(cells) / len(cells) if cells else 0.0

    def as_dict(self):
        return {"demands": self.rows, "banks_needed": self.banks_needed,
                "pass_rate": self.pass_rate, "grid": self.grid}


@dataclass
class CoDesignReport(Result):
    """Per-workload heterogeneous memory plan from `CoDesignQuery`.

    `plans` has one dict per profiled workload:

      {"workload": "arch:shape", "kind": ..., "step_time_s": ...,
       "feasible": bool,                  # both levels plannable
       "total_area_um2": ..., "total_energy_per_inference_j": ...,
       "levels": {"L1": <entry>, "L2": <entry>}}

    and each level entry carries the chosen bank (`DesignPoint.as_dict`
    including its `vdd_scale`), the operating rail `vdd_v` in volts, the
    interleaved-macro sizing (`banks_needed`, `macro_area_um2`,
    `macro_capacity_bits`, `macro_f_max_hz`), the macro standby watts
    and the joules per inference step — or, when infeasible, the demand
    that could not be met. `lattice` is the underlying
    `repro_torch.core.dse_batch.VddLattice` for further slicing."""
    plans: List[dict]
    query: object = None
    lattice: object = None
    filename = "codesign.json"

    def __iter__(self):
        return iter(self.plans)

    def __getitem__(self, workload: str) -> dict:
        for p in self.plans:
            if p["workload"] == workload:
                return p
        raise KeyError(workload)

    @property
    def all_feasible(self) -> bool:
        return all(p["feasible"] for p in self.plans)

    def as_dict(self):
        n_vdd, n_cfg = self.lattice.shape if self.lattice is not None \
            else (0, 0)
        return {"n_workloads": len(self.plans),
                "n_configs": n_cfg, "n_vdd": n_vdd,
                "vdd_scales": list(getattr(self.lattice, "vdd_scales", ())),
                "all_feasible": self.all_feasible,
                "plans": self.plans}


@dataclass
class OptimizeResult(Result):
    """grad_optimize outcome (optimized design + discrete validation)."""
    raw: dict
    query: object = None
    filename = "optimize.json"

    def __getitem__(self, k):
        return self.raw[k]

    @property
    def met(self) -> bool:
        return bool(self.raw.get("met"))

    def as_dict(self):
        return dict(self.raw)
