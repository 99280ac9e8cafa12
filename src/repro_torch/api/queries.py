"""Declarative query objects accepted by `repro_torch.api.Session.run`.
Port of `repro.api.queries`.

Each query is a frozen dataclass (hashable where possible, so sessions
can memoize whole results). Validation lives in `__post_init__`, so an
invalid query fails AT CONSTRUCTION — before it is submitted, queued,
serialized or shipped to a compile service — not halfway through a
session method. The `run(session)` hook remains as the legacy dispatch
path for user-defined Query subclasses; the built-in queries are
lowered by the planner (`repro_torch.api.plan`) instead.

Every query constructs and validates as in the reference. What the port
does not run yet raises NotImplementedError naming its ROADMAP item when
a Session plans it: `CoDesignQuery` (item 12).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.core.bank import BankConfig
from repro_torch.core.dse import Demand, lattice_configs


@dataclass(frozen=True)
class Query:
    """Base class. Built-in subclasses are planned (api.plan);
    user-defined subclasses may override run(session) -> Result, which
    Session.run falls back to when it cannot plan a query."""

    def run(self, session):
        return session.run(self)


@dataclass(frozen=True)
class CompileQuery(Query):
    """One bank config -> full compiler report (netlists, floorplan,
    timing/power/retention; optionally transient-simulated)."""
    cfg: BankConfig = BankConfig()
    simulate: bool = False
    solver: str = "jnp"


@dataclass(frozen=True)
class SweepQuery(Query):
    """Config lattice -> DesignTable, evaluated by the batched
    struct-of-arrays evaluator (set batched=False for the scalar loop).

    fidelity picks the model tier:
      "analytic"  (default) — logical-effort + Elmore algebra, the
                  GEMTOO-class fast model; returns a DesignTable.
      "transient" — additionally integrates every gain-cell point's read
                  column with the batched Newton engine (HSPICE-class,
                  one transient run per cell topology) and returns a
                  CalibratedTable: the analytic DesignTable plus the
                  per-point simulated sense time and analytic-vs-transient
                  error. sim_steps/solver/precision parameterize that
                  engine: solver "pallas" (default) is the fused
                  Woodbury-Newton engine (prefactored K; on the card
                  one launch of the CUDA scan kernel per topology
                  group, its plain torch version on the CPU), "sparse"
                  the fixed-pattern symbolic-LU engine (plain torch on
                  the session's device), "jnp" the dense f64
                  reference. precision "f64" (default) | "mixed"
                  (f32 carried traces, f64 model + solve — passes the
                  1% scalar-parity contract) | "f32" (screening only).
      "layout"  — the transient tier driven by LAYOUT-EXTRACTED
                  parasitics instead of the hand-modeled wire RC: every
                  point's bank is placed + routed + DRC/LVS-verified by
                  `geom` (one batched struct-of-arrays extraction
                  per topology group replaces `core.bank.bitline_rc`),
                  and the result is a LayoutTable carrying the per-point
                  geometry verification reports alongside the transient
                  characterization. sim_steps/solver/precision apply as
                  in "transient". Geometry is verified on the host.
    """
    cells: Tuple[str, ...] = ("gc2t_nn", "gc2t_np", "gc2t_osos")
    word_sizes: Tuple[int, ...] = (16, 32, 64, 128)
    num_words: Tuple[int, ...] = (16, 32, 64, 128)
    write_vts: Tuple[Optional[str], ...] = (None,)
    wwlls: Tuple[bool, ...] = (False, True)
    batched: bool = True
    fidelity: str = "analytic"
    sim_steps: int = 300
    solver: str = "pallas"
    precision: str = "f64"

    def __post_init__(self):
        for f in ("cells", "word_sizes", "num_words", "write_vts",
                  "wwlls"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        if self.fidelity not in ("analytic", "transient", "layout"):
            raise ValueError(
                f"unknown SweepQuery fidelity {self.fidelity!r} "
                "(analytic | transient | layout)")
        if self.solver not in ("jnp", "pallas", "sparse"):
            raise ValueError(f"unknown SweepQuery solver {self.solver!r} "
                             "(jnp | pallas | sparse)")
        if self.precision not in ("f64", "mixed", "f32"):
            raise ValueError(f"unknown SweepQuery precision "
                             f"{self.precision!r} (f64 | mixed | f32)")
        if self.fidelity in ("transient", "layout") and \
                self.precision == "f32":
            # pure-f32 solves through the cond(J)~1e6 MNA Jacobian are
            # outside the parity contract (docs/fidelity-tiers.md);
            # "mixed" keeps the model + solve in f64 and passes it
            warnings.warn(
                "SweepQuery(precision='f32') solves in float32 "
                "throughout; calibration numbers are screening-grade "
                "only (precision='mixed' keeps the solve f64 and holds "
                "the 1% parity contract)", stacklevel=2)

    def configs(self, tech):
        return lattice_configs(self.cells, self.word_sizes, self.num_words,
                               self.write_vts, self.wwlls, tech=tech)


@dataclass(frozen=True)
class MatchQuery(Query):
    """Lattice x workload demands -> shmoo grid + feasibility + multibank
    sizing (`banks_needed`) per demand (the Fig 10 flow).

    The default sweep runs at TRANSIENT fidelity (on the card one launch
    of the fused Newton scan kernel per cell topology), so feasibility
    verdicts come calibrated out of the box. Pass an analytic SweepQuery
    to screen."""
    demands: Tuple[Demand, ...] = ()
    sweep: SweepQuery = field(
        default_factory=lambda: SweepQuery(fidelity="transient"))
    allow_refresh: bool = True
    max_banks: int = 1024

    def __post_init__(self):
        object.__setattr__(self, "demands", tuple(self.demands))
        dkeys = [f"{d.level}:{d.name}" for d in self.demands]
        if len(set(dkeys)) != len(dkeys):
            raise ValueError(f"duplicate demand keys in match: {dkeys} "
                             "(grid/banks_needed are keyed by level:name)")


@dataclass(frozen=True)
class CoDesignQuery(Query):
    """Workload -> memory co-design over (design lattice x operating
    voltage): consume workload Profiles from `workloads.profiler`,
    evaluate the sweep lattice at every `vdd_scales` operating point
    (one device-batched program per cell topology), and for each
    workload's L1/L2 demand pick the feasible (config, voltage) combo
    minimizing the objective, sized as an interleaved multibank macro.

    Not run by the port yet: the profiles come from the workload
    profiler, which waits for ROADMAP item 12.

    The result is a `CoDesignReport`: one heterogeneous per-workload
    plan (best L1 bank at its best operating point + best L2 bank at
    its, possibly different, operating point), memoized in the Session
    like sweep tables.

      profiles      tuple of Profile (frozen/hashable)
      vdd_scales    operating-voltage multipliers of tech.vdd — the
                    paper's "retention tuned on-the-fly by changing the
                    operating voltage" knob
      objective     "energy" -> minimize joules per inference step
                    (dynamic read + macro standby over the step);
                    "area" -> minimize macro area in um^2
      allow_refresh / max_banks follow MatchQuery semantics
    """
    profiles: Tuple["Profile", ...] = ()
    sweep: SweepQuery = field(default_factory=SweepQuery)
    vdd_scales: Tuple[float, ...] = (0.7, 0.85, 1.0, 1.15)
    allow_refresh: bool = True
    max_banks: int = 1024
    objective: str = "energy"

    def __post_init__(self):
        object.__setattr__(self, "profiles", tuple(self.profiles))
        object.__setattr__(self, "vdd_scales",
                           tuple(float(v) for v in self.vdd_scales))
        if self.objective not in ("energy", "area"):
            raise ValueError(f"unknown CoDesignQuery objective "
                             f"{self.objective!r} (energy | area)")
        if not self.profiles:
            raise ValueError("CoDesignQuery needs >= 1 Profile "
                             "(see workloads.profiler)")
        if self.sweep.fidelity != "analytic":
            raise ValueError(
                f"vdd_lattice/codesign run the analytic tier only; got "
                f"SweepQuery(fidelity={self.sweep.fidelity!r}). Calibrate "
                "a shortlist separately with SweepQuery(fidelity="
                "'transient').")


@dataclass(frozen=True)
class OptimizeQuery(Query):
    """Gradient-based continuous design optimization of ONE gain-cell
    bank topology (projected Adam on the differentiable evaluator —
    `optim.dse_opt` over `core.dse_grad`), on the session's device.

    The discrete vdd ladder is demoted to a global SEED (it shares the
    session/store `vdd_lattice` artifacts); the continuous `knobs`
    (operating voltage, device widths, bitline wire width) are then
    refined under the `dse.feasible` demand constraints
    (target_freq_hz, target_ret_s), minimizing `objective`. The result
    is verified with the exact quantized algebra and never regresses
    vs the seed rung (see dse_opt.optimize).

      cell/word_size/num_words/write_vt/wwlls   the frozen topology
      target_freq_hz, target_ret_s   the demand (read Hz, lifetime s)
      objective    any dse_grad output; conventionally one of
                   dse_opt.OBJECTIVES ("standby_w", "t_read_s",
                   "e_read_j", "e_write_j")
      knobs        subset of dse_grad.KNOBS to optimize
      steps, lr    Adam iterations / learning rate
      seed_vdd_scales   the coarse ladder rungs seeding the loop
    """
    cell: str = "gc2t_nn"
    word_size: int = 32
    num_words: int = 64
    write_vt: Optional[str] = None
    wwlls: bool = False
    target_ret_s: float = 1e-4
    target_freq_hz: float = 1e8
    objective: str = "standby_w"
    knobs: Tuple[str, ...] = ("vdd_scale",)
    steps: int = 60
    lr: float = 0.05
    seed_vdd_scales: Tuple[float, ...] = (0.7, 0.85, 1.0, 1.15)
    allow_refresh: bool = True

    def __post_init__(self):
        from repro_torch.core.cells import CELLS, Bitcell
        from repro_torch.core.dse_grad import KNOBS, OUTPUTS
        object.__setattr__(self, "knobs", tuple(self.knobs))
        object.__setattr__(self, "seed_vdd_scales",
                           tuple(float(v) for v in self.seed_vdd_scales))
        if self.cell not in CELLS:
            raise ValueError(f"unknown cell {self.cell!r} "
                             f"(known: {sorted(CELLS)})")
        if not isinstance(CELLS[self.cell], Bitcell):
            raise ValueError(f"OptimizeQuery optimizes gain cells; "
                             f"{self.cell!r} has no retention/width knobs")
        bad = set(self.knobs) - set(KNOBS)
        if bad:
            raise ValueError(f"unknown knobs {sorted(bad)} "
                             f"(allowed: {KNOBS})")
        if not self.knobs:
            raise ValueError("OptimizeQuery needs >= 1 knob")
        if self.objective not in OUTPUTS:
            raise ValueError(f"unknown objective {self.objective!r} "
                             f"(one of {OUTPUTS})")
        if self.steps <= 0 or self.lr <= 0:
            raise ValueError(f"steps/lr must be positive, got "
                             f"steps={self.steps} lr={self.lr}")
        if self.target_ret_s <= 0 or self.target_freq_hz <= 0:
            raise ValueError(
                f"targets must be positive, got target_ret_s="
                f"{self.target_ret_s} target_freq_hz={self.target_freq_hz}")
        if not self.seed_vdd_scales or \
                any(v <= 0 for v in self.seed_vdd_scales):
            raise ValueError(f"seed_vdd_scales must be positive, got "
                             f"{self.seed_vdd_scales}")
        if self.write_vt is not None:
            wf = CELLS[self.cell].write_flavor
            if wf.startswith("os") != self.write_vt.startswith("os"):
                raise ValueError(
                    f"write_vt {self.write_vt!r} is the wrong device "
                    f"family for cell {self.cell!r} (write flavor {wf!r})")
