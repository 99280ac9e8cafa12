"""Session: the stateful entry point of the unified query API.
Port of `repro.api.session`.

A Session binds a TechFile and a device (the card unless the caller asks
for the CPU) and memoizes work across queries. Every evaluation of its
queries runs on that device: the lattice algebra, retention, the
transient characterization (one launch of the fused Newton scan kernel
per topology group on the card) and the compile flow. A session on
"cuda" without a CUDA device raises at construction; nothing moves to
the host to carry on.

It memoizes:

  * per-config DesignPoints (shared between sweeps, matches and
    multibank sizing — a MatchQuery after a SweepQuery re-evaluates
    nothing);
  * whole DesignTables keyed by the sweep's LATTICE-SHAPING fields
    (cells/word_sizes/num_words/write_vts/wwlls + fidelity tier), so
    sweeps differing only in evaluation knobs (`batched`, an analytic
    sweep's `sim_steps`/`solver`/`precision`) share one cached table;
  * compiled Reports keyed by (config, simulate, solver), match results
    and co-design reports by their own shaping fields.

Execution is PLAN-THEN-EXECUTE (`api.plan` lowers queries to
content-hash-keyed node DAGs, `api.executor` runs them):

    s = Session(device="cuda")
    table = s.run(SweepQuery(...))        # eager surface, planned core
    futs = [s.submit(q) for q in queries] # async: queue...
    s.flush()                             # ...drain one coalesced wave
    results = s.run_many(queries)         # submit + flush + collect

`run` is a thin wrapper over submit/flush, so the eager API and its
memoization semantics are unchanged — but concurrently submitted
queries COALESCE: identical plan nodes execute once, and distinct
lattice-eval nodes union into a single device batch. Passing
`store=` (a directory path or `api.store.ArtifactStore`) adds a
content-addressed on-disk cache, so evaluated tables and transient
characterizations survive process restarts and are shared between
sessions.

Convenience methods (`compile/sweep/match/codesign/optimize/evaluate/
multibank`) mirror the Query objects, so both styles work:

    Session().run(SweepQuery(cells=("gc2t_nn",)))
    Session().sweep(SweepQuery(cells=("gc2t_nn",)))

`codesign_measured(windows, cfg)` turns serving telemetry windows
(`repro_torch.runtime`) into profiles and runs their CoDesignQuery.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.api.executor import Executor, QueryFuture
from repro_torch.api.queries import (CoDesignQuery, CompileQuery,
                                     MatchQuery, OptimizeQuery, Query,
                                     SweepQuery)
from repro_torch.api.results import (CalibratedTable, CoDesignReport,
                                     CompileResult, DesignTable,
                                     LayoutTable, MatchResult, Result)
from repro_torch.api.store import ArtifactStore
from repro_torch.api import plan as plan_mod
from repro_torch.core import dse
from repro_torch.core import multibank as mb_mod
from repro_torch.core.bank import BankConfig
from repro_torch.core.dse import Demand, DesignPoint
from repro_torch.core.dse_batch import VddLattice
from repro_torch.core.techfile import SYN40, TechFile


class Session:
    def __init__(self, tech: TechFile = SYN40, store=None, leases=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Session(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run on the host")
        self.tech = tech
        self.store: Optional[ArtifactStore] = \
            ArtifactStore(os.fspath(store)) \
            if isinstance(store, (str, os.PathLike)) else store
        # lease/claim coordination over the shared store directory so N
        # concurrent worker processes never duplicate a lattice
        # evaluation (api.leases): pass a LeaseManager, or True to
        # build one over the store root. Meaningless without a store.
        if leases is True:
            from repro_torch.api.leases import LeaseManager
            leases = LeaseManager(self.store.root) \
                if self.store is not None else None
        self.leases = leases if self.store is not None else None
        self._points: Dict[tuple, DesignPoint] = {}
        # whole tables keyed by lattice-shaping fields + fidelity tier
        # (see _table_key) — NOT by the full query, so evaluation knobs
        # don't fragment the cache
        self._tables: Dict[tuple, DesignTable] = {}
        self._reports: Dict[tuple, CompileResult] = {}
        # per-config transient characterizations, keyed by
        # (config key, sim_steps, solver, precision, parasitics) —
        # shared between overlapping transient/layout-fidelity sweeps
        # exactly like the analytic points
        self._tchars: Dict[tuple, object] = {}
        # per-config geometry verification reports (layout tier), keyed
        # by (config key, n_seg)
        self._geoms: Dict[tuple, dict] = {}
        # (lattice fields, vdd_scales) -> VddLattice; match results and
        # co-design reports by their shaping fields (_match_key /
        # _codesign_key)
        self._vlattices: Dict[tuple, VddLattice] = {}
        self._matches: Dict[tuple, MatchResult] = {}
        self._codesigns: Dict[tuple, CoDesignReport] = {}
        self._optimizes: Dict[object, "Result"] = {}
        self._executor = Executor(self)

    # ------------------------------------------------------------------
    # planned execution surface
    # ------------------------------------------------------------------
    @property
    def executor(self) -> Executor:
        return self._executor

    def run(self, query: Query) -> Result:
        """Execute any Query; returns its Result. Planned queries go
        plan -> (coalescing) execute -> compose; a Query subclass
        overriding run(session) — even a subclass of a built-in query —
        keeps its legacy eager hook."""
        if type(query).run is not Query.run:
            return query.run(self)         # legacy subclass hook
        if not plan_mod.plannable(query):
            raise TypeError(
                f"cannot plan query of type {type(query).__name__} and "
                "it overrides no run(session) hook")
        return self._executor.run_one(query)

    def submit(self, query: Query) -> QueryFuture:
        """Queue a query; returns a Future. Queued queries drain in one
        coalesced admission wave at the next flush() (or implicitly at
        the first Future.result()). Legacy run()-override queries can't
        coalesce; they execute eagerly and return a resolved future."""
        if type(query).run is not Query.run:
            fut = QueryFuture(self._executor, query)
            try:
                fut._set(result=query.run(self))
            except Exception as e:                       # noqa: BLE001
                fut._set(error=e)
            return fut
        return self._executor.submit(query)

    def run_many(self, queries: Iterable[Query]) -> List[Result]:
        """Submit every query and drain them in ONE coalesced wave;
        results come back in input order, bit-identical to sequential
        run() calls."""
        futs = [self.submit(q) for q in queries]
        self.flush()
        return [f.result() for f in futs]

    def flush(self) -> None:
        self._executor.flush()

    # ------------------------------------------------------------------
    # config keys and adoption
    # ------------------------------------------------------------------
    def _adopt(self, cfg: BankConfig) -> BankConfig:
        """Configs evaluated through a session use the session's tech."""
        if cfg.tech is not self.tech:
            cfg = dataclasses.replace(cfg, tech=self.tech)
        return cfg

    @staticmethod
    def _key(cfg: BankConfig) -> tuple:
        return (cfg.word_size, cfg.num_words, cfg.cell, cfg.write_vt,
                cfg.wwlls, cfg.wwl_boost)

    def _cfg_from_key(self, key: tuple) -> BankConfig:
        ws, nw, cell, write_vt, wwlls, boost = key
        return BankConfig(int(ws), int(nw), cell=cell, write_vt=write_vt,
                          wwlls=bool(wwlls), wwl_boost=float(boost),
                          tech=self.tech)

    # ------------------------------------------------------------------
    # result-level cache (lattice-shaping keys only)
    # ------------------------------------------------------------------
    @staticmethod
    def _lattice_key(sweep: SweepQuery) -> tuple:
        return (sweep.cells, sweep.word_sizes, sweep.num_words,
                sweep.write_vts, sweep.wwlls)

    @classmethod
    def _table_key(cls, sweep: SweepQuery) -> tuple:
        base = cls._lattice_key(sweep)
        if sweep.fidelity in ("transient", "layout"):
            return base + (sweep.fidelity, sweep.sim_steps, sweep.solver,
                           sweep.precision)
        return base + ("analytic",)

    @classmethod
    def _match_key(cls, q: MatchQuery) -> tuple:
        return (q.demands, cls._table_key(q.sweep), q.allow_refresh,
                q.max_banks)

    @classmethod
    def _codesign_key(cls, q: CoDesignQuery) -> tuple:
        return (q.profiles, cls._lattice_key(q.sweep), q.vdd_scales,
                q.allow_refresh, q.max_banks, q.objective)

    @staticmethod
    def _vlattice_key(sweep: SweepQuery, vdd_scales) -> tuple:
        return Session._lattice_key(sweep) + \
            (tuple(float(v) for v in vdd_scales),)

    def _result_cache_get(self, query: Query) -> Optional[Result]:
        if isinstance(query, SweepQuery):
            return self._tables.get(self._table_key(query))
        if isinstance(query, MatchQuery):
            return self._matches.get(self._match_key(query))
        if isinstance(query, CoDesignQuery):
            return self._codesigns.get(self._codesign_key(query))
        if isinstance(query, CompileQuery):
            cfg = self._adopt(query.cfg)
            return self._reports.get(
                (self._key(cfg), query.simulate, query.solver))
        if isinstance(query, OptimizeQuery):
            # frozen + tuple-only fields -> the query is its own key
            return self._optimizes.get(query)
        return None

    def _result_cache_put(self, query: Query, result: Result) -> None:
        if isinstance(query, SweepQuery):
            self._tables.setdefault(self._table_key(query), result)
        elif isinstance(query, MatchQuery):
            self._matches.setdefault(self._match_key(query), result)
        elif isinstance(query, CoDesignQuery):
            self._codesigns.setdefault(self._codesign_key(query), result)
        elif isinstance(query, OptimizeQuery):
            self._optimizes.setdefault(query, result)
        # CompileQuery results land in _reports inside the compile node

    def _table_from_points(self, query: SweepQuery, points,
                           chars=None, geoms=None) -> DesignTable:
        """Build (or return the cached) table for an evaluated lattice —
        the compose step of SweepQuery plans."""
        tkey = self._table_key(query)
        hit = self._tables.get(tkey)
        if hit is not None:
            return hit
        if query.fidelity == "layout":
            table = LayoutTable(list(points), query, list(chars),
                                list(geoms))
        elif query.fidelity == "transient":
            table = CalibratedTable(list(points), query, list(chars))
        else:
            table = DesignTable(list(points), query)
        self._tables[tkey] = table
        return table

    # ------------------------------------------------------------------
    # eager convenience surface (thin wrappers over run())
    # ------------------------------------------------------------------
    def compile(self, cfg: Optional[BankConfig] = None, *, simulate=False,
                solver="jnp", **cfg_kw) -> CompileResult:
        """One bank -> Report (netlists + floorplan + all reports).
        Accepts a BankConfig or BankConfig kwargs."""
        cfg = self._adopt(cfg if cfg is not None
                          else BankConfig(tech=self.tech, **cfg_kw))
        return self._executor.run_one(CompileQuery(cfg, simulate=simulate,
                                                   solver=solver))

    def evaluate(self, cfg: BankConfig) -> DesignPoint:
        """Scalar-evaluate (and cache) one config."""
        cfg = self._adopt(cfg)
        k = self._key(cfg)
        if k not in self._points:
            self._points[k] = dse.evaluate(cfg, device=self.device)
        return self._points[k]

    def sweep(self, query: SweepQuery = SweepQuery()) -> DesignTable:
        """Evaluate the config lattice; batched by default.

        fidelity="analytic" returns a DesignTable; fidelity="transient"
        additionally runs the topology-grouped batched transient engine
        over every gain-cell point and returns a CalibratedTable;
        fidelity="layout" drives that engine with layout-extracted
        parasitics and returns a LayoutTable that also carries every
        point's geometry verification report (DRC + LVS-lite +
        extraction bit-parity, `geom`).

        Goes straight to the planned path (NOT through run()'s
        subclass-override dispatch), so a legacy subclass whose run()
        hook delegates here cannot recurse."""
        return self._executor.run_one(query)

    def match(self, demands: Iterable[Demand],
              sweep: SweepQuery = SweepQuery(), *, allow_refresh=True,
              max_banks=1024) -> MatchResult:
        """Shmoo the lattice against demands; for every demand also size
        an interleaved multibank macro (paper: multi-banked GCRAM serves
        the aggregate L2 request stream no single bank can)."""
        return self._executor.run_one(
            MatchQuery(tuple(demands), sweep,
                       allow_refresh=allow_refresh, max_banks=max_banks))

    def multibank(self, cfg: BankConfig,
                  n_banks: int) -> "mb_mod.MultiBankPoint":
        """Compose an N-bank interleaved macro around a (cached) bank."""
        return mb_mod.compose_multibank(self.evaluate(cfg), n_banks)

    def vdd_lattice(self, sweep: SweepQuery = SweepQuery(),
                    vdd_scales=(0.7, 0.85, 1.0, 1.15)) -> VddLattice:
        """Evaluate (and cache) the sweep lattice across an operating-
        voltage ladder — the third lattice dimension of the co-design
        flow. Analytic tier only: a transient-fidelity sweep is rejected
        rather than silently downgraded."""
        if sweep.fidelity != "analytic":
            raise ValueError(
                f"vdd_lattice/codesign run the analytic tier only; got "
                f"SweepQuery(fidelity={sweep.fidelity!r}). Calibrate a "
                "shortlist separately with SweepQuery(fidelity="
                "'transient').")
        # same node execution as a CoDesignQuery plan: keyed on the
        # lattice-shaping fields only (evaluation knobs share the
        # table), consulting and populating the artifact store
        return self._executor.eval_vdd_lattice(
            plan_mod.vdd_lattice_node(self, sweep, vdd_scales))

    def codesign(self, query: CoDesignQuery) -> CoDesignReport:
        """Workload -> memory co-design: per profiled workload, pick the
        best (config, voltage) per L1/L2 demand and size its interleaved
        macro; the whole (vdd x lattice x demand) cube is evaluated on
        the session's device (`core.dse_batch.codesign_metrics`)."""
        return self._executor.run_one(query)

    def codesign_measured(self, windows, cfg, *,
                          sweep: SweepQuery = SweepQuery(),
                          vdd_scales=(0.7, 0.85, 1.0, 1.15),
                          objective: str = "energy",
                          arch: Optional[str] = None,
                          step_time_s: Optional[float] = None,
                          allow_refresh: bool = True,
                          max_banks: int = 1024) -> CoDesignReport:
        """Co-design directly from MEASURED telemetry windows: each
        window becomes a `repro_torch.runtime.measured_profile` over the
        model config that produced it, and the list feeds an ordinary
        CoDesignQuery — the loop from the live engine back into design-
        space exploration. Passing the plain list (CoDesignQuery
        normalizes profile lists to tuples) keeps the report cacheable."""
        from repro_torch.runtime.profile import measured_profile
        profiles = [measured_profile(w, cfg, arch=arch, shape=f"win{i}",
                                     step_time_s=step_time_s)
                    for i, w in enumerate(windows)]
        return self.run(CoDesignQuery(profiles, sweep=sweep,
                                      vdd_scales=tuple(vdd_scales),
                                      objective=objective,
                                      allow_refresh=allow_refresh,
                                      max_banks=max_banks))

    def optimize(self, query: OptimizeQuery = OptimizeQuery()
                 ) -> "Result":
        return self._executor.run_one(query)
