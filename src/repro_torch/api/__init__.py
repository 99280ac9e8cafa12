"""Unified OpenGCRAM query API — ONE user-facing entry point.

Port of `repro.api`, with the same public names:

    from repro_torch.api import Session, CompileQuery, SweepQuery, MatchQuery

    s = Session(device="cuda")             # tech + device + caches
    rep = s.run(CompileQuery(BankConfig(32, 32, cell="gc2t_nn")))
    table = s.run(SweepQuery())            # batched analytic lattice
    match = s.run(MatchQuery(demands=(Demand("act", "L1", 5e8, 1e-6),)))
    best = table.pareto().best("eff_bw_bps")

Queries are declarative dataclasses; every result shares the `Result`
interface (`.as_dict()` / `.write(outdir)`). A `Session` memoizes
per-config evaluations and whole sweep tables, and `SweepQuery` runs
through the struct-of-arrays evaluator in `repro_torch.core.dse_batch`
(scalar reference: `repro_torch.core.dse.evaluate`) on the session's
device. `SweepQuery(fidelity="transient")` escalates to the transient
tier: `core.spice.char_batch.characterize` simulates every gain-cell
read column, one run of the fused Newton scan kernel per cell topology
on the card, and the returned `CalibratedTable` reports the
analytic-vs-transient error per point. `MatchQuery` (the paper's Fig-10
flow) runs that transient sweep by default, then the shmoo grid and the
multibank sizing per demand.

Execution is PLANNED, not eager: every query lowers to a small DAG of
content-hash-keyed evaluation nodes (`api.plan`), and a coalescing
executor (`api.executor`) runs them — `Session.run` is a thin wrapper
over `submit(query) -> Future` / `run_many(queries)`, which dedupe
identical nodes across concurrently submitted queries and union distinct
lattice evaluations into single device batches, bit-identical to
sequential runs. `Session(store=...)` adds the content-addressed on-disk
artifact cache (`api.store`), so evaluated tables and characterizations
survive process restarts; `Session(leases=True)` coordinates workers
that share a store (`api.leases`).

`CoDesignQuery` takes workload profiles (`repro_torch.workloads`, or
measured ones from `repro_torch.runtime` through
`Session.codesign_measured`) and picks a (config, voltage) per cache
demand over the analytic (vdd x lattice) table on the session's device.
"""
from repro_torch.api.executor import Executor, QueryFuture
from repro_torch.api.leases import Lease, LeaseManager
from repro_torch.api.queries import (CoDesignQuery, CompileQuery,
                                     MatchQuery, OptimizeQuery, Query,
                                     SweepQuery)
from repro_torch.api.results import (CalibratedTable, CoDesignReport,
                                     CompileResult, DesignTable,
                                     LayoutTable, MatchResult,
                                     OptimizeResult, Result)
from repro_torch.api.session import Session
from repro_torch.api.store import ArtifactStore

__all__ = [
    "Session", "Query", "CompileQuery", "SweepQuery", "MatchQuery",
    "CoDesignQuery", "OptimizeQuery", "Result", "CompileResult",
    "DesignTable", "CalibratedTable", "LayoutTable", "MatchResult",
    "CoDesignReport", "OptimizeResult", "Executor", "QueryFuture",
    "ArtifactStore", "Lease", "LeaseManager",
]
