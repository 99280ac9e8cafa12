"""Query planning: lower every Query into a DAG of canonical
evaluation nodes. Port of `repro.api.plan`.

Planned execution splits every query into two halves:

  * a small DAG of `Node`s naming the device-side work — config-lattice
    evaluation (`points`), transient characterization (`transient`),
    geometry verification for the layout tier (`geom`), the
    (vdd x lattice) table (`vdd_lattice`), the shmoo grid (`shmoo`),
    one-bank compilation (`compile`) and gradient optimization
    (`optimize`), and the co-design cube over the vdd table
    (`codesign_cube`);
  * a pure-host `compose` step that assembles the query's Result from
    the node outputs (select/compose: pick banks, size macros, build
    tables).

Node keys are CONTENT HASHES of `(kind, tech hash, lattice-shaping
payload, backend tag)`: two queries that need the same evaluation
produce the same key no matter which session, process or tenant
submitted them. That is what the coalescing executor (`api.executor`)
dedupes on, what distinct lattice-eval nodes union device batches
across, and what the on-disk artifact store (`api.store`) files results
under. The backend tag names this package, so a store shared with the
JAX package never hands either package the other's artifacts.
Evaluation knobs that cannot change the result (e.g. `batched`) stay
OUT of the key and ride in `spec` instead.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.queries import (CoDesignQuery, CompileQuery,
                                     MatchQuery, OptimizeQuery, Query,
                                     SweepQuery)
from repro_torch.api.results import (CoDesignReport, MatchResult,
                                     OptimizeResult)
from repro_torch.core import multibank as mb_mod
from repro_torch.core.bank import BankConfig
from repro_torch.core.dse import DesignPoint
from repro_torch.core.dse_batch import VddLattice
from repro_torch.core.spice.char_batch import TransientChar

__all__ = ["Node", "Plan", "plan_query", "plannable", "node_key",
           "tech_hash"]

#: hashed into every node key: artifacts of this package and of the JAX
#: reference never share a key
BACKEND = "repro_torch"


# ---------------------------------------------------------------------------
# content hashing
# ---------------------------------------------------------------------------

# id(tech) -> (tech, hash); the strong reference keeps the deck alive so
# a recycled id can never alias a different TechFile (same caveat and
# fix as dse_batch._CONSTS_CACHE)
_TECH_HASH_CACHE: Dict[int, tuple] = {}


def tech_hash(tech) -> str:
    """Stable content hash of a TechFile deck: equal decks hash equal
    across processes (the property the on-disk store keys rely on)."""
    hit = _TECH_HASH_CACHE.get(id(tech))
    if hit is not None and hit[0] is tech:
        return hit[1]
    blob = json.dumps(dataclasses.asdict(tech), sort_keys=True,
                      default=repr)
    h = hashlib.sha256(blob.encode()).hexdigest()[:16]
    _TECH_HASH_CACHE[id(tech)] = (tech, h)
    return h


def node_key(kind: str, tech, payload) -> str:
    """Content-hash key of one evaluation node. `payload` must hold the
    lattice-shaping fields only — everything that determines the node's
    RESULT, nothing that merely tunes how it is computed."""
    blob = json.dumps([kind, tech_hash(tech), payload, BACKEND],
                      sort_keys=True)
    return f"{kind}-{hashlib.sha256(blob.encode()).hexdigest()[:24]}"


# ---------------------------------------------------------------------------
# nodes and plans
# ---------------------------------------------------------------------------

@dataclass
class Node:
    """One canonical evaluation step. `key` is the content hash (dedupe
    + store identity); `cfgs`/`spec` carry the runtime payload the
    executor needs; `deps` are keys of nodes whose outputs this one
    consumes."""
    kind: str
    key: str
    cfgs: Tuple[BankConfig, ...] = ()
    spec: dict = field(default_factory=dict)
    deps: Tuple[str, ...] = ()


@dataclass
class Plan:
    """A query's node DAG + the host-side compose step. `nodes` is
    ordered dependencies-first, so executing in list order (after
    cross-plan dedupe, which keeps first occurrences) is always valid."""
    query: Query
    nodes: List[Node]
    compose: Callable  # (session, {node key: output}) -> Result


def plannable(query) -> bool:
    return isinstance(query, (CompileQuery, SweepQuery, MatchQuery,
                              CoDesignQuery, OptimizeQuery))


def _cfg_keys(session, cfgs) -> list:
    return [list(session._key(c)) for c in cfgs]


def _demand_payload(demands) -> list:
    return [[d.name, d.level, d.read_freq_hz, d.lifetime_s,
             d.capacity_bits] for d in demands]


def _lattice_payload(sweep: SweepQuery) -> list:
    return [list(sweep.cells), list(sweep.word_sizes),
            list(sweep.num_words), list(sweep.write_vts),
            list(sweep.wwlls)]


def plan_query(session, query: Query) -> Plan:
    """Lower one query into its Plan. Raises TypeError for query types
    the planner does not know (legacy Query subclasses keep working via
    their own `run(session)` hooks — see Session.run)."""
    if isinstance(query, SweepQuery):
        return _plan_sweep(session, query)
    if isinstance(query, MatchQuery):
        return _plan_match(session, query)
    if isinstance(query, CoDesignQuery):
        return _plan_codesign(session, query)
    if isinstance(query, CompileQuery):
        return _plan_compile(session, query)
    if isinstance(query, OptimizeQuery):
        return _plan_optimize(session, query)
    raise TypeError(f"cannot plan query of type {type(query).__name__}")


def _plan_sweep(session, q: SweepQuery) -> Plan:
    cfgs = tuple(q.configs(session.tech))
    pkeys = _cfg_keys(session, cfgs)
    pnode = Node("points", node_key("points", session.tech, pkeys),
                 cfgs=cfgs, spec={"batched": q.batched})
    nodes = [pnode]
    tnode = gnode = None
    if q.fidelity in ("transient", "layout"):
        parasitics = "extracted" if q.fidelity == "layout" else "modeled"
        payload = [pkeys, q.sim_steps, q.solver, q.precision]
        if parasitics != "modeled":
            # appended only for the layout tier, so stored hand-modeled
            # transient artifacts keep their pre-layout keys
            payload.append(parasitics)
        tnode = Node(
            "transient", node_key("transient", session.tech, payload),
            cfgs=cfgs, spec={"sim_steps": q.sim_steps, "solver": q.solver,
                             "precision": q.precision,
                             "parasitics": parasitics})
        nodes.append(tnode)
    if q.fidelity == "layout":
        # geometry build + DRC/LVS + scalar-vs-batched extraction parity,
        # one verification report per config (the layout tier)
        gnode = Node("geom", node_key("geom", session.tech, pkeys),
                     cfgs=cfgs, spec={"n_seg": 8})
        nodes.append(gnode)

    def compose(s, out):
        chars = out[tnode.key] if tnode is not None else None
        if gnode is not None:
            return s._table_from_points(q, out[pnode.key], chars,
                                        geoms=out[gnode.key])
        return s._table_from_points(q, out[pnode.key], chars)

    return Plan(q, nodes, compose)


def _plan_match(session, q: MatchQuery) -> Plan:
    sub = _plan_sweep(session, q.sweep)
    pnode = sub.nodes[0]
    snode = Node(
        "shmoo",
        node_key("shmoo", session.tech,
                 [pnode.key, _demand_payload(q.demands), q.allow_refresh]),
        spec={"demands": q.demands, "allow_refresh": q.allow_refresh},
        deps=(pnode.key,))

    def compose(s, out):
        table = sub.compose(s, out)
        return compose_match(s, q, table, out[snode.key])

    return Plan(q, sub.nodes + [snode], compose)


def vdd_lattice_node(session, sweep: SweepQuery, vdd_scales) -> Node:
    """The (vdd x lattice) evaluation node — shared by CoDesignQuery
    plans and the eager Session.vdd_lattice, so both read and populate
    the same session cache and on-disk artifacts."""
    scales = tuple(float(v) for v in vdd_scales)
    return Node(
        "vdd_lattice",
        node_key("vdd_lattice", session.tech,
                 [_lattice_payload(sweep), list(scales)]),
        spec={"sweep": sweep, "vdd_scales": scales})


def _plan_codesign(session, q: CoDesignQuery) -> Plan:
    vnode = vdd_lattice_node(session, q.sweep, q.vdd_scales)
    demands, steps = [], []
    for prof in q.profiles:
        for d in prof.demands():
            demands.append(d)
            steps.append(prof.step_time_s)
    cnode = Node(
        "codesign_cube",
        node_key("codesign_cube", session.tech,
                 [vnode.key, _demand_payload(demands), list(steps),
                  q.allow_refresh, q.max_banks]),
        spec={"demands": tuple(demands), "steps": tuple(steps),
              "allow_refresh": q.allow_refresh, "max_banks": q.max_banks},
        deps=(vnode.key,))

    def compose(s, out):
        return compose_codesign(s, q, out[vnode.key], out[cnode.key])

    return Plan(q, [vnode, cnode], compose)


def _plan_compile(session, q: CompileQuery) -> Plan:
    cfg = session._adopt(q.cfg)
    node = Node(
        "compile",
        node_key("compile", session.tech,
                 [list(session._key(cfg)), q.simulate, q.solver]),
        cfgs=(cfg,), spec={"simulate": q.simulate, "solver": q.solver})
    return Plan(q, [node], lambda s, out: out[node.key])


def _plan_optimize(session, q: OptimizeQuery) -> Plan:
    # seed ladder as a shared vdd_lattice node: the single-config
    # (vdd x 1) table dedupes/caches/persists exactly like the co-design
    # lattices (same session cache, same on-disk artifacts)
    sweep = SweepQuery(cells=(q.cell,), word_sizes=(q.word_size,),
                       num_words=(q.num_words,), write_vts=(q.write_vt,),
                       wwlls=(q.wwlls,))
    vnode = vdd_lattice_node(session, sweep, q.seed_vdd_scales)
    cfg = session._adopt(BankConfig(q.word_size, q.num_words, cell=q.cell,
                                    write_vt=q.write_vt, wwlls=q.wwlls,
                                    tech=session.tech))
    spec = {"target_ret_s": q.target_ret_s,
            "target_freq_hz": q.target_freq_hz, "objective": q.objective,
            "knobs": q.knobs, "steps": q.steps, "lr": q.lr,
            "seed_vdd_scales": q.seed_vdd_scales,
            "allow_refresh": q.allow_refresh}
    payload = [list(session._key(cfg)),
               sorted((k, list(v) if isinstance(v, tuple) else v)
                      for k, v in spec.items()), vnode.key]
    node = Node("optimize", node_key("optimize", session.tech, payload),
                cfgs=(cfg,), spec=spec, deps=(vnode.key,))
    return Plan(q, [vnode, node],
                lambda s, out: OptimizeResult(out[node.key], q))


# ---------------------------------------------------------------------------
# compose steps (select/compose: pure host logic, no device work)
# ---------------------------------------------------------------------------

def compose_match(session, q: MatchQuery, table, grid) -> MatchResult:
    """Per-demand bank selection + multibank sizing over an evaluated
    table and its shmoo grid (the host half of the old Session.match)."""
    fastest = table.best("f_max_hz")
    rows, banks = [], {}
    for d in q.demands:
        key = f"{d.level}:{d.name}"
        feas = table.feasible(d, allow_refresh=q.allow_refresh)
        # densest single bank if one works, else the fastest bank tiled
        pick = max(feas, key=lambda p: p.cfg.bits / p.area_um2) \
            if len(feas) else fastest
        n = mb_mod.banks_needed(pick, d, capacity_bits=d.capacity_bits,
                                max_banks=q.max_banks,
                                allow_refresh=q.allow_refresh) \
            if pick is not None else q.max_banks + 1
        banks[key] = n
        rows.append({
            "demand": key, "read_freq_hz": d.read_freq_hz,
            "lifetime_s": d.lifetime_s,
            "capacity_bits": d.capacity_bits,
            "n_feasible": len(feas),
            # n > max_banks is banks_needed's infeasibility sentinel:
            # even a max_banks-wide macro cannot serve this demand
            "macro_feasible": n <= q.max_banks,
            "banks_needed": n,
            "bank": pick.as_dict() if pick is not None else None,
        })
    return MatchResult(grid, rows, banks, table)


def compose_codesign(session, q: CoDesignQuery, lat: VddLattice,
                     cube) -> CoDesignReport:
    """Per-workload (config, voltage) selection + macro sizing over the
    evaluated co-design cube (the host half of the old
    Session.codesign)."""
    feas, banks, energy, macro_ok = cube
    _, P = lat.shape
    plans, j = [], 0
    for prof in q.profiles:
        levels = {}
        for d in prof.demands():
            # a level is plannable if SOME interleaved macro serves it
            # (banks_needed tiles past a single bank's f_max, exactly
            # like MatchQuery's fastest-bank fallback)
            ok = macro_ok[:, :, j]
            entry = {"read_freq_hz": d.read_freq_hz,
                     "lifetime_s": d.lifetime_s,
                     "capacity_bits": d.capacity_bits,
                     "n_feasible": int(feas[:, :, j].sum()),
                     "n_macro_feasible": int(ok.sum()),
                     "feasible": bool(ok.any())}
            if entry["feasible"]:
                score = energy[:, :, j] if q.objective == "energy" \
                    else banks[:, :, j] * lat.area_um2[None, :]
                vi, pi = divmod(int(np.argmin(
                    np.where(ok, score, np.inf))), P)
                n = int(banks[vi, pi, j])
                dp = lat.point(vi, pi)
                macro = mb_mod.compose_multibank(dp, n)
                entry.update(
                    bank=dp.as_dict(),
                    vdd_scale=float(lat.vdd_scales[vi]),
                    vdd_v=session.tech.vdd * float(lat.vdd_scales[vi]),
                    banks_needed=n,
                    macro_area_um2=macro.area_um2,
                    macro_capacity_bits=macro.capacity_bits,
                    macro_f_max_hz=macro.f_max_hz,
                    standby_w=n * dp.standby_w,
                    energy_per_inference_j=float(energy[vi, pi, j]))
            levels[d.level] = entry
            j += 1
        okl = [e for e in levels.values() if e["feasible"]]
        plans.append({
            "workload": f"{prof.arch}:{prof.shape}",
            "kind": prof.kind, "step_time_s": prof.step_time_s,
            "feasible": len(okl) == len(levels),
            "total_area_um2": sum(e["macro_area_um2"] for e in okl),
            "total_energy_per_inference_j":
                sum(e["energy_per_inference_j"] for e in okl),
            "levels": levels,
        })
    return CoDesignReport(plans, q, lat)


# ---------------------------------------------------------------------------
# artifact (de)serialization — JSON-able forms for the on-disk store.
# Floats round-trip exactly (shortest repr), so a decoded artifact is
# bit-identical to the evaluation it replaces.
# ---------------------------------------------------------------------------

_POINT_FIELDS = ("area_um2", "f_max_hz", "read_bw_bps", "write_bw_bps",
                 "eff_bw_bps", "leakage_w", "refresh_w", "retention_s",
                 "swing_ok", "t_read_s", "t_write_s", "vdd_scale")


def encode_points(session, points) -> list:
    return [{"cfg": list(session._key(p.cfg)),
             **{f: getattr(p, f) for f in _POINT_FIELDS}}
            for p in points]


def decode_points(session, data) -> List[DesignPoint]:
    return [DesignPoint(session._cfg_from_key(tuple(d["cfg"])),
                        *(d[f] for f in _POINT_FIELDS)) for d in data]


_CHAR_FIELDS = ("t_cell_s", "t_cell_analytic_s", "rel_dev", "swing_ok",
                "t_end_s", "n_steps")


def encode_chars(session, chars) -> list:
    return [None if c is None else
            {"cfg": list(session._key(c.cfg)),
             **{f: getattr(c, f) for f in _CHAR_FIELDS}}
            for c in chars]


def decode_chars(session, data) -> List[Optional[TransientChar]]:
    return [None if d is None else
            TransientChar(session._cfg_from_key(tuple(d["cfg"])),
                          *(d[f] for f in _CHAR_FIELDS)) for d in data]


def encode_geoms(session, geoms) -> list:
    """Geometry verification reports (`geom.verify.verify_bank`) are
    already JSON-able dicts of ints/floats/bools/strings."""
    return [None if g is None else dict(g) for g in geoms]


def decode_geoms(session, data) -> list:
    return [None if g is None else dict(g) for g in data]


_VLAT_2D = ("f_max_hz", "t_read_s", "t_write_s", "retention_s",
            "swing_ok", "leakage_w", "refresh_w", "e_read_j", "e_write_j")
_VLAT_1D = ("area_um2", "bits", "num_words", "is_gc")


def encode_vdd_lattice(session, lat: VddLattice) -> dict:
    out = {"cfgs": [list(session._key(c)) for c in lat.cfgs],
           "vdd_scales": list(lat.vdd_scales)}
    for f in _VLAT_2D + _VLAT_1D:
        out[f] = np.asarray(getattr(lat, f)).tolist()
    return out


def decode_vdd_lattice(session, data) -> VddLattice:
    cfgs = [session._cfg_from_key(tuple(k)) for k in data["cfgs"]]
    arrs = {}
    for f in _VLAT_2D + _VLAT_1D:
        dt = bool if f in ("swing_ok", "is_gc") else np.float64
        arrs[f] = np.asarray(data[f], dtype=dt)
    return VddLattice(cfgs, tuple(float(v) for v in data["vdd_scales"]),
                      **arrs)
