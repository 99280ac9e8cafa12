"""Coalescing plan executor: Session.submit / run_many / run.
Port of `repro.api.executor`; every evaluation runs on the session's
device.

Queries submitted to a Session no longer execute eagerly — they queue
as (query, future) pairs and drain in ADMISSION WAVES. One wave:

  1. result-cache check: queries whose whole Result the session already
     memoizes resolve immediately (same objects as before — `run` twice
     still returns the identical table);
  2. plan: every remaining query lowers to its node DAG
     (`api.plan`); nodes dedupe across queries by content-hash
     key, first submission wins — N queries sharing a lattice carry ONE
     `points` node into execution;
  3. coalesce: still-missing configs of ALL `points` nodes union into a
     single device batch per evaluation mode (batched nodes share one
     `dse_batch.evaluate_batch` call, riding its topology grouping;
     scalar nodes loop), walked in
     submission order so shared points are computed exactly as a
     sequential `Session.run` series would compute them. `transient`
     nodes union the same way per (sim_steps, solver, precision,
     parasitics) — the layout tier's extracted-parasitics runs never
     mix batches with hand-modeled ones.
  4. execute: remaining nodes run dependencies-first, consulting the
     session caches and the on-disk artifact store
     (`api.store`) before any device work, persisting fresh
     artifacts after;
  5. compose + resolve: each query's host-side compose step assembles
     its Result from the node outputs; failures (plan, node, or
     compose) resolve ONLY the futures that depend on them — the rest
     of the wave completes.

Results are bit-identical to running the same queries sequentially
through the eager path: node evaluation goes through the same
primitives (`dse_batch.evaluate_batch`, `char_batch.characterize`,
`dse_batch.evaluate_vdd_lattice`, ...) whose per-point algebra is
elementwise, so union batching cannot perturb any point's value —
asserted in tests/test_torch_api.py.

The `geom` node (layout tier) verifies geometry on the host (numpy,
`geom.verify.verify_bank`). The `optimize` node runs
`optim.dse_opt.optimize` on the session's device; unlike the
reference, it also files its result dict in the artifact store, so a
session on a store another session wrote recomputes no optimization.

Single-threaded by design: `flush()` (and therefore `Future.result()`
on a pending future) runs the wave on the calling thread under a lock.
`submit` is safe to call from other threads.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional

from repro_torch.api import plan as plan_mod
from repro_torch.api.plan import Node
from repro_torch.core import compiler as compiler_mod
from repro_torch.core import dse
from repro_torch.core import dse_batch
from repro_torch.core.spice import char_batch

__all__ = ["Executor", "QueryFuture"]


class QueryFuture:
    """Handle for one submitted query. `result()` / `exception()` on a
    still-pending future flush the executor's queue first, so a lone
    submit-then-result behaves exactly like an eager run."""

    __slots__ = ("_executor", "query", "_done", "_result", "_error")

    def __init__(self, executor: "Executor", query):
        self._executor = executor
        self.query = query
        self._done = False
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._executor.flush()
        if not self._done:             # belt: flush resolves every
            raise RuntimeError(        # future, even on wave failure
                f"query future for {type(self.query).__name__} was "
                "never resolved")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self) -> Optional[BaseException]:
        if not self._done:
            self._executor.flush()
        return self._error

    def _set(self, result=None, error=None):
        self._result, self._error, self._done = result, error, True


class Executor:
    def __init__(self, session):
        self.session = session
        self._pending: List[tuple] = []
        self._lock = threading.RLock()
        # keys known present in the store (avoids re-stat + re-put)
        self._persisted = set()
        # keys whose stored artifact this process found corrupt (torn
        # write, bit-rot, schema mismatch): their recompute is a HEAL,
        # not a duplicate evaluation — see LeaseManager.log_eval
        self._healed = set()
        self.stats = Counter()

    # ------------------------------------------------------------------
    # lease plumbing (fleet mode: session.leases is a LeaseManager)
    # ------------------------------------------------------------------
    @property
    def _leases(self):
        s = self.session
        return s.leases if s.store is not None else None

    def _eval_reason(self, lease, key: str) -> str:
        if lease is not None and lease.stolen:
            return "steal"
        return "heal" if key in self._healed else "fresh"

    def _log_eval(self, lease, key: str) -> None:
        leases = self._leases
        if leases is not None:
            leases.log_eval(key, self._eval_reason(lease, key))

    # ------------------------------------------------------------------
    # submission API (surfaced as Session.submit / run_many / run)
    # ------------------------------------------------------------------
    def submit(self, query) -> QueryFuture:
        fut = QueryFuture(self, query)
        with self._lock:
            self._pending.append((query, fut))
        return fut

    def flush(self) -> None:
        """Drain the queue: one admission wave over everything pending.
        A wave can never strand a future: anything that escapes the
        per-query/per-node handling resolves every unresolved future of
        the wave with the error (surfaced through the futures, the
        contract of this API)."""
        with self._lock:
            pending, self._pending = self._pending, []
            if not pending:
                return
            try:
                self._run_wave(pending)
            except Exception as e:                       # noqa: BLE001
                for _, fut in pending:
                    if not fut.done():
                        fut._set(error=e)

    def run_one(self, query):
        """Eagerly execute one PLANNABLE query (submit + flush +
        result). Multi-query submission lives on Session.run_many,
        which also handles legacy run()-override queries — there is
        deliberately no executor-side duplicate of that loop."""
        fut = self.submit(query)
        self.flush()
        return fut.result()

    # ------------------------------------------------------------------
    # wave execution
    # ------------------------------------------------------------------
    def _run_wave(self, pending) -> None:
        s = self.session
        jobs = []
        for query, fut in pending:
            try:
                cached = s._result_cache_get(query)
                if cached is not None:
                    self.stats["result_cache_hits"] += 1
                    fut._set(result=cached)
                    continue
                jobs.append((query, fut, plan_mod.plan_query(s, query)))
            except Exception as e:                       # noqa: BLE001
                fut._set(error=e)
        if not jobs:
            return
        self.stats["waves"] += 1
        self.stats["queries"] += len(jobs)

        # dedupe nodes by content key, preserving submission order
        nodes: Dict[str, Node] = {}
        for _, _, p in jobs:
            for n in p.nodes:
                if n.key in nodes:
                    self.stats["nodes_coalesced"] += 1
                else:
                    nodes[n.key] = n
        self.stats["nodes_executed"] += len(nodes)

        out: Dict[str, object] = {}
        err: Dict[str, BaseException] = {}
        self._coalesce_points([n for n in nodes.values()
                               if n.kind == "points"], err)
        self._coalesce_transient([n for n in nodes.values()
                                  if n.kind == "transient"], err)
        for n in nodes.values():
            if n.key in err:
                continue
            try:
                out[n.key] = self._exec_node(n, out, err)
            except Exception as e:                       # noqa: BLE001
                err[n.key] = e

        for query, fut, p in jobs:
            try:
                # an earlier duplicate in this same wave may have
                # composed already — resolve to the identical object,
                # exactly like the sequential path would
                cached = s._result_cache_get(query)
                if cached is not None:
                    self.stats["result_cache_hits"] += 1
                    fut._set(result=cached)
                    continue
                bad = next((err[n.key] for n in p.nodes if n.key in err),
                           None)
                if bad is not None:
                    raise bad
                res = p.compose(s, out)
                s._result_cache_put(query, res)
                fut._set(result=res)
            except Exception as e:                       # noqa: BLE001
                fut._set(error=e)

    # ------------------------------------------------------------------
    # cross-query coalescing of lattice evaluation
    # ------------------------------------------------------------------
    def _coalesce_points(self, pnodes: List[Node], err: dict) -> None:
        """Union every points node's still-missing configs into one
        device batch per evaluation mode. Submission order decides which
        node CLAIMS a shared config (and with which mode) — the same
        config the same position in the sequential-run order would have
        computed it with.

        With a LeaseManager attached (fleet mode), each node whose
        artifact is missing is first CLAIMED: nodes whose lease a live
        foreign worker holds are deferred, and only waited on AFTER our
        own claims are evaluated and published — no worker ever blocks
        while holding unpublished work, which keeps the lease protocol
        deadlock-free."""
        s = self.session
        leases = self._leases
        claims = {True: [], False: []}      # batched? -> [cfg, ...]
        owners = {True: set(), False: set()}  # batched? -> {node key}
        claim_mode = {}                     # cfg key -> claiming mode
        held = {}                           # node key -> Lease
        waiting = []                        # [(node, missing)] foreign
        for n in pnodes:
            pkeys = [s._key(c) for c in n.cfgs]
            missing = [(c, k) for c, k in zip(n.cfgs, pkeys)
                       if k not in s._points]
            if missing:
                pts = self._store_decode(n.key, plan_mod.decode_points)
                for p in pts or ():
                    k = s._key(p.cfg)
                    if k not in s._points:
                        s._points[k] = p
                if pts:
                    missing = [(c, k) for c, k in missing
                               if k not in s._points]
            if missing and leases is not None:
                lease = leases.try_claim(n.key)
                if lease is None:           # live foreign owner: defer
                    waiting.append((n, missing))
                    continue
                held[n.key] = lease
            mode = bool(n.spec.get("batched", True))
            for c, k in missing:
                if k not in claim_mode:     # dedupe within + across nodes
                    claim_mode[k] = mode
                    claims[mode].append(c)
                # the node depends on WHOEVER claimed the config: if that
                # mode's evaluation fails, this node must carry the real
                # error, not a KeyError at output assembly
                owners[claim_mode[k]].add(n.key)
        if claims[True]:
            self.stats["eval_batch_calls"] += 1
            self.stats["points_evaluated"] += len(claims[True])
            try:
                pts = dse_batch.evaluate_batch(claims[True],
                                               device=s.device)
                for c, p in zip(claims[True], pts):
                    s._points[s._key(c)] = p
            except Exception as e:                       # noqa: BLE001
                for k in owners[True]:
                    err[k] = e
        if claims[False]:
            self.stats["points_evaluated"] += len(claims[False])
            try:
                for c in claims[False]:
                    self.stats["scalar_evals"] += 1
                    s._points[s._key(c)] = dse.evaluate(c,
                                                        device=s.device)
            except Exception as e:                       # noqa: BLE001
                for k in owners[False]:
                    err[k] = e
        if leases is None:
            return
        # publish everything we claimed (artifact first, then release
        # the lease), THEN wait on the foreign-held nodes
        for n in pnodes:
            lease = held.pop(n.key, None)
            if lease is None:
                continue
            try:
                if n.key not in err:
                    pts = [s._points[s._key(c)] for c in n.cfgs]
                    self._store_put(
                        n.key, lambda: plan_mod.encode_points(s, pts))
                    self._log_eval(lease, n.key)
            finally:
                lease.release()
        for n, missing in waiting:
            self._await_points(n, missing, err)

    def _await_points(self, n: Node, missing, err: dict) -> None:
        """A foreign worker holds this points node's lease: wait for its
        artifact, or steal the lease once it expires (the owner died
        mid-flight) and evaluate the node ourselves."""
        s = self.session

        def have():
            pts = self._store_decode(n.key, plan_mod.decode_points)
            if not pts:
                return None
            for p in pts:
                s._points.setdefault(s._key(p.cfg), p)
            return pts

        try:
            status, val = self._leases.acquire(n.key, have)
        except Exception as e:                           # noqa: BLE001
            err[n.key] = e
            return
        if status == "have":
            return
        lease = val
        try:
            cfgs = [c for c, k in missing if k not in s._points]
            if cfgs:
                self.stats["points_evaluated"] += len(cfgs)
                if bool(n.spec.get("batched", True)):
                    self.stats["eval_batch_calls"] += 1
                    pts = dse_batch.evaluate_batch(cfgs, device=s.device)
                else:
                    self.stats["scalar_evals"] += len(cfgs)
                    pts = [dse.evaluate(c, device=s.device) for c in cfgs]
                for c, p in zip(cfgs, pts):
                    s._points[s._key(c)] = p
            allpts = [s._points[s._key(c)] for c in n.cfgs]
            self._store_put(n.key,
                            lambda: plan_mod.encode_points(s, allpts))
            self._log_eval(lease, n.key)
        except Exception as e:                           # noqa: BLE001
            err[n.key] = e
        finally:
            lease.release()

    def _coalesce_transient(self, tnodes: List[Node], err: dict) -> None:
        s = self.session
        leases = self._leases
        # (steps, solver, precision, parasitics) -> [cfg]
        groups: Dict[tuple, list] = {}
        owners: Dict[tuple, set] = {}
        claimed = set()
        held = {}                             # node key -> Lease
        waiting = []                          # [(node, mode)] foreign
        for n in tnodes:
            mode = (n.spec["sim_steps"], n.spec["solver"],
                    n.spec.get("precision", "f64"),
                    n.spec.get("parasitics", "modeled"))
            tkeys = [(s._key(c),) + mode for c in n.cfgs]
            missing = [(c, tk) for c, tk in zip(n.cfgs, tkeys)
                       if tk not in s._tchars]
            if missing:
                chars = self._store_decode(n.key, plan_mod.decode_chars)
                if chars:
                    for c, ch in zip(n.cfgs, chars):
                        tk = (s._key(c),) + mode
                        if tk not in s._tchars:
                            s._tchars[tk] = ch
                    missing = [(c, tk) for c, tk in missing
                               if tk not in s._tchars]
            if missing and leases is not None:
                lease = leases.try_claim(n.key)
                if lease is None:             # live foreign owner: defer
                    waiting.append((n, mode))
                    continue
                held[n.key] = lease
            for c, tk in missing:
                if tk not in claimed:       # dedupe within + across nodes
                    claimed.add(tk)
                    groups.setdefault(mode, []).append(c)
                # transient claims share the node's (steps, solver) mode,
                # so the claiming group IS this mode's group — but the
                # node must still own it to inherit a group failure
                owners.setdefault(mode, set()).add(n.key)
        for mode, cfgs in groups.items():
            self.stats["char_calls"] += 1
            try:
                chars = char_batch.characterize(
                    cfgs, n_steps=mode[0], solver=mode[1],
                    precision=mode[2], parasitics=mode[3], device=s.device)
                for c, ch in zip(cfgs, chars):
                    s._tchars[(s._key(c),) + mode] = ch
            except Exception as e:                       # noqa: BLE001
                for k in owners[mode]:
                    err[k] = e
        if leases is None:
            return
        for n in tnodes:                      # publish, then wait
            lease = held.pop(n.key, None)
            if lease is None:
                continue
            try:
                if n.key not in err:
                    mode = (n.spec["sim_steps"], n.spec["solver"],
                            n.spec.get("precision", "f64"),
                            n.spec.get("parasitics", "modeled"))
                    chars = [s._tchars[(s._key(c),) + mode]
                             for c in n.cfgs]
                    self._store_put(
                        n.key, lambda: plan_mod.encode_chars(s, chars))
                    self._log_eval(lease, n.key)
            finally:
                lease.release()
        for n, mode in waiting:
            self._await_transient(n, mode, err)

    def _await_transient(self, n: Node, mode: tuple, err: dict) -> None:
        s = self.session

        def have():
            chars = self._store_decode(n.key, plan_mod.decode_chars)
            if not chars:
                return None
            for c, ch in zip(n.cfgs, chars):
                s._tchars.setdefault((s._key(c),) + mode, ch)
            return chars

        try:
            status, val = self._leases.acquire(n.key, have)
        except Exception as e:                           # noqa: BLE001
            err[n.key] = e
            return
        if status == "have":
            return
        lease = val
        try:
            cfgs = [c for c in n.cfgs
                    if (s._key(c),) + mode not in s._tchars]
            if cfgs:
                self.stats["char_calls"] += 1
                chars = char_batch.characterize(
                    cfgs, n_steps=mode[0], solver=mode[1],
                    precision=mode[2], parasitics=mode[3], device=s.device)
                for c, ch in zip(cfgs, chars):
                    s._tchars[(s._key(c),) + mode] = ch
            allchars = [s._tchars[(s._key(c),) + mode] for c in n.cfgs]
            self._store_put(n.key,
                            lambda: plan_mod.encode_chars(s, allchars))
            self._log_eval(lease, n.key)
        except Exception as e:                           # noqa: BLE001
            err[n.key] = e
        finally:
            lease.release()

    # ------------------------------------------------------------------
    # per-node execution
    # ------------------------------------------------------------------
    def _exec_node(self, n: Node, out: dict, err: dict):
        for d in n.deps:
            if d in err:
                raise err[d]
        s = self.session
        if n.kind == "points":
            pts = [s._points[s._key(c)] for c in n.cfgs]
            self._store_put(n.key, lambda: plan_mod.encode_points(s, pts))
            return pts
        if n.kind == "transient":
            mode = (n.spec["sim_steps"], n.spec["solver"],
                    n.spec.get("precision", "f64"),
                    n.spec.get("parasitics", "modeled"))
            chars = [s._tchars[(s._key(c),) + mode] for c in n.cfgs]
            self._store_put(n.key, lambda: plan_mod.encode_chars(s, chars))
            return chars
        if n.kind == "geom":
            n_seg = int(n.spec.get("n_seg", 8))
            missing = [c for c in n.cfgs
                       if (s._key(c), n_seg) not in s._geoms]
            if missing:
                reports = self._store_decode(n.key, plan_mod.decode_geoms)
                if reports:
                    for c, g in zip(n.cfgs, reports):
                        s._geoms.setdefault((s._key(c), n_seg), g)
                    missing = [c for c in missing
                               if (s._key(c), n_seg) not in s._geoms]
            if missing:
                from repro_torch.geom import verify as geom_verify
                self.stats["geom_verifies"] += len(missing)
                for c in missing:
                    s._geoms[(s._key(c), n_seg)] = \
                        geom_verify.verify_bank(c, n_seg=n_seg)
            geoms = [s._geoms[(s._key(c), n_seg)] for c in n.cfgs]
            self._store_put(n.key, lambda: plan_mod.encode_geoms(s, geoms))
            return geoms
        if n.kind == "vdd_lattice":
            return self.eval_vdd_lattice(n)
        if n.kind == "shmoo":
            self.stats["shmoo_calls"] += 1
            return dse_batch.shmoo_batch(
                out[n.deps[0]], list(n.spec["demands"]),
                allow_refresh=n.spec["allow_refresh"], device=s.device)
        if n.kind == "codesign_cube":
            self.stats["cube_calls"] += 1
            return dse_batch.codesign_metrics(
                out[n.deps[0]], list(n.spec["demands"]),
                list(n.spec["steps"]),
                allow_refresh=n.spec["allow_refresh"],
                max_banks=n.spec["max_banks"], device=s.device)
        if n.kind == "compile":
            cfg = n.cfgs[0]
            rkey = (s._key(cfg), n.spec["simulate"], n.spec["solver"])
            if rkey not in s._reports:
                self.stats["compile_calls"] += 1
                s._reports[rkey] = compiler_mod.compile_bank(
                    cfg, simulate=n.spec["simulate"],
                    solver=n.spec["solver"], device=s.device)
            return s._reports[rkey]
        if n.kind == "optimize":
            # the result dict is a pure function of the node key, so it
            # is stored like the other artifacts: a session on a store
            # another session wrote recomputes nothing
            got = self._store_decode(n.key, lambda s_, d: dict(d))
            if got is not None:
                return got
            self.stats["optimize_calls"] += 1
            sp = n.spec
            from repro_torch.optim import dse_opt
            r = dse_opt.optimize(
                n.cfgs[0], target_freq_hz=sp["target_freq_hz"],
                target_ret_s=sp["target_ret_s"],
                objective=sp["objective"], knobs=sp["knobs"],
                steps=sp["steps"], lr=sp["lr"],
                seed_vdd_scales=sp["seed_vdd_scales"],
                allow_refresh=sp["allow_refresh"],
                seed_lattice=out[n.deps[0]], device=s.device)
            got = r.as_dict()
            self._store_put(n.key, lambda: got)
            return got
        raise ValueError(f"unknown node kind {n.kind!r}")

    def eval_vdd_lattice(self, n: Node):
        """Execute one vdd_lattice node (session cache -> store ->
        evaluate, persisting fresh artifacts). Public on purpose: it is
        the sanctioned entry for the eager Session.vdd_lattice as well
        as the in-wave node executor, so both paths share one cache and
        store policy."""
        s = self.session
        sweep, scales = n.spec["sweep"], n.spec["vdd_scales"]
        vkey = s._vlattice_key(sweep, scales)
        lat = s._vlattices.get(vkey)
        lease = None
        if lat is None:
            lat = self._store_decode(n.key,
                                     plan_mod.decode_vdd_lattice)
            if lat is None and self._leases is not None:
                # fleet mode: claim the node (or wait for whoever holds
                # it to publish; steal if that owner died)
                status, val = self._leases.acquire(
                    n.key, lambda: self._store_decode(
                        n.key, plan_mod.decode_vdd_lattice))
                if status == "have":
                    lat = val
                else:
                    lease = val
        try:
            if lat is None:
                self.stats["vdd_evals"] += 1
                lat = dse_batch.evaluate_vdd_lattice(
                    sweep.configs(s.tech), scales, device=s.device)
                s._vlattices[vkey] = lat
                self._store_put(
                    n.key, lambda: plan_mod.encode_vdd_lattice(s, lat))
                if lease is not None:
                    self._log_eval(lease, n.key)
                return lat
            s._vlattices[vkey] = lat
            self._store_put(n.key,
                            lambda: plan_mod.encode_vdd_lattice(s, lat))
            return lat
        finally:
            if lease is not None:
                lease.release()

    # ------------------------------------------------------------------
    # store plumbing
    # ------------------------------------------------------------------
    def _store_get(self, key: str):
        store = self.session.store
        if store is None:
            return None
        before = store.corrupt
        data = store.get(key)
        if data is not None:
            self._persisted.add(key)
            self.stats["store_hits"] += 1
        elif store.corrupt > before:
            # the entry existed but was torn/bit-rotted: the recompute
            # that follows is a store HEAL, not a duplicate evaluation
            self._healed.add(key)
            self.stats["store_heals"] += 1
        return data

    def _store_decode(self, key: str, decode):
        """Fetch + decode one artifact; a checksum-valid entry that no
        longer decodes (e.g. written by a different code version)
        degrades to a miss-and-recompute, never a wave failure."""
        data = self._store_get(key)
        if data is None:
            return None
        s = self.session
        try:
            return decode(s, data)
        except Exception:                                # noqa: BLE001
            self.stats["store_hits"] -= 1
            self.stats["store_decode_errors"] += 1
            self._persisted.discard(key)    # the recompute rewrites it
            self._healed.add(key)           # schema heal, not duplicate
            if s.store is not None:
                s.store.drop(key)
            return None

    def _store_put(self, key: str, make) -> None:
        store = self.session.store
        if store is None or key in self._persisted:
            return
        if not store.has(key):
            store.put(key, make())
        self._persisted.add(key)
