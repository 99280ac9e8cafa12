"""Fault-tolerant multi-worker compile fleet (port of
`repro.launch.fleet`).

`repro_torch.launch.compile_service` is one process draining admission waves;
this module is the FLEET around it: a dispatcher shards queued JSON
query requests across N `CompileService` worker subprocesses over a
spool directory, and survives the failures a fleet actually has —
crashed workers, hung waves, torn artifacts, poison requests.

Topology (everything is plain files, so any worker on any host sharing
the filesystem can join):

    spool/
      w0/inbox/<rid>.json    per-worker request shards (atomic writes)
      outbox/<rid>.json      responses, any worker -> dispatcher
      stats/<wid>.json       terminal worker stats (graceful exit), with
                             the worker's kernel launches
      ready/<wid>.json       a worker's pid, device and cold-start times
      stop                   global shutdown flag
    store/                   shared content-addressed ArtifactStore
      _leases/               claim files + the evaluation log

Failure handling, layer by layer:

  * **no duplicate work**: every worker session runs with a
    `repro_torch.api.leases.LeaseManager` over the shared store, so a lattice
    evaluation is computed by exactly one worker no matter how requests
    shard; the rest read the published artifact. A crashed worker's
    claims expire after one lease TTL and are STOLEN — in-flight nodes
    are reclaimed, not lost.
  * **deadlines**: a request with no response within `deadline_s` is
    re-dispatched to another worker (the slow worker's eventual
    response is still accepted if it arrives first).
  * **bounded retry**: worker death and retryable (node-evaluation)
    failures re-queue the request with exponential backoff; after
    `max_attempts` dispatches the request is QUARANTINED — it resolves
    with a structured ``{"ok": false, "error": ..., "attempts": K,
    "quarantined": true}`` response instead of wedging the fleet.
    Deterministic failures (bad JSON, invalid queries) are returned
    immediately, as the single service would.
  * **graceful degradation**: if no worker subprocess can start — or
    every worker dies mid-run — the dispatcher finishes the workload
    through an in-process `CompileService` with the same retry and
    quarantine semantics. Its results are still correct, so a caller
    that needs the workers (a check that the card served the fleet)
    reads `Fleet.degraded` and the spawn/death counters.

Devices: every worker and the in-process fallback evaluate on the
fleet's `device`, the card unless the caller passes `device="cpu"`
(`--device cpu`). Workers are fresh interpreters started with
`subprocess.Popen`, never forked, so each builds its own CUDA context;
on the card a worker creates it, and loads the service's kernels (the
fused-Newton scan and Gauss-Jordan libraries), before it takes work,
and records how long each took in `ready/<wid>.json`.

CLI (dispatcher):

    PYTHONPATH=src python -m repro_torch.launch.fleet \
        --input requests.jsonl --workers 3 \
        --spool /tmp/gcram-spool --store /tmp/gcram-store [--device cpu]

Workers are spawned as `python -m repro_torch.launch.fleet --worker ...
--device <dev>`; `--faults "seed=7,tear_rate=0.3,..."` arms the
deterministic chaos harness (`repro_torch.testing.faults`) inside a
worker — used by the chaos tests.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.techfile import SYN40

__all__ = ["Fleet", "worker_main"]

_RID_RE = re.compile(r"^r(\d+)-(\d+)\.(\d+)$")


def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=str)
    os.replace(tmp, path)


def _src_pythonpath() -> str:
    """PYTHONPATH entry that makes `repro_torch` importable in workers,
    regardless of the dispatcher's cwd."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    current = os.environ.get("PYTHONPATH", "")
    return src + (os.pathsep + current if current else "")


# ---------------------------------------------------------------------------
# worker subprocess
# ---------------------------------------------------------------------------

def _cold_start(device: str) -> dict:
    """Import torch and, on a CUDA device, create this process's context
    and load the service's kernel libraries; seconds of each step."""
    t0 = time.perf_counter()
    import torch
    out = {"torch_import_s": time.perf_counter() - t0}
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        out["cuda_context_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name in ("fused_newton", "gauss_jordan"):
            build.load(name)
        out["kernel_load_s"] = time.perf_counter() - t0
    return out


def _launch_counts() -> dict:
    """This process's launches of the service's kernels, from the
    wrappers' counters (0 on the CPU, where no kernel launches)."""
    from repro_torch.kernels.batched_solve import fused
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    return {"fused_newton_scan": fused.fused_newton_scan.launches,
            "fused_newton": fused.fused_newton.launches,
            "gauss_jordan": batched_solve.launches}


def worker_main(spool: str, wid: str, store_dir: str,
                wave_size: int = 16, lease_ttl_s: float = 10.0,
                faults: str = "", poll_s: float = 0.02,
                tech=SYN40, device: str = "cuda") -> int:
    """One fleet worker: scan the inbox shard, drain each batch as one
    `CompileService` admission wave against the SHARED leased store,
    publish responses atomically to the outbox. Exits on the spool's
    `stop` flag."""
    cold = _cold_start(device)
    from repro_torch.api import Session
    from repro_torch.api.leases import LeaseManager
    from repro_torch.api.store import ArtifactStore
    from repro_torch.launch.compile_service import CompileService
    from repro_torch.testing.faults import (FaultInjector, FaultSpec,
                                            InjectedFault)

    inbox = os.path.join(spool, wid, "inbox")
    outbox = os.path.join(spool, "outbox")
    stats_dir = os.path.join(spool, "stats")
    ready_dir = os.path.join(spool, "ready")
    stop_flag = os.path.join(spool, "stop")
    for d in (inbox, outbox, stats_dir, ready_dir):
        os.makedirs(d, exist_ok=True)

    store = ArtifactStore(store_dir)
    store.sweep_tmp()                 # droppings of previously killed writers
    leases = LeaseManager(store_dir, owner=wid, ttl_s=lease_ttl_s)
    session = Session(tech, store=store, leases=leases, device=device)
    svc = CompileService(session=session, wave_size=wave_size)
    _atomic_json(os.path.join(ready_dir, f"{wid}.json"), {
        "worker": wid, "pid": os.getpid(), "device": device,
        "t_ready": time.time(), "cold_start": cold})
    injector = None
    if faults:
        spec = FaultSpec.parse(faults)
        if spec.any_faults():
            injector = FaultInjector(spec).install(store=store, evals=True)

    while not os.path.exists(stop_flag):
        names = sorted(f for f in os.listdir(inbox)
                       if f.endswith(".json"))[:wave_size]
        if not names:
            time.sleep(poll_s)
            continue
        batch = []
        for name in names:
            try:
                with open(os.path.join(inbox, name)) as f:
                    batch.append((name, json.load(f)))
            except (OSError, ValueError):
                continue              # vanished mid-scan; re-listed next loop
        ready, responses = [], []
        for name, req in batch:
            if injector is not None:
                try:
                    injector.check_request(req)
                except InjectedFault as e:
                    responses.append((name, {
                        "id": req.get("id"),
                        "tenant": req.get("tenant", "anonymous"),
                        "ok": False, "error": f"InjectedFault: {e}",
                        "retryable": True}))
                    continue
            svc.submit(req)
            ready.append(name)
        if ready:                      # one admission wave for the shard
            responses.extend(zip(ready, svc.drain()))
        for name, resp in responses:
            _atomic_json(os.path.join(outbox, name), resp)
            try:
                os.unlink(os.path.join(inbox, name))
            except OSError:
                pass
    _atomic_json(os.path.join(stats_dir, f"{wid}.json"), {
        "worker": wid, "service": svc.stats(), "leases": leases.stats(),
        "faults": dict(injector.counts) if injector is not None else {},
        "launches": _launch_counts()})
    return 0


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

@dataclass
class _Worker:
    wid: str
    inbox: str
    proc: Optional[subprocess.Popen] = None
    alive: bool = False
    t_spawn: float = 0.0              # wall clock at Popen


@dataclass
class _Req:
    idx: int
    req: dict
    status: str = "queued"            # queued | inflight | done
    attempts: int = 0                 # dispatches tried so far
    worker: Optional[_Worker] = None
    rid: str = ""
    due: float = 0.0                  # monotonic: earliest (re)dispatch
    dispatched: float = 0.0           # monotonic: last dispatch time
    last_error: str = ""
    response: Optional[dict] = None


class Fleet:
    """Dispatcher for N compile-service worker subprocesses.

    `run(requests)` returns one response per request, in request order,
    every one resolved — success, deterministic error, or structured
    quarantine. Use as a context manager (`with Fleet(...) as f:`) so
    workers are always stopped and their stats collected."""

    def __init__(self, spool: str, store: Optional[str],
                 n_workers: int = 2, wave_size: int = 16,
                 deadline_s: float = 120.0, max_attempts: int = 5,
                 backoff_s: float = 0.25, lease_ttl_s: float = 5.0,
                 poll_s: float = 0.02,
                 fault_specs: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None, tech=SYN40,
                 device: str = "cuda"):
        self.spool = os.fspath(spool)
        self.store_dir = os.fspath(store) if store is not None else None
        self.n_workers = int(n_workers)
        self.wave_size = int(wave_size)
        self.deadline_s = float(deadline_s)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.lease_ttl_s = float(lease_ttl_s)
        self.poll_s = float(poll_s)
        self.fault_specs = dict(fault_specs or {})
        self.python = python or sys.executable
        self.tech = tech
        self.device = str(device)
        self.workers: List[_Worker] = []
        self.degraded = False
        self.counters: Counter = Counter()
        self.worker_stats: Dict[str, dict] = {}
        self._started = False
        self._rr = 0
        self._run_seq = 0
        self._inline_svc = None
        self._inline_injector = None
        self.outbox = os.path.join(self.spool, "outbox")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Fleet":
        if self._started:
            return self
        self._started = True
        os.makedirs(self.outbox, exist_ok=True)
        os.makedirs(os.path.join(self.spool, "stats"), exist_ok=True)
        env = dict(os.environ, PYTHONPATH=_src_pythonpath())
        logs = os.path.join(self.spool, "logs")
        os.makedirs(logs, exist_ok=True)
        for i in range(self.n_workers):
            wid = f"w{i}"
            inbox = os.path.join(self.spool, wid, "inbox")
            os.makedirs(inbox, exist_ok=True)
            cmd = [self.python, "-m", "repro_torch.launch.fleet",
                   "--worker", "--spool", self.spool, "--worker-id", wid,
                   "--store", self.store_dir or "",
                   "--wave-size", str(self.wave_size),
                   "--lease-ttl", str(self.lease_ttl_s),
                   "--device", self.device]
            spec = self.fault_specs.get(wid)
            if spec:
                cmd += ["--faults", spec]
            w = _Worker(wid, inbox)
            try:
                log = open(os.path.join(logs, f"{wid}.log"), "w")
                w.t_spawn = time.time()
                w.proc = subprocess.Popen(
                    cmd, env=env, stdout=log, stderr=log,
                    stdin=subprocess.DEVNULL)
                w.alive = True
            except OSError as e:
                self.counters["spawn_failures"] += 1
                w.alive = False
                w.proc = None
                self.counters[f"spawn_error_{type(e).__name__}"] += 1
            self.workers.append(w)
        if not any(w.alive for w in self.workers):
            # no subprocess could start: single-worker in-process mode
            self.degraded = True
        return self

    def stop(self) -> None:
        if not self._started:
            return
        try:
            with open(os.path.join(self.spool, "stop"), "w") as f:
                f.write("stop\n")
        except OSError:
            pass
        for w in self.workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
            w.alive = False
        stats_dir = os.path.join(self.spool, "stats")
        for w in self.workers:
            path = os.path.join(stats_dir, f"{w.wid}.json")
            try:
                with open(path) as f:
                    self.worker_stats[w.wid] = json.load(f)
            except (OSError, ValueError):
                pass                  # killed workers leave no stats

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def ready(self) -> Dict[str, dict]:
        """The workers that have finished their cold start: wid -> their
        `ready/<wid>.json` (pid, device, cold-start seconds) plus
        `spawn_to_ready_s`, the wall from Popen to ready."""
        out = {}
        for w in self.workers:
            path = os.path.join(self.spool, "ready", f"{w.wid}.json")
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            out[w.wid] = dict(rec, spawn_to_ready_s=rec["t_ready"]
                              - w.t_spawn)
        return out

    def kill_worker(self, i: int) -> None:
        """SIGKILL worker i (chaos testing: a crash, not a shutdown)."""
        w = self.workers[i]
        if w.proc is not None and w.proc.poll() is None:
            w.proc.kill()

    def _live(self) -> List[_Worker]:
        return [w for w in self.workers if w.alive]

    # -- the run loop --------------------------------------------------
    def run(self, requests, timeout_s: float = 600.0) -> List[dict]:
        self.start()
        self._run_seq += 1
        states = [_Req(i, dict(r)) for i, r in enumerate(requests)]
        if self.degraded:
            self.counters["degraded_runs"] += 1
            self._run_inline(states)
            return [st.response for st in states]
        now = time.monotonic()
        for st in states:
            st.due = now
        t_end = now + float(timeout_s)
        seen: set = set()
        while any(st.status != "done" for st in states):
            now = time.monotonic()
            if now > t_end:
                self.counters["run_timeouts"] += 1
                for st in states:
                    if st.status != "done":
                        self._quarantine(
                            st, f"fleet run timed out after {timeout_s}s")
                break
            self._collect(states, seen)
            self._check_liveness(states)
            if not self._live():
                # every worker died: finish in-process
                self.degraded = True
                self.counters["degraded_runs"] += 1
                self._run_inline([st for st in states
                                  if st.status != "done"])
                continue
            self._check_deadlines(states)
            self._dispatch_due(states)
            time.sleep(self.poll_s)
        return [st.response for st in states]

    # -- run-loop pieces -----------------------------------------------
    def _collect(self, states: List[_Req], seen: set) -> None:
        try:
            names = os.listdir(self.outbox)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json") or name in seen:
                continue
            seen.add(name)
            m = _RID_RE.match(name[:-5])
            if not m or int(m.group(1)) != self._run_seq:
                continue              # stale response from an earlier run
            idx, attempt = int(m.group(2)), int(m.group(3))
            if idx >= len(states):
                continue
            st = states[idx]
            if st.status == "done":
                continue
            try:
                with open(os.path.join(self.outbox, name)) as f:
                    resp = json.load(f)
            except (OSError, ValueError):
                seen.discard(name)    # mid-write; retry next poll
                continue
            if resp.get("ok") or not resp.get("retryable"):
                # success and deterministic errors resolve from ANY
                # attempt (results are content-addressed: a late
                # duplicate is bit-identical)
                st.response = {**resp, "attempts": st.attempts}
                st.status = "done"
                self.counters["resolved"] += 1
            elif attempt == st.attempts and st.status == "inflight":
                self._fail(st, resp.get("error", "worker error"))

    def _check_liveness(self, states: List[_Req]) -> None:
        for w in self.workers:
            if not w.alive or w.proc is None:
                continue
            if w.proc.poll() is None:
                continue
            w.alive = False
            self.counters["worker_deaths"] += 1
            for st in states:
                if st.status == "inflight" and st.worker is w:
                    self._fail(st, f"worker {w.wid} died "
                                   f"(exit {w.proc.returncode})")

    def _check_deadlines(self, states: List[_Req]) -> None:
        now = time.monotonic()
        for st in states:
            if st.status == "inflight" and \
                    now - st.dispatched > self.deadline_s:
                self.counters["deadline_expiries"] += 1
                self._fail(st, f"deadline {self.deadline_s}s exceeded "
                               f"on {st.worker.wid if st.worker else '?'}")

    def _dispatch_due(self, states: List[_Req]) -> None:
        now = time.monotonic()
        live = self._live()
        if not live:
            return
        for st in states:
            if st.status != "queued" or st.due > now:
                continue
            w = live[self._rr % len(live)]
            self._rr += 1
            st.attempts += 1
            st.rid = f"r{self._run_seq}-{st.idx:05d}.{st.attempts}"
            _atomic_json(os.path.join(w.inbox, st.rid + ".json"), st.req)
            st.worker = w
            st.status = "inflight"
            st.dispatched = time.monotonic()
            self.counters["dispatched"] += 1

    def _fail(self, st: _Req, error: str) -> None:
        st.last_error = error
        if st.attempts >= self.max_attempts:
            self._quarantine(st, error)
            return
        self.counters["retries"] += 1
        st.status = "queued"
        st.worker = None
        st.due = time.monotonic() + \
            self.backoff_s * (2 ** max(0, st.attempts - 1))

    def _quarantine(self, st: _Req, error: str) -> None:
        """A request that keeps failing gets a structured terminal
        response — the fleet never wedges on a poison request."""
        st.response = {"id": st.req.get("id"),
                       "tenant": st.req.get("tenant", "anonymous"),
                       "ok": False, "error": error,
                       "attempts": st.attempts, "quarantined": True}
        st.status = "done"
        self.counters["quarantined"] += 1

    # -- degraded in-process mode --------------------------------------
    def _inline(self):
        if self._inline_svc is None:
            from repro_torch.api import Session
            from repro_torch.api.leases import LeaseManager
            from repro_torch.launch.compile_service import CompileService
            from repro_torch.testing.faults import FaultInjector, FaultSpec
            leases = LeaseManager(self.store_dir, owner="inline",
                                  ttl_s=self.lease_ttl_s) \
                if self.store_dir else None
            session = Session(self.tech, store=self.store_dir,
                              leases=leases, device=self.device)
            self._inline_svc = CompileService(session=session,
                                              wave_size=self.wave_size)
            spec_str = self.fault_specs.get("inline", "")
            if spec_str:
                spec = FaultSpec.parse(spec_str)
                if spec.any_faults():
                    self._inline_injector = FaultInjector(spec).install(
                        store=session.store, evals=True)
        return self._inline_svc

    def _run_inline(self, states: List[_Req]) -> None:
        """Single-worker in-process fallback with the same bounded
        retry + quarantine semantics as the subprocess path."""
        from repro_torch.testing.faults import InjectedFault
        svc = self._inline()
        for st in states:
            if st.status == "done":
                continue
            while True:
                st.attempts += 1
                self.counters["dispatched"] += 1
                resp = None
                if self._inline_injector is not None:
                    try:
                        self._inline_injector.check_request(st.req)
                    except InjectedFault as e:
                        resp = {"id": st.req.get("id"),
                                "tenant": st.req.get("tenant",
                                                     "anonymous"),
                                "ok": False,
                                "error": f"InjectedFault: {e}",
                                "retryable": True}
                if resp is None:
                    svc.submit(st.req)
                    resp = svc.drain()[0]
                if resp.get("ok") or not resp.get("retryable"):
                    st.response = {**resp, "attempts": st.attempts}
                    st.status = "done"
                    self.counters["resolved"] += 1
                    break
                if st.attempts >= self.max_attempts:
                    self._quarantine(st, resp.get("error", "error"))
                    break
                self.counters["retries"] += 1
                time.sleep(min(
                    self.backoff_s * (2 ** max(0, st.attempts - 1)),
                    2.0))

    # -- accounting ----------------------------------------------------
    def eval_summary(self) -> dict:
        """Evaluation accounting across ALL workers, from the shared
        lease log: unique keys, evaluations by reason, and any key
        fresh-evaluated more than once (the fleet invariant is that
        `duplicates` is empty)."""
        from repro_torch.api.leases import LeaseManager
        if not self.store_dir:
            return {"unique_keys": 0, "by_reason": {}, "duplicates": {}}
        counts = LeaseManager.read_eval_log(self.store_dir)
        by_reason: Counter = Counter()
        for c in counts.values():
            by_reason.update(c)
        return {"unique_keys": len(counts),
                "by_reason": dict(by_reason),
                "duplicates": LeaseManager.duplicate_evals(
                    self.store_dir)}

    def stats(self) -> dict:
        return {"n_workers": self.n_workers, "degraded": self.degraded,
                **{k: self.counters[k] for k in sorted(self.counters)},
                "evals": self.eval_summary(),
                "workers": self.worker_stats}


# ---------------------------------------------------------------------------
# CLI: dispatcher by default, --worker for the subprocess entry
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true",
                    help="run as a fleet worker (internal)")
    ap.add_argument("--spool", required=True)
    ap.add_argument("--store", default=None)
    ap.add_argument("--worker-id", default="w0")
    ap.add_argument("--wave-size", type=int, default=16)
    ap.add_argument("--lease-ttl", type=float, default=10.0)
    ap.add_argument("--faults", default="",
                    help="FaultSpec string, e.g. seed=7,tear_rate=0.3")
    ap.add_argument("--input", default="-",
                    help="JSONL request file, or - for stdin")
    ap.add_argument("--output", default="-")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--deadline", type=float, default=120.0)
    ap.add_argument("--max-attempts", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="device of every evaluation (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.worker:
        if not args.store:
            ap.error("--worker requires --store")
        return worker_main(args.spool, args.worker_id, args.store,
                           wave_size=args.wave_size,
                           lease_ttl_s=args.lease_ttl,
                           faults=args.faults, device=args.device)
    src = sys.stdin if args.input == "-" else open(args.input)
    try:
        requests = [json.loads(line) for line in src if line.strip()]
    finally:
        if src is not sys.stdin:
            src.close()
    with Fleet(args.spool, args.store, n_workers=args.workers,
               wave_size=args.wave_size, deadline_s=args.deadline,
               max_attempts=args.max_attempts,
               lease_ttl_s=args.lease_ttl, device=args.device) as fleet:
        responses = fleet.run(requests)
        stats = fleet.stats()
    dst = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for resp in responses:
            dst.write(json.dumps(resp, default=str) + "\n")
    finally:
        if dst is not sys.stdout:
            dst.close()
    print(json.dumps(stats, default=str), file=sys.stderr)
    return 0 if all(r.get("ok") for r in responses) else 1


if __name__ == "__main__":
    raise SystemExit(main())
