"""Multi-tenant GCRAM compile service over the coalescing executor
(port of `repro.launch.compile_service`).

The query API (`repro_torch.api`) is in-process; this module is the
PROCESS-LEVEL front end the ROADMAP's production story needs: many
tenants (DSE jobs, co-design agents, CI) post JSON query requests onto
one queue, and a single session drains them in ADMISSION WAVES through
`Session.run_many` — so concurrently submitted queries coalesce
(identical plan nodes execute once, distinct lattice evaluations union
into one padded device batch) and, with `--store`, every artifact
lands in the shared content-addressed on-disk cache where the next
service process (or any other session) finds it.

Request (one JSON object per line; `id` echoes back, `tenant` is
accounting only — isolation is by content, not by tenant):

    {"id": "r1", "tenant": "teamA",
     "query": {"type": "sweep", "cells": ["gc2t_nn"],
               "word_sizes": [16, 32], "num_words": [16, 32]}}

`type` is one of compile | sweep | match | codesign | optimize, with
fields mirroring the Query dataclasses (demands as dicts, codesign
profiles as {"arch", "shape"} pairs resolved via the workload
profiler). Responses stream back one JSON line per request, in request
order per wave:

    {"id": "r1", "tenant": "teamA", "ok": true, "wave": 0,
     "result": {...Result.as_dict()...}}

Errors (bad JSON, unknown type, invalid query construction, node
failures) resolve ONLY the offending request — the rest of the wave
completes: {"ok": false, "error": "..."}.

Every evaluation runs on the service's device: the card unless the
caller passes `device="cpu"` (`--device cpu`). On the card a
`fidelity: "transient"` sweep runs one fused-Newton scan launch per
topology group, and a `compile` with `simulate: true, solver: "pallas"`
runs each Newton solve through the Gauss-Jordan kernel.

CLI:

    PYTHONPATH=src python -m repro_torch.launch.compile_service \
        --input requests.jsonl --wave-size 64 --store /tmp/gcram-store \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from typing import Iterable, Iterator, List, Optional

from repro_torch.api import Session
from repro_torch.api.queries import (CoDesignQuery, CompileQuery,
                                     MatchQuery, OptimizeQuery, Query,
                                     SweepQuery)
from repro_torch.core.bank import BankConfig
from repro_torch.core.dse import Demand
from repro_torch.core.techfile import SYN40

__all__ = ["CompileService", "parse_query"]


# ---------------------------------------------------------------------------
# JSON -> Query
# ---------------------------------------------------------------------------

_SWEEP_TUPLES = ("cells", "word_sizes", "num_words", "write_vts", "wwlls")
_SWEEP_SCALARS = ("batched", "fidelity", "sim_steps", "solver",
                  "precision")


def _parse_sweep(spec: dict) -> SweepQuery:
    kw = {}
    for f in _SWEEP_TUPLES:
        if f in spec:
            kw[f] = tuple(spec[f])
    for f in _SWEEP_SCALARS:
        if f in spec:
            kw[f] = spec[f]
    return SweepQuery(**kw)


def _parse_demand(spec: dict) -> Demand:
    return Demand(spec["name"], spec["level"],
                  float(spec["read_freq_hz"]), float(spec["lifetime_s"]),
                  int(spec.get("capacity_bits", 0)))


def _parse_cfg(spec: dict, tech) -> BankConfig:
    kw = {k: spec[k] for k in ("word_size", "num_words", "cell",
                               "write_vt", "wwlls", "wwl_boost")
          if k in spec}
    return BankConfig(tech=tech, **kw)


def parse_query(spec: dict, tech=SYN40) -> Query:
    """One request's `query` object -> the matching frozen Query.
    Validation happens in the Query constructors themselves, so an
    invalid request fails here — before it is queued or coalesced."""
    kind = spec.get("type")
    if kind == "sweep":
        return _parse_sweep(spec)
    if kind == "compile":
        return CompileQuery(_parse_cfg(spec.get("cfg", {}), tech),
                            simulate=bool(spec.get("simulate", False)),
                            solver=spec.get("solver", "jnp"))
    if kind == "match":
        return MatchQuery(
            tuple(_parse_demand(d) for d in spec.get("demands", ())),
            _parse_sweep(spec.get("sweep", {})),
            allow_refresh=bool(spec.get("allow_refresh", True)),
            max_banks=int(spec.get("max_banks", 1024)))
    if kind == "codesign":
        from repro_torch.workloads.profiler import profile_arch
        profiles = tuple(profile_arch(p["arch"], p["shape"])
                         for p in spec.get("profiles", ()))
        kw = {}
        if "vdd_scales" in spec:
            kw["vdd_scales"] = tuple(spec["vdd_scales"])
        return CoDesignQuery(
            profiles, _parse_sweep(spec.get("sweep", {})),
            allow_refresh=bool(spec.get("allow_refresh", True)),
            max_banks=int(spec.get("max_banks", 1024)),
            objective=spec.get("objective", "energy"), **kw)
    if kind == "optimize":
        kw = {k: spec[k] for k in ("cell", "target_ret_s",
                                   "target_freq_hz", "steps", "lr")
              if k in spec}
        return OptimizeQuery(**kw)
    raise ValueError(f"unknown query type {kind!r} (compile | sweep | "
                     "match | codesign | optimize)")


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class CompileService:
    """One coalescing Session behind a thread-safe request queue.

    `submit(request)` enqueues (any thread); `drain()` pops everything
    available — up to `wave_size` requests — and runs it as ONE
    admission wave, returning the JSON-able responses in request order.
    Tenants share all artifact caches by content, which is safe because
    node keys hash the full evaluation payload (tech + lattice-shaping
    fields): a tenant can only ever hit cache entries it would have
    computed identically itself."""

    def __init__(self, session: Optional[Session] = None, tech=SYN40,
                 store=None, wave_size: int = 64, device="cuda"):
        self.session = session if session is not None \
            else Session(tech, store=store, device=device)
        self.wave_size = int(wave_size)
        self.queue: "queue.Queue[dict]" = queue.Queue()
        self.waves = 0
        self.tenants: dict = {}
        # notified on every submit (and at EOF) so serve_stream can
        # wait event-driven instead of busy-polling an idle queue
        self._arrival = threading.Condition()

    # -- request intake ------------------------------------------------
    def submit(self, request: dict) -> None:
        self.queue.put(dict(request))
        with self._arrival:
            self._arrival.notify_all()

    def submit_line(self, line: str) -> None:
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            req = {"_parse_error": f"bad request line: {e}"}
        self.submit(req)

    # -- wave processing ----------------------------------------------
    def _account(self, tenant: str, ok: bool) -> None:
        t = self.tenants.setdefault(tenant, {"requests": 0, "errors": 0})
        t["requests"] += 1
        t["errors"] += 0 if ok else 1

    def drain(self) -> List[dict]:
        """Process one admission wave; returns [] when the queue is
        empty."""
        reqs: List[dict] = []
        while len(reqs) < self.wave_size:
            try:
                reqs.append(self.queue.get_nowait())
            except queue.Empty:
                break
        if not reqs:
            return []
        wave = self.waves
        self.waves += 1
        pending = []                      # (request, future-or-None, err)
        for req in reqs:
            err = req.get("_parse_error")
            if err is None:
                try:
                    q = parse_query(req.get("query") or {},
                                    self.session.tech)
                    pending.append((req, self.session.submit(q), None))
                    continue
                except Exception as e:               # noqa: BLE001
                    err = f"{type(e).__name__}: {e}"
            pending.append((req, None, err))
        t0 = time.time()
        self.session.flush()
        wall = time.time() - t0
        out = []
        for req, fut, err in pending:
            tenant = req.get("tenant", "anonymous")
            resp = {"id": req.get("id"), "tenant": tenant, "wave": wave}
            retryable = False
            if err is None:
                e = fut.exception()
                if e is None:
                    # result extraction and serialization can raise too
                    # (a Result whose as_dict trips, a value json can't
                    # encode): that failure must resolve ONLY this
                    # request, like every other per-request error path
                    try:
                        result = fut.result().as_dict()
                        json.dumps(result, default=str)
                        resp["ok"] = True
                        resp["result"] = result
                    except Exception as e2:              # noqa: BLE001
                        err = ("response serialization failed: "
                               f"{type(e2).__name__}: {e2}")
                else:
                    # node/evaluation failures may be transient (a fleet
                    # dispatcher retries them); parse and serialization
                    # failures are deterministic and are not
                    err = f"{type(e).__name__}: {e}"
                    retryable = True
            if err is not None:
                resp["ok"] = False
                resp["error"] = err
                resp["retryable"] = retryable
            self._account(tenant, resp["ok"])
            out.append(resp)
        if out:
            out[-1]["wave_wall_s"] = round(wall, 4)
        return out

    def serve_lines(self, lines: Iterable[str]) -> Iterator[str]:
        """Stream request lines -> response lines, draining a wave every
        `wave_size` requests and at end of input. Suits finite inputs
        (files, closed pipes); for a long-lived producer that may hold
        the stream open use `serve_stream`, which drains partial waves
        after an idle window instead of waiting for EOF."""
        for line in lines:
            if not line.strip():
                continue
            self.submit_line(line)
            if self.queue.qsize() >= self.wave_size:
                for resp in self.drain():
                    yield json.dumps(resp, default=str)
        while True:
            wave = self.drain()
            if not wave:
                break
            for resp in wave:
                yield json.dumps(resp, default=str)

    def serve_stream(self, lines: Iterable[str],
                     max_wait_s: float = 0.05) -> Iterator[str]:
        """Like serve_lines, but for LIVE streams (stdin from a
        long-running tenant, a FIFO): a background reader feeds the
        queue while waves drain as soon as `wave_size` accumulates OR
        the stream goes quiet for `max_wait_s` — a small tenant batch
        gets its responses without waiting for EOF or a full wave.

        Fully event-driven: an idle service BLOCKS on the arrival
        condition (zero wake-ups, no busy-poll); once a request lands,
        the admission window is a timed condition wait that ends the
        moment the wave fills or the stream hits EOF, and is bounded by
        `max_wait_s` so partial waves still drain on time."""
        eof = threading.Event()

        def reader():
            try:
                for line in lines:
                    if line.strip():
                        self.submit_line(line)
            finally:
                eof.set()
                with self._arrival:
                    self._arrival.notify_all()

        threading.Thread(target=reader, daemon=True).start()
        while True:
            with self._arrival:
                # idle: sleep until a request (or EOF) arrives
                while self.queue.empty() and not eof.is_set():
                    self._arrival.wait()
                if self.queue.empty() and eof.is_set():
                    break
                # admission window: gather arrivals until the wave is
                # full, the producer closes, or max_wait_s elapses
                deadline = time.monotonic() + max_wait_s
                while (self.queue.qsize() < self.wave_size
                       and not eof.is_set()):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._arrival.wait(remaining):
                        break
            for resp in self.drain():
                yield json.dumps(resp, default=str)

    def stats(self) -> dict:
        ex = self.session.executor
        out = {"waves": self.waves, "tenants": self.tenants,
               "executor": dict(ex.stats)}
        if self.session.store is not None:
            out["store"] = self.session.store.stats()
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", default="-",
                    help="JSONL request file, or - for stdin")
    ap.add_argument("--output", default="-",
                    help="JSONL response file, or - for stdout")
    ap.add_argument("--wave-size", type=int, default=64)
    ap.add_argument("--wait", type=float, default=0.05,
                    help="stdin mode: idle window (s) before draining "
                         "a partial wave")
    ap.add_argument("--store", default=None,
                    help="artifact-store directory shared across runs")
    ap.add_argument("--leases", action="store_true",
                    help="claim evaluations via file leases on the "
                         "store directory (run N services against one "
                         "store without duplicating work)")
    ap.add_argument("--device", default="cuda",
                    help="device of every evaluation (cuda | cpu)")
    args = ap.parse_args(argv)
    session = Session(store=args.store, leases=args.leases or None,
                      device=args.device)
    svc = CompileService(session=session, wave_size=args.wave_size)
    src = sys.stdin if args.input == "-" else open(args.input)
    # stdin may be a long-lived pipe: drain partial waves after an idle
    # window so small batches are answered without waiting for EOF
    serve = (lambda s: svc.serve_stream(s, max_wait_s=args.wait)) \
        if src is sys.stdin else svc.serve_lines
    dst = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        n_err = 0
        for line in serve(src):
            dst.write(line + "\n")
            dst.flush()
            n_err += not json.loads(line)["ok"]
    finally:
        if src is not sys.stdin:
            src.close()
        if dst is not sys.stdout:
            dst.close()
    print(json.dumps(svc.stats(), default=str), file=sys.stderr)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
