"""Deterministic, seeded fault injection for the compile fleet (the
port's copy of `repro.testing.faults`; its decisions equal the
reference's on the same spec and keys).

Chaos testing only proves something if the chaos is REPRODUCIBLE: every
fault decision here is a pure function of `(seed, salt, kind, key)` —
a SHA-256 roll, no RNG state, no wall clock — so a failing run replays
bit-for-bit from its spec string. The injector monkeypatches exactly
the seams the fault-tolerance layer defends:

  * **store put**  — torn writes: the artifact file is truncated AFTER
    the atomic rename, modelling a host crash mid-flush. The store's
    checksum turns this into a miss + self-heal on next read.
  * **store get**  — checksum corruption: a byte inside the entry's
    `data` section is flipped before the real read runs, modelling
    bit-rot. Same self-heal path.
  * **evaluation** — node exceptions and slow nodes on
    `repro_torch.core.dse_batch.evaluate_batch` / `evaluate_vdd_lattice`
    / `repro_torch.core.spice.char_batch.characterize`, modelling
    transient device failures. The executor calls these through their
    modules, so the patched attribute is the one it runs. An
    eval fault fires at most ONCE per (key, process), so a retried
    request eventually lands on an attempt that succeeds — the fleet's
    bounded-retry contract is what's under test, not an unwinnable
    request.
  * **worker liveness** — `die_after_puts=N` hard-kills the process
    (`os._exit(137)`) after its N-th successful artifact publish: a
    worker killed MID-WAVE, with some artifacts published and some
    leases still held. Lease expiry + steal must reclaim the rest.
  * **poison requests** — any request whose id contains the `poison`
    marker raises on every attempt, in every worker: the one failure
    class retry can never fix, which must end in quarantine (a
    structured error response), not a wedged fleet.

`FaultSpec` round-trips through a `k=v,k=v` string so a spec crosses
the subprocess boundary on the worker command line
(`repro_torch.launch.fleet --worker --faults "seed=7,tear_rate=0.3,..."`).
Per-worker `salt` decorrelates decisions between workers (two workers
tearing the SAME key on their first put would starve the heal path).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault"]


class InjectedFault(RuntimeError):
    """An error raised (or a corruption planted) by the harness."""


@dataclass(frozen=True)
class FaultSpec:
    seed: int = 0
    salt: str = ""                 # per-worker decorrelation
    tear_rate: float = 0.0         # P(torn write) per put key
    corrupt_rate: float = 0.0      # P(bit flip) per get key
    eval_fail_rate: float = 0.0    # P(exception) per evaluation key
    eval_slow_rate: float = 0.0    # P(stall) per evaluation key
    slow_s: float = 0.05           # stall duration
    die_after_puts: int = 0        # 0 = never; else hard-exit after Nth
    poison: str = ""               # request-id marker that always fails

    _FLOATS = ("tear_rate", "corrupt_rate", "eval_fail_rate",
               "eval_slow_rate", "slow_s")

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """`"seed=7,salt=w0,tear_rate=0.3"` -> FaultSpec."""
        kw = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            if k in ("seed", "die_after_puts"):
                kw[k] = int(v)
            elif k in cls._FLOATS:
                kw[k] = float(v)
            elif k in ("salt", "poison"):
                kw[k] = v
            else:
                raise ValueError(f"unknown fault field {k!r}")
        return cls(**kw)

    def encode(self) -> str:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out.append(f"{f.name}={v}")
        return ",".join(out)

    def any_faults(self) -> bool:
        return bool(self.tear_rate or self.corrupt_rate
                    or self.eval_fail_rate or self.eval_slow_rate
                    or self.die_after_puts or self.poison)


def _cfg_token(cfg) -> tuple:
    return (cfg.word_size, cfg.num_words, cfg.cell, cfg.write_vt,
            cfg.wwlls, cfg.wwl_boost)


class FaultInjector:
    """Installs the hooks above on a concrete store instance and/or the
    evaluation modules; `uninstall()` (or the context manager) restores
    everything. `counts` records every fault actually fired, so tests
    and the fleet bench can assert the chaos was real."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec if isinstance(spec, FaultSpec) \
            else FaultSpec.parse(spec)
        self.counts: Counter = Counter()
        self._once = set()             # (kind, key) that already fired
        self._puts = 0
        self._restore = []             # (obj, attr, original)

    # ------------------------------------------------------------------
    # deterministic decisions
    # ------------------------------------------------------------------
    def _roll(self, kind: str, key: str) -> float:
        h = hashlib.sha256(
            f"{self.spec.seed}:{self.spec.salt}:{kind}:{key}".encode()
        ).hexdigest()[:12]
        return int(h, 16) / float(16 ** 12)

    def _fire_once(self, kind: str, key: str, rate: float) -> bool:
        """Seeded decision that fires at most once per (kind, key) in
        this process — transient faults, not permanent ones."""
        if rate <= 0.0:
            return False
        token = (kind, key)
        if token in self._once:
            return False
        if self._roll(kind, key) >= rate:
            return False
        self._once.add(token)
        return True

    # ------------------------------------------------------------------
    # install / uninstall
    # ------------------------------------------------------------------
    def install(self, store=None, evals: bool = False) -> "FaultInjector":
        if store is not None:
            self._wrap(store, "put", self._put_hook)
            self._wrap(store, "get", self._get_hook)
            self._store = store
        if evals:
            from repro_torch.core import dse_batch
            from repro_torch.core.spice import char_batch
            self._wrap(dse_batch, "evaluate_batch",
                       self._eval_hook("evaluate_batch"))
            self._wrap(dse_batch, "evaluate_vdd_lattice",
                       self._eval_hook("evaluate_vdd_lattice"))
            self._wrap(char_batch, "characterize",
                       self._eval_hook("characterize"))
        return self

    def _wrap(self, obj, attr: str, factory) -> None:
        """`factory(original) -> replacement`; original restored by
        uninstall()."""
        orig = getattr(obj, attr)
        self._restore.append((obj, attr, orig))
        setattr(obj, attr, factory(orig))

    def uninstall(self) -> None:
        while self._restore:
            obj, attr, orig = self._restore.pop()
            setattr(obj, attr, orig)

    def __enter__(self) -> "FaultInjector":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------------
    # hooks
    # ------------------------------------------------------------------
    def check_request(self, request: dict) -> None:
        """Raise for poison requests (called by fleet workers before
        submission). Fires on EVERY attempt — poison is the permanent
        failure class that must end in quarantine."""
        marker = self.spec.poison
        if marker and marker in str(request.get("id", "")):
            self.counts["poison_hits"] += 1
            raise InjectedFault(
                f"poison request {request.get('id')!r}")

    def _put_hook(self, orig):
        def put(key, data):
            orig(key, data)
            if self._fire_once("tear", key, self.spec.tear_rate):
                self._tear(key)
            self._puts += 1
            if self.spec.die_after_puts and \
                    self._puts >= self.spec.die_after_puts:
                self.counts["worker_suicides"] += 1
                os._exit(137)      # SIGKILL-equivalent: no cleanup runs
        return put

    def _get_hook(self, orig):
        def get(key):
            if self._fire_once("corrupt", key, self.spec.corrupt_rate):
                self._flip_byte(key)
            return orig(key)
        return get

    def _eval_hook(self, name: str):
        def make(orig):
            def wrapped(cfgs, *args, **kwargs):
                key = name + ":" + hashlib.sha256(
                    repr([_cfg_token(c) for c in cfgs]).encode()
                ).hexdigest()[:16]
                if self._fire_once("slow", key, self.spec.eval_slow_rate):
                    self.counts["slow_evals"] += 1
                    time.sleep(self.spec.slow_s)
                if self._fire_once("fail", key, self.spec.eval_fail_rate):
                    self.counts["eval_faults"] += 1
                    raise InjectedFault(
                        f"injected {name} failure ({key})")
                return orig(cfgs, *args, **kwargs)
            return wrapped
        return make

    # ------------------------------------------------------------------
    # file-level damage
    # ------------------------------------------------------------------
    def _artifact_path(self, key: str) -> Optional[str]:
        store = getattr(self, "_store", None)
        if store is None:
            return None
        path = store._path(key)
        return path if os.path.exists(path) else None

    def _tear(self, key: str) -> None:
        """Truncate the renamed artifact to half its length — the torn
        state a crash between rename and (missing) fsync leaves."""
        path = self._artifact_path(key)
        if path is None:
            return
        size = os.path.getsize(path)
        if size < 4:
            return
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        self.counts["torn_writes"] += 1

    def _flip_byte(self, key: str) -> None:
        """Flip one byte inside the entry's `data` section (the part
        the sha256 covers), modelling bit-rot the checksum must catch."""
        path = self._artifact_path(key)
        if path is None:
            return
        with open(path, "r+b") as f:
            blob = f.read()
            anchor = blob.find(b'"data"')
            if anchor < 0 or len(blob) - anchor < 12:
                return
            pos = anchor + 8 + (len(blob) - anchor - 10) // 2
            f.seek(pos)
            f.write(bytes([blob[pos] ^ 0x01]))
        self.counts["corrupted_reads"] += 1
