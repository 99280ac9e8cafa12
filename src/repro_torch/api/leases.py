"""File-based lease/claim protocol over a shared artifact-store
directory. Port of `repro.api.leases` (no device code: a copy).

N compile-fleet workers share one content-addressed `ArtifactStore`
(`repro_torch.api.store`). Node keys name results, so the only coordination
the fleet needs is "who computes a missing artifact" — everything else
is the store's atomic-rename publish. This module provides that claim:

  * `try_claim(key)` atomically creates `<root>/_leases/<key>.lease`
    with `O_CREAT | O_EXCL` (the POSIX mutual-exclusion primitive that
    works on a shared directory): exactly one process wins, no matter
    how many race.
  * The claim file holds the owner id; its **mtime is the heartbeat**.
    A background daemon thread re-touches every held lease, so a live
    owner's lease never expires — even while the owner is blocked in a
    long device evaluation.
  * A lease whose mtime is older than `ttl_s` belongs to a DEAD worker.
    Anyone may steal it: take the per-key breaker lock (its own O_EXCL
    file), RE-CHECK expiry under the lock, unlink, then race the normal
    `O_CREAT | O_EXCL` claim. The re-check under mutual exclusion is
    what makes stealing safe — a slow second stealer can never tear
    down the fresh lease a quicker winner just created. A crashed
    worker's in-flight nodes are therefore reclaimed after at most one
    TTL, never lost.
  * `acquire(key, have)` is the waiter's loop: poll `have()` (usually a
    store read) until the owner publishes, or steal the lease once it
    expires. Callers must publish their own claimed work BEFORE waiting
    on foreign keys — that ordering is what makes the protocol
    deadlock-free (no one ever blocks while holding an unpublished
    claim; see `repro_torch.api.executor`).

The manager also keeps an append-only evaluation log
(`_leases/evals.log`, one `key<TAB>reason<TAB>owner` line per fresh
device evaluation, written with `O_APPEND`) so a fleet run can PROVE
"zero duplicate lattice evaluations": every key must appear with reason
`fresh` at most once across all workers; `steal` (reclaimed from a dead
owner) and `heal` (recompute after detected store corruption) are the
sanctioned recovery paths and are reported separately.
"""
from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
import uuid
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

__all__ = ["Lease", "LeaseManager"]

_SAFE = re.compile(r"[^-\w.]")


class Lease:
    """A held claim on one key. Release after publishing the artifact;
    an unreleased lease expires (and is stolen) one TTL after its last
    heartbeat."""

    __slots__ = ("_manager", "key", "path", "stolen")

    def __init__(self, manager: "LeaseManager", key: str, path: str,
                 stolen: bool):
        self._manager = manager
        self.key = key
        self.path = path
        self.stolen = stolen            # claimed by expiring a dead owner

    def heartbeat(self) -> None:
        self._manager._touch_if_owned(self.path)

    def release(self) -> None:
        self._manager._release(self)

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        return f"Lease({self.key!r}, stolen={self.stolen})"


class LeaseManager:
    """Claim/heartbeat/steal coordinator for one store directory.

    Thread-safe; every worker process builds its own manager over the
    SHARED `root` (normally `ArtifactStore.root`). `owner` defaults to
    `host:pid:nonce` and is written into each claim file so stale
    leases are attributable and release/heartbeat can verify ownership
    (a stolen lease is never touched or unlinked by its old owner).
    """

    def __init__(self, root: str, owner: Optional[str] = None,
                 ttl_s: float = 30.0, poll_s: float = 0.02,
                 heartbeat: bool = True):
        self.root = os.path.join(os.fspath(root), "_leases")
        self.owner = owner or (f"{socket.gethostname()}:{os.getpid()}:"
                               f"{uuid.uuid4().hex[:8]}")
        self.ttl_s = float(ttl_s)
        self.poll_s = float(poll_s)
        self._heartbeat = bool(heartbeat)
        self._held: Dict[str, Lease] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.counts: Counter = Counter()

    # ------------------------------------------------------------------
    # paths and file helpers
    # ------------------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.root, _SAFE.sub("_", key) + ".lease")

    def _read_owner(self, path: str) -> Optional[str]:
        try:
            with open(path) as f:
                return json.load(f).get("owner")
        except (OSError, ValueError):
            return None

    def _touch_if_owned(self, path: str) -> None:
        """Refresh the heartbeat mtime — but only while the file is
        still OUR claim (never resuscitate a lease someone stole)."""
        if self._read_owner(path) == self.owner:
            try:
                os.utime(path)
            except OSError:
                pass

    def _expired(self, path: str) -> bool:
        try:
            return time.time() - os.stat(path).st_mtime > self.ttl_s
        except OSError:
            return False                 # vanished: claimable, not stale

    def _break(self, path: str) -> bool:
        """Remove an EXPIRED lease so it can be re-claimed. The caller's
        expiry check races: by the time we act, a quicker stealer may
        have broken the old lease AND someone may have re-claimed it
        fresh. So removal happens under a per-key breaker lock (its own
        `O_CREAT | O_EXCL` file) with expiry RE-CHECKED inside — of N
        racing stealers at most one unlinks, and a fresh lease is never
        torn down. A breaker orphaned by a crash mid-break expires like
        a lease (its critical section is microseconds, so an old one is
        always dead) and is cleared for the next pass."""
        brk = path + ".brk"
        try:
            fd = os.open(brk, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if self._expired(brk):
                try:
                    os.unlink(brk)
                except OSError:
                    pass
            return False
        except OSError:
            return False
        try:
            os.close(fd)
            if not self._expired(path):
                return False           # re-claimed while we raced
            try:
                os.unlink(path)
            except OSError:
                return False
            self.counts["broken"] += 1
            return True
        finally:
            try:
                os.unlink(brk)
            except OSError:
                pass

    # ------------------------------------------------------------------
    # claim / release
    # ------------------------------------------------------------------
    def try_claim(self, key: str) -> Optional[Lease]:
        """Claim `key` if it is unclaimed (or its claim expired).
        Returns the Lease, or None while a LIVE foreign owner holds it.
        Never blocks on a live owner."""
        os.makedirs(self.root, exist_ok=True)
        path = self._path(key)
        stolen = False
        for _ in range(8):               # bounded retries around races
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if not self._expired(path):
                    return None
                if self._break(path):
                    stolen = True
                continue                 # re-race the O_EXCL create
            except OSError:
                return None
            with os.fdopen(fd, "w") as f:
                json.dump({"owner": self.owner, "key": key}, f)
            lease = Lease(self, key, path, stolen)
            with self._lock:
                self._held[key] = lease
            self.counts["claims"] += 1
            if stolen:
                self.counts["steals"] += 1
            self._ensure_heartbeat()
            return lease
        return None

    def _release(self, lease: Lease) -> None:
        with self._lock:
            self._held.pop(lease.key, None)
        # unlink only our own claim file: if the lease was stolen, the
        # stealer renamed it away (or re-created it as THEIRS)
        if self._read_owner(lease.path) == self.owner:
            try:
                os.unlink(lease.path)
            except OSError:
                pass
        self.counts["releases"] += 1

    def acquire(self, key: str, have: Callable[[], object],
                timeout: Optional[float] = None) -> Tuple[str, object]:
        """Wait-or-claim loop: returns `("have", value)` as soon as
        `have()` yields a value (the owner published), or
        `("own", lease)` once we hold the claim — immediately if the key
        is unclaimed, or after stealing an expired lease (owner died
        without publishing). Raises TimeoutError past `timeout`."""
        deadline = None if timeout is None else time.time() + timeout
        waited = False
        while True:
            val = have()
            if val is not None:
                if waited:
                    self.counts["waits_satisfied"] += 1
                return ("have", val)
            lease = self.try_claim(key)
            if lease is not None:
                return ("own", lease)
            if not waited:
                waited = True
                self.counts["waits"] += 1
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"gave up waiting {timeout}s for lease/artifact "
                    f"{key!r}")
            time.sleep(self.poll_s)

    # ------------------------------------------------------------------
    # heartbeats
    # ------------------------------------------------------------------
    def _ensure_heartbeat(self) -> None:
        if not self._heartbeat or self._hb_thread is not None:
            return
        t = threading.Thread(target=self._hb_loop, daemon=True,
                             name="lease-heartbeat")
        self._hb_thread = t
        t.start()

    def _hb_loop(self) -> None:
        # touch every held lease a few times per TTL, so a lease only
        # ever expires when its owner PROCESS is gone
        while not self._stop.wait(max(self.ttl_s / 4.0, 0.01)):
            with self._lock:
                held = list(self._held.values())
            for lease in held:
                self._touch_if_owned(lease.path)

    def close(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    # evaluation accounting (the zero-duplicates proof)
    # ------------------------------------------------------------------
    def log_eval(self, key: str, reason: str) -> None:
        """Record one fresh device evaluation of `key` by this owner.
        `reason` is `fresh` (first computation), `steal` (reclaimed from
        an expired lease) or `heal` (recompute after the store reported
        the artifact corrupt). One O_APPEND write: atomic for lines this
        short on POSIX."""
        os.makedirs(self.root, exist_ok=True)
        line = f"{key}\t{reason}\t{self.owner}\n"
        fd = os.open(os.path.join(self.root, "evals.log"),
                     os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        self.counts[f"evals_{reason}"] += 1

    @staticmethod
    def read_eval_log(store_root: str) -> Dict[str, Counter]:
        """{key: Counter(reason -> evaluations)} across every worker
        that shared `store_root` (the store directory, not `_leases`)."""
        path = os.path.join(os.fspath(store_root), "_leases", "evals.log")
        out: Dict[str, Counter] = {}
        try:
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        out.setdefault(parts[0], Counter())[parts[1]] += 1
        except OSError:
            pass
        return out

    @staticmethod
    def duplicate_evals(store_root: str) -> Dict[str, int]:
        """Keys evaluated fresh MORE than once — the fleet invariant is
        that this is empty (steals/heals are sanctioned recoveries and
        excluded)."""
        return {k: c["fresh"] for k, c in
                LeaseManager.read_eval_log(store_root).items()
                if c.get("fresh", 0) > 1}

    def stats(self) -> dict:
        with self._lock:
            held = len(self._held)
        return {"owner": self.owner, "ttl_s": self.ttl_s, "held": held,
                **dict(self.counts)}
