"""Content-addressed on-disk artifact cache for planned query execution.
Port of `repro.api.store` (no device code: a copy).

Plan nodes (see `repro_torch.api.plan`) are keyed by a content hash of
`(kind, tech hash, lattice-shaping payload)`, so a node's key names its
result as much as its work. This store persists those results —
evaluated lattice points, transient characterizations, (vdd x lattice)
tables — as JSON files keyed by node key, letting tables and
characterizations survive process restarts: many sessions (or a fleet
of compile-service workers sharing a directory) pay each lattice once.

Layout: `<root>/<kind>/<hash>.json`, one artifact per file, each
wrapped as `{"key", "sha256", "data"}`. The sha256 covers the canonical
JSON of `data`; `get()` verifies it and treats any unreadable,
unparsable or checksum-failing entry as a miss (counted in `corrupt`),
so a torn write or bit-rot degrades to recompute, never to a wrong
result. Writes go through a temp file + `os.replace`, so concurrent
readers and writers only ever see whole artifacts. Floats round-trip
exactly through JSON (shortest-repr), so a store hit is bit-identical
to the evaluation it replaced; non-finite values use the Python
`json` extensions (Infinity/NaN), which this module both writes and
reads.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

__all__ = ["ArtifactStore"]


def _digest(data) -> str:
    blob = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class ArtifactStore:
    """Directory-backed artifact cache. Thread/process-safe for the
    single-writer-per-key pattern the executor uses (atomic renames);
    hit/miss/corruption counters are per-instance, not persisted."""

    def __init__(self, root: str):
        self.root = str(root)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.corrupt = 0
        self.pruned = 0
        self.swept = 0

    def _path(self, key: str) -> str:
        kind, _, h = key.partition("-")
        return os.path.join(self.root, kind, (h or "misc") + ".json")

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def get(self, key: str):
        """The artifact for `key`, or None on miss OR corruption (the
        caller recomputes either way). Corrupt entries are unlinked so
        the recompute's put() repairs the store in place."""
        path = self._path(key)
        if not os.path.exists(path):
            self.misses += 1
            return None
        try:
            with open(path) as f:
                blob = json.load(f)
            data = blob["data"]
            if blob.get("sha256") != _digest(data):
                raise ValueError("artifact checksum mismatch")
        except (OSError, ValueError, KeyError, TypeError):
            self.corrupt += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.hits += 1
        return data

    def put(self, key: str, data) -> None:
        """Persist `data` (JSON-able) under `key`, atomically. The temp
        file is fsync'd BEFORE the rename: a host crash can leave a
        stale `.tmp` (swept by `sweep_tmp`) or the old entry, but never
        a truncated file under the final name."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        blob = {"key": key, "sha256": _digest(data), "data": data}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.puts += 1

    def sweep_tmp(self, max_age_s: float = 600.0) -> int:
        """Unlink `*.tmp` files older than `max_age_s` — the droppings
        of writers killed between mkstemp and the atomic rename. Safe
        concurrently: an in-flight writer's temp file is younger than
        any sane age bound."""
        cutoff = time.time() - max_age_s
        swept = 0
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if not name.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, name)
                try:
                    if os.stat(p).st_mtime <= cutoff:
                        os.unlink(p)
                        swept += 1
                except OSError:
                    pass
        self.swept += swept
        return swept

    def prune(self, max_age_s: float) -> int:
        """Drop artifacts not touched within `max_age_s` (plus stale
        temp files of the same age) — the retention policy for a
        long-lived fleet store. Returns the number of entries removed;
        a pruned entry simply recomputes on next use."""
        cutoff = time.time() - max_age_s
        pruned = 0
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if not name.endswith(".json"):
                    continue
                p = os.path.join(dirpath, name)
                try:
                    if os.stat(p).st_mtime <= cutoff:
                        os.unlink(p)
                        pruned += 1
                except OSError:
                    pass
        self.pruned += pruned
        self.sweep_tmp(max_age_s)
        return pruned

    def drop(self, key: str) -> None:
        """Remove an entry the caller found unusable (e.g. it decodes
        against a different artifact schema), counting it corrupt so a
        recompute's put() can repair the store in place."""
        self.corrupt += 1
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def __len__(self) -> int:
        n = 0
        for dirpath, _, files in os.walk(self.root):
            if os.path.basename(dirpath) == "_leases":
                continue                 # lease/claim files, not artifacts
            n += sum(f.endswith(".json") for f in files)
        return n

    def stats(self) -> dict:
        return {"root": self.root, "entries": len(self),
                "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "corrupt": self.corrupt,
                "pruned": self.pruned, "swept": self.swept}
