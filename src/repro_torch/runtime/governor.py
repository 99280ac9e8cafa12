"""Adaptive operating-voltage governor over a precomputed `VddLattice`
(the port's copy of `repro.runtime.governor`). The lattice's arrays are
numpy on the host, so every rung read below is a host read.

The paper's flexibility claim — GCRAM retention/power "tuned on-the-fly
by changing the operating voltage" — becomes a runtime policy here: a
deployed KV-cache macro (one lattice config, `n_banks` interleaved
banks) moves along its voltage ladder as MEASURED traffic shifts.

Physics (gc2t_np, the PMOS-read gain cell this repo's benches govern):
dropping vdd LENGTHENS retention — the written level sits farther from
the read margin — so the refresh interval stretches, refresh power
falls, and every access costs fewer CV^2 joules, at the price of f_max.
The governor rides that tradeoff: serve bursts at a rung that meets the
measured read rate, drop to the cheapest admissible rung when traffic
quiets.

Admissibility of rung `vi` for a traffic window mirrors `core.dse.
feasible` exactly: swing_ok, aggregate n_banks x f_max covers the read
rate, and native retention >= the window's OBSERVED data lifetime OR
refresh covers it at <10% bandwidth overhead (num_words / retention_s
< 0.1 x f_max); retention <= 0 never passes. Operating points failing
the retention rule are FORBIDDEN regardless of how fast or cheap they
are.

Energy-accounting rules (shared with bench_runtime's scoreboard and
docs/runtime.md):
  e_dyn     = window accesses x e_read_j[vi]        (per-access CV^2)
  e_leak    = n_banks x leakage_w[vi] x duration
  e_refresh = n_banks x refresh_w[vi] x duration, charged only when
              retention falls short of the observed lifetime (native
              retention needs no refresh)
  a FIXED operating point inadmissible in ANY window scores +inf total
  — pinned there, the deployment would have dropped requests (rate
  shortfall) or lost data (retention shortfall). Fixed points are held
  to the SAME headroom admission margin the governor provisions with,
  so the comparison is like-for-like QoS.

Policy: the first observed window calibrates the starting rung; after
that, up-switches are immediate (capacity emergencies don't wait) and
down-switches are hysteretic — at least `dwell_windows` quiet windows
AND `down_headroom` capacity margin at the lower rung — so traffic
flutter at a capacity boundary cannot flap the rail.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.runtime.telemetry import TelemetryWindow


@dataclasses.dataclass(frozen=True)
class Traffic:
    """One telemetry window's demand on the governed macro.

    `read_hz` is the AGGREGATE word-read rate across the macro's banks
    (window-averaged — idle time dilutes it); `lifetime_s` the longest
    observed data residency the rung's retention must cover;
    `accesses` the window's total reads (rate x duration)."""
    read_hz: float
    lifetime_s: float
    duration_s: float
    accesses: float


def traffic_from_window(win: TelemetryWindow, cfg, *,
                        word_bytes: float = 8.0) -> Traffic:
    """Derive the governed macro's traffic from a telemetry window: the
    macro is the (L2-class) KV-cache store, so its request stream is the
    measured KV byte stream divided into `word_bytes` words. The
    lifetime is the window's LONGEST admit->retire residency (every
    resident datum must survive), falling back to the window duration
    when nothing retired."""
    from repro_torch.runtime.profile import kv_stream_bytes
    total_words = kv_stream_bytes(win, cfg) / word_bytes
    dur = win.duration_s
    life = max(win.kv_lifetimes_s) if win.kv_lifetimes_s else dur
    return Traffic(read_hz=total_words / dur if dur > 0 else 0.0,
                   lifetime_s=life, duration_s=dur, accesses=total_words)


@dataclasses.dataclass(frozen=True)
class GovernorPolicy:
    headroom: float = 1.25        # capacity margin a rung must provision
    down_headroom: float = 1.6    # stricter margin required to step DOWN
    dwell_windows: int = 1        # quiet windows to wait before stepping down


@dataclasses.dataclass(frozen=True)
class Decision:
    """One governed window: the rung chosen, its refresh bookkeeping and
    the window's energy split under the accounting rules above."""
    window: int
    vi: int
    vdd_scale: float
    switched: bool
    admissible: bool              # chosen rung admissible for the window
    refresh_interval_s: float     # retention_s at the rung = max interval
    e_dyn_j: float
    e_leak_j: float
    e_refresh_j: float

    @property
    def energy_j(self) -> float:
        return self.e_dyn_j + self.e_leak_j + self.e_refresh_j


class VddGovernor:
    """Moves one lattice config (`pi`, x `n_banks` interleaved) along the
    lattice's voltage ladder, one `observe(traffic)` call per window."""

    def __init__(self, lattice, pi: int, n_banks: int,
                 policy: Optional[GovernorPolicy] = None,
                 start_vi: Optional[int] = None):
        self.lat = lattice
        self.pi = int(pi)
        self.n_banks = int(n_banks)
        self.policy = policy or GovernorPolicy()
        self.vi: Optional[int] = None if start_vi is None else int(start_vi)
        self._dwell = 0
        self.decisions: List[Decision] = []

    # -- rung properties ------------------------------------------------
    def capacity_hz(self, vi: int) -> float:
        """Aggregate read capacity of the macro at rung vi."""
        return self.n_banks * float(self.lat.f_max_hz[vi, self.pi])

    def refresh_interval_s(self, vi: int) -> float:
        return float(self.lat.retention_s[vi, self.pi])

    def retention_covers(self, vi: int, lifetime_s: float) -> bool:
        """`core.dse.feasible`'s retention/refresh rule at rung vi."""
        ret = float(self.lat.retention_s[vi, self.pi])
        if ret >= lifetime_s:
            return True
        if ret <= 0:
            return False
        refresh_rate = float(self.lat.num_words[self.pi]) / ret
        return refresh_rate < 0.1 * float(self.lat.f_max_hz[vi, self.pi])

    def admissible(self, vi: int, t: Traffic, *, margin: float = 1.0) -> bool:
        return (bool(self.lat.swing_ok[vi, self.pi])
                and self.capacity_hz(vi) >= margin * t.read_hz
                and self.retention_covers(vi, t.lifetime_s))

    def target(self, t: Traffic) -> Optional[int]:
        """Lowest (cheapest) rung admissible with provisioning headroom;
        None when no rung — even the top — can carry the window."""
        for vi in range(len(self.lat.vdd_scales)):
            if self.admissible(vi, t, margin=self.policy.headroom):
                return vi
        return None

    def energy_at(self, vi: int, t: Traffic):
        """(e_dyn, e_leak, e_refresh) joules of serving `t` at rung vi."""
        needs_refresh = float(self.lat.retention_s[vi, self.pi]) \
            < t.lifetime_s
        e_dyn = t.accesses * float(self.lat.e_read_j[vi, self.pi])
        e_leak = self.n_banks * float(self.lat.leakage_w[vi, self.pi]) \
            * t.duration_s
        e_ref = self.n_banks * float(self.lat.refresh_w[vi, self.pi]) \
            * t.duration_s if needs_refresh else 0.0
        return e_dyn, e_leak, e_ref

    # -- the policy -----------------------------------------------------
    def observe(self, t: Traffic) -> Decision:
        tgt = self.target(t)
        switched = False
        if self.vi is None:
            # first window calibrates the boot rung (no history yet);
            # fall back to the fastest swing-ok rung when nothing admits
            self.vi = tgt if tgt is not None else self._fastest_ok()
        elif tgt is None:
            best = self._fastest_ok()
            switched = best != self.vi
            self.vi, self._dwell = best, 0
        elif tgt > self.vi:
            self.vi, self._dwell, switched = tgt, 0, True   # urgent up
        elif tgt < self.vi:
            if (self._dwell >= self.policy.dwell_windows
                    and self.capacity_hz(tgt)
                    >= self.policy.down_headroom * t.read_hz):
                self.vi, self._dwell, switched = tgt, 0, True
            else:
                self._dwell += 1                 # hysteresis: hold rail
        else:
            self._dwell += 1
        e_dyn, e_leak, e_ref = self.energy_at(self.vi, t)
        d = Decision(len(self.decisions), self.vi,
                     float(self.lat.vdd_scales[self.vi]), switched,
                     self.admissible(self.vi, t),
                     self.refresh_interval_s(self.vi), e_dyn, e_leak,
                     e_ref)
        self.decisions.append(d)
        return d

    def _fastest_ok(self) -> int:
        cands = [vi for vi in range(len(self.lat.vdd_scales))
                 if bool(self.lat.swing_ok[vi, self.pi])]
        return max(cands, key=self.capacity_hz) if cands \
            else len(self.lat.vdd_scales) - 1

    @property
    def total_energy_j(self) -> float:
        return sum(d.energy_j for d in self.decisions)


def replay_fixed(lattice, pi: int, n_banks: int,
                 traffics: Sequence[Traffic], vi: int,
                 policy: Optional[GovernorPolicy] = None) -> float:
    """Total energy of a deployment PINNED at rung `vi` across the
    traffic windows, under the same admission margin the governor
    provisions with; +inf when any window is inadmissible there."""
    gov = VddGovernor(lattice, pi, n_banks, policy=policy, start_vi=vi)
    margin = gov.policy.headroom
    total = 0.0
    for t in traffics:
        if not gov.admissible(vi, t, margin=margin):
            return float("inf")
        total += sum(gov.energy_at(vi, t))
    return total
