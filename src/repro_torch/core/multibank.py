"""Multibank GCRAM macro generation. Port of `repro.core.multibank`.

Paper §VI future work + the Fig 10 discussion: "Analogous to how NVIDIA
GPUs organize the L2 SRAM cache, we can employ a multi-banked GCRAM
design to accommodate multiple parallel read and write requests".

A MultiBank composes N identical banks behind an address-interleaved
crossbar: capacity and bandwidth scale ~N, frequency stays the bank's,
area adds a routing/arbiter overhead per bank.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

from repro_torch.core import dse
from repro_torch.core.bank import BankConfig

XBAR_OVERHEAD = 0.06     # crossbar/arbiter area per bank (fraction)
XBAR_DELAY_S = 35e-12    # one crossbar hop on the read path


@dataclass
class MultiBankPoint:
    """Composed macro metrics. Units follow DesignPoint: `area_um2`
    um^2, `f_max_hz` Hz, `eff_bw_bps` bits/s, powers watts,
    `retention_s` seconds (per bank — banking does not change it)."""
    n_banks: int
    bank: dse.DesignPoint
    area_um2: float
    f_max_hz: float
    eff_bw_bps: float
    capacity_bits: int
    leakage_w: float
    refresh_w: float
    retention_s: float

    def as_dict(self):
        d = {"n_banks": self.n_banks, **self.bank.as_dict()}
        d.update({"macro_area_um2": self.area_um2,
                  "macro_f_max_hz": self.f_max_hz,
                  "macro_eff_bw_bps": self.eff_bw_bps,
                  "macro_capacity_bits": self.capacity_bits})
        return d


def compose_multibank(dp: dse.DesignPoint, n_banks: int) -> MultiBankPoint:
    """Compose an N-bank interleaved macro around an already-evaluated
    bank (the core implementation; `repro_torch.api.Session.multibank`
    caches the bank evaluation and calls this)."""
    if dp.t_read_s <= 0 or dp.t_write_s <= 0:
        raise ValueError(
            "compose_multibank needs a DesignPoint with t_read_s/t_write_s "
            "(from dse.evaluate or the batched evaluator); got "
            f"t_read_s={dp.t_read_s}, t_write_s={dp.t_write_s}")
    # crossbar hop slows the read path by one stage-quantized hop
    t_read = dp.t_read_s + XBAR_DELAY_S
    f = 1.0 / max(t_read, dp.t_write_s)
    area = n_banks * dp.area_um2 * (1.0 + XBAR_OVERHEAD)
    return MultiBankPoint(
        n_banks=n_banks, bank=dp, area_um2=area, f_max_hz=f,
        eff_bw_bps=n_banks * dp.eff_bw_bps * (f / dp.f_max_hz),
        capacity_bits=n_banks * dp.cfg.bits,
        leakage_w=n_banks * dp.leakage_w,
        refresh_w=n_banks * dp.refresh_w,
        retention_s=dp.retention_s)


def build_multibank(cfg: BankConfig, n_banks: int,
                    device="cuda") -> MultiBankPoint:
    """DEPRECATED: use repro_torch.api.Session().multibank(cfg, n_banks)."""
    warnings.warn(
        "build_multibank() is deprecated; use repro_torch.api.Session()"
        ".multibank(cfg, n_banks)", DeprecationWarning, stacklevel=2)
    from repro_torch.api import Session
    return Session(cfg.tech, device=device).multibank(cfg, n_banks)


def banks_needed(dp: dse.DesignPoint, demand: dse.Demand,
                 capacity_bits: int = 0, max_banks: int = 1024, *,
                 allow_refresh: bool = True) -> int:
    """Smallest bank count whose interleaved macro meets the demand's
    per-bank read frequency is 1 by construction (interleaving divides the
    request stream); what multibanking buys is AGGREGATE frequency and
    capacity — return the count needed so that n * f_bank >= n_requests
    AND n * bits >= capacity.

    Units: `demand.read_freq_hz` Hz, `capacity_bits` bits. Returns
    `max_banks + 1` as the infeasibility sentinel (per-bank retention/
    refresh rule fails, swing fails, or f_max <= 0) — see `dse.feasible`
    for the exact refresh rule. Scalar reference for
    `core.dse_batch.banks_needed_grid`."""
    if not dp.swing_ok or dp.f_max_hz <= 0:
        return max_banks + 1
    n_freq = math.ceil(demand.read_freq_hz / dp.f_max_hz)
    n_cap = math.ceil(capacity_bits / dp.cfg.bits) if capacity_bits else 1
    n = max(1, n_freq, n_cap)
    # retention/refresh feasibility is per bank (unchanged by banking)
    if not dse.feasible(dp, dse.Demand(demand.name, demand.level,
                                       min(demand.read_freq_hz, dp.f_max_hz),
                                       demand.lifetime_s),
                        allow_refresh=allow_refresh):
        return max_banks + 1
    return n
