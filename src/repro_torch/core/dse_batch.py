"""Lattice batching helpers shared with the transient characterization.

Port of the grouping and bucketing part of `repro.core.dse_batch`. The
batched analytic evaluator (`evaluate_vdd_lattice`, `VddLattice`,
`feasible_grid`, `banks_needed_grid`, `shmoo_batch`, `codesign_metrics`)
is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch._deferred import deferred
from repro_torch.core.bank import BankConfig


def pow2_bucket(n: int, floor: int = 4) -> int:
    """Smallest power-of-two >= n, floored at `floor`: the shared
    batch-bucketing rule, so batches of varying size land in a handful
    of shapes."""
    return max(floor, 1 << max(0, n - 1).bit_length())


def pad_bucket(a: np.ndarray, bucket: int) -> np.ndarray:
    """Edge-repeat `a` along axis 0 up to `bucket` rows (no-op when
    already there). Padded rows are dropped by the caller's slice-back,
    so bucketing is value-transparent."""
    n = a.shape[0]
    if bucket <= n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], bucket - n, axis=0)],
                          axis=0)


def topology_key(cfg: BankConfig) -> tuple:
    """Cell-topology grouping key: configs sharing it have identical cell
    electricals and identical critical-path netlist STRUCTURE; only
    wire/structural values differ."""
    return (cfg.cell, cfg.write_vt, cfg.wwlls, cfg.wwl_boost, id(cfg.tech))


def group_by_topology(cfgs: Sequence[BankConfig]) -> Dict[tuple, List[int]]:
    """Indices of `cfgs` grouped by topology_key, preserving order."""
    groups: Dict[tuple, List[int]] = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(topology_key(cfg), []).append(i)
    return groups


evaluate_vdd_lattice = deferred("dse_batch.evaluate_vdd_lattice",
                                "Queue 1 item 8 (DSE)")
evaluate_batch = deferred("dse_batch.evaluate_batch", "Queue 1 item 8 (DSE)")
