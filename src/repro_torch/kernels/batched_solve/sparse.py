"""Precision policy and device-parameter packing shared by the lattice
engines.

The fixed-pattern symbolic-LU engine of `repro.kernels.batched_solve.sparse`
(`lu_schedule`, `factor`, `solve_factored`, `make_newton_iter`,
`newton_solve_implicit`, `j_constant`) is not ported yet; this module
holds only what the fused Woodbury-Newton engine reads.

Precision policy: `store_dtype` is the dtype of the carried state and
traces, `compute_dtype` that of the model evaluation and the solve.
"mixed" = float32 storage with float64 compute, safe because Newton
re-evaluates the residual from the stored state each iteration; "f32"
is screening-only (cond(J) ~ 1e6 amplifies solve round-off).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._deferred import deferred

#: storage/compute dtypes per precision mode
PRECISIONS: Dict[str, tuple] = {
    "f64": (torch.float64, torch.float64),
    "mixed": (torch.float32, torch.float64),
    "f32": (torch.float32, torch.float32),
}

#: device parameter pack order (gg = gate-leak conductance ig*w/1.1 is
#: appended as the 8th row by `pack_params`)
PARAM_FIELDS = ("pol", "vt0", "n", "kp", "lam", "w", "l")
N_PARAMS = len(PARAM_FIELDS) + 1

_SPARSE = "Queue 1 item 4 (sparse-LU engine)"
build_spec = deferred("sparse.build_spec", _SPARSE)
newton_solve_implicit = deferred("sparse.newton_solve_implicit", _SPARSE)


def pack_params(dev: dict, B: int, dtype, overrides=None) -> torch.Tensor:
    """Device parameter dict -> (B, N_PARAMS, n_dev) operand block
    (PARAM_FIELDS rows + the gate-leak conductance gg as the last row),
    broadcast over the batch, on the device of `dev`'s tensors.

    `overrides` maps PARAM_FIELDS names (plus "ig") to per-point values
    (scalar, (B, 1) or (B, n_dev)); gg is recomputed from the possibly
    overridden w/ig."""
    n_dev = int(dev["pol"].shape[-1])
    device = dev["pol"].device
    over = dict(overrides or {})
    bad = set(over) - set(PARAM_FIELDS) - {"ig"}
    if bad:
        raise ValueError(f"unknown device-param overrides {sorted(bad)} "
                         f"(allowed: {PARAM_FIELDS + ('ig',)})")

    def val(k):
        return torch.as_tensor(over[k] if k in over else dev[k],
                               dtype=dtype, device=device)

    cols = [val(k) for k in PARAM_FIELDS]
    cols.append(val("ig") * val("w") / 1.1)
    return torch.stack([c.expand(B, n_dev) for c in cols], dim=1) \
        .contiguous()
