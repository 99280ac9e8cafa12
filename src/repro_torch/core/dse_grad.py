"""Differentiable twin of `dse.evaluate` (the §VI gradient-based DSE).

Only the knob and output names are ported so far: `api.queries`
validates an `OptimizeQuery` against them. The traced evaluator itself
(`evaluate_grad_fn`, `evaluate_grad`) waits for ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from repro_torch._deferred import deferred

KNOBS = ("vdd_scale", "w_read_scale", "w_write_scale", "bl_wire_scale")

#: Traced outputs of `evaluate_grad_fn` (all (B,) arrays). `swing_margin_a`
#: is the read-current margin i_read - 3*i_leak_total whose sign is the
#: `swing_ok` feasibility bit of the scalar evaluator.
OUTPUTS = ("t_read_s", "t_write_s", "t_cell_s", "t_wl_s", "f_max_hz",
           "retention_s", "leakage_w", "refresh_w", "standby_w",
           "e_read_j", "e_write_j", "read_bw_bps", "eff_bw_bps",
           "swing_margin_a", "swing_margin_rel")

_ITEM = "Queue 1 item 11 (differentiable DSE)"
evaluate_grad_fn = deferred("dse_grad.evaluate_grad_fn", _ITEM)
evaluate_grad = deferred("dse_grad.evaluate_grad", _ITEM)
