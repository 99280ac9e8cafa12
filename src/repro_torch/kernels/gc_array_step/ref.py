"""Plain-torch oracle for the structured bitcell-array implicit step
(port of `repro.kernels.gc_array_step.ref`).

The parameters stay Python floats, as in the reference, so the formulas
mix float64 scalar algebra into float32 tensors the same way; only the
polarity and the channel length are float32 0-d tensors, because the
channel model selects and clamps on them as tensors.

`step_body` is the algorithm itself. The oracle and the array-step
kernel's plain version (`kernel.step_plain`) both call it; they differ
only in the rail conductance's step and in the type of the parameters.
"""
from __future__ import annotations

import torch

from repro_torch.core.spice.mna import channel_current_raw

NEWTON = 3
GS_SWEEPS = 2
NEWTON_DV = 1e-4    # finite-difference step of the storage-node Newton
ORACLE_RAIL_DV = 1e-3


def step_body(v_sn, v_bl, wwl, wbl, rwl, h, p, rail_dv, colsum=None):
    """GS_SWEEPS Gauss-Seidel sweeps of (NEWTON Newton iterations per
    storage node, rails frozen; then the linearized rail KCL per column
    from column sums). `p` holds the 16 parameters, "lw" and "lr" as
    tensors; `rail_dv` is the step of the rail conductance's difference
    quotient; `colsum` maps the (R, C) cell currents to their (C,) column
    sums (torch's `sum(0)` unless given)."""
    if colsum is None:
        colsum = lambda x: x.sum(0)
    one = torch.ones((), dtype=v_sn.dtype, device=v_sn.device)

    def i_write(vsn, row_wwl, col_wbl):
        # write device: gate=WWL, channel WBL <-> SN
        return channel_current_raw(one, p["vtw"], p["nw"], p["kpw"],
                                   p["lamw"], p["ww"], p["lw"],
                                   row_wwl, vsn, col_wbl)

    def i_read(vsn, vbl, row_rwl):
        # read device: gate=SN, channel RBL <-> RWL
        return channel_current_raw(one, p["vtr"], p["nr"], p["kpr"],
                                   p["lamr"], p["wr"], p["lr"],
                                   vsn, vbl, row_rwl)

    v_sn_new, v_bl_new = v_sn, v_bl
    for _ in range(GS_SWEEPS):
        # --- per-cell implicit SN update (rails frozen) ---
        def res_sn(vs):
            return (p["c_sn"] * (vs - v_sn) / h
                    + i_write(vs, wwl[:, None], wbl[None, :]))

        vs = v_sn_new
        for _ in range(NEWTON):
            r = res_sn(vs)
            dr = (res_sn(vs + NEWTON_DV) - r) / NEWTON_DV
            vs = vs - r / dr.clamp_min(1e-18)
        v_sn_new = vs

        # --- rail update: linearized KCL with column-summed currents ---
        i_cells = i_read(v_sn_new, v_bl_new[None, :], rwl[:, None])
        i_col = colsum(i_cells)                       # (C,) leaving BL
        # conductance of cells wrt BL (numerical, for implicit rail)
        g_cells = (colsum(i_read(v_sn_new, (v_bl_new + rail_dv)[None, :],
                                 rwl[:, None])) - i_col) / rail_dv
        num = (p["c_bl"] / h) * v_bl + p["g_bl"] * p["v_bl_drv"] \
            - (i_col - g_cells * v_bl_new)
        den = p["c_bl"] / h + p["g_bl"] + g_cells
        v_bl_new = num / den
    return v_sn_new, v_bl_new


def gc_array_step_ref(v_sn, v_bl, wwl, wbl, rwl, h, p):
    """One backward-Euler step of an R x C gain-cell array.

    v_sn: (R, C) storage nodes;  v_bl: (C,) read bitlines
    wwl:  (R,) write wordline voltages;  wbl: (C,) write bitlines
    rwl:  (R,) read wordline voltages (source terminal of read devices)
    h: timestep; p: dict of scalars {vtw, nw, kpw, lamw, ww, lw,
       vtr, nr, kpr, lamr, wr, lr, c_sn, c_bl, g_bl, v_bl_drv} (g_bl: BL
       driver conductance to its target v_bl_drv).

    Returns (v_sn', v_bl'). Cells couple only through the bitline rails:
    per-cell pointwise-implicit Newton for SN, column-sum KCL for rails,
    Gauss-Seidel between the two. The rail conductance takes a step of
    1e-3, as the reference's oracle; its kernel takes 1e-4.
    """
    f = dict(dtype=v_sn.dtype, device=v_sn.device)
    p = {**p, "lw": torch.as_tensor(p["lw"], **f),
         "lr": torch.as_tensor(p["lr"], **f)}
    return step_body(v_sn, v_bl, wwl, wbl, rwl, h, p, ORACLE_RAIL_DV)
