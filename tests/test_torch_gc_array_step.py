"""Port parity: the gain-cell array step of `repro_torch` (its plain torch
version, which CPU tensors take, and its oracle) against the reference's
Pallas kernel in interpret mode and the reference's oracle."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import cells as ref_cells  # noqa: E402
from repro.kernels.gc_array_step import ops as ref_ops  # noqa: E402
from repro.kernels.gc_array_step.ref import gc_array_step_ref as ref_oracle  # noqa: E402,E501
from repro_torch.kernels.gc_array_step import kernel, ops  # noqa: E402
from repro_torch.kernels.gc_array_step.ref import gc_array_step_ref  # noqa: E402,E501
from repro_torch.kernels.gc_array_step.ref import step_body  # noqa: E402

SHAPES = [(16, 16, 16), (32, 48, 16), (64, 130, 64), (8, 8, 128)]
# plain version vs the reference kernel, both float32: the storage nodes
# agree to a few ulp (measured 3.1e-7 V); the rail takes its conductance
# as a difference quotient of two column sums over dv = 1e-4, which
# turns summation-order round-off of the sums into ~1e-5 V (measured
# 3.4e-5 V at 64x130)
ATOL_SN = 2e-6
ATOL_BL = 2e-4
# the port's oracle vs the reference's oracle (same formulas, float32;
# measured 3.0e-6 V on the rail)
ATOL_ORACLE = 2e-5
# kernel (dv = 1e-4 on the rail) vs oracle (dv = 1e-3): the reference's
# own contract, tests/test_kernels.py
ATOL_KERNEL_VS_ORACLE = 1e-3


def _inputs(R, C):
    rng = np.random.default_rng(R + C)
    v_sn = rng.uniform(0, 0.9, (R, C)).astype(np.float32)
    v_bl = rng.uniform(0, 1.1, (C,)).astype(np.float32)
    wwl = np.zeros((R,), np.float32)
    wwl[R // 2] = 1.1
    wbl = rng.uniform(0, 1.1, (C,)).astype(np.float32)
    rwl = np.full((R,), 1.1, np.float32)
    return v_sn, v_bl, wwl, wbl, rwl


@pytest.mark.parametrize("R,C,bc", SHAPES)
def test_plain_matches_reference_kernel(R, C, bc):
    arrays = _inputs(R, C)
    p = ops.cell_params("gc2t_nn")
    want_sn, want_bl = ref_ops.gc_array_step(
        *(jnp.asarray(a) for a in arrays), 2e-11, p, block_c=bc)
    before = kernel.gc_array_step.launches
    sn, bl = ops.gc_array_step(*(torch.tensor(a) for a in arrays), 2e-11, p,
                               block_c=bc)
    assert kernel.gc_array_step.launches == before   # CPU: no launch
    assert sn.shape == (R, C) and bl.shape == (C,)
    assert sn.dtype == bl.dtype == torch.float32
    np.testing.assert_allclose(sn.numpy(), np.asarray(want_sn), rtol=0,
                               atol=ATOL_SN)
    np.testing.assert_allclose(bl.numpy(), np.asarray(want_bl), rtol=0,
                               atol=ATOL_BL)


@pytest.mark.parametrize("R,C,bc", SHAPES)
def test_oracle_matches_reference_oracle(R, C, bc):
    arrays = _inputs(R, C)
    p = ops.cell_params("gc2t_nn")
    want_sn, want_bl = ref_oracle(*(jnp.asarray(a) for a in arrays), 2e-11,
                                  p)
    tensors = [torch.tensor(a) for a in arrays]
    sn, bl = gc_array_step_ref(*tensors, 2e-11, p)
    np.testing.assert_allclose(sn.numpy(), np.asarray(want_sn), rtol=0,
                               atol=ATOL_ORACLE)
    np.testing.assert_allclose(bl.numpy(), np.asarray(want_bl), rtol=0,
                               atol=ATOL_ORACLE)
    k_sn, k_bl = ops.gc_array_step(*tensors, 2e-11, p, block_c=bc)
    np.testing.assert_allclose(k_sn.numpy(), sn.numpy(),
                               atol=ATOL_KERNEL_VS_ORACLE)
    np.testing.assert_allclose(k_bl.numpy(), bl.numpy(),
                               atol=ATOL_KERNEL_VS_ORACLE)


@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t"])
def test_cell_params_match_reference(cell):
    from repro.kernels.gc_array_step.ops import cell_params as ref_params
    assert ops.cell_params(cell) == ref_params(cell)
    assert ops.cell_params(cell, c_bl=1e-14, g_bl=2e-4, v_bl_drv=1.1) == \
        ref_params(cell, c_bl=1e-14, g_bl=2e-4, v_bl_drv=1.1)
    assert ref_cells.CELLS.keys() >= {cell}


def test_write_physics_matches_reference():
    """200 steps of a selected-row write: SN approaches VDD-VT; unselected
    rows stay parked; the port's trajectory follows the reference
    kernel's."""
    p = ops.cell_params("gc2t_nn")
    R = C = 16
    v_sn, v_bl = torch.zeros((R, C)), torch.full((C,), 1.1)
    wwl = torch.zeros((R,))
    wwl[3] = 1.1
    wbl, rwl = torch.full((C,), 1.1), torch.full((R,), 1.1)
    r_sn, r_bl = jnp.zeros((R, C)), jnp.full((C,), 1.1)
    r_wwl, r_wbl, r_rwl = (jnp.asarray(x.numpy()) for x in (wwl, wbl, rwl))
    for _ in range(200):
        v_sn, v_bl = ops.gc_array_step(v_sn, v_bl, wwl, wbl, rwl, 1e-11, p,
                                       block_c=16)
        r_sn, r_bl = ref_ops.gc_array_step(r_sn, r_bl, r_wwl, r_wbl, r_rwl,
                                           1e-11, p, block_c=16)
    assert 0.6 < float(v_sn[3, 0]) < 1.0
    assert float(v_sn[5].abs().max()) < 0.05
    np.testing.assert_allclose(v_sn.numpy(), np.asarray(r_sn), atol=1e-4)
    np.testing.assert_allclose(v_bl.numpy(), np.asarray(r_bl), atol=1e-4)


# -- the kernel's launch geometry (csrc/gc_array_step.cu, "Work split") ------

N_SM = 132      # SMs of an H100 SXM


def _owned_cells(R, C, geom):
    """Yield (row, column) for every cell of every thread of the launch,
    walking the kernel's loops: block b is rank b % cluster of column
    block b // cluster; thread (x, y) owns column x of it and rows
    rank * row_groups + y, stepping by cluster * row_groups."""
    step = geom.cluster * geom.row_groups
    for b in range(geom.blocks):
        col_block, rank = divmod(b, geom.cluster)
        for y in range(geom.row_groups):
            for x in range(geom.cols):
                c = col_block * geom.cols + x
                if c < C:
                    for r in range(rank * geom.row_groups + y, R, step):
                        yield r, c


def _kernel_colsum(geom):
    """Column sums of (R, C) float32 cell currents in the kernel's order
    under `geom`: each thread's rows in row order, a tree over a block's
    row groups (strides halving from the largest power of two below
    `row_groups`), then the cluster's ranks in rank order."""
    def colsum(x):
        R, C = x.shape
        ty, cs = geom.row_groups, geom.cluster
        G = cs * ty
        pad = torch.zeros((-(-R // G) * G - R, C), dtype=x.dtype)
        rows = torch.cat([x, pad]).view(-1, G, C)
        part = torch.zeros((G, C), dtype=x.dtype)
        for k in range(rows.shape[0]):   # 0 + v == v: the pad adds nothing
            part = part + rows[k]
        part = part.view(cs, ty, C).clone()
        s = 1
        while 2 * s < ty:
            s *= 2
        while s > 0:
            hi = min(2 * s, ty)
            part[:, :hi - s] = part[:, :hi - s] + part[:, s:hi]
            s //= 2
        total = torch.zeros((C,), dtype=x.dtype)
        for q in range(cs):
            total = total + part[q, 0]
        return total
    return colsum


def _step_plain_with(colsum, v_sn, v_bl, wwl, wbl, rwl, h, p):
    """`kernel.step_plain` with the column sums taken by `colsum`."""
    p = {k: torch.tensor(p[k], dtype=torch.float32) for k in kernel.PKEYS}
    return step_body(v_sn, v_bl, wwl, wbl, rwl,
                     torch.tensor(h, dtype=torch.float32), p, kernel.DV,
                     colsum)
GEOMETRY_SHAPES = [(512, 512, 128), (128, 128, 128), (64, 130, 128),
                   (64, 130, 16), (64, 130, 1), (64, 2200, 128),
                   (16, 16, 16), (8, 8, 128), (200, 3, 128), (1, 1, 1),
                   (1000, 7, 3)]


@pytest.mark.parametrize("R,C,bc", GEOMETRY_SHAPES)
def test_geometry_is_a_valid_launch_that_owns_every_cell_once(R, C, bc):
    g = kernel.geometry(R, C, bc, N_SM)
    assert 1 <= g.cols <= min(bc, kernel.MAX_COLS)
    assert 1 <= g.cols * g.row_groups <= 1024
    assert g.cluster in (1, 2, 4, 8)
    assert g.blocks == -(-C // g.cols) * g.cluster    # whole clusters
    count = np.zeros((R, C), np.int64)
    for r, c in _owned_cells(R, C, g):
        count[r, c] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("R,C", [(512, 512), (128, 128)])
def test_geometry_fills_every_sm_of_an_h100(R, C):
    g = kernel.geometry(R, C, 128, N_SM)
    assert g.blocks >= N_SM
    assert g.cluster > 1        # the columns alone cannot fill the card
    assert kernel.MIN_COLS <= g.cols <= kernel.MAX_COLS


def test_geometry_block_c_only_caps_the_columns():
    assert kernel.geometry(64, 2200, 128, N_SM).cols == 8
    assert kernel.geometry(64, 2200, 4, N_SM).cols == 4
    assert kernel.geometry(64, 2200, 1, N_SM).cols == 1
    with pytest.raises(ValueError):
        kernel.geometry(64, 64, 0, N_SM)


# the array the column sums run over for each launch geometry: columns
# are independent, so 512x512's order is checked on 64 of its columns
ORDER_CASES = [((512, 512), 64), ((128, 128), 128), ((64, 130), 130)]


@pytest.mark.parametrize("shape,cols", ORDER_CASES)
def test_kernel_summation_order_keeps_the_rail_within_limits(shape, cols):
    """The plain step with the kernel's column-sum order (per thread, a
    tree over row groups, then the cluster's ranks) against torch's sums:
    the storage nodes do not depend on the sums; the rail's difference
    quotient magnifies their round-off, which must stay inside the
    kernel-vs-plain limit the card is held to."""
    R = shape[0]
    g = kernel.geometry(*shape, 128, N_SM)
    arrays = [torch.tensor(a) for a in _inputs(R, cols)]
    p = ops.cell_params("gc2t_nn")
    sn, bl = kernel.step_plain(*arrays, 2e-11, p)
    same_sn, same_bl = _step_plain_with(None, *arrays, 2e-11, p)
    assert torch.equal(same_sn, sn) and torch.equal(same_bl, bl)
    k_sn, k_bl = _step_plain_with(_kernel_colsum(g), *arrays, 2e-11, p)
    assert torch.equal(k_sn, sn)
    assert float((k_bl - bl).abs().max()) <= ATOL_BL
    x = torch.tensor(np.random.default_rng(R).uniform(-1, 1, (R, cols)),
                     dtype=torch.float32)
    np.testing.assert_allclose(_kernel_colsum(g)(x).numpy(),
                               x.double().sum(0).numpy(), rtol=0, atol=1e-4)
