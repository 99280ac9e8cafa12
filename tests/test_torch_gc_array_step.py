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
