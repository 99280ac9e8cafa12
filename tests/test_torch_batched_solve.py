"""Port parity: the batched Gauss-Jordan solve of `repro_torch` (its plain
torch version, which CPU tensors take) against the reference's Pallas
kernel in interpret mode and against the library oracle."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.batched_solve import ops as ref_ops  # noqa: E402
from repro_torch.kernels.batched_solve import kernel, ops  # noqa: E402
from repro_torch.kernels.batched_solve.ref import batched_solve_ref  # noqa: E402,E501

SHAPES = [(1, 4), (4, 8), (8, 33), (3, 64), (16, 130), (2, 17)]
# against the reference kernel: both run the same float32 Gauss-Jordan
# steps, but XLA may fuse a product and a difference into one rounding;
# measured 6e-8 (one float32 ulp near 1), limit 16 ulp
ATOL_KERNEL = 1e-6
# against the LU oracle: the reference's own contract (test_kernels.py)
TOL_ORACLE = 2e-5


def _dd_system(rng, B, N, dtype=np.float32):
    A = rng.standard_normal((B, N, N)).astype(dtype) * 0.1
    A += np.eye(N, dtype=dtype)[None] * (np.abs(A).sum(-1).max() + 1.0)
    r = rng.standard_normal((B, N)).astype(dtype)
    return A, r


@pytest.mark.parametrize("B,N", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, N):
    A, r = _dd_system(np.random.default_rng(B * 100 + N), B, N)
    want = np.asarray(ref_ops.batched_solve(jnp.asarray(A), jnp.asarray(r)))
    before = kernel.batched_solve.launches
    got = ops.batched_solve(torch.tensor(A), torch.tensor(r))
    assert kernel.batched_solve.launches == before   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_KERNEL)
    oracle = batched_solve_ref(torch.tensor(A), torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=TOL_ORACLE,
                               atol=TOL_ORACLE)


def test_block_sizes_do_not_change_the_result():
    A, r = _dd_system(np.random.default_rng(0), 7, 24)
    A, r = torch.tensor(A), torch.tensor(r)
    base = ops.batched_solve(A, r)
    for bb in (1, 2, 8):
        assert torch.equal(ops.batched_solve(A, r, block_b=bb), base)
    with pytest.raises(ValueError):
        ops.batched_solve(A, r, block_b=0)


def test_single_system_and_dispatch():
    A, r = _dd_system(np.random.default_rng(1), 5, 16)
    A, r = torch.tensor(A), torch.tensor(r)
    one = torch.stack([ops.solve1(A[0], rr) for rr in r])
    want = batched_solve_ref(A[0].expand(5, 16, 16), r)
    np.testing.assert_allclose(one.numpy(), want.numpy(), rtol=TOL_ORACLE,
                               atol=TOL_ORACLE)
    assert torch.equal(ops.solve(A[0], r[0]), ops.solve1(A[0], r[0]))
    assert torch.equal(ops.solve(A, r), ops.batched_solve(A, r))


def test_float64_inputs_compute_in_float32_like_the_reference():
    """The kernel computes in float32 whatever the input type and casts
    the result back to r's type, as the reference does."""
    A, r = _dd_system(np.random.default_rng(2), 3, 13, np.float64)
    got = ops.batched_solve(torch.tensor(A), torch.tensor(r))
    assert got.dtype == torch.float64
    f32 = ops.batched_solve(torch.tensor(A, dtype=torch.float32),
                            torch.tensor(r, dtype=torch.float32))
    assert torch.equal(got, f32.double())
    with jax.enable_x64(True):
        want = np.asarray(ref_ops.batched_solve(jnp.asarray(A),
                                                jnp.asarray(r)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_KERNEL)


def test_mna_jacobian_solves_like_the_reference():
    """A real read-column Newton system (16x64 gc2t_nn, N = 13, f64): the
    solve the transient path makes, float32 inside."""
    from repro.core import timing as ref_timing
    from repro.core.bank import BankConfig, build_bank
    with jax.enable_x64(True):
        ckt, _ = ref_timing.read_netlist(build_bank(BankConfig(16, 64)))
        sys = ckt.build()
        rng = np.random.default_rng(3)
        v = jnp.asarray(rng.uniform(0, 1.1, sys.n))
        J = np.asarray(sys.jacobian(v, 1e-12))[None]
        r = rng.standard_normal((1, sys.n))
        want = np.asarray(ref_ops.batched_solve(jnp.asarray(J),
                                                jnp.asarray(r)))
    got = ops.batched_solve(torch.tensor(J), torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    exact = np.linalg.solve(J, r[..., None])[..., 0]
    # float32 elimination through cond(J) ~ 1e6: a few parts in 1e2
    assert np.max(np.abs(got - exact) / np.abs(exact).max()) < 5e-2


def test_plain_version_is_the_kernel_arithmetic():
    """gauss_jordan_plain: pivots in order, factors read before the
    update, row k left as it is, x = r / diag(J)."""
    A, r = _dd_system(np.random.default_rng(4), 2, 6)
    A64, r64 = A.astype(np.float32), r.astype(np.float32)
    for k in range(6):
        inv = np.float32(1.0) / A64[:, k, k]
        fac = A64[:, :, k] * inv[:, None]
        fac[:, k] = 0
        A64 = A64 - fac[:, :, None] * A64[:, k:k + 1, :]
        r64 = r64 - fac * r64[:, k:k + 1]
    want = r64 / np.diagonal(A64, axis1=1, axis2=2)
    got = kernel.gauss_jordan_plain(torch.tensor(A), torch.tensor(r))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,kind", [(1, "warp"), (12, "warp"), (13, "warp"),
                                    (16, "warp"), (17, "warp"), (32, "warp"),
                                    (33, "block"), (130, "block"),
                                    (240, "block")])
def test_route_picks_the_kernel_by_system_size(N, kind):
    assert kernel.route(N) == kind


@pytest.mark.parametrize("N", [0, -3, 241, 1024])
def test_route_raises_outside_the_kernels(N):
    with pytest.raises(ValueError):
        kernel.route(N)
