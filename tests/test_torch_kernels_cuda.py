"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: each test skips unless a CUDA device is present, and
the kernels build with nvcc at first use. On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import timing
from repro_torch.core.bank import BankConfig, build_bank
from repro_torch.core.spice.mna import G_BIG, Circuit
from repro_torch.core.techfile import SYN40
from repro_torch.kernels.batched_solve import newton as nwt
from repro_torch.kernels.batched_solve.fused import fused_newton
from repro_torch.kernels.batched_solve.sparse import pack_params

pytestmark = pytest.mark.cuda
ATOL = {"f64": 1e-10, "mixed": 1e-5, "f32": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _operands(system, precision, B, device, seed=0):
    spec = nwt.build_fused_spec(system, precision)
    sdt, cdt = spec.dtypes
    rng = np.random.default_rng(seed)
    n = system.n
    G = system.G.expand(B, n, n) * torch.as_tensor(
        1 + 0.1 * rng.uniform(-1, 1, (B, 1, 1)), device=device)
    h = torch.as_tensor(rng.uniform(1e-12, 3e-12, B), device=device)
    pre = nwt.precompute(spec, G, system.C.expand(B, n, n), h)
    v0 = torch.as_tensor(rng.uniform(0, 1.1, (B, n)), dtype=sdt,
                         device=device)
    # Norton injections at the source nodes, levels between the rails
    src = torch.zeros((B, n), dtype=cdt, device=device)
    src[:, system.src_node] = torch.as_tensor(
        G_BIG * rng.uniform(0, 1.1, (B, len(system.src_node))), dtype=cdt,
        device=device)
    Krhs = (torch.einsum("bij,bj->bi", pre["KCoh"], v0.to(cdt))
            + torch.einsum("bij,bj->bi", pre["K"], src)).contiguous()
    return spec, pre, Krhs, pack_params(system.dev, B, sdt), v0


def _one_device_system(device):
    ckt = Circuit()
    ckt.vsrc("in", 0)
    ckt.vsrc("vdd", 1)
    ckt.r("vdd", "out", 1e4)
    ckt.c("out", "0", 1e-15)
    ckt.dev(SYN40.flavor("nmos_svt"), 0.5, 0.04, "in", "out", "0")
    return ckt.build(device=device)


@pytest.mark.parametrize("precision", list(ATOL))
@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "one_device"])
def test_kernel_matches_plain(cuda, cell, precision):
    if cell == "one_device":
        system = _one_device_system(cuda)
    else:
        ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, cell)))
        system = ckt.build(device=cuda)
    for B in (1, 16, 1000):
        spec, pre, Krhs, params, v0 = _operands(system, precision, B, cuda)
        before = fused_newton.launches
        got = fused_newton(spec, pre, Krhs, params, v0, iters=6, tol=1e-6)
        assert fused_newton.launches == before + 1
        want = nwt.newton_solve_fixed(spec, pre, Krhs, params, v0, 6, 1e-6)
        torch.cuda.synchronize()
        assert got.dtype == v0.dtype and torch.isfinite(got).all()
        err = float((got.double() - want.double()).abs().max())
        assert err <= ATOL[precision], (B, err)


def test_kernel_rejects_what_it_does_not_take(cuda):
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, "gc2t_nn")))
    spec, pre, Krhs, params, v0 = _operands(ckt.build(device=cuda), "f64",
                                            4, cuda)
    with pytest.raises(TypeError):
        fused_newton(spec, pre, Krhs.float(), params, v0, iters=6, tol=1e-6)
    with pytest.raises(ValueError):
        fused_newton(spec, pre, Krhs[:, :-1], params, v0, iters=6, tol=1e-6)
    bad = dict(pre, KU=pre["KU"].transpose(1, 2).contiguous()
               .transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        fused_newton(spec, bad, Krhs, params, v0, iters=6, tol=1e-6)


# -- Gauss-Jordan solve (csrc/gauss_jordan.cu) -------------------------------

def _read_column_system(cuda, B, seed=0):
    """Real Newton systems of the transient read path: the Jacobian and
    residual of the 16x64 gc2t_nn read column (N = 13), at B jittered
    states around the precharge level and random drive levels."""
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, "gc2t_nn")))
    system = ckt.build(device=cuda)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(1.1 + rng.uniform(-0.05, 0.05, (B, system.n)),
                        device=cuda)
    h = torch.full((B,), 2e-12, dtype=torch.float64, device=cuda)
    wave = torch.as_tensor(rng.uniform(0, 1.1, (B, 4)), device=cuda)
    return system.newton_system(v, v, h, wave)


@pytest.mark.parametrize("B", [1, 4096])
def test_gauss_jordan_matches_plain_on_the_path(cuda, B):
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain)
    J, r = _read_column_system(cuda, B)
    before = batched_solve.launches
    got = batched_solve(J.contiguous(), r.contiguous())
    assert batched_solve.launches == before + 1
    want = gauss_jordan_plain(J, r)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    # same float32 operations in the same order, each rounded on its own
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gauss_jordan_large_systems(cuda, dtype):
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain)
    from repro_torch.kernels.batched_solve.ref import batched_solve_ref
    rng = np.random.default_rng(5)
    B, N = 16, 130       # 68 KB of shared memory: the dynamic opt-in
    A = rng.standard_normal((B, N, N)) * 0.1
    A += np.eye(N)[None] * (np.abs(A).sum(-1).max() + 1.0)
    J = torch.as_tensor(A, dtype=dtype, device=cuda)
    r = torch.as_tensor(rng.standard_normal((B, N)), dtype=dtype,
                        device=cuda)
    got = batched_solve(J, r)
    torch.cuda.synchronize()
    assert torch.equal(got, gauss_jordan_plain(J, r))
    ref = batched_solve_ref(J.double(), r.double())
    assert float((got.double() - ref).abs().max()) < 2e-5
    with pytest.raises(ValueError):
        batched_solve(torch.zeros((1, 241, 241), device=cuda),
                      torch.zeros((1, 241), device=cuda))
    with pytest.raises(TypeError):
        batched_solve(J.float(), r.double())


# -- gain-cell array step (csrc/gc_array_step.cu) ----------------------------

# kernel vs plain: the same float32 arithmetic but sequential column sums
# and the card's expf/log1pf; the rail's difference quotient over
# dv = 1e-4 turns sum-order round-off into up to ~1e-5 V on the CPU
# (tests/test_torch_gc_array_step.py), so the limits are those of the
# CPU parity test
GC_ATOL_SN, GC_ATOL_BL = 2e-6, 2e-4


# bc None: the default block_c (32 columns per block); C = 130 is not a
# multiple of it, and block_c = 16 gives blocks of 16 columns
@pytest.mark.parametrize("R,C,bc", [(128, 128, None), (512, 512, None),
                                    (64, 130, None), (64, 130, 16)])
def test_gc_array_step_matches_plain(cuda, R, C, bc):
    from repro_torch.kernels.gc_array_step import ops
    from repro_torch.kernels.gc_array_step.kernel import step_plain
    rng = np.random.default_rng(R + C)
    p = ops.cell_params("gc2t_nn")
    f32 = dict(dtype=torch.float32, device=cuda)
    v_sn = torch.as_tensor(rng.uniform(0, 0.9, (R, C)), **f32)
    v_bl = torch.as_tensor(rng.uniform(0, 1.1, (C,)), **f32)
    wwl = torch.zeros((R,), **f32)
    wwl[R // 2] = 1.1
    wbl = torch.as_tensor(rng.uniform(0, 1.1, (C,)), **f32)
    rwl = torch.full((R,), 1.1, **f32)
    before = ops.gc_array_step.launches
    kw = {} if bc is None else {"block_c": bc}
    sn, bl = ops.gc_array_step(v_sn, v_bl, wwl, wbl, rwl, 2e-11, p, **kw)
    assert ops.gc_array_step.launches == before + 1
    want_sn, want_bl = step_plain(v_sn, v_bl, wwl, wbl, rwl, 2e-11, p)
    torch.cuda.synchronize()
    assert float((sn - want_sn).abs().max()) <= GC_ATOL_SN
    assert float((bl - want_bl).abs().max()) <= GC_ATOL_BL
    ref_sn, ref_bl = ops.gc_array_step_ref(v_sn, v_bl, wwl, wbl, rwl, 2e-11,
                                           p)
    assert float((sn - ref_sn).abs().max()) <= 1e-3
    assert float((bl - ref_bl).abs().max()) <= 1e-3


# -- retention on the card (compile flow) ------------------------------------

@pytest.mark.parametrize("name", ["gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t"])
def test_retention_on_the_card_matches_cpu(cuda, name):
    """Float32 on both; they differ by the card's expf/log1pf and the order
    of the 4000-term sum. The limit is the CPU parity test's against the
    reference (tests/test_torch_compiler.py)."""
    from repro_torch.core import cells, retention, techfile
    cell, tech = cells.CELLS[name], techfile.SYN40
    got = retention.analyze(cell, tech, device=cuda)
    want = retention.analyze(cell, tech, device="cpu")
    np.testing.assert_allclose(got.t_ret_s, want.t_ret_s, rtol=2e-6)
    np.testing.assert_allclose(got.i_leak0_a, want.i_leak0_a, rtol=2e-6)
    vts = np.linspace(0.3, 0.6, 7)
    np.testing.assert_allclose(
        retention.retention_vs_vt(cell, tech, vts, device=cuda),
        retention.retention_vs_vt(cell, tech, vts, device="cpu"), rtol=2e-6)
