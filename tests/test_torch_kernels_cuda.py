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
from repro_torch.kernels.batched_solve.fused import (fused_newton,
                                                     fused_newton_scan,
                                                     fused_newton_scan_plain)
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


# -- the scan: a whole transient in one launch (csrc/fused_newton.cu) --------

# kernel vs plain over a whole trajectory (volts): per step the Newton
# solve agrees as in the one-step test, and the in-kernel KCoh @ v sum may
# differ from the einsum's order by an ulp; the circuit is stable, so such
# differences do not grow past round-off. mixed and f32 store the state in
# float32 (spacing ~1e-7 V near 1 V), where one flipped rounding moves a
# node by an ulp; f32 also solves in float32 through cond(J) ~ 1e6
SCAN_ATOL = {"f64": 1e-9, "mixed": 1e-5, "f32": 1e-3}
SCAN_STEPS = 20


def _scan_operands(system, precision, B, device, T=SCAN_STEPS, seed=0):
    """`_operands` plus a T-step source term K @ src: Norton injections
    at the source nodes, seeded levels that ramp in over four steps."""
    spec, pre, _, params, v0 = _operands(system, precision, B, device, seed)
    _, cdt = spec.dtypes
    rng = np.random.default_rng(seed + 1)
    levels = torch.as_tensor(
        G_BIG * rng.uniform(0, 1.1, (B, len(system.src_node))), dtype=cdt,
        device=device)
    src = torch.zeros((T, B, system.n), dtype=cdt, device=device)
    for t in range(T):
        src[t][:, system.src_node] = levels * min(1.0, t / 4)
    Ksrc = torch.einsum("bij,tbj->tbi", pre["K"], src).contiguous()
    return spec, pre, Ksrc, params, v0


@pytest.mark.parametrize("precision", list(SCAN_ATOL))
@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_np", "one_device"])
def test_scan_kernel_matches_plain(cuda, cell, precision):
    if cell == "one_device":
        system = _one_device_system(cuda)
    else:
        ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, cell)))
        system = ckt.build(device=cuda)
    for B in (1, 16, 1000):
        spec, pre, Ksrc, params, v0 = _scan_operands(system, precision, B,
                                                     cuda)
        before = fused_newton_scan.launches
        got = fused_newton_scan(spec, pre, Ksrc, params, v0, iters=6,
                                tol=1e-6)
        assert fused_newton_scan.launches == before + 1
        want = fused_newton_scan_plain(spec, pre, Ksrc, params, v0, 6, 1e-6)
        torch.cuda.synchronize()
        assert got.shape == (B, SCAN_STEPS, system.n)
        assert got.dtype == v0.dtype and torch.isfinite(got).all()
        err = float((got.double() - want.double()).abs().max())
        assert err <= SCAN_ATOL[precision], (B, err)


def test_scan_kernel_rejects_what_it_does_not_take(cuda):
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, "gc2t_nn")))
    spec, pre, Ksrc, params, v0 = _scan_operands(ckt.build(device=cuda),
                                                 "f64", 4, cuda)
    before = fused_newton_scan.launches
    with pytest.raises(TypeError):
        fused_newton_scan(spec, pre, Ksrc.float(), params, v0, iters=6,
                          tol=1e-6)
    with pytest.raises(ValueError):
        fused_newton_scan(spec, pre, Ksrc[:, :, :-1].contiguous(), params,
                          v0, iters=6, tol=1e-6)
    with pytest.raises(ValueError):
        fused_newton_scan(spec, pre, Ksrc[0], params, v0, iters=6, tol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        fused_newton_scan(spec, pre, Ksrc.transpose(0, 1).contiguous()
                          .transpose(0, 1), params, v0, iters=6, tol=1e-6)
    bad = dict(pre, KCoh=pre["KCoh"].transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        fused_newton_scan(spec, bad, Ksrc, params, v0, iters=6, tol=1e-6)
    assert fused_newton_scan.launches == before


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


def _dd_systems(cuda, B, N, seed=0):
    """B diagonally dominant float64 systems of size N."""
    rng = np.random.default_rng(seed + N)
    A = rng.standard_normal((B, N, N)) * 0.1
    A += np.eye(N)[None] * (np.abs(A).sum(-1).max() + 1.0)
    return (torch.as_tensor(A, device=cuda),
            torch.as_tensor(rng.standard_normal((B, N)), device=cuda))


# N = 13: the path's read column (warp kernel, two systems per warp);
# N = 32: the widest warp system; N = 33: the narrowest block system.
# B = 64 is run_batch's batch
@pytest.mark.parametrize("N", [13, 32, 33])
@pytest.mark.parametrize("B", [1, 64, 4096])
def test_gauss_jordan_matches_plain_on_the_path(cuda, B, N):
    from repro_torch.kernels.batched_solve.kernel import (batched_solve,
                                                          gauss_jordan_plain,
                                                          route)
    if N == 13:
        J, r = _read_column_system(cuda, B)
    else:
        J, r = _dd_systems(cuda, B, N)
    assert J.shape[-1] == N
    kind = route(N)
    before = (batched_solve.launches, batched_solve.warp_launches,
              batched_solve.block_launches)
    got = batched_solve(J.contiguous(), r.contiguous())
    assert batched_solve.launches == before[0] + 1
    assert batched_solve.warp_launches == before[1] + (kind == "warp")
    assert batched_solve.block_launches == before[2] + (kind == "block")
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

# kernel vs plain: the same float32 arithmetic but the kernel's order of
# the column sums and the card's expf/log1pf; the rail's difference
# quotient over dv = 1e-4 turns sum-order round-off into up to ~1e-5 V on
# the CPU (tests/test_torch_gc_array_step.py), so the limits are those of
# the CPU parity test
GC_ATOL_SN, GC_ATOL_BL = 2e-6, 2e-4


# bc None: the default block_c (128; at most 8 columns per block). At
# 132 SMs, 128x128, 512x512 and 64x130 split each column's rows over a
# cluster of blocks; 64x2200 fills the card with column blocks alone.
# C = 130 and 2200 are not multiples of the block; block_c = 16 and 1 cap
# the columns per block
@pytest.mark.parametrize("R,C,bc", [(128, 128, None), (512, 512, None),
                                    (64, 130, None), (64, 130, 16),
                                    (64, 130, 1), (64, 2200, None)])
def test_gc_array_step_matches_plain(cuda, R, C, bc):
    from repro_torch.kernels.gc_array_step import kernel, ops
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
    geom = kernel.geometry(R, C, bc or 128, kernel.sm_count(cuda.index))
    assert ops.gc_array_step.last_geometry == geom
    if kernel.sm_count(cuda.index) == 132:     # H100 SXM
        assert (geom.cluster > 1) == (C < 1000)
    # a second launch gives the same bits: the sums run in a fixed order
    sn2, bl2 = ops.gc_array_step(v_sn, v_bl, wwl, wbl, rwl, 2e-11, p, **kw)
    want_sn, want_bl = step_plain(v_sn, v_bl, wwl, wbl, rwl, 2e-11, p)
    torch.cuda.synchronize()
    assert torch.equal(sn2, sn) and torch.equal(bl2, bl)
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


# -- flash attention (csrc/flash_attention_tc.cu for bf16, -----------------
# csrc/flash_attention.cu for float32)

# (B, Sq, Skv, H, K, hd, q_offset, kv_len): the serving path's prefill
# shapes (two prompts of one length per admission group), B = 4 at S = 512
# and B = 1 at S = 1024, Sq not a multiple of the tile, a q_offset slice,
# kv_len < Skv, G = 1, G = 7 and hd = 128
FLASH_SHAPES = [(2, 128, 128, 32, 8, 64, 0, None),
                (2, 256, 256, 32, 8, 64, 0, None),
                (2, 512, 512, 32, 8, 64, 0, None),
                (2, 1024, 1024, 32, 8, 64, 0, None),
                (4, 512, 512, 32, 8, 64, 0, None),
                (2, 80, 80, 24, 8, 128, 0, None),
                (1, 1024, 1024, 32, 8, 64, 0, None),
                (2, 100, 100, 32, 8, 64, 0, None),
                (2, 32, 128, 4, 1, 16, 96, None),
                (1, 96, 128, 8, 2, 32, 0, 77),
                (2, 64, 64, 8, 8, 64, 0, None),
                (2, 200, 200, 14, 2, 64, 0, None)]
# the reference's own limits (tests/test_kernels.py)
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _flash_limit(dtype, want):
    """FLASH_ATOL, and for bfloat16 at most 4 units of its 2^-8 rounding
    of the plain output's largest magnitude: many keys average the values
    down (max|o| 0.20-0.66 at whisper's non-causal shapes), where 3e-2
    absolute would pass a kernel that drops a tail key."""
    if dtype != torch.bfloat16:
        return FLASH_ATOL[dtype]
    return min(FLASH_ATOL[dtype], 2.0 ** -6 * float(want.float().abs().max()))


def _flash_counts():
    from repro_torch.kernels.flash_attention import kernel
    return {torch.bfloat16: kernel.flash_attention_tc.launches,
            torch.float32: kernel.flash_attention_f32.launches}


def _one_launch_of(dtype, before):
    """The kernel that serves `dtype` was launched once since `before`,
    the other not at all."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    now = _flash_counts()
    return now[dtype] == before[dtype] + 1 and now[other] == before[other]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_attention_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    B, Sq, Skv, H, K, hd, off, kv_len = shape
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                               device=cuda)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    before = _flash_counts()
    got = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    assert _one_launch_of(dtype, before)
    want = flash_attention_plain(q, k, v, q_offset=off, kv_len=kv_len)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= \
        FLASH_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk_kv", [32, 40, 1024])
def test_flash_attention_follows_chunk_kv(cuda, chunk_kv, dtype):
    """The running max is refreshed once per chunk_kv keys, as in the plain
    version, also where a chunk ends inside a key tile (32 keys in the
    float32 kernel, 64 in the bf16 tensor-core kernel)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    rng = np.random.default_rng(chunk_kv)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                               device=cuda)
               for s in ((1, 300, 8, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    before = _flash_counts()
    got = flash_attention_fwd(q, k, v, kv_len=250, chunk_kv=chunk_kv)
    assert _one_launch_of(dtype, before)
    want = flash_attention_plain(q, k, v, kv_len=250, chunk_kv=chunk_kv)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= \
        FLASH_ATOL[dtype]


@pytest.mark.parametrize("shape", [(2, 1024, 1024, 32, 8, 64, 0, None),
                                   (2, 200, 200, 14, 2, 64, 0, None),
                                   (1, 96, 128, 8, 2, 32, 0, 77)], ids=str)
def test_flash_attention_tc_is_deterministic(cuda, shape):
    """Two launches of the bf16 tensor-core kernel on the same inputs give
    the same bits: no atomics, a fixed order of sums."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    B, Sq, Skv, H, K, hd, off, kv_len = shape
    rng = np.random.default_rng(Sq + H)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                               device=cuda)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    before = _flash_counts()
    first = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    second = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _flash_counts()[torch.bfloat16] == before[torch.bfloat16] + 2
    assert torch.equal(first, second)


# the float32 kernel at the full-width float32 serve's four prefill shapes
# and at hd = 128 (llama3.2-3b widths) over several key tiles
F32_FULL_WIDTH = [(2, 128, 128, 32, 8, 64, 0, None),
                  (2, 256, 256, 32, 8, 64, 0, None),
                  (2, 512, 512, 32, 8, 64, 0, None),
                  (2, 1024, 1024, 32, 8, 64, 0, None),
                  (2, 256, 256, 24, 8, 128, 0, None),
                  (1, 1024, 1024, 24, 8, 128, 0, None),
                  (1, 200, 300, 16, 2, 128, 100, 290)]


def _f32_inputs(shape, device, seed):
    B, Sq, Skv, H, K, hd = shape[:6]
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                 device=device)
                 for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))


@pytest.mark.parametrize("shape", F32_FULL_WIDTH, ids=str)
def test_flash_attention_f32_full_width(cuda, shape):
    """The float32 kernel against the plain version at the serve's schedule
    (one 1024-key chunk) and at its own (one refresh per F32_KEY_TILE
    keys), within the float32 limit, one launch per call."""
    from repro_torch.kernels.flash_attention.kernel import (
        F32_KEY_TILE, flash_attention_fwd, flash_attention_plain)
    off, kv_len = shape[6], shape[7]
    q, k, v = _f32_inputs(shape, cuda, shape[1] + shape[5])
    before = _flash_counts()
    got = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    assert _one_launch_of(torch.float32, before)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for chunk_kv in (1024, F32_KEY_TILE):
        want = flash_attention_plain(q, k, v, q_offset=off, kv_len=kv_len,
                                     chunk_kv=chunk_kv)
        assert float((got - want).abs().max()) <= FLASH_ATOL[torch.float32]


@pytest.mark.parametrize("shape", [(2, 1024, 1024, 32, 8, 64, 0, None),
                                   (1, 96, 96, 32, 8, 64, 0, None),
                                   (2, 256, 256, 24, 8, 128, 0, None),
                                   (1, 96, 128, 8, 2, 32, 0, 77)], ids=str)
def test_flash_attention_f32_is_deterministic(cuda, shape):
    """Two launches of the float32 kernel on the same inputs give the same
    bits: no atomics, a fixed order of sums."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    off, kv_len = shape[6], shape[7]
    q, k, v = _f32_inputs(shape, cuda, shape[1] + shape[3])
    before = _flash_counts()
    first = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    second = flash_attention_fwd(q, k, v, off, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _flash_counts()[torch.float32] == before[torch.float32] + 2
    assert torch.equal(first, second)


def test_flash_attention_f32_does_not_spill(cuda):
    """ptxas reports no spill bytes for any instantiation of the float32
    kernel (every padded head_dim from 16 to 256, both tilings)."""
    from repro_torch.kernels import build
    log = build.build_all(["flash_attention"])["flash_attention"] \
        .with_suffix(".log")
    spills = [line for line in log.read_text().splitlines()
              if "spill" in line]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                          for line in spills), spills


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q[..., :44].contiguous(),
                            k[..., :44].contiguous(), k[..., :44].contiguous())
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_fwd(q, k, k, kv_len=9)
    with pytest.raises(ValueError, match="chunk_kv"):
        flash_attention_fwd(q, k, k, chunk_kv=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, k)
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(q, k, k, window=-1)


# (B, Sq, Skv, H, K, hd, q_offset, kv_len, window): zamba2's hd = 80 at a
# serve's prefill shape; mixtral's windowed prefill (hd = 128, window
# 4096, a prompt longer than it); hd = 8, 24, 72 and 256 with and without
# a window, with q_offset > 0 and kv_len < Skv (every row keeps a key in
# its window)
FLASH_NEW_SHAPES = [(2, 256, 256, 32, 32, 80, 0, None, 0),
                    (2, 5120, 5120, 32, 8, 128, 0, None, 4096),
                    (2, 300, 300, 8, 2, 8, 0, None, 0),
                    (2, 300, 300, 8, 2, 8, 0, None, 100),
                    (1, 200, 240, 8, 2, 24, 40, 230, 0),
                    (1, 200, 240, 8, 2, 24, 40, 230, 64),
                    (2, 150, 180, 4, 4, 72, 20, 170, 33),
                    (1, 256, 300, 4, 2, 256, 30, 290, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_NEW_SHAPES, ids=str)
def test_flash_attention_window_and_head_dims_match_plain(cuda, shape,
                                                          dtype):
    """Both kernels at head_dims padded inside the launch and with a
    sliding window, against the plain version, at the model's chunk_kv
    and at one that ends inside a key tile."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    B, Sq, Skv, H, K, hd, off, kv_len, window = shape
    rng = np.random.default_rng(Sq + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                               device=cuda)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    for chunk_kv in ((1024,) if Sq > 1024 else (1024, 40)):
        before = _flash_counts()
        got = flash_attention_fwd(q, k, v, off, kv_len=kv_len, window=window,
                                  chunk_kv=chunk_kv)
        assert _one_launch_of(dtype, before)
        want = flash_attention_plain(q, k, v, q_offset=off, kv_len=kv_len,
                                     window=window, chunk_kv=chunk_kv)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert float((got.float() - want.float()).abs().max()) <= \
            FLASH_ATOL[dtype]


# non-causal (whisper-large-v3's prefill): the encoder's self-attention
# (B = 2, 1500 frames, H = K = 20, hd = 64: chunks of 1024 + 476 keys, a
# ragged last row tile), its cross-attention from prompts of 32 and 192
# tokens to the 1500 frames, and both with kv_len < Skv
FLASH_NONCAUSAL_SHAPES = [(2, 1500, 1500, 20, 20, 64, 0, None),
                          (2, 32, 1500, 20, 20, 64, 0, None),
                          (2, 192, 1500, 20, 20, 64, 0, None),
                          (2, 1500, 1500, 20, 20, 64, 0, 1391),
                          (1, 100, 300, 8, 2, 64, 0, 250)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_NONCAUSAL_SHAPES, ids=str)
def test_flash_attention_non_causal_matches_plain(cuda, shape, dtype):
    """Both kernels with causal=False against the plain version: every
    query sees every key below kv_len, Sq != Skv for cross-attention."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    B, Sq, Skv, H, K, hd, off, kv_len = shape
    rng = np.random.default_rng(Sq + Skv + 1)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                               device=cuda)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    before = _flash_counts()
    got = flash_attention_fwd(q, k, v, off, kv_len=kv_len, causal=False)
    assert _one_launch_of(dtype, before)
    want = flash_attention_plain(q, k, v, q_offset=off, kv_len=kv_len,
                                 causal=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    limit = _flash_limit(dtype, want)
    assert float((got.float() - want.float()).abs().max()) <= limit
    short = flash_attention_plain(q, k, v, q_offset=off,
                                  kv_len=(kv_len or Skv) - 1, causal=False)
    assert float((short.float() - want.float()).abs().max()) > limit
    causal = flash_attention_plain(q, k, v, q_offset=off, kv_len=kv_len)
    assert float((causal.float() - want.float()).abs().max()) > 0.1


def test_ssm_audio_and_vlm_serving_on_the_card(cuda):
    """Reduced xlstm, whisper (8 frames, the float32 kernel non-causal in
    its encoder and cross-attention) and internvl2 (4 patches) at float32
    on the card: each prefill dispatch launches the float32 kernel once
    per attention (whisper n_enc_layers + 2 n_layers, internvl2 n_layers,
    xlstm none), and the greedy streams of both modes equal the CPU run
    with the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_f32
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, lens in (("xlstm-1.3b", (12, 20, 12)),
                       ("whisper-large-v3", (12, 20, 12)),
                       ("internvl2-1b", (12, 20, 12))):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        per = {"ssm": 0, "audio": cfg.n_enc_layers + 2 * cfg.n_layers,
               "vlm": cfg.n_layers}[cfg.family]
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, device="cpu", seed=0).to(cuda)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        streams = []
        for model, mode in ((card, "device"), (card, "host"),
                            (cpu, "device")):
            eng = ServeEngine(cfg, model, n_slots=2, window=64, mode=mode,
                              decode_chunk=4)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
            before = flash_attention_f32.launches
            done, _ = eng.run()
            assert flash_attention_f32.launches - before == \
                (per * eng.admit_syncs if model is card else 0)
            streams.append({r.rid: r.out_tokens for r in done})
        assert streams[0] == streams[1] == streams[2]


def test_moe_and_hybrid_serving_on_the_card(cuda):
    """Reduced mixtral (prompts longer than its 32-token window) and
    zamba2 at float32 on the card: every prefill attention launches the
    float32 kernel, and the greedy streams of both modes equal the CPU
    run with the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_f32
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, lens in (("mixtral-8x7b", (40, 40, 36)),
                       ("zamba2-2.7b", (12, 20, 12))):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, device="cpu", seed=0).to(cuda)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        streams = []
        for model, mode in ((card, "device"), (card, "host"),
                            (cpu, "device")):
            eng = ServeEngine(cfg, model, n_slots=2, window=64, mode=mode,
                              decode_chunk=4)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
            before = flash_attention_f32.launches
            done, _ = eng.run()
            per = (cfg.n_layers // cfg.attn_every if cfg.attn_every
                   else cfg.n_layers)
            assert flash_attention_f32.launches - before == \
                (per * eng.admit_syncs if model is card else 0)
            streams.append({r.rid: r.out_tokens for r in done})
        assert streams[0] == streams[1] == streams[2]


def test_serving_on_the_card(cuda):
    """A reduced llama3.2-1b at float32 served on the card: every prefill
    attention launches the float32 kernel, device and host modes give the
    same greedy streams, and they equal the CPU run with the same
    weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_f32
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServeEngine
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="float32")
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, device="cpu", seed=0).to(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 12, 20, 7, 20)]
    streams = []
    for model, mode in ((card, "device"), (card, "host"), (cpu, "device")):
        eng = ServeEngine(cfg, model, n_slots=2, window=64, mode=mode,
                          decode_chunk=4)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        before = flash_attention_f32.launches
        done, _ = eng.run()
        launches = flash_attention_f32.launches - before
        assert launches == (cfg.n_layers * eng.admit_syncs
                            if model is card else 0)
        streams.append({r.rid: r.out_tokens for r in done})
    assert streams[0] == streams[1] == streams[2]


def test_layout_sweep_on_the_card(cuda):
    """SweepQuery(fidelity="layout") over the default 96-point lattice on
    the card: one scan launch per topology group (6), no one-step launch,
    96 clean geometry reports, and t_cell within 1e-9 of the port's CPU
    characterization with extracted parasitics."""
    from repro_torch import api
    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.spice.char_batch import characterize
    s = api.Session(device="cuda")
    fused_newton.launches = 0
    fused_newton_scan.launches = 0
    t = s.run(api.SweepQuery(fidelity="layout"))
    assert fused_newton_scan.launches == 6
    assert fused_newton.launches == 0
    assert s.executor.stats["geom_verifies"] == 96
    summary = t.geometry_summary()
    assert summary["all_clean"] and summary["n_verified"] == 96
    cpu = characterize(lattice_configs(), parasitics="extracted",
                       device="cpu")
    got = np.array([c.t_cell_s for c in t.transient])
    want = np.array([c.t_cell_s for c in cpu])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_sparse_sweep_on_the_card(cuda):
    """SweepQuery(solver="sparse") on the card launches no scan kernel and
    matches the port's CPU run of the sparse engine to 1e-9."""
    from repro_torch import api
    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.spice.char_batch import characterize
    q = dict(cells=("gc2t_nn",), word_sizes=(16,), num_words=(16, 64),
             wwlls=(False,))
    fused_newton_scan.launches = 0
    t = api.Session(device="cuda").run(
        api.SweepQuery(fidelity="transient", solver="sparse", **q))
    assert fused_newton_scan.launches == 0
    cpu = characterize(lattice_configs(**q), solver="sparse", device="cpu")
    np.testing.assert_allclose([c.t_cell_s for c in t.transient],
                               [c.t_cell_s for c in cpu], rtol=1e-9)


def test_sparse_sweep_repeats_on_the_card(cuda):
    """ROADMAP Queue 3 F1: the sparse engine's A @ v sums each row in
    pattern order on the card (not with `index_add_`'s atomics), so two
    runs of a sparse sweep give the same bits, and one product equals
    the CPU's bit for bit."""
    from repro_torch import api
    from repro_torch.core import timing
    from repro_torch.kernels.batched_solve import sparse
    q = api.SweepQuery(cells=("gc2t_np",), word_sizes=(16,),
                       num_words=(16, 64), wwlls=(False,),
                       fidelity="transient", solver="sparse")
    runs = [[c.t_cell_s for c in api.Session(device="cuda").run(q).transient]
            for _ in range(2)]
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64,
                                                       cell="gc2t_np")))
    sp = ckt.build_sparsity()
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.uniform(-1, 1, (64, sp.nnz)))
    v = torch.as_tensor(rng.uniform(-1, 1, (64, sp.n)))
    host = sparse.coo_matvec(sp, vals, v)
    card = sparse.coo_matvec(sp, vals.to(cuda), v.to(cuda))
    assert torch.equal(card.cpu(), host)


# -- the differentiable DSE path ---------------------------------------------
# the scan's backward (the implicit-function adjoint, plain torch) on the
# card against the same Function on the CPU, from the same operands. The
# limits follow the forward's (SCAN_ATOL): at f64 both runs are float64
# to round-off; mixed and f32 store the trajectory in float32, where one
# flipped rounding in the forward moves the roots the backward starts
# from by an ulp
SCAN_GRAD_RTOL = {"f64": 1e-7, "mixed": 1e-3, "f32": 5e-2}


@pytest.mark.parametrize("precision", list(SCAN_GRAD_RTOL))
def test_scan_backward_on_the_card(cuda, precision):
    from repro_torch.kernels.batched_solve import ops
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 64, "gc2t_np")))
    spec, pre, Ksrc, params, v0 = _scan_operands(ckt.build(device="cpu"),
                                                 precision, 16, "cpu")
    names = ("KCoh", "KPa", "KPg")
    weights = torch.randn(16, SCAN_STEPS, spec.n,
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = {k: pre[k].to(dev).requires_grad_() for k in names}
        leaves.update(Ksrc=Ksrc.to(dev).requires_grad_(),
                      params=params.to(dev).requires_grad_(),
                      v0=v0.to(dev).requires_grad_())
        p = dict({k: pre[k].to(dev) for k in ("KU", "Sb")},
                 **{k: leaves[k] for k in names})
        before = fused_newton_scan.launches
        vs = ops.fused_newton_scan(spec, p, leaves["Ksrc"], leaves["params"],
                                   leaves["v0"], iters=6, tol=1e-6)
        launched = fused_newton_scan.launches - before
        assert launched == (1 if dev == cuda else 0)
        loss = (vs.double() * weights.to(dev)).sum()
        got = torch.autograd.grad(loss, list(leaves.values()))
        assert fused_newton_scan.launches - before == launched
        for k, g in zip(leaves, got):
            assert g.device == leaves[k].device
            assert g.dtype == leaves[k].dtype and torch.isfinite(g).all(), k
        grads[str(dev)] = {k: g.double().cpu() for k, g in zip(leaves, got)}
    for k, want in grads["cpu"].items():
        err = float((grads[str(cuda)][k] - want).abs().max())
        assert err <= SCAN_GRAD_RTOL[precision] * float(want.abs().max()), \
            (k, err)


def test_t_cell_grad_on_the_card(cuda):
    """`t_cell_grad_fn` on the card: one scan launch forward, none
    backward; t_cell within 1e-9 and gradients within 1e-7 of the CPU."""
    from repro_torch.core.spice.char_batch import t_cell_grad_fn
    cfg = BankConfig(16, 16, cell="gc2t_np")
    x = np.array([[1.0, 1.0, 1.0], [0.97, 1.05, 0.92]])
    out = {}
    for dev in ("cpu", "cuda"):
        fn = t_cell_grad_fn(cfg, device=dev)
        k = torch.tensor(x, device=dev, requires_grad=True)
        fused_newton_scan.launches = 0
        t, valid = fn({"vdd_scale": k[:, 0], "w_read_scale": k[:, 1],
                       "bl_wire_scale": k[:, 2]})
        assert fused_newton_scan.launches == (1 if dev == "cuda" else 0)
        (g,) = torch.autograd.grad(t.sum(), k)
        assert fused_newton_scan.launches == (1 if dev == "cuda" else 0)
        assert valid.all()
        out[dev] = (t.detach().cpu().numpy(), g.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-7)


def test_optimize_query_on_the_card(cuda):
    """The README's OptimizeQuery through Session(device="cuda") against
    the CPU session: equal verdicts, knobs and objective within 1e-6."""
    from repro_torch import api
    q = api.OptimizeQuery(cell="gc2t_np", target_freq_hz=5e8,
                          target_ret_s=5e-5,
                          knobs=("vdd_scale", "w_read_scale"))
    card = api.Session(device="cuda").run(q).as_dict()
    host = api.Session(device="cpu").run(q).as_dict()
    for k in ("met", "seed_met", "fell_back", "improved"):
        assert card[k] == host[k], k
    for k, v in host["knobs"].items():
        assert card["knobs"][k] == pytest.approx(v, rel=1e-6), k
    assert card["objective_value"] == pytest.approx(host["objective_value"],
                                                    rel=1e-6)


# -- the compile service ------------------------------------------------------
def test_compile_service_launches_the_kernels(cuda):
    """`CompileService(device="cuda")`: a transient sweep request launches
    the scan kernel once per topology group, a simulated compile with
    solver "pallas" one warp Gauss-Jordan launch per Newton iteration
    (6 x 300); both responses equal the CPU service's (t_cell 1e-9 for
    the sweep, 5e-8 for the compile, the analytic fields 1e-12)."""
    import json

    from repro_torch.core.dse import lattice_configs
    from repro_torch.core.dse_batch import group_by_topology
    from repro_torch.kernels.batched_solve.kernel import batched_solve
    from repro_torch.launch.compile_service import CompileService
    sweep = dict(cells=["gc2t_nn", "gc2t_osos"], word_sizes=[16],
                 num_words=[16, 64], wwlls=[False, True])
    reqs = [{"id": "transient", "query": dict(
                sweep, type="sweep", fidelity="transient", solver="pallas")},
            {"id": "compile", "query": {
                "type": "compile", "simulate": True, "solver": "pallas",
                "cfg": {"word_size": 16, "num_words": 64,
                        "cell": "gc2t_nn"}}}]
    n_groups = len(group_by_topology(lattice_configs(**{
        k: tuple(v) for k, v in sweep.items()})))
    out = {}
    for dev in ("cuda", "cpu"):
        fused_newton_scan.launches = fused_newton.launches = 0
        batched_solve.launches = batched_solve.warp_launches = 0
        svc = CompileService(device=dev)
        out[dev] = {r["id"]: r for r in map(json.loads, svc.serve_lines(
            json.dumps(r) for r in reqs))}
        if dev == "cuda":
            assert fused_newton_scan.launches == n_groups
            assert fused_newton.launches == 0
            assert batched_solve.launches == batched_solve.warp_launches \
                == 6 * 300
    card, host = out["cuda"], out["cpu"]
    assert all(r["ok"] for r in card.values())
    rows = zip(card["transient"]["result"]["rows"],
               host["transient"]["result"]["rows"])
    for g, w in rows:
        assert g["cell"] == w["cell"] and g["wwlls"] == w["wwlls"]
        assert g["f_max_hz"] == pytest.approx(w["f_max_hz"], rel=1e-12)
        assert g["transient"]["t_cell_sim_s"] == pytest.approx(
            w["transient"]["t_cell_sim_s"], rel=1e-9)
    g, w = card["compile"]["result"], host["compile"]["result"]
    assert g["t_cell_sim_s"] == pytest.approx(w["t_cell_sim_s"], rel=5e-8)
    assert g["timing"]["t_read_s"] == pytest.approx(w["timing"]["t_read_s"],
                                                    rel=1e-12)


# -- training: the flash Function's backward and a reduced train step

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 300, 300, 8, 2, 64, 0, True),
                                   (2, 64, 150, 4, 4, 64, 0, False),
                                   (1, 600, 600, 8, 2, 128, 256, True)],
                         ids=str)
def test_flash_function_backward_matches_autograd_through_plain(cuda, shape,
                                                                dtype):
    """A CUDA flash call whose inputs require grad goes through the
    Function (one forward launch, an output with a grad_fn); its dq, dk,
    dv match autograd through the plain version: 1e-5 of the largest at
    float32, 2^-5 at bf16 (the kernel's output enters D = rowsum(dO O),
    and the plain version's autograd rounds p's gradient to bf16)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    B, Sq, Skv, H, K, hd, window, causal = shape
    rng = np.random.default_rng(Sq + Skv)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                   device=cuda)
                   for s in ((B, Sq, H, hd), (B, Skv, K, hd),
                             (B, Skv, K, hd), (B, Sq, H, hd)))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _flash_counts()
    o = ops.flash_attention(*ins, bq=128, bkv=256, causal=causal,
                            window=window)
    assert _one_launch_of(dtype, before) and o.grad_fn is not None
    got = torch.autograd.grad(o, ins, do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(
        *ref, causal=causal, window=window, chunk_q=128, chunk_kv=256),
        ref, do)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert float((g.float() - w.float()).abs().max()) <= \
            rtol * float(w.float().abs().max())


def test_reduced_train_step_on_the_card(cuda):
    """Two reduced llama train steps on the card against the CPU (the
    same initial state and batches) within the CPU parity limits, with
    the float32 flash kernel launched once per layer and step, and bit
    for bit the same when repeated."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="float32")
    bundle = steps.build_train(cfg, total_steps=50)
    init = bundle.init_state(Model(cfg, device="cpu", seed=0))
    data = SyntheticLMData(cfg.vocab_size, 64, 4)

    def run(device):
        state = interop.tree_map(lambda t: t.to(device), init)
        losses = []
        for s in range(2):
            state, m = bundle.step(state, steps.to_device(data.batch_at(s),
                                                          device))
            losses.append(float(m["loss"]))
        return interop.train_state_to_numpy(state), losses

    before = kernel.flash_attention_f32.launches
    card, card_l = run(cuda)
    assert kernel.flash_attention_f32.launches - before == 2 * cfg.n_layers
    again, again_l = run(cuda)
    host, host_l = run("cpu")
    assert again_l == card_l
    for a, b in zip(tree_leaves(card), tree_leaves(again)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(card_l, host_l):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(tree_leaves(card["params"]),
                    tree_leaves(host["params"])):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_mesh_prefill_on_the_card_launches_the_kernel(cuda):
    """The prefill bundle on a (1, 1) DeviceMesh over a one-rank nccl
    group (reduced llama in bf16, B = 2, S = 256): every layer launches
    the tensor-core flash kernel, the logits match the model's without a
    mesh within 1e-2 of the largest (the same operations on one rank),
    and the analyzer's flops, dots and bytes
    equal those of the same bundle run on fake tensors. The group is
    closed whatever happens."""
    import socket

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import hlo_analysis, mesh as M, steps
    from repro_torch.models.model import Model
    cfg = get_config("llama3.2-1b").reduced()
    shape = ShapeConfig("mesh_prefill", 256, 2, "prefill")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    M.open_group(1, backend="nccl", init_method=f"tcp://localhost:{port}")
    try:
        mesh = M.make_test_mesh(1, 1, device_type="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                               generator=torch.Generator().manual_seed(0),
                               dtype=torch.int32).to(cuda)
        b = steps.build(cfg, mesh, shape)
        before = kernel.flash_attention_tc.launches
        real, (lg, _, _), _ = hlo_analysis.analyze(
            b.fn, *b.shard({"tokens": tokens}))
        torch.cuda.synchronize()
        assert kernel.flash_attention_tc.launches == before + cfg.n_layers
        with FakeTensorMode():
            bf = steps.build(cfg, mesh, shape)
            fake, _, _ = hlo_analysis.analyze(bf.fn, *bf.inputs())
        for key in ("flops", "dot_count", "mem_bytes"):
            assert real[key] == fake[key], key
        want, _, _ = Model(cfg, device=cuda, seed=0).prefill(
            {"tokens": tokens})
        err = float((lg.full_tensor() - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max()), err
    finally:
        M.close_group()
