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
