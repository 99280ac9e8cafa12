"""Port parity: MNA assembly (`Circuit.build_stamps`, `Circuit.build`) of
the read netlists against the JAX reference, and the analytic channel
partials against torch.autograd."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import timing as ref_timing  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core.bank import build_bank as ref_build_bank  # noqa: E402
from repro_torch.core import timing  # noqa: E402
from repro_torch.core.bank import BankConfig, build_bank  # noqa: E402
from repro_torch.core.spice import mna  # noqa: E402
from repro_torch.core.techfile import SYN40  # noqa: E402

CELLS = ("gc2t_nn", "gc2t_np", "gc2t_osos")


def _netlists(cell, n_seg=8):
    ref_ckt, ref_meta = ref_timing.read_netlist(
        ref_build_bank(RefBankConfig(16, 64, cell)), n_seg=n_seg)
    ckt, meta = timing.read_netlist(build_bank(BankConfig(16, 64, cell)),
                                    n_seg=n_seg)
    return ref_ckt, ref_meta, ckt, meta


@pytest.mark.parametrize("cell", CELLS)
def test_read_netlist_elements_match_reference(cell):
    ref_ckt, ref_meta, ckt, meta = _netlists(cell)
    assert ckt.names == ref_ckt.names
    assert ckt.res == ref_ckt.res
    assert ckt.caps == ref_ckt.caps
    assert ckt.vsrcs == ref_ckt.vsrcs
    assert ckt.probes == ref_ckt.probes
    assert ckt.devs == ref_ckt.devs
    assert meta == ref_meta


@pytest.mark.parametrize("cell", CELLS)
def test_build_stamps_match_reference_exactly(cell):
    ref_ckt, _, ckt, _ = _netlists(cell)
    for got, want in zip(ckt.build_stamps(), ref_ckt.build_stamps(),
                         strict=True):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cell", CELLS)
def test_build_matches_reference_exactly(cell):
    ref_ckt, _, ckt, _ = _netlists(cell)
    with jax.enable_x64(True):
        ref = ref_ckt.build()
        ref_G, ref_C = np.asarray(ref.G), np.asarray(ref.C)
        ref_dev = {k: np.asarray(v) for k, v in ref.dev.items()}
    got = ckt.build(device="cpu")
    assert got.G.dtype == torch.float64 and got.G.device.type == "cpu"
    np.testing.assert_array_equal(got.G.numpy(), ref_G)
    np.testing.assert_array_equal(got.C.numpy(), ref_C)
    assert set(got.dev) == set(ref_dev)
    for k, want in ref_dev.items():
        np.testing.assert_array_equal(got.dev[k].numpy(), want, err_msg=k)
    for k in ("g", "a", "b"):
        np.testing.assert_array_equal(got.didx[k], ref.didx[k])
        assert got.didx[k].dtype == ref.didx[k].dtype
    np.testing.assert_array_equal(got.src_node, ref.src_node)
    np.testing.assert_array_equal(got.src_wave, ref.src_wave)
    assert (got.n, got.probes, got.names) == (ref.n, ref.probes, ref.names)


@pytest.mark.parametrize("flavor", ["nmos_svt", "pmos_svt", "os_n"])
def test_analytic_grads_match_autograd(flavor):
    rng = np.random.default_rng(5)
    fl = SYN40.flavor(flavor)
    N = 300
    p = [torch.full((N,), v, dtype=torch.float64)
         for v in (float(fl.polarity), fl.vt0, fl.n_slope, fl.k_prime,
                   fl.lambda_)]
    w = torch.as_tensor(rng.uniform(0.1, 1.0, N))
    length = torch.as_tensor(rng.uniform(0.03, 0.08, N))
    volts = [torch.as_tensor(rng.uniform(-0.2, 1.3, N), dtype=torch.float64)
             .requires_grad_() for _ in range(3)]
    i = mna.channel_current_raw(*p, w, length, *volts)
    auto = torch.autograd.grad(i.sum(), volts)
    with torch.no_grad():
        grads = mna.channel_current_grads(*p, w, length, *volts)
        fused = mna.channel_current_and_grads(*p, w, length, *volts)
    torch.testing.assert_close(fused[0], i.detach(), rtol=0, atol=0)
    for a, g, f in zip(auto, grads, fused[1:], strict=True):
        scale = float(a.abs().max())
        torch.testing.assert_close(g, a, rtol=1e-10, atol=1e-12 * scale)
        torch.testing.assert_close(f, g, rtol=0, atol=0)


def test_build_sparsity_is_deferred():
    """`Circuit.build_sparsity` is ported (ROADMAP Queue 1 item 3): the
    pattern and its projections equal the reference's exactly."""
    ref_ckt, _, ckt, _ = _netlists("gc2t_nn")
    got, want = ckt.build_sparsity(), ref_ckt.build_sparsity()
    assert (got.n, got.nnz) == (want.n, want.nnz)
    for f in ("rows", "cols", "diag_pos", "dev_pos", "res_proj", "cap_proj",
              "src_nnz"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
