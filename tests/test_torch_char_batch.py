"""Port parity: batched transient characterization (`characterize`) of
`repro_torch` on the CPU against the JAX reference."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import dse as ref_dse  # noqa: E402
from repro.core.spice import char_batch as ref_cb  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.bank import BankConfig  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.core.spice.transient import Transient  # noqa: E402

LATTICE = dict(cells=("gc2t_nn", "gc2t_np"), word_sizes=(16, 32),
               num_words=(16, 32), wwlls=(False,))
RTOL_F64 = 1e-9


@pytest.fixture(scope="module")
def both_f64():
    ref = ref_cb.characterize(ref_dse.lattice_configs(**LATTICE))
    got = char_batch.characterize(dse.lattice_configs(**LATTICE),
                                  device="cpu")
    return ref, got


def test_lattice_configs_match_reference():
    ref = ref_dse.lattice_configs()
    got = dse.lattice_configs()
    assert len(got) == len(ref) == 96
    for r, g in zip(ref, got, strict=True):
        assert (r.word_size, r.num_words, r.cell, r.write_vt, r.wwlls,
                r.wwl_boost) == (g.word_size, g.num_words, g.cell,
                                 g.write_vt, g.wwlls, g.wwl_boost)


@pytest.mark.parametrize("field", ["t_cell_s", "t_cell_analytic_s",
                                   "rel_dev", "t_end_s"])
def test_characterize_matches_reference_f64(both_f64, field):
    ref, got = both_f64
    assert len(got) == len(ref) == 8
    want = np.array([getattr(r, field) for r in ref])
    have = np.array([getattr(g, field) for g in got])
    assert np.isfinite(want).all()
    np.testing.assert_allclose(have, want, rtol=RTOL_F64)


def test_characterize_flags_match_reference(both_f64):
    ref, got = both_f64
    for r, g in zip(ref, got, strict=True):
        assert (g.swing_ok, g.n_steps, g.cfg.cell, g.cfg.word_size,
                g.cfg.num_words) == (r.swing_ok, r.n_steps, r.cfg.cell,
                                     r.cfg.word_size, r.cfg.num_words)


def test_mixed_precision_deviation_is_the_reference_s():
    """The mixed engine's own t_cell deviation from f64 (2.8e-6 on this
    point, the default lattice's worst) is a property of the reference,
    which the port reproduces: both precisions agree with the reference's
    to 1e-9."""
    cfg = dict(word_size=32, num_words=128, cell="gc2t_osos")
    ref = {p: ref_cb.characterize([ref_dse.BankConfig(**cfg)],
                                  precision=p)[0].t_cell_s
           for p in ("f64", "mixed")}
    got = {p: char_batch.characterize([BankConfig(**cfg)], precision=p,
                                      device="cpu")[0].t_cell_s
           for p in ("f64", "mixed")}
    for p in ref:
        np.testing.assert_allclose(got[p], ref[p], rtol=RTOL_F64)
    dev = abs(got["mixed"] - got["f64"]) / got["f64"]
    assert 1.5e-6 < dev < 3e-6, dev


def test_non_gain_cells_and_deferred_paths():
    out = char_batch.characterize([BankConfig(16, 16, cell="sram6t")],
                                  device="cpu")
    assert out == [None]
    # parasitics="extracted" (the layout tier) runs and matches the
    # reference
    got = char_batch.characterize(dse.lattice_configs(**LATTICE)[:1],
                                  parasitics="extracted", device="cpu")
    want = ref_cb.characterize(ref_dse.lattice_configs(**LATTICE)[:1],
                               parasitics="extracted")
    np.testing.assert_allclose(got[0].t_cell_s, want[0].t_cell_s,
                               rtol=RTOL_F64)
    with pytest.raises(ValueError):
        char_batch.characterize([], parasitics="bogus", device="cpu")
    # t_cell_grad_fn runs now (tests/test_torch_grad_dse.py); it refuses
    # what the reference refuses
    with pytest.raises(ValueError, match="single-ended"):
        char_batch.t_cell_grad_fn(BankConfig(16, 16, cell="sram6t"),
                                  device="cpu")
    with pytest.raises(ValueError, match="not differentiable"):
        char_batch.t_cell_grad_fn(BankConfig(16, 16), solver="jnp",
                                  device="cpu")


@pytest.mark.parametrize("solver", ["jnp", "sparse"])
def test_transient_other_solvers_are_deferred(solver):
    """Both other solvers run now: "jnp" (the dense stepper) and
    "sparse" (the sparse-LU engine, whose lattice run is held to the
    dense one within the reference's 1e-6 V)."""
    from repro_torch.core import timing
    from repro_torch.core.bank import build_bank
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 16)))
    system = ckt.build(device="cpu")
    if solver == "jnp":
        tr = Transient(system, solver=solver)
        out = tr.run([([0.0, 1.0], [1.1, 1.1])] * 4, 1e-10, n_steps=5,
                     v0=torch.full((system.n,), 1.1, dtype=torch.float64))
        assert out["all"].shape == (5, system.n)
        assert torch.isfinite(out["all"]).all()
        return
    wt = np.array([[[0.0, 1.0]] * 4])
    wv = np.array([[[1.1, 1.1], [0.0, 0.0], [1.1, 1.1], [1.1, 1.1]]])
    v0 = torch.full((system.n,), 1.1, dtype=torch.float64)
    got = Transient(system, solver=solver).run_lattice(
        wt, wv, [1e-10], 5, v0=v0)["all"]
    want = Transient(system, solver="jnp").run_lattice(
        wt, wv, [1e-10], 5, v0=v0)["all"]
    assert got.shape == (1, 5, system.n)
    assert float((got - want).abs().max()) <= 1e-6


def test_run_lattice_rejects_unknown_overrides():
    from repro_torch.core import timing
    from repro_torch.core.bank import build_bank
    ckt, _ = timing.read_netlist(build_bank(BankConfig(16, 16)))
    tr = Transient(ckt.build(device="cpu"), solver="pallas")
    with pytest.raises(ValueError, match="overrides"):
        tr.run_lattice(np.zeros((1, 4, 3)), np.zeros((1, 4, 3)), [1e-9], 4,
                       over_batches={"bogus": torch.ones(1)})
