"""Port parity: the copied deck, cell library, layout, bank and read-path
timing of `repro_torch` against the JAX reference, field by field, so the
copies cannot drift."""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import bank as ref_bank  # noqa: E402
from repro.core import cells as ref_cells  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core import dse_batch as ref_dse_batch  # noqa: E402
from repro.core import layout as ref_layout  # noqa: E402
from repro.core import techfile as ref_techfile  # noqa: E402
from repro.core import timing as ref_timing  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import bank, cells, dse, dse_batch, layout, techfile  # noqa: E402,E501
from repro_torch.core import timing  # noqa: E402

ALL_CFGS = list(zip(ref_dse.lattice_configs(), dse.lattice_configs()))


def test_syn40_matches_reference_field_by_field():
    ref = dataclasses.asdict(ref_techfile.SYN40)
    got = dataclasses.asdict(techfile.SYN40)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k], k
    assert techfile.PHI_T == ref_techfile.PHI_T


@pytest.mark.parametrize("name", sorted(ref_cells.CELLS))
def test_cells_match_reference_field_by_field(name):
    ref, got = ref_cells.CELLS[name], cells.CELLS[name]
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert cells.CELLS.keys() == ref_cells.CELLS.keys()


@pytest.mark.parametrize("flavor", ["nmos_hvt", "nmos_lvt", "os_n_hvt"])
def test_with_write_vt_matches_reference(flavor):
    ref = ref_cells.with_write_vt(ref_cells.CELLS["gc2t_nn"], flavor)
    got = cells.with_write_vt(cells.CELLS["gc2t_nn"], flavor)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_layout_constants_match_reference():
    for k in ("MODULE_GEOM", "RING_W_NM", "BLOCK_MARGIN_NM",
              "ROUTING_FACTOR", "GC_PORT_FACTOR", "PACK_FACTOR",
              "UM2_PER_NM2"):
        assert getattr(layout, k) == getattr(ref_layout, k), k


def test_with_vdd_scale_matches_reference():
    for s in (0.8, 1.0, 1.2):
        ref = ref_techfile.with_vdd_scale(ref_techfile.SYN40, s)
        got = techfile.with_vdd_scale(techfile.SYN40, s)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert techfile.with_vdd_scale(techfile.SYN40, 0.9) is \
        techfile.with_vdd_scale(techfile.SYN40, 0.9)


@pytest.mark.parametrize("i", range(0, len(ALL_CFGS), 8))
def test_bank_and_read_timing_match_reference(i):
    ref_cfg, cfg = ALL_CFGS[i]
    rb, b = ref_bank.build_bank(ref_cfg), bank.build_bank(cfg)
    assert b.summary() == rb.summary()
    assert b.plan.manifest() == rb.plan.manifest()
    assert bank.bitline_rc(b) == ref_bank.bitline_rc(rb)
    assert bank.wordline_rc(b) == ref_bank.wordline_rc(rb)
    assert timing.decoder_delay(b.rows) == ref_timing.decoder_delay(rb.rows)
    assert timing.wordline_delay(b) == ref_timing.wordline_delay(rb)
    with jax.enable_x64(True):
        t_ref, ok_ref = ref_timing.cell_read_time(rb)
    t_got, ok_got = timing.cell_read_time(b)
    assert ok_got == ok_ref
    np.testing.assert_allclose(t_got, t_ref, rtol=1e-12)
    v_sn = b.cell.v_sn_written(b.cfg.tech, 1)
    assert timing.read_stimulus(b.cell, b.cfg.tech, v_sn, 1e-11) == \
        ref_timing.read_stimulus(rb.cell, rb.cfg.tech, v_sn, 1e-11)


def test_sram_read_current_matches_reference():
    cfg = dict(word_size=16, num_words=16, cell="sram6t")
    with jax.enable_x64(True):
        t_ref = ref_timing.cell_read_time(
            ref_bank.build_bank(ref_bank.BankConfig(**cfg)))
        leak_ref = ref_cells.CELLS["sram6t"].cell_leakage(
            ref_techfile.SYN40)
    t_got = timing.cell_read_time(bank.build_bank(bank.BankConfig(**cfg)))
    np.testing.assert_allclose(t_got[0], t_ref[0], rtol=1e-12)
    np.testing.assert_allclose(
        cells.CELLS["sram6t"].cell_leakage(techfile.SYN40), leak_ref,
        rtol=1e-12)


def test_grouping_and_buckets_match_reference():
    ref_cfgs, cfgs = zip(*ALL_CFGS)
    assert list(dse_batch.group_by_topology(cfgs).values()) == \
        list(ref_dse_batch.group_by_topology(ref_cfgs).values())
    for n in (1, 3, 4, 5, 16, 17, 100):
        assert dse_batch.pow2_bucket(n) == ref_dse_batch.pow2_bucket(n)
        a = np.arange(n * 2.0).reshape(n, 2)
        b = dse_batch.pow2_bucket(n)
        np.testing.assert_array_equal(dse_batch.pad_bucket(a, b),
                                      ref_dse_batch.pad_bucket(a, b))


def test_interop_round_trips_reference_configs():
    tech = interop.techfile_from_dict(
        dataclasses.asdict(ref_techfile.SYN40))
    assert tech is techfile.SYN40
    hot = interop.techfile_from_dict(dataclasses.asdict(
        ref_techfile.with_vdd_scale(ref_techfile.SYN40, 1.2)))
    assert hot.vdd == pytest.approx(1.32) and hot is not techfile.SYN40
    for ref_cfg, cfg in ALL_CFGS[::7]:
        got = interop.bank_config_from_dict(dataclasses.asdict(ref_cfg))
        assert got == cfg and got.tech is techfile.SYN40
    d = dataclasses.asdict(ref_dse.lattice_configs()[0])
    d.pop("tech")
    assert interop.bank_config_from_dict(d).tech is techfile.SYN40


def test_deferred_parts_name_their_roadmap_item():
    from repro_torch.core import compiler
    for fn in (compiler.GCRAMCompiler, cells.v_sn_written_t, dse.evaluate):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
    b = bank.build_bank(bank.BankConfig(16, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        timing.analyze(b, parasitics="extracted")
