"""Port parity: the layout tier of `repro_torch` (`geom/`, extracted
parasitics in `timing.analyze` and `characterize`) against the JAX
reference, on the CPU.

Limits:
  * geometry (placement, routing, DRC, LVS, extraction) is host numpy in
    both packages, so reports, manifests and extracted values are held
    equal exactly;
  * `timing.analyze(parasitics="extracted")` 1e-12 relative to the
    reference under x64 (the analytic limit of tests/test_torch_core.py);
  * `characterize(parasitics="extracted")` t_cell 1e-9 relative at f64
    (the lattice limit of tests/test_torch_char_batch.py).
"""
import dataclasses
import json
import os

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.geom as ref_geom  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core import timing as ref_timing  # noqa: E402
from repro.core.bank import BankConfig as RefBankConfig  # noqa: E402
from repro.core.bank import build_bank as ref_build_bank  # noqa: E402
from repro.core.spice import char_batch as ref_cb  # noqa: E402
from repro.core.techfile import SYN40 as REF_SYN40  # noqa: E402
from repro.geom import extract as ref_gx  # noqa: E402
from repro.geom import grid as ref_grid  # noqa: E402
from repro.geom import verify as ref_verify  # noqa: E402
import repro_torch.geom as geom  # noqa: E402
from repro_torch.core import dse, timing  # noqa: E402
from repro_torch.core.bank import BankConfig, build_bank  # noqa: E402
from repro_torch.core.spice import char_batch  # noqa: E402
from repro_torch.core.techfile import SYN40  # noqa: E402
from repro_torch.geom import extract as gx  # noqa: E402
from repro_torch.geom import grid  # noqa: E402
from repro_torch.geom.grid import Rect  # noqa: E402
from repro_torch.geom.verify import check_rules, lvs_read_column  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the supported matrix of tests/test_geom.py
MATRIX = [(cell, ws, nw)
          for cell in ("gc2t_nn", "gc2t_np", "gc2t_osos", "gc3t",
                       "gc2t_hyb", "sram6t")
          for ws, nw in ((8, 32), (16, 64))]
RTOL_ANALYTIC = 1e-12
RTOL_T_CELL = 1e-9
# a 4-point extracted lattice: two topologies, 16 and 64 rows
LATTICE = dict(cells=("gc2t_nn", "gc2t_osos"), word_sizes=(16,),
               num_words=(16, 64), wwlls=(False,))


def _geom(cfg):
    return geom.route_bank(geom.place_bank(build_bank(cfg)))


def test_public_names_match_reference():
    assert geom.__all__ == ref_geom.__all__
    for name in geom.__all__:
        assert getattr(geom, name).__name__ == \
            getattr(ref_geom, name).__name__
    assert grid.WIRE_LAYERS == ref_grid.WIRE_LAYERS
    assert dataclasses.asdict(grid.RuleDeck.from_tech(SYN40)) == \
        dataclasses.asdict(ref_grid.RuleDeck.from_tech(REF_SYN40))
    rects = [Rect("m1", 0.0, 0.0, 10.0, 40.0, net="a"),
             Rect("m2", 5.0, 1.0, 95.0, 21.0, net="b", name="w")]
    got = grid.rects_to_soa(rects)
    want = ref_grid.rects_to_soa(
        [ref_grid.Rect(**dataclasses.asdict(r)) for r in rects])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert grid.bbox(rects) == ref_grid.bbox(
        [ref_grid.Rect(**dataclasses.asdict(r)) for r in rects])


@pytest.mark.parametrize("cell,ws,nw", MATRIX,
                         ids=[f"{c}-{w}x{n}" for c, w, n in MATRIX])
def test_verify_bank_matches_reference(cell, ws, nw):
    """Place + route + DRC + LVS + extraction: the whole report equals
    the reference's, and it is clean."""
    got = geom.verify_bank(BankConfig(ws, nw, cell=cell))
    want = ref_geom.verify_bank(RefBankConfig(ws, nw, cell=cell))
    assert got == want
    assert got["drc_clean"], got["drc_violations"]
    assert got["lvs_ok"], got["lvs_msg"]
    assert got["extract_bit_identical"]
    assert got["n_vias"] > 0 and got["n_wires"] > 0


def test_extract_lattice_bit_identical_to_point_and_reference():
    cfgs = [BankConfig(ws, nw, cell=cell) for cell, ws, nw in MATRIX]
    banks = [build_bank(c) for c in cfgs]
    lat = geom.extract_lattice(banks)
    want = ref_geom.extract_lattice(
        [ref_build_bank(RefBankConfig(ws, nw, cell=cell))
         for cell, ws, nw in MATRIX])
    assert lat.keys() == want.keys()
    for k in want:
        assert lat[k].dtype == want[k].dtype
        np.testing.assert_array_equal(lat[k], want[k])
    for i, cfg in enumerate(cfgs):
        point = geom.extract_point(_geom(cfg))
        for k, v in point.items():
            assert v == float(lat[k][i]), (cfg.cell, k)


def test_read_column_helpers_match_reference():
    for cell in ("gc2t_nn", "gc2t_osos", "gc3t", "sram6t"):
        bank = build_bank(BankConfig(16, 64, cell=cell))
        rbank = ref_build_bank(RefBankConfig(16, 64, cell=cell))
        assert gx.read_column_rc(bank) == ref_gx.read_column_rc(rbank)
        seg = geom.read_column_segments(bank, n_seg=8)
        rseg = ref_geom.read_column_segments(rbank, n_seg=8)
        assert seg.keys() == rseg.keys()
        for k in rseg:
            np.testing.assert_array_equal(seg[k], rseg[k])
        assert gx.ladder_elmore_s(seg["r_seg_ohm"], seg["c_seg_f"],
                                  r_drv=1e3, c_load=1e-15) == \
            ref_gx.ladder_elmore_s(rseg["r_seg_ohm"], rseg["c_seg_f"],
                                   r_drv=1e3, c_load=1e-15)


@pytest.mark.parametrize("cell,name", [
    ("gc2t_nn", "manifest_gc2t_nn_16x64.json"),
    ("gc2t_osos", "manifest_gc2t_osos_16x64.json")])
def test_manifest_matches_golden(cell, name):
    got = _geom(BankConfig(16, 64, cell=cell)).manifest()
    with open(os.path.join(GOLDEN, name)) as f:
        want = json.load(f)
    assert got == want


def test_drc_catches_planted_violations():
    """A short, a sliver and an escape each trip a distinct rule, with
    the reference's messages."""
    g = _geom(BankConfig(8, 32, cell="gc2t_nn"))
    rg = ref_geom.route_bank(ref_geom.place_bank(
        ref_build_bank(RefBankConfig(8, 32, cell="gc2t_nn"))))
    assert check_rules(g) == [] == ref_verify.check_rules(rg)
    w0 = g.wires[0]
    for rule, planted in (
            ("short", (w0.layer, w0.x0, w0.y0, w0.x1, w0.y1, "__other__",
                       "planted_short")),
            ("width", ("m2", 5000.0, 5000.0, 5010.0, 5500.0, "__sliver__",
                       "planted_sliver")),
            ("out of bank", ("m3", -500.0, 0.0, -400.0, 400.0, "__esc__",
                             "planted_escape"))):
        g.wires.append(Rect(*planted))
        rg.wires.append(ref_grid.Rect(*planted))
        got = check_rules(g)
        assert any(rule in v for v in got), rule
        assert got == ref_verify.check_rules(rg)
        g.wires.pop()
        rg.wires.pop()
    assert check_rules(g) == []


def test_lvs_catches_missing_bitline():
    g = _geom(BankConfig(8, 32, cell="gc2t_nn"))
    assert lvs_read_column(g) == (True, "ok")
    rbl = g.nets.pop("rbl_0")
    ok, msg = lvs_read_column(g)
    assert not ok and "rbl_0" in msg
    g.nets["rbl_0"] = rbl
    sram = _geom(BankConfig(8, 32, cell="sram6t"))
    with pytest.raises(ValueError):
        lvs_read_column(sram)


@pytest.mark.parametrize("cell", ["gc2t_nn", "gc2t_osos", "gc3t", "sram6t"])
def test_analyze_extracted_matches_reference(cell):
    """The extracted read path slows t_cell and the wordline against the
    hand models, and every field equals the x64 reference to 1e-12."""
    got = timing.analyze(build_bank(BankConfig(16, 64, cell=cell)),
                         parasitics="extracted")
    modeled = timing.analyze(build_bank(BankConfig(16, 64, cell=cell)))
    with jax.enable_x64(True):
        want = ref_timing.analyze(
            ref_build_bank(RefBankConfig(16, 64, cell=cell)),
            parasitics="extracted")
    g, w = got.as_dict(), want.as_dict()
    assert g.keys() == w.keys()
    for k, v in w.items():
        if isinstance(v, float):
            np.testing.assert_allclose(g[k], v, rtol=RTOL_ANALYTIC, err_msg=k)
        else:
            assert g[k] == v, k
    assert got.t_cell_s > modeled.t_cell_s
    assert got.t_wl_s > modeled.t_wl_s
    assert got.delay_stages >= modeled.delay_stages


@pytest.fixture(scope="module")
def extracted_chars():
    want = ref_cb.characterize(ref_dse.lattice_configs(**LATTICE),
                               parasitics="extracted")
    got = char_batch.characterize(dse.lattice_configs(**LATTICE),
                                  parasitics="extracted", device="cpu")
    modeled = char_batch.characterize(dse.lattice_configs(**LATTICE),
                                      device="cpu")
    return got, want, modeled


@pytest.mark.parametrize("field", ["t_cell_s", "t_cell_analytic_s",
                                   "rel_dev", "t_end_s"])
def test_characterize_extracted_matches_reference(extracted_chars, field):
    got, want, _ = extracted_chars
    assert len(got) == len(want) == 4
    have = np.array([getattr(g, field) for g in got])
    ref = np.array([getattr(w, field) for w in want])
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(have, ref, rtol=RTOL_T_CELL)


def test_characterize_extracted_exceeds_modeled(extracted_chars):
    """Extraction adds read-column RC, so t_cell grows at every point,
    by a few percent (the reference's 2.9-7.3% at 16x64)."""
    got, want, modeled = extracted_chars
    for g, w, m in zip(got, want, modeled, strict=True):
        assert (g.swing_ok, g.n_steps) == (w.swing_ok, w.n_steps)
        assert g.t_cell_s > m.t_cell_s
        assert (g.t_cell_s - m.t_cell_s) / m.t_cell_s < 0.25
