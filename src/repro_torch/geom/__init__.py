"""Generated bank geometry: the layout-fidelity tier.

`core.layout` answers "how big is the bank" analytically; this package
generates the geometry itself — track-grid rectangles placed
hierarchically (`placer`), ladder-routed wordlines/bitlines/buses
(`router`), checked against a width/spacing/enclosure rule deck plus an
LVS-lite connectivity pass (`verify`), and batched parasitic extraction
of per-segment wire R/C from the routed lengths (`extract`) that feeds
the transient characterization engine in place of the hand-modeled
bitline ladders (`SweepQuery(fidelity="layout")`).

Everything is host-side numpy over struct-of-arrays rectangle sets;
module footprints come from the same `layout.MODULE_GEOM` deck the
analytic floorplan uses, so the generated bank bounding box reproduces
`layout.floorplan` exactly (asserted in tests).

Port of `repro.geom`: host numpy only, no torch, so its reports equal
the reference's exactly (tests/test_torch_geom.py).
"""
from repro_torch.geom.grid import Rect, RuleDeck, Via
from repro_torch.geom.placer import BankGeometry, place_bank
from repro_torch.geom.router import route_bank
from repro_torch.geom.extract import (extract_lattice, extract_point,
                                      read_column_segments)
from repro_torch.geom.verify import check_rules, lvs_read_column, verify_bank

__all__ = ["Rect", "RuleDeck", "Via", "BankGeometry", "place_bank",
           "route_bank", "extract_lattice", "extract_point",
           "read_column_segments", "check_rules", "lvs_read_column",
           "verify_bank"]
