"""Hierarchical bank placement: `layout.floorplan` strips -> rectangles.

`place_bank(bank)` consumes the SAME floorplan the analytic model emits
(`bank.plan.modules`, in um) for the top-level blocks, so the generated
bank bounding box reproduces `layout.floorplan` exactly, then fills each
strip with leaf module rectangles:

  left strip    per-row write decoder + WL driver (+ WWL level shifter)
  right strip   per-row read decoder + WL driver          (GC dual port)
  top strip     per-column precharge/predischarge (+ read colmux), then
                per-data-bit sense amps and output DFFs, stacked inward
                -> outward
  bottom strip  per-data-bit write drivers (+ write colmux), input DFFs
  corner strip  control FSMs + reference generator + address DFFs (the
                width `floorplan` folds into core_w)
  rings         n_rings supply-pair frames on the dedicated "ring" layer

Leaf footprints come from `layout.MODULE_GEOM`; a module wider than its
row/column pitch is folded AREA-PRESERVING to the pitch (w = pitch,
h = area / w) — the pitch-matching every real compiler does.

Layers: "place" top-level blocks, "mod" leaves, "array" the bitcell
array (its own layer so a BEOL array may legally stack over the packed
periphery), "ring" the power frames. Wires/vias are added by
`geom.router`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import layout
from repro_torch.core.bank import Bank
from repro_torch.geom.grid import Rect, RuleDeck, Via

NM_PER_UM = 1000.0
RAIL_ROWS_PER = 16       # must match layout.floorplan's rail_rows_per


def _mod_wh(tech, kind: str):
    pp, tr = layout.MODULE_GEOM[kind]
    return pp * tech.cpp, tr * tech.track


@dataclass
class BankGeometry:
    """One placed (and, after `route_bank`, routed) bank."""
    bank: Bank
    deck: RuleDeck
    packed: bool
    blocks: List[Rect] = field(default_factory=list)
    wires: List[Rect] = field(default_factory=list)
    vias: List[Via] = field(default_factory=list)
    nets: Dict[str, object] = field(default_factory=dict)  # router.Net
    # array frame in nm (origin = bank lower-left corner, y up)
    ax0: float = 0.0
    ay0: float = 0.0
    aw: float = 0.0
    ah: float = 0.0
    cw: float = 0.0
    ch: float = 0.0

    @property
    def bank_w(self) -> float:
        return self.bank.plan.bank_w_um * NM_PER_UM

    @property
    def bank_h(self) -> float:
        return self.bank.plan.bank_h_um * NM_PER_UM

    def block(self, name: str) -> Optional[Rect]:
        for r in self.blocks:
            if r.name == name:
                return r
        return None

    def row_y(self, r: int) -> float:
        """Bottom edge of cell row r (rail rows every RAIL_ROWS_PER)."""
        track = self.bank.cfg.tech.track
        return self.ay0 + (r // RAIL_ROWS_PER + 1) * 2 * track + r * self.ch

    def col_x(self, c: int) -> float:
        """Center x of cell column c."""
        return self.ax0 + (c + 0.5) * self.cw

    def manifest(self) -> dict:
        """Compact JSON-able record (int nm) — the golden-file surface:
        top-level block bboxes, ring count, per-layer wire stats, via
        count, and the place-layer no-overlap invariant."""
        place = [b for b in self.blocks if b.layer == "place"]
        top = {b.name: [int(round(v)) for v in
                        (b.x0, b.y0, b.x1, b.y1)] for b in place}
        arr = self.block("bitcell_array")
        if arr is not None:
            top[arr.name] = [int(round(v)) for v in
                             (arr.x0, arr.y0, arr.x1, arr.y1)]
        overlap = any(a.overlaps(b) for i, a in enumerate(place)
                      for b in place[i + 1:])
        layers: Dict[str, dict] = {}
        for w in self.wires:
            d = layers.setdefault(w.layer, {"n": 0, "length_nm": 0})
            d["n"] += 1
            d["length_nm"] += int(round(max(w.w, w.h)))
        return {
            "bank_w_nm": int(round(self.bank_w)),
            "bank_h_nm": int(round(self.bank_h)),
            "rows": self.bank.rows, "cols": self.bank.cols,
            "packed": self.packed,
            "blocks": dict(sorted(top.items())),
            "n_mod_blocks": sum(b.layer == "mod" for b in self.blocks),
            "n_rings": sum(b.layer == "ring" and b.name.endswith(":S")
                           for b in self.blocks) // 2,
            "wires": dict(sorted(layers.items())),
            "n_vias": len(self.vias),
            "no_overlap": not overlap,
        }


def _ring_frames(g: BankGeometry, n_rings: int, wwlls: bool) -> None:
    """Per ring: two concentric supply frames (a vdd/vss pair), each
    40% of RING_W_NM wide, 10% gap — four rects per frame, overlapping
    at the corners (same net, so the checker merges them)."""
    W = layout.RING_W_NM
    bw, bh = g.bank_w, g.bank_h
    for k in range(n_rings):
        nets = ("vdd", "vss") if k == 0 else ("vddh", "vssh")
        for j, net in enumerate(nets):
            off = k * W + (0.05 + 0.55 * j) * W
            t = 0.4 * W
            frame = (("S", off, off, bw - off, off + t),
                     ("N", off, bh - off - t, bw - off, bh - off),
                     ("W", off, off, off + t, bh - off),
                     ("E", bw - off - t, off, bw - off, bh - off))
            for side, x0, y0, x1, y1 in frame:
                g.blocks.append(Rect("ring", x0, y0, x1, y1, net=net,
                                     name=f"ring{k}:{net}:{side}"))


def _fold(native_w: float, native_h: float, pitch: float):
    """Pitch-match: fold a module wider than `pitch` area-preserving."""
    if native_w <= pitch:
        return native_w, native_h
    return pitch, native_w * native_h / pitch


def _col_row(g: BankGeometry, kind: str, y: float, pitch: float,
             n: int, x_of, tag: str) -> float:
    """One row of n pitch-matched module instances; returns row height."""
    tech = g.bank.cfg.tech
    w, h = _fold(*_mod_wh(tech, kind), pitch)
    for i in range(n):
        xc = x_of(i)
        g.blocks.append(Rect("mod", xc - w / 2, y, xc + w / 2, y + h,
                             name=f"{tag}_{i}"))
    return h


def _stack(g: BankGeometry, specs, x0: float, x1: float, y: float,
           up: bool = True) -> None:
    """Stack full-width slabs (name, area_nm2) from y, growing up/down."""
    w = x1 - x0
    for name, area in specs:
        if area <= 0 or w <= 0:
            continue
        h = area / w
        y0, y1 = (y, y + h) if up else (y - h, y)
        g.blocks.append(Rect("mod", x0, y0, x1, y1, name=name))
        y = y1 if up else y0


def _place_standard(g: BankGeometry) -> None:
    bank, tech = g.bank, g.bank.cfg.tech
    m = layout.BLOCK_MARGIN_NM
    left = g.block("left_port_address")
    right = g.block("right_port_address")
    top = g.block("top_port_data")
    bot = g.block("bottom_port_data")

    # -- side strips: per-row decoder/driver chain, driver at the inner
    # edge (it abuts the wordline it drives), decoder outboard
    def side(strip, inner_right: bool, kinds, tag):
        if strip is None or strip.w <= 0:
            return
        for r in range(bank.rows):
            y = g.row_y(r)
            x = strip.x1 if inner_right else strip.x0
            for kind in kinds:
                w, h = _fold(*_mod_wh(tech, kind), strip.w)
                h = min(h, g.ch)
                x0, x1 = (x - w, x) if inner_right else (x, x + w)
                g.blocks.append(Rect("mod", x0, y, x1, y + h,
                                     name=f"{tag}_{kind}_{r}"))
                x = x0 if inner_right else x1

    lkinds = ["wl_driver", "decoder_unit"]
    if bank.is_gc and bank.cfg.wwlls:
        lkinds = ["wwl_ls"] + lkinds
    side(left, True, lkinds, "w" if bank.is_gc else "rw")
    if bank.is_gc:
        side(right, False, ["wl_driver", "decoder_unit"], "r")

    # -- top strip: precharge row (per column), optional colmux, sense
    # amps + out DFFs (per data bit), stacked inner -> outer
    pre = "predischarge" if bank.is_gc and bank.cell.predischarge \
        else "precharge"
    sa = "sense_amp_se" if bank.is_gc else "sense_amp"
    bit_pitch = bank.words_per_row * g.cw
    bit_x = lambda i: g.col_x(i * bank.words_per_row)
    if top is not None and top.w > 0:
        y = top.y0
        y += _col_row(g, pre, y, g.cw, bank.cols, g.col_x, pre)
        if bank.has_colmux:
            y += _col_row(g, "colmux_unit", y, g.cw, bank.cols,
                          g.col_x, "r_colmux")
        y += _col_row(g, sa, y, bit_pitch, bank.cfg.word_size, bit_x, "sa")
        _col_row(g, "dff", y, bit_pitch, bank.cfg.word_size, bit_x,
                 "out_dff")

    # -- bottom strip: write drivers (+ write colmux), in DFFs, stacked
    # inner (top edge) -> outer (downward)
    wd = "write_driver" if bank.is_gc else "write_driver_diff"
    if bot is not None and bot.w > 0:
        y = bot.y1
        w, h = _fold(*_mod_wh(tech, wd), bit_pitch)
        y -= _col_row(g, wd, y - h, bit_pitch, bank.cfg.word_size,
                      bit_x, "wd")
        if bank.is_gc and bank.has_colmux:
            w, h = _fold(*_mod_wh(tech, "colmux_unit"), g.cw)
            y -= _col_row(g, "colmux_unit", y - h, g.cw, bank.cols,
                          g.col_x, "w_colmux")
        w, h = _fold(*_mod_wh(tech, "dff"), bit_pitch)
        _col_row(g, "dff", y - h, bit_pitch, bank.cfg.word_size, bit_x,
                 "in_dff")

    # -- corner strip: floorplan folds its width into core_w to the
    # right of the right strip; reconstruct it and stack control there
    rref = right if right is not None and right.w > 0 else \
        g.block("bitcell_array")
    cx0 = rref.x1 + (m if rref.name == "bitcell_array" else 0.0)
    ring_band = bot.y0 if bot is not None else \
        (left.x0 if left is not None else 0.0)
    cx1 = g.bank_w - ring_band
    if cx1 - cx0 > 1.0:
        y0, y1 = ring_band, g.bank_h - ring_band
        g.blocks.append(Rect("place", cx0, y0, cx1, y1,
                             name="ctrl_corner"))
        um2 = 1.0 / layout.UM2_PER_NM2
        specs = [("ctrl", bank.modules.get("ctrl", 0.0) * um2),
                 ("addr_dff", bank.modules.get("addr_dff", 0.0) * um2)]
        if bank.is_gc:
            specs.insert(0, ("refgen", bank.modules["refgen"] * um2))
        _stack(g, specs, cx0, cx1, y0, up=True)


def _place_packed(g: BankGeometry) -> None:
    """BEOL (OS-OS) floorplan: periphery slabs under the stacked array
    — per-layer no-overlap holds because the array is its own layer."""
    per = g.block("periphery(under array)")
    if per is None:
        return
    um2 = 1.0 / layout.UM2_PER_NM2
    specs = [(k, a * um2) for k, a in sorted(g.bank.modules.items())]
    _stack(g, specs, per.x0, per.x1, per.y0, up=True)


def place_bank(bank: Bank, deck: Optional[RuleDeck] = None
               ) -> BankGeometry:
    """Generate the placed geometry of one bank (no wires yet — see
    `router.route_bank`)."""
    tech = bank.cfg.tech
    deck = deck or RuleDeck.from_tech(tech)
    packed = bank.is_gc and getattr(bank.cell, "is_beol", False)
    g = BankGeometry(bank, deck, packed)
    cw, ch = layout.cell_wh_nm(tech, bank.cell.geom_key)
    g.cw, g.ch = cw, ch

    n_rings = 0
    for mod in bank.plan.modules:
        x0 = mod["x"] * NM_PER_UM
        y0 = mod["y"] * NM_PER_UM
        x1 = x0 + mod["w"] * NM_PER_UM
        y1 = y0 + mod["h"] * NM_PER_UM
        name = mod["name"]
        if name == "power_rings":
            n_rings = mod["rings"]
            g.blocks.append(Rect("outline", x0, y0, x1, y1, name=name))
            continue
        layer = "array" if name.startswith("bitcell_array") else "place"
        if name.startswith("bitcell_array"):
            g.ax0, g.ay0 = x0, y0
            g.aw, g.ah = x1 - x0, y1 - y0
            name = "bitcell_array"
        if x1 - x0 > 0 and y1 - y0 > 0:
            g.blocks.append(Rect(layer, x0, y0, x1, y1, name=name))

    _ring_frames(g, n_rings, bank.cfg.wwlls)
    if packed:
        _place_packed(g)
    else:
        _place_standard(g)
    return g
