"""Ladder-style metal routing over a placed bank.

Layer plan (half-pitch widths from the RuleDeck; two wordline tracks
fit one cell row at every supported row pitch):

  m2  wordlines — GC: WWL at 1/4 row height (driven from the LEFT strip)
      and RWL at 3/4 (driven from the RIGHT strip); SRAM: one WL.
  m3  read bitlines (GC) / BL+BLb (SRAM), one ladder per column, SA end
      at the TOP with a via stack down to the sense-amp input; also the
      address buses (horizontal, bottom strip).
  m4  write bitlines (GC) jogging to the bottom-strip write drivers,
      plus the data-in/out pin stubs at the bank edge.

Every net records its DESIGNED segment lengths explicitly as
(layer, length_nm) pairs — computed from the closed forms in
`geom.extract`, in the same association order the batched
extractor uses — rather than re-deriving them from rect coordinate
differences (floating-point (y0+L)-y0 is not L). `extract_point` sums
these records; `extract_lattice` recomputes the closed forms
vectorized; the two are bit-identical.

Via stacks stagger their landing pads by column parity (and BL/BLb
index for SRAM) so pads stay spacing-clean at column pitches tighter
than pad + min_space. Packed (BEOL) banks route across the stacked
array only, with a VIA_TIP_NM tip past the array edge for the stacks,
and omit the peripheral buses — see docs/layout.md.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.geom import extract as ex
from repro_torch.geom.grid import Rect, Via
from repro_torch.geom.placer import BankGeometry

_ORDER = ("m1", "m2", "m3", "m4")
STAGGER_NM = 300.0     # pad-center offset between adjacent via stacks


@dataclass
class Net:
    """One routed net: designed segment lengths + via count + the
    indices of its wire rects in `geom.wires`."""
    name: str
    kind: str                      # wordline | bitline | bus | stub
    segments: List[Tuple[str, float]] = field(default_factory=list)
    n_vias: int = 0
    wire_ids: List[int] = field(default_factory=list)

    def length_nm(self, layer: Optional[str] = None) -> float:
        return sum(l for lay, l in self.segments
                   if layer is None or lay == layer)


def _wire(g: BankGeometry, net: Net, layer: str, x0, y0, x1, y1) -> None:
    net.wire_ids.append(len(g.wires))
    g.wires.append(Rect(layer, x0, y0, x1, y1, net=net.name))


def _hwire(g, net, layer, x0, x1, yc):
    w = g.deck.wire_width(layer)
    _hw = w / 2
    _wire(g, net, layer, min(x0, x1), yc - _hw, max(x0, x1), yc + _hw)


def _vwire(g, net, layer, xc, y0, y1):
    w = g.deck.wire_width(layer)
    _wire(g, net, layer, xc - w / 2, min(y0, y1), xc + w / 2,
          max(y0, y1))


def _pad_half(g: BankGeometry) -> float:
    return g.deck.via_size / 2 + g.deck.via_enclosure


def _via_stack(g: BankGeometry, net: Net, x: float, y: float,
               lo: str, hi: str) -> None:
    """Stacked cuts from `hi` down to `lo` + landing pads on every
    touched layer (pads are wider than the wire so the enclosure rule
    holds around each cut)."""
    vs, ph = g.deck.via_size, _pad_half(g)
    i0, i1 = _ORDER.index(lo), _ORDER.index(hi)
    for layer in _ORDER[i0:i1 + 1]:
        net.wire_ids.append(len(g.wires))
        g.wires.append(Rect(layer, x - ph, y - ph, x + ph, y + ph,
                            net=net.name, name=f"{net.name}:pad:{layer}"))
    for k in range(i0, i1):
        cut = Rect("via", x - vs / 2, y - vs / 2, x + vs / 2, y + vs / 2,
                   net=net.name, name=f"{net.name}:cut:{k}")
        g.vias.append(Via(cut, _ORDER[k], _ORDER[k + 1]))
        net.n_vias += 1


def _route_wordlines(g: BankGeometry) -> None:
    bank = g.bank
    ax1 = g.ax0 + g.aw
    left = g.block("left_port_address")
    right = g.block("right_port_address")
    aw = bank.cols * g.cw
    jw, jr = ex.wwl_jog_nm(bank), ex.rwl_jog_nm(bank)
    for r in range(bank.rows):
        y = g.row_y(r)
        if bank.is_gc:
            wwl = Net(f"wwl_{r}", "wordline")
            rwl = Net(f"rwl_{r}", "wordline")
            if g.packed:
                _hwire(g, wwl, "m2", g.ax0, ax1, y + g.ch / 4)
                _hwire(g, rwl, "m2", g.ax0, ax1, y + 3 * g.ch / 4)
            else:
                _hwire(g, wwl, "m2", left.x1 - left.w / 4, ax1,
                       y + g.ch / 4)
                _hwire(g, rwl, "m2", g.ax0, right.x0 + right.w / 4,
                       y + 3 * g.ch / 4)
            wwl.segments += [("m2", aw), ("m2", jw)]
            rwl.segments += [("m2", aw), ("m2", jr)]
            g.nets[wwl.name] = wwl
            g.nets[rwl.name] = rwl
        else:
            wl = Net(f"wl_{r}", "wordline")
            _hwire(g, wl, "m2", left.x1 - left.w / 4, ax1, y + g.ch / 2)
            wl.segments += [("m2", aw), ("m2", jr)]
            g.nets[wl.name] = wl


def _route_bitlines(g: BankGeometry) -> None:
    bank, tech = g.bank, g.bank.cfg.tech
    span = ex.col_span_nm(bank.rows, g.ch, tech.track)
    jt = ex.top_jog_nm(bank)
    jb = ex.bot_jog_nm(bank)
    ph = _pad_half(g)
    for c in range(bank.cols):
        x = g.col_x(c)
        stag = (c % 2) * STAGGER_NM
        if bank.is_gc:
            # read bitline: SA end (ladder segment 0) at the top, active
            # cell at the bottom — timing.read_netlist's orientation
            rbl = Net(f"rbl_{c}", "bitline")
            y_top = g.ay0 + span + jt
            _vwire(g, rbl, "m3", x, g.ay0, y_top)
            rbl.segments += [("m3", span), ("m3", jt)]
            _via_stack(g, rbl, x, y_top - ph - stag, "m1", "m3")
            g.nets[rbl.name] = rbl

            wbl = Net(f"wbl_{c}", "bitline")
            y_bot = g.ay0 - jb
            _vwire(g, wbl, "m4", x, y_bot, g.ay0 + span)
            wbl.segments += [("m4", span), ("m4", jb)]
            _via_stack(g, wbl, x, y_bot + ph + stag, "m1", "m4")
            g.nets[wbl.name] = wbl
        else:
            for j, name in ((0, f"bl_{c}"), (1, f"blb_{c}")):
                xj = g.ax0 + (c + (j + 1) / 3.0) * g.cw
                n = Net(name, "bitline")
                y_top, y_bot = g.ay0 + span + jt, g.ay0 - jb
                _vwire(g, n, "m3", xj, y_bot, y_top)
                n.segments += [("m3", span), ("m3", jt), ("m3", jb)]
                _via_stack(g, n, xj, y_top - ph - j * STAGGER_NM,
                           "m1", "m3")
                _via_stack(g, n, xj, y_bot + ph + j * STAGGER_NM,
                           "m1", "m3")
                g.nets[name] = n


def _route_buses(g: BankGeometry) -> None:
    """Address buses (m3, horizontal, lower part of the bottom strip —
    below the write-bitline landing pads at 3/4 depth) and per-data-bit
    pin stubs (m4, vertical, outer strip halves)."""
    bank, tech = g.bank, g.bank.cfg.tech
    bot = g.block("bottom_port_data")
    top = g.block("top_port_data")
    left = g.block("left_port_address")
    right = g.block("right_port_address")
    corner = g.block("ctrl_corner")
    if bot is None or top is None:
        return
    cx = corner.cx if corner is not None else g.ax0 + g.aw / 2
    n_addr = max(1, int(math.log2(max(bank.cfg.num_words, 2))))
    pitch = float(tech.m2_pitch)
    y = bot.y0 + pitch / 2
    spans = [("waddr", left.x0 + left.w / 2 if left is not None else g.ax0,
              cx)]
    if bank.is_gc and right is not None and right.w > 0:
        spans.append(("raddr", right.x0 + right.w / 2, cx))
    for tag, x0, x1 in spans:
        for b in range(n_addr):
            n = Net(f"{tag}_{b}", "bus")
            _hwire(g, n, "m3", x0, x1, y)
            n.segments.append(("m3", abs(x1 - x0)))
            g.nets[n.name] = n
            y += pitch

    ring_band = bot.y0
    for i in range(bank.cfg.word_size):
        x = g.col_x(i * bank.words_per_row)
        dout = Net(f"dout_{i}", "stub")
        y0, y1 = top.y1 - top.h / 4, g.bank_h - ring_band - 2 * pitch
        _vwire(g, dout, "m4", x, y0, y1)
        dout.segments.append(("m4", y1 - y0))
        g.nets[dout.name] = dout
        din = Net(f"din_{i}", "stub")
        y0, y1 = ring_band + 2 * pitch, bot.y0 + bot.h / 4
        _vwire(g, din, "m4", x, y0, y1)
        din.segments.append(("m4", y1 - y0))
        g.nets[din.name] = din


def route_bank(g: BankGeometry) -> BankGeometry:
    """Route wordlines, bitlines and peripheral buses in place; returns
    the same BankGeometry with `wires`/`vias`/`nets` filled."""
    _route_wordlines(g)
    _route_bitlines(g)
    if not g.packed:
        _route_buses(g)
    return g
