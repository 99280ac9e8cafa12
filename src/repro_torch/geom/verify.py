"""Geometry verification: rule checking + LVS-lite connectivity.

`check_rules` sweeps the generated rectangles against the RuleDeck —
width, spacing (different-net), shorts (different-net overlap), via
enclosure, block-level no-overlap and bank-bounds — vectorized per
layer over struct-of-arrays coordinate columns. The router targets the
same deck, so a clean result guards REFACTORS (a placer or router
change that pinches a pitch fails here, not in silicon-land fiction).

`lvs_read_column` is the connectivity check the paper's LVS step plays:
it re-derives the read-column netlist from GEOMETRY FACTS (the routed
rbl net + its via stack, the placed precharge/predischarge and sense-amp
instances, the read wordline) plus the cell library's device flavors,
then proves it isomorphic to `timing.read_netlist`'s MNA circuit by
Weisfeiler-Lehman color refinement over the union element/node graph —
element types, port roles (g/a/b vs resistor terminals) and source wave
bindings are the initial colors, so a swapped terminal, a missing
ladder segment or a precharge-vs-predischarge mixup all refine apart.

`verify_bank` is the one-call report the `fidelity="layout"` executor
node runs: place + route + DRC + LVS + extract, including the
batched-vs-scalar extraction bit-identity assertion.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.geom import extract as ex
from repro_torch.geom.grid import WIRE_LAYERS, Rect, rects_to_soa
from repro_torch.geom.placer import BankGeometry, place_bank
from repro_torch.geom.router import route_bank

EPS = 1e-6          # float slop on exact-by-construction dimensions
_MAX_REPORT = 20    # violations listed per check before truncating
_CHUNK = 512        # pairwise sweep row-block size


def _pairwise_layer(out: List[str], layer: str, rs: List[Rect],
                    space: float) -> None:
    """Different-net spacing + short sweep over one layer, blocked so the
    (n, n) separation matrix never materializes whole."""
    n = len(rs)
    if n < 2:
        return
    soa = rects_to_soa(rs)
    x0, y0, x1, y1 = soa["x0"], soa["y0"], soa["x1"], soa["y1"]
    nets = soa["net"]
    reported = 0
    for i0 in range(0, n, _CHUNK):
        i1 = min(i0 + _CHUNK, n)
        gx = np.maximum(x0[i0:i1, None] - x1[None, :],
                        x0[None, :] - x1[i0:i1, None])
        gy = np.maximum(y0[i0:i1, None] - y1[None, :],
                        y0[None, :] - y1[i0:i1, None])
        sep = np.maximum(gx, gy)
        diff = nets[i0:i1, None] != nets[None, :]
        upper = np.arange(n)[None, :] > np.arange(i0, i1)[:, None]
        bad = diff & upper & (sep < space - EPS)
        for bi, bj in zip(*np.nonzero(bad)):
            if reported >= _MAX_REPORT:
                out.append(f"{layer}: ... more spacing violations elided")
                return
            i, j = i0 + int(bi), int(bj)
            kind = "short" if sep[bi, bj] < -EPS else "spacing"
            out.append(
                f"{layer} {kind}: {nets[i] or rs[i].name!r} vs "
                f"{nets[j] or rs[j].name!r} sep={sep[bi, bj]:.0f}nm "
                f"< {space:.0f}nm")
            reported += 1


def check_rules(g: BankGeometry) -> List[str]:
    """All rule violations of one placed+routed bank ([] == clean)."""
    out: List[str] = []
    deck = g.deck
    bw, bh = g.bank_w, g.bank_h

    by_layer: Dict[str, List[Rect]] = defaultdict(list)
    for r in g.wires:
        by_layer[r.layer].append(r)

    for layer in WIRE_LAYERS:
        rs = by_layer.get(layer)
        if not rs:
            continue
        soa = rects_to_soa(rs)
        w = soa["x1"] - soa["x0"]
        h = soa["y1"] - soa["y0"]
        mn = np.minimum(w, h)
        for i in np.nonzero(mn < deck.min_width[layer] - EPS)[0][:_MAX_REPORT]:
            out.append(f"{layer} width: {rs[i].net or rs[i].name!r} "
                       f"{mn[i]:.0f}nm < {deck.min_width[layer]:.0f}nm")
        oob = ((soa["x0"] < -EPS) | (soa["y0"] < -EPS)
               | (soa["x1"] > bw + EPS) | (soa["y1"] > bh + EPS))
        for i in np.nonzero(oob)[0][:_MAX_REPORT]:
            out.append(f"{layer} out of bank: {rs[i].net or rs[i].name!r}")
        _pairwise_layer(out, layer, rs, deck.min_space[layer])

    # via cuts enclosed by same-net metal on both joined layers
    pads: Dict[Tuple[str, str], List[Rect]] = defaultdict(list)
    for r in g.wires:
        pads[(r.layer, r.net)].append(r)
    inset = deck.via_enclosure - EPS
    for via in g.vias:
        cut = via.rect
        for side in (via.lo, via.hi):
            if not any(r.contains(cut, inset)
                       for r in pads.get((side, cut.net), ())):
                out.append(f"via enclosure: {cut.name!r} not enclosed "
                           f"on {side}")
                if sum(v.startswith("via enclosure") for v in out) \
                        > _MAX_REPORT:
                    break

    # block-level: top-level "place" blocks and leaf "mod" rects must not
    # overlap within their own layer ("array" is a separate layer so a
    # BEOL array may stack over the packed periphery); ring frames of
    # DIFFERENT nets must not touch (same-net corner overlaps merge)
    place = [b for b in g.blocks if b.layer == "place"]
    for i, a in enumerate(place):
        for b in place[i + 1:]:
            if a.overlaps(b):
                out.append(f"place overlap: {a.name!r} vs {b.name!r}")
    rings = [b for b in g.blocks if b.layer == "ring"]
    for i, a in enumerate(rings):
        for b in rings[i + 1:]:
            if a.net != b.net and a.overlaps(b):
                out.append(f"ring short: {a.name!r} vs {b.name!r}")
    mods = [b for b in g.blocks if b.layer == "mod"]
    if len(mods) > 1:
        soa = rects_to_soa(mods)
        x0, y0, x1, y1 = soa["x0"], soa["y0"], soa["x1"], soa["y1"]
        reported = 0
        for i0 in range(0, len(mods), _CHUNK):
            i1 = min(i0 + _CHUNK, len(mods))
            ox = (x0[i0:i1, None] < x1[None, :] - EPS) & \
                 (x0[None, :] < x1[i0:i1, None] - EPS)
            oy = (y0[i0:i1, None] < y1[None, :] - EPS) & \
                 (y0[None, :] < y1[i0:i1, None] - EPS)
            upper = np.arange(len(mods))[None, :] > \
                np.arange(i0, i1)[:, None]
            for bi, bj in zip(*np.nonzero(ox & oy & upper)):
                if reported >= _MAX_REPORT:
                    out.append("mod: ... more overlaps elided")
                    return out
                out.append(f"mod overlap: {mods[i0 + int(bi)].name!r} vs "
                           f"{mods[int(bj)].name!r}")
                reported += 1
    return out


# ---------------------------------------------------------------------------
# LVS-lite: extracted netlist vs the MNA read-column circuit
# ---------------------------------------------------------------------------

def _circuit_graph(ckt):
    """(initial colors, adjacency) of the element/node multigraph."""
    colors: List[tuple] = [("gnd",) if i == 0 else ("node",)
                           for i in range(len(ckt.names))]
    adj: List[List[tuple]] = [[] for _ in colors]

    def elem(color, ports):
        vid = len(colors)
        colors.append(color)
        adj.append([])
        for lbl, nd in ports:
            adj[vid].append((lbl, nd))
            adj[nd].append((lbl, vid))

    for a, b, _gv in ckt.res:
        elem(("r",), [("t", a), ("t", b)])
    for a, b, _cv in ckt.caps:
        elem(("c",), [("t", a), ("t", b)])
    for d in ckt.devs:
        elem(("dev", d["pol"]),
             [("g", d["g"]), ("a", d["a"]), ("b", d["b"])])
    for nd, wave in ckt.vsrcs:
        elem(("v", int(wave)), [("p", nd)])
    return colors, adj


def _wl_isomorphic(ckt_a, ckt_b) -> bool:
    """Weisfeiler-Lehman color refinement over the DISJOINT UNION of both
    circuit graphs (shared interning arena, so colors are comparable);
    isomorphic-for-our-purposes iff the final color multisets match."""
    ca, aa = _circuit_graph(ckt_a)
    cb, ab = _circuit_graph(ckt_b)
    off = len(ca)
    colors = ca + cb
    adj = [list(e) for e in aa] + \
          [[(lbl, u + off) for lbl, u in e] for e in ab]
    intern: Dict[tuple, int] = {}
    cur = [intern.setdefault(c, len(intern)) for c in colors]
    n_colors = len(intern)
    for _ in range(len(cur)):
        intern = {}
        cur = [intern.setdefault(
            (cur[v], tuple(sorted((lbl, cur[u]) for lbl, u in adj[v]))),
            len(intern)) for v in range(len(cur))]
        if len(intern) == n_colors:
            break
        n_colors = len(intern)
    return sorted(cur[:off]) == sorted(cur[off:])


def lvs_read_column(g: BankGeometry,
                    n_seg: int = 8) -> Tuple[bool, str]:
    """Extract the read-column netlist from geometry facts and prove it
    isomorphic to `timing.read_netlist`. Gain-cell banks only."""
    from repro_torch.core import timing as timing_mod
    from repro_torch.core.spice.mna import Circuit

    bank = g.bank
    if not bank.is_gc:
        raise ValueError("no single-ended read column to LVS "
                         f"(cell {bank.cfg.cell!r})")
    tech, cell = bank.cfg.tech, bank.cell
    problems = []
    rbl = g.nets.get("rbl_0")
    if rbl is None:
        return False, "no routed rbl_0 net"
    if rbl.n_vias != ex.N_BL_VIAS_GC:
        problems.append(f"rbl_0 via stack has {rbl.n_vias} cuts, "
                        f"expected {ex.N_BL_VIAS_GC}")
    if g.nets.get("rwl_0") is None:
        problems.append("no routed rwl_0 net")

    pre_mods = [b for b in g.blocks if b.layer == "mod" and
                b.name.startswith(("precharge", "predischarge"))]
    if not pre_mods:
        return False, "no placed precharge/predischarge instance"
    pre_high = pre_mods[0].name.startswith("precharge")
    if not any(b.layer == "mod" and b.name.startswith(("sa_", "sense_amp"))
               for b in g.blocks):
        problems.append("no placed sense amp")
    # geometric port binding: the column-0 bitline must run through the
    # x-span of a precharge instance (packed banks stack over the full
    # periphery slab instead)
    x_bl = g.col_x(0)
    if not g.packed and not any(b.x0 - EPS <= x_bl <= b.x1 + EPS
                                for b in pre_mods):
        problems.append("rbl_0 misses every precharge instance x-span")

    rc = ex.extract_point(g)
    ckt = Circuit()
    ckt.vsrc("rwl", 0)
    ckt.vsrc("pre_en", 1)
    if pre_high:
        ckt.vsrc("vdd", 3)
        ckt.dev(tech.flavor("pmos_svt"), 1.2, 0.04, "pre_en", "vdd",
                "rbl_0", name="precharge")
    else:
        ckt.dev(tech.flavor("nmos_svt"), 1.2, 0.04, "pre_en", "rbl_0",
                "0", name="predischarge")
    for i in range(n_seg):
        ckt.r(f"rbl_{i}", f"rbl_{i+1}", rc["bl_r_ohm"] / n_seg)
        ckt.c(f"rbl_{i+1}", "0", rc["bl_c_f"] / n_seg)
    ckt.c("rbl_0", "0", timing_mod.SA_INPUT_C_F)
    ckt.vsrc("sn", 2)
    ckt.dev(cell.rf(tech), cell.w_read, cell.l_read, "sn",
            f"rbl_{n_seg}", "rwl", name="read_dev")

    ref, _ = timing_mod.read_netlist(bank, n_seg=n_seg)
    if not _wl_isomorphic(ckt, ref):
        problems.append("extracted netlist not isomorphic to MNA circuit")
    return (not problems), ("; ".join(problems) or "ok")


def verify_bank(bank_or_cfg, n_seg: int = 8) -> dict:
    """Place + route + DRC + LVS-lite + extraction bit-parity for one
    bank; the JSON-able report the layout-tier executor node persists."""
    from repro_torch.core.bank import BankConfig, build_bank
    bank = build_bank(bank_or_cfg) \
        if isinstance(bank_or_cfg, BankConfig) else bank_or_cfg
    g = route_bank(place_bank(bank))
    drc = check_rules(g)
    point = ex.extract_point(g)
    lat = ex.extract_lattice([bank], deck=g.deck)
    bit_identical = all(point[k] == float(lat[k][0]) for k in point)
    if bank.is_gc:
        lvs_ok, lvs_msg = lvs_read_column(g, n_seg=n_seg)
    else:
        lvs_ok, lvs_msg = True, "skipped: differential column (SRAM)"
    return {
        "cell": bank.cfg.cell, "word_size": bank.cfg.word_size,
        "num_words": bank.cfg.num_words, "rows": bank.rows,
        "cols": bank.cols, "packed": g.packed,
        "bank_w_nm": int(round(g.bank_w)),
        "bank_h_nm": int(round(g.bank_h)),
        "n_blocks": len(g.blocks), "n_wires": len(g.wires),
        "n_vias": len(g.vias),
        "drc_clean": not drc, "drc_violations": drc,
        "lvs_ok": lvs_ok, "lvs_msg": lvs_msg,
        "extract": point, "extract_bit_identical": bool(bit_identical),
    }
