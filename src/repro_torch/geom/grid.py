"""Track-grid rectangle primitives and the rule deck.

All coordinates are NANOMETERS, y-up, bank origin at (0, 0). A `Rect`
is one axis-aligned rectangle on one layer with an optional net label;
module placements live on the "place" layer (and "array" for the
bitcell array block, so a BEOL array may legally stack over the "place"
periphery), wires on "m1".."m4", cut shapes on "via".

The `RuleDeck` derives width/spacing minima from the TechFile pitches
(half-pitch rules) — the same deck `verify.check_rules` enforces and
the router targets, so a clean bank is clean BY CONSTRUCTION and the
checker guards refactors rather than tuning.

`rects_soa` flattens a rect list into struct-of-arrays numpy columns —
the form the vectorized DRC sweeps and batched extraction consume.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.techfile import TechFile

# routing direction convention per layer (ladder routing alternates)
H_LAYERS = ("m2",)            # wordlines, address bus
V_LAYERS = ("m1", "m3", "m4")  # pins/risers, read bitlines, write bitlines
WIRE_LAYERS = ("m1", "m2", "m3", "m4")


@dataclass(frozen=True)
class Rect:
    layer: str
    x0: float
    y0: float
    x1: float
    y1: float
    net: str = ""
    name: str = ""

    @property
    def w(self) -> float:
        return self.x1 - self.x0

    @property
    def h(self) -> float:
        return self.y1 - self.y0

    @property
    def cx(self) -> float:
        return 0.5 * (self.x0 + self.x1)

    @property
    def cy(self) -> float:
        return 0.5 * (self.y0 + self.y1)

    def overlaps(self, o: "Rect") -> bool:
        return (self.x0 < o.x1 and o.x0 < self.x1
                and self.y0 < o.y1 and o.y0 < self.y1)

    def contains(self, o: "Rect", inset: float = 0.0) -> bool:
        return (self.x0 + inset <= o.x0 and o.x1 <= self.x1 - inset
                and self.y0 + inset <= o.y0 and o.y1 <= self.y1 - inset)


@dataclass(frozen=True)
class Via:
    """One cut connecting two wire layers at a point; `lo`/`hi` name the
    layers it joins (a multi-layer stack is emitted as one Via per hop
    so enclosure checks stay per-pair)."""
    rect: Rect
    lo: str
    hi: str


def snap(v: float, pitch: float) -> float:
    """Snap DOWN onto the track grid."""
    return pitch * int(v // pitch)


def snap_up(v: float, pitch: float) -> float:
    return pitch * -int(-v // pitch)


@dataclass(frozen=True)
class RuleDeck:
    """Width / spacing / enclosure minima (nm) per layer, plus the cut
    size and the per-cut parasitics the extractor charges."""
    min_width: Dict[str, float]
    min_space: Dict[str, float]
    via_size: float
    via_enclosure: float
    block_space: float
    r_via_ohm: float = 2.0
    c_via_f: float = 0.05e-15

    @classmethod
    def from_tech(cls, tech: TechFile) -> "RuleDeck":
        # half-pitch width/space on the routing layers; m3/m4 have no
        # pitch entry in the deck, so they inherit the m2 pitch (upper
        # metals in a 40 nm-class BEOL are no tighter than m2)
        pitch = {"m1": float(tech.m1_pitch), "m2": float(tech.m2_pitch),
                 "m3": float(tech.m2_pitch), "m4": float(tech.m2_pitch)}
        return cls(
            min_width={l: p / 2.0 for l, p in pitch.items()},
            min_space={l: p / 2.0 for l, p in pitch.items()},
            via_size=float(tech.m1_pitch) / 2.0,
            via_enclosure=float(tech.min_l_nm) / 2.0,
            block_space=100.0,
        )

    def wire_width(self, layer: str) -> float:
        return self.min_width[layer]


def rects_to_soa(rects: Sequence[Rect]) -> Dict[str, np.ndarray]:
    """Struct-of-arrays view of a rect list (the vectorized-DRC form):
    float64 coordinate columns + object columns for layer/net."""
    return {
        "layer": np.array([r.layer for r in rects], dtype=object),
        "net": np.array([r.net for r in rects], dtype=object),
        "x0": np.array([r.x0 for r in rects], dtype=np.float64),
        "y0": np.array([r.y0 for r in rects], dtype=np.float64),
        "x1": np.array([r.x1 for r in rects], dtype=np.float64),
        "y1": np.array([r.y1 for r in rects], dtype=np.float64),
    }


def bbox(rects: Sequence[Rect]) -> Tuple[float, float, float, float]:
    return (min(r.x0 for r in rects), min(r.y0 for r in rects),
            max(r.x1 for r in rects), max(r.y1 for r in rects))
