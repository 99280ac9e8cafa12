"""Design-space lattices.

Port of `repro.core.dse.lattice_configs`. The scalar evaluator
(`evaluate`, `DesignPoint`, `feasible`, `pareto`) is not ported yet.
"""
from __future__ import annotations

import itertools
from typing import List

from repro_torch._deferred import deferred
from repro_torch.core.bank import BankConfig
from repro_torch.core.cells import CELLS
from repro_torch.core.techfile import SYN40


def lattice_configs(cells=("gc2t_nn", "gc2t_np", "gc2t_osos"),
                    word_sizes=(16, 32, 64, 128),
                    num_words=(16, 32, 64, 128),
                    write_vts=(None,), wwlls=(False, True),
                    tech=SYN40) -> List[BankConfig]:
    """Expand a config lattice, skipping write-VT flavors that don't match
    the cell's device family (Si VT overrides on OS cells and vice versa)."""
    out = []
    for c, ws, nw, vt, ls in itertools.product(cells, word_sizes, num_words,
                                               write_vts, wwlls):
        wf = getattr(CELLS[c], "write_flavor", None)
        if vt is not None and (wf is None
                               or wf.startswith("os") != vt.startswith("os")):
            continue
        out.append(BankConfig(ws, nw, cell=c, write_vt=vt, wwlls=ls,
                              tech=tech))
    return out


evaluate = deferred("dse.evaluate", "Queue 1 item 8 (DSE)")
