"""Public entry of the array-step kernel and its parameter packing.

`gc_array_step` is the kernel wrapper itself (`kernel.gc_array_step`):
a CUDA tensor launches `csrc/gc_array_step.cu` (or raises), a CPU tensor
runs the plain torch version.
"""
from __future__ import annotations

from repro_torch.core.cells import CELLS, Bitcell
from repro_torch.core.techfile import SYN40, TechFile
from repro_torch.kernels.gc_array_step.kernel import gc_array_step
from repro_torch.kernels.gc_array_step.ref import gc_array_step_ref

__all__ = ["cell_params", "gc_array_step", "gc_array_step_ref"]


def cell_params(cell_name: str = "gc2t_nn", tech: TechFile = SYN40,
                c_bl: float = 20e-15, g_bl: float = 1e-4,
                v_bl_drv: float = 0.0) -> dict:
    """The 16 scalar parameters of the array step for one cell type."""
    cell: Bitcell = CELLS[cell_name]
    wf, rf = cell.wf(tech), cell.rf(tech)
    return {
        "vtw": wf.vt0, "nw": wf.n_slope, "kpw": wf.k_prime,
        "lamw": wf.lambda_, "ww": cell.w_write, "lw": cell.l_write,
        "vtr": rf.vt0, "nr": rf.n_slope, "kpr": rf.k_prime,
        "lamr": rf.lambda_, "wr": cell.w_read, "lr": cell.l_read,
        "c_sn": cell.sn_cap(tech), "c_bl": c_bl, "g_bl": g_bl,
        "v_bl_drv": v_bl_drv,
    }
