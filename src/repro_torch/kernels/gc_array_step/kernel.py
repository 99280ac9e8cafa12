"""One implicit step of an R x C gain-cell array with bitline-rail
coupling, as one CUDA kernel (`csrc/gc_array_step.cu`).

Replaces the Pallas kernel `repro.kernels.gc_array_step.kernel`
(`gc_array_step`, bodies `_kernel` and `_step_math`): per-cell Newton on
the storage nodes (rails frozen), then the linearized rail KCL per column
from column sums, two Gauss-Seidel sweeps, all in float32. The Pallas
kernel tiles over column blocks of `block_c`; the CUDA kernel's blocks
hold a few columns each, with the rows spread over row groups and, where
the columns alone cannot fill the card, over the blocks of a thread-block
cluster (`geometry`). C need not be a multiple of the block.

`gc_array_step` launches the kernel for CUDA tensors and raises if the
build or the launch fails (a cluster launch the card refuses included).
For CPU tensors it runs `step_plain`, the same float32 arithmetic (the
parameters as float32 scalars, as the Pallas kernel reads them) with the
column sums in torch's order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gc_array_step.ref import NEWTON_DV, step_body

# the rail conductance's step: the Pallas kernel takes the Newton's 1e-4,
# its oracle 1e-3
DV = NEWTON_DV

PKEYS = ("vtw", "nw", "kpw", "lamw", "ww", "lw",
         "vtr", "nr", "kpr", "lamr", "wr", "lr",
         "c_sn", "c_bl", "g_bl", "v_bl_drv")

# the launch geometry (csrc/gc_array_step.cu, "Work split")
MAX_COLS, MIN_COLS = 8, 2   # columns per block
BLOCK_THREADS = 256         # threads per block when the rows allow
MAX_CLUSTER = 8             # the portable cluster size
MIN_CLUSTER_ROWS = 16       # rows per block below which no cluster grows

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


class _Params(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in PKEYS]


class Geometry(NamedTuple):
    """One launch of the array-step kernel: `cols` columns and
    `row_groups` row groups per block (threadIdx.x, threadIdx.y), and
    `cluster` blocks per thread-block cluster sharing one column block's
    rows; `blocks` in the grid."""
    cols: int
    row_groups: int
    cluster: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def geometry(R: int, C: int, block_c: int, n_sm: int) -> Geometry:
    """The launch for an R x C array on a card of `n_sm` SMs, aiming at
    two or more blocks per SM: columns per block from min(block_c, C, 8)
    halved (down to 2) while the column blocks number fewer than 2 n_sm;
    then clusters of 2, 4 or 8 blocks split each column's rows while the
    blocks still number fewer than 2 n_sm and each block keeps at least
    16 rows; row groups up to 256 threads per block, at most one per row
    of the block's share."""
    if R < 1 or C < 1 or block_c < 1 or n_sm < 1:
        raise ValueError(f"geometry takes R, C, block_c, n_sm >= 1, got "
                         f"{(R, C, block_c, n_sm)}")
    target = 2 * n_sm
    cols = min(block_c, C, MAX_COLS)
    while cols > MIN_COLS and _cdiv(C, cols) < target:
        cols = _cdiv(cols, 2)
    col_blocks = _cdiv(C, cols)
    cluster = 1
    while (cluster < MAX_CLUSTER and col_blocks * cluster < target
           and _cdiv(R, 2 * cluster) >= MIN_CLUSTER_ROWS):
        cluster *= 2
    row_groups = min(max(1, BLOCK_THREADS // cols), _cdiv(R, cluster))
    return Geometry(cols, row_groups, cluster, col_blocks * cluster)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    lib = build.load("gc_array_step")
    if lib.gc_array_step_launch.argtypes is None:
        lib.gc_array_step_launch.argtypes = [
            _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
            _Params, ctypes.c_float, _PTR, _PTR, _PTR]
        lib.gc_array_step_launch.restype = _INT
        lib.gc_array_step_error.argtypes = [_INT]
        lib.gc_array_step_error.restype = ctypes.c_char_p
    return lib


def step_plain(v_sn, v_bl, wwl, wbl, rwl, h, p):
    """Plain torch version of the kernel (the Pallas `_step_math`): the
    oracle's algorithm with the kernel's rail step and float32
    parameters."""
    f32 = dict(dtype=torch.float32, device=v_sn.device)
    p = {k: torch.as_tensor(p[k], **f32) for k in PKEYS}
    return step_body(v_sn, v_bl, wwl, wbl, rwl, torch.as_tensor(h, **f32),
                     p, DV)


def gc_array_step(v_sn, v_bl, wwl, wbl, rwl, h, p, block_c: int = 128):
    """v_sn (R, C), v_bl (C,), wwl/rwl (R,), wbl (C,) float32; h scalar;
    p the 16 scalar parameters (`PKEYS`). Returns (v_sn', v_bl'). Counts
    each kernel launch in `gc_array_step.launches` and keeps its
    `Geometry` in `gc_array_step.last_geometry`.

    `block_c` stays for parity with the reference's signature; on the
    card it only caps the columns per block, which are at most 8 anyway,
    so every `block_c` of 8 or more gives the same launch."""
    if not v_sn.is_cuda:
        return step_plain(v_sn, v_bl, wwl, wbl, rwl, h, p)
    device = v_sn.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return gc_array_step(v_sn, v_bl, wwl, wbl, rwl, h, p, block_c)
    if v_sn.ndim != 2:
        raise ValueError(f"v_sn must be (R, C), got {tuple(v_sn.shape)}")
    R, C = v_sn.shape
    if not 1 <= block_c <= 1024:
        raise ValueError(f"block_c must be in 1..1024, got {block_c}")
    for name, x, shape in (("v_sn", v_sn, (R, C)), ("v_bl", v_bl, (C,)),
                           ("wwl", wwl, (R,)), ("wbl", wbl, (C,)),
                           ("rwl", rwl, (R,))):
        if x.shape != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, expected float32")
        if x.device != device:
            raise ValueError(f"{name}: on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    lib = _lib()
    geom = geometry(R, C, block_c, sm_count(device.index))
    out_sn = torch.empty_like(v_sn)
    out_bl = torch.empty_like(v_bl)
    params = _Params(*(float(p[k]) for k in PKEYS))
    rc = lib.gc_array_step_launch(
        R, C, geom.cols, geom.row_groups, geom.cluster, v_sn.data_ptr(),
        v_bl.data_ptr(), wwl.data_ptr(), wbl.data_ptr(), rwl.data_ptr(),
        params, float(h), out_sn.data_ptr(), out_bl.data_ptr(),
        build.raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"gc_array_step kernel launch failed ({geom}): "
                           + lib.gc_array_step_error(rc).decode())
    gc_array_step.launches += 1
    gc_array_step.last_geometry = geom
    return out_sn, out_bl


gc_array_step.launches = 0
gc_array_step.last_geometry = None
