"""One implicit step of an R x C gain-cell array with bitline-rail
coupling, as one CUDA kernel (`csrc/gc_array_step.cu`).

Replaces the Pallas kernel `repro.kernels.gc_array_step.kernel`
(`gc_array_step`, bodies `_kernel` and `_step_math`): per-cell Newton on
the storage nodes (rails frozen), then the linearized rail KCL per column
from column sums, two Gauss-Seidel sweeps, all in float32. The Pallas
kernel tiles over column blocks of `block_c`; the CUDA kernel takes at
most 32 columns per block (fewer only when `block_c` is below 32), each
column's rows spread over up to 32 threads, and C need not be a multiple
of the block.

`gc_array_step` launches the kernel for CUDA tensors and raises if the
build or the launch fails. For CPU tensors it runs `step_plain`, the same
float32 arithmetic in the same order (the parameters as float32 scalars,
as the Pallas kernel reads them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gc_array_step.ref import NEWTON_DV, step_body

# the rail conductance's step: the Pallas kernel takes the Newton's 1e-4,
# its oracle 1e-3
DV = NEWTON_DV

PKEYS = ("vtw", "nw", "kpw", "lamw", "ww", "lw",
         "vtr", "nr", "kpr", "lamr", "wr", "lr",
         "c_sn", "c_bl", "g_bl", "v_bl_drv")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


class _Params(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in PKEYS]


def _lib():
    lib = build.load("gc_array_step")
    if lib.gc_array_step_launch.argtypes is None:
        lib.gc_array_step_launch.argtypes = [
            _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _Params,
            ctypes.c_float, _PTR, _PTR, _PTR]
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
    each kernel launch in `gc_array_step.launches`.

    `block_c` stays for parity with the reference's signature; on the
    card it only caps the columns per block, which are at most 32 anyway,
    so every `block_c` of 32 or more gives the same launch."""
    if not v_sn.is_cuda:
        return step_plain(v_sn, v_bl, wwl, wbl, rwl, h, p)
    if v_sn.ndim != 2:
        raise ValueError(f"v_sn must be (R, C), got {tuple(v_sn.shape)}")
    R, C = v_sn.shape
    if not 1 <= block_c <= 1024:
        raise ValueError(f"block_c must be in 1..1024, got {block_c}")
    for name, x, shape in (("v_sn", v_sn, (R, C)), ("v_bl", v_bl, (C,)),
                           ("wwl", wwl, (R,)), ("wbl", wbl, (C,)),
                           ("rwl", rwl, (R,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, expected float32")
        if x.device != v_sn.device:
            raise ValueError(f"{name}: on {x.device}, expected {v_sn.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    lib = _lib()
    out_sn = torch.empty_like(v_sn)
    out_bl = torch.empty_like(v_bl)
    params = _Params(*(float(p[k]) for k in PKEYS))
    stream = torch.cuda.current_stream(v_sn.device).cuda_stream
    with torch.cuda.device(v_sn.device):
        rc = lib.gc_array_step_launch(
            R, C, block_c, v_sn.data_ptr(), v_bl.data_ptr(), wwl.data_ptr(),
            wbl.data_ptr(), rwl.data_ptr(), params, float(h),
            out_sn.data_ptr(), out_bl.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("gc_array_step kernel launch failed: "
                           + lib.gc_array_step_error(rc).decode())
    gc_array_step.launches += 1
    return out_sn, out_bl


gc_array_step.launches = 0
