"""Batched dense Gauss-Jordan solve of MNA Newton systems J x = r over a
(B, N, N) batch, as hand-written CUDA kernels (`csrc/gauss_jordan.cu`).

Replaces the Pallas kernel `repro.kernels.batched_solve.kernel`
(`batched_solve`, body `_gauss_jordan_kernel`): unpivoted Gauss-Jordan
in float32 whatever the input type, the result cast back to r's type.
The MNA Jacobian's gmin + C/h + G_BIG diagonal makes pivoting
unnecessary. `route(N)` picks the kernel: one warp per system with the
rows in registers for N <= 32 (the transient path's N = 12-13), one
thread block per system with J in shared memory for 32 < N <= 240; see
the source for what bounds each.

`batched_solve` launches a kernel for CUDA tensors and raises if the
build or the launch fails. For CPU tensors it runs `gauss_jordan_plain`,
the same operations in the same order (each product and difference
rounded to float32 on its own), so the two agree bit for bit. The
reference pads N to 128 and B to `block_b`; the pad changes nothing in
the real rows, so neither version pads, and `block_b` stays in the
signature for parity.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

WARP_N_MAX = 32     # largest system of the warp kernel (csrc WARP_N_MAX)
N_MAX = 240         # largest system of the block kernel (csrc N_MAX)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def route(N: int) -> str:
    """The kernel that solves (B, N, N) systems: "warp" for N <= 32,
    "block" for 32 < N <= 240. Raises ValueError outside 1..240."""
    if 1 <= N <= WARP_N_MAX:
        return "warp"
    if WARP_N_MAX < N <= N_MAX:
        return "block"
    raise ValueError(f"batched_solve kernels take 1 <= N <= {N_MAX}, got "
                     f"N={N}")


def _lib():
    lib = build.load("gauss_jordan")
    if lib.gauss_jordan_error.argtypes is None:
        for fn in (lib.gauss_jordan_warp_launch,
                   lib.gauss_jordan_block_launch):
            fn.argtypes = [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR]
            fn.restype = _INT
        lib.gauss_jordan_error.argtypes = [_INT]
        lib.gauss_jordan_error.restype = ctypes.c_char_p
    return lib


def gauss_jordan_plain(J, r):
    """Plain torch version of the kernel: J (B, N, N), r (B, N) -> x
    (B, N) in r's dtype, computed in float32."""
    A = J.to(torch.float32)
    x = r.to(torch.float32)
    for k in range(r.shape[-1]):
        inv = 1.0 / A[:, k, k]
        fac = A[:, :, k] * inv[:, None]
        fac[:, k] = 0.0
        A = A - fac[:, :, None] * A[:, k:k + 1, :]
        x = x - fac * x[:, k:k + 1]
    return (x / torch.diagonal(A, dim1=1, dim2=2)).to(r.dtype)


def batched_solve(J, r, block_b: int = 8):
    """J: (B, N, N), r: (B, N) -> x: (B, N), float32 compute. Counts
    each kernel launch in `batched_solve.launches`, and by kernel in
    `batched_solve.warp_launches` and `batched_solve.block_launches`."""
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if not r.is_cuda:
        return gauss_jordan_plain(J, r)
    device = r.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return batched_solve(J, r, block_b)
    shape = r.shape
    if len(shape) != 2 or J.shape != (shape[0], shape[1], shape[1]):
        raise ValueError(f"batched_solve takes J (B, N, N) and r (B, N), got "
                         f"{tuple(J.shape)} and {tuple(shape)}")
    B, N = shape
    kind = route(N)
    dtype = r.dtype
    if J.dtype != dtype or dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_solve kernel takes J and r of one dtype, "
                        f"float32 or float64; got {J.dtype} and {dtype}")
    if B < 1:
        raise ValueError("batched_solve kernel takes B >= 1")
    if J.device != device:
        raise ValueError(f"J on {J.device}, r on {device}")
    if not (J.is_contiguous() and r.is_contiguous()):
        raise ValueError("batched_solve kernel takes contiguous J and r")
    lib = _lib()
    launch = (lib.gauss_jordan_warp_launch if kind == "warp"
              else lib.gauss_jordan_block_launch)
    out = torch.empty_like(r)
    rc = launch(int(dtype == torch.float64), B, N, J.data_ptr(),
                r.data_ptr(), out.data_ptr(), build.raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"gauss_jordan {kind} kernel launch failed: "
                           + lib.gauss_jordan_error(rc).decode())
    batched_solve.launches += 1
    if kind == "warp":
        batched_solve.warp_launches += 1
    else:
        batched_solve.block_launches += 1
    return out


batched_solve.launches = 0
batched_solve.warp_launches = 0
batched_solve.block_launches = 0
