"""Batched dense Gauss-Jordan solve of MNA Newton systems J x = r over a
(B, N, N) batch, as one CUDA kernel (`csrc/gauss_jordan.cu`).

Replaces the Pallas kernel `repro.kernels.batched_solve.kernel`
(`batched_solve`, body `_gauss_jordan_kernel`): unpivoted Gauss-Jordan
in float32 whatever the input type, the result cast back to r's type.
The MNA Jacobian's gmin + C/h + G_BIG diagonal makes pivoting
unnecessary. One thread block solves one system with J in shared
memory; see the source for what bounds it.

`batched_solve` launches the kernel for CUDA tensors and raises if the
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

N_MAX = 240         # largest system the kernel holds (csrc N_MAX)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    lib = build.load("gauss_jordan")
    if lib.gauss_jordan_launch.argtypes is None:
        lib.gauss_jordan_launch.argtypes = [_INT, _INT, _INT, _PTR, _PTR,
                                            _PTR, _PTR]
        lib.gauss_jordan_launch.restype = _INT
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
    each kernel launch in `batched_solve.launches`."""
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if not r.is_cuda:
        return gauss_jordan_plain(J, r)
    if r.ndim != 2 or tuple(J.shape) != (r.shape[0], r.shape[1], r.shape[1]):
        raise ValueError(f"batched_solve takes J (B, N, N) and r (B, N), got "
                         f"{tuple(J.shape)} and {tuple(r.shape)}")
    B, N = r.shape
    if not 1 <= N <= N_MAX or B < 1:
        raise ValueError(f"batched_solve kernel takes 1 <= N <= {N_MAX} and "
                         f"B >= 1, got B={B}, N={N}")
    if r.dtype not in (torch.float32, torch.float64) or J.dtype != r.dtype:
        raise TypeError(f"batched_solve kernel takes J and r of one dtype, "
                        f"float32 or float64; got {J.dtype} and {r.dtype}")
    if J.device != r.device:
        raise ValueError(f"J on {J.device}, r on {r.device}")
    if not (J.is_contiguous() and r.is_contiguous()):
        raise ValueError("batched_solve kernel takes contiguous J and r")
    lib = _lib()
    out = torch.empty_like(r)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = lib.gauss_jordan_launch(int(r.dtype == torch.float64), B, N,
                                     J.data_ptr(), r.data_ptr(),
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("gauss_jordan kernel launch failed: "
                           + lib.gauss_jordan_error(rc).decode())
    batched_solve.launches += 1
    return out


batched_solve.launches = 0
