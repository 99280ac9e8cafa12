#!/usr/bin/env python3
"""Host cost of the Gauss-Jordan and array-step wrappers, piece by piece.

Times on the card, by a host clock over 1000 calls with no
synchronize inside, each whole wrapper (`batched_solve` at B = 1, N = 13;
`gc_array_step` at 128x128 and 512x512) and the pieces a ctypes launch is
made of: the output allocation, the current-device check, the stream
lookup (the public `torch.cuda.current_stream().cuda_stream` against
`build.raw_stream`), a device guard, and the bare ctypes launch. Prints
one line per piece in microseconds. Needs a CUDA device; exits nonzero
without one.

Run from the root of the repository:
    python3 bench_torch/wrapper_cost.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls: int = 1000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("wrapper_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.batched_solve import kernel as gj
    from repro_torch.kernels.gc_array_step import kernel as gc
    from repro_torch.kernels.gc_array_step import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    J = (torch.rand((1, 13, 13), generator=gen, device=dev,
                    dtype=torch.float64)
         + 13 * torch.eye(13, dtype=torch.float64, device=dev))
    r = torch.rand((1, 13), generator=gen, device=dev, dtype=torch.float64)
    out = torch.empty_like(r)
    launch = gj._lib().gauss_jordan_warp_launch
    stream = build.raw_stream(0)

    def guard():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "batched_solve B=1 N=13 (whole wrapper)":
            lambda: gj.batched_solve(J, r),
        "torch.empty_like": lambda: torch.empty_like(r),
        "torch.cuda.current_device": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "build.raw_stream": lambda: build.raw_stream(0),
        "with torch.cuda.device(device)": guard,
        "ctypes launch of the warp kernel alone":
            lambda: launch(1, 1, 13, J.data_ptr(), r.data_ptr(),
                           out.data_ptr(), stream),
    }
    p = ops.cell_params("gc2t_nn")
    for R in (128, 512):
        a = [torch.rand(shape, generator=gen, device=dev)
             for shape in ((R, R), (R,), (R,), (R,), (R,))]
        pieces[f"gc_array_step {R}x{R} (whole wrapper)"] = \
            lambda a=a: ops.gc_array_step(*a, 1e-11, p)
    pieces["gc_array_step geometry (cached)"] = \
        lambda: gc.geometry(512, 512, 128, 132)
    for name, fn in pieces.items():
        print(f"{name}: {host_us(fn)!r} us per call [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
