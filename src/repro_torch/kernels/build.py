"""Build and load the port's CUDA C++ kernels.

Each source under `src/repro_torch/csrc/` compiles with `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
ctypes. Builds happen at first use (of any kernel: every missing source then
builds at once), into `build/repro_torch_kernels/` at the root of the
checkout, keyed by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.
`build_all` starts one `nvcc` per source together and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_newton", "gauss_jordan", "gc_array_step",
           "flash_attention", "flash_attention_tc", "decode_attention")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on the machine with the card (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` goes, keyed by content."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one `nvcc` process
    per source, all started together. Returns name -> library path and
    writes each compiler's output (registers, spills) beside it as
    `.log`. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def raw_stream(index: int) -> int:
    """The cudaStream_t of PyTorch's current stream on CUDA device
    `index`, as an int for a ctypes launch. This is the call PyTorch's
    own generated kernel launchers make; the public
    `torch.cuda.current_stream().cuda_stream` builds a Stream object and
    took 5.2 us per call on an H100's host against 0.2 us for this one
    (`bench_torch/wrapper_cost.py`)."""
    return torch._C._cuda_getCurrentRawStream(index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed: the
    first one missing builds every missing source of `SOURCES` at once,
    so a process that uses several kernels waits for one `nvcc`, not for
    each in turn."""
    lib = _LOADED.get(name)
    if lib is None:
        names = SOURCES if name in SOURCES else (name,)
        lib = _LOADED[name] = ctypes.CDLL(str(build_all(names)[name]))
    return lib
