"""PyTorch/CUDA port of the OpenGCRAM compiler.

Mirrors the module paths of the JAX package `repro` one to one, so
`repro_torch/core/spice/mna.py` is the counterpart of
`repro/core/spice/mna.py`. The port imports torch, numpy and the
standard library only. Entry points that create tensors take an explicit
`device=` argument defaulting to "cuda"; the CPU is used only when the
caller asks for it.

Ported so far, each slice with its hand-written CUDA C++ kernels in
`csrc/`:
  1. the transient read characterization of a design lattice
     (`core.spice.char_batch.characterize`) and its fused Woodbury-Newton
     kernel (`kernels.batched_solve.fused`, `csrc/fused_newton.cu`);
  2. the bank compile flow with its simulated read
     (`core.compiler.compile_bank(simulate=True)`), whose dense Newton
     solves run in the Gauss-Jordan kernel (`kernels.batched_solve.kernel`,
     `csrc/gauss_jordan.cu`), and the gain-cell array step
     (`kernels.gc_array_step`, `csrc/gc_array_step.cu`);
  3. serving of the dense model family (`configs`, `models`, `serving`,
     `runtime.telemetry`, `launch.serve`), whose prefill attention runs
     in the flash-attention kernel (`kernels.flash_attention`,
     `csrc/flash_attention.cu`).
"""
