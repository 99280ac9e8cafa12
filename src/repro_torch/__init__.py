"""PyTorch/CUDA port of the OpenGCRAM compiler.

Mirrors the module paths of the JAX package `repro` one to one, so
`repro_torch/core/spice/mna.py` is the counterpart of
`repro/core/spice/mna.py`. The port imports torch, numpy and the
standard library only. Entry points that create tensors take an explicit
`device=` argument defaulting to "cuda"; the CPU is used only when the
caller asks for it.

Ported so far: the transient read characterization of a design lattice
(`core.spice.char_batch.characterize`) and its fused Woodbury-Newton
kernel (`kernels.batched_solve.fused`, CUDA C++ in `csrc/`).
"""
