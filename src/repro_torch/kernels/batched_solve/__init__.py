"""Port of `repro.kernels.batched_solve`: the fused Woodbury-Newton
engine (`newton`), its CUDA kernel wrapper (`fused`) and the dispatching
entry point (`ops`)."""
