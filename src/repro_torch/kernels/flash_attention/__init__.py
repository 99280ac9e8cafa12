"""Port of `repro.kernels.flash_attention`: causal GQA flash-attention
forward, its CUDA kernel wrapper and plain version (`kernel`), the naive
oracle (`ref`) and the public entry point (`ops`)."""
