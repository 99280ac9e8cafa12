"""Port of `repro.kernels.gc_array_step`: one implicit step of a gain-cell
array, its CUDA kernel wrapper (`kernel`), the oracle (`ref`) and the
public entry point (`ops`)."""
