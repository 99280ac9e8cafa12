"""Decode attention over the KV cache: the CUDA kernel's wrapper and the
plain PyTorch version (`kernel`)."""
