"""The tensor-core flash-attention kernel's share of its roofline in the
traced part of a serve run: the least time its launches could take at the
card's bf16 peak or HBM rate (`perfbench.harness.flops.flash_bound_s`,
visible pairs only) over their device time in the profiler's trace."""
from perfbench.harness.trace import flash_roofline


def read(ctx):
    return flash_roofline(ctx, "serve")
