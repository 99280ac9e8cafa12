"""Device milliseconds of the MoE FFN per decode step: the program's `moe`
spans under each `model.decode_loop` inside the traced stretch, over
those loops' steps."""
from perfbench.metrics.program_spans import decode_ms_per_step


def read(ctx):
    return decode_ms_per_step(ctx, "moe")
