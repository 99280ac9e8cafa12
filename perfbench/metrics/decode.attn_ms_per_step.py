"""Device milliseconds of attention per decode step: the program's `attn`
spans (every layer's `attention.decode` over the slots' caches) under
each `model.decode_loop` inside the traced stretch, over those loops'
steps."""
from perfbench.metrics.program_spans import decode_ms_per_step


def read(ctx):
    return decode_ms_per_step(ctx, "attn")
