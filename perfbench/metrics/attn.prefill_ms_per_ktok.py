"""Device milliseconds of attention in prefill per 1,000 prompt rows: the
program's `attn` spans (the attention sublayer of each block, CUDA events
on the current stream) under every `model.prefill` inside the traced
stretch, over those prefills' rows (B x S)."""
from perfbench.metrics.program_spans import prefill_ms_per_ktok


def read(ctx):
    return prefill_ms_per_ktok(ctx, "attn")
