"""Device milliseconds of the MoE FFN in prefill per 1,000 prompt rows:
the program's `moe` spans (`moe._moe_local`: routing, dispatch, the
expert products and the combine) under every `model.prefill` inside the
traced stretch, over those prefills' rows."""
from perfbench.metrics.program_spans import prefill_ms_per_ktok


def read(ctx):
    return prefill_ms_per_ktok(ctx, "moe")
