"""Share of the MoE FFN's device time in prefill spent outside the expert
products, in percent: 100 x (1 - the `moe.experts` spans' device time /
the `moe` spans'), both under the traced stretch's prefills. What is left
is routing with its rank cumsum, the dispatch buffer and the combine."""
from perfbench.metrics.program_spans import calls, device_ms


def read(ctx):
    c = calls(ctx)
    if c is None:
        return None
    whole = device_ms(c.prefill("moe"))
    if not whole:
        return None
    return 100.0 * (1.0 - device_ms(c.prefill("moe.experts")) / whole)
