"""Useful share of the MoE expert products in prefill, in percent: the
routed assignments (T x k) over the expert rows the batched products run
on (E x C), summed over the `moe` spans' counts under the traced
stretch's prefills. Dropless routing (C = T) reads k / E."""
from perfbench.metrics.program_spans import calls


def read(ctx):
    c = calls(ctx)
    spans = c.prefill("moe") if c is not None else []
    rows = sum(s.counts["expert_rows"] for s in spans)
    if not rows:
        return None
    return 100.0 * sum(s.counts["assignments"] for s in spans) / rows
