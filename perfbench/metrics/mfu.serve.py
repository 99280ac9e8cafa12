"""The serve window's model operations over what the card's bf16 peak
would do in the window, in percent: every prefill whose first token
reached the host in the window, and every token decoded in it, counted by
`perfbench.harness.flops` from the configuration's widths."""
from perfbench.harness.flops import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["window_s"]:
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAK_BF16_FLOPS)
