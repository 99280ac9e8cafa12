"""Milliseconds per decode step inside `Model.decode_loop`: the sum of its
calls' spans (CUDA events around each call) over the steps they ran."""


def read(ctx):
    n = ctx.get("decode_steps")
    return 1000.0 * ctx["decode_s"] / n if n else None
