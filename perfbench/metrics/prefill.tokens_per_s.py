"""Prompt rows processed per second inside `Model.prefill`: the rows of
every prefill call over the sum of their spans, each a pair of CUDA events
around the call (device clock; the device's waits for the host inside a
call count to it)."""


def read(ctx):
    s = ctx.get("prefill_s")
    return ctx["prefill_tokens"] / s if s else None
