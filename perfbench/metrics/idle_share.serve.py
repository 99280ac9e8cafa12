"""Share of the traced part of a serve run in which no operation ran on the
device, in percent: one less the union of the profiler's device intervals
over the traced seconds."""


def read(ctx):
    t = ctx.get("tracer")
    if ctx.get("kind") != "serve" or t is None or not t.done:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
