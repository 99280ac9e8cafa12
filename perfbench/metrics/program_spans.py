"""What the readers of the program's spans share: the spans that
`repro_torch.runtime.telemetry` recorded inside a `--trace 1` run's
traced stretch, each filed under the model call it ran in.

A span counts toward a prefill metric only if its `model.prefill`
ancestor began and ended inside the stretch, and toward a decode metric
only if its `model.decode_loop` ancestor did. `kv.slot_write` runs in the
engine after its prefill, not under it: it counts when a counted
`model.prefill` began before it. Every reader returns None in another
kind of cell, without a finished trace, or where the program records no
spans (a program without them included).
"""
from __future__ import annotations

ROOTS = ("model.prefill", "model.decode_loop")


def traced_spans(ctx):
    """The program's spans inside the traced stretch, in the order they
    began, or None."""
    t = ctx.get("tracer")
    if ctx.get("kind") != "serve" or t is None or not t.done:
        return None
    try:
        from repro_torch.runtime.telemetry import spans
    except ImportError:
        return None
    return spans(int(t.t0 * 1e9), int((t.t0 + t.window_s) * 1e9)) or None


class Calls:
    """The stretch's spans by model call: `rows` (prompt rows of the
    counted prefills), `steps` (decode steps of the counted loops),
    `under[root][name]` (the spans named `name` under a counted `root`),
    `slot_writes` (the counted `kv.slot_write` spans)."""

    def __init__(self, got):
        root_of = {}
        self.under = {r: {} for r in ROOTS}
        self.rows = self.steps = 0
        self.slot_writes = []
        for s in got:
            if s.name == "model.prefill":
                self.rows += s.counts["rows"]
            elif s.name == "model.decode_loop":
                self.steps += s.counts["steps"]
            if s.name in ROOTS:
                root_of[s.id] = s.name
            elif s.parent in root_of:
                root_of[s.id] = root_of[s.parent]
                self.under[root_of[s.id]].setdefault(s.name, []).append(s)
            elif s.name == "kv.slot_write" and self.rows:
                self.slot_writes.append(s)

    def prefill(self, name):
        return self.under["model.prefill"].get(name, [])

    def decode(self, name):
        return self.under["model.decode_loop"].get(name, [])


def calls(ctx):
    """`Calls` of the traced stretch, or None."""
    got = traced_spans(ctx)
    return Calls(got) if got else None


def device_ms(spans) -> float:
    return 1000.0 * sum(s.device_s for s in spans)


def prefill_ms_per_ktok(ctx, *names):
    """Device ms of the spans named `names` under the counted prefills per
    1,000 of their prompt rows."""
    c = calls(ctx)
    if c is None or not c.rows:
        return None
    return device_ms([s for n in names for s in c.prefill(n)]) \
        / (c.rows / 1000.0)


def decode_ms_per_step(ctx, name):
    """Device ms of the spans named `name` under the counted decode loops
    per decode step."""
    c = calls(ctx)
    if c is None or not c.steps:
        return None
    return device_ms(c.decode(name)) / c.steps
