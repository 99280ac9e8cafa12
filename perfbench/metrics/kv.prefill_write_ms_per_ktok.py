"""Device milliseconds of building the KV cache in prefill per 1,000
prompt rows: the program's `kv.pad` spans (each layer's K or V rows
stacked into a window-wide, zero-padded block) under the traced stretch's
prefills, and its `kv.slot_write` spans (the engine copying those rows
into the slots' cache), over the prefills' rows."""
from perfbench.metrics.program_spans import calls, device_ms


def read(ctx):
    c = calls(ctx)
    if c is None or not c.rows:
        return None
    return (device_ms(c.prefill("kv.pad")) + device_ms(c.slot_writes)) \
        / (c.rows / 1000.0)
