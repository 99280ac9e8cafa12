"""Placeholders for the parts of `repro` that later slices of the port
bring over. Calling one raises NotImplementedError naming its ROADMAP
item, so a caller learns at once what is missing."""
from __future__ import annotations


def deferred(name: str, item: str):
    """A function that raises NotImplementedError for `name`, which waits
    for ROADMAP item `item`."""
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to repro_torch yet (ROADMAP {item})")
    fn.__name__ = name.rsplit(".", 1)[-1]
    fn.__doc__ = f"Not ported yet: waits for ROADMAP {item}."
    return fn
