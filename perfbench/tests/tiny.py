"""Tiny versions of the benchmark's cells for CPU tests: the same
configuration and traffic files with small widths and few requests or
steps, so a whole run (the program, the reference, the check) fits a test
on the CPU.

A configuration's tiny sizes are in `tests/tiny/<config>.json`: "config"
(the small widths, under the configuration file's own keys), "port" (the
program's overrides to match), "limits" (the tiny cell's limits of the
correctness check) and, for a model with sparse experts, "expert_keys"
(the file's keys of experts per token, "k", and of experts, "E"). Every
serve cell runs the one tiny serve mix below."""
from __future__ import annotations

import copy

from perfbench.harness import common

TINY_SERVE = {"rate_per_s": 20.0,
              "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6,
                         "min": 8, "max": 64},
              "output": {"dist": "uniform", "min": 3, "max": 6},
              "n_slots": 4, "decode_chunk": 2, "trace_seconds": 0.5,
              "check_tokens": 90}


def sizes(config: str) -> dict:
    """The tiny file of the configuration named `config`."""
    return common.load_json(common.PERFBENCH / "tests" / "tiny"
                            / f"{config}.json")


def shrink(cell):
    """(cell, port override) of `cell` at its configuration's tiny sizes
    and limits, under the tiny serve mix."""
    t = sizes(cell.workload["config"])
    c = copy.deepcopy(cell)
    c.config.update(t["config"])
    c.traffic.update(copy.deepcopy(TINY_SERVE), limits=dict(t["limits"]))
    return c, dict(t["port"])


def cell(name: str):
    """(cell, port override) of the named cell at tiny sizes."""
    return shrink(common.find_cell(name))


def config(name: str):
    """(configuration file, port override) of the named configuration at
    tiny sizes."""
    conf = [c for c in common.benchmark()["configs"] if c["name"] == name][0]
    t = sizes(name)
    return dict(common.load_json(common.ROOT / conf["file"]),
                **t["config"]), dict(t["port"])
