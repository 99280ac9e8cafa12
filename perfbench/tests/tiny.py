"""Tiny versions of the benchmark's cells for CPU tests: the same
configuration and traffic files with small widths and few requests or
steps, so a whole run (the program, the reference, the check) fits a test
on the CPU."""
from __future__ import annotations

import copy

from perfbench.harness.common import find_cell

TINY_MIXTRAL = {"hidden_size": 64, "intermediate_size": 96,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "num_hidden_layers": 2, "num_local_experts": 4,
                "num_experts_per_tok": 2, "vocab_size": 256}
TINY_MIXTRAL_PORT = {"d_model": 64, "d_ff": 96, "n_heads": 4, "n_kv_heads": 2,
                     "head_dim": 16, "n_layers": 2, "n_experts": 4,
                     "vocab_size": 256, "capacity_factor": 2.0}
TINY_SERVE = {"rate_per_s": 20.0,
              "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6,
                         "min": 8, "max": 64},
              "output": {"dist": "uniform", "min": 3, "max": 6},
              "n_slots": 4, "decode_chunk": 2, "trace_seconds": 0.5,
              "check_tokens": 90,
              # the tiny cell's own limits, set as the cell's are, from
              # readings at its size (CPU; seeds 2**31 + 1..8, 21, 22, 31,
              # 32): the program's widest gap <= 0.064 and trimmed mean 0;
              # the fp8 control's trimmed mean 0 to 0.0035 (over 1e-4 on 8
              # of the 12); every served token altered (plus one): widest
              # >= 4.7
              "limits": {"trimmed_gap": 1e-4, "gap": 0.15}}


def cell(name: str):
    """(cell, port override) of the named mixtral cell at tiny sizes."""
    c = copy.deepcopy(find_cell(name))
    c.config.update(TINY_MIXTRAL)
    c.traffic.update(copy.deepcopy(TINY_SERVE))
    return c, TINY_MIXTRAL_PORT
