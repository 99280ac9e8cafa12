"""What every run shares: the benchmark file, a cell's configuration and
traffic, the program's configuration object, the result line, and the
checks on the device and on forbidden modules.

A cell is found by name in `BENCHMARK.json`; its configuration file
(`perfbench/configs/<config>.json`), its traffic file
(`perfbench/traffic/<traffic>.json`, whose "kind" names the driver module
`perfbench/drivers/<kind>.py`) and each per-layer metric's reader
(`perfbench/metrics/<name>.py`) are found by the names in it; the
configuration file names its plain reference
(`perfbench/reference/<reference>.py`) and its `model_type` the module of
its operation counts (`perfbench/counts/<model_type>.py`). So a new cell,
mix, metric or model type is new files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent

# top-level module names that may not be loaded in a run's process: the
# JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    end_to_end: list        # the end-to-end metric entries it reports
    per_layer: list         # the per-layer metric entries it reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if _reports(m, name) and m["moves"] in moved]
    return Cell(name, w, load_json(ROOT / conf["file"]),
                load_json(PERFBENCH / "traffic" / f"{w['traffic']}.json"),
                e2e, per)


def driver(kind: str):
    """The traffic driver module of a traffic kind."""
    return importlib.import_module(f"perfbench.drivers.{kind}")


_PIECES = {}            # path -> module loaded from it


def piece(kind: str, name: str):
    """The module `perfbench/<kind>/<name>.py`, loaded from its file once a
    process. A piece that is not there fails here, naming the path."""
    path = PERFBENCH / kind / f"{name}.py"
    if path not in _PIECES:
        if not path.is_file():
            raise FileNotFoundError(
                f"perfbench: no {kind} module for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PIECES[path] = mod
    return _PIECES[path]


def reference(config: dict):
    """The plain reference module a configuration file names."""
    return piece("reference", config["reference"])


def counts(config: dict):
    """The operation counts of a configuration file's model type:
    `layer_matmul_params(c)` and `attention_layers(c)`, and where the type
    has them `other_prefill_flops(c, S)` and `other_decode_flops(c,
    context)` (`harness/flops.py`)."""
    return piece("counts", config["model_type"])


def reader(metric: str):
    """The `read(ctx)` of a per-layer metric's reader file."""
    return piece("metrics", metric).read


def port_config(config: dict, override=None):
    """The program's configuration object for a configuration file: its
    registered arch with the file's replacements; its widths are checked
    against the file's so the two cannot drift apart."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = dataclasses.replace(get_config(port["arch"]), **port["replace"])
    if override:
        cfg = dataclasses.replace(cfg, **override)
    return cfg


# program attribute -> configuration file key, checked where the file has
# the key
WIDTHS = {"d_model": "hidden_size", "d_ff": "intermediate_size",
          "n_heads": "num_attention_heads",
          "n_kv_heads": "num_key_value_heads",
          "n_layers": "num_hidden_layers", "vocab_size": "vocab_size",
          "n_experts": "num_local_experts", "top_k": "num_experts_per_tok",
          "sliding_window": "sliding_window", "rope_theta": "rope_theta",
          "norm_eps": "rms_norm_eps", "act": "hidden_act",
          "dtype": "torch_dtype", "tie_embeddings": "tie_word_embeddings"}


def check_widths(cfg, c: dict):
    """The program's config must carry the configuration file's widths:
    the pairs of `WIDTHS` whose key the file has, and every pair the file
    lists under `port.widths` (program attribute -> file key)."""
    pairs = {a: b for a, b in WIDTHS.items() if b in c} \
        | c["port"].get("widths", {})
    bad = [(a, getattr(cfg, a), c[b]) for a, b in pairs.items()
           if getattr(cfg, a) != (c[b] if c[b] is not None else 0)]
    if bad:
        raise RuntimeError(f"the program's config differs from the "
                           f"configuration file: {bad}")


def process_age_s() -> float:
    """Seconds since this process was created (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared for `correct`, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def device_info(device, count: int = 1) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def emit(result: dict, checks: list, out=sys.stdout, err=sys.stderr,
         readings=None):
    """The end of a run: `readings` (numbers read but not compared), then
    each compared number beside its limit on standard error, then the
    result line (with the compared numbers under "checks", last) as the
    last line of standard output."""
    for k, v in (readings or {}).items():
        print(f"reading {k}: {v!r} (not compared)", file=err)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=err)
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
