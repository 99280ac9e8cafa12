"""Logical-axis -> mesh-axis rule tables and sharding-tree builders (port
of `repro.launch.sharding`).

The scheme (MaxText-style):
  * batch            -> all data axes ("pod","data")
  * embed_fsdp       -> "data"   (ZeRO/FSDP shard of the big tables)
  * embed            -> "data"   (param d_model dim: FSDP; activations fall
                                  back to replicated because 'data' is taken
                                  by 'batch' in any activation spec)
  * heads/kv_heads   -> "model"  (TP); logical_to_pspec replicates a head
                        count that does not divide the axis
  * mlp/inner/...    -> "model"
  * experts          -> "model"  (EP)
  * vocab            -> "model"
  * kv_seq           -> "model", or ("data","model") when the decode batch is
                        too small to occupy the data axes (long_500k B=1)
  * layers/seq/state -> replicated

Divisibility fallback (models/common.logical_to_pspec) replicates any dim
whose size does not divide the assigned axes, so one rule table serves all
10 architectures. A spec is the reference's PartitionSpec as a tuple (per
dimension None, an axis name or a tuple of them); a sharding is the
DTensor placements of a spec (`models.common.to_placements`).
"""
from __future__ import annotations

import math
import torch

from repro_torch.launch.mesh import axis_names, data_axis_names
from repro_torch.models.common import axis_sizes, logical_to_pspec, \
    to_placements
from repro_torch.optim.optimizers import tree_map


def _sanitize(rules: dict, mesh) -> dict:
    """Drop mesh axes the rule table names but this mesh doesn't have
    (e.g. a data-only bring-up mesh has no 'model' axis)."""
    have = set(axis_names(mesh))

    def fix(v):
        if v is None:
            return None
        axes = v if isinstance(v, tuple) else (v,)
        axes = tuple(a for a in axes if a in have)
        if not axes:
            return None
        # preserve tuple-ness: consumers iterate rules["batch"] as a tuple
        return axes if isinstance(v, tuple) else axes[0]

    return {k: fix(v) for k, v in rules.items()}


def make_rules(mesh, *, batch_size: int = None, kind: str = "train") -> dict:
    data_axes = data_axis_names(mesh)
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes)
    small_batch = batch_size is not None and batch_size < n_data
    if kind == "decode":
        # Serving layout: no gradients, so no FSDP shard of the expert
        # weights over 'data'; experts stay EP over 'model', expert d_ff
        # shards over the data axes, everything else as in training.
        return _sanitize({
            "batch": data_axes,
            "seq": None,
            "layers": None,
            "embed": "data",
            "embed_fsdp": "data",
            "vocab": "model",
            "heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "mlp": "model",
            "expert_mlp": data_axes,
            "experts": "model",
            "inner": "model",
            "inner_all": "model",
            "conv_dim": "model",
            "ssm_heads": "model",
            "kv_seq": ("data", "model") if small_batch else "model",
        }, mesh)
    return _sanitize({
        "batch": data_axes,
        "seq": None,
        "layers": None,
        "embed": "data",
        "embed_fsdp": "data",
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        # head_dim is never sharded: a contraction over a sharded head_dim
        # would reduce inside every flash-attention tile
        "head_dim": None,
        "mlp": "model",
        "expert_mlp": None,
        "experts": "model",
        "inner": "model",
        "inner_all": "model",
        "conv_dim": "model",
        "ssm_heads": "model",
        "kv_seq": ("data", "model") if small_batch else "model",
    }, mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _shape(s) -> tuple:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


def spec_tree(logical_tree, shape_tree, rules, mesh):
    """Map a tree of logical-axis tuples + a tree of the same structure
    whose leaves have a `.shape` (tensors, `Spec`s) or are shapes, to
    specs (with divisibility fallback)."""
    return tree_map(lambda axes, s: logical_to_pspec(
        axes, rules, shape=_shape(s), mesh=mesh), logical_tree, shape_tree,
        leaf=_is_axes)


def sharding_tree(logical_tree, shape_tree, rules, mesh):
    """The DTensor placements of every leaf of `spec_tree`."""
    specs = spec_tree(logical_tree, shape_tree, rules, mesh)
    return tree_map(lambda sp: to_placements(sp, mesh), specs,
                    leaf=_is_spec)


def batch_sharding(mesh, rules) -> tuple:
    """Placements for (B, ...) host-data arrays: batch over data axes."""
    return to_placements((rules["batch"],) if rules["batch"] else (), mesh)


class Spec(tuple):
    """A sharded input's global shape and dtype, a (shape, dtype) pair, with
    its DTensor `placements` (None: a plain tensor): the reference's
    ShapeDtypeStruct with a sharding."""

    def __new__(cls, shape, dtype, placements=None):
        self = super().__new__(cls, (tuple(shape), dtype))
        self.placements = placements
        return self

    @property
    def shape(self) -> tuple:
        return self[0]

    @property
    def dtype(self) -> torch.dtype:
        return self[1]

    def __repr__(self):
        return f"Spec({self[0]}, {self[1]}, {self.placements})"


def sds(shape, dtype, placements=None) -> Spec:
    return Spec(shape, dtype, placements)
