"""Carry state from the reference package into the port.

The reference's state arrives as numpy arrays and plain dicts (never as
its own objects: the port does not import it), and leaves here as the
port's dataclasses and tensors, so a test can feed both packages the
same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bank import BankConfig
from repro_torch.core.spice.mna import MNASystem
from repro_torch.core.techfile import SYN40, DeviceFlavor, TechFile
from repro_torch.kernels.batched_solve.newton import FusedSpec
from repro_torch.kernels.batched_solve.sparse import PRECISIONS

_SPEC_ARRAYS = ("um", "vm", "pa", "pg", "g_safe", "a_safe", "b_safe")


def techfile_from_dict(d: dict) -> TechFile:
    """TechFile from `dataclasses.asdict` of the reference's deck. A deck
    equal to the port's SYN40 returns SYN40 itself, so topology grouping
    (keyed by the deck's identity) matches the reference's."""
    d = dict(d)
    d["devices"] = {k: v if isinstance(v, DeviceFlavor) else DeviceFlavor(**v)
                    for k, v in d["devices"].items()}
    tech = TechFile(**d)
    return SYN40 if tech == SYN40 else tech


def bank_config_from_dict(d: dict) -> BankConfig:
    """BankConfig from `dataclasses.asdict` of the reference's config; a
    missing "tech" means SYN40."""
    d = dict(d)
    tech = d.pop("tech", None)
    return BankConfig(**d, tech=SYN40 if tech is None
                      else techfile_from_dict(tech))


def fused_inputs_from_numpy(spec_fields: dict, pre: dict, Krhs, params, v0,
                            device="cuda", precision: str = "f64"):
    """The fused Newton solve's inputs in the port's form.

    spec_fields: the reference FusedSpec's fields ("n", "n_dev" and the
    numpy incidence/gather arrays); pre: the reference `precompute` dict
    as numpy; Krhs, params, v0 numpy. Returns (spec, pre, Krhs, params,
    v0) with pre/Krhs in the compute dtype and params/v0 in the store
    dtype of `precision`, on `device`."""
    sdt, cdt = PRECISIONS[precision]
    spec = FusedSpec(n=int(spec_fields["n"]), n_dev=int(spec_fields["n_dev"]),
                     precision=precision,
                     **{k: np.asarray(spec_fields[k]) for k in _SPEC_ARRAYS})

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    pre_t = {k: t(v, cdt) for k, v in pre.items()}
    return spec, pre_t, t(Krhs, cdt), t(params, sdt), t(v0, sdt)


def mna_system_from_numpy(G, C, dev: dict, didx: dict, src_node, src_wave,
                          n: int, probes: dict, names, device="cuda"):
    """The port's MNASystem from the reference system's fields as numpy:
    G/C (n, n) and the per-device parameter arrays become float64 tensors
    on `device`; the index maps stay numpy int32."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float64,
                            device=device)

    return MNASystem(t(G), t(C), {k: t(v) for k, v in dev.items()},
                     {k: np.asarray(v, np.int32) for k, v in didx.items()},
                     np.asarray(src_node, np.int32),
                     np.asarray(src_wave, np.int32), int(n), dict(probes),
                     list(names))


def model_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's `Model` holding the reference's weights.

    tree: the reference's parameter tree as numpy
    (`jax.tree.map(np.asarray, params)`): "embed", "final_norm",
    ["unembed"], and the layer stacks, every leaf stacked over a leading
    layer axis of the stack's own depth: "blocks" (dense, vlm and moe,
    n_layers; a moe block holds "moe" {router, w1, w3, w2} and, for
    arctic, "dense_mlp"), "mamba" (hybrid, n_layers; its shared block
    "shared_attn" is not stacked), "mlstm" and "slstm" (ssm, n_layers -
    n_layers // slstm_every and n_layers // slstm_every), "enc" and "dec"
    (audio, n_enc_layers and n_layers; "enc_norm" is not stacked). Layer
    i's slice goes to `<stack>[i]` under the same names, each weight in
    the dtype of the port's parameter (the working dtype, but float32 for
    the MoE router, the Mamba2 A_log, D and dt_bias, and the xLSTM gates'
    w_if, b_if and b, as in the reference) on `device`. The head layouts
    are kept as they are, so query head h stays kv head h // G, group
    h % G."""
    from repro_torch.models.model import Model, xlstm_depths

    model = Model(cfg, device="meta").to_empty(device=device)
    n_m, n_s = xlstm_depths(cfg) if cfg.slstm_every else (0, 0)
    depths = {"blocks": cfg.n_layers, "mamba": cfg.n_layers,
              "dec": cfg.n_layers, "enc": cfg.n_enc_layers,
              "mlstm": n_m, "slstm": n_s}

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    values = {}
    for name, a in flat({k: v for k, v in tree.items()
                         if k not in depths}):
        values[name] = a
    for stack, depth in depths.items():
        for name, a in flat(tree.get(stack, {})):
            if a.shape[0] != depth:
                raise ValueError(f"{stack}.{name} has {a.shape[0]} layers, "
                                 f"the config {depth}")
            for layer in range(depth):
                values[f"{stack}.{layer}.{name}"] = a[layer]
    params = dict(model.named_parameters())
    if set(values) != set(params):
        raise ValueError(f"parameter names differ: only in the tree "
                         f"{sorted(set(values) - set(params))}, only in the "
                         f"model {sorted(set(params) - set(values))}")
    with torch.no_grad():
        for name, p in params.items():
            a = values[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree {a.shape}, model "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(np.asarray(a, np.float32)).to(p.dtype))
    return model
