"""Carry state from the reference package into the port.

The reference's state arrives as numpy arrays and plain dicts (never as
its own objects: the port does not import it), and leaves here as the
port's dataclasses and tensors, so a test can feed both packages the
same inputs; model weights and training states also go back the other
way (`model_params_to_numpy`, `train_state_to_numpy`).

A model's parameters in the reference's layout are a STACKED tree
(`param_tree`, which lives with the model in `models.model`, as does
`stack_depths`): "embed", "final_norm", ["unembed"], and per family the
layer stacks of `stack_depths`, each leaf of a stack carrying a leading
layer axis of the stack's depth. The trainer's state is that tree in
float32 (the master) with the optimizer's moments of the same shapes and
a 0-d int32 "step", so it maps one to one onto the reference's
`{"params", "opt", "step"}` and onto the checkpoint layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bank import BankConfig
from repro_torch.core.spice.mna import MNASystem
from repro_torch.core.techfile import SYN40, DeviceFlavor, TechFile
from repro_torch.kernels.batched_solve.newton import FusedSpec
from repro_torch.kernels.batched_solve.sparse import PRECISIONS
from repro_torch.models.model import param_tree, stack_depths
from repro_torch.optim.optimizers import tree_map

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


def param_dtypes(cfg) -> dict:
    """The working dtype of every leaf of the stacked tree: the config's
    dtype, float32 for the MoE router, the Mamba2 A_log, D and dt_bias,
    and the xLSTM gates' w_if, b_if and b (as the reference's init)."""
    from repro_torch.models.model import Model
    return tree_map(lambda t: t.dtype, param_tree(Model(cfg,
                                                        device="meta")))


def _to_numpy(t) -> np.ndarray:
    """A tensor as numpy; bfloat16 (which numpy lacks) as float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def model_params_to_numpy(model) -> dict:
    """The inverse of `model_params_from_numpy`: the model's weights as
    the reference's stacked numpy tree (bfloat16 weights as float32)."""
    return tree_map(_to_numpy, param_tree(model))


def train_state_to_numpy(state: dict) -> dict:
    """A training state {"params", "opt", "step"} of tensors as the
    reference's numpy tree: the same keys and shapes, the step a 0-d
    int32 array."""
    return tree_map(_to_numpy, state)


def train_state_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's training state {"params", "opt", "step"} as numpy
    (`jax.tree.map(np.asarray, state)`) -> the port's, tensors of the
    same dtypes on `device` (the step a 0-d int32 tensor)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(device),
                    tree)


def model_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's `Model` holding the reference's weights.

    tree: the reference's parameter tree as numpy
    (`jax.tree.map(np.asarray, params)`), or the same tree of tensors
    (`param_tree`, a checkpoint's "params"): "embed", "final_norm",
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
    from repro_torch.models.model import Model

    model = Model(cfg, device="meta").to_empty(device=device)
    depths = stack_depths(cfg)

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

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
            if not isinstance(a, torch.Tensor):
                a = torch.tensor(np.asarray(a, np.float32))
            p.copy_(a.to(p.dtype))
    return model
