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
