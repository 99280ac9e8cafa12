"""Roofline terms of an analysis dict (port of `repro.launch.roofline`).

  compute term    = HLO_FLOPs / (chips x peak)      [per-device flops / peak]
  memory term     = HLO_bytes / (chips x HBM bw)
  collective term = wire bytes / (chips x link bw)

The analysis dict's flops, bytes and wire bytes are PER-DEVICE, so the
terms divide by per-chip rates directly. Producing that dict from a
compiled program (`hlo_analysis`) waits for ROADMAP Queue 1 item 13d.

PEAK_FLOPS, HBM_BW and LINK_BW are the reference's parameters of its
analytic target pod (256 chips of a TPU v5e class), on which every
workload `Profile` is defined. The port keeps the same values so that its
co-design results equal the reference's. They describe that analytic
target, not the card the port runs on.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 197e12      # bf16 FLOP/s per chip of the reference's target pod
HBM_BW = 819e9           # bytes/s per chip of that pod
LINK_BW = 50e9           # bytes/s per inter-chip link of that pod


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # 6*N*D useful flops (global)
    hlo_flops_global: float
    bottleneck: str
    step_time_s: float          # max of the three (no-overlap bound)
    mfu: float                  # model_flops / (chips*peak*step_time)
    roofline_frac: float        # dominant-term utilization vs its peak

    def as_dict(self):
        return self.__dict__.copy()


def derive(analysis: dict, *, n_chips: int, model_flops: float) -> Roofline:
    f = analysis["flops"]                 # per-device
    b = analysis["mem_bytes"]
    w = analysis["collective_wire_bytes"]
    ct = f / PEAK_FLOPS
    mt = b / HBM_BW
    lt = w / LINK_BW
    terms = {"compute": ct, "memory": mt, "collective": lt}
    bottleneck = max(terms, key=terms.get)
    step = max(ct, mt, lt)
    hlo_global = f * n_chips
    mfu = model_flops / (n_chips * PEAK_FLOPS * step) if step > 0 else 0.0
    # fraction of roofline: time the dominant resource is busy doing the
    # dominant term's work vs the whole step (1.0 = perfectly bound)
    frac = terms[bottleneck] / step if step > 0 else 0.0
    return Roofline(ct, mt, lt, model_flops, hlo_global, bottleneck, step,
                    mfu, frac)


def active_params(cfg) -> int:
    """Active weights of `cfg`, counted on the meta device (no storage).
    A family the port's Model does not build yet raises
    NotImplementedError naming its ROADMAP item."""
    from repro_torch.models.model import Model
    return Model(cfg, device="meta").param_count(active_only=True)


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE) per step; decode D = batch tokens."""
    n = active_params(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks  # forward only
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence
