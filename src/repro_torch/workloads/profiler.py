"""GainSight-analogue workload profiler (paper Table I + Fig 9); port of
`repro.workloads.profiler`.

The paper profiles NVIDIA L1/L2 cache demands per AI task and matches
them against GCRAM configs. Here the workloads are OUR ten assigned
architectures x shapes, profiled on the TPU-v5e-target memory hierarchy
from the compiled dry-run artifacts (DESIGN.md §2 assumption 4). The
profile is analytic: the pod's rates are the reference's target-pod
parameters (`launch/roofline.py`), and parameters are counted on the
meta device, so profiling allocates no weights:

  per (arch, shape):
    step_time        roofline step bound (launch/roofline.py)
    traffic classes  weights / kv-state / activations bytes per step
                     (analytic from the config; cross-checked against the
                     dry-run's HLO bytes)
    "L1" demand      per-CORE working-buffer request rate: the chip's
                     operand feed split over n_cores x banks_per_core
                     L1 instances; lifetime ~ one layer
    "L2" demand      the SHARED level: aggregate L1 misses (AI workloads
                     stream — low L1 reuse, miss ratio ~0.6) plus the
                     weight/KV stream, split over the few wide L2 banks.
                     This is the paper's "counterintuitive" Fig 9 finding:
                     L2 per-bank read frequency EXCEEDS L1's because L2 is
                     shared by all cores; lifetime = class reuse interval

Demands feed core/dse.shmoo — the Fig 10 reproduction.
"""
from __future__ import annotations

import glob
import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.dse import Demand
from repro_torch.launch import roofline as rl

# hierarchy shape (H100-class, matching GainSight's profiling target);
# L1_MISS=0.25: tiled GEMMs reuse operands in L1, attention/streams miss.
# Module-level so measured profiles (repro_torch.runtime.profile) split
# their traffic over the SAME hierarchy as the analytic ones.
N_CORES = 128
BANKS_PER_CORE = 8
L2_BANKS = 128
L1_MISS = 0.25
REUSE_DEPTH = 64          # operand-reuse window amortizing the L1 feed
WORD_BYTES = 4.0          # bytes per cache request


def hierarchy_split(flops_per_s: float, stream_bytes_per_s: float):
    """Split one device's compute + HBM-stream rates into PER-INSTANCE
    L1/L2 read Hz on the profiled hierarchy — the single source of truth
    for both analytic (`profile_config`) and measured
    (`repro_torch.runtime.profile.measured_profile`) profiles.

    Operand feed: ~2 words/MAC amortized over a REUSE_DEPTH-deep reuse
    window; L2 sees the L1 miss stream plus the class (weight/KV/act)
    stream, divided over the few wide L2 banks — the paper's Fig 9
    "shared L2 exceeds L1 per-bank rate" effect."""
    l1_bw = flops_per_s * 2 * 2 / REUSE_DEPTH      # bytes/s on-chip feed
    l1_per_bank = l1_bw / (N_CORES * BANKS_PER_CORE) / WORD_BYTES
    l2_per_bank = (L1_MISS * l1_bw + stream_bytes_per_s) / L2_BANKS \
        / WORD_BYTES
    return l1_per_bank, l2_per_bank


@dataclass(frozen=True)
class Profile:
    """One (arch, shape) workload's memory-demand profile.

    Units: times/lifetimes in seconds, traffic in bytes per step,
    `l1_read_hz` / `l2_read_hz` in PER-INSTANCE request Hz — the
    aggregate on-chip feed is already split over the profiled
    hierarchy's (cores x banks) memory instances. Single-bank
    feasibility compares these directly against a bank's `f_max_hz`;
    when one bank falls short, multibanking covers the same rate in
    aggregate (the `core.dse.Demand` convention).
    Frozen (hashable) so `repro_torch.api.CoDesignQuery` tuples of Profiles can
    key session memoization."""
    arch: str
    shape: str
    kind: str
    step_time_s: float
    weights_bytes: float
    kv_bytes: float
    act_bytes_per_layer: float
    weight_reuse_s: float        # lifetime demand for weight memory (s)
    kv_lifetime_s: float
    act_lifetime_s: float
    l1_read_hz: float
    l2_read_hz: float

    def demands(self) -> List[Demand]:
        """The profile's two cache-level Demands. Frequencies are
        per-instance Hz (already split over the hierarchy's banks — see
        class docstring), lifetimes seconds."""
        return [
            Demand(f"{self.arch}:{self.shape}", "L1",
                   self.l1_read_hz, self.act_lifetime_s),
            Demand(f"{self.arch}:{self.shape}", "L2",
                   self.l2_read_hz,
                   max(self.kv_lifetime_s, self.act_lifetime_s)),
        ]


def _bytes_classes(cfg, shape):
    """Analytic per-step traffic per class (bf16)."""
    n_active = rl.active_params(cfg)
    wb = 2.0 * n_active                       # one stream of active weights
    if shape.kind == "train":
        wb *= 3.0                             # fwd + bwd(dgrad+wgrad)
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    act = 2.0 * toks * cfg.d_model * 12       # ~12 materialized tensors/layer
    kv = 0.0
    if shape.kind != "train":
        W = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        kv = (2.0 * cfg.n_layers * shape.global_batch * W
              * cfg.n_kv_heads * cfg.hd() * 2)
        if cfg.ssm_state:
            kv += (cfg.n_layers * shape.global_batch * 4
                   * (cfg.d_model * cfg.ssm_expand // max(cfg.ssm_headdim, 1))
                   * cfg.ssm_headdim * cfg.ssm_state)
    return wb, kv, act


def profile_config(cfg, shape, *, arch_name: Optional[str] = None,
                   shape_name: Optional[str] = None, n_devices: int = 256,
                   step_time_s: Optional[float] = None) -> Profile:
    """Analytic profile of an explicit (config, shape) on an
    `n_devices`-way pod. Demands are derived at TARGET efficiency — 50%
    MFU for train/prefill, HBM-stream-bound for decode — so the memory
    system is sized for what the accelerator is SUPPOSED to sustain, not
    for the current software baseline. `step_time_s` overrides the
    roofline step (used when diffing against MEASURED profiles, which
    observe a real per-step time)."""
    wb, kvb, act = _bytes_classes(cfg, shape)
    mf = rl.model_flops_for(cfg, shape)
    if step_time_s is not None:
        step = float(step_time_s)
    elif shape.kind == "decode":
        step = max((wb + kvb) / n_devices / rl.HBM_BW,
                   mf / (n_devices * rl.PEAK_FLOPS))
    else:
        step = mf / (n_devices * rl.PEAK_FLOPS) / 0.5
    L = cfg.n_layers + cfg.n_enc_layers

    layer_t = step / max(L, 1)
    decode_session = shape.seq_len * step if shape.kind == "decode" else step
    flops_dev = rl.model_flops_for(cfg, shape) / n_devices
    stream_bw = (wb + kvb + act) / n_devices / step  # HBM-side class stream
    l1_per_bank, l2_per_bank = hierarchy_split(flops_dev / step, stream_bw)
    return Profile(
        arch_name or cfg.name, shape_name or shape.name, shape.kind, step,
        wb, kvb, act / max(L, 1),
        weight_reuse_s=3600.0 * 24,                # weights live for the job
        kv_lifetime_s=decode_session,
        act_lifetime_s=layer_t,
        l1_read_hz=l1_per_bank,
        l2_read_hz=l2_per_bank,
    )


def profile_arch(arch: str, shape_name: str,
                 dryrun_record: Optional[dict] = None) -> Profile:
    """Profile a registered (arch, shape) pair on the 256-device pod
    (dryrun_record's own step is recorded for reference only)."""
    from repro_torch.configs import get_config, SHAPES
    return profile_config(get_config(arch), SHAPES[shape_name],
                          arch_name=arch, shape_name=shape_name)


def profile_from_dryrun(results_dir: str) -> List[Profile]:
    out = []
    for path in sorted(glob.glob(f"{results_dir}/*pod256.json")):
        rec = json.load(open(path))
        out.append(profile_arch(rec["arch"], rec["shape"], rec))
    return out


def demands_table(profiles: List[Profile], **kw) -> List[Demand]:
    ds = []
    for p in profiles:
        ds.extend(p.demands(**kw))
    return ds


# ---------------------------------------------------------------------------
# memory-system planner: pick a GCRAM config per buffer class (the paper's
# "activation caches need us lifetimes; weight memory needs hours" §V-D)
# ---------------------------------------------------------------------------

def plan_memory(profile: Profile, points=None,
                device="cuda") -> Dict[str, dict]:
    """For each buffer class pick the smallest-area feasible GCRAM bank;
    without `points`, the default lattice is swept on `device`."""
    from repro_torch.core import dse
    if points is None:
        from repro_torch.api import Session
        points = Session(device=device).sweep().points
    classes = {
        "activation_cache": Demand("act", "L1", profile.l1_read_hz,
                                   profile.act_lifetime_s),
        "kv_state": Demand("kv", "L2", profile.l2_read_hz,
                           profile.kv_lifetime_s),
        "weight_memory": Demand("w", "L2", profile.l2_read_hz,
                                profile.weight_reuse_s),
    }
    plan = {}
    for name, d in classes.items():
        feas = [p for p in points if dse.feasible(p, d)]
        if feas:
            # prefer density: max bits/area among feasible
            best = max(feas, key=lambda p: p.cfg.bits / p.area_um2)
            plan[name] = {"feasible": True, **best.as_dict()}
        else:
            plan[name] = {"feasible": False,
                          "demand_hz": d.read_freq_hz,
                          "lifetime_s": d.lifetime_s}
    return plan
