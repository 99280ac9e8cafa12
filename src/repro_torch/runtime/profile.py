"""Measured workload profiles: TelemetryWindow -> `workloads.profiler.
Profile`, so runtime observations feed `CoDesignQuery` UNCHANGED and can
be diffed field-by-field against the analytic profiles. The port's copy
of `repro.runtime.profile`; parameters are counted on the meta device.

Byte model (mirrors `workloads.profiler._bytes_classes`):
  weights      one stream of active params x 2 bytes/step (x3 training)
  kv           per resident row per layer, (K+V) x n_kv_heads x head_dim
               x itemsize bytes (itemsize 1 for int8 KV, else 2); the
               measured resident rows come from the window's
               `kv_row_steps` integral instead of the analytic
               batch x seq_len assumption
  activations  ~12 materialized tensors/layer x 2 bytes x tokens/step
               x d_model

The hierarchy split (per-instance L1/L2 Hz) is the SAME
`workloads.profiler.hierarchy_split` the analytic path uses, so a
measured-vs-analytic diff isolates genuine traffic differences, not
modeling skew. Lifetimes: KV lifetime is the mean observed
admit->retire residency (the governor uses the max — see
`runtime.governor.traffic_from_window`); activation lifetime is one
layer's slice of the step, as in the analytic profile.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.runtime.telemetry import TelemetryWindow


def kv_row_bytes(cfg) -> float:
    """Bytes one KV-cache row (one token position, one layer) occupies."""
    itemsize = 1.0 if cfg.kv_dtype == "int8" else 2.0
    return 2.0 * cfg.n_kv_heads * cfg.hd() * itemsize


def kv_stream_bytes(win: TelemetryWindow, cfg) -> float:
    """Total KV bytes streamed across the window: every decode step
    re-reads each live slot's resident rows in every layer, so the
    stream is the rows-over-steps integral x per-row bytes x layers."""
    L = max(cfg.n_layers + cfg.n_enc_layers, 1)
    return L * win.kv_row_steps * kv_row_bytes(cfg)


def measured_profile(win: TelemetryWindow, cfg, *,
                     arch: Optional[str] = None, shape: str = "measured",
                     n_devices: int = 1,
                     step_time_s: Optional[float] = None):
    """Convert one telemetry window into a frozen Profile.

    `step_time_s` overrides the per-step time (defaults to the window's
    virtual-clock step, else observed duration / steps — note the
    latter includes idle time). `n_devices` splits the traffic when the
    measured engine stands in for a pod (default 1: profile the device
    that actually ran)."""
    from repro_torch.launch.roofline import active_params
    from repro_torch.workloads.profiler import Profile, hierarchy_split

    if win.train_steps and win.decode_steps:
        raise ValueError("telemetry window mixes serving and training "
                         "steps; snapshot them separately")
    kind = "train" if win.train_steps else "decode"
    steps = win.train_steps or win.decode_steps
    if steps == 0:
        raise ValueError("empty telemetry window: no model steps observed")
    if step_time_s is not None:
        step = float(step_time_s)
    elif win.step_time_s is not None:
        step = win.step_time_s
    elif kind == "train":
        step = win.train_time_s / steps
    else:
        step = win.duration_s / steps
    L = max(cfg.n_layers + cfg.n_enc_layers, 1)
    n_active = active_params(cfg)

    if kind == "train":
        toks = win.train_tokens / steps            # tokens per step
        wb = 2.0 * n_active * 3.0                  # fwd + bwd(dgrad+wgrad)
        kvb = 0.0
        kv_life = step
        flops_per_step = 3.0 * 2.0 * n_active * toks
    else:
        toks = win.mean_batch
        wb = 2.0 * n_active
        kvb = L * win.mean_kv_rows * kv_row_bytes(cfg)
        kv_life = sum(win.kv_lifetimes_s) / len(win.kv_lifetimes_s) \
            if win.kv_lifetimes_s else win.duration_s
        flops_per_step = 2.0 * n_active * toks
    act = 2.0 * toks * cfg.d_model * 12
    l1_hz, l2_hz = hierarchy_split(
        flops_per_step / step / n_devices,
        (wb + kvb + act) / n_devices / step)
    return Profile(
        arch or f"measured:{cfg.name}", shape, kind, step, wb, kvb,
        act / L,
        weight_reuse_s=3600.0 * 24,
        kv_lifetime_s=kv_life,
        act_lifetime_s=step / L,
        l1_read_hz=l1_hz,
        l2_read_hz=l2_hz)


DIFF_FIELDS = ("step_time_s", "weights_bytes", "kv_bytes",
               "act_bytes_per_layer", "l1_read_hz", "l2_read_hz")


def diff_profiles(measured, analytic,
                  fields=DIFF_FIELDS) -> Dict[str, float]:
    """Relative deviation per field: (measured - analytic) / analytic
    (exact-zero analytic fields report 0.0 on match, 1.0 on mismatch)."""
    out = {}
    for f in fields:
        a, m = getattr(analytic, f), getattr(measured, f)
        out[f] = (m - a) / a if a else float(m != a)
    return out
