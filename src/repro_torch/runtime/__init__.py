"""Runtime telemetry + adaptive voltage governor: the loop from the live
serving engine back into co-design (port of `repro.runtime`).

Three layers: `telemetry` accumulates host-side counters from the
serving loop (zero extra device syncs); `profile` converts a telemetry
window into the frozen `workloads.profiler.Profile` schema so measured
workloads feed `CoDesignQuery` unchanged; `governor` moves a deployed
macro along its precomputed `VddLattice` as measured traffic shifts.
`replay` drives deterministic traffic scenarios for benchmarks and
tests.
"""
from repro_torch.runtime.governor import (Decision, GovernorPolicy, Traffic,
                                          VddGovernor, replay_fixed,
                                          traffic_from_window)
from repro_torch.runtime.profile import (DIFF_FIELDS, diff_profiles,
                                         kv_row_bytes, kv_stream_bytes,
                                         measured_profile)
from repro_torch.runtime.replay import Phase, Scenario, run_scenario
from repro_torch.runtime.telemetry import (TelemetryCollector,
                                           TelemetryWindow, VirtualClock)

__all__ = [
    "TelemetryCollector", "TelemetryWindow", "VirtualClock",
    "measured_profile", "diff_profiles", "kv_row_bytes", "kv_stream_bytes",
    "DIFF_FIELDS",
    "Traffic", "traffic_from_window", "GovernorPolicy", "Decision",
    "VddGovernor", "replay_fixed",
    "Phase", "Scenario", "run_scenario",
]
