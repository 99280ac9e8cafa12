"""Runtime telemetry of the serving loop (port of `repro.runtime`, its
collector only). Profiles, the voltage governor and replays are deferred
(ROADMAP Queue 1 item 13)."""
from repro_torch.runtime.telemetry import (TelemetryCollector, TelemetryWindow,
                                           VirtualClock)

__all__ = ["TelemetryCollector", "TelemetryWindow", "VirtualClock"]
