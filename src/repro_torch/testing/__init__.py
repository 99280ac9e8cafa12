"""Deterministic fault-injection harness for chaos tests and the
fleet (port of `repro.testing`)."""
from repro_torch.testing.faults import FaultInjector, FaultSpec, InjectedFault

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault"]
