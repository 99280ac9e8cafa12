"""Workload profiles for co-design (port of `repro.workloads`)."""
from repro_torch.workloads.profiler import (Profile, demands_table,
                                            hierarchy_split, plan_memory,
                                            profile_arch, profile_config,
                                            profile_from_dryrun)

__all__ = ["Profile", "demands_table", "hierarchy_split", "plan_memory",
           "profile_arch", "profile_config", "profile_from_dryrun"]
