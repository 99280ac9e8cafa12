"""Port of `repro.core.spice`: EKV devices, MNA assembly, the transient
integrator and the batched read characterization."""
