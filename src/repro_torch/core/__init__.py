"""Port of `repro.core`: techfile, cells, layout, bank, timing and the
lattice helpers the transient characterization needs."""
