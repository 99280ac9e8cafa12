"""Port of `repro.launch`: the serving launcher (`serve`)."""
