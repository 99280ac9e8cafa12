"""Port of `repro.models`: the dense decoder family (common, attention,
transformer, model)."""
