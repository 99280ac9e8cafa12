"""Optimizers (port of `repro.optim`): AdamW and the projected-Adam
design optimizer behind `OptimizeQuery` (`dse_opt`). The training
optimizers and schedules wait for ROADMAP Queue 1 item 13."""
