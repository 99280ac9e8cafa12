"""Optimizers (port of `repro.optim`): AdamW and Adafactor over trees of
tensors, `make_optimizer` that picks the config's, the learning-rate
schedules, and the projected-Adam design optimizer behind
`OptimizeQuery` (`dse_opt`)."""
from repro_torch.optim.optimizers import (adafactor, adamw, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import make_schedule

__all__ = ["adamw", "adafactor", "make_optimizer", "global_norm",
           "make_schedule"]
