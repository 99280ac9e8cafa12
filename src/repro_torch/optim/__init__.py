"""Optimizers (port of `repro.optim`): AdamW and the projected-Adam
design optimizer behind `OptimizeQuery` (`dse_opt`). The training
optimizers and schedules (`adafactor`, `make_optimizer`, `make_schedule`)
raise NotImplementedError until ROADMAP Queue 1 item 13c."""
from repro_torch._deferred import deferred
from repro_torch.optim.optimizers import (_TRAINING, adafactor, adamw,
                                          global_norm, make_optimizer)

make_schedule = deferred("schedules.make_schedule", _TRAINING)

__all__ = ["adamw", "adafactor", "make_optimizer", "global_norm",
           "make_schedule"]
