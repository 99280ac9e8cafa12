"""Port of `repro.training`: the fault-tolerant training loop."""
from repro_torch.training.loop import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig"]
