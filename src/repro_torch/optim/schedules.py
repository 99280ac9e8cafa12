"""Learning-rate schedules (port of `repro.optim.schedules`): cosine
(llama-style) and WSD (minicpm's Warmup-Stable-Decay).

Each is a pure function of the step, an integer or an integer tensor, to
a float32 0-d tensor on the step's device, with no branch on the step's
value (so no host sync inside a train step). The arithmetic is the
reference's float32: the step is cast to float32 and every constant
enters as a float32 tensor.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step32(step):
    return torch.as_tensor(step).to(F32)


def cosine(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Linear warmup to `peak_lr` over `warmup_steps`, then a cosine from
    peak_lr down to min_ratio * peak_lr at `total_steps`."""
    step = _step32(step)
    c = lambda x: step.new_tensor(x)  # noqa: E731
    warm = c(peak_lr) * step / c(max(warmup_steps, 1))
    t = torch.clamp((step - c(warmup_steps))
                    / c(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = c(peak_lr) * (c(min_ratio) + c((1 - min_ratio) * 0.5)
                        * (1 + torch.cos(c(math.pi) * t)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr, warmup_steps, total_steps, decay_frac=0.1,
        min_ratio=0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    plateau at peak, and an exponential decay to min_ratio * peak_lr over
    the last `decay_frac` of training."""
    step = _step32(step)
    c = lambda x: step.new_tensor(x)  # noqa: E731
    warm = c(peak_lr) * step / c(max(warmup_steps, 1))
    decay_start = total_steps * (1 - decay_frac)
    t = torch.clamp((step - c(decay_start))
                    / c(max(total_steps - decay_start, 1)), 0.0, 1.0)
    decay = c(peak_lr) * torch.exp(torch.log(c(min_ratio)) * t)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start, c(peak_lr), decay))


def make_schedule(name, **kw):
    """The schedule `name` ("cosine" or "wsd") with its keywords bound:
    a function of the step alone."""
    base = {"cosine": cosine, "wsd": wsd}[name]

    def fn(step):
        return base(step, **kw)
    return fn
