"""Seeded weights, drawn on the device by the benchmark itself.

The reference module of a configuration names every weight with its
shape, dtype and role (`layout`). All weights of one dtype come out of
one normal draw (a `torch.Generator` on the device, seeded with the
run's seed), cut into views and scaled by role:

  embed   std 1: the residual stream starts at unit RMS;
  in      std 1/sqrt(fan_in): every input projection gives unit-RMS
          outputs from unit-RMS (normed) inputs;
  out     std 1/sqrt(fan_in * R), R the configuration's residual
          branches: each branch adds about 1/sqrt(R) of the stream's RMS,
          so the stream stays near unit RMS through the whole depth, as a
          trained model's does, and no branch swamps the others (the
          program's own init, 1/sqrt(fan_in) everywhere, grows the stream
          layer by layer and makes a deep stack amplify rounding);
  router  std 1/sqrt(d), float32;
  ones    norm scales;
  zeros   biases that start at zero;
  given   values the reference module works out itself, by its
          `initial(c, name, shape, dtype, gen, device)` in plain torch,
          from the run's own generator: state and biases whose published
          initialisation is not a scaled normal draw, such as Mamba2's
          `A_log` (the log of a uniform draw) and `dt_bias` (the inverse
          softplus of a log-uniform step). They are made after every
          normal draw, so the tensors of the other roles are the same
          with or without them.

The same tensors go to the program (`load_into`) and to the reference.
"""
from __future__ import annotations

import math

import torch

_CHUNK = 1 << 30          # elements per draw call


def _fill_normal(buf, gen):
    flat = buf.view(-1)
    for a in range(0, flat.numel(), _CHUNK):
        part = flat[a:a + _CHUNK]
        part.normal_(0.0, 1.0, generator=gen)


def draw(layout, residual_branches: int, seed: int, device,
         initial=None) -> dict:
    """name -> tensor of every weight of `layout` ((name, shape, dtype,
    role, fan_in) entries), from `seed`; `initial(name, shape, dtype, gen,
    device)` makes the "given" entries."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    random = [e for e in layout if e[3] in ("embed", "in", "out", "router")]
    out = {}
    by_dtype = {}
    for name, shape, dtype, role, fan_in in random:
        by_dtype.setdefault(dtype, []).append((name, shape, role, fan_in))
    for dtype, items in by_dtype.items():
        total = sum(math.prod(s) for _, s, _, _ in items)
        buf = torch.empty(total, dtype=dtype, device=device)
        _fill_normal(buf, gen)
        at = 0
        for name, shape, role, fan_in in items:
            n = math.prod(shape)
            t = buf[at:at + n].view(shape)
            at += n
            if role == "embed":
                std = 1.0
            elif role == "out":
                std = 1.0 / math.sqrt(fan_in * residual_branches)
            else:                                      # in, router
                std = 1.0 / math.sqrt(fan_in)
            t.mul_(std)
            out[name] = t
    for name, shape, dtype, role, _ in layout:
        if name in out or role == "given":
            continue
        if role == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif role == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown weight role {role!r} of {name}")
    for name, shape, dtype, role, _ in layout:
        if role != "given":
            continue
        if initial is None:
            raise ValueError(f"{name} is given, and no initial() was passed")
        t = initial(name, shape, dtype, gen, device)
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"initial() made {name} {tuple(t.shape)} "
                             f"{t.dtype}, the layout says {shape} {dtype}")
        out[name] = t
    return {name: out[name] for name, *_ in layout}


def load_into(model, weights: dict):
    """Hand `weights` to the program's model (built on the meta device),
    after checking that its parameters are exactly the layout's names,
    shapes and dtypes."""
    mine = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    theirs = {n: (tuple(t.shape), t.dtype) for n, t in weights.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))[:6]
        raise RuntimeError(f"the program's parameters differ from the "
                           f"benchmark's layout: {diff}")
    model.load_state_dict(weights, assign=True, strict=True)
    return model
