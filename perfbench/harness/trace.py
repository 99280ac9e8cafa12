"""The traced part of a `--trace 1` run: `torch.profiler` over a stretch
of the window, read back into the device's busy time, its idle gaps (each
labelled with what the harness was doing on the host then), device time by
kernel, and the shapes of every flash-attention launch in it.

Host labels are `torch.profiler.record_function` ranges that the harness
opens around its calls into the program ("pb.<what>"); a gap is labelled
with the innermost one that covers its middle.
"""
from __future__ import annotations

import time

import torch

FLASH_KERNEL = "flash_attention_tc_kernel"


def label(name: str):
    """A host range the trace attributes idle gaps to."""
    return torch.profiler.record_function(f"pb.{name}")


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(ev, f"{what}_us")() * 1000


class Tracer:
    """Profile from `start()` to `stop()`; both synchronize the device, so
    every launch enqueued in between is in the trace, and no other."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.flash = []          # launch args (B, Sq, Skv, H, K, hd, ...)
        self.active = False
        self.done = False
        self._restore = None

    def _record_flash(self):
        """Record the shape of every tensor-core flash launch while tracing:
        the kernel module's launch function, wrapped (its launch counters
        carried over, and back when the trace ends)."""
        try:
            from repro_torch.kernels.flash_attention import kernel
        except ImportError:
            return
        orig = getattr(kernel, "flash_attention_tc", None)
        if orig is None:
            return

        def recorded(q, k, v, args):
            if self.active:
                self.flash.append(tuple(args))
            return orig(q, k, v, args)
        counters = [a for a in ("launches", "noncausal_launches")
                    if hasattr(orig, a)]
        for a in counters:
            setattr(recorded, a, getattr(orig, a))
        kernel.flash_attention_tc = recorded
        self._restore = (kernel, orig, recorded, counters)

    def _unwrap(self):
        if self._restore is not None:
            kernel, orig, recorded, counters = self._restore
            for a in counters:
                setattr(orig, a, getattr(recorded, a))
            kernel.flash_attention_tc = orig
            self._restore = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._record_flash()
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self):
        if not self.active:
            return
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.active = False
        self.done = True
        self._unwrap()
        self._read()

    def abandon(self):
        """Stop without reading (a run that failed inside the trace)."""
        if self.active:
            self.active = False
            self.prof.__exit__(None, None, None)
            self.prof = None
        self._unwrap()

    def _read(self):
        dev, host, host_names = [], [], set()
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, start + dur, name))
            else:
                host_names.add(name)
                if name.startswith("pb."):
                    host.append((start, start + dur, name))
        # a host range also shows on the device's timeline (a user
        # annotation spanning its kernels): not an operation
        dev = sorted(d for d in dev if d[2] not in host_names)
        self.prof = None
        merged = []
        for a, b, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        by_name = {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0) + (b - a)
        self.device_ops = sorted(([n[:160], t / 1e9] for n, t in
                                  by_name.items()), key=lambda x: -x[1])[:10]
        self.flash_device_s = [(b - a) / 1e9 for a, b, n in dev
                               if FLASH_KERNEL in n]
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
                 merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        self.idle_gaps = []
        for g, a, b in gaps[:10]:
            mid = (a + b) / 2
            inside = [h for h in host if h[0] <= mid <= h[1]]
            name = max(inside)[2] if inside else "pb.none"
            self.idle_gaps.append([name, g / 1e9])

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def flash_roofline(ctx, kind):
    """Sum of the bound time of every traced `flash_attention_tc` launch
    (from its recorded shape, `flops.flash_bound_s`) over the sum of their
    device times, in percent; None without a trace, in another kind of
    cell, or when the launches and the kernels in the trace do not pair
    up."""
    from perfbench.harness.flops import flash_bound_s
    t = ctx.get("tracer")
    if ctx.get("kind") != kind or t is None or not t.done:
        return None
    if not t.flash or len(t.flash) != len(t.flash_device_s):
        return None
    bound = sum(flash_bound_s(*a[:10]) for a in t.flash)
    return 100.0 * bound / sum(t.flash_device_s)
