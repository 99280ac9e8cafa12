"""Serve driver: an open loop of requests through the program's
`ServeEngine.run()` (slots, length-grouped prefill, device decode loop).

Set-up draws the weights, builds the engine and warms it up with the
mix's longest and shortest prompts (one decode chunk each). The window
then opens: requests arrive on the traffic file's schedule, and are
submitted when due from the engine's own hooks (its telemetry interface:
admission and each decode chunk) or, while it is idle, from this loop.
Every clock reading is this process's `time.perf_counter`, which the
engine is given as its clock, so its first-token and retire stamps are
the host's arrival times of those tokens.

After the window the engine drains (every request due in the window
completes), the device peak is read, the engine is freed, and a sample of
the finished requests is run through the configuration's plain float32
reference. Per served (greedy) token, the gap by which its reference
logit lies below the reference's best at its position; the mix's
"limits" name which of the widest gap and the trimmed mean are compared
for `correct`.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import flops, traffic as tr, weights as wts
from perfbench.harness.common import Check, check_widths, counts, \
    port_config, process_age_s, reference
from perfbench.harness.trace import Tracer, label


class _Spans:
    """CUDA-event spans (host clock on the CPU) around the model's
    prefill and decode-loop calls, with their shapes."""

    def __init__(self, model, device):
        self.model, self.cuda = model, device.type == "cuda"
        # (host start, rows or steps, start, end)
        self.prefill, self.decode = [], []

    def _time(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def install(self):
        pf, dl = self.model.prefill, self.model.decode_loop

        def prefill(batch, *a, **k):
            now = time.perf_counter()
            B, S = batch["tokens"].shape
            with label("prefill"):
                t0 = self._time()
                out = pf(batch, *a, **k)
                self.prefill.append((now, B * S, t0, self._time()))
            return out

        def decode_loop(*a, n_tokens, **k):
            now = time.perf_counter()
            with label("decode_loop"):
                t0 = self._time()
                out = dl(*a, n_tokens=n_tokens, **k)
                self.decode.append((now, n_tokens, t0, self._time()))
            return out
        self.model.prefill, self.model.decode_loop = prefill, decode_loop

    def totals(self, spans, before):
        """(rows or steps, seconds) summed over the spans that began on the
        host before `before`."""
        if self.cuda:
            torch.cuda.synchronize()
        n = s = 0.0
        for h, k, a, b in spans:
            if h < before:
                n += k
                s += a.elapsed_time(b) / 1000.0 if self.cuda else b - a
        return n, s


class _Loop:
    """The open loop: due requests go to the engine from its hooks. A
    tracer, if given, profiles the last `trace_s` seconds of the window;
    the host's per-layer readings are taken before it starts (`cut`),
    since tracing slows the host."""

    def __init__(self, engine, reqs, clock, tracer, trace_s, seconds):
        self.engine, self.reqs, self.clock = engine, reqs, clock
        self.tracer, self.seconds = tracer, seconds
        self.trace_from = seconds - trace_s
        self.cut = None              # host time the trace began
        self.syncs_at_cut = None
        self.next = 0
        self.t0 = None
        self.live = {}               # rid -> engine Request
        self.stats = {}              # rid -> RequestStats
        self.admits = []             # (t, prompt tokens + first tokens)
        self.chunks = []             # (t, tokens emitted, mean context)

    # -- the engine's telemetry interface ---------------------------------
    def on_submit(self, rid, prompt_len, queue_len):
        pass

    def on_admit(self, n, prompt_tokens, queue_len):
        if self.t0 is None:              # warm-up
            return
        now = self.clock()
        self.admits.append((now, prompt_tokens + n))
        self.poll(now)

    def on_chunk(self, steps, emitted, rows, queue_len):
        if self.t0 is None:
            return
        now = self.clock()
        self.chunks.append((now, emitted, float(np.mean(rows)) if rows
                            else 0.0))
        self.poll(now)

    def on_retire(self, st):
        self.stats[st.rid] = st

    # -- arrivals ----------------------------------------------------------
    def poll(self, now):
        tracer = self.tracer
        if tracer is not None and not tracer.active and not tracer.done \
                and now >= self.t0 + self.trace_from:
            self.cut, self.syncs_at_cut = now, self.engine.host_syncs
            tracer.start()
        elif tracer is not None and tracer.active \
                and now >= self.t0 + self.seconds:
            tracer.stop()
        from repro_torch.serving import Request
        while self.next < len(self.reqs) \
                and self.t0 + self.reqs[self.next].due_s <= now:
            q = self.reqs[self.next]
            r = Request(rid=q.index, prompt=q.prompt, max_new_tokens=q.max_new)
            self.live[q.index] = r
            with label("submit"):
                self.engine.submit(r)
            self.next += 1

    def run(self):
        self.t0 = self.clock()
        try:
            self._serve()
        except BaseException:
            if self.tracer is not None:
                self.tracer.abandon()
            raise
        if self.tracer is not None:
            self.poll(max(self.clock(), self.t0 + self.seconds))

    def _serve(self):
        eng = self.engine
        while True:
            self.poll(self.clock())
            if eng.queue or any(r is not None for r in eng.active):
                with label("engine_run"):
                    eng.run(max_steps=1 << 30)
            elif self.next < len(self.reqs):
                due = self.t0 + self.reqs[self.next].due_s
                if self.tracer is not None and not self.tracer.done:
                    due = min(due, self.t0 + (self.seconds if self.cut
                                              else self.trace_from))
                wait = due - self.clock()
                if wait > 0:
                    with label("await_arrival"):
                        time.sleep(wait)
            else:
                break


def _warm_up(engine, mix, vocab, seed):
    """The mix's longest and shortest prompts, each through one prefill and
    one decode chunk."""
    from repro_torch.serving import Request
    rng = np.random.default_rng([int(seed), 0x3A9])
    for i, n in enumerate((mix["prompt"]["max"], mix["prompt"]["min"])):
        engine.submit(Request(rid=-1 - i, prompt=rng.integers(
            0, vocab, n).astype(np.int32),
            max_new_tokens=mix["decode_chunk"] + 1))
    engine.run()


class Served:
    """A built serve cell: the weights, the program's model and engine."""

    def __init__(self, cell, seed, device, override=None):
        from repro_torch.models.model import Model
        from repro_torch.serving import ServeEngine
        self.c, self.mix, self.device = cell.config, cell.traffic, device
        counts(self.c)          # the window counts with it: fail here
        cfg = port_config(self.c, override)
        check_widths(cfg, self.c)
        self.ref = reference(self.c)
        self.weights = wts.draw(
            self.ref.layout(self.c), self.ref.residual_branches(self.c),
            seed, device,
            initial=lambda *a: self.ref.initial(self.c, *a))
        self.model = wts.load_into(Model(cfg, device="meta"), self.weights)
        mix = self.mix
        self.engine = ServeEngine(
            cfg, self.model, n_slots=mix["n_slots"],
            window=mix["prompt"]["max"] + mix["output"]["max"], seed=seed,
            mode="device", decode_chunk=mix["decode_chunk"],
            telemetry=None, clock=time.perf_counter)
        _warm_up(self.engine, mix, self.c["vocab_size"], seed)
        self.spans = _Spans(self.model, device)
        self.spans.install()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def window(self, reqs, seconds, tracer=None):
        """Serve `reqs` on their schedule; returns (end-to-end metrics,
        the readers' context, the loop)."""
        c, eng, spans = self.c, self.engine, self.spans
        spans.prefill.clear()
        spans.decode.clear()
        loop = _Loop(eng, reqs, time.perf_counter, tracer,
                     self.mix["trace_seconds"], seconds)
        eng.telemetry = loop
        syncs0 = eng.host_syncs
        loop.run()
        eng.telemetry = None
        t0, t1 = loop.t0, loop.t0 + seconds
        done = [loop.stats[q.index] for q in reqs if q.index in loop.stats]
        admitted = sum(n for t, n in loop.admits if t0 <= t <= t1)
        decoded = sum(n for t, n, _ in loop.chunks if t0 <= t <= t1)
        metrics = {"tokens_per_s": (admitted + decoded) / seconds}
        # per-layer readings: the window up to the trace (all of it when
        # untraced), the engine's syncs over it and the drain
        cut = loop.cut if loop.cut is not None else t1
        syncs = (loop.syncs_at_cut if loop.cut is not None
                 else eng.host_syncs) - syncs0
        pf_n, pf_s = spans.totals(spans.prefill, cut)
        dl_n, dl_s = spans.totals(spans.decode, cut)
        ctx = {
            "kind": "serve", "config": c, "window_s": cut - t0,
            "host_syncs": syncs,
            "completed": sum(1 for s in done if s.t_retire_s < cut)
            if loop.cut is not None else len(done),
            "prefill_tokens": pf_n, "prefill_s": pf_s,
            "decode_steps": dl_n, "decode_s": dl_s,
            "model_flops": sum(
                flops.prefill_flops(c, 1, len(reqs[s.rid].prompt))
                for s in done if t0 <= s.t_first_s <= cut) + sum(
                n * flops.decode_flops(c, x) for t, n, x in loop.chunks
                if t0 <= t <= cut),
            "tracer": tracer,
            # tokens_per_s's parts: admissions (prompts and their first
            # tokens) and decode chunks
            "window_tokens": {"admitted": admitted, "decoded": decoded},
        }
        return metrics, ctx, loop


def run(cell, seed: int, seconds: float, trace: bool, device,
        override=None):
    """One run of a serve cell. Returns (metrics, checks, extra) where
    extra holds "attempted", "failed", "setup_s", "peak", the readers'
    context "ctx" and, traced, "busy_s", "window_s" and "breakdown"."""
    sv = Served(cell, seed, device, override)
    reqs = tr.serve_schedule(sv.mix, seed, seconds, sv.c["vocab_size"])
    tracer = Tracer(device) if trace else None
    setup_s = process_age_s()
    metrics, ctx, loop = sv.window(reqs, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # correctness: a sample of the finished requests against the reference
    sample = tr.check_sample(reqs, sv.mix, seed)
    served = {i: list(loop.live[i].out_tokens) for i in sample}
    loop_done = loop.stats
    sv.engine = sv.model = sv.spans = loop = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = gaps(sv.ref, sv.c, sv.weights, reqs, served, device)
    checks, other = checks_of(sv.mix, readings)
    extra = {"attempted": len(reqs),
             "failed": len(reqs) - len(loop_done),
             "setup_s": setup_s, "peak": peak, "ctx": ctx,
             "readings": dict(other, served_tokens_compared=readings[2],
                              **{f"window_tokens_{k}": v for k, v in
                                 ctx["window_tokens"].items()})}
    if tracer is not None and tracer.done:
        extra.update(busy_s=tracer.busy_s, window_s=tracer.window_s,
                     breakdown=tracer.breakdown())
    return metrics, checks, extra


def _sequence(reqs, i, out, device):
    """The sequence the reference runs for request i (its prompt and its
    served tokens but the last) and the rows whose logits chose them."""
    prompt = torch.as_tensor(reqs[i].prompt, device=device)
    seq = torch.cat([prompt, torch.as_tensor(out[:-1], dtype=prompt.dtype,
                                             device=device)])
    return seq, torch.arange(len(prompt) - 1, len(seq), device=device)


def token_gaps(ref, c, weights, reqs, served, device, choose=None):
    """Per served token, the gap between the reference's best logit and its
    logit of the token at that position: the served token; with `choose`
    "altered" the served token plus one (the fault of a token altered
    where it is produced, read in the reference's place); with "fp8" or
    "bf16" the token the reference computed in that precision puts first
    (the control, and a witness of the configuration's own rounding). One
    float32 tensor over the sample."""
    out_gaps = []
    for i, out in served.items():
        seq, rows = _sequence(reqs, i, out, device)
        lg = ref.logits(c, weights, seq, rows)
        pick = torch.as_tensor(out, device=device).long()
        if choose == "altered":
            pick = (pick + 1) % lg.shape[-1]
        elif choose is not None:
            pick = ref.logits(c, weights, seq, rows, choose).argmax(-1)
        out_gaps.append(lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0])
    return torch.cat(out_gaps)


def summary(g):
    """(widest, trimmed mean, count) of a tensor of gaps: the trimmed mean
    leaves out the largest TRIM share of the gaps."""
    g = g.sort().values
    keep = g[:len(g) - math.ceil(TRIM * len(g))]
    return float(g[-1]), float(keep.mean()), len(g)


def gaps(*args, **kwargs):
    """`summary` of `token_gaps`."""
    return summary(token_gaps(*args, **kwargs))


# the share of the largest served-token gaps the trimmed mean leaves out
TRIM = 0.02


NUMBERS = {"gap": ("served_token_logit_gap", 0),
           "trimmed_gap": ("served_token_trimmed_mean_gap", 1)}


def checks_of(mix, readings):
    """The numbers the mix's "limits" name, as checks; the rest as
    readings not compared."""
    checks, other = [], {}
    for key, (name, i) in NUMBERS.items():
        if key in mix["limits"]:
            checks.append(Check(name, readings[i], mix["limits"][key]))
        else:
            other[name] = readings[i]
    return checks, other
