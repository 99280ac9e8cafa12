"""Batched serving engine: prefill + decode with slot-based continuous
batching (port of `repro.serving.engine`).

The engine owns a fixed decode batch of `n_slots` sequences and a KV
cache sized (slots, window). Requests are queued (deque, O(1) FIFO);
whenever slots free (EOS or max tokens) waiting requests are admitted in
prompt-length groups: equal-length prompts prefill in ONE batched
forward, with the batch dim padded to a power-of-two bucket (edge
repeat), as the reference does for compiled-program reuse. The prompt
length itself is never padded. Pad rows are dropped by selecting the
real rows explicitly: the reference gives them an out-of-bounds slot
index that JAX's scatter ignores, which torch indexing would not.

Every family the model serves goes through the same engine, which asks
the model what differs: `Model.stub_inputs` gives the prefill's frontend
inputs (the audio family's `frames`, the vlm family's `patches`, zeros as
in the reference), `Model.prefix_rows` the cache rows and positions they
take before the prompt (n_patches). A request must fit its cache: it
writes n_patches + len(prompt) + max_new_tokens - 1 rows (the last token
emitted is never fed back), and `submit` raises a ValueError when that
exceeds the window (the reference clamps the write position instead),
unless `Model.rows_bounded` is False (a sliding-window ring, the ssm
family's state).

Decode (`mode="device"`): `Model.decode_loop` runs `decode_chunk` steps
of decode_step + sampling (greedy and top-k temperature, from the
engine's `torch.Generator`) with no host sync; finished slots freeze
inside the chunk, so a slot that stops mid-chunk emits exactly its
budget. Right after a chunk is enqueued, its (toks, live) block is
copied into pinned host memory with `non_blocking=True` and a CUDA event
is recorded; reconcile waits on that event only (one blocking sync per
chunk, counted in `host_syncs`). `run()` enqueues chunk N+1 before it
reconciles chunk N, so host bookkeeping (retire, admit, prefill
enqueue) overlaps device compute; a freed slot rejoins one chunk later.
Admission writes only the admitted slots' rows, in stream order behind
any in-flight chunk. `step()` stays synchronous (admit -> one chunk ->
reconcile) for lifecycle tests.

`mode="host"` keeps the per-token loop (logits to the host, numpy-rng
sampling every token) as the parity and throughput reference: greedy
token streams are equal across modes; stochastic streams share the top-k
support but not the random stream (see serving/sampling.py).
`host_syncs` counts blocking device->host transfers in both modes.

Observability: a completed-request log (`request_log`) and an optional
duck-typed `telemetry` collector (repro_torch.runtime) fed only from
host-side values the engine already reconciled, so it adds no device
syncs and cannot change a token stream.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.sampling import sample_host, sample_tokens

TOP_K_MAX = 64      # default width of the device sampler's top-k candidates


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 40
    eos_id: Optional[int] = None  # emitting this token stops the request
    out_tokens: Optional[list] = None
    # engine-stamped lifecycle times (engine clock, seconds)
    t_submit_s: Optional[float] = None
    t_admit_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Lifecycle record of one COMPLETED request, appended to
    `ServeEngine.request_log` at retire. Timestamps come from the engine
    clock — the `clock` it was given, else an attached telemetry
    collector's virtual clock, else `time.monotonic`. The first token is
    sampled at admission, so `t_first_s == t_admit_s`."""
    rid: int
    prompt_len: int
    emitted: int
    t_submit_s: float
    t_admit_s: float
    t_first_s: float
    t_retire_s: float

    @property
    def queue_wait_s(self) -> float:
        return self.t_admit_s - self.t_submit_s

    @property
    def service_s(self) -> float:
        """Admission-to-retire residency — the observed data lifetime of
        the request's KV-cache rows."""
        return self.t_retire_s - self.t_admit_s


class ServeEngine:
    """Serve `model` (a `repro_torch.models.model.Model` holding the
    weights, on the device the engine runs on) for config `cfg`."""

    def __init__(self, cfg, model, *, n_slots=4, window=512, seed=0,
                 mode="device", decode_chunk=8, top_k_max=TOP_K_MAX,
                 telemetry=None, clock=None):
        if mode not in ("device", "host"):
            raise ValueError(f"mode must be 'device' or 'host': {mode!r}")
        if not isinstance(model, Model):
            raise TypeError(f"ServeEngine serves a repro_torch Model, got "
                            f"{type(model).__name__}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.window = self.model.kv_window(window)
        self.mode = mode
        self.decode_chunk = max(1, int(decode_chunk)) if mode == "device" \
            else 1
        self.top_k_max = top_k_max
        # device sampling stream; the np rng only feeds the host-mode
        # reference sampler — the two streams intentionally differ
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.default_rng(seed)

        self.cache = self.model.init_cache(n_slots, self.window)
        self.active: List[Optional[Request]] = [None] * n_slots
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self.host_syncs = 0       # all blocking device->host transfers
        self.admit_syncs = 0      # ...of which admission (prefill) syncs
        # host-side prediction of per-slot emitted counts INCLUDING
        # in-flight chunks (exact up to EOS), so run() can skip chunks in
        # which every slot would sit frozen
        self._pred = [0] * n_slots

        # the engine clock: `clock` if given, else the collector's
        # (virtual clocks make replays deterministic), else wall time
        self.telemetry = telemetry
        self.clock = clock if clock is not None else \
            (getattr(telemetry, "clock", None) or time.monotonic)
        self.request_log: List[RequestStats] = []
        # host-tracked per-slot context length (KV-cache rows in use)
        self._ctx = [0] * n_slots

        # per-slot decode state, on the device
        i32 = dict(dtype=torch.int32, device=self.device)
        self.pos = torch.zeros((n_slots,), **i32)
        self.last_tok = torch.zeros((n_slots, 1), **i32)
        self.emitted = torch.zeros((n_slots,), **i32)
        self.done_mask = torch.ones((n_slots,), dtype=torch.bool,
                                    device=self.device)
        self._temp_d = torch.zeros((n_slots,), dtype=torch.float32,
                                   device=self.device)
        self._topk_d = torch.ones((n_slots,), **i32)
        self._maxnew_d = torch.zeros((n_slots,), **i32)
        self._eos_d = torch.full((n_slots,), -1, **i32)
        # host-mode mirror of the feedback tokens, uploaded once per step
        self._tok_np = np.zeros((n_slots, 1), np.int32)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        n_p = self.model.prefix_rows
        rows = n_p + len(req.prompt) + req.max_new_tokens - 1
        if self.model.rows_bounded and rows > self.window:
            raise ValueError(
                f"request {req.rid}: n_patches + prompt + max_new_tokens - 1"
                f" = {n_p} + {len(req.prompt)} + {req.max_new_tokens} - 1 "
                f"cache rows exceed the engine's window {self.window}; "
                f"admission needs n_patches + prompt + max_new - 1 <= window"
                f" (a longer request would write past the cache)")
        if (self.mode == "device" and req.temperature > 0
                and req.top_k > self.top_k_max):
            warnings.warn(
                f"request {req.rid}: top_k={req.top_k} exceeds the "
                f"engine's top_k_max={self.top_k_max}; device sampling "
                f"draws from the top {self.top_k_max} candidates only (host "
                f"mode would use the full top_k) — raise "
                f"ServeEngine(top_k_max=...) for wider sampling")
        req.out_tokens = []
        req.t_submit_s = self.clock()
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(req.rid, len(req.prompt),
                                     len(self.queue))

    def _free_slots(self):
        return [i for i, r in enumerate(self.active) if r is None]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    # ------------------------------------------------------------------
    # admission: length-grouped, batch-bucketed prefill
    # ------------------------------------------------------------------
    def _admit(self):
        free = self._free_slots()
        if not free or not self.queue:
            return
        take = []
        for slot in free:
            if not self.queue:
                break
            take.append((slot, self.queue.popleft()))
        groups = {}
        for slot, req in take:
            groups.setdefault(len(req.prompt), []).append((slot, req))
        for items in groups.values():
            self._admit_group(items)
        if self.mode == "host":
            self.last_tok = self._upload(self._tok_np)

    def _admit_group(self, items):
        """One prefill for equal-length prompts, batch padded to a
        power-of-two bucket (edge repeat); only the real rows are
        written back."""
        B = len(items)
        toks = np.stack([r.prompt for _, r in items]).astype(np.int32)
        Bp = 1 << (B - 1).bit_length()
        if Bp > B:
            toks = np.concatenate(
                [toks, np.repeat(toks[-1:], Bp - B, axis=0)])
        batch = {"tokens": self._upload(toks),
                 **self.model.stub_inputs(toks.shape[0])}
        idx = self._upload(np.array([s for s, _ in items], np.int64))

        if self.mode == "device":
            # (top_k, max_new, eos) packed into one int32 upload; pad rows
            # sample greedily and are never written back
            meta_i = np.full((3, Bp), -1, np.int32)
            meta_i[1] = 1
            temp = np.zeros((Bp,), np.float32)
            for i, (_, r) in enumerate(items):
                meta_i[0, i] = r.top_k
                meta_i[1, i] = r.max_new_tokens
                meta_i[2, i] = -1 if r.eos_id is None else r.eos_id
                temp[i] = r.temperature
            meta_d, r_temp = self._upload(meta_i), self._upload(temp)
            logits, rows, rpos = self.model.prefill(batch, W=self.window)
            tok = sample_tokens(logits, self.gen, r_temp, meta_d[0],
                                k_max=self.top_k_max)[:B]
            r_topk, r_maxnew, r_eos = meta_d[:, :B]
            fin = (r_maxnew <= 1) | ((r_eos >= 0) & (tok == r_eos))
            for name, c in self.cache.items():
                c[:, idx] = rows[name][:, :B].to(c.dtype)
            self.pos[idx] = rpos[:B]
            self.last_tok[idx, 0] = tok
            self.emitted[idx] = 1
            self.done_mask[idx] = fin
            self._temp_d[idx] = r_temp[:B]
            self._topk_d[idx] = r_topk
            self._maxnew_d[idx] = r_maxnew
            self._eos_d[idx] = r_eos
            first = tok.cpu().numpy()
            self.host_syncs += 1
            self.admit_syncs += 1
            self._record_first_tokens(items, first)
            return

        logits, cache_g, rpos = self.model.prefill(batch, W=self.window)
        logits_np = logits.float().cpu().numpy()
        self.host_syncs += 1
        self.admit_syncs += 1
        first = np.array(
            [sample_host(logits_np[i], r.temperature, r.top_k, self.rng)
             for i, (_, r) in enumerate(items)], np.int32)
        for name, c in self.cache.items():
            c[:, idx] = cache_g[name][:, :B].to(c.dtype)
        self.pos[idx] = rpos[:B]
        self._record_first_tokens(items, first)

    def _record_first_tokens(self, items, first):
        """Shared admission bookkeeping: record each request's prefill
        token, retire requests that finish at prefill (max_new <= 1 or
        EOS — the device path computes the matching `fin` flag), and
        activate the rest. Both modes run this identically."""
        now = self.clock()
        for i, (slot, req) in enumerate(items):
            t = int(first[i])
            req.out_tokens.append(t)
            req.t_admit_s = now
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (req.eos_id is not None and t == req.eos_id)):
                self.done.append(req)      # finished at prefill
                self._log_done(req, now)
                continue
            self.active[slot] = req
            # one cache row per backbone position: the patches, then the
            # prompt
            self._ctx[slot] = len(req.prompt) + self.model.prefix_rows
            self._tok_np[slot, 0] = t
            self._pred[slot] = 1
        if self.telemetry is not None:
            self.telemetry.on_admit(
                len(items), sum(len(r.prompt) for _, r in items),
                len(self.queue))

    def _log_done(self, req, now):
        fallback = lambda t: t if t is not None else now
        st = RequestStats(req.rid, len(req.prompt), len(req.out_tokens),
                          fallback(req.t_submit_s), fallback(req.t_admit_s),
                          fallback(req.t_admit_s), now)
        self.request_log.append(st)
        if self.telemetry is not None:
            self.telemetry.on_retire(st)

    def _retire(self, slot):
        req = self.active[slot]
        self.active[slot] = None
        self._ctx[slot] = 0
        self.done.append(req)
        self._log_done(req, self.clock())

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _dispatch_chunk(self):
        """Enqueue one K-token decode and the copy of its (K, slots) token
        and live blocks to the host, WITHOUT waiting. Returns what
        `_reconcile` needs."""
        samp = lambda lg: sample_tokens(lg, self.gen, self._temp_d,
                                        self._topk_d,
                                        k_max=self.top_k_max)
        (self.cache, self.last_tok, self.pos, self.emitted, self.done_mask,
         toks, live) = self.model.decode_loop(
            self.cache, self.last_tok, self.pos, self.emitted,
            self._maxnew_d, self.done_mask, self._eos_d, samp,
            n_tokens=self.decode_chunk)
        ready = None
        if toks.is_cuda:
            toks_h = torch.empty(toks.shape, dtype=toks.dtype,
                                 pin_memory=True)
            live_h = torch.empty(live.shape, dtype=live.dtype,
                                 pin_memory=True)
            toks_h.copy_(toks, non_blocking=True)
            live_h.copy_(live, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            toks, live = toks_h, live_h
        for slot, req in enumerate(self.active):
            if req is not None:
                self._pred[slot] = min(self._pred[slot] + self.decode_chunk,
                                       req.max_new_tokens)
        return toks, live, ready, list(self.active)

    def _reconcile(self, toks, live, ready, snapshot):
        """Fold a (K, slots) chunk back into the request streams recorded
        at dispatch time and retire finished slots (one blocking sync)."""
        if ready is not None:
            ready.synchronize()
        self.host_syncs += 1
        toks, live = toks.numpy(), live.numpy()
        if self.telemetry is not None:
            # per-slot emitted counts are the live-mask column sums; the
            # hook runs BEFORE the retire loop so a virtual clock has
            # advanced past this chunk when retire timestamps are stamped
            em = live.sum(axis=0)
            rows = [min(self._ctx[s]
                        + (int(em[s]) if self.active[s] is r else 0),
                        self.window)
                    for s, r in enumerate(snapshot) if r is not None]
            self.telemetry.on_chunk(
                toks.shape[0],
                int(sum(int(em[s]) for s, r in enumerate(snapshot)
                        if r is not None)),
                rows, len(self.queue))
        for slot, req in enumerate(snapshot):
            if req is None:
                continue
            n_app = 0
            for k in range(toks.shape[0]):
                if not live[k, slot]:
                    break                 # slot froze earlier in the chunk
                req.out_tokens.append(int(toks[k, slot]))
                n_app += 1
            if self.active[slot] is not req:
                continue                  # slot re-admitted since dispatch
            self._ctx[slot] = min(self._ctx[slot] + n_app, self.window)
            self._tok_np[slot, 0] = req.out_tokens[-1]
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and req.out_tokens[-1] == req.eos_id)):
                self._retire(slot)

    def _may_emit(self):
        """Host-side prediction of whether any slot can still produce
        tokens (EOS hits are only discovered at reconcile)."""
        return any(r is not None and self._pred[s] < r.max_new_tokens
                   for s, r in enumerate(self.active))

    def step(self):
        """One synchronous engine iteration: admit waiting requests, then
        one decode dispatch — `decode_chunk` tokens (device mode) or a
        single token (host mode) — and reconcile."""
        self._admit()
        # a whole admission wave can finish at prefill without occupying
        # a slot — keep draining the queue
        while all(r is None for r in self.active) and self.queue:
            self._admit()
        if all(r is None for r in self.active):
            return False
        if self.mode == "host":
            return self._step_host()
        self._reconcile(*self._dispatch_chunk())
        return True

    def _step_host(self):
        """The per-token loop: one decode_step, logits pulled to the host,
        numpy-rng sampling per slot. Kept as the parity reference."""
        logits, self.cache = self.model.decode_step(self.cache,
                                                    self.last_tok, self.pos)
        self.pos = self.pos + 1
        logits_np = logits.float().cpu().numpy()
        self.host_syncs += 1
        if self.telemetry is not None:
            rows = [min(self._ctx[s] + 1, self.window)
                    for s, r in enumerate(self.active) if r is not None]
            self.telemetry.on_chunk(1, len(rows), rows, len(self.queue))
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = sample_host(logits_np[slot], req.temperature, req.top_k,
                              self.rng)
            req.out_tokens.append(tok)
            self._ctx[slot] = min(self._ctx[slot] + 1, self.window)
            self._tok_np[slot, 0] = tok
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                self._retire(slot)
        self.last_tok = self._upload(self._tok_np)
        return True

    def run(self, max_steps=10000):
        """Serve until queue and slots drain. Device mode pipelines: the
        next chunk is enqueued before the previous chunk's tokens are
        read, so reconcile/admit/prefill run while the device decodes (a
        freed slot rejoins one chunk later)."""
        steps = 0
        if self.mode == "host":
            while (self.queue or any(r is not None for r in self.active)) \
                    and steps < max_steps:
                self.step()
                steps += 1
            return self.done, steps
        pending = None
        while steps < max_steps:
            if pending is None:
                self._admit()   # nothing in flight: admit synchronously
                while not self._may_emit() and self.queue:
                    self._admit()
                if not self._may_emit():
                    break
            nxt = self._dispatch_chunk() if self._may_emit() else None
            if pending is not None:
                self._reconcile(*pending)
            self._admit()       # freed slots rejoin at the NEXT chunk
            pending = nxt
            steps += 1
        if pending is not None:
            self._reconcile(*pending)
        return self.done, steps
