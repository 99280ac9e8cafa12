"""Low-overhead runtime telemetry for the serving and training loops (the
port's copy of `repro.runtime.telemetry`, which has no JAX).

Design rule (asserted in tests/test_runtime.py and
tests/test_torch_serving.py): the collector is fed
exclusively from HOST-side values the engine already reconciled — the
np token/live arrays `ServeEngine._reconcile` pulls once per fused
chunk, host-tracked per-slot context lengths, python queue depths — so
attaching it to a `mode="device"` engine adds ZERO device syncs and
leaves greedy token streams bit-identical.

Clocks: with `step_time_s` set the collector runs on a `VirtualClock` —
time is model-steps x step_time_s, advanced by the chunk hooks (and by
`tick()` when a replay drives an idle engine step) — so deterministic
replays produce deterministic windows. Without it, wall time
(time.monotonic).

A `TelemetryWindow` snapshot is a frozen bag of counters; the byte-level
interpretation (KV bytes per row, weight stream, hierarchy split) lives
in `repro_torch.runtime.profile`, which converts windows into the frozen
`repro_torch.workloads.profiler.Profile` schema, and in
`repro_torch.runtime.governor`, which turns windows into macro `Traffic`.

Program spans (`span`, `spans`) time the serve path from inside: where
a prefill's or a decode step's device time goes (attention, the MoE FFN
and its dispatch, the KV-cache build) and what the host was doing when
the device ran dry. A span records only while a torch profiler is
recording; otherwise `span()` returns one shared no-op object after that
single check, so the serve path pays one call and creates no event.
While recording, each span is also a profiler range of its name (the
record function `torch.profiler.record_function` opens, through its
low-cost C++ entry), so it sits on the profiler's clock beside the
kernels; `CLOCK_OFFSET_NS` maps the registry's `time.perf_counter_ns()`
stamps (the engine's and the benchmark's host clock) onto the profiler's
Unix-epoch event stamps. Device time is a pair of CUDA events on the
current stream (the stream's time between them, its idle included) or,
off the card, the host duration; events are resolved when the registry
is read, after one synchronize, never on the serve path.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch


class VirtualClock:
    """Deterministic model-step clock: now() = steps_seen x step_time_s.

    The serving engine reads it for request timestamps; the collector
    advances it once per observed (or idle-ticked) model step."""

    def __init__(self, step_time_s: float):
        self.step_time_s = float(step_time_s)
        self._t = 0.0

    def __call__(self) -> float:
        return self._t

    def advance(self, n_steps: int = 1) -> None:
        self._t += n_steps * self.step_time_s


@dataclasses.dataclass(frozen=True)
class TelemetryWindow:
    """Counters accumulated between two `snapshot()` calls.

    `decode_steps` counts FUSED model steps (a K-step chunk adds K,
    including steps where some slots sat frozen), so
    `decode_tokens / decode_steps` is the effective live batch.
    `kv_row_steps` integrates resident KV-cache rows over model steps
    (rows sampled at chunk boundaries, capped at the engine window);
    `kv_row_steps / decode_steps` is mean resident rows.
    `kv_lifetimes_s` holds admit->retire residency per retired request
    — the observed data lifetime the governor checks retention against.
    """
    t_start_s: float
    t_end_s: float
    step_time_s: Optional[float]       # virtual-clock step, if configured
    decode_steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0            # prompt tokens pushed at admission
    n_submitted: int = 0
    n_admitted: int = 0                # each also emits 1 token at prefill
    n_retired: int = 0
    batch_hist: Tuple[Tuple[int, int], ...] = ()  # (live_slots, steps)
    queue_depth_sum: int = 0
    queue_samples: int = 0
    kv_row_steps: float = 0.0
    kv_lifetimes_s: Tuple[float, ...] = ()
    train_steps: int = 0
    train_tokens: int = 0
    train_time_s: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.t_end_s - self.t_start_s

    @property
    def mean_batch(self) -> float:
        """Tokens emitted per decode model step (effective live batch)."""
        return self.decode_tokens / self.decode_steps \
            if self.decode_steps else 0.0

    @property
    def mean_kv_rows(self) -> float:
        """Mean resident KV-cache rows across decode steps (all slots)."""
        return self.kv_row_steps / self.decode_steps \
            if self.decode_steps else 0.0

    @property
    def mean_queue_depth(self) -> float:
        return self.queue_depth_sum / self.queue_samples \
            if self.queue_samples else 0.0

    @property
    def tokens_per_s(self) -> float:
        toks = self.decode_tokens + self.n_admitted + self.train_tokens
        return toks / self.duration_s if self.duration_s > 0 else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(duration_s=self.duration_s, mean_batch=self.mean_batch,
                 mean_kv_rows=self.mean_kv_rows,
                 mean_queue_depth=self.mean_queue_depth,
                 tokens_per_s=self.tokens_per_s)
        return d


class TelemetryCollector:
    """Accumulates engine/trainer hooks into TelemetryWindows.

    Attach via `ServeEngine(..., telemetry=collector)` (serving) or
    `TrainConfig(telemetry=collector)` (training); call
    `snapshot(reset=True)` at window boundaries. All hooks are O(live
    slots) python arithmetic on host data — no device interaction."""

    def __init__(self, *, step_time_s: Optional[float] = None, clock=None):
        self.step_time_s = step_time_s
        if clock is not None:
            self.clock = clock
        elif step_time_s is not None:
            self.clock = VirtualClock(step_time_s)
        else:
            self.clock = time.monotonic
        self._reset()

    def _reset(self) -> None:
        self._t0 = self.clock()
        self._decode_steps = 0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._n_submitted = 0
        self._n_admitted = 0
        self._n_retired = 0
        self._batch: Dict[int, int] = {}
        self._queue_sum = 0
        self._queue_n = 0
        self._kv_row_steps = 0.0
        self._kv_lifetimes: List[float] = []
        self._train_steps = 0
        self._train_tokens = 0
        self._train_time = 0.0

    def _advance(self, n_steps: int) -> None:
        if isinstance(self.clock, VirtualClock):
            self.clock.advance(n_steps)

    # ------------------------------------------------------------------
    # serving hooks (called by ServeEngine; host-side data only)
    # ------------------------------------------------------------------
    def on_submit(self, rid: int, prompt_len: int, queue_depth: int) -> None:
        self._n_submitted += 1

    def on_admit(self, n_requests: int, prompt_tokens: int,
                 queue_depth: int) -> None:
        self._n_admitted += n_requests
        self._prefill_tokens += prompt_tokens
        self._queue_sum += queue_depth
        self._queue_n += 1

    def on_chunk(self, n_steps: int, emitted_tokens: int, kv_rows,
                 queue_depth: int) -> None:
        """One reconciled decode chunk: `n_steps` fused model steps,
        `emitted_tokens` tokens folded into streams, `kv_rows` the
        resident cache rows of each live slot at the chunk boundary."""
        self._advance(n_steps)
        self._decode_steps += n_steps
        self._decode_tokens += emitted_tokens
        n_live = len(kv_rows)
        self._batch[n_live] = self._batch.get(n_live, 0) + n_steps
        self._kv_row_steps += float(sum(kv_rows)) * n_steps
        self._queue_sum += queue_depth
        self._queue_n += 1

    def on_retire(self, stats) -> None:
        self._n_retired += 1
        self._kv_lifetimes.append(stats.service_s)

    def tick(self, n_steps: int = 1) -> None:
        """Advance the virtual clock across an IDLE engine step (no
        dispatch happened). Idle time dilutes window rates — exactly what
        the governor should see from a quiet macro."""
        self._advance(n_steps)
        self._batch[0] = self._batch.get(0, 0) + n_steps

    # ------------------------------------------------------------------
    # training hook (called by training.loop.Trainer)
    # ------------------------------------------------------------------
    def on_train_step(self, step: int, tokens: int, dt_s: float,
                      loss: Optional[float] = None) -> None:
        self._train_steps += 1
        self._train_tokens += int(tokens)
        self._train_time += float(dt_s)

    # ------------------------------------------------------------------
    def snapshot(self, reset: bool = True) -> TelemetryWindow:
        win = TelemetryWindow(
            t_start_s=self._t0, t_end_s=self.clock(),
            step_time_s=self.step_time_s,
            decode_steps=self._decode_steps,
            decode_tokens=self._decode_tokens,
            prefill_tokens=self._prefill_tokens,
            n_submitted=self._n_submitted, n_admitted=self._n_admitted,
            n_retired=self._n_retired,
            batch_hist=tuple(sorted(self._batch.items())),
            queue_depth_sum=self._queue_sum, queue_samples=self._queue_n,
            kv_row_steps=self._kv_row_steps,
            kv_lifetimes_s=tuple(self._kv_lifetimes),
            train_steps=self._train_steps, train_tokens=self._train_tokens,
            train_time_s=self._train_time)
        if reset:
            self._reset()
        return win


# ---------------------------------------------------------------------------
# program spans
# ---------------------------------------------------------------------------

# spans kept in memory (oldest dropped first, counted in `spans_dropped`)
SPAN_CAPACITY = 1 << 17
# perf_counter_ns stamp + CLOCK_OFFSET_NS = the profiler's event stamp
CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_profiling = torch._C._autograd._profiler_enabled
# a `record_function` range at a tenth of its host cost
_RANGE = torch._C._profiler._RecordFunctionFast
_registry: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_open = threading.local()
_dropped = 0


class _Off:
    """The span of a run no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span: `name`, `id`, `parent` (the id of the innermost
    span open around it, or None), `t0_ns` / `t1_ns` on
    `time.perf_counter_ns()`, `counts` (integers; `rids` a tuple of
    request ids), and, once read through `spans()`, `device_s` and
    `self_s` (its device time less its children's)."""
    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "counts",
                 "device_s", "self_s", "_stream", "_events", "_range")

    def __init__(self, name, device, counts):
        self.name, self.counts = name, counts
        self.id = next(_ids)
        self.device_s = self.self_s = None
        device = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            and torch.cuda.is_initialized() else None)
        self._stream = (torch.cuda.current_stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self._events = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.t0_ns = time.perf_counter_ns()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        global _dropped
        if self._events is not None:
            self._events[1].record(self._stream)
        self.t1_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        if len(_registry) == _registry.maxlen:
            _dropped += 1
        _registry.append(self)
        return False


def span(name: str, *, device=None, **counts):
    """A context manager timing the code inside it as the span `name`
    while a torch profiler records; the shared no-op otherwise. `device`:
    where its work runs (CUDA: device time from events on the current
    stream; None: the current CUDA device once CUDA is initialized, else
    the host); `counts`: integers (or `rids`, request ids) kept with it."""
    if not _profiling():
        return _OFF
    return Span(name, device, counts)


def spans(since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that began and ended inside [since_ns,
    until_ns] (perf_counter_ns), in the order they began, with `device_s`
    and `self_s` resolved (one device synchronize if any is unresolved)."""
    lo = since_ns if since_ns is not None else -(1 << 62)
    hi = until_ns if until_ns is not None else 1 << 62
    out = sorted((s for s in list(_registry)
                  if lo <= s.t0_ns and s.t1_ns <= hi),
                 key=lambda s: (s.t0_ns, s.id))
    pending = [s for s in out if s.device_s is None]
    if any(s._events is not None for s in pending):
        torch.cuda.synchronize()
    for s in pending:
        if s._events is not None:
            s.device_s = s._events[0].elapsed_time(s._events[1]) / 1000.0
            s._events = s._stream = None
        else:
            s.device_s = (s.t1_ns - s.t0_ns) / 1e9
    children: Dict[int, float] = {}
    for s in out:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.device_s
    for s in out:
        s.self_s = s.device_s - children.get(s.id, 0.0)
    return out


def spans_dropped() -> int:
    """Spans pushed out of the registry by newer ones since the start."""
    return _dropped
