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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


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
    queue_waits_s: Tuple[float, ...] = ()
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
        self._queue_waits: List[float] = []
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
        self._queue_waits.append(stats.queue_wait_s)

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
            queue_waits_s=tuple(self._queue_waits),
            train_steps=self._train_steps, train_tokens=self._train_tokens,
            train_time_s=self._train_time)
        if reset:
            self._reset()
        return win
