"""Deterministic traffic replay: drive a ServeEngine through scripted
phases and snapshot one TelemetryWindow per phase (the port's copy of
`repro.runtime.replay`, over `repro_torch.serving.engine.Request`).

Scenarios are the benchmark's unit of traffic shape (chat burst, batch
offline, long context). Replays are seeded and step-count-driven, so the
same scenario on a plain engine and on a telemetry-instrumented engine
produces bit-identical greedy streams — the parity check in
tests/test_runtime.py and tests/test_torch_runtime.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Phase:
    """One scripted traffic phase: submit `n_requests` identical-shape
    requests, then drive `steps` engine steps (idle steps tick the
    collector's virtual clock so quiet phases dilute window rates)."""
    name: str
    n_requests: int
    prompt_len: int
    max_new_tokens: int
    steps: int


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    phases: Tuple[Phase, ...]


def run_scenario(eng, scenario: Scenario, *, seed: int = 0,
                 collector=None, rid_base: int = 0) -> List:
    """Replay `scenario` on `eng`; returns one collector window per phase
    (empty list when no collector is attached — the plain-engine side of
    a parity comparison).

    The FINAL phase drains the engine before its snapshot, so scenarios
    compose on a reused (compile-warm) engine without leaking live slots
    into the next replay."""
    # imported here: the engine and the model import this package's spans
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    windows = []
    rid = rid_base
    for pi, ph in enumerate(scenario.phases):
        for _ in range(ph.n_requests):
            prompt = rng.integers(
                0, eng.cfg.vocab_size, ph.prompt_len).astype(np.int32)
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=ph.max_new_tokens,
                               temperature=0.0))
            rid += 1
        for _ in range(ph.steps):
            if not eng.step() and collector is not None:
                collector.tick(eng.decode_chunk)
        if pi == len(scenario.phases) - 1:
            while eng.queue or any(r is not None for r in eng.active):
                eng.step()
        if collector is not None:
            windows.append(collector.snapshot(reset=True))
    return windows
