"""Straggler detection: step-time monitoring, the JAX package's
``repro.distributed.straggler``, code for code.

On a synchronous mesh a straggling host shows up as a slow global step.
The monitor tracks a per-step EWMA and flags outliers (a step slower than
``threshold`` x the running mean, after ``warmup_steps``) without letting
them into the mean. In this package it watches the per-epoch times of the
resumable executor: :class:`repro_torch.core.executor.ExecutionGuard`
feeds it and emits a ``guard.straggler`` telemetry event per verdict.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup_steps: int = 5, history: int = 100):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.ewma: Optional[float] = None
        self.step = 0
        self.events: deque[StragglerEvent] = deque(maxlen=history)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, step_time: float) -> Optional[StragglerEvent]:
        self.step += 1
        if self.ewma is None:
            self.ewma = step_time
            return None
        event = None
        ratio = step_time / max(self.ewma, 1e-9)
        if self.step > self.warmup_steps and ratio > self.threshold:
            event = StragglerEvent(self.step, step_time, self.ewma, ratio)
            self.events.append(event)
            # do not pollute the EWMA with the outlier
            return event
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return event
