"""Fault-tolerance runtime: the step watchdog and the retry policy (the
reference's ``runtime/fault.py``)."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running median of the
    last 100; the decision is pluggable via ``on_straggler``."""
    threshold: float = 3.0
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: list = dataclasses.field(default_factory=list)
    straggler_count: int = 0

    def observe(self, step: int, dt: float):
        if len(self._times) >= self.warmup_steps:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.threshold * med:
                self.straggler_count += 1
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, dt, med)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self._times.append(dt)
        if len(self._times) > 100:
            self._times.pop(0)


@dataclasses.dataclass
class RetryPolicy:
    """Retries a step function on transient failures (preemption, a
    collective timeout), ``max_retries`` times with exponential backoff;
    ``fallback`` (e.g. the uncompressed step) runs after the last
    failure, else the last error is raised."""
    max_retries: int = 3
    backoff_s: float = 0.1

    def run(self, fn: Callable, *args, fallback: Optional[Callable] = None):
        last = None
        for attempt in range(self.max_retries):
            try:
                return fn(*args)
            except Exception as e:
                last = e
                log.warning("step failed (attempt %d): %s", attempt + 1, e)
                time.sleep(self.backoff_s * (2 ** attempt))
        if fallback is not None:
            log.warning("falling back after %d failures", self.max_retries)
            return fallback(*args)
        raise last
