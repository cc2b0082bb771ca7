"""Fault-tolerance runtime: the step watchdog (the reference's
``runtime/fault.py``; its retry policy has no caller in the port yet)."""
from __future__ import annotations

import dataclasses
import logging
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
