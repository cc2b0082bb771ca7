"""Training loop: straggler watchdog, comm-failure retry (compressed step
-> fallback step), metrics. Checkpoint and resume wait for the
checkpoint slice (ROADMAP queue 1, item 8)."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

from repro_torch.runtime.fault import StragglerWatchdog

log = logging.getLogger("repro_torch.trainer")

_NO_CKPT = "checkpoints are not ported: ROADMAP queue 1, item 8"


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_dir: Optional[str] = None    # not ported: raises
    log_every: int = 10


class Trainer:
    """Drives a train step over a dataset with fault handling.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``.
    If ``metrics["ok"]`` is False (compressed-wire escape-pool overflow),
    the step is redone with ``fallback_step_fn``: the lossless guarantee
    holds by retrying on the uncompressed path rather than accepting
    corrupt gradients. ``on_step(step, metrics) -> Optional[new_step_fn]``
    runs after each completed step; a callable it returns replaces
    ``step_fn`` from the next step on.
    """

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 fallback_step_fn: Optional[Callable] = None,
                 on_step: Optional[Callable] = None):
        if cfg.checkpoint_dir:
            raise NotImplementedError(_NO_CKPT)
        self.cfg = cfg
        self.step_fn = step_fn
        self.fallback_step_fn = fallback_step_fn
        self.on_step = on_step
        self.watchdog = StragglerWatchdog()
        self.history: list = []
        self.comm_fallbacks = 0

    def run(self, params, opt_state, dataset, start_step: int = 0):
        step = start_step
        while step < self.cfg.total_steps:
            batch = dataset.batch_at(step)
            t0 = time.perf_counter()
            params2, opt2, metrics = self.step_fn(params, opt_state, batch)
            ok = bool(metrics.get("ok", True))
            metrics["ok"] = ok
            if not ok and self.fallback_step_fn is not None:
                self.comm_fallbacks += 1
                log.warning("comm escape overflow at step %d; retrying "
                            "uncompressed", step)
                del params2, opt2
                params2, opt2, metrics = self.fallback_step_fn(
                    params, opt_state, batch)
            params, opt_state = params2, opt2
            del params2, opt2
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            if self.on_step is not None:
                new_step_fn = self.on_step(step, metrics)
                if new_step_fn is not None:
                    log.info("step fn replaced at step %d", step)
                    self.step_fn = new_step_fn
            step += 1
            self.history.append({"step": step, "loss": loss, "dt": dt,
                                 "ok": ok})
            if step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
        return params, opt_state
