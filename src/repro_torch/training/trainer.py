"""Training loop: checkpoint and resume, straggler watchdog, comm-failure
retry (compressed step -> fallback step), metrics."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, Layout
from repro_torch.models.transformer import tree_leaves
from repro_torch.runtime.fault import StragglerWatchdog

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    log_every: int = 10
    keep_checkpoints: int = 3


class Trainer:
    """Drives a train step over a dataset with fault handling.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``.
    If ``metrics["ok"]`` is False (compressed-wire escape-pool overflow),
    the step is redone with ``fallback_step_fn``: the lossless guarantee
    holds by retrying on the uncompressed path rather than accepting
    corrupt gradients; the attempt's ``"adapt/*"`` telemetry is kept in
    the metrics. ``on_step(step, metrics) -> Optional[new_step_fn]``
    runs after each completed step; a callable it returns replaces
    ``step_fn`` from the next step on. With ``checkpoint_dir``,
    ``(params, opt_state)`` is saved with ``extra={"step": step}`` every
    ``checkpoint_every`` steps and after the last one, and
    :meth:`restore_or` resumes from the latest checkpoint.

    ``save_extra() -> dict`` adds entries to every save's ``extra`` (the
    launcher's wire registry), and :meth:`restore_or` leaves the restored
    checkpoint's ``extra`` in ``restored_extra``.

    ``layout`` (``checkpoint.Layout``): how the ranks of the run hold
    ``(params, opt_state)``. Every rank saves into the one
    ``checkpoint_dir``, which holds the whole tree as the reference
    saves it, with ``extra["layout"] = {"data": D, "model": M}``; every
    rank resumes from rank 0's latest step, cut to its own parts (under
    FSDP, ``Layout.data_cut``: each rank's ``data x model`` block of the
    parameters and moments it was given, restored in place). None:
    one rank, the tree saved as it is. ``ckpt_seconds`` holds the stage
    seconds (``CheckpointManager.timings``, and ``total``) of the restore
    and of the last save.
    """

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 fallback_step_fn: Optional[Callable] = None,
                 on_step: Optional[Callable] = None,
                 layout: Optional[Layout] = None,
                 save_extra: Optional[Callable[[], dict]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.fallback_step_fn = fallback_step_fn
        self.on_step = on_step
        self.save_extra = save_extra
        self.restored_extra: dict = {}
        self.layout = layout or Layout()
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir,
                                       keep=cfg.keep_checkpoints)
                     if cfg.checkpoint_dir else None)
        self.history: list = []
        self.comm_fallbacks = 0
        self.ckpt_seconds: dict = {}

    def restore_or(self, params, opt_state, start_step: int = 0):
        """``(params, opt_state, start_step)`` from the latest checkpoint,
        each rank's parts cut from it and copied into the given tensors
        (the run's initial state, which it replaces, so the device holds
        one copy of the state); the given ones when there is none."""
        if self.ckpt is None:
            return params, opt_state, start_step
        step = self.ckpt.latest_step(self.layout)
        if step is None:
            return params, opt_state, start_step
        device = tree_leaves(params)[0].device
        t0 = time.perf_counter()
        (params, opt_state), extra = self.ckpt.restore(
            (params, opt_state), step=step, device=device,
            layout=self.layout, in_place=True)
        if isinstance(opt_state.get("step"), torch.Tensor):
            # restored on the parameters' device; the update reads it on
            # the host (training.optimizer)
            opt_state["step"] = opt_state["step"].cpu()
        self.ckpt_seconds["restore"] = dict(
            self.ckpt.timings, total=time.perf_counter() - t0)
        start_step = int(extra.get("step", step))
        self.restored_extra = extra
        log.info("resumed from step %d", start_step)
        return params, opt_state, start_step

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
                # The compressed attempt's wire telemetry stays: the
                # traffic that overflowed is what adaptation must see.
                telemetry = {k: v for k, v in metrics.items()
                             if k.startswith("adapt/")}
                params2, opt2, metrics = self.fallback_step_fn(
                    params, opt_state, batch)
                metrics.update(telemetry)
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
            if self.ckpt is not None and (
                    step % self.cfg.checkpoint_every == 0
                    or step == self.cfg.total_steps):
                extra = self.save_extra() if self.save_extra else {}
                extra.update(step=step, layout=self.layout.shape)
                t0 = time.perf_counter()
                self.ckpt.save(step, (params, opt_state), extra=extra,
                               layout=self.layout)
                self.ckpt_seconds["save"] = dict(
                    self.ckpt.timings, total=time.perf_counter() - t0)
        return params, opt_state
