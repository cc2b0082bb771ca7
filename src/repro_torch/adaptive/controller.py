"""The adaptation loop: wrap channels, watch traffic, hot-swap codecs.

:class:`AdaptiveController` wires the three stages together:

    monitor (histograms)  ->  policy (drift?)  ->  recalibrator
                                                       |
    AdaptiveChannel.rebind(new entry)  <--  registry.register_revision

:class:`AdaptiveChannel` is the rebind seam for consumers that encode
per call (the paged KV cache): it forwards every attribute to an
immutable ``Channel`` and swaps that reference in one assignment, so
work in flight keeps the old channel and new calls see the new codec.
The compressed train step holds its channels from when it was built, so
it is rebuilt after a swap instead: :class:`TrainingAdapter` packages
that as a ``Trainer.on_step`` hook.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.adaptive.drift import DriftConfig, DriftPolicy
from repro_torch.adaptive.monitor import TrafficMonitor
from repro_torch.adaptive.recalibrate import Recalibrator


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One completed hot-swap."""
    name: str
    old_scheme_id: int
    new_scheme_id: int
    measured_bits: float        # traffic cost under the OLD codec
    old_expected_bits: float    # what the old plan promised
    new_expected_bits: float    # what the new plan promises


class AdaptiveChannel:
    """Attribute-forwarding proxy over a ``Channel`` with an atomic
    rebind: ``rebind(entry)`` swaps the underlying channel to a new codec
    entry in one reference assignment; callers that captured the
    previous channel (or its tables) keep a consistent old view."""

    __slots__ = ("_chan",)

    def __init__(self, channel):
        object.__setattr__(self, "_chan", channel)

    @property
    def channel(self):
        """The current underlying ``Channel``."""
        return self._chan

    def rebind(self, entry):
        """Rebind to ``entry`` (a ``CodecEntry``)."""
        object.__setattr__(self, "_chan", self._chan.replace(codec=entry))

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_chan"), name)

    def __repr__(self):
        return f"AdaptiveChannel({self._chan!r})"


class AdaptiveController:
    """Owns the monitor, policy and recalibrator and the rebind fan-out.

    Usage::

        ctl = AdaptiveController(registry)
        ch = ctl.wrap(Channel(ChannelSpec(codec="kv/k"), registry=reg))
        payload, scales, hist = ch.compress(x, with_hist=True)
        ctl.observe("kv/k", hist.cpu())
        events = ctl.check()          # [] or the swaps just made

    ``check`` runs the drift policy per observed name; a flagged name is
    recalibrated on its accumulated histogram, registered under a new
    scheme-id, and every wrapped channel bound to it is rebound. Old
    entries stay in the registry.
    """

    def __init__(self, registry, *,
                 monitor: Optional[TrafficMonitor] = None,
                 policy: Optional[DriftPolicy] = None,
                 recalibrator: Optional[Recalibrator] = None,
                 drift: Optional[DriftConfig] = None):
        self.registry = registry
        self.monitor = monitor or TrafficMonitor(registry)
        self.policy = policy or DriftPolicy(self.monitor,
                                            drift or DriftConfig())
        self.recalibrator = recalibrator or Recalibrator(registry)
        self._channels: Dict[str, List[AdaptiveChannel]] = {}
        self.events: List[SwapEvent] = []
        #: name -> whether the policy flagged it on the last check.
        self.flags: Dict[str, bool] = {}

    def wrap(self, channel, name: Optional[str] = None) -> AdaptiveChannel:
        """Wrap ``channel`` for rebinding, tracked under its entry's name
        (or ``name``, the registry key swaps target)."""
        if name is None:
            if channel.entry is None:
                raise ValueError("channel has no registry entry; pass "
                                 "wrap(channel, name=...)")
            name = channel.entry.name
        ach = channel if isinstance(channel, AdaptiveChannel) \
            else AdaptiveChannel(channel)
        self._channels.setdefault(name, []).append(ach)
        return ach

    def observe(self, name: str, hist, **kw):
        """Forward one encode pass's histogram to the monitor."""
        return self.monitor.observe(name, hist, **kw)

    def check(self, names=None) -> List[SwapEvent]:
        """Run drift detection (and swap) over ``names`` (default: every
        name with traffic). Returns the swaps made by this call."""
        if names is None:
            names = self.monitor.names()
        swapped: List[SwapEvent] = []
        for name in names:
            self.flags[name] = self.policy.update(name)
            if self.flags[name]:
                swapped.extend(self._swap(name))
        return swapped

    def _swap(self, name: str) -> List[SwapEvent]:
        old = self.registry[name]
        t = self.monitor.traffic(name)
        counts = np.asarray(t.counts, np.float64)
        new = self.recalibrator.recalibrate(name, counts)
        if new.scheme_id == old.scheme_id:
            # Recalibration landed on the deployed codec: the plan
            # misjudged, the codec did not. Reset the policy so the same
            # ledger cannot re-flag at once.
            self.policy.notify_swapped(name)
            return []
        for ach in self._channels.get(name, []):
            ach.rebind(new)
        ev = SwapEvent(
            name=name,
            old_scheme_id=old.scheme_id,
            new_scheme_id=new.scheme_id,
            measured_bits=t.measured_bits_per_symbol(old.tables.enc_len),
            old_expected_bits=old.plan.expected_bits_per_symbol,
            new_expected_bits=new.plan.expected_bits_per_symbol)
        self.events.append(ev)
        self.monitor.reset(name, old.scheme_id)
        self.policy.notify_swapped(name)
        return [ev]


def _to_host(metrics: dict, keys) -> Dict[str, np.ndarray]:
    """The values of ``keys`` present in ``metrics`` as numpy arrays, with
    one device-to-host read for all the tensors among them."""
    present = [k for k in keys if k in metrics]
    tensors = [k for k in present if isinstance(metrics[k], torch.Tensor)]
    out = {k: np.asarray(metrics[k]) for k in present if k not in tensors}
    if tensors:
        flat = torch.cat([metrics[k].reshape(-1) for k in tensors]).cpu()
        off = 0
        for k in tensors:
            n = metrics[k].numel()
            out[k] = flat[off:off + n].reshape(metrics[k].shape).numpy()
            off += n
    return out


class TrainingAdapter:
    """``Trainer.on_step`` hook: feed the step's histograms to the
    controller and rebuild the step after a swap.

    The compressed train step holds its channels, so a rebind cannot
    reach into it: the adapter calls ``build_step()`` (a closure that
    re-runs ``make_compressed_step`` against the revised registry) and
    returns the new step for the trainer to install.

    ``make_compressed_step(..., telemetry=True)`` puts the gradient and
    parameter wires' histograms, summed over the group, in the metrics
    under ``"adapt/grads_hist"`` / ``"adapt/params_hist"``, and whether
    either wire's escape pool overflowed on some rank under
    ``"adapt/grads_overflow"`` / ``"adapt/params_overflow"``. Where an
    overflow key is present, the observation counts one container and
    whether it overflowed, so the policy's overflow trigger sees it.

    ``checks`` records each check: per name its scheme-id, measured and
    planned bits/symbol before the check, and whether it was flagged;
    ``swaps`` each check that swapped: its events, the seconds of the
    check (recalibration included) and of the step's rebuild.
    """

    GRADS_HIST = "adapt/grads_hist"
    PARAMS_HIST = "adapt/params_hist"
    GRADS_OVERFLOW = "adapt/grads_overflow"
    PARAMS_OVERFLOW = "adapt/params_overflow"

    def __init__(self, controller: AdaptiveController,
                 build_step: Callable[[], Callable], *,
                 grad_key: str = "grads", param_key: Optional[str] = None,
                 check_every: int = 10,
                 on_swap: Optional[Callable[[SwapEvent], None]] = None):
        self.controller = controller
        self.build_step = build_step
        self.grad_key = grad_key
        self.param_key = param_key
        self.check_every = max(1, int(check_every))
        self.on_swap = on_swap
        self.checks: List[dict] = []
        self.swaps: List[dict] = []

    def _observe(self, name, host, hist_key, overflow_key):
        if hist_key not in host:
            return
        kw = {}
        if overflow_key in host:
            kw = dict(overflow=bool(host[overflow_key]), containers=1.0)
        self.controller.observe(name, host[hist_key], **kw)

    def __call__(self, step: int, metrics: dict) -> Optional[Callable]:
        host = _to_host(metrics, (self.GRADS_HIST, self.PARAMS_HIST,
                                  self.GRADS_OVERFLOW,
                                  self.PARAMS_OVERFLOW))
        self._observe(self.grad_key, host, self.GRADS_HIST,
                      self.GRADS_OVERFLOW)
        if self.param_key is not None:
            self._observe(self.param_key, host, self.PARAMS_HIST,
                          self.PARAMS_OVERFLOW)
        if (step + 1) % self.check_every:
            return None
        c = self.controller
        names = [n for n in (self.grad_key, self.param_key)
                 if n is not None and n in c.registry]
        before = {n: (c.registry[n].scheme_id, c.monitor.measured_bits(n),
                      c.registry[n].plan.expected_bits_per_symbol)
                  for n in names}
        t0 = time.perf_counter()
        events = c.check()
        check_s = time.perf_counter() - t0
        for n, (sid, measured, planned) in before.items():
            self.checks.append({"step": step, "name": n, "scheme_id": sid,
                                "measured_bits": measured,
                                "planned_bits": planned,
                                "flagged": c.flags.get(n, False)})
        if not events:
            return None
        if self.on_swap is not None:
            for ev in events:
                self.on_swap(ev)
        t0 = time.perf_counter()
        step_fn = self.build_step()
        self.swaps.append({"step": step, "events": events,
                           "check_s": check_s,
                           "rebuild_s": time.perf_counter() - t0})
        return step_fn
