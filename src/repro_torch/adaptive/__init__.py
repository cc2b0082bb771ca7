"""Online codec adaptation: telemetry -> drift detection -> hot-swap.

Calibration is one-shot: a codec frozen at startup loses bits/symbol as
training reshapes the e4m3 distribution. This package closes the loop,
as the reference package's ``adaptive`` does, on the same numbers:

1. **Telemetry** (:class:`TrafficMonitor`): the 256-bin symbol histogram
   that K1 counts beside its encode (``emit_hist``; the ``Channel``
   collectives' ``with_hist=``), filed per ``(name, scheme_id)`` with the
   measured bits/symbol and the escape-pool pressure.
2. **Drift detection** (:class:`DriftPolicy`): a binding is flagged when
   its EMA'd measured bits/symbol exceeds the plan's
   ``expected_bits_per_symbol`` by more than the plan's own
   ``drift_margin_bits`` (or the escape or overflow rate spikes), with
   hysteresis and a cooldown.
3. **Recalibration and hot-swap** (:class:`Recalibrator`,
   :class:`AdaptiveController`): off the hot path, the codec is rebuilt
   from the accumulated histogram, registered under a new scheme-id
   (``CodecRegistry.register_revision``) and the affected channels are
   rebound. Old entries are kept, so payloads written under an old
   scheme-id keep decoding.

numpy only, like the reference's; the histograms come off the card in
one read per observation.
"""
from repro_torch.adaptive.monitor import ChannelTraffic, TrafficMonitor
from repro_torch.adaptive.drift import DriftConfig, DriftPolicy
from repro_torch.adaptive.recalibrate import Recalibrator
from repro_torch.adaptive.controller import (AdaptiveChannel,
                                             AdaptiveController, SwapEvent,
                                             TrainingAdapter)

__all__ = [
    "ChannelTraffic", "TrafficMonitor",
    "DriftConfig", "DriftPolicy",
    "Recalibrator",
    "AdaptiveChannel", "AdaptiveController", "SwapEvent",
    "TrainingAdapter",
]
