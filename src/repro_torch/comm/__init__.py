"""Compressed collectives: QLC-coded e4m3 communication over
``torch.distributed``, the weight wire, calibration and wire planning."""
from repro_torch.comm.compressed import (  # noqa: F401
    CommConfig,
    ReduceScatterResult,
    WirePayload,
    pad_to_multiple,
    wire_bytes,
)
from repro_torch.comm import transport  # noqa: F401
from repro_torch.comm import channel  # noqa: F401
from repro_torch.comm.channel import (  # noqa: F401
    Channel,
    ChannelSpec,
    measure_decode_Bps,
    measure_wire_Bps,
    open_channels,
)
from repro_torch.comm.planner import (  # noqa: F401
    LINK_CLASSES,
    ONESHOT,
    RING,
    TRANSPORT_KINDS,
    AlphaBetaModel,
    CommPlan,
    TransportConfig,
    choose_a2a_transport,
    choose_transport,
    effective_compression_ratio,
    modeled_a2a_ring_time,
    modeled_oneshot_time,
    modeled_ring_time,
    plan_for_tables,
    resolve_transport,
    transport_crossover_bytes,
)
