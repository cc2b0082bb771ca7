"""Quad Length Codes: schemes, LUTs, registry and the pure-torch codec."""
from repro_torch.core.schemes import (  # noqa: F401
    NUM_SYMBOLS,
    PAPER_SCHEMES,
    QLCScheme,
    TABLE1,
    TABLE2,
)
from repro_torch.core.lut import CodecTables, build_tables, identity_tables  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    CodecEntry,
    CodecRegistry,
    registry_of,
)
from repro_torch.core.adapt import (  # noqa: F401
    AdaptResult,
    calibrate_tables,
    default_scheme_for,
    select_scheme,
)
