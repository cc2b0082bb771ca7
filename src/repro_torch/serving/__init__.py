"""Serving: continuous-batching engine, the compressed weight wire and
the compressed paged KV cache."""
from repro_torch.comm.blockpool import (  # noqa: F401
    ArenaExhausted, ArenaStale, BlockArena, BlockPool, PoolExhausted)
from repro_torch.serving.engine import (  # noqa: F401
    ServeConfig, codec_from_manifest, compress_params_for_serving,
    open_params, place_wire, prefill, serving_manifest, window_step)
from repro_torch.serving.kv_cache import (  # noqa: F401
    BlockPrefetcher, DeviceBlock, KVBlock, KVCacheOverflowError,
    KVCacheSpec, LayerFramePlan, PagedKVCache, SSMBoundaryTracker,
    all_gather_block_wire, calibrate_cache, kv_cache_manifest,
    kv_spec_from_manifest, open_kv_channels)
from repro_torch.serving.scheduler import (  # noqa: F401
    Engine, GenerationRequest, RequestStatus)
