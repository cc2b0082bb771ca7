"""Serving: continuous-batching engine and the compressed weight wire."""
from repro_torch.serving.engine import (  # noqa: F401
    ServeConfig, compress_params_for_serving, open_params, prefill)
from repro_torch.serving.scheduler import (  # noqa: F401
    Engine, GenerationRequest, RequestStatus)
