from .engine import InferenceEngine, InferenceResult, ServingConfig
from .server import make_server, serve_forever
from .streaming import (
    StreamingConfig,
    StreamingHub,
    StreamingResult,
    StreamingSession,
    measure_finalization_flips,
)

__all__ = [
    "InferenceEngine",
    "InferenceResult",
    "ServingConfig",
    "StreamingConfig",
    "StreamingHub",
    "StreamingResult",
    "StreamingSession",
    "make_server",
    "measure_finalization_flips",
    "serve_forever",
]
