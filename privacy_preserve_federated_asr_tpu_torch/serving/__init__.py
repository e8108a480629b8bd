from .engine import InferenceEngine, InferenceResult, ServingConfig
from .server import make_server, serve_forever

__all__ = ["InferenceEngine", "InferenceResult", "ServingConfig",
           "make_server", "serve_forever"]
