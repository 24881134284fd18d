from .engine import BlockwiseExecutor, flatten_layers
from .server import CoInferenceServer, Request, ServeReport, run_partitioned

__all__ = ["BlockwiseExecutor", "flatten_layers", "CoInferenceServer",
           "Request", "ServeReport", "run_partitioned"]
