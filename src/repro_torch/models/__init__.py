from .model import RunCtx, forward, init_params

__all__ = ["RunCtx", "forward", "init_params"]
