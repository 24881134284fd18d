from .model import (RunCtx, decode_step, forward, init_cache, init_params,
                    prefill)

__all__ = ["RunCtx", "decode_step", "forward", "init_cache", "init_params",
           "prefill"]
