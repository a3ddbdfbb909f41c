from .engine import (ServeEngine, make_decode_step,  # noqa: F401
                     make_prefill_step)
