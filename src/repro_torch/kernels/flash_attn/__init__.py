"""Flash attention forward (kernel G): ``flash_attn`` holds the wrapper
``flash_attention`` and its plain version ``flash_attention_plain``, as
``repro/kernels/flash_attn`` holds the Pallas kernel and its oracle."""
from . import flash_attn  # noqa: F401
from .flash_attn import flash_attention, flash_attention_plain  # noqa: F401
