"""Flash attention forward (kernel G), as ``repro/kernels/flash_attn``:
``flash_attn`` holds the kernel's wrapper ``flash_attention`` (CUDA
tensors only; it re-exports the oracle as ``flash_attention_plain``),
``ref`` the oracle ``flash_attention_ref`` and ``ops`` the dispatcher the
layers call."""
from . import flash_attn  # noqa: F401
from .flash_attn import flash_attention, flash_attention_plain  # noqa: F401
