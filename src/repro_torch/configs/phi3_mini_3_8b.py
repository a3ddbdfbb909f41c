"""Phi-3-mini-3.8B [dense]: 32L d_model=3072 32H (kv=32, i.e. MHA)
d_ff=8192 vocab=32064 — RoPE SwiGLU.  [arXiv:2404.14219; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3_mini_3_8b", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, head_dim=96, d_ff=8192,
    vocab_size=32064, rope_theta=1e4,
    pattern_unit="D", source="arXiv:2404.14219"))
