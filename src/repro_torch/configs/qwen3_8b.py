"""Qwen3-8B [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3_8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288,
    vocab_size=151936, qk_norm=True, rope_theta=1e6,
    pattern_unit="D", source="hf:Qwen/Qwen3-8B"))
