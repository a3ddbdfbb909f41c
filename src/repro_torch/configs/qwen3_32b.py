"""Qwen3-32B [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3_32b", family="dense", num_layers=64, d_model=5120,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=25600,
    vocab_size=151936, qk_norm=True, rope_theta=1e6,
    pattern_unit="D", source="hf:Qwen/Qwen3-32B"))
