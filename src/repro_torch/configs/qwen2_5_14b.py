"""Qwen2.5-14B [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5 family; hf]

40 heads do not divide the 16-way model axis: the sharding engine falls
back to head_dim/sequence sharding (DESIGN.md §5, §Perf cell candidate).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2_5_14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=13824,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    pattern_unit="D", source="hf:Qwen/Qwen2.5-14B"))
