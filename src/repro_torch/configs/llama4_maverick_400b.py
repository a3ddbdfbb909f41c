"""Llama-4-Maverick-400B-A17B [moe]: 48L d_model=5120 40H (GQA kv=8)
MoE d_ff=8192, 128 experts top-1, shared expert; vocab=202048; MoE on
every other layer (pattern DE), dense layers d_ff=16384 — early fusion.
[hf:meta-llama/Llama-4-*; unverified]

Totals ~400B params / ~17B active (see ModelConfig.param_count).
"""
from .base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="llama4_maverick_400b", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=202048, rope_theta=5e5,
    pattern_unit="DE",
    moe=MoECfg(num_experts=128, top_k=1, d_ff=8192, shared_d_ff=8192,
               capacity_factor=1.25, group_size=1024),
    train_accum=8,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled)"))
