"""Chameleon-34B [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early fusion, VQ image tokens (stub frontend supplies
precomputed token ids; image tokens share the text vocab).
[arXiv:2405.09818; unverified]
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon_34b", family="vlm", num_layers=48, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
    vocab_size=65536, qk_norm=True, rope_theta=1e4,
    pattern_unit="D", frontend="vq_image",
    source="arXiv:2405.09818"))
