"""Mamba2-2.7B [ssm]: 64L d_model=2560 (attention-free), ssm_state=128,
vocab=50280 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Sub-quadratic: runs long_500k (state is O(1) in sequence length).
"""
from .base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="mamba2_2_7b", family="ssm", num_layers=64, d_model=2560,
    num_heads=1, num_kv_heads=1, head_dim=64, d_ff=0,
    vocab_size=50280, tie_embeddings=True,
    pattern_unit="M", sub_quadratic=True,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    source="arXiv:2405.21060"))
