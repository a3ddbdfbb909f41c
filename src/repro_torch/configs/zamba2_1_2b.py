"""Zamba2-1.2B [hybrid]: 38L d_model=2048, Mamba2 backbone with shared
attention blocks (32H kv=32, block MLP d_ff=8192), ssm_state=64,
vocab=32000.  [arXiv:2411.15242; hf]

Pattern: 6 x (5 Mamba2 + 1 attention) + 2 Mamba2 tail = 38 layers.
Sub-quadratic: runs long_500k.
"""
from .base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="zamba2_1_2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
    vocab_size=32000, tie_embeddings=True, rope_theta=1e4,
    pattern_unit="MMMMMA", tail="MM", sub_quadratic=True,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    source="arXiv:2411.15242"))
