"""Whisper-large-v3 [audio]: enc-dec, 32 encoder + 32 decoder layers,
d_model=1280 20H (kv=20) d_ff=5120 vocab=51866 — conv frontend is a STUB
(input_specs supplies precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]

Backbone-only spec: we use the shared RoPE/RMSNorm decoder substrate
(adaptation noted in DESIGN.md §4).  20 heads do not divide the model
axis -> head_dim/seq fallback sharding.
"""
from .base import ModelConfig, EncoderCfg, register

CONFIG = register(ModelConfig(
    name="whisper_large_v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120,
    vocab_size=51866, rope_theta=1e4,
    pattern_unit="D", frontend="audio",
    encoder=EncoderCfg(num_layers=32, num_frames=1500),
    source="arXiv:2212.04356"))
