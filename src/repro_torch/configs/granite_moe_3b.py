"""Granite-MoE-3B-A800M [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512, 40 experts top-8, vocab=49155.  [hf:ibm-granite; hf]

40 experts do not divide the 16-way model axis: expert weights fall back
to TP over the expert FFN dim ("expert_mlp") — the cost-model-guided
EP-vs-TP decision of DESIGN.md §3.2.
"""
from .base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="granite_moe_3b", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, head_dim=64, d_ff=512,
    vocab_size=49155, tie_embeddings=True, rope_theta=1e4,
    pattern_unit="E",
    moe=MoECfg(num_experts=40, top_k=8, d_ff=512, shared_d_ff=0,
               capacity_factor=1.25, group_size=1024),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base"))
