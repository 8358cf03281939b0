"""zamba2-1.2b — hybrid: Mamba2 backbone + shared (weight-tied) attention
blocks [arXiv:2411.15242].

38L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=32000, ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="Zamba2 [arXiv:2411.15242]",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    shared_attn_every=6,  # a weight-tied attn+MLP block every 6 layers
    tie_embeddings=True,
)
