"""starcoder2-3b — dense, GQA + RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="StarCoder2 [arXiv:2402.19173]",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    qkv_bias=True,
    rope_theta=999_999.4,
    act="gelu",
    serve_window=4_096,
)
