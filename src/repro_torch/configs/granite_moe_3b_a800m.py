"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,  # fine-grained expert width
    vocab_size=49_155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
)
