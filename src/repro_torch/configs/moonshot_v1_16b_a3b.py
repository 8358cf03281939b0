"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6 + shared expert
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840.
The assignment sheet labels it [dense] but specifies "MoE 64e top-6"; we
implement the MoE as specified (fine-grained experts + one shared expert,
DeepSeek-V3-style, which Moonlight follows).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="Moonlight [hf:moonshotai/Moonlight-16B-A3B]",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    experts_per_token=6,
    moe_shared_ff=1408 * 2,  # always-on shared expert
    fsdp=True,
    serve_window=4_096,
)
