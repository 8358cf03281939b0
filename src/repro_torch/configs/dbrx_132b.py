"""dbrx-132b — MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="[hf:databricks/dbrx-base]",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    fsdp=True,  # 132B params: shard weights over data axis too (ZeRO-3)
    serve_window=4_096,
)
