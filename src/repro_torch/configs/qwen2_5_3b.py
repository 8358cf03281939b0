"""qwen2.5-3b — dense, GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    source="[hf:Qwen/Qwen2.5-0.5B]",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    serve_window=4_096,  # opt-in SWA variant for long_500k serving
)
