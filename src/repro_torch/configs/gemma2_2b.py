"""gemma2-2b — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    source="Gemma 2 [arXiv:2408.00118]",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4_096,
    local_global_pattern=2,  # every 2nd layer is global
    act="gelu",
    tie_embeddings=True,
)
