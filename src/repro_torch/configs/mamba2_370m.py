"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="SSD / Mamba-2 [arXiv:2405.21060]",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
