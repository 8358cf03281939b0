"""zamba2-7b — hf ``Zyphra/Zamba2-7B-Instruct`` as released: the port's own
release-layout hybrid [arXiv:2411.15242], which the reference's registry
does not have.

81 Mamba-2 layers at d_model=3584 (112 heads of 64 in 2 groups, state 64,
conv 4, chunk 256); 13 of them first apply one of 2 weight-tied blocks in
turn: attention over concat(hidden, embeddings) (7168 wide, 32 MHA heads of
224, RoPE over all 224 at theta 1e4, scale (224 / 2)^-1/2) and a gated MLP
of 14336 with the exact GELU, a rank-128 LoRA on its gate and up
projections per application, then a (d, d) linear per layer whose output
joins that layer's Mamba input. vocab=32000, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="Zamba2 [arXiv:2411.15242]; hf Zyphra/Zamba2-7B-Instruct config.json",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=224,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=2,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    norm_eps=1e-5,
    tie_embeddings=True,
    act="gelu_erf",
)
