"""internvl2-26b — VLM: InternViT (stubbed frontend) + InternLM2-20B backbone
[arXiv:2404.16821].

LM backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision encoder + projector is a STUB per the assignment carve-out:
``input_specs()`` provides precomputed patch embeddings (vision_tokens x d).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="InternVL2 [arXiv:2404.16821]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    vision_tokens=256,  # stubbed ViT patch embeddings prepended to the text
    fsdp=True,
    serve_window=4_096,
)
