"""whisper-base — encoder-decoder, conv/mel frontend STUBBED
[arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.
``input_specs()`` provides precomputed frame embeddings (encoder_seq x d)
per the assignment carve-out — the mel-spectrogram + conv feature extractor
is not implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    source="Whisper [arXiv:2212.04356]",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    encoder_layers=6,
    encoder_seq=1500,  # 30 s of audio after the (stubbed) conv frontend
    act="gelu",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
)
