"""whisper-base [audio]: enc-dec transformer backbone, conv/mel frontend stubbed.

[arXiv:2212.04356] 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    pos_emb="sinusoid",  # whisper: sinusoid enc / learned dec; we use sinusoid
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_len=1500,
    audio_stub=True,
    tie_embeddings=True,
    sliding_window=8192,
    max_seq_len=524288,
    source="arXiv:2212.04356 (Whisper)",
)

SMOKE = ModelConfig(
    arch_id="whisper-base-smoke",
    family="encdec",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    pos_emb="sinusoid",
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_len=32,
    audio_stub=True,
    tie_embeddings=True,
    max_seq_len=256,
    source="reduced whisper-base",
)
