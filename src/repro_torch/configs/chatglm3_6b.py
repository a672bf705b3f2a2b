"""chatglm3-6b [dense]: RoPE-2d (half-rotary), GQA kv=2.

[arXiv:2406.12793] 28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    pos_emb="rope2d",
    qkv_bias=True,   # chatglm uses bias on QKV only
    sliding_window=8192,
    max_seq_len=524288,
    source="arXiv:2406.12793 (ChatGLM)",
)

SMOKE = ModelConfig(
    arch_id="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    pos_emb="rope2d",
    qkv_bias=True,
    max_seq_len=256,
    source="reduced chatglm3",
)
