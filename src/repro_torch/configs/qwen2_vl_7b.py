"""qwen2-vl-7b [vlm]: M-RoPE (3-axis), dynamic-resolution ViT frontend stubbed.

[arXiv:2409.12191] 28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    pos_emb="mrope",
    rope_theta=1000000.0,
    qkv_bias=True,
    vision_stub=True,
    sliding_window=8192,
    max_seq_len=524288,
    source="arXiv:2409.12191 (Qwen2-VL)",
)

SMOKE = ModelConfig(
    arch_id="qwen2-vl-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    pos_emb="mrope",
    qkv_bias=True,
    vision_stub=True,
    max_seq_len=256,
    source="reduced qwen2-vl",
)
