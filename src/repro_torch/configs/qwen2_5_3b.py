"""qwen2.5-3b [dense]: GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B family] 36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    pos_emb="rope",
    rope_theta=1000000.0,
    qkv_bias=True,
    sliding_window=8192,
    max_seq_len=524288,
    source="hf:Qwen/Qwen2.5-0.5B (scaled per assignment)",
)

SMOKE = ModelConfig(
    arch_id="qwen2.5-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    pos_emb="rope",
    qkv_bias=True,
    max_seq_len=256,
    source="reduced qwen2.5",
)
