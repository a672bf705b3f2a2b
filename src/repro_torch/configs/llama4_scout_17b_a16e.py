"""llama4-scout-17b-a16e [moe]: 16 routed experts top-1 + shared expert, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (kv=8) d_ff=8192
vocab=202048.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    pos_emb="rope",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, d_expert=8192),
    sliding_window=8192,
    max_seq_len=524288,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    arch_id="llama4-scout-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pos_emb="rope",
    moe=MoEConfig(n_experts=4, top_k=1, n_shared=1, d_expert=128),
    max_seq_len=256,
    source="reduced llama4-scout",
)
