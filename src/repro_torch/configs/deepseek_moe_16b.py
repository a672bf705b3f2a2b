"""deepseek-moe-16b [moe]: fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066] 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    pos_emb="rope",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    sliding_window=8192,
    max_seq_len=524288,
    source="arXiv:2401.06066 (DeepSeekMoE)",
)

SMOKE = ModelConfig(
    arch_id="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    pos_emb="rope",
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=64),
    max_seq_len=256,
    source="reduced deepseek-moe",
)
