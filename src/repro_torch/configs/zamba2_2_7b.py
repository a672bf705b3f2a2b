"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    pos_emb="rope",
    ssm=SSMConfig(state_dim=64, conv_dim=4, n_groups=1, expand=2),
    hybrid_attn_every=6,
    sliding_window=8192,
    max_seq_len=524288,
    source="arXiv:2411.15242 (Zamba2)",
)

SMOKE = ModelConfig(
    arch_id="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    pos_emb="rope",
    ssm=SSMConfig(state_dim=16, conv_dim=4, n_groups=1, expand=2),
    hybrid_attn_every=2,
    max_seq_len=256,
    source="reduced zamba2",
)
