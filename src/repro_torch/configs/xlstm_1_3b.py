"""xlstm-1.3b [ssm]: alternating mLSTM / sLSTM blocks, attention-free.

[arXiv:2405.04517] 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.
LayerKV is inapplicable (no attention KV); see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pos_emb="none",
    ssm=SSMConfig(state_dim=512, conv_dim=4, n_groups=1, expand=2),
    xlstm_slstm_every=8,  # 6 superblocks of (7 mLSTM + 1 sLSTM) ~ xLSTM[7:1]
    max_seq_len=524288,
    source="arXiv:2405.04517 (xLSTM)",
)

SMOKE = ModelConfig(
    arch_id="xlstm-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    pos_emb="none",
    ssm=SSMConfig(state_dim=64, conv_dim=4, n_groups=1, expand=2),
    xlstm_slstm_every=2,
    max_seq_len=256,
    source="reduced xlstm",
)
