"""granite-3-2b [dense]: GQA kv=8.

[hf:ibm-granite/granite-3.0-2b-base] 40L d_model=2048 32H (kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    pos_emb="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    sliding_window=8192,
    max_seq_len=524288,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = ModelConfig(
    arch_id="granite-3-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    pos_emb="rope",
    tie_embeddings=True,
    max_seq_len=256,
    source="reduced granite-3",
)
