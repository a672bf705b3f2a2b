"""codeqwen1.5-7b [dense]: qwen1.5 arch, MHA (kv=32), QKV bias.

[hf:Qwen/CodeQwen1.5-7B] 32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    pos_emb="rope",
    rope_theta=1000000.0,
    qkv_bias=True,
    sliding_window=8192,
    max_seq_len=524288,
    source="hf:Qwen/CodeQwen1.5-7B",
)

SMOKE = ModelConfig(
    arch_id="codeqwen1.5-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    pos_emb="rope",
    qkv_bias=True,
    max_seq_len=256,
    source="reduced codeqwen1.5",
)
