"""llama2-7b: the paper's own primary evaluation model (Fig. 1, 4, 8).

[arXiv:2307.09288] 32L d_model=4096 32H (kv=32, MHA) d_ff=11008 vocab=32000.
Not part of the assigned pool; used by the paper-figure benchmarks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    pos_emb="rope",
    sliding_window=0,
    max_seq_len=16384,
    source="arXiv:2307.09288 (Llama 2)",
)

SMOKE = ModelConfig(
    arch_id="llama2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    pos_emb="rope",
    max_seq_len=256,
    source="reduced llama2",
)
