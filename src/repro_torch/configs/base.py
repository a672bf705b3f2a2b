"""Model / input-shape configuration dataclasses.

Every assigned architecture gets one module in this package exporting CONFIG
(the exact published config) and SMOKE (a reduced variant of the same family:
<=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0          # routed experts
    top_k: int = 0
    n_shared: int = 0           # always-on shared experts
    d_expert: int = 0           # per-expert FFN hidden size


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64         # per-head SSM state (Mamba2 "N")
    conv_dim: int = 4           # depthwise conv width
    n_groups: int = 1
    expand: int = 2             # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # positional encoding: 'rope' | 'rope2d' (chatglm half-rotary) | 'mrope'
    # (qwen2-vl 3-axis) | 'learned' (whisper) | 'none' (xlstm)
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu (SwiGLU) | gelu
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid (zamba2): attention block shared across depth, applied every k layers
    hybrid_attn_every: int = 0
    # xlstm: pattern of block kinds per scan step
    xlstm_slstm_every: int = 0  # every k-th block is sLSTM, rest mLSTM
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500     # fixed stub-frontend sequence length
    # vlm stub frontend
    vision_stub: bool = False
    audio_stub: bool = False
    # distribution: pad query heads up to this count (0 = no padding).
    # Set by the launcher when n_heads does not divide the TP degree
    # (llama4's 40H / qwen2-vl's 28H over 16-way TP); pad heads' wo rows
    # are zero in a real deployment so outputs are unchanged.
    head_pad_to: int = 0
    # int8 KV cache (per-token-head symmetric scales) — the paper's named
    # future-work direction; beyond-paper optimization in §Perf
    kv_quant: bool = False
    # serving / long-context
    sliding_window: int = 0     # 0 = full attention; >0 enables SW variant
    max_seq_len: int = 32768
    dtype: str = "bfloat16"
    source: str = ""            # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_q_heads(self) -> int:
        """Query heads incl. TP padding (see head_pad_to)."""
        return max(self.head_pad_to, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so logits/embeddings shard
        evenly on the model axis (pad logits are masked in the loss)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.hybrid_attn_every == 0

    def n_attention_layers(self) -> int:
        """Number of layers that hold sequence-proportional KV cache."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.hybrid_attn_every:
            return self.n_layers // self.hybrid_attn_every
        return self.n_layers

    def kv_bytes_per_token(self, f_precision: int = 2) -> int:
        """Per-token KV footprint across all attention layers (paper Eq. 4 term)."""
        hd = self.resolved_head_dim
        return 2 * self.n_attention_layers() * self.n_kv_heads * hd * f_precision

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "moe" and self.moe.n_experts:
            routed = 3 * d * self.moe.d_expert * self.moe.n_experts
            shared = 3 * d * self.moe.d_expert * self.moe.n_shared
            ffn = routed + shared + d * self.moe.n_experts  # router
        elif self.family == "ssm":
            d_in = self.ssm.expand * d
            ffn = 0
            attn = 2 * d * d_in + d_in * d  # rough ssm block proj count
        else:
            mult = 3 if self.act == "silu" else 2
            ffn = mult * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = per_layer * self.n_layers + emb
        if self.is_encoder_decoder:
            total += per_layer * self.n_encoder_layers
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.family != "moe" or not self.moe.n_experts:
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        ffn = 3 * d * self.moe.d_expert * (self.moe.n_shared + self.moe.top_k) \
            + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        return per_layer * self.n_layers + self.vocab_size * d * 2


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "whisper-base",
    "chatglm3-6b",
    "qwen2.5-3b",
    "qwen2-vl-7b",
    "deepseek-moe-16b",
    "codeqwen1.5-7b",
    "llama4-scout-17b-a16e",
    "zamba2-2.7b",
    "granite-3-2b",
    "xlstm-1.3b",
]


def _module_for(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    return _module_for(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module_for(arch_id).SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
