"""Shared neural-net building blocks — the port of `repro.models.layers`
(the attention families: decoder, vlm and encoder-decoder).

Conventions (as in the reference):
  * params are nested dicts of tensors; layer-stacked params carry a
    leading (L, ...) axis, and matrices keep JAX's (in, out) layout so
    every projection is `x @ w` and weights cross from JAX as a copy;
  * activations run in the config dtype (bf16 at scale, f32 in smoke
    tests); norms and softmax accumulate in f32;
  * initialisers draw from an explicit `torch.Generator` with the
    reference's scales (the numbers differ from `jax.random`'s; tests
    hand weights over with `repro_torch.weights`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.act_sharding import replaceable


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim, out_dim, dtype, device):
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    return (torch.randn(in_dim, out_dim, generator=gen, device=device)
            * scale).to(dtype)


def embed_init(gen, vocab, dim, dtype, device):
    return (torch.randn(vocab, dim, generator=gen, device=device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

@replaceable
def rmsnorm(x, w, eps=1e-6):
    return ops.rmsnorm(x, w, eps)


@replaceable
def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def init_norm(cfg: ModelConfig, dim, dtype, device):
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones(dim, dtype=dtype, device=device)}
    return {"w": torch.ones(dim, dtype=dtype, device=device),
            "b": torch.zeros(dim, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary position embeddings (rope / rope2d / mrope)
# ---------------------------------------------------------------------------

def _rope_freqs(dim, theta, device):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x, cos, sin):
    """x: (..., D_rot) rotated as complex pairs (first half, second half)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(cfg: ModelConfig, x, positions):
    """x: (B, S, N, D); positions: (B, S) int for 'rope'/'rope2d',
    (3, B, S) for 'mrope'. Returns same shape/dtype as x."""
    D = x.shape[-1]
    if cfg.pos_emb in ("none", "learned", "sinusoid"):
        return x
    if cfg.pos_emb == "rope":
        freqs = _rope_freqs(D, cfg.rope_theta, x.device)      # (D/2,)
        ang = positions[..., None].float() * freqs            # (B,S,D/2)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        return _rotate(x.float(), cos, sin).to(x.dtype)
    if cfg.pos_emb == "rope2d":
        # ChatGLM half-rotary: rotate first half of head_dim, pass the rest.
        Dr = D // 2
        freqs = _rope_freqs(Dr, cfg.rope_theta, x.device)
        ang = positions[..., None].float() * freqs
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        xr, xp = x[..., :Dr], x[..., Dr:]
        xr = _rotate(xr.float(), cos, sin).to(x.dtype)
        return torch.cat([xr, xp], dim=-1)
    if cfg.pos_emb == "mrope":
        # Qwen2-VL multimodal rope: head_dim/2 freq slots split into three
        # sections (t, h, w) = (1/4, 3/8, 3/8), each driven by its own
        # position id stream. positions: (3, B, S).
        half = D // 2
        st = half // 4
        sh = (half - st) // 2
        sections = [st, sh, half - st - sh]
        freqs = _rope_freqs(D, cfg.rope_theta, x.device)      # (half,)
        parts, off = [], 0
        for i, sec in enumerate(sections):
            parts.append(positions[i][..., None].float()
                         * freqs[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)                        # (B,S,half)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        return _rotate(x.float(), cos, sin).to(x.dtype)
    raise ValueError(cfg.pos_emb)


def sinusoid_pos_emb(positions, dim):
    """positions: (B, S) -> (B, S, dim) float32 sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H = cfg.n_q_heads  # incl. TP padding; pad wo rows are zero
    p = {
        "wq": dense_init(gen, d, H * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, H * hd, d, dtype, device),
    }
    if cfg.head_pad_to > cfg.n_heads:
        # zero the padded heads' output rows so they cannot affect results
        p["wo"][cfg.n_heads * hd:] = 0
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, dtype=dtype, device=device)
    return p


@replaceable
def split_heads(t, n_heads: int):
    """A flat projection (..., n_heads * hd) viewed as (..., n_heads,
    hd)."""
    return t.reshape(*t.shape[:-1], n_heads, t.shape[-1] // n_heads)


@replaceable
def attention(q, k, v, **kwargs):
    """The flash attention (`ops.flash_attention`)."""
    return ops.flash_attention(q, k, v, **kwargs)


def qkv_proj(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_heads(q, cfg.n_q_heads), split_heads(k, cfg.n_kv_heads),
            split_heads(v, cfg.n_kv_heads))


def attn_out(cfg: ModelConfig, p, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


def self_attention(cfg: ModelConfig, p, x, positions, *, causal=True,
                   window=0, kv_len=None):
    """Full self-attention over x (prefill). Returns (out, (k, v))."""
    q, k, v = qkv_proj(cfg, p, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    o = attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    return attn_out(cfg, p, o), (k, v)


def cross_attention(cfg: ModelConfig, p, x, k, v, enc_len=None):
    """Decoder queries x (B, S, d) over encoder keys / values k, v
    (B, T, KV, hd) (`cross_kv`), non-causal; enc_len (B,) masks keys past
    it."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = split_heads(q, cfg.n_q_heads)
    o = attention(q, k, v, causal=False, kv_len=enc_len)
    return attn_out(cfg, p, o)


def cross_kv(cfg: ModelConfig, p, enc_out):
    """Encoder output (B, T, d) -> the cross-attention's k, v
    (B, T, KV, hd)."""
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return split_heads(k, cfg.n_kv_heads), split_heads(v, cfg.n_kv_heads)


def decode_self_attention(cfg: ModelConfig, p, x, positions):
    """One-token decode projections: x (B, 1, d) -> roped q, k and v; the
    caller owns cache insertion (dense, ring-buffer or paged) and the
    attention call."""
    q, k, v = qkv_proj(cfg, p, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, dtype, device, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"wg": dense_init(gen, d, f, dtype, device),
                "wu": dense_init(gen, d, f, dtype, device),
                "wd": dense_init(gen, f, d, dtype, device)}
    return {"w1": dense_init(gen, d, f, dtype, device),
            "b1": torch.zeros(f, dtype=dtype, device=device),
            "w2": dense_init(gen, f, d, dtype, device),
            "b2": torch.zeros(d, dtype=dtype, device=device)}


def mlp(cfg: ModelConfig, p, x):
    if cfg.act == "silu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] \
        + p["b2"]
