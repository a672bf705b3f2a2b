"""Mixture-of-experts FFN — the port of `repro.models.moe` for serving:
shared experts plus routed top-k (deepseek-moe-16b: 64 experts top-6 + 2
shared; llama4-scout: 16 top-1 + 1 shared).

The reference dispatches through a capacity buffer of `(E, C, d)` rows;
with `dropless=True` (the serving path) C = T*K, so no token is ever
dropped and each routed expert sees exactly the tokens that picked it.
`moe_ffn` computes that same function without building the buffer: the
T*K (token, expert) assignments are grouped by expert and each expert
runs one `torch.matmul` chain over its own rows. At full width the
buffer would be (64, 6T, 2048) and cost 64x the useful expert FLOPs.
Grouping needs the per-expert counts on the host (one device sync per
layer). The routed outputs are combined in the reference's order
(`for kk in range(K)`, `moe.py:105-112`) so f32 results match it to
matmul rounding.

The capacity-factor path (`dropless=False`, training) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


def _stacked_init(gen, n, in_dim, out_dim, dtype, device):
    """n (in, out) matrices at `dense_init`'s scale, stacked (n, in, out)."""
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    return (torch.randn(n, in_dim, out_dim, generator=gen, device=device)
            * scale).to(dtype)


def init_moe(cfg: ModelConfig, gen, dtype, device):
    """One layer's MoE params at the reference's init scales. The router
    is f32 whatever `dtype` is, as in the reference."""
    d, m = cfg.d_model, cfg.moe
    p = {
        "router": dense_init(gen, d, m.n_experts, torch.float32, device),
        "we_gate": _stacked_init(gen, m.n_experts, d, m.d_expert, dtype,
                                 device),
        "we_up": _stacked_init(gen, m.n_experts, d, m.d_expert, dtype,
                               device),
        "we_down": _stacked_init(gen, m.n_experts, m.d_expert, d, dtype,
                                 device),
    }
    if m.n_shared:
        # shared experts fused into one dense SwiGLU of width n_shared*d_expert
        f = m.n_shared * m.d_expert
        p["shared"] = {"wg": dense_init(gen, d, f, dtype, device),
                       "wu": dense_init(gen, d, f, dtype, device),
                       "wd": dense_init(gen, f, d, dtype, device)}
    return p


def moe_ffn(cfg: ModelConfig, p, x, *, dropless=False):
    """x: (B, S, d) -> (B, S, d). The reference's load-balance terms
    (its `aux`) serve training only and come with the capacity path."""
    if not dropless:
        raise NotImplementedError(
            "moe_ffn(dropless=False), the capacity-factor training path, "
            "is not yet ported")
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    xf = x.reshape(T, d)

    logits = xf.float() @ p["router"]                        # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # group the T*K assignments by expert (stable: token order inside one)
    flat_e = expert_idx.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    tok = order // K                                         # token of each
    out_assign = xf.new_empty((T * K, d))
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        rows = order[start:start + n]
        xe = xf[tok[start:start + n]]
        h = F.silu(xe @ p["we_gate"][e]) * (xe @ p["we_up"][e])
        out_assign[rows] = h @ p["we_down"][e]
        start += n

    # combine in the reference's kk order, in x.dtype
    out_assign = out_assign.reshape(T, K, d)
    gate2 = gate_vals.to(x.dtype)
    routed = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for kk in range(K):
        routed = routed + out_assign[:, kk] * gate2[:, kk, None]

    out = routed
    if m.n_shared:
        sp = p["shared"]
        out = out + (F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])) @ sp["wd"]
    return out.reshape(B, S, d)
