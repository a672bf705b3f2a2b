"""Mixture-of-experts FFN — the port of `repro.models.moe`: shared experts
plus routed top-k (deepseek-moe-16b: 64 experts top-6 + 2 shared;
llama4-scout: 16 top-1 + 1 shared), with the reference's load-balance
terms.

`moe_ffn` returns `(out, aux)` as the reference does, on two paths:

  dropless=True   (serving) computes the reference's function with
                  C = T*K without building the (E, C, d) buffer: the T*K
                  (token, expert) assignments are grouped by expert and
                  each expert runs one `torch.matmul` chain over its own
                  rows. At full width the buffer would be (64, 6T, 2048)
                  and cost 64x the useful expert FLOPs. Grouping needs the
                  per-expert counts on the host (one device sync per
                  layer).
  dropless=False  (training) is the reference's capacity-factor dispatch
                  (`moe.py:44-119`): C = max(1, int(T*K/E*capacity_factor))
                  slots per expert, each (token, k) pair's position within
                  its expert counted in the flat token-major (T*K) order,
                  pairs at position >= C dropped, an (E, C, d) buffer
                  gathered through a slot -> token map and the experts run
                  as batched products. C is fixed by the shape, so this
                  path never waits for the device.

Both combine the routed outputs in the reference's order
(`for kk in range(K)`) so f32 results match it to matmul rounding. On
the capacity path `aux` holds `lb_loss` = E * sum(mean router prob x
fraction dispatched) and `dropped_frac`, the share of (token, k) pairs
past their expert's capacity. The dropless path returns an empty `aux`:
serving never reads the load-balance terms, and eager PyTorch would
launch their ops on every layer of every step. On CUDA the backward of
the buffer's gathers accumulates with atomics, so MoE gradients are not
bitwise repeatable from run to run.
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


def _load_balance(probs, counts, T, K, E, dropped_frac):
    """The reference's aux terms: E * sum(mean router prob x fraction of
    the T*K assignments dispatched to each expert)."""
    me = probs.mean(0)
    ce = counts / (T * K)
    return {"lb_loss": E * torch.sum(me * ce), "dropped_frac": dropped_frac}


# slots per expert on the capacity path, as a multiple of the even share
# T*K/E (the reference's default)
CAPACITY_FACTOR = 1.25


def moe_ffn(cfg: ModelConfig, p, x, *, capacity_factor=CAPACITY_FACTOR,
            dropless=False):
    """x: (B, S, d) -> ((B, S, d), aux) — the routed experts dropless
    (serving) or through the capacity buffer (training); module
    docstring."""
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
    flat_e = expert_idx.reshape(T * K)
    counts = torch.bincount(flat_e, minlength=E)
    gate2 = gate_vals.to(x.dtype)
    if dropless:
        routed = _routed_grouped(p, xf, flat_e, counts, gate2, T, K)
        aux = {}
    else:
        C = max(1, int(T * K / E * capacity_factor))
        routed, keep = _routed_capacity(p, xf, flat_e, counts, gate2, T, K,
                                        E, C)
        aux = _load_balance(probs, counts, T, K, E,
                            1.0 - keep.float().mean())

    out = routed
    if m.n_shared:
        sp = p["shared"]
        out = out + (F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])) @ sp["wd"]
    return out.reshape(B, S, d), aux


def _routed_grouped(p, xf, flat_e, counts, gate2, T, K):
    """Dropless: group the T*K assignments by expert (stable: token order
    inside one), one matmul chain per expert over its own rows."""
    d = xf.shape[1]
    order = torch.argsort(flat_e, stable=True)
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
    routed = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
    for kk in range(K):
        routed = routed + out_assign[:, kk] * gate2[:, kk, None]
    return routed


def _routed_capacity(p, xf, flat_e, counts, gate2, T, K, E, C):
    """Capacity-factor dispatch (the reference's, `moe.py:70-112`).
    Returns (routed (T, d), keep (T*K,) bool)."""
    d = xf.shape[1]
    n = T * K
    # each pair's exclusive position within its expert in flat (T*K)
    # order: a stable sort by expert keeps that order inside an expert,
    # so position = rank in the sort - the expert's first rank
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=xf.device)
    starts = torch.cumsum(counts, 0) - counts
    pos = rank - starts[flat_e]
    keep = pos < C

    # an int slot -> token map (T = empty), then the payload by gathers;
    # dropped pairs scatter into one spare slot past the end
    slot = flat_e * C + torch.clamp(pos, max=C - 1)          # (T*K,)
    tok_idx = torch.arange(n, device=xf.device) // K
    slot_src = torch.full((E * C + 1,), T, dtype=torch.long,
                          device=xf.device)
    slot_src[torch.where(keep, slot, E * C)] = tok_idx
    slot_src = slot_src[:E * C]
    # gathers by index_select: their backward is index_add_ (atomics);
    # advanced indexing's sorts its indices first, and took 38 ms of a
    # 276 ms deepseek-moe-16b train step on the H100 (chip_smoke.py
    # --profile)
    filled = (slot_src < T)[:, None].to(xf.dtype)
    buf = (xf.index_select(0, torch.clamp(slot_src, max=T - 1))
           * filled).reshape(E, C, d)

    # expert compute: (E, C, d) x (E, d, f)
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    flat_out = torch.bmm(h, p["we_down"]).reshape(E * C, d)

    routed = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
    slot2, keep2 = slot.reshape(T, K), keep.reshape(T, K)
    for kk in range(K):  # K gathers of (T, d), never (T*K, d)
        g = flat_out.index_select(0, slot2[:, kk])
        routed = routed + g * (gate2[:, kk]
                               * keep2[:, kk].to(xf.dtype))[:, None]
    return routed, keep
