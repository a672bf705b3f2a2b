"""Mixture-of-experts FFN — the port of `repro.models.moe`: shared experts
plus routed top-k (deepseek-moe-16b: 64 experts top-6 + 2 shared;
llama4-scout: 16 top-1 + 1 shared), with the reference's load-balance
terms.

`moe_ffn` returns `(out, aux)` as the reference does, on two paths:

  dropless=True   (serving) computes the reference's function with
                  C = T*K without building the (E, C, d) buffer, in
                  static shapes and with no value read on the host, so a
                  captured CUDA graph holds it whole (the reference jits
                  its serving steps, MoE included). The T*K (token,
                  expert) assignments are sorted by expert (stable:
                  token order inside one), gathered, run through three
                  grouped products (`torch._grouped_mm`) whose group
                  offsets, the counts' cumulative sum, stay on the
                  device, and put back in (token, k) order. At full
                  width the buffer would be (64, 6T, 2048) and cost 64x
                  the useful expert FLOPs. Where the grouped product
                  would read its offsets on the host (on CUDA every dtype
                  but bf16: the CUTLASS route takes bf16 only, the others
                  a per-group loop that copies the offsets to the host),
                  the capacity dispatch below runs at C = T: top-k picks
                  K distinct experts a token, so no expert gets more
                  than T rows and nothing is dropped.
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
from repro_torch.models import act_sharding
from repro_torch.models.act_sharding import pin_grad, replaceable
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
    xf = pin_grad(act_sharding.constrain_moe_tokens(x.reshape(T, d)))

    logits = xf.float() @ p["router"]                        # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = act_sharding.constrain_moe_tokens(expert_idx.reshape(T * K))
    counts = bincount(flat_e, E)
    gate2 = gate_vals.to(x.dtype)
    if dropless:
        routed = routed_dropless(p, xf, flat_e, counts, gate2, T, K, E)
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
    # a DTensor gradient may arrive laid out otherwise than this output;
    # its reshape backward needs the output's own layout
    return pin_grad(out.reshape(B, S, d)), aux


@replaceable
def bincount(x, n: int):
    """The count of each of the `n` values in the 1-d integer `x`, by a
    scatter-add into n zeros (`torch.bincount` on CUDA reads x's largest
    value on the host to size its output)."""
    return torch.zeros(n, dtype=torch.int64, device=x.device).scatter_add_(
        0, x, torch.ones_like(x))


@replaceable
def replicated(x):
    """`x`, in full on every rank (the dry run's form gathers a DTensor)."""
    return x


@replaceable
def gathered(*xs):
    """`xs`, each in full on every rank as a plain tensor (the dry run's
    form gathers DTensors)."""
    return xs


@replaceable
def routed_dropless(p, xf, flat_e, counts, gate2, T, K, E):
    """Dropless routing in static shapes with no host read: the grouped
    products where they keep their offsets on the device, else the
    capacity dispatch at C = T (module docstring). (The dry run's form is
    the capacity dispatch at C = T*K.)"""
    if grouped_offsets_stay_on_device(xf):
        return _routed_grouped(p, xf, flat_e, counts, gate2, T, K)
    return _routed_capacity(p, xf, flat_e, counts, gate2, T, K, E, T)[0]


def grouped_offsets_stay_on_device(x) -> bool:
    """Whether `torch._grouped_mm` takes x's dtype on x's device without
    reading its offsets on the host: on CUDA bf16 only (the CUTLASS
    route; other dtypes take a loop over the groups, which copies the
    offsets to the host), on the CPU every dtype (no device to wait
    for)."""
    return x.device.type != "cuda" or x.dtype == torch.bfloat16


def _routed_grouped(p, xf, flat_e, counts, gate2, T, K):
    """Dropless: the T*K assignments sorted by expert (stable: token
    order inside one), each expert's SwiGLU chain over its own rows as
    grouped products with the group ends cumsum(counts) on the device."""
    d = xf.shape[1]
    order = torch.argsort(flat_e, stable=True)
    xs = xf.index_select(0, order // K)            # each assignment's token
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    h = F.silu(torch._grouped_mm(xs, p["we_gate"], offs=ends)) \
        * torch._grouped_mm(xs, p["we_up"], offs=ends)
    ys = torch._grouped_mm(h, p["we_down"], offs=ends)
    # back in (token, k) order; combined in the reference's kk order, in
    # x.dtype
    out_assign = ys.new_empty((T * K, d)).index_copy_(0, order, ys) \
        .reshape(T, K, d)
    routed = torch.zeros((T, d), dtype=xf.dtype, device=xf.device)
    for kk in range(K):
        routed = routed + out_assign[:, kk] * gate2[:, kk, None]
    return routed


def _capacity_slots(flat_e, counts, C):
    """(keep, slot) of each of the n (token, k) pairs in flat (T*K)
    order: its exclusive position within its expert, counted in that
    order (a stable sort by expert keeps it inside an expert, so position
    = rank in the sort - the expert's first rank), kept below C; its slot
    e * C + position in the (E, C) buffer (clamped to C - 1 when
    dropped)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=flat_e.device)
    starts = torch.cumsum(counts, 0) - counts
    pos = rank - starts[flat_e]
    return pos < C, flat_e * C + torch.clamp(pos, max=C - 1)


def _routed_capacity(p, xf, flat_e, counts, gate2, T, K, E, C):
    """Capacity-factor dispatch (the reference's, `moe.py:70-112`).
    Returns (routed (T, d), keep (T*K,) bool)."""
    # on DTensors the routing's index math runs on every rank in full
    # (gathered expert ids: T*K integers), as plain tensors
    flat_e, counts = gathered(flat_e, counts)
    keep, slot = _capacity_slots(flat_e, counts, C)
    buf = act_sharding.constrain_moe_buffer(dispatch(xf, slot, keep, E, C))
    # expert compute: (E, C, d) x (E, d, f)
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    out_buf = act_sharding.constrain_moe_buffer(torch.bmm(h, p["we_down"]))
    return combine(out_buf, slot, keep, gate2), keep


@replaceable
def dispatch(xf, slot, keep, E, C):
    """The (E, C, d) buffer of the tokens xf (T, d): slot j holds the
    token of the kept pair at slot j, zeros where none. An int slot ->
    token map (T = empty), then the payload by a gather; dropped pairs
    scatter into one spare slot past the end. (The dry run's form builds
    each rank's shard of the buffer from its own tokens by an
    all-to-all.)"""
    T, d = xf.shape
    K = slot.shape[0] // T
    tok_idx = torch.arange(slot.shape[0], device=xf.device) // K
    slot_src = torch.full((E * C + 1,), T, dtype=torch.long,
                          device=xf.device)
    slot_src[torch.where(keep, slot, E * C)] = tok_idx
    slot_src = slot_src[:E * C]
    # gathers by index_select: their backward is index_add_ (atomics);
    # advanced indexing's sorts its indices first, and took 38 ms of a
    # 276 ms deepseek-moe-16b train step on the H100 (chip_smoke.py
    # --profile)
    filled = (slot_src < T)[:, None].to(xf.dtype)
    # (on DTensors the gather reads a replicated source: the tokens'
    # all-gather, which DTensor's own gather rule would issue too, with a
    # backward it can run)
    return (replicated(xf).index_select(0, torch.clamp(slot_src, max=T - 1))
            * filled).reshape(E, C, d)


@replaceable
def combine(out_buf, slot, keep, gate2):
    """(T, d): each token's kept expert outputs from the (E, C, d) buffer,
    weighted by its gates, summed in the reference's kk order in
    out_buf's dtype: K gathers of (T, d), never (T*K, d). (The dry run's
    form brings each token shard's rows back by an all-to-all.)"""
    T, K = gate2.shape
    d = out_buf.shape[-1]
    # replicated before the flattening view: the view's backward cannot
    # unflatten a gradient whose capacity dim is sharded over two mesh
    # dims (2x16x16's 'pod' and 'data')
    flat_out = replicated(out_buf).reshape(-1, d)
    routed = torch.zeros((T, d), dtype=out_buf.dtype, device=out_buf.device)
    slot2, keep2 = slot.reshape(T, K), keep.reshape(T, K)
    for kk in range(K):
        g = act_sharding.constrain_moe_tokens(
            flat_out.index_select(0, slot2[:, kk]))
        routed = routed + g * (gate2[:, kk]
                               * keep2[:, kk].to(out_buf.dtype))[:, None]
    return routed
