"""Plain PyTorch versions of the attention functions the port's kernels
compute — ports of `repro.kernels.ref`, with the same masking (NEG_INF =
-1e30, never -inf), the same f32 accumulation and the same place where
values are rounded to the storage dtype, so f32 results match the JAX
oracles to float rounding.

The CUDA wrappers (`flash_prefill.flash_attention`,
`paged_attention.paged_attention`, `paged_prefill.paged_prefill`) run
these for CPU tensors only; the tests and `chip_smoke.py` hold the
kernels against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _as_lens(x, B, device):
    """int / sequence / tensor -> (B,) int64 tensor on `device`."""
    t = torch.as_tensor(x, device=device).reshape(-1).to(torch.int64)
    return t.expand(B) if t.numel() == 1 else t


def mha_reference(q, k, v, *, causal=True, window=0, kv_len=None, q_offset=0,
                  softmax_scale=None):
    """Unchunked masked GQA attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H % KV == 0.
    kv_len: (B,) valid KV prefix length (None -> all valid).
    q_offset: absolute position of q[0] (int or (B,) tensor) for causal
      masking when Sq < Skv (decode / chunked prefill).
    window: >0 -> sliding-window attention (each query sees the last
      `window` keys, inclusive of itself).
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qh = (q * scale).reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k).float()

    dev = q.device
    q_pos = _as_lens(q_offset, B, dev)[:, None] \
        + torch.arange(Sq, device=dev)                      # (B, Sq)
    k_pos = torch.arange(Skv, device=dev)
    mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos[None, None, :]
    if window:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
    if kv_len is not None:
        mask &= k_pos[None, None, :] < _as_lens(kv_len, B, dev)[:, None, None]
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def flash_attention_reference(q, k, v, *, causal=True, window=0, kv_len=None,
                              q_offset=0, q_chunk=512, kv_chunk=512,
                              softmax_scale=None):
    """Chunked online-softmax GQA attention (the flash kernel's plain
    version). Shapes as in `mha_reference`; ragged Sq / Skv are padded up
    to the chunk grid (padded KV masked via kv_len, padded q rows sliced
    off)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    orig_Sq = Sq
    pad_q = (-Sq) % q_chunk
    pad_kv = (-Skv) % kv_chunk
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        if kv_len is None:
            kv_len = torch.full((B,), Skv, dtype=torch.int64, device=dev)
        Skv += pad_kv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        Sq += pad_q
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    qh = q.reshape(B, nq, q_chunk, KV, G, D)
    kh = k.reshape(B, nk, kv_chunk, KV, D)
    vh = v.reshape(B, nk, kv_chunk, KV, D)
    q_off = _as_lens(q_offset, B, dev).reshape(-1, 1)          # (B, 1)
    kv_len_arr = None if kv_len is None \
        else _as_lens(kv_len, B, dev).reshape(-1, 1, 1)
    neg = torch.tensor(NEG_INF, device=dev)

    outs = []
    for qi in range(nq):
        qc = qh[:, qi].float() * scale                         # (B,qc,KV,G,D)
        q_pos = q_off + qi * q_chunk \
            + torch.arange(q_chunk, device=dev)                # (B, qc)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, D), device=dev)
        for ki in range(nk):
            kc = kh[:, ki].float()
            vc = vh[:, ki].float()
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kc)
            mask = torch.ones((q_pos.shape[0], q_chunk, kv_chunk),
                              dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, :, None] >= k_pos[None, None, :]
            if window:
                mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
            if kv_len_arr is not None:
                mask &= k_pos[None, None, :] < kv_len_arr
            logits = torch.where(mask[:, None, None], logits, neg)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,qc,D)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, D)
    return out[:, :orig_Sq]


def decode_attention_reference(q, k_cache, v_cache, kv_len, *, window=0,
                               softmax_scale=None):
    """Single-token GQA decode attention over a dense cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, KV, D); kv_len: (B,) valid
    entries. With a ring buffer every cached slot is within the window
    already, so `window` changes nothing here (as in the reference)."""
    del window
    return mha_reference(q, k_cache, v_cache, causal=False, window=0,
                         kv_len=kv_len, softmax_scale=softmax_scale)


def paged_attention_reference(q, kv_pool, block_table, kv_len, *,
                              softmax_scale=None):
    """Decode GQA attention over a paged KV pool (the paged kernel's plain
    version).

    q:           (B, H, D) one query token per sequence
    kv_pool:     (NB, BS, 2, KV, D); [..., 0, :, :] = K, [..., 1, :, :] = V
    block_table: (B, MAX_BLOCKS) int32 physical block ids (padding: any
                 in-range id, masked out by kv_len)
    kv_len:      (B,) valid token count per sequence
    returns      (B, H, D)
    """
    B, H, D = q.shape
    BS, KV = kv_pool.shape[1], kv_pool.shape[3]
    MAX_BLOCKS = block_table.shape[1]
    gathered = kv_pool[block_table.long()]        # (B, MAXB, BS, 2, KV, D)
    k = gathered[:, :, :, 0].reshape(B, MAX_BLOCKS * BS, KV, D)
    v = gathered[:, :, :, 1].reshape(B, MAX_BLOCKS * BS, KV, D)
    out = mha_reference(q[:, None], k, v, causal=False, kv_len=kv_len,
                        softmax_scale=softmax_scale)
    return out[:, 0]


def paged_prefill_reference(q, kv_pool, block_table, seg_ids, q_pos, kv_len,
                            *, host_pool=None, tier=None, tq=8,
                            softmax_scale=None):
    """Segmented GQA prefill attention straight over a paged KV pool (the
    paged-prefill kernel's plain version).

    The token batch is a flat concatenation of per-request segments (a
    prefill chunk, a one-token decode, a kv_len = 0 dummy), each padded to
    a multiple of the query tile `tq`, so a tile never straddles two
    segments. Every query attends causally against its segment's KV in
    the pool (the chunk's own KV must already be written there). KV is
    gathered once per query tile, as the kernel chases the table per tile.

    q:           (T, H, D) flat token batch, T % tq == 0
    kv_pool:     (NB, BS, 2, KV, D) device pool; [..., 0/1, :, :] = K/V
    block_table: (S, MAXB) int physical block ids per segment
    seg_ids:     (T,) int segment of each token
    q_pos:       (T,) int absolute position of each token
    kv_len:      (S,) int valid tokens per segment (prefix + chunk)
    host_pool/tier: with `tier` (S,) set, a segment whose flag is set
                 reads `host_pool` (NBH, BS, 2, KV, D) instead; the host
                 pool may lie on the CPU (its gathered blocks are moved to
                 q's device). Out-of-range ids are clamped into each pool
                 (the not-selected gather is discarded), as in the
                 reference.
    returns      (T, H, D)
    """
    T, H, D = q.shape
    S, MAXB = block_table.shape
    BS, KV = kv_pool.shape[1], kv_pool.shape[3]
    G = H // KV
    NT = T // tq
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    tile_seg = seg_ids.reshape(NT, tq)[:, 0].long()
    tab_t = block_table.long()[tile_seg]                    # (NT, MAXB)
    g = kv_pool[torch.clamp(tab_t, max=kv_pool.shape[0] - 1)]
    if tier is not None:                          # (NT, MAXB, BS, 2, KV, D)
        hid = torch.clamp(tab_t, max=host_pool.shape[0] - 1)
        gh = host_pool[hid.to(host_pool.device)].to(dev)
        tt = tier.to(dev).bool()[tile_seg]
        g = torch.where(tt[:, None, None, None, None, None], gh, g)
    k = g[:, :, :, 0].reshape(NT, MAXB * BS, KV, D)
    v = g[:, :, :, 1].reshape(NT, MAXB * BS, KV, D)
    qh = (q * scale).reshape(NT, tq, KV, G, D)
    logits = torch.einsum("ntkgd,nskd->nkgts", qh, k).float()
    k_pos = torch.arange(MAXB * BS, device=dev)
    qp = q_pos.long().reshape(NT, tq)
    lens = kv_len.long()[tile_seg]
    mask = (qp[:, :, None] >= k_pos[None, None]) \
        & (k_pos[None, None] < lens[:, None, None])
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(logits, dim=-1)             # (NT, KV, G, tq, Skv)
    out = torch.einsum("nkgts,nskd->ntkgd", p.to(v.dtype), v)
    return out.reshape(T, H, D)
