"""Paged GQA decode attention: the CUDA kernels `csrc/paged_attention.cu`
for CUDA tensors, the plain PyTorch version for CPU tensors.

Replaces the TPU kernel
`repro.kernels.paged_attention.paged_attention_pallas`: one query token
per sequence attends over KV kept in a single pooled tensor of blocks
(paper §4), addressed through a block table. On the card the context is
split into SPLIT-token pieces, one block each; a row longer than one split
leaves f32 partials, and the last of its split blocks to finish merges
them in split order (one launch per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import _DTYPES, _check
from repro_torch.kernels.ref import NEG_INF, paged_attention_reference

# kernel launches since the last reset (CPU calls do not count): one per
# call (the merge of a row's splits runs inside the same launch)
launches = 0
# the counter above, by name: a replayed CUDA graph adds what its capture
# counted (`serving.executor._StepGraph`)
COUNTERS = ("launches",)

MAX_GROUP = 16  # query heads per KV head the kernel holds (csrc MAX_G)
# the head dims the paged kernels (this one and paged_prefill.cu) have
# cases for: the served families' (dense, MoE). Not flash's list, which
# also takes zamba2's 80: a paged call at D = 80 raises here, before any
# launch, rather than fail in the kernel's dispatch
_HEAD_DIMS = (32, 64, 128)
SPLIT = 256     # context tokens per block (csrc SPLIT)


# the kernel's plain PyTorch version, run for CPU tensors and held
# against the kernel on the card
paged_attention_plain = paged_attention_reference


def n_splits(kv_len, ctx, split=SPLIT):
    """Splits a row of `kv_len` tokens uses, kv_len clamped to the table's
    `ctx` = MAXB * BS tokens (0 for an empty row)."""
    return (kv_len.long().clamp(max=ctx) + split - 1) // split


def combine_plain(part_o, part_ml, rows_splits):
    """The plain version of the kernel's merge of a row's splits. part_o
    (B, H, NS, D) and part_ml (B, H, NS, 2) hold each split's f32 (acc,
    (m, l)); row b uses its first rows_splits[b] splits, in order.
    Returns (B, H, D) f32:
    sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), 0 for a
    row with no split."""
    NS = part_o.shape[2]
    used = torch.arange(NS, device=part_o.device)[None] \
        < rows_splits.to(part_o.device)[:, None]            # (B, NS)
    used = used[:, None]                                    # (B, 1, NS)
    m = torch.where(used, part_ml[..., 0], float("-inf"))
    M = m.amax(dim=-1, keepdim=True)
    w = torch.where(used, torch.exp(m - M), 0.0)
    L = (torch.where(used, part_ml[..., 1], 0.0) * w).sum(-1)
    O = (torch.where(used[..., None], part_o, 0.0) * w[..., None]).sum(-2)
    return O / torch.clamp(L, min=1e-30)[..., None]


def paged_attention_split_plain(q, kv_pool, block_table, kv_len, *,
                                split=SPLIT, softmax_scale=None):
    """The split kernel's algorithm in plain PyTorch: per (row, head,
    split) f32 partials (m, l, acc) over tokens [s * split, (s + 1) *
    split) below kv_len, scores masked at -1e30, an empty split with m =
    -inf and l = 0; then `combine_plain`. Shapes as
    `paged_attention_reference`; returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    BS, KV = kv_pool.shape[1], kv_pool.shape[3]
    MAXB = block_table.shape[1]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    ctx = MAXB * BS
    ns = -(-ctx // split)
    g = kv_pool[block_table.long()]               # (B, MAXB, BS, 2, KV, D)
    kv = g.reshape(B, ctx, 2, KV, D).float()
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, 0, 0, ns * split - ctx))
    k = kv[:, :, 0].reshape(B, ns, split, KV, D)
    v = kv[:, :, 1].reshape(B, ns, split, KV, D)
    qh = (q * scale).float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bnskd->bkgns", qh, k)  # (B, KV, G, ns, split)
    pos = torch.arange(ns * split, device=q.device).reshape(ns, split)
    lens = kv_len.long().clamp(max=ctx).to(q.device)
    live = (pos[None] < lens[:, None, None])[:, None, None]
    s = torch.where(live, s, torch.tensor(NEG_INF, device=q.device))
    empty = ~live.any(dim=-1)                     # (B, 1, 1, ns)
    m = torch.where(empty, float("-inf"), s.amax(dim=-1))
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, v)
    part_o = acc.reshape(B, H, ns, D)
    part_ml = torch.stack([m, l], dim=-1).reshape(B, H, ns, 2)
    out = combine_plain(part_o, part_ml, n_splits(kv_len, ctx, split))
    return out.to(q.dtype)


def _fn():
    lib = _build.load("paged_attention")
    f = lib.paged_attention_fwd
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp] * 8 + [ci] * 8 + [ctypes.c_float, ci, vp]
        f.restype = ci
    return f


# per (CUDA device, stream): B * KV int32 tickets, zero between calls
# (the kernel's last split block of each row resets its own); grown,
# never shrunk. Calls on one stream run in order, so no two calls ever
# share tickets at once
_tickets = {}


def reserve_tickets(stream, n):
    """The ticket buffer of calls on `stream` (a torch.cuda.Stream), grown
    to at least `n` tickets first if it holds fewer: a new zeroed buffer
    made on the current stream. A CUDA graph that
    captures calls on `stream` reserves what its launches need before the
    capture and keeps the buffer returned, whose address they hold: a
    later growth puts a new buffer in its place here, which the captured
    launches never read. Replays of graphs that share a buffer must not
    overlap (they do not: they run on one stream)."""
    key = (stream.device, stream.cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=stream.device)
        _tickets[key] = buf
    return buf


def _ticket_buffer(device, n):
    """At least `n` zeroed int32 tickets for calls on `device`'s current
    stream, allocated (and zeroed) on it only when a call there needs
    more than any call before. Raises on a stream that is capturing a
    CUDA graph and has fewer: a buffer made inside the capture would be
    the graph's, zeroed by it, and no later eager call could see it
    (`reserve_tickets` first)."""
    stream = torch.cuda.current_stream(device)
    buf = _tickets.get((stream.device, stream.cuda_stream))
    if (buf is None or buf.numel() < n) \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"paged_attention: a capturing stream needs {n} "
                           "tickets reserved before the capture "
                           "(reserve_tickets)")
    return reserve_tickets(stream, n)


def split_pass(q, kv_pool, block_table, kv_len, scale):
    """Launch the split kernel on checked CUDA inputs. Returns (out,
    part_o, part_ml): out (B, H, D) holds every row, those longer than
    one split merged inside the launch from their f32 partials part_o
    (B, H, NS, D) and part_ml (B, H, NS, 2) (None when the table spans
    one split), which the call leaves in place."""
    global launches
    B, H, D = q.shape
    KV, BS = kv_pool.shape[3], kv_pool.shape[1]
    MAXB = block_table.shape[1]
    ns = -(-MAXB * BS // SPLIT)
    out = torch.empty_like(q)
    part_o = part_ml = tickets = None
    if ns > 1:
        part_o = torch.empty(B, H, ns, D, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(B, H, ns, 2, dtype=torch.float32,
                              device=q.device)
        tickets = _ticket_buffer(q.device, B * KV)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), kv_pool.data_ptr(), block_table.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (part_o, part_ml, tickets)),
                B, H, KV, D, BS, MAXB, SPLIT, ns, float(scale),
                _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out, part_o, part_ml


def paged_attention(q, kv_pool, block_table, kv_len, *, softmax_scale=None):
    """q: (B, H, D); kv_pool: (NB, BS, 2, KV, D); block_table: (B, MAXB)
    int32; kv_len: (B,) int32. Returns (B, H, D) in q.dtype. Every table
    entry below ceil(kv_len / BS) must be a block id < NB (the caller's
    contract; the kernel does not read the rest). CPU tensors run the
    plain version; CUDA tensors launch the split kernel once, which takes
    bf16 or f32, D in {32, 64, 128}, H / KV <= 16 and contiguous inputs,
    and raises on anything else. Each stream has tickets of its own
    for the split merge, so calls may run on several streams at once."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pool, block_table, kv_len,
                                     softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    _check("q", q, q.dtype, q.device, 3)
    _check("kv_pool", kv_pool, q.dtype, q.device, 5)
    _check("block_table", block_table, torch.int32, q.device, 2)
    _check("kv_len", kv_len, torch.int32, q.device, 1)
    B, H, D = q.shape
    NB, BS, two, KV, Dp = kv_pool.shape
    MAXB = block_table.shape[1]
    if two != 2 or Dp != D:
        raise ValueError(f"kv_pool shape {tuple(kv_pool.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if block_table.shape[0] != B or kv_len.shape != (B,):
        raise ValueError("block_table / kv_len batch does not match q")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not in {_HEAD_DIMS}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention: H={H}, KV={KV} needs "
                         f"H % KV == 0 and H / KV <= {MAX_GROUP}")
    if MAXB == 0:
        raise ValueError("paged_attention: block_table has no column")
    if any(t.data_ptr() % 16 for t in (q, kv_pool)):
        raise ValueError("paged_attention: inputs must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    return split_pass(q, kv_pool, block_table, kv_len, scale)[0]
