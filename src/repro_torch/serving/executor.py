"""PyTorch executor for the serving engine: paged KV pools + the model
forwards that read and write them — the port of
`repro.serving.executor.PagedExecutor` (prefill, pool writes and copies,
two-call chunked prefill, paged decode, and the fused `mixed_step`, whose
chunk rows attend straight over the pools through the paged-prefill
kernel). Decoder-only families: dense and MoE.

Physical layout follows the paper's §4: ONE pooled tensor per memory tier
(device / host), shared by all layers — `(num_blocks, block_size, 2, KV,
hd)` — so any physical block can hold any (request, layer) slice; logical
placement lives in the block manager. Each pool carries ONE extra
physical block (`trash_block`, id == num_*_blocks) that the block manager
never hands out: padded batch rows scatter their garbage KV there.

Where JAX donated the pool buffers to each jitted step, the port updates
the pools in place (`index_copy_` / `index_put_` / slice `copy_`).

Host tier: on CUDA the HOST pool is pinned CPU memory. Device-to-host and
host-to-device block copies (offload, reload) are `non_blocking` copies
of contiguous runs of host blocks on the current stream, so they are
ordered with the forwards that produce and consume them without any
extra synchronisation. The only CPU-side access to the host pool (a
same-pool host copy) synchronises the stream first.

Inside a fused step, a chunk whose layer is host-resident reads that
layer's live host blocks from a device staging buffer (slot s * MAXB +
j). `mixed_step` lists each such layer's blocks on the host as copy runs
(`paged_prefill.host_block_runs`), and the copy engine stages them one
host-tier layer ahead on a side stream (`paged_prefill.staging_stream`)
into one of two buffers, while the layer before computes. Ordering is by
CUDA events only: the side stream waits for an event recorded at the
start of the step (every earlier write into the host pool is before it)
and, before it refills a buffer, for the body that last read it; the
layer's writes and body wait for its staging. The chunk's own new K/V of
a host-tier layer go both to the host pool (async copies of contiguous
slot runs, which later steps read) and, by a device scatter, into the
staged blocks the chunk fills, which were copied before those rows
existed; so the body reads exactly the values the host pool holds, and
two pools give one pool's bits. The two buffers are allocated once,
grown to the largest step's need and kept (`staging_bytes`). On the CPU
the same code runs with the plain staging, in the same order, without
streams.

Bucketed-shape contract (as in the reference): `prefill` pads the prompt
buffer, `decode` the batch width R, and `mixed_step` the chunk rows Tc /
chunk segments Sc / decode width Rb / output rows Sb to power-of-two
buckets, block tables round to 8-block granularity, padded rows carry
trash-block tables. Every novel shape signature is counted in the registry's
`jit_retraces` series, the reference's name for it: in the port a
signature is what a later CUDA-graph capture would key on.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
from typing import List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import paged_prefill as pp
from repro_torch.models import layers
from repro_torch.models.model import (DecoderModel, ffn, layer_params,
                                      mask_pad_logits, torch_dtype)
from repro_torch.obs.registry import MetricsRegistry

log = logging.getLogger(__name__)

# query-tile granularity of the fused mixed step: every chunk segment's
# tokens are padded to a multiple of TQ so a query tile never straddles
# two segments (the reference's value)
MIXED_TQ = 32


def _round_up(n, m):
    return -(-n // m) * m


def _bucket(n: int, lo: int = 1) -> int:
    """Smallest power-of-two >= n (and >= lo) — the shape bucket."""
    b = lo
    while b < n:
        b *= 2
    return b


def _runs(ids: Sequence[int]):
    """Maximal runs of consecutive ids: yields (i, j, ids[i]) with
    ids[i:j] == range(ids[i], ids[i] + j - i)."""
    i, n = 0, len(ids)
    while i < n:
        j = i + 1
        while j < n and ids[j] == ids[j - 1] + 1:
            j += 1
        yield i, j, ids[i]
        i = j


@dataclasses.dataclass
class MixedChunk:
    """One prefill chunk riding the fused mixed step."""
    tokens: List[int]        # chunk token ids
    offset: int              # absolute position of tokens[0] (= prefill_done)
    tables: List[List[int]]  # per-layer LIVE block ids — only the
    #                          ceil((offset + len(tokens)) / BS) blocks that
    #                          hold valid KV, never the full allocation
    tiers: List[bool]        # per-layer: True = blocks live in the HOST pool


@dataclasses.dataclass
class MixedDecode:
    """One decode token riding the fused mixed step."""
    token: int               # last generated token (the step's input)
    ctx: int                 # tokens already cached; KV grows to ctx + 1
    tables: List[List[int]]  # per-layer DEVICE block ids


class _HostStaging:
    """One fused step's host staging. Host-tier layers h_0 < h_1 < ...
    (those with a live host block) alternate between two staging buffers:
    h_k's live host blocks are copied into buffer k % 2 by the copy engine
    (`paged_prefill.stage_host_runs`), issued at the top of layer h_{k-1}
    (h_0's at the start of the step). On CUDA the copies run on the side
    stream and CUDA events order them, with no host sync: the side stream
    waits for the step's start event (every earlier host-pool write is
    before it) and, before it refills a buffer, for the body that last read
    it; layer h_k's writes wait for its copies. On the CPU the same calls
    run in the same order, with the plain staging and no events."""

    def __init__(self, ex: "PagedExecutor", runs, st_idx, n_slots: int):
        self.ex, self.runs, self.st_idx = ex, runs, st_idx
        self.layers = [l for l, r in enumerate(runs) if r is not None]
        self.order = {l: k for k, l in enumerate(self.layers)}
        if not self.layers:
            return
        self.bufs = ex._staging_buffers(n_slots + 1)   # + the trash block
        self.cuda = ex.device.type == "cuda"
        if self.cuda:
            if ex._staging_sync is None:
                ex._staging_sync = (pp.staging_stream(ex.device),
                                    [torch.cuda.Event() for _ in range(2)],
                                    [torch.cuda.Event() for _ in range(2)])
            self.side, self.staged_ev, self.read_ev = ex._staging_sync
            self.main = torch.cuda.current_stream(ex.device)
            self.side.wait_stream(self.main)      # the step's start
        self._stage(0)

    def _stage(self, k: int) -> None:
        """Issue host-tier layer h_k's copies into buffer k % 2."""
        b = k % 2
        if self.cuda:
            if k >= 2:
                self.side.wait_event(self.read_ev[b])
            with torch.cuda.stream(self.side):
                pp.stage_host_runs(self.ex.host_pool,
                                   self.runs[self.layers[k]], self.bufs[b])
            self.staged_ev[b].record(self.side)
        else:
            pp.stage_host_runs(self.ex.host_pool, self.runs[self.layers[k]],
                               self.bufs[b])

    def ahead(self, l: int) -> None:
        """At the top of layer l: if l is host-tier layer h_k, issue
        h_{k+1}'s copies, which run while h_k computes."""
        k = self.order.get(l)
        if k is not None and k + 1 < len(self.layers):
            self._stage(k + 1)

    def write(self, l: int, host_runs, k, v):
        """Write the chunk rows' new K/V (Tc, KV, hd) of host-tier layer l
        into the host pool (async copies) and into its staged blocks (a
        device scatter, after its copies). Returns the staging buffer the
        layer's body reads, or None for a layer with no host block."""
        kk = self.order.get(l)
        if kk is None:
            return None
        buf = self.bufs[kk % 2]
        if self.cuda:
            self.main.wait_event(self.staged_ev[kk % 2])
        kv = torch.stack([k, v], dim=1).to(buf.dtype)   # (Tc, 2, KV, hd)
        self.ex._host_scatter(host_runs, kv)
        buf.view(-1, *buf.shape[2:]).index_copy_(0, self.st_idx[l], kv)
        return buf

    def read(self, l: int) -> None:
        """After layer l's body: its buffer may be refilled."""
        kk = self.order.get(l)
        if kk is not None and self.cuda:
            self.read_ev[kk % 2].record(self.main)


class PagedExecutor:
    """Owns the physical KV pools (device + host buffers, paged in
    `block_size`-token blocks) and runs model forwards against them:
    batched prefill, paged decode, two-call chunked prefill, and the fused
    `mixed_step`. Pure
    mechanism — which blocks a request may touch is decided upstream by
    `SchedulerCore`/`LayerwiseBlockManager`."""

    def __init__(self, cfg: ModelConfig, params, num_device_blocks: int,
                 num_host_blocks: int, block_size: int, *, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = DecoderModel(cfg, params, device=self.device, seed=seed)
        self.params = self.model.params
        hd = cfg.resolved_head_dim
        dt = torch_dtype(cfg.dtype)
        self.block_size = block_size
        self.num_device_blocks = num_device_blocks
        self.num_host_blocks = num_host_blocks
        self._pinned = self.device.type == "cuda"
        # +1: the trash block (id == num_*_blocks) absorbing padded rows'
        # scatter writes; the block manager never allocates it and no
        # block table with kv_len > 0 ever reads it
        self.device_pool = torch.zeros(
            (num_device_blocks + 1, block_size, 2, cfg.n_kv_heads, hd),
            dtype=dt, device=self.device)
        self.host_pool = torch.zeros(
            (num_host_blocks + 1, block_size, 2, cfg.n_kv_heads, hd),
            dtype=dt, pin_memory=self._pinned)
        # logits rows that came out non-finite, counted on the device so
        # the check never waits for it
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        # the fused step's two host staging buffers (grown to the largest
        # step's Sc * MAXBc + 1 blocks, reused across steps) and, on CUDA,
        # the side stream and events that order them (`_HostStaging`)
        self._staging = None
        self._staging_sync = None
        # shape accounting: every novel (entry point, shape bucket)
        # signature. Counts live in the obs registry; the owning engine
        # swaps in the core's registry so one snapshot() carries both.
        self.registry = MetricsRegistry()
        self._jit_sigs: set = set()

    @property
    def jit_retraces(self) -> collections.Counter:
        """Novel shape signatures per entry point (registry-backed
        Counter — the reference's attribute shape)."""
        return self.registry.counter_view("jit_retraces", "fn")

    def _note_trace(self, fn: str, sig: tuple) -> None:
        if (fn, sig) not in self._jit_sigs:
            self._jit_sigs.add((fn, sig))
            self.registry.inc("jit_retraces", fn=fn)
            log.info("new shape signature #%d for %s%s",
                     int(self.registry.get("jit_retraces", fn=fn)),
                     fn, sig)

    def nonfinite_logits(self) -> int:
        """Logits rows with a NaN or inf since construction (waits for
        the device)."""
        return int(self._nonfinite)

    def _note_logits(self, logits) -> None:
        self._nonfinite += (~torch.isfinite(logits)).reshape(
            -1, logits.shape[-1]).any(dim=-1).sum()

    def _to_device(self, a, dtype=torch.int64):
        """Host array / list -> device tensor without a stream sync
        (staged through pinned memory on CUDA)."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self._pinned:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _host_sync(self) -> None:
        """Wait for queued copies into / out of the pinned host pool
        before the CPU touches it."""
        if self._pinned:
            torch.cuda.current_stream(self.device).synchronize()

    # -------------------------------------------------------------- prefill
    def prefill(self, prompt: List[int], pad_to: int):
        """Run one request's prefill (B=1). `pad_to` is bucketed to the
        next power of two (>= 16). Returns (next_token, k_layers,
        v_layers) with shapes (L, S_bucket, KV, hd); only the first
        len(prompt) positions are valid (callers slice what they need)."""
        S = len(prompt)
        pad_to = _bucket(pad_to, 16)
        self._note_trace("prefill", (pad_to,))
        toks = np.zeros((1, pad_to), np.int64)
        toks[0, :S] = prompt
        batch = {"tokens": self._to_device(toks),
                 "prompt_len": self._to_device([S], torch.int32)}
        cache = self.model.init_cache(1, pad_to)
        logits, cache = self.model.prefill(batch, cache, dropless=True)
        self._note_logits(logits)
        next_tok = int(torch.argmax(logits[0]))
        return next_tok, cache["k"][:, 0], cache["v"][:, 0]

    # ----------------------------------------------------- block movement
    def _pool(self, tier: str):
        return self.device_pool if tier == "device" else self.host_pool

    def _put_blocks(self, tier: str, ids: List[int], blocks) -> None:
        """pool[ids] = blocks, blocks (n, BS, 2, KV, hd) on the device.
        Host writes go out as one async copy per contiguous run."""
        if tier == "device":
            self.device_pool.index_copy_(0, self._to_device(ids), blocks)
            return
        for i, j, first in _runs(ids):
            self.host_pool[first:first + j - i].copy_(
                blocks[i:j], non_blocking=True)

    def _get_blocks(self, tier: str, ids: List[int]):
        """pool[ids] as a new device tensor (n, BS, 2, KV, hd). Host reads
        come in as one async copy per contiguous run."""
        if tier == "device":
            return self.device_pool[self._to_device(ids)]
        parts = [self.host_pool[first:first + j - i].to(
                     self.device, non_blocking=True)
                 for i, j, first in _runs(ids)]
        if not parts:
            return self.device_pool.new_empty(
                (0, *self.device_pool.shape[1:]))
        return torch.cat(parts)

    def write_layer(self, tier: str, block_ids: List[int], k, v):
        """Write one layer's KV (>= len(block_ids) * BS rows, KV, hd) into
        whole `block_ids` blocks, pad positions included."""
        nb = len(block_ids)
        S_pad = nb * self.block_size
        pool = self._pool(tier)
        kr = k[:S_pad].reshape(nb, self.block_size, *k.shape[1:])
        vr = v[:S_pad].reshape(nb, self.block_size, *v.shape[1:])
        kv = torch.stack([kr, vr], dim=2).to(pool.dtype)
        self._put_blocks(tier, block_ids, kv)

    def write_layer_slice(self, tier: str, block_ids: List[int],
                          token_offset: int, k, v):
        """Append one layer's chunk KV (C, KV, hd) into `block_ids` starting
        at absolute token `token_offset` (need not be block-aligned)."""
        BS = self.block_size
        C = k.shape[0]
        pos = np.arange(token_offset, token_offset + C)
        if tier == "device":
            blk = self._to_device(np.asarray(block_ids)[pos // BS])
            off = self._to_device(pos % BS)
            self.device_pool[blk, off, 0] = k.to(self.device_pool.dtype)
            self.device_pool[blk, off, 1] = v.to(self.device_pool.dtype)
            return
        kv = torch.stack([k, v], dim=1).to(self.host_pool.dtype)
        t = 0
        while t < C:   # one async copy per touched block
            p = token_offset + t
            n = min(BS - p % BS, C - t)
            self.host_pool[block_ids[p // BS], p % BS:p % BS + n].copy_(
                kv[t:t + n], non_blocking=True)
            t += n

    def gather_layer(self, tier: str, block_ids: List[int], kv_valid=None):
        """Dense (nb*BS, KV, hd) K and V of one layer's block list, on the
        device — the contiguous prefix buffer two-call chunked prefill
        attends against. With `kv_valid` set, only the ceil(kv_valid / BS)
        blocks holding live tokens are read; the remaining rows come back
        zero (callers mask them via kv_len anyway)."""
        BS = self.block_size
        nb = len(block_ids)
        live = nb if kv_valid is None else min(
            _round_up(kv_valid, BS) // BS, nb)
        g = self._get_blocks(tier, list(block_ids[:live]))
        shape = (nb * BS, *self.device_pool.shape[3:])
        k = self.device_pool.new_zeros(shape)
        v = self.device_pool.new_zeros(shape)
        k[:live * BS] = g[:, :, 0].reshape(live * BS, *shape[1:])
        v[:live * BS] = g[:, :, 1].reshape(live * BS, *shape[1:])
        return k, v

    def copy_blocks(self, src_tier: str, dst_tier: str, src_ids, dst_ids):
        """Physical block copy between (or within) tiers: d2h/h2d
        transfers and copy-on-write duplication. Reads every source block
        before writing any destination (the reference's
        `dst.at[dst_ids].set(src[src_ids])`)."""
        src_ids, dst_ids = list(src_ids), list(dst_ids)
        if src_tier == dst_tier == "host":
            self._host_sync()
            si = torch.as_tensor(src_ids, dtype=torch.int64)
            di = torch.as_tensor(dst_ids, dtype=torch.int64)
            self.host_pool.index_copy_(0, di, self.host_pool[si])
            return
        blocks = self._get_blocks(src_tier, src_ids)
        self._put_blocks(dst_tier, dst_ids, blocks)

    # ------------------------------------------------------- chunked prefill
    def _chunk_forward(self, tokens, kbuf, vbuf, offset: int, kv_valid):
        """One prefill chunk at absolute token `offset` — the two-call
        chunk path. tokens: (C,) int64; kbuf/vbuf: (L, S_buf, KV, hd)
        dense prefix buffers on the device (rows >= offset ignored). The
        chunk's K/V are written into the buffers IN PLACE at rows
        [offset, offset + C) (the reference writes a copy), then each
        layer attends with q_offset = offset and kv_len = kv_valid.
        Returns (last-position logits, k_chunk, v_chunk) with chunk KV
        shaped (L, C, KV, hd)."""
        cfg, params = self.cfg, self.params
        C = tokens.shape[0]
        x = params["embed"][tokens][None]                    # (1, C, d)
        positions = offset + torch.arange(C, device=self.device)[None]
        if cfg.pos_emb == "mrope":
            positions = positions[None].expand(3, 1, C)
        ks_out, vs_out = [], []
        for l in range(cfg.n_layers):
            lp = layer_params(params["layers"], l)
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            q, k, v = layers.qkv_proj(cfg, lp["attn"], h)
            q = layers.apply_rope(cfg, q, positions)
            k = layers.apply_rope(cfg, k, positions)
            kbuf[l, offset:offset + C] = k[0]
            vbuf[l, offset:offset + C] = v[0]
            o = ops.flash_attention(q, kbuf[l][None], vbuf[l][None],
                                    causal=True, kv_len=kv_valid,
                                    q_offset=offset)
            x = x + layers.attn_out(cfg, lp["attn"], o)
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + ffn(cfg, lp, h)[0]
            ks_out.append(k[0])
            vs_out.append(v[0])
        x = layers.apply_norm(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = mask_pad_logits(cfg, x[0, -1] @ w)
        return logits, torch.stack(ks_out), torch.stack(vs_out)

    def prefill_chunk(self, chunk: List[int], offset: int, kbuf, vbuf):
        """Run `chunk` prompt tokens starting at `offset`. Returns
        (logits, k_chunk, v_chunk); logits stay on the device — the
        caller argmaxes them only on a request's FINAL chunk."""
        self._note_trace("chunk", (len(chunk), kbuf.shape[1]))
        logits, kc, vc = self._chunk_forward(
            self._to_device(chunk), kbuf, vbuf, offset,
            self._to_device([offset + len(chunk)], torch.int32))
        self._note_logits(logits)
        return logits, kc, vc

    # ----------------------------------------------------------- fused step
    def _host_scatter(self, runs, kv) -> None:
        """Write chunk rows' K/V (T, 2, KV, hd) into the HOST pool: one
        async copy per run (row_a, row_b, slot) of consecutive pool slots
        (slot = block * BS + offset), on the current stream."""
        hp = self.host_pool
        flat = hp.view(-1, *hp.shape[2:])                # (slots, 2, KV, hd)
        for a, b, slot in runs:
            flat[slot:slot + b - a].copy_(kv[a:b], non_blocking=True)

    @property
    def staging_bytes(self) -> int:
        """Device bytes the fused step's two staging buffers hold, from the
        first host-tier step for as long as the executor lives (outside
        the KV pools the block manager accounts for); 0 before."""
        st = self._staging
        return 0 if st is None else st.numel() * st.element_size()

    def _staging_buffers(self, n_blocks: int):
        """Two staging buffers of `n_blocks` pool blocks each, (2,
        n_blocks, BS, 2, KV, hd): views of one allocation made on the
        current stream and grown only when a step needs more."""
        if self._staging is None or self._staging.shape[1] < n_blocks:
            self._staging = None
            self._staging = self.device_pool.new_zeros(
                (2, n_blocks, *self.device_pool.shape[1:]))
        return self._staging[:, :n_blocks]

    def _mixed_forward(self, tokens, q_pos, off, blk_dev, host_runs, c_seg,
                       c_qpos, c_kvlens, c_tables, c_tier, d_tables,
                       d_kvlens, sample_idx, is_chunk, stage_runs, st_idx,
                       Tc: int, Rb: int):
        """ONE forward for a whole serving iteration: prefill-chunk tokens
        and decode tokens ride the same flat batch, so each layer's
        weights stream once. Per layer: project QKV for all T tokens,
        write the new K/V into the pool(s) at per-token (block, offset)
        slots, then attend straight over the pool. The flat batch is
        [chunk part (Tc rows, segment-padded to the query tile) | decode
        part (Rb rows)]: chunk rows go through the paged-prefill kernel,
        decode rows through the paged decode kernel.

        tokens/q_pos/off: (T,) flat batch; blk_dev: (L, T) device-pool
        write targets (trash block for rows that do not write the device
        tier); host_runs: per layer, the host-pool slot runs of the chunk
        rows whose layer is host-resident. Chunk part: c_seg/c_qpos (Tc,),
        c_kvlens (Sc,), c_tables (L, Sc, MAXBc), c_tier (L, Sc). Decode
        part: d_tables (L, Rb, MAXBd), d_kvlens (Rb,) cached tokens
        (attends ctx + 1 after the in-step write). sample_idx: (Sb,) flat
        row each output samples; is_chunk selects pad-vocab masking (chunk
        samples masked, decode samples raw, as the two-call paths do).
        stage_runs: per layer, None or the (R, 3) copy runs of its live
        host blocks (`paged_prefill.host_block_runs`); st_idx: (L, Tc) the
        staging-buffer row (slot * BS + offset) each chunk row of a
        host-tier layer writes, the trash block's first row for the rest.
        Writes the pools in place; returns (Sb, V) logits."""
        cfg, params = self.cfg, self.params
        dpool = self.device_pool
        T = tokens.shape[0]
        staging = _HostStaging(self, stage_runs, st_idx,
                               c_tables.shape[1] * c_tables.shape[2])
        x = params["embed"][tokens][None]                  # (1, T, d)
        positions = q_pos[None]                            # (1, T)
        if cfg.pos_emb == "mrope":
            positions = positions[None].expand(3, 1, T)
        for l in range(cfg.n_layers):
            staging.ahead(l)
            lp = layer_params(params["layers"], l)
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            q, k, v = layers.qkv_proj(cfg, lp["attn"], h)
            q = layers.apply_rope(cfg, q, positions)
            k = layers.apply_rope(cfg, k, positions)
            dpool[blk_dev[l], off, 0] = k[0].to(dpool.dtype)
            dpool[blk_dev[l], off, 1] = v[0].to(dpool.dtype)
            staged = staging.write(l, host_runs[l], k[0, :Tc], v[0, :Tc])
            parts = []
            if Tc:
                parts.append(ops.paged_prefill(
                    q[0, :Tc].contiguous(), dpool, c_tables[l], c_seg,
                    c_qpos, c_kvlens, staged=staged,
                    tier=None if staged is None else c_tier[l],
                    tq=MIXED_TQ))
                staging.read(l)
            if Rb:
                parts.append(ops.paged_attention(
                    q[0, Tc:].contiguous(), dpool, d_tables[l],
                    d_kvlens + 1))
            o = torch.cat(parts) if len(parts) > 1 else parts[0]
            x = x + layers.attn_out(cfg, lp["attn"], o[None])
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + ffn(cfg, lp, h)[0]
        x = layers.apply_norm(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x[0][sample_idx] @ w                      # (Sb, V)
        return torch.where(is_chunk[:, None], mask_pad_logits(cfg, logits),
                           logits)

    def mixed_step(self, chunks: List[MixedChunk],
                   decodes: List[MixedDecode]) -> List[int]:
        """Run one fused iteration: all prefill chunks + the decode batch
        in one forward (one weight stream). Chunk and decode K/V are
        written into the pools inside the step; attention reads the pools
        directly. Shapes are power-of-two bucketed (chunk rows Tc, chunk
        segments Sc, decode width Rb, output rows Sb; table widths round
        to 8 blocks) with padded rows writing the trash block. Returns
        the (n_chunks + n_decodes,) argmax'd next tokens (chunk rows are
        only meaningful for a request's final chunk)."""
        TQ = MIXED_TQ
        BS = self.block_size
        L = self.cfg.n_layers
        n_c, n_d = len(chunks), len(decodes)
        assert n_c + n_d > 0, "mixed_step needs at least one segment"
        pads = [_round_up(len(c.tokens), TQ) for c in chunks]
        Tc = _bucket(sum(pads), TQ) if n_c else 0
        Sc = _bucket(n_c) if n_c else 0
        Rb = _bucket(n_d) if n_d else 0
        Sb = _bucket(n_c + n_d)
        T = Tc + Rb
        MAXBc = _round_up(max((len(c.tables[0]) for c in chunks),
                              default=1), 8) if n_c else 0
        MAXBd = _round_up(max((len(d.tables[0]) for d in decodes),
                              default=1), 8) if n_d else 0

        tokens = np.zeros(T, np.int64)
        q_pos = np.zeros(T, np.int32)
        off = np.zeros(T, np.int64)
        blk_dev = np.full((L, T), self.num_device_blocks, np.int64)  # trash
        host_runs: List[list] = [[] for _ in range(L)]
        # staging-buffer rows of host-tier chunk rows; the rest write the
        # trash block after the Sc * MAXBc slots
        st_idx = np.full((L, Tc), Sc * MAXBc * BS, np.int64)
        c_seg = np.full(Tc, max(Sc - 1, 0), np.int32)
        c_tables = np.zeros((L, Sc, MAXBc), np.int32)
        c_tier = np.zeros((L, Sc), np.int32)
        c_kvlens = np.zeros(Sc, np.int32)
        d_tables = np.full((L, Rb, MAXBd), self.num_device_blocks, np.int32)
        d_kvlens = np.zeros(Rb, np.int32)
        sample_idx = np.zeros(Sb, np.int64)
        is_chunk = np.zeros(Sb, bool)

        t0 = 0
        for i, c in enumerate(chunks):
            C = len(c.tokens)
            tokens[t0:t0 + C] = c.tokens
            q_pos[t0:t0 + pads[i]] = c.offset + np.arange(pads[i])
            c_seg[t0:t0 + pads[i]] = i
            pos = c.offset + np.arange(C)
            off[t0:t0 + C] = pos % BS
            nb = len(c.tables[0])
            for l in range(L):
                lblk = np.asarray(c.tables[l], np.int64)
                c_tables[l, i, :nb] = lblk
                c_tier[l, i] = c.tiers[l]
                if c.tiers[l]:
                    slots = lblk[pos // BS] * BS + pos % BS
                    host_runs[l].extend((t0 + a, t0 + b, int(s0))
                                        for a, b, s0 in _runs(slots))
                    st_idx[l, t0:t0 + C] = (i * MAXBc + pos // BS) * BS \
                        + pos % BS
                else:
                    blk_dev[l, t0:t0 + C] = lblk[pos // BS]
            c_kvlens[i] = c.offset + C
            sample_idx[i] = t0 + C - 1
            is_chunk[i] = True
            t0 += pads[i]
        # chunk-part tail tiles: contiguous positions (a query tile's base
        # + row arithmetic stays valid); they map to the last chunk
        # segment slot (a kv_len=0 dummy when Sc > n_c), write only trash,
        # and their outputs are discarded
        q_pos[t0:Tc] = np.arange(Tc - t0)
        for j, d in enumerate(decodes):
            t = Tc + j
            tokens[t] = d.token
            q_pos[t] = d.ctx
            off[t] = d.ctx % BS
            nb = len(d.tables[0])
            for l in range(L):
                d_tables[l, j, :nb] = d.tables[l]
                blk_dev[l, t] = d.tables[l][d.ctx // BS]
            d_kvlens[j] = d.ctx
            sample_idx[n_c + j] = t
        has_host = bool(c_tier.any())
        self._note_trace("mixed", (Tc, Sc, Rb, Sb, MAXBc, MAXBd, has_host))
        # each host-tier layer's live host blocks as copy-engine runs
        stage_runs = [pp.host_block_runs(c_tables[l], c_kvlens, c_tier[l],
                                         BS, self.host_pool.shape[0])
                      if c_tier[l].any() else None for l in range(L)]
        dv = self._to_device
        logits = self._mixed_forward(
            dv(tokens), dv(q_pos, torch.int32), dv(off), dv(blk_dev),
            host_runs, dv(c_seg, torch.int32), dv(q_pos[:Tc], torch.int32),
            dv(c_kvlens, torch.int32), dv(c_tables, torch.int32),
            dv(c_tier, torch.int32), dv(d_tables, torch.int32),
            dv(d_kvlens, torch.int32), dv(sample_idx), dv(is_chunk,
                                                          torch.bool),
            stage_runs, dv(st_idx) if has_host else None, Tc, Rb)
        n = n_c + n_d
        self._note_logits(logits[:n])
        return torch.argmax(logits[:n], dim=-1).tolist()

    # --------------------------------------------------------------- decode
    def _paged_decode(self, tokens, tables, kv_lens):
        """tokens: (R,) int64; tables: (L, R, MAXB) int32 device block ids;
        kv_lens: (R,) int32 tokens already cached. Writes each layer's new
        K/V into the device pool in place; returns raw logits (the
        reference does not mask pad-vocab logits on the decode side)."""
        cfg, params = self.cfg, self.params
        BS = self.block_size
        R = tokens.shape[0]
        dpool = self.device_pool
        x = params["embed"][tokens][:, None]                 # (R, 1, d)
        positions = kv_lens[:, None]     # the new token's absolute position
        if cfg.pos_emb == "mrope":
            positions = positions[None].expand(3, R, 1)
        r_idx = torch.arange(R, device=self.device)
        lens64 = kv_lens.long()
        cur_block, cur_off = lens64 // BS, lens64 % BS
        attend = kv_lens + 1
        for l in range(cfg.n_layers):
            lp = layer_params(params["layers"], l)
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            q, k, v = layers.decode_self_attention(cfg, lp["attn"], h,
                                                   positions)
            # scatter the new token's KV into its block
            blk = tables[l][r_idx, cur_block].long()         # (R,)
            dpool[blk, cur_off, 0] = k[:, 0].to(dpool.dtype)
            dpool[blk, cur_off, 1] = v[:, 0].to(dpool.dtype)
            o = ops.paged_attention(q[:, 0], dpool, tables[l], attend)
            x = x + layers.attn_out(cfg, lp["attn"], o[:, None])
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + ffn(cfg, lp, h)[0]
        x = layers.apply_norm(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x[:, 0] @ w

    def decode(self, tokens: List[int], tables: np.ndarray,
               kv_lens: List[int]) -> List[int]:
        """One decode iteration. tables: (L, R, MAXB) int32 into the DEVICE
        pool (caller guarantees residency). The batch width R is padded to
        a power-of-two bucket and the table width MAXB to 8-block
        granularity; padded rows carry trash-block tables (kv_len 0)."""
        R = len(tokens)
        L, _, maxb = tables.shape
        Rb = _bucket(R)
        MAXBb = _round_up(max(maxb, 1), 8)
        self._note_trace("decode", (Rb, MAXBb))
        toks = np.zeros(Rb, np.int64)
        toks[:R] = tokens
        lens = np.zeros(Rb, np.int32)
        lens[:R] = kv_lens
        tab = np.full((L, Rb, MAXBb), self.num_device_blocks, np.int32)
        tab[:, :R, :maxb] = tables
        logits = self._paged_decode(self._to_device(toks),
                                    self._to_device(tab, torch.int32),
                                    self._to_device(lens, torch.int32))
        self._note_logits(logits[:R])
        return torch.argmax(logits[:R], dim=-1).tolist()
