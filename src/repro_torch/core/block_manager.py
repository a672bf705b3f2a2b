"""Layer-wise paged KV block allocator (paper §3.1.1-§3.1.2) with
ref-counted cross-request prefix caching (Apt-Serve-style hybrid sharing).

Two physical pools — DEVICE (GPU/TPU HBM) and HOST — each a flat set of
fixed-size blocks backed by one pooled tensor (paper §4: a single tensor so
any block can serve any layer of any request). On top, a block table maps
(request, layer, logical_block) -> (pool, physical_block). Residency is
tracked per (request, layer): a layer's KV lives wholly on one pool at a
time (the paper offloads whole layers), with per-layer interleaving chosen
by the offload engine.

Prefix caching (enabled with `prefix_cache=True`): every FULL block of a
prompt is content-addressed by the hash chain of its token ids, one cache
entry per (layer, chain-hash). A later request whose prompt shares the
token prefix maps the same physical blocks (refcount += 1 per mapping) and
skips prefill compute for the shared tokens. Sharing is full-block
granular; the block containing the first *recomputed* token is
copy-on-write: the new request gets a private copy of the cached block and
writes its recomputed tail there, never mutating the shared original.
Blocks whose refcount drops to 0 stay resident as reclaimable cache (LRU):
allocation prefers the free list, then evicts LRU unreferenced cache
blocks — demoting them to the HOST tier when it has room (hierarchical
context caching a la Strata) before dropping them outright. Physical
copies the cache decides on (COW, promotion, demotion) are surfaced
through the `on_copy` hook so the executor moves real bytes and the
simulator charges the link ledger — the manager itself stays logical.

Invariants (enforced + property-tested):
  * free + allocated == pool size, always (cache-retained blocks count as
    allocated);
  * an UNSHARED physical block belongs to at most one (request, layer);
    a shared block's table multiplicity equals its cache refcount;
  * a shared block is never freed or migrated while another request still
    references it;
  * copy-on-write never mutates the shared source block;
  * request state never references a freed block.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.units import Blocks, LayerIdx, Tokens, tokens_to_blocks

DEVICE = "device"
HOST = "host"

CACHE_OWNER = "<prefix-cache>"

# (src_pool, src_block, dst_pool, dst_block) -> None
CopyHook = Callable[[str, int, str, int], None]


class PoolExhausted(Exception):
    pass


class _Pool:
    def __init__(self, name: str, num_blocks: Blocks) -> None:
        self.name = name
        self.num_blocks: Blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owner: Dict[int, Tuple[str, int]] = {}  # block -> (req, layer)

    @property
    def num_free(self) -> Blocks:
        return len(self._free)

    def alloc(self, n: int, owner: Tuple[str, int]) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"{self.name}: want {n}, have {len(self._free)}")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._owner[b] = owner
        return blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._owner:
                raise KeyError(f"{self.name}: double free of block {b}")
            del self._owner[b]
            self._free.append(b)

    def chown(self, block: int, owner: Tuple[str, int]) -> None:
        assert block in self._owner, f"{self.name}: chown of free {block}"
        self._owner[block] = owner

    def check(self) -> None:
        assert len(self._free) + len(self._owner) == self.num_blocks
        assert set(self._free).isdisjoint(self._owner)


@dataclasses.dataclass
class LayerAllocation:
    pool: str                    # DEVICE or HOST
    blocks: List[int]            # physical ids, logical order
    num_tokens: Tokens = 0       # valid tokens written


@dataclasses.dataclass
class CachedBlock:
    """One content-addressed full block of prompt KV for one layer."""
    key: Tuple[int, int]         # (layer, chain hash)
    pool: str                    # current residency tier
    block: int                   # physical id in `pool`
    ref: int = 0                 # live (request, layer) mappings
    tick: int = 0                # LRU stamp, meaningful at ref == 0
    tokens: Optional[Tuple[int, ...]] = None  # this block's token ids —
    #   verified on match so a 64-bit chain-hash collision can never map
    #   another prompt's KV (stored once per layer-0 entry)


def block_hashes(tokens: Iterable[int], block_size: int) -> List[int]:
    """Chain hashes of the FULL blocks of a token sequence: block i's hash
    commits to every token in blocks 0..i, so equal hashes imply equal
    prefixes (CPython int/tuple hashing is deterministic in-process)."""
    toks = list(tokens)
    out: List[int] = []
    h = 0
    for s in range(0, len(toks) - block_size + 1, block_size):
        h = hash((h, tuple(toks[s:s + block_size])))
        out.append(h)
    return out


@dataclasses.dataclass
class PrefixAcquisition:
    """Result of mapping a cached prefix into a request's block tables.
    The physical copies were already issued through `on_copy`; the lists
    here are for accounting/tests."""
    cached_len: Tokens                            # prompt tokens skipped
    cow_copies: List[Tuple[int, int, int]]        # (layer, src, dst) d2d
    promotions: List[Tuple[int, int, int]]        # (layer, host src, dst)


class PrefixCache:
    """Content-addressed registry of full prompt blocks, per layer."""

    def __init__(self) -> None:
        self.entries: Dict[Tuple[int, int], CachedBlock] = {}
        self.by_block: Dict[Tuple[str, int], CachedBlock] = {}
        self._tick = 0
        # unreferenced (reclaimable) entries per pool in LRU order: CPython
        # dicts preserve insertion order, so popping the FIRST key is the
        # least-recently-unreferenced entry — every transition is O(1)
        # (a sorted scan here was the hot path of the whole simulator)
        self.lru: Dict[str, Dict[Tuple[int, int], CachedBlock]] = {
            DEVICE: {}, HOST: {}}
        # stats (token-granular so hit rate is meaningful)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.n_hits = 0
        self.n_lookups = 0

    def tick(self) -> int:
        self._tick += 1
        return self._tick

    def n_unref(self, pool: str) -> int:
        return len(self.lru[pool])

    def lookup(self, pool: str, block: int) -> Optional[CachedBlock]:
        return self.by_block.get((pool, block))

    def incref(self, e: CachedBlock) -> None:
        if e.ref == 0:
            del self.lru[e.pool][e.key]
        e.ref += 1

    def decref(self, e: CachedBlock) -> None:
        assert e.ref > 0
        e.ref -= 1
        if e.ref == 0:
            e.tick = self.tick()
            self.lru[e.pool][e.key] = e

    def add(self, key: Tuple[int, int], pool: str, block: int,
            ref: int, tokens: Optional[Tuple[int, ...]] = None
            ) -> CachedBlock:
        assert key not in self.entries
        e = CachedBlock(key, pool, block, ref, self.tick(), tokens)
        self.entries[key] = e
        self.by_block[(pool, block)] = e
        if ref == 0:
            self.lru[pool][key] = e
        return e

    def count(self, lookup_tokens: Tokens, hit_tokens: Tokens) -> None:
        """Record one admission's lookup — called ONCE per admitted
        request (not per retry), so hit_rate measures workload sharing."""
        self.lookup_tokens += lookup_tokens
        self.hit_tokens += hit_tokens
        self.n_lookups += 1
        self.n_hits += int(hit_tokens > 0)

    def relocate(self, e: CachedBlock, pool: str, block: int) -> None:
        del self.by_block[(e.pool, e.block)]
        if e.ref == 0:
            del self.lru[e.pool][e.key]
            self.lru[pool][e.key] = e
        e.pool, e.block = pool, block
        self.by_block[(pool, block)] = e

    def drop(self, e: CachedBlock) -> None:
        del self.entries[e.key]
        del self.by_block[(e.pool, e.block)]
        if e.ref == 0:
            del self.lru[e.pool][e.key]

    def pop_lru(self, pool: str) -> Optional[CachedBlock]:
        """Least-recently-unreferenced entry on `pool`, or None."""
        lru = self.lru[pool]
        if not lru:
            return None
        return next(iter(lru.values()))

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0


class LayerwiseBlockManager:
    """Per-layer block accounting for one engine replica."""

    def __init__(self, num_device_blocks: int, num_host_blocks: int,
                 block_size: int, n_layers: int,
                 prefix_cache: bool = False) -> None:
        self.block_size = block_size
        self.n_layers = n_layers
        self.pools = {DEVICE: _Pool(DEVICE, num_device_blocks),
                      HOST: _Pool(HOST, num_host_blocks)}
        # request -> layer -> LayerAllocation
        self.tables: Dict[str, Dict[int, LayerAllocation]] = {}
        self.cache: Optional[PrefixCache] = \
            PrefixCache() if prefix_cache else None
        # physical-copy hook: the executor moves the bytes, the simulator
        # charges the link ledger. No-op by default (pure accounting runs).
        self.on_copy: Optional[CopyHook] = None
        # prompt-object -> hash chain memo: the scheduler probes the same
        # immutable prompt many times per iteration (admission estimates,
        # device-need gates, per-chunk registration) — hash it once
        self._hash_memo: Dict[int, Tuple[list, List[int]]] = {}

    # ------------------------------------------------------------- queries
    def num_free(self, pool: str = DEVICE) -> Blocks:
        """Allocatable blocks: the free list plus unreferenced cache blocks
        (reclaimed on demand inside `_alloc_blocks`)."""
        n = self.pools[pool].num_free
        if self.cache is not None:
            n += self.cache.n_unref(pool)
        return n

    def blocks_for_tokens(self, n_tokens: Tokens) -> Blocks:
        return tokens_to_blocks(n_tokens, self.block_size)

    def request_blocks(self, n_tokens: Tokens,
                       n_layers: Optional[int] = None) -> Blocks:
        """Blocks needed to hold `n_tokens` of KV for `n_layers` layers
        (request-wise baseline passes n_layers = all)."""
        L = self.n_layers if n_layers is None else n_layers
        return self.blocks_for_tokens(n_tokens) * L

    def layers_on(self, req: str, pool: str) -> List[int]:
        return [l for l, a in self.tables.get(req, {}).items()
                if a.pool == pool]

    def allocation(self, req: str, layer: LayerIdx) -> LayerAllocation:
        return self.tables[req][layer]

    def live_requests(self) -> List[str]:
        return list(self.tables)

    def layer_shared(self, req: str, layer: LayerIdx) -> bool:
        """True when any block of (req, layer) is also referenced by
        another live request — such layers must not migrate or be evicted
        out from under the sharer."""
        if self.cache is None:
            return False
        a = self.tables[req][layer]
        for b in a.blocks:
            e = self.cache.lookup(a.pool, b)
            if e is not None and e.ref > 1:
                return True
        return False

    # ---------------------------------------------------------- allocation
    def can_alloc(self, n_blocks: Blocks, pool: str = DEVICE) -> bool:
        return self.num_free(pool) >= n_blocks

    def _copy(self, src_pool: str, src: int, dst_pool: str,
              dst: int) -> None:
        if self.on_copy is not None:
            self.on_copy(src_pool, src, dst_pool, dst)

    def _alloc_blocks(self, pool: str, n: int, owner: Tuple[str, int]
                      ) -> List[int]:
        """Pool allocation that reclaims LRU unreferenced cache blocks when
        the free list runs short. Reclaimed DEVICE blocks are demoted to
        the HOST tier while it has room (their cached KV survives there);
        otherwise the entry is dropped."""
        p = self.pools[pool]
        if self.cache is not None and p.num_free < n:
            host = self.pools[HOST]
            while p.num_free < n:
                e = self.cache.pop_lru(pool)
                if e is None:
                    break
                if pool == DEVICE and host.num_free > 0:
                    (dst,) = host.alloc(1, (CACHE_OWNER, e.key[0]))
                    self._copy(DEVICE, e.block, HOST, dst)
                    p.free([e.block])
                    self.cache.relocate(e, HOST, dst)
                else:
                    p.free([e.block])
                    self.cache.drop(e)
        return p.alloc(n, owner)

    def alloc_layer(self, req: str, layer: LayerIdx, n_tokens: Tokens,
                    pool: str = DEVICE) -> LayerAllocation:
        assert 0 <= layer < self.n_layers
        tbl = self.tables.setdefault(req, {})
        assert layer not in tbl, f"{req} layer {layer} already allocated"
        n = self.blocks_for_tokens(n_tokens)
        blocks = self._alloc_blocks(pool, n, (req, layer))
        alloc = LayerAllocation(pool, blocks, n_tokens)
        tbl[layer] = alloc
        return alloc

    def extend_layer(self, req: str, layer: LayerIdx,
                     n_new_tokens: Tokens = 1) -> LayerAllocation:
        """Grow a layer's allocation for newly decoded tokens (same pool)."""
        a = self.tables[req][layer]
        need = self.blocks_for_tokens(a.num_tokens + n_new_tokens) \
            - len(a.blocks)
        if need > 0:
            a.blocks.extend(self._alloc_blocks(a.pool, need, (req, layer)))
        a.num_tokens += n_new_tokens
        return a

    # -------------------------------------------------------- prefix cache
    def _hashes(self, tokens: List[int]) -> List[int]:
        """Memoized chain hashes of `tokens` (prompts are immutable; the
        chain for a prefix is a prefix of the chain)."""
        key = id(tokens)
        hit = self._hash_memo.get(key)
        if hit is not None and hit[0] is tokens:
            return hit[1]
        if len(self._hash_memo) > 4096:
            self._hash_memo.clear()
        hs = block_hashes(tokens, self.block_size)
        self._hash_memo[key] = (tokens, hs)
        return hs

    def match_prefix(self, tokens: Optional[List[int]]) -> Tokens:
        """Longest cached prompt prefix, in tokens. Full-block granular,
        capped at len(tokens)-1 so at least one token is always recomputed
        (its logits produce the first output token). A block counts as
        cached only when ALL layers hold an entry for it — prefill compute
        is skipped for all layers at once or not at all. The stored token
        ids are compared on match, so a chain-hash collision degrades to a
        miss instead of mapping another prompt's KV. Stat counting lives
        in PrefixCache.count (once per admission, not per probe)."""
        if self.cache is None or not tokens:
            return 0
        BS = self.block_size
        matched = 0
        for i, h in enumerate(self._hashes(tokens)):
            e0 = self.cache.entries.get((0, h))
            if e0 is None or any((l, h) not in self.cache.entries
                                 for l in range(1, self.n_layers)):
                break
            if e0.tokens is not None \
                    and e0.tokens != tuple(tokens[i * BS:(i + 1) * BS]):
                break  # 64-bit collision: verify, never trust
            matched += BS
        return min(matched, len(tokens) - 1)

    def acquire_prefix(self, req: str, tokens: List[int]
                       ) -> Optional[PrefixAcquisition]:
        """Map the cached prefix of `tokens` into `req`'s tables (all
        layers, DEVICE tier) and allocate nothing else; the caller then
        extends each layer with the uncached suffix. Returns None on a
        miss or when the device pool cannot host the promotions/COW
        copies; a None return leaves every pool and refcount as it found
        them.

        Per needed entry, three resolutions:
          * device-resident, fully reused     -> map the block, ref += 1;
          * device-resident, partial tail     -> COW: private d2d copy;
          * host-resident. If cache-owned (no live mapper) the entry is
            PROMOTED back to device and shared; if a live request still
            maps it on the host tier (it was detach-evicted there), the
            acquirer gets a private h2d copy instead — the mapper's block
            is never freed or relocated out from under it."""
        assert req not in self.tables, f"{req} already has allocations"
        cached_len = self.match_prefix(tokens)
        if cached_len <= 0:
            return None
        n_shared = cached_len // self.block_size       # fully shared blocks
        tail = cached_len % self.block_size            # tokens COW-reused
        n_used = n_shared + (1 if tail else 0)
        hashes = self._hashes(tokens)
        # Pin every entry we are about to touch: a pinned (ref > 0) entry
        # can neither be reclaimed nor demoted by the allocations below.
        pinned: List[CachedBlock] = []
        for l in range(self.n_layers):
            for i in range(n_used):
                e = self.cache.entries[(l, hashes[i])]
                self.cache.incref(e)
                pinned.append(e)
        cow: List[Tuple[int, int, int]] = []
        promos: List[Tuple[int, int, int]] = []
        unpin: List[CachedBlock] = []    # resolved private: pin is dropped
        private: List[int] = []          # device blocks to free on rollback

        def _resolve(e: CachedBlock, l: int, want_private: bool) -> int:
            if e.pool == HOST and e.ref > 1:
                # a live request maps this block on host (post-detach):
                # private h2d copy, never disturb the mapper
                (dst,) = self._alloc_blocks(DEVICE, 1, (req, l))
                self._copy(HOST, e.block, DEVICE, dst)
                promos.append((l, e.block, dst))
                unpin.append(e)
                private.append(dst)
                return dst
            if e.pool == HOST:
                # cache-owned (our pin is the only ref): promote the entry
                (dst,) = self._alloc_blocks(DEVICE, 1, (CACHE_OWNER, l))
                self._copy(HOST, e.block, DEVICE, dst)
                promos.append((l, e.block, dst))
                self.pools[HOST].free([e.block])
                self.cache.relocate(e, DEVICE, dst)
            if not want_private:
                return e.block
            # copy-on-write: private copy of the partially-reused cached
            # block; the recomputed tokens [cached_len, block end) land in
            # the copy, never in the shared original
            (dst,) = self._alloc_blocks(DEVICE, 1, (req, l))
            self._copy(DEVICE, e.block, DEVICE, dst)
            cow.append((l, e.block, dst))
            unpin.append(e)
            private.append(dst)
            return dst

        tbl: Dict[int, LayerAllocation] = {}
        try:
            for l in range(self.n_layers):
                blocks: List[int] = []
                for i in range(n_shared):
                    e = self.cache.entries[(l, hashes[i])]
                    blocks.append(_resolve(e, l, want_private=False))
                if tail:
                    e = self.cache.entries[(l, hashes[n_shared])]
                    blocks.append(_resolve(e, l, want_private=True))
                tbl[l] = LayerAllocation(DEVICE, blocks, cached_len)
        except PoolExhausted:
            # roll back refs and private copies; promotions already
            # physically copied stay coherent (the entry moved tiers)
            for e in pinned:
                self.cache.decref(e)
            for dst in private:
                self.pools[DEVICE].free([dst])
            return None
        for e in unpin:
            self.cache.decref(e)
        self.tables[req] = tbl
        return PrefixAcquisition(cached_len, cow, promos)

    def register_prefix(self, req: str, tokens: List[int],
                        upto: Optional[Tokens] = None) -> Blocks:
        """Publish `req`'s full prompt blocks into the cache, for the
        blocks wholly inside [0, upto) (default: the whole prompt) — call
        as their KV is written (chunked prefill registers incrementally).
        Hashes already present are skipped — when `req` acquired them, its
        mapping was counted at acquire time. Returns #blocks newly
        cached."""
        if self.cache is None or req not in self.tables:
            return 0
        BS = self.block_size
        hashes = self._hashes(tokens)
        n_full = len(hashes) if upto is None \
            else min(len(hashes), upto // BS)
        added = 0
        for l, a in self.tables[req].items():
            for i in range(n_full):
                if i >= len(a.blocks):
                    break
                h = hashes[i]
                if (l, h) in self.cache.entries:
                    continue
                b = a.blocks[i]
                if self.cache.lookup(a.pool, b) is not None:
                    continue  # block already published under another key
                chunk = tuple(tokens[i * BS:(i + 1) * BS]) if l == 0 \
                    else None
                self.cache.add((l, h), a.pool, b, ref=1, tokens=chunk)
                added += 1
        return added

    # ----------------------------------------------------------- migration
    def move_layer(self, req: str, layer: LayerIdx, to_pool: str,
                   detach: bool = False) -> Tuple[List[int], List[int]]:
        """Migrate one layer's KV between pools. Returns (src_blocks,
        dst_blocks) so the caller can issue the physical copies; accounting
        is updated immediately (the engine's transfer ledger owns timing).

        Cache entries owned solely by `req` follow the move. Blocks SHARED
        with another live request are never pulled out from under the
        sharer: with `detach=False` such a layer refuses to migrate;
        eviction paths pass `detach=True`, which COPIES the shared blocks
        out (the request gets private replicas on `to_pool`, its refcounts
        drop, the shared originals stay where the sharers map them)."""
        a = self.tables[req][layer]
        if a.pool == to_pool:
            return (a.blocks, a.blocks)
        if self.layer_shared(req, layer) and not detach:
            raise ValueError(
                f"layer {layer} of {req} holds shared blocks; migration "
                "would pull them out from under another request "
                "(pass detach=True to copy them out)")
        src = list(a.blocks)
        dst = self._alloc_blocks(to_pool, len(src), (req, layer))
        for s, d in zip(src, dst, strict=True):
            e = self.cache.lookup(a.pool, s) \
                if self.cache is not None else None
            if e is not None and e.ref > 1:
                # copy-out: the shared source block survives untouched
                self.cache.decref(e)
                continue
            if e is not None:
                self.cache.relocate(e, to_pool, d)
            self.pools[a.pool].free([s])
        a.pool, a.blocks = to_pool, dst
        return src, dst

    # ------------------------------------------------------------- release
    def free_request(self, req: str) -> Blocks:
        """Release every block of a finished request. Cache-registered
        blocks are decref'd and retained (reclaimable LRU) instead of
        freed. Returns #blocks made available on DEVICE (free or
        reclaimable — feeds Eq.5 Released(t))."""
        tbl = self.tables.pop(req, {})
        dev_freed = 0
        for l, a in tbl.items():
            for b in a.blocks:
                e = self.cache.lookup(a.pool, b) \
                    if self.cache is not None else None
                if e is not None and e.ref > 0:
                    self.cache.decref(e)
                    if e.ref == 0:
                        self.pools[a.pool].chown(b, (CACHE_OWNER, l))
                        if a.pool == DEVICE:
                            dev_freed += 1  # reclaimable on demand
                    continue
                self.pools[a.pool].free([b])
                if a.pool == DEVICE:
                    dev_freed += 1
        return dev_freed

    def drop_cache(self) -> Blocks:
        """Drop every unreferenced cache entry (test/maintenance hook)."""
        if self.cache is None:
            return 0
        n = 0
        for e in list(self.cache.entries.values()):
            if e.ref == 0:
                self.pools[e.pool].free([e.block])
                self.cache.drop(e)
                n += 1
        return n

    def check(self) -> None:
        for p in self.pools.values():
            p.check()
        # table multiplicity of every physical block
        mult: Dict[Tuple[str, int], int] = {}
        for req, tbl in self.tables.items():
            for layer, a in tbl.items():
                for b in a.blocks:
                    mult[(a.pool, b)] = mult.get((a.pool, b), 0) + 1
        for key, m in mult.items():
            e = self.cache.lookup(*key) if self.cache is not None else None
            if e is None:
                assert m == 1, f"block {key} double-owned"
            else:
                assert m == e.ref, \
                    f"block {key}: {m} mappings but refcount {e.ref}"
        if self.cache is not None:
            for pool in (DEVICE, HOST):
                unref = {e.key for e in self.cache.entries.values()
                         if e.pool == pool and e.ref == 0}
                assert unref == set(self.cache.lru[pool]), \
                    f"{pool}: LRU index out of sync with entries"
            for e in self.cache.entries.values():
                key = (e.pool, e.block)
                assert e.ref == mult.get(key, 0), \
                    f"cache entry {e.key}: refcount {e.ref} but " \
                    f"{mult.get(key, 0)} mappings"
                # cached blocks are always pool-allocated, never free
                assert key[1] in self.pools[e.pool]._owner, \
                    f"cache entry {e.key} points at freed block {key}"
