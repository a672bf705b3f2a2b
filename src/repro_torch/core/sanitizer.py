"""Opt-in runtime KV-accounting sanitizer (``ServeConfig.sanitize``).

The block manager, prefix cache, and transfer ledger each keep their own
books; the identity/property tests check those books at *run end*. The
sanitizer turns that into "every intermediate state is consistent": it
interposes on the mutation API of one `LayerwiseBlockManager` (pool
alloc/free/chown, cache incref/decref/add/drop/relocate, `move_layer`,
the `_copy` hook) and the `LinkLedger.submit` path, maintains an
INDEPENDENT shadow model from the observed event stream, and compares
shadow against reality after every scheduler step on either backend.

Invariants checked (see docs/ARCHITECTURE.md "Invariants & analysis"):

  S1  pool mirror        shadow owner map == pool._owner and shadow free
                         count == len(pool._free), per pool — a mutation
                         that bypassed the pool API (or a double
                         accounting inside it) diverges the mirror;
  S2  conservation       free + owned == pool size, per pool, where
                         owned splits into live (request, layer) mappings
                         and CACHE_OWNER-retained ref==0 blocks;
  S3  single tier        every block of a (request, layer) allocation is
                         owned in exactly the allocation's pool; a block
                         is never simultaneously free and owned;
  S4  refcounts          shadow refcount == cache entry refcount == live
                         table multiplicity, for every cache entry, and
                         never negative (a decref below zero raises at
                         the event, not at the next check);
  S5  ledger h2d         cumulative "reload" bytes == bytes implied by
                         shadow-observed host->device layer movements and
                         cache promotions (every h2d charge in the stack
                         is movement-driven, so this is an equality);
  S6  ledger d2h         cumulative "offload" bytes >= bytes implied by
                         shadow-observed device->host movements (prefill
                         d2h STREAMING of freshly produced KV is charged
                         on top of movements, so d2h is one-sided);
  S7  phase/queue        every live request sits in exactly the
                         SchedulerCore queue its Phase names
                         (scheduler.PHASE_QUEUES — the same registry the
                         PHASE001 lint rule keeps total over the enum),
                         and every block table belongs to a live request;
  S8  baseline           with no live requests, both pools are back to
                         baseline: nothing owned except ref==0 cache
                         retentions (cancel/preempt/resume unwound
                         everything they touched);
  S9  recovery baseline  after a replica kill unwinds every request the
                         dead replica owned (`ClusterSession.kill`), the
                         core must be FULLY at baseline — no live
                         requests in any queue, no block tables, nothing
                         owned by non-cache owners, all cache refcounts
                         zero — before any work is re-dispatched
                         (`check_recovery_baseline`, an unconditional
                         strict form of S8).

Cost discipline — ``check`` runs after EVERY scheduler step, so it is
tiered: the count/conservation halves of S1/S2, the ledger totals
(S5/S6), and the phase/queue scan (S7) are O(pools + live requests) and
run on every call; the deep structural comparison (owner-map equality,
the full table walk behind S3/S4, per-entry refcounts) is O(mapped
blocks) and runs every ``check_interval`` steps, whenever the core goes
idle (so S8 always sees a deep-checked baseline), and on
``check(core, full=True)``.  Mutation-time traps (double free, negative
refcount) fire at the offending event regardless of cadence.  The full
free-list/owner disjointness scan (part of S3) is additionally skipped
for pools larger than ``FULL_SCAN_MAX_BLOCKS`` (the sim's default host
pool is 2^20 blocks); S1/S2 still catch free-list corruption there via
counts and the owner mirror.

Test hooks: ``inject_double_free`` / ``inject_refcount_leak`` /
``inject_ledger_mismatch`` plant exactly the historical bug classes the
sanitizer exists for, bypassing the structure's own guards the way a
buggy caller would; a regression test asserts ``check()`` catches each.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from repro_torch.core.block_manager import (
    CACHE_OWNER, DEVICE, HOST, CachedBlock, LayerwiseBlockManager, _Pool,
)
from repro_torch.core.offload_engine import OffloadEngine

if TYPE_CHECKING:  # pragma: no cover - import cycle (scheduler -> here)
    from repro_torch.serving.costmodel import CostModel
    from repro_torch.serving.scheduler import SchedulerCore

# pools at or under this size get the full free-list/owner disjointness
# scan every step; larger pools rely on the owner mirror + counts
FULL_SCAN_MAX_BLOCKS = 8192


class SanitizerError(AssertionError):
    """An accounting invariant broke. Carries the invariant id (S1..S9)
    in the message so regression tests can pin which check fired."""


class _ShadowPool:
    """Event-sourced mirror of one `_Pool`: owner map + free count,
    updated ONLY from intercepted alloc/free/chown calls."""

    def __init__(self, pool: _Pool):
        self.name = pool.name
        self.total = pool.num_blocks
        self.free_count = pool.num_free
        self.owner: Dict[int, Tuple[str, int]] = dict(pool._owner)


class KVSanitizer:
    """Shadow-tracks one block manager + offload engine. Construct once
    per `SchedulerCore` (both backends); call `check(core)` after each
    scheduler step."""

    # deep structural comparison cadence (see module docstring)
    check_interval = 16

    def __init__(self, bm: LayerwiseBlockManager, off: OffloadEngine,
                 cost: "CostModel"):
        self.bm = bm
        self.off = off
        self.cost = cost
        self.n_checks = 0
        self.n_full_checks = 0
        self.n_events = 0
        self.shadow_pools = {name: _ShadowPool(p)
                             for name, p in bm.pools.items()}
        # cache key -> shadow refcount (entries mirrored at install time)
        self.shadow_refs: Dict[Tuple[int, int], int] = {}
        if bm.cache is not None:
            self.shadow_refs = {k: e.ref for k, e in bm.cache.entries.items()}
        # ledger accounting: bytes the ledger charged per direction vs
        # bytes the observed layer movements imply
        self.charged_h2d = 0.0
        self.charged_d2h = 0.0
        self.expected_h2d = 0.0
        self.expected_d2h = 0.0
        self._install()

    # ------------------------------------------------------------ wiring
    def _install(self) -> None:
        for pool in self.bm.pools.values():
            self._wrap_pool(pool)
        if self.bm.cache is not None:
            self._wrap_cache()
        self._wrap_moves()
        self._wrap_ledger()

    def _wrap_pool(self, pool: _Pool) -> None:
        sp = self.shadow_pools[pool.name]
        orig_alloc, orig_free, orig_chown = pool.alloc, pool.free, pool.chown

        def alloc(n: int, owner: Tuple[str, int]) -> List[int]:
            blocks = orig_alloc(n, owner)
            self.n_events += 1
            sp.free_count -= len(blocks)
            for b in blocks:
                if b in sp.owner:
                    raise SanitizerError(
                        f"S1 {sp.name}: alloc handed out owned block {b}")
                sp.owner[b] = owner
            return blocks

        def free(blocks: List[int]) -> None:
            # shadow first: a double free must be caught even if the
            # pool's own guard were broken (that guard is the bug class)
            self.n_events += 1
            for b in blocks:
                if b not in sp.owner:
                    raise SanitizerError(
                        f"S1 {sp.name}: free of unowned block {b} "
                        "(double free)")
                del sp.owner[b]
                sp.free_count += 1
            orig_free(blocks)

        def chown(block: int, owner: Tuple[str, int]) -> None:
            self.n_events += 1
            if block not in sp.owner:
                raise SanitizerError(
                    f"S1 {sp.name}: chown of free block {block}")
            sp.owner[block] = owner
            orig_chown(block, owner)

        pool.alloc, pool.free, pool.chown = alloc, free, chown

    def _wrap_cache(self) -> None:
        cache = self.bm.cache
        refs = self.shadow_refs
        orig = {m: getattr(cache, m)
                for m in ("incref", "decref", "add", "drop")}

        def incref(e: CachedBlock) -> None:
            self.n_events += 1
            refs[e.key] = refs.get(e.key, 0) + 1
            orig["incref"](e)

        def decref(e: CachedBlock) -> None:
            self.n_events += 1
            if refs.get(e.key, 0) <= 0:
                raise SanitizerError(
                    f"S4 cache entry {e.key}: refcount would drop below "
                    "zero")
            refs[e.key] -= 1
            orig["decref"](e)

        def add(key, pool, block, ref, tokens=None) -> CachedBlock:
            self.n_events += 1
            refs[key] = ref
            return orig["add"](key, pool, block, ref, tokens)

        def drop(e: CachedBlock) -> None:
            self.n_events += 1
            refs.pop(e.key, None)
            orig["drop"](e)

        cache.incref, cache.decref = incref, decref
        cache.add, cache.drop = add, drop

    def _wrap_moves(self) -> None:
        bm = self.bm
        orig_move, orig_copy = bm.move_layer, bm._copy

        def move_layer(req: str, layer: int, to_pool: str,
                       detach: bool = False):
            a = bm.tables[req][layer]
            crossed = a.pool != to_pool
            nbytes = self.cost.kv_bytes(a.num_tokens, 1) if crossed else 0.0
            from_pool = a.pool
            out = orig_move(req, layer, to_pool, detach=detach)
            if crossed:
                self.n_events += 1
                if from_pool == HOST and to_pool == DEVICE:
                    self.expected_h2d += nbytes
                elif from_pool == DEVICE and to_pool == HOST:
                    self.expected_d2h += nbytes
            return out

        def _copy(src_pool: str, src: int, dst_pool: str, dst: int):
            # charges only flow when a copy hook is installed
            # (SchedulerCore.cache_copy); d2d COW never touches the link
            if bm.on_copy is not None and src_pool != dst_pool:
                self.n_events += 1
                nbytes = self.cost.kv_bytes(bm.block_size, 1)
                if src_pool == HOST and dst_pool == DEVICE:
                    self.expected_h2d += nbytes
                else:
                    self.expected_d2h += nbytes
            orig_copy(src_pool, src, dst_pool, dst)

        bm.move_layer, bm._copy = move_layer, _copy

    def _wrap_ledger(self) -> None:
        ledger = self.off.ledger
        orig_submit = ledger.submit

        def submit(now: float, nbytes: float, kind: str) -> float:
            self.n_events += 1
            if kind == "reload":
                self.charged_h2d += nbytes
            else:
                self.charged_d2h += nbytes
            return orig_submit(now, nbytes, kind)

        ledger.submit = submit

    # ------------------------------------------------------------ checks
    @staticmethod
    def _fail(msg: str) -> None:
        raise SanitizerError(msg)

    def _check_counts(self) -> None:
        """Every-step S1/S2 skim: count-level mirror + conservation,
        O(number of pools)."""
        for name, pool in self.bm.pools.items():
            sp = self.shadow_pools[name]
            if sp.free_count != pool.num_free:
                self._fail(
                    f"S1 {name}: shadow free count {sp.free_count} != "
                    f"pool free list {pool.num_free}")
            if len(sp.owner) != len(pool._owner):
                self._fail(
                    f"S1 {name}: shadow owns {len(sp.owner)} blocks, "
                    f"pool owns {len(pool._owner)}")
            if sp.free_count + len(sp.owner) != sp.total:
                self._fail(
                    f"S2 {name}: free {sp.free_count} + owned "
                    f"{len(sp.owner)} != pool size {sp.total}")

    def _check_pools(self) -> Dict[Tuple[str, int], Tuple[str, int]]:
        """S1-S3 pool side; returns the combined (pool, block) -> owner
        map for the table checks."""
        owners: Dict[Tuple[str, int], Tuple[str, int]] = {}
        for name, pool in self.bm.pools.items():
            sp = self.shadow_pools[name]
            if sp.owner != pool._owner:
                only_s = set(sp.owner) - set(pool._owner)
                only_p = set(pool._owner) - set(sp.owner)
                self._fail(
                    f"S1 {name}: shadow owner map diverged from pool "
                    f"(shadow-only {sorted(only_s)[:4]}, pool-only "
                    f"{sorted(only_p)[:4]})")
            if sp.free_count != pool.num_free:
                self._fail(
                    f"S1 {name}: shadow free count {sp.free_count} != "
                    f"pool free list {pool.num_free}")
            if sp.free_count + len(sp.owner) != sp.total:
                self._fail(
                    f"S2 {name}: free {sp.free_count} + owned "
                    f"{len(sp.owner)} != pool size {sp.total}")
            if sp.total <= FULL_SCAN_MAX_BLOCKS:
                free_set = set(pool._free)
                if len(free_set) != pool.num_free:
                    self._fail(f"S3 {name}: duplicate ids on the free list")
                inter = free_set & set(pool._owner)
                if inter:
                    self._fail(
                        f"S3 {name}: blocks {sorted(inter)[:4]} are both "
                        "free and owned")
            for b, owner in sp.owner.items():
                owners[(name, b)] = owner
        return owners

    def _check_tables(
            self, owners: Dict[Tuple[str, int], Tuple[str, int]]
    ) -> Dict[Tuple[str, int], int]:
        """S3/S4 table side; returns live multiplicity per block."""
        cache = self.bm.cache
        mult: Dict[Tuple[str, int], int] = {}
        for req, tbl in self.bm.tables.items():
            for layer, a in tbl.items():
                for b in a.blocks:
                    key = (a.pool, b)
                    mult[key] = mult.get(key, 0) + 1
                    if key not in owners:
                        self._fail(
                            f"S3 {req} layer {layer}: maps block {b} on "
                            f"{a.pool} but the pool does not own it "
                            "(freed or wrong tier)")
                    if cache is None or cache.lookup(a.pool, b) is None:
                        if owners[key] != (req, layer):
                            self._fail(
                                f"S3 uncached block {key} mapped by "
                                f"({req}, {layer}) but owned by "
                                f"{owners[key]}")
        for key, m in mult.items():
            e = cache.lookup(*key) if cache is not None else None
            if e is None and m != 1:
                self._fail(f"S3 uncached block {key} mapped {m} times")
        return mult

    def _check_cache(self, mult: Dict[Tuple[str, int], int]) -> int:
        """S4 + the cache half of S2; returns #cache-retained blocks."""
        cache = self.bm.cache
        if cache is None:
            if self.shadow_refs:
                self._fail("S4 shadow has refs but the cache is off")
            return 0
        if set(self.shadow_refs) != set(cache.entries):
            self._fail(
                "S4 shadow entry set diverged from the cache "
                f"({len(self.shadow_refs)} shadow vs "
                f"{len(cache.entries)} actual)")
        retained = 0
        for key, e in cache.entries.items():
            sref = self.shadow_refs[key]
            if sref < 0:
                self._fail(f"S4 cache entry {key}: negative shadow "
                           f"refcount {sref}")
            if sref != e.ref:
                self._fail(
                    f"S4 cache entry {key}: shadow refcount {sref} != "
                    f"entry refcount {e.ref}")
            if e.ref != mult.get((e.pool, e.block), 0):
                self._fail(
                    f"S4 cache entry {key}: refcount {e.ref} but "
                    f"{mult.get((e.pool, e.block), 0)} live mappings")
            if e.ref == 0:
                retained += 1
        return retained

    def _check_ledger(self) -> None:
        if not math.isclose(self.charged_h2d, self.expected_h2d,
                            rel_tol=1e-9, abs_tol=1.0):
            self._fail(
                f"S5 ledger reload bytes {self.charged_h2d:.0f} != "
                f"shadow-observed h2d movement bytes "
                f"{self.expected_h2d:.0f}")
        if self.charged_d2h < self.expected_d2h - 1.0:
            self._fail(
                f"S6 ledger offload bytes {self.charged_d2h:.0f} < "
                f"shadow-observed d2h movement bytes "
                f"{self.expected_d2h:.0f} (a movement went uncharged)")

    def _check_lifecycle(self, core: "SchedulerCore") -> None:
        from repro_torch.serving.scheduler import LIVE_QUEUES, PHASE_QUEUES
        live_rids = set()
        for phase, qname in PHASE_QUEUES.items():
            for r in getattr(core, qname):
                if r.phase is not phase:
                    self._fail(
                        f"S7 request {r.rid} sits in '{qname}' but its "
                        f"phase is {r.phase.name} (expected {phase.name})")
                if qname in LIVE_QUEUES:
                    live_rids.add(r.rid)
        stray = set(self.bm.tables) - live_rids
        if stray:
            self._fail(
                f"S7 block tables for {sorted(stray)[:4]} but no live "
                "request owns them (leak on a retire/cancel path)")

    def _check_baseline(self, core: "SchedulerCore") -> None:
        if core.prefilling or core.decoding or core.paused \
                or self.bm.tables:
            return
        for name, sp in self.shadow_pools.items():
            non_cache = [b for b, (req, _) in sp.owner.items()
                         if req != CACHE_OWNER]
            if non_cache:
                self._fail(
                    f"S8 {name}: idle core but blocks "
                    f"{sorted(non_cache)[:4]} are still owned by "
                    "non-cache owners (unwind leaked them)")
        for key, ref in self.shadow_refs.items():
            if ref != 0:
                self._fail(
                    f"S8 cache entry {key}: idle core but refcount {ref}")

    def check_recovery_baseline(self, core: "SchedulerCore") -> None:
        """S9: post-kill pool accounting. `ClusterSession.kill` calls
        this after unwinding everything the dead replica owned and
        before re-dispatching any of it — unlike S8 (which silently
        skips while anything looks live), a non-empty queue or a
        leftover block table here IS the failure: the kill path missed
        something, and re-dispatch would double-account it."""
        for qname in ("waiting", "prefilling", "decoding", "paused"):
            q = getattr(core, qname)
            if q:
                self._fail(
                    f"S9 recovery: '{qname}' still holds "
                    f"{[r.rid for r in q][:4]} after the kill unwind")
        if self.bm.tables:
            self._fail(
                f"S9 recovery: block tables survive for "
                f"{sorted(self.bm.tables)[:4]} (KV not freed)")
        for name, sp in self.shadow_pools.items():
            non_cache = [b for b, (req, _) in sp.owner.items()
                         if req != CACHE_OWNER]
            if non_cache:
                self._fail(
                    f"S9 recovery: {name} blocks {sorted(non_cache)[:4]} "
                    "still owned by non-cache owners")
        for key, ref in self.shadow_refs.items():
            if ref != 0:
                self._fail(
                    f"S9 recovery: cache entry {key} refcount {ref} != 0")

    def check(self, core: Optional["SchedulerCore"] = None,
              full: Optional[bool] = None) -> None:
        """Assert the invariants against the current state. Called by
        the backends after each step. ``full=None`` lets the cadence
        decide (every ``check_interval``-th call, or whenever the core
        is idle); ``full=True`` forces the deep structural comparison
        (tests use this), ``full=False`` forces the cheap tier only."""
        self.n_checks += 1
        self._check_counts()
        self._check_ledger()
        idle = core is not None and not (
            core.prefilling or core.decoding or core.paused
            or self.bm.tables)
        if core is not None:
            self._check_lifecycle(core)
        if full is None:
            full = idle or self.n_checks % self.check_interval == 0
        if full:
            self.n_full_checks += 1
            owners = self._check_pools()
            mult = self._check_tables(owners)
            self._check_cache(mult)
            if core is not None:
                self._check_baseline(core)

    # -------------------------------------------------------- test hooks
    def inject_double_free(self) -> None:
        """Plant a free-list/owner overlap: an owned block re-enters the
        free list behind the pool API's back (the effect of freeing a
        block twice through a path that skips the guard)."""
        pool = self.bm.pools[DEVICE]
        if not pool._owner:
            raise RuntimeError("need at least one owned device block")
        b = next(iter(pool._owner))
        pool._free.append(b)

    def inject_refcount_leak(self) -> None:
        """Bump a cache entry's refcount with no table mapping behind it
        (the effect of an incref whose mapping was rolled back)."""
        cache = self.bm.cache
        if cache is None or not cache.entries:
            raise RuntimeError("need a populated prefix cache")
        e = next(iter(cache.entries.values()))
        e.ref += 1

    def inject_ledger_mismatch(self) -> None:
        """Charge the link for an h2d transfer no layer movement backs
        (the double-accounting class the PR 2 `_promote` fix removed)."""
        self.off.ledger.submit(0.0, float(self.cost.kv_bytes(1, 1)),
                               "reload")
