"""Layer-wise KV offload policy + transfer ledger (paper §3.1.1-§3.1.3).

Three responsibilities:
  1. choose WHICH layers to retain on device (Eq. 4 overlap condition via
     the cost model, evenly interleaved across depth per §3.1.2);
  2. track WHEN transfers complete on the offload link — a simple busy-time
     ledger that both the real engine and the simulator share;
  3. avoid link contention with collectives (§3.1.3): transfers are cut
     into sub-units and each sub-unit defers while the link is reserved
     (the all-reduce critical path on PCIe testbeds; disjoint fabrics on
     TPU, where this policy simply never triggers).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover — import cycle (serving -> core)
    from repro_torch.serving.costmodel import CostModel


def interleave_offload_layers(n_layers: int, retain: int) -> List[int]:
    """Indices of layers to OFFLOAD, evenly spread across depth. With 8
    layers and retain=4 the paper keeps 1,3,5,7 and offloads 0,2,4,6."""
    retain = max(0, min(retain, n_layers))
    n_off = n_layers - retain
    if n_off <= 0:
        return []
    if retain == 0:
        return list(range(n_layers))
    # distribute offloaded layers as evenly as possible, starting at 0
    out, acc = [], 0.0
    step = n_layers / n_off
    for i in range(n_off):
        out.append(min(n_layers - 1, int(round(i * step))))
    # dedupe while preserving count (fall back to first free slots)
    seen, fixed = set(), []
    for l in out:
        while l in seen:
            l += 1
        seen.add(l)
        fixed.append(l)
    return sorted(fixed)


@dataclasses.dataclass
class Transfer:
    start: float      # when bytes actually began moving (post-queueing)
    end: float
    nbytes: int
    kind: str         # 'offload' (d2h) | 'reload' (h2d)
    submitted: float = 0.0  # when the transfer was queued; start - submitted
    #                         is the link-queueing delay


class LinkLedger:
    """Serialized offload-link occupancy with §3.1.3 contention avoidance."""

    def __init__(self, bandwidth: float, chunk_bytes: int = 4 << 20,
                 check_backoff: float = 0.2):
        self.bw = bandwidth
        self.chunk = chunk_bytes
        self.backoff = check_backoff  # fraction of reservation to wait
        self.busy_until = 0.0
        self.reservations: List[Tuple[float, float]] = []  # collectives
        self.log: List[Transfer] = []

    # collectives (all-reduce) reserve the link on non-NVLink testbeds
    def reserve(self, start: float, dur: float) -> None:
        # prune expired windows so _blocked stays O(live reservations)
        self.reservations = [(s, e) for s, e in self.reservations
                             if e > start]
        self.reservations.append((start, start + dur))

    def _blocked(self, t: float) -> Optional[float]:
        for s, e in self.reservations:
            if s <= t < e:
                return e
        return None

    def submit(self, now: float, nbytes: int, kind: str) -> float:
        """Queue a transfer at `now`; returns completion time. The transfer
        is chunked; each chunk checks the link and defers by a fraction of
        the blocking reservation when occupied (paper §3.1.3). The logged
        `start` is when the FIRST byte moves — after both the link-busy
        queue and any reservation deferrals — not the submit time."""
        t = max(now, self.busy_until)
        remaining = nbytes
        start = None
        while remaining > 0:
            blk = self._blocked(t)
            if blk is not None:
                t += max((blk - t) * self.backoff, 1e-6)
                continue
            if start is None:
                start = t
            sz = min(self.chunk, remaining)
            t += sz / self.bw
            remaining -= sz
        self.busy_until = t
        self.log.append(Transfer(start if start is not None else t, t,
                                 nbytes, kind, submitted=now))
        return t

    def idle_at(self, now: float) -> bool:
        return now >= self.busy_until and self._blocked(now) is None


@dataclasses.dataclass
class OffloadPlan:
    retain_layers: List[int]     # stay on device
    offload_layers: List[int]    # go to host during prefill
    x: int                       # = len(retain_layers)


class OffloadEngine:
    """Policy front-end used by both the real engine and the simulator."""

    def __init__(self, cost: CostModel, n_layers: int,
                 ledger: Optional[LinkLedger] = None):
        self.cost = cost
        self.n_layers = n_layers
        self.ledger = ledger or LinkLedger(cost.hw.offload_bw)

    def plan_for_prompt(self, prompt_len: int) -> OffloadPlan:
        """Eq. 4: retain the minimum x layers whose offload cannot hide
        under prefill compute; long prompts drive x to 0."""
        x = self.cost.min_retained_layers(prompt_len)
        off = interleave_offload_layers(self.n_layers, x)
        retain = [l for l in range(self.n_layers) if l not in set(off)]
        return OffloadPlan(retain, off, x)

    def prefill_offload_done(self, now: float, prompt_len: int,
                             plan: OffloadPlan) -> float:
        """Completion time of the prefill-stage d2h copies (they start as
        soon as each layer's KV is produced; paper §4 overlaps them with
        the same layer's compute)."""
        nbytes = self.cost.kv_bytes(prompt_len, len(plan.offload_layers))
        if nbytes == 0:
            return now
        return self.ledger.submit(now, nbytes, "offload")

    def proactive_offload(self, now: float, ctx_len: int,
                          n_layers_to_evict: int) -> float:
        nbytes = self.cost.kv_bytes(ctx_len, n_layers_to_evict)
        if nbytes == 0:
            return now
        return self.ledger.submit(now, nbytes, "offload")

    def decode_reload_time(self, batch_size: int, avg_ctx: int,
                           host_layers: int) -> float:
        """Per-step h2d streaming of host-resident layers (overlapped; the
        cost model already takes max(compute, reload))."""
        return self.cost.kv_bytes(avg_ctx, host_layers) * batch_size \
            / self.cost.hw.offload_bw
