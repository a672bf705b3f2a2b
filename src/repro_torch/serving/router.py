"""Routing policies for the cluster serving subsystem.

At fleet scale the *router* decides which replica's queue a request
joins — and, because the PR 2 prefix cache is per-replica, whether it
lands on the replica that already holds its prefix. Dispatch is
therefore the single biggest lever on both queueing delay (the paper's
dominant TTFT term) and the effective cache hit rate.

A `RoutingPolicy` sees the shared `SchedulerCore` of every replica
(load introspection only — policies never mutate a core) and picks a
replica index per request at its ARRIVAL time. Four built-ins:

  round_robin      static striping; the load-oblivious baseline;
  least_loaded     join-shortest-queue by outstanding KV-block demand
                   (`SchedulerCore.load_stats().kv_demand`): blocks held
                   by in-flight requests plus the minimum blocks the
                   waiting queue still needs;
  prefix_affinity  route by the prompt's block-hash chain so repeat
                   prefixes rendezvous on the replica whose cache holds
                   them (probed via `match_prefix`, with a
                   highest-random-weight hash of the first full block
                   breaking ties before any replica has registered it),
                   plus a load-based spillover threshold priced in the
                   request's own prefill economics so a hot template
                   cannot hotspot one replica into unbounded queueing;
  slo_aware        route to the replica whose Alg.1 slack admits the
                   request soonest (`SchedulerCore.admit_eta`: queued
                   Eq.3 prefill work plus the part of the request's own
                   prefill the Eq.1 decode slack cannot absorb). With
                   deadline admission the ETA is preemption-adjusted:
                   only same-or-higher-priority queued work counts,
                   since lower-priority work orders behind the request
                   (and with preemption on can even be paused for it).

Every policy breaks ties toward the lowest replica index, so routing is
deterministic — the cluster benchmarks and the cluster-of-1 identity
tests rely on reproducible dispatch.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.block_manager import block_hashes
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import SchedulerCore


class RoutingPolicy:
    """Picks the replica a request is dispatched to. `choose` runs once
    per request, at the request's arrival on the cluster's shared
    virtual clock; `cores` are the replicas' scheduler cores in replica
    order. Implementations must be read-only observers of the cores."""

    name = "?"

    def choose(self, request: Request, cores: Sequence[SchedulerCore],
               now: float) -> int:
        raise NotImplementedError


class RoundRobinRouting(RoutingPolicy):
    """Static striping, load- and content-oblivious (the baseline every
    load-aware policy must beat)."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, request, cores, now):
        i = self._next % len(cores)
        self._next += 1
        return i


def _least(loads: List, by_tokens: bool = False) -> int:
    if by_tokens:
        return min(range(len(loads)),
                   key=lambda i: (loads[i].token_demand, i))
    return min(range(len(loads)), key=lambda i: (loads[i].kv_demand, i))


class LeastLoadedRouting(RoutingPolicy):
    """Join-shortest-queue on outstanding KV-block demand. Queue length
    in *blocks* (not requests) is the right unit here: the paper's core
    finding is that TTFT is dominated by queueing for KV blocks, so a
    replica with few-but-huge prompts queued is more loaded than one
    with many tiny ones.

    With `ServeConfig.route_by_tokens` the key switches to outstanding
    TOKEN demand (`LoadStats.token_demand`): queued uncached prefill
    suffixes plus live context. Blocks weigh a replica by pool
    pressure, tokens by the compute it still owes — under heavy prefix
    sharing the two rankings differ (a replica whose queue is all cache
    hits owes little compute but still needs the blocks). Default off:
    block-demand routing is the paper's join-shortest-queue."""

    name = "least_loaded"

    def choose(self, request, cores, now):
        by_tokens = bool(cores) and cores[0].sc.route_by_tokens
        return _least([c.load_stats() for c in cores], by_tokens)


class PrefixAffinityRouting(RoutingPolicy):
    """Rendezvous dispatch on the prompt's block-hash chain, with a
    load-based spillover threshold priced in prefill economics.

    Preference order: replicas holding a longer cached prefix of the
    prompt come first (probed with the same `match_prefix` admission
    uses); ties — including the all-cold case before any replica has
    registered the template — break by highest-random-weight rendezvous
    on the hash of the prompt's FIRST full block (the head of the
    content-addressing chain every cached block commits to), so all
    requests of a template agree on a home replica, and on the same
    deterministic spill SEQUENCE, even before the first one finishes
    prefilling.

    Spillover (consistent-hashing-with-bounded-loads shaped): walk the
    preference order and take the first replica whose estimated
    admission delay (`SchedulerCore.admit_eta` — queued Eq.3 prefill
    work against Eq.1 decode slack) is within the spill budget of the
    cluster-wide minimum. The budget is priced in the request's OWN
    prefill economics: `spill_frac * (saved + cold)`, where `saved` is
    the Eq.3 compute the candidate's cached prefix would skip and
    `cold` the full-prompt prefill cost. Waiting a little for a big hit
    is worth it; waiting longer than the recompute it avoids is not —
    so a hot template spills to its (deterministic) next-preferred
    replica exactly when affinity stops paying for itself, and a fresh
    template tolerates only a small backlog before placing by load. A
    spilled request re-prefills and registers the prefix on the spill
    target, so hot templates organically replicate instead of
    hotspotting one replica."""

    name = "prefix_affinity"

    def __init__(self, spill_frac: float = 0.5):
        self.spill_frac = spill_frac

    def choose(self, request, cores, now):
        toks = request.prompt
        if not toks:
            # nothing to rendezvous on: place by load
            return _least([c.load_stats() for c in cores])
        bs = cores[0].bm.block_size
        anchor = block_hashes(toks, bs)[0] if len(toks) >= bs \
            else hash(tuple(toks))
        matches = [c.bm.match_prefix(toks) for c in cores]
        etas = [c.admit_eta(request, now) for c in cores]
        eta_min = min(etas)
        pref = sorted(range(len(cores)),
                      key=lambda i: (-matches[i], hash((anchor, i))))
        for i in pref:
            cold = cores[i].cost.chunk_prefill_time(request.prompt_len, 0)
            saved = cold - cores[i].cost.chunk_prefill_time(
                request.prompt_len - matches[i], matches[i])
            if etas[i] <= eta_min + self.spill_frac * (saved + cold):
                return i
        return min(range(len(cores)), key=lambda i: (etas[i], i))


class SLOAwareRouting(RoutingPolicy):
    """Route to the replica whose Alg.1 slack admits the request
    soonest. `admit_eta` prices the Eq.3 prefill work queued ahead of
    the request plus whatever part of its own prefill the decode batch's
    Eq.1 slack cannot absorb — under deadline admission only
    same-or-higher-priority queued work counts (lower-priority work
    orders behind the request, and with preemption on can be paused for
    it); KV-block demand breaks ETA ties (two empty replicas -> the
    emptier pool)."""

    name = "slo_aware"

    def choose(self, request, cores, now):
        keyed = [(c.admit_eta(request, now),
                  c.load_stats().kv_demand, i)
                 for i, c in enumerate(cores)]
        return min(keyed)[2]


ROUTING_POLICIES = {
    RoundRobinRouting.name: RoundRobinRouting,
    LeastLoadedRouting.name: LeastLoadedRouting,
    PrefixAffinityRouting.name: PrefixAffinityRouting,
    SLOAwareRouting.name: SLOAwareRouting,
}


def make_routing_policy(spec) -> RoutingPolicy:
    """str name -> fresh policy instance; a RoutingPolicy passes through
    (policies are stateful — round_robin's cursor — so instances are
    never shared between clusters)."""
    if isinstance(spec, RoutingPolicy):
        return spec
    if spec not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {spec!r}; choose from "
                         f"{sorted(ROUTING_POLICIES)}")
    return ROUTING_POLICIES[spec]()
