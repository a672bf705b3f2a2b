"""Shared scheduler core: the admission/queueing/residency logic that the
real engine (`engine.py`) and the discrete-event simulator (`sim.py`) both
drive.

Before this module existed, the two serving frontends each carried private
copies of the same decisions — cached-prefix probing, the device-block
admission gate, the Eq.4 layer-split allocation, the Alg.1 admission loop,
chunk assembly under the per-iteration token budget, and the ledger
routing of cache-driven block copies — which is exactly how they drift.
Everything decision-shaped now lives here, once; the backends keep only
what genuinely differs (the engine moves real bytes through the
`PagedExecutor`, the simulator prices steps with the cost model).

Three public pieces:

  ServeConfig      ONE config for both backends (EngineConfig/SimConfig
                   are thin deprecation shims over it);
  AdmissionPolicy  pluggable ordering of the waiting queue — `fcfs`
                   (paper semantics), `prefix_aware` (cache-hitting
                   requests admit first under congestion, with an aging
                   bound so misses never starve), and `deadline`
                   (earliest-virtual-deadline-first across priority
                   classes, the order the preemption controller serves);
  SchedulerCore    the shared state machine: waiting/prefilling/decoding/
                   paused queues, admission, allocation, chunk assembly,
                   lossless preemption (pause = demote KV layer-wise to
                   HOST, resume = promote back, zero recompute), and the
                   cancellation path that unwinds everything a request
                   can leave in flight.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Deque, Dict, List, \
    Optional, Tuple

from repro_torch.core import (
    DEVICE, HOST, LayerwiseBlockManager, OffloadEngine, PoolExhausted,
    SLOScheduler, interleave_offload_layers,
)
from repro_torch.core.units import Blocks, Seconds, Tokens
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.request import Phase, Request

if TYPE_CHECKING:  # pragma: no cover — import cycle (sanitizer -> here)
    from repro_torch.core.sanitizer import KVSanitizer
    from repro_torch.obs.trace import Tracer


# Which SchedulerCore queue a request in each Phase sits in. This registry
# is load-bearing twice: the runtime sanitizer walks it to assert
# phase/queue consistency after every step, and the PHASE001 lint rule
# asserts it stays TOTAL over the Phase enum — adding a lifecycle state
# without deciding where such requests live is a hard lint error, not a
# silent fall-through in some free/cancel path.
# (Port note: the one statement that differs from the reference's copy.
# repro-lint's project-wide PHASE001 check reads the LAST plain
# `PHASE_QUEUES = ...` of the tree as the scheduler to check; binding it
# by unpacking keeps that the reference's identical file, so its
# suppression below stays in use. The same note covers the reworded
# suppression in `preempt_request`.)
(PHASE_QUEUES,) = ({
    Phase.QUEUED: "waiting",
    Phase.PREFILL: "prefilling",
    Phase.DECODE: "decoding",
    Phase.PAUSED: "paused",
    Phase.FINISHED: "done",
    Phase.CANCELLED: "cancelled",
    Phase.SHED: "shed",
},)

# The queues holding LIVE requests — the ones cancel() must test and
# unwind paths must cover. PHASE001 also checks that any scheduler
# function dispatching over several of these covers all of them (or
# carries an explicit suppression naming why not).
LIVE_QUEUES: Tuple[str, ...] = ("waiting", "prefilling", "decoding",
                                "paused")


# --------------------------------------------------------------------------
# Unified configuration
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeConfig:
    """One config for the whole serving stack — accepted verbatim by BOTH
    `LayerKVEngine` and `ServingSimulator` (a drift-guard test asserts
    this stays true). Fields are grouped: the shared scheduling axes and
    pool geometry first, then knobs only one backend reads (clearly
    marked). `EngineConfig` / `SimConfig` remain as deprecation shims
    that fill in each backend's historical defaults.
    """
    # ---- scheduling axes (shared) ----------------------------------------
    policy: str = "layerkv"         # 'layerkv' | 'vllm'
    slo_aware: bool = True          # Alg.1 admission (layerkv only)
    chunked: bool = False           # chunked prefill + mixed batching
    prefix_cache: bool = False      # ref-counted cross-request sharing
    fused: bool = False             # ONE forward/iteration (chunked only)
    preemption: bool = False        # lossless priority preemption: when a
    #                                 higher-priority request cannot pass
    #                                 the device-block gate, demote victim
    #                                 KV layer-wise to HOST and resume it
    #                                 later with NO recompute. Off (the
    #                                 default) is bit-identical to the
    #                                 pre-preemption scheduler. Pairs
    #                                 naturally with admission='deadline'.
    admission: str = "fcfs"         # waiting-queue order: 'fcfs' |
    #                                 'prefix_aware' | 'deadline'
    #                                 (see AdmissionPolicy)
    route_by_tokens: bool = False   # least_loaded routing keys on
    #                                 outstanding TOKEN demand
    #                                 (LoadStats.token_demand) instead
    #                                 of KV-block demand. Off (the
    #                                 default) keeps the paper's
    #                                 block-demand join-shortest-queue
    #                                 bit-identically.
    sanitize: bool = False          # opt-in runtime KV-accounting
    #                                 sanitizer: shadow-track every pool/
    #                                 cache/ledger mutation and assert the
    #                                 S1-S8 invariants after each step on
    #                                 either backend (docs/ARCHITECTURE.md
    #                                 "Invariants & analysis"). Also forced
    #                                 on by the REPRO_SANITIZE=1 env var.
    shed_overload: bool = False     # graceful degradation: when a gate-
    #                                 blocked request's deadline is
    #                                 hopeless (or the scheduler would
    #                                 wedge outright), SHED it with a
    #                                 typed reason (AdmissionImpossible
    #                                 subclass name on r.shed_reason)
    #                                 instead of stalling the queue. Off
    #                                 (the default) is bit-identical to
    #                                 the pre-fault scheduler.
    shed_grace_frac: float = 1.0    # how far past its effective deadline
    #                                 (unit: fraction of the request's own
    #                                 TTFT SLO) a blocked request may age
    #                                 before shed_overload rejects it
    trace: bool = False             # end-to-end tracing: per-request
    #                                 lifecycle spans, per-pass scheduler
    #                                 decision records, and exact TTFT
    #                                 attribution (repro.obs). Off (the
    #                                 default) is bit-identical and never
    #                                 even imports the tracer module —
    #                                 same identity discipline as
    #                                 `sanitize`/`preemption`. Export via
    #                                 repro.obs.export / `launch/serve.py
    #                                 --trace=PATH`.
    admission_age_frac: float = 0.5  # aging bound, unit: fraction of the
    #                                 request's own TTFT SLO.
    #                                 prefix_aware: a HIT is ordered by a
    #                                 virtual arrival this fraction of its
    #                                 TTFT SLO early, so a miss is only
    #                                 ever overtaken by hits arriving
    #                                 within that window after it (bounded
    #                                 reordering, no starvation).
    #                                 deadline: each priority level above
    #                                 0 moves the virtual deadline this
    #                                 fraction of the request's TTFT SLO
    #                                 earlier (same bounded-overtaking
    #                                 argument, per class)
    # ---- pool geometry / batching (shared) -------------------------------
    num_device_blocks: Blocks = 0   # 0 = backend default (engine: 128,
    #                                 sim: derive from HW memory)
    num_host_blocks: Blocks = 1024  # host (offload) KV pool size
    block_size: int = 16            # tokens per paged-KV block
    max_batch_size: int = 64        # in-flight (prefill+decode) requests
    max_prefill_tokens: Tokens = 8192  # per-iteration prefill budget
    #                                 (chunked mode chunk cap; exclusive
    #                                 sim batched-prefill cap)
    chunk_floor: Tokens = 8         # min chunk tokens/iter (progress)
    # ---- engine-only -----------------------------------------------------
    max_tokens_per_request: Tokens = 4096  # generation cap per request
    # ---- sim-only --------------------------------------------------------
    proactive: bool = True          # Eq.5 forecast eviction
    collective_reserve_frac: float = 0.0  # §3.1.3 all-reduce reservation
    forecast_horizon: int = 32
    forecast_threshold_frac: float = 0.05
    gpu_mem_util: float = 0.9       # vLLM gpu_memory_utilization
    max_model_len: Tokens = 16384   # drives activation reservation

    def validate(self) -> "ServeConfig":
        if self.fused and not self.chunked:
            raise ValueError("ServeConfig.fused requires chunked=True")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {self.admission!r}; "
                f"choose from {sorted(ADMISSION_POLICIES)}")
        return self

    # Historical per-backend defaults, preserved so the EngineConfig /
    # SimConfig shims (and anything still importing them) behave exactly
    # as before the unification.
    @classmethod
    def for_engine(cls, **kw: Any) -> "ServeConfig":
        kw.setdefault("num_device_blocks", 128)
        kw.setdefault("max_prefill_tokens", 32)
        return cls(**kw).validate()

    @classmethod
    def for_sim(cls, **kw: Any) -> "ServeConfig":
        kw.setdefault("num_host_blocks", 1 << 20)
        kw.setdefault("max_batch_size", 256)
        kw.setdefault("chunk_floor", 16)
        return cls(**kw).validate()


@dataclasses.dataclass(frozen=True)
class LoadStats:
    """One replica's load, as a cluster router sees it (read-only
    snapshot of `SchedulerCore` state — computing it never changes a
    scheduling decision). `kv_demand` is the join-shortest-queue key:
    device blocks already held by in-flight requests plus the minimum
    blocks every waiting request still needs, i.e. the outstanding
    KV-block demand this replica's device pool has committed to."""

    n_waiting: int           # requests queued, not yet prefilling
    n_inflight: int          # prefilling + decoding
    queued_blocks: Blocks    # min device blocks the waiting queue
    #                          still needs, plus the device blocks
    #                          paused (preempted) requests need to
    #                          resume
    active_blocks: Blocks    # device blocks held by live allocations
    free_blocks: Blocks      # allocatable now (incl. reclaimable
    #                          cache)
    total_blocks: Blocks     # device pool size
    n_paused: int = 0        # preempted requests parked on HOST
    queued_tokens: Tokens = 0   # prefill tokens still owed by the
    #                             waiting queue (uncached suffixes)
    #                             and paused requests
    active_tokens: Tokens = 0   # context tokens (prompt + generated)
    #                             held by in-flight requests

    @property
    def kv_demand(self) -> Blocks:
        return self.queued_blocks + self.active_blocks

    @property
    def token_demand(self) -> Tokens:
        """Outstanding token demand: the `route_by_tokens` routing
        key. Token demand weighs a replica by the COMPUTE it still
        owes (queued prefill suffixes + live context), where
        `kv_demand` weighs it by pool pressure — under heavy prefix
        sharing the two rankings genuinely differ."""
        return self.queued_tokens + self.active_tokens

    @property
    def occupancy(self) -> float:
        return 1.0 - self.free_blocks / self.total_blocks \
            if self.total_blocks else 0.0


class AdmissionImpossible(RuntimeError):
    """The head waiting request can never be admitted: nothing is in
    flight to free blocks and the pools cannot fit it. Raised instead of
    the old opaque "wedged with waiting requests" — a temporarily
    unadmittable request simply waits (backpressure), only a permanently
    unservable one raises."""


# Typed rejection reasons: with `shed_overload` on, the scheduler sheds a
# doomed request (Phase.SHED, `r.shed_reason` = the subclass NAME) instead
# of raising/wedging; the classes double as raisable errors for callers
# that want hard failure. Per-class shed counts surface in
# `SimMetrics.class_report()`.
class PoolInfeasible(AdmissionImpossible):
    """The request's minimum device need exceeds the pool outright — no
    amount of waiting can ever admit it."""


class HostPoolExhausted(AdmissionImpossible):
    """The HOST (offload) pool cannot take the request's layers — under
    a host_exhaust fault or genuine host-memory pressure."""


class DeadlineUnmeetable(AdmissionImpossible):
    """The request aged past its effective deadline plus grace while
    blocked; serving it now could only burn pool on a lost cause."""


class DispatchFailed(AdmissionImpossible):
    """Cluster-level: every dispatch attempt failed (transient dispatch
    faults or no live replica) and the bounded retry budget ran out."""


# --------------------------------------------------------------------------
# Admission ordering policies
# --------------------------------------------------------------------------

class AdmissionPolicy:
    """Orders the waiting queue before each admission pass. Admission
    itself stays head-of-line within the returned order (the first
    request that does not fit blocks the rest), so a policy controls
    priority, never fairness-by-accident."""

    name = "?"

    def order(self, waiting: List[Request], now: float,
              core: "SchedulerCore") -> List[Request]:
        raise NotImplementedError


class FCFSAdmission(AdmissionPolicy):
    """Paper semantics: first come, first served — no reordering, hence
    no starvation (§1)."""

    name = "fcfs"

    def order(self, waiting: List[Request], now: float,
              core: "SchedulerCore") -> List[Request]:
        return list(waiting)


class PrefixAwareAdmission(AdmissionPolicy):
    """Cache-hitting requests admit ahead of cold misses under
    congestion. Two mechanisms compound:

      * shortest-job-first on the Eq.3 prefill cost — a hit's prefill
        prices only the uncached suffix, so serving hits first shrinks
        the mean queueing everyone sees behind exclusive prefills and
        the Alg.1 slack each admission consumes;
      * head-of-line unblocking — a hit's device-block need is only its
        suffix (the shared prefix is already resident), so a small hit
        admits into a block gap that would stall a large miss at the
        head, raising pool utilization and the effective hit rate (the
        prefix is reused while it is still hot, before LRU churn).

    Anti-starvation (aging bound): ordering is FCFS on a *virtual*
    arrival in which a hit gets a head start of `age_frac` of its own
    TTFT SLO. A miss can therefore only be overtaken by hits that
    arrived within that bounded window after it — never by the whole
    future hit stream — so the miss delay added over strict FCFS is
    bounded (~ arrival_rate x window overtakes) and no request starves,
    no matter how deep the queue grows. Under light load the order
    degenerates to plain FCFS."""

    name = "prefix_aware"

    def __init__(self, age_frac: float = 0.5) -> None:
        self.age_frac = age_frac

    def order(self, waiting: List[Request], now: float,
              core: "SchedulerCore") -> List[Request]:
        keyed: List[Tuple[float, int, Request]] = []
        for i, r in enumerate(waiting):
            head_start = self.age_frac * r.ttft_slo \
                if core.cached_hint(r) > 0 else 0.0
            keyed.append((r.arrival - head_start, i, r))
        keyed.sort()
        return [r for _, _, r in keyed]


class DeadlineAdmission(AdmissionPolicy):
    """Earliest-virtual-deadline-first across priority classes (the
    SLO-attainment ordering of "Mitigating KV Cache Competition",
    arXiv 2503.13773). Each request is keyed by

        vdl = deadline_for_ordering - priority * age_frac * ttft_slo

    so a higher class's deadline is treated as `age_frac` of its own
    TTFT SLO earlier per priority level. The deadline used for ordering
    is the request's effective first-token deadline, except for PAUSED
    requests that already emitted tokens — their first-token deadline is
    history, so their *next-token* due time (last token + TPOT SLO)
    keys the resume instead.

    Anti-starvation (bounded aging): a batch request (priority 0) is
    only ever overtaken by higher-class requests whose boosted virtual
    deadline still precedes its own — i.e. requests arriving within a
    bounded window after it. Past that window every new arrival orders
    BEHIND the batch request, whose real deadline keeps aging, so under
    any finite load it reaches the head and (admission being
    head-of-line for waiting requests) admits as soon as in-flight work
    frees blocks — no request starves forever."""

    name = "deadline"

    def __init__(self, age_frac: float = 0.5) -> None:
        self.age_frac = age_frac

    def order(self, waiting: List[Request], now: float,
              core: "SchedulerCore") -> List[Request]:
        keyed: List[Tuple[float, float, int, Request]] = []
        for i, r in enumerate(waiting):
            if r.phase is Phase.PAUSED and r.last_token_time >= 0.0:
                dl = r.last_token_time + r.tpot_slo
            else:
                dl = r.effective_deadline
            vdl = dl - r.priority * self.age_frac * r.ttft_slo
            keyed.append((vdl, r.arrival, i, r))
        keyed.sort(key=lambda k: k[:3])
        return [r for _, _, _, r in keyed]


ADMISSION_POLICIES = {
    FCFSAdmission.name: FCFSAdmission,
    PrefixAwareAdmission.name: PrefixAwareAdmission,
    DeadlineAdmission.name: DeadlineAdmission,
}


def make_admission_policy(sc: ServeConfig) -> AdmissionPolicy:
    if sc.admission == PrefixAwareAdmission.name:
        return PrefixAwareAdmission(sc.admission_age_frac)
    if sc.admission == DeadlineAdmission.name:
        return DeadlineAdmission(sc.admission_age_frac)
    return ADMISSION_POLICIES[sc.admission]()


# --------------------------------------------------------------------------
# The shared core
# --------------------------------------------------------------------------

# backend hook: (src_pool, src_block, dst_pool, dst_block) -> None, moves
# the REAL bytes (engine) — the core itself only charges the ledger
PhysicalCopy = Callable[[str, int, str, int], None]


class SchedulerCore:
    """Queues + decisions shared by the engine and the simulator.

    Owns the request lifecycle state (waiting/prefilling/decoding/done/
    cancelled), per-request residency bookkeeping (`host_layers`, Eq.4
    plan memo), admission (policy ordering, Alg.1 budget, the device-need
    gate, the layer-split allocation), chunk assembly, the ledger routing
    of cache-driven copies, and cancellation. The clock is the backend's:
    backends assign `core.now` as their step progresses so ledger stamps
    land at the right virtual time."""

    def __init__(self, sc: ServeConfig, cost: CostModel,
                 bm: LayerwiseBlockManager, off: OffloadEngine,
                 slo: SLOScheduler, n_layers: int,
                 physical_copy: Optional[PhysicalCopy] = None,
                 reserve_blocks: Blocks = 0) -> None:
        self.sc = sc
        self.cost = cost
        self.bm = bm
        self.off = off
        self.slo = slo
        self.L = n_layers
        self.policy = make_admission_policy(sc)
        self.physical_copy = physical_copy
        # layerkv allocation headroom (sim: Eq.5 forecast reserve)
        self.reserve_blocks: Blocks = reserve_blocks
        self.now: Seconds = 0.0
        # ---- request lifecycle --------------------------------------------
        self.waiting: deque[Request] = deque()
        self.prefilling: List[Request] = []   # chunked: in-flight chunks
        self.decoding: List[Request] = []
        self.paused: List[Request] = []       # preempted, KV parked on HOST
        self.done: List[Request] = []
        self.cancelled: List[Request] = []
        self.shed: List[Request] = []         # rejected under overload
        #                                       (graceful degradation)
        # unified counter/gauge registry (repro.obs): preemption/resume/
        # shed/cancel counts live here (back-compat properties below);
        # the owning backend and cluster fold in their own counters so
        # one snapshot() returns everything
        self.registry = MetricsRegistry()
        # host-pool blocks made unusable by an active host_exhaust fault
        # (serving/faults.py). 0 unless a FaultPlan is installed on the
        # owning cluster, and every read is inert at 0 — fault-free runs
        # are bit-identical.
        self.fault_host_reserve = 0
        # ---- per-request bookkeeping --------------------------------------
        self.host_layers: Dict[str, int] = {}  # layers resident on host
        self.plans: Dict[str, object] = {}     # rid -> Eq.4 OffloadPlan
        self.reload_bytes_migrated = 0
        if sc.prefix_cache:
            # cache-driven copies (COW, promote, demote) charge the
            # transfer ledger here; the engine also moves the real bytes
            bm.on_copy = self.cache_copy
        # opt-in KV-accounting sanitizer: installed AFTER on_copy so its
        # event wrappers see the fully-wired manager; backends call
        # sanitizer.check(core) after every step
        self.sanitizer: Optional["KVSanitizer"] = None
        if sc.sanitize or os.environ.get("REPRO_SANITIZE"):
            from repro_torch.core.sanitizer import KVSanitizer
            self.sanitizer = KVSanitizer(bm, off, cost)
        # opt-in tracer, installed exactly like the sanitizer: the
        # module is imported ONLY here, so trace=False runs never load
        # it and every hot-path emission is one `is not None` test
        self.tracer: Optional["Tracer"] = None
        if sc.trace:
            from repro_torch.obs.trace import Tracer
            self.tracer = Tracer()

    # ---------------------------------------------- counter back-compat
    @property
    def n_preempted(self) -> int:
        """Lossless preemption events (registry-backed)."""
        return int(self.registry.get("preemptions", kind="pause"))

    @property
    def n_resumed(self) -> int:
        return int(self.registry.get("resumes"))

    # ------------------------------------------------------------- queries
    def in_flight(self) -> int:
        return len(self.prefilling) + len(self.decoding)

    def idle(self) -> bool:
        return not (self.prefilling or self.decoding or self.paused)

    def _blocks(self, tokens: Tokens) -> Blocks:
        return self.bm.blocks_for_tokens(tokens)

    def host_free(self) -> Blocks:
        """Usable HOST-pool blocks: the manager's free count minus any
        fault-injected reserve. Every HOST-side gate (admission offload
        layers, preemption demotion, sim eviction) reads this instead of
        `bm.num_free(HOST)` so host_exhaust faults degrade those paths
        without ever touching real pool accounting."""
        return self.bm.num_free(HOST) - self.fault_host_reserve

    def cached_hint(self, r: Request) -> Tokens:
        """Cached-prefix length for Eq.3 admission estimates (price the
        uncached suffix only, or admission over-throttles)."""
        if self.sc.prefix_cache and r.prompt:
            return self.bm.match_prefix(r.prompt)
        return 0

    def device_need(self, r: Request, memoize: bool = True) -> Blocks:
        """MINIMUM device blocks to start r's prefill. With the prefix
        cache on, a hit needs only the uncached suffix (+ COW tail) but
        all layers device-resident — which for short prefixes can EXCEED
        the layer-wise plan; the gate takes the min of the two estimates
        (a larger hit estimate must never wedge a request the plain path
        fits). `memoize=False` keeps the Eq.4 plan out of the per-request
        memo — for probes about requests this core may never own (the
        cluster feasibility backstop), whose memo entry `release()` would
        otherwise never drop."""
        if self.sc.policy == "vllm":
            need = self._blocks(r.prompt_len) * self.L
        else:
            plan = self.plans.get(r.rid)
            if plan is None:
                plan = self.off.plan_for_prompt(r.prompt_len)
                if memoize:
                    self.plans[r.rid] = plan
            send_buf = 1 if plan.offload_layers else 0
            need = self._blocks(r.prompt_len) * (plan.x + send_buf)
        if self.sc.prefix_cache and r.prompt:
            c = self.bm.match_prefix(r.prompt)
            if c > 0:
                hit_need = (self._blocks(r.prompt_len)
                            - c // self.sc.block_size) * self.L
                need = min(need, hit_need)
        return need

    # --------------------------------------------------- load introspection
    def occupancy(self) -> float:
        """Fraction of the device pool held by live allocations (cheap —
        suitable for per-step sampling)."""
        total = self.bm.pools[DEVICE].num_blocks
        return 1.0 - self.bm.num_free(DEVICE) / total if total else 0.0

    def load_stats(self) -> LoadStats:
        """Snapshot this replica's outstanding KV-block demand for a
        cluster router. Pure read: `device_need` only fills the same
        Eq.4 plan memo admission would, so probing never perturbs the
        schedule (the cluster-of-1 identity tests pin this)."""
        total = self.bm.pools[DEVICE].num_blocks
        free = self.bm.num_free(DEVICE)
        queued = sum(self.device_need(r) for r in self.waiting) \
            + sum(self.resume_need(r) for r in self.paused)
        # token-level demand (the route_by_tokens routing key):
        # prefill tokens still owed — a hit's cached prefix costs
        # nothing, exactly as admission prices it — plus the live
        # context every in-flight request already holds
        queued_toks = sum(r.prompt_len - self.cached_hint(r)
                          for r in self.waiting) \
            + sum(r.prefill_remaining for r in self.paused)
        active_toks = sum(r.prompt_len + r.tokens_out
                          for r in self.prefilling + self.decoding)
        return LoadStats(n_waiting=len(self.waiting),
                         n_inflight=self.in_flight(),
                         queued_blocks=queued,
                         active_blocks=total - free,
                         free_blocks=free, total_blocks=total,
                         n_paused=len(self.paused),
                         queued_tokens=queued_toks,
                         active_tokens=active_toks)

    def admit_eta(self, r: Request, now: Seconds) -> Seconds:
        """Estimated delay before this replica's Alg.1 slack admits `r`
        behind its current waiting queue: the Eq.3 prefill work already
        queued ahead of it, plus however much of r's own prefill does not
        fit in the decode batch's remaining Eq.1 slack. Prefix-cache hits
        price only their uncached suffix, exactly as admission does. With
        slo_aware off (or the vllm policy) the queue term alone orders
        replicas.

        Preemption-adjusted: under the `deadline` admission ordering,
        waiting work of a strictly LOWER priority class never sits ahead
        of `r` (it orders behind, and with preemption on its running
        siblings can even be paused for r) — so only same-or-higher
        class queued work counts toward r's ETA. This is what `slo_aware`
        routing sees: an overloaded-with-batch replica still advertises
        a near-zero ETA to an interactive request."""
        t = max(now, self.now)

        def _cost(q: Request) -> Seconds:
            c = self.cached_hint(q)
            return self.cost.chunk_prefill_time(q.prompt_len - c, c)

        ahead = [q for q in self.waiting if q.priority >= r.priority] \
            if self.sc.admission == "deadline" else self.waiting
        queued = sum(_cost(q) for q in ahead)
        if not (self.sc.policy == "layerkv" and self.sc.slo_aware):
            return queued
        budget = self.slo.allow_prefill_budget(self.decoding, t)
        if budget == float("inf"):
            return queued
        return queued + max(_cost(r) - max(budget - queued, 0.0), 0.0)

    # --------------------------------------------------------- cache copies
    def cache_copy(self, src_pool: str, src: int, dst_pool: str,
                   dst: int) -> None:
        """Route one cache-driven block copy: the backend's hook moves
        the real bytes (engine), the ledger charges the offload link for
        cross-tier moves (d2d COW copies never touch the link)."""
        if self.physical_copy is not None:
            self.physical_copy(src_pool, src, dst_pool, dst)
        nbytes = self.cost.kv_bytes(self.sc.block_size, 1)
        if src_pool == HOST and dst_pool == DEVICE:
            self.off.ledger.submit(self.now, nbytes, "reload")
            self.reload_bytes_migrated += nbytes
        elif src_pool == DEVICE and dst_pool == HOST:
            self.off.ledger.submit(self.now, nbytes, "offload")

    # ----------------------------------------------------------- allocation
    def alloc_prefill(self, r: Request) -> Optional[Tuple[list, list]]:
        """Allocate r's prompt KV per the policy; returns (retain, off)
        layer lists or None when the pools cannot fit it. Sets
        `host_layers[r.rid]` and, on a prefix hit, r.prefill_done /
        r.cached_prompt_len (all layers device-resident; prefill compute
        then starts at the cached length). A hit that cannot fit falls
        through to the plain policy path. Never touches the transfer
        ledger — callers account d2h traffic at the granularity their
        step semantics require (whole-prompt vs per-chunk)."""
        if self.sc.prefix_cache and r.prompt:
            acq = self.bm.acquire_prefix(r.rid, r.prompt)
            if acq is not None:
                try:
                    suffix = r.prompt_len - acq.cached_len
                    for l in range(self.L):
                        self.bm.extend_layer(r.rid, l, suffix)
                except PoolExhausted:
                    self.bm.free_request(r.rid)
                    r.prefill_done = 0
                else:
                    r.prefill_done = acq.cached_len
                    r.cached_prompt_len = acq.cached_len
                    self.host_layers[r.rid] = 0
                    self.bm.cache.count(r.prompt_len, acq.cached_len)
                    return list(range(self.L)), []
        per_layer = self._blocks(r.prompt_len)
        try:
            if self.sc.policy == "vllm":
                retain, off = list(range(self.L)), []
            else:
                plan = self.plans.get(r.rid)
                if plan is None:
                    plan = self.off.plan_for_prompt(r.prompt_len)
                    self.plans[r.rid] = plan
                # retain as many layers as currently fit (free
                # prefetching, §3.1.1), never fewer than Eq.4's x
                fit = max((self.bm.num_free(DEVICE) - self.reserve_blocks)
                          // max(per_layer, 1) - 1, 0)
                retain_n = min(self.L, max(plan.x, fit))
                off = interleave_offload_layers(self.L, retain_n)
                retain = [l for l in range(self.L) if l not in set(off)]
                # host-side gate for the offload layers: inert unless a
                # host_exhaust fault holds a reserve (without one, the
                # HOST allocation below raises PoolExhausted on exactly
                # the same shortfall)
                if off and self.fault_host_reserve > 0 \
                        and self.host_free() < per_layer * len(off):
                    return None
            for l in retain:
                self.bm.alloc_layer(r.rid, l, r.prompt_len, DEVICE)
            for l in off:
                self.bm.alloc_layer(r.rid, l, r.prompt_len, HOST)
        except PoolExhausted:
            self.bm.free_request(r.rid)
            return None
        self.host_layers[r.rid] = len(off)
        if self.sc.prefix_cache and r.prompt:
            self.bm.cache.count(r.prompt_len, 0)  # admitted as a miss
        return retain, off

    # ----------------------------------------------------------- preemption
    def _migrate_layer(self, rid: str, layer: int, to_pool: str,
                       kind: str, now: float) -> None:
        """Move one layer's KV across tiers for pause/resume: the block
        manager remaps (detach: blocks shared through the prefix cache
        are copied out, never pulled from under another sharer), the
        backend hook moves the real bytes, and the transfer ledger is
        charged once per layer."""
        a = self.bm.allocation(rid, layer)
        nbytes = self.cost.kv_bytes(a.num_tokens, 1)
        from_pool = a.pool
        src, dst = self.bm.move_layer(rid, layer, to_pool, detach=True)
        if self.physical_copy is not None:
            for s, d in zip(src, dst, strict=True):
                self.physical_copy(from_pool, s, to_pool, d)
        self.off.ledger.submit(now, nbytes, kind)
        if kind == "reload":
            self.reload_bytes_migrated += nbytes

    def reclaimable_blocks(self, r: Request) -> Blocks:
        """Device blocks that preempting `r` would actually free: blocks
        shared through the prefix cache are detached (copied out, the
        device original stays with its other sharers) and free nothing."""
        n = 0
        for l in self.bm.layers_on(r.rid, DEVICE):
            for b in self.bm.allocation(r.rid, l).blocks:
                e = self.bm.cache.lookup(DEVICE, b) if self.bm.cache \
                    else None
                if e is None or e.ref <= 1:
                    n += 1
        return n

    def total_host_blocks(self, r: Request) -> Blocks:
        """Blocks a request currently holds on the HOST tier."""
        return sum(len(self.bm.allocation(r.rid, l).blocks)
                   for l in self.bm.layers_on(r.rid, HOST))

    def resume_need(self, r: Request) -> Blocks:
        """MINIMUM device blocks to resume a paused request. Under the
        request-wise `vllm` policy that is its whole KV (decode needs
        every layer device-resident); under `layerkv` it is one layer's
        footprint — the rest stays host-resident and streams/promotes
        through the same §3.1.1 machinery every offloaded request uses."""
        if self.sc.policy == "vllm":
            return self.total_host_blocks(r)
        return self._blocks(r.prompt_len + r.tokens_out)

    def preempt_request(self, r: Request, now: Seconds) -> bool:
        """Pause one running request losslessly: demote its
        device-resident KV layer-wise to HOST through the PR 2 demotion
        path and park it in `paused`. Nothing is recomputed on resume —
        prefill progress, chunk state, and generated tokens all survive
        (the engine's cached chunk buffers stay valid; chunk assembly
        re-seats a resumed prefill by its original `prefill_start`).
        Returns False when `r` is not running or the HOST pool cannot
        hold its KV (the victim is then simply left running)."""
        # (PHASE001 suppressed in the reference) pause targets RUNNING work only:
        # a QUEUED request holds no KV to demote and a PAUSED one is
        # already parked, so only prefilling/decoding membership is tested
        if r in self.prefilling:
            src_q = self.prefilling
        elif r in self.decoding:
            src_q = self.decoding
        else:
            return False
        dev = self.bm.layers_on(r.rid, DEVICE)
        host_need = sum(len(self.bm.allocation(r.rid, l).blocks)
                        for l in dev)
        if self.host_free() < host_need:
            return False
        for l in dev:
            self._migrate_layer(r.rid, l, HOST, "offload", now)
        self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))
        src_q.remove(r)
        r.phase = Phase.PAUSED
        r.n_preempted += 1
        self.paused.append(r)
        self.registry.inc("preemptions", kind="pause")
        if self.tracer is not None:
            self.tracer.preempt(r, now, mode="pause")
        return True

    def _try_resume(self, r: Request, now: Seconds) -> bool:
        """Re-enter a paused request where it left off (decoding once its
        prefill completed, else the chunk queue) — no recompute ever.
        Promotion is greedy: as many host layers move back to DEVICE as
        fit (allocation headroom respected); whatever stays host-resident
        re-enters through the SAME layer-wise machinery every offloaded
        request already uses (the sim streams/promotes it per §3.1.1, the
        engine's decode selection promotes on demand). Under the
        request-wise `vllm` policy everything must promote. False when
        even `resume_need` does not fit yet — the request stays paused,
        and unlike a blocked fresh admission it does NOT stall the pass
        (its KV is safe on host and its aging continues)."""
        if self.bm.num_free(DEVICE) < self.resume_need(r):
            return False
        for l in self.bm.layers_on(r.rid, HOST):
            a = self.bm.allocation(r.rid, l)
            if self.bm.num_free(DEVICE) - self.reserve_blocks \
                    < len(a.blocks):
                if self.sc.policy == "vllm":
                    return False   # unreachable past the gate, but safe
                break
            self._migrate_layer(r.rid, l, DEVICE, "reload", now)
        self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))
        self.paused.remove(r)
        if r.prefill_complete:
            r.phase = Phase.DECODE
            self.decoding.append(r)
        else:
            r.phase = Phase.PREFILL
            self.prefilling.append(r)
        self.registry.inc("resumes")
        if self.tracer is not None:
            self.tracer.resume(r, now)
        return True

    def _preempt_to_fit(self, r: Request, now: Seconds) -> bool:
        """Victim selection (arXiv 2503.13773-shaped): when `r` fails the
        device-block gate, free its shortfall by pausing strictly
        lower-priority running requests. Victims are taken lowest
        priority class first, then largest reclaimable KV, then latest
        deadline; SLO pricing (SLOScheduler.victim_affordable) charges
        each victim the h2d promotion it must later pay against its own
        deadline slack — unaffordable victims are touched only when `r`
        is itself already past its effective deadline. All-or-nothing:
        if the chosen set cannot cover the shortfall, nobody is paused
        (a pointless preemption costs two PCIe crossings and buys no
        admission)."""
        shortfall = self.device_need(r) - self.bm.num_free(DEVICE)
        if shortfall <= 0:
            return True
        cands = [v for v in self.prefilling + self.decoding
                 if v.priority < r.priority]
        if not cands:
            return False
        reclaim = {v.rid: self.reclaimable_blocks(v) for v in cands}
        bw = self.cost.hw.offload_bw
        afford = {
            v.rid: self.slo.victim_affordable(
                v, now, self.cost.kv_bytes(
                    v.prompt_len + v.tokens_out, self.L), bw)
            for v in cands}
        critical = now > r.effective_deadline
        pool = [v for v in cands if afford[v.rid]]
        if critical:
            pool += [v for v in cands if not afford[v.rid]]
        pool.sort(key=lambda v: (v.priority, -reclaim[v.rid],
                                 -v.effective_deadline))
        chosen: List[Request] = []
        freed = 0
        for v in pool:
            if freed >= shortfall:
                break
            chosen.append(v)
            freed += reclaim[v.rid]
        if freed < shortfall:
            return False
        for v in chosen:
            self.preempt_request(v, now)
        return self.bm.num_free(DEVICE) >= self.device_need(r)

    # ------------------------------------------------------------ admission
    def admission_budget(self, order: List[Request],
                         now: Seconds) -> int:
        """Alg.1: how many of the ordered waiting prefills fit in the
        decode batch's minimum TPOT slack."""
        if self.sc.policy == "layerkv" and self.sc.slo_aware:
            return self.slo.max_prefills(order, self.decoding, now,
                                         cached_len=self.cached_hint)
        return len(order)

    def admit_waiting(self, now: Seconds,
                      immediate: Optional[Callable[[Request], bool]] = None,
                      token_budget: Optional[Tokens] = None
                      ) -> List[Request]:
        """One admission pass over the policy-ordered waiting queue.
        Head-of-line within the order: the first request that fails a
        gate stops the pass. Three caller modes:

          chunked (sc.chunked)   allocate KV and queue the request into
                                 `prefilling` for chunk-by-chunk prefill;
          immediate=<fn>         exclusive engine: run each admitted
                                 prefill NOW (fn appends to `decoding`);
          neither                exclusive sim: allocate only; the caller
                                 runs the returned batch exclusively
                                 (`token_budget` caps its prompt tokens).

        With preemption on, PAUSED requests join the same policy order
        (under `deadline` ordering a resume competes by its next-token
        due time) and re-enter by promoting their parked KV — they never
        consume the Alg.1 prefill budget (nothing is prefilled) and a
        blocked resume is skipped rather than stalling the pass (its KV
        is safe on host; only fresh admissions are head-of-line). When a
        fresh request fails the device-block gate, the preemption
        controller may pause lower-priority running requests to fit it
        (`_preempt_to_fit`) before the gate gives up.

        Returns the (fresh) requests admitted this pass."""
        pool = list(self.waiting) + list(self.paused)
        if not pool:
            return []
        order = self.policy.order(pool, now, self)
        waiting_set = set(map(id, self.waiting))
        budget_n = self.admission_budget(
            [r for r in order if id(r) in waiting_set], now)
        admitted: List[Request] = []
        deferred = immediate is None and not self.sc.chunked
        # TTFT attribution: which gate stopped this pass (head-of-line:
        # every request still waiting afterwards waited on it)
        stop_gate: Optional[str] = None
        for r in order:
            in_flight = self.in_flight() + (len(admitted) if deferred
                                            else 0)
            if in_flight >= self.sc.max_batch_size:
                stop_gate = "gate:max_batch_size"
                break
            if id(r) not in waiting_set:
                self._try_resume(r, now)
                continue
            if budget_n <= 0:
                stop_gate = "gate:alg1_budget"
                break
            if token_budget is not None and admitted \
                    and r.prompt_len > token_budget:
                stop_gate = "gate:token_budget"
                break
            if self.bm.num_free(DEVICE) < self.device_need(r):
                if not (self.sc.preemption
                        and self._preempt_to_fit(r, now)):
                    if self._maybe_shed(r, now):
                        continue
                    stop_gate = "gate:device_blocks"
                    break
            if self.sc.chunked:
                if self.alloc_prefill(r) is None:
                    if self._maybe_shed(r, now):
                        continue
                    stop_gate = "gate:host_reserve"
                    break
                self.waiting.remove(r)
                r.phase = Phase.PREFILL
                r.prefill_start = now
                self.prefilling.append(r)
            elif immediate is not None:
                self.waiting.remove(r)
                # read the clock FRESH: an earlier immediate() in this
                # pass ran a whole prefill and advanced it — stamping the
                # pass-start `now` would under-report queueing and tie
                # every prefill_start in the pass (breaking newest-first
                # eviction ordering)
                r.prefill_start = self.now
                if not immediate(r):
                    self.waiting.appendleft(r)
                    if self._maybe_shed(r, now):
                        continue
                    stop_gate = "gate:host_reserve"
                    break
            else:
                if self.alloc_prefill(r) is None:
                    if self._maybe_shed(r, now):
                        continue
                    stop_gate = "gate:host_reserve"
                    break
                self.waiting.remove(r)
            admitted.append(r)
            budget_n -= 1
            if token_budget is not None:
                token_budget -= r.prompt_len
        tracer = self.tracer
        if tracer is not None:
            tracer.sched_pass(self, now, admitted, stop_gate,
                              immediate_mode=immediate is not None)
        return admitted

    # ------------------------------------------------------- chunk assembly
    def chunk_token_cap(self, now: Seconds) -> Tokens:
        """Per-iteration prefill token budget: Eq.1 slack converted to
        tokens when slo_aware, else the static cap."""
        if self.sc.policy == "layerkv" and self.sc.slo_aware:
            return self.slo.max_chunk_tokens(
                self.decoding, now, self.sc.max_prefill_tokens,
                floor=self.sc.chunk_floor)
        return self.sc.max_prefill_tokens

    def assemble_chunks(self, now: Seconds, decode_tokens: Tokens
                        ) -> List[Tuple[Request, int]]:
        """FCFS chunk assembly under the token budget; this iteration's
        decode tokens count against it. A floor guarantees prefill
        progress when no decode batch runs."""
        budget = self.chunk_token_cap(now) - decode_tokens
        if self.prefilling and decode_tokens == 0:
            budget = max(budget, self.sc.chunk_floor)
        work: List[Tuple[Request, int]] = []
        for r in sorted(self.prefilling, key=lambda q: q.prefill_start):
            if budget <= 0:
                break
            c = min(budget, r.prefill_remaining)
            work.append((r, c))
            budget -= c
        return work

    # ------------------------------------------------------------- release
    def release(self, r: Request) -> None:
        """Drop the per-request bookkeeping (retire and cancel paths)."""
        self.host_layers.pop(r.rid, None)
        self.plans.pop(r.rid, None)

    def cancel(self, r: Request, now: Seconds) -> bool:
        """Unwind everything `r` has in flight, whatever its phase:

          * waiting      — just leaves the queue;
          * prefilling   — mid-chunk KV (device AND host-resident
                           offloaded layers) is freed; blocks it shares
                           through the prefix cache are decref'd, never
                           pulled from under another sharer, and FULL
                           blocks it already registered stay behind as
                           reclaimable cache (a cancelled request's
                           computed prefix remains hittable);
          * decoding     — same, plus it leaves the decode batch;
          * paused       — same unwind over its host-parked KV (a
                           preempted request never resumes after cancel).

        Transfers already submitted to the link ledger are sunk cost: the
        bytes were queued on the link, the ledger is occupancy accounting
        and stays monotone. Returns False when `r` is not live (already
        finished or cancelled) — cancellation is idempotent."""
        self.now = now
        was_live = False
        if r in self.waiting:
            self.waiting.remove(r)
            was_live = True
        if r in self.prefilling:
            self.prefilling.remove(r)
            was_live = True
        if r in self.decoding:
            self.decoding.remove(r)
            was_live = True
        if r in self.paused:
            self.paused.remove(r)
            was_live = True
        if not was_live:
            return False
        if r.rid in self.bm.tables:
            self.bm.free_request(r.rid)
        self.release(r)
        r.phase = Phase.CANCELLED
        r.finish_time = now
        self.cancelled.append(r)
        self.registry.inc("cancelled_total")
        if self.tracer is not None:
            self.tracer.cancel(r, now)
        return True

    # ---------------------------------------------- graceful degradation
    def _shed_class(self, r: Request) -> type:
        """Typed rejection reason for a blocked request, most-specific
        first (permanent infeasibility beats fault pressure beats aging
        out)."""
        if self.device_need(r, memoize=False) \
                > self.bm.pools[DEVICE].num_blocks:
            return PoolInfeasible
        if self.fault_host_reserve > 0:
            return HostPoolExhausted
        return DeadlineUnmeetable

    def shed_request(self, r: Request, reason: str,
                     now: Seconds) -> None:
        """Reject a WAITING request with a typed reason: it leaves the
        queue terminally (Phase.SHED), keeps nothing allocated, and is
        reported per deadline class by `SimMetrics.class_report()`."""
        if r in self.waiting:
            self.waiting.remove(r)
        self.release(r)
        r.phase = Phase.SHED
        r.shed_reason = reason
        r.prefill_start = -1.0
        r.finish_time = now
        self.shed.append(r)
        self.registry.inc("shed_total", reason=reason)
        if self.tracer is not None:
            self.tracer.shed(r, now, reason)

    def _maybe_shed(self, r: Request, now: Seconds) -> bool:
        """Shed-by-deadline-class at the admission gate: with
        `shed_overload` on, a fresh request that failed a gate AND has
        aged `shed_grace_frac` of its own TTFT SLO past its effective
        deadline is rejected (typed reason) instead of blocking the
        head of the line. Off by default — returning False preserves
        the head-of-line `break` bit-identically."""
        if not self.sc.shed_overload:
            return False
        if now <= r.effective_deadline \
                + self.sc.shed_grace_frac * r.ttft_slo:
            return False
        self.shed_request(r, self._shed_class(r).__name__, now)
        return True

    def shed_blocked(self, now: Seconds) -> bool:
        """Last-resort degradation for a WEDGED scheduler: nothing is in
        flight, nothing can be admitted, and the queue would otherwise
        raise `wedged_error`. With `shed_overload` on, shed the blocking
        head of the policy order (typed reason) so the queue behind it
        drains; returns True when something was shed (progress)."""
        if not self.sc.shed_overload or not self.waiting:
            return False
        order = self.policy.order(list(self.waiting), now, self)
        r = next((q for q in order if q in self.waiting), None)
        if r is None:
            return False
        self.shed_request(r, self._shed_class(r).__name__, now)
        return True

    def wedged_error(self) -> AdmissionImpossible:
        """Names the request that actually blocked the admission pass:
        the head of the POLICY order (admission is head-of-line within
        it), which under prefix_aware need not be waiting[0]."""
        pool = list(self.waiting) or list(self.paused)
        order = self.policy.order(pool, self.now, self)
        r = order[0] if order else pool[0]
        if r in self.paused:
            return AdmissionImpossible(
                f"paused request {r.rid} can never resume: needs "
                f"{self.resume_need(r)} device blocks, the pool has "
                f"{self.bm.pools[DEVICE].num_blocks} and nothing is in "
                f"flight to free any")
        return AdmissionImpossible(
            f"request {r.rid} (prompt {r.prompt_len}) can never be "
            f"admitted: needs {self.device_need(r)} device blocks, the "
            f"pool has {self.bm.pools[DEVICE].num_blocks} and nothing is "
            f"in flight to free any")


class CoreDelegateMixin:
    """Queue/clock delegation shared by every backend that drives a
    `SchedulerCore` — the engine and the simulator inherit this instead
    of each hand-mirroring the core's lifecycle state (which is exactly
    the duplication the core exists to prevent). Subclasses set
    `self.core` in __init__ and keep their own named clock property
    (`engine.now`, `sim.t`) on top of `clock()`/`advance_to()`."""

    core: SchedulerCore

    @property
    def waiting(self) -> Deque[Request]:
        return self.core.waiting

    @property
    def prefilling(self) -> List[Request]:
        return self.core.prefilling

    @property
    def decoding(self) -> List[Request]:
        return self.core.decoding

    @property
    def paused(self) -> List[Request]:
        return self.core.paused

    @property
    def done(self) -> List[Request]:
        return self.core.done

    @property
    def cancelled(self) -> List[Request]:
        return self.core.cancelled

    @property
    def shed(self) -> List[Request]:
        return self.core.shed

    @property
    def host_layers(self) -> Dict[str, int]:
        return self.core.host_layers

    def clock(self) -> float:
        return self.core.now

    def advance_to(self, t: float) -> None:
        self.core.now = max(self.core.now, t)
