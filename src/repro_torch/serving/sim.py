"""Discrete-event serving simulator.

Drives the *production* LayerKV decision logic (block manager, offload
engine, SLO scheduler, forecast) with a simulated clock and the Eq.3/4 cost
model, reproducing the paper's 7B-70B figures on a CPU-only box. The only
thing swapped vs. the real engine is the executor: step latencies come from
`CostModel` instead of measured JAX step times.

Everything decision-shaped — admission (policy-ordered, Alg.1 budgeted),
the device-need gate, the Eq.4 layer-split allocation, chunk assembly,
cache-copy ledger routing, cancellation — lives in the shared
`SchedulerCore` (serving/scheduler.py); the real engine drives the SAME
core, so the two frontends cannot drift. The simulator keeps only what is
simulation-specific: pricing iterations with the cost model, Eq.5
proactive eviction, preemption-by-recompute, and the §3.1.3 collective
reservation.

Engine-step semantics (ServeConfig.chunked selects the second mode):

  exclusive  vLLM 0.5.5 (the paper's baseline): iteration-level batching;
             prefills run exclusively, stalling the decode batch; decode
             batches every running sequence; preemption-by-recompute when a
             decode step cannot get a block.
  chunked    chunked prefill with mixed batching: each prompt is split into
             scheduler-controlled chunks under a per-iteration token budget
             (max_prefill_tokens, tightened by Eq.1 slack when slo_aware);
             chunk tokens batch WITH the decode tokens, so an iteration
             costs max(chunk compute, decode compute) instead of their sum.
             `ServeConfig.fused` additionally prices the iteration as the
             fused single-forward executor (one weight stream), mirroring
             the real engine's fused axis.

Policies (orthogonal to the step semantics):
  'vllm'     request-wise allocation: a prefill is admitted only when KV
             blocks for ALL layers of the whole prompt are free on device.
  'layerkv'  layer-wise allocation (paper): device blocks for the x retained
             layers (+1 transient send-buffer layer), the remaining L-x
             layers stream to host hidden under prefill compute; optional
             SLO-aware admission (Alg. 1) and Eq.5 proactive eviction.

The simulator is driven through a `ServingSession` (serving/session.py):
submit/stream/cancel online, or the batch `run(requests)` wrapper.
"""
from __future__ import annotations

import dataclasses
import math
import re
import statistics
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    AvailabilityForecast, DEVICE, HOST, LayerwiseBlockManager, OffloadEngine,
    PoolExhausted, SLOScheduler,
)
from repro_torch.core.predictor import LengthPredictor, OraclePredictor
from repro_torch.core.units import Blocks, Bytes, Seconds
from repro_torch.serving.costmodel import CostModel, HWProfile
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import CoreDelegateMixin, SchedulerCore, \
    ServeConfig
from repro_torch.serving.session import ServingSession


def SimConfig(**kw) -> ServeConfig:
    """Deprecated shim: builds a `ServeConfig` with the historical
    simulator defaults (derived device blocks, 2^20 host blocks, batch
    256, chunk floor 16)."""
    return ServeConfig.for_sim(**kw)


def pooled_percentile(series: List[float], q: float = 0.99) -> float:
    """Nearest-rank percentile over a RAW pooled series: the
    ceil(q*n)-th smallest. Every percentile in SimMetrics — cluster-wide
    or per-class — goes through this one helper over concatenated raw
    series; averaging per-replica (or slicing per-class from truncated)
    percentiles understates the tail exactly when load is imbalanced."""
    if not series:
        return 0.0
    s = sorted(series)
    return s[min(len(s), math.ceil(q * len(s))) - 1]


@dataclasses.dataclass
class SimMetrics:
    """Per-run serving metrics. Carries RAW per-request series (not
    just aggregates) so `merge` can pool seeds without averaging
    averages — percentiles over merged runs are pooled nearest-rank,
    and `class_report()` re-slices everything by priority class."""
    ttft: List[float]
    queuing: List[float]
    prefill_lat: List[float]
    tpot: List[float]
    finish_times: List[float]
    tokens_out: int
    makespan: float
    slo_violations: int
    n_requests: int
    preemptions: int
    # chunked-mode accounting (zero in exclusive mode)
    chunk_iters: int = 0                 # iterations that carried a chunk
    max_iter_prefill_tokens: int = 0     # largest per-iteration chunk total
    # prefix-cache accounting (zero with the cache off)
    prefix_hit_tokens: int = 0           # prompt tokens served from cache
    prefix_lookup_tokens: int = 0        # prompt tokens looked up
    n_cancelled: int = 0                 # session cancellations (excluded
    #                                      from every latency series above)
    # per-request series ALIGNED with ttft/tpot/... (same index = same
    # request), so per-class slices stay raw series and percentiles pool
    # correctly across replicas
    priorities: List[int] = dataclasses.field(default_factory=list)
    tbt: List[float] = dataclasses.field(default_factory=list)
    #   ^ per-request MAX inter-token gap (s) — the stall preemption causes
    deadline_slack: List[float] = dataclasses.field(default_factory=list)
    #   ^ effective_deadline - first_token_time (s); negative = violated
    req_tokens: List[int] = dataclasses.field(default_factory=list)
    #   ^ tokens generated per request (goodput numerator, deadline-gated)
    # fault-tolerance accounting (all zero/empty without a FaultPlan or
    # shed_overload — the counters exist so degraded runs stay auditable)
    n_shed: int = 0                      # requests rejected under overload
    shed_priorities: List[int] = dataclasses.field(default_factory=list)
    shed_reasons: List[str] = dataclasses.field(default_factory=list)
    #   ^ AdmissionImpossible subclass names, aligned with shed_priorities
    n_retries: int = 0                   # dispatch retries (backoff spins)
    retry_priorities: List[int] = dataclasses.field(default_factory=list)
    n_redispatched: int = 0              # restarts after a replica kill
    redispatch_priorities: List[int] = dataclasses.field(
        default_factory=list)
    n_replica_kills: int = 0
    n_replica_recoveries: int = 0
    # request ids ALIGNED with ttft/priorities/... — carry the tenant
    # encoding (rid "t{k}r{i}") so class_report(by="tenant") can re-key
    # the same raw series without a second bookkeeping path
    rids: List[str] = dataclasses.field(default_factory=list)
    shed_rids: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def merge(cls, parts: List["SimMetrics"]) -> "SimMetrics":
        """Pool per-replica metrics into cluster-level metrics. Raw
        latency SERIES are concatenated and the derived statistics
        (means, p99, throughput) recomputed over the pooled data —
        averaging per-replica percentiles is statistically wrong and
        understates the tail exactly when replicas are imbalanced,
        which is what routing policies differ on. Counters sum;
        makespan / max_iter_prefill_tokens take the max."""
        return cls(
            ttft=[t for m in parts for t in m.ttft],
            queuing=[t for m in parts for t in m.queuing],
            prefill_lat=[t for m in parts for t in m.prefill_lat],
            tpot=[t for m in parts for t in m.tpot],
            finish_times=[t for m in parts for t in m.finish_times],
            tokens_out=sum(m.tokens_out for m in parts),
            makespan=max((m.makespan for m in parts), default=0.0),
            slo_violations=sum(m.slo_violations for m in parts),
            n_requests=sum(m.n_requests for m in parts),
            preemptions=sum(m.preemptions for m in parts),
            chunk_iters=sum(m.chunk_iters for m in parts),
            max_iter_prefill_tokens=max(
                (m.max_iter_prefill_tokens for m in parts), default=0),
            prefix_hit_tokens=sum(m.prefix_hit_tokens for m in parts),
            prefix_lookup_tokens=sum(
                m.prefix_lookup_tokens for m in parts),
            n_cancelled=sum(m.n_cancelled for m in parts),
            priorities=[p for m in parts for p in m.priorities],
            tbt=[t for m in parts for t in m.tbt],
            deadline_slack=[s for m in parts for s in m.deadline_slack],
            req_tokens=[n for m in parts for n in m.req_tokens],
            n_shed=sum(m.n_shed for m in parts),
            shed_priorities=[p for m in parts for p in m.shed_priorities],
            shed_reasons=[s for m in parts for s in m.shed_reasons],
            n_retries=sum(m.n_retries for m in parts),
            retry_priorities=[p for m in parts
                              for p in m.retry_priorities],
            n_redispatched=sum(m.n_redispatched for m in parts),
            redispatch_priorities=[p for m in parts
                                   for p in m.redispatch_priorities],
            n_replica_kills=sum(m.n_replica_kills for m in parts),
            n_replica_recoveries=sum(
                m.n_replica_recoveries for m in parts),
            rids=[r for m in parts for r in m.rids],
            shed_rids=[r for m in parts for r in m.shed_rids],
        )

    @property
    def mean_ttft(self):
        return statistics.mean(self.ttft) if self.ttft else 0.0

    @property
    def p99_ttft(self):
        """Nearest-rank p99 over the pooled raw series (int(0.99*n) was
        an off-by-one that indexed the MAX at n=100)."""
        return pooled_percentile(self.ttft, 0.99)

    @property
    def p99_tbt(self):
        return pooled_percentile(self.tbt, 0.99)

    @property
    def mean_tbt(self):
        vals = [t for t in self.tbt if t > 0]
        return statistics.mean(vals) if vals else 0.0

    @property
    def deadline_violations(self) -> int:
        return sum(1 for s in self.deadline_slack if s < 0)

    @property
    def deadline_violation_rate(self) -> float:
        return self.deadline_violations / max(len(self.deadline_slack), 1)

    @property
    def goodput(self) -> float:
        """Tokens/s from requests that met their first-token deadline
        (tokens that arrive too late to matter don't count — the
        SLO-attainment throughput the deadline scheduler optimizes)."""
        if self.makespan <= 0:
            return 0.0
        good = sum(n for n, s in zip(self.req_tokens, self.deadline_slack,
                                     strict=True) if s >= 0)
        return good / self.makespan

    @staticmethod
    def _tenant_of(rid: str) -> int:
        """Tenant id encoded in a multi-tenant rid (``t{k}r{i}``);
        -1 for rids outside that convention (single-tenant runs)."""
        m = re.match(r"^t(\d+)r\d+$", rid)
        return int(m.group(1)) if m else -1

    def class_report(self, by: str = "priority") -> dict:
        """Per-class metrics, computed by slicing the ALIGNED raw series
        and running the same pooled nearest-rank path as the
        cluster-wide percentiles (never recomputed from pre-truncated
        per-replica statistics). `by="priority"` (default) keys on the
        priority class; `by="tenant"` keys on the tenant id parsed from
        rids shaped ``t{k}r{i}`` (everything else pools under -1) —
        per-tenant tail latency and goodput from ONE run's series. Each
        entry reports n / mean+p99 TTFT / p99 TBT / deadline-violation
        rate / goodput share (tokens per second from deadline-met
        requests) / requests shed under overload; priority entries add
        the remaining fault-tolerance counters (dispatch retries,
        kill-restart re-dispatches — which classes degradation actually
        lands on), which are tracked per priority only."""
        if by == "tenant":
            keys = [self._tenant_of(r) for r in self.rids]
            shed_keys = [self._tenant_of(r) for r in self.shed_rids]
            retry_keys: List[int] = []
            redispatch_keys: List[int] = []
        elif by == "priority":
            keys = self.priorities
            shed_keys = self.shed_priorities
            retry_keys = self.retry_priorities
            redispatch_keys = self.redispatch_priorities
        else:
            raise ValueError(
                f"class_report: unknown axis {by!r} "
                "(expected 'priority' or 'tenant')")
        out: dict = {}
        classes = set(keys) | set(shed_keys) | set(retry_keys) \
            | set(redispatch_keys)
        for cls_id in sorted(classes):
            idx = [i for i, p in enumerate(keys) if p == cls_id]
            ttft = [self.ttft[i] for i in idx]
            slack = [self.deadline_slack[i] for i in idx]
            toks = [self.req_tokens[i] for i in idx]
            entry = {
                "n": len(idx),
                "mean_ttft": statistics.mean(ttft) if ttft else 0.0,
                "p99_ttft": pooled_percentile(ttft, 0.99),
                "p99_tbt": pooled_percentile(
                    [self.tbt[i] for i in idx], 0.99),
                "deadline_violation_rate":
                    sum(1 for s in slack if s < 0) / max(len(slack), 1),
                "goodput": (sum(n for n, s in zip(toks, slack, strict=True)
                                if s >= 0) / self.makespan)
                    if self.makespan > 0 else 0.0,
                "n_shed": sum(1 for p in shed_keys if p == cls_id),
            }
            if by == "priority":
                entry["n_retries"] = sum(
                    1 for p in retry_keys if p == cls_id)
                entry["n_redispatched"] = sum(
                    1 for p in redispatch_keys if p == cls_id)
            out[cls_id] = entry
        return out

    @property
    def prefix_hit_rate(self):
        return self.prefix_hit_tokens / self.prefix_lookup_tokens \
            if self.prefix_lookup_tokens else 0.0

    @property
    def mean_tpot(self):
        vals = [t for t in self.tpot if t > 0]
        return statistics.mean(vals) if vals else 0.0

    @property
    def mean_queuing(self):
        return statistics.mean(self.queuing) if self.queuing else 0.0

    @property
    def mean_prefill(self):
        return statistics.mean(self.prefill_lat) if self.prefill_lat else 0.0

    @property
    def throughput(self):
        return self.tokens_out / self.makespan if self.makespan > 0 else 0.0

    @property
    def violation_rate(self):
        return self.slo_violations / max(self.n_requests, 1)


class DeviceMemoryError(ValueError):
    """Params + activation reservation exceed the device memory budget."""


def derive_device_blocks(cfg: ModelConfig, hw: HWProfile,
                         sim: ServeConfig) -> Blocks:
    """vLLM-style profiling: KV pool = gpu_mem_util * (mem - params -
    activations(max_model_len)); longer max context -> more activation
    reservation -> fewer KV blocks (paper §2.2). Raises DeviceMemoryError
    (naming the shortfall) instead of silently returning a zero-block pool
    that would later die with a confusing scheduling deadlock."""
    L = max(cfg.n_attention_layers(), 1)
    param_bytes = cfg.param_count() * hw.f_precision
    act_bytes = 2 * sim.max_model_len * cfg.d_model * 24 * hw.f_precision
    budget = hw.mem_bytes * sim.gpu_mem_util
    free = budget - param_bytes - act_bytes
    kv_per_block = 2 * cfg.n_kv_heads * cfg.resolved_head_dim \
        * hw.f_precision * sim.block_size  # one layer's block
    blocks = int(free // kv_per_block) // L * L if free > 0 else 0
    if blocks < L:
        raise DeviceMemoryError(
            f"no room for a KV pool on {hw.name}: memory budget "
            f"{budget / 1e9:.2f} GB (mem {hw.mem_bytes / 1e9:.1f} GB x "
            f"gpu_mem_util {sim.gpu_mem_util}) - params "
            f"{param_bytes / 1e9:.2f} GB - activation reservation "
            f"{act_bytes / 1e9:.2f} GB (max_model_len={sim.max_model_len}) "
            f"leaves {free / 1e9:.2f} GB, but one block per layer needs "
            f"{L * kv_per_block / 1e9:.2f} GB ({L} layers x {kv_per_block} "
            f"B). Lower max_model_len, raise gpu_mem_util, shard over more "
            f"chips, or set num_device_blocks explicitly.")
    return blocks


class ServingSimulator(CoreDelegateMixin):
    """The discrete-event serving backend: drives the shared
    `SchedulerCore` with step latencies priced by `CostModel` instead
    of real forwards — same decisions as `LayerKVEngine`, no JAX
    dependency. This is what the benchmarks and policy studies run."""

    produces_token_ids = False   # step latencies are modeled; the token
    #                              stream carries ordinals, not real ids

    def __init__(self, cfg: ModelConfig, hw: HWProfile, sim: ServeConfig,
                 predictor: Optional[LengthPredictor] = None,
                 alpha: float = 1.15, beta: float = 1.1):
        self.cfg = cfg
        self.hw = hw
        self.sim = sim.validate()
        self.cost = CostModel(cfg, hw, alpha=alpha, beta=beta)
        self.L = max(cfg.n_attention_layers(), 1)
        ndb = sim.num_device_blocks or derive_device_blocks(cfg, hw, sim)
        self.bm = LayerwiseBlockManager(ndb, sim.num_host_blocks,
                                        sim.block_size, self.L,
                                        prefix_cache=sim.prefix_cache)
        self.off = OffloadEngine(self.cost, self.L)
        self.predictor = predictor or OraclePredictor(
            [64, 128, 256, 512, 1024])
        self.sched = SLOScheduler(self.cost, self.predictor)
        self.fc = AvailabilityForecast(self.predictor, sim.block_size)
        # cache-driven physical copies (COW / promote / demote) charge the
        # link ledger in the core; d2d copies never touch the offload link
        self.core = SchedulerCore(
            self.sim, self.cost, self.bm, self.off, self.sched, self.L,
            reserve_blocks=int(sim.forecast_threshold_frac * ndb))
        self._chunk_iters = 0
        self._max_iter_prefill_tokens = 0

    @property
    def preemptions(self) -> int:
        """vLLM recompute-preemptions (core registry-backed)."""
        return int(self.core.registry.get("preemptions", kind="recompute"))

    # --------------------------------------------- shared-core delegation
    # queues/host_layers/clock()/advance_to() come from CoreDelegateMixin
    @property
    def t(self) -> Seconds:
        return self.core.now

    @t.setter
    def t(self, v: Seconds) -> None:
        self.core.now = v

    @property
    def plans(self):
        return self.core.plans

    @property
    def reload_bytes_migrated(self) -> Bytes:
        return self.core.reload_bytes_migrated

    def finish(self) -> None:
        self.bm.check()

    def cancel(self, r: Request) -> bool:
        return self.core.cancel(r, self.t)

    # ------------------------------------------------------------ helpers
    def _prefill_cost(self, r: Request) -> Seconds:
        """Eq.3 prefill compute for the UNCACHED part of r's prompt (the
        cached prefix, r.prefill_done at admission, skips compute)."""
        c = r.prefill_done
        return self.cost.chunk_prefill_time(r.prompt_len - c, c)

    def _finish_prefill(self, r: Request) -> None:
        """Prefill-complete bookkeeping shared by every admission path:
        publish the prompt's full blocks into the prefix cache."""
        if self.sim.prefix_cache and r.prompt:
            self.bm.register_prefix(r.rid, r.prompt)

    def _promote(self, now: Seconds, dt: Seconds,
                 decoding: List[Request]) -> None:
        """Swap host-resident layers back to device while blocks and link
        bandwidth allow (paper: 'maximizing the number of layers retained
        on the GPU'). Budget: what the link can move within one step.

        Accounting: each promoted byte is charged to the link ledger
        exactly once, here. Callers must recompute the decode step's
        host_kv_bytes AFTER promotion (from the post-promotion host_layers)
        so promoted bytes are not ALSO charged as per-step host streaming —
        double-charging inflated busy_until and delayed later prefill
        offload completions."""
        reserve = int(2 * self.sim.forecast_threshold_frac
                      * self.bm.pools[DEVICE].num_blocks)
        budget = self.cost.hw.offload_bw * max(dt, 1e-6)
        room = True
        for r in sorted(decoding, key=lambda q: q.prefill_start):
            if budget <= 0 or not room:
                break
            host = self.bm.layers_on(r.rid, HOST)
            if not host:
                continue
            for l in host:
                if budget <= 0:
                    break
                a = self.bm.allocation(r.rid, l)
                # charge the bytes actually resident in the allocation
                # (ctx-1 during a step: this step's token isn't written yet)
                per_layer_bytes = self.cost.kv_bytes(a.num_tokens, 1)
                if self.bm.num_free(DEVICE) < len(a.blocks) + reserve:
                    room = False
                    break
                self.bm.move_layer(r.rid, l, DEVICE)
                self.off.ledger.submit(now, per_layer_bytes, "reload")
                self.core.reload_bytes_migrated += per_layer_bytes
                budget -= per_layer_bytes
            self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))

    def _extend_for_token(self, r: Request) -> bool:
        """Grow allocations by one token across all layers; False if the
        device pool is exhausted (caller preempts)."""
        try:
            for l in list(self.bm.tables[r.rid]):
                self.bm.extend_layer(r.rid, l, 1)
            return True
        except PoolExhausted:
            return False

    def _preempt(self, r: Request, t: Seconds):
        """vLLM recompute-preemption: drop all KV, requeue at the FRONT."""
        self.bm.free_request(r.rid)
        self.host_layers.pop(r.rid, None)
        r.phase = Phase.QUEUED
        r.tokens_out = 0
        r.first_token_time = -1.0
        r.prefill_done = 0
        r.n_chunks = 0
        r.cached_prompt_len = 0
        r.n_preempted += 1
        self.waiting.appendleft(r)
        self.core.registry.inc("preemptions", kind="recompute")
        if self.core.tracer is not None:
            self.core.tracer.preempt(r, t, mode="recompute")

    def _select_decode_batch(self, now: Seconds,
                             decoding: List[Request]) -> tuple:
        """Pick this iteration's running batch. Device-resident requests
        always run; host-resident ones join only while their layer-wise
        h2d streaming stays hideable under the step's HBM-bound compute
        (paper §4 overlap), most-behind-on-TPOT first. The rest pause this
        iteration — their TPOT *average* is protected by Eq.1 admission.
        vLLM policy: everything is device-resident, so sel == decoding."""
        if self.sim.policy == "vllm":
            return list(decoding), 0.0

        def urgency(r):
            return r.tpot_slo - r.current_tpot(now)  # ascending: worst first

        cand = sorted(decoding, key=urgency)
        avg_ctx = sum(r.prompt_len + r.tokens_out for r in cand) / len(cand)
        t_est = self.cost.decode_step_time(len(cand), int(avg_ctx), 0.0)
        budget = self.cost.hw.offload_bw * t_est * 0.9
        sel, used = [], 0.0
        for r in cand:
            hb = self.cost.kv_bytes(r.prompt_len + r.tokens_out,
                                    self.host_layers.get(r.rid, 0))
            if hb == 0.0:
                sel.append(r)
            elif hb <= budget:
                sel.append(r)
                budget -= hb
                used += hb
        if not sel:  # progress guarantee: run the most urgent one anyway
            r = cand[0]
            used = self.cost.kv_bytes(r.prompt_len + r.tokens_out,
                                      self.host_layers.get(r.rid, 0))
            sel = [r]
        return sel, used

    def _evict_for_space(self, now: Seconds, decoding: List[Request],
                         min_free_blocks: Blocks = 64):
        """Emergency eviction: move device layers of the most recently
        admitted requests to host until some headroom exists."""
        for r in sorted(decoding, key=lambda q: -q.prefill_start):
            if self.bm.num_free(DEVICE) >= min_free_blocks:
                return
            dev_layers = self.bm.layers_on(r.rid, DEVICE)
            ctx = self.bm.allocation(r.rid, dev_layers[0]).num_tokens \
                if dev_layers else 0
            for l in dev_layers:
                a = self.bm.allocation(r.rid, l)
                if self.core.host_free() < len(a.blocks):
                    return  # host tier full: nothing more to evict into
                # detach: shared prefix blocks are copied out, never pulled
                # from under the requests still mapping them
                self.bm.move_layer(r.rid, l, HOST, detach=True)
                if self.bm.num_free(DEVICE) >= min_free_blocks:
                    break
            moved = len(dev_layers) - len(self.bm.layers_on(r.rid, DEVICE))
            if moved:
                self.off.proactive_offload(now, ctx, moved)
                self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))

    def _proactive_evict(self, now: Seconds,
                         decoding: List[Request]):
        """Eq.5: if the forecast dips below threshold, offload retained
        layers of the most recent requests (x/2 first, then all)."""
        thresh = int(self.sim.forecast_threshold_frac
                     * self.bm.pools[DEVICE].num_blocks)
        if not self.fc.needs_proactive_offload(
                self.bm.num_free(DEVICE), decoding,
                self.sim.forecast_horizon, thresh):
            return
        for r in sorted(decoding, key=lambda q: -q.prefill_start):
            dev_layers = self.bm.layers_on(r.rid, DEVICE)
            if not dev_layers:
                continue
            n_evict = max(len(dev_layers) // 2, 1)
            ctx = self.bm.allocation(r.rid, dev_layers[0]).num_tokens
            moved = 0
            for l in dev_layers[:n_evict]:
                a = self.bm.allocation(r.rid, l)
                if self.core.host_free() < len(a.blocks):
                    break  # host tier full: stop evicting
                self.bm.move_layer(r.rid, l, HOST, detach=True)
                moved += 1
            if not moved:
                return
            self.host_layers[r.rid] = len(self.bm.layers_on(r.rid, HOST))
            self.off.proactive_offload(now, ctx, moved)
            if self.bm.num_free(DEVICE) >= thresh:
                break

    # ------------------------------------------------------ shared pieces
    def _decode_bookkeep(self, t: Seconds, sel: List[Request]) -> None:
        """Post-step accounting for one decode batch: grow allocations,
        evict-or-preempt on exhaustion, retire finished requests."""
        finished: List[Request] = []
        for r in sel:
            ok = self._extend_for_token(r)
            if not ok and self.sim.policy == "layerkv":
                # evict device layers (newest requests first) to host
                # instead of preempting (paper §3.1.1)
                self._evict_for_space(t, self.decoding)
                ok = self._extend_for_token(r)
            if not ok:
                self._preempt(r, t)
                self.decoding.remove(r)
                continue
            r.tokens_out += 1
            r.note_token(t)
            if r.tokens_out >= r.output_len:
                r.finish_time = t
                r.phase = Phase.FINISHED
                self.bm.free_request(r.rid)
                self.core.release(r)
                self.predictor.observe(r.output_len)
                self.done.append(r)
                finished.append(r)
                if self.core.tracer is not None:
                    self.core.tracer.finish(r, t)
        for r in finished:
            self.decoding.remove(r)

    def _metrics(self, done: List[Request]) -> SimMetrics:
        mk = max((r.finish_time for r in done), default=0.0)
        return SimMetrics(
            ttft=[r.ttft for r in done],
            queuing=[r.queuing_delay for r in done],
            prefill_lat=[r.prefill_latency for r in done],
            tpot=[r.tpot for r in done],
            finish_times=[r.finish_time for r in done],
            # tokens_salvaged: delivered by incarnations a replica kill
            # destroyed — still real output of this request
            tokens_out=sum(r.tokens_out + r.tokens_salvaged for r in done),
            makespan=mk,
            slo_violations=sum(1 for r in done if r.slo_violated()),
            n_requests=len(done),
            # recompute-preemptions (vLLM path) + lossless pause/resume
            preemptions=self.preemptions + self.core.n_preempted,
            priorities=[r.priority for r in done],
            tbt=[r.max_tbt for r in done],
            deadline_slack=[r.effective_deadline - r.first_token_time
                            for r in done],
            req_tokens=[r.tokens_out + r.tokens_salvaged for r in done],
            chunk_iters=self._chunk_iters,
            max_iter_prefill_tokens=self._max_iter_prefill_tokens,
            prefix_hit_tokens=self.bm.cache.hit_tokens
            if self.bm.cache else 0,
            prefix_lookup_tokens=self.bm.cache.lookup_tokens
            if self.bm.cache else 0,
            n_cancelled=len(self.core.cancelled),
            n_shed=len(self.core.shed),
            shed_priorities=[r.priority for r in self.core.shed],
            shed_reasons=[r.shed_reason or "" for r in self.core.shed],
            rids=[r.rid for r in done],
            shed_rids=[r.rid for r in self.core.shed],
        )

    def metrics(self) -> SimMetrics:
        """Metrics over everything finished so far (session use)."""
        return self._metrics(self.done)

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One engine-step iteration at the current clock. Returns False
        when fully idle (nothing admissible, nothing in flight)."""
        out = self._step_chunked() if self.sim.chunked \
            else self._step_exclusive()
        if self.core.sanitizer is not None:
            self.core.sanitizer.check(self.core)
        return out

    def _step_exclusive(self) -> bool:
        """vLLM 0.5.5 engine-step: prefills stall the decode batch."""
        t = self.t
        admitted = self.core.admit_waiting(
            t, token_budget=self.sim.max_prefill_tokens)

        if admitted:
            # prefills run exclusively (vLLM 0.5.5 semantics); cached
            # prefixes skip their share of the Eq.3 compute. The TP
            # all-reduce reserves the link FIRST (§3.1.3) so this
            # batch's d2h offload traffic defers around it.
            for r in admitted:
                r.phase = Phase.PREFILL
                r.prefill_start = t
            dt = sum(self._prefill_cost(r) for r in admitted)
            if self.sim.collective_reserve_frac > 0.0:
                self.off.ledger.reserve(
                    t, self.sim.collective_reserve_frac * dt)
            if self.sim.policy == "layerkv":
                for r in admitted:
                    n_off = self.host_layers.get(r.rid, 0)
                    if n_off:
                        self.off.ledger.submit(
                            t, self.cost.kv_bytes(r.prompt_len, n_off),
                            "offload")
            t += dt
            self.t = t
            for r in admitted:
                # preserved across a replica-kill restart: the user saw
                # their first token from the dead incarnation already
                if r.first_token_time < 0:
                    r.first_token_time = t
                    if self.core.tracer is not None:
                        self.core.tracer.first_token(r, t)
                r.tokens_out = 1
                r.note_token(t)
                r.prefill_done = r.prompt_len
                r.n_chunks += 1
                r.phase = Phase.DECODE
                self._finish_prefill(r)
                self.decoding.append(r)
            return True

        if self.decoding:
            if self.sim.policy == "layerkv" and self.sim.proactive:
                self._proactive_evict(t, self.decoding)
            sel, host_bytes = self._select_decode_batch(t, self.decoding)
            B = len(sel)
            avg_ctx = sum(r.prompt_len + r.tokens_out for r in sel) / B
            if self.sim.policy == "layerkv":
                # promote against an ESTIMATED step time, then price
                # the step from what is STILL host-resident: promoted
                # bytes are charged once (to the ledger, in _promote),
                # never again as per-step host streaming
                dt_est = self.cost.decode_step_time(
                    B, int(avg_ctx), host_bytes)
                self._promote(t, dt_est, self.decoding)
                host_bytes = sum(
                    self.cost.kv_bytes(r.prompt_len + r.tokens_out,
                                       self.host_layers.get(r.rid, 0))
                    for r in sel)
            dt = self.cost.decode_step_time(B, int(avg_ctx), host_bytes)
            t += dt
            self.t = t
            self._decode_bookkeep(t, sel)
            return True

        return False

    def _step_chunked(self) -> bool:
        """One chunked-prefill iteration: admission into the chunk queue,
        then up to `max_prefill_tokens` prompt-chunk tokens (FCFS across
        in-flight prefills, Eq.1-tightened when slo_aware) batched WITH
        the decode tokens; costs max(chunk compute, decode compute)."""
        t = self.t
        self.core.admit_waiting(t)
        if not (self.prefilling or self.decoding):
            return False

        if self.sim.policy == "layerkv" and self.sim.proactive:
            self._proactive_evict(t, self.decoding)
        sel: List[Request] = []
        host_bytes = 0.0
        avg_ctx = 0
        if self.decoding:
            sel, host_bytes = self._select_decode_batch(t, self.decoding)
            avg_ctx = int(sum(r.prompt_len + r.tokens_out for r in sel)
                          / len(sel))

        chunks = self.core.assemble_chunks(t, len(sel))
        t_chunk = sum(self.cost.chunk_prefill_time(c, r.prefill_done)
                      for r, c in chunks)
        # §3.1.3: the TP all-reduce of the chunk compute reserves the
        # link BEFORE this iteration's d2h traffic is submitted
        if t_chunk > 0.0 and self.sim.collective_reserve_frac > 0.0:
            self.off.ledger.reserve(
                t, self.sim.collective_reserve_frac * t_chunk)

        # chunk-granular d2h: each chunk's offloaded-layer KV enters
        # the link ledger as it is produced, overlapping chunk compute
        if self.sim.policy == "layerkv":
            for r, c in chunks:
                n_off = self.host_layers.get(r.rid, 0)
                if n_off:
                    self.off.ledger.submit(
                        t, self.cost.kv_bytes(c, n_off), "offload")

        if self.sim.policy == "layerkv" and self.decoding:
            # promote against an estimate, then re-price host streaming
            # from post-promotion residency (each byte charged once)
            dt_est = self.cost.mixed_step_time(t_chunk, len(sel),
                                               avg_ctx, host_bytes,
                                               fused=self.sim.fused)
            self._promote(t, dt_est, self.decoding)
            host_bytes = sum(
                self.cost.kv_bytes(r.prompt_len + r.tokens_out,
                                   self.host_layers.get(r.rid, 0))
                for r in sel)
        dt = self.cost.mixed_step_time(t_chunk, len(sel), avg_ctx,
                                       host_bytes, fused=self.sim.fused)
        t0 = t
        t += dt
        self.t = t
        if self.core.tracer is not None:
            # before the bookkeeping below mutates prefill_done
            self.core.tracer.chunk_iteration(self.core, t0, t, chunks)

        if chunks:
            self._chunk_iters += 1
            self._max_iter_prefill_tokens = max(
                self._max_iter_prefill_tokens,
                sum(c for _, c in chunks))
        for r, c in chunks:
            r.prefill_done += c
            r.n_chunks += 1
            if self.sim.prefix_cache and r.prompt:
                # incremental publication, mirroring the engine: full
                # blocks written so far become hittable immediately
                self.bm.register_prefix(r.rid, r.prompt,
                                        upto=r.prefill_done)
            if r.prefill_complete:
                if r.first_token_time < 0:  # survives replica-kill restart
                    r.first_token_time = t
                    if self.core.tracer is not None:
                        self.core.tracer.first_token(r, t)
                r.tokens_out = 1
                r.note_token(t)
                r.phase = Phase.DECODE
                self.prefilling.remove(r)
                self.decoding.append(r)

        self._decode_bookkeep(t, sel)
        return True

    # ---------------------------------------------------------------- run
    def run(self, requests: List[Request]) -> SimMetrics:
        """Batch convenience wrapper: one session, every request submitted
        up front at its own arrival, drained to completion."""
        self._chunk_iters = 0
        self._max_iter_prefill_tokens = 0
        session = ServingSession(self)
        for r in sorted(requests, key=lambda q: q.arrival):
            session.submit(r, arrival=r.arrival)
        session.drain()
        return self._metrics(self.done)
