"""SLO-aware scheduler (paper §3.1, Algorithm 1).

Decides, at each scheduling event, how many queued requests' prefill stages
may run *now* without pushing any currently-decoding request past its TPOT
SLO. The slack of decoding request i (Eq. 1):

    T_allow^i = T_tpot^i * (N_past^i + N_future^i) - (T_past^i + T_future^i)

and prefills q_1..q_n are admitted while  sum_k T_prefill(q_k) < min_i
T_allow^i  (Eq. 2), with T_prefill estimated by the Eq. 3 cost model and
N_future by the bucketed length predictor.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Optional, Sequence

from repro_torch.core.predictor import LengthPredictor
from repro_torch.core.units import Bytes, Seconds, Tokens, bytes_to_seconds

if TYPE_CHECKING:  # pragma: no cover — import cycle (serving -> core)
    from repro_torch.serving.costmodel import CostModel
    from repro_torch.serving.request import Request


@dataclasses.dataclass
class SLOScheduler:
    cost: CostModel
    predictor: LengthPredictor
    # requests with no TPOT headroom would block admissions forever; the
    # paper's fairness guarantee comes from admitting at least one prefill
    # whenever no decode slack is violated *yet* — keep a small floor.
    min_admit_when_idle: int = 1

    # ------------------------------------------------------------------ Eq.1
    def allow_prefill_budget(self, decoding: Sequence[Request], now: Seconds
                             ) -> Seconds:
        """min_i T_allow^i over decoding requests; +inf if none decoding."""
        budget = float("inf")
        for r in decoding:
            n_future = self.predictor.n_future(r, r.n_past)
            cur = r.current_tpot(now)
            if cur <= 0.0:
                cur = self.cost.decode_step_time(max(len(decoding), 1),
                                                 r.prompt_len)
            t_future = cur * n_future
            t_allow = r.tpot_slo * (r.n_past + n_future) \
                - (r.t_past(now) + t_future)
            budget = min(budget, t_allow)
        return budget

    # ------------------------------------------------------------- Alg.1
    def max_prefills(self, queue: Sequence[Request],
                     decoding: Sequence[Request], now: Seconds,
                     cached_len: Optional[Callable[[Request], Tokens]] = None
                     ) -> int:
        """Maximum n such that the first n queued prefills fit in the
        minimum TPOT slack (Eq. 2). `queue` arrives in the caller's
        admission order — FCFS by default (paper §1: no reordering, no
        starvation), or an `AdmissionPolicy` ordering (e.g. prefix_aware,
        whose bounded aging window carries the no-starvation guarantee
        instead). Since hits price only their uncached suffix, a
        hits-first order also fits MORE prefills into the same slack.
        `cached_len(q)` reports the prompt tokens a prefix-cache hit
        would skip: the Eq.3 estimate must price only the UNCACHED
        suffix, or admission over-throttles exactly the workloads the
        cache accelerates (chunk_prefill_time(p, 0) == prefill_time(p),
        so the uncached case telescopes to the original estimate)."""
        if not queue:
            return 0
        budget = self.allow_prefill_budget(decoding, now)
        if not decoding:
            return len(queue)  # nothing to protect
        total, n = 0.0, 0
        for q in queue:
            c = cached_len(q) if cached_len is not None else 0
            total += self.cost.chunk_prefill_time(q.prompt_len - c, c)
            if total < budget:
                n += 1
            else:
                break
        return n

    # ------------------------------------------------- preemption pricing
    def preempt_slack(self, r: Request, now: Seconds) -> Seconds:
        """Deadline slack of one request, for victim selection:

          * not yet decoding — first-token headroom, its effective
            deadline minus `now` (a prefill-phase victim loses TTFT);
          * decoding — its own Eq.1 T_allow (a decode-phase victim loses
            inter-token time against its TPOT SLO).

        Negative slack means the request is already past its budget."""
        if r.first_token_time < 0:
            return r.effective_deadline - now
        return self.allow_prefill_budget([r], now)

    def victim_affordable(self, r: Request, now: Seconds,
                          resume_bytes: Bytes, offload_bw: float) -> bool:
        """Can `r` absorb being preempted without blowing its own SLO?
        The price of pausing r is the h2d promotion it must later pay to
        resume (its whole KV crossing the offload link back); affordable
        means that reload time fits inside r's current deadline slack.
        The preemption controller prefers affordable victims and touches
        unaffordable ones only for a preemptor that is itself already
        past its deadline."""
        return self.preempt_slack(r, now) \
            >= bytes_to_seconds(resume_bytes, max(offload_bw, 1e-9))

    # ------------------------------------------------- chunked prefill budget
    def max_chunk_tokens(self, decoding: Sequence[Request], now: Seconds,
                         cap: Tokens, floor: Tokens = 16) -> Tokens:
        """Per-iteration prefill-TOKEN budget for chunked prefill (the
        token-budget analogue of Alg.1). With mixed batching decodes are
        not stalled by a prefill, but the iteration stretches to the chunk
        compute time — so the chunk is sized to fit the minimum Eq.1 TPOT
        slack. A small floor guarantees prefill progress (same fairness
        rationale as `min_admit_when_idle`); `cap` is the engine's
        max_prefill_tokens."""
        if not decoding:
            return cap
        slack = self.allow_prefill_budget(decoding, now)
        if slack == float("inf"):
            return cap
        if slack <= 0.0:
            return min(floor, cap)
        # Eq.3 linear term gives a conservative (attention-free) per-token
        # cost; inverting it bounds the chunk that fits in the slack.
        per_token = self.cost.chunk_prefill_time(1, 0)
        n = int(slack / max(per_token, 1e-12))
        return max(min(floor, cap), min(cap, n))
