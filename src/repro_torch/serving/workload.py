"""Workload generators for the serving benchmarks.

`sharegpt_like` mirrors the ShareGPT trace statistics the paper uses
(conversations collected from ChatGPT-3.5: prompt/output lengths 4-2.3k
tokens, heavy-tailed) without requiring the dataset download in this
offline container: lognormal lengths clipped to the paper's range.

`shared_prefix` generates the scenario class the prefix cache targets:
requests whose prompts share leading tokens (system prompts, multi-turn
chat, RAG templates). These requests carry REAL token-id lists in
`Request.prompt` — the content-addressed cache hashes them, in both the
simulator and the real engine.

`multi_tenant` generates the traffic class the cluster ROUTER targets:
per-tenant shared-prefix templates with bursty on-off arrivals and a
skewed (Zipf) tenant popularity, so prefix-affinity dispatch (keep a
tenant's template on one replica's cache) versus load-aware dispatch
(spread the burst) is a real trade-off rather than a tie.
"""
from __future__ import annotations

import random
from typing import List

from repro_torch.serving.request import Request


def fixed_length(n: int, prompt_len: int, output_len: int, rate: float,
                 seed: int = 0, tpot_slo: float = 0.2, ttft_slo: float = 3.0
                 ) -> List[Request]:
    """Poisson arrivals at `rate` req/s with fixed prompt/output lengths
    (paper Fig. 1/4/5 methodology)."""
    rng = random.Random(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.expovariate(rate)
        out.append(Request(rid=f"r{i}", prompt_len=prompt_len,
                           output_len=output_len, arrival=t,
                           tpot_slo=tpot_slo, ttft_slo=ttft_slo))
    return out


def sharegpt_like(n: int, rate: float, seed: int = 0, tpot_slo: float = 0.2,
                  ttft_slo: float = 3.0, min_len: int = 4,
                  max_len: int = 2300) -> List[Request]:
    """Heavy-tailed prompt/output lengths in the ShareGPT range."""
    rng = random.Random(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.expovariate(rate)
        p = int(min(max(rng.lognormvariate(5.6, 1.1), min_len), max_len))
        o = int(min(max(rng.lognormvariate(5.1, 0.9), min_len), max_len))
        out.append(Request(rid=f"r{i}", prompt_len=p, output_len=o,
                           arrival=t, tpot_slo=tpot_slo, ttft_slo=ttft_slo))
    return out


def _toks(rng: random.Random, n: int, vocab: int) -> List[int]:
    return [rng.randrange(vocab) for _ in range(n)]


def shared_prefix(n: int, rate: float, scenario: str = "system_prompt",
                  share_ratio: float = 0.5, prompt_len: int = 1024,
                  output_len: int = 128, n_templates: int = 4,
                  turns_per_conv: int = 4, vocab_size: int = 32000,
                  seed: int = 0, tpot_slo: float = 0.2,
                  ttft_slo: float = 3.0,
                  unique_frac: float = 0.0) -> List[Request]:
    """Poisson arrivals whose prompts share leading tokens.

    scenario:
      'system_prompt'  every request = one global system prompt of
                       ~share_ratio * prompt_len tokens + a unique user
                       suffix (heavy shared-system-prompt traffic);
      'rag_template'   `n_templates` instruction/context templates; each
                       request picks one (so sharing splits across
                       template groups) + a unique query suffix;
      'multi_turn'     conversations of `turns_per_conv` requests; turn k's
                       prompt extends turn k-1's full context (prompt +
                       answer + new user turn), so the shareable prefix
                       GROWS within a conversation. share_ratio sets the
                       first turn's length relative to prompt_len.

    All scenarios draw the unique suffix length ~ +-25% around its mean so
    block-boundary effects (partial tails, COW) are exercised.

    `unique_frac` mixes in cache-cold traffic: that fraction of requests
    (system_prompt / rag_template scenarios) get a fully unique prompt
    with NO shared prefix — the workload class the prefix-aware admission
    policy must serve without starving (its aging bound)."""
    rng = random.Random(seed)
    out: List[Request] = []
    t = 0.0

    def _arrive() -> float:
        nonlocal t
        t += rng.expovariate(rate)
        return t

    if scenario in ("system_prompt", "rag_template"):
        shared_len = max(int(prompt_len * share_ratio), 1)
        k = 1 if scenario == "system_prompt" else max(n_templates, 1)
        prefixes = [_toks(rng, shared_len, vocab_size) for _ in range(k)]
        for i in range(n):
            sfx_mean = max(prompt_len - shared_len, 1)
            sfx = max(1, int(sfx_mean * rng.uniform(0.75, 1.25)))
            # NB: no RNG draw when unique_frac is 0 — the default stream
            # (and every committed benchmark artifact) stays bit-stable
            if unique_frac > 0.0 and rng.random() < unique_frac:
                prompt = _toks(rng, shared_len + sfx, vocab_size)
            else:
                prompt = prefixes[rng.randrange(k)] \
                    + _toks(rng, sfx, vocab_size)
            out.append(Request(
                rid=f"r{i}", prompt_len=len(prompt), output_len=output_len,
                arrival=_arrive(), tpot_slo=tpot_slo, ttft_slo=ttft_slo,
                prompt=prompt))
        return out

    if scenario == "multi_turn":
        i = 0
        first_len = max(int(prompt_len * share_ratio), 1)
        while i < n:
            ctx = _toks(rng, first_len, vocab_size)
            for _ in range(min(turns_per_conv, n - i)):
                turn = max(
                    1, int((prompt_len - first_len)
                           / max(turns_per_conv - 1, 1)
                           * rng.uniform(0.75, 1.25)))
                prompt = list(ctx) + _toks(rng, turn, vocab_size)
                out.append(Request(
                    rid=f"r{i}", prompt_len=len(prompt),
                    output_len=output_len, arrival=_arrive(),
                    tpot_slo=tpot_slo, ttft_slo=ttft_slo, prompt=prompt))
                # next turn continues from this prompt + its answer
                ctx = prompt + _toks(rng, output_len, vocab_size)
                i += 1
        out.sort(key=lambda r: r.arrival)
        return out

    raise ValueError(f"unknown shared-prefix scenario: {scenario!r}")


def multi_tenant(n: int, rate: float, n_tenants: int = 4,
                 share_ratio: float = 0.5, prompt_len: int = 1024,
                 output_len: int = 128, zipf_s: float = 1.0,
                 burst_on: float = 4.0, burst_off: float = 8.0,
                 burst_cv: float = 2.0, vocab_size: int = 32000,
                 seed: int = 0, tpot_slo: float = 0.2,
                 ttft_slo: float = 3.0,
                 interactive_tenants: int = 0,
                 interactive_ttft_slo: float = 0.0,
                 interactive_tpot_slo: float = 0.0) -> List[Request]:
    """Per-tenant shared-prefix templates under bursty on-off arrivals.

    Each of `n_tenants` tenants owns one template prefix of
    ~share_ratio * prompt_len tokens; a tenant's request = its template
    + a unique suffix (+-25% length jitter, as in `shared_prefix`, so
    partial tails and COW are exercised). Tenant popularity is Zipf:
    tenant k gets weight (k+1)^-zipf_s of the aggregate `rate`, so a
    couple of templates are HOT — the traffic that makes
    `prefix_affinity` concentrate (and need its spillover) while
    `least_loaded` scatters the hot template across every replica's
    cache.

    Arrivals are an independent on-off (interrupted-Poisson) process
    per tenant: exponential ON periods of mean `burst_on` seconds at
    `burst_cv / duty` x the tenant's average rate, separated by
    exponential OFF gaps with no arrivals. The OFF mean is stretched to
    `burst_cv * (burst_on + burst_off) - burst_on`, which exactly
    cancels the burst_cv intensity boost — the long-run average stays
    at the tenant's share of `rate` while burst_cv only sharpens the
    peak-to-mean ratio. Bursts from different tenants overlap at
    random, so instantaneous cluster load swings well above and below
    its mean — queueing behaviour a load-oblivious router cannot see.
    `burst_cv=1` with `burst_off=0` degenerates to plain Poisson per
    tenant.

    Priority classes (the KV-competition workload, arXiv 2503.13773):
    the first `interactive_tenants` tenants are the INTERACTIVE class —
    their requests carry `priority=1` and the (typically tighter)
    `interactive_ttft_slo` / `interactive_tpot_slo` (0 = inherit the
    batch values); the remaining tenants are the BATCH class at
    `priority=0`. Because the hot Zipf tenants come first, making them
    interactive reproduces the paper-style mix: a latency-critical hot
    class competing for KV with long-running batch traffic. The default
    `interactive_tenants=0` draws the identical RNG stream as before
    (class assignment is by tenant index, never by a draw), so every
    committed artifact stays bit-stable.

    Tenant quotas are apportioned by largest remainder so exactly `n`
    requests are returned, in arrival order, rids `t{tenant}r{i}` so
    tests and benchmarks can group by tenant."""
    if n_tenants < 1:
        raise ValueError("multi_tenant needs at least one tenant")
    rng = random.Random(seed)
    shared_len = max(int(prompt_len * share_ratio), 1)
    templates = [_toks(rng, shared_len, vocab_size)
                 for _ in range(n_tenants)]
    weights = [(k + 1) ** -zipf_s for k in range(n_tenants)]
    wsum = sum(weights)
    # largest-remainder apportionment: sum(quota) == n exactly
    quota = [n * w / wsum for w in weights]
    n_per = [int(q) for q in quota]
    for k in sorted(range(n_tenants), key=lambda k: quota[k] - n_per[k],
                    reverse=True)[: n - sum(n_per)]:
        n_per[k] += 1
    cv = max(burst_cv, 1.0)
    off_mean = cv * (burst_on + burst_off) - burst_on \
        if burst_on + burst_off > 0 else 0.0
    out: List[Request] = []
    for k in range(n_tenants):
        interactive = k < interactive_tenants
        k_prio = 1 if interactive else 0
        k_ttft = interactive_ttft_slo \
            if interactive and interactive_ttft_slo > 0 else ttft_slo
        k_tpot = interactive_tpot_slo \
            if interactive and interactive_tpot_slo > 0 else tpot_slo
        tenant_rate = rate * weights[k] / wsum
        # arrivals only flow during ON windows, at burst_cv/duty x the
        # tenant's average rate; the stretched OFF mean above restores
        # the long-run average to exactly tenant_rate
        duty = burst_on / (burst_on + burst_off) \
            if burst_on + burst_off > 0 else 1.0
        on_rate = tenant_rate * cv / max(duty, 1e-9)
        n_k = n_per[k]
        t = rng.expovariate(1.0 / max(off_mean, 1e-9)) \
            if off_mean > 0 else 0.0
        i = 0
        while i < n_k:
            burst_end = t + rng.expovariate(1.0 / max(burst_on, 1e-9))
            while i < n_k:
                t += rng.expovariate(on_rate)
                if t >= burst_end:
                    t = burst_end
                    break
                sfx_mean = max(prompt_len - shared_len, 1)
                sfx = max(1, int(sfx_mean * rng.uniform(0.75, 1.25)))
                prompt = templates[k] + _toks(rng, sfx, vocab_size)
                out.append(Request(
                    rid=f"t{k}r{i}", prompt_len=len(prompt),
                    output_len=output_len, arrival=t,
                    tpot_slo=k_tpot, ttft_slo=k_ttft, prompt=prompt,
                    priority=k_prio))
                i += 1
            t += rng.expovariate(1.0 / max(off_mean, 1e-9)) \
                if off_mean > 0 else 0.0
    out.sort(key=lambda r: (r.arrival, r.rid))
    return out
