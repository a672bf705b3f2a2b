"""Serving driver CLI for the PyTorch port: run the port's LayerKV engine
on a synthetic workload through a live `ClusterSession` — requests are
submitted online and every generated token is printed as its iteration
produces it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --smoke --policy layerkv --requests 16 --device-blocks 64

The flags are `repro.launch.serve`'s: --policy, --no-slo-aware,
--chunked, --fused (implies --chunked: one forward per iteration, chunks
attending straight over the paged pools), --prefix-cache, --preemption,
--admission, --interactive-every, --shed-overload, --trace, and the
cluster's: `--replicas N` engines behind a router (--router
round_robin|least_loaded|prefix_affinity|slo_aware; a cluster of 1 runs
the same code and streams the bare engine's tokens), `--fault-plan SPEC`
(deterministic failures on the shared virtual clock, grammar in
serving/faults.py) and `--liveness-timeout` (missing-heartbeat
detection). Every replica computes with the same weights, made once on
the device and shared: each engine gets the same tensors. `--device`
(default cuda) selects where it runs; without a CUDA device it raises
unless given `--device cpu`. Prints the per-token stream with its
replica, per-request TTFT, the fault summary and recovery log, a
per-replica line, and the offload-ledger summary summed over replicas.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--policy", default="layerkv",
                    choices=["layerkv", "vllm"])
    ap.add_argument("--no-slo-aware", action="store_true")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill + mixed batching (two calls)")
    ap.add_argument("--fused", action="store_true",
                    help="ONE forward per iteration, chunks + decode "
                         "sharing the weight stream (implies --chunked)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="ref-counted cross-request prefix sharing")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="per-iteration prefill token budget (chunked)")
    ap.add_argument("--admission", default="fcfs",
                    choices=["fcfs", "prefix_aware", "deadline"],
                    help="waiting-queue admission ordering")
    ap.add_argument("--preemption", action="store_true",
                    help="lossless priority preemption: pause "
                         "lower-priority KV to HOST, resume later "
                         "(pairs with --admission deadline)")
    ap.add_argument("--interactive-every", type=int, default=0,
                    help="every k-th request is interactive: priority 1, "
                         "TTFT SLO (and deadline) tightened 4x (0 = all "
                         "batch)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the cluster router")
    ap.add_argument("--router", default="round_robin",
                    choices=["round_robin", "least_loaded",
                             "prefix_affinity", "slo_aware"],
                    help="cluster dispatch policy (--replicas > 1)")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault injection, e.g. "
                         "'crash@0.5:r0:recover=1.0;wedge@0.2:r1:dur=0.3' "
                         "or 'random:SEED[:n=N]' (serving/faults.py)")
    ap.add_argument("--liveness-timeout", type=float, default=None,
                    help="kill any replica whose next due event lags the "
                         "shared clock by more than this many seconds "
                         "while frozen (heartbeat failure detection)")
    ap.add_argument("--shed-overload", action="store_true",
                    help="graceful degradation: shed blocked requests "
                         "with a typed reason instead of wedging")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--shared-len", type=int, default=0,
                    help="leading tokens shared by every prompt "
                         "(exercises --prefix-cache)")
    ap.add_argument("--output-len", type=int, default=16)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--device-blocks", type=int, default=64)
    ap.add_argument("--host-blocks", type=int, default=1024)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-token stream printout")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the full event stream and write "
                         "Chrome-trace JSON here at drain")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if not 0 <= args.shared_len < args.prompt_len:
        ap.error(f"--shared-len {args.shared_len} must be in "
                 f"[0, --prompt-len {args.prompt_len}): every prompt "
                 "needs at least one unique token")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serving.cluster import ClusterSession
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ServeConfig

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.RandomState(args.seed)
    shared = [int(x) for x in
              rng.randint(0, cfg.vocab_size, args.shared_len)]
    t = 0.0
    reqs = []
    for i in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        sfx = args.prompt_len - len(shared)
        interactive = args.interactive_every > 0 \
            and i % args.interactive_every == 0
        reqs.append(Request(
            rid=f"r{i}", prompt_len=args.prompt_len,
            output_len=args.output_len, arrival=t,
            priority=1 if interactive else 0,
            ttft_slo=3.0 / 4 if interactive else 3.0,
            prompt=shared + [int(x) for x in
                             rng.randint(0, cfg.vocab_size, sfx)]))

    sc = ServeConfig.for_engine(
        policy=args.policy,
        slo_aware=not args.no_slo_aware,
        chunked=args.chunked or args.fused,
        fused=args.fused,
        prefix_cache=args.prefix_cache,
        preemption=args.preemption,
        admission=args.admission,
        max_prefill_tokens=args.chunk_size,
        num_device_blocks=args.device_blocks,
        num_host_blocks=args.host_blocks,
        block_size=args.block_size,
        shed_overload=args.shed_overload,
        trace=bool(args.trace))
    plan = FaultPlan.parse(args.fault_plan, n_replicas=args.replicas) \
        if args.fault_plan else None
    if plan is not None:
        print("fault plan:")
        for line in plan.describe():
            print(f"  {line}")
    # every replica computes with the SAME weights (one seed, as the
    # reference's one PRNG key): the first engine makes them on the
    # device, the others get the same tensors — the executor never
    # writes its weights, so one copy serves the whole cluster
    engines = [LayerKVEngine(cfg, None, sc, device=args.device,
                             seed=args.seed)]
    engines += [LayerKVEngine(cfg, engines[0].ex.params, sc,
                              device=args.device)
                for _ in range(args.replicas - 1)]

    # submit everything up front (arrivals dispatch as the shared clock
    # reaches them) and pump the cluster one event at a time, printing
    # the token stream live as each iteration produces it
    session = ClusterSession(engines, router=args.router,
                             fault_plan=plan,
                             liveness_timeout=args.liveness_timeout)
    handles = [session.submit(r, arrival=r.arrival) for r in reqs]
    while session.step():
        for h in handles:
            new = h.take_new()
            if new and not args.quiet:
                star = "*" if h.request.cached_prompt_len else " "
                where = "?" if h.replica is None else h.replica
                print(f"[t={session.clock() * 1e3:9.3f}ms] {h.rid:>4}{star}"
                      f"@{where} +{len(new)} -> {new}")
    done = session.drain()

    ttfts = [r.ttft for r in done]
    print(f"policy={args.policy} chunked={args.chunked or args.fused} "
          f"fused={args.fused} prefix_cache={args.prefix_cache} "
          f"preemption={args.preemption} admission={args.admission} "
          f"replicas={args.replicas} router={args.router} "
          f"device={engines[0].ex.device}")
    if args.preemption:
        print(f"preemptions={sum(e.core.n_preempted for e in engines)} "
              f"resumes={sum(e.core.n_resumed for e in engines)}")
    if ttfts:
        print(f"requests={len(done)} "
              f"mean_ttft={statistics.mean(ttfts)*1e3:.1f}ms "
              f"p99_ttft={sorted(ttfts)[-1]*1e3:.1f}ms (virtual clock)")
    if session.recovery_log or plan is not None:
        shed = len(session.shed) \
            + sum(len(e.core.shed) for e in engines)
        print(f"faults: kills={session.n_kills} "
              f"recoveries={session.n_recoveries} "
              f"redispatched={len(session.redispatch_priorities)} "
              f"dispatch_retries={session.n_retries} shed={shed}")
        for line in session.recovery_log:
            print(f"  {line}")
    print(f"served={sum(len(e.core.done) for e in engines)}")
    for i, (eng, st) in enumerate(zip(engines, session.stats)):
        served = len(eng.core.done)
        hit = f"{eng.bm.cache.hit_rate:.2f}" \
            if eng.bm.cache is not None else "-"
        print(f"replica {i}: dispatched={st.dispatched} served={served} "
              f"iterations={st.steps} "
              f"peak_occupancy={st.peak_occupancy:.2f} "
              f"prefix_hit_rate={hit}")
    off = [x for eng in engines for x in eng.off.ledger.log
           if x.kind == "offload"]
    rel = [x for eng in engines for x in eng.off.ledger.log
           if x.kind == "reload"]
    print(f"layer-wise transfers: {len(off)} offloads "
          f"({sum(x.nbytes for x in off)/2**20:.2f} MiB), "
          f"{len(rel)} reloads "
          f"({sum(x.nbytes for x in rel)/2**20:.2f} MiB)")
    if args.trace:
        session.write_trace(args.trace)
        n_ev = sum(len(e.core.tracer.events) for e in engines) \
            + len(session.tracer.events)
        print(f"trace: {n_ev} events -> {args.trace} "
              "(load at ui.perfetto.dev)")
    if done:
        sample = done[0]
        print(f"sample output ({sample.rid}): {sample.generated[:8]}...")

if __name__ == "__main__":
    main()
