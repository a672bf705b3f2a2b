"""End-to-end serving comparison — the port of `examples/serve_comparison.py`:
LayerKV vs the request-wise (vLLM-style) policy on the SAME model and
workload, with real execution on the paged KV pools, driven through
`ServingSession` (online submit + drain).

Demonstrates the paper's two headline properties at smoke scale:
  1. losslessness — identical generated tokens under forced offloading;
  2. earlier admission — layer-wise allocation starts prefills sooner when
     the device pool is tight.

    PYTHONPATH=src python -m repro_torch.examples.serve_comparison \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import LayerKVEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ServeConfig
from repro_torch.serving.session import ServingSession


def config():
    """granite-3-2b's smoke config in f32."""
    return dataclasses.replace(get_smoke_config("granite-3-2b"),
                               dtype="float32")


def make_workload(cfg, n=10, seed=0):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(32, 56))
        reqs.append(Request(
            rid=f"r{i}", prompt_len=plen, output_len=int(rng.randint(12, 24)),
            arrival=i * 0.002,
            prompt=[int(t) for t in rng.randint(0, cfg.vocab_size, plen)]))
    return reqs


def run(cfg, policy, blocks, seed=0, *, device="cuda", params=None):
    """One engine over `blocks` device blocks (weights `params`, or random
    from seed 7 as the reference's PRNGKey(7)). Returns (engine,
    {rid: request})."""
    eng = LayerKVEngine(
        cfg, params,
        ServeConfig.for_engine(policy=policy, num_device_blocks=blocks,
                               num_host_blocks=512, block_size=8),
        device=device, seed=7)
    session = ServingSession(eng)
    for r in make_workload(cfg, seed=seed):
        session.submit(r, arrival=r.arrival)
    done = session.drain()
    return eng, {r.rid: r for r in done}


def compare(cfg, *, device="cuda", params=None):
    """Ground truth (vllm on 1024 blocks), then vllm and layerkv on 20
    blocks. Returns a dict of the three runs' outputs and the layerkv
    run's transfer counts."""
    _, truth = run(cfg, "vllm", 1024, device=device, params=params)
    eng_v, out_v = run(cfg, "vllm", 20, device=device, params=params)
    eng_l, out_l = run(cfg, "layerkv", 20, device=device, params=params)
    log = eng_l.off.ledger.log
    return {
        "truth": truth, "vllm": out_v, "layerkv": out_l,
        "mismatches": sum(truth[r].generated != out_l[r].generated
                          for r in truth),
        "offloads": sum(t.kind == "offload" for t in log),
        "reloads": sum(t.kind == "reload" for t in log),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    res = compare(config(), device=args.device)
    truth, out_v, out_l = res["truth"], res["vllm"], res["layerkv"]
    mismatches = res["mismatches"]
    print(f"losslessness: {len(truth) - mismatches}/{len(truth)} requests "
          f"identical under {res['offloads']} offloads / "
          f"{res['reloads']} reloads")

    tv = statistics.mean(r.ttft for r in out_v.values())
    tl = statistics.mean(r.ttft for r in out_l.values())
    print(f"mean TTFT  request-wise: {tv*1e6:10.1f} us")
    print(f"mean TTFT  layer-wise  : {tl*1e6:10.1f} us "
          f"({tv/max(tl,1e-12):.2f}x)")
    assert mismatches == 0


if __name__ == "__main__":
    main()
