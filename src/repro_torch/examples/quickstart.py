"""Quickstart — the port of `examples/quickstart.py`: build a model, train
a few steps, then serve it through a live `ServingSession` (submit
online, stream tokens per iteration).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card (the default) every norm and attention call runs the port's
kernels: RMSNorm and flash forward and backward in training, flash
prefill, paged decode and RMSNorm in the engine. As in the reference,
the served model has fresh random weights (seed 0), not the trained
ones.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import LayerKVEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ServeConfig
from repro_torch.serving.session import ServingSession
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train

STEPS = 60
# the schedule `train` gives 60 steps by default
SCHEDULE = AdamWConfig(lr=1e-3, total_steps=STEPS,
                       warmup_steps=max(STEPS // 10, 5))


def config():
    """granite-3-2b's smoke config in f32."""
    return dataclasses.replace(get_smoke_config("granite-3-2b"),
                               dtype="float32")


def train_part(cfg, *, device="cuda", params=None, steps=STEPS,
               verbose=True):
    """AdamW steps on the synthetic stream, batches of 8 x 64, on the
    60-step schedule (`steps` < 60 runs its first steps)."""
    return train(cfg, steps=steps, dc=DataConfig(batch_size=8, seq_len=64),
                 opt=SCHEDULE, log_every=20, verbose=verbose, device=device,
                 params=params)


def serve_part(cfg, *, device="cuda", params=None, verbose=True):
    """6 requests of 32 prompt tokens and 8 output tokens through an
    online session over a tight pool (layer-wise KV offloading); r0 is
    streamed token by token. Returns (engine, done requests, r0's
    streamed tokens)."""
    rng = np.random.RandomState(0)
    eng = LayerKVEngine(cfg, params,
                        ServeConfig.for_engine(policy="layerkv",
                                               num_device_blocks=24,
                                               num_host_blocks=256,
                                               block_size=8),
                        device=device, seed=0)
    session = ServingSession(eng)
    handles = [
        session.submit(Request(rid=f"r{i}", prompt_len=32, output_len=8,
                               prompt=[int(t) for t in
                                       rng.randint(0, cfg.vocab_size, 32)]),
                       arrival=i * 0.01)
        for i in range(6)]

    # stream the first request token-by-token (the rest decode alongside)
    if verbose:
        print("  streaming r0:", end="", flush=True)
    streamed = []
    for tok in session.stream(handles[0]):
        streamed.append(tok)
        if verbose:
            print(f" {tok}", end="", flush=True)
    if verbose:
        print()
    done = session.drain()                 # run the rest to completion
    return eng, done, streamed


def transfers(eng):
    """(offloads, reloads) in the engine's transfer ledger."""
    log = eng.off.ledger.log
    return (sum(t.kind == "offload" for t in log),
            sum(t.kind == "reload" for t in log))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    cfg = config()
    print(f"== arch {cfg.arch_id}: {cfg.n_layers}L d={cfg.d_model} "
          f"{cfg.n_heads}H(kv={cfg.n_kv_heads}) on {args.device}")

    # --- 1. train a few steps on the synthetic pipeline ---------------------
    print(f"\n== training {STEPS} steps ==")
    res = train_part(cfg, device=args.device)
    print(f"loss: {res.losses[0]:.3f} -> {res.final_loss:.3f}")

    # --- 2. serve requests through an online session ------------------------
    print("\n== serving 6 requests (layer-wise KV offloading) ==")
    eng, done, _ = serve_part(cfg, device=args.device)
    for r in done:
        print(f"  {r.rid}: {len(r.generated)} tokens, "
              f"ttft={r.ttft*1e3:.1f}ms -> {r.generated[:6]}...")
    off, rel = transfers(eng)
    print(f"layer-wise KV transfers: {off} offloads, {rel} reloads")


if __name__ == "__main__":
    main()
