"""Training driver CLI for the PyTorch port (`repro.launch.train`'s flags
plus `--device`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke --steps 200 --batch 8 --seq 128 --device cpu

--smoke uses the reduced config. `--device` (default cuda) selects where
it runs; without a CUDA device it raises unless given `--device cpu`.
Dense models only (MoE training is not yet ported).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    res = train(
        cfg, steps=args.steps,
        dc=DataConfig(batch_size=args.batch, seq_len=args.seq),
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 10, 5)),
        ckpt_path=args.ckpt or None, device=args.device)
    print(f"final loss {res.final_loss:.4f} "
          f"({res.tokens_per_s:.0f} tokens/s)")


if __name__ == "__main__":
    main()
