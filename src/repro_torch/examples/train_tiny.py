"""Train a ~100M-parameter decoder for a few hundred steps — the port of
`examples/train_tiny.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 300] \
        [--device cpu]

On the card every norm and attention call runs the port's kernels,
forward and backward. Checkpoints use the reference's npz + manifest
format (`training/checkpoint.save`; `weights.load_checkpoint` reads
them back), by default under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import train

# ~100M params: 12L d=768 12H GQA kv=4, SwiGLU, 32k vocab
TINY_100M = ModelConfig(
    arch_id="tiny-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
    pos_emb="rope", dtype="float32", source="examples/train_tiny")


def run(steps=300, batch=4, seq=256, ckpt=None, *, device="cuda",
        params=None, verbose=True):
    """Train TINY_100M for `steps` AdamW steps of `batch` x `seq` tokens,
    checkpointing every 100 steps and at the end (when `ckpt` is set)."""
    return train(TINY_100M, steps=steps,
                 dc=DataConfig(batch_size=batch, seq_len=seq),
                 ckpt_path=ckpt, ckpt_every=100, log_every=20,
                 verbose=verbose, device=device, params=params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "tiny100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    print(f"params ~= {TINY_100M.param_count()/1e6:.0f}M")
    res = run(args.steps, args.batch, args.seq, args.ckpt,
              device=args.device)
    print(f"final loss {res.final_loss:.4f} "
          f"({res.tokens_per_s:.0f} tokens/s); checkpoint at {args.ckpt}")


if __name__ == "__main__":
    main()
