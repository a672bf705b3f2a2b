"""Synthetic autoregressive data pipeline — the port of
`repro.training.data`.

Deterministic, seedable token streams with enough structure that a model's
loss measurably drops within a few hundred steps (a noisy order-k Markov
process over the vocab). The numpy stream is the reference's, draw for
draw, so one seed gives both packages the same tokens; batches arrive as
int64 tensors on the stream's device.

The vlm and encdec frontend stubs (precomputed patch / frame embeddings)
make the reference's one numpy draw per stub, so the token stream after
them stays the reference's, and seed a `torch.Generator` on the stream's
device from it: their values differ from the reference's `jax.random`
ones (the parity tests hand the reference's arrays over instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    markov_order: int = 1
    noise: float = 0.1


class SyntheticLM:
    """Order-k Markov chain over the model vocab: next = hash(prev_k) with
    probability 1-noise, else uniform. Learnable by any competent LM."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig, device="cuda"):
        self.cfg = cfg
        self.dc = dc
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(dc.seed)
        V = cfg.vocab_size
        self._mults = self.rng.randint(1, V, size=dc.markov_order) * 2 + 1

    def _next(self, context: np.ndarray) -> np.ndarray:
        """context: (B, k) -> (B,) deterministic successor."""
        V = self.cfg.vocab_size
        h = np.zeros(context.shape[0], np.int64)
        for i in range(self.dc.markov_order):
            h = h * 1000003 + context[:, i] * self._mults[i]
        return (h % V).astype(np.int32)

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        B, S = self.dc.batch_size, self.dc.seq_len
        V = self.cfg.vocab_size
        k = self.dc.markov_order
        while True:
            toks = np.zeros((B, S + 1), np.int32)
            toks[:, :k] = self.rng.randint(0, V, size=(B, k))
            for t in range(k, S + 1):
                nxt = self._next(toks[:, t - k:t])
                flip = self.rng.rand(B) < self.dc.noise
                nxt[flip] = self.rng.randint(0, V, size=flip.sum())
                toks[:, t] = nxt
            dev = torch.from_numpy(toks.astype(np.int64)).to(self.device)
            batch = {"tokens": dev[:, :-1], "labels": dev[:, 1:]}
            yield self._add_frontend_stubs(batch, B, S)

    def _stub_normal(self, shape):
        """N(0, 1) f32 from a generator seeded by one draw of the stream's
        rng, in the model dtype, times 0.02."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.rng.randint(1 << 30)))
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=self.device)
        return x.to(torch_dtype(self.cfg.dtype)) * 0.02

    def _add_frontend_stubs(self, batch, B, S):
        cfg = self.cfg
        if cfg.family == "vlm":
            # stub ViT/projector output: embeddings for the token stream
            # (in training, vision patches + text share the stream)
            batch["embeds"] = self._stub_normal((B, S, cfg.d_model))
            batch["mrope_pos"] = torch.arange(S, device=self.device)[
                None, None].expand(3, B, S)
        if cfg.family == "encdec":
            batch["enc_embeds"] = self._stub_normal(
                (B, cfg.encoder_len, cfg.d_model))
        return batch
