"""Synthetic autoregressive data pipeline — the port of
`repro.training.data`.

Deterministic, seedable token streams with enough structure that a model's
loss measurably drops within a few hundred steps (a noisy order-k Markov
process over the vocab). The numpy stream is the reference's, draw for
draw, so one seed gives both packages the same tokens; batches arrive as
int64 tensors on the stream's device. The vlm / encdec frontend stubs
(precomputed patch / frame embeddings) wait for those families' port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
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
        if cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                f"{cfg.family} frontend stubs are not yet ported")
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
            yield {"tokens": dev[:, :-1], "labels": dev[:, 1:]}
