"""AdamW + LR schedule + global-norm clipping — the port of
`repro.training.optimizer`, on nested dicts of tensors.

The reference returns new pytrees; here `adamw_update` updates the
parameters and the moments IN PLACE (a full-size model cannot hold a
second copy of either) and returns the same objects. The moments are f32
whatever the parameter dtype, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.model import flatten_params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_frac * lr."""
    warm = step / max(cfg.warmup_steps, 1)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + math.cos(math.pi * prog))
    return cfg.lr * (warm if step < cfg.warmup_steps else cos)


def _zeros_f32(tree):
    return {k: _zeros_f32(v) if isinstance(v, dict)
            else torch.zeros_like(v, dtype=torch.float32)
            for k, v in tree.items()}


def init_opt_state(params) -> OptState:
    return OptState(0, _zeros_f32(params), _zeros_f32(params))


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten_params(tree).values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (params, new_state, metrics); `params` and the moments in
    `state` are updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    G, M, V = (flatten_params(t) for t in (grads, state.mu, state.nu))
    for key, p in flatten_params(params).items():
        g = G[key].float() * scale
        m, v = M[key], V[key]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        p32 = p.float()
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(delta.mul_(-lr).add_(p32))      # p - lr * delta
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
