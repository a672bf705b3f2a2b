"""Training loop — the port of `repro.training.train_loop`: a train step
(loss, gradients by autograd, AdamW in place) and the driver, with the
reference's defaults, log lines and checkpoint cadence.

On CUDA every norm and every attention call runs the port's kernels,
forward and backward (`kernels/rmsnorm.py`, `kernels/flash_prefill.py`);
on the CPU their plain versions, differentiated by autograd.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import DecoderModel
from repro_torch.models.model import flatten_params
from repro_torch.training.checkpoint import save as ckpt_save
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, adamw_update, init_opt_state,
)


def make_train_step(model: DecoderModel, opt: AdamWConfig) -> Callable:
    """`train_step(opt_state, batch) -> (opt_state, metrics)`: one step
    on `model`'s trainable params, updated in place."""
    flat = flatten_params(model.params)

    def train_step(opt_state: OptState, batch):
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {k: p.grad for k, p in flat.items()}
        _, opt_state, opt_metrics = adamw_update(opt, grads, opt_state,
                                                 flat)
        for p in flat.values():
            p.grad = None
        return opt_state, {**metrics, **opt_metrics}

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    final_loss: float
    steps: int
    tokens_per_s: float
    grad_norms: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)


def train(cfg: ModelConfig, steps: int = 200, dc: Optional[DataConfig] = None,
          opt: Optional[AdamWConfig] = None, seed: int = 0,
          ckpt_path: Optional[str] = None, ckpt_every: int = 0,
          log_every: int = 20, verbose: bool = True, *, device="cuda",
          params=None) -> TrainResult:
    """Train `cfg` (dense) from `params` (the port's nested dict on
    `device`, e.g. `weights.from_jax_params`), or from random weights
    drawn from `seed`, on the synthetic stream. Each step's wall time
    (`step_s`) ends in the host's read of its loss."""
    dc = dc or DataConfig()
    opt = opt or AdamWConfig(lr=1e-3, total_steps=steps,
                             warmup_steps=max(steps // 10, 5))
    model = DecoderModel(cfg, params, device=device, seed=seed)
    model.requires_grad_(True)
    opt_state = init_opt_state(model.params)
    step_fn = make_train_step(model, opt)
    data = SyntheticLM(cfg, dc, device=device).batches()

    losses, grad_norms, step_s = [], [], []
    t0 = time.perf_counter()
    tokens = 0
    for step in range(steps):
        ts = time.perf_counter()
        batch = next(data)
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        tokens += dc.batch_size * dc.seq_len
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"grad_norm {grad_norms[-1]:7.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if ckpt_path and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt_save(ckpt_path, {"params": model.params},
                      meta={"step": step + 1, "loss": loss})
    dt = time.perf_counter() - t0
    if ckpt_path:
        ckpt_save(ckpt_path, {"params": model.params},
                  meta={"step": steps, "loss": losses[-1]})
    return TrainResult(losses, losses[-1], steps, tokens / dt, grad_norms,
                       step_s)
