"""The decoder-only model (dense and MoE) — the port of
`repro.models.model._decoder_model` (`init`, `init_cache`, `prefill`,
`train_logits`, `_mask_pad_logits`) and of `Model.loss` /
`cross_entropy`.

    model = DecoderModel(cfg, params=None, device="cuda", seed=0)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(batch, cache)   # fill cache, last-pos logits
    model.requires_grad_(True)                    # weights trainable
    loss, metrics = model.loss(batch)             # teacher forcing, remat

Layers run as a Python loop over the layer-stacked params (the
reference's `lax.scan`). MoE blocks run `moe.moe_ffn`: dropless on the
serving paths, through the capacity buffer in training, where each
block's load-balance terms come out of its checkpoint and are averaged
over layers, and `loss` adds `0.01 * lb_loss` to the cross-entropy as
the reference's does. Dense-cache `decode`, `kv_quant` and the other
families wait for later slices; the constructor raises for them.
Weights are frozen (`requires_grad=False`) until `requires_grad_(True)`;
the serving paths never turn it on.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def layer_params(tree, l: int):
    """Layer `l`'s slice of layer-stacked params (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def flatten_params(tree, prefix=""):
    """{'layers/attn/wq': tensor, ...} — the checkpoint key format."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten_params(flat):
    """Inverse of `flatten_params`."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def unbind_layers(tree):
    """Per-layer views of layer-stacked params, one `unbind` per leaf. Its
    backward stacks the layers' gradients once; indexing each layer
    (`layer_params`) would add a full-size zero tensor per layer."""
    flat = {k: v.unbind(0) for k, v in flatten_params(tree).items()}
    n = len(next(iter(flat.values())))
    return [unflatten_params({k: v[l] for k, v in flat.items()})
            for l in range(n)]


def positions_for(cfg: ModelConfig, B, S, device):
    """Absolute positions 0..S-1 of a full-sequence forward."""
    pos = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.pos_emb == "mrope":
        return pos[None].expand(3, B, S)  # text-only stream
    return pos


def mask_pad_logits(cfg: ModelConfig, logits):
    """Embeddings/heads are padded to cfg.padded_vocab; pad positions must
    never win argmax."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(iota >= cfg.vocab_size, -1e30)


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) any-dtype, labels (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def ffn(cfg: ModelConfig, p, h, *, dropless=True):
    """The block's feed-forward and its aux terms: dense MLP ({}), or the
    MoE FFN (dropless on every serving path, as in the reference's
    executor, with no aux; the capacity path in training)."""
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, p["moe"], h, dropless=dropless)
    return layers.mlp(cfg, p["mlp"], h), {}


def block_forward(cfg: ModelConfig, p, x, positions, *, window=0,
                  kv_len=None, dropless=False):
    """Full-sequence transformer block. Returns (x, (k, v), aux)."""
    h = layers.apply_norm(cfg, p["attn_norm"], x)
    attn, kv = layers.self_attention(cfg, p["attn"], h, positions,
                                     causal=True, window=window,
                                     kv_len=kv_len)
    x = x + attn
    h = layers.apply_norm(cfg, p["mlp_norm"], x)
    f, aux = ffn(cfg, p, h, dropless=dropless)
    return x + f, kv, aux


class DecoderModel(nn.Module):
    """Decoder (dense or MoE) with params as a nested dict
    (`self.params`, the reference's pytree layout) whose tensors are also
    registered, flat, as frozen parameters of the module."""

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"family {cfg.family!r} is not yet ported "
                             "(dense and moe only)")
        if cfg.kv_quant:
            raise ValueError("kv_quant is not yet ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        if params is None:
            params = self._init(seed)
        self.flat = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in flatten_params(params).items()})
        self.params = unflatten_params(dict(self.flat.items()))

    # ------------------------------------------------------------------ init
    def _init(self, seed: int):
        """Random weights at the reference's init scales, drawn from one
        seeded generator on the model's device, one layer at a time into
        preallocated (L, ...) stacks (a full-width model never holds a
        second copy of its layers)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        stacked = None
        for l in range(cfg.n_layers):
            block = {
                "attn_norm": layers.init_norm(cfg, cfg.d_model, dt, dev),
                "attn": layers.init_attention(cfg, gen, dt, dev),
                "mlp_norm": layers.init_norm(cfg, cfg.d_model, dt, dev),
            }
            if cfg.family == "moe":
                block["moe"] = moe.init_moe(cfg, gen, dt, dev)
            else:
                block["mlp"] = layers.init_mlp(cfg, gen, dt, dev)
            lp = flatten_params(block)
            if stacked is None:
                stacked = {k: torch.empty((cfg.n_layers, *t.shape),
                                          dtype=t.dtype, device=dev)
                           for k, t in lp.items()}
            for k, t in lp.items():
                stacked[k][l] = t
        p = {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev),
            "layers": unflatten_params(stacked),
            "final_norm": layers.init_norm(cfg, cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dt, dev)
        return p

    def init_cache(self, B, cache_len, cache_dtype=None):
        cfg = self.cfg
        cd = torch_dtype(cache_dtype or cfg.dtype)
        shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "len": torch.zeros(B, dtype=torch.int32, device=self.device),
            "window": cache_len if cfg.sliding_window
            and cache_len <= cfg.sliding_window else 0,
            "k": torch.zeros(shape, dtype=cd, device=self.device),
            "v": torch.zeros(shape, dtype=cd, device=self.device),
        }

    # --------------------------------------------------------------- forward
    def train_logits(self, batch, remat=True):
        """Full-sequence teacher-forcing logits (B, S, padded_vocab),
        pad-vocab masked. batch: tokens (B, S) int."""
        return self.train_logits_aux(batch, remat)[0]

    def train_logits_aux(self, batch, remat=True):
        """(logits, aux): `train_logits` and, for MoE, the load-balance
        terms (`lb_loss`, `dropped_frac`) averaged over layers, as the
        reference's `train_logits` returns them ({} for dense). With
        `remat` each block runs under `torch.utils.checkpoint` (the
        reference's `jax.checkpoint`): only its input is kept, the
        backward runs its forward again, and the aux terms come out of
        the checkpoint with the block's output."""
        cfg, p = self.cfg, self.params
        x = p["embed"][batch["tokens"]]
        B, S = x.shape[:2]
        positions = positions_for(cfg, B, S, self.device)

        def block(x, lp):
            x, _, aux = block_forward(cfg, lp, x, positions)
            return x, aux.get("lb_loss"), aux.get("dropped_frac")

        lbs, drops = [], []
        for lp in unbind_layers(p["layers"]):
            x, lb, dropped = (checkpoint(block, x, lp, use_reentrant=False)
                              if remat else block(x, lp))
            lbs.append(lb)
            drops.append(dropped)
        aux = {}
        if cfg.family == "moe":
            aux = {"lb_loss": torch.stack(lbs).mean(),
                   "dropped_frac": torch.stack(drops).mean()}
        x = layers.apply_norm(cfg, p["final_norm"], x)
        return self.unembed(x), aux

    def loss(self, batch):
        """(total, metrics): mean next-token cross-entropy over
        batch["labels"] (B, S), masked by batch["loss_mask"] if given,
        plus `0.01 * lb_loss` for MoE (`lb_loss` and `dropped_frac` in
        the metrics), as the reference's `Model.loss`."""
        logits, aux = self.train_logits_aux(batch)
        ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        total = ce
        metrics = {"ce": ce.detach()}
        if "lb_loss" in aux:
            total = total + 0.01 * aux["lb_loss"]
            metrics.update(lb_loss=aux["lb_loss"].detach(),
                           dropped_frac=aux["dropped_frac"].detach())
        metrics["loss"] = total.detach()
        return total, metrics

    def unembed(self, x):
        """Final-norm features -> logits, pad-vocab masked (prefill side)."""
        p = self.params
        w = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return mask_pad_logits(self.cfg, x @ w)

    def prefill(self, batch, cache, dropless=False):
        """batch: tokens (B, S) int, optional prompt_len (B,) int (the
        valid prefix; keys past it are masked). Writes every layer's K/V
        into `cache` in place and returns (logits at each row's last valid
        position, cache). `dropless` is the MoE FFN's (the serving
        executor passes True, as the reference's does)."""
        cfg, p = self.cfg, self.params
        tokens = batch["tokens"]
        x = p["embed"][tokens]
        B, S = x.shape[:2]
        positions = positions_for(cfg, B, S, self.device)
        kv_len = batch.get("prompt_len")
        S_buf = cache["k"].shape[2]
        W = min(S, S_buf)   # sliding-window cache keeps the trailing W
        for l in range(cfg.n_layers):
            x, (k, v), _ = block_forward(cfg, layer_params(p["layers"], l),
                                         x, positions, kv_len=kv_len,
                                         dropless=dropless)
            cache["k"][l, :, :W] = k[:, S - W:]
            cache["v"][l, :, :W] = v[:, S - W:]
        new_len = (kv_len.to(torch.int32) if kv_len is not None
                   else torch.full((B,), S, dtype=torch.int32,
                                   device=self.device))
        cache["len"] = new_len
        x = layers.apply_norm(cfg, p["final_norm"], x)
        if kv_len is not None:
            last = x[torch.arange(B, device=self.device), new_len.long() - 1]
        else:
            last = x[:, -1]
        return self.unembed(last), cache
