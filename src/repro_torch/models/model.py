"""Every family's model — the port of `repro.models.model`'s
`_decoder_model` (dense, MoE and vlm), `_encdec_model` (whisper),
`_hybrid_model` (zamba2) and `_xlstm_model` (xlstm), with `Model.loss`,
`cross_entropy` and `build_model`.

    model = build_model(cfg, params=None, device="cuda", seed=0)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(batch, cache)   # fill cache, last-pos logits
    logits, cache = model.decode(tokens, cache)   # one token per sequence
    model.requires_grad_(True)                    # weights trainable
    loss, metrics = model.loss(batch)             # teacher forcing, remat

`batch` keys by family, as in the reference: dense / moe `tokens`; vlm
`embeds` (B, S, d) and `mrope_pos` (3, B, S) in place of the token
embedding and positions (decode takes text tokens at text-stream
positions); encdec `enc_embeds` (B, T, d) and `tokens`; hybrid and ssm
`tokens` (one S for the batch); all `labels` for the loss.

Layers run as a Python loop over the layer-stacked params (the
reference's `lax.scan`), each block taking its weights through
`layer_weights` (the identity; the dry run gathers FSDP shards there);
the hybrid's and xlstm's superblocks are
stacked twice, (n_sb, per_sb, ...), and `train_logits` checkpoints a
whole superblock, as the reference does. MoE blocks run
`moe.moe_ffn`: dropless on the serving and decode paths, through the
capacity buffer in training,
where each block's load-balance terms come out of its checkpoint and are
averaged over layers, and `loss` adds `0.01 * lb_loss` to the
cross-entropy as the reference's does. `prefill` and `decode` write the
dense (L, B, S, KV, hd) cache in place (the reference threads it
through its scan carry); with `cfg.kv_quant` it holds int8 codes and a
bf16 scale per (token, head), and decode requantizes only the row it
writes. A sliding-window cache is a ring buffer laid out exactly as the
reference lays it out (ROADMAP C8); the hybrid's shared block keeps one
such cache per use. Weights are frozen
(`requires_grad=False`) until `requires_grad_(True)`; the serving paths
never turn it on.
"""
from __future__ import annotations

import itertools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers, moe, ssm
from repro_torch.models.act_sharding import (constrain, constrain_compute,
                                             constrain_kv,
                                             constrain_kv_stack,
                                             replaceable)

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


@replaceable
def layer_weights(lp):
    """One layer's weights where the layer uses them: the identity. It is
    called inside each block (so inside an activation checkpoint and
    again in its recompute); the dry run's form gathers the weights'
    FSDP shards there (`launch.dtensor_forms.layer_weights`), so a rank
    holds one layer's gathered weights at a time, as GSPMD's layer scan
    does."""
    return lp


def unbind_layers(tree):
    """Per-layer views of layer-stacked params, one `unbind` per leaf. Its
    backward stacks the layers' gradients once; indexing each layer
    (`layer_params`) would add a full-size zero tensor per layer."""
    flat = {k: v.unbind(0) for k, v in flatten_params(tree).items()}
    n = len(next(iter(flat.values())))
    return [unflatten_params({k: v[l] for k, v in flat.items()})
            for l in range(n)]


def positions_for(cfg: ModelConfig, B, S, device, offset=0):
    """Absolute positions offset..offset+S-1 (B, S), `offset` an int or a
    (B,) tensor; for mrope the text-only stream (3, B, S)."""
    off = torch.as_tensor(offset, device=device).reshape(-1, 1)
    pos = (torch.arange(S, device=device)[None] + off).expand(B, S)
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


@replaceable
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


def quantize(t):
    """(..., hd) -> int8 codes and a bf16 scale per (..., ) row: scale =
    max(amax / 127, 1e-8) in f32, codes round half to even (as jnp) and
    clip to +-127."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize(q, scale, dtype):
    """int8 codes times their bf16 scale widened to f32, in `dtype`."""
    return (q.float() * scale.float()[..., None]).to(dtype)


@replaceable
def embed(table, tokens):
    """The embedding rows of `tokens`."""
    return table[tokens]


@replaceable
def write_rows(cache, rows, idx, val):
    """`cache[rows, idx] = val` in place: a decode step's new K/V row per
    sequence."""
    cache[rows, idx] = val
    return cache


@replaceable
def write_prefix(layer, t):
    """`layer[:, :W] = t` in place, W = t.shape[1]: a prefill's K/V into
    one layer's cache (B, S_buf, ...)."""
    layer[:, :t.shape[1]] = t
    return layer


@replaceable
def decode_attention(q, k_cache, v_cache, kv_len):
    """One query row per sequence over a dense cache
    (`ops.decode_attention`)."""
    return ops.decode_attention(q, k_cache, v_cache, kv_len)


def attn_decode(cfg: ModelConfig, p, h, k_cache, v_cache, kv_len,
                positions, write_idx):
    """Self-attention of one new token per sequence over a dense cache:
    h (B, 1, d); its K/V are written into the caches (B, S_buf, KV, hd)
    at slots `write_idx` (B,), in place, before the attention reads them;
    kv_len (B,) counts the valid slots with the new one."""
    q, k, v = layers.decode_self_attention(cfg, p, h, positions)
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    write_rows(k_cache, rows, write_idx, k[:, 0].to(k_cache.dtype))
    write_rows(v_cache, rows, write_idx, v[:, 0].to(v_cache.dtype))
    return layers.attn_out(cfg, p, decode_attention(q, k_cache, v_cache,
                                                    kv_len))


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


def block_decode(cfg: ModelConfig, p, x, k_cache, v_cache, kv_len,
                 positions, write_idx):
    """One-token block step. x: (B, 1, d); caches (B, S_buf, KV, hd)
    written in place (`attn_decode`). The MoE FFN is dropless. Returns
    x."""
    h = layers.apply_norm(cfg, p["attn_norm"], x)
    x = x + attn_decode(cfg, p["attn"], h, k_cache, v_cache, kv_len,
                        positions, write_idx)
    h = layers.apply_norm(cfg, p["mlp_norm"], x)
    return x + ffn(cfg, p, h, dropless=True)[0]


def decode_slots(cache):
    """(write_idx, kv_len) of a decode step: the ring slot cur % S_buf
    when the cache is a window, else min(cur, S_buf - 1); kv_len =
    min(cur + 1, S_buf)."""
    cur = cache["len"]
    S_buf = cache["k"].shape[2]
    write_idx = (cur % S_buf if cache["window"] > 0
                 else torch.clamp(cur, max=S_buf - 1))
    return write_idx.long(), torch.clamp(cur + 1, max=S_buf).to(torch.int32)


def stack_init(n, make_block, device):
    """Layer-stacked params of `n` blocks (an int, or a tuple such as
    (n_sb, per_sb) for superblocks stacked twice): `make_block()` draws
    one block's nested dict, copied into preallocated (*n, ...) stacks
    in row-major order (a full-width model never holds a second copy of
    its layers)."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    stacked = None
    for idx in itertools.product(*map(range, shape)):
        lp = flatten_params(make_block())
        if stacked is None:
            stacked = {k: torch.empty((*shape, *t.shape), dtype=t.dtype,
                                      device=device)
                       for k, t in lp.items()}
        for k, t in lp.items():
            stacked[k][idx] = t
    return unflatten_params(stacked)


class _Model(nn.Module):
    """Params as a nested dict (`self.params`, the reference's pytree
    layout) whose tensors are also registered, flat, as frozen parameters
    of the module; `loss` over the family's `train_logits_aux`."""

    FAMILIES: tuple = ()

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not built by "
                             f"{type(self).__name__} "
                             f"({', '.join(self.FAMILIES)} only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        if params is None:
            params = self._init(seed)
        self.flat = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in flatten_params(params).items()})
        self.params = unflatten_params(dict(self.flat.items()))

    def train_logits(self, batch, remat=True):
        """Full-sequence teacher-forcing logits (B, S, padded_vocab),
        pad-vocab masked."""
        return self.train_logits_aux(batch, remat)[0]

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


class DecoderModel(_Model):
    """Decoder-only model: dense, MoE or vlm."""

    FAMILIES = ("dense", "moe", "vlm")

    # ------------------------------------------------------------------ init
    def _init(self, seed: int):
        """Random weights at the reference's init scales, drawn from one
        seeded generator on the model's device, one layer at a time."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def block():
            b = {"attn_norm": layers.init_norm(cfg, cfg.d_model, dt, dev),
                 "attn": layers.init_attention(cfg, gen, dt, dev),
                 "mlp_norm": layers.init_norm(cfg, cfg.d_model, dt, dev)}
            if cfg.family == "moe":
                b["moe"] = moe.init_moe(cfg, gen, dt, dev)
            else:
                b["mlp"] = layers.init_mlp(cfg, gen, dt, dev)
            return b
        p = {
            "layers": stack_init(cfg.n_layers, block, dev),
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev),
            "final_norm": layers.init_norm(cfg, cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dt, dev)
        return p

    def init_cache(self, B, cache_len, cache_dtype=None):
        """Dense (L, B, cache_len, KV, hd) K/V buffers, `len` (B,) and
        `window` (cache_len when the config's sliding window covers it:
        a ring buffer); with `cfg.kv_quant` int8 codes plus bf16
        `k_scale` / `v_scale` (L, B, cache_len, KV)."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache = {
            "len": torch.zeros(B, dtype=torch.int32, device=dev),
            "window": cache_len if cfg.sliding_window
            and cache_len <= cfg.sliding_window else 0,
        }
        if cfg.kv_quant:
            for name in ("k", "v"):
                cache[name] = torch.zeros(shape, dtype=torch.int8,
                                          device=dev)
                cache[f"{name}_scale"] = torch.zeros(
                    shape[:-1], dtype=torch.bfloat16, device=dev)
        else:
            cd = torch_dtype(cache_dtype or cfg.dtype)
            cache["k"] = torch.zeros(shape, dtype=cd, device=dev)
            cache["v"] = torch.zeros(shape, dtype=cd, device=dev)
        return cache

    # --------------------------------------------------------------- forward
    def _embed_batch(self, batch):
        """vlm: the stub frontend's `embeds` replace the token embedding."""
        if self.cfg.family == "vlm" and "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        return embed(self.params["embed"], batch["tokens"])

    def _positions(self, batch, B, S):
        if self.cfg.pos_emb == "mrope" and "mrope_pos" in batch:
            return batch["mrope_pos"]
        return positions_for(self.cfg, B, S, self.device)

    def train_logits_aux(self, batch, remat=True):
        """(logits, aux): `train_logits` and, for MoE, the load-balance
        terms (`lb_loss`, `dropped_frac`) averaged over layers, as the
        reference's `train_logits` returns them ({} otherwise). With
        `remat` each block runs under `torch.utils.checkpoint` (the
        reference's `jax.checkpoint`): only its input is kept, the
        backward runs its forward again, and the aux terms come out of
        the checkpoint with the block's output."""
        cfg, p = self.cfg, self.params
        x = self._embed_batch(batch)
        B, S = x.shape[:2]
        positions = self._positions(batch, B, S)

        def block(x, lp):
            x, _, aux = block_forward(cfg, layer_weights(lp),
                                      constrain_compute(x), positions)
            return constrain(x), aux.get("lb_loss"), aux.get("dropped_frac")

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
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x), aux

    def unembed(self, x):
        """Final-norm features -> logits, pad-vocab masked."""
        p = self.params
        w = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return mask_pad_logits(self.cfg, x @ w)

    def prefill(self, batch, cache, dropless=False):
        """batch: tokens (B, S) int (vlm: embeds and mrope_pos), optional
        prompt_len (B,) int (the valid prefix; keys past it are masked).
        Writes every layer's K/V (quantized with `kv_quant`) into `cache`
        in place and returns (logits at each row's last valid position,
        cache). A prompt longer than a windowed cache keeps its trailing
        S_buf positions in slots 0.. (the reference's layout, C8).
        `dropless` is the MoE FFN's (the serving executor passes True, as
        the reference's does)."""
        cfg, p = self.cfg, self.params
        x = self._embed_batch(batch)
        B, S = x.shape[:2]
        positions = self._positions(batch, B, S)
        kv_len = batch.get("prompt_len")
        S_buf = cache["k"].shape[2]
        W = min(S, S_buf)   # sliding-window cache keeps the trailing W
        for l in range(cfg.n_layers):
            lp = layer_weights(layer_params(p["layers"], l))
            x, kv, _ = block_forward(cfg, lp, constrain_compute(x),
                                     positions, kv_len=kv_len,
                                     dropless=dropless)
            x, kv = constrain(x), constrain_kv(kv)
            for name, t in zip(("k", "v"), kv):
                t = t[:, S - W:]
                if cfg.kv_quant:
                    codes, scale = quantize(t)
                    cache[name][l, :, :W] = codes
                    cache[f"{name}_scale"][l, :, :W] = scale
                else:
                    write_prefix(cache[name][l], t)
        cache["k"], cache["v"] = constrain_kv_stack(cache["k"], cache["v"])
        new_len = (kv_len.to(torch.int32) if kv_len is not None
                   else torch.full((B,), S, dtype=torch.int32,
                                   device=self.device))
        cache["len"] = new_len
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        if kv_len is not None:
            last = x[torch.arange(B, device=self.device), new_len.long() - 1]
        else:
            last = x[:, -1]
        return self.unembed(last), cache

    def decode(self, tokens, cache):
        """One token per sequence, tokens (B,) (vlm: text tokens at
        text-stream mrope positions). Runs layer by layer, writing each
        layer's new K/V into `cache` in place (ring slot when windowed;
        with `kv_quant` the layer is dequantized, the new row written in
        the model dtype and attended unquantized, then only that row is
        requantized), and returns (logits (B, padded_vocab), cache)."""
        cfg, p = self.cfg, self.params
        B = tokens.shape[0]
        x = embed(p["embed"], tokens.reshape(B, 1))
        write_idx, kv_len = decode_slots(cache)
        positions = positions_for(cfg, B, 1, self.device,
                                  offset=cache["len"])
        rows = torch.arange(B, device=self.device)
        for l in range(cfg.n_layers):
            if cfg.kv_quant:
                kc, vc = (dequantize(cache[n][l], cache[f"{n}_scale"][l],
                                     self.dtype) for n in ("k", "v"))
            else:
                kc, vc = cache["k"][l], cache["v"][l]   # views
            x = block_decode(cfg, layer_weights(layer_params(p["layers"], l)),
                             x, kc, vc, kv_len, positions, write_idx)
            if cfg.kv_quant:
                for name, c in (("k", kc), ("v", vc)):
                    codes, scale = quantize(c[rows, write_idx])
                    cache[name][l, rows, write_idx] = codes
                    cache[f"{name}_scale"][l, rows, write_idx] = scale
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, 0]), cache


class EncDecModel(_Model):
    """Encoder-decoder (whisper backbone): a non-causal encoder over the
    stub frontend's frames with sinusoid positions, and a decoder whose
    blocks add cross-attention over the encoder output; the embedding is
    tied."""

    FAMILIES = ("encdec",)

    def _init(self, seed: int):
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def norm():
            return layers.init_norm(cfg, cfg.d_model, dt, dev)

        def enc_block():
            return {"attn_norm": norm(),
                    "attn": layers.init_attention(cfg, gen, dt, dev),
                    "mlp_norm": norm(),
                    "mlp": layers.init_mlp(cfg, gen, dt, dev)}

        def dec_block():
            return {"attn_norm": norm(),
                    "attn": layers.init_attention(cfg, gen, dt, dev),
                    "cross_norm": norm(),
                    "cross": layers.init_attention(cfg, gen, dt, dev),
                    "mlp_norm": norm(),
                    "mlp": layers.init_mlp(cfg, gen, dt, dev)}
        return {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev),
            "enc_layers": stack_init(cfg.n_encoder_layers, enc_block, dev),
            "dec_layers": stack_init(cfg.n_layers, dec_block, dev),
            "enc_norm": norm(),
            "final_norm": norm(),
        }

    def encode(self, enc_embeds):
        """enc_embeds (B, T, d) -> encoder output (B, T, d)."""
        cfg, p = self.cfg, self.params
        B, T, _ = enc_embeds.shape
        pos = positions_for(cfg, B, T, self.device)
        # every row's positions are the same: one row's embedding,
        # broadcast over the batch
        x = enc_embeds.to(self.dtype) + layers.sinusoid_pos_emb(
            pos[:1], cfg.d_model).to(self.dtype)
        for lp in unbind_layers(p["enc_layers"]):
            lp = layer_weights(lp)
            x = constrain_compute(x)
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            a, _ = layers.self_attention(cfg, lp["attn"], h, pos,
                                         causal=False)
            x = x + a
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = constrain(x + layers.mlp(cfg, lp["mlp"], h))
        return layers.apply_norm(cfg, p["enc_norm"], constrain_compute(x))

    def _dec_embed(self, tokens, offset=0):
        B, S = tokens.shape
        pos = positions_for(self.cfg, B, S, self.device, offset)
        # an int offset gives every row the same positions: one row's
        # embedding, broadcast over the batch
        x = embed(self.params["embed"], tokens) + layers.sinusoid_pos_emb(
            pos if torch.is_tensor(offset) else pos[:1],
            self.cfg.d_model).to(self.dtype)
        return x, pos

    def _dec_block(self, lp, x, pos, enc):
        """Full-sequence decoder block: (x, (k, v), (ck, cv))."""
        cfg = self.cfg
        lp = layer_weights(lp)
        x = constrain_compute(x)
        h = layers.apply_norm(cfg, lp["attn_norm"], x)
        a, kv = layers.self_attention(cfg, lp["attn"], h, pos, causal=True)
        x = x + a
        h = layers.apply_norm(cfg, lp["cross_norm"], x)
        ck, cv = layers.cross_kv(cfg, lp["cross"], enc)
        x = x + layers.cross_attention(cfg, lp["cross"], h, ck, cv)
        h = layers.apply_norm(cfg, lp["mlp_norm"], x)
        return (constrain(x + layers.mlp(cfg, lp["mlp"], h)),
                constrain_kv(kv), (ck, cv))

    def unembed(self, x):
        return mask_pad_logits(self.cfg, x @ self.params["embed"].T)

    def train_logits_aux(self, batch, remat=True):
        """(logits, {}) for batch enc_embeds (B, T, d), tokens (B, S);
        with `remat` each decoder block is checkpointed (as the
        reference's scan body is; its encoder is not)."""
        cfg, p = self.cfg, self.params
        enc = self.encode(batch["enc_embeds"])
        x, pos = self._dec_embed(batch["tokens"])

        def block(x, lp, enc):
            return self._dec_block(lp, x, pos, enc)[0]

        for lp in unbind_layers(p["dec_layers"]):
            x = (checkpoint(block, x, lp, enc, use_reentrant=False)
                 if remat else block(x, lp, enc))
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x), {}

    def init_cache(self, B, cache_len, cache_dtype=None):
        """Self-attention K/V (L, B, cache_len, KV, hd), the encoder's
        cross K/V `ck` / `cv` (L, B, encoder_len, KV, hd), `len`, and
        `window` 0."""
        cfg, dev = self.cfg, self.device
        cd = torch_dtype(cache_dtype or cfg.dtype)
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        cache = {"len": torch.zeros(B, dtype=torch.int32, device=dev),
                 "window": 0}
        for name, S in (("k", cache_len), ("v", cache_len),
                        ("ck", cfg.encoder_len), ("cv", cfg.encoder_len)):
            cache[name] = torch.zeros((L, B, S, KV, hd), dtype=cd,
                                      device=dev)
        return cache

    def prefill(self, batch, cache):
        """Encode batch["enc_embeds"], run the decoder over
        batch["tokens"] (B, S), write every layer's self K/V and cross
        K/V into `cache` in place; returns (last-position logits,
        cache)."""
        cfg, p = self.cfg, self.params
        enc = self.encode(batch["enc_embeds"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x, pos = self._dec_embed(tokens)
        for l in range(cfg.n_layers):
            x, (k, v), (ck, cv) = self._dec_block(
                layer_params(p["dec_layers"], l), x, pos, enc)
            write_prefix(cache["k"][l], k)
            write_prefix(cache["v"][l], v)
            cache["ck"][l] = ck
            cache["cv"][l] = cv
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=self.device)
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, -1]), cache

    def decode(self, tokens, cache):
        """One token per sequence over the cached self K/V and the cached
        cross K/V; returns (logits (B, padded_vocab), cache)."""
        cfg, p = self.cfg, self.params
        B = tokens.shape[0]
        x, pos = self._dec_embed(tokens.reshape(B, 1), offset=cache["len"])
        write_idx, kv_len = decode_slots(cache)
        for l in range(cfg.n_layers):
            lp = layer_weights(layer_params(p["dec_layers"], l))
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            x = x + attn_decode(cfg, lp["attn"], h, cache["k"][l],
                                cache["v"][l], kv_len, pos, write_idx)
            h = layers.apply_norm(cfg, lp["cross_norm"], x)
            x = x + layers.cross_attention(cfg, lp["cross"], h,
                                           cache["ck"][l], cache["cv"][l])
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + layers.mlp(cfg, lp["mlp"], h)
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, 0]), cache


class HybridModel(_Model):
    """Hybrid (zamba2): a Mamba2 backbone in superblocks of
    `hybrid_attn_every` layers, each superblock opened by ONE shared
    attention + MLP block (the same weights at every use, so its
    gradient sums over the n_sb uses). Params keep the reference's keys:
    `embed`, `mamba_sb` stacked (n_sb, per_sb, ...), `shared_attn`,
    `final_norm` and an untied `lm_head`. The cache holds each use's
    K/V (n_sb, B, S, KV, hd) (a ring buffer when the config's window
    covers it, laid out as the reference's), each Mamba2 layer's SSD
    state (f32) and conv tail, `len` and `window`. `prefill` takes one
    S for the whole batch (no `prompt_len`), at most 128 or a multiple
    of 128 (`ssm.ssd_chunked`)."""

    FAMILIES = ("hybrid",)

    def _sb(self):
        per_sb = self.cfg.hybrid_attn_every
        assert self.cfg.n_layers % per_sb == 0
        return self.cfg.n_layers // per_sb, per_sb

    def _init(self, seed: int):
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n_sb, per_sb = self._sb()

        def norm():
            return layers.init_norm(cfg, cfg.d_model, dt, dev)

        def mamba_layer():
            return {"norm": norm(),
                    "mamba": ssm.init_mamba(cfg, gen, dt, dev)}
        return {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev),
            "mamba_sb": stack_init((n_sb, per_sb), mamba_layer, dev),
            "shared_attn": {
                "attn_norm": norm(),
                "attn": layers.init_attention(cfg, gen, dt, dev),
                "mlp_norm": norm(),
                "mlp": layers.init_mlp(cfg, gen, dt, dev)},
            "final_norm": norm(),
            "lm_head": layers.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dt, dev),
        }

    def unembed(self, x):
        """Final-norm features -> logits through the untied `lm_head`
        (the reference's hybrid and xlstm never tie it), pad-vocab
        masked."""
        return mask_pad_logits(self.cfg, x @ self.params["lm_head"])

    def _shared_attn_full(self, x, pos, window):
        """The shared block over a whole sequence: (x, (k, v))."""
        cfg, sp = self.cfg, self.params["shared_attn"]
        h = layers.apply_norm(cfg, sp["attn_norm"], x)
        a, kv = layers.self_attention(cfg, sp["attn"], h, pos, causal=True,
                                      window=window)
        x = x + a
        h = layers.apply_norm(cfg, sp["mlp_norm"], x)
        return x + layers.mlp(cfg, sp["mlp"], h), kv

    def _mamba_layer(self, lp, x):
        """One Mamba2 layer over a whole sequence, from a zero state:
        (x, (ssd_state, conv_tail))."""
        lp = layer_weights(lp)
        h = layers.apply_norm(self.cfg, lp["norm"], x)
        out, st = ssm.mamba_forward(self.cfg, lp["mamba"], h)
        return x + out, st

    def train_logits_aux(self, batch, remat=True):
        """(logits, {}) for batch tokens (B, S); with `remat` each whole
        superblock (shared block + its Mamba2 layers) runs under
        `torch.utils.checkpoint`, as the reference's `jax.checkpoint
        (sb_fn)`."""
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], batch["tokens"])
        B, S = x.shape[:2]
        pos = positions_for(cfg, B, S, self.device)
        window = cfg.sliding_window if S > cfg.sliding_window > 0 else 0

        def superblock(x, sb):
            x, _ = self._shared_attn_full(constrain_compute(x), pos, window)
            for lp in unbind_layers(sb):
                x, _ = self._mamba_layer(lp, x)
            return constrain(x)

        for sb in unbind_layers(p["mamba_sb"]):
            x = (checkpoint(superblock, x, sb, use_reentrant=False)
                 if remat else superblock(x, sb))
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x), {}

    def init_cache(self, B, cache_len, cache_dtype=None):
        cfg, dev = self.cfg, self.device
        cd = torch_dtype(cache_dtype or cfg.dtype)
        n_sb, per_sb = self._sb()
        d_in, H, P, N, G = ssm.mamba_dims(cfg)
        kv = (n_sb, B, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(kv, dtype=cd, device=dev),
            "v": torch.zeros(kv, dtype=cd, device=dev),
            "ssm_state": torch.zeros((n_sb, per_sb, B, H, N, P),
                                     dtype=torch.float32, device=dev),
            "conv": torch.zeros((n_sb, per_sb, B, cfg.ssm.conv_dim - 1,
                                 d_in + 2 * G * N), dtype=cd, device=dev),
            "len": torch.zeros(B, dtype=torch.int32, device=dev),
            "window": cache_len if cfg.sliding_window
            and cache_len <= cfg.sliding_window else 0,
        }

    def prefill(self, batch, cache):
        """tokens (B, S): every shared-block use's K/V (a prompt longer
        than the cache keeps its trailing S_buf positions in slots 0..,
        attended through the config's window) and every Mamba2 layer's
        final SSD state and conv tail go into `cache` in place; returns
        (last-position logits, cache)."""
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], batch["tokens"])
        B, S = x.shape[:2]
        pos = positions_for(cfg, B, S, self.device)
        S_buf = cache["k"].shape[2]
        window = cfg.sliding_window if S > S_buf else 0
        W = min(S, S_buf)
        n_sb, per_sb = self._sb()
        for i in range(n_sb):
            x, kv = self._shared_attn_full(constrain_compute(x), pos, window)
            k, v = constrain_kv(kv)
            write_prefix(cache["k"][i], k[:, S - W:])
            write_prefix(cache["v"][i], v[:, S - W:])
            for j in range(per_sb):
                x, (st, conv) = self._mamba_layer(
                    layer_params(p["mamba_sb"], (i, j)), x)
                cache["ssm_state"][i, j] = st
                cache["conv"][i, j] = conv
            x = constrain(x)
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=self.device)
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, -1]), cache

    def decode(self, tokens, cache):
        """One token per sequence: the shared block over each use's cached
        K/V (written in place, ring slot when windowed), each Mamba2
        layer's recurrent step from its cached state and conv tail;
        returns (logits (B, padded_vocab), cache)."""
        cfg, p = self.cfg, self.params
        sp = p["shared_attn"]
        B = tokens.shape[0]
        x = embed(p["embed"], tokens.reshape(B, 1))
        write_idx, kv_len = decode_slots(cache)
        pos = positions_for(cfg, B, 1, self.device, offset=cache["len"])
        n_sb, per_sb = self._sb()
        for i in range(n_sb):
            h = layers.apply_norm(cfg, sp["attn_norm"], x)
            x = x + attn_decode(cfg, sp["attn"], h, cache["k"][i],
                                cache["v"][i], kv_len, pos, write_idx)
            h = layers.apply_norm(cfg, sp["mlp_norm"], x)
            x = x + layers.mlp(cfg, sp["mlp"], h)
            for j in range(per_sb):
                lp = layer_weights(layer_params(p["mamba_sb"], (i, j)))
                h = layers.apply_norm(cfg, lp["norm"], x)
                out, (st, conv) = ssm.mamba_decode(
                    cfg, lp["mamba"], h, cache["ssm_state"][i, j],
                    cache["conv"][i, j])
                x = x + out
                cache["ssm_state"][i, j] = st
                cache["conv"][i, j] = conv
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, 0]), cache


class XLSTMModel(_Model):
    """xLSTM (the ssm family): superblocks of `xlstm_slstm_every - 1`
    mLSTM layers and one sLSTM layer, attention-free. Params `embed`,
    `mlstm_sb` (n_sb, n_m, ...), `slstm_sb` (n_sb, ...), `final_norm`,
    `lm_head`. The cache is the recurrent state: mLSTM `mC` / `mn` /
    `mm` (m starts at -1e30) and sLSTM `sc` / `sn` / `sm` (m starts at
    -10) / `sh`, all f32, and `len`; `prefill` (the chunked mLSTM, S at
    most 128 or a multiple of 128) and `decode` (the exact recurrence)
    both run from it."""

    FAMILIES = ("ssm",)

    def _sb(self):
        per_sb = self.cfg.xlstm_slstm_every
        assert self.cfg.n_layers % per_sb == 0
        return self.cfg.n_layers // per_sb, per_sb - 1

    def _init(self, seed: int):
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n_sb, n_m = self._sb()

        def norm():
            return layers.init_norm(cfg, cfg.d_model, dt, dev)
        return {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev),
            "mlstm_sb": stack_init(
                (n_sb, n_m), lambda: {"norm": norm(), "mlstm":
                                      ssm.init_mlstm(cfg, gen, dt, dev)},
                dev),
            "slstm_sb": stack_init(
                n_sb, lambda: {"norm": norm(), "slstm":
                               ssm.init_slstm(cfg, gen, dt, dev)}, dev),
            "final_norm": norm(),
            "lm_head": layers.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dt, dev),
        }

    unembed = HybridModel.unembed   # the same untied lm_head

    def train_logits_aux(self, batch, remat=True):
        """(logits, {}) for batch tokens (B, S); with `remat` each
        superblock is checkpointed, as the reference's."""
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], batch["tokens"])

        def superblock(x, mp, sp):
            x = constrain_compute(x)
            for lp in unbind_layers(mp):
                lp = layer_weights(lp)
                h = layers.apply_norm(cfg, lp["norm"], x)
                x = x + ssm.mlstm_forward(cfg, lp["mlstm"], h)[0]
            sp = layer_weights(sp)
            h = layers.apply_norm(cfg, sp["norm"], x)
            return constrain(x + ssm.slstm_forward(cfg, sp["slstm"], h)[0])

        for mp, sp in zip(unbind_layers(p["mlstm_sb"]),
                          unbind_layers(p["slstm_sb"])):
            x = (checkpoint(superblock, x, mp, sp, use_reentrant=False)
                 if remat else superblock(x, mp, sp))
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x), {}

    def init_cache(self, B, cache_len, cache_dtype=None):
        """The recurrent state (no K/V: `cache_len` and `cache_dtype` are
        the Model API's and change nothing)."""
        del cache_len, cache_dtype
        cfg, dev = self.cfg, self.device
        n_sb, n_m = self._sb()
        d_in, H, hd = ssm.mlstm_dims(cfg)
        s = (n_sb, B, cfg.n_heads, cfg.d_model // cfg.n_heads)

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)
        return {
            "mC": full((n_sb, n_m, B, H, hd, hd), 0.0),
            "mn": full((n_sb, n_m, B, H, hd), 0.0),
            "mm": full((n_sb, n_m, B, H), -1e30),
            "sc": full(s, 0.0), "sn": full(s, 0.0), "sm": full(s, -10.0),
            "sh": full(s, 0.0),
            "len": torch.zeros(B, dtype=torch.int32, device=dev),
        }

    def _run_with_state(self, x, cache, decode_mode):
        """Every layer from its cached state (chunked mLSTM over the
        sequence, or its one-token recurrence), the new state written
        into `cache` in place."""
        cfg, p = self.cfg, self.params
        n_sb, n_m = self._sb()
        mkeys, skeys = ("mC", "mn", "mm"), ("sc", "sn", "sm", "sh")
        for i in range(n_sb):
            x = constrain_compute(x)
            for j in range(n_m):
                lp = layer_weights(layer_params(p["mlstm_sb"], (i, j)))
                h = layers.apply_norm(cfg, lp["norm"], x)
                st = tuple(cache[k][i, j] for k in mkeys)
                out, st = (ssm.mlstm_decode(cfg, lp["mlstm"], h, st)
                           if decode_mode else
                           ssm.mlstm_forward(cfg, lp["mlstm"], h, state=st))
                x = x + out
                for k, t in zip(mkeys, st):
                    cache[k][i, j] = t
            sp = layer_weights(layer_params(p["slstm_sb"], i))
            h = layers.apply_norm(cfg, sp["norm"], x)
            out, st = ssm.slstm_forward(cfg, sp["slstm"], h,
                                        state=tuple(cache[k][i]
                                                    for k in skeys))
            x = constrain(x + out)
            for k, t in zip(skeys, st):
                cache[k][i] = t
        return x

    def prefill(self, batch, cache):
        cfg, p = self.cfg, self.params
        x = embed(p["embed"], batch["tokens"])
        B, S = x.shape[:2]
        x = self._run_with_state(x, cache, decode_mode=False)
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=self.device)
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, -1]), cache

    def decode(self, tokens, cache):
        cfg, p = self.cfg, self.params
        B = tokens.shape[0]
        x = embed(p["embed"], tokens.reshape(B, 1))
        x = self._run_with_state(x, cache, decode_mode=True)
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], constrain_compute(x))
        return self.unembed(x[:, 0]), cache


def build_model(cfg: ModelConfig, params=None, *, device="cuda",
                seed: int = 0):
    """The family's model (`repro.models.build_model`): DecoderModel for
    dense / moe / vlm, EncDecModel for encdec, HybridModel for hybrid
    (zamba2), XLSTMModel for ssm (xlstm)."""
    for cls in (DecoderModel, EncDecModel, HybridModel, XLSTMModel):
        if cfg.family in cls.FAMILIES:
            return cls(cfg, params, device=device, seed=seed)
    raise ValueError(cfg.family)
