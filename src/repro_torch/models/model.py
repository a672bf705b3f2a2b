"""The attention families' models — the port of
`repro.models.model`'s `_decoder_model` (dense, MoE and vlm) and
`_encdec_model` (whisper), with `Model.loss`, `cross_entropy` and
`build_model`.

    model = build_model(cfg, params=None, device="cuda", seed=0)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(batch, cache)   # fill cache, last-pos logits
    logits, cache = model.decode(tokens, cache)   # one token per sequence
    model.requires_grad_(True)                    # weights trainable
    loss, metrics = model.loss(batch)             # teacher forcing, remat

`batch` keys by family, as in the reference: dense / moe `tokens`; vlm
`embeds` (B, S, d) and `mrope_pos` (3, B, S) in place of the token
embedding and positions (decode takes text tokens at text-stream
positions); encdec `enc_embeds` (B, T, d) and `tokens`; all `labels`
for the loss.

Layers run as a Python loop over the layer-stacked params (the
reference's `lax.scan`). MoE blocks run `moe.moe_ffn`: dropless on the
serving and decode paths, through the capacity buffer in training,
where each block's load-balance terms come out of its checkpoint and are
averaged over layers, and `loss` adds `0.01 * lb_loss` to the
cross-entropy as the reference's does. `prefill` and `decode` write the
dense (L, B, S, KV, hd) cache in place (the reference threads it
through its scan carry); with `cfg.kv_quant` it holds int8 codes and a
bf16 scale per (token, head), and decode requantizes only the row it
writes. A sliding-window cache is a ring buffer laid out exactly as the
reference lays it out (ROADMAP C8). The hybrid and ssm families are not
ported yet; `build_model` raises for them. Weights are frozen
(`requires_grad=False`) until `requires_grad_(True)`; the serving paths
never turn it on.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers, moe

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


def attn_decode(cfg: ModelConfig, p, h, k_cache, v_cache, kv_len,
                positions, write_idx):
    """Self-attention of one new token per sequence over a dense cache:
    h (B, 1, d); its K/V are written into the caches (B, S_buf, KV, hd)
    at slots `write_idx` (B,), in place, before the attention reads them;
    kv_len (B,) counts the valid slots with the new one."""
    q, k, v = layers.decode_self_attention(cfg, p, h, positions)
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, write_idx] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, write_idx] = v[:, 0].to(v_cache.dtype)
    return layers.attn_out(cfg, p, ops.decode_attention(q, k_cache, v_cache,
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
    """Layer-stacked params of `n` blocks: `make_block()` draws one
    block's nested dict, copied into preallocated (n, ...) stacks (a
    full-width model never holds a second copy of its layers)."""
    stacked = None
    for l in range(n):
        lp = flatten_params(make_block())
        if stacked is None:
            stacked = {k: torch.empty((n, *t.shape), dtype=t.dtype,
                                      device=device)
                       for k, t in lp.items()}
        for k, t in lp.items():
            stacked[k][l] = t
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
            raise ValueError(f"family {cfg.family!r} is not yet ported "
                             f"by {type(self).__name__} "
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
        return self.params["embed"][batch["tokens"]]

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
            x, kv, _ = block_forward(cfg, layer_params(p["layers"], l), x,
                                     positions, kv_len=kv_len,
                                     dropless=dropless)
            for name, t in zip(("k", "v"), kv):
                t = t[:, S - W:]
                if cfg.kv_quant:
                    codes, scale = quantize(t)
                    cache[name][l, :, :W] = codes
                    cache[f"{name}_scale"][l, :, :W] = scale
                else:
                    cache[name][l, :, :W] = t
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

    def decode(self, tokens, cache):
        """One token per sequence, tokens (B,) (vlm: text tokens at
        text-stream mrope positions). Runs layer by layer, writing each
        layer's new K/V into `cache` in place (ring slot when windowed;
        with `kv_quant` the layer is dequantized, the new row written in
        the model dtype and attended unquantized, then only that row is
        requantized), and returns (logits (B, padded_vocab), cache)."""
        cfg, p = self.cfg, self.params
        B = tokens.shape[0]
        x = p["embed"][tokens.reshape(B, 1)]
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
            x = block_decode(cfg, layer_params(p["layers"], l), x, kc, vc,
                             kv_len, positions, write_idx)
            if cfg.kv_quant:
                for name, c in (("k", kc), ("v", vc)):
                    codes, scale = quantize(c[rows, write_idx])
                    cache[name][l, rows, write_idx] = codes
                    cache[f"{name}_scale"][l, rows, write_idx] = scale
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], x)
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
        x = enc_embeds.to(self.dtype) \
            + layers.sinusoid_pos_emb(pos, cfg.d_model).to(self.dtype)
        for lp in unbind_layers(p["enc_layers"]):
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            a, _ = layers.self_attention(cfg, lp["attn"], h, pos,
                                         causal=False)
            x = x + a
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + layers.mlp(cfg, lp["mlp"], h)
        return layers.apply_norm(cfg, p["enc_norm"], x)

    def _dec_embed(self, tokens, offset=0):
        B, S = tokens.shape
        pos = positions_for(self.cfg, B, S, self.device, offset)
        x = self.params["embed"][tokens] \
            + layers.sinusoid_pos_emb(pos, self.cfg.d_model).to(self.dtype)
        return x, pos

    def _dec_block(self, lp, x, pos, enc):
        """Full-sequence decoder block: (x, (k, v), (ck, cv))."""
        cfg = self.cfg
        h = layers.apply_norm(cfg, lp["attn_norm"], x)
        a, kv = layers.self_attention(cfg, lp["attn"], h, pos, causal=True)
        x = x + a
        h = layers.apply_norm(cfg, lp["cross_norm"], x)
        ck, cv = layers.cross_kv(cfg, lp["cross"], enc)
        x = x + layers.cross_attention(cfg, lp["cross"], h, ck, cv)
        h = layers.apply_norm(cfg, lp["mlp_norm"], x)
        return x + layers.mlp(cfg, lp["mlp"], h), kv, (ck, cv)

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
        x = layers.apply_norm(cfg, p["final_norm"], x)
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
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
            cache["ck"][l] = ck
            cache["cv"][l] = cv
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=self.device)
        x = layers.apply_norm(cfg, p["final_norm"], x)
        return self.unembed(x[:, -1]), cache

    def decode(self, tokens, cache):
        """One token per sequence over the cached self K/V and the cached
        cross K/V; returns (logits (B, padded_vocab), cache)."""
        cfg, p = self.cfg, self.params
        B = tokens.shape[0]
        x, pos = self._dec_embed(tokens.reshape(B, 1), offset=cache["len"])
        write_idx, kv_len = decode_slots(cache)
        for l in range(cfg.n_layers):
            lp = layer_params(p["dec_layers"], l)
            h = layers.apply_norm(cfg, lp["attn_norm"], x)
            x = x + attn_decode(cfg, lp["attn"], h, cache["k"][l],
                                cache["v"][l], kv_len, pos, write_idx)
            h = layers.apply_norm(cfg, lp["cross_norm"], x)
            x = x + layers.cross_attention(cfg, lp["cross"], h,
                                           cache["ck"][l], cache["cv"][l])
            h = layers.apply_norm(cfg, lp["mlp_norm"], x)
            x = x + layers.mlp(cfg, lp["mlp"], h)
        cache["len"] = cache["len"] + 1
        x = layers.apply_norm(cfg, p["final_norm"], x)
        return self.unembed(x[:, 0]), cache


def build_model(cfg: ModelConfig, params=None, *, device="cuda",
                seed: int = 0):
    """The family's model (`repro.models.build_model`): DecoderModel for
    dense / moe / vlm, EncDecModel for encdec; hybrid and ssm are not
    yet ported."""
    if cfg.family in DecoderModel.FAMILIES:
        return DecoderModel(cfg, params, device=device, seed=seed)
    if cfg.family in EncDecModel.FAMILIES:
        return EncDecModel(cfg, params, device=device, seed=seed)
    if cfg.family in ("hybrid", "ssm"):
        raise ValueError(f"family {cfg.family!r} is not yet ported")
    raise ValueError(cfg.family)
