"""Input stand-ins + sharding rules for every (arch x shape x mesh) — the
port of `repro.launch.specs`.

Stand-ins are fake tensors (`FakeTensorMode`): the right shapes and
dtypes, zero bytes allocated. A spec is the reference's PartitionSpec as
a tuple, one entry per tensor dim (None, a mesh axis name, or a tuple of
names), keyed by the port's flat param keys (``layers/attn/wq``), so the
rules below return exactly the reference's specs and a test compares
them one for one; `act_sharding.placements` turns a spec into DTensor
placements. The modality frontends are stubs, as in the reference:
audio / VLM entries receive precomputed frame / patch embeddings of the
right shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import InputShape, ModelConfig, SHAPES
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models import build_model
from repro_torch.models.model import flatten_params, unflatten_params
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update)

# leaf-name -> which dim gets the 'model' axis
_LAST_DIM_MODEL = {
    "wq", "wk", "wv", "wg", "wu", "w1", "w_in", "w_up", "w_gates",
    "bq", "bk", "bv", "b1", "conv_w", "conv_b", "lm_head",
}
_PENULT_DIM_MODEL = {"wo", "wd", "w2", "w_out", "w_down"}
_EXPERT_SHARDED = {"we_gate", "we_up", "we_down"}  # expert axis -> 'model'
_REPLICATED = {
    "w", "b", "b2", "router", "A_log", "D", "dt_bias", "norm_w", "r_gates",
    "b_gates", "w_i", "w_f", "b_i", "b_f",
}


def _fit(mesh, spec: tuple, shape: tuple) -> tuple:
    """Drop axes whose extent does not divide the dim (the reference's
    pjit argument shardings require exact divisibility; oddball dims like
    vocab=49155 fall back to replication on that dim)."""
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            fixed.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= axis_size(mesh, a)
        fixed.append(entry if dim % size == 0 else None)
    return _canonical(fixed)


def _canonical(entries) -> tuple:
    """A spec tuple in PartitionSpec's canonical form: a one-name tuple
    entry such as ``("data",)`` becomes the bare name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _param_spec(key: str, leaf) -> tuple:
    name = key.split("/")[-1]
    nd = leaf.ndim
    none = (None,) * nd
    if name == "embed":
        return ("model", None)
    if name in _REPLICATED or nd == 0:
        return none
    if name in _EXPERT_SHARDED:
        # stacked: (L, E, d, f) -> expert axis is -3
        spec = list(none)
        spec[-3] = "model"
        return tuple(spec)
    if name in _LAST_DIM_MODEL:
        spec = list(none)
        spec[-1] = "model"
        return tuple(spec)
    if name in _PENULT_DIM_MODEL:
        spec = list(none)
        if nd >= 2:
            spec[-2] = "model"
        return tuple(spec)
    return none


def _add_fsdp(mesh, spec: tuple, shape: tuple, dp_axes: tuple) -> tuple:
    """2D sharding: put the data(+pod) axes on the largest still-unsharded
    divisible dim (ZeRO-3/FSDP-style weight sharding)."""
    if len(shape) < 2:
        return spec
    dp_size = 1
    for a in dp_axes:
        dp_size *= axis_size(mesh, a)
    entries = list(tuple(spec) + (None,) * (len(shape) - len(tuple(spec))))
    cands = [(d, i) for i, (d, e) in enumerate(zip(shape, entries))
             if e is None and d % dp_size == 0 and d >= dp_size]
    if not cands:
        return spec
    _, idx = max(cands)
    entries[idx] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(entries)


def param_shardings(mesh, params_flat: Dict[str, Any],
                    fsdp: bool = False) -> Dict[str, tuple]:
    """{flat key: spec} for every param leaf."""
    dp_axes = data_axes(mesh)
    out = {}
    for key, leaf in params_flat.items():
        spec = _fit(mesh, _param_spec(key, leaf), tuple(leaf.shape))
        if fsdp:
            spec = _add_fsdp(mesh, spec, tuple(leaf.shape), dp_axes)
        out[key] = spec
    return out


def _dp_for(mesh, batch: int):
    dp_axes = data_axes(mesh)
    dp_size = 1
    for a in dp_axes:
        dp_size *= axis_size(mesh, a)
    return dp_axes if (batch >= dp_size and dp_axes) else None


def _cache_spec(name, leaf, dp, seq_sharded: bool) -> tuple:
    nd = leaf.ndim
    none = [None] * nd
    if name in ("k", "v", "ck", "cv", "k_scale", "v_scale"):
        # (L, B, S, KV[, hd]): batch over dp; KV-cache sequence over 'model'
        # (flash-decoding-style partial softmax); int8 quantization scales
        # shard exactly like their cache
        spec = none[:]
        spec[1] = dp
        if seq_sharded:
            spec[2] = "model"
        return tuple(spec)
    if name == "ssm_state":        # (n_sb, per_sb, B, H, N, P)
        return (None, None, dp, "model", None, None)
    if name == "conv":             # (n_sb, per_sb, B, K-1, C)
        return (None, None, dp, None, "model")
    if name == "mC":               # (n_sb, n_m, B, H, hd, hd)
        return (None, None, dp, None, "model", None)
    if name in ("mn", "mm"):
        spec = none[:]
        spec[2] = dp
        return tuple(spec)
    if name in ("sc", "sn", "sm", "sh"):  # (n_sb, B, H, hd)
        return (None, dp, None, "model")
    if name == "len":
        return (dp,)
    return tuple(none)


def cache_shardings(mesh, cache: Dict[str, Any], batch: int,
                    seq_sharded=True) -> Dict[str, tuple]:
    """{cache key: spec} for every tensor leaf of a cache (the port's
    `window` is a Python int, not a leaf)."""
    dp = _dp_for(mesh, batch)
    return {name: _fit(mesh, _cache_spec(name, leaf, dp, seq_sharded),
                       tuple(leaf.shape))
            for name, leaf in cache.items() if isinstance(leaf, torch.Tensor)}


def batch_shardings(mesh, batch_shape: Dict[str, Any],
                    batch: int) -> Dict[str, tuple]:
    dp = _dp_for(mesh, batch)
    out = {}
    for name, leaf in batch_shape.items():
        nd = leaf.ndim
        if name == "mrope_pos":     # (3, B, S)
            spec = (None, dp, None)
        else:
            s = [None] * nd
            if nd >= 1:
                s[0] = dp
            spec = tuple(s)
        out[name] = _fit(mesh, spec, tuple(leaf.shape))
    return out


# ---------------------------------------------------------------------------
# input stand-ins per (arch, shape)
# ---------------------------------------------------------------------------

def train_batch_struct(cfg: ModelConfig, shp: InputShape) -> Dict[str, Any]:
    """Fake (empty) batch tensors; call under a `FakeTensorMode`."""
    B, S = shp.global_batch, shp.seq_len
    i32 = torch.int32
    batch = {"tokens": torch.empty((B, S), dtype=i32),
             "labels": torch.empty((B, S), dtype=i32)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch_dtype(cfg.dtype))
        batch["mrope_pos"] = torch.empty((3, B, S), dtype=i32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.empty(
            (B, cfg.encoder_len, cfg.d_model), dtype=torch_dtype(cfg.dtype))
    return batch


def decode_cache_len(cfg: ModelConfig, shp: InputShape) -> int:
    """KV buffer length for a decode shape. long_500k requires
    sub-quadratic attention: dense/vlm/encdec/hybrid archs use their
    sliding-window variant (ring buffer of `sliding_window`)."""
    if shp.seq_len > 32768 and cfg.sliding_window:
        return cfg.sliding_window
    return shp.seq_len


def params_struct(cfg: ModelConfig, mode=None):
    """(model, {flat key: fake tensor}): the model built under `mode`
    (a new `FakeTensorMode` if None) at full size, no bytes allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = mode or FakeTensorMode()
    with mode:
        model = build_model(cfg, device="cpu")
    return model, flatten_params(model.params)


@functools.lru_cache(maxsize=2)
def _fake_model(cfg: ModelConfig):
    """(mode, model, params) for `cfg`, built once: the four shapes of an
    arch share one stand-in model (its tensors hold no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    return (mode, *params_struct(cfg, mode))


def tp_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """Pad query heads to the TP degree (and a KV-group multiple), as the
    reference does: GSPMD resharding of non-dividing head counts (40H /
    28H over 16) falls back to replicated activations."""
    tp = axis_size(mesh, "model")
    if cfg.n_heads % tp:
        padded = -(-cfg.n_heads // tp) * tp
        while padded % cfg.n_kv_heads:
            padded += tp
        cfg = dataclasses.replace(cfg, head_pad_to=padded)
    return cfg


def use_fsdp(cfg: ModelConfig, shp: InputShape, mesh) -> bool:
    """FSDP when TP-only sharding cannot hold the weights (llama4-scout:
    108B total params; 16-way TP leaves 13.5 GiB/chip of bf16 weights)."""
    tp = axis_size(mesh, "model")
    return cfg.param_count() * 2 / tp > 6e9 or shp.kind == "train"


def _mb_slice(x, i: int, k: int, B: int, dp: int):
    """Microbatch i of k along the batch dim (dim 0, or dim 1 for mrope's
    (3, B, S)). Where B splits into dp shards of k pieces each, the
    microbatch is the i-th k-th of every data shard's rows, so it stays
    sharded and no collective moves the batch (the reference slices B
    contiguously, which GSPMD reshards). Where the microbatch's rows do
    not split over the data ranks (16 rows over 2x16x16's 32), each
    rank's own rows, sharded over 'data' and replicated over 'pod' by an
    all-gather of those rows alone (`dtensor_forms.microbatch_rows`), as
    GSPMD's padding gives each rank one row; otherwise a contiguous
    slice, sharded evenly (`dtensor_forms.even_shards`)."""
    if x.ndim < 2:
        return x
    dim = 0 if x.shape[0] == B else (1 if x.shape[1] == B else None)
    if dim is None:
        return x
    m = B // k
    if B % (dp * k) == 0:
        shp = list(x.shape)
        y = x.reshape(*shp[:dim], dp, k, B // (dp * k), *shp[dim + 1:])
        y = y.select(dim + 1, i)
        return y.reshape(*shp[:dim], m, *shp[dim + 1:])
    from repro_torch.launch.dtensor_forms import even_shards, microbatch_rows
    mb = microbatch_rows(x, dim, i, k)
    return mb if mb is not None else even_shards(x.narrow(dim, i * m, m))


# the layer-stacked params' top-level keys -> their number of stack axes
# ((L, ...) or a superblock's (n_sb, per_sb, ...))
LAYER_STACKS = {"layers": 1, "enc_layers": 1, "dec_layers": 1,
                "mamba_sb": 2, "mlstm_sb": 2, "slstm_sb": 1}


def sharded_model(cfg: ModelConfig, params: Dict[str, Any]):
    """The model on `params` ({flat key: DTensor at its spec}) as the
    step runs it. A leaf outside the layer stacks (embedding, final
    norm, unembedding, zamba2's shared block) has its data-axis (FSDP)
    shards gathered once for the step. The layer stacks reach the model
    sharded, and each layer's weights are gathered where its block uses
    them (`model.layer_weights`, whose DTensor form is
    `dtensor_forms.layer_weights`), as GSPMD gathers inside the layer
    scan; given the sharded weights themselves, DTensor's matmul
    strategy would gather the activations instead. A stack sharded on a
    stack axis (codeqwen1.5-7b's (32, 4096) biases in training) is
    first gathered along it (`dtensor_forms.gather_stack_axes`)."""
    from repro_torch.launch.dtensor_forms import (gather_data_axes,
                                                  gather_stack_axes)
    out = {}
    for n, x in params.items():
        depth = LAYER_STACKS.get(n.split("/")[0])
        out[n] = gather_data_axes(x) if depth is None \
            else gather_stack_axes(x, depth, n)
    return build_model(cfg, unflatten_params(out), device="cpu")


def _grad(p):
    """p's gradient; zeros for a leaf the loss does not reach (the vlm's
    token embedding, when the stub embeds replace it), as in JAX."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def input_specs(cfg: ModelConfig, shape_name: str, mesh,
                microbatches: int = 1, mode=None):
    """Returns (step_fn, args, shardings, out_shardings): `args` are fake
    tensors (nested as the step takes them) made under `mode` (if None,
    the mode of a stand-in model cached per config; the step must run
    under it too, as `step_fn.fake_mode`), `shardings` / `out_shardings`
    their specs in
    the same nesting. The step runs the port's model on whatever tensors
    it is given: the dry run hands it DTensors."""
    shp = SHAPES[shape_name]
    cfg = tp_config(cfg, mesh)
    if mode is None:
        mode, model, p_struct = _fake_model(cfg)
    else:
        model, p_struct = params_struct(cfg, mode)
    fsdp = use_fsdp(cfg, shp, mesh)
    p_shard = param_shardings(mesh, p_struct, fsdp=fsdp)
    B = shp.global_batch
    dp_size = 1
    for a in data_axes(mesh):
        dp_size *= axis_size(mesh, a)

    if shp.kind == "train":
        with mode:
            batch = train_batch_struct(cfg, shp)
            o_struct = OptState(
                0, {k: torch.empty(v.shape, dtype=torch.float32)
                    for k, v in p_struct.items()},
                {k: torch.empty(v.shape, dtype=torch.float32)
                 for k, v in p_struct.items()})
        b_shard = batch_shardings(mesh, batch, B)
        opt_cfg = AdamWConfig()
        o_shard = OptState((), param_shardings(mesh, o_struct.mu, fsdp=fsdp),
                           param_shardings(mesh, o_struct.nu, fsdp=fsdp))
        k = microbatches
        out_shard = (p_shard, o_shard, ())

        def train_step(params, opt_state, batch):
            model = sharded_model(cfg, params)
            model.requires_grad_(True)
            flat = flatten_params(model.params)
            if k <= 1:
                loss, _ = model.loss(batch)
                loss.backward()
                grads = {n: _grad(p) for n, p in flat.items()}
                loss = loss.detach()
            else:
                # gradient accumulation over k microbatches in f32, so
                # live activations are 1/k of the global batch
                grads, loss = None, None
                for i in range(k):
                    mb = {n: _mb_slice(x, i, k, B, dp_size)
                          for n, x in batch.items()}
                    l, _ = model.loss(mb)
                    l.backward()
                    with torch.no_grad():
                        g = {n: _grad(p).float() / k
                             for n, p in flat.items()}
                        grads = g if grads is None else {
                            n: grads[n] + g[n] for n in g}
                        loss = l.detach() / k if loss is None \
                            else loss + l.detach() / k
                    for p in flat.values():
                        p.grad = None
            # gradients back to the params' own (FSDP) layout: the
            # reduce-scatter; AdamW then updates the sharded params and
            # moments in place
            from repro_torch.models.act_sharding import _to_spec
            grads = {n: _to_spec(g, p_shard[n], even=False)
                     for n, g in grads.items()}
            _, opt_state, _ = adamw_update(opt_cfg, grads, opt_state, params)
            return params, opt_state, loss

        train_step.fake_mode = mode
        return (train_step, (p_struct, o_struct, batch),
                (p_shard, o_shard, b_shard), out_shard)

    logits_shard = _fit(mesh, (data_axes(mesh), "model"),
                        (B, cfg.padded_vocab))

    if shp.kind == "prefill":
        with mode:
            batch = train_batch_struct(cfg, shp)
            batch.pop("labels")
            cache = model.init_cache(B, shp.seq_len, cfg.dtype)
        b_shard = batch_shardings(mesh, batch, B)
        c_shard = cache_shardings(mesh, cache, B)

        def prefill_step(params, batch, cache):
            return sharded_model(cfg, params).prefill(batch, cache)

        prefill_step.fake_mode = mode
        return (prefill_step, (p_struct, batch, cache),
                (p_shard, b_shard, c_shard), (logits_shard, c_shard))

    # decode: ONE new token against a full cache
    cache_len = decode_cache_len(cfg, shp)
    with mode:
        cache = model.init_cache(B, cache_len, cfg.dtype)
        tokens = torch.empty((B,), dtype=torch.int32)
    c_shard = cache_shardings(mesh, cache, B)
    t_shard = batch_shardings(mesh, {"t": tokens}, B)["t"]

    def serve_step(params, tokens, cache):
        return sharded_model(cfg, params).decode(tokens, cache)

    serve_step.fake_mode = mode
    return (serve_step, (p_struct, tokens, cache),
            (p_shard, t_shard, c_shard), (logits_shard, c_shard))
