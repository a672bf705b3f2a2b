"""Port parity, model: the port's layer functions and dense `prefill`
against the JAX reference (`repro.models`), at f32 with the reference's
own weights carried across by `repro_torch.weights` (a copy — both sides
keep the (in, out) layout and compute `x @ w`). Inputs come from numpy
with a seed. Prefill logits agree to atol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model, layers as jlayers
from repro.training import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderModel, layers as tlayers
from repro_torch.models import build_model as build_torch_model
from repro_torch.models.model import flatten_params, layer_params
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
ARCHS = ["granite-3-2b", "llama2-7b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_params(jcfg, seed=0):
    return build_model(jcfg).init(jax.random.PRNGKey(seed))


def _layer0(jp, tcfg):
    """(JAX layer-0 params, port layer-0 params) from one JAX init."""
    tp = from_jax_params(_flat(jp), tcfg, device="cpu")
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            layer_params(tp["layers"], 0))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------- layers --

def test_norms_match_jax():
    x, w, b = _x((2, 5, 64)), _x((64,), 1), _x((64,), 2)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _close(tlayers.rmsnorm(tx, tw), jlayers.rmsnorm(x, w))
    _close(tlayers.layernorm(tx, tw, tb), jlayers.layernorm(x, w, b))


@pytest.mark.parametrize("pos_emb", ["rope", "rope2d", "mrope"])
def test_rope_variants_match_jax(pos_emb):
    jcfg, tcfg = _cfgs("granite-3-2b", pos_emb=pos_emb)
    x = _x((2, 7, 4, 32))
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [13]])
    if pos_emb == "mrope":
        pos = np.stack([pos, pos + 1, pos * 2])
    _close(tlayers.apply_rope(tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos)),
           jlayers.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)),
           atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True},
                                   {"head_pad_to": 12}])
def test_attention_projections_match_jax(extra):
    jcfg, tcfg = _cfgs("granite-3-2b", **extra)
    jl, tl = _layer0(_jax_params(jcfg), tcfg)
    if extra.get("qkv_bias"):   # zero-initialised: give them values
        for i, name in enumerate(("bq", "bk", "bv")):
            b = _x(jl["attn"][name].shape, 10 + i)
            jl["attn"][name] = jnp.asarray(b)
            tl["attn"][name] = torch.from_numpy(b)
    x = _x((2, 6, jcfg.d_model), 3)
    jq, jk, jv = jlayers.qkv_proj(jcfg, jl["attn"], jnp.asarray(x))
    tq, tk, tv = tlayers.qkv_proj(tcfg, tl["attn"], torch.from_numpy(x))
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _close(t, j, atol=1e-5)
    o = _x(tuple(jq.shape), 4)
    _close(tlayers.attn_out(tcfg, tl["attn"], torch.from_numpy(o)),
           jlayers.attn_out(jcfg, jl["attn"], jnp.asarray(o)), atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg, tcfg = _cfgs("llama2-7b", act=act)
    jl, tl = _layer0(_jax_params(jcfg), tcfg)
    x = _x((2, 5, jcfg.d_model), 5)
    _close(tlayers.mlp(tcfg, tl["mlp"], torch.from_numpy(x)),
           jlayers.mlp(jcfg, jl["mlp"], jnp.asarray(x)), atol=1e-5)


# --------------------------------------------------------------- prefill --

def _prefill_both(arch, jp, prompt_len=(20, 32), S=32, seed=0):
    jcfg, tcfg = _cfgs(arch)
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (len(prompt_len), S)).astype(np.int32)
    plen = np.asarray(prompt_len, np.int32)
    jm = build_model(jcfg)
    jlog, jcache = jm.prefill(
        jp, {"tokens": jnp.asarray(toks), "prompt_len": jnp.asarray(plen)},
        jm.init_cache(len(prompt_len), S))
    tm = DecoderModel(tcfg, from_jax_params(_flat(jp), tcfg, "cpu"),
                      device="cpu")
    tlog, tcache = tm.prefill(
        {"tokens": torch.from_numpy(toks).long(),
         "prompt_len": torch.from_numpy(plen)},
        tm.init_cache(len(prompt_len), S))
    return (tlog, tcache), (jlog, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    jp = _jax_params(_cfgs(arch)[0])
    (tlog, tcache), (jlog, jcache) = _prefill_both(arch, jp)
    _close(tlog, jlog, atol=1e-4, rtol=1e-4)
    _close(tcache["k"], jcache["k"], atol=1e-4, rtol=1e-4)
    _close(tcache["v"], jcache["v"], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlog, -1)))


def test_pad_vocab_masked_on_prefill():
    """granite's smoke vocab 512 pads to 512 (no pad); widen it to force
    padding and check pad logits never win, as in the reference."""
    jcfg, tcfg = _cfgs("granite-3-2b", vocab_size=500)
    assert tcfg.padded_vocab == 512
    tm = DecoderModel(tcfg, device="cpu", seed=3)
    logits, _ = tm.prefill({"tokens": torch.zeros(1, 16, dtype=torch.long)},
                           tm.init_cache(1, 16))
    assert (logits[:, 500:] == -1e30).all()


# ----------------------------------------------------------- checkpoints --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    """A directory written by repro.training.checkpoint.save loads into
    the port (numpy only) as the same weights from_jax_params gives."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype)
                  for c in _cfgs("granite-3-2b"))
    jp = _jax_params(jcfg, seed=1)
    checkpoint.save(str(tmp_path), jp, meta={"step": 7})
    params, meta = load_checkpoint(str(tmp_path), tcfg, device="cpu")
    assert meta == {"step": 7}
    want = flatten_params(from_jax_params(_flat(jp), tcfg, "cpu"))
    got = flatten_params(params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == getattr(torch, dtype)
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_prefill_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs("llama2-7b")
    jp = _jax_params(jcfg, seed=2)
    checkpoint.save(str(tmp_path), jp)
    params, _ = load_checkpoint(str(tmp_path), tcfg, device="cpu")
    toks = np.arange(16, dtype=np.int32)[None] % jcfg.vocab_size
    jm = build_model(jcfg)
    jlog, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                         jm.init_cache(1, 16))
    tm = DecoderModel(tcfg, params, device="cpu")
    tlog, _ = tm.prefill({"tokens": torch.from_numpy(toks).long()},
                         tm.init_cache(1, 16))
    _close(tlog, jlog, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ init / API --

def test_seeded_init_is_deterministic_with_reference_shapes():
    jcfg, tcfg = _cfgs("llama2-7b")
    a = flatten_params(DecoderModel(tcfg, device="cpu", seed=5).params)
    b = flatten_params(DecoderModel(tcfg, device="cpu", seed=5).params)
    c = flatten_params(DecoderModel(tcfg, device="cpu", seed=6).params)
    ref_shapes = {k: v.shape for k, v in _flat(_jax_params(jcfg)).items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == ref_shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/attn/wq"], c["layers/attn/wq"])


@pytest.mark.parametrize("arch,extra", [("zamba2-2.7b", {}),
                                        ("xlstm-1.3b", {})])
def test_unported_model_variants_raise(arch, extra):
    """The last two families (hybrid, ssm) are ported: `build_model` makes
    their own classes, and a decoder-only model still refuses them."""
    from repro_torch.models import HybridModel, XLSTMModel
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **extra)
    want = {"hybrid": HybridModel, "ssm": XLSTMModel}[cfg.family]
    assert type(build_torch_model(cfg, device="cpu")) is want
    with pytest.raises(ValueError, match="is not built by DecoderModel"):
        DecoderModel(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-base",
                                  "zamba2-2.7b", "xlstm-1.3b"])
def test_from_jax_params_carries_vlm_and_encdec_keys(arch):
    """The vlm's and the encdec's reference params (encoder and decoder
    stacks, cross-attention, q / k / v biases), and the hybrid's and the
    ssm's (superblocks stacked twice, (n_sb, per_sb, ...); f32 leaves
    such as A_log, r_gates and the gate weights inside a bf16 model)
    cross over key for key, each leaf in its own dtype (bf16 model), and
    the port's own init makes the same keys, shapes and dtypes."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs(arch))
    jflat = _flat(_jax_params(jcfg))
    tp = flatten_params(from_jax_params(jflat, tcfg, device="cpu"))
    assert tp.keys() == jflat.keys()
    if arch == "whisper-base":
        assert {"enc_layers/attn/bq", "dec_layers/cross/wk",
                "dec_layers/cross/bv", "enc_norm/b"} <= tp.keys()
    f32 = {"zamba2-2.7b": "mamba_sb/mamba/A_log",
           "xlstm-1.3b": "slstm_sb/slstm/r_gates"}.get(arch)
    if f32:
        assert tp[f32].dtype == torch.float32
        assert len(tp[f32].shape) == len(jflat[f32].shape) >= 2
    for k, a in jflat.items():
        assert str(tp[k].dtype) == f"torch.{a.dtype.name}", k
        assert tuple(tp[k].shape) == a.shape, k
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      a.astype(np.float32))
    own = flatten_params(build_torch_model(tcfg, device="cpu",
                                           seed=1).params)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in own.items()} \
        == {k: (a.shape, f"torch.{a.dtype.name}") for k, a in jflat.items()}
