"""Port parity, the encoder-decoder family (whisper-base smoke, f32;
ROADMAP A4c): `layers.sinusoid_pos_emb`, `cross_kv`, `cross_attention`,
and `EncDecModel`'s `encode`, `train_logits`, `loss` and its gradients,
prefill and decode, and one AdamW train step, against the JAX package
with its weights handed over; and the data stream's encdec stub.

Tolerances (f32): layer functions atol = rtol = 1e-5 (sinusoids near
position 1500: 1e-4, see its test); encoder output,
logits and caches atol = rtol = 1e-4 (tests/test_torch_model.py's
prefill); loss atol = rtol = 1e-5 and gradients tests/test_torch_train.
py's rule (atol = 1e-5 * max |grad|, rtol 1e-4); the train step's losses
and gradient norm atol = rtol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jstep
from repro_torch.models import EncDecModel, layers as tlayers
from repro_torch.models.model import layer_params
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import make_train_step as tstep

from torch_parity import (assert_grads_close, close, models, randn,
                          to_jax, to_torch, tokens)

torch.set_num_threads(2)
ARCH = "whisper-base"
TOL = 1e-4


def _batch(cfg, B, S, seed):
    toks = tokens(cfg.vocab_size, (B, S + 1), seed)
    return {"enc_embeds": randn((B, cfg.encoder_len, cfg.d_model),
                                seed + 1, 0.02),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("dim", [128, 6, 2])
@pytest.mark.parametrize("start,tol", [(0, 1e-5), (1491, 1e-4)])
def test_sinusoid_pos_emb_matches_jax(dim, start, tol):
    """Near whisper's last frame (position 1499) the angles reach ~1500
    rad, where one f32 ulp of an angle (the two packages' exp may round
    a frequency differently) moves sin / cos by ~1e-4: atol = rtol =
    1e-4 there, 1e-5 near 0."""
    pos = start + np.arange(9)[None] + np.array([[0], [1]])
    close(tlayers.sinusoid_pos_emb(torch.from_numpy(pos), dim),
          jlayers.sinusoid_pos_emb(jnp.asarray(pos), dim), tol, tol)


def test_cross_kv_and_cross_attention_match_jax():
    """Layer 0's cross-attention params (biases given values: the init
    zeroes them), decoder rows over encoder frames, with and without
    enc_len."""
    jcfg, jm, jp, tm = models(ARCH)
    jl = jax.tree.map(lambda a: a[0], jp["dec_layers"])["cross"]
    tl = layer_params(tm.params["dec_layers"], 0)["cross"]
    for i, name in enumerate(("bq", "bk", "bv")):
        b = randn(jl[name].shape, 10 + i, 0.1)
        jl[name] = jnp.asarray(b)
        tl[name] = torch.from_numpy(b)
    enc = randn((2, jcfg.encoder_len, jcfg.d_model), 1)
    x = randn((2, 5, jcfg.d_model), 2)
    jk, jv = jlayers.cross_kv(jcfg, jl, jnp.asarray(enc))
    tk, tv = tlayers.cross_kv(tm.cfg, tl, torch.from_numpy(enc))
    close(tk, jk, 1e-5, 1e-5)
    close(tv, jv, 1e-5, 1e-5)
    for enc_len in (None, np.array([7, 32], np.int32)):
        want = jlayers.cross_attention(
            jcfg, jl, jnp.asarray(x), jk, jv,
            None if enc_len is None else jnp.asarray(enc_len))
        got = tlayers.cross_attention(
            tm.cfg, tl, torch.from_numpy(x), tk, tv,
            None if enc_len is None else torch.from_numpy(enc_len))
        close(got, want, 1e-5, 1e-5)


def test_encode_train_logits_loss_and_grads_match_jax():
    jcfg, jm, jp, tm = models(ARCH)
    assert isinstance(tm, EncDecModel)
    batch = _batch(jcfg, B=2, S=16, seed=0)
    tb = to_torch(batch)
    jlogits, _ = jax.jit(jm.train_logits)(jp, to_jax(batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, to_jax(batch))
    # the reference's encoder is a closure inside its train_logits: hold
    # the port's `encode` through the logits and through a model whose
    # decoder reads nothing but the encoder (prefill's cross K/V below)
    with torch.no_grad():
        close(tm.train_logits(tb), jlogits, TOL, TOL)
        close(tm.train_logits(tb, remat=False), jlogits, TOL, TOL)
    tm.requires_grad_(True)
    loss, metrics = tm.loss(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    assert float(metrics["ce"]) == float(metrics["loss"])
    assert_grads_close(tm, jgrads)


def test_prefill_then_decode_matches_jax():
    """Prefill (encode + decoder over the prompt; the cache takes every
    layer's self K/V and the encoder's cross K/V), then 5 decode steps
    over the cached cross K/V: logits at every step and every cache
    entry. The cross K/V are `cross_kv` of `encode`, so they hold the
    port's encoder against the reference's."""
    jcfg, jm, jp, tm = models(ARCH, seed=1)
    B, S, N = 2, 6, 5
    batch = _batch(jcfg, B, S, seed=3)
    del batch["labels"]
    nxt = tokens(jcfg.vocab_size, (B, N), 4)
    jlog, jc = jax.jit(jm.prefill)(jp, to_jax(batch), jm.init_cache(B, 16))
    with torch.no_grad():
        tlog, tc = tm.prefill(to_torch(batch), tm.init_cache(B, 16))
    close(tlog, jlog, TOL, TOL, "prefill")
    for name in ("ck", "cv"):
        assert tc[name].shape == (jcfg.n_layers, B, jcfg.encoder_len,
                                  jcfg.n_kv_heads, jcfg.resolved_head_dim)
        close(tc[name], jc[name], TOL, TOL, name)
    decode = jax.jit(jm.decode)
    for i in range(N):
        jlog, jc = decode(jp, jnp.asarray(nxt[:, i]), jc)
        with torch.no_grad():
            tlog, tc = tm.decode(torch.from_numpy(nxt[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
    for name in ("k", "v"):
        close(tc[name], jc[name], TOL, TOL, name)
    assert tc["len"].tolist() == [S + N] * B and tc["window"] == 0
    # the port's encoder output, read directly
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(batch["enc_embeds"]))
    assert enc.shape == (B, jcfg.encoder_len, jcfg.d_model)
    assert torch.isfinite(enc).all()


def test_train_step_matches_jax():
    """Two AdamW steps on one reference batch (its own stub frames
    handed over): the loss of each step (the second reads the updated
    weights) and the gradient norm."""
    jcfg, jm, jp, tm = models(ARCH, seed=2)
    batch = _batch(jcfg, B=2, S=16, seed=5)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jfn = jstep(jcfg, jopt.AdamWConfig(**opt), donate=False)
    jstate = jopt.init_opt_state(jp)
    tm.requires_grad_(True)
    tfn = tstep(tm, topt.AdamWConfig(**opt))
    tstate = topt.init_opt_state(tm.params)
    for _ in range(2):
        jp, jstate, jmet = jfn(jp, jstate, to_jax(batch))
        tstate, tmet = tfn(tstate, to_torch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       atol=1e-4, rtol=1e-4, err_msg=key)


def test_encdec_stub_stream_matches_jax_tokens():
    """The encdec stub makes the reference's one numpy draw per batch, so
    the token stream stays the reference's; its frames are N(0, 1) x
    0.02 from a torch generator (values differ from jax.random's)."""
    jcfg, _, _, tm = models(ARCH)
    dc = dict(batch_size=2, seq_len=12, seed=6)
    jb = jdata.SyntheticLM(jcfg, jdata.DataConfig(**dc)).batches()
    tb = tdata.SyntheticLM(tm.cfg, tdata.DataConfig(**dc),
                           device="cpu").batches()
    for _ in range(3):
        j, t = next(jb), next(tb)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
        assert t["enc_embeds"].shape == j["enc_embeds"].shape \
            == (2, jcfg.encoder_len, jcfg.d_model)
        assert 0.015 < float(t["enc_embeds"].std()) < 0.025
        assert not np.allclose(t["enc_embeds"].numpy(),
                               np.asarray(j["enc_embeds"]))


def test_encdec_train_cli_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
          "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out
