"""Port parity, the hybrid family (zamba2-2.7b smoke, f32; ROADMAP A4d):
`models/ssm.py`'s Mamba2 half (`ssd_chunked`, `mamba_forward`,
`mamba_decode`) and `HybridModel`'s `train_logits`, `loss` and every
gradient leaf (the shared attention block's gradient summed over its
uses, `A_log`, `dt_bias`, `conv_w`), `prefill` and `decode` with every
cache leaf, a prompt of 256 tokens (two 128-token SSD chunks), and the
ring cache of a sliding window, against the JAX package with its
weights handed over; two steps through `train_loop`; and five AdamW
steps' losses and gradient norms against the reference's train step.

Tolerances (f32): logits and loss atol = rtol = 1e-5; gradients
tests/test_torch_train.py's rule (atol = 1e-5 * max |grad|, rtol 1e-4);
prefill / decode logits and every cache leaf atol = rtol = 1e-4
(tests/test_torch_model.py's prefill tolerance); the core functions
atol = rtol = 1e-5, their input gradients under the gradient rule; the
five steps' losses atol = rtol = 1e-4, gradient norms rtol 1e-4.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import HybridModel
from repro_torch.models import ssm as tssm
from repro_torch.models.model import (decode_slots, flatten_params,
                                     layer_params)

from torch_parity import (assert_grads_close,
                          assert_train_path_matches_jax, close, grad_close,
                          models, randn, to_jax, to_torch, tokens)

torch.set_num_threads(2)
ARCH = "zamba2-2.7b"
TOL = 1e-4
CACHE_KEYS = ("k", "v", "ssm_state", "conv")


def _batch(cfg, B, S, seed):
    toks = tokens(cfg.vocab_size, (B, S + 1), seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_train_logits_loss_and_grads_match_jax():
    jcfg, jm, jp, tm = models(ARCH)
    assert isinstance(tm, HybridModel)
    batch = _batch(jcfg, B=2, S=24, seed=0)
    tb = to_torch(batch)
    jlogits, _ = jax.jit(jm.train_logits)(jp, to_jax(batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, to_jax(batch))
    with torch.no_grad():
        close(tm.train_logits(tb), jlogits, 1e-5, 1e-5)
        close(tm.train_logits(tb, remat=False), jlogits, 1e-5, 1e-5)
    tm.requires_grad_(True)
    loss, metrics = tm.loss(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    assert float(metrics["ce"]) == float(metrics["loss"])
    # the leaves the issue names: one shared block used n_sb times, the
    # f32 SSD parameters and the conv weights, all with a gradient
    flat = {"shared_attn/attn/wq", "shared_attn/mlp/wg",
            "mamba_sb/mamba/A_log", "mamba_sb/mamba/dt_bias",
            "mamba_sb/mamba/conv_w"}
    got = flatten_params(tm.params)
    assert all(got[k].grad is not None for k in flat)
    assert got["mamba_sb/mamba/A_log"].dtype == torch.float32
    assert_grads_close(tm, jgrads)


def _prefill_decode(jm, jp, tm, toks, S, N, cache_len):
    """Prefill toks[:, :S], then N decodes of toks[:, S:] on both
    packages: [(port logits, JAX logits)] per step, and both caches."""
    B = toks.shape[0]
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   jm.init_cache(B, cache_len))
    with torch.no_grad():
        tlog, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                              tm.init_cache(B, cache_len))
    steps = [(tlog, jlog)]
    decode = jax.jit(jm.decode)
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        with torch.no_grad():
            tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        steps.append((tlog, jlog))
    return steps, tc, jc


@pytest.mark.parametrize("S", [24, 256])
def test_prefill_then_decode_matches_jax(S):
    """Prefill S tokens (256: two 128-token SSD chunks, the inter-chunk
    state carried), then 3 decodes: logits at every step and every cache
    leaf (the shared block's K/V per use, each Mamba2 layer's SSD state
    and conv tail, len, window)."""
    jcfg, jm, jp, tm = models(ARCH, seed=1)
    B, N = 2 if S < 128 else 1, 3
    toks = tokens(jcfg.vocab_size, (B, S + N), 2)
    steps, tc, jc = _prefill_decode(jm, jp, tm, toks, S, N, S + N)
    for i, (t, j) in enumerate(steps):
        close(t, j, TOL, TOL, f"step {i}")
    assert sorted(tc) == sorted(jc)
    for name in CACHE_KEYS:
        close(tc[name], jc[name], TOL, TOL, name)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [S + N] * B
    assert tc["window"] == int(jc["window"]) == 0


def test_ring_cache_matches_jax_layout():
    """sliding_window 16, a 24-token prompt into a 16-slot cache: the
    reference keeps positions 8..23 in slots 0..15 (its prefill attends
    through the window), then decodes into slot cur % 16, so the first
    decode overwrites slot 8 of every use's K/V and nothing else. Logits,
    every cache leaf and that slot match."""
    jcfg, jm, jp, tm = models(ARCH, sliding_window=16)
    B, S, N = 1, 24, 5
    toks = tokens(jcfg.vocab_size, (B, S + N), 3)
    steps, tc, jc = _prefill_decode(jm, jp, tm, toks, S, 0, 16)
    close(steps[0][0], steps[0][1], TOL, TOL, "prefill")
    assert tc["window"] == int(jc["window"]) == 16
    write_idx, kv_len = decode_slots(tc)
    assert write_idx.tolist() == [8] and kv_len.tolist() == [16]
    before = tc["k"].clone()
    decode = jax.jit(jm.decode)
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        with torch.no_grad():
            tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
        if i == S:
            changed = (tc["k"] != before).flatten(3).any(-1)   # (n_sb,B,S)
            assert changed.any(0).any(0).nonzero().flatten().tolist() == [8]
    for name in CACHE_KEYS:
        close(tc[name], jc[name], TOL, TOL, name)


def test_mamba_core_functions_match_jax():
    """`ssd_chunked` with chunk 8 < S 32, two groups over four heads and
    a non-zero incoming state (values and the gradients of every input);
    `mamba_forward` with a non-zero state and conv tail, chunk 8 < S 16;
    `mamba_decode` from a non-zero state and conv tail."""
    B, S, H, P, G, N = 2, 32, 4, 16, 2, 8
    x, Bm, Cm = (randn(s, i, 0.5) for i, s in
                 enumerate([(B, S, H, P), (B, S, G, N), (B, S, G, N)]))
    dt = np.abs(randn((B, S, H), 3, 0.3)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    s0 = randn((B, H, N, P), 4, 0.5)
    ry, rs = randn((B, S, H, P), 5), randn((B, H, N, P), 6)

    def jloss(x, dt, Bm, Cm, s0):
        y, st = jssm.ssd_chunked(x, dt, jnp.asarray(A), Bm, Cm, chunk=8,
                                 initial_state=s0)
        return (y * ry).sum() + (st * rs).sum(), (y, st)
    (_, (jy, jst)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=range(5), has_aux=True))(
        *map(jnp.asarray, (x, dt, Bm, Cm, s0)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, Bm, Cm, s0)]
    y, st = tssm.ssd_chunked(*leaves[:2], torch.from_numpy(A), *leaves[2:4],
                             chunk=8, initial_state=leaves[4])
    ((y * torch.from_numpy(ry)).sum()
     + (st * torch.from_numpy(rs)).sum()).backward()
    close(y, jy, 1e-5, 1e-5, "y")
    close(st, jst, 1e-5, 1e-5, "state")
    for t, j in zip(leaves, jg):
        grad_close(t.grad, j)

    jcfg, jm, jp, tm = models(ARCH, seed=2)
    jl = jax.tree.map(lambda a: a[0, 0], jp["mamba_sb"])["mamba"]
    tl = layer_params(tm.params["mamba_sb"], (0, 0))["mamba"]
    d_in, H, P, N, G = tssm.mamba_dims(tm.cfg)
    K, C = jcfg.ssm.conv_dim, d_in + 2 * G * N
    h = randn((B, 16, jcfg.d_model), 7)
    state, conv = randn((B, H, N, P), 8, 0.3), randn((B, K - 1, C), 9)
    jout, (jst, jcv) = jax.jit(lambda *a: jssm.mamba_forward(
        jcfg, *a[:2], state=a[2], conv_cache=a[3], chunk=8))(
        jl, *map(jnp.asarray, (h, state, conv)))
    tout, (tst, tcv) = tssm.mamba_forward(tm.cfg, tl, torch.from_numpy(h),
                                          state=torch.from_numpy(state),
                                          conv_cache=torch.from_numpy(conv),
                                          chunk=8)
    for t, j, name in ((tout, jout, "out"), (tst, jst, "state"),
                       (tcv, jcv, "conv")):
        close(t, j, 1e-5, 1e-5, name)
    jout, (jst, jcv) = jax.jit(lambda *a: jssm.mamba_decode(jcfg, *a))(
        jl, *map(jnp.asarray, (h[:, :1], state, conv)))
    tout, (tst, tcv) = tssm.mamba_decode(tm.cfg, tl, torch.from_numpy(
        h[:, :1]), torch.from_numpy(state), torch.from_numpy(conv))
    for t, j, name in ((tout, jout, "decode out"), (tst, jst, "decode state"),
                       (tcv, jcv, "decode conv")):
        close(t, j, 1e-5, 1e-5, name)


def test_hybrid_trains_through_train_loop(capsys):
    """Two AdamW steps through the training CLI (`train_loop.train`, the
    data stream's tokens and labels): finite losses near ln(vocab)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    res = train(cfg, steps=2, dc=DataConfig(batch_size=2, seq_len=16),
                device="cpu", log_every=1)
    assert len(res.losses) == 2 and all(map(math.isfinite, res.losses))
    assert abs(res.losses[0] - math.log(cfg.vocab_size)) < 1.0
    assert "step     1" in capsys.readouterr().out


def test_five_adamw_steps_match_jax():
    """Five AdamW steps of `train_loop.train` against the reference's
    jitted train step from the same weights: losses and gradient norms
    step by step (a second witness for the port's backward and optimizer
    over steps, beside the one-step gradients above)."""
    assert_train_path_matches_jax(ARCH)
