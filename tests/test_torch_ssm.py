"""Port parity, the ssm family (xlstm-1.3b smoke, f32; ROADMAP A4e):
`models/ssm.py`'s xLSTM half (`_mlstm_core_chunked`, `mlstm_forward`,
`mlstm_decode`, `slstm_forward`) and `XLSTMModel`'s `train_logits`,
`loss` and every gradient leaf (`r_gates`, `b_gates` and the f32 gate
weights included), `prefill` and `decode` with every cache leaf, and a
prompt of 256 tokens (two 128-token mLSTM chunks), against the JAX
package with its weights handed over; two steps through `train_loop`;
and five AdamW steps' losses and gradient norms against the
reference's train step.

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
from repro_torch.configs import get_smoke_config
from repro_torch.models import XLSTMModel
from repro_torch.models import ssm as tssm
from repro_torch.models.model import flatten_params, layer_params

from torch_parity import (assert_grads_close,
                          assert_train_path_matches_jax, close, grad_close,
                          models, randn, to_jax, to_torch, tokens)

torch.set_num_threads(2)
ARCH = "xlstm-1.3b"
TOL = 1e-4
CACHE_KEYS = ("mC", "mn", "mm", "sc", "sn", "sm", "sh")


def test_train_logits_loss_and_grads_match_jax():
    jcfg, jm, jp, tm = models(ARCH)
    assert isinstance(tm, XLSTMModel)
    toks = tokens(jcfg.vocab_size, (2, 25), 0)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
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
    got = flatten_params(tm.params)
    for key in ("slstm_sb/slstm/r_gates", "slstm_sb/slstm/b_gates",
                "mlstm_sb/mlstm/w_i", "mlstm_sb/mlstm/b_f"):
        assert got[key].dtype == torch.float32 and got[key].grad is not None
    assert_grads_close(tm, jgrads)


@pytest.mark.parametrize("S", [24, 256])
def test_prefill_then_decode_matches_jax(S):
    """Prefill S tokens from the initial state (mm at -1e30, sm at -10;
    256: two 128-token mLSTM chunks, the inter-chunk state carried), then
    3 decodes by the exact recurrence: logits at every step and every
    cache leaf."""
    jcfg, jm, jp, tm = models(ARCH, seed=1)
    B, N = 2 if S < 128 else 1, 3
    toks = tokens(jcfg.vocab_size, (B, S + N), 2)
    jc, tc = jm.init_cache(B, S + N), tm.init_cache(B, S + N)
    assert sorted(tc) == sorted(jc)
    for name in CACHE_KEYS:
        close(tc[name], jc[name], 0, 0, name)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   jc)
    with torch.no_grad():
        tlog, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                              tc)
    close(tlog, jlog, TOL, TOL, "prefill")
    decode = jax.jit(jm.decode)
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        with torch.no_grad():
            tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
    for name in CACHE_KEYS:
        close(tc[name], jc[name], TOL, TOL, name)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [S + N] * B


def test_mlstm_core_matches_jax():
    """`_mlstm_core_chunked` with chunk 8 < S 32 from a non-zero incoming
    state (values, and the gradients of q, k, v, the gates and the state)
    and from no state (m at -inf)."""
    B, S, H, hd = 2, 32, 2, 16
    q, k, v = (randn((B, S, H, hd), i, 0.5) for i in range(3))
    ig, fg = randn((B, S, H), 3), randn((B, S, H), 4) + 2.0
    C0, n0 = randn((B, H, hd, hd), 5, 0.5), randn((B, H, hd), 6, 0.5)
    m0 = randn((B, H), 7)
    rh, rC, rn = randn((B, S, H, hd), 8), randn((B, H, hd, hd), 9), \
        randn((B, H, hd), 10)
    ins = (q, k, v, ig, fg, C0, n0, m0)

    def jloss(q, k, v, ig, fg, C0, n0, m0):
        h, (C, n, m) = jssm._mlstm_core_chunked(q, k, v, ig, fg, chunk=8,
                                                state=(C0, n0, m0))
        return ((h * rh).sum() + (C * rC).sum() + (n * rn).sum()
                + m.sum()), (h, C, n, m)
    (_, jouts), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=range(8), has_aux=True))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    h, (C, n, m) = tssm._mlstm_core_chunked(*leaves[:5], chunk=8,
                                            state=tuple(leaves[5:]))
    ((h * torch.from_numpy(rh)).sum() + (C * torch.from_numpy(rC)).sum()
     + (n * torch.from_numpy(rn)).sum() + m.sum()).backward()
    for t, j, name in zip((h, C, n, m), jouts, ("h", "C", "n", "m")):
        close(t, j, 1e-5, 1e-5, name)
    for t, j, name in zip(leaves, jg, ("q", "k", "v", "ig", "fg", "C0",
                                       "n0", "m0")):
        grad_close(t.grad, j, name)
    jh, jst = jax.jit(lambda *a: jssm._mlstm_core_chunked(*a, chunk=8))(
        *map(jnp.asarray, ins[:5]))
    th, tst = tssm._mlstm_core_chunked(*map(torch.from_numpy, ins[:5]),
                                       chunk=8)
    close(th, jh, 1e-5, 1e-5, "h, no state")
    for t, j in zip(tst, jst):
        close(t, j, 1e-5, 1e-5, "state, no state")


def test_mlstm_and_slstm_blocks_match_jax():
    """`mlstm_forward` (chunk 8 < S 16) and `mlstm_decode` from a non-zero
    state, and `slstm_forward` from a non-zero (c, n, m, h), on the smoke
    model's first layers."""
    jcfg, jm, jp, tm = models(ARCH, seed=2)
    B, S = 2, 16
    x = randn((B, S, jcfg.d_model), 11)
    d_in, H, hd = tssm.mlstm_dims(tm.cfg)
    mst = (randn((B, H, hd, hd), 12, 0.3), randn((B, H, hd), 13, 0.3),
           randn((B, H), 14))
    jl = jax.tree.map(lambda a: a[0, 0], jp["mlstm_sb"])["mlstm"]
    tl = layer_params(tm.params["mlstm_sb"], (0, 0))["mlstm"]
    for name, jfn, tfn, xs in (
            ("mlstm_forward",
             lambda p, x, s: jssm.mlstm_forward(jcfg, p, x, state=s,
                                                chunk=8),
             lambda p, x, s: tssm.mlstm_forward(tm.cfg, p, x, state=s,
                                                chunk=8), x),
            ("mlstm_decode", lambda p, x, s: jssm.mlstm_decode(jcfg, p, x, s),
             lambda p, x, s: tssm.mlstm_decode(tm.cfg, p, x, s), x[:, :1])):
        jout, jst = jax.jit(jfn)(jl, jnp.asarray(xs),
                                 tuple(map(jnp.asarray, mst)))
        tout, tst = tfn(tl, torch.from_numpy(xs),
                        tuple(map(torch.from_numpy, mst)))
        close(tout, jout, 1e-5, 1e-5, name)
        for t, j in zip(tst, jst):
            close(t, j, 1e-5, 1e-5, f"{name} state")
    Hs, hds = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    sst = (randn((B, Hs, hds), 15, 0.5), np.abs(randn((B, Hs, hds), 16)) + 1,
           randn((B, Hs, hds), 17), randn((B, Hs, hds), 18, 0.3))
    jl = jax.tree.map(lambda a: a[0], jp["slstm_sb"])["slstm"]
    tl = layer_params(tm.params["slstm_sb"], 0)["slstm"]
    jout, jst = jax.jit(lambda p, x, s: jssm.slstm_forward(
        jcfg, p, x, state=s))(jl, jnp.asarray(x), tuple(map(jnp.asarray, sst)))
    tout, tst = tssm.slstm_forward(tm.cfg, tl, torch.from_numpy(x),
                                   state=tuple(map(torch.from_numpy, sst)))
    close(tout, jout, 1e-5, 1e-5, "slstm_forward")
    for t, j, name in zip(tst, jst, "cnmh"):
        close(t, j, 1e-5, 1e-5, f"slstm state {name}")


def test_xlstm_trains_through_train_loop(capsys):
    """Two AdamW steps through `train_loop.train` on the data stream's
    tokens and labels: finite losses near ln(vocab)."""
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
