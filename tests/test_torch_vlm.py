"""Port parity, the vlm family (qwen2-vl-7b smoke, f32; ROADMAP A4b):
`train_logits`, `loss` and its gradients with the stub frontend's
`embeds` and three-stream `mrope_pos`, and prefill + decode (text tokens
at text-stream positions), against the JAX package with its weights
handed over; and the data stream's vlm stub.

Tolerances (f32): logits and caches atol = rtol = 1e-4
(tests/test_torch_model.py's prefill); loss atol = rtol = 1e-5 and
gradients tests/test_torch_train.py's rule (atol = 1e-5 * max |grad|,
rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.training import data as jdata
from repro_torch.training import data as tdata

from torch_parity import (assert_grads_close, close, models, randn,
                          to_jax, to_torch, tokens)

torch.set_num_threads(2)
ARCH = "qwen2-vl-7b"
TOL = 1e-4


def _batch(cfg, B, S, seed):
    """Stub embeds (B, S, d) x 0.02 and positions whose three streams
    differ (t, h, w of a patch grid after a text prefix)."""
    toks = tokens(cfg.vocab_size, (B, S + 1), seed)
    t = np.arange(S)
    grid = np.stack([t, t // 4 + 3 * (t % 2), t % 4 + 1])       # (3, S)
    mrope = np.broadcast_to(grid[:, None] + np.arange(B)[None, :, None],
                            (3, B, S)).astype(np.int32)
    return {"embeds": randn((B, S, cfg.d_model), seed + 1, 0.02),
            "mrope_pos": np.ascontiguousarray(mrope),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_train_logits_loss_and_grads_match_jax():
    jcfg, jm, jp, tm = models(ARCH)
    batch = _batch(jcfg, B=2, S=24, seed=0)
    jlogits, _ = jax.jit(jm.train_logits)(jp, to_jax(batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, to_jax(batch))
    tb = to_torch(batch)
    with torch.no_grad():
        close(tm.train_logits(tb), jlogits, TOL, TOL)
    tm.requires_grad_(True)
    loss, metrics = tm.loss(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    assert float(metrics["loss"]) == float(loss.detach())
    # the stub embeds replace the token embedding, which gets no gradient
    assert tm.params["embed"].grad is None
    assert_grads_close(tm, jgrads)


def test_prefill_then_decode_matches_jax():
    """Prefill from embeds / mrope_pos, then 4 text tokens decoded at
    text-stream positions: logits at every step and the cache."""
    jcfg, jm, jp, tm = models(ARCH, seed=1)
    B, S, N = 2, 20, 4
    batch = _batch(jcfg, B, S, seed=2)
    del batch["labels"]
    nxt = tokens(jcfg.vocab_size, (B, N), 5)
    jlog, jc = jax.jit(jm.prefill)(jp, to_jax(batch), jm.init_cache(B, 32))
    tlog, tc = tm.prefill(to_torch(batch), tm.init_cache(B, 32))
    close(tlog, jlog, TOL, TOL, "prefill")
    decode = jax.jit(jm.decode)
    for i in range(N):
        jlog, jc = decode(jp, jnp.asarray(nxt[:, i]), jc)
        tlog, tc = tm.decode(torch.from_numpy(nxt[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
    for name in ("k", "v"):
        close(tc[name], jc[name], TOL, TOL, name)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [S + N] * B


def test_vlm_stub_stream_matches_jax_tokens():
    """The vlm stub makes the reference's one numpy draw per batch, so the
    token stream stays the reference's; mrope_pos is the reference's
    text positions; the embeds are N(0, 1) x 0.02 from a torch generator
    (their values differ from jax.random's)."""
    jcfg, _, _, tm = models(ARCH)
    dc = dict(batch_size=2, seq_len=16, seed=4)
    jb = jdata.SyntheticLM(jcfg, jdata.DataConfig(**dc)).batches()
    tb = tdata.SyntheticLM(tm.cfg, tdata.DataConfig(**dc),
                           device="cpu").batches()
    for _ in range(3):
        j, t = next(jb), next(tb)
        for key in ("tokens", "labels", "mrope_pos"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
        assert t["embeds"].shape == j["embeds"].shape == (2, 16, 256)
        assert t["embeds"].dtype == torch.float32
        assert 0.015 < float(t["embeds"].std()) < 0.025
        assert not np.allclose(t["embeds"].numpy(), np.asarray(j["embeds"]))


def test_vlm_trains_through_train_loop():
    """`train()` builds the vlm model by family and steps on the stub
    stream: finite losses, and the unused token embedding takes AdamW's
    decay only (its gradient is zero, as in the reference)."""
    from repro_torch.training.train_loop import train
    _, _, jp, tm = models(ARCH)
    embed0 = tm.params["embed"].detach().clone()
    res = train(tm.cfg, steps=2, dc=tdata.DataConfig(batch_size=2,
                                                     seq_len=16),
                device="cpu", params=tm.params, verbose=False)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    moved = (tm.params["embed"] - embed0).abs().max()
    assert float(moved) < 1e-3 * float(embed0.abs().max()) + 1e-6
