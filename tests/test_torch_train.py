"""Port parity, training: the port's training path (`repro_torch.models.
model.DecoderModel.loss`, `repro_torch.training.*`, `launch/train.py`)
against the JAX package on granite-3-2b smoke in f32 (and on
deepseek-moe-16b smoke, through the MoE capacity path), with the
reference's own weights handed over by `weights.from_jax_params` and the
same numpy-made inputs on both sides. On the CPU every norm and attention
call runs the kernels' plain versions, differentiated by autograd — the
functions the CUDA backward kernels are held against on the card.

Tolerances (f32), each from the order of a sum that differs between the
two packages:
  * flash attention gradients: atol = rtol = 2e-5 (the repo's
    Pallas-vs-reference tolerance; sums over <= 256 keys);
  * loss: atol = rtol = 1e-5; every parameter's gradient: atol = 1e-5 *
    max|grad of that parameter| + rtol 1e-4 (sums over the B*S tokens
    and, for the tied embedding, over the vocab as well);
  * AdamW: parameters and moments atol = rtol = 1e-5 on the same
    gradients;
  * `train()` losses over 5 steps: atol = rtol = 1e-4. The first AdamW
    step moves every parameter by about lr * sign(g), so a gradient near
    0 may round to either sign; the losses, not the parameters, are held.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as jref
from repro.models import build_model
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import train as jtrain
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref as tref
from repro_torch.models import DecoderModel
from repro_torch.models.model import cross_entropy, flatten_params
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import train as ttrain
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
ARCH = "granite-3-2b"


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                                **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(cfg, B=2, S=32, seed=0):
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# ------------------------------------------------------- flash gradient ---

@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_grad_matches_jax(D):
    B, S, H, KV = 1, 256, 4, 2
    r = np.random.RandomState(D)
    q, k, v, do = (r.randn(B, S, n, D).astype(np.float32)
                   for n in (H, KV, KV, H))

    def jf(q, k, v):
        return jref.flash_attention_reference(q, k, v, causal=True,
                                              q_chunk=128, kv_chunk=64)
    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tref.flash_attention_reference(tq, tk, tv, causal=True, q_chunk=128,
                                   kv_chunk=64).backward(
                                       torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=2e-5)


# ------------------------------------------------------ loss, gradients ---

@pytest.mark.parametrize("vocab,remat", [(512, True), (500, True),
                                         (500, False)])
def test_loss_and_grads_match_jax(vocab, remat):
    """vocab 500 pads to 512: the pad-vocab mask must give its columns
    zero gradient (tied embedding rows 500..511) and keep the loss
    finite."""
    jcfg, tcfg = _cfgs(vocab_size=vocab)
    model = build_model(jcfg)
    jp = model.init(jax.random.PRNGKey(0))
    toks, labels = _batch(tcfg)
    (jloss, _), jgrads = jax.value_and_grad(model.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tm = DecoderModel(tcfg, from_jax_params(_flat(jp), tcfg, "cpu"),
                      device="cpu")
    tm.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    with torch.no_grad():
        assert tm.train_logits(batch).shape == (2, 32, tcfg.padded_vocab)
    if remat:
        loss, metrics = tm.loss(batch)
        assert float(metrics["ce"]) == float(metrics["loss"]) \
            == float(loss.detach())
    else:
        loss = cross_entropy(tm.train_logits(batch, remat=False),
                             batch["labels"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    flat = flatten_params(tm.params)
    jflat = _flat(jgrads)
    assert sorted(flat) == sorted(jflat)
    for key, p in flat.items():
        want = jflat[key]
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=atol,
                                   rtol=1e-4, err_msg=key)
    if vocab < tcfg.padded_vocab:
        assert (flat["embed"].grad[vocab:] == 0).all()


def test_masked_cross_entropy_matches_jax():
    from repro.models.model import cross_entropy as jce
    r = np.random.RandomState(5)
    logits = r.randn(2, 16, 40).astype(np.float32)
    labels = r.randint(0, 40, (2, 16)).astype(np.int32)
    mask = (r.rand(2, 16) < 0.6).astype(np.float32)
    for m in (mask, None):
        want = jce(jnp.asarray(logits), jnp.asarray(labels),
                   None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6,
                                   rtol=1e-6)


MOE = "deepseek-moe-16b"


def _moe_cfgs():
    return (dataclasses.replace(jax_smoke(MOE), dtype="float32"),
            dataclasses.replace(get_smoke_config(MOE), dtype="float32"))


@pytest.mark.parametrize("remat", [True, False])
def test_moe_loss_and_grads_match_jax(remat):
    """deepseek-moe-16b smoke through the capacity path: the total loss
    (ce + 0.01 * lb_loss), `ce`, `lb_loss` (the mean over layers) and
    `dropped_frac` against the reference's `Model.loss`, and every
    gradient, at the dense test's tolerances; with and without per-block
    checkpointing, whose forward carries the aux terms out."""
    jcfg, tcfg = _moe_cfgs()
    model = build_model(jcfg)
    jp = model.init(jax.random.PRNGKey(1))
    toks, labels = _batch(tcfg, B=2, S=24, seed=3)
    (jloss, jm), jgrads = jax.value_and_grad(model.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tm = DecoderModel(tcfg, from_jax_params(_flat(jp), tcfg, "cpu"),
                      device="cpu")
    tm.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    if remat:
        loss, metrics = tm.loss(batch)
    else:
        logits, aux = tm.train_logits_aux(batch, remat=False)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + 0.01 * aux["lb_loss"]
        metrics = {"ce": ce, "lb_loss": aux["lb_loss"],
                   "dropped_frac": aux["dropped_frac"], "loss": loss}
    assert float(jm["dropped_frac"]) > 0      # the capacity drops pairs
    for key in ("ce", "lb_loss", "dropped_frac", "loss"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    # the same pairs are dropped: the count over layers is equal (the
    # reference's scanned, fused `1 - mean` rounds its last bit otherwise)
    pairs = tcfg.n_layers * toks.size * tcfg.moe.top_k
    assert round(float(metrics["dropped_frac"]) * pairs) \
        == round(float(jm["dropped_frac"]) * pairs)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    loss.backward()
    flat = flatten_params(tm.params)
    jflat = _flat(jgrads)
    assert sorted(flat) == sorted(jflat)
    for key, p in flat.items():
        want = jflat[key]
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=atol,
                                   rtol=1e-4, err_msg=key)


# -------------------------------------------------------------- AdamW ----

def test_adamw_matches_jax():
    r = np.random.RandomState(0)
    shapes = {"a": (3, 16), "b/c": (8,), "b/d": (2, 4, 4)}
    params = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.randn(*s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5)

    def nest(flat, conv):
        out = {}
        for k, v in flat.items():
            *path, leaf = k.split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = conv(v)
        return out

    jp = nest(params, jnp.asarray)
    jstate = jopt.init_opt_state(jp)
    tp = nest(params, lambda a: torch.from_numpy(a.copy()))
    tstate = topt.init_opt_state(tp)
    for g in grads:
        jp, jstate, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg),
                                           nest(g, jnp.asarray), jstate, jp)
        tp, tstate, tm = topt.adamw_update(
            topt.AdamWConfig(**cfg), nest(g, torch.from_numpy), tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for ours, theirs in ((tp, jp), (tstate.mu, jstate.mu),
                             (tstate.nu, jstate.nu)):
            tf, jf = flatten_params(ours), _flat(theirs)
            for k in tf:
                np.testing.assert_allclose(tf[k].numpy(), jf[k], atol=1e-5,
                                           rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 3


# --------------------------------------------------------------- data ----

def test_synthetic_stream_matches_jax():
    _, tcfg = _cfgs()
    dc = dict(batch_size=3, seq_len=40, seed=7, markov_order=2, noise=0.2)
    jb = jdata.SyntheticLM(tcfg, jdata.DataConfig(**dc)).batches()
    tb = tdata.SyntheticLM(tcfg, tdata.DataConfig(**dc),
                           device="cpu").batches()
    for _ in range(3):
        j, t = next(jb), next(tb)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


# -------------------------------------------------------------- train ----

def test_train_losses_match_jax(capsys):
    jcfg, tcfg = _cfgs()
    dc = dict(batch_size=2, seq_len=32)
    want = jtrain(jcfg, steps=5, dc=jdata.DataConfig(**dc), verbose=False)
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    got = ttrain(tcfg, steps=5, dc=tdata.DataConfig(**dc), device="cpu",
                 params=from_jax_params(_flat(jp), tcfg, "cpu"), log_every=2)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-4,
                               rtol=1e-4)
    assert got.steps == 5 and got.final_loss == got.losses[-1]
    assert len(got.grad_norms) == len(got.step_s) == 5
    assert all(np.isfinite(got.grad_norms)) and got.tokens_per_s > 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2", "4"]


def test_moe_train_losses_match_jax(capsys):
    """Five AdamW steps of deepseek-moe-16b smoke: the port's losses
    against the reference's `train()` from the same weights, and the
    load-balance terms in the result and the log line."""
    jcfg, tcfg = _moe_cfgs()
    dc = dict(batch_size=2, seq_len=24)
    want = jtrain(jcfg, steps=5, dc=jdata.DataConfig(**dc), verbose=False)
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    got = ttrain(tcfg, steps=5, dc=tdata.DataConfig(**dc), device="cpu",
                 params=from_jax_params(_flat(jp), tcfg, "cpu"), log_every=2)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-4,
                               rtol=1e-4)
    assert len(got.lb_losses) == len(got.dropped_fracs) == 5
    assert all(np.isfinite(got.lb_losses))
    assert all(0 <= f < 1 for f in got.dropped_fracs)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2", "4"]
    assert all("lb_loss" in ln and "dropped_frac" in ln for ln in lines)


# --------------------------------------------------------- checkpoints ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_crosses_both_ways(tmp_path, dtype):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jp = build_model(jcfg).init(jax.random.PRNGKey(3))
    tp = from_jax_params(_flat(jp), tcfg, "cpu")
    # port save -> JAX load
    tckpt.save(str(tmp_path / "port"), {"params": tp}, meta={"step": 3})
    back, meta = jckpt.load(str(tmp_path / "port"), {"params": jp})
    assert meta == {"step": 3}
    for k, a in _flat(back["params"]).items():
        assert a.dtype == _flat(jp)[k].dtype, k
        np.testing.assert_array_equal(a.astype(np.float32),
                                      _flat(jp)[k].astype(np.float32))
    with open(tmp_path / "port" / "manifest.json") as f:
        assert set(json.load(f)) >= {"keys", "dtypes", "meta"}
    # JAX save -> port load
    jckpt.save(str(tmp_path / "jax"), {"params": jp}, meta={"step": 4})
    loaded, meta = load_checkpoint(str(tmp_path / "jax"), tcfg, "cpu")
    assert meta == {"step": 4}
    for k, t in flatten_params(loaded["params"]).items():
        assert t.dtype == flatten_params(tp)[k].dtype, k
        assert torch.equal(t, flatten_params(tp)[k]), k


def test_train_checkpoint_cadence(tmp_path):
    _, tcfg = _cfgs()
    ttrain(tcfg, steps=2, dc=tdata.DataConfig(batch_size=1, seq_len=8),
           device="cpu", ckpt_path=str(tmp_path), ckpt_every=1,
           verbose=False)
    params, meta = load_checkpoint(str(tmp_path), tcfg, "cpu")
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert os.path.exists(tmp_path / "arrays.npz")
    assert set(params) == {"params"}


# ---------------------------------------------------------------- CLI ----

def test_train_cli_runs_on_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step     1" in out


def test_train_cli_runs_moe_on_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--arch", MOE, "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step     1" in out
    assert "lb_loss" in out and "dropped_frac" in out


def test_train_cli_raises_without_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
