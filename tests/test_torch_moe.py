"""Port parity, MoE: the port's `moe_ffn` against the JAX
`repro.models.moe.moe_ffn` from the same params carried across by
`repro_torch.weights`, at f32 atol = rtol = 2e-5 — the dropless path
(grouped by expert, no (E, T*K, d) capacity buffer, no aux terms) and
the capacity-factor path (output, `lb_loss`, `dropped_frac` exactly,
and the input and parameter gradients at the train tolerance of
tests/test_torch_train.py); the MoE model's prefill against JAX's; the
seeded init's router dtype; and the weight bridge keeping the
reference's f32 router in a bf16 model."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model
from repro.models import moe as jmoe
from repro.training import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderModel
from repro_torch.models import moe as tmoe
from repro_torch.models.model import flatten_params, layer_params
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "deepseek-moe-16b"


def _cfgs(dtype="float32", **moe_kw):
    j, t = jax_smoke(ARCH), get_smoke_config(ARCH)
    if moe_kw:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw))
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


@pytest.fixture(scope="module")
def smoke_params():
    jcfg, tcfg = _cfgs()
    jp = build_model(jcfg).init(jax.random.PRNGKey(4))
    return jcfg, tcfg, jp, from_jax_params(_flat(jp), tcfg, "cpu")


@pytest.mark.parametrize("B,S", [(1, 1), (1, 37), (3, 8)])
def test_moe_ffn_dropless_matches_jax(smoke_params, B, S):
    jcfg, tcfg, jp, tp = smoke_params
    x = np.random.RandomState(B * 100 + S).randn(
        B, S, jcfg.d_model).astype(np.float32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])["moe"]
    tl = layer_params(tp["layers"], 1)["moe"]
    want, _ = jmoe.moe_ffn(jcfg, jl, jnp.asarray(x), dropless=True)
    got, aux = tmoe.moe_ffn(tcfg, tl, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # serving reads no load-balance terms, so the dropless path makes none
    assert aux == {}


def test_moe_ffn_without_shared_experts_matches_jax():
    """llama4-scout style: no shared expert, top-1 routing."""
    jcfg, tcfg = _cfgs(n_shared=0, top_k=1)
    jp = build_model(jcfg).init(jax.random.PRNGKey(7))
    tp = from_jax_params(_flat(jp), tcfg, "cpu")
    x = np.random.RandomState(0).randn(2, 9, jcfg.d_model) \
        .astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])["moe"]
    tl = layer_params(tp["layers"], 0)["moe"]
    assert "shared" not in tl
    want, _ = jmoe.moe_ffn(jcfg, jl, jnp.asarray(x), dropless=True)
    got, _ = tmoe.moe_ffn(tcfg, tl, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def no_shared_params():
    """No shared expert, top-2 routing. (At top-1 the renormalised gate is
    identically 1, so the router's gradient through it is zero up to
    rounding and a comparison would hold only rounding noise.)"""
    jcfg, tcfg = _cfgs(n_shared=0, top_k=2)
    jp = build_model(jcfg).init(jax.random.PRNGKey(7))
    return jcfg, tcfg, jp, from_jax_params(_flat(jp), tcfg, "cpu")


# (config, B, S, capacity factor, layer): the default factor 1.25 drops
# pairs on skewed routing (deepseek smoke B 2 S 37: 1 of 74 pairs), a
# factor of 0.5 drops half of a balanced load, and a single token fits
CAPACITY_CASES = [("deepseek", 1, 1, 1.25, 0), ("deepseek", 2, 37, 1.25, 1),
                  ("deepseek", 3, 8, 0.5, 1), ("deepseek", 4, 16, 1.0, 0),
                  ("no_shared", 2, 9, 1.25, 0), ("no_shared", 3, 16, 0.5, 0)]


@pytest.mark.parametrize("which,B,S,cf,layer", CAPACITY_CASES)
def test_moe_ffn_capacity_matches_jax(smoke_params, no_shared_params, which,
                                      B, S, cf, layer):
    """The capacity-factor path (training's): the output and `lb_loss` at
    f32 atol = rtol = 2e-5, `dropped_frac` exactly (the same pairs are
    dropped), and the gradients of sum(out * r) + lb_loss with respect
    to the input and every parameter at the train tolerance (atol = 1e-5
    x max |grad|, rtol = 1e-4: tests/test_torch_train.py)."""
    jcfg, tcfg, jp, tp = smoke_params if which == "deepseek" \
        else no_shared_params
    rng = np.random.RandomState(B * 100 + S)
    x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    r = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    jl = jax.tree.map(lambda a: a[layer], jp["layers"])["moe"]
    tl = {k: v.clone().requires_grad_(True) for k, v in
          _flat(layer_params(tp["layers"], layer)["moe"],
                leaf=lambda t: t).items()}

    def jf(x, p):
        out, aux = jmoe.moe_ffn(jcfg, p, x, capacity_factor=cf)
        return jnp.sum(out * jnp.asarray(r)) + aux["lb_loss"], (out, aux)
    (_, (want, waux)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jl)

    tx = torch.from_numpy(x).requires_grad_(True)
    nested = {}
    for k, v in tl.items():
        *path, leaf = k.split("/")
        node = nested
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    got, aux = tmoe.moe_ffn(tcfg, nested, tx, capacity_factor=cf)
    (torch.sum(got * torch.from_numpy(r)) + aux["lb_loss"]).backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"].detach()),
                               float(waux["lb_loss"]), **TOL)
    assert float(aux["dropped_frac"]) == float(waux["dropped_frac"])
    if (which, B, S) in (("deepseek", 2, 37), ("deepseek", 3, 8),
                         ("no_shared", 3, 16)):
        assert float(aux["dropped_frac"]) > 0
    jflat = {"x": np.asarray(jgx), **_flat(jgp)}
    tflat = {"x": tx.grad, **{k: v.grad for k, v in tl.items()}}
    assert sorted(tflat) == sorted(jflat)
    for key, g in tflat.items():
        w = jflat[key]
        atol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=1e-4,
                                   err_msg=key)


def test_moe_model_prefill_matches_jax(smoke_params):
    jcfg, tcfg, jp, tp = smoke_params
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 24))
    plen = np.asarray([24, 17], np.int32)
    jm = build_model(jcfg)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                   "prompt_len": jnp.asarray(plen)},
                              jm.init_cache(2, 24), dropless=True)
    tm = DecoderModel(tcfg, tp, device="cpu")
    tlog, tcache = tm.prefill({"tokens": torch.from_numpy(toks).long(),
                               "prompt_len": torch.from_numpy(plen)},
                              tm.init_cache(2, 24), dropless=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4, rtol=1e-4)


def test_seeded_moe_init_has_reference_shapes_and_f32_router():
    jcfg, tcfg = _cfgs("bfloat16")
    a = flatten_params(DecoderModel(tcfg, device="cpu", seed=5).params)
    ref = _flat(jax.eval_shape(build_model(jcfg).init,
                               jax.random.PRNGKey(0)), leaf=lambda v: v)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert {k: str(v.dtype)[6:] for k, v in a.items()} == \
        {k: str(v.dtype) for k, v in ref.items()}
    assert a["layers/moe/router"].dtype == torch.float32
    assert a["layers/moe/we_gate"].dtype == torch.bfloat16


def test_bf16_moe_router_crosses_over_in_f32(tmp_path):
    """The weight bridge keeps each leaf's own dtype: the reference's f32
    router stays f32 in a bf16 model, directly and through a checkpoint
    (which widens bf16 to f32 on disk and records the dtype)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = build_model(jcfg).init(jax.random.PRNGKey(2))
    flat = _flat(jp)
    assert flat["layers/moe/router"].dtype == np.float32
    assert flat["layers/moe/we_gate"].dtype == ml_dtypes.bfloat16
    checkpoint.save(str(tmp_path), jp)
    for params in (from_jax_params(flat, tcfg, "cpu"),
                   load_checkpoint(str(tmp_path), tcfg, "cpu")[0]):
        fp = flatten_params(params)
        assert fp["layers/moe/router"].dtype == torch.float32
        assert fp["layers/moe/we_up"].dtype == torch.bfloat16
        assert fp["layers/attn/wq"].dtype == torch.bfloat16
        assert torch.equal(fp["layers/moe/router"],
                           torch.tensor(flat["layers/moe/router"]))
