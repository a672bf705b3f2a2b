"""Port parity, MoE: the port's `moe_ffn(dropless=True)` — grouped by
expert, no (E, T*K, d) capacity buffer — against the JAX
`repro.models.moe.moe_ffn(dropless=True)` from the same params carried
across by `repro_torch.weights`, at f32 atol = rtol = 2e-5; the MoE
model's prefill against JAX's; the seeded init's router dtype; and the
weight bridge keeping the reference's f32 router in a bf16 model."""
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
    got = tmoe.moe_ffn(tcfg, tl, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    got = tmoe.moe_ffn(tcfg, tl, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_capacity_path_is_not_yet_ported(smoke_params):
    _, tcfg, _, tp = smoke_params
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tmoe.moe_ffn(tcfg, layer_params(tp["layers"], 0)["moe"], x)


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
