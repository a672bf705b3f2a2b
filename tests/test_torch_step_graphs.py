"""The executor's compiled steps (`repro_torch.serving.executor.
_StepGraph`) on the CPU, where they run their static-buffer code without
a capture (the card's capture and replay are in tests/test_torch_cuda.py):

* a dense decode signature's static inputs, refilled whole each step: a
  first decode and a second one at the same signature with other rows,
  lengths and tables each equal, bit for bit, a fresh `_paged_decode` on
  fresh tensors, its logits, tokens and pool writes (the second step's
  padded row back at the trash block and length 0);
* the same for a host-free fused step (`mixed_step`) signature, against
  a fresh `_mixed_forward` on fresh tensors of the same host arrays;
* the same for deepseek-moe-16b's decode and host-free fused steps
  (the dropless dispatch reads nothing on the host, so its steps take
  the static buffers as a dense model's do);
* fused steps with a host-tier chunk stay eager, with no static
  buffers, for both families;
* the engine's tokens, `jit_retraces` and registry snapshot still equal
  the JAX engine's on granite-3-2b and deepseek-moe-16b smoke in f32 in
  exclusive, two-call chunked and fused modes, its compiled steps in
  use.

Smoke configs in f32, at most 5 requests of prompts below 60 tokens."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model
from repro.serving.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.serving.engine import LayerKVEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro.serving.scheduler import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.serving.costmodel import TPU_V5E
from repro_torch.serving.engine import LayerKVEngine
from repro_torch.serving.executor import (MixedChunk, MixedDecode,
                                          PagedExecutor, _StepGraph)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ServeConfig
from repro_torch.weights import from_jax_params
from torch_parity import two_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

ARCH = "granite-3-2b"
BS, NDB, NHB = 8, 40, 16


def _cfg(arch=ARCH):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _executor(arch=ARCH, params=None):
    """A CPU executor (random weights from seed 0, or `params`) whose
    device and host pools hold random values, so every attention read
    is of real data."""
    ex = PagedExecutor(_cfg(arch), params, NDB, NHB, BS, device="cpu",
                       seed=0)
    g = torch.Generator().manual_seed(1)
    for pool in (ex.device_pool, ex.host_pool):
        pool.copy_(torch.randn(pool.shape, generator=g))
    return ex


def _twin(ex):
    """An executor with `ex`'s weights and a copy of its pools."""
    ref = PagedExecutor(ex.cfg, ex.params, NDB, NHB, BS, device="cpu")
    ref.device_pool.copy_(ex.device_pool)
    ref.host_pool.copy_(ex.host_pool)
    return ref


def _same_pool(ex, ref):
    """The device pools equal bit for bit but for the trash block, where
    padded rows write garbage, several to one slot in no set order."""
    return torch.equal(ex.device_pool[:NDB], ref.device_pool[:NDB])


def _logits_of(ex):
    """Make `ex` keep the logits each step reads for its non-finite
    count (the rows it returns tokens for)."""
    seen = []
    note = ex._note_logits

    def keep(logits):
        seen.append(logits.clone())
        note(logits)
    ex._note_logits = keep
    return seen


def _decode_batch(rng, L, R, maxb):
    """R rows, each with its own device blocks per layer and a context
    whose next token falls in its last table column at most."""
    ids = rng.permutation(NDB)[:L * R * maxb].reshape(L, R, maxb)
    lens = rng.randint(1, maxb * BS, R)
    toks = rng.randint(0, 512, R)
    return toks.tolist(), ids.astype(np.int32), lens.tolist()


def _fresh_decode(ref, tokens, tables, kv_lens):
    """`_paged_decode` on fresh tensors padded to the bucket by hand:
    rows to the next power of two (trash tables, length 0), table width
    to 8 blocks."""
    L, R, maxb = tables.shape
    Rb, MAXBb = 1 << (R - 1).bit_length(), -(-maxb // 8) * 8
    tab = torch.full((L, Rb, MAXBb), NDB, dtype=torch.int32)
    tab[:, :R, :maxb] = torch.as_tensor(tables)
    toks = torch.zeros(Rb, dtype=torch.int64)
    toks[:R] = torch.as_tensor(tokens)
    lens = torch.zeros(Rb, dtype=torch.int32)
    lens[:R] = torch.as_tensor(kv_lens, dtype=torch.int32)
    return ref._paged_decode(toks, tab, lens)[:R]


def test_static_decode_equals_a_fresh_decode():
    """Two decodes at one signature (Rb 4, MAXB 8): 4 rows, then 3 rows
    with other tables and lengths; each step's logits, tokens and pool
    (`_same_pool`) equal a fresh `_paged_decode`'s bit for bit, through
    one set of static buffers, and the second step's padded row reads
    the trash block with length 0."""
    _check_static_decode(ARCH)


def test_static_moe_decode_equals_a_fresh_decode():
    """The same for deepseek-moe-16b: its decode steps, MoE dispatch
    included, through the static buffers bit for bit."""
    _check_static_decode("deepseek-moe-16b")


def _check_static_decode(arch):
    ex = _executor(arch)
    ref = _twin(ex)
    seen = _logits_of(ex)
    rng = np.random.RandomState(3)
    L = ex.cfg.n_layers
    for step, R in enumerate((4, 3)):
        tokens, tables, kv_lens = _decode_batch(rng, L, R, 3)
        got = ex.decode(tokens, tables, kv_lens)
        want = _fresh_decode(ref, tokens, tables, kv_lens)
        assert torch.equal(seen[-1], want)
        assert got == torch.argmax(want, dim=-1).tolist()
        assert _same_pool(ex, ref)
        assert list(ex._graphs) == [("decode", (4, 8))]
        g = ex._graphs[("decode", (4, 8))]
        assert g.steps == step + 1 and ex.eager_steps == {"cpu": step + 1}
    assert g.inputs["kv_lens"][3] == 0 and g.inputs["tokens"][3] == 0
    assert (g.inputs["tables"][:, 3] == NDB).all()
    assert ex.graph_captures == ex.graph_replays == 0


def _free_blocks(rng, L):
    """One step's device blocks, per layer: one iterator over the pool's
    blocks in a random order, shared by every layer and row of the step,
    so no two of them write one slot (as no two live sequences' layers
    do, and a scatter to one slot twice leaves either value)."""
    return [iter(rng.permutation(NDB).tolist())] * L


def _chunk(rng, ids, C, offset, tiers=None):
    """A chunk of C tokens at `offset`, each layer's blocks taken from
    its iterator in `ids` (`_free_blocks`) or, for a layer with
    tiers[l], host blocks."""
    nb = -(-(offset + C) // BS)
    tiers = tiers or [False] * len(ids)
    tables = [rng.permutation(NHB)[:nb].tolist() if t
              else [next(it) for _ in range(nb)]
              for t, it in zip(tiers, ids)]
    return MixedChunk(rng.randint(0, 512, C).tolist(), offset, tables,
                      list(tiers))


def _decode_row(rng, ids, ctx):
    nb = ctx // BS + 1
    return MixedDecode(int(rng.randint(0, 512)), ctx,
                       [[next(it) for _ in range(nb)] for it in ids])


def _fresh_mixed(ref, a, Tc, Rb):
    """`_mixed_forward` on fresh tensors of the host arrays `a` a
    compiled fused step was filled from."""
    L = ref.cfg.n_layers

    def t(name, dtype):
        return torch.as_tensor(np.array(a[name]), dtype=dtype)
    i32, i64 = torch.int32, torch.int64
    return ref._mixed_forward(
        t("tokens", i64), t("q_pos", i32), t("off", i64), t("blk_dev", i64),
        [[] for _ in range(L)], t("c_seg", i32),
        torch.as_tensor(np.array(a["q_pos"][:Tc]), dtype=i32),
        t("c_kvlens", i32), t("c_tables", i32), t("c_tier", i32),
        t("d_tables", i32), t("d_kvlens", i32), t("sample_idx", i64),
        t("is_chunk", torch.bool), [None] * L, None, Tc, Rb)


def test_static_fused_step_equals_a_fresh_forward(monkeypatch):
    """Two host-free fused steps at one signature (Tc 64, Sc 2, Rb 2, Sb
    4, MAXBc 8, MAXBd 8): two chunks and two decode rows, then other
    chunks at other offsets and decode rows with other tables and
    contexts; each step's logits and pool (`_same_pool`) equal a fresh
    `_mixed_forward`'s bit for bit, through one set of static buffers."""
    _check_static_fused(monkeypatch, ARCH)


def test_static_moe_fused_step_equals_a_fresh_forward(monkeypatch):
    """The same for deepseek-moe-16b's host-free fused steps."""
    _check_static_fused(monkeypatch, "deepseek-moe-16b")


def _check_static_fused(monkeypatch, arch):
    filled = []
    run = _StepGraph.run

    def spy(self, arrays):
        filled.append({k: np.array(v) for k, v in arrays.items()})
        return run(self, arrays)
    monkeypatch.setattr(_StepGraph, "run", spy)
    ex = _executor(arch)
    ref = _twin(ex)
    seen = _logits_of(ex)
    rng = np.random.RandomState(4)
    L = ex.cfg.n_layers
    steps = []
    for (c1, c2), (d1, d2) in ((((20, 0), (24, 16)), (30, 9)),
                               (((17, 24), (30, 8)), (41, 3))):
        ids = _free_blocks(rng, L)
        steps.append(([_chunk(rng, ids, *c1), _chunk(rng, ids, *c2)],
                      [_decode_row(rng, ids, d1), _decode_row(rng, ids, d2)]))
    sig = (64, 2, 2, 4, 8, 8, False)
    for i, (chunks, decodes) in enumerate(steps):
        got = ex.mixed_step(chunks, decodes)
        want = _fresh_mixed(ref, filled[-1], 64, 2)[:4]
        assert torch.equal(seen[-1], want)
        assert got == torch.argmax(want, dim=-1).tolist()
        assert _same_pool(ex, ref)
        assert list(ex._graphs) == [("mixed", sig)]
        assert ex._graphs[("mixed", sig)].steps == i + 1
    assert ex.eager_steps == {"cpu": 2}


def test_moe_and_host_tier_steps_stay_eager():
    """deepseek-moe-16b's decode and host-free fused steps take their
    static buffers (counted "cpu" here), its fused step with a host-tier
    chunk runs op by op, as does a dense fused step with one: no static
    buffers, counted by reason."""
    rng = np.random.RandomState(5)
    moe = _executor("deepseek-moe-16b")
    L = moe.cfg.n_layers
    moe.decode(*_decode_batch(rng, L, 2, 2))
    ids = _free_blocks(rng, L)
    moe.mixed_step([_chunk(rng, ids, 12, 0)], [_decode_row(rng, ids, 5)])
    assert [fn for fn, _ in moe._graphs] == ["decode", "mixed"]
    assert moe.eager_steps == {"cpu": 2}
    ids = _free_blocks(rng, L)
    moe.mixed_step([_chunk(rng, ids, 12, 8, tiers=[False, True])],
                   [_decode_row(rng, ids, 5)])
    assert len(moe._graphs) == 2
    assert moe.eager_steps == {"cpu": 2, "host-tier": 1}
    dense = _executor()
    L = dense.cfg.n_layers
    ids = _free_blocks(rng, L)
    dense.mixed_step([_chunk(rng, ids, 12, 8, tiers=[False, True])],
                     [_decode_row(rng, ids, 5)])
    assert dense._graphs == {} and dense.eager_steps == {"host-tier": 1}
    assert any(sig[-1] for fn, sig in dense._jit_sigs if fn == "mixed")


# ---------------------------------------------------------- engine parity --

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _params(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    jp = build_model(jcfg).init(jax.random.PRNGKey(42))
    tcfg = _cfg(arch)
    return jcfg, tcfg, jp, from_jax_params(_flat(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def params():
    return _params(ARCH)


@pytest.fixture(scope="module")
def moe_params():
    return _params("deepseek-moe-16b")


MODES = {
    "exclusive": dict(num_device_blocks=30),
    "chunked": dict(num_device_blocks=30, chunked=True,
                    max_prefill_tokens=24),
    "fused": dict(num_device_blocks=40, chunked=True, fused=True,
                  max_prefill_tokens=24),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_with_compiled_steps_matches_jax(params, mode):
    """Tokens, shape signatures (`jit_retraces`) and the registry's
    snapshot equal the JAX engine's; the port's decode (and, fused, its
    host-free mixed) steps ran through their static buffers."""
    _check_engine(params, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_moe_engine_with_compiled_steps_matches_jax(moe_params, mode):
    """The same for deepseek-moe-16b smoke, its MoE steps compiled."""
    _check_engine(moe_params, mode)


def _check_engine(params, mode):
    jcfg, tcfg, jp, tp = params
    r0 = np.random.RandomState(2)
    spec = [(f"r{i}", int(r0.randint(6, 10)),
             [int(x) for x in r0.randint(0, jcfg.vocab_size,
                                         int(r0.randint(28, 52)))])
            for i in range(5)]
    kw = dict(policy="layerkv", slo_aware=False, num_host_blocks=512,
              block_size=8, **MODES[mode])

    def reqs(cls):
        return [cls(rid=rid, prompt_len=len(p), output_len=o, arrival=0.0,
                    prompt=list(p)) for rid, o, p in spec]
    jeng = JaxEngine(jcfg, jp, JaxServeConfig.for_engine(**kw),
                     hw=JAX_TPU_V5E)
    jdone = {r.rid: r.generated for r in jeng.run(reqs(JaxRequest))}
    teng = LayerKVEngine(tcfg, tp, ServeConfig.for_engine(**kw),
                         hw=TPU_V5E, device="cpu")
    tdone = {r.rid: r.generated for r in teng.run(reqs(Request))}
    assert tdone == jdone
    assert dict(teng.ex.jit_retraces) == dict(jeng.ex.jit_retraces)
    assert teng.core.registry.snapshot() == jeng.core.registry.snapshot()
    fns = {fn for fn, _ in teng.ex._graphs}
    assert fns == ({"mixed"} if mode == "fused" else {"decode"})
    assert teng.ex.eager_steps["cpu"] >= len(teng.ex._graphs) > 0
    assert teng.ex.graph_captures == teng.ex.graph_replays == 0
