"""Port parity, the fused mixed step: the port's `LayerKVEngine` with
`chunked=True, fused=True` (one forward per iteration, prefill chunks
attending straight over the paged pools through `paged_prefill`)
generates the same token ids as the JAX fused engine, from the same
weights (the reference's init, carried across by `repro_torch.weights`)
and the same prompts, at f32 on the smoke configs of granite-3-2b (dense,
GQA) and deepseek-moe-16b (MoE): on a roomy pool, on a tight pool whose
chunks run with host-resident layers (the two-pool variant), and with
prefix-cache hits. Inside the port, fused tokens equal the two-call
engine's and the mixed step reuses its bucketed shape signatures. The
exclusive-prefill MoE engine matches JAX too. Both engines are priced
with the same `TPU_V5E` profile so their schedules, ledgers and shape
signatures can be compared as well as their tokens."""
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
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ServeConfig
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
ARCHS = ["granite-3-2b", "deepseek-moe-16b"]


def _cfgs(arch):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def params():
    """arch -> (jax cfg, port cfg, JAX params, the same params in the
    port), built once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp = build_model(jcfg).init(jax.random.PRNGKey(42))
        out[arch] = (jcfg, tcfg, jp, from_jax_params(_flat(jp), tcfg,
                                                     "cpu"))
    return out


def _prompts(vocab, n=5, plen=(28, 52), out=(6, 10), seed=2):
    r0 = np.random.RandomState(seed)
    spec = []
    for i in range(n):
        p = int(r0.randint(*plen))
        spec.append((f"r{i}", int(r0.randint(*out)),
                     [int(x) for x in r0.randint(0, vocab, p)]))
    return spec


def _shared_prefix_prompts(vocab, n=4, seed=5):
    r0 = np.random.RandomState(seed)
    shared = [int(x) for x in r0.randint(0, vocab, 24)]
    return [(f"r{i}", 8, shared + [int(x) for x in r0.randint(0, vocab, 14)])
            for i in range(n)]


def _reqs(cls, spec, stagger=0.0):
    return [cls(rid=rid, prompt_len=len(p), output_len=o,
                arrival=i * stagger, prompt=list(p))
            for i, (rid, o, p) in enumerate(spec)]


def _kw(**over):
    kw = dict(policy="layerkv", slo_aware=False, num_device_blocks=40,
              num_host_blocks=512, block_size=8, chunked=True, fused=True,
              max_prefill_tokens=24)
    kw.update(over)
    return kw


def _ledger(eng):
    return [(x.kind, x.nbytes) for x in eng.off.ledger.log]


def _run_both(params, arch, spec, stagger=0.0, **over):
    jcfg, tcfg, jp, tp = params[arch]
    kw = _kw(**over)
    jeng = JaxEngine(jcfg, jp, JaxServeConfig.for_engine(**kw),
                     hw=JAX_TPU_V5E)
    jdone = {r.rid: r.generated
             for r in jeng.run(_reqs(JaxRequest, spec, stagger))}
    teng = LayerKVEngine(tcfg, tp, ServeConfig.for_engine(**kw),
                         hw=TPU_V5E, device="cpu")
    # every (offset, host-tier layers) of the chunks the port's steps ran
    teng.host_chunks = []
    step = teng.ex.mixed_step

    def spy(chunks, decodes):
        teng.host_chunks += [(c.offset, sum(c.tiers)) for c in chunks
                             if any(c.tiers)]
        return step(chunks, decodes)
    teng.ex.mixed_step = spy
    tdone = {r.rid: r.generated
             for r in teng.run(_reqs(Request, spec, stagger))}
    return jeng, jdone, teng, tdone


CASES = {
    # roomy pool: chunks and decodes share every step
    "roomy": dict(n=4, seed=2, over={}),
    # tight pool: layerkv admits prompts with layers in the HOST pool, so
    # fused steps run chunk segments through the two-pool kernel variant
    "tight": dict(n=5, seed=2, over=dict(num_device_blocks=30)),
    # the same pool with 20-token chunks on 8-token blocks: a host-tier
    # chunk starts mid-block, so the step's prefetch stages a block the
    # previous chunk half filled and this chunk fills
    "tight_unaligned": dict(n=5, seed=2, over=dict(num_device_blocks=30,
                                                   max_prefill_tokens=20)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_engine_tokens_match_jax(params, arch, case):
    c = CASES[case]
    spec = _prompts(params[arch][0].vocab_size, n=c["n"], seed=c["seed"])
    jeng, jdone, teng, tdone = _run_both(params, arch, spec, **c["over"])
    assert tdone == jdone
    assert _ledger(teng) == _ledger(jeng)
    assert dict(teng.ex.jit_retraces) == dict(jeng.ex.jit_retraces)
    assert max(r.n_chunks for r in teng.done) > 1, "workload must chunk"
    assert teng.ex.nonfinite_logits() == 0
    host_steps = [sig for fn, sig in teng.ex._jit_sigs
                  if fn == "mixed" and sig[-1]]
    if case.startswith("tight"):
        kinds = [k for k, _ in _ledger(teng)]
        assert "offload" in kinds and "reload" in kinds
        assert host_steps, "a fused step must read the host tier"
    if case == "tight_unaligned":
        bs = _kw()["block_size"]
        assert any(off % bs for off, _ in teng.host_chunks), \
            "a host-tier chunk must start mid-block"
    teng.finish()


def test_fused_prefix_cache_hits_match_jax(params):
    """Hits start the fused chunk at prefill_done = cached_len: q_offset
    > 0 against shared blocks, tokens unchanged."""
    arch = "granite-3-2b"
    spec = _shared_prefix_prompts(params[arch][0].vocab_size)
    jeng, jdone, teng, tdone = _run_both(
        params, arch, spec, stagger=1e-4, num_device_blocks=64,
        max_prefill_tokens=16, prefix_cache=True)
    assert teng.bm.cache.n_hits == jeng.bm.cache.n_hits > 0
    assert any(r.cached_prompt_len > 0 for r in teng.done)
    assert tdone == jdone


def test_exclusive_moe_engine_matches_jax(params):
    arch = "deepseek-moe-16b"
    spec = _prompts(params[arch][0].vocab_size, n=4, seed=3)
    jeng, jdone, teng, tdone = _run_both(
        params, arch, spec, chunked=False, fused=False,
        num_device_blocks=30)
    assert tdone == jdone
    assert _ledger(teng) == _ledger(jeng)
    assert "offload" in [k for k, _ in _ledger(teng)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_two_call_in_port(params, arch):
    """THE fused guarantee inside the port: one forward per iteration
    never changes generated tokens, and steady state reuses bucketed
    shape signatures (far fewer than iterations)."""
    _, tcfg, _, tp = params[arch]
    spec = _prompts(tcfg.vocab_size, n=4, seed=7)
    outs = {}
    for fused in (False, True):
        eng = LayerKVEngine(tcfg, tp,
                            ServeConfig.for_engine(**_kw(fused=fused)),
                            hw=TPU_V5E, device="cpu")
        outs[fused] = {r.rid: r.generated
                       for r in eng.run(_reqs(Request, spec))}
    assert outs[True] == outs[False]
    iters = sum(r.n_chunks + r.tokens_out for r in eng.done)
    assert 0 < eng.ex.jit_retraces["mixed"] < iters
    assert "chunk" not in eng.ex.jit_retraces
