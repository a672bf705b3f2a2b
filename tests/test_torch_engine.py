"""Port parity, serving: the port's `PagedExecutor` units, and the port's
`LayerKVEngine` generating the same token ids as the JAX
`LayerKVEngine` on granite-3-2b smoke at f32, from the same weights (the
reference's init, carried across by `repro_torch.weights`) and the same
prompts — in exclusive vllm, exclusive layerkv under a tight pool
(offload + reload), two-call chunked mode, prefix-cache hits and a
mid-run cancel; plus lossless preempt/resume inside the port. Both
engines are priced
with the same `TPU_V5E` profile here so their schedules, not only their
tokens, can be compared."""
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
from repro.serving.session import ServingSession as JaxSession
from repro_torch.configs import get_smoke_config
from repro_torch.serving.costmodel import H100, TPU_V5E
from repro_torch.serving.engine import LayerKVEngine
from repro_torch.serving.executor import PagedExecutor, _bucket, _runs
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import ServeConfig
from repro_torch.serving.session import ServingSession
from repro_torch.weights import from_jax_params

torch.set_num_threads(2)
ARCH = "granite-3-2b"


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_params():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    return jcfg, build_model(jcfg).init(jax.random.PRNGKey(42))


def _prompts(vocab, n=5, plen=(28, 52), out=(6, 10), seed=2):
    r0 = np.random.RandomState(seed)
    spec = []
    for i in range(n):
        p = int(r0.randint(*plen))
        spec.append((f"r{i}", int(r0.randint(*out)),
                     [int(x) for x in r0.randint(0, vocab, p)]))
    return spec


def _reqs(cls, spec):
    return [cls(rid=rid, prompt_len=len(p), output_len=o, arrival=0.0,
                prompt=list(p)) for rid, o, p in spec]


def _ledger(eng):
    return [(x.kind, x.nbytes) for x in eng.off.ledger.log]


MODES = {
    "vllm": dict(policy="vllm", num_device_blocks=1024),
    "layerkv_tight": dict(policy="layerkv", num_device_blocks=30),
    "chunked": dict(policy="layerkv", num_device_blocks=30, chunked=True,
                    max_prefill_tokens=24),
}


def _port_engine(params, device="cpu", hw=TPU_V5E, **kw):
    base = dict(slo_aware=False, num_host_blocks=512, block_size=8)
    base.update(kw)
    return LayerKVEngine(_cfg(), params, ServeConfig.for_engine(**base),
                         hw=hw, device=device)


# --------------------------------------------------------- engine parity --

@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_tokens_match_jax_engine(jax_params, mode):
    jcfg, jp = jax_params
    spec = _prompts(jcfg.vocab_size)
    kw = dict(slo_aware=False, num_host_blocks=512, block_size=8,
              **MODES[mode])
    jeng = JaxEngine(jcfg, jp, JaxServeConfig.for_engine(**kw),
                     hw=JAX_TPU_V5E)
    jdone = {r.rid: r.generated for r in jeng.run(_reqs(JaxRequest, spec))}
    teng = _port_engine(from_jax_params(_flat(jp), _cfg(), "cpu"),
                        **MODES[mode])
    tdone = {r.rid: r.generated for r in teng.run(_reqs(Request, spec))}
    assert tdone == jdone
    # same cost model, same core: the schedule is the same too
    assert _ledger(teng) == _ledger(jeng)
    assert dict(teng.ex.jit_retraces) == dict(jeng.ex.jit_retraces)
    if mode == "layerkv_tight":
        kinds = [k for k, _ in _ledger(teng)]
        assert "offload" in kinds and "reload" in kinds
    if mode == "chunked":
        assert max(r.n_chunks for r in teng.done) > 1
    assert teng.ex.nonfinite_logits() == 0


def _shared_prefix_prompts(vocab, n=5, pre=24, seed=1):
    r0 = np.random.RandomState(seed)
    prefix = [int(x) for x in r0.randint(0, vocab, pre)]
    return [(f"r{i}", int(r0.randint(6, 12)),
             prefix + [int(x) for x in r0.randint(
                 0, vocab, int(r0.randint(6, 20)))]) for i in range(n)]


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["exclusive", "chunked"])
def test_prefix_cache_hits_match_jax_engine(jax_params, chunked):
    """Prefix-cache hits run the uncached suffix through the chunk path
    (flash with a runtime q_offset over the shared blocks)."""
    jcfg, jp = jax_params
    spec = _shared_prefix_prompts(jcfg.vocab_size)
    kw = dict(policy="layerkv", slo_aware=False, num_device_blocks=64,
              num_host_blocks=512, block_size=8, chunked=chunked,
              max_prefill_tokens=24, prefix_cache=True)

    def staggered(cls):   # early prefills register before later arrivals
        reqs = _reqs(cls, spec)
        for i, r in enumerate(reqs):
            r.arrival = i * 1e-4
        return reqs
    jeng = JaxEngine(jcfg, jp, JaxServeConfig.for_engine(**kw),
                     hw=JAX_TPU_V5E)
    jdone = {r.rid: r.generated for r in jeng.run(staggered(JaxRequest))}
    teng = LayerKVEngine(_cfg(), from_jax_params(_flat(jp), _cfg(), "cpu"),
                         ServeConfig.for_engine(**kw), hw=TPU_V5E,
                         device="cpu")
    tdone = {r.rid: r.generated for r in teng.run(staggered(Request))}
    assert teng.bm.cache.n_hits == jeng.bm.cache.n_hits > 0
    assert tdone == jdone


def test_cancel_mid_run_matches_jax_engine(jax_params):
    jcfg, jp = jax_params
    spec = _prompts(jcfg.vocab_size, n=4, seed=3)
    kw = dict(policy="layerkv", slo_aware=False, num_device_blocks=30,
              num_host_blocks=512, block_size=8)
    outs = []
    for eng, sess_cls, req_cls in (
            (JaxEngine(jcfg, jp, JaxServeConfig.for_engine(**kw),
                       hw=JAX_TPU_V5E), JaxSession, JaxRequest),
            (_port_engine(from_jax_params(_flat(jp), _cfg(), "cpu"), **kw),
             ServingSession, Request)):
        sess = sess_cls(eng)
        handles = [sess.submit(r, arrival=0.0)
                   for r in _reqs(req_cls, spec)]
        for _ in range(3):
            sess.step()
        assert sess.cancel(handles[1])
        outs.append({r.rid: list(r.generated) for r in sess.drain()})
        eng.finish()
    assert "r1" not in outs[0] and outs[0] == outs[1]


def test_preempt_and_resume_is_lossless_in_port():
    """Pause r0 mid-decode (KV demoted to the HOST pool and back): its
    tokens equal an uninterrupted run's — the port's d2h/h2d copies keep
    the bytes (mirrors tests/test_preemption.py on the reference)."""
    sc = dict(policy="layerkv", preemption=True, admission="deadline",
              num_device_blocks=96, block_size=8)
    spec = _prompts(_cfg().vocab_size, n=3, plen=(24, 25), out=(8, 9))
    ref = {r.rid: list(r.generated)
           for r in _port_engine(None, **sc).run(_reqs(Request, spec))}
    eng = _port_engine(None, **sc)
    sess = ServingSession(eng)
    for r in _reqs(Request, spec):
        sess.submit(r, arrival=0.0)
    preempted = False
    while True:
        if not preempted:
            v = [r for r in eng.decoding
                 if r.rid == "r0" and r.tokens_out >= 3]
            if v:
                assert eng.core.preempt_request(v[0], eng.now)
                assert v[0].phase is Phase.PAUSED
                preempted = True
        if not sess.step():
            break
    got = {r.rid: list(r.generated) for r in sess.drain()}
    assert preempted and eng.core.n_resumed == 1
    assert got == ref
    eng.finish()


def test_port_vllm_matches_layerkv_with_offload():
    """The paper's guarantee inside the port: layer-wise offload and
    reload never change the tokens (default H100 pricing)."""
    spec = _prompts(_cfg().vocab_size, n=6, seed=5)
    v = _port_engine(None, hw=H100, policy="vllm", num_device_blocks=1024)
    lk = _port_engine(None, hw=H100, policy="layerkv", num_device_blocks=30)
    out_v = {r.rid: r.generated for r in v.run(_reqs(Request, spec))}
    out_l = {r.rid: r.generated for r in lk.run(_reqs(Request, spec))}
    kinds = [k for k, _ in _ledger(lk)]
    assert kinds.count("offload") > 0 and kinds.count("reload") > 0
    assert out_v == out_l


def test_sanitizer_and_tracer_run_on_port_engine():
    eng = _port_engine(None, policy="layerkv", num_device_blocks=30,
                       sanitize=True, trace=True)
    spec = _prompts(_cfg().vocab_size, n=4, seed=9)
    done = eng.run(_reqs(Request, spec))
    assert len(done) == 4
    assert eng.core.sanitizer is not None
    tr = eng.core.tracer
    assert len(tr.breakdowns()) == 4
    assert all("wall" in ev for ev in tr.events)
    assert eng.ex.registry is eng.core.registry
    assert eng.core.registry.total("jit_retraces") > 0


def test_unported_engine_modes_raise():
    """Dense and MoE, fused or not, are ported (tests/test_torch_fused.py);
    the other families and the int8 KV cache still raise."""
    for arch, extra in (("qwen2-vl-7b", {}),
                        ("deepseek-moe-16b", {"kv_quant": True})):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  **extra)
        with pytest.raises(ValueError, match="not yet ported"):
            LayerKVEngine(cfg, None, ServeConfig.for_engine(chunked=True,
                                                            fused=True),
                          device="cpu")


# -------------------------------------------------------- executor units --

def _ex(ndb=16, nhb=32, bs=8):
    return PagedExecutor(_cfg(), None, ndb, nhb, bs, device="cpu", seed=0)


def test_bucket_and_runs():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert _bucket(3, lo=16) == 16
    assert list(_runs([4, 5, 6, 9, 2, 3])) == [(0, 3, 4), (3, 4, 9),
                                              (4, 6, 2)]
    assert list(_runs([])) == []


def test_pools_carry_trash_block():
    ex = _ex(ndb=16, nhb=32)
    cfg = _cfg()
    tail = (8, 2, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert tuple(ex.device_pool.shape) == (17, *tail)
    assert tuple(ex.host_pool.shape) == (33, *tail)


def test_prefill_pad_bucketing_shares_signatures():
    ex = _ex()
    ex.prefill([1, 2, 3], 8)      # bucket 16
    ex.prefill([4, 5], 16)        # bucket 16 — same signature
    ex.prefill([1] * 20, 24)      # bucket 32
    assert ex.jit_retraces["prefill"] == 2


def test_decode_buckets_and_pad_rows():
    ex = _ex()
    L = _cfg().n_layers
    tab = np.zeros((L, 3, 2), np.int32)
    for r, blocks in enumerate(([0, 1], [2, 3], [4, 5])):
        _, kk, vv = ex.prefill([7, 3, 5, 2, 9], 16)
        for l in range(L):
            ex.write_layer("device", blocks, kk[l], vv[l])
        tab[:, r, :] = blocks
    out2 = ex.decode([1, 2], tab[:, :2], [5, 5])
    out3 = ex.decode([1, 2, 3], tab, [5, 5, 5])
    assert len(out2) == 2 and len(out3) == 3
    assert ex.jit_retraces["decode"] == 2     # R buckets 2 and 4
    # the pad row of the R=3 call wrote only the trash block
    assert ex.decode([1, 2, 3], tab, [5, 5, 5]) == out3
    assert ex.jit_retraces["decode"] == 2
    ex.decode([1], np.zeros((L, 1, 9), np.int32), [5])  # MAXB 9 -> 16
    assert ("decode", (1, 16)) in ex._jit_sigs


def test_gather_layer_kv_valid_slices_to_live_blocks():
    ex = _ex()
    BS = ex.block_size
    _, k, v = ex.prefill(list(range(1, 21)), 24)
    ex.write_layer("device", [3, 6, 9], k[0], v[0])
    full_k, full_v = ex.gather_layer("device", [3, 6, 9])
    assert torch.equal(full_k[:20], k[0][:20])
    part_k, part_v = ex.gather_layer("device", [3, 6, 9], kv_valid=10)
    live = -(-10 // BS) * BS
    assert torch.equal(part_k[:live], full_k[:live])
    assert (part_k[live:] == 0).all() and (part_v[live:] == 0).all()
    zk, _ = ex.gather_layer("device", [3, 6, 9], kv_valid=0)
    assert zk.shape == full_k.shape and (zk == 0).all()


def test_copy_blocks_between_and_within_tiers():
    ex = _ex(ndb=16, nhb=32)
    ex.device_pool.copy_(torch.randn(ex.device_pool.shape))
    orig = ex.device_pool.clone()
    ex.copy_blocks("device", "host", [3, 4, 7], [10, 11, 20])   # d2h, 2 runs
    assert torch.equal(ex.host_pool[[10, 11, 20]], orig[[3, 4, 7]])
    ex.copy_blocks("host", "host", [10, 20], [0, 1])            # host COW
    assert torch.equal(ex.host_pool[[0, 1]], orig[[3, 7]])
    ex.copy_blocks("host", "device", [20, 11], [0, 1])          # h2d
    assert torch.equal(ex.device_pool[[0, 1]], orig[[7, 4]])
    ex.copy_blocks("device", "device", [0, 5], [5, 0])          # swap COW
    assert torch.equal(ex.device_pool[5], orig[7])
    assert torch.equal(ex.device_pool[0], orig[5])


@pytest.mark.parametrize("tier", ["device", "host"])
def test_write_layer_slice_and_whole_blocks_agree(tier):
    """Appending a layer's KV chunk by chunk at token offsets lands the
    same bytes as one whole-block write, on either tier."""
    ex = _ex()
    _, k, v = ex.prefill(list(range(1, 24)), 24)
    ids = [5, 6, 2]
    ex.write_layer(tier, ids, k[1], v[1])
    whole = ex.gather_layer(tier, ids)
    pool = ex.device_pool if tier == "device" else ex.host_pool
    pool.zero_()
    for a, b in ((0, 5), (5, 13), (13, 24)):
        ex.write_layer_slice(tier, ids, a, k[1][a:b], v[1][a:b])
    again = ex.gather_layer(tier, ids)
    assert torch.equal(whole[0], again[0]) and torch.equal(whole[1], again[1])
