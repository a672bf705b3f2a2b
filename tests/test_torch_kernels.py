"""Port parity, kernels: the port's plain attention functions
(`repro_torch.kernels.ref`, what the CUDA wrappers run for CPU tensors)
against the JAX oracles (`repro.kernels.ref`) and, where the Pallas
kernels take the inputs, against the Pallas kernels in interpret mode —
the same inputs, made with numpy from a seed, on both sides. f32
tolerance atol = rtol = 2e-5, the repo's Pallas-vs-ref tolerance
(tests/test_kernels.py).

The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_prefill import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import flash_prefill, ops, paged_attention
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B, Sq, Skv, H, KV, D, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, H, D).astype(np.float32),
            r.randn(B, Skv, KV, D).astype(np.float32),
            r.randn(B, Skv, KV, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(torch_out, jax_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


# ---------------------------------------------------------------- flash ----

@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2), (4, 1), (28, 4)])
@pytest.mark.parametrize("S", [128, 384])
def test_flash_reference_matches_jax_and_pallas(H, KV, S):
    qkv = _qkv(2, S, S, H, KV, 64)
    tq, tk, tv = _t(*qkv)
    out = tref.flash_attention_reference(tq, tk, tv, causal=True,
                                         q_chunk=128, kv_chunk=128)
    _close(out, jref.flash_attention_reference(*_j(*qkv), causal=True,
                                               q_chunk=128, kv_chunk=128))
    if S == 128:   # interpret-mode Pallas is slow: one size is witness enough
        _close(out, flash_attention_pallas(*_j(*qkv), causal=True,
                                           block_q=64, block_k=64))


def test_mha_reference_matches_jax():
    qkv = _qkv(2, 96, 96, 8, 2, 32, seed=1)
    out = tref.mha_reference(*_t(*qkv), causal=True)
    _close(out, jref.mha_reference(*_j(*qkv), causal=True))


@pytest.mark.parametrize("window", [1, 17, 64, 1000])
def test_flash_sliding_window(window):
    qkv = _qkv(2, 256, 256, 4, 4, 64, seed=2)
    out = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                         window=window, q_chunk=64,
                                         kv_chunk=64)
    _close(out, jref.flash_attention_reference(
        *_j(*qkv), causal=True, window=window, q_chunk=64, kv_chunk=64))
    if window == 17:
        _close(out, flash_attention_pallas(*_j(*qkv), causal=True,
                                           window=window, block_q=64,
                                           block_k=64))


def test_flash_kv_len_ragged_prompt():
    """The engine's prefill call: bucket-padded prompts, kv_len = the
    prompt lengths, chunk sizes that do not divide the sequence."""
    qkv = _qkv(3, 80, 80, 8, 2, 64, seed=3)
    kv_len = np.array([3, 47, 80], np.int32)
    out = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                         kv_len=torch.from_numpy(kv_len),
                                         q_chunk=32, kv_chunk=48)
    _close(out, jref.flash_attention_reference(
        *_j(*qkv), causal=True, kv_len=jnp.asarray(kv_len), q_chunk=32,
        kv_chunk=48))


@pytest.mark.parametrize("per_row", [False, True])
def test_flash_runtime_q_offset_with_kv_len(per_row):
    """The two-call chunk path: a chunk of queries at a runtime offset
    into a longer prefix buffer, tail masked by kv_len."""
    B, C, Skv = 2, 24, 128
    qkv = _qkv(B, C, Skv, 8, 4, 64, seed=4)
    if per_row:
        q_off = np.array([40, 96], np.int32)
        t_off, j_off = torch.from_numpy(q_off), jnp.asarray(q_off)
    else:
        q_off = np.array([40, 40], np.int32)
        t_off = j_off = 40
    kv_len = q_off + C
    out = tref.flash_attention_reference(
        *_t(*qkv), causal=True, kv_len=torch.from_numpy(kv_len),
        q_offset=t_off)
    _close(out, jref.flash_attention_reference(
        *_j(*qkv), causal=True, kv_len=jnp.asarray(kv_len), q_offset=j_off))


def test_flash_static_q_offset_matches_pallas():
    """Chunk-style q_offset > 0 on a shape the Pallas kernel takes."""
    qkv = _qkv(1, 64, 192, 4, 2, 64, seed=5)
    out = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                         q_offset=128)
    _close(out, flash_attention_pallas(*_j(*qkv), causal=True,
                                       q_offset=128, block_q=64,
                                       block_k=64))


def test_ops_flash_runs_plain_version_on_cpu():
    qkv = _qkv(1, 40, 40, 4, 2, 64, seed=6)
    before = flash_prefill.launches
    kv_len = torch.tensor([33])
    a = ops.flash_attention(*_t(*qkv), causal=True, kv_len=kv_len)
    b = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                       kv_len=kv_len)
    assert torch.equal(a, b)
    assert flash_prefill.launches == before  # CPU calls are not launches


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 16, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention.paged_attention(
            torch.zeros(1, 4, 64, device="meta"),
            torch.zeros(2, 8, 2, 4, 64, device="meta"),
            torch.zeros(1, 1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))


def test_decode_attention_reference_matches_jax():
    r = np.random.RandomState(7)
    q = r.randn(3, 1, 8, 32).astype(np.float32)
    k = r.randn(3, 40, 2, 32).astype(np.float32)
    v = r.randn(3, 40, 2, 32).astype(np.float32)
    kv_len = np.array([1, 20, 40], np.int32)
    out = tref.decode_attention_reference(*_t(q, k, v, kv_len))
    _close(out, jref.decode_attention_reference(*_j(q, k, v, kv_len)))


# ---------------------------------------------------------------- paged ----

def _paged_inputs(B, H, KV, D, NB, BS, MAXB, kv_len, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, H, D).astype(np.float32)
    pool = r.randn(NB, BS, 2, KV, D).astype(np.float32)
    tab = r.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    return q, pool, tab, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2), (16, 1), (12, 4)])
@pytest.mark.parametrize("BS", [8, 16])
def test_paged_reference_matches_jax_and_pallas(H, KV, BS):
    B, D, NB, MAXB = 3, 64, 64, 6
    args = _paged_inputs(B, H, KV, D, NB, BS, MAXB,
                         [1, BS * 2 + 3, BS * MAXB])
    out = tref.paged_attention_reference(*_t(*args))
    _close(out, jref.paged_attention_reference(*_j(*args)))
    _close(out, paged_attention_pallas(*_j(*args)))


def test_paged_pad_rows_finite():
    """The executor's pow2 pad rows: kv_len = 0 over the trash block."""
    B, H, KV, D, NB, BS, MAXB = 4, 8, 2, 64, 33, 16, 8
    q, pool, _, _ = _paged_inputs(B, H, KV, D, NB, BS, MAXB, [0] * B)
    tab = np.full((B, MAXB), NB - 1, np.int32)     # all rows -> trash
    tab[0, :2] = [0, 1]
    kv_len = np.array([20, 0, 0, 0], np.int32)
    out = ops.paged_attention(*_t(q, pool, tab, kv_len))
    assert torch.isfinite(out).all()
    _close(out[:1], jref.paged_attention_reference(
        *_j(q, pool, tab, kv_len))[:1])


# ------------------------------------------ flash: the kernels' tile edges --

# G = H / KV in {1, 4, 8} at D = 64 and 128, the head layouts the card
# checks (chip_smoke.py, tests/test_torch_cuda.py) at small widths
GQA = [(8, 8, 64), (8, 2, 64), (8, 1, 64), (8, 8, 128), (8, 2, 128),
       (8, 1, 128)]
# (B, Sq, Skv, kv_len, q_offset, window): Sq and Skv off the kernels'
# tile grids, kv_len below one tile, per-row q_offset with kv_len across
# a tile boundary, a sliding window
EDGES = {
    "ragged Sq Skv": (1, 100, 137, None, 37, 0),
    "kv_len below one tile": (2, 40, 64, [5, 30], 0, 0),
    "per-row q_offset across a tile": (2, 24, 160, [70, 130], [40, 100],
                                       0),
    "window": (1, 100, 137, None, 37, 50),
}


@pytest.mark.parametrize("H,KV,D", GQA)
@pytest.mark.parametrize("case", list(EDGES))
def test_flash_reference_tile_edges_match_jax(H, KV, D, case):
    """The plain version the card holds the kernels against, with its
    chunks at the forward kernel's 128-row tiles (padding the ragged
    edges), against the JAX oracle in one chunk."""
    B, Sq, Skv, kv_len, q_off, window = EDGES[case]
    qkv = _qkv(B, Sq, Skv, H, KV, D, seed=8)
    kw_t, kw_j = dict(window=window), dict(window=window)
    if kv_len is not None:
        kw_t["kv_len"] = torch.tensor(kv_len)
        kw_j["kv_len"] = jnp.asarray(kv_len, jnp.int32)
    if isinstance(q_off, list):
        kw_t["q_offset"] = torch.tensor(q_off)
        kw_j["q_offset"] = jnp.asarray(q_off, jnp.int32)
    else:
        kw_t["q_offset"] = kw_j["q_offset"] = q_off
    out = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                         q_chunk=128, kv_chunk=128, **kw_t)
    _close(out, jref.flash_attention_reference(
        *_j(*qkv), causal=True, q_chunk=Sq, kv_chunk=Skv, **kw_j))


@pytest.mark.parametrize("H,KV,D", GQA)
@pytest.mark.parametrize("window", [0, 50])
def test_flash_reference_gqa_matches_pallas(H, KV, D, window):
    """The same head layouts through the Pallas kernel (interpret mode),
    which takes whole 64-row blocks and no kv_len."""
    qkv = _qkv(1, 128, 128, H, KV, D, seed=9)
    out = tref.flash_attention_reference(*_t(*qkv), causal=True,
                                         window=window)
    _close(out, flash_attention_pallas(*_j(*qkv), causal=True,
                                       window=window, block_q=64,
                                       block_k=64))


@pytest.mark.parametrize("H,KV,D", GQA)
@pytest.mark.parametrize("case", ["ragged Sq Skv", "window"])
def test_flash_reference_grad_tile_edges_match_jax(H, KV, D, case):
    """What the backward kernels are held against on the card -- autograd
    through the plain version -- against jax.vjp of the JAX oracle, at
    the backward's edge shapes (a chunk at q_offset 37 off the 64-row
    grid, with and without a window; every key valid)."""
    B, Sq, Skv, _, q_off, window = EDGES[case]
    q, k, v = _qkv(B, Sq, Skv, H, KV, D, seed=10)
    do = np.random.RandomState(11).randn(*q.shape).astype(np.float32)

    def jf(q, k, v):
        return jref.flash_attention_reference(
            q, k, v, causal=True, window=window, q_offset=q_off,
            q_chunk=Sq, kv_chunk=Skv)
    _, vjp = jax.vjp(jf, *_j(q, k, v))
    want = vjp(jnp.asarray(do))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    tref.flash_attention_reference(
        *leaves, causal=True, window=window, q_offset=q_off, q_chunk=64,
        kv_chunk=64).backward(torch.from_numpy(do))
    for t, w in zip(leaves, want):
        _close(t.grad, w)
