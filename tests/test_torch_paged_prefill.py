"""Port parity, paged chunk-prefill attention: the port's plain
`paged_prefill` (what the CUDA wrapper runs for CPU tensors) against the
JAX oracle `repro.kernels.ref.paged_prefill_reference` and the Pallas
kernel `paged_prefill_pallas` in interpret mode, on the cases of
tests/test_fused.py: chunk edges, a chunk + decode tokens + a kv_len = 0
dummy in one call, and the two-pool (host tier) variant with host ids
above the device pool's size. Inputs are made with numpy from a seed and
handed to both sides; f32 atol = rtol = 2e-5, the repo's Pallas-vs-ref
tolerance.

The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_prefill import paged_prefill_pallas
from repro_torch.kernels import ops, paged_prefill
from repro_torch.kernels import ref as tref
from paged_chunk_layouts import CHUNKINGS, chunk_layout

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
TQ = 8


def _pool(nb, bs, kv, d, seed=0):
    return np.random.RandomState(seed).randn(nb, bs, 2, kv, d) \
        .astype(np.float32)


def _segments(specs, h, d, maxb, nb, tq=TQ, seed=1):
    """A flat tq-padded batch from (q_offset, n_q_tokens) specs: (q, tab,
    seg_ids, q_pos, kv_len) as numpy arrays."""
    rng = np.random.RandomState(seed)
    pads = [-(-max(n, 1) // tq) * tq for _, n in specs]
    T = sum(pads)
    seg_ids = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    kv_len = np.zeros(len(specs), np.int32)
    t = 0
    for i, ((off, n), pad) in enumerate(zip(specs, pads)):
        seg_ids[t:t + pad] = i
        q_pos[t:t + pad] = off + np.arange(pad)
        kv_len[i] = off + n
        t += pad
    tab = rng.permutation(nb)[:len(specs) * maxb].reshape(len(specs), maxb)
    q = rng.randn(T, h, d).astype(np.float32)
    return q, tab.astype(np.int32), seg_ids, q_pos, kv_len


def _both(q, pool, tab, seg, pos, klen, hpool=None, tier=None, tq=TQ):
    """(port plain, JAX oracle, Pallas interpret) outputs as numpy."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, pool, tab, seg, pos, klen)]
    th = None if hpool is None else torch.from_numpy(hpool)
    tt = None if tier is None else torch.from_numpy(tier)
    got = paged_prefill.paged_prefill(*t, host_pool=th, tier=tt, tq=tq)
    j = [jnp.asarray(a) for a in (q, pool, tab, seg, pos, klen)]
    jh = None if hpool is None else jnp.asarray(hpool)
    jt = None if tier is None else jnp.asarray(tier)
    want = jref.paged_prefill_reference(*j, host_pool=jh, tier=jt, tq=tq)
    pallas = paged_prefill_pallas(*j, host_pool=jh, tier=jt, tq=tq)
    return got.numpy(), np.asarray(want), np.asarray(pallas)


@pytest.mark.parametrize("spec", [
    (13, 11),   # chunk straddling a block boundary (BS=8)
    (0, 16),    # first chunk of a fresh prompt, block-aligned
    (23, 1),    # single-token final chunk
    (5, 3),     # mid-block start AND end
])
def test_paged_prefill_plain_matches_jax_edges(spec):
    H, KV, D, BS, NB, MAXB = 6, 2, 64, 8, 32, 4
    pool = _pool(NB, BS, KV, D)
    q, tab, seg, pos, klen = _segments([spec], H, D, MAXB, NB)
    got, want, pallas = _both(q, pool, tab, seg, pos, klen)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_paged_prefill_plain_multi_segment_chunk_decode_dummy():
    """One call serving a chunk, two decode tokens and a kv_len = 0 dummy
    — the fused step's steady-state layout. Live rows are compared; every
    row must be finite."""
    H, KV, D, BS, NB, MAXB = 8, 2, 32, 8, 48, 5
    pool = _pool(NB, BS, KV, D)
    specs = [(9, 12), (30, 1), (17, 1), (0, 0)]
    q, tab, seg, pos, klen = _segments(specs, H, D, MAXB, NB)
    got, want, pallas = _both(q, pool, tab, seg, pos, klen)
    live = klen[seg] > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    np.testing.assert_allclose(got[live], pallas[live], **TOL)
    assert np.all(np.isfinite(got))


def test_paged_prefill_plain_host_tier_variant():
    """Two pools: a host-resident segment reads the HOST pool with ids
    valid only there (above the device pool's size)."""
    H, KV, D, BS, MAXB = 4, 1, 32, 8, 3
    dpool = _pool(8, BS, KV, D, seed=3)
    hpool = _pool(64, BS, KV, D, seed=4)
    q, _, seg, pos, klen = _segments([(4, 9), (11, 5)], H, D, MAXB, 8)
    tab = np.asarray([[60, 33, 51], [2, 5, 1]], np.int32)
    tier = np.asarray([True, False])
    got, want, pallas = _both(q, dpool, tab, seg, pos, klen, hpool, tier)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_paged_prefill_plain_at_mixed_tq_with_tail_tiles():
    """The executor's layout at tq = MIXED_TQ = 32: a GQA chunk at an
    offset, a decode token, and a tail tile mapped to a kv_len = 0 dummy
    slot (live rows compared)."""
    H, KV, D, BS, NB, MAXB = 8, 2, 64, 16, 40, 6
    pool = _pool(NB, BS, KV, D, seed=5)
    q, tab, seg, pos, klen = _segments([(37, 40), (70, 1), (0, 0)], H, D,
                                       MAXB, NB, tq=32, seed=6)
    got, want, _ = _both(q, pool, tab, seg, pos, klen, tq=32)
    live = klen[seg] > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.all(np.isfinite(got))


def test_ops_paged_prefill_runs_the_plain_version_on_cpu():
    H, KV, D, BS, NB, MAXB = 4, 2, 64, 8, 16, 2
    pool = _pool(NB, BS, KV, D)
    q, tab, seg, pos, klen = _segments([(3, 5)], H, D, MAXB, NB)
    t = [torch.from_numpy(a) for a in (q, pool, tab, seg, pos, klen)]
    before = (paged_prefill.launches, paged_prefill.launches_tiered)
    a = ops.paged_prefill(*t)
    b = tref.paged_prefill_reference(*t)
    assert torch.equal(a, b)
    # CPU calls are not kernel launches
    assert (paged_prefill.launches, paged_prefill.launches_tiered) == before


# Two-pool cases for the staging's plain version: (specs, tiers,
# (H, KV, D, BS, MAXB), device and host pool sizes, table or None for
# host ids drawn above the device pool's size)
STAGE_CASES = {
    # tests/test_fused.py::test_paged_prefill_host_tier_variant
    "test_fused host tier": ([(4, 9), (11, 5)], [True, False],
                             (4, 1, 32, 8, 3), 8, 64,
                             [[60, 33, 51], [2, 5, 1]]),
    "mixed tiers": ([(9, 12), (30, 1), (17, 1), (40, 20)],
                    [True, False, True, False], (8, 2, 64, 8, 8), 16, 64,
                    None),
    "host segment at kv_len 0": ([(5, 7), (0, 0), (20, 3)],
                                 [False, True, True], (4, 2, 32, 8, 4), 12,
                                 40, None),
    "ids past both pools (clamped)": ([(3, 10), (6, 4)], [True, False],
                                      (4, 1, 32, 8, 3), 8, 64,
                                      [[70, 99, 63], [9, 12, 1]]),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_staged_host_blocks_one_pool_match_jax_two_pools(case):
    """The staging's plain version copies each live host block
    (tier set, j < ceil(kv_len / BS)) to slot s * MAXB + j and nothing
    else; the one-pool plain version over [device pool | staged buffer]
    (host segments pointed at their slots, device ids clamped into the
    device pool) equals the JAX two-pool reference on live rows."""
    specs, tiers, (H, KV, D, BS, MAXB), nbd, nbh, tab = STAGE_CASES[case]
    dpool = _pool(nbd, BS, KV, D, seed=3)
    hpool = _pool(nbh, BS, KV, D, seed=4)
    q, _, seg, pos, klen = _segments(specs, H, D, MAXB,
                                     len(specs) * MAXB)
    tier = np.asarray(tiers)
    if tab is None:
        r = np.random.RandomState(5)
        tab = np.where(tier[:, None], r.randint(nbd, nbh, (len(specs), MAXB)),
                       r.randint(0, nbd, (len(specs), MAXB)))
    tab = np.asarray(tab, np.int32)
    t_tab, t_klen, t_tier = (torch.from_numpy(a) for a in (tab, klen, tier))
    staged = paged_prefill.stage_host_blocks_plain(
        torch.from_numpy(hpool), t_tab, t_klen, t_tier).numpy()
    nblk = -(-np.minimum(klen, MAXB * BS) // BS)
    live = tier[:, None] & (np.arange(MAXB)[None] < nblk[:, None])
    assert np.array_equal(paged_prefill.live_host_slots(
        t_tab, t_klen, t_tier, BS).numpy(), live)
    want_staged = np.zeros_like(staged)
    for s, j in zip(*np.nonzero(live)):
        want_staged[s * MAXB + j] = hpool[min(tab[s, j], nbh - 1)]
    np.testing.assert_array_equal(staged, want_staged)

    pool = np.concatenate([dpool, staged])
    slots = nbd + np.arange(len(specs) * MAXB).reshape(len(specs), MAXB)
    tab1 = np.where(tier[:, None], slots, np.minimum(tab, nbd - 1))
    got = paged_prefill.paged_prefill_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, pool, tab1.astype(np.int32), seg, pos, klen)], tq=TQ).numpy()
    want = np.asarray(jref.paged_prefill_reference(
        *[jnp.asarray(a) for a in (q, dpool, tab, seg, pos, klen)],
        host_pool=jnp.asarray(hpool), tier=jnp.asarray(tier), tq=TQ))
    rows = klen[seg] > 0
    np.testing.assert_allclose(got[rows], want[rows], **TOL)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("cut", ["two chunks", "three chunks"])
@pytest.mark.parametrize("H,KV,D", [(4, 1, 64), (8, 2, 32)])
def test_paged_prefill_plain_rows_invariant_to_chunking(cut, H, KV, D):
    """A row's output depends only on its q, its segment's keys and its
    position: the prompt's rows computed as one chunk and as chunks split
    mid-block, with other segments beside them (`paged_chunk_layouts`,
    the card test's case), agree with each other
    and with the JAX reference and the Pallas kernel on every layout (tq
    32, BS 16)."""
    pool = _pool(64, 16, KV, D, seed=21)
    outs = {}
    for name in ("one chunk", cut):
        q, tab, seg, pos, klen, rows = chunk_layout(CHUNKINGS[name], H, D)
        assert np.array_equal(pos[rows], np.arange(100))
        got, want, pallas = _both(q, pool, tab, seg, pos, klen, tq=32)
        np.testing.assert_allclose(got[rows], want[rows], **TOL)
        np.testing.assert_allclose(got[rows], pallas[rows], **TOL)
        outs[name] = got[rows]
    np.testing.assert_allclose(outs[cut], outs["one chunk"], **TOL)


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_host_block_runs_stage_the_live_host_slots(case):
    """`host_block_runs` lists every live host slot once (runs consecutive
    in the host pool and in the staging slots, ids clamped as the plain
    staging clamps them); copying the runs (`stage_host_runs`, its plain
    version on the CPU) gives `stage_host_blocks_plain`'s blocks on the
    live slots and leaves every other slot as it was."""
    specs, tiers, (H, KV, D, BS, MAXB), nbd, nbh, tab = STAGE_CASES[case]
    hpool = torch.from_numpy(_pool(nbh, BS, KV, D, seed=4))
    klen = np.asarray([off + n for off, n in specs], np.int32)
    tier = np.asarray(tiers)
    if tab is None:
        r = np.random.RandomState(5)
        tab = np.where(tier[:, None], r.randint(nbd, nbh, (len(specs), MAXB)),
                       r.randint(0, nbd, (len(specs), MAXB)))
    tab = np.asarray(tab, np.int32)
    runs = paged_prefill.host_block_runs(tab, klen, tier, BS, nbh)
    assert runs.dtype == np.int64 and runs.shape[1] == 3
    assert (runs[:, 2] >= 1).all()
    slots = np.concatenate([np.arange(d, d + n) for _, d, n in runs]
                           or [np.zeros(0, np.int64)])
    live = paged_prefill.live_host_slots(
        *(torch.from_numpy(a) for a in (tab, klen, tier)), BS).reshape(-1)
    assert np.array_equal(slots, np.flatnonzero(live.numpy()))
    out = torch.full((len(specs) * MAXB, *hpool.shape[1:]), float("nan"))
    before = paged_prefill.launches_stage
    got = paged_prefill.stage_host_runs(hpool, runs, out)
    assert paged_prefill.launches_stage == before   # CPU: no launch
    want = paged_prefill.stage_host_blocks_plain(
        hpool, *(torch.from_numpy(a) for a in (tab, klen, tier)))
    assert torch.equal(got[live], want[live])
    assert got[~live].isnan().all()


# (chunk spec, other segments, tiers): the chunk is host-resident and its
# first row lands mid-block, in a block an earlier chunk half filled
PREFETCH_CASES = {
    "chunk mid-block": ([(13, 11), (30, 1), (6, 9)], [True, False, True]),
    "chunk ends mid-block": ([(5, 3), (21, 1)], [True, False]),
    "chunk on a block edge": ([(16, 8), (0, 0), (9, 4)], [True, False, True]),
}


@pytest.mark.parametrize("case", list(PREFETCH_CASES))
def test_prefetched_staging_with_chunk_rows_matches_two_pools(case):
    """The fused step's prefetch: the host blocks are staged BEFORE the
    chunk's own K/V reach the host pool (the staged copy of each block
    the chunk fills holds stale rows there), then the chunk's rows are
    scattered into their staged slots (s * MAXB + pos // BS, pos % BS).
    The body over that buffer (`staged=`) gives the plain two-pool output
    over the host pool that holds the chunk's rows, and the JAX two-pool
    reference's, at f32 atol = rtol = 2e-5 on live rows; without the
    scatter it does not."""
    specs, tiers = PREFETCH_CASES[case]
    H, KV, D, BS, MAXB, nbd, nbh = 4, 2, 32, 8, 5, 12, 48
    dpool = _pool(nbd, BS, KV, D, seed=3)
    stale = _pool(nbh, BS, KV, D, seed=4)
    q, _, seg, pos, klen = _segments(specs, H, D, MAXB, len(specs) * MAXB,
                                     seed=6)
    tier = np.asarray(tiers)
    r = np.random.RandomState(7)
    tab = np.where(tier[:, None],
                   r.permutation(nbh)[:len(specs) * MAXB]
                   .reshape(len(specs), MAXB),
                   r.randint(0, nbd, (len(specs), MAXB))).astype(np.int32)
    off, n = specs[0]
    chunk_pos = off + np.arange(n)
    kv_new = r.randn(n, 2, KV, D).astype(np.float32)
    fresh = stale.copy()                 # the host pool after the writes
    fresh[tab[0, chunk_pos // BS], chunk_pos % BS] = kv_new

    runs = paged_prefill.host_block_runs(tab, klen, tier, BS, nbh)
    S = len(specs)
    staged = torch.zeros((S * MAXB + 1, BS, 2, KV, D))
    paged_prefill.stage_host_runs(torch.from_numpy(stale), runs, staged)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, dpool, tab, seg, pos, klen)]
    t_tier = torch.from_numpy(tier)
    missing = paged_prefill.paged_prefill(*t, staged=staged.clone(),
                                          tier=t_tier, tq=TQ).numpy()
    rows = torch.from_numpy(chunk_pos // BS * BS + chunk_pos % BS)
    staged.view(-1, 2, KV, D).index_copy_(0, rows, torch.from_numpy(kv_new))
    got = paged_prefill.paged_prefill(*t, staged=staged, tier=t_tier,
                                      tq=TQ).numpy()
    plain = paged_prefill.paged_prefill_plain(
        *t, host_pool=torch.from_numpy(fresh), tier=t_tier, tq=TQ).numpy()
    want = np.asarray(jref.paged_prefill_reference(
        *[jnp.asarray(a) for a in (q, dpool, tab, seg, pos, klen)],
        host_pool=jnp.asarray(fresh), tier=jnp.asarray(tier), tq=TQ))
    live = klen[seg] > 0
    np.testing.assert_allclose(got[live], plain[live], **TOL)
    np.testing.assert_allclose(got[live], want[live], **TOL)
    chunk_rows = seg == 0
    assert not np.allclose(missing[chunk_rows], want[chunk_rows], **TOL)
