"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without an NVIDIA GPU
(the kernels have no CPU mode; their plain versions are held against the
JAX reference in tests/test_torch_kernels.py). This file imports no JAX,
so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol = rtol = 2e-5 (the repo's Pallas-vs-reference
tolerance); bf16 2e-2 (the plain paged version rounds its logits and
probabilities to bf16 where the kernel keeps f32). Gradients (RMSNorm
and flash backward against autograd through the plain versions) are
sums over rows or keys taken in another order, so their atol is the
same tolerance times the largest |gradient|; in bf16 autograd through
the plain RMSNorm also rounds dy * w to bf16 where the kernel keeps f32.
"""
import numpy as np
import pytest
import torch

from paged_chunk_layouts import CHUNKINGS, chunk_layout
from repro_torch.kernels import flash_prefill, paged_attention, \
    paged_prefill, rmsnorm

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
# llama2-7b, granite-3-2b, and the granite-3-2b and deepseek-moe-16b
# smoke configs (D = 32: bf16 on the CUDA-core kernels)
SHAPES = [(32, 32, 128), (32, 8, 64), (8, 2, 32), (4, 4, 32)]
# the paged prefill's largest group: 16 query heads per KV head, 512
# (query, head) rows per 32-token tile, several blocks per tile
G16 = (32, 2, 128)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _randn(shape, dtype, seed):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(
        "cuda", dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_flash_kernel_matches_plain(dtype, tol, H, KV, D):
    _need_cuda()
    B, Sq, Skv = 2, 200, 256
    q = _randn((B, Sq, H, D), dtype, 0)
    k = _randn((B, Skv, KV, D), dtype, 1)
    v = _randn((B, Skv, KV, D), dtype, 2)
    kv_len = torch.tensor([131, 256], dtype=torch.int32, device="cuda")
    before = flash_prefill.launches
    for q_off in (0, 56, torch.tensor([56, 0], device="cuda")):
        got = flash_prefill.flash_attention(q, k, v, kv_len=kv_len,
                                            q_offset=q_off)
        want = flash_prefill.flash_attention_plain(q, k, v, kv_len=kv_len,
                                                   q_offset=q_off)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert flash_prefill.launches == before + 3


@pytest.mark.parametrize("window", [17, 64])
def test_flash_kernel_window(window):
    _need_cuda()
    q, k, v = (_randn((1, 256, 8, 64), torch.float32, s) for s in range(3))
    got = flash_prefill.flash_attention(q, k, v, window=window)
    want = flash_prefill.flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# G = H / KV in {1, 4, 8} at D = 64 and 128, and the smoke configs' D = 32
GQA_SHAPES = [(8, 8, 64), (8, 2, 64), (8, 1, 64), (8, 8, 128), (8, 2, 128),
              (8, 1, 128), (8, 2, 32), (4, 4, 32)]
# the forward's tile edges (128 query rows x 128 keys): (B, Sq, Skv,
# kv_len, q_offset, window)
FWD_EDGES = {
    "ragged Sq Skv": (1, 1000, 1037, [1037], 37, 0),
    "kv_len below one tile": (2, 200, 256, [5, 100], 0, 0),
    "per-row q_offset across a tile": (2, 96, 512, [200, 300], [104, 250],
                                       0),
    "window": (1, 1000, 1037, [1037], 37, 200),
}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", GQA_SHAPES)
@pytest.mark.parametrize("case", list(FWD_EDGES))
def test_flash_kernel_tile_edges(dtype, tol, H, KV, D, case):
    _need_cuda()
    B, Sq, Skv, kv_len, q_off, window = FWD_EDGES[case]
    q = _randn((B, Sq, H, D), dtype, 30)
    k = _randn((B, Skv, KV, D), dtype, 31)
    v = _randn((B, Skv, KV, D), dtype, 32)
    kw = dict(kv_len=torch.tensor(kv_len, dtype=torch.int32, device="cuda"),
              q_offset=q_off if isinstance(q_off, int) else torch.tensor(
                  q_off, dtype=torch.int32, device="cuda"), window=window)
    got = flash_prefill.flash_attention(q, k, v, **kw)
    want = flash_prefill.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_paged_kernel_matches_plain(dtype, tol, H, KV, D):
    _need_cuda()
    B, NB, BS, MAXB = 4, 64, 16, 8
    r = np.random.RandomState(3)
    q = _randn((B, H, D), dtype, 4)
    pool = _randn((NB, BS, 2, KV, D), dtype, 5)
    tab = torch.from_numpy(r.permutation(NB)[:B * MAXB].reshape(B, MAXB)
                           .astype(np.int32)).cuda()
    kv_len = torch.tensor([1, 17, 128, 0], dtype=torch.int32, device="cuda")
    got = paged_attention.paged_attention(q, pool, tab, kv_len)
    want = paged_attention.paged_attention_plain(q, pool, tab, kv_len)
    torch.testing.assert_close(got[:3].float(), want[:3].float(), atol=tol,
                               rtol=tol)
    assert torch.isfinite(got).all() and (got[3] == 0).all()


def _decode_case(dtype, H, KV, D, lens, seed, BS=16):
    """Rows at `lens` (kv_len 0 rows are pad rows on a trash block),
    tables from a permutation of the pool, MAXB a multiple of 8."""
    r = np.random.RandomState(seed)
    maxb = max(-(-max(lens) // BS), 1)
    MAXB = -(-maxb // 8) * 8
    B = len(lens)
    nb = B * MAXB + 1
    pool = _randn((nb, BS, 2, KV, D), dtype, seed + 1)
    tab = r.permutation(nb - 1)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tab[np.asarray(lens) == 0] = nb - 1
    q = _randn((B, H, D), dtype, seed + 2)
    return (q, pool, torch.from_numpy(tab).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


S_ = paged_attention.SPLIT
# kv_len at the split's edges, and batches of 1, 8 and 32 with pad rows
DECODE_LENS = {
    "split edges": [1, S_ - 1, S_, S_ + 1, 2 * S_ - 1, 2 * S_, 2 * S_ + 1,
                    4096, 0],
    "B=1": [4096],
    "B=8 with pad rows": [281, 1040, 700, 513, 0, 0, 0, 0],
    "B=32 with pad rows": [int(x) for x in
                           np.random.RandomState(9).randint(1, 2000, 20)]
    + [0] * 12,
}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES)
@pytest.mark.parametrize("case", list(DECODE_LENS))
def test_paged_kernel_split_matches_plain(dtype, tol, H, KV, D, case):
    """The split kernel (its last split block per row merging the row's
    splits) against the plain version and the plain split algorithm; pad
    rows give 0; one launch per call, whatever the table spans."""
    _need_cuda()
    lens = DECODE_LENS[case]
    q, pool, tab, kv_len = _decode_case(dtype, H, KV, D, lens, 20)
    before = paged_attention.launches
    got = paged_attention.paged_attention(q, pool, tab, kv_len)
    want = paged_attention.paged_attention_plain(q, pool, tab, kv_len)
    split = paged_attention.paged_attention_split_plain(q, pool, tab,
                                                        kv_len)
    torch.cuda.synchronize()
    live = kv_len > 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), split.float(), atol=tol,
                               rtol=tol)
    assert torch.isfinite(got).all() and (got[~live] == 0).all()
    assert paged_attention.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_paged_kernel_is_batch_invariant(dtype, H, KV, D):
    """A row has the same bits alone as inside a batch of 8 (split
    boundaries depend on the position only)."""
    _need_cuda()
    lens = [1040, 281, 700, 4096, 513, 256, 0, 17]
    q, pool, tab, kv_len = _decode_case(dtype, H, KV, D, lens, 21)
    full = paged_attention.paged_attention(q, pool, tab, kv_len)
    for i in range(len(lens)):
        alone = paged_attention.paged_attention(
            q[i:i + 1].contiguous(), pool, tab[i:i + 1].contiguous(),
            kv_len[i:i + 1].contiguous())
        assert torch.equal(alone[0], full[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_combine_matches_plain(dtype):
    """The merge of a row's splits, now done inside the split kernel by
    the row's last split block, against its plain version
    (`combine_plain`) on the partials the same launch left; the wrapper
    returns the same bits."""
    _need_cuda()
    lens = DECODE_LENS["B=8 with pad rows"]
    q, pool, tab, kv_len = _decode_case(dtype, 32, 32, 128, lens, 22)
    got, part_o, part_ml = paged_attention.split_pass(
        q, pool, tab, kv_len, 128 ** -0.5)
    ctx = tab.shape[1] * 16
    rows = paged_attention.n_splits(kv_len, ctx) > 1
    assert rows.any()
    want = paged_attention.combine_plain(
        part_o, part_ml, paged_attention.n_splits(kv_len, ctx)).to(dtype)
    again = paged_attention.paged_attention(q, pool, tab, kv_len)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["B=1 ctx 4096", "serve batch"])
def test_paged_decode_folded_merge_is_batch_invariant(dtype, case):
    """With the merge folded into the split kernel (tickets drawn in any
    order, splits merged in split order) a row has the same bits in
    repeated calls, alone, and in a batch: at B 1 ctx 4096 and at the
    serve batch (8 llama2-7b rows of 281-1040 tokens)."""
    _need_cuda()
    lens = ([4096, 281, 1040, 17] if case == "B=1 ctx 4096"
            else [281, 1040, 700, 513, 977, 300, 650, 842])
    q, pool, tab, kv_len = _decode_case(dtype, 32, 32, 128, lens, 23)
    full = paged_attention.paged_attention(q, pool, tab, kv_len)
    for _ in range(3):
        assert torch.equal(paged_attention.paged_attention(
            q, pool, tab, kv_len), full)
    for i in range(1 if case == "B=1 ctx 4096" else len(lens)):
        alone = paged_attention.paged_attention(
            q[i:i + 1].contiguous(), pool, tab[i:i + 1].contiguous(),
            kv_len[i:i + 1].contiguous())
        assert torch.equal(alone[0], full[i]), i


def test_paged_decode_is_one_launch():
    """A decode call over a table of several splits runs one kernel on
    the card (after the first call, which may zero the ticket buffer)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    q, pool, tab, kv_len = _decode_case(torch.bfloat16, 32, 32, 128,
                                        DECODE_LENS["B=8 with pad rows"], 24)
    paged_attention.paged_attention(q, pool, tab, kv_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        paged_attention.paged_attention(q, pool, tab, kv_len)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    assert len(names) == 1 and "paged_decode_kernel" in names[0], names


def test_wrappers_reject_bad_inputs():
    _need_cuda()
    q = torch.zeros(1, 16, 4, 80, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_prefill.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_prefill.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 4, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_prefill.flash_attention(q, q, q)
    pool = torch.zeros(4, 16, 2, 1, 64, device="cuda")   # G = 32
    with pytest.raises(ValueError, match="H / KV"):
        paged_attention.paged_attention(
            torch.zeros(1, 32, 64, device="cuda"), pool,
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"),
            torch.ones(1, dtype=torch.int32, device="cuda"))


def _segments(specs, H, D, MAXB, NB, tq, seed):
    """A flat tq-padded batch of (q_offset, n_tokens) segments on the
    card, tables drawn from a permutation of NB ids."""
    r = np.random.RandomState(seed)
    pads = [-(-max(n, 1) // tq) * tq for _, n in specs]
    seg = np.repeat(np.arange(len(specs)), pads).astype(np.int32)
    pos = np.concatenate([off + np.arange(p) for (off, _), p
                          in zip(specs, pads)]).astype(np.int32)
    klen = np.asarray([off + n for off, n in specs], np.int32)
    tab = r.permutation(NB)[:len(specs) * MAXB].reshape(len(specs), MAXB)
    cuda = [torch.from_numpy(a.astype(np.int32)).cuda()
            for a in (tab, seg, pos, klen)]
    return (_randn((sum(pads), H, D), torch.float32, seed), cuda,
            klen[seg] > 0)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES + [G16])
@pytest.mark.parametrize("tq", [8, 32])
def test_paged_prefill_kernel_matches_plain(dtype, tol, H, KV, D, tq):
    """Chunk edges (straddling a block, block-aligned, one token, mid-block
    start and end), decode tokens and a kv_len = 0 dummy in one call;
    live rows compared, every row finite, dummy rows 0."""
    _need_cuda()
    NB, BS, MAXB = 64, 16, 8
    pool = _randn((NB, BS, 2, KV, D), dtype, 7)
    specs = [(29, 11), (0, 16), (47, 1), (5, 3), (70, 40), (90, 1), (0, 0)]
    q, (tab, seg, pos, klen), live = _segments(specs, H, D, MAXB, NB, tq, 8)
    q = q.to(dtype)
    before = paged_prefill.launches
    got = paged_prefill.paged_prefill(q, pool, tab, seg, pos, klen, tq=tq)
    want = paged_prefill.paged_prefill_plain(q, pool, tab, seg, pos, klen,
                                             tq=tq)
    torch.cuda.synchronize()
    live = torch.from_numpy(live).cuda()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=tol)
    assert torch.isfinite(got).all() and (got[~live] == 0).all()
    assert paged_prefill.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", SHAPES + [G16])
def test_paged_prefill_rows_invariant_to_chunking(dtype, H, KV, D):
    """A row's output depends only on its q, its segment's keys and the
    key steps: the prompt's rows computed as one chunk, as two chunks and
    as three (split mid-block, other segments beside them, tq 32:
    `paged_chunk_layouts`) are equal bit for bit."""
    _need_cuda()
    pool = _randn((64, 16, 2, KV, D), dtype, 21)
    outs = {}
    for name, cuts in CHUNKINGS.items():
        q, *ints, rows = (torch.from_numpy(a).cuda()
                          for a in chunk_layout(cuts, H, D))
        outs[name] = paged_prefill.paged_prefill(q.to(dtype), pool, *ints,
                                                 tq=32)[rows]
    torch.cuda.synchronize()
    for name in CHUNKINGS:
        assert torch.equal(outs[name], outs["one chunk"]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_paged_prefill_body_route(dtype, D):
    """bf16 at D = 64 and 128 launches the tensor-core body, f32 at every
    D and bf16 at D = 32 the CUDA-core one: one launch on the route's
    counter per call, one pool or two."""
    _need_cuda()
    KV, BS = 2, 16
    pool = _randn((8, BS, 2, KV, D), dtype, 22)
    q, (tab, seg, pos, klen), _ = _segments([(20, 30)], 8, D, 4, 8, 32, 23)
    route = "mma" if dtype == torch.bfloat16 and D >= 64 else "fma"
    assert paged_prefill.body_route(dtype, D) == route
    tier = torch.ones(1, dtype=torch.bool, device="cuda")
    for two in (False, True):
        before = (paged_prefill.launches_mma, paged_prefill.launches_fma)
        if two:
            _staged_call(q.to(dtype), pool, pool.cpu().pin_memory(), tab,
                         seg, pos, klen, tier)
        else:
            paged_prefill.paged_prefill(q.to(dtype), pool, tab, seg, pos,
                                        klen, tq=32)
        torch.cuda.synchronize()
        after = (paged_prefill.launches_mma, paged_prefill.launches_fma)
        want = (1, 0) if route == "mma" else (0, 1)
        assert (after[0] - before[0], after[1] - before[1]) == want


def _staged_call(q, pool, hpool, tab, seg, pos, klen, tier, tq=32):
    """One two-pool call as the executor issues it: the live host blocks
    listed on the host (`host_block_runs`), staged by the copy engine on
    the side stream after the current stream's work, then the body over
    the staged buffer once the current stream has waited for it."""
    BS, (S, MAXB) = pool.shape[1], tab.shape
    runs = paged_prefill.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(),
                                         BS, hpool.shape[0])
    staged = torch.empty((S * MAXB, *pool.shape[1:]), dtype=pool.dtype,
                         device=pool.device)
    main, side = (torch.cuda.current_stream(),
                  paged_prefill.staging_stream(pool.device))
    side.wait_stream(main)
    with torch.cuda.stream(side):
        paged_prefill.stage_host_runs(hpool, runs, staged)
    main.wait_stream(side)
    return paged_prefill.paged_prefill(q, pool, tab, seg, pos, klen,
                                       staged=staged, tier=tier, tq=tq)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_paged_prefill_kernel_two_pools(dtype, tol, H, KV, D):
    """A host-resident segment reads its blocks of the pinned HOST pool,
    staged by the copy engine, with ids above the device pool's size;
    device segments read the device pool."""
    _need_cuda()
    BS, MAXB = 16, 4
    dpool = _randn((8, BS, 2, KV, D), dtype, 9)
    hpool = _randn((64, BS, 2, KV, D), dtype, 10).cpu().pin_memory()
    q, (_, seg, pos, klen), _ = _segments([(20, 30), (33, 17), (3, 1)], H,
                                          D, MAXB, 64, 32, 11)
    q = q.to(dtype)
    tab = torch.tensor([[60, 33, 51, 40], [2, 5, 1, 7], [12, 0, 0, 0]],
                       dtype=torch.int32, device="cuda")
    tier = torch.tensor([True, False, True], device="cuda")
    before = paged_prefill.launches_tiered
    got = _staged_call(q, dpool, hpool, tab, seg, pos, klen, tier)
    want = paged_prefill.paged_prefill_plain(q, dpool, tab, seg, pos, klen,
                                             host_pool=hpool, tier=tier,
                                             tq=32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert paged_prefill.launches_tiered == before + 1


def _two_pool_case(dtype, H, KV, D, specs, tiers, tail=0, seed=12):
    """The fused step's layout (tq 32, BS 16, `tail` tail tiles on the
    last slot): device pool and pinned host pool holding the same blocks
    at the same ids, so two pools and one must give the same bits."""
    BS, TQ = 16, 32
    q, (_, seg, pos, klen), live = _segments(specs, H, D, 1, len(specs),
                                             TQ, seed)
    if tail:
        last = len(specs) - 1
        seg = torch.cat([seg, torch.full((tail * TQ,), last,
                                         dtype=torch.int32, device="cuda")])
        pos = torch.cat([pos, torch.arange(tail * TQ, dtype=torch.int32,
                                           device="cuda")])
        q = torch.cat([q, _randn((tail * TQ, H, D), torch.float32, seed)])
        live = np.concatenate([live, np.zeros(tail * TQ, bool)])
    maxb = max(8, -(-max(-(-int(k) // BS) for k in klen.tolist()) // 8) * 8)
    nb = len(specs) * maxb + 3
    pool = _randn((nb, BS, 2, KV, D), dtype, seed + 1)
    r = np.random.RandomState(seed + 2)
    tab = torch.from_numpy(r.permutation(nb)[:len(specs) * maxb]
                           .reshape(len(specs), maxb).astype(np.int32)).cuda()
    tier = torch.tensor(tiers, device="cuda")
    return (q.to(dtype), pool, pool.cpu().pin_memory(), tab, seg, pos, klen,
            tier, torch.from_numpy(live).cuda())


# (specs, tiers, tail tiles): the main path's timed shape (one 512-token
# chunk at offset 512, host-resident) and the fused step's own layout
TWO_POOL_LAYOUTS = {
    "timed shape": ([(512, 512)], [True], 0),
    "fused layout": ([(512, 512), (1000, 1), (777, 1), (0, 0)],
                     [True, False, True, False], 13),
    "chunk edges, mixed tiers": ([(29, 11), (0, 16), (47, 1), (5, 3),
                                  (70, 40), (0, 0)],
                                 [True, True, False, True, False, True], 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(32, 32, 128), (8, 2, 32)])
@pytest.mark.parametrize("layout", list(TWO_POOL_LAYOUTS))
def test_paged_prefill_two_pools_bit_identical_to_one_pool(dtype, H, KV, D,
                                                          layout):
    """Host segments read their staged blocks with the body's one-pool
    arithmetic: the two-pool output equals the one-pool output on the same
    blocks bit for bit, and one staging call goes with each call."""
    _need_cuda()
    specs, tiers, tail = TWO_POOL_LAYOUTS[layout]
    q, pool, hpool, tab, seg, pos, klen, tier, _ = _two_pool_case(
        dtype, H, KV, D, specs, tiers, tail)
    before = (paged_prefill.launches_tiered, paged_prefill.launches_stage)
    two = _staged_call(q, pool, hpool, tab, seg, pos, klen, tier)
    one = paged_prefill.paged_prefill(q, pool, tab, seg, pos, klen, tq=32)
    torch.cuda.synchronize()
    assert torch.equal(two, one)
    assert (paged_prefill.launches_tiered,
            paged_prefill.launches_stage) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(32, 32, 128), (8, 2, 32)])
@pytest.mark.parametrize("layout", list(TWO_POOL_LAYOUTS))
def test_paged_prefill_prefetched_staging_bit_identical_to_one_pool(
        dtype, H, KV, D, layout):
    """The fused step's prefetch: the host blocks are staged by the copy
    engine on the side stream from the host pool BEFORE the first
    segment's own rows reach it (stale there), those rows are then
    scattered into their staged slots, and the body over that buffer
    (`staged=`) equals the one-pool body over the pool holding the rows,
    bit for bit; one staging call, one copy-engine run per run listed."""
    _need_cuda()
    specs, tiers, tail = TWO_POOL_LAYOUTS[layout]
    q, pool, _, tab, seg, pos, klen, tier, _ = _two_pool_case(
        dtype, H, KV, D, specs, tiers, tail)
    BS, S, MAXB = 16, *tab.shape
    off, n = specs[0]
    cpos = torch.arange(off, off + n, device="cuda")
    blk = tab[0, cpos // BS].long()
    stale = pool.clone()
    stale[blk, cpos % BS] = _randn((n, 2, KV, D), dtype, 31)
    runs = paged_prefill.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(),
                                         BS, pool.shape[0])
    staged = torch.zeros((S * MAXB + 1, BS, 2, KV, D), dtype=dtype,
                         device="cuda")
    main = torch.cuda.current_stream()
    side = paged_prefill.staging_stream(pool.device)
    hstale = stale.cpu().pin_memory()
    side.wait_stream(main)
    before = (paged_prefill.launches_stage, paged_prefill.stage_runs)
    with torch.cuda.stream(side):
        paged_prefill.stage_host_runs(hstale, runs, staged)
    main.wait_stream(side)
    rows = (cpos // BS) * BS + cpos % BS          # segment 0's slots
    staged.view(-1, 2, KV, D).index_copy_(0, rows, pool[blk, cpos % BS])
    two = paged_prefill.paged_prefill(q, pool, tab, seg, pos, klen,
                                      staged=staged, tier=tier, tq=32)
    one = paged_prefill.paged_prefill(q, pool, tab, seg, pos, klen, tq=32)
    torch.cuda.synchronize()
    assert torch.equal(two, one)
    assert (paged_prefill.launches_stage, paged_prefill.stage_runs) == \
        (before[0] + 1, before[1] + len(runs))


def test_stage_host_runs_rejects_bad_inputs():
    """The copy-engine staging refuses the legacy default stream, a run
    outside either buffer and a pageable host pool."""
    _need_cuda()
    hpool = torch.zeros(8, 16, 2, 2, 32).pin_memory()
    out = torch.zeros(4, 16, 2, 2, 32, device="cuda")
    ok = np.asarray([[1, 0, 2]], np.int64)
    with pytest.raises(ValueError, match="legacy default stream"):
        with torch.cuda.stream(torch.cuda.default_stream()):
            paged_prefill.stage_host_runs(hpool, ok, out)
    with torch.cuda.stream(paged_prefill.staging_stream(out.device)):
        for bad in ([[7, 0, 2]], [[0, 3, 2]], [[0, 0, 0]], [[-1, 0, 1]]):
            with pytest.raises(ValueError, match="outside"):
                paged_prefill.stage_host_runs(
                    hpool, np.asarray(bad, np.int64), out)
        with pytest.raises(ValueError, match="pinned"):
            paged_prefill.stage_host_runs(hpool.clone(), ok, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(TWO_POOL_LAYOUTS))
def test_stage_host_blocks_matches_plain(dtype, layout):
    """The staging (the copy engine, on the side stream) writes exactly
    the live host slots, each equal to its plain version; a NaN-filled
    buffer keeps every other slot."""
    _need_cuda()
    specs, tiers, tail = TWO_POOL_LAYOUTS[layout]
    _, _, hpool, tab, _, _, klen, tier, _ = _two_pool_case(
        dtype, 8, 2, 64, specs, tiers, tail)
    S, MAXB = tab.shape
    buf = torch.full((S * MAXB, *hpool.shape[1:]), float("nan"),
                     dtype=dtype, device="cuda")
    runs = paged_prefill.host_block_runs(tab.cpu(), klen.cpu(), tier.cpu(),
                                         16, hpool.shape[0])
    side = paged_prefill.staging_stream(buf.device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = paged_prefill.stage_host_runs(hpool, runs, buf)
    want = paged_prefill.stage_host_blocks_plain(hpool, tab, klen, tier)
    torch.cuda.synchronize()
    live = paged_prefill.live_host_slots(tab, klen, tier, 16).reshape(-1)
    assert torch.equal(got[live], want[live])
    assert got[~live].isnan().all()
    written = ~got.reshape(S * MAXB, -1).isnan().all(dim=1)
    assert torch.equal(written, live)


def test_paged_prefill_wrapper_rejects_bad_inputs():
    _need_cuda()
    pool = torch.zeros(4, 16, 2, 2, 64, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    args = (torch.zeros(8, 4, 64, device="cuda"), pool,
            torch.zeros(1, 2, **i32), torch.zeros(8, **i32),
            torch.arange(8, **i32), torch.ones(1, **i32))
    with pytest.raises(ValueError, match="multiple of tq"):
        paged_prefill.paged_prefill(*args, tq=16)
    with pytest.raises(ValueError, match="staged="):
        paged_prefill.paged_prefill(*args, host_pool=pool.cpu().pin_memory(),
                                    tier=torch.ones(1, **i32))
    with pytest.raises(ValueError, match="blocks of kv_pool"):
        paged_prefill.paged_prefill(*args, staged=pool[:1],
                                    tier=torch.ones(1, **i32))
    with pytest.raises(ValueError, match="go together"):
        paged_prefill.paged_prefill(*args, tier=torch.ones(1, **i32))


def _close_grad(got, want, tol):
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=tol)


# RMSNorm rows x d: the smoke widths, a row count below the SM count,
# one row of the narrowest d, llama4-scout's d 5120, the train shape
NORM_SHAPES = [(4, 128), (3, 33, 512), (300, 2048), (8, 4096), (1, 8),
               (5, 5120), (4096, 2048), (100, 4096)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rmsnorm_kernel_matches_plain(dtype, tol, shape):
    _need_cuda()
    x = _randn(shape, dtype, 10)
    w = (_randn(shape[-1:], torch.float32, 11) * 0.1 + 1).to(dtype)
    before = rmsnorm.launches
    got = rmsnorm.rmsnorm(x, w)
    torch.testing.assert_close(got.float(), rmsnorm.rmsnorm_plain(x, w)
                               .float(), atol=tol, rtol=tol)
    assert rmsnorm.launches == before + 1


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 128), (3, 33, 512), (1000, 2048),
                                   (1, 8), (5, 5120), (4096, 2048),
                                   (100, 4096)])
def test_rmsnorm_backward_matches_autograd(dtype, tol, shape):
    _need_cuda()
    x = _randn(shape, dtype, 12)
    w = (_randn(shape[-1:], torch.float32, 13) * 0.1 + 1).to(dtype)
    dy = _randn(shape, dtype, 14)
    before = rmsnorm.launches_bwd
    grads = []
    for fn in (rmsnorm.rmsnorm, rmsnorm.rmsnorm_plain):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xg, wg).backward(dy)
        grads.append((xg.grad, wg.grad))
    assert rmsnorm.launches_bwd == before + 1
    (gx, gw), (px, pw) = grads
    assert gx.dtype == gw.dtype == dtype
    _close_grad(gx, px, tol)
    _close_grad(gw, pw, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 2048), (1000, 5120), (7, 256)])
def test_rmsnorm_backward_dw_is_bit_identical_across_calls(dtype, shape):
    """dw is summed in a fixed order (no atomics): two calls on the same
    inputs give the same bits, dx too."""
    _need_cuda()
    x = _randn(shape, dtype, 15)
    w = (_randn(shape[-1:], torch.float32, 16) * 0.1 + 1).to(dtype)
    dy = _randn(shape, dtype, 17)
    _, rstd = rmsnorm._forward(x, w, 1e-6, keep_rstd=True)
    dx1, dw1 = rmsnorm.rmsnorm_bwd(dy, x, w, rstd)
    dx2, dw2 = rmsnorm.rmsnorm_bwd(dy, x, w, rstd)
    assert torch.equal(dw1, dw2) and torch.equal(dx1, dx2)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", SHAPES)
@pytest.mark.parametrize("case", ["causal", "window", "offset",
                                  "full"])
def test_flash_backward_matches_autograd(dtype, tol, H, KV, D, case):
    _need_cuda()
    B, Sq, Skv = 2, 200, 200
    kw = {"causal": True, "window": 0, "q_offset": 0}
    if case == "window":
        kw["window"] = 48
    elif case == "offset":          # a chunk at the end of its context
        Sq, kw["q_offset"] = 72, 128
    elif case == "full":
        kw["causal"] = False
    q = _randn((B, Sq, H, D), dtype, 20)
    k = _randn((B, Skv, KV, D), dtype, 21)
    v = _randn((B, Skv, KV, D), dtype, 22)
    do = _randn((B, Sq, H, D), dtype, 23)
    before = flash_prefill.launches_bwd
    got = []
    for fn in (flash_prefill.flash_attention,
               flash_prefill.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, **kw)
        out.backward(do)
        got.append((out.detach(), *(t.grad for t in leaves)))
    assert flash_prefill.launches_bwd == before + 1
    torch.testing.assert_close(got[0][0].float(), got[1][0].float(),
                               atol=tol, rtol=tol)
    for a, b in zip(got[0][1:], got[1][1:]):
        _close_grad(a, b, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", GQA_SHAPES)
@pytest.mark.parametrize("case", ["ragged", "window"])
def test_flash_backward_tile_edges(dtype, tol, H, KV, D, case):
    """Sq and Skv off the 64-row grid (a chunk at q_offset 37), with and
    without a window, at G in {1, 4, 8} and D in {32, 64, 128}."""
    _need_cuda()
    B, Sq, Skv = 1, 300, 337
    kw = {"causal": True, "q_offset": 37,
          "window": 100 if case == "window" else 0}
    q = _randn((B, Sq, H, D), dtype, 40)
    k = _randn((B, Skv, KV, D), dtype, 41)
    v = _randn((B, Skv, KV, D), dtype, 42)
    do = _randn((B, Sq, H, D), dtype, 43)
    got = []
    for fn in (flash_prefill.flash_attention,
               flash_prefill.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, **kw).backward(do)
        got.append([t.grad for t in leaves])
    for a, b in zip(*got):
        _close_grad(a, b, tol)


def test_flash_kernels_run_on_tensor_cores():
    """The flash forward's SASS holds wgmma (HGMMA), the backward's
    mma.sync (HMMA) or wgmma; the compiler's report of the two libraries
    is printed, spills included."""
    _need_cuda()
    from repro_torch.kernels import _build
    _build.build(["flash_prefill", "flash_backward"])
    fwd = _build.sass_counts("flash_prefill")
    bwd = _build.sass_counts("flash_backward")
    for name in ("flash_prefill", "flash_backward"):
        for line in _build.log_text(name).splitlines():
            if "spill" in line or "registers" in line:
                print(name, line.strip())
    assert fwd["HGMMA"] > 0, fwd
    assert bwd["HMMA"] + bwd["HGMMA"] > 0, bwd


def test_backward_wrappers_reject_bad_inputs():
    _need_cuda()
    w = torch.ones(12, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm.rmsnorm(torch.zeros(4, 12, device="cuda"), w)
    with pytest.raises(ValueError, match="above 8192"):
        rmsnorm.rmsnorm(torch.zeros(2, 8200, device="cuda"),
                        torch.ones(8200, device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        rmsnorm.rmsnorm(torch.zeros(4, 16, device="cuda",
                                    dtype=torch.float16),
                        torch.ones(16, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="w must be"):
        rmsnorm.rmsnorm(torch.zeros(4, 16, device="cuda"),
                        torch.ones(16, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm(torch.zeros(16, 4, device="cuda").T,
                        torch.ones(16, device="cuda"))
    q = torch.zeros(1, 16, 4, 64, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="kv_len"):
        flash_prefill.flash_attention(q, q, q, kv_len=torch.ones(
            1, dtype=torch.int32, device="cuda"))
