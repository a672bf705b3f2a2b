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
# smoke configs (D = 32: bf16 flash on the 3xTF32 kernels, bf16 paged
# attention on the CUDA-core ones)
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


# G = H / KV in {1, 4, 8} at D = 64 and 128, the smoke configs' D = 32,
# and zamba2's D = 80 (bf16 on the tensor-core kernels) at G 1, 4
GQA_SHAPES = [(8, 8, 64), (8, 2, 64), (8, 1, 64), (8, 8, 128), (8, 2, 128),
              (8, 1, 128), (8, 2, 32), (4, 4, 32), (8, 8, 80), (8, 2, 80)]
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
    q = torch.zeros(1, 16, 4, 96, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_prefill.flash_attention(q, q, q)
    # D = 80 runs flash (zamba2) but has no paged kernel: both paged
    # wrappers refuse it before any launch
    n = (paged_attention.launches, paged_prefill.launches)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim 80"):
        paged_attention.paged_attention(
            torch.zeros(1, 4, 80, device="cuda"),
            torch.zeros(4, 16, 2, 4, 80, device="cuda"),
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"), one)
    with pytest.raises(ValueError, match="head dim 80"):
        paged_prefill.paged_prefill(
            torch.zeros(8, 4, 80, device="cuda"),
            torch.zeros(4, 16, 2, 4, 80, device="cuda"),
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"),
            torch.zeros(8, dtype=torch.int32, device="cuda"),
            torch.arange(8, dtype=torch.int32, device="cuda"), one * 8)
    assert (paged_attention.launches, paged_prefill.launches) == n
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


# the bf16 tensor-core body's cases (D 64 / 128 at G 1 and G 4), over
# more seeds: its output's bf16 rounding hides most one-ulp changes of
# the f32 rows, so a correction that is not exactly 1 shows only on rows
# that round at a bf16 boundary
BF16_MMA_ROWS = [(32, 32, 64), (32, 32, 128), (32, 8, 64), (32, 8, 128)]
ROW_CASES = ([(dt, *shape, 20) for dt in (torch.float32, torch.bfloat16)
              for shape in SHAPES + [G16]]
             + [(torch.bfloat16, *shape, seed) for shape in BF16_MMA_ROWS
                for seed in range(21, 29)])


@pytest.mark.parametrize("dtype,H,KV,D,seed", ROW_CASES)
def test_paged_prefill_rows_invariant_to_chunking(dtype, H, KV, D, seed):
    """A row's output depends only on its q, its segment's keys and the
    key steps: the prompt's rows computed as one chunk, as two chunks and
    as three (split mid-block, other segments beside them, tq 32:
    `paged_chunk_layouts`) are equal bit for bit, in both bodies."""
    _need_cuda()
    pool = _randn((64, 16, 2, KV, D), dtype, seed + 1)
    outs = {}
    for name, cuts in CHUNKINGS.items():
        q, *ints, rows = (torch.from_numpy(a).cuda()
                          for a in chunk_layout(cuts, H, D, seed=seed))
        outs[name] = paged_prefill.paged_prefill(q.to(dtype), pool, *ints,
                                                 tq=32)[rows]
    torch.cuda.synchronize()
    for name in CHUNKINGS:
        assert torch.equal(outs[name], outs["one chunk"]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_paged_prefill_body_route(dtype, D):
    """bf16 at D = 64 and 128 launches the bf16 tensor-core body, f32 at
    every D and bf16 at D = 32 the 3xTF32 one: one launch on the route's
    counter per call, one pool or two."""
    _need_cuda()
    KV, BS = 2, 16
    pool = _randn((8, BS, 2, KV, D), dtype, 22)
    q, (tab, seg, pos, klen), _ = _segments([(20, 30)], 8, D, 4, 8, 32, 23)
    route = "mma" if dtype == torch.bfloat16 and D >= 64 else "tf32"
    assert paged_prefill.body_route(dtype, D) == route
    tier = torch.ones(1, dtype=torch.bool, device="cuda")
    for two in (False, True):
        before = (paged_prefill.launches_mma, paged_prefill.launches_tf32)
        if two:
            _staged_call(q.to(dtype), pool, pool.cpu().pin_memory(), tab,
                         seg, pos, klen, tier)
        else:
            paged_prefill.paged_prefill(q.to(dtype), pool, tab, seg, pos,
                                        klen, tq=32)
        torch.cuda.synchronize()
        after = (paged_prefill.launches_mma, paged_prefill.launches_tf32)
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
               (5, 5120), (4096, 2048), (100, 4096), (33, 2560)]


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
    without a window, at G in {1, 4, 8} and D in {32, 64, 80, 128}."""
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


# ------------------------------------------- Model API shapes (PR 21) --
#
# dense-cache decode (the flash forward at one query row, non-causal,
# runtime kv_len), whisper-base's non-causal Sq != Skv attention, and
# qwen2-vl-7b's G = 7 (H 28 over KV 4)
DECODE_HKD = [(32, 32, 128), (28, 4, 128), (8, 8, 64), (8, 2, 32),
              (32, 32, 80)]
CROSS_HKD = [(8, 8, 64), (4, 4, 32), (28, 4, 128)]
# (B, Sq, Skv, kv_len or None): Skv off the 128-key tile (1500 = 11 x
# 128 + 92), Skv > Sq and Sq > Skv, one decode row
CROSS_CASES = {"Sq 448 Skv 1500": (1, 448, 1500, None),
               "Sq 100 Skv 300 enc_len": (2, 100, 300, [300, 93]),
               "Sq 300 Skv 100": (2, 300, 100, None),
               "Sq 1 Skv 1500": (3, 1, 1500, None)}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", DECODE_HKD)
def test_decode_attention_kernel_matches_plain(dtype, tol, H, KV, D):
    """One query row per sequence over a dense cache, kv_len at the key
    tile's edges and up to the whole cache: one launch, counted in
    `launches_decode` and `launches`, equal to the plain version."""
    _need_cuda()
    lens = [1, 127, 128, 129, 300, 1056]
    B, S = len(lens), 1056
    q = _randn((B, 1, H, D), dtype, 50)
    k = _randn((B, S, KV, D), dtype, 51)
    v = _randn((B, S, KV, D), dtype, 52)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n, nd = flash_prefill.launches, flash_prefill.launches_decode
    got = flash_prefill.decode_attention(q, k, v, kv_len)
    want = flash_prefill.decode_attention_plain(q, k, v, kv_len)
    assert (flash_prefill.launches, flash_prefill.launches_decode) \
        == (n + 1, nd + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="B, 1, H, D"):
        flash_prefill.decode_attention(_randn((B, 2, H, D), dtype, 53), k, v,
                                       kv_len)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,KV,D", CROSS_HKD)
@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_flash_non_causal_cross_shapes(dtype, tol, H, KV, D, case):
    """Non-causal Sq != Skv, forward and (without kv_len, as training
    calls it) backward against the plain version and autograd."""
    _need_cuda()
    B, Sq, Skv, lens = CROSS_CASES[case]
    q = _randn((B, Sq, H, D), dtype, 60)
    k = _randn((B, Skv, KV, D), dtype, 61)
    v = _randn((B, Skv, KV, D), dtype, 62)
    kw = dict(causal=False, kv_len=None if lens is None else torch.tensor(
        lens, dtype=torch.int32, device="cuda"))
    got = flash_prefill.flash_attention(q, k, v, **kw)
    want = flash_prefill.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if lens is not None:
        return
    do = _randn((B, Sq, H, D), dtype, 63)
    grads = []
    for fn in (flash_prefill.flash_attention,
               flash_prefill.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=False).backward(do)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close_grad(a, b, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", ["causal 1024", "ragged q_offset 37",
                                  "window"])
def test_flash_g7_forward_and_backward(dtype, tol, case):
    """qwen2-vl-7b's heads (G = 7: 28 query heads over 4 KV heads,
    D 128): forward and backward against the plain version."""
    _need_cuda()
    H, KV, D = 28, 4, 128
    Sq, Skv, kw = {"causal 1024": (1024, 1024, {}),
                   "ragged q_offset 37": (300, 337, {"q_offset": 37}),
                   "window": (300, 337, {"q_offset": 37, "window": 100})}[
        case]
    q = _randn((1, Sq, H, D), dtype, 70)
    k = _randn((1, Skv, KV, D), dtype, 71)
    v = _randn((1, Skv, KV, D), dtype, 72)
    do = _randn((1, Sq, H, D), dtype, 73)
    outs, grads = [], []
    for fn in (flash_prefill.flash_attention,
               flash_prefill.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, **kw)
        out.backward(do)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.testing.assert_close(outs[0].float(), outs[1].float(), atol=tol,
                               rtol=tol)
    for a, b in zip(*grads):
        _close_grad(a, b, tol)


# zamba2-2.7b's shared attention at D 80 (H = KV = 32): (B, Sq, Skv, KV,
# kwargs). Sq and Skv off the 128-row / 128-key tiles (300 / 337 at
# q_offset 37), a window below one 128-key tile, G = 2, a ragged kv_len,
# and decode (Sq = 1, ragged kv_len over a 1056-slot cache)
D80_CASES = {
    "causal 1024": (2, 1024, 1024, 32, {}),
    "ragged q_offset 37": (1, 300, 337, 32, {"q_offset": 37}),
    "window": (1, 300, 337, 32, {"q_offset": 37, "window": 100}),
    "window below one tile": (2, 300, 337, 32, {"q_offset": 37,
                                                "window": 50}),
    "G 2": (1, 300, 337, 16, {"q_offset": 37}),
    "kv_len": (2, 200, 256, 32, {"kv_len": [131, 256]}),
    "decode": (4, 1, 1056, 32, {"kv_len": [1, 129, 1000, 1056]}),
}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", list(D80_CASES))
def test_flash_d80_forward_and_backward(dtype, tol, case):
    """zamba2-2.7b's shared attention (H 32, D 80: bf16 on the bf16
    tensor-core kernels, f32 on the 3xTF32 ones): forward and backward
    against the plain version and autograd through it. With a ragged
    kv_len the forward takes it (as prefill passes it) and the backward,
    which takes none (training passes none), runs per row on the keys cut
    to that row's kv_len: its dq, dk and dv equal autograd through the
    plain version with kv_len, whose dk and dv are 0 past kv_len. Decode
    is `decode_attention`, one launch on the same forward kernel."""
    _need_cuda()
    H, D = 32, 80
    B, Sq, Skv, KV, kw = D80_CASES[case]
    kw = dict(kw)
    q = _randn((B, Sq, H, D), dtype, 80)
    k = _randn((B, Skv, KV, D), dtype, 81)
    v = _randn((B, Skv, KV, D), dtype, 82)
    do = _randn((B, Sq, H, D), dtype, 83)
    lens = kw.pop("kv_len", None)
    if case == "decode":
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        nd = flash_prefill.launches_decode
        got = flash_prefill.decode_attention(q, k, v, kv_len)
        want = flash_prefill.decode_attention_plain(q, k, v, kv_len)
        assert flash_prefill.launches_decode == nd + 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        return
    if lens is not None:
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = flash_prefill.flash_attention(q, k, v, kv_len=kv_len, **kw)
        want = flash_prefill.flash_attention_plain(q, k, v, kv_len=kv_len,
                                                   **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_prefill.flash_attention_plain(*leaves, kv_len=kv_len,
                                            **kw).backward(do)
        for b, L in enumerate(lens):
            cut = [q[b:b + 1], k[b:b + 1, :L], v[b:b + 1, :L]]
            cut = [t.contiguous().requires_grad_() for t in cut]
            out = flash_prefill.flash_attention(*cut, **kw)
            torch.testing.assert_close(out.detach()[0].float(),
                                       got[b].float(), atol=tol, rtol=tol)
            out.backward(do[b:b + 1])
            _close_grad(cut[0].grad[0], leaves[0].grad[b], tol)
            for g, w in zip(cut[1:], leaves[1:]):
                _close_grad(g.grad[0], w.grad[b, :L], tol)
                assert not w.grad[b, L:].any()
        return
    outs, grads = [], []
    for fn in (flash_prefill.flash_attention,
               flash_prefill.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, **kw)
        out.backward(do)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.testing.assert_close(outs[0].float(), outs[1].float(), atol=tol,
                               rtol=tol)
    for a, b in zip(*grads):
        _close_grad(a, b, tol)


@pytest.mark.parametrize("arch,kw", [("granite-3-2b", {}),
                                     ("granite-3-2b", {"sliding_window": 16}),
                                     ("codeqwen1.5-7b", {"kv_quant": True}),
                                     ("qwen2-vl-7b", {}),
                                     ("whisper-base", {}),
                                     ("zamba2-2.7b", {}),
                                     ("zamba2-2.7b", {"sliding_window": 16}),
                                     ("xlstm-1.3b", {})])
def test_model_prefill_decode_on_card_matches_cpu(arch, kw):
    """The Model API on the card (flash forward, decode_attention, RMSNorm
    kernels) against the same weights on the CPU (plain versions), smoke
    configs in f32: prefill and 4 decodes at atol = rtol = 1e-4 (int8:
    after prefill and after every decode step the two sides' codes sit
    at most 1 apart, at rounding ties, and the card's cache then takes
    the CPU's codes and scales, so each step decodes from the same
    cache), the decode kernel launched once per self-attention layer and
    step (the hybrid: once per shared-block use; xlstm: never); the
    hybrid's and xlstm's recurrent cache leaves after the last step."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    _need_cuda()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    cpu = build_model(cfg, device="cpu", seed=4)
    card = build_model(cfg, _to_cuda(cpu.params), device="cuda")
    B, S, N = 2, 24, 4
    r = np.random.RandomState(4)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, (B, S + N)))
    batch = {"tokens": toks[:, :S]}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(
            r.randn(B, S, cfg.d_model).astype(np.float32) * 0.02)
        batch["mrope_pos"] = torch.arange(S)[None, None].expand(3, B, S)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            r.randn(B, cfg.encoder_len, cfg.d_model).astype(np.float32)
            * 0.02)
    cache_len = 16 if kw.get("sliding_window") else S + N
    b_cpu = batch
    b_card = {k: v.cuda() for k, v in batch.items()}
    lg_cpu, c_cpu = cpu.prefill(b_cpu, cpu.init_cache(B, cache_len))
    lg_card, c_card = card.prefill(b_card, card.init_cache(B, cache_len))
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    _sync_int8_codes(cfg, c_card, c_cpu)
    before = flash_prefill.launches_decode
    for i in range(S, S + N):
        lg_cpu, c_cpu = cpu.decode(toks[:, i], c_cpu)
        lg_card, c_card = card.decode(toks[:, i].cuda(), c_card)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
        _sync_int8_codes(cfg, c_card, c_cpu)
    assert flash_prefill.launches_decode - before \
        == N * cfg.n_attention_layers()
    for name in ("ssm_state", "conv", "mC", "mn", "mm", "sc", "sn", "sm",
                 "sh"):
        if name in c_cpu:
            torch.testing.assert_close(c_card[name].cpu(), c_cpu[name],
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_model_grads_and_train_steps_on_card_match_cpu(arch):
    """The hybrid's and the ssm's training on the card (flash forward and
    backward, RMSNorm both ways) against the same weights on the CPU
    (plain versions), smoke configs in f32: the loss at atol = rtol =
    1e-5 and every gradient leaf of `loss.backward()` at atol = 1e-4 *
    max |grad of that leaf|, rtol 1e-4; then five AdamW steps of
    `train_loop.train` from those weights, each step's loss at atol =
    rtol = 1e-4 and its gradient norm at rtol 1e-3 (five steps of Adam
    carry the first step's rounding forward)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.model import flatten_params
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    _need_cuda()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, device="cpu", seed=5)
    card = build_model(cfg, _to_cuda(cpu.params), device="cuda")
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flash_before, norm_before = (flash_prefill.launches_bwd,
                                 rmsnorm.launches_bwd)
    losses = []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        m.requires_grad_(True)
        loss, _ = m.loss({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses.append(float(loss.detach()))
    assert rmsnorm.launches_bwd > norm_before
    if cfg.n_attention_layers():
        assert flash_prefill.launches_bwd > flash_before
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=1e-5)
    want, got = flatten_params(cpu.params), flatten_params(card.params)
    assert sorted(want) == sorted(got)
    for key, p in want.items():
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(got[key].grad.cpu(), p.grad,
                                   atol=1e-4 * scale, rtol=1e-4, msg=key)
    dc = DataConfig(batch_size=2, seq_len=32)
    runs = [train(cfg, steps=5, dc=dc, device=dev, verbose=False,
                  params=_to_device(cpu.params, dev))
            for dev in ("cpu", "cuda")]
    np.testing.assert_allclose(runs[1].losses, runs[0].losses, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(runs[1].grad_norms, runs[0].grad_norms,
                               rtol=1e-3)


def _to_device(tree, device):
    """A copy of a params tree on `device`, without gradients."""
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.detach().to(device, copy=True) for k, v in tree.items()}


def _sync_int8_codes(cfg, c_card, c_cpu):
    """With `kv_quant`: the int8 codes of the two sides may sit 1 apart at
    rounding ties (their f32 inputs differ in the last bits); assert no
    more, then give the card's cache the CPU's codes and scales."""
    if not cfg.kv_quant:
        return
    for name in ("k", "v"):
        diff = (c_card[name].cpu().int() - c_cpu[name].int()).abs()
        assert int(diff.max()) <= 1
    for name in ("k", "v", "k_scale", "v_scale"):
        c_card[name] = c_cpu[name].cuda()


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.detach().cuda()
            for k, v in tree.items()}


def test_flash_kernels_run_on_tensor_cores():
    """The flash forward's SASS holds wgmma (HGMMA, its bf16 kernel) and
    mma.sync (HMMA, its 3xTF32 kernel for f32 and D 32), the backward's
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
    assert fwd["HGMMA"] > 0 and fwd["HMMA"] > 0, fwd
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


# ------------------------------------------------- replicas on one card --

def _smoke_prompts(n, seed, lo=40, hi=160):
    from repro_torch.configs import get_smoke_config
    vocab = get_smoke_config("granite-3-2b").vocab_size
    r = np.random.RandomState(seed)
    return [[int(t) for t in r.randint(0, vocab, int(L))]
            for L in r.randint(lo, hi + 1, n)]


def _fused_engine(params=None, seed=0):
    """granite-3-2b smoke (bf16, D 32) through the fused step on a device
    pool tight enough that chunks read host-resident layers (the
    fused-smoke path of chip_smoke.py)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.scheduler import ServeConfig
    ec = ServeConfig.for_engine(policy="layerkv", slo_aware=False,
                                block_size=16, num_device_blocks=24,
                                num_host_blocks=1024, chunked=True,
                                fused=True, max_prefill_tokens=64)
    return LayerKVEngine(get_smoke_config("granite-3-2b"), params, ec,
                         device="cuda", seed=seed)


def _submit(session, prompts, tag, out_len=8):
    from repro_torch.serving.request import Request
    return [session.submit(Request(rid=f"{tag}{i}", prompt_len=len(p),
                                   output_len=out_len, arrival=0.0,
                                   prompt=p))
            for i, p in enumerate(prompts)]


def _host_steps(eng):
    return sum(1 for fn, sig in eng.ex._jit_sigs if fn == "mixed" and sig[-1])


def test_two_executors_interleaved_on_one_card_match_solo_runs():
    """Two engines on one card, sharing one set of weights, one staging
    side stream and the decode tickets, their fused steps interleaved one
    by one, both reading the host tier: each replica's tokens equal, bit
    for bit, the tokens it gives when it runs alone."""
    _need_cuda()
    from repro_torch.serving.session import ServingSession
    a_prompts = _smoke_prompts(5, seed=11)
    b_prompts = _smoke_prompts(5, seed=12)
    solo = []
    for prompts in (a_prompts, b_prompts):
        eng = _fused_engine()
        sess = ServingSession(eng)
        _submit(sess, prompts, "r")
        solo.append({r.rid: r.generated for r in sess.drain()})
        assert _host_steps(eng) > 0
    a = _fused_engine()
    b = _fused_engine(params=a.ex.params)
    assert b.ex.params["embed"].data_ptr() == a.ex.params["embed"].data_ptr()
    sa, sb = ServingSession(a), ServingSession(b)
    _submit(sa, a_prompts, "r")
    _submit(sb, b_prompts, "r")
    busy = [True, True]
    while any(busy):
        busy = [sa.step() if busy[0] else False,
                sb.step() if busy[1] else False]
    got = [{r.rid: r.generated for r in s.drain()} for s in (sa, sb)]
    assert got == solo
    assert _host_steps(a) > 0 and _host_steps(b) > 0
    assert a.ex.nonfinite_logits() == b.ex.nonfinite_logits() == 0


def test_cluster_kill_frees_and_revived_replica_serves_on_card():
    """A two-replica cluster on one card: kill replica 0 while it streams
    (its live requests re-dispatched, every stream whole), both pools
    back at baseline after the drain, then replica 0, revived with its
    pools and staging buffers kept, serves a second wave whose tokens
    equal a fresh engine's."""
    _need_cuda()
    from repro_torch.core import DEVICE, HOST
    from repro_torch.serving.cluster import ClusterSession
    from repro_torch.serving.request import Request
    from repro_torch.serving.session import ServingSession
    first = _fused_engine()
    engines = [first, _fused_engine(params=first.ex.params)]
    cl = ClusterSession(engines, router="round_robin")
    wave1 = _smoke_prompts(6, seed=13)
    hs = _submit(cl, wave1, "w")
    streams = {h.rid: [] for h in hs}

    def pump():
        while cl.step():
            for h in hs:
                streams[h.rid] += h.take_new()
    while not any(h.replica == 0 and streams[h.rid] for h in hs):
        assert cl.step()
        for h in hs:
            streams[h.rid] += h.take_new()
    cl.kill(0)
    pump()
    cl.drain()
    assert cl.n_kills == 1 and cl.redispatch_priorities
    for h, p in zip(hs, wave1):
        assert streams[h.rid] == h.request.prompt[len(p):] \
            + h.request.generated
        assert len(streams[h.rid]) == 8
    for eng in engines:
        eng.bm.drop_cache()
        eng.bm.check()
        for tier in (DEVICE, HOST):
            assert eng.bm.num_free(tier) == eng.bm.pools[tier].num_blocks
    cl.revive(0)
    wave2 = _smoke_prompts(4, seed=14)
    hs = _submit(cl, wave2, "x")
    cl.drain()
    on0 = [(h.rid, p) for h, p in zip(hs, wave2) if h.replica == 0]
    assert on0
    sess = ServingSession(_fused_engine(params=first.ex.params))
    for rid, p in on0:
        sess.submit(Request(rid=rid, prompt_len=len(p), output_len=8,
                            arrival=0.0, prompt=p))
    want = {r.rid: r.generated for r in sess.drain()}
    assert {h.rid: h.request.generated for h in hs if h.replica == 0} \
        == want
    assert engines[0].ex.nonfinite_logits() == 0


# --------------------------------------------------- MoE capacity path --

def test_moe_capacity_bf16_matches_f32_plain_run():
    """The capacity-factor `moe_ffn` (training's) at deepseek-moe-16b's
    full width (64 experts top-6 + 2 shared, d 2048, d_expert 1408) over
    2 x 256 tokens in bf16 on the card, against the same function in f32
    on the CPU from the same values (inputs and weights rounded to bf16
    first, the router f32 in both): the same pairs are dropped, lb_loss
    within 1e-5 (both from f32 router probabilities), the output within
    atol = 2e-2 x max |out| and rtol = 2e-2 (bf16 rounds each of the
    expert chain's products and the gate multiply)."""
    _need_cuda()
    from repro_torch.models import moe
    cfg, gen, p32, pbf = _moe_full_width()
    x = torch.randn(2, 256, cfg.d_model, generator=gen).to(torch.bfloat16)
    want, waux = moe.moe_ffn(cfg, p32, x.float())
    got, aux = moe.moe_ffn(cfg, pbf, x.to("cuda"))
    assert float(aux["dropped_frac"]) == float(waux["dropped_frac"]) > 0
    torch.testing.assert_close(aux["lb_loss"].cpu(), waux["lb_loss"],
                               atol=1e-5, rtol=1e-5)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float().cpu(), want,
                               atol=2e-2 * scale, rtol=2e-2)


def _moe_full_width(seed=3):
    """deepseek-moe-16b's config and one layer's MoE params from a seed:
    f32 on the CPU (the bf16 init widened), and on the card in bf16 but
    the f32 router."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(seed)
    p32 = moe.init_moe(dataclasses.replace(cfg, dtype="bfloat16"), gen,
                       torch.bfloat16, "cpu")
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in p32.items()}

    def to_card(v):
        return v.to("cuda", torch.float32 if v is p32["router"]
                    else torch.bfloat16)
    pbf = {k: ({kk: to_card(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else to_card(v))
           for k, v in p32.items()}
    return cfg, gen, p32, pbf


def test_moe_dropless_bf16_matches_f32_plain_run():
    """The dropless `moe_ffn` (serving's) at deepseek-moe-16b's full
    width over 2 x 256 tokens: bf16 on the card (the grouped products)
    against f32 on the CPU from the same values, at
    `test_moe_capacity_bf16_matches_f32_plain_run`'s tolerance; and f32
    on the card (the capacity dispatch at C = T) against the same CPU run
    at atol = rtol = 2e-5 x max |out|."""
    _need_cuda()
    from repro_torch.models import moe
    cfg, gen, p32, pbf = _moe_full_width()
    x = torch.randn(2, 256, cfg.d_model, generator=gen).to(torch.bfloat16)
    want, _ = moe.moe_ffn(cfg, p32, x.float(), dropless=True)
    got, aux = moe.moe_ffn(cfg, pbf, x.to("cuda"), dropless=True)
    assert aux == {}
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float().cpu(), want,
                               atol=2e-2 * scale, rtol=2e-2)
    p32c = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cuda())
            for k, v in p32.items()}
    got32, _ = moe.moe_ffn(cfg, p32c, x.float().cuda(), dropless=True)
    torch.testing.assert_close(got32.cpu(), want, atol=2e-5 * scale,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [6, 512])
def test_moe_dropless_captures_in_a_cuda_graph(dtype, T):
    """The dropless `moe_ffn` at deepseek-moe-16b's full width, T tokens
    (a decode batch, a fused chunk), captured by `torch.cuda.graph` in
    bf16 (the grouped products) and f32 (C = T): the capture raises
    nothing, and replays on other tokens equal eager calls on them bit
    for bit."""
    _need_cuda()
    from repro_torch.models import moe
    cfg, gen, _, pbf = _moe_full_width()
    p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
             if isinstance(v, dict) else v if k == "router" else v.to(dtype))
         for k, v in pbf.items()}
    xs = [torch.randn(1, T, cfg.d_model, generator=gen).to("cuda", dtype)
          for _ in range(3)]
    static = xs[0].clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):          # warm-up off the default stream
        moe.moe_ffn(cfg, p, static, dropless=True)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_ffn(cfg, p, static, dropless=True)
    for x in xs[1:]:
        static.copy_(x)
        graph.replay()
        want, _ = moe.moe_ffn(cfg, p, x, dropless=True)
        torch.cuda.synchronize()
        assert torch.equal(out, want), \
            float((out.float() - want.float()).abs().max())


# ----------------------------------------- compiled steps (CUDA graphs) --

GRAPH_NDB, GRAPH_BS = 48, 16


def _graph_executors(seed=0, arch="granite-3-2b"):
    """A smoke executor of `arch` (bf16, D 32) on the card whose pool
    holds random values, and a twin with its weights and a copy of its
    pool, which runs the same steps eagerly on fresh tensors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.executor import PagedExecutor
    cfg = get_smoke_config(arch)
    ex = PagedExecutor(cfg, None, GRAPH_NDB, 16, GRAPH_BS, device="cuda",
                       seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ex.device_pool.copy_(torch.randn(ex.device_pool.shape, generator=g,
                                     device="cuda"))
    ref = PagedExecutor(cfg, ex.params, GRAPH_NDB, 16, GRAPH_BS,
                        device="cuda")
    ref.device_pool.copy_(ex.device_pool)
    return ex, ref


def _graph_steps(kind, rng, L):
    """Three steps of one signature: decode (Rb 4, MAXB 8) with 4, 3 and
    4 rows, or a host-free fused step (Tc 64, Sc 2, Rb 2) of two chunks
    and two decode rows, each step other blocks, offsets and contexts
    (every row's blocks its own)."""
    from repro_torch.serving.executor import MixedChunk, MixedDecode
    out = []
    for R in (4, 3, 4):
        ids = iter(rng.permutation(GRAPH_NDB).tolist())
        if kind == "decode":
            lens = rng.randint(1, 3 * GRAPH_BS, R)
            tab = np.array([[[next(ids) for _ in range(3)]
                             for _ in range(R)] for _ in range(L)],
                           np.int32)
            out.append((rng.randint(0, 512, R).tolist(), tab,
                        lens.tolist()))
            continue
        chunks = []
        for C, off in ((int(rng.randint(10, 33)), int(rng.randint(0, 24))),
                       (int(rng.randint(10, 33)), 0)):
            nb = -(-(off + C) // GRAPH_BS)
            tabs = [[next(ids) for _ in range(nb)] for _ in range(L)]
            chunks.append(MixedChunk(rng.randint(0, 512, C).tolist(), off,
                                     tabs, [False] * L))
        decodes = []
        for _ in range(2):
            ctx = int(rng.randint(1, 40))
            tabs = [[next(ids) for _ in range(ctx // GRAPH_BS + 1)]
                    for _ in range(L)]
            decodes.append(MixedDecode(int(rng.randint(0, 512)), ctx, tabs))
        out.append((chunks, decodes))
    return out


def _eager_twin(ref, kind, arrays, sig):
    """The step's forward on fresh tensors of its host arrays, eager."""
    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device="cuda")
    i32, i64 = torch.int32, torch.int64
    if kind == "decode":
        return ref._paged_decode(t("tokens", i64), t("tables", i32),
                                 t("kv_lens", i32))
    L, Tc, Rb = ref.cfg.n_layers, sig[0], sig[2]
    return ref._mixed_forward(
        t("tokens", i64), t("q_pos", i32), t("off", i64), t("blk_dev", i64),
        [[] for _ in range(L)], t("c_seg", i32),
        torch.as_tensor(np.array(arrays["q_pos"][:Tc]), dtype=i32,
                        device="cuda"),
        t("c_kvlens", i32), t("c_tables", i32), t("c_tier", i32),
        t("d_tables", i32), t("d_kvlens", i32), t("sample_idx", i64),
        t("is_chunk", torch.bool), [None] * L, None, Tc, Rb)


def _counts():
    return (paged_attention.launches, paged_prefill.launches,
            paged_prefill.launches_tf32, rmsnorm.launches)


@pytest.mark.parametrize("kind", ["decode", "mixed"])
def test_step_graph_replay_matches_eager(monkeypatch, kind):
    """One signature's three steps: the first eager (warm-up), the second
    captured and replayed, the third replayed, each against the same
    step run eagerly on fresh tensors by a twin executor: tokens equal,
    logits and the pool (but its trash block) bit for bit; each step
    advances the launch counters by the eager step's counts."""
    _check_replay(monkeypatch, kind, "granite-3-2b")


@pytest.mark.parametrize("kind", ["decode", "mixed"])
def test_moe_step_graph_replay_matches_eager(monkeypatch, kind):
    """The same for deepseek-moe-16b smoke: its decode and host-free
    fused steps, dropless MoE dispatch included, captured and replayed
    bit for bit against the eager twin."""
    _check_replay(monkeypatch, kind, "deepseek-moe-16b")


def _check_replay(monkeypatch, kind, arch):
    _need_cuda()
    from repro_torch.serving.executor import _StepGraph
    filled = []
    run = _StepGraph.run

    def spy(self, arrays):
        filled.append({k: np.array(v) for k, v in arrays.items()})
        return run(self, arrays)
    monkeypatch.setattr(_StepGraph, "run", spy)
    ex, ref = _graph_executors(arch=arch)
    seen = []
    note = ex._note_logits
    ex._note_logits = lambda lg: (seen.append(lg.clone()), note(lg))
    rng = np.random.RandomState(7)
    L = ex.cfg.n_layers
    for i, step in enumerate(_graph_steps(kind, rng, L)):
        before = _counts()
        got = (ex.decode if kind == "decode" else ex.mixed_step)(*step)
        stepped = [a - b for a, b in zip(_counts(), before)]
        (fn, sig), = ex._graphs
        n = len(got)
        mid = _counts()
        want = _eager_twin(ref, kind, filled[-1], sig)[:n]
        assert stepped == [a - b for a, b in zip(_counts(), mid)]
        torch.cuda.synchronize()
        assert got == torch.argmax(want, dim=-1).tolist()
        assert torch.equal(seen[-1], want), \
            float((seen[-1].float() - want.float()).abs().max())
        assert torch.equal(ex.device_pool[:GRAPH_NDB],
                           ref.device_pool[:GRAPH_NDB])
        assert (ex.graph_captures, ex.graph_replays) == \
            ((0, 0), (1, 1), (1, 2))[i]
    assert ex.eager_steps == {"first": 1} and ex.graph_pool_bytes > 0


def test_step_graph_capture_error_raises():
    """A step that syncs the host inside its forward cannot be captured:
    its first step runs (eagerly), its second raises, with no graph kept
    and the launch counters as before it; the card then runs on."""
    _need_cuda()
    ex, _ = _graph_executors()
    decode = ex._paged_decode

    def host_synced(tokens, tables, kv_lens):
        int(kv_lens.max())           # a host read: refused under capture
        return decode(tokens, tables, kv_lens)
    ex._paged_decode = host_synced
    rng = np.random.RandomState(8)
    steps = _graph_steps("decode", rng, ex.cfg.n_layers)
    ex.decode(*steps[0])
    before = _counts()
    with pytest.raises(RuntimeError):
        ex.decode(*steps[1])
    assert _counts() == before and ex.graph_captures == 0
    g, = ex._graphs.values()
    assert g.graph is None
    torch.cuda.synchronize()
    assert float(torch.ones(4, device="cuda").sum()) == 4.0
