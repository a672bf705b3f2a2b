"""3xTF32 over a paged pool, the arithmetic of the port's paged prefill
body for f32 and for bf16 at D 32 (`tf::paged_prefill_tf32`,
csrc/paged_prefill.cu), in numpy. The kernel walks a tile's keys in steps
of BK from key 0, each gathered through the segment's block table, and
keeps an online softmax per (query, head) row: S = Q K^T of the step,
masked to -1e30 where a key is past kv_len or after the row's position,
the running max in raw scores, exp2 with the scale folded in, and O = O
* corr + P V. Both products are 3xTF32 (tests/torch_parity.py): every f32
operand split into its TF32 pair, each product hi.hi + hi.lo + lo.hi.

The emulation, at a chunk + 2 decodes + a kv_len = 0 dummy + tail tiles
(the fused step's layout, tq 32, BS 16, a permuted table with one id
past the pool, clamped) at D 32, 64 and 128 and G 1, 4 and 16, stays
within a tenth of the card checks' f32 tolerance against float64 and
within that tolerance of the JAX package's `paged_prefill_reference`;
one TF32 pass misses it. A bf16 value splits with lo == 0, so at bf16 D
32 the kernel skips the passes that would add lo terms. The dispatch in
the source sends f32 at every D and bf16 at D 32 to the 3xTF32 kernel
and leaves no CUDA-core body."""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from torch_parity import mm_3xtf32, mm_tf32, split, tf32

TOL = 2e-5   # chip_smoke.TOL["float32"]: atol = rtol
TQ, BS, KV = 32, 16, 2
BK = {32: 64, 64: 64, 128: 32}   # the kernel's keys per step by head dim
LOG2E = 1.4426950408889634
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
# (q_offset, tokens): a chunk, two decode tokens, a kv_len = 0 dummy; two
# tail tiles on the dummy's slot with positions from 0
SPECS = [(40, 70), (150, 1), (97, 1), (0, 0)]
TAIL = 2
CASES = [(D, G) for D in (32, 64, 128) for G in (1, 4, 16)]


def _layout(D, G, seed=0):
    """(q, pool, table, seg_ids, q_pos, kv_len, live rows) as numpy: the
    fused step's layout over a pool of 4 blocks more than the table
    holds, the table a permutation with one live entry past the pool."""
    r = np.random.RandomState(seed)
    H = G * KV
    pads = [-(-max(n, 1) // TQ) * TQ for _, n in SPECS]
    seg = np.repeat(np.arange(len(SPECS)), pads)
    pos = np.concatenate([off + np.arange(p) for (off, _), p
                          in zip(SPECS, pads)])
    seg = np.concatenate([seg, np.full(TAIL * TQ, len(SPECS) - 1)])
    pos = np.concatenate([pos, np.arange(TAIL * TQ)])
    klen = np.asarray([off + n for off, n in SPECS])
    maxb = -(-int(klen.max()) // BS)
    nb = len(SPECS) * maxb + 4
    tab = r.permutation(nb)[:len(SPECS) * maxb].reshape(len(SPECS), maxb)
    tab[0, 1] = nb + 5   # out of range: clamped to the last block
    q = r.standard_normal((seg.size, H, D)).astype(np.float32)
    pool = r.standard_normal((nb, BS, 2, KV, D)).astype(np.float32)
    i32 = np.int32
    return (q, pool, tab.astype(i32), seg.astype(i32), pos.astype(i32),
            klen.astype(i32), klen[seg] > 0)


def paged_prefill_steps(q, pool, tab, seg, pos, klen, mm, dtype=np.float32):
    """The kernel's step-wise paged prefill: per query tile and KV head,
    its tq x G rows over keys [0, min(kv_len, MAXB * BS, max q_pos + 1))
    in steps of BK, each step's K / V gathered through the table (ids
    clamped into the pool), both products through `mm`, in `dtype`."""
    T, H, D = q.shape
    NB = pool.shape[0]
    S, MAXB = tab.shape
    G, bk = H // KV, BK[D]
    f = dtype
    sl2 = f(D ** -0.5 * LOG2E)
    neg = f(-1e30)
    out = np.zeros((T, H, D), f)
    for t0 in range(0, T, TQ):
        s = seg[t0]
        k_lim = min(int(klen[s]), MAXB * BS)
        k_end = min(k_lim, int(pos[t0:t0 + TQ].max()) + 1)
        kv = pool[np.minimum(tab[s], NB - 1)].reshape(MAXB * BS, 2, KV, D)
        qp = np.repeat(pos[t0:t0 + TQ], G)[:, None]
        for h in range(KV):
            qh = q[t0:t0 + TQ, h * G:(h + 1) * G].reshape(TQ * G, D).astype(f)
            m = np.full((TQ * G, 1), neg, f)
            l = np.zeros((TQ * G, 1), f)
            o = np.zeros((TQ * G, D), f)
            for k0 in range(0, k_end, bk):
                keys = np.arange(k0, k0 + bk)
                gk = np.where((keys < k_end)[:, None, None],
                              kv[np.minimum(keys, MAXB * BS - 1)][:, :, h],
                              0).astype(f)
                sc = mm(qh, gk[:, 0].T).astype(f)
                live = (keys[None] < k_lim) & (keys[None] <= qp)
                sc = np.where(live, sc, neg)
                mx = np.maximum(m, sc.max(1, keepdims=True))
                corr = np.exp2(m * sl2 - mx * sl2).astype(f)
                p = np.exp2(sc * sl2 - mx * sl2).astype(f)
                m = mx
                l = (l * corr + p.sum(1, keepdims=True)).astype(f)
                o = (o * corr + mm(p, gk[:, 1])).astype(f)
            o = o / np.maximum(l, f(1e-30))
            out[t0:t0 + TQ, h * G:(h + 1) * G] = o.reshape(TQ, G, D)
    return out


def _f64(a, b):
    return a @ b


@functools.lru_cache(maxsize=None)
def _run(D, G, how):
    """(got, live rows, inputs) of the emulation at case (D, G) with its
    products `how`: "3xtf32", "tf32" (one pass) or "f64" (exact)."""
    case = _layout(D, G)
    mm = {"3xtf32": mm_3xtf32, "tf32": mm_tf32, "f64": _f64}[how]
    got = paged_prefill_steps(*case[:6], mm,
                              np.float64 if how == "f64" else np.float32)
    return got, case[6], case


def _within(got, want, tol):
    return bool((np.abs(got - want) <= tol + tol * np.abs(want)).all())


def test_bf16_values_split_with_lo_zero():
    """Every finite bf16 value, widened to f32, is its own TF32 hi with a
    lo of 0: the 3xTF32 passes the kernel skips for bf16 inputs (lo.hi of
    q and K, hi.lo of K and V) would each add exactly 0."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    hi, lo = split(x)
    assert np.array_equal(hi.view(np.uint32), x.view(np.uint32))
    assert not lo.any()
    assert np.array_equal(tf32(x).view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("D,G", CASES)
def test_3xtf32_paged_prefill_within_a_tenth_of_the_f32_tolerance(D, G):
    got, live, _ = _run(D, G, "3xtf32")
    want = _run(D, G, "f64")[0]
    assert np.isfinite(got).all() and not got[~live].any()
    err = float(np.abs(got[live] - want[live]).max())
    assert _within(got[live], want[live], TOL / 10), err


@pytest.mark.parametrize("D,G", CASES)
def test_3xtf32_paged_prefill_matches_the_jax_reference(D, G):
    got, live, case = _run(D, G, "3xtf32")
    want = np.asarray(jref.paged_prefill_reference(
        *(jnp.asarray(a) for a in case[:6]), tq=TQ))
    err = float(np.abs(got[live] - want[live]).max())
    assert _within(got[live], want[live], TOL), err


@pytest.mark.parametrize("D,G", CASES)
def test_one_tf32_pass_misses_the_f32_tolerance(D, G):
    got, live, _ = _run(D, G, "tf32")
    want = _run(D, G, "f64")[0]
    assert not _within(got[live], want[live], TOL), \
        float(np.abs(got[live] - want[live]).max())


def test_paged_prefill_dispatch_takes_3xtf32():
    """In csrc/paged_prefill.cu, f32 at D 32 / 64 / 128 and bf16 at D 32
    go to the 3xTF32 case (its macro launches `tf::launch`), bf16 at D 64
    and 128 to the bf16 tensor-core one, the route entry names the two,
    and no CUDA-core body is left."""
    text = (CSRC / "paged_prefill.cu").read_text()
    routes = {(int(t), int(d)): m for t, d, m in re.findall(
        r"if \(dtype == (\d) && D == (\d+)\) (REPRO_\w+)\(", text)}
    assert routes == {(0, 32): "REPRO_PP_TF32_CASE",
                      (0, 64): "REPRO_PP_TF32_CASE",
                      (0, 128): "REPRO_PP_TF32_CASE",
                      (1, 32): "REPRO_PP_TF32_CASE",
                      (1, 64): "REPRO_PP_TC_CASE",
                      (1, 128): "REPRO_PP_TC_CASE"}, routes
    macro = re.search(r"#define REPRO_PP_TF32_CASE\(.*?\n(.*?)\n#define",
                      text, re.S).group(1)
    assert "tf::launch" in macro, macro
    assert re.search(r"\bpaged_prefill_tf32\s*\(", text)
    assert re.search(r"\bpaged_prefill_mma\s*\(", text)
    assert "return dtype == 1 && (D == 64 || D == 128) ? 1 : 0;" in text
    port = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch"
    left = [str(p) for p in port.rglob("*") if p.suffix in (".cu", ".cuh",
                                                            ".py")
            and "paged_prefill_kernel" in p.read_text()]
    assert not left, left
