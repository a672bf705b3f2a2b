"""3xTF32, the arithmetic of the f32 flash kernels on the card
(`tf::flash_fwd_tf32`, `tf::flash_bwd_{dq,dkdv}_tf32`; hopper.cuh), in
numpy: every f32 operand x is split into hi = tf32(x) and lo = tf32(x -
hi), rounded to nearest with ties away (`cvt.rna.tf32.f32`: TF32 keeps 10
of f32's 23 mantissa bits), and each product is taken as hi.hi + hi.lo +
lo.hi, each term an f32-accumulated product of TF32 values (exact
products, as the tensor cores form them). The attention forward with
both of its products done so (S = Q K^T, then O = P V with P split too)
stays within a tenth of the card checks' f32 tolerance against float64
at train_tiny's shape and at D 128; the same forward with one TF32 pass
misses that tolerance, which is why the kernels take three."""
import numpy as np
import pytest

from torch_parity import mm_3xtf32, mm_tf32, split, tf32

TOL = 2e-5   # chip_smoke.TOL["float32"]: atol = rtol


def attention(q, k, v, mm):
    """Causal GQA attention of q (B, S, H, D), k / v (B, S, KV, D) f32
    with both products through `mm`, the softmax in f32."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.transpose(0, 2, 1, 3)                                 # B H S D
    kh = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1)
    vh = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1)
    s = mm(qh, kh.transpose(0, 1, 3, 2)) * np.float32(D ** -0.5)
    s = np.where(np.tril(np.ones((S, S), bool)), s, np.float32(-1e30))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    o = mm(p, vh) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3).astype(np.float32)


def reference(q, k, v):
    f = np.float64
    return attention(q.astype(f), k.astype(f), v.astype(f),
                     lambda a, b: a @ b)


# train_tiny's attention (TINY_100M: 12 query heads over 4 KV heads of
# 64, B 4 x S 256) and a D 128 shape (llama2-7b's head dim, G = 4)
SHAPES = {"train_tiny G=3 D=64": (4, 256, 12, 4, 64),
          "G=4 D=128": (1, 256, 8, 2, 128)}


def _inputs(shape, seed=0):
    B, S, H, KV, D = shape
    r = np.random.RandomState(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, S, KV, D)).astype(np.float32),
            r.standard_normal((B, S, KV, D)).astype(np.float32))


def _within(got, want, tol):
    return bool((np.abs(got - want) <= tol + tol * np.abs(want)).all())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                  1 + 2 ** -11 - 2 ** -23, -(1 + 2 ** -11)], np.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9, 1.0,
            -(1 + 2 ** -10)]
    assert tf32(x).tolist() == want         # ties away, as cvt.rna
    hi, lo = split(x)
    assert np.all(tf32(hi) == hi) and np.all(tf32(lo) == lo)
    # the pair holds x to about 2^-22 relative (22 of its 24 bits)
    d = np.abs(hi.astype(np.float64) + lo - x)
    assert np.all(d <= 2.0 ** -22 * np.abs(x)), d


@pytest.mark.parametrize("name", list(SHAPES))
def test_3xtf32_attention_within_a_tenth_of_the_f32_tolerance(name):
    q, k, v = _inputs(SHAPES[name])
    want = reference(q, k, v)
    got = attention(q, k, v, mm_3xtf32)
    err = float(np.abs(got - want).max())
    assert _within(got, want, TOL / 10), err


@pytest.mark.parametrize("name", list(SHAPES))
def test_one_tf32_pass_misses_the_f32_tolerance(name):
    q, k, v = _inputs(SHAPES[name])
    want = reference(q, k, v)
    got = attention(q, k, v, mm_tf32)
    assert not _within(got, want, TOL), float(np.abs(got - want).max())
