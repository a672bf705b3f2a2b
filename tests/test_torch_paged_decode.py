"""Port parity, paged decode split over the context: the plain version of
the split kernel's algorithm (`paged_attention_split_plain`: per-split f32
partials (m, l, acc) over SPLIT-token pieces, an empty split with m = -inf
and l = 0, combined in split order) against the JAX oracle
`repro.kernels.ref.paged_attention_reference` at the split's edges, for G
in {1, 4} and D in {32, 64, 128}. A row at kv_len = 0 is compared with the
Pallas kernel `paged_attention_pallas` in interpret mode, which writes 0
there (the oracle's fully masked softmax averages V instead). Inputs are
made with numpy from a seed and handed to both sides; f32 atol = rtol =
2e-5, the repo's Pallas-vs-reference tolerance.

The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
SPLIT = pa.SPLIT
BS = 16


def _case(kv, G, D, seed):
    """Two rows: the kv_len under test and a two-split row (300); tables
    from a permutation of the pool's blocks."""
    r = np.random.RandomState(seed)
    KV = 2
    lens = np.asarray([kv, 300], np.int32)
    maxb = -(-max(kv, 300) // BS)
    maxb = -(-maxb // 8) * 8
    nb = 2 * maxb
    pool = r.randn(nb, BS, 2, KV, D).astype(np.float32)
    tab = r.permutation(nb).reshape(2, maxb).astype(np.int32)
    q = r.randn(2, KV * G, D).astype(np.float32)
    return q, pool, tab, lens


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("kv", [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 4096])
def test_split_plain_matches_jax(kv, G, D):
    q, pool, tab, lens = _case(kv, G, D, seed=kv + 7 * G + D)
    got = pa.paged_attention_split_plain(
        *[torch.from_numpy(a) for a in (q, pool, tab, lens)]).numpy()
    want = np.asarray(jref.paged_attention_reference(
        *[jnp.asarray(a) for a in (q, pool, tab, lens)]))
    assert np.all(np.isfinite(got))
    if kv:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got[1:], want[1:], **TOL)
        pallas = np.asarray(paged_attention_pallas(
            *[jnp.asarray(a) for a in (q[:1], pool, tab[:1, :1], lens[:1])]))
        assert not pallas.any()
        np.testing.assert_array_equal(got[:1], pallas)
