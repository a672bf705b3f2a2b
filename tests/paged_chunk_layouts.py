"""The row-invariance case of the paged prefill tests, shared by the CPU
parity test (tests/test_torch_paged_prefill.py) and the card test
(tests/test_torch_cuda.py): one 100-token prompt (positions 0..99) as
one chunk and cut into chunks at CHUNKINGS' points, mid-block at BS 16,
beside two other requests' segments, a 20-token chunk at offset 37 and
a decode token at 50. Numpy only, so the card test needs no JAX."""
import numpy as np

CHUNKINGS = {"one chunk": (0, 100), "two chunks": (0, 45, 100),
             "three chunks": (0, 13, 71, 100)}


def chunk_layout(cuts, H, D, tq=32, seed=20):
    """A flat tq-padded batch of [other chunk, the prompt's chunks
    cuts[i]..cuts[i + 1] with the decode token after the first], every
    chunk of the prompt over the prompt's table row (MAXB 8 of 64 pool
    blocks): (q, tab, seg, pos, klen, rows) as numpy, `rows` indexing the
    prompt's 100 real rows in position order."""
    r = np.random.RandomState(seed)
    qp = r.randn(100 + tq, H, D).astype(np.float32)   # the prompt's q
    qo = r.randn(2, 32 + tq, H, D).astype(np.float32)
    # (offset, tokens, q rows, table row); table row 0 is the prompt's
    segs = [(37, 20, qo[0], 1)]
    for i in range(len(cuts) - 1):
        a, b = cuts[i], cuts[i + 1]
        segs.append((a, b - a, qp[a:], 0))
        if i == 0:
            segs.append((50, 1, qo[1], 2))
    qs, seg, pos, klen, rows, t = [], [], [], [], [], 0
    for s, (off, n, src, trow) in enumerate(segs):
        pad = -(-n // tq) * tq
        qs.append(src[:pad])
        seg += [s] * pad
        pos += list(range(off, off + pad))
        klen.append(off + n)
        if trow == 0:
            rows += list(range(t, t + n))
        t += pad
    tab = r.permutation(64)[:3 * 8].reshape(3, 8)[[x[3] for x in segs]]
    return (np.concatenate(qs), *(np.asarray(a, np.int32)
                                  for a in (tab, seg, pos, klen)),
            np.asarray(rows))
