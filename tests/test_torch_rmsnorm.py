"""Port parity, RMSNorm: the port's `rmsnorm` (what a CPU tensor runs: the
CUDA kernel's plain version, reached through `models.layers.rmsnorm` ->
`kernels.ops.rmsnorm`) against the TPU kernel `rmsnorm_pallas` in
interpret mode and the reference's `layers.rmsnorm`, and its gradient
(autograd through the plain version — the backward kernel's plain
version) against `jax.vjp` of the reference norm. Same numpy-seeded
inputs on both sides, on the shapes of tests/test_kernels.py.

Tolerances: forward f32 atol = rtol = 1e-5 and bf16 2e-2, those of
tests/test_kernels.py for the Pallas kernel; gradients f32 atol = rtol =
1e-5 (a mean over d <= 512 and a sum over <= 99 rows, in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)
SHAPES = [(4, 128), (2, 7, 256), (3, 33, 512)]


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    w = (r.randn(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rmsnorm_matches_pallas_and_reference(shape, dtype, tol):
    x, w = _inputs(shape)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    out = tlayers.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype
    got = out.float().numpy()
    for want in (rmsnorm_pallas(jx, jw, block_rows=8),
                 jlayers.rmsnorm(jx, jw)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # the wrapper's CPU path is its plain version, bit for bit
    assert torch.equal(out, trms.rmsnorm_plain(tx, tw))


@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_grad_matches_jax(shape):
    x, w = _inputs(shape, seed=1)
    dy = np.random.RandomState(2).randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tlayers.rmsnorm(tx, tw).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)
