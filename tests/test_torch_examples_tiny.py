"""Port parity, `repro_torch.examples.train_tiny` against the
reference's `examples/train_tiny.py` (loaded by path), on the CPU:
TINY_100M is the same config; at its full width (12 layers, d 768, 32k
vocab) its first 2 steps, cut from batch 4 x 256 tokens to 2 x 32 to
stay inside the file's time budget, from the reference's weights
(PRNGKey(0), as its `train` draws them), give the losses the reference
gives at the train tolerance of tests/test_torch_train.py (atol = rtol =
1e-4); and its checkpoint is the reference's format, read back by the
reference's own `checkpoint.load`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.training import checkpoint as jckpt
from repro_torch.examples import train_tiny
from repro_torch.weights import from_jax_params
from torch_parity import flat, ref_example
from torch_parity import two_threads  # noqa: F401 (a fixture)

# every test here on two intra-op threads (`two_threads`)
pytestmark = pytest.mark.usefixtures("two_threads")
TOL = dict(atol=1e-4, rtol=1e-4)


def test_train_tiny_first_steps_match_reference(tmp_path):
    ref = ref_example("train_tiny")
    assert dataclasses.asdict(ref.TINY_100M) == \
        dataclasses.asdict(train_tiny.TINY_100M)
    from repro.training.data import DataConfig as JData
    from repro.training.train_loop import train as jtrain
    jres = jtrain(ref.TINY_100M, steps=2, dc=JData(batch_size=2, seq_len=32),
                  log_every=20, verbose=False)
    like = jbuild(ref.TINY_100M).init(jax.random.PRNGKey(0))
    params = from_jax_params(flat(like), train_tiny.TINY_100M, "cpu")
    ckpt = tmp_path / "ckpt"
    tres = train_tiny.run(steps=2, batch=2, seq=32, ckpt=str(ckpt),
                          device="cpu", params=params, verbose=False)
    np.testing.assert_allclose(tres.losses, jres.losses, **TOL)
    # the reference reads the port's checkpoint
    tree, meta = jckpt.load(str(ckpt), {"params": like})
    assert meta["step"] == 2
    assert tree["params"]["layers"]["attn"]["wq"].shape == \
        like["layers"]["attn"]["wq"].shape
