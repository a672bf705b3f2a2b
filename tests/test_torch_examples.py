"""Port parity, the examples: `repro_torch.examples.quickstart` against
the reference's `examples/quickstart.py`, loaded by path, with the
reference's weights handed over by `weights.from_jax_params`, on the CPU
in f32: the training losses at the train tolerance of
tests/test_torch_train.py (atol = rtol = 1e-4), over 12 of the
example's 60 steps (the cut keeps the file inside its time budget; the
example's own batch, sequence and 60-step schedule); the served tokens
exactly, on the example's own workload (6 requests of 32 prompt tokens,
8 out, a 24-block pool), r0's stream included.

serve_comparison is held in tests/test_torch_examples_serve.py,
train_tiny in tests/test_torch_examples_tiny.py; `ref_example` and the
weight helpers live in tests/torch_parity.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart
from repro_torch.weights import from_jax_params
from torch_parity import flat, jax_flat_params, ref_example
from torch_parity import two_threads  # noqa: F401 (a fixture)

# every test here on two intra-op threads (`two_threads`)
pytestmark = pytest.mark.usefixtures("two_threads")
TOL = dict(atol=1e-4, rtol=1e-4)


def test_quickstart_training_losses_match_reference():
    """The reference example's `train` call (its 60-step schedule) and the
    port's `train_part`, both cut to their first 12 steps, from the same
    weights (the reference's PRNGKey(0) init)."""
    from repro.training.optimizer import AdamWConfig as JAdamW
    ref = ref_example("quickstart")
    jcfg = dataclasses.replace(ref.get_smoke_config("granite-3-2b"),
                               dtype="float32")
    steps = 12
    jres = ref.train(jcfg, steps=steps,
                     dc=ref.DataConfig(batch_size=8, seq_len=64),
                     opt=JAdamW(lr=1e-3, total_steps=60, warmup_steps=6),
                     log_every=20, verbose=False)
    cfg = quickstart.config()
    assert quickstart.SCHEDULE.total_steps == 60 and \
        quickstart.SCHEDULE.warmup_steps == 6
    tres = quickstart.train_part(
        cfg, device="cpu", steps=steps, verbose=False,
        params=from_jax_params(jax_flat_params(jcfg, 0), cfg, "cpu"))
    np.testing.assert_allclose(tres.losses, jres.losses, **TOL)


def test_quickstart_serving_tokens_match_reference():
    """The reference example's serving half, as its main runs it, and the
    port's `serve_part` on the same weights: every token equal, r0's
    stream equal to its output."""
    ref = ref_example("quickstart")
    jcfg = dataclasses.replace(ref.get_smoke_config("granite-3-2b"),
                               dtype="float32")
    rng = np.random.RandomState(0)
    eng = ref.LayerKVEngine(jcfg, None,
                            ref.ServeConfig.for_engine(policy="layerkv",
                                                       num_device_blocks=24,
                                                       num_host_blocks=256,
                                                       block_size=8),
                            rng=jax.random.PRNGKey(0))
    session = ref.ServingSession(eng)
    handles = [
        session.submit(ref.Request(rid=f"r{i}", prompt_len=32, output_len=8,
                                   prompt=[int(t) for t in rng.randint(
                                       0, jcfg.vocab_size, 32)]),
                       arrival=i * 0.01)
        for i in range(6)]
    jstream = list(session.stream(handles[0]))
    jdone = {r.rid: r.generated for r in session.drain()}
    jlog = [t.kind for t in eng.off.ledger.log]

    cfg = quickstart.config()
    params = from_jax_params(flat(eng.ex.params), cfg, "cpu")
    teng, tdone, tstream = quickstart.serve_part(cfg, device="cpu",
                                                 params=params,
                                                 verbose=False)
    assert {r.rid: r.generated for r in tdone} == jdone
    assert tstream == jstream == jdone["r0"]
    assert quickstart.transfers(teng) == (jlog.count("offload"),
                                          jlog.count("reload"))
