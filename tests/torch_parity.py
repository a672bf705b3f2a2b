"""Helpers shared by the port's Model-API parity tests
(tests/test_torch_{decode,vlm,encdec,hybrid,ssm}.py) and its examples'
(tests/test_torch_examples*.py): both packages' smoke configs in f32,
the reference's params from `build_model(cfg).init(PRNGKey(k))` handed
to the port by `repro_torch.weights.from_jax_params`, seeded numpy
inputs converted for each side, and the reference's example files. Also
the 3xTF32 arithmetic of the port's f32 attention kernels in numpy
(`tf32`, `split`, `mm_3xtf32`, `mm_tf32`), which
tests/test_torch_{flash,paged_prefill}_tf32.py emulate."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.weights import from_jax_params


@pytest.fixture
def two_threads():
    """Two intra-op threads for one test (the examples' and the dry run's
    products oversubscribe a CPU shared by the test workers otherwise),
    restored after it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cfgs(arch, **kw):
    """(reference config, port config), smoke, f32, with `kw` replaced."""
    return (dataclasses.replace(jax_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                **kw))


def flat(tree, prefix=""):
    """A pytree as {'layers/attn/wq': numpy array, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_flat_params(jcfg, seed):
    """The reference's params for `jcfg` from PRNGKey(seed), flat."""
    return flat(jax_build(jcfg).init(jax.random.PRNGKey(seed)))


def ref_example(name):
    """The reference's `examples/<name>.py`, loaded by path as a module."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def models(arch, seed=0, **kw):
    """(jcfg, JAX model, its params, port model on the CPU with the same
    weights)."""
    jcfg, tcfg = cfgs(arch, **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, from_jax_params(flat(jp), tcfg, "cpu"),
                     device="cpu")
    return jcfg, jm, jp, tm


def tf32(x):
    """f32 rounded to TF32, to nearest with ties away from zero
    (`cvt.rna.tf32.f32`: TF32 keeps 10 of f32's 23 mantissa bits): adding
    half of TF32's last place to the bit pattern carries into the kept
    bits exactly when the dropped 13 bits are at least half."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """x as its TF32 pair (hi, lo): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x.astype(np.float32) - hi)


def mm_3xtf32(a, b):
    """a @ b (f32, batched) as the kernels take it: hi.hi + hi.lo + lo.hi,
    each an f32-accumulated product of TF32 values, the small terms
    first."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float32
    return (al @ bh).astype(f) + (ah @ bl).astype(f) + (ah @ bh).astype(f)


def mm_tf32(a, b):
    """a @ b with one TF32 pass."""
    return (tf32(a) @ tf32(b)).astype(np.float32)


def randn(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def tokens(vocab, shape, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    """int arrays become int64 (the port's index dtype), floats stay."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v)
            for k, v in batch.items()}


def close(t, j, atol, rtol, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def grad_close(got, want, name=""):
    """One gradient at tests/test_torch_train.py's rule: atol = 1e-5 *
    max |want|, rtol 1e-4."""
    w = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), w, rtol=1e-4,
        atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=name)


def assert_grads_close(tm, jgrads):
    """Every parameter's gradient at tests/test_torch_train.py's rule:
    atol = 1e-5 * max |grad of that parameter|, rtol 1e-4. Two kinds of
    leaf differ: one the loss does not reach has no port gradient and a
    zero JAX one; one whose JAX gradient lies wholly below 1e-5 * the
    largest gradient of the model holds rounding noise only (whisper's
    key biases: without rope a key bias adds one constant to every score
    of a softmax row, so its gradient is zero in exact arithmetic), and
    each side is held below that bound."""
    from repro_torch.models.model import flatten_params
    got = flatten_params(tm.params)
    want = flat(jgrads)
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, p in got.items():
        w = want[key]
        if p.grad is None:
            assert not np.any(w), key
            continue
        if float(np.abs(w).max()) < 1e-5 * top:
            for g in (p.grad.numpy(), w):
                assert float(np.abs(g).max()) <= 1e-5 * top, key
            continue
        atol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=atol, rtol=1e-4,
                                   err_msg=key)


def assert_train_path_matches_jax(arch, steps=5, B=2, S=32):
    """`steps` AdamW steps of the port's `train_loop.train` against the
    reference's jitted train step (`make_train_step`, the same optimizer
    defaults as its `train`), from the same weights on the same synthetic
    stream: each step's loss at atol = rtol = 1e-4
    (tests/test_torch_train.py's) and its gradient norm, before clipping,
    at rtol 1e-4. Returns the two gradient-norm paths."""
    from repro.training.data import DataConfig as JDC
    from repro.training.data import SyntheticLM
    from repro.training.optimizer import AdamWConfig, init_opt_state
    from repro.training.train_loop import make_train_step
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import train
    jcfg, tcfg = cfgs(arch)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    got = train(tcfg, steps=steps, dc=DataConfig(batch_size=B, seq_len=S),
                device="cpu", params=from_jax_params(flat(jp), tcfg, "cpu"),
                verbose=False)
    opt = AdamWConfig(lr=1e-3, total_steps=steps,
                      warmup_steps=max(steps // 10, 5))
    step = make_train_step(jcfg, opt, donate=False)
    state, data = init_opt_state(jp), SyntheticLM(
        jcfg, JDC(batch_size=B, seq_len=S)).batches()
    losses, norms = [], []
    for _ in range(steps):
        jp, state, metrics = step(jp, state, next(data))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    np.testing.assert_allclose(got.losses, losses, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.grad_norms, norms, rtol=1e-4)
    return got.grad_norms, norms
