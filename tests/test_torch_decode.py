"""Port parity, dense-cache decode (ROADMAP A4a): `ops.decode_attention`
and `DecoderModel.decode` / `kv_quant` against the JAX package, on the
smoke configs in f32 with the reference's weights handed over.

Tolerances (f32): `decode_attention` atol = rtol = 2e-5 (the repo's
Pallas-vs-reference tolerance); logits and caches atol = rtol = 1e-4
(tests/test_torch_model.py's prefill tolerance). The int8 codes may
differ by 1 where the scaled value sits at a rounding tie (both round
half to even; the f32 inputs differ in their last bits); scales and
logits hold at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.models.model import decode_slots

from torch_parity import close, models, randn, tokens

torch.set_num_threads(2)
TOL = 1e-4


@pytest.mark.parametrize("H,KV,D", [(4, 4, 32), (8, 2, 64), (28, 4, 128)])
def test_decode_attention_matches_reference(H, KV, D):
    B, S = 3, 40
    q = randn((B, 1, H, D), 0)
    k, v = randn((B, S, KV, D), 1), randn((B, S, KV, D), 2)
    kv_len = np.array([1, 17, 40], np.int32)
    want = jref.decode_attention_reference(*(jnp.asarray(a) for a in
                                             (q, k, v, kv_len)))
    got = ops.decode_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, kv_len)))
    close(got, want, 2e-5, 2e-5)


def _run(arch, B, S, N, cache_len, prompt_len=None, seed=0, **kw):
    """Prefill S tokens (optionally ragged by prompt_len) then N decodes
    on both packages; yields (step, port logits, JAX logits) and returns
    the final caches."""
    jcfg, jm, jp, tm = models(arch, seed=seed, **kw)
    toks = tokens(jcfg.vocab_size, (B, S + N), seed + 1)
    batch = {"tokens": toks[:, :S]}
    if prompt_len is not None:
        batch["prompt_len"] = np.asarray(prompt_len, np.int32)
    moe = dict(dropless=True) if jcfg.family == "moe" else {}
    prefill = jax.jit(functools.partial(jm.prefill, **moe))
    decode = jax.jit(jm.decode)
    jlog, jc = prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jm.init_cache(B, cache_len))
    tlog, tc = tm.prefill({k: torch.from_numpy(v).long() if k == "tokens"
                           else torch.from_numpy(v)
                           for k, v in batch.items()},
                          tm.init_cache(B, cache_len), **moe)
    steps = [(tlog, jlog)]
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        steps.append((tlog, jlog))
    return steps, tc, jc


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_prefill_then_decode_matches_jax(arch):
    """Ragged prompts (the valid prefix by prompt_len), then 4 decode
    steps: logits at every step, the cache and its length (MoE decodes
    dropless, as the reference's block_decode)."""
    steps, tc, jc = _run(arch, B=2, S=24, N=4, cache_len=32,
                         prompt_len=(17, 24))
    for i, (t, j) in enumerate(steps):
        close(t, j, TOL, TOL, f"step {i}")
        np.testing.assert_array_equal(t.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(j, -1)))
    for name in ("k", "v"):
        close(tc[name], jc[name], TOL, TOL, name)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["window"] == int(jc["window"])


def test_ring_buffer_matches_jax_layout():
    """sliding_window 16, a 24-token prompt into a 16-slot ring: the
    reference keeps positions 8..23 in slots 0..15, then decodes into
    slot cur % 16 = 8, overwriting position 16 while position 8 stays
    (ROADMAP C8). The port keeps that layout: logits and every slot
    match, and the slots the first decode leaves alone are unchanged."""
    jcfg, jm, jp, tm = models("granite-3-2b", sliding_window=16)
    B, S, N = 1, 24, 8
    toks = tokens(jcfg.vocab_size, (B, S + N), 3)
    jc = jm.init_cache(B, 16)
    tc = tm.init_cache(B, 16)
    assert tc["window"] == int(jc["window"]) == 16
    decode = jax.jit(jm.decode)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   jc)
    tlog, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                          tc)
    close(tlog, jlog, TOL, TOL)
    write_idx, kv_len = decode_slots(tc)
    assert write_idx.tolist() == [8] and kv_len.tolist() == [16]
    before = tc["k"].clone()
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
        if i == S:
            changed = (tc["k"] != before).flatten(3).any(-1)[:, 0]
            assert changed.any(0).nonzero().flatten().tolist() == [8]
    for name in ("k", "v"):
        close(tc[name], jc[name], TOL, TOL, name)
    assert tc["len"].tolist() == [S + N]


def _assert_codes_close(tc, jc):
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8
        diff = np.abs(tc[name].numpy().astype(np.int32)
                      - np.asarray(jc[name]).astype(np.int32))
        assert diff.max() <= 1, name
        assert (diff > 0).mean() < 1e-3, name
        assert tc[f"{name}_scale"].dtype == torch.bfloat16
        close(tc[f"{name}_scale"], np.asarray(jc[f"{name}_scale"],
                                              np.float32), TOL, TOL, name)


def test_int8_kv_cache_matches_jax():
    """codeqwen1.5-7b smoke with kv_quant. Prefill: the int8 codes (at
    most 1 apart, at rounding ties), the bf16 scales and the logits
    against the reference's. Decode: from the reference's own prefill
    cache (so a tie flipped in prefill does not move the logits), 4
    steps of logits, then the codes and scales again. And, as the
    reference's test_int8_kv_cache_decode holds, within rel 5e-2 of the
    f32 cache with the same argmax."""
    jcfg, jm, jp, tm = models("codeqwen1.5-7b", kv_quant=True)
    B, S, N = 2, 24, 4
    toks = tokens(jcfg.vocab_size, (B, S + N), 1)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   jm.init_cache(B, 64))
    tlog, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                          tm.init_cache(B, 64))
    close(tlog, jlog, TOL, TOL)
    _assert_codes_close(tc, jc)
    for name in ("k", "v", "k_scale", "v_scale"):
        tc[name] = torch.from_numpy(np.asarray(jc[name]).astype(
            np.float32)).to(tc[name].dtype)
    decode = jax.jit(jm.decode)
    for i in range(S, S + N):
        jlog, jc = decode(jp, jnp.asarray(toks[:, i]), jc)
        tlog, tc = tm.decode(torch.from_numpy(toks[:, i]).long(), tc)
        close(tlog, jlog, TOL, TOL, f"decode {i}")
    _assert_codes_close(tc, jc)
    steps, _, _ = _run("codeqwen1.5-7b", B=B, S=S, N=N, cache_len=64)
    lf = steps[-1][0]
    rel = float((tlog - lf).abs().max() / lf.abs().max())
    assert rel < 5e-2
    assert torch.equal(tlog.argmax(-1), lf.argmax(-1))


def test_quantize_rounds_half_to_even_like_jnp():
    from repro_torch.models.model import dequantize, quantize
    x = np.array([[0.5, 1.5, 2.5, -2.5, 127.0, 3.25]], np.float32)
    codes, scale = quantize(torch.from_numpy(x))
    assert codes.tolist() == [[0, 2, 2, -2, 127, 3]]
    assert scale.dtype == torch.bfloat16 and float(scale) == 1.0
    assert torch.equal(dequantize(codes, scale, torch.float32),
                       codes.float())
    zero, s0 = quantize(torch.zeros(1, 4))
    assert zero.abs().sum() == 0 and float(s0) > 0
