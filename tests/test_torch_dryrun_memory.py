"""The dry run's memory model is the plan the card runs
(`repro_torch.launch.dryrun`, 16x16 placeholder mesh, granite-3-2b smoke
in f32 at test-only shapes):

* attention is the card's flash kernels (`dtensor_forms.
  counted_attention`): no Sq x Skv score block, so a prefill's and a
  train step's `temp_size` are affine in S; its FLOPs are the plain
  tiled attention's, counted; what it saves is what `_Flash` saves, and
  its backward allocates what `flash_attention_bwd` does, by hand;
* FSDP weights are gathered layer by layer where each block uses them
  (`model.layer_weights`, `dtensor_forms.layer_weights`): a decode
  step's `temp_size` does not grow with the layers, and a train step
  adds one all-gather per sharded layer leaf in each forward and
  recompute and one reduce-scatter per leaf in each backward, counted
  from the specs.

Also: a step after a new process group in the same process (the CLI over
both meshes) gets no sharding spec cached on a destroyed group's mesh."""
import dataclasses

import pytest
import torch

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import flash_prefill
from repro_torch.kernels.ref import flash_attention_reference
from repro_torch.launch import dryrun, dtensor_forms, specs
from repro_torch.launch.mesh import make_production_mesh
from torch_parity import two_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

ARCH = "granite-3-2b"
AG = "_c10d_functional.all_gather_into_tensor"
RS = "_c10d_functional.reduce_scatter_tensor"


@pytest.fixture(scope="module")
def group():
    """The fake process group of the 16x16 mesh for this module (a test
    may replace it), destroyed after it."""
    import torch.distributed as dist
    make_production_mesh()
    yield
    dist.destroy_process_group()


def _record(monkeypatch, kind, S, B, n_layers=None, fsdp=None):
    """One record of the smoke config in f32 at a test-only shape (two
    microbatches in training); `fsdp` forces `specs.use_fsdp`."""
    name = f"{kind}_mem_test"
    monkeypatch.setitem(SHAPES, name, InputShape(name, S, B, kind))
    if fsdp is not None:
        monkeypatch.setattr(specs, "use_fsdp", lambda *a: fsdp)
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rec = dryrun.run_one(ARCH, name, False, microbatches=2, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    return rec


@pytest.mark.parametrize("kind,B", [("prefill", 16), ("train", 128)])
def test_temp_size_is_affine_in_the_sequence(group, monkeypatch, kind, B):
    """At S 128, 256 and 512 the peak grows by the same bytes per token
    from 256 to 512 as from 128 to 256: no Sq x Skv term is left (the
    plain attention's f32 score block was one). The train step's batch,
    4 rows a rank in each microbatch, puts its peak at the same point of
    the backward at every S (with 2 rows, a weight gradient's constant
    bytes set the peak at S 128)."""
    t = [_record(monkeypatch, kind, S, B)["memory"]["temp_size"]
         for S in (128, 256, 512)]
    assert t[0] < t[1] < t[2]
    assert t[2] - t[1] == 2 * (t[1] - t[0]), t


def _qkv(mesh, B, Sq, Skv, H, KV, D, grad):
    """Fake DTensors q (B, Sq, H, D), k, v (B, Skv, KV, D), batch over
    'data' and heads over 'model', as the model's attention gets them."""
    from torch.distributed.tensor import Shard, distribute_tensor
    pl = [Shard(0), Shard(2)]
    out = [distribute_tensor(torch.empty(B, S, n, D), mesh, pl)
           for S, n in ((Sq, H), (Skv, KV), (Skv, KV))]
    return [t.requires_grad_(grad) for t in out]


# (causal, Sq, Skv): self attention, and whisper's cross attention
CASES = [(True, 64, 64), (False, 64, 64), (False, 32, 96)]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("causal,Sq,Skv", CASES)
def test_flash_form_counts_the_plain_tiled_flops(group, causal, Sq, Skv,
                                                 grad):
    """`counted_attention` on DTensors (local q (2, Sq, 2, 16), k, v (2,
    Skv, 1, 16)) counts the FLOPs of `ref.flash_attention_reference`
    tiled at 32 on the same local shapes, under `_LocalCounter`, in the
    forward and (with `grad`) forward + backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = make_production_mesh()
    with FakeTensorMode():
        q, k, v = _qkv(mesh, 32, Sq, Skv, 32, 16, 16, grad)
        form = dryrun._LocalCounter()
        with dryrun._dtensor_fixes(form), form:
            out = dtensor_forms.counted_attention(
                form, flash_attention_reference, q, k, v, causal=causal)
            assert out.shape == q.shape and out.placements == q.placements
            if grad:
                out.to_local().backward(torch.empty_like(out.to_local()))
        ql, kl, vl = (torch.empty(t.to_local().shape, requires_grad=grad)
                      for t in (q, k, v))
        plain = dryrun._LocalCounter()
        with plain:
            o = flash_attention_reference(ql, kl, vl, causal=causal,
                                          q_chunk=32, kv_chunk=32)
            if grad:
                o.backward(torch.empty_like(o))
    F = 2 * 2 * Sq * Skv * 16                      # B H Sq Skv D, local
    assert plain.flops == (12 if grad else 4) * F
    assert form.flops == plain.flops


def test_flash_form_keeps_what_the_kernels_keep(monkeypatch):
    """One call, counted by hand (B 2, Sq 64, Skv 96, H 4, KV 2, D 32,
    f32): the form's forward allocates out (B Sq H D x 4 bytes) and lse
    (B H Sq x 4) and saves q, k, v, out, lse, as `_Flash` does (its
    kernel launch stood in for on the CPU: `_launch_fwd` allocating the
    same buffers); the backward allocates dq, dk, dv and delta (B H Sq x
    4), and after it the saved out and lse are gone. Its bytes accessed
    are each operand's once (delta twice)."""
    B, Sq, Skv, H, KV, D = 2, 64, 96, 4, 2, 32
    out_b, lse_b = B * Sq * H * D * 4, B * H * Sq * 4
    qkv_b = (B * Sq * H * D + 2 * B * Skv * KV * D) * 4
    q = torch.randn(B, Sq, H, D, requires_grad=True)
    k, v = (torch.randn(B, Skv, KV, D, requires_grad=True)
            for _ in range(2))

    def launch(q, k, v, causal, window, kv_len, q_offset, scale, keep_lse):
        return torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
    monkeypatch.setattr(flash_prefill, "_launch_fwd", launch)
    card = flash_prefill._Flash.apply(q, k, v, False, 0, 0, D ** -0.5)
    want = [(t.shape, t.dtype) for t in card.grad_fn.saved_tensors]

    c = dryrun._LocalCounter()
    dout = torch.randn(B, Sq, H, D)
    with c:
        out = dtensor_forms._CountedFlash.apply(c, q, k, v)
        assert c.live == c.peak == out_b + lse_b
        saved = out.grad_fn.saved_tensors
        assert [(t.shape, t.dtype) for t in saved] == want
        assert sum(t.numel() * t.element_size() for t in saved) == \
            qkv_b + out_b + lse_b
        assert all(a is b for a, b in zip(saved, (q, k, v)))
        del saved
        assert c.accessed == qkv_b + out_b + lse_b
        grads = torch.autograd.grad(out, (q, k, v), dout)
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        assert c.peak == out_b + lse_b + qkv_b + lse_b    # dq dk dv delta
        del out
        assert c.live == qkv_b                             # dq, dk, dv
    assert c.accessed == 2 * (qkv_b + out_b + lse_b) + out_b + qkv_b \
        + 2 * lse_b                                # + dout, dq dk dv, delta


def test_decode_temp_size_does_not_grow_with_the_layers(group, monkeypatch):
    """FSDP forced on a decode step: each layer's weights are gathered
    where its block uses them and freed after it, so 2 and 4 layers peak
    at the same bytes (gathering every layer up front added two layers'
    gathered weights)."""
    t = [_record(monkeypatch, "decode", 128, 16, n_layers=L,
                 fsdp=True)["memory"]["temp_size"] for L in (2, 4)]
    assert t[0] == t[1] > 0


def test_train_step_gathers_each_layer_on_use(group, monkeypatch):
    """A train step (2 microbatches, each layer's block checkpointed)
    with FSDP against the same step without it: the gathered weights are
    the unsharded ones, so every other collective is the same, and FSDP
    adds, counted from the specs, one all-gather per data-sharded layer
    leaf per layer in each forward and each recompute of each
    microbatch, one per leaf outside the layer stacks (once for the
    step), and one reduce-scatter per layer leaf per layer and
    microbatch (its gradient) and per leaf outside the stacks (once).
    One more: DTensor leaves the gradient of the attention's output
    projection `wo` (heads padded to 16) as partial sums over 'model'
    too, which the step without FSDP reduce-scatters once, stacked, at
    the end, and the per-layer gradient reduces at each use."""
    fsdp = _record(monkeypatch, "train", 64, 64, fsdp=True)
    plain = _record(monkeypatch, "train", 64, 64, fsdp=False)
    cfg = specs.tp_config(dataclasses.replace(get_smoke_config(ARCH),
                                              dtype="float32"),
                          make_production_mesh())
    _, p = specs.params_struct(cfg)
    shard = specs.param_shardings(make_production_mesh(), p, fsdp=True)

    def data_sharded(spec):
        return any(e == "data" or (isinstance(e, tuple) and "data" in e)
                   for e in spec)
    layer = sum(data_sharded(shard[n]) for n in p
                if n.split("/")[0] in specs.LAYER_STACKS)
    top = sum(data_sharded(shard[n]) for n in p
              if n.split("/")[0] not in specs.LAYER_STACKS)
    assert layer > 0 and top > 0
    L, mb = cfg.n_layers, 2
    got, base = (r["collectives"]["counts"] for r in (fsdp, plain))
    assert got[AG] - base.get(AG, 0) == layer * L * 2 * mb + top
    wo = 1
    assert got[RS] - base.get(RS, 0) == (layer + wo) * L * mb + top - wo
    assert fsdp["flops"] == plain["flops"]


def test_a_stack_sharded_on_its_layer_axis_is_gathered_along_it(group):
    """`dtensor_forms.gather_stack_axes`: a (32, 4096) stack whose layer
    axis FSDP shards over 'data' (codeqwen1.5-7b's biases in training)
    is gathered along that axis before the per-layer views, its 'model'
    shards kept, and the record notes it; a stack sharded elsewhere
    passes as it is."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dtensor_forms.clear_notes()
    mesh = make_production_mesh()
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(32, 4096), mesh,
                              [Shard(0), Shard(1)])
        y = dtensor_forms.gather_stack_axes(x, 1, "layers/attn/bq")
        assert y.placements == (Replicate(), Shard(1))
        z = distribute_tensor(torch.empty(32, 4096), mesh,
                              [Shard(1), Replicate()])
        assert dtensor_forms.gather_stack_axes(z, 1, "layers/w") is z
    assert any("layers/attn/bq" in n for n in dtensor_forms.notes())
    dtensor_forms.clear_notes()


def test_a_new_process_group_starts_with_empty_sharding_caches(
        group, monkeypatch):
    """One process, two process groups (the dry run's CLI over both
    meshes; test modules that each start one): DTensor caches an op's
    output spec on the mesh it ran on, and that mesh compares equal to
    the same layout on a later group. A step after a new group must not
    get a cached spec whose mesh names a destroyed group
    (`mesh._clear_sharding_caches`). The earlier group's meshes are
    made past the later group's names first, so a stale name cannot
    resolve by chance."""
    import torch.distributed as dist
    for _ in range(4):
        make_production_mesh()
    _record(monkeypatch, "decode", 128, 16)
    dist.destroy_process_group()
    make_production_mesh()
    assert _record(monkeypatch, "decode", 128, 16)["ok"]
