"""The dry run's decode-step form of the SSD recurrence and its count of a
collective's result (`repro_torch.launch.dtensor_forms.ssd_step`,
`repro_torch.launch.dryrun._LocalCounter`), on fake process groups:

* `ssd_step` (Mamba2's one-token state update and output, which
  `ssm.mamba_decode` calls) on a (2, 2) ('data', 'model') mesh of four
  fake ranks, the state's batch and heads both sharded: each rank's
  block of the new state and of y equals the plain step's block at f32
  atol = rtol = 2e-5 (zamba2-2.7b smoke's N and P and its one group; an
  even and an uneven batch), computed on each rank's own block with no
  collective; a state sharded on N, or two groups, fall back to the
  plain body, say so in `notes` and keep its values (a one-rank gloo
  mesh, where a DTensor's whole tensor is real);
* a gather's result is held once: a fake `wait_tensor` hands back the
  tensor it was given, as on a card, so an all-gather's `temp_size` is
  its output's bytes, counted by hand.

No JAX: the file also runs on the card machine's torch."""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, dtensor_forms
from repro_torch.launch.mesh import _clear_sharding_caches, \
    make_production_mesh
from repro_torch.models import ssm
from repro_torch.models.act_sharding import forms

AG = "_c10d_functional.all_gather_into_tensor"


@pytest.fixture(autouse=True)
def no_group_after():
    """No process group outlives a test."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake_mesh(rank: int, world: int = 4):
    """A (2, 2) ('data', 'model') mesh on a fake process group, seen from
    `rank`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    _clear_sharding_caches()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                      mesh_dim_names=("data", "model"))


def _step_inputs(B, H, G, seed=0):
    """state (B, H, N, P), dec, dt (B, H), x (B, H, P) and Bm, Cm (B, G,
    N) in f32 at zamba2-2.7b smoke's N and P, from a seed."""
    _, _, P, N, _ = ssm.mamba_dims(get_smoke_config("zamba2-2.7b"))
    rng = np.random.default_rng(seed)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    return (t(B, H, N, P), t(B, H, lo=0.5, hi=1.0), t(B, H, lo=0.0, hi=0.2),
            t(B, H, P), t(B, G, N), t(B, G, N))


def _block(t, coords, groups=True):
    """Rank `coords` = (data, model)'s block of t, as DTensor's Shard(0)
    on 'data' and (`groups`) Shard(1) on 'model' cut it."""
    t = t.chunk(2, dim=0)[coords[0]]
    return t.chunk(2, dim=1)[coords[1]] if groups else t


@pytest.mark.parametrize("B,H", [(4, 4), (3, 6), (2, 8), (5, 2)])
@pytest.mark.parametrize("rank", range(4))
def test_ssd_step_form_equals_the_plain_step(rank, B, H):
    """Each rank's block of the form's new state and y equals the plain
    step's, with the batch over 'data' and the heads over 'model' (an
    uneven batch at B 3 and 5; one head a rank at H 2); B comes in with
    its rows over 'data' and C as a plain tensor (replicated), each cut
    where it lies to the rank's rows, its one group whole. The form
    makes no collective and keeps the state's placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    ins = _step_inputs(B, H, 1)
    want_s, want_y = ssm.ssd_step(*ins)
    mesh = _fake_mesh(rank)
    coords = (rank // 2, rank % 2)
    both = (Shard(0), Shard(1))

    def sharded(t, pl=both):
        return DTensor.from_local(_block(t, coords, pl == both), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    state, dec, dt, x, Bm, Cm = ins
    args = (*(sharded(t) for t in (state, dec, dt, x)),
            sharded(Bm, (Shard(0), Replicate())), Cm)
    dtensor_forms.clear_notes()
    with forms(dtensor_forms.FORMS), CommDebugMode() as comm:
        s, y = ssm.ssd_step(*args)
    assert comm.get_total_counts() == 0
    assert dtensor_forms.notes() == []
    for got, want in ((s, want_s), (y, want_y)):
        assert isinstance(got, DTensor) and got.placements == both
        assert got.shape == want.shape
        torch.testing.assert_close(got.to_local(), _block(want, coords),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("state_at,G", [((Replicate(), Shard(2)), 1),
                                        ((Shard(0), Replicate()), 2)],
                         ids=["state-sharded-on-n", "two-groups"])
def test_ssd_step_form_falls_back_where_the_state_is_sharded_on_n(
        state_at, G):
    """A state sharded on N over 'model' is not a (b, h) block, and two
    groups are more than the form's one: the form runs the plain body on
    the DTensors, leaves a line in `notes`, and keeps the plain step's
    values (f32 atol = rtol = 2e-5). A one-rank gloo mesh, so the
    outputs' whole tensors are real."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    _clear_sharding_caches()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    ins = _step_inputs(4, 4, G)
    want_s, want_y = ssm.ssd_step(*ins)
    state, *rest = ins
    dtensor_forms.clear_notes()
    with forms(dtensor_forms.FORMS), implicit_replication():
        s, y = ssm.ssd_step(distribute_tensor(state, mesh, state_at), *rest)
    assert [n for n in dtensor_forms.notes()
            if n.startswith("SSD decode step")]
    for got, want in ((s, want_s), (y, want_y)):
        torch.testing.assert_close(got.full_tensor(), want,
                                   atol=2e-5, rtol=2e-5)


def test_a_gather_is_held_once():
    """An all-gather over 'data' of a (256, 64) f32 tensor sharded 16
    rows a rank on the 16x16 fake mesh, then a sum over its result: the
    peak of the live bytes is the gathered tensor, 256 x 64 x 4 bytes,
    and the 4-byte sum; the fake `wait_tensor` hands back its input, as
    on a card (its meta kernel's copy would double the peak)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_production_mesh()
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 64), mesh,
                              (Shard(0), Replicate()))
        c = dryrun._LocalCounter()
        with dryrun._dtensor_fixes(c), c:
            y = x.redistribute(mesh, (Replicate(), Replicate()))
            total = y.to_local().sum()
        assert total.shape == ()
    assert c.counts == {AG: 1} and c.bytes == {AG: 256 * 64 * 4}
    assert c.peak == 256 * 64 * 4 + 4
