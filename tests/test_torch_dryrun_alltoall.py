"""The dry run counts a shard-to-shard move as the all-to-all a card makes
(`repro_torch.launch.dryrun._dtensor_fixes`): on a CPU mesh DTensor
moves a tensor from Shard(i) to Shard(j) on one mesh dim
(`shard_dim_alltoall`) by an all-gather of every rank's shard and a
chunk; NCCL's all-to-all on a card holds the output shard only.

* on the 16x16 fake mesh, a Shard(2) -> Shard(1) move over 'model' of a
  (4, 64, 320) f32 tensor counts its output shard (4, 4, 320) live and
  one all-to-all of its 20,480 bytes, in the counter and in
  CommDebugMode, and no all-gather;
* Mamba2's gated norm (`layers.rmsnorm(y * F.silu(z), w)`, as
  `ssm.mamba_forward` calls it) on channel-sharded operands whose
  gradient comes back sequence-sharded, as zamba2-2.7b's train step
  runs it: each shard-to-shard move DTensor makes there (how many
  depends on the torch release's plan) is one all-to-all of one shard
  in place of an all-gather, no allocation holds more than one shard,
  where the CPU mesh's move holds a 16-shard buffer, and the peak is
  no higher;
* on four real processes (`gloo`) the counted move's values equal the
  plain redistribution's and the whole tensor's.

No JAX: the file also runs on the card machine's torch."""
import socket

import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

A2A = dryrun.ALL_TO_ALL
WORLD = 4


@pytest.fixture(autouse=True)
def no_group_after():
    """No process group outlives a test."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,dim", [((4, 64, 320), 1),
                                       ((64, 4, 320), 0)])
def test_shard_to_shard_move_counts_one_all_to_all(shape, dim):
    """(4, 64, 320) f32, Shard(2) -> Shard(1) over 'model' (16 ranks), and
    (64, 4, 320) to Shard(0), whose shard the CPU mesh leaves as a view
    of its gathered buffer: the output shard (4, 4, 320), 20,480 bytes,
    is the step's only live allocation; one all-to-all of those bytes,
    read from the input shard and written once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = make_production_mesh()
    shard = 4 * 4 * 320 * 4
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(shape), mesh,
                              (Replicate(), Shard(2)))
        c, comm = dryrun._LocalCounter(), CommDebugMode()
        with dryrun._dtensor_fixes(c, comm), c, comm:
            y = x.redistribute(mesh, (Replicate(), Shard(dim)))
        assert y.to_local().shape == (4, 4, 320)
    assert c.counts == {A2A: 1} and c.bytes == {A2A: shard}
    assert c.peak == c.live == shard
    assert c.accessed == 2 * shard
    assert {str(k): v for k, v in comm.get_comm_counts().items()} == \
        {"c10d_functional.all_to_all_single": 1}


def _gated_norm_step(card_move: bool):
    """Mamba2's gated norm on (32, 256, 320) f32 operands sharded by batch
    over 'data' and channel over 'model', its output constrained and its
    gradient given by sequence over 'model' (the train step's activation
    spec), forward and backward under the dry run's counter; with
    `card_move` False the shard-to-shard moves run counted as the CPU
    mesh makes them (an all-gather and a chunk), and the counter's
    `move_peak` is the highest peak reached inside one of them."""
    import torch.distributed.tensor._collective_utils as coll_utils
    import torch.distributed.tensor.placement_types as ptypes
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers
    mesh = make_production_mesh()
    B, S, C = 32, 256, 320
    cpu_move = {m: m.shard_dim_alltoall for m in (coll_utils, ptypes)
                if hasattr(m, "shard_dim_alltoall")}
    with FakeTensorMode():
        y, z = (distribute_tensor(torch.empty(B, S, C), mesh,
                                  (Shard(0), Shard(2))).requires_grad_()
                for _ in range(2))
        w = distribute_tensor(torch.empty(C), mesh, (Replicate(), Shard(0)))
        g = distribute_tensor(torch.empty(B, S, C), mesh,
                              (Shard(0), Shard(1)))
        c = dryrun._LocalCounter()
        c.move_peak = 0

        def cpu_move_noted(*args):
            before = c.peak
            out = cpu_move[coll_utils](*args)
            if c.peak > before:
                c.move_peak = c.peak
            return out
        with dryrun._dtensor_fixes(c), implicit_replication(), c:
            if not card_move:      # `_dtensor_fixes` restores its own
                for m in cpu_move:
                    m.shard_dim_alltoall = cpu_move_noted
            out = layers.rmsnorm(y * F.silu(z), w)
            out.redistribute(mesh, (Shard(0), Shard(1))).backward(g)
    return c


def test_gated_norm_backward_moves_shards_by_all_to_all():
    """The gated norm's forward and backward move operands between
    channels and positions over 'model': counted as a card makes them,
    each move is one all-to-all of a (2, 16, 320) f32 shard in place of
    one all-gather of 16 shards, and the step's peak is no higher than
    with the CPU mesh's moves, and lower where one of those set it (on
    torch 2.13 they do, as in zamba2-2.7b's train_4k record; torch 2.11
    plans fewer moves here and peaks elsewhere)."""
    card, cpu = _gated_norm_step(True), _gated_norm_step(False)
    AG = "_c10d_functional.all_gather_into_tensor"
    shard = 2 * 16 * 320 * 4
    n = card.counts[A2A]
    assert n > 0 and A2A not in cpu.counts
    assert card.bytes[A2A] == n * shard
    assert card.counts.get(AG, 0) == cpu.counts[AG] - n
    assert cpu.bytes[AG] - card.bytes.get(AG, 0) == 16 * n * shard
    if cpu.move_peak == cpu.peak:
        assert card.peak < cpu.peak
    else:
        assert card.peak <= cpu.peak


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, errors):
    import os
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    try:
        _check_values()
    except Exception as e:  # noqa: BLE001 — reported to the parent
        import traceback
        errors.put((rank, f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()[-3000:]}"))
    finally:
        dist.destroy_process_group()


def _check_values():
    """On a (2, 2) ('data', 'model') mesh: (3, 8, 12) counted from
    Shard(2) to Shard(1) over 'model' under the dry run's fixes equals,
    shard for shard, the same move made plainly, and the whole tensor;
    the counter saw one all-to-all."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = torch.arange(3 * 8 * 12, dtype=torch.float32).reshape(3, 8, 12)
    d = distribute_tensor(x, mesh, (Replicate(), Shard(2)))
    c = dryrun._LocalCounter()
    with dryrun._dtensor_fixes(c), c:
        got = d.redistribute(mesh, (Replicate(), Shard(1)))
    want = d.redistribute(mesh, (Replicate(), Shard(1)))
    assert c.counts == {A2A: 1} and c.bytes == {A2A: 3 * 4 * 12 * 4}
    assert torch.equal(got.to_local(), want.to_local())
    assert torch.equal(got.full_tensor(), x)


def test_shard_to_shard_move_values_on_gloo():
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    mp.start_processes(_worker, args=(_free_port(), errors), nprocs=WORLD,
                       start_method="spawn")
    if not errors.empty():
        rank, msg = errors.get()
        pytest.fail(f"rank {rank}: {msg}")
