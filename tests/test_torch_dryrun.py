"""Port parity, the dry run: `repro_torch.launch.dryrun.run_one` on the
16x16 placeholder mesh (a fake process group, made once for this module
and destroyed after it) gives a record with the reference's keys whose
`memory.argument_size` is exactly the reference's per-device argument
bytes: the sum of `NamedSharding.shard_shape` bytes of the reference's
`input_specs` on the same leaves (the reference's optimizer step and
cache window are scalars the port keeps as Python ints). Full configs
where a step takes seconds (chatglm3-6b decode_32k, with its host
offload split); the train and prefill steps at the smoke configs
through test-only shapes (a full train_4k step takes a minute or more).
Also: the `constrain*` functions are the identity on plain tensors and
give the spec's placements on a DTensor."""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import InputShape as JInputShape
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.examples import offload_dryrun
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import act_sharding
from torch_parity import two_threads  # noqa: F401 (a fixture)

# every test here on two intra-op threads (`two_threads`)
pytestmark = pytest.mark.usefixtures("two_threads")

MESH = AbstractMesh((16, 16), ("data", "model"))
# the reference's record keys (src/repro/launch/dryrun.py: run_one)
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "microbatches", "ok",
            "lower_s", "compile_s", "memory", "bytes_per_device", "flops",
            "bytes_accessed", "collectives", "wall_s"}
REF_MEMORY = {"argument_size", "output_size", "temp_size", "alias_size",
              "host_argument_size", "host_temp_size"}
TEST_SHAPES = {"train_test": (64, 64, "train"),
               "prefill_test": (128, 16, "prefill")}


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    yield make_production_mesh()
    dist.destroy_process_group()


@pytest.fixture
def test_shapes(monkeypatch):
    """Test-only input shapes, in both packages' SHAPES."""
    for name, (S, B, kind) in TEST_SHAPES.items():
        monkeypatch.setitem(SHAPES, name, InputShape(name, S, B, kind))
        monkeypatch.setitem(JSHAPES, name, JInputShape(name, S, B, kind))


def _ref_argument_bytes(jcfg, shape_name, microbatches=1):
    """Per-device argument bytes of the reference's plan, without the
    scalars the port keeps as Python ints (optimizer step, cache
    window)."""
    _, args, shard, _ = jspecs.input_specs(jcfg, shape_name, MESH,
                                           microbatches=microbatches)
    total = 0
    for (path, a), s in zip(jax.tree_util.tree_flatten_with_path(args)[0],
                            jax.tree_util.tree_leaves(shard)):
        if a.ndim == 0:
            continue
        total += math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def chatglm_decode(mesh):
    return dryrun.run_one("chatglm3-6b", "decode_32k", False)


def test_record_keys_and_argument_bytes_full_config(chatglm_decode):
    rec = chatglm_decode
    assert rec["ok"], rec.get("traceback")
    assert REF_KEYS <= set(rec) and set(rec["memory"]) == REF_MEMORY
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_size"] == _ref_argument_bytes(
        jget_config("chatglm3-6b"), "decode_32k")
    assert rec["memory"]["host_argument_size"] == 0
    # measured: the peak of the step's live local bytes (an int), no
    # temporary on the host, and the reference's argument + temp - alias
    # as device arguments + temp (outputs inside the peak)
    mem = rec["memory"]
    assert type(mem["temp_size"]) is int and mem["temp_size"] > 0
    assert mem["host_temp_size"] == 0
    assert rec["bytes_per_device"] == mem["argument_size"] + mem["temp_size"]
    assert type(rec["bytes_accessed"]) is float and rec["bytes_accessed"] > 0
    # the cache is written in place: its bytes alias the arguments
    assert 0 < rec["memory"]["alias_size"] <= rec["memory"]["output_size"]
    assert rec["flops"] > 0 and "whole step" in rec["flops_scope"]
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes"].values())
    # the same collectives as CommDebugMode counts, under its legacy names
    assert sum(coll["counts"].values()) == \
        sum(coll["comm_debug_counts"].values())
    # chatglm3's 2 KV heads cannot split over 16: the record says so
    assert any("2 heads" in n for n in rec["notes"])


def test_offload_split_puts_exactly_the_kv_shards_on_the_host(
        chatglm_decode):
    base = chatglm_decode
    off = offload_dryrun.lower_decode(offload=True)
    m0, m1 = base["memory"], off["memory"]
    _, args, shard, _ = jspecs.input_specs(jget_config("chatglm3-6b"),
                                           "decode_32k", MESH)
    kv = sum(math.prod(shard[2][k].shard_shape(args[2][k].shape))
             * args[2][k].dtype.itemsize for k in ("k", "v"))
    assert m1["host_argument_size"] == kv > 0
    assert m1["argument_size"] + m1["host_argument_size"] == \
        m0["argument_size"]
    assert off["flops"] == base["flops"]      # the same step
    assert offload_dryrun.kv_per_gpu() == kv   # the cost model's count


@pytest.mark.parametrize("arch,shape_name", [
    ("granite-3-2b", "train_test"), ("granite-3-2b", "prefill_test")])
def test_smoke_records_match_reference_bytes(mesh, test_shapes, arch,
                                             shape_name):
    """The train step (microbatches, AdamW, FSDP) and prefill at the
    smoke configs in f32: ok, and the reference's argument bytes."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    rec = dryrun.run_one(arch, shape_name, False, microbatches=2, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    mb = 2 if SHAPES[shape_name].kind == "train" else 1
    assert rec["microbatches"] == mb
    assert rec["memory"]["argument_size"] == _ref_argument_bytes(
        jcfg, shape_name, mb)
    if SHAPES[shape_name].kind == "train":
        # params and moments updated in place
        assert rec["memory"]["alias_size"] > 0
    assert rec["flops"] > 0


def test_constrain_functions(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = torch.ones(32, 16, 8)
    # no spec, or a plain tensor: the identity
    assert act_sharding.constrain(x) is x
    assert act_sharding.constrain_compute(x) is x
    with act_sharding.activation_sharding((("data",), "model", None),
                                          (("data",), None, None)):
        assert act_sharding.constrain(x) is x
        assert act_sharding.constrain_compute(x) is x
        with FakeTensorMode():
            d = distribute_tensor(torch.empty(32, 16, 8), mesh,
                                  [Replicate(), Replicate()])
            assert act_sharding.constrain(d).placements == \
                (Shard(0), Shard(1))
            assert act_sharding.constrain_compute(d).placements == \
                (Shard(0), Replicate())
    with act_sharding.kv_sharding(("data", "model", None, None)):
        with FakeTensorMode():
            k = distribute_tensor(torch.empty(32, 64, 2, 8), mesh,
                                  [Replicate(), Replicate()])
            k2, v2 = act_sharding.constrain_kv((k, k))
            assert k2.placements == v2.placements == (Shard(0), Shard(1))
            s = distribute_tensor(torch.empty(4, 32, 64, 2, 8), mesh,
                                  [Replicate(), Replicate()])
            assert act_sharding.constrain_kv_stack(s, s)[0].placements == \
                (Shard(1), Shard(2))
    with act_sharding.moe_buffer_sharding(("model", "data", None)):
        with FakeTensorMode():
            b = distribute_tensor(torch.empty(16, 32, 8), mesh,
                                  [Replicate(), Replicate()])
            assert act_sharding.constrain_moe_buffer(b).placements == \
                (Shard(1), Shard(0))
            t = distribute_tensor(torch.empty(64, 8), mesh,
                                  [Replicate(), Replicate()])
            assert act_sharding.constrain_moe_tokens(t).placements == \
                (Shard(0), Replicate())
    assert act_sharding.placements(mesh, (("data",), None)) == \
        (Shard(0), Replicate())


def test_uneven_shards_keep_the_axes_that_divide(mesh):
    """`act_sharding.placements` given a shape, and
    `dtensor_forms.even_shards` on a DTensor, drop a dim's outermost
    sharding axes until the rest divide it (16 rows over ('data',
    'model') shard over 'model' only; 8 rows over 'data' replicate):
    DTensor's rules assume even shards, where GSPMD pads (the 2x16x16
    mesh's 16-row microbatches over 32 data ranks)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dtensor_forms import even_shards
    both = ((("data", "model"), None))
    assert act_sharding.placements(mesh, both) == (Shard(0), Shard(0))
    assert act_sharding.placements(mesh, both, (512, 4)) == (Shard(0),
                                                             Shard(0))
    assert act_sharding.placements(mesh, both, (16, 4)) == (Replicate(),
                                                            Shard(0))
    assert act_sharding.placements(mesh, (("data",), None), (8, 4)) == \
        (Replicate(), Replicate())
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(48, 8), mesh,
                              [Shard(0), Shard(0)])
        assert even_shards(x).placements == (Replicate(), Shard(0))
        y = distribute_tensor(torch.empty(512, 8), mesh,
                              [Shard(0), Shard(0)])
        assert even_shards(y) is y
    assert even_shards(torch.ones(3)).shape == (3,)


def test_torch_has_the_internals_the_dry_run_patches():
    """The dry run patches two private DTensor methods while a step runs
    and builds its mesh on torch's test-only fake process group
    (`dryrun.TORCH_INTERNALS`): a torch that moves one fails here, by
    name, before any run of the dry run."""
    assert dryrun.missing_torch_internals() == [], torch.__version__
    import importlib
    for mod, path in dryrun.TORCH_INTERNALS:
        obj = importlib.import_module(mod)
        for name in path.split("."):
            obj = getattr(obj, name)
        assert callable(obj), f"{mod}.{path}"


def test_replaceable_runs_its_plain_body_unless_a_form_is_installed():
    """The seam (`act_sharding.replaceable`): the plain body by default,
    the installed form (given the plain body) inside `forms`, the plain
    body again after it; and every DTensor form of the dry run is named
    after a replaceable function of the model (a misnamed form would
    never run)."""
    from repro_torch.launch.dtensor_forms import FORMS
    from repro_torch.models import layers, model, moe, ssm  # noqa: F401
    x = torch.arange(12.0).reshape(1, 2, 6)
    assert layers.split_heads(x, 3).shape == (1, 2, 3, 2)
    seen = []

    def form(plain, t, n):
        seen.append(n)
        return plain(t, n)
    with act_sharding.forms({"split_heads": form}):
        assert layers.split_heads(x, 2).shape == (1, 2, 2, 3)
    layers.split_heads(x, 3)
    assert seen == [2]
    assert set(FORMS) <= act_sharding.REPLACEABLE



def test_local_counter_counts_a_step_known_by_hand(mesh):
    """The memory and bytes of a few local ops on DTensors of fake tensors
    (x (1024, 1024) f32 sharded by rows over 'data': 256 KiB a rank; w
    replicated: 4 MiB), counted by hand: y = x @ w allocates 256 KiB, z =
    relu(y) 256 more (the peak, 512 KiB), `del y` frees 256, u = 2 z
    allocates 256, a view of u and an in-place add allocate nothing, and
    the view keeps u's bytes after `del u`. Bytes accessed: each op's
    inputs and output, the view none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    kib = 1024
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(1024, 1024), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(1024, 1024), mesh,
                              [Replicate(), Replicate()])
        c = dryrun._LocalCounter()
        with dryrun._dtensor_fixes(c), c:
            y = x @ w
            assert c.live == c.peak == 256 * kib
            z = y.relu()
            del y
            assert c.live == 256 * kib and c.peak == 512 * kib
            u = z * 2
            v = u.view(-1)
            u.add_(1)
            assert c.live == 512 * kib
            del u
            assert c.live == 512 * kib and v.to_local().numel() == 64 * 1024
    assert c.peak == 512 * kib
    assert c.accessed == ((256 + 4096 + 256)       # mm
                          + (256 + 256)            # relu
                          + (256 + 256)            # mul by a scalar
                          + (256 + 256)) * kib     # add_: read, write
    del v, z
    assert c.live == 0


def test_local_counter_scales_what_it_counts_inside_a_region():
    """`_LocalCounter.scaled(k)`: each op inside the region counts k
    times (nested regions multiply), and the scale is restored after."""
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    with dryrun._LocalCounter() as c:
        a @ b
        with c.scaled(3):
            a @ b
            with c.scaled(2):
                a @ b
        a @ b
    assert c.flops == (1 + 3 + 6 + 1) * 2 * 4 * 8 * 2
    assert c.scale == 1


# short xlstm sequences for the counted sLSTM loop (C10)
C10_SHAPES = {"train_s16": (16, 32, "train"), "prefill_s16": (16, 16,
                                                              "prefill")}


@pytest.fixture(scope="module", params=list(C10_SHAPES))
def c10_records(request, mesh):
    """(shape name, the counted loop's record, the full loop's record,
    the shapes the counted form was called with) at a short sequence
    (xlstm-1.3b smoke, f32, 2 microbatches); the full loop is the loop
    form (`slstm_scan`, every step on each rank's batch rows), installed
    in the counted form's place."""
    from repro_torch.launch import dtensor_forms
    shape_name = request.param
    S, B, kind = C10_SHAPES[shape_name]
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                              dtype="float32")
    counted = dtensor_forms.counted_slstm_scan
    calls = []

    def spy(counter, plain, *args):
        calls.append(args[0].shape)
        return counted(counter, plain, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(SHAPES, shape_name, InputShape(shape_name, S, B, kind))
        mp.setattr(dtensor_forms, "counted_slstm_scan", spy)
        got = dryrun.run_one("xlstm-1.3b", shape_name, False,
                             microbatches=2, cfg=cfg)
        mp.setattr(dtensor_forms, "counted_slstm_scan",
                   lambda counter, plain, *args:
                   dtensor_forms.slstm_scan(plain, *args))
        want = dryrun.run_one("xlstm-1.3b", shape_name, False,
                              microbatches=2, cfg=cfg)
    assert dtensor_forms.counted_slstm_scan is counted
    return shape_name, got, want, calls


def test_counted_slstm_loop_counts_what_the_full_loop_does(c10_records):
    """C10: the dry run counts the sLSTM's token loop as steps 0 and 1,
    one step scaled by S - 3 and the last, forward, recompute and
    backward (`dtensor_forms.counted_slstm_scan`, installed by
    `dryrun._contexts` only). At a short sequence its FLOPs, collective
    counts and collective bytes equal the full loop's. Elsewhere the loop
    form stays."""
    from repro_torch.launch import dtensor_forms
    shape_name, got, want, calls = c10_records
    S = C10_SHAPES[shape_name][0]
    assert got["ok"], got.get("traceback")
    assert want["ok"], want.get("traceback")
    assert calls and all(s[1] == S for s in calls)
    assert got["flops"] == want["flops"] > 0
    for key in ("counts", "bytes", "total_bytes"):
        assert got["collectives"][key] == want["collectives"][key], key
    assert dtensor_forms.FORMS["slstm_scan"] is dtensor_forms.slstm_scan


def test_counted_slstm_loop_keeps_the_full_loops_peak(c10_records):
    """A2 with C10: the counted loop's `temp_size` (the peak of the live
    bytes one rank allocates) equals the full loop's, in the checkpointed
    train step (forward, recompute, backward) and in prefill: the steps
    that do not run are stood for by allocations of their saved bytes."""
    shape_name, got, want, _ = c10_records
    assert got["ok"] and want["ok"]
    assert type(got["memory"]["temp_size"]) is int
    assert got["memory"]["temp_size"] == want["memory"]["temp_size"] > 0
    assert got["bytes_per_device"] == want["bytes_per_device"]
