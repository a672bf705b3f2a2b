"""Port parity, distribution plan: `repro_torch.launch.specs` against the
reference's `repro.launch.specs.input_specs` on `jax.sharding.
AbstractMesh` (no devices), for every arch x every input shape x both
production meshes (16x16 and 2x16x16), leaf by leaf: the specs of the
params, the optimizer moments, the batch and the cache, the stand-ins'
shapes and dtypes (which carry the query-head padding to the TP
degree), the FSDP decision and `decode_cache_len`. Exact equality: the
rules are copied, not re-derived.

The port's meshes live on a fake process group of 512 placeholder ranks
(`launch.mesh`), made once for this module and destroyed after it. The
single mesh's specs come from the port's `input_specs`; the multi-pod
mesh's from the same spec functions on those stand-ins (they do not
depend on the mesh), so each arch's stand-in model is built once.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh

torch.set_num_threads(2)

JAX_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
              "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    import torch.distributed as dist
    multi = make_production_mesh(multi_pod=True)     # the 512-rank group
    single = make_production_mesh()                  # its first 256 ranks
    yield {"single": single, "multi": multi}
    dist.destroy_process_group()


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jflat(tree):
    """{'layers/attn/wq': leaf, ...} of a reference pytree."""
    return {_key(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec(named, ndim):
    t = tuple(named.spec)
    return t + (None,) * (ndim - len(t))


def _check_tree(port_args, port_specs, ref_args, ref_shard, what,
                skip=()):
    """Every reference leaf has a port twin with the same shape, dtype
    and spec (leaves named in `skip` are the reference's scalars the port
    keeps as Python ints)."""
    ra, rs = _jflat(ref_args), _jflat(ref_shard)
    assert set(ra) - set(skip) == set(port_args), what
    for k in port_args:
        t, ref = port_args[k], ra[k]
        assert tuple(t.shape) == tuple(ref.shape), (what, k)
        assert str(t.dtype).removeprefix("torch.") == str(ref.dtype), \
            (what, k)
        assert port_specs[k] == _spec(rs[k], ref.ndim), \
            (what, k, port_specs[k], rs[k].spec)


def _port_specs(mesh, cfg, shape_name, args):
    """The port's specs on `mesh` for the stand-ins `args` of
    `input_specs` (any mesh: they do not depend on it)."""
    shp = SHAPES[shape_name]
    cfg = tspecs.tp_config(cfg, mesh)
    fsdp = tspecs.use_fsdp(cfg, shp, mesh)
    B = shp.global_batch
    p = tspecs.param_shardings(mesh, args[0], fsdp=fsdp)
    if shp.kind == "train":
        o = (tspecs.param_shardings(mesh, args[1].mu, fsdp=fsdp),
             tspecs.param_shardings(mesh, args[1].nu, fsdp=fsdp))
        return fsdp, (p, o, tspecs.batch_shardings(mesh, args[2], B))
    if shp.kind == "prefill":
        return fsdp, (p, tspecs.batch_shardings(mesh, args[1], B),
                      tspecs.cache_shardings(mesh, args[2], B))
    t = tspecs.batch_shardings(mesh, {"t": args[1]}, B)["t"]
    return fsdp, (p, t, tspecs.cache_shardings(mesh, args[2], B))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_specs_equal_reference(meshes, arch, shape_name):
    shp = SHAPES[shape_name]
    _, args, shard, _ = tspecs.input_specs(get_config(arch), shape_name,
                                           meshes["single"])
    for mname, mesh in meshes.items():
        _, rargs, rshard, _ = jspecs.input_specs(jget_config(arch),
                                                 shape_name,
                                                 JAX_MESHES[mname])
        fsdp, specs = _port_specs(mesh, get_config(arch), shape_name, args)
        if mname == "single":
            assert specs[0] == shard[0] and specs[2] == shard[2]
        what = (arch, shape_name, mname)
        # the FSDP decision: data axes on some param iff fsdp
        dp = {"data", "pod"}
        ref_fsdp = any(
            dp & set(a for e in s.spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))
            for s in jax.tree_util.tree_leaves(rshard[0]))
        assert fsdp == ref_fsdp, what
        _check_tree(args[0], specs[0], rargs[0], rshard[0], what)
        if shp.kind == "train":
            o_args, o_specs = args[1], specs[1]
            assert str(rshard[1][0].spec) == "PartitionSpec()"
            _check_tree(o_args.mu, o_specs[0], rargs[1].mu, rshard[1].mu,
                        what + ("mu",))
            _check_tree(o_args.nu, o_specs[1], rargs[1].nu, rshard[1].nu,
                        what + ("nu",))
            _check_tree(args[2], specs[2], rargs[2], rshard[2],
                        what + ("batch",))
        elif shp.kind == "prefill":
            _check_tree(args[1], specs[1], rargs[1], rshard[1],
                        what + ("batch",))
            _check_tree({k: v for k, v in args[2].items()
                         if isinstance(v, torch.Tensor)}, specs[2],
                        rargs[2], rshard[2], what + ("cache",),
                        skip=("window",))
        else:
            tok = args[1]
            assert tuple(tok.shape) == rargs[1].shape
            assert str(tok.dtype).removeprefix("torch.") == \
                str(rargs[1].dtype)
            assert specs[1] == _spec(rshard[1], 1), what
            _check_tree({k: v for k, v in args[2].items()
                         if isinstance(v, torch.Tensor)}, specs[2],
                        rargs[2], rshard[2], what + ("cache",),
                        skip=("window",))
            n = tspecs.decode_cache_len(get_config(arch), shp)
            assert n == jspecs.decode_cache_len(jget_config(arch), shp)
            if "k" in args[2]:
                assert args[2]["k"].shape[2] == n
