"""Multi-pod dry run: run every (arch x input-shape x mesh) step on a
placeholder DeviceMesh — the port of `repro.launch.dryrun`.

Proves the distribution plan is coherent without hardware, as the
reference's does: 256 (or 512) ranks of a fake process group stand in
for the chips (`launch.mesh`). Every argument is a fake tensor
distributed (`distribute_tensor`) to its spec's placements, so each rank
holds the shape of its local shard and nothing is allocated; the step
(the train step, prefill or one decode token) then runs eagerly on
DTensors, under `CommDebugMode` and a counter of the local ops one rank
runs. Run it as a fresh process
(`python -m repro_torch.launch.dryrun ...`): the process group is
process-global.

What a record holds, against the reference's (compiled XLA) record:

* `memory.argument_size`: the local shard bytes of every argument on one
  rank (params, optimizer state, batch, cache); `host_argument_size`
  the part placed in host memory (`host_keys`). `output_size` is the
  local bytes of the step's outputs, `alias_size` the part written in
  place into an argument (the reference's donation). `temp_size` is the
  peak over the step of the live bytes one rank allocates inside it
  (activations, saved tensors, gradients, collective results, held
  once, and the outputs as they appear; not the arguments), tracked by
  storage (`_LocalCounter`); `host_temp_size` is 0: the port places no
  temporary in host memory. `bytes_per_device` is the device-resident
  arguments plus `temp_size`: the reference's `argument + temp - alias`,
  where XLA's temp excludes the outputs and an aliased output reuses its
  argument; here an output not written in place is inside the peak and
  one written in place allocates nothing. The peak is that of the plan
  the card runs: attention is the card's flash kernels (the buffers
  their wrapper allocates and saves, no Sq x Skv score block:
  `dtensor_forms.counted_attention`), and FSDP-sharded layer weights
  are gathered where each block uses them and freed after it (inside
  an activation checkpoint, and again in its recompute:
  `model.layer_weights`), so a rank holds one layer's gathered weights
  at a time, as GSPMD's layer scan does; the leaves outside the layer
  stacks are gathered once for the step (`specs.sharded_model`). What
  the reference's specs keep sharded stays sharded: each rank builds
  its own shard of the MoE's (E, C, d) capacity buffer by an
  all-to-all (`dtensor_forms.dispatch`, `combine`), runs Mamba2's conv
  and SSD on its own channels and heads (`in_proj`, `ssd_chunked`) and
  a decode step's state update on its own (b, h) block (`ssd_step`), and
  a microbatch that does not split over the data ranks comes from its
  own rows (`specs._mb_slice`); where a form cannot, `notes` says so.
* `flops`: the whole step, per rank: `torch.utils.flop_counter`'s
  formulas over the local ops one rank runs (`_LocalCounter`), and for
  attention the plain version's products over the whole Sq x Skv, by
  formula. Unlike XLA's `cost_analysis`, which counts a scan body once,
  the port's layer and microbatch loops are Python loops: `flops_scope`
  says so. `bytes_accessed` is the local bytes those ops read and
  write, eager and unfused, and for attention the flash kernels' floor
  (`bytes_accessed_scope`), so at or above what XLA's fused count would
  report.
* `collectives`: counts and result bytes per kind under DTensor's own
  op names (`_c10d_functional.*`), for the whole step. With FSDP: one
  all-gather per sharded leaf of a layer each time its block runs (a
  checkpointed block's forward and recompute, each microbatch), one
  reduce-scatter per such leaf as its gradient in each microbatch's
  backward, and one of each per sharded leaf outside the stacks.
* `notes`: each redistribution DTensor needed that GSPMD makes silently
  (`dtensor_forms.notes`).

Failures are data (`ok: False`, `error`, `traceback`), as in the
reference.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dtensor_forms
from repro_torch.launch.mesh import axis_size, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.act_sharding import (
    activation_sharding, forms, kv_sharding, moe_buffer_sharding,
    placements, state_sharding)

DEFAULT_MICROBATCHES = 4  # train_4k grad-accumulation factor

# per-arch grad-accumulation overrides (the reference's, so the two plans
# stay comparable)
MICROBATCH = {
    "llama4-scout-17b-a16e": 16,
    "qwen2-vl-7b": 16,
    "codeqwen1.5-7b": 8,
    "chatglm3-6b": 8,
    "deepseek-moe-16b": 8,
    "xlstm-1.3b": 8,
    "zamba2-2.7b": 8,
}

BYTES_ACCESSED_SCOPE = (
    "eager and unfused: each local op's inputs (once each) and outputs, "
    "views excepted, scaled as the FLOPs are, but attention as the flash "
    "kernels' floor (each operand of a call read or written once, "
    "forward and backward); at or above what XLA's fused cost_analysis "
    "counts")

FLOPS_SCOPE = ("whole step: every layer and microbatch loop runs in "
               "Python and is counted each time it runs, the sLSTM's "
               "token loop as its first step and one later step counted "
               "S - 1 times (XLA's cost_analysis counts a scan body once)")


def _leaves(tree):
    """Tensor leaves of nested dicts / tuples / lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _local_bytes(t) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _distribute(mesh, tree, spec):
    """`tree`'s tensor leaves as DTensors at `spec`'s placements (same
    nesting; an OptState's int step and a cache's int window pass
    through)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(mesh, spec))
    if isinstance(tree, dict):
        return {k: (_distribute(mesh, v, spec[k])
                    if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [_distribute(mesh, v, s) if isinstance(v, (torch.Tensor, dict))
               else v for v, s in zip(tree, spec)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else tuple(out)
    return tree


_WAIT = torch.ops._c10d_functional.wait_tensor.default
# the counter's name for an all-to-all (the MoE forms' and a shard-to-
# shard move's)
ALL_TO_ALL = "_c10d_functional.all_to_all_single"


class _LocalCounter(TorchDispatchMode):
    """A dispatch mode that lets DTensor desugar each op first (as
    CommDebugMode does) and then sees only the LOCAL ops one rank runs:
    their FLOPs, by `torch.utils.flop_counter`'s formulas, every
    functional collective with its result bytes, the bytes the ops read
    and write, and the memory one rank allocates. (FlopCounterMode itself
    would also count the global-shape ops DTensor decomposes.) Inside
    `scaled(k)` each op counts k times, and inside `scaled_nodes` each op
    a given autograd node runs: a loop whose steps are alike runs one
    step there for all of them (`dtensor_forms.counted_slstm_scan`).

    Memory is kept by untyped storage: a storage that an op's output
    brings and none of its inputs had is a new allocation, live until the
    storage dies (a weakref finalizer), so a view or an in-place write
    allocates nothing and a view that outlives its base keeps the bytes
    live. A storage first seen as an input (an argument of the step) is
    not the step's. A collective's `wait_tensor` returns the tensor it
    was given, as on a card (the fake group's meta kernel makes a second
    one), so its result is held once. `peak` is the most bytes live at
    once (`temp_size`).
    `accessed` sums each op's input bytes (each input once) and output
    bytes, but for views (an op that writes nothing and returns only
    storages of its inputs) and queries with no tensor output."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.counts, self.bytes = {}, {}
        self.paused = 0
        self.scale = 1
        self.live = self.peak = self.accessed = 0
        self._held = {}     # id(storage) -> its bytes (0: not the step's)
        self._nodes = []    # `scaled_nodes` ranges

    @contextlib.contextmanager
    def scaled(self, k: int):
        """Count every op inside the context `k` times (memory is the one
        run's: `dtensor_forms._CountedScan` allocates the rest)."""
        prev = self.scale
        self.scale = prev * k
        try:
            yield
        finally:
            self.scale = prev

    @contextlib.contextmanager
    def allocating(self):
        """Inside the context ops count memory only: a form that stands
        for a kernel allocates its buffers here and `charge`s the
        kernel's FLOPs and bytes by formula
        (`dtensor_forms.counted_attention`)."""
        with self.scaled(0):
            yield

    def charge(self, flops: int, accessed: int):
        """Add FLOPs and bytes accessed counted by formula, scaled as an
        op here would be."""
        self.flops += self.scale * flops
        self.accessed += self.scale * accessed

    @contextlib.contextmanager
    def scaled_nodes(self, lo: int, hi: int, k: int):
        """Inside the context, count k times each op that an autograd
        node with a sequence number in (lo, hi] runs: a backward whose
        graph holds one step for k alike ones."""
        self._nodes.append((lo, hi, k))
        try:
            yield
        finally:
            self._nodes.pop()

    def _free(self, key):
        self.live -= self._held.pop(key)

    def _storage(self, t, new: bool, nbytes=None):
        """The key of `t`'s storage (None if it has none of its own),
        registered if unseen: as a new allocation of the step (`new`) of
        the storage's bytes (or `nbytes`) or as one from outside it."""
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return None
        key = id(st)
        if key in self._held:
            return key
        nbytes = (st.nbytes() if nbytes is None else nbytes) if new else 0
        self._held[key] = nbytes
        weakref.finalize(st, self._free, key)
        if nbytes:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        if func is _WAIT:
            return args[0]
        out = func(*args, **kwargs)
        with self._node_scaled():
            return self._count(func, args, kwargs, out)

    @contextlib.contextmanager
    def _node_scaled(self):
        """`scale`, times the factor of the autograd node the current op
        runs for (`scaled_nodes`)."""
        prev = self.scale
        if self._nodes:
            node = torch._C._current_autograd_node()
            seq = -1 if node is None else node._sequence_nr()
            self.scale *= math.prod(k for lo, hi, k in self._nodes
                                    if lo < seq <= hi)
        try:
            yield
        finally:
            self.scale = prev

    def all_to_all(self, inp, out):
        """Count one all-to-all that took `inp` to `out` (a shard-to-shard
        move made uncounted): `out` is a new allocation of its own bytes
        (the CPU mesh's may be a view of its gathered buffer), they are
        the collective's result, and it reads `inp` and writes `out`
        once."""
        with self._node_scaled():
            self._storage(out, new=True, nbytes=_local_bytes(out))
            self.accessed += self.scale * (_local_bytes(inp)
                                           + _local_bytes(out))
            self.counts[ALL_TO_ALL] = self.counts.get(ALL_TO_ALL, 0) \
                + self.scale
            self.bytes[ALL_TO_ALL] = self.bytes.get(ALL_TO_ALL, 0) \
                + self.scale * _local_bytes(out)

    def _count(self, func, args, kwargs, out):
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        held = {self._storage(t, new=False) for t in ins}
        made = [self._storage(t, new=True) for t in outs]
        # a view (by tag or by aliasing: `_unsafe_view`) moves no bytes
        view = func.is_view or (not func._schema.is_mutable
                                and held.issuperset(made))
        if outs and not view:
            self.accessed += self.scale * sum(
                t.numel() * t.element_size()
                for t in [*{id(t): t for t in ins}.values(), *outs])
        pkt = func.overloadpacket
        if pkt in flop_registry:
            def shape(x):
                return x.shape if isinstance(x, torch.Tensor) else x
            self.flops += self.scale * flop_registry[pkt](
                *tree_map(shape, args), **tree_map(shape, kwargs),
                out_val=tree_map(shape, out))
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional") \
                and "wait" not in func.name():
            name = f"{ns}.{pkt.__name__}"
            self.counts[name] = self.counts.get(name, 0) + self.scale
            self.bytes[name] = self.bytes.get(name, 0) + self.scale * sum(
                _local_bytes(t) for t in _leaves(out))
        return out


# torch's private names the dry run reaches into (`_dtensor_fixes`,
# `launch.mesh`), as (module, attribute path): a release that moves one
# fails `missing_torch_internals` (and its CPU test) by name
TORCH_INTERNALS = (
    ("torch.distributed.tensor.placement_types",
     "_StridedShard.local_shard_size_and_offset"),
    ("torch.distributed.tensor._sharding_prop",
     "ShardingPropagator._propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._sharding_prop",
     "ShardingPropagator.propagate_op_sharding_non_cached"),
    ("torch._subclasses.fake_tensor", "unset_fake_temporarily"),
    ("torch.testing._internal.distributed.fake_pg", "FakeStore"),
    # the counted sLSTM loop (`dtensor_forms._CountedScan`): the ambient
    # saved-tensor hooks, and the node whose backward an op runs (whose
    # `_sequence_nr` `_LocalCounter.scaled_nodes` reads)
    ("torch._C._autograd", "_top_saved_tensors_default_hooks"),
    ("torch._C", "_current_autograd_node"),
    # the MoE forms' all-to-all, the microbatch slice's all-gather, the
    # token mesh dims flattened into one group, and the fake step's test
    # (`dtensor_forms._MoePlan`, `microbatch_rows`)
    ("torch.distributed._functional_collectives",
     "all_to_all_single_autograd"),
    ("torch.distributed._functional_collectives", "all_gather_tensor"),
    ("torch.distributed.device_mesh", "DeviceMesh._flatten"),
    ("torch._subclasses.fake_tensor", "is_fake"),
    # a shard-to-shard move, made on a CPU mesh as an all-gather and a
    # chunk and counted as the all-to-all a card makes
    # (`_dtensor_fixes`); `placement_types` holds its own name of it where
    # it imported the function, and CommDebugMode's key for an all-to-all
    ("torch.distributed.tensor._collective_utils", "shard_dim_alltoall"),
    ("torch", "ops.c10d_functional.all_to_all_single"),
    # the sharding caches a new process group empties
    # (`mesh._clear_sharding_caches`)
    ("torch._C", "_clear_DTensor_sharding_propagator_cache"),
    ("torch.distributed.tensor",
     "DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding"
     ".cache_clear"),
)


def missing_torch_internals() -> list:
    """The entries of TORCH_INTERNALS this torch does not have."""
    import importlib
    missing = []
    for mod, path in TORCH_INTERNALS:
        try:
            obj = importlib.import_module(mod)
            for name in path.split("."):
                obj = getattr(obj, name)
        except (ImportError, AttributeError):
            missing.append(f"{mod}.{path}")
    return missing


@contextlib.contextmanager
def _dtensor_fixes(counter, comm=None):
    """Three adjustments to DTensor for a step on fake tensors.

    Sharding propagation picks an op's placements and infers its output
    shapes by running ops on GLOBAL-shape fake tensors and on fake meshes
    of its own (`propagate_op_sharding_non_cached`,
    `_propagate_tensor_meta_non_cached`): no rank runs those, so
    `counter` (its FLOPs, bytes and memory) pauses while they run.

    DTensor computes a strided shard's (`_StridedShard`, from flattening
    two sharded dims, as a batched attention product does) local size
    from an index tensor it builds with torch ops and reads back with
    `.tolist()`; under FakeTensorMode that tensor is fake and cannot be
    read. Run that computation on real (tiny) tensors, uncounted: it reads
    metadata only.

    A redistribution Shard(i) -> Shard(j) on one mesh dim
    (`shard_dim_alltoall`) is, on a CPU mesh, an all-gather of every
    rank's shard and a chunk of the result; a card's NCCL makes it one
    all-to-all that holds the output shard only. The move runs as torch
    makes it (its values unchanged) with `counter` paused, and counts as
    that all-to-all: its output shard live, one all-to-all of the
    output's bytes (`_LocalCounter.all_to_all`), no all-gather; `comm`, a
    CommDebugMode, likewise counts the one all-to-all."""
    import torch.distributed.tensor._collective_utils as coll_utils
    import torch.distributed.tensor.placement_types as ptypes
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def uncounted(fn, real=False):
        def run(*args, **kwargs):
            counter.paused += 1
            try:
                with unset_fake_temporarily() if real \
                        else contextlib.nullcontext():
                    return fn(*args, **kwargs)
            finally:
                counter.paused -= 1
        return run

    patches = [(_StridedShard, "local_shard_size_and_offset", True),
               (ShardingPropagator, "propagate_op_sharding_non_cached",
                False),
               (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                False)]
    move = coll_utils.shard_dim_alltoall

    def all_to_all(inp, gather_dim, shard_dim, mesh, mesh_dim):
        seen = None if comm is None else dict(comm.comm_counts)
        out = uncounted(move)(inp, gather_dim, shard_dim, mesh, mesh_dim)
        if comm is not None:
            comm.comm_counts.clear()
            comm.comm_counts.update(seen)
            comm.comm_counts[torch.ops.c10d_functional.all_to_all_single] \
                += 1
        counter.all_to_all(inp, out)
        return out

    patches += [(m, "shard_dim_alltoall", None) for m in (coll_utils, ptypes)
                if getattr(m, "shard_dim_alltoall", None) is move]
    origs = [getattr(cls, name) for cls, name, _ in patches]
    for (cls, name, real), fn in zip(patches, origs):
        setattr(cls, name, all_to_all if real is None
                else uncounted(fn, real))
    try:
        yield
    finally:
        for (cls, name, _), fn in zip(patches, origs):
            setattr(cls, name, fn)


def _contexts(cfg, shape_name, mesh, multi_pod, counter=None):
    """The model's DTensor forms (`dtensor_forms`; with a `counter`, the
    sLSTM's token loop counted by it, not run, and attention as the
    card's flash kernels: their buffers, their FLOPs and bytes counted
    by formula) and the reference's
    activation / KV / MoE / state specs for this pair, as one context."""
    kind = SHAPES[shape_name].kind
    dp = ("pod", "data") if multi_pod else ("data",)
    stack = contextlib.ExitStack()
    table = dict(dtensor_forms.FORMS)
    if counter is not None:
        table["slstm_scan"] = functools.partial(
            dtensor_forms.counted_slstm_scan, counter)
        table["attention"] = functools.partial(
            dtensor_forms.counted_attention, counter)
    stack.enter_context(forms(table))
    # sequence-parallel activation sharding for full-sequence passes
    # (Megatron-SP): the checkpointed carry lives (batch, seq)-sharded
    if kind in ("train", "prefill"):
        stack.enter_context(activation_sharding((dp, "model", None),
                                                (dp, None, None)))
    # fine-grained MoE (experts >> TP degree): pin the dispatch buffer
    # expert-sharded
    if cfg.family == "moe" and cfg.moe.n_experts > axis_size(mesh, "model") \
            and kind in ("train", "prefill"):
        stack.enter_context(moe_buffer_sharding(("model", dp, None)))
    if kind == "prefill":
        stack.enter_context(kv_sharding((dp, "model", None, None)))
    # recurrent chunk states (mLSTM C matrices): head-dim over 'model'
    if cfg.family in ("ssm", "hybrid") and kind in ("train", "prefill"):
        stack.enter_context(state_sharding((dp, None, None, "model", None)))
    return stack


def run_one(arch: str, shape_name: str, multi_pod: bool,
            microbatches: int = 0, *, cfg=None, host_keys=()) -> dict:
    """One (arch x shape x mesh) record. `cfg` overrides `get_config(arch)`
    (tests pass smoke configs); `host_keys` names cache leaves placed in
    host memory (`examples/offload_dryrun.py`)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = SHAPES[shape_name].kind
    if not microbatches:
        microbatches = MICROBATCH.get(arch, DEFAULT_MICROBATCHES)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_devices": mesh.size(),
           "microbatches": microbatches if kind == "train" else 1}
    t0 = time.time()
    dtensor_forms.clear_notes()
    try:
        fn, args, shardings, out_shardings = input_specs(
            cfg, shape_name, mesh,
            microbatches=microbatches if kind == "train" else 1)
        mode = fn.fake_mode
        with mode:
            dargs = tuple(_distribute(mesh, a, s)
                          for a, s in zip(args, shardings))
        arg_leaves = _leaves(dargs)
        arg_bytes = sum(_local_bytes(t) for t in arg_leaves)
        host = 0
        if host_keys:
            cache = dargs[-1]
            host = sum(_local_bytes(cache[k]) for k in host_keys)
        t_build = time.time() - t0
        coll = _LocalCounter()
        comm = CommDebugMode()
        # Python's cycle collector stays off for the step, so garbage in
        # reference cycles is freed at the same point in every run (after
        # it), and the peak does not depend on when a collection ran
        gc.collect()
        gc.disable()
        try:
            with _contexts(cfg, shape_name, mesh, multi_pod, coll), mode, \
                    _dtensor_fixes(coll, comm), implicit_replication(), coll, \
                    comm:
                out = fn(*dargs)
        finally:
            gc.enable()
        t_step = time.time() - t0 - t_build
        in_ids = {id(t) for t in arg_leaves}
        out_leaves = _leaves(out)
        out_bytes = sum(_local_bytes(t) for t in out_leaves)
        alias = sum(_local_bytes(t) for t in out_leaves if id(t) in in_ids)
        comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        rec.update(
            ok=True,
            lower_s=round(t_build, 2),      # stand-ins and shards built
            compile_s=round(t_step, 2),     # the step run on DTensors
            memory=dict(
                argument_size=arg_bytes - host,
                output_size=out_bytes,
                temp_size=coll.peak,
                alias_size=alias,
                host_argument_size=host,
                host_temp_size=0,
            ),
            # per rank: the reference's argument + temp - alias, with the
            # outputs inside the peak and in-place writes allocating none
            bytes_per_device=arg_bytes - host + coll.peak,
            flops=float(coll.flops),
            flops_scope=FLOPS_SCOPE,
            bytes_accessed=float(coll.accessed),
            bytes_accessed_scope=BYTES_ACCESSED_SCOPE,
            collectives=dict(
                bytes=coll.bytes, counts=coll.counts,
                total_bytes=sum(coll.bytes.values()),
                comm_debug_counts=comm_counts,
                scope="whole step (no scan body: nothing to multiply)"),
            notes=dtensor_forms.notes(),
        )
    except Exception as e:  # noqa: BLE001 — failures are data here
        rec.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    seen = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in seen:
                    continue
                print(f"=== {arch} x {shape} x {key[2]} ===", flush=True)
                rec = run_one(arch, shape, mp)
                status = "OK" if rec["ok"] else f"FAIL {rec['error'][:120]}"
                gb = rec.get("bytes_per_device", 0) / 2**30
                print(f"    {status}  mem/dev={gb:.2f}GiB "
                      f"wall={rec['wall_s']}s", flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} combinations ran")


if __name__ == "__main__":
    main()
