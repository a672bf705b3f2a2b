"""Sequence-parallel activation sharding (Megatron-SP) on DTensor — the
port of `repro.models.act_sharding`.

The reference pins layouts with `jax.lax.with_sharding_constraint` and
lets GSPMD insert the collectives. Here a spec is the reference's
PartitionSpec as a tuple, one entry per tensor dim: None, a mesh axis
name, or a tuple of names (``(("data",), "model", None)``), and each
`constrain*` function redistributes a `DTensor` to the placements the
spec names on the tensor's own mesh (`placements`). On a plain tensor,
or while no spec is set, each is the identity.

Off by default; the dry run (`repro_torch.launch.dryrun`) enables the
specs under its mesh, as the reference's launcher does.

The seam (no twin in the reference). A few operations of the model
need another form on DTensors, where GSPMD partitions the plain one
silently and DTensor refuses it or gathers in full: the head view, the
attention calls, the norms' input, the loss, the embedding, the cache
writes, the MoE's dropless dispatch, the sLSTM's token loop, and a
layer's weights at their use (where the dry run gathers FSDP shards).
The model code calls each through a function decorated `replaceable`,
which runs its plain body unless a form is installed under its name
(`forms`).
The dry run installs its DTensor forms (`repro_torch.launch.
dtensor_forms`) for the length of a step; every other path runs the
plain bodies, and nothing in the model tests for DTensor.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

_SAVED_SPEC: Optional[tuple] = None     # layer-boundary (checkpointed) layout
_COMPUTE_SPEC: Optional[tuple] = None   # in-layer layout
_FORMS: dict = {}   # name -> form(plain, *args, **kwargs), while installed
REPLACEABLE: set = set()   # the names `replaceable` has wrapped


def replaceable(fn):
    """`fn`, or the form installed under its name: called as
    `form(fn, *args, **kwargs)`, so a form can fall back on the plain
    body."""
    name = fn.__name__
    REPLACEABLE.add(name)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        form = _FORMS.get(name)
        if form is None:
            return fn(*args, **kwargs)
        return form(fn, *args, **kwargs)
    return call


@contextlib.contextmanager
def forms(table: dict):
    """Install `table` ({name: form}) over the `replaceable` functions for
    the length of the context."""
    prev = dict(_FORMS)
    _FORMS.update(table)
    try:
        yield
    finally:
        _FORMS.clear()
        _FORMS.update(prev)


@replaceable
def pin_grad(x):
    """`x`, whose gradient arrives in `x`'s own layout (the identity on a
    plain tensor; the dry run's form pins a DTensor's)."""
    return x


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (imports nothing for a plain tensor)."""
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(mesh, spec, shape=None) -> tuple:
    """A spec tuple -> DTensor placements on `mesh`: an entry naming
    axes (a name, or a tuple such as ``("pod", "data")``) becomes
    `Shard(d)` on each of those mesh dims, in mesh order; every other
    mesh dim is `Replicate()`. Given the tensor's `shape`, they are made
    even (`even_placements`)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out) if shape is None \
        else even_placements(mesh, out, shape)


def even_placements(mesh, pl, shape) -> tuple:
    """Placements `pl` of a tensor of `shape` with, for each tensor dim
    whose extent the product of its sharding mesh dims does not divide,
    those mesh dims replicated, outermost first, until the rest divide
    it (16 rows over 2x16x16's ('pod', 'data') shard over 'data' only):
    DTensor's rules assume even shards, where GSPMD pads."""
    from torch.distributed.tensor import Replicate
    out = list(pl)
    for d in range(len(shape)):
        axes = [i for i, p in enumerate(out) if p.is_shard() and p.dim == d]
        while axes and shape[d] % math.prod(mesh.size(i) for i in axes):
            out[axes.pop(0)] = Replicate()
    return tuple(out)


def _to_spec(x, spec, even=True):
    """Redistribute DTensor `x` to `spec`'s placements (with `even`, on
    the axes that shard its dims evenly: `placements`), and pin its
    gradient there too (`pin_grad`); identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    target = placements(x.device_mesh, spec, x.shape if even else None)
    if tuple(x.placements) != target:
        x = x.redistribute(x.device_mesh, target)
    return pin_grad(x)


@contextlib.contextmanager
def activation_sharding(saved, compute=None):
    """saved: spec for the (B, S, d) activations crossing layer
    boundaries (what remat stores, typically seq-sharded on 'model');
    compute: layout restored at layer entry (typically seq-replicated so
    attention partitions normally)."""
    global _SAVED_SPEC, _COMPUTE_SPEC
    prev = (_SAVED_SPEC, _COMPUTE_SPEC)
    _SAVED_SPEC, _COMPUTE_SPEC = saved, compute
    try:
        yield
    finally:
        _SAVED_SPEC, _COMPUTE_SPEC = prev


def constrain(x):
    """Layer-boundary constraint (applied to the layer loop's carry)."""
    if _SAVED_SPEC is not None and x.ndim == 3 and x.shape[1] > 1:
        return _to_spec(x, _SAVED_SPEC)
    return x


def constrain_compute(x):
    """Layer-entry constraint (gather back to the compute layout)."""
    if _COMPUTE_SPEC is not None and x.ndim == 3 and x.shape[1] > 1:
        return _to_spec(x, _COMPUTE_SPEC)
    return x


_KV_SPEC = None  # spec for collected per-layer KV (B, S, KV, hd)


@contextlib.contextmanager
def kv_sharding(spec):
    global _KV_SPEC
    prev = _KV_SPEC
    _KV_SPEC = spec
    try:
        yield
    finally:
        _KV_SPEC = prev


def constrain_kv(kv):
    """Constrain a prefill-collected (k, v) pair before it is written into
    the (L, B, S, KV, hd) cache."""
    if _KV_SPEC is None or kv is None:
        return kv
    k, v = kv
    if k.ndim != 4:
        return kv
    return _to_spec(k, _KV_SPEC), _to_spec(v, _KV_SPEC)


def constrain_kv_stack(k, v):
    """Pin the (L, B, S, KV, hd) prefill KV to the cache layout."""
    if _KV_SPEC is None or k.ndim != 5:
        return k, v
    spec = (None, *tuple(_KV_SPEC))
    return _to_spec(k, spec), _to_spec(v, spec)


_STATE_SPEC = None  # spec for recurrent chunk states (B, nc, H, hd, hd)


@contextlib.contextmanager
def state_sharding(spec):
    """Pin mLSTM chunkwise state tensors (rank-5 (B, nc, H, hd, hd)) so
    their products don't bounce layouts."""
    global _STATE_SPEC
    prev = _STATE_SPEC
    _STATE_SPEC = spec
    try:
        yield
    finally:
        _STATE_SPEC = prev


def constrain_state(x):
    if _STATE_SPEC is None or x.ndim != 5:
        return x
    return _to_spec(x, _STATE_SPEC)


_MOE_SPEC = None  # spec for the (E, C, d) expert dispatch buffer


@contextlib.contextmanager
def moe_buffer_sharding(spec):
    global _MOE_SPEC
    prev = _MOE_SPEC
    _MOE_SPEC = spec
    try:
        yield
    finally:
        _MOE_SPEC = prev


def constrain_moe_buffer(buf):
    if _MOE_SPEC is not None and buf.ndim == 3:
        return _to_spec(buf, _MOE_SPEC)
    return buf


def constrain_moe_tokens(x):
    """Keep per-token MoE intermediates sharded on the token axis (dim 0).
    Uses the batch axes of the active MoE buffer spec."""
    if _MOE_SPEC is None:
        return x
    dp = tuple(_MOE_SPEC)[1]  # (E, C, d) -> C carries the data axes
    if dp is None:
        return x
    return _to_spec(x, (dp, *([None] * (x.ndim - 1))))
