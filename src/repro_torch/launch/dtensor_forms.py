"""The DTensor forms of the model's `replaceable` operations
(`repro_torch.models.act_sharding`), which the dry run
(`repro_torch.launch.dryrun`) installs for the length of a step: GSPMD
partitions the plain forms silently, DTensor refuses them or gathers in
full. Each form is called as `form(plain, *args)` and falls back on the
plain body where its input is a plain tensor.

Two of them change a layout only because DTensor must (`split_heads`,
`attention`): a tensor can only be viewed as heads when every shard
holds whole heads. Each redistribution they make is noted (`notes`), so
the dry run's record says why its collective is there.
"""
from __future__ import annotations

import contextlib
import math
import weakref

import torch

from repro_torch.launch.mesh import data_axes
from repro_torch.models.act_sharding import even_placements, is_dtensor
from repro_torch.models.ssm import slstm_step

_NOTES: set = set()


def notes() -> list:
    """The redistributions `split_heads`, `gqa_heads` and
    `gather_stack_axes` made, and the plain bodies the forms of the
    MoE dispatch, the SSD and its decode step, Mamba2's in-projection
    and the microbatch slice fell back to on DTensors, since the last
    `clear_notes`, one line each."""
    return sorted(_NOTES)


def clear_notes():
    _NOTES.clear()


def pin_grad(plain, x):
    """DTensor `x` whose gradient is redistributed to `x`'s own placements
    as it arrives. A scalar loss's gradient reaches the graph replicated
    (the backward of a mean), and DTensor's ops keep a replicated operand
    replicated, so without a pin the whole backward would run on every
    rank in full. Identity on a plain tensor or without grad."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    # a partial-sum output's gradient is the same on every rank
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)

    def hook(g):
        return g if tuple(g.placements) == pl else g.redistribute(mesh, pl)
    x.register_hook(hook)
    return x


def _sharded_dims(x, dim):
    """The mesh dims whose placement shards tensor dim `dim` of `x`."""
    return [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim == dim]


def _replicate_dims(x, mesh_dims):
    from torch.distributed.tensor import Replicate
    pl = list(x.placements)
    for i in mesh_dims:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, tuple(pl))


def even_shards(x):
    """DTensor `x` redistributed to even shards
    (`act_sharding.even_placements`: 16 rows or 48 heads over ('pod',
    'data') keep 'data' only); identity on a plain tensor and where every
    shard is even."""
    if not is_dtensor(x):
        return x
    pl = even_placements(x.device_mesh, x.placements, x.shape)
    return x if pl == tuple(x.placements) \
        else x.redistribute(x.device_mesh, pl)


def _rank_along(mesh, dims) -> int:
    """This rank's index in the row-major order of mesh dims `dims` (the
    order DTensor gives the shards of a dim sharded over them)."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _strides(shape) -> tuple:
    """The strides of a contiguous tensor of `shape` (a DTensor's global
    ones, for `DTensor.from_local`)."""
    out = [1]
    for n in reversed(tuple(shape)[1:]):
        out.insert(0, out[0] * n)
    return tuple(out)


def microbatch_rows(x, dim: int, i: int, k: int):
    """Microbatch i of k of DTensor `x` along its batch dim `dim`, where
    its m = B / k rows do not split over every mesh dim that shards the
    batch (16 rows over 2x16x16's 32 data ranks). The inner of those
    dims whose extent n_in divides m keep the microbatch sharded, q = m /
    n_in rows a rank; the outer ones ('pod', n_out ranks) hold it
    replicated, as GSPMD's padding leaves each rank ceil(m / dp) rows.
    Microbatch i is rows (i // n_out) q .. + q of each rank of outer
    group i % n_out: each rank takes them from its own shard, and one
    all-gather over the outer dims of those q rows gives every rank its
    group's; a slice of the sharded batch would gather the whole batch
    first. The batch carries no gradient (the all-gather has none).
    None where the shards do not allow it."""
    if not is_dtensor(x):
        return None
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    # (`all_gather_tensor` is `all_gather_single` before its rename)
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    mesh = x.device_mesh
    dims = _sharded_dims(x, dim)
    B = x.shape[dim]
    m, inner = B // k, list(dims)
    while inner and m % math.prod(mesh.size(d) for d in inner):
        inner.pop(0)
    outer = [d for d in dims if d not in inner]
    n_in = math.prod(mesh.size(d) for d in inner)
    n_out = math.prod(mesh.size(d) for d in outer)
    q, r = m // n_in, x.to_local().shape[dim]
    if not outer or B % k or k % n_out or (k // n_out) * q != r:
        names = [mesh.mesh_dim_names[d] for d in dims]
        _NOTES.add(f"microbatch of {m} of {B} rows sharded over {names}: "
                   f"not from each rank's own rows; the contiguous slice")
        return None
    local = x.to_local().narrow(dim, (i // n_out) * q, q).movedim(dim, 0)
    for d in reversed(outer):
        local = gather(local.contiguous(), 0, (mesh, d))
    local = local.narrow(0, (i % n_out) * q, q).movedim(0, dim).contiguous()
    pl = tuple(Replicate() if j in outer else p
               for j, p in enumerate(x.placements))
    shape = (*x.shape[:dim], m, *x.shape[dim + 1:])
    return DTensor.from_local(local, mesh, pl, shape=shape,
                              stride=_strides(shape))


def split_heads(plain, t, n_heads: int):
    """A flat projection (..., n_heads * hd) viewed as heads: where its
    last dim is sharded over mesh dims whose extent does not divide
    `n_heads`, replicate it there first (a shard must hold whole heads;
    GSPMD would reshard silently)."""
    if is_dtensor(t):
        dims = _sharded_dims(t, t.ndim - 1)
        size = 1
        for i in dims:
            size *= t.device_mesh.size(i)
        if dims and n_heads % size:
            names = [t.device_mesh.mesh_dim_names[i] for i in dims]
            _NOTES.add(f"{n_heads} heads of {t.shape[-1] // n_heads} do "
                       f"not divide {names} ({size}); replicated there "
                       f"before the head view")
            t = _replicate_dims(t, dims)
    return plain(t, n_heads)


def gqa_heads(q, k, v):
    """q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) about to enter
    attention, which views q's H as (KV, G): where q's heads are sharded
    over mesh dims whose extent does not divide KV, give k and v all H
    heads, G = 1, sharded like q's (no collective: each shard keeps its
    own heads' copy). Identity on plain tensors."""
    if not is_dtensor(q):
        return q, k, v
    H, KV = q.shape[2], k.shape[2]
    dims = _sharded_dims(q, 2)
    size = 1
    for i in dims:
        size *= q.device_mesh.size(i)
    if not dims or KV % size == 0:
        return q, k, v
    names = [q.device_mesh.mesh_dim_names[i] for i in dims]
    _NOTES.add(f"attention: {KV} KV heads do not divide {names} ({size}); "
               f"K/V expanded to the {H} query heads, sharded like them")
    B, Skv, _, hd = k.shape
    G = H // KV
    qpl = tuple(q.placements)

    def expand(t):
        if is_dtensor(t):
            t = _replicate_dims(t, _sharded_dims(t, 2))
        t = t.unsqueeze(3).expand(B, Skv, KV, G, hd).reshape(B, Skv, H, hd)
        return t.redistribute(t.device_mesh, tuple(
            qp if i in dims else tp for i, (qp, tp)
            in enumerate(zip(qpl, t.placements))))
    return q, expand(k), expand(v)


def reduce_partials(x):
    """A DTensor holding partial sums (a row-parallel product's output
    added to the residual) reduced to real values before a norm reads
    it (Megatron's all-reduce after the row-parallel projection); GSPMD
    places that reduction itself, DTensor would carry the partial sums
    into the norm and then replicate the next product's weights.
    Identity on a plain tensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _attention_local(fn, q, k, v, kw):
    """`fn(q, k, v, kw)` on the local shards of DTensors q, k, v (K/V
    first given whole heads: `gqa_heads`), laid out alike on batch and
    heads (never on the sequence): attention is then local to each
    shard, as GSPMD partitions it. The result is a DTensor with q's
    placements. (Flattening a data-sharded batch with model-sharded
    heads into one batched product leaves a strided shard, whose
    backward DTensor would gather in full.)"""
    from torch.distributed.tensor import DTensor
    q, k, v = gqa_heads(q, k, v)
    q = reduce_partials(q)
    mesh, pl = q.device_mesh, tuple(q.placements)
    k, v = (t.redistribute(mesh, pl) if tuple(t.placements) != pl else t
            for t in (k, v))
    if is_dtensor(kw.get("kv_len")):
        kw["kv_len"] = kw["kv_len"].to_local()
    out = fn(q.to_local(), k.to_local(), v.to_local(), kw)
    return DTensor.from_local(out, mesh, pl, shape=q.shape,
                              stride=q.stride())


def attention(plain, q, k, v, **kw):
    """`plain(q, k, v, **kw)` (the flash attention, tiled), on plain
    tensors as it is and on DTensors' local shards (`_attention_local`):
    the values of the model's own function. The dry run installs
    `counted_attention` in its place."""
    if not is_dtensor(q):
        return plain(q, k, v, **kw)
    return _attention_local(lambda q, k, v, kw: plain(q, k, v, **kw),
                            q, k, v, kw)


def counted_attention(counter, plain, q, k, v, **kw):
    """The dry run's form of `attention`: on DTensors' local shards
    (`_attention_local`) the card's flash kernels as a `_LocalCounter`
    sees them (`_CountedFlash`), with no values (the dry run's tensors
    are fake): the buffers the kernels' wrapper allocates and keeps
    (`kernels/flash_prefill.py`: out, and with a gradient to come the
    row log-sum-exp; `_Flash` saves q, k, v, out, lse; its backward
    allocates dq, dk, dv and `delta`), no Sq x Skv score block, the
    plain version's FLOPs by formula and the kernels' bytes. On plain
    tensors `plain`."""
    if not is_dtensor(q):
        return plain(q, k, v, **kw)

    def flash(q, k, v, kw):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _CountedFlash.apply(counter, q, k, v)
        return _counted_flash_fwd(counter, q, k, v, keep_lse=False)[0]
    return _attention_local(flash, q, k, v, kw)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_flops(q, k) -> int:
    """F = B H Sq Skv D: one of the flash call's products is 2F."""
    B, Sq, H, D = q.shape
    return B * H * Sq * k.shape[1] * D


def _counted_flash_fwd(counter, q, k, v, keep_lse: bool):
    """The forward kernel's buffers, out and (`keep_lse`) lse, allocated
    under `counter`, its FLOPs and bytes charged: (out, lse or None)."""
    B, Sq, H, _ = q.shape
    with counter.allocating():
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32,
                          device=q.device) if keep_lse else None
    counter.charge(4 * _flash_flops(q, k),
                   _nbytes(q, k, v, *(t for t in (out, lse)
                                      if t is not None)))
    return out, lse


class _CountedFlash(torch.autograd.Function):
    """`flash_prefill._Flash` as the dry run counts it
    (`counted_attention`). q (B, Sq, H, D), k, v (B, Skv, KV, D).

    Memory: the forward allocates out (q's shape and dtype) and lse (B,
    H, Sq) f32 and saves q, k, v, out, lse (the first forward of an
    activation checkpoint keeps none of them: the checkpoint's hooks);
    without a backward to come only out is allocated
    (`_counted_flash_fwd`). The backward allocates dq, dk, dv and delta
    (B, H, Sq) f32, its scratch, as `flash_attention_bwd` does.

    FLOPs: the plain version's (`ref.flash_attention_reference`, which
    computes every tile of the whole Sq x Skv, masked or not): F = B H
    Sq Skv D, two products of 2F forward, and in the backward 2F for
    each product operand whose gradient is wanted (P's when q's or k's
    is). Bytes accessed: the kernels' floor, each operand of a call
    read or written once (the backward's delta written once and read
    once)."""

    @staticmethod
    def forward(ctx, counter, q, k, v):
        out, lse = _counted_flash_fwd(counter, q, k, v, keep_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.counter = counter
        return out

    @staticmethod
    def backward(ctx, dout):
        counter = ctx.counter
        q, k, v, out, lse = ctx.saved_tensors
        F = _flash_flops(q, k)
        dout = dout.contiguous()
        with counter.allocating():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty_like(lse)
        _, gq, gk, gv = ctx.needs_input_grad
        products = gq + gk + gv + (gq or gk)
        counter.charge(2 * F * products, _nbytes(
            q, k, v, out, dout, lse, dq, dk, dv, delta, delta))
        del delta
        return None, dq, dk, dv


def norm(plain, x, *args, **kwargs):
    """A norm (`rmsnorm`, `layernorm`) of `x` with its partial sums
    reduced first (`reduce_partials`)."""
    return plain(reduce_partials(x), *args, **kwargs)


def cross_entropy(plain, logits, labels, mask=None):
    """The loss: on DTensor logits with no mask, the vocab-parallel form
    (`sharded_cross_entropy`)."""
    if mask is None and is_dtensor(logits):
        return sharded_cross_entropy(logits, labels)
    return plain(logits, labels, mask)


def sharded_cross_entropy(logits, labels):
    """Mean next-token cross-entropy of DTensor logits (B, S, V) whose
    vocab dim may be sharded, in the vocab-parallel form (Megatron's, and
    GSPMD's partitioning of it): each rank's max, sum of exponentials
    and label logit over its own vocab slice, as partial values reduced
    by (B, S)-sized all-reduces; the logits are never gathered, and
    their gradient stays on each rank's slice."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = logits.float()
    mesh = x.device_mesh
    bd, vd = _sharded_dims(x, 0), _sharded_dims(x, 2)
    pl_x = tuple(Shard(0) if i in bd else Shard(2) if i in vd
                 else Replicate() for i in range(mesh.ndim))
    pl_b = tuple(Shard(0) if i in bd else Replicate()
                 for i in range(mesh.ndim))
    if tuple(x.placements) != pl_x:
        x = x.redistribute(mesh, pl_x)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh,
                                    (Replicate(),) * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, pl_b).to_local().long()
    xl = x.to_local()
    B_l, S, V_l = xl.shape
    off = _rank_along(mesh, vd) * V_l     # this rank's slice of the vocab
    n_b = x.shape[0] // B_l

    def reduced(t, op):
        """A rank's partial (B_l, S) value, reduced over the vocab dims."""
        pl = tuple(Partial(op) if i in vd else p for i, p in enumerate(pl_b))
        return DTensor.from_local(t, mesh, pl, shape=(B_l * n_b, S),
                                  stride=(S, 1)
                                  ).redistribute(mesh, pl_b).to_local()
    m = reduced(xl.detach().amax(dim=-1), "max")
    sumexp = reduced(torch.exp(xl - m[..., None]).sum(dim=-1), "sum")
    mine = (lab >= off) & (lab < off + V_l)
    picked = torch.gather(xl, -1, (lab - off).clamp(0, V_l - 1)[..., None])
    ll = reduced(torch.where(mine, picked[..., 0],
                             torch.zeros((), device=xl.device)), "sum")
    nll = m + torch.log(sumexp) - ll
    return DTensor.from_local(nll, mesh, pl_b, shape=(B_l * n_b, S),
                              stride=(S, 1)).mean()


def decode_attention(plain, q, k_cache, v_cache, kv_len):
    """`plain(q, k_cache, v_cache, kv_len)` (decode attention: q (B, 1, H,
    D) over caches (B, S, KV, D)), on plain tensors as it is. On a DTensor
    cache sharded on its sequence, flash-decoding, as the reference's
    cache layout intends (`launch/specs.py`: GSPMD's partial softmax):
    q is replicated over the sequence's mesh dims, each rank attends to
    its own keys (its slice's positions masked by `kv_len`) and keeps
    its row's log-sum-exp, and the partial results combine by a max and
    two sums over those mesh dims."""
    if not is_dtensor(k_cache) or not _sharded_dims(k_cache, 1):
        return plain(q, k_cache, v_cache, kv_len)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    seq = _sharded_dims(k_cache, 1)
    bat = _sharded_dims(k_cache, 0)
    pl = [Replicate()] * mesh.ndim
    for i in bat:
        pl[i] = Shard(0)

    def rows(t):      # a plain tensor stands for the whole (replicated) one
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, tuple(pl)).to_local()
    q, kv_len = rows(q), rows(torch.as_tensor(kv_len, device=q.device))
    k, v = k_cache.to_local(), v_cache.to_local()
    B, _, H, D = q.shape
    S_loc, KV = k.shape[1], k.shape[2]
    split = _rank_along(mesh, seq)  # this rank's slice of the sequence
    k_pos = split * S_loc + torch.arange(S_loc, device=k.device)
    valid = k_pos[None, :] < kv_len.reshape(-1, 1).long()     # (B, S_loc)
    qh = (q.float() * D ** -0.5).reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    s = torch.where(valid[:, None, None], s,
                    torch.full((), -1e30, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / den[..., None]
    lse = torch.where(valid.any(-1)[:, None, None], m + torch.log(den),
                      torch.full((), float("-inf"), device=s.device))
    # stack the splits on a new leading dim, sharded over the sequence's
    # mesh dims, and combine there
    spl = list(pl)
    for i in bat:
        spl[i] = Shard(1)
    for i in seq:
        spl[i] = Shard(0)
    o = DTensor.from_local(o.reshape(1, B, H, D), mesh, tuple(spl))
    lse = DTensor.from_local(lse.reshape(1, B, H), mesh, tuple(spl))
    mx = lse.amax(0)
    w = torch.exp(lse - mx)
    out = (o * w[..., None]).sum(0) / w.sum(0)[..., None]
    # DTensor may leave the combine's heads sharded over the batch's mesh
    # dims; over two of them (2x16x16) unevenly
    return even_shards(out).reshape(out.shape[0], 1, H, D).to(q.dtype)


def replicated(plain, x):
    """A DTensor replicated on every mesh dim (differentiable: its
    gradient returns to x's layout); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    rep = (Replicate(),) * x.device_mesh.ndim
    x = reduce_partials(x)
    return x if tuple(x.placements) == rep \
        else x.redistribute(x.device_mesh, rep)


def gathered(plain, *xs):
    """Each DTensor in `xs` gathered in full on every rank and returned as
    a plain tensor (which the dry run's implicit replication reads as
    replicated); plain tensors as they are."""
    out = []
    for x in xs:
        if is_dtensor(x):
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh,
                               (Replicate(),) * x.device_mesh.ndim
                               ).to_local()
        out.append(x)
    return tuple(out)


def slstm_scan(plain, pre, c, n, m, h, r):
    """The sLSTM's token loop (`ssm._slstm_scan`) on each rank's own
    batch rows (`batch_local`): its state and gates are batch-major, its
    recurrent weights `r` replicated."""
    return batch_local(plain, (pre, c, n, m, h), (r,))


def counted_slstm_scan(counter, plain, pre, c, n, m, h, r):
    """The dry run's form of `slstm_scan`: `slstm_scan`'s, but the token
    loop is counted, not run. Every token step issues the same operations
    on tensors of the same shapes, so four steps run: the first two, one
    counted S - 3 times for steps 2 .. S - 2 (under `counter.scaled`, and
    in the backward through `counter.scaled_nodes`), and the last; the
    outputs have the full shapes. The memory of the steps that do not run
    is allocated in one piece (`_CountedScan`). The FLOPs, collectives
    and peak memory a record counts are the full loop's; the values are
    not (the dry run's tensors are fake). Sequences of fewer than 4
    tokens run the loop."""
    def scan(*args):
        if pre.shape[1] < 4:
            return plain(*args)
        hs, *state = _CountedScan.apply(counter, *args)
        return hs, tuple(state)
    return batch_local(scan, (pre, c, n, m, h), (r,))


def _edge(t):
    """The gradient edge of `t` if it needs a gradient, else None: it
    holds `t`'s node, not `t`."""
    from torch.autograd.graph import get_gradient_edge
    return get_gradient_edge(t) if t.requires_grad else None


def _sum(a, b):
    return b if a is None else a if b is None else a + b


def _step_rows(rows, S):
    """(B, S, ...) of rows[0], rows[1], S - 3 copies of rows[2] and
    rows[3]."""
    r0, r1, r2, r3 = (x[:, None] for x in rows)
    return torch.cat([r0, r1, r2.expand(-1, S - 3, *r2.shape[2:]), r3], 1)


class _CountedScan(torch.autograd.Function):
    """`ssm.slstm_scan` as steps 0, 1, one step counted S - 3 times for
    steps 2 .. S - 2, and step S - 1, forward and backward
    (`counted_slstm_scan`; S >= 4). Memory follows the full loop's.

    Where the ambient saved-tensor hooks keep what a graph saves (none,
    or an activation checkpoint's recompute), the four steps run as the
    loop does, on one graph over pre and r that keeps its saved tensors,
    counted as they are, and the S - 4 steps that do not run are stood
    for by one allocation of S - 4 times what step 1 saved beyond step 0
    (its graph's packed storages but the inputs every step shares: pre,
    r and the constant 1), given back as step 1's backward starts. The
    graph's gradient edges and that allocation ride on a tensor handed to
    the hooks as the loop's saved tensors are, so under a checkpoint the
    backward runs the recompute's graph, in one pass as the loop's: each
    step's tensors go as its nodes finish, pre's rows and r's gradients
    sum where the loop's do, and what step 2's nodes run counts S - 3
    times (their sequence numbers: `counter.scaled_nodes`).

    Where the hooks keep nothing (a checkpoint's first forward) or no
    gradient is wanted, the steps run without a graph, and S - 4 more of
    the h the loop keeps in its list until the stack are allocated."""

    @staticmethod
    def forward(ctx, counter, pre, c, n, m, h, r):
        S = pre.shape[1]
        one = torch.ones((), dtype=torch.float32, device=pre.device)
        hooks = torch._C._autograd._top_saved_tensors_default_hooks(False)

        def hand(t):
            """`t` handed to the hooks (kept here without them): the
            holder, and whether the hooks keep `t`."""
            alive = weakref.ref(t)
            return (hooks[0](t) if hooks else t), alive

        probe, alive = hand(torch.empty(0, device=pre.device))
        grad = any(ctx.needs_input_grad[1:]) and alive() is not None
        del probe
        shared = {id(t.untyped_storage()) for t in (pre, r, one)}
        packed, sizes, outs = {}, [], []

        def note(t):            # a storage a step saves
            st = t.untyped_storage()
            if id(st) not in shared:
                packed[id(st)] = st.nbytes()
            return t

        # the steps' graph keeps its saved tensors itself: it is the one
        # the backward runs, which reads them inside `scaled_nodes`
        with torch.enable_grad() if grad else torch.no_grad(), \
                torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
            state = (c, n, m, h)

            def step(t):
                out = slstm_step(pre[:, t], *state, r, one)
                outs.append(out)
                sizes.append(sum(packed.values()))
                return out
            for t in (0, 1):
                state = step(t)
            # steps 2 .. S - 3: what they save, or the h they list
            per = (sizes[1] - sizes[0] if grad
                   else state[3].untyped_storage().nbytes())
            stand = torch.empty(((S - 4) * per,), dtype=torch.uint8,
                                device=pre.device)
            with counter.scaled(S - 3):
                state = step(2)
            state = step(3)
        hs = [o[3] for o in outs]
        out = _step_rows([x.detach() for x in hs], S)
        carrier = torch.empty(0, device=pre.device)
        if grad:
            # step i's nodes: sequence numbers up to its outputs' last
            last = [max((x.grad_fn for x in o), key=lambda f:
                        f._sequence_nr()) for o in outs[1:3]]
            # step 1's last node is the first of it to run back: step 2's
            # backward is done, and the missing steps' bytes go
            carrier.stand = box = [stand]
            last[0].register_prehook(lambda grads: box.clear())
            carrier.graph = (
                [_edge(x) for x in (*hs, *state[:3])],
                [_edge(x) for x in (pre, c, n, m, h, r)],
                tuple(f._sequence_nr() for f in last))
        del outs, hs, stand
        ctx.held, _ = hand(carrier)
        del carrier
        ctx.counter, ctx.S = counter, S
        ctx.give = hooks[1] if hooks else None
        # an output the caller drops gets no gradient (the loop's would
        # get none), not a zero tensor
        ctx.set_materialize_grads(False)
        return (out, *(t.detach() for t in state))

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm, dh):
        counter, S, held = ctx.counter, ctx.S, ctx.held
        del ctx.held
        # under a checkpoint this reads the recompute's graph (and runs
        # the recompute if no earlier read ran it)
        carrier = ctx.give(held) if ctx.give is not None else held
        outs, ins, (lo, hi) = carrier.graph
        del carrier.graph, carrier, held
        rows = (None,) * 4 if dhs is None else tuple(
            dhs[:, t] for t in (0, 1, S - 2, S - 1))
        gouts = [*rows[:3], rows[3] if dh is None else _sum(rows[3], dh),
                 dc, dn, dm]
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if o is not None and g is not None]
        want = [i for i in ins if i is not None]
        del outs, gouts, rows
        if not pairs or not want:
            return (None,) * 7
        with counter.scaled_nodes(lo, hi, S - 3):
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True))
        return (None, *(next(got) if i is not None else None for i in ins))


def batch_local(fn, batched, replicated=()):
    """`fn(*batched, *replicated)`, whose inputs and outputs (a tensor or
    nested tuples of tensors) are all batch-major but `replicated`. On
    plain tensors as it is. On DTensors `fn` runs on each rank's own
    batch rows (the mesh dims that shard the first batched input's batch
    dim; every other dim replicated), as plain tensors: a long
    elementwise recurrence (the sLSTM's token loop) then costs plain
    dispatches, not DTensor ones. The outputs are DTensors sharded the
    same way."""
    x0 = batched[0]
    if not is_dtensor(x0):
        return fn(*batched, *replicated)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map
    mesh = x0.device_mesh
    dims = _sharded_dims(x0, 0)
    pl = tuple(Shard(0) if i in dims else Replicate()
               for i in range(mesh.ndim))
    rep = (Replicate(),) * mesh.ndim
    n = 1
    for i in dims:
        n *= mesh.size(i)

    def rows(t):      # a plain tensor stands for the whole (replicated) one
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, pl).to_local()
    # a replicated input's gradient from one rank's rows is a partial sum
    # over the batch dims
    part = tuple(Partial() if i in dims else Replicate()
                 for i in range(mesh.ndim))
    local = [rows(t) for t in batched] + \
        [t.redistribute(mesh, rep).to_local(grad_placements=part)
         if is_dtensor(t) else t for t in replicated]
    out = fn(*local)
    return tree_map(
        lambda t: DTensor.from_local(
            t, mesh, pl, shape=(t.shape[0] * n, *t.shape[1:]),
            stride=t.contiguous().stride()), out)


def log_sigmoid(plain, x):
    """`plain(x)`; on a DTensor `-softplus(-x)`, the same function
    through an op DTensor shards pointwise (it has no strategy for
    log_sigmoid's forward, which returns a second buffer)."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return plain(x)
    return -F.softplus(-x)


def bincount(plain, x, n: int):
    """`plain(x, n)`; on a DTensor (no sharding strategy for bincount)
    the sum of a one-hot comparison, which reduces over a sharded x by a
    small all-reduce."""
    if not is_dtensor(x):
        return plain(x, n)
    return (x[:, None] == torch.arange(n, device=x.device)).sum(0)


def embed(plain, table, tokens):
    """`plain(table, tokens)`; on a DTensor table whose vocab dim is
    sharded, the
    vocab-parallel lookup: each rank looks up the tokens in its own
    vocab slice (zeros elsewhere) and the partial rows are summed by one
    all-reduce, where indexing would gather the whole table."""
    if not is_dtensor(table):
        return plain(table, tokens)
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vd = _sharded_dims(table, 0)
    pl_t = tuple(Shard(0) if i in vd else Replicate()
                 for i in range(mesh.ndim))
    if tuple(table.placements) != pl_t:
        table = table.redistribute(mesh, pl_t)
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    bd = [i for i in _sharded_dims(tokens, 0) if i not in vd]
    pl_b = tuple(Shard(0) if i in bd else Replicate()
                 for i in range(mesh.ndim))
    tok = tokens.redistribute(mesh, pl_b).to_local().long()
    # each rank's table gradient covers its own tokens only: a partial
    # sum over the token dims
    tl = table.to_local(grad_placements=tuple(
        Partial() if i in bd else p for i, p in enumerate(pl_t)))
    V_l = tl.shape[0]
    off = _rank_along(mesh, vd) * V_l     # this rank's slice of the vocab
    mine = ((tok >= off) & (tok < off + V_l))[..., None]
    rows = F.embedding((tok - off).clamp(0, V_l - 1), tl)
    out = torch.where(mine, rows, torch.zeros((), dtype=rows.dtype))
    n_b = tokens.shape[0] // tok.shape[0]
    shape = (out.shape[0] * n_b, *out.shape[1:])
    pl = tuple(Partial() if i in vd else p for i, p in enumerate(pl_b))
    return DTensor.from_local(out, mesh, pl, shape=shape,
                              stride=out.stride()).redistribute(mesh, pl_b)


def write_prefix(plain, layer, t):
    """`plain(layer, t)`: `layer[:, :W] = t` in place, W = t.shape[1], a
    prefill's K/V into one layer's cache (B, S_buf, ...). On a DTensor
    layer a slice of its
    sharded sequence dim is not a safe destination (DTensor writes the
    wrong rows), so the whole layer is written: t itself when it fills
    the layer, else the layer gathered along its sequence, written
    there, and laid out again."""
    W = t.shape[1]
    if not is_dtensor(layer):
        return plain(layer, t)
    if W == layer.shape[1]:
        layer.copy_(t)
        return layer
    seq = _sharded_dims(layer, 1)
    full = _replicate_dims(layer, seq)
    full[:, :W] = _replicate_dims(t, _sharded_dims(t, 1)) \
        if is_dtensor(t) else t
    layer.copy_(full.redistribute(layer.device_mesh, layer.placements))
    return layer


def write_rows(plain, cache, rows, idx, val):
    """`plain(cache, rows, idx, val)`: `cache[rows, idx] = val` in place,
    a decode step's new K/V row per sequence. On a DTensor whose written
    dims are sharded no in-place scatter keeps the layout, so the row is selected in elementwise
    (`where` over a one-hot of `idx` along dim 1), as GSPMD lowers an
    update into a sharded dim."""
    if not is_dtensor(cache):
        return plain(cache, rows, idx, val)
    S = cache.shape[1]
    hit = torch.arange(S, device=cache.device)[None, :] == idx[:, None]
    hit = hit.reshape(*hit.shape, *([1] * (cache.ndim - 2)))
    if is_dtensor(hit):      # laid out like the cache: no gather of it
        hit = hit.redistribute(cache.device_mesh, cache.placements)
    cache.copy_(torch.where(hit, val[:, None].to(cache.dtype), cache))
    return cache


def gather_data_axes(x):
    """A DTensor weight with its data-axis shards gathered (the FSDP
    all-gather; its gradient comes back as the reduce-scatter), its
    'model' shards kept. Identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    dp = {mesh.mesh_dim_names.index(a) for a in data_axes(mesh)}
    pl = tuple(Replicate() if i in dp else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


def gather_stack_axes(x, depth: int, name: str):
    """A layer stack `x` (its first `depth` dims the stack axes) with the
    mesh dims that shard a stack axis gathered, noted: a per-layer view
    of a stack sharded on its layer axis would gather the whole stack at
    every view (GSPMD reshards silently). Identity otherwise."""
    if not is_dtensor(x):
        return x
    dims = [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim < depth]
    if not dims:
        return x
    names = [x.device_mesh.mesh_dim_names[i] for i in dims]
    _NOTES.add(f"{name}: FSDP shards a layer axis over {names}; gathered "
               f"along it once for the step, before the per-layer views")
    return _replicate_dims(x, dims)


def layer_weights(plain, lp):
    """One layer's weights at their use (`model.layer_weights`), each
    DTensor leaf's FSDP shards gathered there (`gather_data_axes`): one
    all-gather per sharded leaf each time a block runs (its forward, and
    a checkpointed block's recompute), one reduce-scatter per leaf as its
    gradient; between layers a rank keeps only its shards, as GSPMD
    gathers inside the layer scan."""
    from torch.utils._pytree import tree_map
    return tree_map(gather_data_axes, plain(lp))


def routed_dropless(plain, p, xf, flat_e, counts, gate2, T, K, E):
    """The MoE's dropless routing, which only the decode steps take (the
    train step and prefill take the capacity path): the reference's own
    dropless form, the capacity dispatch at C = T*K slots, whose
    cross-rank plan (`dispatch`, `combine`) keeps the buffer sharded
    (the plain form's grouped products have no sharding rule)."""
    from repro_torch.models import moe
    return moe._routed_capacity(p, xf, flat_e, counts, gate2, T, K, E,
                                T * K)[0]


class _MoePlan:
    """Who sends which rows where in the capacity dispatch on DTensors
    (`dispatch`, `combine`), from the tokens' layout and the replicated
    int routing (slot, keep of each of the T*K pairs).

    The tokens (T, d) are sharded by rows over the mesh dims `td` (n
    shards of T_loc, as the batch is), replicated over the rest. The
    buffer (E, C, d) is laid out as the reference pins it: experts over
    'model' (where E divides by it; `md`), slots over `td`, so a rank
    holds (E_loc, C_loc, d), L = E_loc * C_loc rows. A kept pair (t, k)
    of expert e at position c lives in the buffer on data rank c //
    C_loc, row (e % E_loc) * C_loc + c % C_loc, of model rank e // E_loc,
    and its token on data rank t // T_loc: within each model column the
    payload moves between the `td` ranks as one all-to-all, each rank
    sending its own tokens of the column's experts to the slots' ranks
    (sorted by destination, then buffer row) and receiving its slots'
    tokens (sorted by source, then buffer row). Every rank builds the
    whole plan from the replicated ints; its rows and splits depend on
    the routing, which a fake step cannot read: there the all-to-all
    moves L rows each way, even splits (the receive's bound, and the
    send's mean)."""

    def __init__(self, tok, slot, keep, E, C):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = self.mesh = tok.device_mesh
        td = self.td = _sharded_dims(tok, 0)
        n = math.prod(mesh.size(i) for i in td)
        names = mesh.mesh_dim_names
        md = names.index("model") if "model" in names else None
        if md is not None and (md in td or E % mesh.size(md)):
            md = None
        tp = mesh.size(md) if md is not None else 1
        T = tok.shape[0]
        K = slot.shape[0] // T
        self.ok = bool(td) and T % n == 0 and C % n == 0
        if not self.ok:
            return
        self.n, self.T, self.E, self.C = n, T, E, C
        self.T_loc, E_loc, C_loc = T // n, E // tp, C // n
        self.E_loc, self.C_loc = E_loc, C_loc
        L = self.L = E_loc * C_loc
        ndim = mesh.ndim
        self.tok_pl = tuple(Shard(0) if i in td else Replicate()
                            for i in range(ndim))
        # a column's rows carry its own experts' share of a token's
        # output and gradient: partial sums over 'model'
        self.tok_part = tuple(Shard(0) if i in td else Partial()
                              if i == md else Replicate()
                              for i in range(ndim))
        self.buf_pl = tuple(Shard(1) if i in td else Shard(0) if i == md
                            else Replicate() for i in range(ndim))
        if len(td) == 1:
            self.group = (mesh, td[0])
        else:       # one group over ('pod', 'data'): the mesh's own ranks
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                self.group = mesh[tuple(names[i] for i in td)]._flatten()
        me = _rank_along(mesh, td)
        col = mesh.get_local_rank(md) if md is not None else 0
        dev = slot.device
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(slot):
            even = [L // n + (i < L % n) for i in range(n)]
            self.send_splits = self.recv_splits = even
            self.send_tok, self.send_pair, self.recv_rows = (
                torch.zeros(L, dtype=torch.long, device=dev)
                for _ in range(3))
            return
        pair = torch.arange(T * K, device=dev)
        t, e, c = pair // K, slot // C, slot % C
        ours = keep & (e // E_loc == col)
        dst, src = c // C_loc, t // self.T_loc
        row = (e % E_loc) * C_loc + c % C_loc

        def listed(sel, by):
            idx = torch.nonzero(sel)[:, 0]
            idx = idx[torch.argsort(by[idx] * L + row[idx])]
            return idx, torch.bincount(by[idx], minlength=n).tolist()
        out, self.send_splits = listed(ours & (src == me), dst)
        inn, self.recv_splits = listed(ours & (dst == me), src)
        self.send_tok = t[out] - me * self.T_loc
        self.send_pair = self.send_tok * K + pair[out] % K
        self.recv_rows = row[inn]

    def rows(self, x):
        """This rank's rows of token-sharded DTensor `x` (T, ...), as a
        plain tensor whose gradient is partial over 'model'."""
        if tuple(x.placements) != self.tok_pl:
            x = reduce_partials(x).redistribute(self.mesh, self.tok_pl)
        return x.to_local(grad_placements=self.tok_part)

    def all_to_all(self, x, out_splits, in_splits):
        """`x`'s rows exchanged within the column (differentiable: the
        gradient takes the reverse exchange)."""
        from torch.distributed._functional_collectives import \
            all_to_all_single_autograd
        return all_to_all_single_autograd(x.contiguous(), out_splits,
                                          in_splits, self.group)


def _moe_plan(tok, slot, keep, E, C):
    """The `_MoePlan` of token-sharded DTensor `tok` (T, ...) and plain
    routing ints, or None where the forms do not apply (the tokens not
    sharded evenly, or the slots not dividing over their shards)."""
    if not is_dtensor(tok) or is_dtensor(slot):
        return None
    plan = _MoePlan(tok, slot, keep, E, C)
    if not plan.ok:
        names = [plan.mesh.mesh_dim_names[i] for i in plan.td]
        _NOTES.add(f"MoE dispatch: {tok.shape[0]} tokens, {C} slots over "
                   f"the token shards {names}: the plain dispatch, the "
                   f"whole ({E}, {C}, d) buffer on every rank")
        return None
    return plan


def dispatch(plain, xf, slot, keep, E, C):
    """`plain(xf, slot, keep, E, C)`, the (E, C, d) capacity buffer of
    tokens xf (T, d). On DTensor tokens sharded over the data axes each
    rank builds only its own shard of the buffer (`_MoePlan`: experts
    over 'model', slots over the data axes): it sends its tokens of its
    column's experts to their slots' ranks and places the rows it
    receives, by one all-to-all; no rank holds the whole buffer or the
    whole (T, d). Its gradient takes the reverse exchange back to the
    tokens."""
    from torch.distributed.tensor import DTensor
    plan = _moe_plan(xf, slot, keep, E, C)
    if plan is None:
        return plain(xf, slot, keep, E, C)
    xl = plan.rows(xf)
    d = xl.shape[1]
    got = plan.all_to_all(xl.index_select(0, plan.send_tok),
                          plan.recv_splits, plan.send_splits)
    buf = torch.zeros((plan.L, d), dtype=xl.dtype, device=xl.device
                      ).index_copy(0, plan.recv_rows, got)
    return DTensor.from_local(buf.view(plan.E_loc, plan.C_loc, d),
                              plan.mesh, plan.buf_pl, shape=(E, C, d),
                              stride=_strides((E, C, d)))


def combine(plain, out_buf, slot, keep, gate2):
    """`plain(out_buf, slot, keep, gate2)`, each token's gated expert
    outputs (T, d). On DTensors laid out as `dispatch` leaves them, each
    buffer row goes back to its token's rank by the reverse all-to-all,
    and each rank sums its own tokens' rows, gated (an index_add); the
    result is sharded as the tokens are, a partial sum over 'model'
    (each column's experts), which the next layout change reduces."""
    from torch.distributed.tensor import DTensor
    E, C, d = out_buf.shape
    plan = _moe_plan(gate2, slot, keep, E, C)
    if plan is None or not is_dtensor(out_buf):
        return plain(out_buf, slot, keep, gate2)
    if tuple(out_buf.placements) != plan.buf_pl:
        out_buf = out_buf.redistribute(plan.mesh, plan.buf_pl)
    ol = out_buf.to_local().reshape(plan.L, d)
    got = plan.all_to_all(ol.index_select(0, plan.recv_rows),
                          plan.send_splits, plan.recv_splits)
    gate = plan.rows(gate2).reshape(-1).index_select(0, plan.send_pair)
    routed = torch.zeros((plan.T_loc, d), dtype=ol.dtype, device=ol.device
                         ).index_add(0, plan.send_tok,
                                     got * gate.to(ol.dtype)[:, None])
    return DTensor.from_local(routed, plan.mesh, plan.tok_part,
                              shape=(plan.T, d), stride=_strides((plan.T, d)))


def in_proj(plain, x, w, sizes):
    """`plain(x, w, sizes)`: `x @ w` split along its last dim. On a
    DTensor weight sharded on its output dim over mesh dims whose extent
    divides every piece (Mamba2's fused in-projection: z, x, B, C and dt
    over 'model'), each piece comes out sharded on its own channels, as
    a column-parallel projection's, laid out as the fused product was:
    slicing the fused product at the pieces' bounds, which do not fall on
    its shards' bounds, would leave each piece whole on every rank. Of
    the fused weight (d, sum of sizes) and the product (a rank's rows,
    sum of sizes), the smaller is gathered: a prefill's or a train
    step's rows outnumber d, so the weight, and one product per piece on
    that piece's columns; a decode step's few rows, so the product,
    then each piece re-sharded where it lies (no collective). The same
    FLOPs either way."""
    dims = _sharded_dims(w, w.ndim - 1) if is_dtensor(w) else []
    if not dims:
        return plain(x, w, sizes)
    mesh = w.device_mesh
    n = math.prod(mesh.size(i) for i in dims)
    if any(s % n for s in sizes):
        _NOTES.add(f"in-projection pieces {tuple(sizes)} do not divide "
                   f"over {n} ranks: the fused product, sliced")
        return plain(x, w, sizes)
    rows = math.prod((x.to_local() if is_dtensor(x) else x).shape[:-1])
    if rows <= w.shape[0]:
        y = x @ w
        pl = y.placements
        return tuple(t.redistribute(mesh, pl) for t in
                     torch.split(_replicate_dims(y, dims), sizes, dim=-1))
    full = _replicate_dims(w, dims)
    out, a = [], 0
    for s in sizes:
        out.append(x @ full[..., a:a + s].redistribute(mesh, w.placements))
        a += s
    return tuple(out)


def _local_at(t, mesh, placements, grad=None):
    """This rank's local tensor of `t` laid out at `placements` (a plain
    `t` stands for a replicated one; partial sums reduced first); `grad`:
    the placements of its gradient, as `to_local` takes them."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    t = reduce_partials(t)
    if tuple(t.placements) != placements:
        t = t.redistribute(mesh, placements)
    return t.to_local(grad_placements=grad)


def ssd_chunked(plain, x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
    """`plain(...)` (the chunked SSD: x (B, S, H, P), dt (B, S, H), A
    (H,), Bm, Cm (B, S, G, N), initial_state (B, H, N, P) or None). On
    DTensors each rank runs its own batch rows (the mesh dims that shard
    x's batch) and its own heads over 'model', as the reference's specs
    shard the SSM state's heads (`ssm_state`: H over 'model'): every
    head is independent, so the (B, nc, Q, Q, H) f32 tensors hold H /
    |model| heads a rank. Bm and Cm stay whole over 'model' (one group:
    every head reads it; their gradient is a partial sum there), A's
    gradient sums over the batch dims. The outputs are DTensors: y
    sharded like x, the final state (B, H, N, P) on the batch and heads.
    As it is where 'model' does not divide H (or G > 1 does not divide
    over it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    kw = dict(chunk=chunk, initial_state=initial_state)
    if not is_dtensor(x) or "model" not in x.device_mesh.mesh_dim_names:
        return plain(x, dt, A, Bm, Cm, **kw)
    mesh = x.device_mesh
    md = mesh.mesh_dim_names.index("model")
    bd = [i for i in _sharded_dims(x, 0) if i != md]
    tp = mesh.size(md)
    B, S, H, P = x.shape
    G = Bm.shape[2]
    if H % tp or (G > 1 and G % tp) or B % math.prod(mesh.size(i)
                                                    for i in bd):
        _NOTES.add(f"SSD: {H} heads, {G} groups over 'model' ({tp}): "
                   f"every head on every rank")
        return plain(x, dt, A, Bm, Cm, **kw)

    def pl(heads):
        """Shard(0) on the batch dims, `heads` on 'model'."""
        return tuple(Shard(0) if i in bd else heads if i == md
                     else Replicate() for i in range(mesh.ndim))

    def local(t, placements, grad=None):
        return None if t is None else _local_at(t, mesh, placements, grad)
    grp = Shard(2) if G > 1 else Replicate()
    a_pl = tuple(Shard(0) if i == md else Replicate()
                 for i in range(mesh.ndim))
    y, s = plain(
        local(x, pl(Shard(2))), local(dt, pl(Shard(2))),
        local(A, a_pl, tuple(Shard(0) if i == md else Partial() if i in bd
                             else Replicate() for i in range(mesh.ndim))),
        *(local(t, pl(grp), pl(grp if G > 1 else Partial()))
          for t in (Bm, Cm)),
        chunk=chunk, initial_state=local(initial_state, pl(Shard(1))))
    shape = (B, H, *s.shape[2:])
    # (the einsums may leave y's local strides permuted; the global
    # strides given are contiguous ones)
    return (DTensor.from_local(y.contiguous(), mesh, pl(Shard(2)),
                               shape=x.shape, stride=_strides(x.shape)),
            DTensor.from_local(s.contiguous(), mesh, pl(Shard(1)),
                               shape=shape, stride=_strides(shape)))


def _ssd_step_plan(state):
    """The state's placements if they shard nothing but its (b, h) dims
    (the block `ssd_step`'s form runs on each rank), else None."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(state.placements)
    if all(type(p) is Replicate or (type(p) is Shard and p.dim < 2)
           for p in pl):
        return pl
    return None


def ssd_step(plain, state, dec, dt, x, Bm, Cm):
    """`plain(...)` (one token of the SSD recurrence: state (B, H, N, P),
    dec, dt (B, H), x (B, H, P), Bm, Cm (B, G, N)). On a DTensor state
    each rank runs the plain body on its own (b, h) block of the state,
    as plain tensors (`_ssd_step_plan`), with B and C whole on the
    rank's rows (one group: every head reads it): DTensor's own einsums
    view (b, h) as one dim, which torch 2.11 refuses while h is sharded,
    and gather the whole state's heads where B and C come in sharded by
    channel. The outputs are DTensors at the state's placements. As it
    is, noted, where the state is sharded on N or P or holds partial
    sums, or where there is more than one group."""
    if not is_dtensor(state):
        return plain(state, dec, dt, x, Bm, Cm)
    pl = _ssd_step_plan(state)
    G = Bm.shape[1]
    if pl is None or G > 1:
        _NOTES.add(f"SSD decode step: state {tuple(state.shape)} at "
                   f"{tuple(state.placements)}, {G} groups: DTensor's "
                   f"einsums")
        return plain(state, dec, dt, x, Bm, Cm)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = state.device_mesh
    rows = tuple(Replicate() if type(p) is Shard and p.dim == 1 else p
                 for p in pl)
    s, y = plain(*(_local_at(t, mesh, pl) for t in (state, dec, dt, x)),
                 *(_local_at(t, mesh, rows) for t in (Bm, Cm)))
    return tuple(DTensor.from_local(t.contiguous(), mesh, pl, shape=shape,
                                    stride=_strides(shape))
                 for t, shape in ((s, state.shape), (y, x.shape)))


# the `replaceable` functions' names -> their DTensor forms
FORMS = {
    "pin_grad": pin_grad, "split_heads": split_heads,
    "attention": attention, "rmsnorm": norm, "layernorm": norm,
    "cross_entropy": cross_entropy, "decode_attention": decode_attention,
    "embed": embed, "write_prefix": write_prefix, "write_rows": write_rows,
    "routed_dropless": routed_dropless, "bincount": bincount,
    "dispatch": dispatch, "combine": combine, "ssd_chunked": ssd_chunked,
    "ssd_step": ssd_step, "in_proj": in_proj,
    "replicated": replicated, "gathered": gathered,
    "log_sigmoid": log_sigmoid, "slstm_scan": slstm_scan,
    "layer_weights": layer_weights,
}
