"""The dry run's DTensor path computes the model's own function: four
real CPU processes (`gloo` on localhost) form a (2, 2) and a (1, 4)
("data", "model") mesh, distribute the smoke configs' weights and
inputs to the port's specs (`launch.specs`, FSDP included), and run the
model on DTensors under the reference's activation specs, as
`launch.dryrun` does on fake tensors, with the dry run's DTensor forms
installed (`launch.dtensor_forms`): the model built by
`specs.sharded_model`, so each layer's FSDP shards are gathered where
its block uses them and its gradient comes back reduce-scattered. The
loss, every gradient, and the prefill + decode logits must equal the
plain model's on the same weights (f32, atol 1e-5: sums taken in
another order). The (1, 4) mesh
splits granite-3-2b smoke's 2 KV heads over 4 ranks, so the forms of
`split_heads` and `attention` (`gqa_heads`) run; the (2, 2) mesh the
vocab-parallel loss, the flash-decoding over the sequence-sharded cache
(`decode_attention`) and the decode row write (`write_rows`);
deepseek-moe-16b smoke the capacity dispatch of the train step and
prefill and the dropless dispatch of decode, each rank's buffer shard
built by an all-to-all (`dispatch`, `combine`; every call checked to
make its cross-rank plan); zamba2-2.7b smoke the Mamba2 in-projection
and conv by channel, the SSD on each rank's heads (`in_proj`,
`ssd_chunked`) and the decode step's state update on each rank's (b, h)
block (`ssd_step`; every decode call checked to make that plan);
xlstm-1.3b smoke (tests/test_torch_act_sharding_ssm.py) the sLSTM token
loop on each rank's own rows (`slstm_scan`)."""
import socket

import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, arch, mesh_shape, serve, errors):
    import dataclasses
    import os
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    try:
        _check(arch, mesh_shape, serve, dataclasses)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        import traceback
        errors.put((rank, f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()[-3000:]}"))
    finally:
        dist.destroy_process_group()


def _check_slstm(mesh_shape):
    """One sLSTM layer (xlstm-1.3b smoke) on DTensors against the plain
    layer: output and every parameter's gradient."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.launch.dtensor_forms import FORMS
    from repro_torch.models import ssm
    from repro_torch.models.act_sharding import forms, placements
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = ssm.init_slstm(cfg, g, torch.float32, "cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    pp = {k: v.clone().requires_grad_() for k, v in p.items()}
    want, _ = ssm.slstm_forward(cfg, pp, x)
    (want ** 2).sum().backward()
    with forms(FORMS), implicit_replication():
        dp = {k: distribute_tensor(v, mesh, placements(mesh, specs._fit(
            mesh, specs._param_spec(k, v), tuple(v.shape))))
            .requires_grad_() for k, v in p.items()}
        dx = distribute_tensor(x, mesh, placements(mesh, ("data",)))
        got, _ = ssm.slstm_forward(cfg, dp, dx)
        (got ** 2).sum().backward()
        torch.testing.assert_close(got.full_tensor(), want, atol=1e-5,
                                   rtol=1e-5)
        for k in p:
            torch.testing.assert_close(dp[k].grad.full_tensor(),
                                       pp[k].grad, atol=1e-4, rtol=1e-4,
                                       msg=k)


def _check(arch, mesh_shape, serve, dataclasses):
    if arch == "slstm":
        return _check_slstm(mesh_shape)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dtensor_forms, specs
    from repro_torch.launch.dryrun import _contexts
    from repro_torch.models import build_model
    from repro_torch.models.act_sharding import placements
    from repro_torch.models.model import flatten_params

    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    cfg = specs.tp_config(dataclasses.replace(get_smoke_config(arch),
                                              dtype="float32"), mesh)
    plain = build_model(cfg, device="cpu", seed=3)
    flat = flatten_params(plain.params)
    p_spec = specs.param_shardings(mesh, flat, fsdp=True)
    dparams = {k: distribute_tensor(v.detach(), mesh,
                                    placements(mesh, p_spec[k]))
               for k, v in flat.items()}
    B, S = 4, 32 if arch != "xlstm-1.3b" else 8
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": tokens, "labels": labels}
    b_spec = specs.batch_shardings(mesh, batch, B)
    dbatch = {k: distribute_tensor(v, mesh, placements(mesh, b_spec[k]))
              for k, v in batch.items()}

    def close(got, want, what):
        if isinstance(got, DTensor):
            got = got.full_tensor()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                                   msg=what)

    # the forms' plans on each rank's own block, made at every call: the
    # MoE's cross-rank dispatch in every step, the SSD's decode step on
    # the state's (b, h) block in every decode
    used = {"_moe_plan": [], "_ssd_step_plan": []}

    def traced(name):
        plan = getattr(dtensor_forms, name)

        def run(*args):
            out = plan(*args)
            used[name].append(out is not None)
            return out
        setattr(dtensor_forms, name, run)
    for name in used:
        traced(name)

    def planned(what):
        name = {"moe": "_moe_plan", "hybrid": "_ssd_step_plan"}.get(
            cfg.family)
        if name and (cfg.family == "moe" or what.startswith("decode")):
            assert used[name] and all(used[name]), \
                f"{what}: {name} {used[name]}"
        for calls in used.values():
            calls.clear()

    # train: loss and every gradient
    plain.requires_grad_(True)
    want_loss, _ = plain.loss(batch)
    want_loss.backward()
    with _contexts(cfg, "train_4k", mesh, False), implicit_replication():
        model = specs.sharded_model(cfg, dparams)
        model.requires_grad_(True)
        loss, _ = model.loss(dbatch)
        loss.backward()
        close(loss, want_loss.detach(), "loss")
        for k, p in flatten_params(model.params).items():
            close(specs._grad(p), specs._grad(flat[k]), f"grad {k}")
    planned("train")
    if not serve:
        return
    # prefill + one decode step over a cache laid out by the specs
    cache = plain.init_cache(B, S + 8)
    with torch.no_grad():
        want_p, cache = plain.prefill({"tokens": tokens}, cache)
        want_d, _ = plain.decode(want_p.argmax(-1), cache)
        model = specs.sharded_model(cfg, dparams)
        dcache = model.init_cache(B, S + 8)
        c_spec = specs.cache_shardings(mesh, dcache, B)
        dcache = {k: (distribute_tensor(v, mesh, placements(mesh, c_spec[k]))
                      if isinstance(v, torch.Tensor) else v)
                  for k, v in dcache.items()}
        with _contexts(cfg, "prefill_32k", mesh, False), \
                implicit_replication():
            got_p, dcache = model.prefill({"tokens": dbatch["tokens"]},
                                          dcache)
        close(got_p, want_p, "prefill logits")
        planned("prefill")
        with _contexts(cfg, "decode_32k", mesh, False), \
                implicit_replication():
            tok = distribute_tensor(want_p.argmax(-1), mesh,
                                    placements(mesh, (("data",),)))
            got_d, _ = model.decode(tok, dcache)
        close(got_d, want_d, "decode logits")
        planned("decode (dropless)")


def run_on_gloo(arch, mesh_shape, serve=True):
    """`_check` in four spawned processes (with `serve`, prefill and
    decode too); fails with the first rank's error."""
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    mp.start_processes(_worker, args=(_free_port(), arch, mesh_shape,
                                      serve, errors),
                       nprocs=WORLD, start_method="spawn")
    if not errors.empty():
        rank, msg = errors.get()
        pytest.fail(f"rank {rank}: {msg}")


@pytest.mark.parametrize("arch,mesh_shape", [
    ("granite-3-2b", (2, 2)), ("granite-3-2b", (1, 4)),
    ("deepseek-moe-16b", (2, 2)), ("zamba2-2.7b", (2, 2))])
def test_dtensor_step_equals_plain_model(arch, mesh_shape):
    run_on_gloo(arch, mesh_shape)
