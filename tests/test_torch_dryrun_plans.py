"""The dry run's plans that a card would make (`repro_torch.launch.
dryrun`, fake tensors on the 16x16 and 2x16x16 placeholder meshes, smoke
configs widened where a case needs it, f32, test-only shapes): for each
case the largest storage a rank allocates inside the case's code, held
against a hand count of the sharded tensor, where the parent's plan held
the whole one:

* the MoE's capacity dispatch under the buffer pin (experts > 'model')
  and without it (experts == 'model'): each rank builds its own shard of
  the (E, C, d) buffer by an all-to-all and sums its own tokens' rows
  back (`dtensor_forms.dispatch`, `combine`), so nothing larger than its
  (T / dp, d) token rows;
* whisper's sinusoid positions, one row broadcast over the batch
  (every row's positions are the same);
* Mamba2's conv on each rank's own channels and the SSD's (B, nc, Q, Q,
  H) tensors on its own heads (`dtensor_forms.in_proj`, `ssd_chunked`);
* a microbatch whose rows do not split over 2x16x16's 32 data ranks,
  built from each rank's own rows (`dtensor_forms.microbatch_rows`).

Also: the MoE forms compute the plain capacity path's values and
gradients (plain tensors, and a one-rank gloo mesh where they run; the
4-process mesh is tests/test_torch_act_sharding.py's), and the pinned MoE
step's FLOPs equal the unformed step's."""
import dataclasses

import pytest
import torch

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, dtensor_forms, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.act_sharding import placements
from torch_parity import two_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

MESHES = [(False, 16), (True, 32)]     # (multi_pod, data ranks)


@pytest.fixture(autouse=True, scope="module")
def no_group_after():
    """No process group outlives the module."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


class _Largest(dryrun._LocalCounter):
    """`_LocalCounter` that keeps the largest storage allocated while a
    scope is open (`scope`), by scope name."""

    runs: list = []

    def __init__(self):
        super().__init__()
        self.open, self.largest = [], {}
        _Largest.runs.append(self)

    def _storage(self, t, new):
        key = super()._storage(t, new)
        if new and key is not None and self.open:
            for name in self.open:
                self.largest[name] = max(self.largest.get(name, 0),
                                         self._held[key])
        return key


def _scoped(name, fn):
    """`fn` with the newest `_Largest` run's scope `name` open inside."""
    def run(*args, **kwargs):
        c = _Largest.runs[-1]
        c.open.append(name)
        try:
            return fn(*args, **kwargs)
        finally:
            c.open.remove(name)
    return run


def _record(monkeypatch, arch, cfg, kind, S, B, multi):
    """One record of `cfg` in f32 at a test-only shape, counted by
    `_Largest`."""
    name = f"{kind}_plans_test"
    monkeypatch.setitem(SHAPES, name, InputShape(name, S, B, kind))
    monkeypatch.setattr(dryrun, "_LocalCounter", _Largest)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rec = dryrun.run_one(arch, name, multi, cfg=cfg)
    assert rec["ok"], rec.get("traceback")
    return rec, _Largest.runs[-1]


def _moe_cfg(arch, n_experts):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts))


# deepseek-moe-16b smoke widened to 32 experts (> 'model': the buffer
# pin), llama4-scout smoke to 16 (== 'model': no pin)
MOE = [("deepseek-moe-16b", 32), ("llama4-scout-17b-a16e", 16)]


@pytest.mark.parametrize("multi,dp", MESHES)
@pytest.mark.parametrize("arch,E", MOE)
def test_moe_dispatch_builds_each_ranks_shard(monkeypatch, arch, E, multi,
                                              dp):
    """Prefill, B 32 x S 256: T = 8192 tokens, C = T K / E 1.25 slots,
    experts over 'model' (E / 16 a rank), slots over the data ranks.
    Inside the dispatch and the combine the largest storage is a rank's
    own token rows, (T / dp, d) f32 (the combine's sum); the buffer
    shard (E / 16, C / dp, d) and the all-to-all's rows are smaller. The
    plain dispatch on DTensors gathered the tokens (T, d) and the whole
    (E, C, d) buffer on every rank."""
    cfg = _moe_cfg(arch, E)
    for name in ("dispatch", "combine"):
        monkeypatch.setitem(dtensor_forms.FORMS, name, _scoped(
            "moe", dtensor_forms.FORMS[name]))
    rec, c = _record(monkeypatch, arch, cfg, "prefill", 256, 32, multi)
    T, d, K = 32 * 256, cfg.d_model, cfg.moe.top_k
    C = int(T * K / E * 1.25)
    tokens = T // dp * d * 4
    buf = E // 16 * (C // dp) * d * 4
    assert c.largest["moe"] == tokens > buf
    assert c.largest["moe"] * dp <= T * d * 4 < E * C * d * 4
    assert rec["collectives"]["counts"][
        "_c10d_functional.all_to_all_single"] == 2 * cfg.n_layers


@pytest.mark.parametrize("multi,dp", MESHES)
def test_whisper_positions_on_each_ranks_rows(monkeypatch, multi, dp):
    """Prefill B 32 x S 256 (and the encoder's B 32 x T frames): the
    sinusoid embedding's largest storage is one row, (1, S, d) f32,
    broadcast over the rank's own rows, where every rank built all 32
    rows."""
    from repro_torch.models import layers
    arch = "whisper-base"
    cfg = get_smoke_config(arch)
    monkeypatch.setattr(layers, "sinusoid_pos_emb", _scoped(
        "pos", layers.sinusoid_pos_emb))
    _, c = _record(monkeypatch, arch, cfg, "prefill", 256, 32, multi)
    S = max(256, cfg.encoder_len)
    assert c.largest["pos"] == S * cfg.d_model * 4


@pytest.mark.parametrize("multi,dp", MESHES)
def test_ssd_on_each_ranks_heads(monkeypatch, multi, dp):
    """zamba2-2.7b smoke widened to d 512 (H = 2 x 512 / 64 = 16 heads,
    one a rank over 'model'), prefill B 32 x S 256 (Q 128, nc 2): the
    SSD's largest storage is a (B / dp, nc, Q, Q, 1) f32 tensor, where
    every rank held all 16 heads; the conv's is x's padded input on the
    rank's own channels, (B / dp, S + K - 1, d_in / 16) f32, where every
    rank held all d_in + 2 G N channels of the conv's output."""
    from repro_torch.models import ssm
    arch = "zamba2-2.7b"
    cfg = dataclasses.replace(get_smoke_config(arch), d_model=512)
    monkeypatch.setitem(dtensor_forms.FORMS, "ssd_chunked", _scoped(
        "ssd", dtensor_forms.FORMS["ssd_chunked"]))
    monkeypatch.setattr(ssm, "_causal_conv", _scoped(
        "conv", ssm._causal_conv))
    _, c = _record(monkeypatch, arch, cfg, "prefill", 256, 32, multi)
    assert c.largest["ssd"] == 32 // dp * 2 * 128 * 128 * 1 * 4
    d_in, K = 2 * 512, cfg.ssm.conv_dim
    assert c.largest["conv"] == 32 // dp * (256 + K - 1) * d_in // 16 * 4


@pytest.mark.parametrize("multi,dp", MESHES)
def test_microbatch_from_each_ranks_rows(multi, dp):
    """16 microbatches of a (256, 8, 64) f32 batch sharded over the data
    ranks (8 rows a rank on 2x16x16): on 16x16 each microbatch is one row
    of every rank's own 16, no storage and no collective; on 2x16x16 its
    16 rows are one a rank over 'data', replicated over 'pod', by one
    all-gather over 'pod' of one row (its output 2 rows, the largest
    storage), where slicing the sharded batch gathered all 256."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_production_mesh(multi_pod=multi)
    row = 8 * 64 * 4
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 8, 64), mesh,
                              placements(mesh, (("pod", "data")
                                                if multi else "data",)))
        c = _Largest()
        with dryrun._dtensor_fixes(c), c:
            for i in range(16):
                c.open.append("mb")
                mb = specs._mb_slice(x, i, 16, 256, dp)
                c.open.remove("mb")
                assert mb.shape == (16, 8, 64)
                assert mb.to_local().shape == (1, 8, 64)
                assert mb.placements[-2:] == (Shard(0), Replicate())
    AG = "_c10d_functional.all_gather_into_tensor"
    if multi:
        assert mb.placements[0] == Replicate()
        assert c.largest["mb"] == 2 * row and c.counts == {AG: 16}
    else:
        assert c.largest.get("mb", 0) == 0 and c.counts == {}


def _moe_inputs(E, seed=0):
    """deepseek-moe-16b smoke's MoE params at E experts and its routing
    of 64 tokens, f32, from a seed."""
    from repro_torch.models import moe
    cfg = _moe_cfg("deepseek-moe-16b", E)
    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(cfg, g, torch.float32, "cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    return cfg, p, x


def _capacity(cfg, p, x):
    """The capacity path's routed output and its gradients (x and every
    expert weight) for the loss sum(out ** 2)."""
    from repro_torch.models import moe
    out, _ = moe.moe_ffn(cfg, p, x, dropless=False)
    (out.float() ** 2).sum().backward()
    return out, x.grad, {k: p[k].grad for k in ("router", "we_gate",
                                                 "we_up", "we_down")}


def test_moe_forms_equal_the_plain_capacity_path():
    """On plain tensors the dispatch and combine forms run the plain
    bodies; on a one-rank gloo mesh (tokens sharded over 'data', experts
    over 'model', both of extent 1) the forms' own path runs, the
    all-to-all included: output and gradients equal the plain path's at
    f32 2e-5."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.act_sharding import forms, moe_buffer_sharding

    def fresh(p, x):
        return ({k: (v.detach().clone().requires_grad_()
                     if isinstance(v, torch.Tensor) else
                     {kk: vv.detach().clone().requires_grad_()
                      for kk, vv in v.items()}) for k, v in p.items()},
                x.detach().clone().requires_grad_())
    cfg, p0, x0 = _moe_inputs(8)
    want, wdx, wgrads = _capacity(cfg, *fresh(p0, x0))
    with forms(dtensor_forms.FORMS):
        got, gdx, ggrads = _capacity(cfg, *fresh(p0, x0))
    assert torch.equal(got, want) and torch.equal(gdx, wdx)

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    used = []
    plan = dtensor_forms._moe_plan
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        p, x = fresh(p0, x0)
        dp = {k: distribute_tensor(v, mesh, placements(mesh, specs._fit(
            mesh, specs._param_spec(k, v), tuple(v.shape))))
            for k, v in p.items() if k != "shared"}
        dp = {k: v.detach().requires_grad_() for k, v in dp.items()}
        dp["shared"] = {k: distribute_tensor(v.detach(), mesh, placements(
            mesh, (None, None))) for k, v in p["shared"].items()}
        dx = distribute_tensor(x.detach(), mesh, placements(
            mesh, ("data",))).requires_grad_()

        def traced(*args):
            out = plan(*args)
            used.append(out is not None)
            return out
        dtensor_forms._moe_plan = traced
        with forms(dtensor_forms.FORMS), implicit_replication(), \
                moe_buffer_sharding(("model", "data", None)):
            got, gdx, ggrads = _capacity(cfg, dp, dx)
        assert used and all(used)
        tol = dict(atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(got.full_tensor(), want, **tol)
        torch.testing.assert_close(gdx.full_tensor(), wdx, **tol)
        for k, g in wgrads.items():
            torch.testing.assert_close(ggrads[k].full_tensor(), g, **tol,
                                       msg=k)
    finally:
        dtensor_forms._moe_plan = plan
        dist.destroy_process_group()


def test_pinned_moe_flops_equal_the_unformed_step(monkeypatch):
    """deepseek-moe-16b smoke at 32 experts (the pin), prefill B 32 x S
    128 on 16x16: the forms move the payload, not the products (the
    pinned buffer's expert products already ran on each rank's shard), so
    the step's FLOPs equal those of the step with the plain dispatch and
    combine on DTensors."""
    arch = "deepseek-moe-16b"
    cfg = _moe_cfg(arch, 32)
    formed, _ = _record(monkeypatch, arch, cfg, "prefill", 128, 32, False)
    for name in ("dispatch", "combine"):
        monkeypatch.delitem(dtensor_forms.FORMS, name)
    plain, _ = _record(monkeypatch, arch, cfg, "prefill", 128, 32, False)
    assert formed["flops"] == plain["flops"] > 0
    assert formed["memory"]["temp_size"] < plain["memory"]["temp_size"]

