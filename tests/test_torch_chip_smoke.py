"""`chip_smoke.py`'s serving paths, dry-run on the CPU at their model
configs (full width and depth for the main paths, the smoke configs for
the *-smoke paths): the port's real `LayerKVEngine` and scheduler drive
a stub executor (no weights, no pools, every sampled token 1), so the
script's pool sizes can be checked without a card. On each path the
layerkv run must force layer-wise offload and reload, and the paths
that list the two-pool kernel must run fused steps whose chunks have
host-resident layers — the preconditions `chip_smoke.py` asserts on the
H100. The stub also counts the fused steps that read the host tier,
which, times the layer count, is the number of two-pool kernel launches
the card run should show."""
import sys
from pathlib import Path

import pytest

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving import engine as engine_mod

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


class _StubExecutor:
    """Stands in for `PagedExecutor`: accepts every call the engine
    makes, moves no bytes, and records the fused steps' signatures the
    way the real executor does (the last field: a host-tier chunk)."""

    def __init__(self, cfg, params, ndb, nhb, block_size, *, device,
                 seed=0):
        self.cfg, self.params = cfg, params
        self.registry = MetricsRegistry()
        self._jit_sigs = set()
        self.host_steps = 0
        self.staging_bytes = 0

    def prefill(self, prompt, pad_to):
        return 1, [None] * self.cfg.n_layers, [None] * self.cfg.n_layers

    def write_layer(self, *args):
        pass

    def copy_blocks(self, *args):
        pass

    def decode(self, tokens, tables, kv_lens):
        return [1] * len(tokens)

    def mixed_step(self, chunks, decodes):
        has_host = any(any(c.tiers) for c in chunks)
        self.host_steps += has_host
        self._jit_sigs.add(("mixed", (len(chunks), len(decodes), has_host)))
        return [1] * (len(chunks) + len(decodes))

    def nonfinite_logits(self):
        return 0


@pytest.mark.parametrize("tag", sorted(chip_smoke.PATHS))
def test_chip_smoke_path_forces_offload_at_full_config(tag, monkeypatch):
    monkeypatch.setattr(engine_mod, "PagedExecutor", _StubExecutor)
    pc = chip_smoke.PATHS[tag]
    cfg = chip_smoke.path_config(tag)
    # the script's own driver and assertions: every request finishes,
    # offload and reload happen, two-pool paths read the host tier, first
    # tokens equal the vllm reference's
    res, prompts, out_len = chip_smoke._run_path(tag, cfg, None, "cpu")
    assert len(res["tokens"]) == len(prompts) == pc["n"]
    assert res["offloads"] > 0 and res["reloads"] > 0
    if "paged_prefill_tiered" in pc["kernels"]:
        assert res["host_tier_signatures"] > 0


def test_chip_smoke_cluster_path_at_full_config(monkeypatch):
    monkeypatch.setattr(engine_mod, "PagedExecutor", _StubExecutor)
    pc = chip_smoke.CLUSTER
    cfg = chip_smoke.path_config(pc["prompts"])
    assert cfg.arch_id == pc["arch"]
    # the script's own driver and assertions (every stream whole, one
    # kill with streamed tokens salvaged, a recovery and a re-dispatch,
    # each replica offloading and reading the host tier, pools back at
    # baseline, the revived replica serving again)
    res = chip_smoke._run_cluster(cfg, None, "cpu")
    assert len(res["tokens"]) == chip_smoke.PATHS[pc["prompts"]]["n"]
    assert res["n_kills"] == 1 and res["n_recoveries"] == 1
    # the crash hit replica 0's live, streaming requests: each salvaged
    # one had been routed there and is re-dispatched to replica 1
    assert res["salvaged"] and res["redispatched"] >= len(res["salvaged"])
    assert all(res["routed"][rid] == 1 for rid in res["salvaged"])
    assert res["recovery_log"][0].endswith("kill r0 (fault)")
    assert "unwound r0" in res["recovery_log"][1]
    for rep in res["replicas"]:
        assert rep["dispatched"] and rep["offloads"]
        assert rep["host_tier_signatures"] > 0
    assert sum(rep["reloads"] for rep in res["replicas"]) > 0
    # the late request went through the router to the revived replica 0
    assert res["late_replica"] == 0 and all(res["served"])


def test_partial_eviction_counts_its_host_layers(monkeypatch):
    """ROADMAP C6, fixed in the port: on the cluster path at 8192 host
    blocks a replica that takes its dead peer's load runs the host pool
    short part-way through an eviction. The layers already moved must be
    counted in `host_layers`, so the request is promoted before it
    decodes again; uncounted, the next decode met a host layer and
    asserted."""
    from repro_torch.core import HOST
    monkeypatch.setattr(engine_mod, "PagedExecutor", _StubExecutor)
    monkeypatch.setitem(chip_smoke.CLUSTER, "nhb", 8192)
    partial = []
    evict = engine_mod.LayerKVEngine._evict_newest

    def spy(self, exclude=()):
        on_host = {r.rid: len(self.bm.layers_on(r.rid, HOST))
                   for r in self.decoding}
        ok = evict(self, exclude)
        for r in self.decoding:
            n = len(self.bm.layers_on(r.rid, HOST))
            if not ok and n != on_host[r.rid]:
                partial.append(r.rid)
                assert self.host_layers[r.rid] == n
        return ok

    monkeypatch.setattr(engine_mod.LayerKVEngine, "_evict_newest", spy)
    cfg = chip_smoke.path_config(chip_smoke.CLUSTER["prompts"])
    res = chip_smoke._run_cluster(cfg, None, "cpu")
    assert partial
    assert sum(rep["partial_evictions"] for rep in res["replicas"]) \
        == len(partial)
    assert len(res["tokens"]) == chip_smoke.PATHS["fused"]["n"]
