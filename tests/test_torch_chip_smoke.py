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
