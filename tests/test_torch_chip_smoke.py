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
import collections
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
        # the compiled steps' counts (`PagedExecutor`): none without one
        self.graph_captures = self.graph_replays = self.graph_pool_bytes = 0
        self.eager_steps = collections.Counter()

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


# ------------------------------------------------------ Model API paths --
#
# The generate, generate-vlm, encdec and train-vlm phases' own drivers
# and assertions, at the smoke configs in f32 on the CPU (the kernels'
# plain versions; the launch counts are asserted only on the card), and
# their full-config sizes from shapes alone.

def _smoke(arch):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def test_chip_smoke_generate_dry_run():
    """Ragged prompts batched with prompt_len, greedy decodes with a
    dense cache, then an int8 cache fed the same tokens (within rel 5e-2
    of the dense one, as the card asserts), and decode against teacher
    forcing."""
    cfg = _smoke(chip_smoke.GENERATE["arch"])
    prompts = chip_smoke._prompts(cfg.vocab_size, n=3, lo=20, hi=40)
    res = chip_smoke.run_generate(cfg, None, prompts, 4, "cpu",
                                  ref_tokens={f"r{i}": [0] * 5
                                              for i in range(3)})
    assert len(res["tokens"]) == 3 and len(res["tokens"][0]) == 5
    assert len(res["tpot_s"]) == len(res["int8_rel"]) - 1 == 4
    assert max(res["int8_rel"]) < 5e-2
    assert res["cache_bytes_int8"] < res["cache_bytes"]
    assert chip_smoke._decode_vs_teacher_forcing("t", cfg, "cpu", 2, 20,
                                                 4) < 5e-3


def test_chip_smoke_graphs_dry_run():
    """The graphs phase's check (`check_step_graphs`) at granite-3-2b
    smoke in f32 on the CPU, at the phase's own pool and batch settings:
    one decode and one host-free fused signature, every step through its
    static buffers equal to the eager twin's bit for bit."""
    cfg = _smoke("granite-3-2b")
    out = chip_smoke.check_step_graphs(cfg, None, "cpu")
    g = chip_smoke.GRAPHS
    assert out["decode"]["signature"] == (g["rows"], 64)
    assert out["mixed"]["signature"] == (512, 2, 4, 8, 32, 64, False)
    assert out["decode"]["max_abs_err"] == out["mixed"]["max_abs_err"] == 0
    assert out["mixed"]["eager_steps"] == {"cpu": 2 * g["steps"]}


def test_chip_smoke_moe_graphs_dry_run():
    """The same check at deepseek-moe-16b smoke in f32: its decode and
    host-free fused signatures, MoE dispatch included, through the
    static buffers bit for bit against the eager twin."""
    out = chip_smoke.check_step_graphs(_smoke("deepseek-moe-16b"), None,
                                       "cpu")
    g = chip_smoke.GRAPHS
    assert out["decode"]["signature"] == (g["rows"], 64)
    assert out["mixed"]["signature"] == (512, 2, 4, 8, 32, 64, False)
    assert out["decode"]["max_abs_err"] == out["mixed"]["max_abs_err"] == 0
    assert out["mixed"]["eager_steps"] == {"cpu": 2 * g["steps"]}


@pytest.mark.parametrize("eager,replays,captures,ok", [
    ({"first": 2, "host-tier": 9}, 40, 2, True),
    ({"first": 2}, 40, 2, True),
    ({"first": 2, "moe": 3}, 40, 2, False),
    ({"first": 2}, 0, 2, False),
    ({"first": 3}, 40, 3, False)],
    ids=["host-tier", "warm-ups", "moe-eager", "no-replay", "3-captures"])
def test_chip_smoke_check_graphs(eager, replays, captures, ok):
    """`_check_graphs`, every main path's rule (serve, fused, moe): graphs
    replayed, at most one capture per compiled signature, and no step
    eager for a reason but a signature's first or a host-tier one."""
    g = {"captures": captures, "replays": replays, "eager_steps": eager,
         "graph_pool_bytes": 1, "compiled_signatures": 2}
    assert chip_smoke.GRAPH_PATHS == ("serve", "fused", "moe")
    if ok:
        chip_smoke._check_graphs("moe", g)
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_graphs("moe", g)


def test_chip_smoke_generate_vlm_and_train_vlm_dry_run():
    cfg = _smoke(chip_smoke.GENERATE_VLM["arch"])
    res = chip_smoke.run_generate_vlm(cfg, [20, 33], 3, "cpu")
    assert len(res["tokens"]) == 2 and len(res["tokens"][0]) == 4
    assert not res["nonfinite_steps"]
    tr = chip_smoke.run_train("train-vlm", cfg, 2, 16, 2, (), "cpu")
    assert len(tr["losses"]) == 2


def test_chip_smoke_train_driver_carries_moe_terms():
    """`run_train` (every train phase's driver) on the MoE smoke config:
    the capacity path's lb_loss and dropped_frac come out and pass its
    checks."""
    tr = chip_smoke.run_train("train-moe", _smoke("deepseek-moe-16b"), 2, 16,
                              2, chip_smoke.TRAIN_KERNELS, "cpu")
    assert len(tr["lb_losses"]) == len(tr["dropped_fracs"]) == 2


def test_chip_smoke_encdec_dry_run():
    """Generate from stub frames over the cached cross K/V, decode
    against teacher forcing, and training."""
    cfg = _smoke(chip_smoke.ENCDEC["arch"])
    res = chip_smoke.run_encdec(cfg, 2, 4, 5, 16, 2, "cpu")
    assert len(res["tokens"][0]) == 6 and not res["nonfinite_steps"]
    assert res["teacher_forcing_rel"] < 5e-3
    assert len(res["train"]["losses"]) == 2


def test_chip_smoke_model_api_sizes_fit_one_card():
    """The full configs' sizes the card phases rely on: llama2-7b's
    generate cache (8 rows x 1056 slots, ~4.4 GB bf16, half that plus
    scales in int8), qwen2-vl-7b's bf16 weights, and train-vlm's 8-layer
    cut at 12 bytes a parameter under 40 GiB of the card's 80 GB."""
    sz = chip_smoke.path_sizes()
    assert 4.3e9 < sz["generate_cache_bytes"] < 4.5e9
    assert sz["generate_int8_cache_bytes"] < 0.51 * sz[
        "generate_cache_bytes"]
    assert 14e9 < sz["generate_vlm_weight_bytes"] < 17e9
    assert 2.9e9 < sz["train_vlm_params"] < 3.0e9
    assert sz["train_vlm_reckon_bytes"] < 40 * 2**30


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_chip_smoke_recurrent_generate_and_train_dry_run(arch):
    """The generate-hybrid / generate-ssm driver (one S for the batch,
    greedy decodes, decode against teacher forcing over one superblock)
    and the train driver, on the smoke config."""
    cfg = _smoke(arch)
    res = chip_smoke.run_generate_recurrent(
        "t", cfg, 2, 16, 3, dict(tf_batch=2, tf_prompt=12, tf_steps=4),
        "cpu")
    assert len(res["tokens"]) == 2 and len(res["tokens"][0]) == 4
    assert not res["nonfinite_steps"] and res["teacher_forcing_rel"] < 5e-3
    assert res["n_params"] == chip_smoke.model_size(cfg)[0]
    tr = chip_smoke.run_train("t", cfg, 2, 16, 2, (), "cpu")
    assert len(tr["losses"]) == 2


def test_chip_smoke_ssm_ranges_mark_and_restore():
    """`_ssm_ranges` wraps each sequence core of models/ssm.py for a
    traced run and puts the module's own functions back after it."""
    from repro_torch.models import ssm
    before = {n: getattr(ssm, n) for n in chip_smoke.SSM_RANGES}
    with chip_smoke._ssm_ranges() as names:
        assert names == chip_smoke.SSM_RANGES
        assert all(getattr(ssm, n) is not before[n] for n in names)
    assert all(getattr(ssm, n) is before[n] for n in before)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_model_size_counts_the_models_leaves(arch, dtype):
    """`model_size` (parameters and bytes from shapes alone, f32 leaves at
    4 bytes) equals the smoke model's own leaves in either dtype."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = dataclasses.replace(_smoke(arch), dtype=dtype)
    flat = list(build_model(cfg, device="cpu").flat.values())
    assert chip_smoke.model_size(cfg) == (
        sum(t.numel() for t in flat),
        sum(t.numel() * t.element_size() for t in flat))


def test_chip_smoke_recurrent_sizes_fit_one_card():
    """zamba2-2.7b: 2.42 B parameters (4.84 GB in bf16), a 1056-slot cache
    for 4 rows of ~0.68 GB, 29 GB at 12 bytes a parameter for training at
    full depth; xlstm-1.3b as the reference builds it: 3.53 B parameters
    (wq / wk / wv are d_in x d_in), a 2.82 GB mC for 4 rows, and train-ssm's
    16-layer cut at 1.31 B parameters. Each leaves room on an 80 GB card
    for activations and the optimizer's temporaries."""
    sz = chip_smoke.path_sizes()
    assert 4.8e9 < sz["generate_hybrid_weight_bytes"] < 4.9e9
    assert 0.6e9 < sz["generate_hybrid_cache_bytes"] < 0.75e9
    assert 7.0e9 < sz["generate_ssm_weight_bytes"] < 7.2e9
    assert 2.8e9 < sz["generate_ssm_cache_bytes"] < 2.9e9
    assert 2.40e9 < sz["train_hybrid_params"] < 2.45e9
    assert 1.30e9 < sz["train_ssm_params"] < 1.32e9
    assert sz["train_hybrid_reckon_bytes"] < 30e9
    assert sz["train_ssm_reckon_bytes"] < 16e9


# ------------------------------------------------ examples and dry run --

@pytest.fixture
def two_threads():
    """Two intra-op threads (TINY_100M's products oversubscribe a shared
    CPU otherwise), restored after the test."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_chip_smoke_examples_dry_run(two_threads):
    """The examples phase (`run_examples`) on the CPU, cut to 2 quickstart
    steps and 1 train_tiny step of 1 x 32 (the card runs 60 and 50 of
    4 x 256): every part finite, r0's stream whole, serve_comparison
    lossless under forced offload and reload, train_tiny's checkpoint
    written."""
    out = chip_smoke.run_examples("cpu", quick_steps=2, tiny_steps=1,
                                  tiny_batch=1, tiny_seq=32)
    assert set(out) == {"quickstart-train", "quickstart-serve",
                        "serve-comparison", "train-tiny"}
    assert all("launches" in v for v in out.values())
    assert len(out["quickstart-train"]["losses"]) == 2
    assert len(out["quickstart-serve"]["tokens"]) == 6
    sc = out["serve-comparison"]
    assert sc["mismatches"] == 0 and sc["offloads"] > 0 and sc["reloads"] > 0
    assert out["train-tiny"]["checkpoint_written"]
    assert chip_smoke.EXAMPLES == dict(quick_steps=60, tiny_steps=50,
                                       tiny_batch=4, tiny_seq=256)


@pytest.mark.parametrize("hbm", ["80GB", "1B"])
def test_chip_smoke_dryrun_phase(tmp_path, monkeypatch, hbm):
    """The dryrun phase (`run_dryrun`) on one quick pair on each mesh (the
    card runs chatglm3-6b decode_32k on both, granite-3-2b train_4k,
    deepseek-moe-16b prefill_32k and zamba2-2.7b decode_32k on 16x16, and
    the offload example): a fresh process per pair, ok records with an
    int temp_size, their roofline rows; a record over the HBM fails the
    phase (the same pairs against a 1-byte HBM)."""
    from repro_torch.roofline import analysis
    pairs = (("whisper-base", "long_500k", "single"),
             ("whisper-base", "long_500k", "multi"))
    if hbm == "1B":
        monkeypatch.setattr(analysis, "HBM_BYTES", 1)
        with pytest.raises(AssertionError, match="OVER-HBM"):
            chip_smoke.run_dryrun(str(tmp_path), pairs=pairs, offload=False)
        return
    out = chip_smoke.run_dryrun(str(tmp_path), pairs=pairs, offload=False)
    recs = out["records"]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for rec in recs:
        assert rec["ok"] and type(rec["memory"]["temp_size"]) is int
    assert [r["mesh"] for r in out["roofline"]] == ["16x16", "2x16x16"]
    for row in out["roofline"]:
        assert row["arch"] == "whisper-base" and row["dominant"] in (
            "compute", "memory", "collective")
        assert row["fits_hbm"]
    assert chip_smoke.DRYRUN_PAIRS == (
        ("chatglm3-6b", "decode_32k", "single"),
        ("granite-3-2b", "train_4k", "single"),
        ("chatglm3-6b", "decode_32k", "multi"),
        ("deepseek-moe-16b", "prefill_32k", "single"),
        ("zamba2-2.7b", "decode_32k", "single"))
