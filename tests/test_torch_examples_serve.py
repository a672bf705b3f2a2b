"""Port parity, `repro_torch.examples.serve_comparison` against the
reference's `examples/serve_comparison.py` (loaded by path) at the
example's own size, on the CPU in f32: its workload (10 requests of
32-55 prompt tokens), its three engine runs (vllm on 1024 device blocks
as ground truth, then vllm and layerkv on 20), on the reference's
weights (PRNGKey(7), as its `run` draws them) handed over by
`weights.from_jax_params`: every generated token and the layerkv run's
offload / reload counts exactly, and losslessness (0 mismatches)."""
import jax
import pytest
import torch

from repro.models import build_model as jbuild
from repro_torch.examples import serve_comparison
from repro_torch.weights import from_jax_params
from torch_parity import flat, ref_example
from torch_parity import two_threads  # noqa: F401 (a fixture)

# every test here on two intra-op threads (`two_threads`)
pytestmark = pytest.mark.usefixtures("two_threads")


def test_serve_comparison_matches_reference():
    ref = ref_example("serve_comparison")
    cfg = serve_comparison.config()
    jcfg = ref.dataclasses.replace(ref.get_smoke_config("granite-3-2b"),
                                   dtype="float32")
    assert [(r.rid, r.prompt, r.output_len, r.arrival)
            for r in ref.make_workload(jcfg)] == \
        [(r.rid, r.prompt, r.output_len, r.arrival)
         for r in serve_comparison.make_workload(cfg)]
    jruns = {}
    for tag, policy, blocks in (("truth", "vllm", 1024),
                                ("vllm", "vllm", 20),
                                ("layerkv", "layerkv", 20)):
        eng, out = ref.run(jcfg, policy, blocks)
        jruns[tag] = ({rid: r.generated for rid, r in out.items()},
                      [t.kind for t in eng.off.ledger.log])
    params = from_jax_params(
        flat(jbuild(jcfg).init(jax.random.PRNGKey(7))), cfg, "cpu")
    res = serve_comparison.compare(cfg, device="cpu", params=params)
    for tag in ("truth", "vllm", "layerkv"):
        assert {rid: r.generated for rid, r in res[tag].items()} == \
            jruns[tag][0], tag
    log = jruns["layerkv"][1]
    assert (res["offloads"], res["reloads"]) == (log.count("offload"),
                                                 log.count("reload"))
    assert res["offloads"] > 0 and res["reloads"] > 0
    assert res["mismatches"] == 0
