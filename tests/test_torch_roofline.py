"""Port parity, roofline: `repro_torch.roofline.analysis`'s analytic
counts equal the reference's `repro.roofline.analysis` on every arch x
input shape (the functions are copied, so exactly), its peaks are read
from the port's `serving.costmodel.H100` (not the reference's TPU v5e
constants), and `analyze_record` reads a port dry-run record as one
whole step (no scan-body multiplier)."""
import json

import pytest

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config
from repro_torch.roofline import analysis as tanalysis
from repro_torch.serving.costmodel import H100


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_reference(arch):
    for name, shp in SHAPES.items():
        tcfg, jcfg = get_config(arch), jget_config(arch)
        assert tanalysis.model_flops(tcfg, shp) == \
            janalysis.model_flops(jcfg, shp), (arch, name)
        assert tanalysis.hbm_bytes_analytic(tcfg, shp) == \
            janalysis.hbm_bytes_analytic(jcfg, shp), (arch, name)
        for tokens, ctx in ((1, 1), (shp.global_batch, shp.seq_len),
                            (shp.global_batch * shp.seq_len, shp.seq_len)):
            assert tanalysis.attention_flops(tcfg, tokens, ctx) == \
                janalysis.attention_flops(jcfg, tokens, ctx)
        assert tanalysis.layer_iters(tcfg) == janalysis.layer_iters(jcfg)


def test_peaks_are_the_h100_profile():
    assert tanalysis.PEAK_FLOPS == H100.flops_per_s == 989e12
    assert tanalysis.HBM_BW == H100.hbm_bw == 3.35e12
    assert tanalysis.NVLINK_BW == H100.ici_bw == 450e9
    assert tanalysis.HBM_BYTES == H100.mem_bytes == 80e9
    assert tanalysis.PEAK_FLOPS != janalysis.PEAK_FLOPS


def _record(**over):
    rec = {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "16x16",
           "n_devices": 256, "microbatches": 4, "ok": True,
           "flops": 1.5e14, "bytes_per_device": 3 * 2**30,
           "collectives": {"total_bytes": 9e10}}
    rec.update(over)
    return rec


def test_analyze_record_takes_the_whole_step(tmp_path):
    """The three terms from one record: FLOPs per rank times the ranks
    (no layer or microbatch multiplier), the analytic HBM bytes, the
    collective bytes per rank over one NVLink term; `fits_hbm` against
    80 GB; failed records are skipped."""
    rec = _record()
    r = tanalysis.analyze_record(rec)
    cfg, shp = get_config("granite-3-2b"), SHAPES["train_4k"]
    mf = tanalysis.model_flops(cfg, shp)
    assert r.hlo_flops_corrected == 1.5e14 * 256
    assert r.compute_s == pytest.approx(max(1.5e14 * 256, mf) / 256
                                        / 989e12)
    assert r.memory_s == pytest.approx(
        tanalysis.hbm_bytes_analytic(cfg, shp) / 256 / 3.35e12)
    assert r.collective_s == pytest.approx(9e10 / 450e9)
    assert r.dominant == max(("compute", r.compute_s),
                             ("memory", r.memory_s),
                             ("collective", r.collective_s),
                             key=lambda t: t[1])[0]
    assert r.fits_hbm and r.useful_ratio == pytest.approx(mf / (1.5e14 * 256))
    assert not tanalysis.analyze_record(_record(bytes_per_device=90e9)
                                        ).fits_hbm
    path = tmp_path / "recs.json"
    path.write_text(json.dumps([rec, _record(ok=False),
                                _record(mesh="2x16x16")]))
    rows = tanalysis.analyze_file(str(path))
    assert len(rows) == 1 and rows[0].arch == "granite-3-2b"
    assert "granite-3-2b" in rows[0].row()
