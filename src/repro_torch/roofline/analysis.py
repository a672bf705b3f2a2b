"""Three-term roofline analysis from the dry run's records — the port of
`repro.roofline.analysis`, at the H100's peaks.

Per (arch x shape) on the single-pod 16x16 mesh:

    compute term    = FLOPs / (chips * 989e12)
    memory term     = HBM bytes / (chips * 3.35e12)
    collective term = collective bytes per chip / 450e9

The peaks are `serving.costmodel.H100`'s, spec-sheet values of the
H100 SXM, not measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
NVLink at 450 GB/s each way taken as ONE collective term (no per-link
split), and 80 GB for `fits_hbm`. A 16-wide 'model' axis spans two
8-GPU NVLink domains on real H100 nodes, so part of its traffic would
cross the slower inter-node network: the collective term at the NVLink
rate is a floor, not modelled further.

Methodology (structural analysis, no wall time):
  * The port's dry-run record counts the WHOLE step (`flops_scope`):
    its layer, microbatch and token loops run in Python and every pass
    is counted, so no scan-body correction applies (the reference
    multiplies XLA's body-once count by the iteration count;
    `analyze_record` here does not). `layer_iters` is kept for the
    reference's API.
  * MODEL_FLOPS is the analytic useful-work count (6*N_active*D for train
    incl. backward, 2*N_active*T + attention terms for inference), giving
    the MODEL_FLOPS / counted FLOPs ratio (`useful_ratio`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.serving.costmodel import H100

PEAK_FLOPS = H100.flops_per_s    # bf16 dense / GPU (spec sheet)
HBM_BW = H100.hbm_bw             # bytes/s / GPU (spec sheet)
NVLINK_BW = H100.ici_bw          # bytes/s / GPU, one term (spec sheet)
HBM_BYTES = H100.mem_bytes       # device memory / GPU


# ---------------------------------------------------------------------------
# analytic model FLOPs (global, whole step)
# ---------------------------------------------------------------------------

def attention_flops(cfg: ModelConfig, tokens: int, ctx: int) -> float:
    """2 * 2 * L_attn * H * hd * tokens * ctx (QK^T and PV), causal halves
    the prefill case."""
    hd = cfg.resolved_head_dim
    return (4.0 * cfg.n_attention_layers() * cfg.n_q_heads * hd
            * tokens * ctx)


def model_flops(cfg: ModelConfig, shp: InputShape) -> float:
    """Useful FLOPs of one step (global, forward [+backward for train])."""
    N = cfg.active_param_count()
    B, S = shp.global_batch, shp.seq_len
    if shp.kind == "train":
        T = B * S
        base = 6.0 * N * T                      # fwd 2ND + bwd 4ND
        attn = 3.0 * attention_flops(cfg, T, S) * 0.5   # causal avg ctx S/2
        return base + attn
    if shp.kind == "prefill":
        T = B * S
        return 2.0 * N * T + attention_flops(cfg, T, S) * 0.5
    # decode: one token per sequence against ctx of S (or the SW window)
    ctx = S
    if S > 32768 and cfg.sliding_window:
        ctx = cfg.sliding_window
    if cfg.family == "ssm":
        ctx = 0  # recurrent state, no KV attention
    return 2.0 * N * B + attention_flops(cfg, B, ctx)


def hbm_bytes_analytic(cfg: ModelConfig, shp: InputShape) -> float:
    """Minimum HBM traffic of one step (global): weights once (+opt state
    r/w for train), KV/state cache r/w, activation stream."""
    f = 2  # bf16
    B, S = shp.global_batch, shp.seq_len
    N = cfg.active_param_count()
    Ntot = cfg.param_count()
    act_stream = 4.0 * B * S * cfg.d_model * f * cfg.n_layers
    if shp.kind == "train":
        # params + grads + adam m/v (f32) read+write, remat re-read
        return Ntot * (2 + 4 * 3 * 2) + act_stream * 2
    if shp.kind == "prefill":
        kv = cfg.kv_bytes_per_token() * B * S
        return N * f + act_stream + kv
    ctx = S if not (S > 32768 and cfg.sliding_window) else cfg.sliding_window
    if cfg.family == "ssm":
        kv = 0.0
    else:
        kv = cfg.kv_bytes_per_token() * B * ctx
    return N * f + kv + 4.0 * B * cfg.d_model * f * cfg.n_layers


# ---------------------------------------------------------------------------
# scan-iteration counts (the reference's body-once correction)
# ---------------------------------------------------------------------------

def layer_iters(cfg: ModelConfig) -> int:
    """The reference's body multiplier for XLA's scan-body-once counts.
    The port's records count the whole step, so `analyze_record` does
    not use it; kept so the two modules expose the same functions."""
    return cfg.n_layers


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_corrected: float
    useful_ratio: float
    bytes_per_device_gib: float
    fits_hbm: bool
    notes: str = ""

    def row(self):
        return (f"{self.arch:24s} {self.shape:12s} {self.mesh:8s} "
                f"C={self.compute_s*1e3:9.3f}ms M={self.memory_s*1e3:9.3f}ms "
                f"X={self.collective_s*1e3:9.3f}ms -> {self.dominant:10s} "
                f"useful={self.useful_ratio:5.2f} "
                f"mem={self.bytes_per_device_gib:6.2f}GiB"
                f"{' OVER-HBM' if not self.fits_hbm else ''}")


def analyze_record(rec: dict) -> Optional[Roofline]:
    if not rec.get("ok"):
        return None
    cfg = get_config(rec["arch"])
    shp = SHAPES[rec["shape"]]
    chips = rec["n_devices"]

    # --- compute ------------------------------------------------------------
    mf = model_flops(cfg, shp)
    # the record's per-rank FLOPs already cover the whole step
    flops_total = rec.get("flops", 0.0) * chips
    compute_s = max(flops_total, mf) / chips / PEAK_FLOPS

    # --- memory ---------------------------------------------------------
    # the analytic minimum-traffic model (the record has no measured
    # bytes accessed)
    memory_s = hbm_bytes_analytic(cfg, shp) / chips / HBM_BW

    # --- collectives ------------------------------------------------------
    coll = rec.get("collectives", {})
    collective_s = coll.get("total_bytes", 0) / NVLINK_BW   # per rank

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    gib = rec.get("bytes_per_device", 0) / 2**30
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf,
        hlo_flops_corrected=flops_total,
        useful_ratio=mf / flops_total if flops_total else 0.0,
        bytes_per_device_gib=gib, fits_hbm=gib <= HBM_BYTES / 2**30)


def analyze_file(path: str, mesh: str = "16x16"):
    with open(path) as f:
        recs = json.load(f)
    out = []
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        a = analyze_record(r)
        if a:
            out.append(a)
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_results.json")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = analyze_file(args.results, args.mesh)
    print(f"{'arch':24s} {'shape':12s} {'mesh':8s} roofline terms")
    for r in rows:
        print(r.row())
    # dominant-term histogram
    from collections import Counter
    print("\ndominant terms:", dict(Counter(r.dominant for r in rows)))


if __name__ == "__main__":
    main()
