"""Analytic serving cost model (paper Eq. 3 / Eq. 4) + hardware profiles.

Used by (a) the SLO-aware scheduler's admission decisions — exactly as the
paper does on real hardware — and (b) the discrete-event simulator that
reproduces the paper-scale figures on this CPU-only container.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.units import Bytes, Seconds, Tokens, bytes_to_seconds, \
    tokens_to_bytes


@dataclasses.dataclass(frozen=True)
class HWProfile:
    """Accelerator price sheet the cost model reads (units per chip;
    bandwidths in bytes/s). Instances below (L20, A100, TPU_V5E, ...)
    are the `hw` argument of both serving backends."""
    name: str
    flops_per_s: float          # dense (bf16/fp16) peak per chip
    hbm_bw: float               # bytes/s per chip
    offload_bw: float           # bytes/s host<->device (PCIe or host DMA)
    ici_bw: float               # bytes/s per inter-chip link (collectives)
    mem_bytes: float            # device memory per chip
    f_precision: int = 2        # KV cache bytes per element

    def scaled(self, tp: int) -> "HWProfile":
        """Tensor-parallel aggregate view over `tp` chips. Offload bandwidth:
        the paper's testbed shares one PCIe link per two GPUs; we expose
        aggregate = offload_bw * tp (each shard moves its own KV slice)."""
        return dataclasses.replace(
            self, name=f"{self.name}x{tp}",
            flops_per_s=self.flops_per_s * tp,
            hbm_bw=self.hbm_bw * tp,
            offload_bw=self.offload_bw * tp,
            mem_bytes=self.mem_bytes * tp)


# NVIDIA L20 (the paper's testbed): 119.5 TFLOP/s FP16, 864 GB/s GDDR6,
# 48 GB; PCIe Gen4 x16 shared by two GPUs -> ~16 GB/s effective per GPU.
L20 = HWProfile("L20", 119.5e12, 864e9, 16e9, 64e9, 48e9)

# TPU v5e (our deployment target).
TPU_V5E = HWProfile("TPUv5e", 197e12, 819e9, 100e9, 50e9, 16e9)

# NVIDIA H100 SXM (the PyTorch/CUDA port's target), spec-sheet values,
# not measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, PCIe Gen5
# x16 at 64 GB/s each way, NVLink 450 GB/s each way, 80 GB.
H100 = HWProfile("H100", 989e12, 3.35e12, 64e9, 450e9, 80e9)

PROFILES = {"L20": L20, "TPUv5e": TPU_V5E, "H100": H100}


@dataclasses.dataclass
class CostModel:
    """Analytic latency/size model (paper Eq.3 / Eq.4): prices prefill
    and decode steps from model shape + `HWProfile`, derated by
    achievable MFU/MBU. The simulator uses it to advance the clock; the
    scheduler uses it for admission budgets and preemption pricing."""
    cfg: ModelConfig
    hw: HWProfile
    alpha: float = 1.15         # Eq.3 empirical correction (profiling fudge)
    beta: float = 1.1           # Eq.4 empirical correction
    mfu_prefill: float = 0.55   # achievable fraction of peak in prefill
    mbu_decode: float = 0.70    # achievable fraction of HBM bw in decode

    # ------------------------------------------------------------------ Eq.3
    def prefill_time(self, seqlen: Tokens) -> Seconds:
        """T_prefill = alpha * seqlen * (2 n_param + 2 seqlen n_hidden)
        / FLOPs  (paper Eq. 3), with FLOPs derated by achievable MFU."""
        n_param = self.cfg.active_param_count()
        n_hidden = self.cfg.d_model
        flops = 2 * n_param + 2 * seqlen * n_hidden
        return self.alpha * seqlen * flops / (
            self.hw.flops_per_s * self.mfu_prefill)

    def chunk_prefill_time(self, chunk_len: Tokens,
                           prefix_len: Tokens) -> Seconds:
        """Eq.3 cost of prefilling tokens [prefix, prefix+chunk) given that
        `prefix_len` tokens are already cached (chunked prefill). The
        quadratic attention term is split so chunk costs telescope exactly:
        sum over a request's chunks == prefill_time(prompt_len), i.e.
        chunking never changes total prefill compute, only its placement."""
        if chunk_len <= 0:
            return 0.0
        n_param = self.cfg.active_param_count()
        n_hidden = self.cfg.d_model
        end = prefix_len + chunk_len
        flops = 2 * n_param * chunk_len \
            + 2 * n_hidden * (end * end - prefix_len * prefix_len)
        return self.alpha * flops / (self.hw.flops_per_s * self.mfu_prefill)

    # ------------------------------------------------------------------ Eq.4
    def kv_bytes(self, seqlen: Tokens, n_layers: int | None = None) -> Bytes:
        """KV bytes for `seqlen` tokens across `n_layers` attention layers
        (default: all of them). 2 * d_heads * n_heads * f_precision per
        token-layer, with GQA heads."""
        L = self.cfg.n_attention_layers() if n_layers is None else n_layers
        hd = self.cfg.resolved_head_dim
        per_token = int(2 * L * self.cfg.n_kv_heads * hd
                        * self.hw.f_precision)
        return tokens_to_bytes(seqlen, per_token)

    def offload_time(self, seqlen: Tokens, n_offload_layers: int) -> Seconds:
        """T_offload = beta * seqlen * 2 (L-x) d_heads n_heads f / BW."""
        return self.beta * bytes_to_seconds(
            self.kv_bytes(seqlen, n_offload_layers), self.hw.offload_bw)

    def min_retained_layers(self, seqlen: Tokens) -> int:
        """Smallest x with T_offload(L - x) <= T_prefill(seqlen) (paper
        §3.1.1): retain x layers on device, offload the rest fully hidden
        under prefill compute."""
        L = self.cfg.n_attention_layers()
        t_pre = self.prefill_time(seqlen)
        for x in range(0, L + 1):
            if self.offload_time(seqlen, L - x) <= t_pre:
                return x
        return L

    # ---------------------------------------------------------------- decode
    def decode_step_time(self, batch_size: int, avg_ctx: Tokens,
                         host_kv_bytes: Bytes = 0) -> Seconds:
        """One decode iteration for a running batch. Memory-bound: stream
        active params once + the batch's KV; `host_kv_bytes` of KV resident
        on the host streams over the offload link overlapped with compute
        (paper §4), so the step takes max(HBM-bound compute, host reload)."""
        p_bytes = self.cfg.active_param_count() * self.hw.f_precision
        kv_total = self.kv_bytes(avg_ctx) * batch_size
        t_hbm = (p_bytes + kv_total) / (self.hw.hbm_bw * self.mbu_decode)
        t_reload = host_kv_bytes / self.hw.offload_bw
        return max(t_hbm, t_reload)

    # ----------------------------------------------------------- mixed batch
    def mixed_step_time(self, prefill_chunk_time: Seconds, batch_size: int,
                        avg_ctx: Tokens, host_kv_bytes: Bytes = 0,
                        fused: bool = False) -> Seconds:
        """One iteration that batches prefill-chunk tokens WITH the decode
        tokens (chunked prefill). The chunk portion is FLOPs-bound, the
        decode portion HBM-bound — the iteration takes the max of the two,
        not the sum (this overlap is the mixed-batching win).

        The default arm models the TWO-CALL executor (chunk forward +
        decode forward): each call streams the weights itself, so the
        decode side bills params + KV. The `fused` arm models the single
        `mixed_step` forward: ONE weight stream per iteration — the decode
        tokens ride the chunk's parameter pass, so the decode side bills
        only its KV (and host reload) traffic. With no chunk in the
        iteration the fused step degenerates to a plain decode step (the
        params must stream for the decode batch either way)."""
        t_dec = self.decode_step_time(batch_size, avg_ctx, host_kv_bytes) \
            if batch_size > 0 else 0.0
        if not fused or batch_size <= 0 or prefill_chunk_time <= 0.0:
            return max(prefill_chunk_time, t_dec)
        kv_total = self.kv_bytes(avg_ctx) * batch_size
        t_kv = kv_total / (self.hw.hbm_bw * self.mbu_decode)
        t_reload = host_kv_bytes / self.hw.offload_bw
        return max(prefill_chunk_time, t_kv, t_reload)
