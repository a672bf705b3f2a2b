"""The paper's primary contribution: layer-wise KV cache management.

block_manager   layer-wise paged allocator over DEVICE + HOST pools
offload_engine  Eq.4 retention policy, interleaving, link ledger (§3.1.3)
slo_scheduler   Algorithm 1 / Eq.1-3 admission control
predictor       bucketed generation-length prediction
forecast        Eq.5 availability state transition
"""
from repro_torch.core.block_manager import (
    CACHE_OWNER,
    DEVICE,
    HOST,
    LayerwiseBlockManager,
    PoolExhausted,
    PrefixAcquisition,
    PrefixCache,
    block_hashes,
)
from repro_torch.core.forecast import AvailabilityForecast
from repro_torch.core.offload_engine import (
    LinkLedger,
    OffloadEngine,
    OffloadPlan,
    interleave_offload_layers,
)
from repro_torch.core.predictor import (
    HistogramPredictor,
    LengthPredictor,
    OraclePredictor,
)
from repro_torch.core.slo_scheduler import SLOScheduler

__all__ = [
    "CACHE_OWNER", "DEVICE", "HOST", "LayerwiseBlockManager",
    "PoolExhausted", "PrefixAcquisition", "PrefixCache", "block_hashes",
    "AvailabilityForecast", "LinkLedger", "OffloadEngine", "OffloadPlan",
    "interleave_offload_layers", "HistogramPredictor", "LengthPredictor",
    "OraclePredictor", "SLOScheduler",
]
