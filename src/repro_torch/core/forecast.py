"""GPU KV block availability forecast (paper Eq. 5).

    Avail(t+1) = Avail(t) + Released(t) - Allocated(t)

Rolls the block ledger forward over a horizon of decode stages to decide
*proactively* whether the retained x layers of recent requests must be
offloaded before the pool runs dry (paper §3.1.1 last paragraph).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence

from repro_torch.core.predictor import LengthPredictor

if TYPE_CHECKING:  # annotation-only: a runtime import would cycle via
    from repro_torch.serving.request import Request  # repro.core.units


@dataclasses.dataclass
class AvailabilityForecast:
    predictor: LengthPredictor
    block_size: int

    def forecast(self, avail_now: int, decoding: Sequence[Request],
                 horizon: int, prefill_blocks_per_stage: int = 0
                 ) -> List[int]:
        """Projected free DEVICE blocks at the start of the next `horizon`
        stages. Released(t): blocks of sequences predicted (bucket median)
        to finish at stage t. Allocated(t): one block per live sequence
        (conservative, paper §3.1.1) + the controlled prefill allocation."""
        # predicted remaining tokens per decoding request
        remaining = []
        for r in decoding:
            med = self.predictor.n_median_total(r)
            remaining.append(max(1, med - r.tokens_out))
        # device blocks a finished request releases (its device-resident
        # share; callers pass per-request block counts via closure if they
        # want exactness — the paper uses the same rough estimate)
        avail = avail_now
        out = []
        live = list(remaining)
        for t in range(1, horizon + 1):
            released = 0
            still = []
            for rem, r in zip(live, decoding):
                if rem == t:  # predicted to finish at this stage
                    released += sum(
                        1 for _ in range(self._req_device_blocks(r)))
                else:
                    still.append((rem, r))
            allocated = len([rem for rem, _ in still if rem > t]) \
                + prefill_blocks_per_stage
            avail = avail + released - allocated
            out.append(avail)
        return out

    def _req_device_blocks(self, r: Request) -> int:
        # rough: ceil(ctx/block) blocks for ONE device-resident layer; the
        # engine overrides with exact numbers via `blocks_of`.
        ctx = r.prompt_len + r.tokens_out
        return -(-ctx // self.block_size)

    def needs_proactive_offload(self, avail_now: int,
                                decoding: Sequence[Request],
                                horizon: int, threshold: int,
                                prefill_blocks_per_stage: int = 0) -> bool:
        fc = self.forecast(avail_now, decoding, horizon,
                           prefill_blocks_per_stage)
        return any(a < threshold for a in fc)
