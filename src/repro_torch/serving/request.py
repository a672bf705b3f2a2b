"""Request lifecycle and SLO metrics."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.core.units import Seconds, Tokens


class Phase(enum.Enum):
    """Request lifecycle states, shared by both backends."""
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    PAUSED = "paused"                # preempted: KV parked on HOST, will
    #                                  resume losslessly (no recompute)
    FINISHED = "finished"
    CANCELLED = "cancelled"          # unwound by ServingSession.cancel
    SHED = "shed"                    # rejected under overload/fault
    #                                  (graceful degradation; reason in
    #                                  Request.shed_reason)


@dataclasses.dataclass
class Request:
    """One serving request plus its live scheduling state. SLO fields
    are in seconds; `priority`/`deadline` feed the `deadline` admission
    policy and the preemption controller (units in field comments)."""
    rid: str
    prompt_len: Tokens
    output_len: Tokens                  # target generation length (EOS position)
    arrival: Seconds = 0.0
    tpot_slo: Seconds = 0.2            # seconds/token (paper Fig.8: 200 ms)
    ttft_slo: Seconds = 3.0            # seconds (paper Fig.8: 3000 ms)
    prompt: Optional[list] = None    # token ids (real engine)
    priority: int = 0                # class rank; HIGHER preempts lower
    #                                  (0 = batch, 1 = interactive by
    #                                  convention). Only the 'deadline'
    #                                  admission policy and the preemption
    #                                  controller read it.
    deadline: Seconds = -1.0           # absolute first-token deadline
    #                                  (seconds on the virtual clock);
    #                                  < 0 derives arrival + ttft_slo

    phase: Phase = Phase.QUEUED
    prefill_start: Seconds = -1.0
    first_token_time: Seconds = -1.0   # TTFT reference point
    finish_time: Seconds = -1.0
    tokens_out: Tokens = 0
    decode_start: Seconds = -1.0
    generated: List[int] = dataclasses.field(default_factory=list)
    n_preempted: int = 0             # times this request was paused
    last_token_time: Seconds = -1.0    # stamp of the newest emitted token
    max_tbt: Seconds = 0.0             # widest gap between adjacent tokens

    # --- chunked-prefill progress (scheduler-owned) --------------------------
    prefill_done: Tokens = 0            # prompt tokens whose KV is cached
    n_chunks: int = 0                # chunks this prefill was split into
    cached_prompt_len: Tokens = 0       # prompt tokens served from the
    #                                  cross-request prefix cache (compute
    #                                  skipped; subset of prefill_done)

    # --- fault tolerance (cluster-owned) -------------------------------------
    shed_reason: Optional[str] = None  # AdmissionImpossible subclass name
    #                                    when phase is SHED
    n_redispatched: int = 0          # replica kills survived: each one
    #                                  folded the streamed tokens into the
    #                                  prompt and restarted the remainder
    tokens_salvaged: Tokens = 0         # tokens streamed by DEAD incarnations
    #                                  (already delivered; excluded from
    #                                  output_len, which counts down)
    n_dispatch_retries: int = 0      # transient dispatch failures retried

    @property
    def prefill_remaining(self) -> Tokens:
        return max(self.prompt_len - self.prefill_done, 0)

    @property
    def prefill_complete(self) -> bool:
        return self.prefill_done >= self.prompt_len

    # --- deadline / preemption ----------------------------------------------
    @property
    def effective_deadline(self) -> Seconds:
        """Absolute time the first token is due: the explicit `deadline`
        when set, else `arrival + ttft_slo` (so every request has one and
        the deadline policy degrades gracefully to TTFT-SLO ordering)."""
        return self.deadline if self.deadline >= 0.0 \
            else self.arrival + self.ttft_slo

    def deadline_met(self) -> bool:
        return self.first_token_time >= 0 \
            and self.first_token_time <= self.effective_deadline

    def note_token(self, now: Seconds) -> None:
        """Stamp a token emission at `now`; maintains the max inter-token
        gap (TBT) — the tail metric preemption trades against."""
        if self.last_token_time >= 0.0:
            self.max_tbt = max(self.max_tbt, now - self.last_token_time)
        self.last_token_time = now

    # --- derived metrics -----------------------------------------------------
    @property
    def ttft(self) -> Seconds:
        return self.first_token_time - self.arrival

    @property
    def queuing_delay(self) -> Seconds:
        return self.prefill_start - self.arrival

    @property
    def prefill_latency(self) -> Seconds:
        return self.first_token_time - self.prefill_start

    @property
    def tpot(self) -> float:
        """Average time per output token after the first."""
        if self.tokens_out <= 1 or self.finish_time < 0:
            return 0.0
        return (self.finish_time - self.first_token_time) \
            / (self.tokens_out - 1)

    def current_tpot(self, now: float) -> float:
        """Running average time/token (paper: 'the current TPOT'),
        including waiting time between tokens."""
        if self.first_token_time < 0 or self.tokens_out <= 1:
            return 0.0
        return (now - self.first_token_time) / (self.tokens_out - 1)

    # --- scheduler state (paper Eq. 1) ---------------------------------------
    def t_past(self, now: Seconds) -> Seconds:
        """Decoding time already spent, incl. waiting between tokens."""
        if self.first_token_time < 0:
            return 0.0
        return now - self.first_token_time

    @property
    def n_past(self) -> Tokens:
        return self.tokens_out

    def slo_violated(self) -> bool:
        if self.first_token_time >= 0 and self.ttft > self.ttft_slo:
            return True
        return self.tokens_out > 1 and self.tpot > self.tpot_slo
