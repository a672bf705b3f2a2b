"""Bucketed generation-length predictor (paper §3.1, following [31]).

The paper frames output-length prediction as multi-class classification over
percentile buckets; the conservative lower bound of the predicted bucket
feeds N_future (Eq. 1) and the bucket median feeds the Released(t) forecast
(Eq. 5).

Two implementations behind one interface:
  * HistogramPredictor — feature-free running histogram of observed output
    lengths (cold-start prior = workload config); always available.
  * OraclePredictor(accuracy=p) — returns the true bucket with probability p
    else a random one; lets benchmarks ablate prediction quality the same
    way the paper's proxy-model accuracy would vary.
"""
from __future__ import annotations

import bisect
import random
from typing import List, Optional, Sequence, Tuple


class LengthPredictor:
    """Percentile-bucketed length prediction."""

    def __init__(self, bucket_edges: Sequence[int]):
        """bucket_edges: ascending interior edges, e.g. [64, 128, 256, 512]
        makes buckets [1,64), [64,128), ..., [512, inf)."""
        self.edges = list(bucket_edges)

    # -- bucket helpers ------------------------------------------------------
    def bucket_of(self, length: int) -> int:
        return bisect.bisect_right(self.edges, length)

    def bucket_bounds(self, b: int) -> Tuple[int, int]:
        lo = 1 if b == 0 else self.edges[b - 1]
        hi = self.edges[b] if b < len(self.edges) else 4 * self.edges[-1]
        return lo, hi

    def lower_bound(self, b: int) -> int:
        return self.bucket_bounds(b)[0]

    def median(self, b: int) -> int:
        lo, hi = self.bucket_bounds(b)
        return (lo + hi) // 2

    # -- interface -----------------------------------------------------------
    def predict_bucket(self, request) -> int:
        raise NotImplementedError

    def observe(self, output_len: int) -> None:
        pass

    def n_future(self, request, n_past: int) -> int:
        """Conservative remaining-length estimate (paper: bucket lower bound
        minus tokens already generated, clamped positive)."""
        return max(1, self.lower_bound(self.predict_bucket(request)) - n_past)

    def n_median_total(self, request) -> int:
        return self.median(self.predict_bucket(request))


class HistogramPredictor(LengthPredictor):
    def __init__(self, bucket_edges: Sequence[int],
                 prior_counts: Optional[List[int]] = None):
        super().__init__(bucket_edges)
        n = len(bucket_edges) + 1
        self.counts = list(prior_counts) if prior_counts else [1] * n

    def observe(self, output_len: int) -> None:
        self.counts[self.bucket_of(output_len)] += 1

    def predict_bucket(self, request) -> int:
        return max(range(len(self.counts)), key=lambda i: self.counts[i])


class OraclePredictor(LengthPredictor):
    """Knows each request's true output length (sim only); degrades to a
    random bucket with probability 1-accuracy."""

    def __init__(self, bucket_edges: Sequence[int], accuracy: float = 1.0,
                 seed: int = 0):
        super().__init__(bucket_edges)
        self.accuracy = accuracy
        self.rng = random.Random(seed)

    def predict_bucket(self, request) -> int:
        true_b = self.bucket_of(request.output_len)
        if self.rng.random() < self.accuracy:
            return true_b
        return self.rng.randrange(len(self.edges) + 1)
