"""Unit-dimension vocabulary for the KV-accounting surface.

Every accounting bug fixed in PRs 2, 6 and 8 was a unit confusion:
token counts compared against block counts, bytes priced as tokens,
layer indices used as sizes. The Eq.1/3/4 pipeline converts between
five dimensions constantly, so the conversions are made *first-class*
here and everything else is forbidden from mixing dimensions at all.

The aliases are `typing.NewType`-style in intent but implemented as
transparent `TypeAlias`es: a `Tokens` value is a plain `int` at runtime
and to mypy (so arithmetic, dataclass fields and third-party call sites
keep working untouched); the *checking* is supplied by the UNIT001
repro-lint rule (tools/analyze/units.py), which propagates these
dimensions through assignments, arithmetic, calls and returns and flags
any cross-dimension mixing that does not go through a sanctioned
converter below (or an annotated converting method such as
`LayerwiseBlockManager.blocks_for_tokens`).

Sanctioned converters (the ONLY blessed casts — see the table in
docs/ARCHITECTURE.md "Invariants & analysis"):

    tokens_to_blocks   Tokens -> Blocks   ceil-divide by block_size
    blocks_to_tokens   Blocks -> Tokens   multiply by block_size
    tokens_to_bytes    Tokens -> Bytes    multiply by bytes/token
    blocks_to_bytes    Blocks -> Bytes    via blocks_to_tokens
    bytes_to_seconds   Bytes  -> Seconds  divide by link bandwidth
"""
from __future__ import annotations

from typing import TypeAlias

# Dimension aliases. Transparent on purpose: UNIT001 reads these NAMES
# out of annotations; the runtime and mypy see plain int/float.
Tokens: TypeAlias = int      # prompt/generated token counts
Blocks: TypeAlias = int      # paged-KV block counts (device or host)
Bytes: TypeAlias = int       # raw KV byte counts (ledger, link pricing)
LayerIdx: TypeAlias = int    # a transformer layer index (NOT a size)
Seconds: TypeAlias = float   # virtual-clock durations and stamps


def tokens_to_blocks(n_tokens: Tokens, block_size: int) -> Blocks:
    """Blocks needed to hold `n_tokens` (ceil: a partial block is a
    whole block — the same rounding every pool allocation pays)."""
    return -(-n_tokens // block_size) if n_tokens > 0 else 0


def blocks_to_tokens(n_blocks: Blocks, block_size: int) -> Tokens:
    """Token CAPACITY of `n_blocks` (the upper edge of the ceil above:
    converting back and forth can only grow, never lose, capacity)."""
    return n_blocks * block_size


def tokens_to_bytes(n_tokens: Tokens, bytes_per_token: int) -> Bytes:
    """KV bytes for `n_tokens` at a per-token KV footprint (the cost
    model's 2 * d_model * dtype_bytes per layer, times layers)."""
    return n_tokens * bytes_per_token


def blocks_to_bytes(n_blocks: Blocks, block_size: int,
                    bytes_per_token: int) -> Bytes:
    """KV bytes held by `n_blocks` full blocks."""
    return tokens_to_bytes(blocks_to_tokens(n_blocks, block_size),
                           bytes_per_token)


def bytes_to_seconds(n_bytes: Bytes, bandwidth: float) -> Seconds:
    """Link occupancy for `n_bytes` at `bandwidth` bytes/second (the
    ledger's pricing of one offload/reload transfer)."""
    return n_bytes / bandwidth
