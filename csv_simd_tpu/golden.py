"""Golden model: a pure-NumPy oracle of the reference's stage-1 semantics.

Implements the verified behavioral contract (SURVEY.md §8) that every device
path (the XLA scans, sharded build, streaming build) is
differentially tested against:

1. classify each byte via the nibble LUTs (stage1.rs:24-35, 41-52);
2. in-quote mask = inclusive prefix-XOR of the quote indicator, with quote
   parity carried across blocks (avx/stage1.rs:342-407 — the reference
   computes this 64 bits at a time with PCLMULQDQ against all-ones, which
   *is* a 64-bit inclusive prefix XOR);
3. structural mask = (code & 3) outside quotes;
4. index = [0 sentinel] ++ ascending absolute offsets of unmasked
   structural bytes (reader.rs:216, 305).

This model is deliberately scalar/vector NumPy with no blocking: blocking,
padding and carries are *implementation details* of the device paths, and
the oracle must be independent of them.
"""

from __future__ import annotations

import numpy as np

from .config import (
    CODE_QUOTE,
    CODE_STRUCTURAL,
    DEFAULT_DIALECT,
    Dialect,
    build_full_lut,
)


def classify(data: np.ndarray, dialect: Dialect = DEFAULT_DIALECT) -> np.ndarray:
    """Byte -> bit-set code for every byte (uint8 array in, uint8 out)."""
    lut = build_full_lut(dialect)
    return lut[data]


def quote_mask(quote_bits: np.ndarray, carry_in: int = 0) -> np.ndarray:
    """Inclusive prefix-XOR of a 0/1 quote indicator.

    mask[i] = carry_in XOR quote[0] XOR ... XOR quote[i]; 1 means position i
    is inside a quoted region (the opening quote itself is inside, the
    closing quote is outside — exactly the PCLMULQDQ-with-ones semantics,
    avx/stage1.rs:342-361). RFC-4180 escaped quotes `""` toggle parity
    twice and therefore need no special handling for masking purposes.
    """
    par = np.bitwise_xor.accumulate(quote_bits.astype(np.uint8))
    if carry_in:
        par ^= 1
    return par


def structural_mask(
    data: np.ndarray, dialect: Dialect = DEFAULT_DIALECT, carry_in: int = 0
) -> np.ndarray:
    """0/1 mask of structural bytes (delimiter/newline) outside quotes."""
    codes = classify(data, dialect)
    quotes = ((codes & CODE_QUOTE) != 0).astype(np.uint8)
    in_quote = quote_mask(quotes, carry_in)
    struct = ((codes & CODE_STRUCTURAL) != 0).astype(np.uint8)
    return struct & (1 - in_quote)


def structural_index(
    data: bytes | np.ndarray,
    dialect: Dialect = DEFAULT_DIALECT,
) -> np.ndarray:
    """Full structural index ("tape") of a byte buffer.

    Returns int64 offsets with the leading 0 sentinel (reader.rs:216): for
    `res/reader_test01.csv` this is [0, 4, 12, 18, 25, 27, 32, ..., 95]
    (verified against the reference's own test, reader.rs:325-326).
    """
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    mask = structural_mask(arr, dialect)
    offsets = np.flatnonzero(mask).astype(np.int64)
    return np.concatenate([np.zeros(1, dtype=np.int64), offsets])


def quote_parity_out(
    data: bytes | np.ndarray, dialect: Dialect = DEFAULT_DIALECT, carry_in: int = 0
) -> int:
    """Quote parity after consuming the buffer — the carry the reference
    threads between 64-byte blocks as `in_string` (reader.rs:218,239,284),
    and the carry our device paths thread between tiles/shards."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    codes = classify(arr, dialect)
    n_quotes = int(((codes & CODE_QUOTE) != 0).sum())
    return (carry_in ^ n_quotes) & 1
