"""Quote-parity propagation as prefix scans.

The reference computes the in-quote mask 64 bits at a time with
PCLMULQDQ-against-all-ones — a 64-bit inclusive prefix XOR — and threads a
sign-extended carry between blocks (avx/stage1.rs:342-407, reader.rs:239).
XOR-parity of 0/1 indicators is just (prefix sum) mod 2, and prefix sum is
associative, so on the device the whole construction becomes a
two-level scan over the (rows, lanes) byte layout:

  inclusive parity at flat position r*L + c
    = (cumsum of quotes within row r up to c
       + exclusive cumsum of per-row quote totals at r
       + carry_in) mod 2

The same decomposition stitches tiles,
chunks (streaming carry) and shards (exclusive XOR-scan collective) —
SURVEY.md §5.7/§5.8.
"""

from __future__ import annotations

import jax.numpy as jnp


def inclusive_scan_lanes(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix-sum along the lane (last) axis via log2(lanes)
    shift-and-add steps (Hillis–Steele). Constant op count regardless of
    row count — unlike jnp.cumsum(axis=1), whose XLA:CPU lowering has
    pathological compile-time scaling — and maps to plain shifts/adds.
    """
    lanes = x.shape[-1]
    shift = 1
    while shift < lanes:
        shifted = jnp.pad(x, ((0, 0), (shift, 0)))[:, :lanes]
        x = x + shifted
        shift *= 2
    return x


def in_quote_parity(quote: jnp.ndarray, carry_in) -> jnp.ndarray:
    """Inclusive quote parity over a (rows, lanes) 0/1 quote mask, row-major
    flat order. Returns int32 0/1 array of the same shape; 1 = inside
    quotes (opening quote included, closing excluded — clmul semantics).

    carry_in: scalar 0/1 parity carried from preceding bytes.
    """
    q = quote.astype(jnp.int32)
    within = inclusive_scan_lanes(q)  # inclusive, per-row
    row_tot = within[:, -1]
    row_excl = jnp.cumsum(row_tot) - row_tot  # exclusive over rows
    return (within + row_excl[:, None] + carry_in) & 1


def parity_out(quote: jnp.ndarray, carry_in) -> jnp.ndarray:
    """Scalar parity after consuming the whole buffer."""
    return (jnp.sum(quote.astype(jnp.int32)) + carry_in) & 1
