"""Offset extraction: structural mask -> ascending byte offsets.

The reference's `crush_set_bits` peels set bits off each 64-bit mask with
trailing-zeros + clear-lowest-bit, writing absolute offsets into an
over-extended Vec (stage1.rs:162-296). The device equivalent is stream
compaction with static shapes: an exclusive cumsum of the mask assigns each
set position its output slot, and a scatter (via `nonzero(size=...)`, which
XLA lowers to cumsum+scatter) materialises the offsets.

Two device variants:
- `extract_offsets_device`: fixed-capacity compaction entirely on device
  (offsets stay device-resident for gather serving);
- host fallback: pull the packed bitmask words and unpack+flatnonzero on
  the host (used when the density cap would be exceeded).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("capacity",))
def extract_offsets_device(mask2d: jnp.ndarray, capacity: int):
    """Compact set positions of a (rows, lanes) 0/1 mask into a
    fixed-capacity int32 offsets array (flat byte order).

    Returns (offsets[capacity], count). Slots past `count` hold the
    PADDED flat size rows*lanes (jnp.nonzero's fill_value) — not the
    input byte count, which padding makes smaller. If count > capacity
    the result is truncated — callers check and re-run with a larger
    cap.
    """
    flat = mask2d.reshape(-1)
    count = jnp.sum(flat, dtype=jnp.int32)
    (offsets,) = jnp.nonzero(flat, size=capacity, fill_value=flat.shape[0])
    return offsets.astype(jnp.int32), count


def count_set(mask2d: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(mask2d, dtype=jnp.int32)
