"""Device JSON stage-1: escape-aware structural masking on the device.

The jitted counterpart of experiments/json_levels.py (the golden
bitmask-int oracle): classify -> odd-backslash-run escape resolution ->
escape-aware quote parity -> structural mask, all as fixed-shape XLA
ops over the flat byte stream.

The backslash-run carry — the one piece VERDICT r1 noted had no device
counterpart — is solved here without simdjson's add-with-carry trick
(which needs cross-word carry propagation): run starts are marked, run
origins are recovered with a segmented cummax (associative_scan), and a
position is escaped iff its predecessor ends an odd-length run. That is
an O(log n) data-parallel formulation of the same predicate, exact for
runs of ANY length (including runs crossing any block boundary).

Reference analog: json_test.rs (a 16-byte fixture experiment, never
live); simdjson stage 1 is the published construction both follow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..offsetfree import fast_cumsum_i32
from ..utils import as_u8

_STRUCTURAL = tuple(b"{}[]:,")


def fast_cummax_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix-MAX of a 1-D int32 array (values >= -1) via the
    same hierarchical (rows, 512) log-step construction as
    fast_cumsum_i32 — `lax.associative_scan` over tens of millions of
    elements unrolls into a large XLA graph; this one stays a few
    shift-adds per level."""
    n = x.shape[0]
    if n <= 2048:
        return jax.lax.associative_scan(jnp.maximum, x)
    w = 512
    rows = -(-n // w)
    padded = jnp.pad(x, (0, rows * w - n), constant_values=-1).reshape(rows, w)
    s = 1
    while s < w:
        shifted = jnp.pad(padded, ((0, 0), (s, 0)), constant_values=-1)[:, :w]
        padded = jnp.maximum(padded, shifted)
        s *= 2
    tot = padded[:, w - 1]
    incl = fast_cummax_i32(tot)
    excl = jnp.pad(incl, (1, 0), constant_values=-1)[:rows]
    return jnp.maximum(padded, excl[:, None]).reshape(-1)[:n]


@jax.jit
def json_structural_mask_device(arr: jnp.ndarray) -> jnp.ndarray:
    """(n,) uint8 -> (n,) int32 0/1 mask of JSON structural characters
    outside strings (escape-aware). Bit-identical to the golden
    json_levels.json_structural_index support."""
    n = arr.shape[0]
    b = arr.astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)

    is_bs = b == 0x5C
    prev_bs = jnp.pad(is_bs, (1, 0))[:n]
    run_start = fast_cummax_i32(jnp.where(is_bs & ~prev_bs, pos, -1))
    rs_prev = jnp.pad(run_start, (1, 0), constant_values=-1)[:n]
    # escaped iff the previous byte ends a backslash run of odd length:
    # length = (i-1) - run_start + 1 odd  <=>  (i-1 - run_start) even
    escaped = prev_bs & (((pos - 1 - rs_prev) & 1) == 0)

    q_eff = (b == 0x22) & ~escaped
    in_string = fast_cumsum_i32(q_eff.astype(jnp.int32)) & 1

    structural = jnp.zeros(n, bool)
    for c in _STRUCTURAL:
        structural = structural | (b == c)
    # structural chars are never quotes, so the inclusive string mask
    # equals the exclusive one at these positions (clmul semantics)
    return (structural & (in_string == 0)).astype(jnp.int32)


def json_structural_index_device(data: bytes | np.ndarray) -> np.ndarray:
    """Offsets of JSON structural chars outside strings, computed on
    device; host-compacted (same split as the CSV paths)."""
    arr = as_u8(data)
    if arr.size == 0:
        return np.empty(0, np.int64)
    mask = np.asarray(json_structural_mask_device(jnp.asarray(arr)))
    return np.flatnonzero(mask).astype(np.int64)


@jax.jit
def json_depths_device(arr: jnp.ndarray) -> tuple:
    """(n,) uint8 -> (mask, depth) where depth[i] is the container
    nesting depth AT each structural char (level_sets semantics: an
    opener reports the depth it opens FROM, a closer the depth it
    closes TO). Depth is a cumsum of +/-1 over openers/closers outside
    strings — the 'level set' computation on device."""
    mask = json_structural_mask_device(arr)
    b = arr.astype(jnp.int32)
    opens = ((b == 0x7B) | (b == 0x5B)) & (mask == 1)
    closes = ((b == 0x7D) | (b == 0x5D)) & (mask == 1)
    delta = opens.astype(jnp.int32) - closes.astype(jnp.int32)
    incl = fast_cumsum_i32(delta)
    # openers: depth before the char (incl - 1); closers: depth after
    # (incl); others: current depth (incl)
    depth = jnp.where(opens, incl - 1, incl)
    return mask, depth
