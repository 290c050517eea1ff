"""Vectorised UTF-8 validation.

The reference carries a dead simd-json UTF-8 checker (avx/utf8check.rs,
commented out of both mod.rs files — SURVEY.md §2.3) and a scalar
word-at-a-time `is_ascii` (reader.rs:36-132). This module provides both
capabilities for real, vectorised:

- `is_ascii`: all bytes < 0x80 (the fast path);
- `validate_utf8`: full RFC 3629 validation via the Keiser-Lemire
  three-nibble-LUT algorithm ("Validating UTF-8 In Less Than One
  Instruction Per Byte" — the construction simdjson uses): an error
  bitset per position from
      sc  = T1H[prev1 >> 4] & T1L[prev1 & 0xF] & T2H[cur >> 4]
      err = sc XOR (0x80 where a 3rd/4th continuation byte is required)
  is zero everywhere iff the (non-truncated) stream is valid; a final
  check rejects a truncated multi-byte sequence at the buffer end.

NumPy fancy indexing implements the 16-entry LUTs on host; the same
expressions trace under jnp for on-device validation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import as_u8

TOO_SHORT = 1 << 0
TOO_LONG = 1 << 1
OVERLONG_3 = 1 << 2
TOO_LARGE = 1 << 3
SURROGATE = 1 << 4
OVERLONG_2 = 1 << 5
TOO_LARGE_1000 = 1 << 6
OVERLONG_4 = 1 << 6  # shared bit, disjoint trigger patterns
TWO_CONTS = 1 << 7

CARRY = TOO_SHORT | TOO_LONG | TWO_CONTS


def _tables():
    t1h = np.zeros(16, np.uint8)
    t1h[0:8] = TOO_LONG
    t1h[8:12] = TWO_CONTS
    t1h[12] = TOO_SHORT | OVERLONG_2
    t1h[13] = TOO_SHORT
    t1h[14] = TOO_SHORT | OVERLONG_3 | SURROGATE
    t1h[15] = TOO_SHORT | TOO_LARGE | TOO_LARGE_1000 | OVERLONG_4

    t1l = np.full(16, CARRY, np.uint8)
    t1l[0] |= OVERLONG_3 | OVERLONG_2 | OVERLONG_4
    t1l[1] |= OVERLONG_2
    t1l[4] |= TOO_LARGE
    t1l[5:16] |= TOO_LARGE | TOO_LARGE_1000
    t1l[13] |= SURROGATE

    t2h = np.zeros(16, np.uint8)
    t2h[0:8] = TOO_SHORT
    t2h[8] = TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE_1000 | OVERLONG_4
    t2h[9] = TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE
    t2h[10] = TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE
    t2h[11] = TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE
    t2h[12:16] = TOO_SHORT
    return t1h, t1l, t2h


_T1H, _T1L, _T2H = _tables()


def _as_u8(data) -> np.ndarray:
    return as_u8(data)


def is_ascii(data: bytes | np.ndarray) -> bool:
    arr = _as_u8(data)
    return bool((arr < 0x80).all())


def validate_utf8_device(arr) -> bool:
    """Device-side full UTF-8 validation (jnp twin of validate_utf8):
    the three 16-entry LUTs become one-hot selects on device; shifts are
    pad/slice on the flat byte stream. Returns a host bool.

    Used by the validate_utf8 flag on create/PackedDeviceTape when the
    fused scan's non-ASCII counter fires (ASCII-only buffers never pay
    for this pass). Reference intent: avx/utf8check.rs:139-246 (dead
    there, live here)."""
    n = int(arr.shape[0])
    if n == 0:
        return True
    return int(_utf8_errs_jit(jnp.asarray(arr))) == 0


@jax.jit
def _utf8_errs_jit(a):
    """Error count of the device UTF-8 check (module-level jit: a
    per-call closure would re-trace and re-compile on every
    invocation)."""
    n = a.shape[0]
    # direct range logic instead of the 3 nibble LUTs: no
    # per-element table gathers, only ~20 vectorised compares that
    # fuse into one pass. Conditions are RFC 3629 verbatim;
    # equivalence with the LUT construction is pinned by the
    # differential tests.
    cur = a.astype(jnp.int32)

    def shift(k):
        return jnp.pad(cur, (k, 0))[:n]

    p1, p2, p3 = shift(1), shift(2), shift(3)
    is_cont = (cur & 0xC0) == 0x80
    lead2 = (p1 & 0xE0) == 0xC0
    lead3 = (p1 & 0xF0) == 0xE0
    lead4 = (p1 & 0xF8) == 0xF0
    lead3_2 = (p2 & 0xF0) == 0xE0
    lead4_2 = (p2 & 0xF8) == 0xF0
    lead4_3 = (p3 & 0xF8) == 0xF0
    must_cont = lead2 | lead3 | lead4 | lead3_2 | lead4_2 | lead4_3
    bad_cont = is_cont != must_cont
    # overlong / surrogate / out-of-range at the first continuation
    bad_first = (
        ((p1 == 0xC0) | (p1 == 0xC1))                      # overlong 2B
        | ((p1 == 0xE0) & (cur < 0xA0) & is_cont)          # overlong 3B
        | ((p1 == 0xED) & (cur >= 0xA0) & is_cont)         # surrogate
        | ((p1 == 0xF0) & (cur < 0x90) & is_cont)          # overlong 4B
        | ((p1 == 0xF4) & (cur >= 0x90) & is_cont)         # > U+10FFFF
        | (p1 >= 0xF5)                                     # invalid lead
    )
    errs = jnp.sum(bad_cont | bad_first)
    # truncated multi-byte sequence at the buffer end
    tail = (
        (a[n - 1] >= 0xC0).astype(jnp.int32)
        + (a[n - 2] >= 0xE0).astype(jnp.int32) * (1 if n >= 2 else 0)
        + (a[n - 3] >= 0xF0).astype(jnp.int32) * (1 if n >= 3 else 0)
    )
    return errs + tail



def validate_utf8(data: bytes | np.ndarray) -> bool:
    """True iff the buffer is valid UTF-8 (RFC 3629)."""
    arr = _as_u8(data)
    n = arr.size
    if n == 0:
        return True
    if (arr < 0x80).all():
        return True
    cur = arr.astype(np.int32)

    def shift(k: int) -> np.ndarray:
        return np.concatenate([np.zeros(k, np.int32), cur])[:n]

    prev1, prev2, prev3 = shift(1), shift(2), shift(3)

    sc = (
        _T1H[prev1 >> 4].astype(np.int32)
        & _T1L[prev1 & 0xF].astype(np.int32)
        & _T2H[cur >> 4].astype(np.int32)
    )
    # positions that MUST be a continuation because of a 3-byte lead two
    # back or a 4-byte lead three back; XOR cancels the legitimate
    # TWO_CONTS flags and raises an error where a required continuation
    # is missing
    must23 = ((prev2 >= 0xE0) | (prev3 >= 0xF0)).astype(np.int32) * TWO_CONTS
    if ((sc ^ must23) != 0).any():
        return False
    # truncated multi-byte sequence at the very end
    if arr[-1] >= 0xC0:
        return False
    if n >= 2 and arr[-2] >= 0xE0:
        return False
    if n >= 3 and arr[-3] >= 0xF0:
        return False
    return True
