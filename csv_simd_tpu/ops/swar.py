"""SWAR primitives: byte-wise operations on int32-packed byte quads.

Treating each 32-bit lane as 4 packed bytes quadruples per-op
throughput over the upcast-each-byte approach. Bytes
are packed little-endian (byte k of memory = bits 8k..8k+7), matching a
host-side `view('<i4')` of the byte stream.

`swar_eq` uses the exact zero-byte detector (Hacker's Delight 6-1,
carry-free variant): bit 7 of each byte of the result is set iff that
byte of `x` equals `byte`. The naive `(v-0x01010101) & ~v & 0x80808080`
detector has cross-byte borrow false positives (a 0x01 byte following a
0x00 byte is flagged) and is NOT used.
"""

from __future__ import annotations

import jax.numpy as jnp

_LO7 = 0x7F7F7F7F
_HI1 = -0x7F7F7F80  # 0x80808080 as int32


def _bcast32(byte: int) -> int:
    """byte replicated into an int32 bit pattern (two's-complement safe
    for bytes >= 0x80)."""
    v = (byte & 0xFF) * 0x01010101
    return v - (1 << 32) if v >= (1 << 31) else v


def swar_eq(x: jnp.ndarray, byte: int) -> jnp.ndarray:
    """0x80 flag per byte of x equal to `byte` (int32 lanes, 4 bytes each)."""
    y = x ^ jnp.int32(_bcast32(byte))
    t = (y & _LO7) + _LO7  # bit7 of each byte set iff low7 bits nonzero
    t = t | y              # ... or iff bit7 of y set
    return ~t & _HI1       # 0x80 iff the whole byte was zero


_ONES = 0x01010101


def swar_eq_alt(x: jnp.ndarray, byte: int) -> jnp.ndarray:
    """Same function as swar_eq via a different exact identity:
    ((y | 0x80..) - 0x01..) | y has byte-bit7 clear iff the byte is zero
    (each byte of y|0x80.. is >= 0x80 so the subtract never borrows
    across bytes). Deliberately NOT syntactically equal to swar_eq —
    kernels use it to rematerialize classification after a matmul
    boundary without common-subexpression elimination fusing the two
    computations back into one long-lived intermediate."""
    y = x ^ jnp.int32(_bcast32(byte))
    t = ((y | _HI1) - _ONES) | y
    return (t ^ _HI1) & _HI1  # bit7 clear -> flag 0x80


def _classify_parts(x: jnp.ndarray, structural: tuple, quote: int):
    assert quote < 0x80 and all(c < 0x80 for c in structural)
    xl = x & _LO7
    xh = x & _HI1
    ts = None
    for c in structural:
        t = (xl ^ jnp.int32(_bcast32(c) & _LO7)) + _LO7
        ts = t if ts is None else ts & t
    tq = (xl ^ jnp.int32(_bcast32(quote) & _LO7)) + _LO7
    return ts, tq, xh


def swar_classify_s80_q80(
    x: jnp.ndarray, structural: tuple, quote: int
) -> tuple:
    """Shared-subexpression classify, 0x80-flag outputs (drop-in for
    paired swar_eq calls): (sf, qf) with bit 7 per byte set iff the byte
    matches any `structural` char / the quote char. ~30% fewer vector ops
    than independent detectors: the low-7 mask and bit-7 test are
    hoisted (targets must be ASCII < 0x80, asserted), each char then
    costs 2 ops, and per-char results combine before one final negate."""
    ts, tq, xh = _classify_parts(x, structural, quote)
    return ~(ts | xh) & _HI1, ~(tq | xh) & _HI1


def swar_classify_raw(
    x: jnp.ndarray, structural: tuple, quote: int
) -> tuple:
    """Raw classify for mask-chain fusion: (s_nomatch, q_raw, xh).

    bit 7 of each byte of `s_nomatch` is SET iff the byte does NOT
    match any `structural` char; bit 7 of `q_raw` is SET iff the byte
    IS the quote; `xh` = x & 0x80808080. All NON-bit-7 positions of
    s_nomatch/q_raw are GARBAGE — safe consumers are exactly the ops
    whose bit-7 lanes are independent of the other bits: XOR/OR/AND
    against other bit-7-correct values, shifts by multiples of 8
    (swar_prefix_xor_bytes moves bit 8j+7 onto bit 8k+7, never a
    garbage bit), arithmetic >> 31 (replicates bit 31), and a final
    & 0x80808080 cleanup. This drops the two cleanup ops per output
    that swar_classify_s80_q80 pays to return clean flags the
    kernel's mask chain re-ANDs with 0x80808080 anyway."""
    ts, tq, xh = _classify_parts(x, structural, quote)
    return ts | xh, ~(tq | xh), xh


def swar_classify_u(
    x: jnp.ndarray, structural: tuple, quote: int
) -> tuple:
    """Shared-subexpression classify, both outputs in 0x01-flag form.

    Same role as the reference's nibble-LUT classify
    (avx/stage1.rs:249-316); construction is original SWAR.
    """
    ts, tq, xh = _classify_parts(x, structural, quote)
    return (~(ts | xh) >> 7) & _ONES, (~(tq | xh) >> 7) & _ONES


def swar_nibble_compress(u: jnp.ndarray) -> jnp.ndarray:
    """0x01-per-byte flags -> 4-bit value per word (bit b = byte b's
    flag): multiply-gather (u * 0x01020408) places u0..u3 at bits
    24..27. No mask needed: the multiplier's shifts are {3,10,17,24}
    and the flag bytes sit at bits {0,8,16,24}, so the only pairs that
    land in bits 24..31 are 0+24, 8+17, 16+10, 24+3 (= bits 24..27) —
    every other pair is >= 32 and wraps away, leaving bits 28..31 zero
    and the arithmetic >>24 exact. Input bytes MUST be 0/1."""
    return (u * 0x01020408) >> 24


def swar_prefix_xor_bytes(flags: jnp.ndarray) -> jnp.ndarray:
    """In-word inclusive prefix XOR of 0x80-per-byte flags, in memory
    (little-endian) byte order: output bit 8k+7 = XOR of input flags of
    bytes 0..k."""
    p = flags ^ (flags << 8)
    return p ^ (p << 16)


def swar_word_parity(prefix: jnp.ndarray) -> jnp.ndarray:
    """Whole-word flag parity (0/1 int32) from swar_prefix_xor_bytes."""
    return (prefix >> 31) & 1


def swar_broadcast_flag(bit: jnp.ndarray) -> jnp.ndarray:
    """0/1 int32 -> 0x80808080-style all-bytes flag broadcast."""
    return bit * _HI1
