"""Stage-1 scan in plain XLA: byte-quad words -> packed structural bits.

The input is the (rows, 128) int32 view of the zero-padded bytes
(ops/pack.pad_to_words): each lane holds 4 bytes, classified at once by
exact SWAR byte equality (ops/swar.py). Quote parity is an in-word
prefix-XOR, then an exclusive prefix over lanes and a cumsum over rows;
a carry bit enters at the start, so chunks, tiles and shards stitch
with the same associative carry.

Two packed layouts leave the scan:

- fold (`stage1_swar_xla`), tile-dependent, default tile=512: for tile
  s, output row group g in [0, tile/8), word (s*tile/8 + g, lane) holds
  bit (8*b + sigma(j)) = byte b of input word (s*tile + j*tile/8 + g,
  lane), where sigma(j) = 7 - bitrev3(j) (right-shift fold order).
  Inverted by `unpack_packed_host` and the native extractor.
- sequential (`stage1_seq_xla`): the flat little-endian bitstream of
  the structural mask, which offsets-free serving rank-selects in.

Reference lineage: same fused pipeline as avx/stage1.rs:193-430; SWAR
equality replaces the nibble-LUT vpshufb and log-step scans replace
PCLMULQDQ (prefix-XOR is associative; SURVEY.md §7.1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_DIALECT, Dialect
from .swar import (
    swar_broadcast_flag,
    swar_classify_raw,
    swar_classify_s80_q80,
    swar_eq,
    swar_prefix_xor_bytes,
    swar_word_parity,
)

_HI1 = -0x7F7F7F80  # 0x80808080 as int32

LANES = 128
DEFAULT_ROW_TILE = 512  # x 512 B/row = 256 KiB of input per fold tile

_SIGMA = [7, 3, 5, 1, 6, 2, 4, 0]  # sigma(j) = 7 - bitrev3(j)


def _classify(x: jnp.ndarray, dialect: Dialect):
    """0x80-flag (structural, quote) classify. Uses the shared-
    subexpression detector (~30% fewer ops) for ASCII dialects, the
    independent exact detectors otherwise."""
    chars = dialect.newlines + (dialect.delimiter,)
    if dialect.quote < 0x80 and all(c < 0x80 for c in chars):
        sf, qf = swar_classify_s80_q80(x, chars, dialect.quote)
        return sf, qf
    qf = swar_eq(x, dialect.quote)
    sf = swar_eq(x, dialect.delimiter)
    for nl in dialect.newlines:
        sf = sf | swar_eq(x, nl)
    return sf, qf


def _classify_raw(x: jnp.ndarray, dialect: Dialect):
    """Raw classify for the fused mask chain: (s_nomatch, q_raw) — see
    swar_classify_raw for the bit-7-only contract. The mask chain then
    computes `~(s_nomatch | inq_raw) & 0x80808080` directly, never
    materializing clean sf/qf flag tensors (2 full-width ops fewer)."""
    chars = dialect.newlines + (dialect.delimiter,)
    if dialect.quote < 0x80 and all(c < 0x80 for c in chars):
        s_no, q_raw, _ = swar_classify_raw(x, chars, dialect.quote)
        return s_no, q_raw
    sf, qf = _classify(x, dialect)
    return ~sf, qf


def _scan_masked(w2d: jnp.ndarray, carry_in, dialect: Dialect):
    """Shared XLA scan internals: byte-quad words -> (masked 0x80 flag
    words (rows,128), total quote parity). Both packers build on this."""
    rows, lanes = w2d.shape
    # raw classify + fused mask chain (bit-7-only contract:
    # swar_classify_raw)
    s_no, qf = _classify_raw(w2d, dialect)
    p_in = swar_prefix_xor_bytes(qf)
    wp = swar_word_parity(p_in)
    incl = wp
    s = 1
    while s < lanes:
        incl = incl + jnp.pad(incl, ((0, 0), (s, 0)))[:, :lanes]
        s *= 2
    lane_excl = incl - wp
    row_tot = incl[:, lanes - 1]
    row_excl = (jnp.cumsum(row_tot) - row_tot)[:, None]
    base = (lane_excl + row_excl + carry_in) & 1
    inq = p_in ^ swar_broadcast_flag(base)
    masked = ~(s_no | inq) & _HI1
    parity = (jnp.sum(wp) + carry_in) & 1
    return masked, parity


@functools.partial(jax.jit, static_argnames=("dialect",))
def stage1_seq_xla(
    w2d: jnp.ndarray,
    carry_in,
    dialect: Dialect = DEFAULT_DIALECT,
):
    """XLA scan emitting SEQUENTIAL-order packed words: (rows, 16) int32
    where bit m of word (r, g) covers flat byte r*512 + 32*g + m — i.e.
    the flat little-endian bitstream of the structural mask. This is the
    layout offset-free serving needs (popcount-prefix + rank-select);
    `np.unpackbits(words.view('<u4').view(uint8), bitorder='little')`
    inverts it directly.

    Pack: per-word 4-flag compress via the multiply-gather
    (u * 0x01020408) >> 24, then 8 lanes combine with shifts 4l.
    Returns (packed_seq, parity_out)."""
    rows, lanes = w2d.shape
    masked, parity = _scan_masked(w2d, carry_in, dialect)
    # masked has ONLY bit-7 positions set -> one logical shift gives
    # clean 0x01 flags (no clear-AND)
    u = jax.lax.shift_right_logical(masked, 7)
    v = (u * 0x01020408) >> 24  # bit b of v = byte b's flag (swar proof)
    w3 = v.reshape(rows, 16, 8)
    shifts = (jnp.arange(8, dtype=jnp.int32) * 4)[None, None, :]
    packed = jnp.sum(w3 << shifts, axis=-1, dtype=jnp.int32)
    return packed, parity


@functools.partial(jax.jit, static_argnames=("dialect", "row_tile"))
def stage1_swar_xla(
    w2d: jnp.ndarray,
    carry_in,
    dialect: Dialect = DEFAULT_DIALECT,
    row_tile: int = DEFAULT_ROW_TILE,
):
    """Fold-layout scan (see the module docstring): (rows, 128) words
    + carry parity -> (packed (rows//8, 128) int32, parity_out). Rows
    must be a multiple of the tile, min(row_tile, rows)."""
    rows, lanes = w2d.shape
    tile = min(row_tile, rows)
    steps = rows // tile
    masked, parity = _scan_masked(w2d, carry_in, dialect)
    # per-tile fold pack: three right-shift folds (shifts stay in bytes)
    t = masked.reshape(steps, tile, lanes)
    h = tile // 2
    sr = jax.lax.shift_right_logical
    t = t[:, :h] | sr(t[:, h:], 1)
    h //= 2
    t = t[:, :h] | sr(t[:, h:], 2)
    h //= 2
    t = (t[:, :h] | sr(t[:, h:], 4)).reshape(rows // 8, lanes)
    return t, parity


def count_packed(packed: jnp.ndarray) -> jnp.ndarray:
    """Total structural count from packed words (a popcount over 1/32
    of the input data)."""
    return jnp.sum(jax.lax.population_count(packed), dtype=jnp.int32)


def unpack_packed_host(
    packed: np.ndarray, n_bytes: int, tile: int = DEFAULT_ROW_TILE
) -> np.ndarray:
    """Invert the fold-pack: (rows//8, 128) int32 -> flat 0/1 uint8 mask
    of n_bytes. `tile` must match the build (min(row_tile, rows))."""
    g_total, lanes = packed.shape
    rows = g_total * 8
    tile = min(tile, rows)
    gp = tile // 8
    steps = g_total // gp
    p3 = packed.reshape(steps, gp, lanes)
    # out[steps, j, gp, lanes, b] = bit (8b + sigma(j))
    out = np.empty((steps, 8, gp, lanes, 4), np.uint8)
    for j in range(8):
        for b in range(4):
            out[:, j, :, :, b] = (p3 >> (8 * b + _SIGMA[j])) & 1
    return out.reshape(-1)[:n_bytes]
