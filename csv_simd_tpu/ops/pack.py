"""Bitmask packing: bool-per-byte masks -> packed 32-bit words.

The pack is a shift-and-accumulate of distinct powers of two. All
arithmetic is int32; the bit-31 contribution is INT32_MIN and the sum
reconstructs the exact two's-complement bit pattern, so the words are
int32 *bit patterns*.

The layout is **row-group-major**: for a (rows, 128) mask, word
(s, lane) holds mask rows s*32 .. s*32+31 of that lane, bit k = row
s*32+k, i.e. bit k of word (s, lane) covers flat byte position
(s*32 + k) * 128 + lane. This is the compact off-chip index artifact
(1 bit per input byte).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_words(mask: jnp.ndarray) -> jnp.ndarray:
    """(rows, 128) 0/1 int32 mask -> (rows//32, 128) int32
    row-group-major packed words."""
    rows, lanes = mask.shape
    assert rows % 32 == 0
    shifts = jax.lax.broadcasted_iota(jnp.int32, (rows, lanes), 0) % 32
    contrib = mask.astype(jnp.int32) << shifts
    return jnp.sum(contrib.reshape(rows // 32, 32, lanes), axis=1, dtype=jnp.int32)


def unpack_words_host(words: np.ndarray, n_bytes: int) -> np.ndarray:
    """Host inverse: (rows//32, 128) int32 words -> 0/1 uint8 flat mask of
    length n_bytes (row-major flat byte order). (x >> k) & 1 extracts bit
    k regardless of the arithmetic shift's sign fill."""
    s, lanes = words.shape
    bits = (words[:, None, :] >> np.arange(32)[None, :, None]) & 1
    return bits.reshape(s * 32, lanes).reshape(-1)[:n_bytes].astype(np.uint8)


def unpack_words_device(words: jnp.ndarray) -> jnp.ndarray:
    """Device inverse -> (rows, 128) int32 0/1 mask."""
    s, lanes = words.shape
    shifts = jnp.arange(32, dtype=jnp.int32)[None, :, None]
    bits = (words[:, None, :] >> shifts) & 1
    return bits.reshape(s * 32, lanes).astype(jnp.int32)


def pad_to_words(arr: np.ndarray, row_align: int = 512) -> np.ndarray:
    """uint8 1-D -> zero-padded (rows, 128) int32 little-endian byte-quad
    words, the input layout of the stage-1 scans (ops/stage1_v3.py);
    rows bucketed like index.pad_to_grid. Padding is 0x00, which
    classifies to nothing."""
    lanes = 128
    n = arr.size
    row_bytes = lanes * 4
    rows = max(-(-n // row_bytes), 1)
    rows = -(-rows // row_align) * row_align
    if rows <= 8192:
        bucket = row_align
        while bucket < rows:
            bucket *= 2
        rows = bucket
    else:
        rows = -(-rows // 8192) * 8192
    padded = np.zeros(rows * row_bytes, dtype=np.uint8)
    padded[:n] = arr
    return padded.view("<i4").reshape(rows, lanes)
