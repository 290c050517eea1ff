"""Byte classification on device.

The reference classifies with two 16-entry nibble LUTs because `vpshufb`
is the only fast byte-wise table lookup on x86 (stage1.rs:24-35,
avx/stage1.rs:249-316). Vector hardware with native byte compares
classifies with a handful of `==` compares against the
dialect's role bytes — same byte->class function (asserted against the
LUTs in tests), no gather, fuses into the surrounding kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import Dialect


def classify_masks(b: jnp.ndarray, dialect: Dialect):
    """uint8 bytes -> (structural, quote) boolean masks.

    structural = delimiter or any newline byte (the reference's code&3,
    avx/stage1.rs:394); quote = the dialect quote byte.
    """
    nl = b == jnp.uint8(dialect.newlines[0])
    for extra in dialect.newlines[1:]:
        nl = nl | (b == jnp.uint8(extra))
    delim = b == jnp.uint8(dialect.delimiter)
    quote = b == jnp.uint8(dialect.quote)
    return nl | delim, quote


@partial(jax.jit, static_argnames=("dialect",))
def classify_codes(b: jnp.ndarray, dialect: Dialect) -> jnp.ndarray:
    """Full bit-set codes (newline=1, delim=2, space=4, escape=8, quote=16),
    for parity checks against the golden LUT classification."""
    code = jnp.zeros(b.shape, jnp.uint8)
    for nlb in dialect.newlines:
        code = code | jnp.where(b == jnp.uint8(nlb), jnp.uint8(1), jnp.uint8(0))
    pairs = [
        (dialect.delimiter, 2),
        (dialect.space, 4),
        (dialect.escape, 8),
        (dialect.quote, 16),
    ]
    for byte, c in pairs:
        code = code | jnp.where(b == jnp.uint8(byte), jnp.uint8(c), jnp.uint8(0))
    return code
