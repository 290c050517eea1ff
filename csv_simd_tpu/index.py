"""Index-build driver: bytes -> structural index ("the tape").

The analog of the reference's `reader::read` (reader.rs:150-306), redesigned
for XLA: instead of a serial loop over 64-byte SIMD blocks with a carried
quote parity, the whole buffer is laid out as a (rows, 128) array,
zero-padded like the reference's tail block (0x00 classifies to nothing,
avx/stage1.rs:37-94), and processed by one fused
classify -> parity-scan -> mask -> bitpack computation. The device emits
packed bitmask words (1 bit per input byte); offsets are compacted either
on device (fixed-capacity nonzero) or on host.

Backends: "jnp" (the XLA scan on JAX's default device), "native" (the
C++ host engine), "golden" (the NumPy oracle); "auto" is "jnp".
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_DIALECT, Dialect
from .ops.classify import classify_masks
from .ops.compact import extract_offsets_device
from .ops.pack import pack_words, pad_to_words
from .ops.scan import in_quote_parity, parity_out
from .utils import as_u8

LANES = 128
ROW_ALIGN = 32  # rows per packed word (ops/pack.pack_words)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_grid(arr: np.ndarray, row_align: int = ROW_ALIGN) -> np.ndarray:
    """uint8 1-D -> zero-padded (rows, LANES) with rows % row_align == 0.

    Row counts are bucketed (next power of two up to 8192, then multiples
    of 8192) so repeated small builds share a handful of compiled shapes
    instead of recompiling per input size; padding is 0x00, which
    classifies to nothing (the reference's zero-padded tail block,
    avx/stage1.rs:37-94).
    """
    n = arr.size
    rows = max(_cdiv(n, LANES), 1)
    rows = _cdiv(rows, row_align) * row_align
    if rows <= 8192:
        bucket = row_align
        while bucket < rows:
            bucket *= 2
        rows = bucket
    else:
        rows = _cdiv(rows, 8192) * 8192
    padded = np.zeros(rows * LANES, dtype=np.uint8)
    padded[:n] = arr
    return padded.reshape(rows, LANES)


@partial(jax.jit, static_argnames=("dialect",))
def stage1_jnp(b2d: jnp.ndarray, carry_in, dialect: Dialect = DEFAULT_DIALECT):
    """Fused stage-1 scan over (rows, 128) bytes + carry parity ->
    (row-group-major packed words (rows//32, 128), parity_out); the
    layout of ops/pack.pack_words."""
    struct, quote = classify_masks(b2d, dialect)
    inq = in_quote_parity(quote, carry_in)
    masked = (struct & (inq == 0)).astype(jnp.int32)
    words = pack_words(masked)
    return words, parity_out(quote, carry_in)


@partial(jax.jit, static_argnames=("dialect",))
def stage1_mask_jnp(b2d: jnp.ndarray, carry_in, dialect: Dialect = DEFAULT_DIALECT):
    """Same scan but returning the unpacked 0/1 mask (for device-side
    compaction / differential tests)."""
    struct, quote = classify_masks(b2d, dialect)
    inq = in_quote_parity(quote, carry_in)
    masked = struct & (inq == 0)
    return masked.astype(jnp.int32), parity_out(quote, carry_in)


_BACKENDS = ("auto", "jnp", "native", "golden")


def _resolve_backend(backend: str) -> str:
    if backend == "pallas":
        raise ValueError(
            "backend 'pallas' was removed with its hand-written kernels; "
            "'jnp' (or 'auto') runs the same scan through XLA"
        )
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {_BACKENDS}"
        )
    return "jnp" if backend == "auto" else backend


def stage1_words(
    data: bytes | np.ndarray,
    dialect: Dialect = DEFAULT_DIALECT,
    backend: str = "auto",
    carry_in: int = 0,
):
    """bytes -> (packed words int32 (rows//32, 128) [ops/pack.pack_words
    layout], n_bytes, parity_out int); unpack with
    ops/pack.unpack_words_host."""
    arr = as_u8(data)
    b2d = pad_to_grid(arr)
    backend = _resolve_backend(backend)
    if backend == "jnp":
        words, par = stage1_jnp(jnp.asarray(b2d), jnp.int32(carry_in), dialect)
    else:
        raise ValueError(
            f"stage1_words emits packed device words; backend {backend!r} "
            "does not (use build_index for native/golden)"
        )
    return np.asarray(words), arr.size, int(par)


def extract_offsets_from_packed(packed_np: np.ndarray, tile: int,
                                n_bytes: int, base: int = 0) -> np.ndarray:
    """Fold-layout packed words -> ascending int64 ABSOLUTE structural
    offsets (no sentinel): the multithreaded native extractor when
    available, NumPy unpack + flatnonzero otherwise. The one extraction
    fallback shared by build_index and the streaming drain."""
    from .ops.stage1_v3 import unpack_packed_host

    try:
        from . import native

        if native.available():
            return native.extract_offsets_v3(packed_np, tile, n_bytes,
                                             base=base)
    except Exception:
        pass  # no native build: fall through to the NumPy unpack
    mask = unpack_packed_host(packed_np, n_bytes, tile=tile)
    return np.flatnonzero(mask).astype(np.int64) + base


def build_index(
    data: bytes | np.ndarray,
    dialect: Dialect = DEFAULT_DIALECT,
    backend: str = "auto",
) -> np.ndarray:
    """Full structural index with the 0 sentinel (reader.rs:216), as int64
    host offsets — bit-identical to golden.structural_index.

    backend "jnp" runs the fold-layout XLA scan on the device and
    extracts offsets on the host; "native" and "golden" run on the
    host."""
    arr = as_u8(data)
    backend = _resolve_backend(backend)
    if arr.size >= 2**31 and backend == "jnp":
        # single-call device builds address bytes with int32; route big
        # inputs through the streamed device scan (same kernel, 64 MiB
        # chunks, int64 rebasing at the host boundary — reference
        # capacity bar: usize offsets, reader.rs:305)
        from .streaming import StreamingIndexBuilder

        b = StreamingIndexBuilder(dialect, backend)
        step = 1 << 26
        for lo in range(0, arr.size, step):
            b.feed(arr[lo : lo + step])
        return b.finish()
    if backend == "native":
        from . import native

        index, _par = native.host_stage1(arr, dialect, with_sentinel=True)
        return index
    if backend == "golden":
        from . import golden

        return golden.structural_index(arr, dialect)
    if backend == "jnp":
        from .ops.stage1_v3 import stage1_swar_xla

        w2d = jnp.asarray(pad_to_words(arr))
        packed, _par = stage1_swar_xla(w2d, 0, dialect)
        tile = min(512, w2d.shape[0])
        offsets = extract_offsets_from_packed(
            np.asarray(packed), tile, arr.size
        )
    return np.concatenate([np.zeros(1, dtype=np.int64), offsets])


@partial(jax.jit, static_argnames=("dialect", "capacity"))
def _device_offsets_v3(w2d, carry_in, dialect: Dialect, capacity: int):
    """v3 scan + device compaction: byte-quad words -> (offsets, count).

    The flag mask is expanded from SWAR 0x80 flags to a per-byte mask in
    flat order (word (r, lane) bytes b=0..3 -> flat (r*128 + lane)*4 + b)
    and compacted with a fixed-capacity nonzero — all on device; offsets
    never leave HBM (gather serving reads them in place)."""
    from .ops.stage1_v3 import _classify, swar_broadcast_flag
    from .ops.swar import swar_prefix_xor_bytes, swar_word_parity

    rows, lanes = w2d.shape
    sf, qf = _classify(w2d, dialect)
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
    masked = sf & ~(p_in ^ swar_broadcast_flag(base))
    # expand 4 flag bits/word -> per-byte mask in flat byte order
    bits = jnp.stack(
        [(masked >> (8 * b + 7)) & 1 for b in range(4)], axis=-1
    ).reshape(rows, lanes * 4)
    return extract_offsets_device(bits, capacity)


def build_index_device(
    data: bytes | np.ndarray,
    dialect: Dialect = DEFAULT_DIALECT,
    density: float = 0.25,
):
    """Device-resident index build (v3 scan + on-device compaction):
    returns (offsets int32 device array with leading 0 sentinel, count).
    Capacity grows from the density heuristic (the reference reserves
    len/6, design_notes_2.md:14) until the compaction fits."""
    _arr_guard = as_u8(data)
    if _arr_guard.size >= 2**31:
        raise ValueError(
            "build_index_device uses int32 flat byte positions; inputs "
            ">= 2 GiB route through build_index (streamed int64 "
            "rebasing) or parallel.sharded/serving"
        )
    arr = as_u8(data)
    w2d = jnp.asarray(pad_to_words(arr))
    n = arr.size
    cap = max(int(n * density) + 64, 64)
    while True:
        offsets, count = _device_offsets_v3(
            w2d, jnp.int32(0), dialect, capacity=cap
        )
        count = int(count)
        if count <= cap:
            break
        cap = max(count, cap * 2)
    with_sentinel = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), offsets[:count] if count < cap else offsets]
    )
    return with_sentinel, count
