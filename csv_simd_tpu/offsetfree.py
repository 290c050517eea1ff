"""Offsets-free device serving: the packed bitmask IS the index.

Materialising the offsets array on device requires stream compaction
(a `nonzero` pass over every input byte). This module sidesteps
compaction entirely, which no offsets-array design can:

- the index artifact is the *sequential-order* packed structural bitmask
  (1 bit per input byte, ops/stage1_v3.stage1_seq_xla) plus an exclusive
  popcount prefix over its 32-bit words (a cheap dense cumsum on 1/32 of
  the data) — so "index build" runs at scan speed, full stop;
- a tape slot lookup (the k-th structural character) becomes
  searchsorted(word_prefix, k) + an in-word rank-select (5-step binary
  search on popcounts of halves), vectorised over query batches;
- serving then gathers bytes exactly like device_tape.

The slot arithmetic is unchanged from the reference (slot = (r+1)*jump+f,
value = bytes[pos(slot-1)+1 : pos(slot)] — slot k>=1 maps to set-bit
k-1 because slot 0 is the synthetic 0 sentinel, reader.rs:216).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_DIALECT, Dialect
from .device_tape import TypedColumnsMixin
from .errors import InvalidCsvFormat
from .ops.pack import pad_to_words
from .ops.stage1_v3 import stage1_seq_xla
from .tape import Header, NewLine
from .utils import as_u8


def fast_cumsum_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix-sum of a 1-D int32 array via hierarchical
    (rows, 512) log-step scans: a few shift-adds per level instead of
    XLA's reduce-window lowering of a long 1-D cumsum."""
    n = x.shape[0]
    if n <= 2048:
        return jnp.cumsum(x, dtype=jnp.int32)
    w = 512
    rows = -(-n // w)
    padded = jnp.pad(x, (0, rows * w - n)).reshape(rows, w)
    s = 1
    while s < w:
        padded = padded + jnp.pad(padded, ((0, 0), (s, 0)))[:, :w]
        s *= 2
    tot = padded[:, w - 1]
    excl = fast_cumsum_i32(tot) - tot
    return (padded + excl[:, None]).reshape(-1)[:n]


def prefix_for_packed(packed: jnp.ndarray) -> jnp.ndarray:
    """Inclusive ROW-granularity popcount prefix over the (rows, 16)
    packed words. Returns the (rows,) cumsum of per-512-byte-row bit
    counts: 1/16 the scan length of a per-word prefix; queries resolve
    within-row at lookup time. The popcount and per-row reduce run at
    (rows/8, 128)."""
    rows = packed.shape[0]
    if rows % 8 == 0 and rows >= 8:
        wide = packed.reshape(rows // 8, 128)
        pc = jax.lax.population_count(wide)
        row_counts = pc.reshape(rows // 8, 8, 16).sum(
            axis=-1, dtype=jnp.int32).reshape(rows)
    else:
        row_counts = jnp.sum(jax.lax.population_count(packed), axis=1)
    return fast_cumsum_i32(row_counts)


def _select_bit(w: jnp.ndarray, j: jnp.ndarray) -> jnp.ndarray:
    """Position (0..31) of the j-th (0-indexed) set bit of each int32
    word — vectorised 5-step binary search over half popcounts."""
    pos = jnp.zeros_like(j)
    cur = w
    jj = j
    for width in (16, 8, 4, 2, 1):
        low_mask = jnp.int32((1 << width) - 1)
        low = cur & low_mask
        c = jax.lax.population_count(low)
        go_high = jj >= c
        jj = jj - jnp.where(go_high, c, 0)
        pos = pos + jnp.where(go_high, width, 0)
        cur = jnp.where(go_high, (cur >> width) & ((1 << (32 - width)) - 1), low)
    return pos


@jax.jit
def _kth_positions(words2d, row_cum_incl, ks):
    """Flat byte positions of the k-th set bits (vectorised).

    Two-level: searchsorted on the ROW-granularity popcount prefix (the
    only thing the build materialises — 1/16 the prefix work of a
    per-word prefix), then the 16 words of the hit row of the (rows, 16)
    `words2d` are gathered and scanned per query (dense (Q,16) ops)."""
    row = jnp.searchsorted(row_cum_incl, ks, side="right").astype(jnp.int32)
    excl_row = jnp.where(row > 0, row_cum_incl[jnp.maximum(row - 1, 0)], 0)
    j = (ks - excl_row).astype(jnp.int32)  # rank within the row
    wrow = words2d[row]  # (Q, 16)
    pc = jax.lax.population_count(wrow)
    cum = jnp.cumsum(pc, axis=1)  # (Q, 16), tiny
    g = jnp.sum((cum <= j[:, None]).astype(jnp.int32), axis=1)
    excl_word = jnp.where(
        g > 0,
        jnp.take_along_axis(cum, jnp.maximum(g - 1, 0)[:, None], axis=1)[:, 0],
        0,
    )
    jj = j - excl_word
    w = jnp.take_along_axis(wrow, g[:, None], axis=1)[:, 0]
    return (row * 16 + g) * 32 + _select_bit(w, jj)


@functools.partial(jax.jit, static_argnames=("max_len",))
def _serve(data, words2d, cum_incl, records, fields, jump, field_cnt,
           record_cnt, max_len: int):
    valid = (
        (records >= 0) & (records + 1 < record_cnt)
        & (fields >= 0) & (fields < field_cnt)
    )
    r = jnp.where(valid, records, 0)
    f = jnp.where(valid, fields, 0)
    slots = (r + 1) * jump + f  # >= 1 for all valid queries
    ks = jnp.concatenate([slots - 1, slots])  # start bit, end bit
    pos = _kth_positions(words2d, cum_incl, ks)
    n = slots.shape[0]
    starts = pos[:n] + 1
    ends = pos[n:]
    lengths = jnp.where(valid, ends - starts, 0)
    grid = starts[:, None] + jnp.arange(max_len, dtype=jnp.int32)[None, :]
    in_range = grid < ends[:, None]
    grid = jnp.clip(grid, 0, data.shape[0] - 1)
    out = jnp.where(in_range & valid[:, None], data[grid], jnp.uint8(0))
    return out, lengths, valid


_PREFIX_JIT = None


def _prefix_jit(packed):
    """One module-level jit of prefix_for_packed: a fresh jax.jit per
    tape construction would re-trace and re-compile every time."""
    global _PREFIX_JIT
    if _PREFIX_JIT is None:
        _PREFIX_JIT = jax.jit(prefix_for_packed)
    return _PREFIX_JIT(packed)


def packed_seq_meta(header, n_bytes: int, fingerprint: str) -> dict:
    """The packed_seq artifact meta dict — the ONE builder shared by
    PackedDeviceTape.save and ShardedPackedTape.save, so the two
    writers of the common format cannot drift apart."""
    return dict(
        magic="csv-simd-tpu-index", version=1, encoding="packed_seq",
        names=header.names, new_line=header.new_line.value,
        field_cnt=header.field_cnt, delimiter=header.delimiter,
        record_offset=header.record_offset, n_bytes=n_bytes,
        fingerprint=fingerprint,
    )


class PackedDeviceTape(TypedColumnsMixin):
    """Device tape whose index is the sequential packed bitmask + word
    popcount prefix — built at scan speed, no compaction pass. The whole
    typed/decoded/relational serving surface comes from
    TypedColumnsMixin on top of `gather_fields`."""

    def __init__(self, data: bytes | np.ndarray,
                 dialect: Dialect = DEFAULT_DIALECT,
                 validate_utf8: bool = False):
        arr = as_u8(data)
        if arr.size >= 2**31:
            raise ValueError(
                "PackedDeviceTape uses int32 flat byte positions: shard "
                "inputs >= 2 GiB across devices (parallel.serving."
                "ShardedPackedTape) or serve via the int64 native path"
            )
        self.n_bytes = arr.size
        header = Header.parse(arr, delimiter=dialect.delimiter,
                              quote_aware=dialect.header_quotes,
                              quote=dialect.quote)
        self.header = header
        w2d = jnp.asarray(pad_to_words(arr))
        packed, _par = stage1_seq_xla(w2d, 0, dialect)
        self.nonascii_count = None
        self.cum_incl = _prefix_jit(packed)
        self.words = packed  # (rows, 16)
        self.data = jnp.asarray(arr)
        if validate_utf8:
            # only non-ASCII data pays for the full device
            # Keiser-Lemire pass
            self.nonascii_count = int(jnp.sum((self.data & 0x80) != 0))
            if self.nonascii_count:
                from .ops.utf8 import validate_utf8_device

                if not validate_utf8_device(arr):
                    raise InvalidCsvFormat("input is not valid UTF-8")
        count = int(self.cum_incl[-1])
        jump = header.field_cnt + (1 if header.new_line is NewLine.CRLF else 0)
        record_cnt, rem = divmod(count, jump)
        if rem != 0:
            raise InvalidCsvFormat(
                f"non-uniform record stride: {count} structural entries "
                f"not divisible by jump {jump}"
            )
        self.jump = jnp.int32(jump)
        self.field_cnt = jnp.int32(header.field_cnt)
        self.record_cnt = jnp.int32(record_cnt)
        self.num_data_records = max(record_cnt - 1, 0)

    def gather_fields(self, records, fields, max_len: int = 64):
        return _serve(
            self.data, self.words, self.cum_incl,
            jnp.asarray(records, jnp.int32), jnp.asarray(fields, jnp.int32),
            self.jump, self.field_cnt, self.record_cnt, max_len,
        )

    # -- persistence: the packed words ARE the artifact (1 bit/byte);
    #    the prefix is recomputed on load (cheap) --

    def save(self, path) -> None:
        import json

        from .artifact import _fingerprint

        meta = packed_seq_meta(
            self.header, self.n_bytes, _fingerprint(np.asarray(self.data))
        )
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            packed=np.asarray(self.words, dtype=np.int32).reshape(-1, 16),
        )

    @classmethod
    def load(cls, path, data: bytes | np.ndarray,
             dialect: Dialect = DEFAULT_DIALECT) -> "PackedDeviceTape":
        """Rebuild a serving tape from a saved artifact + the original
        bytes — no re-scan; only the prefix cumsum is recomputed."""
        import json

        import os

        try:
            z = np.load(path, allow_pickle=False)
        except OSError:
            # np.savez_compressed appends '.npz' to suffix-less paths:
            # a save/load round-trip with the same path must work
            p = os.fspath(path)
            if not p.endswith(".npz") and os.path.exists(p + ".npz"):
                z = np.load(p + ".npz", allow_pickle=False)
            else:
                raise
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("encoding") != "packed_seq":
            raise InvalidCsvFormat(f"not a packed_seq artifact: {meta.get('encoding')}")
        arr = as_u8(data)
        if meta["n_bytes"] != arr.size:
            raise InvalidCsvFormat("artifact does not match these bytes")
        if arr.size >= 2**31:
            raise ValueError(
                "PackedDeviceTape uses int32 flat byte positions; this "
                "buffer is >= 2 GiB (see parallel.serving.ShardedPackedTape)"
            )
        from .artifact import _fingerprint

        if meta.get("fingerprint") != _fingerprint(arr):
            raise InvalidCsvFormat(
                "index artifact does not match these bytes (fingerprint)"
            )
        self = cls.__new__(cls)
        self.n_bytes = arr.size
        self.header = Header(
            names=list(meta["names"]), new_line=NewLine(meta["new_line"]),
            field_cnt=meta["field_cnt"], delimiter=meta["delimiter"],
            record_offset=meta["record_offset"],
        )
        packed = jnp.asarray(np.asarray(z["packed"]))
        self.words = packed
        self.cum_incl = _prefix_jit(packed)
        self.data = jnp.asarray(arr)
        self.nonascii_count = None  # not recorded in the artifact
        count = int(self.cum_incl[-1])
        jump = self.header.field_cnt + (
            1 if self.header.new_line is NewLine.CRLF else 0
        )
        record_cnt, rem = divmod(count, jump)
        if rem != 0:
            raise InvalidCsvFormat("artifact stride mismatch")
        self.jump = jnp.int32(jump)
        self.field_cnt = jnp.int32(self.header.field_cnt)
        self.record_cnt = jnp.int32(record_cnt)
        self.num_data_records = max(record_cnt - 1, 0)
        return self
