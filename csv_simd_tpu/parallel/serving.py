"""Cross-shard serving: batched field gathers over sharded bytes.

Two tapes, one contract (SURVEY.md §5.8 (iii)):

- ShardedTape: bytes sharded, int32 OFFSETS index replicated (~4 B per
  structural char per device). Lookups reuse device_tape's gather; XLA
  sharding propagation inserts the cross-shard collectives. Capped at
  2 GiB by the replicated int32 index.
- ShardedPackedTape: the offsets-free production path — packed seq
  bitmask AND bytes sharded, only the row popcount prefix replicated.
  Serving is an explicit shard_map kernel addressing bytes as (global
  row, in-row offset) pairs with shard-local int32 positions, so it
  serves corpora far past the 2 GiB flat-int32 line (each SHARD must
  stay under 2 GiB; structural count < 2^31)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device_tape import TypedColumnsMixin, _gather_fields
from .sharded import AXIS
from ..utils import as_u8

_PREFIX_JIT = None


def _prefix_jit(packed):
    """One module-level jit of prefix_for_packed: a fresh jax.jit per
    tape construction would re-trace and re-compile every time."""
    global _PREFIX_JIT
    if _PREFIX_JIT is None:
        from ..offsetfree import prefix_for_packed

        _PREFIX_JIT = jax.jit(prefix_for_packed)
    return _PREFIX_JIT(packed)


class ShardedTape(TypedColumnsMixin):
    """Serving over mesh-sharded bytes + replicated index. Typed
    columns / decode / filters come from TypedColumnsMixin, so the
    relational layer (query/frame/join) runs over the mesh unchanged."""

    def __init__(self, data: np.ndarray, index: np.ndarray, jump: int,
                 field_cnt: int, record_cnt: int, mesh: Mesh,
                 header=None):
        self.header = header  # optional Header (column names, frame.py)
        n_shards = mesh.devices.size
        pad = (-len(data)) % n_shards
        padded = np.concatenate([data, np.zeros(pad, np.uint8)]) if pad else data
        # device_put of the HOST array with a sharding transfers
        # shard-wise (no full staging on one device)
        self.data = jax.device_put(
            np.ascontiguousarray(padded), NamedSharding(mesh, P(AXIS))
        )
        idx_host = np.asarray(index)
        if idx_host.size and int(idx_host[-1]) >= 2**31:
            raise ValueError(
                "ShardedTape replicates an int32 index: >= 2 GiB inputs "
                "need the offsets-free ShardedPackedTape"
            )
        self.index = jax.device_put(
            idx_host.astype(np.int32),
            NamedSharding(mesh, P()),
        )
        self.jump = jnp.int32(jump)
        self.field_cnt = jnp.int32(field_cnt)
        self.record_cnt = jnp.int32(record_cnt)

    @classmethod
    def from_tape(cls, tape, mesh: Mesh) -> "ShardedTape":
        raw = tape.data_bytes
        host = as_u8(raw)
        return cls(
            host,
            np.asarray(tape.index),
            tape.record_jump_size,
            tape.field_cnt,
            tape.record_cnt,
            mesh,
            header=getattr(tape, "header", None),
        )

    def gather_fields(self, records, fields, max_len: int = 64):
        return _gather_fields(
            self.data, self.index,
            jnp.asarray(records, jnp.int32), jnp.asarray(fields, jnp.int32),
            self.jump, self.field_cnt, self.record_cnt, max_len,
        )


def _sharded_serve_fn(data_loc, words_loc, cum, records, fields, jump,
                      field_cnt, record_cnt, *, shard_rows: int,
                      max_len: int):
    """Per-shard body of the offsets-free sharded serve (runs inside
    shard_map). All byte addressing is (global row int32, in-row offset
    0..511) pairs — shard-LOCAL flat positions stay < 2 GiB regardless
    of total corpus size, which is what lets this path serve beyond the
    int32 byte-position ceiling of the single-device tape. Word rows and
    byte windows are fetched from the owning shard and combined with a
    psum (zeros elsewhere) — the collective-gather serving of SURVEY
    §5.8 (iii), explicit."""
    from ..offsetfree import _select_bit

    my = jax.lax.axis_index(AXIS)
    valid = (
        (records >= 0) & (records + 1 < record_cnt)
        & (fields >= 0) & (fields < field_cnt)
    )
    r = jnp.where(valid, records, 0)
    f = jnp.where(valid, fields, 0)
    slots = (r + 1) * jump + f
    ks = jnp.concatenate([slots - 1, slots])  # start bit, end bit

    # replicated math: global row + rank within row
    row = jnp.searchsorted(cum, ks, side="right").astype(jnp.int32)
    excl_row = jnp.where(row > 0, cum[jnp.maximum(row - 1, 0)], 0)
    j = (ks - excl_row).astype(jnp.int32)

    # the 16 words of each hit row come from the owning shard
    owner = row // shard_rows
    lrow = row - owner * shard_rows
    mine = owner == my
    lr = jnp.where(mine, lrow, 0)
    wrow_local = words_loc[lr]  # (2N, 16)
    wrow = jax.lax.psum(
        jnp.where(mine[:, None], wrow_local, 0), AXIS
    )

    pc = jax.lax.population_count(wrow)
    wcum = jnp.cumsum(pc, axis=1)
    g = jnp.sum((wcum <= j[:, None]).astype(jnp.int32), axis=1)
    excl_word = jnp.where(
        g > 0,
        jnp.take_along_axis(wcum, jnp.maximum(g - 1, 0)[:, None], axis=1)[:, 0],
        0,
    )
    w = jnp.take_along_axis(wrow, g[:, None], axis=1)[:, 0]
    inrow = g * 32 + _select_bit(w, j - excl_word)  # 0..511 within row

    n = slots.shape[0]
    # field byte range: start = pos(slot-1)+1, end = pos(slot), as
    # (row, offset) pairs — never a flat global position
    srow, soff = row[:n], inrow[:n] + 1
    carry = soff >> 9
    srow, soff = srow + carry, soff & 511
    erow, eoff = row[n:], inrow[n:]
    lengths = jnp.where(valid, (erow - srow) * 512 + (eoff - soff), 0)

    k = jnp.arange(max_len, dtype=jnp.int32)[None, :]
    off = soff[:, None] + k
    brow = srow[:, None] + (off >> 9)
    boff = off & 511
    in_range = (brow < erow[:, None]) | (
        (brow == erow[:, None]) & (boff < eoff[:, None])
    )
    in_mine = (brow >= my * shard_rows) & (brow < (my + 1) * shard_rows)
    lpos = (brow - my * shard_rows) * 512 + boff
    lpos = jnp.clip(lpos, 0, data_loc.shape[0] - 1)
    got = jnp.where(
        in_mine & in_range & valid[:, None],
        data_loc[lpos],
        jnp.uint8(0),
    )
    out = jax.lax.psum(got.astype(jnp.int32), AXIS).astype(jnp.uint8)
    return out, lengths, valid


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "shard_rows", "max_len"),
)
def _serve_packed_sharded(data, words, cum, records, fields, jump,
                          field_cnt, record_cnt, mesh: Mesh,
                          shard_rows: int, max_len: int):
    fn = shard_map(
        functools.partial(
            _sharded_serve_fn, shard_rows=shard_rows, max_len=max_len
        ),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS, None), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
    )
    return fn(data, words, cum, records, fields, jump, field_cnt, record_cnt)


class ShardedPackedTape(TypedColumnsMixin):
    """Offsets-free serving over a mesh: the packed seq bitmask AND the
    bytes stay sharded row-wise on the devices that own them; only the
    row popcount prefix (4 bytes per 512 input bytes) is replicated.

    This is the production >= 2 GiB serving path: no offsets array
    exists anywhere (no int32 ceiling, no ~4 B/char replication —
    round-1's ShardedTape replicated the whole index per device), and
    queries route by global row: searchsorted on the replicated prefix
    finds the owning row, the word gather + byte gather execute on the
    owning shard with XLA-inserted collectives (SURVEY.md §5.8 (iii))."""

    def __init__(self, data: bytes | np.ndarray, mesh: Mesh,
                 dialect=None, validate_utf8: bool = False):
        import jax as _jax

        from ..config import DEFAULT_DIALECT
        from ..errors import InvalidCsvFormat
        from ..tape import Header, NewLine
        from .sharded import pad_words_for_mesh, sharded_stage1

        dialect = dialect or DEFAULT_DIALECT
        arr = as_u8(data)
        self.n_bytes = arr.size
        self.header = Header.parse(arr, delimiter=dialect.delimiter,
                              quote_aware=dialect.header_quotes,
                              quote=dialect.quote)
        n_shards = mesh.devices.size
        w2d = pad_words_for_mesh(arr, n_shards)
        rows = w2d.shape[0]
        if (rows // n_shards) * 512 >= 2**31:
            raise ValueError(
                "each SHARD must stay under 2 GiB for int32-local byte "
                f"addressing: {rows * 512 / 2**30:.1f} GiB over {n_shards} "
                "shard(s) — use a larger mesh"
            )
        # device_put of HOST arrays with a sharding transfers shard-wise
        # (staging via jnp.asarray would materialize the full input on
        # one device first — the very limit this class exists to pass)
        w_dev = _jax.device_put(w2d, NamedSharding(mesh, P(AXIS, None)))
        out = sharded_stage1(
            w_dev, 0, mesh, dialect, layout="seq",
            count_nonascii=validate_utf8,
        )
        if validate_utf8:
            packed, counts, _ce, _total, _par, na = out
        else:
            (packed, counts, _ce, _total, _par), na = out, None
        self.words = packed  # (rows, 16), sharded P(AXIS, None)
        # replicated row prefix: 1 int32 per 512 input bytes
        self.cum_incl = _jax.device_put(
            _prefix_jit(packed), NamedSharding(mesh, P())
        )
        datap = np.zeros(rows * 512, np.uint8)
        datap[: arr.size] = arr
        self.data = _jax.device_put(
            datap, NamedSharding(mesh, P(AXIS))
        )
        # per-shard counts each fit int32 (shards < 2 GiB); the TOTAL
        # sums in int64 on host — the int32 psum could wrap past 2^32
        # structural entries and slip the old `count < 0` guard
        count = int(np.asarray(counts).astype(np.int64).sum())
        if count >= 2**31:
            raise ValueError(
                "structural count >= 2^31: the replicated row prefix "
                "and slot math are int32 — split the corpus across "
                "files (corpus_api.CsvCorpus)"
            )
        jump = self.header.field_cnt + (
            1 if self.header.new_line is NewLine.CRLF else 0
        )
        record_cnt, rem = divmod(count, jump)
        if rem != 0:
            raise InvalidCsvFormat(
                f"non-uniform record stride: {count} structural entries "
                f"not divisible by jump {jump}"
            )
        self.jump = jnp.int32(jump)
        self.field_cnt = jnp.int32(self.header.field_cnt)
        self.record_cnt = jnp.int32(record_cnt)
        self.num_data_records = max(record_cnt - 1, 0)
        self.mesh = mesh
        self.shard_rows = rows // n_shards
        if validate_utf8:
            # the fused per-shard high-bit counts are free with the
            # scan: pure-ASCII corpora (the common case) skip the full
            # check entirely. Non-ASCII corpora validate on HOST — the
            # device validator expands ~4-10x in HBM over the full
            # un-sharded input, which is exactly what this class's
            # inputs cannot afford.
            na_total = int(np.asarray(na).astype(np.int64).sum())
            self.nonascii_count = na_total
            if na_total > 0:
                from ..ops.utf8 import validate_utf8 as _utf8_host

                if not _utf8_host(arr):
                    raise InvalidCsvFormat("input is not valid UTF-8")
        else:
            self.nonascii_count = None

    def gather_fields(self, records, fields, max_len: int = 64):
        return _serve_packed_sharded(
            self.data, self.words, self.cum_incl,
            jnp.asarray(records, jnp.int32), jnp.asarray(fields, jnp.int32),
            self.jump, self.field_cnt, self.record_cnt,
            self.mesh, self.shard_rows, max_len,
        )

    def save(self, path) -> None:
        """Write the SAME packed_seq artifact as PackedDeviceTape.save —
        the sharded and single-device serving stacks share one artifact
        format (rows beyond the data are all-zero pad and harmless to
        either loader)."""
        import json

        from ..artifact import _fingerprint

        from ..offsetfree import packed_seq_meta

        data_host = np.asarray(self.data)[: self.n_bytes]
        meta = packed_seq_meta(
            self.header, self.n_bytes, _fingerprint(data_host)
        )
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            packed=np.asarray(self.words, dtype=np.int32),
        )

