"""Distributed index build: data-parallel byte shards over a device mesh.

The reference only scaffolded parallelism (Chunk/boundaries split records
for a thread pool that was never built, tape.rs:13-40, 385-428) and left
"splitting work without first knowing record breaks" as an open problem
(README.md:24). Here it is first-class, over a device mesh (SURVEY.md
§2.4, §5.7):

- the byte stream is sharded by offset across devices on a 1-D mesh
  ("data"); no record breaks need to be known up front;
- each shard computes its *local* quote parity (a cheap associative
  reduce), an exclusive XOR-scan across shards (all_gather + masked sum —
  parity is associative, so no speculation about quote state is needed),
  then runs the full stage-1 scan with its carried-in parity;
- per-shard structural counts are exclusive-summed the same way to
  rebase local bit positions into the global offset space;
- outputs stay sharded: packed bitmask words live on the device that owns
  the bytes; serving gathers cross-shard.

Two-phase cost: the parity prepass re-reads the shard's bytes, but it is
a pure streaming reduce (no scans/packing), so the total is ~1.2 passes —
the price of a split point inside quoted text, paid without speculation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_DIALECT, Dialect
from ..ops.pack import pad_to_words
from ..ops.stage1_v3 import (
    count_packed,
    stage1_seq_xla,
    stage1_swar_xla,
    unpack_packed_host,
)
from ..ops.swar import swar_eq, swar_prefix_xor_bytes, swar_word_parity
from ..utils import as_u8

AXIS = "data"


def _local_parity(w: jnp.ndarray, dialect: Dialect) -> jnp.ndarray:
    """Quote parity of a local shard (cheap streaming reduce)."""
    qf = swar_eq(w, dialect.quote)
    wp = swar_word_parity(swar_prefix_xor_bytes(qf))
    return jnp.sum(wp, dtype=jnp.int32) & 1


def _exclusive_scan_axis(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Exclusive prefix-sum of a per-shard scalar across the mesh axis
    (all_gather + masked sum; N is tiny so this beats a ppermute chain)."""
    idx = jax.lax.axis_index(axis_name)
    allv = jax.lax.all_gather(x, axis_name)  # (n_shards,)
    n = allv.shape[0]
    mask = (jnp.arange(n) < idx).astype(allv.dtype)
    return jnp.sum(allv * mask, dtype=allv.dtype)


def _scan_total_psum(x: jnp.ndarray, axis_name: str, n: int):
    """ONE psum serving both the exclusive prefix AND the total of a
    per-shard scalar — the round-5 collective fusion. Shard j
    contributes x to every lane i > j of an (n+1,) vector; lane n
    satisfies i > j for every shard, so psum lane i = exclusive
    prefix at i and lane n = the total. The production build needed 4
    collectives (2 gathers + 2 psums); 2 psums suffice
    (tools/shard_overhead.py: the extra collectives dominated the
    8-wide virtual-mesh overhead after the kernel itself). psum also
    keeps the output statically replicated, which the vma checker can
    verify (a masked sum over an all_gather cannot be)."""
    idx = jax.lax.axis_index(axis_name)
    contrib = jnp.where(jnp.arange(n + 1) > idx, x, 0)
    out = jax.lax.psum(contrib, axis_name)
    return out[idx], out[n]


def _shard_fn(w, carry0, dialect: Dialect, row_tile: int,
              layout: str = "fold", count_nonascii: bool = False,
              n_shards: int = 1):
    # phase A: local parity + exclusive XOR-scan across shards (the
    # one psum also yields the global parity)
    local_par = _local_parity(w, dialect)
    par_excl, par_total = _scan_total_psum(local_par, AXIS, n_shards)
    carry = (par_excl + carry0[0]) & 1
    # phase B: full stage-1 with the carried parity
    # -1 = not counted (derived from local_par so the value is
    # device-varying, matching its P(AXIS) out_spec under the checker)
    na = local_par * 0 - 1
    if layout == "seq":
        packed, _ = stage1_seq_xla(w, carry, dialect)
        if count_nonascii:
            na = jnp.sum(
                jax.lax.population_count(w & jnp.int32(-0x7F7F7F80)),
                dtype=jnp.int32,
            )
    else:
        packed, _ = stage1_swar_xla(
            w, carry, dialect, row_tile=min(row_tile, w.shape[0]))
    count = count_packed(packed)
    # global rebasing state: ONE psum covers both the exclusive
    # offsets and the total (collective fusion, round 5)
    count_excl, total = _scan_total_psum(count, AXIS, n_shards)
    parity_out = (par_total + carry0[0]) & 1
    return (packed, count[None], count_excl[None], total[None],
            parity_out[None], jnp.asarray(na).reshape(1))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "dialect", "row_tile", "layout",
                     "count_nonascii"),
)
def sharded_stage1(
    w2d: jnp.ndarray,
    carry_in,
    mesh: Mesh,
    dialect: Dialect = DEFAULT_DIALECT,
    row_tile: int = 512,
    layout: str = "fold",
    count_nonascii: bool = False,
):
    """Sharded stage-1 over a 1-D mesh: (rows, 128) int32 byte-quad words,
    rows divisible by n_shards*8. `layout` is "fold" (host-extracted
    offsets) or "seq" (offsets-free serving; ops/stage1_v3.py).

    Returns (packed words sharded (rows//8, 128), per-shard counts (n,),
    per-shard exclusive count offsets (n,), total count, parity_out).
    With count_nonascii=True ('seq' layout only) a 6th element holds the
    PER-SHARD high-bit byte counts (n,) — sum them in int64 on host; the
    int32 psum'd `total` can wrap for >2^31 structural entries, so
    callers near that scale should likewise sum the per-shard counts."""
    carry_arr = jnp.asarray(carry_in, jnp.int32).reshape(1)
    fn = shard_map(
        functools.partial(
            _shard_fn, dialect=dialect, row_tile=row_tile, layout=layout,
            count_nonascii=count_nonascii,
            n_shards=int(mesh.devices.size),
        ),
        mesh=mesh,
        in_specs=(P(AXIS, None), P()),
        out_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(), P(), P(AXIS)),
    )
    packed, counts, count_excl, total, parity, na = fn(w2d, carry_arr)
    if count_nonascii:
        return packed, counts, count_excl, total[0], parity[0], na
    return packed, counts, count_excl, total[0], parity[0]


def pad_words_for_mesh(arr: np.ndarray, n_shards: int) -> np.ndarray:
    """(n,) uint8 -> (rows, 128) byte-quad words with rows divisible by
    the mesh AND each shard's rows compatible with the kernel tile:
    shard_rows <= 512 only needs % 8; larger shards must be multiples
    of 512 (the fold tile must divide each shard's rows)."""
    w2d = pad_to_words(arr, row_align=8 * n_shards)
    rows = w2d.shape[0]
    unit = 8 * n_shards if rows <= 512 * n_shards else 512 * n_shards
    if rows % unit != 0:
        pad_rows = -(-rows // unit) * unit - rows
        w2d = np.concatenate(
            [w2d, np.zeros((pad_rows, w2d.shape[1]), w2d.dtype)]
        )
    return w2d


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


def build_index_sharded(
    data: bytes | np.ndarray,
    mesh: Optional[Mesh] = None,
    dialect: Dialect = DEFAULT_DIALECT,
) -> np.ndarray:
    """End-to-end sharded build -> host int64 structural index with
    sentinel, bit-identical to the single-device / golden result."""
    arr = as_u8(data)
    mesh = mesh or make_mesh()
    n_shards = mesh.devices.size
    w2d = pad_words_for_mesh(arr, n_shards)
    sharding = NamedSharding(mesh, P(AXIS, None))
    # device_put of the HOST array with a sharding transfers shard-wise
    # (staging through jnp.asarray would materialize the whole input on
    # one device first, defeating >single-HBM builds)
    w_dev = jax.device_put(w2d, sharding)
    packed, _c, _ce, _total, _par = sharded_stage1(w_dev, 0, mesh, dialect)
    shard_rows = w2d.shape[0] // n_shards
    mask = unpack_packed_host(
        np.asarray(packed), arr.size, tile=min(512, shard_rows)
    )
    offsets = np.flatnonzero(mask).astype(np.int64)
    return np.concatenate([np.zeros(1, dtype=np.int64), offsets])
