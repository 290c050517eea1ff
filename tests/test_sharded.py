"""Distributed build tests on the virtual 8-device CPU mesh: the sharded
index must be bit-identical to golden regardless of shard count, shard
boundaries cutting quoted regions included."""

import numpy as np
import jax
import pytest

from csv_simd_tpu import golden
from csv_simd_tpu.parallel.sharded import (
    build_index_sharded,
    make_mesh,
)

from corpus import basic_cases, synthetic_wide_table


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return make_mesh(n)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_matches_golden(n_shards):
    mesh = _mesh(n_shards)
    data = synthetic_wide_table(200_000)
    got = build_index_sharded(data, mesh=mesh)
    want = golden.structural_index(data)
    np.testing.assert_array_equal(got, want)


def test_sharded_quote_spanning_shards():
    """A quoted region crossing shard boundaries: the exclusive XOR-scan
    of shard parities must flip downstream shards' interpretation."""
    mesh = _mesh(4)
    inner = "x," * 30000  # 60 KB quoted span >> one shard at this size
    data = f'a,b\n"{inner}end",2\nq,w\n'.encode()
    got = build_index_sharded(data, mesh=mesh)
    want = golden.structural_index(data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", basic_cases(), ids=lambda c: c.name)
def test_sharded_corpus(case):
    mesh = _mesh(8)
    got = build_index_sharded(case.data, mesh=mesh)
    want = golden.structural_index(case.data)
    np.testing.assert_array_equal(got, want)


def test_sharded_non_power_of_two_large():
    """3 shards on an input large enough that each shard exceeds the 512
    row tile: the pad must make shard rows a tile multiple (a round-1
    advisor finding — the old 8*n_shards pad tripped the kernel's
    rows % tile assertion here)."""
    mesh = _mesh(3)
    data = synthetic_wide_table(3 * 600 * 512 + 13)  # shard_rows > 512
    got = build_index_sharded(data, mesh=mesh)
    want = golden.structural_index(data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [3, 5, 6])
def test_sharded_non_power_of_two_meshes(n_shards):
    """Non-power-of-two device counts: the mesh padding must keep each
    shard's rows tile-compatible (ADVICE round-1 flagged the original
    8*n padding; large inputs need shard_rows % 512 == 0)."""
    if len(jax.devices()) < n_shards:
        pytest.skip("needs more devices")
    rng = np.random.default_rng(n_shards)
    data = rng.choice(
        np.frombuffer(b'ab"",\n\rx,z: 09', dtype=np.uint8),
        size=3_000_000,  # > 512*8*n rows once padded: hits the big-pad branch
    )
    ref = np.flatnonzero(golden.structural_mask(data)).astype(np.int64)
    mesh = make_mesh(n_shards)
    got = build_index_sharded(data, mesh)
    assert got[0] == 0
    np.testing.assert_array_equal(got[1:], ref)

    from csv_simd_tpu.parallel.serving import ShardedPackedTape

    csv = b"a,b\n" + b"".join(
        f"{i},v{i}\n".encode() for i in range(997)
    )
    t = ShardedPackedTape(csv, mesh)
    o, ln, v = t.gather_fields(np.array([0, 500, 995], np.int32),
                               np.array([1, 1, 0], np.int32))
    vals = [bytes(np.asarray(o)[i][: int(ln[i])]) for i in range(3)]
    assert vals == [b"v0", b"v500", b"995"]
