"""Streaming x sharding composition (VERDICT r3 item 5): chunked
ingestion over the virtual 8-device mesh, with quoted regions spanning
chunk AND shard boundaries, bit-identical to golden."""

import numpy as np
import pytest

from csv_simd_tpu import golden
from csv_simd_tpu.parallel.sharded import make_mesh
from csv_simd_tpu.streaming import (
    ShardedStreamingIndexBuilder,
    StreamingIndexBuilder,
    build_index_sharded_streaming,
)

CHUNK = 64 * 1024  # 64 KiB chunks; 8 shards cut every 8 KiB inside one


def _golden_index(data: bytes) -> np.ndarray:
    mask = golden.structural_mask(np.frombuffer(data, np.uint8))
    return np.concatenate(
        [np.zeros(1, np.int64), np.flatnonzero(mask).astype(np.int64)])


def _mk_spanning_csv() -> bytes:
    """~200 KiB CSV whose quoted fields straddle: the first chunk's
    internal shard cuts (every 8 KiB), the chunk boundary at 64 KiB,
    AND a shard cut of the second chunk."""
    parts = [b"h1,h2\n"]
    filler = b"k%d,v%d\n"
    i = 0
    while sum(map(len, parts)) < 30 * 1024:
        parts.append(filler % (i, i * 3))
        i += 1
    # a quoted field covering bytes ~30 KiB .. ~72 KiB: crosses shard
    # cuts at 32/40/48/56 KiB, the CHUNK cut at 64 KiB, and the second
    # chunk's first shard cut at 72 KiB
    parts.append(b'x,"')
    parts.append(b"a,b\nc " * 7200)  # ~43 KiB of quoted structurals
    parts.append(b'"\n')
    while sum(map(len, parts)) < 200 * 1024:
        parts.append(filler % (i, i * 3))
        i += 1
    # one more quoted span near the end crossing a late shard cut
    parts.append(b'y,"')
    parts.append(b"q\r\n," * 4000)
    parts.append(b'"\n')
    return b"".join(parts)


DATA = _mk_spanning_csv()


def test_spans_cover_boundaries():
    """The fixture really puts quote spans across chunk + shard cuts."""
    arr = np.frombuffer(DATA, np.uint8)
    # quote parity BEFORE each byte (1 = the cut lands inside quotes)
    q = np.cumsum(arr == 0x22) & 1
    inq = np.concatenate([[0], q[:-1]])
    # chunk boundary at 64 KiB inside quotes
    assert inq[CHUNK] == 1
    # at least one 8 KiB shard cut of chunk 0 and of chunk 1 in quotes
    assert any(inq[k * 8 * 1024] for k in range(1, 8))
    assert inq[CHUNK + 8 * 1024] or inq[CHUNK + 16 * 1024]


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_sharded_streaming_bit_identical(pipeline_depth):
    mesh = make_mesh(8)
    b = ShardedStreamingIndexBuilder(mesh, pipeline_depth=pipeline_depth)
    for start in range(0, len(DATA), CHUNK):
        b.feed(DATA[start : start + CHUNK])
    got = b.finish()
    np.testing.assert_array_equal(got, _golden_index(DATA))


def test_matches_single_device_streaming():
    mesh = make_mesh(8)
    got = build_index_sharded_streaming(
        iter([DATA[:CHUNK], DATA[CHUNK : 3 * CHUNK],
              DATA[3 * CHUNK :]]),
        mesh, chunk_bytes=CHUNK)
    single = StreamingIndexBuilder(backend="jnp")
    single.feed(DATA)
    np.testing.assert_array_equal(got, single.finish())


def test_tail_chunk_and_parity_property():
    """Odd-sized final chunk + parity exposed; ends inside a quote."""
    data = b'a,b\n1,"unclosed , \n span'
    mesh = make_mesh(4)
    b = ShardedStreamingIndexBuilder(mesh)
    b.feed(data[:7])
    b.feed(data[7:])
    assert b.quote_parity == 1
    np.testing.assert_array_equal(b.finish(), _golden_index(data))


def test_sharded_checkpoint_resume(tmp_path):
    """Interrupt mid-stream, save, reload on a DIFFERENT mesh size,
    continue — bit-identical to golden (parity + offset + partial
    index are the whole state, same contract as the single-device
    builder)."""
    mesh4, mesh8 = make_mesh(4), make_mesh(8)
    b = ShardedStreamingIndexBuilder(mesh4)
    b.feed(DATA[:CHUNK])
    b.feed(DATA[CHUNK : 2 * CHUNK])
    p = tmp_path / "ckpt.npz"
    b.save(p)
    b2 = ShardedStreamingIndexBuilder.load(p, mesh8)
    for start in range(2 * CHUNK, len(DATA), CHUNK):
        b2.feed(DATA[start : start + CHUNK])
    np.testing.assert_array_equal(b2.finish(), _golden_index(DATA))
