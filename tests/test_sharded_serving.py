"""Cross-shard serving tests: sharded bytes + replicated index on the
8-device CPU mesh; every lookup must match the host tape regardless of
which shard owns the bytes."""

import numpy as np
import jax
import pytest

from csv_simd_tpu import create_from_bytes
from csv_simd_tpu.parallel.serving import ShardedTape
from csv_simd_tpu.parallel.sharded import make_mesh

from corpus import synthetic_wide_table


@pytest.fixture(scope="module")
def setup():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    data = synthetic_wide_table(200_000)
    tape = create_from_bytes(data, backend="golden")
    mesh = make_mesh(8)
    return tape, ShardedTape.from_tape(tape, mesh)


def test_cross_shard_lookups(setup):
    tape, st = setup
    rng = np.random.default_rng(0)
    recs = rng.integers(0, tape.num_data_records, 64)
    flds = rng.integers(0, tape.field_cnt, 64)
    out, lengths, valid = st.gather_fields(recs, flds, max_len=48)
    vals = st.to_host_lists(out, lengths, valid)
    for i in range(64):
        assert vals[i] == tape.seek_field(int(recs[i]), int(flds[i]))


def test_out_of_range_sharded(setup):
    tape, st = setup
    out, lengths, valid = st.gather_fields(
        np.array([0, 10**8]), np.array([0, 0]), max_len=16
    )
    vals = st.to_host_lists(out, lengths, valid)
    assert vals[0] == tape.seek_field(0, 0)
    assert vals[1] is None


@pytest.fixture(scope="module")
def packed_setup():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from csv_simd_tpu.parallel.serving import ShardedPackedTape

    rows = b"".join(
        b'%d,"val,%d",zz%d\n' % (i, i * 3, i) for i in range(3000)
    )
    data = b"a,b,c\n" + rows
    tape = create_from_bytes(data, backend="golden")
    return tape, ShardedPackedTape(data, make_mesh(8))


def test_sharded_packed_lookups(packed_setup):
    """Offsets-free sharded serving: no offsets array, no replication of
    the index — packed words + bytes sharded, row prefix replicated."""
    tape, st = packed_setup
    rng = np.random.default_rng(3)
    recs = rng.integers(0, tape.num_data_records, 64)
    flds = rng.integers(0, tape.field_cnt, 64)
    out, lengths, valid = st.gather_fields(recs, flds, max_len=48)
    vals = st.to_host_lists(out, lengths, valid)
    for i in range(64):
        assert vals[i] == tape.seek_field(int(recs[i]), int(flds[i]))


def test_sharded_packed_column_and_bounds(packed_setup):
    tape, st = packed_setup
    out, ln, v = st.gather_column(2, max_len=16)
    vals = st.to_host_lists(out, ln, v)
    assert vals == tape.column(2)
    out, ln, v = st.gather_fields(
        np.array([0, 10**8]), np.array([0, 0]), max_len=16
    )
    vals = st.to_host_lists(out, ln, v)
    assert vals[0] == tape.seek_field(0, 0) and vals[1] is None


def test_sharded_packed_sharding_layout(packed_setup):
    """The contract that distinguishes this from round-1 ShardedTape:
    words and bytes are actually SHARDED over the mesh (not replicated);
    only the row prefix is replicated."""
    _, st = packed_setup
    ws = st.words.sharding.spec
    assert tuple(ws)[0] == "data", ws
    ds = st.data.sharding.spec
    assert tuple(ds)[0] == "data", ds
    cs = st.cum_incl.sharding.spec
    assert all(ax is None for ax in tuple(cs)), cs


def test_device_build_v3(setup):
    from csv_simd_tpu.index import build_index_device
    from csv_simd_tpu import golden

    data = synthetic_wide_table(100_000)
    offsets, count = build_index_device(data)
    want = golden.structural_index(data)
    np.testing.assert_array_equal(np.asarray(offsets)[: count + 1], want)


def test_sharded_packed_quotes_spanning_shards():
    """A quoted region crossing shard boundaries must serve correctly:
    the seq build's parity stitch feeds rank-select serving."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from csv_simd_tpu.parallel.serving import ShardedPackedTape

    inner = "x," * 30000  # 60 KB quoted span, crosses several shards
    data = f'a,b\n"{inner}end",2\nq,w\n'.encode()
    tape = create_from_bytes(data, backend="golden")
    st = ShardedPackedTape(data, make_mesh(8))
    out, ln, v = st.gather_fields(
        np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]), max_len=70000
    )
    vals = st.to_host_lists(out, ln, v)
    want = [tape.seek_field(r, f) for r, f in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert vals == want


def test_sharded_packed_save_crossloads(tmp_path, packed_setup):
    """One artifact format across stacks: ShardedPackedTape.save loads
    through PackedDeviceTape.load AND artifact.load_tape."""
    tape, st = packed_setup
    data = bytes(np.asarray(st.data)[: st.n_bytes])
    p = tmp_path / "sharded_seq.npz"
    st.save(p)
    from csv_simd_tpu.artifact import load_tape
    from csv_simd_tpu.offsetfree import PackedDeviceTape

    pt = PackedDeviceTape.load(p, data)
    assert int(pt.record_cnt) == int(st.record_cnt)
    out, ln, v = pt.gather_fields(np.array([0, 5]), np.array([1, 2]), max_len=48)
    vals = pt.to_host_lists(out, ln, v)
    assert vals == [tape.seek_field(0, 1), tape.seek_field(5, 2)]
    host = load_tape(p, data)
    assert host.seek_field(0, 1) == tape.seek_field(0, 1)


@pytest.mark.skipif(
    not __import__("os").environ.get("CSV_SIMD_BIG_TESTS"),
    reason="2.5 GiB sharded serving is slow; set CSV_SIMD_BIG_TESTS=1",
)
def test_sharded_packed_serves_past_2gib():
    """The flagship claim, proven: ShardedPackedTape serves fields whose
    bytes live beyond the 2^31 byte line (shard-local int32 addressing —
    a flat int32 position would have wrapped negative)."""
    from csv_simd_tpu.parallel.serving import ShardedPackedTape

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    # uniform 64-byte records -> easy oracle arithmetic
    header = b"a,b\n"
    payload = b"x" * 57
    n_rows = (2**31 + (1 << 26)) // 64
    one = payload + b",00042\n"
    assert len(one) == 64
    data = header + one * n_rows
    assert len(data) > 2**31
    st = ShardedPackedTape(data, make_mesh(8))
    assert int(st.record_cnt) == n_rows + 1
    # a record whose bytes start beyond 2^31
    far = (2**31 - len(header)) // 64 + 10
    start = len(header) + far * 64
    assert start + 64 > 2**31
    out, ln, v = st.gather_fields(
        np.array([far - 1, far - 1]), np.array([0, 1]), max_len=64
    )
    vals = st.to_host_lists(out, ln, v)
    assert vals[0] == payload and vals[1] == b"00042", vals


def test_sharded_packed_gather_decoded(packed_setup):
    from csv_simd_tpu.decode import DecodedView

    tape, st = packed_setup
    view = DecodedView(tape)
    recs = np.array([0, 3, 10])
    flds = np.array([1, 1, 2])
    out, ln, v = st.gather_decoded(recs, flds, max_len=48)
    vals = st.to_host_lists(out, ln, v)
    assert vals == [view.seek_field(int(r), int(f)) for r, f in zip(recs, flds)]


def test_sharded_packed_validate_utf8():
    """validate_utf8 on the sharded tape: per-shard fused high-bit
    counts gate a HOST validation pass (the full device validator
    would blow up HBM on exactly the >HBM corpora this class serves).
    ASCII corpora skip the pass; valid UTF-8 passes; invalid raises."""
    from csv_simd_tpu.errors import InvalidCsvFormat
    from csv_simd_tpu.parallel.serving import ShardedPackedTape

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh(4)
    ascii_csv = b"a,b\n1,2\n3,4\n"
    t = ShardedPackedTape(ascii_csv, mesh, validate_utf8=True)
    assert t.nonascii_count == 0
    utf8_csv = "a,b\nschön,2\nnaïve,4\n".encode()
    t = ShardedPackedTape(utf8_csv, mesh, validate_utf8=True)
    assert t.nonascii_count == 4  # two 2-byte sequences
    o, ln, v = t.gather_fields(np.array([0], np.int32),
                               np.array([0], np.int32))
    raw = bytes(np.asarray(o)[0][: int(ln[0])])
    assert raw.decode() == "schön"
    bad = b"a,b\n\xff\xfe,2\n3,4\n"
    with pytest.raises(InvalidCsvFormat, match="not valid UTF-8"):
        ShardedPackedTape(bad, mesh, validate_utf8=True)
    # without the flag nothing is counted or checked
    t = ShardedPackedTape(bad, mesh)
    assert t.nonascii_count is None
