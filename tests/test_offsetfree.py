"""Offsets-free serving tests: the sequential pack round-trips, rank-
select finds exact positions, and PackedDeviceTape serves identically to
the host tape — with no offsets array ever materialised."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from csv_simd_tpu import create_from_bytes, golden
from csv_simd_tpu.errors import InvalidCsvFormat
from csv_simd_tpu.offsetfree import PackedDeviceTape, _kth_positions
from csv_simd_tpu.ops.pack import pad_to_words
from csv_simd_tpu.ops.stage1_v3 import stage1_seq_xla

from corpus import basic_cases, synthetic_wide_table


def test_sequential_pack_is_flat_bitstream():
    data = synthetic_wide_table(100_000)
    arr = np.frombuffer(data, dtype=np.uint8)
    w2d = jnp.asarray(pad_to_words(arr, row_align=8))
    packed, parity = stage1_seq_xla(w2d, 0)
    bits = np.unpackbits(
        np.asarray(packed).astype("<i4").view(np.uint8), bitorder="little"
    )[: arr.size]
    np.testing.assert_array_equal(bits, golden.structural_mask(arr))
    assert int(parity) == golden.quote_parity_out(arr)


def test_kth_positions():
    from csv_simd_tpu.offsetfree import prefix_for_packed

    data = synthetic_wide_table(50_000)
    arr = np.frombuffer(data, dtype=np.uint8)
    w2d = jnp.asarray(pad_to_words(arr, row_align=8))
    packed, _ = stage1_seq_xla(w2d, 0)
    cum = prefix_for_packed(packed)
    offs = golden.structural_index(data)[1:]
    ks = jnp.asarray(
        np.r_[0, 1, 17, len(offs) - 1, np.arange(0, len(offs), 97)], jnp.int32
    )
    got = np.asarray(_kth_positions(packed, cum, ks))
    np.testing.assert_array_equal(got, offs[np.asarray(ks)])


@pytest.mark.parametrize(
    "case",
    [c for c in basic_cases() if c.should_build],
    ids=lambda c: c.name,
)
def test_packed_tape_serves_identically(case):
    host = create_from_bytes(case.data, backend="golden")
    pt = PackedDeviceTape(case.data)
    assert pt.num_data_records == host.num_data_records
    n = host.num_data_records
    if n == 0:
        return
    rng = np.random.default_rng(1)
    recs = rng.integers(0, n, min(16, 4 * n))
    flds = rng.integers(0, host.field_cnt, recs.size)
    out, lengths, valid = pt.gather_fields(recs, flds, max_len=96)
    vals = pt.to_host_lists(out, lengths, valid)
    for i in range(recs.size):
        assert vals[i] == host.seek_field(int(recs[i]), int(flds[i])), (
            case.name, recs[i], flds[i])


def test_packed_tape_column_and_bounds():
    data = synthetic_wide_table(80_000)
    host = create_from_bytes(data, backend="golden")
    pt = PackedDeviceTape(data)
    out, lengths, valid = pt.gather_column(2, max_len=48)
    vals = pt.to_host_lists(out, lengths, valid)
    assert vals == host.column(2)
    out, lengths, valid = pt.gather_fields([10**7, -1], [0, 0])
    vals = pt.to_host_lists(out, lengths, valid)
    assert vals == [None, None]


def test_packed_tape_ragged_rejected():
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape(b"a,b,c\n1,2,3,\n")


def test_packed_tape_save_load(tmp_path):
    data = synthetic_wide_table(60_000)
    pt = PackedDeviceTape(data)
    p = str(tmp_path / "seq.npz")
    pt.save(p)
    pt2 = PackedDeviceTape.load(p, data)
    assert pt2.num_data_records == pt.num_data_records
    out, ln, v = pt2.gather_fields([0, 3], [1, 2])
    host = create_from_bytes(data, backend="golden")
    vals = pt2.to_host_lists(out, ln, v)
    assert vals[0] == host.seek_field(0, 1)
    assert vals[1] == host.seek_field(3, 2)
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape.load(p, data[:-5])


def test_packed_typed_columns():
    data = b"id,score,exp\n1,2.5,1e2\n-7,0.25,2.5e-1\n2147483647,3.,4E0\n"
    pt = PackedDeviceTape(data)
    v, ok = pt.column_int32(0)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(v), [1, -7, 2147483647])
    f, ok = pt.column_float32(1)
    assert np.asarray(ok).all()
    np.testing.assert_allclose(np.asarray(f), [2.5, 0.25, 3.0])
    e, ok = pt.column_float32_exp(2)
    assert np.asarray(ok).all()
    np.testing.assert_allclose(np.asarray(e), [100.0, 0.25, 4.0])


def test_packed_filter_equals():
    data = b"id,tag\n1,aa\n2,bb\n3,aa\n4,cc\n"
    pt = PackedDeviceTape(data)
    np.testing.assert_array_equal(pt.filter_equals(1, b"aa"), [0, 2])
    np.testing.assert_array_equal(pt.filter_equals(1, b"zz"), [])


@pytest.mark.parametrize("rows", [64, 13])
def test_prefix_for_packed_row_counts(rows):
    """The row popcount prefix equals a host cumsum of per-row bit
    counts, both where rows divide by 8 (the (rows/8, 128) reduce) and
    where they do not."""
    from csv_simd_tpu.offsetfree import prefix_for_packed

    rng = np.random.default_rng(rows)
    packed = rng.integers(-(2**31), 2**31, (rows, 16), dtype=np.int64)
    packed = packed.astype(np.int32)
    bits = np.unpackbits(packed.astype("<i4").view(np.uint8), axis=1)
    want = np.cumsum(bits.sum(axis=1))
    got = np.asarray(prefix_for_packed(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)
