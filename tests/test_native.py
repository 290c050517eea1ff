"""Native C++ engine tests: exact parity with golden on the corpus, the
multithreaded two-phase stitch, the fold-layout extractor, and the
`backend="native"` public path."""

import numpy as np
import jax.numpy as jnp
import pytest

from csv_simd_tpu import create_from_bytes, golden, native

from corpus import all_cases, synthetic_wide_table

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native engine unavailable: {native.build_error()}"
)


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_native_matches_golden(case):
    offs, par = native.host_stage1(case.data, n_threads=1)
    want = golden.structural_index(case.data)[1:]
    np.testing.assert_array_equal(offs, want)
    assert par == golden.quote_parity_out(case.data)


def test_native_multithreaded_quote_stitch():
    inner = "x," * 400000  # 800 KB quoted span crosses thread chunks
    data = (f'a,b\n"{inner}end",2\nq,w\n' * 3).encode()
    offs, par = native.host_stage1(data, n_threads=8)
    want = golden.structural_index(data)[1:]
    np.testing.assert_array_equal(offs, want)
    assert par == 0


def test_native_threads_chunk_inside_quote():
    """Every thread chunk but the first starts INSIDE one giant quoted
    field — the two-hypothesis phase-A counts must resolve to the
    in-quote hypothesis for chunks 1..t-1 (exercises the exact-position
    direct-write stitch; >1 MiB so the threaded path actually engages)."""
    data = b'a,"' + b"x,\n" * 700_000 + b'",b\n'
    offs, par = native.host_stage1(data, n_threads=4)
    want = golden.structural_index(data)[1:]
    np.testing.assert_array_equal(offs, want)
    assert par == 0


def test_native_threads_parity_flips_every_chunk():
    """Quote-dense input whose per-chunk quote counts are odd at some
    boundaries: the exclusive XOR scan must hand each chunk the right
    entry parity AND pick the matching phase-A count."""
    row = b'"' + b"y" * 61 + b'",a\n'
    data = row * 40_000  # ~2.6 MiB
    offs, par = native.host_stage1(data, n_threads=8)
    want = golden.structural_index(data)[1:]
    np.testing.assert_array_equal(offs, want)
    assert par == 0


def test_native_threads_match_single_thread_dense():
    """Dense wide table: threaded exact-count path == serial path."""
    data = synthetic_wide_table(3_000_000)
    o1, p1 = native.host_stage1(data, n_threads=1)
    o4, p4 = native.host_stage1(data, n_threads=4)
    np.testing.assert_array_equal(o1, o4)
    assert p1 == p4


def test_native_carry_in():
    data = b'ab",c\nx,y\n'
    offs, par = native.host_stage1(data, carry_in=1, n_threads=1)
    arr = np.frombuffer(data, dtype=np.uint8)
    want = np.flatnonzero(golden.structural_mask(arr, carry_in=1))
    np.testing.assert_array_equal(offs, want)
    assert par == golden.quote_parity_out(arr, carry_in=1)


def test_native_quote_parity():
    assert native.host_quote_parity(b'abc"def') == 1
    assert native.host_quote_parity(b'a"b"c') == 0
    assert native.host_quote_parity(b'a"bc', carry_in=1) == 0


def test_extract_offsets_v3_matches():
    from csv_simd_tpu.ops.pack import pad_to_words
    from csv_simd_tpu.ops.stage1_v3 import stage1_swar_xla

    data = synthetic_wide_table(300_000)
    arr = np.frombuffer(data, dtype=np.uint8)
    w2d = jnp.asarray(pad_to_words(arr, row_align=8))
    tile = min(512, w2d.shape[0])
    packed, _ = stage1_swar_xla(w2d, 0, row_tile=tile)
    offs = native.extract_offsets_v3(np.asarray(packed), tile, arr.size)
    want = golden.structural_index(data)[1:]
    np.testing.assert_array_equal(offs, want)


def test_native_backend_public(sample_rx):
    tape = create_from_bytes(sample_rx, backend="native")
    ref = create_from_bytes(sample_rx, backend="golden")
    np.testing.assert_array_equal(tape.index, ref.index)
    assert tape.seek_field(1, 2) == ref.seek_field(1, 2)


def test_native_custom_dialect():
    from csv_simd_tpu import Dialect

    data = b"a;b\n1;'x;y'\n2;z\n"
    d = Dialect(delimiter=0x3B, quote=0x27)
    offs, _ = native.host_stage1(data, dialect=d, n_threads=1)
    want = golden.structural_index(data, d)[1:]
    np.testing.assert_array_equal(offs, want)


def test_extract_offsets_v3_overflow_guard():
    """Packed words with more set bits than n_bytes allows (corrupted
    or foreign arrays) previously overflowed the output buffer (glibc
    abort); now out-of-range bits are dropped, every emitted offset is
    < n_bytes, and the capacity can never be exceeded."""
    if not native.available():
        pytest.skip("native engine unavailable")
    bogus = np.full((8, 128), -1, np.int32)  # every bit set
    out = native.extract_offsets_v3(bogus, tile=8, n_bytes=10)
    assert out.tolist() == list(range(10))  # only in-range offsets
    out = native.extract_offsets_v3(bogus, tile=8, n_bytes=8 * 512)
    assert out.size == 8 * 512
    assert out.min() == 0 and out.max() == 8 * 512 - 1
