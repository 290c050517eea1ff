"""Property-based tests (hypothesis): invariants that must hold for ANY
input, not just corpus cases.

Properties:
1. index entries are strictly ascending and point at structural bytes
   outside quotes (checked against a scalar in-quote scan);
2. chunked/streamed builds equal one-shot builds for arbitrary cut
   points;
3. backends agree bit-for-bit on arbitrary byte soup;
4. serving round-trip: joining decoded fields with the dialect
   delimiter reconstructs each record for quote-free tables.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

from csv_simd_tpu import create_from_bytes, golden
from csv_simd_tpu.config import Dialect
from csv_simd_tpu.index import build_index
from csv_simd_tpu.streaming import StreamingIndexBuilder

# byte soup weighted toward structural chars so properties get exercised
soup = st.binary(min_size=0, max_size=2000).map(
    lambda b: bytes(
        x if x >= 56 else (0x2C, 0x22, 0x0A, 0x0D, 0x61, 0x00, 0x5C, 0x20)[x % 8]
        for x in b
    )
)


def scalar_structural(data: bytes):
    out, in_q = [], False
    for i, b in enumerate(data):
        if b == 0x22:
            in_q = not in_q
        elif b in (0x2C, 0x0A, 0x0D) and not in_q:
            out.append(i)
    return np.array(out, dtype=np.int64)


@settings(max_examples=200, deadline=None)
@given(soup)
def test_index_matches_scalar_scan(data):
    idx = golden.structural_index(data)
    assert idx[0] == 0
    np.testing.assert_array_equal(idx[1:], scalar_structural(data))
    assert (np.diff(idx[1:]) > 0).all() if len(idx) > 2 else True


@settings(max_examples=60, deadline=None)
@given(soup, st.integers(min_value=1, max_value=500))
def test_streaming_any_cut(data, chunk):
    b = StreamingIndexBuilder(backend="golden")
    for i in range(0, len(data), chunk):
        b.feed(data[i : i + chunk])
    np.testing.assert_array_equal(b.finish(), golden.structural_index(data))


@settings(max_examples=40, deadline=None)
@given(soup)
def test_backends_agree(data):
    want = golden.structural_index(data)
    np.testing.assert_array_equal(build_index(data, backend="jnp"), want)
    try:
        from csv_simd_tpu import native

        if native.available():
            offs, _ = native.host_stage1(data, n_threads=1)
            np.testing.assert_array_equal(offs, want[1:])
    except RuntimeError:
        pass


# well-formed quote-free tables for the serving round-trip
field_txt = st.text(
    alphabet=st.characters(
        codec="ascii", exclude_characters='",\r\n'
    ),
    max_size=8,
)
table = st.lists(
    st.lists(field_txt, min_size=2, max_size=5),
    min_size=2,
    max_size=8,
).filter(lambda rows: len({len(r) for r in rows}) == 1)


@settings(max_examples=60, deadline=None)
@given(table)
def test_serving_roundtrip(rows):
    data = ("\n".join(",".join(r) for r in rows) + "\n").encode()
    tape = create_from_bytes(data, backend="golden")
    assert tape.num_data_records == len(rows) - 1
    for r in range(tape.num_data_records):
        fields = [tape.seek_field(r, f) for f in range(tape.field_cnt)]
        assert b",".join(fields) == tape.seek_record(r)
        assert [f.decode() for f in fields] == rows[r + 1]


# -- round 2: decode invariants --

field_bytes = st.binary(min_size=0, max_size=40).map(
    lambda b: bytes(
        x if x >= 48 else (0x22, 0x20, 0x09, 0x61, 0x2E, 0x30)[x % 6]
        for x in b
    )
)


@settings(max_examples=150, deadline=None)
@given(st.lists(field_bytes, min_size=1, max_size=8), st.booleans())
def test_device_decode_matches_host(fields, trim):
    """For ANY raw field bytes (quotes/spaces/tabs included), the device
    compaction-gather decode equals the host decoder byte-for-byte."""
    import jax.numpy as jnp

    from csv_simd_tpu.decode import decode_field
    from csv_simd_tpu.device_tape import _decode_fields

    max_len = max(len(f) for f in fields) + 1
    out = np.zeros((len(fields), max_len), np.uint8)
    lengths = np.zeros(len(fields), np.int32)
    for i, f in enumerate(fields):
        out[i, : len(f)] = np.frombuffer(f, np.uint8)
        lengths[i] = len(f)
    valid = np.ones(len(fields), bool)
    spaces = (0x20, 0x09) if trim else ()
    got, ln, _v = _decode_fields(
        jnp.asarray(out), jnp.asarray(lengths), jnp.asarray(valid),
        0x22, spaces,
    )
    got, ln = np.asarray(got), np.asarray(ln)
    for i, f in enumerate(fields):
        want = decode_field(f, trim=trim)
        assert bytes(got[i, : ln[i]]) == want, (f, trim)


# -- relational layer: predicate differential vs a Python oracle --------

_pred_table = st.lists(
    st.tuples(
        st.sampled_from(["AAPL", "MSFT", "GOOG", "AA,PL"]),
        st.integers(min_value=-(2**31), max_value=2**31 - 1),
    ),
    min_size=1, max_size=60,
)
_pred_op = st.sampled_from(["==", "!=", "<", "<=", ">", ">="])
_pred_lit = st.integers(min_value=-(2**31), max_value=2**31 - 1)


@settings(max_examples=60, deadline=None)
@given(_pred_table, _pred_op, _pred_lit)
def test_select_records_matches_python_oracle(rows, op, lit):
    """select_records over a typed predicate == the same comparison in
    plain Python, at arbitrary literals incl. int32 boundaries."""
    import operator

    from csv_simd_tpu.device_tape import DeviceTape
    from csv_simd_tpu.query import select_records

    body = "".join(
        f'"{s}",{q}\n' if "," in s else f"{s},{q}\n" for s, q in rows
    )
    data = ("sym,qty\n" + body).encode()
    tape = create_from_bytes(data, backend="golden")
    dt = DeviceTape.from_tape(tape)
    ids = select_records(dt, [("qty", op, lit)],
                         schema={"qty": "int32"})
    pyop = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
            "<=": operator.le, ">": operator.gt, ">=": operator.ge}[op]
    expect = [i for i, (_s, q) in enumerate(rows) if pyop(q, lit)]
    assert list(ids) == expect


_dialects = st.builds(
    lambda d, q: Dialect(delimiter=d, quote=q),
    st.sampled_from([0x2C, 0x3B, 0x09, 0x7C, 0x20]),  # , ; tab | space
    st.sampled_from([0x22, 0x27, 0x60]),              # " ' `
)


@settings(max_examples=40, deadline=None)
@given(soup, _dialects)
def test_backends_agree_any_dialect(data, dialect):
    """Random delimiter/quote pairs (incl. space-delimited): every
    backend must match golden under the same dialect."""
    want = golden.structural_index(data, dialect)
    np.testing.assert_array_equal(
        build_index(data, dialect=dialect, backend="jnp"), want
    )
    try:
        from csv_simd_tpu import native

        if native.available():
            offs, _ = native.host_stage1(data, dialect, n_threads=2)
            np.testing.assert_array_equal(offs, want[1:])
    except RuntimeError:
        pass
