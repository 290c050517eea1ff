"""Tests for device serving, artifacts, CLI, metrics and debug helpers."""

import json
import subprocess
import sys

import numpy as np
import pytest

from csv_simd_tpu import InvalidState, create_from_bytes, golden
from csv_simd_tpu.artifact import load_tape, save_packed, save_tape
from csv_simd_tpu.device_tape import DeviceTape
from csv_simd_tpu.utils.debug import byte_report, mask_report
from csv_simd_tpu.utils.metrics import Metrics

from corpus import synthetic_wide_table


@pytest.fixture(scope="module")
def tape():
    return create_from_bytes(synthetic_wide_table(60_000), backend="golden")


# ---- device serving ----

def test_device_gather_fields(tape):
    dt = DeviceTape.from_tape(tape)
    recs = np.array([0, 1, 5, 2], dtype=np.int32)
    flds = np.array([0, 3, 1, 2], dtype=np.int32)
    out, lengths, valid = dt.gather_fields(recs, flds, max_len=48)
    vals = dt.to_host_lists(out, lengths, valid)
    for i in range(len(recs)):
        assert vals[i] == tape.seek_field(int(recs[i]), int(flds[i]))


def test_device_gather_column(tape):
    dt = DeviceTape.from_tape(tape)
    out, lengths, valid = dt.gather_column(3, max_len=48)
    vals = dt.to_host_lists(out, lengths, valid)
    want = tape.column(3)
    assert vals == want


def test_device_gather_out_of_range(tape):
    dt = DeviceTape.from_tape(tape)
    recs = np.array([0, 10**6, -1], dtype=np.int32)
    flds = np.array([0, 0, 0], dtype=np.int32)
    out, lengths, valid = dt.gather_fields(recs, flds, max_len=16)
    vals = dt.to_host_lists(out, lengths, valid)
    assert vals[0] == tape.seek_field(0, 0)
    assert vals[1] is None and vals[2] is None


def test_device_gather_truncation(tape):
    dt = DeviceTape.from_tape(tape)
    out, lengths, valid = dt.gather_fields(
        np.array([0]), np.array([3]), max_len=2
    )
    full = tape.seek_field(0, 3)
    assert bytes(np.asarray(out)[0, : min(2, len(full))]) == full[:2]


# ---- artifacts ----

def test_save_load_offsets(tape, tmp_path):
    p = str(tmp_path / "idx.npz")
    save_tape(tape, p)
    t2 = load_tape(p, tape.data_bytes)
    np.testing.assert_array_equal(t2.index, tape.index)
    assert t2.seek_field(2, 1) == tape.seek_field(2, 1)
    assert t2.header_names() == tape.header_names()


def test_load_rejects_stale(tape, tmp_path):
    p = str(tmp_path / "idx.npz")
    save_tape(tape, p)
    with pytest.raises(InvalidState):
        load_tape(p, tape.data_bytes[:-10])


def test_save_load_packed(tmp_path):
    import jax.numpy as jnp

    from csv_simd_tpu.ops.pack import pad_to_words
    from csv_simd_tpu.ops.stage1_v3 import stage1_swar_xla
    from csv_simd_tpu.tape import Header

    data = synthetic_wide_table(40_000)
    arr = np.frombuffer(data, dtype=np.uint8)
    w2d = jnp.asarray(pad_to_words(arr, row_align=8))
    tile = min(512, w2d.shape[0])
    packed, _ = stage1_swar_xla(w2d, 0, row_tile=tile)
    header = Header.parse(data)
    p = str(tmp_path / "packed.npz")
    save_packed(np.asarray(packed), tile, header, data, p)
    t2 = load_tape(p, data)
    ref = create_from_bytes(data, backend="golden")
    np.testing.assert_array_equal(t2.index, ref.index)


# ---- CLI ----

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "csv_simd_tpu", *args],
        capture_output=True, text=True, cwd="/root/repo",
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        timeout=120,
    )


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "t.csv"
    p.write_bytes(b'a,b,c\n1,"x,y",3\n4,5,6\n')
    return str(p)


def test_cli_info(csv_file):
    r = _cli("--backend", "golden", "info", csv_file)
    assert r.returncode == 0 and "records" in r.stdout


def test_cli_field(csv_file):
    r = _cli("--backend", "golden", "field", csv_file, "0", "1")
    assert r.returncode == 0 and r.stdout.strip() == '"x,y"'


def test_cli_index_and_serve(csv_file, tmp_path):
    out = str(tmp_path / "i.npz")
    r = _cli("--backend", "golden", "index", csv_file, "-o", out)
    assert r.returncode == 0
    r = _cli("serve", csv_file, "--from-index", out, "1", "2")
    assert r.returncode == 0 and r.stdout.strip() == "6"


def test_cli_error_path(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_bytes(b"a,b,c\n1,2,3,\n")
    r = _cli("--backend", "golden", "info", str(bad))
    assert r.returncode == 1 and "InvalidCsvFormat" in r.stderr


# ---- metrics & debug ----

def test_metrics():
    m = Metrics()
    with m.span("scan", n_bytes=10**9):
        pass
    m.record("extract", 0.5, 2 * 10**9)
    rep = m.report()
    assert "scan" in rep and "extract" in rep
    lines = m.json_lines().splitlines()
    assert json.loads(lines[1])["gbps"] == 4.0


def test_byte_report():
    rep = byte_report(b"hello\nworld" * 200)
    assert "head[" in rep and "tail[" in rep and "\\x0a" in rep


def test_mask_report():
    data = b"a,b\n"
    mask = golden.structural_mask(np.frombuffer(data, dtype=np.uint8))
    rep = mask_report(data, mask)
    assert "^" in rep


def test_metrics_wired_into_pipeline():
    """The hot paths actually record spans (round-2: the registry was
    previously declared but never fed)."""
    from csv_simd_tpu import create_from_bytes
    from csv_simd_tpu.streaming import StreamingIndexBuilder
    from csv_simd_tpu.utils.metrics import GLOBAL

    GLOBAL.reset()
    create_from_bytes(b"a,b\n1,2\n", backend="golden")
    b = StreamingIndexBuilder(backend="golden")
    b.feed(b"a,b\n1,2\n")
    names = set(GLOBAL.stages)
    assert "index_build[golden]" in names and "streaming_chunk" in names
    assert GLOBAL.stages["streaming_chunk"].bytes == 8
    GLOBAL.reset()


def test_zero_record_serving():
    """Header-only files (zero data records) serve cleanly through every
    device path: empty gathers, empty typed parses, empty decode."""
    from csv_simd_tpu.offsetfree import PackedDeviceTape

    data = b"a,b,c\n"
    t = create_from_bytes(data, backend="golden")
    dt = DeviceTape.from_tape(t)
    out, ln, v = dt.gather_column(0)
    assert out.shape[0] == 0 and dt.to_host_lists(out, ln, v) == []
    vals, ok = dt.column_int32(0)
    assert vals.shape == (0,)
    assert dt.column_decoded(0) == []
    pt = PackedDeviceTape(data)
    assert pt.num_data_records == 0
    o2, l2, v2 = pt.gather_column(1)
    assert o2.shape[0] == 0


def test_cli_decode_and_packed_format(csv_file, tmp_path):
    from csv_simd_tpu.__main__ import main

    out = tmp_path / "seq.npz"
    assert main([
        "--backend", "golden", "index", str(csv_file),
        "-o", str(out), "--format", "packed_seq",
    ]) == 0
    assert main([
        "serve", str(csv_file), "--from-index", str(out), "0", "0",
    ]) == 0
    assert main([
        "--backend", "golden", "--decode", "field", str(csv_file), "0", "0",
    ]) == 0


def test_cli_json_index(tmp_path, capsys):
    from csv_simd_tpu.__main__ import main

    p = tmp_path / "t.json"
    p.write_bytes(b'{"a": [1, {"b": "x,]"}], "c": 2}')
    assert main(["json-index", str(p)]) == 0
    out = capsys.readouterr().out
    assert "structural chars" in out and "depth=" in out


def test_cli_frame(tmp_path):
    p = tmp_path / "prices.csv"
    p.write_bytes(b"sku,price,n\nA,12.34,3\nB,-0.05,4\nC,1.00,5\n")
    r = _cli("--platform", "cpu", "--backend", "golden", "frame", str(p))
    assert r.returncode == 0, r.stderr
    assert "sku [str]" in r.stdout
    assert "price [decimal:2]: 12.34, -0.05, 1.00" in r.stdout
    assert "n [int32]: 3, 4, 5" in r.stdout
    r = _cli("--platform", "cpu", "--backend", "golden", "frame", str(p),
             "--schema", "price=float,n=int32", "--engine", "packed")
    assert r.returncode == 0, r.stderr
    assert "price [float]" in r.stdout and "sku" not in r.stdout


def test_cli_typed_columns(tmp_path):
    p = tmp_path / "prices.csv"
    p.write_bytes(b"sku,price,n\nA,12.34,3\nB,-0.05,4\nC,oops,x\n")
    r = _cli("--platform", "cpu", "--backend", "golden", "column", str(p),
             "1", "--type", "decimal", "--scale", "2")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["12.34", "-0.05", "<not", "ok>"]
    r = _cli("--platform", "cpu", "--backend", "golden", "column", str(p),
             "2", "--type", "int32")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["3", "4", "<not", "ok>"]


def test_artifact_path_without_npz_suffix(tmp_path):
    """np.savez appends '.npz' to suffix-less paths; a save/load
    round-trip with the SAME path string must still work."""
    from csv_simd_tpu import create_from_bytes
    from csv_simd_tpu.artifact import load_tape, save_tape

    data = b"a,b\n1,2\n3,4\n"
    tape = create_from_bytes(data, backend="golden")
    p = str(tmp_path / "idx")  # no suffix
    save_tape(tape, p)
    t2 = load_tape(p, data)
    assert t2.seek_field(0, 1) == b"2"


def test_space_delimited_dialect():
    """A space-delimited dialect is expressible: the (inert) space role
    collides with the delimiter, and the colliding codes OR together
    (plain dict assignment used to drop the structural bit)."""
    import pytest

    from csv_simd_tpu import create_from_bytes
    from csv_simd_tpu.config import Dialect

    d = Dialect(delimiter=0x20)
    data = b'a b\n1 "x y"\n2 z\n'
    for backend in ("golden", "jnp"):
        t = create_from_bytes(data, backend=backend, dialect=d)
        assert t.field_cnt == 2
        assert t.seek_field(0, 1) == b'"x y"'
        assert t.seek_field(1, 1) == b"z"
    # quote must still differ from space/escape (trim precedes unquote)
    with pytest.raises(ValueError, match="quote"):
        Dialect(quote=0x20)
    with pytest.raises(ValueError, match="distinct"):
        Dialect(delimiter=0x0A)


def test_cli_remaining_commands(tmp_path, capsys):
    """Smoke the CLI commands no other test drives: info, record,
    typed column, describe."""
    from csv_simd_tpu.__main__ import main

    p = tmp_path / "t.csv"
    p.write_bytes(
        b"sym,qty,price\nAA,5,1.25\nBB,50,2.50\nAA,500,0.75\n"
    )
    assert main(["--backend", "golden", "info", str(p)]) == 0
    out = capsys.readouterr().out
    assert "header" in out or "Tape" in out
    assert main(["--backend", "golden", "record", str(p), "1"]) == 0
    out = capsys.readouterr().out
    assert "50" in out
    assert main(["column", str(p), "1", "--type", "int32"]) == 0
    out = capsys.readouterr().out
    assert "500" in out
    assert main(["column", str(p), "2", "--type", "decimal",
                 "--scale", "2"]) == 0
    out = capsys.readouterr().out
    assert "1.25" in out  # CLI formats decimals back with the point
    assert main(["describe", str(p)]) == 0
    out = capsys.readouterr().out
    assert "qty" in out and "mean" in out
