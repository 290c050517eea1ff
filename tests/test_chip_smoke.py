"""chip_smoke.py off the card: it refuses to run without a GPU, its
table generator keeps the wide table's row shape, its phases pass at a
tiny size on the CPU (one device and a 4-device virtual mesh), and its
checks catch a wrong answer. The same phases run on the card under the
`gpu` marker."""

import csv
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from csv_simd_tpu.utils.profiling import device_seconds_by_module, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(tmp_path, n_bytes, seed=7):
    path = str(tmp_path / "t.csv")
    size = cs.write_wide_table(path, n_bytes, seed, block_rows=4096,
                               workers=2)
    data = np.fromfile(path, np.uint8)
    assert data.size == size <= n_bytes
    return path, data, cs.native_offsets(data)


def _run(args, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_refuses_to_run_on_cpu():
    r = _run([], REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path, {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("used", [1, 4])
def test_result_line_counts_cards_used(used):
    """The count is the mesh size the run used, even where the host
    shows more devices."""
    import json

    import jax

    devices = jax.devices()
    line = json.loads(cs.result_line(devices * 8, used))
    assert line == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": used}}


def test_wide_table_row_shape(tmp_path):
    path, data, _ref = _table(tmp_path, 300_000)
    rows = list(csv.reader(io.StringIO(data.tobytes().decode())))
    assert rows[0] == [f"f{j}" for j in range(16)]
    assert {len(r) for r in rows} == {16}
    assert [int(r[0]) for r in rows[1:]] == list(range(len(rows) - 1))
    for r in rows[1:]:
        for j in range(1, 16):
            if j % 7 == 3:
                assert r[j].startswith("text, with comma ")
                assert 0 <= int(r[j][17:]) < 10**4
            else:
                assert 0 <= int(r[j]) <= 10**9 and str(int(r[j])) == r[j]
    again = str(tmp_path / "again.csv")
    cs.write_wide_table(again, 300_000, 7, block_rows=4096, workers=2)
    assert open(again, "rb").read() == data.tobytes()


def test_one_card_phases_tiny(tmp_path):
    path, data, ref = _table(tmp_path, 1 << 20)
    cs.run_one_card(path, data, ref, cs.Clock(),
                    trace_dir=str(tmp_path / "trace"), utf8_bytes=1 << 16)


def test_four_device_phases_tiny(tmp_path):
    _path, data, ref = _table(tmp_path, 2 << 20)
    cs.run_four_cards(data, ref, cs.Clock(), chunk_bytes=256 << 10)


def _mutations():
    def packed(path, data, ref):
        import csv_simd_tpu as ct

        bad = ref.copy()
        bad[5] += 1
        cs.check_packed_bits(ct.create_packed(path).words, bad, data.size)

    def index(path, data, ref):
        cs.check_index(np.concatenate([[0], ref[:-1], [ref[-1] + 1]]), ref,
                       "index")

    def lookups(path, data, ref):
        import csv_simd_tpu as ct

        tape = ct.create_packed(path)
        recs, flds = cs.lookup_queries(int(tape.num_data_records), 64, 3)
        bad = data.copy()
        bad[ref[16 + 16 * 3 + 2] - 1] ^= 1  # a byte of record 3, field 2
        cs.check_lookups(tape, bad, ref, int(tape.jump),
                         np.r_[recs, 3], np.r_[flds, 2])

    def groups(path, data, ref):
        import csv_simd_tpu as ct

        tape = ct.create_packed(path)
        n_rec = int(tape.num_data_records)
        oracle = cs.group_oracle(data, ref, 16, n_rec)
        fr = ct.sql(cs.SQL, tape, schema=cs.INT_SCHEMA)
        s = np.asarray(fr["s"]).copy()
        s[0] += 1
        cs.check_groups(fr["f3"], fr["n"], s, fr["lo"], fr["hi"], fr["a"],
                        oracle, "sql")

    return {"packed": packed, "index": index, "lookups": lookups,
            "groups": groups}


@pytest.mark.parametrize("which", sorted(_mutations()))
def test_checks_catch_a_wrong_answer(tmp_path, which):
    path, data, ref = _table(tmp_path, 1 << 19)
    with pytest.raises(cs.SmokeFailure):
        _mutations()[which](path, data, ref)


def test_device_trace_does_not_degrade(tmp_path):
    """A profiler that cannot start raises; a trace with no device plane
    reduces to no programs; a missing trace is an error."""
    import jax.numpy as jnp

    with device_trace(str(tmp_path / "a")):
        jnp.ones(8).block_until_ready()
        with pytest.raises(RuntimeError):
            with device_trace(str(tmp_path / "b")):
                pass
    assert device_seconds_by_module(str(tmp_path / "a")) == {}
    with pytest.raises(FileNotFoundError):
        device_seconds_by_module(str(tmp_path / "missing"))


@pytest.mark.gpu
def test_one_card_phases_on_gpu(gpu, tmp_path):
    path, data, ref = _table(tmp_path, 16 << 20)
    cs.run_one_card(path, data, ref, cs.Clock(),
                    trace_dir=str(tmp_path / "trace"))
