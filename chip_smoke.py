"""Smoke run of the main path on a GPU, at the size the repo claims.

    python chip_smoke.py                # one card: build, serve, SQL, UTF-8
    python chip_smoke.py --devices 4    # the sharded path on four cards
    python chip_smoke.py --trace DIR    # also profile the builds into DIR

The data is the repo's "1 GB synthetic wide-table" (tests/corpus.py
synthetic_wide_table): 16 fields, every seventh a quoted text field with
an embedded comma, generated from a fixed seed by a vectorised NumPy
twin of that generator. One card takes 1 GiB, four take 3 GiB (past the
2 GiB int32 ceiling that sharding lifts). Each phase runs the public
entry points on the card and compares the result with a reference that
shares no device code: the native C++ engine's int64 offsets, and NumPy
oracles computed over them.

Times printed here are first readings of one run (the first call of
each shape includes its compilation), not benchmark results. The last
line of standard output is one JSON object; any failed phase raises and
the script exits non-zero without printing it. With no GPU it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_FIELDS = 16
TEXT_PREFIX = b'"text, with comma '
SEED = 7
MAX_FIELD = 32  # widest field: '"text, with comma 9999"' is 24 bytes
SQL_LIMIT = 10_000_000  # WHERE f1 < this keeps ~1% of the rows
INT_SCHEMA = {f"f{j}": "int32" for j in (1, 2, 4, 5, 6)}
SQL = (f"SELECT f3, COUNT(*) AS n, SUM(f2) AS s, MIN(f4) AS lo, "
       f"MAX(f5) AS hi, AVG(f6) AS a FROM t WHERE f1 < {SQL_LIMIT} "
       f"GROUP BY f3")
# AVG is reduced in float32 on the device; group means of int32 values
# carry float32's 24-bit mantissa, hence a relative bound, not equality
AVG_RTOL = 1e-6


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class Clock:
    """Wall seconds of named steps, printed as they end."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _block(out)
        dt = time.perf_counter() - t0
        self.seconds[name] = dt
        print(f"# {name}: {dt:.3f} s", flush=True)
        return out

    def cold_warm(self, name: str, fn, *args, **kw):
        """Run twice; the first run includes compilation, so the
        difference approximates compile time."""
        cold_out = self(f"{name} (first call)", fn, *args, **kw)
        del cold_out
        out = self(f"{name} (second call)", fn, *args, **kw)
        cold = self.seconds[f"{name} (first call)"]
        warm = self.seconds[f"{name} (second call)"]
        print(f"# {name}: run {warm:.3f} s, compile ~{cold - warm:.3f} s",
              flush=True)
        return out


def _block(out) -> None:
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        if isinstance(leaf, jax.Array):
            leaf.block_until_ready()
    for name in ("words", "cum_incl", "data"):
        arr = getattr(out, name, None)
        if isinstance(arr, jax.Array):
            arr.block_until_ready()


# ----------------------------------------------------------------- data


def _put_digits(mat, mask, col: int, vals: np.ndarray, width: int) -> int:
    """Write (n,) non-negative ints < 2**31 right-aligned as ASCII into
    the column-major mat[col:col+width]; mask keeps the significant
    digits (no leading zeros). Returns the next column."""
    v = vals.astype(np.int32)
    for k in range(width - 1, -1, -1):
        v, d = np.divmod(v, 10)
        np.add(d, 48, out=mat[col + k], casting="unsafe")
        mask[col + k] = vals >= 10 ** (width - 1 - k)
    mask[col + width - 1] = True  # the units digit, zero included
    return col + width


def _put_const(mat, mask, col: int, text: bytes) -> int:
    mat[col:col + len(text)] = np.frombuffer(text, np.uint8)[:, None]
    mask[col:col + len(text)] = True
    return col + len(text)


_ROW_WIDTH = 10 + 15 + 13 * 10 + 2 * (len(TEXT_PREFIX) + 4 + 1) + 1


def wide_table_rows(first_id: int, n: int, seed) -> np.ndarray:
    """n rows of the wide table as flat uint8 bytes: row id, then
    fields 1..15 — '"text, with comma K"' (K < 10**4) where j % 7 == 3,
    else an integer in [0, 10**9]."""
    rng = np.random.default_rng(seed)
    mat = np.empty((_ROW_WIDTH, n), np.uint8)  # column-major: one row
    mask = np.empty((_ROW_WIDTH, n), bool)     # of this per byte column
    col = _put_digits(mat, mask, 0, np.arange(first_id, first_id + n), 10)
    for j in range(1, N_FIELDS):
        col = _put_const(mat, mask, col, b",")
        if j % 7 == 3:
            col = _put_const(mat, mask, col, TEXT_PREFIX)
            col = _put_digits(mat, mask, col, rng.integers(0, 10**4, n), 4)
            col = _put_const(mat, mask, col, b'"')
        else:
            col = _put_digits(mat, mask, col,
                              rng.integers(0, 10**9 + 1, n), 10)
    _put_const(mat, mask, col, b"\n")
    return np.ascontiguousarray(mat.T)[np.ascontiguousarray(mask.T)]


def write_wide_table(path: str, n_bytes: int, seed: int,
                     block_rows: int = 1 << 19, workers: int = 8) -> int:
    """Write whole rows of the wide table while the file stays within
    n_bytes; returns the size written. Blocks are generated in parallel
    threads, each from its own seed (seed, block number)."""
    import concurrent.futures

    header = (",".join(f"f{j}" for j in range(N_FIELDS)) + "\n").encode()
    size = len(header)
    with open(path, "wb") as f, \
            concurrent.futures.ThreadPoolExecutor(workers) as pool:
        f.write(header)
        block = 0
        while size < n_bytes:
            futs = [pool.submit(wide_table_rows, (block + i) * block_rows,
                                block_rows, (seed, block + i))
                    for i in range(workers)]
            block += workers
            for fut in futs:
                rows = fut.result()
                ends = np.flatnonzero(rows == 0x0A) + 1
                keep = int(np.searchsorted(ends, n_bytes - size,
                                           side="right"))
                if keep:
                    f.write(rows[: ends[keep - 1]].tobytes())
                    size += int(ends[keep - 1])
                if keep < block_rows:
                    return size
    return size


# ------------------------------------------------------------ oracles


def native_offsets(data: np.ndarray) -> np.ndarray:
    """The reference: the native engine's ascending int64 offsets."""
    from csv_simd_tpu import native

    if not native.available():
        raise SmokeFailure(f"native engine unavailable: "
                           f"{native.build_error()}")
    offs, parity = native.host_stage1(data)
    check(parity == 0, "native engine: file ends inside quotes")
    return offs


def field_bounds(ref: np.ndarray, jump: int, records, fields):
    """[start, end) byte bounds of (record, field) pairs from the
    offsets: slot (r+1)*jump + f (the header is record -1) ends at
    structural char `slot` and starts after the one before it."""
    slots = (np.asarray(records, np.int64) + 1) * jump + np.asarray(fields)
    return ref[slots - 1] + 1, ref[slots]


def parse_int_field(data: np.ndarray, ref: np.ndarray, jump: int,
                    n_rec: int, field: int) -> np.ndarray:
    """One unquoted integer field of every data record, parsed from the
    bytes between the native offsets (up to 10 digits)."""
    recs = np.arange(n_rec)
    start, end = field_bounds(ref, jump, recs, np.full(n_rec, field))
    width = end - start
    check(int(width.min()) >= 1 and int(width.max()) <= 10,
          f"field {field}: width outside 1..10")
    val = np.zeros(n_rec, np.int64)
    for k in range(10, 0, -1):
        take = width >= k
        d = data[np.where(take, end - k, 0)].astype(np.int64) - 48
        check(bool(((d >= 0) & (d <= 9) | ~take).all()),
              f"field {field}: non-digit byte")
        val = np.where(take, val * 10 + d, val)
    return val


def text_field(data: np.ndarray, ref: np.ndarray, jump: int, n_rec: int,
               field: int, records: np.ndarray) -> list:
    """Unquoted text of one quoted field for the given records."""
    start, end = field_bounds(ref, jump, records,
                              np.full(records.size, field))
    return [bytes(data[s + 1:e - 1]).decode() for s, e in zip(start, end)]


def group_oracle(data, ref, jump, n_rec) -> dict:
    """SQL's answer from NumPy over the native offsets: per f3 text key
    of rows with f1 < SQL_LIMIT, (count, sum f2, min f4, max f5, mean
    f6)."""
    cols = {j: parse_int_field(data, ref, jump, n_rec, j)
            for j in (1, 2, 4, 5, 6)}
    rows = np.flatnonzero(cols[1] < SQL_LIMIT)
    keys = text_field(data, ref, jump, n_rec, 3, rows)
    groups: dict = {}
    for r, k in zip(rows.tolist(), keys):
        g = groups.setdefault(k, [0, 0, None, None, 0])
        g[0] += 1
        g[1] += int(cols[2][r])
        g[2] = int(cols[4][r]) if g[2] is None else min(g[2], int(cols[4][r]))
        g[3] = int(cols[5][r]) if g[3] is None else max(g[3], int(cols[5][r]))
        g[4] += int(cols[6][r])
    return {k: (g[0], g[1], g[2], g[3], g[4] / g[0])
            for k, g in sorted(groups.items())}


# ------------------------------------------------------------- checks


def check_packed_bits(words, ref: np.ndarray, n_bytes: int) -> None:
    """The set bits of sequential packed words, in stream order, are the
    structural offsets."""
    bits = np.unpackbits(
        np.ascontiguousarray(np.asarray(words)).view("<u4").view(np.uint8),
        bitorder="little",
    )
    check(not bits[n_bytes:].any(), "packed bits set in the padding")
    got = np.flatnonzero(bits[:n_bytes])
    check(got.size == ref.size,
          f"packed build: {got.size} structural bits, reference "
          f"{ref.size}")
    check(np.array_equal(got, ref), "packed build: bit positions differ")


def check_index(index: np.ndarray, ref: np.ndarray, what: str) -> None:
    index = np.asarray(index)
    check(index.size == ref.size + 1 and index[0] == 0,
          f"{what}: {index.size} entries, reference {ref.size + 1}")
    check(np.array_equal(index[1:], ref), f"{what}: offsets differ")


def lookup_queries(n_rec: int, n: int, seed: int):
    """Seeded (record, field) pairs: first and last record and both
    quoted fields are always among them."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, n_rec, n)
    flds = rng.integers(0, N_FIELDS, n)
    recs[:4] = [0, n_rec - 1, 0, n_rec - 1]
    flds[:4] = [0, N_FIELDS - 1, 3, 10]
    return recs, flds


def check_lookups(tape, data, ref, jump, recs, flds) -> None:
    """gather_fields on the device == slices cut from the offsets."""
    out, lengths, valid = tape.gather_fields(recs, flds, max_len=MAX_FIELD)
    out, lengths = np.asarray(out), np.asarray(lengths)
    check(bool(np.asarray(valid).all()), "lookup: a query came back invalid")
    start, end = field_bounds(ref, jump, recs, flds)
    want_len = end - start
    check(int(want_len.max()) <= MAX_FIELD, "lookup: field wider than window")
    check(np.array_equal(lengths, want_len), "lookup: lengths differ")
    k = np.arange(MAX_FIELD)[None, :]
    pos = np.minimum(start[:, None] + k, data.size - 1)
    want = np.where(k < want_len[:, None], data[pos], 0)
    check(np.array_equal(out, want), "lookup: bytes differ")


def check_stats(st, data, ref, jump, n_rec) -> None:
    vals = parse_int_field(data, ref, jump, n_rec, 1)
    want = (n_rec, n_rec, int(vals.sum()), int(vals.min()), int(vals.max()))
    got = (st.count, st.ok_count, st.sum, st.min, st.max)
    check(got == want, f"column_stats: {got} != {want}")


def check_groups(keys, count, s, lo, hi, mean, oracle: dict,
                 what: str) -> None:
    got_keys = [k.decode() if isinstance(k, bytes) else str(k)
                for k in keys]
    check(got_keys == list(oracle), f"{what}: group keys differ")
    want = list(oracle.values())
    for col, i in ((count, 0), (s, 1), (lo, 2), (hi, 3)):
        check([int(v) for v in col] == [w[i] for w in want],
              f"{what}: aggregate {i} differs")
    if mean is not None:
        check(np.allclose(np.asarray(mean, np.float64),
                          [w[4] for w in want], rtol=AVG_RTOL, atol=0),
              f"{what}: AVG beyond rtol {AVG_RTOL}")


# ------------------------------------------------------------- phases


def print_memory_analysis(tape) -> None:
    import jax

    from csv_simd_tpu.ops.stage1_v3 import stage1_seq_xla

    rows = tape.words.shape[0]
    w = jax.ShapeDtypeStruct((rows, 128), np.int32)
    compiled = stage1_seq_xla.lower(w, 0).compile()
    print(f"# memory_analysis(stage1_seq_xla, ({rows}, 128) int32): "
          f"{compiled.memory_analysis()}", flush=True)


def traced(trace_dir: str, name: str, fn, *args):
    """One more call of fn under the profiler: device seconds per jitted
    program beside the traced call's wall seconds."""
    from csv_simd_tpu.utils.profiling import (
        device_seconds_by_module,
        device_trace,
    )

    log_dir = os.path.join(trace_dir, name)
    with device_trace(log_dir):
        t0 = time.perf_counter()
        out = fn(*args)
        _block(out)
        wall = time.perf_counter() - t0
    mods = device_seconds_by_module(log_dir)
    print(f"# trace {name}: wall {wall:.4f} s under the profiler; device "
          f"{sum(mods.values()):.4f} s in {len(mods)} programs", flush=True)
    for mod, sec in sorted(mods.items(), key=lambda kv: -kv[1])[:12]:
        print(f"#   {mod}: {sec:.6f} s", flush=True)
    return out


def run_one_card(path: str, data: np.ndarray, ref: np.ndarray, clock,
                 trace_dir=None, utf8_bytes: int = 64 << 20) -> None:
    import csv_simd_tpu as ct
    from csv_simd_tpu.ops.utf8 import validate_utf8, validate_utf8_device

    n_bytes = data.size
    # 1. offsets-free build
    tape = clock.cold_warm("phase 1 create_packed", ct.create_packed, path)
    print_memory_analysis(tape)
    check_packed_bits(tape.words, ref, n_bytes)
    check(int(tape.cum_incl[-1]) == ref.size, "packed build: count differs")
    jump = int(tape.jump)
    n_rec = int(tape.num_data_records)
    check((n_rec + 1) * jump == ref.size, "packed build: record count")
    print(f"# phase 1 ok: {ref.size} structural offsets, {n_rec} records",
          flush=True)
    if trace_dir:
        del tape
        tape = traced(trace_dir, "create_packed", ct.create_packed, path)

    # 2. serving
    recs, flds = lookup_queries(n_rec, 65_536, seed=11)
    clock.cold_warm("phase 2 gather_fields", tape.gather_fields, recs, flds,
                    max_len=MAX_FIELD)
    check_lookups(tape, data, ref, jump, recs, flds)
    print("# phase 2 ok: 65536 lookups", flush=True)

    # 4 (before the tape goes). relational and SQL over the packed tape
    st = clock.cold_warm("phase 4 column_stats", ct.column_stats, tape,
                         "f1", "int32")
    check_stats(st, data, ref, jump, n_rec)
    fr = clock.cold_warm("phase 4 sql", ct.sql, SQL, tape,
                         schema=INT_SCHEMA)
    oracle = group_oracle(data, ref, jump, n_rec)
    check_groups(fr["f3"], fr["n"], fr["s"], fr["lo"], fr["hi"], fr["a"],
                 oracle, "sql")
    print(f"# phase 4 ok: column_stats exact; sql {len(oracle)} groups",
          flush=True)
    del tape

    # 3. tape build: fold scan + host extraction, one-shot and streamed
    t = clock.cold_warm("phase 3 create", ct.create, path)
    check_index(t.index, ref, "create")
    if trace_dir:
        del t
        t = traced(trace_dir, "create", ct.create, path)
    del t
    t = clock.cold_warm("phase 3 create_streaming", ct.create_streaming,
                        path, chunk_bytes=64 << 20)
    check_index(t.index, ref, "create_streaming")
    del t
    print("# phase 3 ok: create and create_streaming == native", flush=True)

    # 5. UTF-8 on the device
    pattern = "aé中😀,\n".encode()
    n = utf8_bytes // len(pattern) * len(pattern)
    buf = np.resize(np.frombuffer(pattern, np.uint8), n)
    ok_dev = clock.cold_warm("phase 5 validate_utf8_device",
                             validate_utf8_device, buf)
    check(bool(ok_dev) and bool(validate_utf8(buf)),
          "utf8: valid buffer refused")
    bad = buf.copy()
    bad[int(np.random.default_rng(5).integers(0, n))] = 0xFF
    check(not validate_utf8_device(bad) and not validate_utf8(bad),
          "utf8: corrupted buffer accepted")
    print(f"# phase 5 ok: {n} bytes, device == host on valid and corrupted",
          flush=True)


def stream_cuts_in_quotes(data: np.ndarray, chunk: int) -> list:
    """Chunk boundaries near multiples of `chunk`, each moved into the
    next quoted text field."""
    cuts = [0]
    needle = np.frombuffer(TEXT_PREFIX, np.uint8)
    while cuts[-1] + chunk < data.size:
        lo = cuts[-1] + chunk
        window = data[lo: lo + 4096]
        hits = np.flatnonzero(window[: window.size - needle.size] == 0x22)
        at = next(int(h) for h in hits
                  if np.array_equal(window[h:h + needle.size], needle))
        cuts.append(lo + at + 5)  # inside "text, with comma ..."
    return cuts + [data.size]


def run_four_cards(data: np.ndarray, ref: np.ndarray, clock,
                   chunk_bytes: int = 256 << 20) -> None:
    import jax

    from csv_simd_tpu.parallel.serving import ShardedPackedTape
    from csv_simd_tpu.parallel.sharded import build_index_sharded, make_mesh
    from csv_simd_tpu.query import groupby_typed
    from csv_simd_tpu.streaming import ShardedStreamingIndexBuilder

    mesh = make_mesh(4)
    spt = clock.cold_warm("sharded ShardedPackedTape", ShardedPackedTape,
                          data, mesh)
    check_packed_bits(spt.words, ref, data.size)
    for name in ("words", "data"):
        arr = getattr(spt, name)
        shards = arr.addressable_shards
        devs = {s.device for s in shards}
        sizes = {s.data.shape[0] for s in shards}
        check(len(devs) == 4 and len(shards) == 4
              and sizes == {arr.shape[0] // 4},
              f"{name}: shards {len(shards)} on {len(devs)} devices, "
              f"rows {sizes} of {arr.shape[0]}")
        print(f"# {name}: {arr.shape} as 4 shards of {sizes.pop()} rows on "
              f"{sorted(str(d) for d in devs)}", flush=True)
    jump = int(spt.jump)
    n_rec = int(spt.num_data_records)
    check((n_rec + 1) * jump == ref.size, "sharded build: record count")
    recs, flds = lookup_queries(n_rec, 65_536, seed=12)
    clock.cold_warm("sharded gather_fields", spt.gather_fields, recs, flds,
                    max_len=MAX_FIELD)
    check_lookups(spt, data, ref, jump, recs, flds)
    g = clock.cold_warm(
        "sharded groupby_typed", groupby_typed, spt, "f3",
        ["f2", "f4", "f5"], value_spec=["int32"] * 3,
        where=[("f1", "<", SQL_LIMIT)], schema=INT_SCHEMA)
    oracle = group_oracle(data, ref, jump, n_rec)
    a = g["aggs"]
    check_groups(g["keys"], g["count"], a["f2"]["sum"], a["f4"]["min"],
                 a["f5"]["max"], None, oracle, "sharded groupby")
    print(f"# sharded tape ok: build, 65536 lookups, groupby "
          f"{len(oracle)} groups", flush=True)
    del spt

    index = clock.cold_warm("sharded build_index_sharded",
                            build_index_sharded, data, mesh)
    check_index(index, ref, "build_index_sharded")
    del index

    cuts = stream_cuts_in_quotes(data, chunk_bytes)

    def ingest():
        b = ShardedStreamingIndexBuilder(mesh)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            b.feed(data[lo:hi])
        return b.finish()

    index = clock.cold_warm("sharded streaming ingest", ingest)
    check_index(index, ref, "ShardedStreamingIndexBuilder")
    print(f"# sharded streaming ok: {len(cuts) - 1} chunks, every cut "
          f"inside a quoted field; devices "
          f"{[str(d) for d in jax.devices()[:4]]}", flush=True)


def result_line(devices, used: int) -> str:
    """The last line: the platform and kind JAX reports, and the number
    of cards the run used (not every card the host shows)."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": used}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4])
    p.add_argument("--out", default=os.path.join(REPO, ".smoke"),
                   help="directory for the generated table (removed "
                   "after the run)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile one extra create_packed and create "
                   "call each into DIR")
    args = p.parse_args(argv)

    import jax

    from csv_simd_tpu.utils.backend import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"error: no GPU: JAX's devices are {devices}", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"error: --devices {args.devices}: JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f"# jax.devices(): {devices}")
    print(f"# jax {jax.__version__}; compile cache {cache}", flush=True)

    gib = 3 if args.devices == 4 else 1
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"wide_{gib}gib.csv")
    clock = Clock()
    try:
        size = clock("generate wide table", write_wide_table, path,
                     gib << 30, SEED)
        print(f"# table: {size} bytes at {path}", flush=True)
        data = np.fromfile(path, np.uint8)
        ref = clock("native reference offsets", native_offsets, data)
        if args.devices == 4:
            run_four_cards(data, ref, clock)
        else:
            run_one_card(path, data, ref, clock, args.trace)
    finally:
        if os.path.exists(path):
            os.remove(path)
    print(result_line(devices, args.devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
