"""Relational-layer benchmark: rows/second for the query primitives
over a device-resident tape (64 MiB synthetic wide table).

Measures wall-clock best-of-N around whole public calls (device work +
the host readbacks the ops genuinely need), with the persistent compile
cache enabled. These paths round-trip to the host by design, so the
numbers are end-to-end rows/s, not kernel times.

Run: python tools/relbench.py
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def best_of(fn, n=5):
    best = 1e18
    for _ in range(n):
        t0 = time.time()
        fn()
        best = min(best, time.time() - t0)
    return best


def run(n_bytes=64 * 1024 * 1024):
    import jax

    from csv_simd_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from corpus import synthetic_wide_table

    from csv_simd_tpu.offsetfree import PackedDeviceTape
    from csv_simd_tpu.query import (
        groupby_typed,
        order_records,
        select_records,
    )
    from csv_simd_tpu.join import join_records

    print(f"platform: {jax.devices()[0].platform}")
    data = synthetic_wide_table(n_bytes)
    t0 = time.time()
    tape = PackedDeviceTape(data)
    build_s = time.time() - t0
    n = int(tape.num_data_records)
    names = tape.header.names
    print(f"rows: {n}  bytes: {len(data)}  first build {build_s:.2f}s "
          "(cold compiles included)")

    # f1 is a random int column; f3 is quoted text with commas
    schema = {"f1": "int32"}

    def sel():
        return select_records(tape, ("f1", ">", 500_000_000),
                              names=names, schema=schema)

    ids = sel()  # warm compiles
    dt = best_of(sel)
    print(f"pushdown select (int pred):  {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms, hits {len(ids)})")

    def grp():
        return groupby_typed(tape, "f2", "f1", key_spec="int32",
                             value_spec="int32")

    g = grp()
    dt = best_of(grp)
    print(f"group-by (int key, int val): {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms, {len(g['keys'])} groups)")

    def order():
        return order_records(tape, "f1", names=names, schema=schema,
                             limit=100)

    order()
    dt = best_of(order)
    print(f"order-by + top-100:          {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms)")

    def join():
        return join_records(tape, tape, "f2", left_names=names,
                            right_names=names, left_spec="int32",
                            right_spec="int32",
                            right_records=np.arange(0, n, 97,
                                                    dtype=np.int32))

    l, r = join()
    dt = best_of(join)
    print(f"sort-merge self-join:        {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms, {len(l)} pairs)")

    # round-4 surface: device window + device set ops through sql()
    import csv_simd_tpu.window as W
    import csv_simd_tpu.setops as SO
    from csv_simd_tpu.sql import sql as run_sql

    W.DEVICE_WINDOW_MIN_ROWS = 1
    SO.DEVICE_SETOP_MIN_ROWS = 1
    sch = {"f1": "int32", "f2": "int32"}

    def win():
        return run_sql(
            "SELECT SUM(f1) OVER (PARTITION BY f2 ORDER BY f1) AS s "
            "FROM t LIMIT 5", tape, schema=sch)

    win()
    dt = best_of(win, 3)
    print(f"window SUM OVER (device):    {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms)")

    def setop():
        return run_sql(
            "SELECT f2 FROM t WHERE f1 > 0 INTERSECT "
            "SELECT f2 FROM t WHERE f1 < 0", tape, schema=sch)

    r2 = setop()
    dt = best_of(setop, 3)
    print(f"INTERSECT (device setop):    {n / dt / 1e6:7.1f} Mrows/s "
          f"({dt * 1e3:.1f} ms, {len(r2)} rows)")


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 64 * 1024 * 1024)
