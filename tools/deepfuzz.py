"""Deep one-off differential fuzz (beyond the CI property budgets).

Two sweeps, both CPU-only and deterministic per seed:

  index:  random dialects x random byte soup -> golden vs jnp vs
          native threads, plus streaming at random cut points (400
          iterations ~4 min).
  sql:    random clean tables x random WHERE/GROUP BY -> sql() vs
          pandas (150 iterations ~3 min).

Run:  python tools/deepfuzz.py [index|sql|all] [seed]
Last clean runs: 2026-08-19 round-4 (all sweeps, 0 mismatches — after
the window/setop/in_rows executor additions).
"""

import io
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fuzz_index(seed: int, iters: int = 400) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from csv_simd_tpu import golden, native
    from csv_simd_tpu.config import Dialect
    from csv_simd_tpu.index import build_index
    from csv_simd_tpu.streaming import StreamingIndexBuilder

    rng = random.Random(seed)
    alphabet = b'ab"x,\n\r;|\'`\t 09\xa2\x8a\xff\x00'
    delims = [0x2C, 0x3B, 0x7C, 0x09, 0x20]
    quotes = [0x22, 0x27, 0x60]
    for i in range(iters):
        d = Dialect(delimiter=rng.choice(delims),
                    quote=rng.choice(quotes))
        n = rng.randint(0, 5000)
        data = bytes(rng.choice(alphabet) for _ in range(n))
        want = golden.structural_index(data, d)
        got = build_index(data, dialect=d, backend="jnp")
        assert np.array_equal(got, want), (i, "jnp")
        if native.available():
            offs, _ = native.host_stage1(
                data, d, n_threads=rng.choice([1, 3, 8]))
            assert np.array_equal(offs, want[1:]), (i, "native")
        if i % 5 == 0 and n:
            b = StreamingIndexBuilder(d, "jnp")
            pos = 0
            while pos < n:
                step = rng.randint(1, max(1, n // 3))
                b.feed(data[pos:pos + step])
                pos += step
            assert np.array_equal(b.finish(), want), (i, "streaming")
        if i % 50 == 0:
            print("index iter", i, flush=True)
    print(f"INDEX DEEP FUZZ OK: {iters} iterations, 0 mismatches")


def fuzz_sql(seed: int, iters: int = 150) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pandas as pd

    from csv_simd_tpu.sql import sql

    rng = random.Random(seed)
    syms = ["AA", "BB", "CC", "DD", "AA PL", "x,y"]
    for it in range(iters):
        n = rng.randint(1, 120)
        rows = [(rng.choice(syms), rng.randint(-100, 100))
                for _ in range(n)]
        csv = "sym,qty\n" + "".join(
            (f'"{s}"' if "," in s else s) + f",{q}\n" for s, q in rows
        )
        df = pd.read_csv(io.StringIO(csv))
        lit = rng.randint(-80, 80)
        op = rng.choice([">", "<", ">=", "<=", "==", "!="])
        q1 = (f"SELECT sym, COUNT(*), SUM(qty) FROM t WHERE qty {op} "
              f"{lit} GROUP BY sym ORDER BY sym")
        r = sql(q1, csv.encode(),
                schema={"qty": "int32", "sym": "str"})
        sub = df[eval(f"df.qty {op} lit")]  # noqa: S307 - op whitelisted
        g = (sub.groupby("sym")
             .agg(c=("qty", "size"), s=("qty", "sum")).sort_index())
        assert list(r["sym"]) == g.index.tolist(), (it, q1)
        assert r["count"].tolist() == g["c"].tolist(), (it, q1)
        assert r["sum_qty"].tolist() == g["s"].tolist(), (it, q1)
        if it % 25 == 0:
            print("sql iter", it, flush=True)
    print(f"SQL-PANDAS DEEP FUZZ OK: {iters} iterations, 0 mismatches")


def fuzz_like(seed: int, iters: int = 300) -> None:
    """Random LIKE patterns (% runs and _ wildcards ANYWHERE) against a
    regex oracle — the greedy in-order device matcher
    (query._like_general_mask) must agree on every row."""
    import re

    import jax

    jax.config.update("jax_platforms", "cpu")
    from csv_simd_tpu.sql import sql

    rng = random.Random(seed + 3)
    alphabet = "abcx,. "
    pat_alphabet = alphabet + "%%__"  # wildcards twice as likely
    for it in range(iters):
        n_rows = rng.randint(1, 40)
        vals = ["".join(rng.choice(alphabet)
                        for _ in range(rng.randint(0, 12)))
                for _ in range(n_rows)]
        csv = "s,v\n" + "".join(
            (f'"{s}"' if ("," in s or s != s.strip()) else s) + ",1\n"
            for s in vals
        )
        pat = "".join(rng.choice(pat_alphabet)
                      for _ in range(rng.randint(0, 8)))
        rx = "^" + "".join(
            ".*" if c == "%" else "." if c == "_" else re.escape(c)
            for c in pat
        ) + "$"
        r = sql(f"SELECT s FROM t WHERE s LIKE '{pat}'", csv.encode(),
                schema={"s": "str"})
        got = [str(x) for x in r["s"]]
        # the decoder strips quotes; quoted cells decode to the raw s
        want = [s for s in vals if re.match(rx, s, re.S)]
        assert got == want, (it, pat, vals, got, want)
        if it % 50 == 0:
            print("like iter", it, flush=True)
    print(f"LIKE-REGEX DEEP FUZZ OK: {iters} iterations, 0 mismatches")


def fuzz_expr(seed: int, iters: int = 200) -> None:
    """Random arithmetic expression trees: the DEVICE evaluator
    (query._eval_vexpr, driving WHERE) and the HOST twin
    (sql._expr_column, driving SELECT items) must select the same rows
    under identical int32-wrap / float32 / 0-div semantics."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from csv_simd_tpu.sql import sql

    rng = random.Random(seed + 7)

    def gen(depth):
        if depth == 0 or rng.random() < 0.4:
            return rng.choice(
                ["a", "b", "f", str(rng.randint(0, 9)),
                 f"(- {rng.randint(1, 9)})"])
        op = rng.choice("+-*/")
        return f"({gen(depth - 1)} {op} {gen(depth - 1)})"

    for it in range(iters):
        n = rng.randint(1, 50)
        rows = []
        for _ in range(n):
            a = rng.randint(-10**6, 10**6)
            b = rng.choice([rng.randint(-50, 50), "x!"])  # NULLs
            f = round(rng.uniform(-100, 100), 3)
            rows.append(f"{a},{b},{f}")
        csv = ("a,b,f\n" + "\n".join(rows) + "\n").encode()
        sch = {"a": "int32", "b": "int32", "f": "float"}
        e = gen(rng.randint(1, 3))
        c = rng.randint(-100, 100)
        sel = sql(f"SELECT a, {e} AS v FROM t", csv, schema=sch)
        okm = sel.ok("v")
        vals = np.asarray(sel["v"])
        want = [int(sel["a"][i]) for i in range(len(sel))
                if (okm is None or okm[i]) and float(vals[i]) > c]
        got = sql(f"SELECT a FROM t WHERE {e} > {c}", csv, schema=sch)
        got = [int(x) for x in got["a"]]
        assert got == want, (it, e, c, got, want)
        if it % 50 == 0:
            print("expr iter", it, flush=True)
    print(f"EXPR DEVICE-HOST DEEP FUZZ OK: {iters} iterations, "
          "0 mismatches")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260818
    if mode in ("index", "all"):
        fuzz_index(seed)
    if mode in ("sql", "all"):
        fuzz_sql(seed)
    if mode in ("like", "all"):
        fuzz_like(seed)
    if mode in ("expr", "all"):
        fuzz_expr(seed)
