"""Window-function executor benchmark: device plan vs host Python loop.

VERDICT r3 item 4 "recorded >=1M-row window query timing". Builds a
synthetic typed frame (no CSV parse in the timed region), evaluates one
representative window item through BOTH executors via sql's public
entry, and prints one JSON line.

    python tools/winbench.py [n_rows] [cpu|gpu]
"""

import json
import os
import sys
import time

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    plat = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from csv_simd_tpu.utils.backend import (
        enable_compile_cache,
        select_platform,
    )

    select_platform(plat)
    enable_compile_cache()

    import csv_simd_tpu.window as W
    from csv_simd_tpu.frame import Col, Frame
    from csv_simd_tpu.sql import _Item, _window_column

    rng = np.random.default_rng(9)
    grp = rng.integers(0, 100, n).astype(np.int32)
    qty = rng.integers(-1000, 1000, n).astype(np.int32)
    fr = Frame(["grp", "qty"], {"grp": grp, "qty": qty},
               {"grp": None, "qty": None},
               {"grp": Col("int32"), "qty": Col("int32")}, n)
    # device-resident parses, exactly as read_typed leaves them
    # (Frame._dev): device-side key factorization then moves O(1)
    # scalars instead of round-tripping each key column through the
    # host
    import jax.numpy as jnp

    ones = jnp.ones(n, bool)
    fr._dev = {"grp": (jnp.asarray(grp), ones),
               "qty": (jnp.asarray(qty), ones)}

    it = _Item("window", col="qty", fn="sum")
    it.part, it.worder = ["grp"], [("qty", False)]

    def resolve(c):
        return c

    results = {}
    # device executor (includes host factorize + scatter overheads)
    W.DEVICE_WINDOW_MIN_ROWS = 1
    _window_column(fr, it, resolve)  # warm/compile
    t0 = time.time()
    vals_d, ok_d, _ = _window_column(fr, it, resolve)
    results["device_s"] = round(time.time() - t0, 3)

    # host Python-loop executor (the round-3 baseline to beat)
    W.DEVICE_WINDOW_MIN_ROWS = 10**9
    t0 = time.time()
    vals_h, ok_h, _ = _window_column(fr, it, resolve)
    results["host_s"] = round(time.time() - t0, 3)

    same = all(
        (vals_d[i] is None) == (vals_h[i] is None)
        and (vals_d[i] is None or int(vals_d[i]) == int(vals_h[i]))
        for i in range(0, n, max(1, n // 5000))
    )
    results.update({
        "rows": n, "platform": plat,
        "speedup": round(results["host_s"] / results["device_s"], 1),
        "identical_sampled": bool(same),
        "query": "SUM(qty) OVER (PARTITION BY grp ORDER BY qty)",
    })
    print(json.dumps({"winbench": results}))


if __name__ == "__main__":
    main()
