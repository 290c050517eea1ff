"""Stage-1 scan throughput on the GPU.

Prints ONE JSON line on stdout:
  {"metric": "stage1_scan_throughput", "value": <GB/s>, "unit": "GB/s",
   "vs_baseline": <fraction of a measured streaming reduce>, ...}

The device and its power limit go to stderr; with no GPU the line
carries an error and the exit code is non-zero. The speed of a plain
streaming reduce over the same buffer is measured, not assumed, and
timed the same way.

Methodology: XLA hoists loop-invariant work, so (a) all repetition
happens on the device inside a jitted lax.fori_loop whose body is
loop-VARIANT (the carry feeds back), (b) throughput comes from the
marginal time between two loop lengths, and (c) the best of several
trials is kept.

    python bench.py            # BENCH_MB=64 by default
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np


def _fail_json(err: str, rc: int = 1):
    """The one-JSON-line contract holds on failure too."""
    print(
        json.dumps(
            {
                "metric": "stage1_scan_throughput",
                "value": None,
                "unit": "GB/s",
                "vs_baseline": None,
                "error": err,
            }
        )
    )
    sys.stdout.flush()
    sys.exit(rc)


def _gen_csv(n_bytes: int) -> bytes:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from corpus import synthetic_wide_table

    return synthetic_wide_table(n_bytes)[:n_bytes]


def _marginal_multi(specs, trials=6, reps=2):
    """Interleaved marginal timing of several chains: every trial round
    touches every (chain, k), so drift hits all of them alike and the
    reported ratios are same-batch. specs: {name: (chain, arr, k_lo,
    k_hi)}."""
    mins = {name: {k: float("inf") for k in (lo, hi)}
            for name, (_c, _a, lo, hi) in specs.items()}
    for name, (chain, arr, lo, hi) in specs.items():
        for k in (lo, hi):
            float(chain(arr, k))  # compile + warm
    for _ in range(trials):
        for name, (chain, arr, lo, hi) in specs.items():
            for k in (lo, hi):
                for _ in range(reps):
                    t0 = time.perf_counter()
                    float(chain(arr, k))
                    mins[name][k] = min(mins[name][k],
                                        time.perf_counter() - t0)
    return {
        name: (mins[name][hi] - mins[name][lo]) / (hi - lo)
        for name, (_c, _a, lo, hi) in specs.items()
    }


def _correctness_gate():
    """Refuse to report a number from a miscompiled scan: run the
    compiled fold and sequential scans on the card and require
    bit-identity with the golden oracle."""
    import jax.numpy as jnp

    from csv_simd_tpu import golden
    from csv_simd_tpu.ops.pack import pad_to_words
    from csv_simd_tpu.ops.stage1_v3 import (
        stage1_seq_xla,
        stage1_swar_xla,
        unpack_packed_host,
    )

    rng = np.random.default_rng(2026)
    data = rng.choice(
        # incl. the raw-classify adversaries: bytes whose low-7 bits
        # equal structural chars but with bit 7 set must stay inert
        np.frombuffer(b'ab"",\n\rx,z":; \t09\xa2\x8a\x8d\xac\xff',
                      dtype=np.uint8),
        size=700_000,
    )
    ref = golden.structural_mask(data)
    w2d = jnp.asarray(pad_to_words(data))
    fold, _ = stage1_swar_xla(w2d, 0)
    if not (unpack_packed_host(np.asarray(fold), data.size) == ref).all():
        _fail_json("correctness gate: compiled stage1_swar_xla != golden")
    seq, _ = stage1_seq_xla(w2d, 0)
    bits = np.unpackbits(
        np.ascontiguousarray(np.asarray(seq)).view("<u4").view(np.uint8),
        bitorder="little",
    )[: data.size]
    if not (bits == ref).all():
        _fail_json("correctness gate: compiled stage1_seq_xla != golden")
    print("# correctness gate: fold and sequential scans bit-identical "
          "to golden on the card", file=sys.stderr)


def main():
    import jax
    import jax.numpy as jnp

    from csv_simd_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _fail_json(f"no GPU: JAX's default device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"# {smi.stdout.strip()} ({dev.device_kind})", file=sys.stderr)

    from csv_simd_tpu.offsetfree import prefix_for_packed
    from csv_simd_tpu.ops.pack import pad_to_words
    from csv_simd_tpu.ops.stage1_v3 import stage1_seq_xla, stage1_swar_xla

    _correctness_gate()
    n_mb = int(os.environ.get("BENCH_MB", "64"))
    n = n_mb * 1024 * 1024
    data = _gen_csv(n)
    arr8 = np.frombuffer(data, dtype=np.uint8)
    w2d = jnp.asarray(pad_to_words(arr8))
    n_padded = w2d.shape[0] * 512

    @functools.partial(jax.jit, static_argnames=("k",))
    def stage1_chain(a, k):
        def body(i, acc):
            packed, parity = stage1_swar_xla(a, acc & 1)
            return acc + parity + packed[0, 0]
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    # streaming reduce whose scalar operand varies per iteration (128
    # possible values) so XLA can neither hoist nor precompute it
    @functools.partial(jax.jit, static_argnames=("k",))
    def sol_chain(a, k):
        def body(i, acc):
            return acc + jnp.sum(jnp.maximum(a, acc & 127), dtype=jnp.int32)
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    # the offsets-free index build: sequential scan + row popcount
    # prefix (offsetfree.PackedDeviceTape)
    @functools.partial(jax.jit, static_argnames=("k",))
    def build_chain(a, k):
        def body(i, acc):
            packed, parity = stage1_seq_xla(a, acc & 1)
            cum = prefix_for_packed(packed)
            return acc + parity + cum[-1] + packed[0, 0]
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    pers = _marginal_multi({
        "s1": (stage1_chain, w2d, 32, 96),
        "build": (build_chain, w2d, 16, 48),
        "sol": (sol_chain, w2d, 128, 384),
    })
    stage1_gbps = n_padded / pers["s1"] / 1e9
    build_gbps = n_padded / pers["build"] / 1e9
    sol_gbps = n_padded / pers["sol"] / 1e9
    print(
        f"# stage1 {stage1_gbps:.1f} GB/s; full index build "
        f"{build_gbps:.1f} GB/s; streaming reduce {sol_gbps:.1f} GB/s; "
        f"buffer {n_mb} MiB (padded {n_padded / 2**20:.0f} MiB)",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "stage1_scan_throughput",
                "value": round(stage1_gbps, 2),
                "unit": "GB/s",
                "vs_baseline": round(stage1_gbps / sol_gbps, 4),
                "build_gbps": round(build_gbps, 2),
                "sol_gbps": round(sol_gbps, 2),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 — contract: always one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        _fail_json(f"{type(e).__name__}: {e}")
