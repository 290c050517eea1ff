"""Sharded-path overhead attribution (VERDICT r4 item 7): decompose
the virtual-mesh build's per-pass time by ABLATION — the only honest
instrument on a rig with no real multi-chip (spans can't see inside
one jit; variants can).

Rows per mesh width n:
  full     — production sharded_stage1 (phase-A parity + exclusive
             XOR-scan + phase-B scan + count collectives)
  nocoll   — collectives ablated (carry/count stay local): delta vs
             full = the all_gather/psum cost at width n
  nophaseA — phase-A local-parity pass ALSO ablated: delta vs nocoll
             = the second full read of the buffer that speculative-
             free sharding pays (the dual-pass design)
  plain    — single-device jit of the same kernel, no shard_map: the
             shard_map partition overhead at n=1 is full(1) - plain

Caveat stamped into the output: virtual CPU devices SHARE the host's
cores, and the n=1 'device' already uses them all via XLA CPU
intra-op threading — the table attributes OVERHEAD, it cannot measure
device scaling.

    python tools/shard_overhead.py [MB]
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from csv_simd_tpu import golden
from csv_simd_tpu.config import DEFAULT_DIALECT
from csv_simd_tpu.ops.pack import pad_to_words
from csv_simd_tpu.ops.stage1_v3 import count_packed, stage1_seq_xla
from csv_simd_tpu.parallel.sharded import (
    AXIS,
    _exclusive_scan_axis,
    _local_parity,
    sharded_stage1,
)

MB = int(sys.argv[1]) if len(sys.argv) > 1 else 256


def _buffer(n_bytes):
    rng = np.random.default_rng(11)
    cell = np.frombuffer(b"abcdefgh,123,456.75,x\n", np.uint8)
    return np.asarray(rng.choice(cell, n_bytes), np.uint8)


def _time(fn, *args, trials=5):
    out = fn(*args)
    jax.block_until_ready(out[0] if isinstance(out, tuple) else out)
    best = float("inf")
    for _ in range(trials):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out[0] if isinstance(out, tuple) else out)
        best = min(best, time.time() - t0)
    return best


def _variant_fn(mesh, which):
    """All variants share the SEQ kernel so deltas isolate exactly one
    mechanism:
      old4     — round-4 production collectives: TWO all_gather-based
                 exclusive scans + TWO psums (parity, count totals)
      new2     — round-5 fusion: two (n+1)-lane psums
      nocoll   — no cross-shard carry at all (local parity only)
      nophaseA — phase-A parity pre-pass also removed (one read of
                 the buffer instead of two)"""
    from csv_simd_tpu.parallel.sharded import _scan_total_psum

    dialect = DEFAULT_DIALECT
    n = int(mesh.devices.size)

    def fn(w, carry0):
        extras = []
        if which == "nophaseA":
            carry = carry0[0] & 1
        else:
            local_par = _local_parity(w, dialect)
            if which == "nocoll":
                carry = (local_par + carry0[0]) & 1  # LOCAL only
            elif which == "old4":
                carry = (_exclusive_scan_axis(local_par, AXIS)
                         + carry0[0]) & 1
                extras.append(jax.lax.psum(local_par, AXIS))
            else:  # new2
                pe, pt = _scan_total_psum(local_par, AXIS, n)
                carry = (pe + carry0[0]) & 1
                extras.append(pt)
        packed, _ = stage1_seq_xla(w, carry, dialect)
        count = count_packed(packed)
        if which == "old4":
            extras.append(_exclusive_scan_axis(count, AXIS))
            extras.append(jax.lax.psum(count, AXIS))
        elif which == "new2":
            ce, ct = _scan_total_psum(count, AXIS, n)
            extras.extend([ce, ct])
        bonus = sum(e * 0 for e in extras) if extras else 0
        return packed, (count + bonus)[None]

    return jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P(AXIS, None), P()),
        out_specs=(P(AXIS, None), P(AXIS)),
        check_vma=False,
    ))


def main():
    devs = jax.devices()
    arr = _buffer(MB * 1024 * 1024)
    w2d = pad_to_words(arr)
    unit = 512 * 8
    if w2d.shape[0] % unit:
        pad = -(-w2d.shape[0] // unit) * unit - w2d.shape[0]
        w2d = np.concatenate([w2d, np.zeros((pad, 128), w2d.dtype)])
    padded = w2d.shape[0] * 512
    want = int(golden.structural_mask(arr).sum())

    # plain single-device jit (no shard_map at all)
    plain = jax.jit(lambda w: stage1_seq_xla(w, 0, DEFAULT_DIALECT))
    wj = jnp.asarray(w2d)
    t_plain = _time(plain, wj)
    out = {"mb": MB, "padded_bytes": padded, "ncpu": len(jax.devices()),
           "plain_s": round(t_plain, 6),
           "plain_gbps": round(padded / t_plain / 1e9, 3), "rows": []}

    for n in (1, 2, 4, 8):
        if n > len(devs):
            break
        mesh = Mesh(np.array(devs[:n]), (AXIS,))
        w_dev = jax.device_put(jnp.asarray(w2d),
                               NamedSharding(mesh, P(AXIS, None)))
        carry = jnp.zeros(1, jnp.int32)
        # correctness anchor for the production path
        prod = sharded_stage1(w_dev, 0, mesh)
        assert int(prod[3]) == want, (n, int(prod[3]), want)
        t_prod = _time(lambda w: sharded_stage1(w, 0, mesh), w_dev)
        row = {"shards": n,
               "production_s": round(t_prod, 6)}
        for which in ("old4", "new2", "nocoll", "nophaseA"):
            f = _variant_fn(mesh, which)
            row[f"{which}_s"] = round(_time(f, w_dev, carry), 6)
        row["collective_fusion_s"] = round(
            row["old4_s"] - row["new2_s"], 6)
        row["collectives_s"] = round(row["new2_s"] - row["nocoll_s"], 6)
        row["phaseA_s"] = round(row["nocoll_s"] - row["nophaseA_s"], 6)
        row["gbps"] = round(padded / t_prod / 1e9, 3)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
