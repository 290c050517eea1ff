"""Multi-host (multi-process) sharded index build demo/check.

Each process plays one "host" with its own local CPU devices;
jax.distributed stitches them into one global mesh over DCN, and the
sharded stage-1 runs as on a multi-host cluster: local scans + exclusive
XOR-scan parity collective across ALL hosts' shards.

Launched by tests/test_multihost.py as N subprocesses:
    python tools/multihost_demo.py <coordinator> <num_procs> <proc_id>
Prints "MULTIHOST_OK <total_structural>" from process 0 on success.
"""

import os
import sys


def main():
    coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num, process_id=pid
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(
        0,
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"
        ),
    )
    from csv_simd_tpu import golden
    from csv_simd_tpu.ops.pack import pad_to_words
    from csv_simd_tpu.parallel.sharded import AXIS, sharded_stage1
    from corpus import synthetic_wide_table

    devs = jax.devices()  # global: num * 4 cpu devices
    n_shards = len(devs)
    mesh = Mesh(np.array(devs), (AXIS,))

    data = synthetic_wide_table(
        int(os.environ.get("MULTIHOST_BYTES", "300000")))
    arr = np.frombuffer(data, dtype=np.uint8)
    w2d = pad_to_words(arr, row_align=8 * n_shards)
    rows = w2d.shape[0]
    if rows % (8 * n_shards):
        extra = -(-rows // (8 * n_shards)) * (8 * n_shards) - rows
        w2d = np.concatenate([w2d, np.zeros((extra, 128), w2d.dtype)])

    sharding = NamedSharding(mesh, P(AXIS, None))
    # each process provides its local shards
    w_dev = jax.make_array_from_callback(
        w2d.shape, sharding, lambda idx: w2d[idx]
    )
    packed, counts, count_excl, total, parity = sharded_stage1(
        w_dev, 0, mesh
    )
    total = int(total)
    want = len(golden.structural_index(data)) - 1
    assert total == want, (total, want)
    # the sequential (serving) layout across hosts too
    packed_seq, _c2, _ce2, total2, _p2 = sharded_stage1(
        w_dev, 0, mesh, layout="seq"
    )
    assert int(total2) == want, (int(total2), want)
    # timed passes: the jit is warm from the calls above; collectives
    # keep the processes in lockstep, so pid 0's wall clock is the
    # group's
    import time

    reps = int(os.environ.get("MULTIHOST_TIME_REPS", "5"))
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = sharded_stage1(w_dev, 0, mesh)
        jax.block_until_ready(out[0])
        best = min(best, time.time() - t0)
    if pid == 0:
        padded_bytes = w2d.shape[0] * 512
        print(f"MULTIHOST_OK {total}", flush=True)
        print(f"MULTIHOST_TIME {best:.6f} {padded_bytes} {n_shards}",
              flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
