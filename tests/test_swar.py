"""SWAR byte-equality detectors (ops/swar.py): exact on adversarial
byte layouts, and the two detector forms agree on every byte value."""

import jax.numpy as jnp
import numpy as np

from csv_simd_tpu.ops.swar import swar_eq


def test_swar_eq_exact():
    """The naive SWAR zero-detector has borrow false positives (a 0x01
    byte after a 0x00 byte); ours must be exact on adversarial layouts."""
    import jax

    tricky = np.array(
        [0x00012C00, 0x2C2D0001, 0x012C0100, -0x7FFFFFD4], dtype=np.int32
    ).reshape(1, 4)
    got = np.asarray(jax.jit(lambda x: swar_eq(x, 0x2C))(jnp.asarray(tricky)))
    bytes_le = tricky.view(np.uint8).reshape(-1)
    want_flags = np.zeros(4, dtype=np.int64)
    for w in range(4):
        for b in range(4):
            if bytes_le[w * 4 + b] == 0x2C:
                want_flags[w] |= 0x80 << (8 * b)
    want = want_flags.astype(np.uint32).astype(np.int64)
    got_u = np.asarray(got, dtype=np.int64).reshape(-1) & 0xFFFFFFFF
    np.testing.assert_array_equal(got_u, want)


def test_swar_eq_alt_equivalence():
    """The CSE-proof alternate zero-byte detector must agree with
    swar_eq for every byte value (used for rematerialization studies)."""
    import jax

    from csv_simd_tpu.ops.swar import swar_eq, swar_eq_alt

    rng = np.random.default_rng(0)
    x = rng.integers(-(2**31), 2**31, (64, 128), dtype=np.int64).astype(np.int32)
    x.view(np.uint8).reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    for byte in (0x2C, 0x22, 0x0A, 0x0D, 0x00, 0xFF, 0x80, 0x01):
        a = np.asarray(jax.jit(lambda v, b=byte: swar_eq(v, b))(jnp.asarray(x)))
        b = np.asarray(jax.jit(lambda v, b=byte: swar_eq_alt(v, b))(jnp.asarray(x)))
        np.testing.assert_array_equal(a, b, err_msg=hex(byte))
