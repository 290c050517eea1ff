"""The stage-1 XLA scans against the golden oracle: every corpus case
plus multi-tile inputs, with carry-in 0 and 1, through each path that
builds an index (fold layout, sequential layout, the byte-grid scan),
and the fold layout's bit placement."""

import numpy as np
import jax.numpy as jnp
import pytest

from csv_simd_tpu import golden
from csv_simd_tpu.index import stage1_words
from csv_simd_tpu.ops.pack import pad_to_words, unpack_words_host
from csv_simd_tpu.ops.stage1_v3 import (
    count_packed,
    stage1_seq_xla,
    stage1_swar_xla,
    unpack_packed_host,
)

from corpus import Case, all_cases, synthetic_wide_table


def _multi_tile_cases():
    """Inputs past one 512-row (256 KiB) fold tile: a quoted span that
    crosses tile cuts, and the wide table."""
    inner = b"x," * 200_000
    return [
        Case("multi_tile_quote_span", b'a,b\n"' + inner + b'end",2\nq,w\n'),
        Case("multi_tile_wide_table", synthetic_wide_table(600_000)),
    ]


def _fold(arr, carry):
    w2d = jnp.asarray(pad_to_words(arr))
    packed, parity = stage1_swar_xla(w2d, carry)
    mask = unpack_packed_host(np.asarray(packed), arr.size,
                              tile=min(512, w2d.shape[0]))
    assert int(count_packed(packed)) == int(mask.sum())
    return mask, parity


def _seq(arr, carry):
    packed, parity = stage1_seq_xla(jnp.asarray(pad_to_words(arr)), carry)
    bits = np.unpackbits(
        np.ascontiguousarray(np.asarray(packed)).view("<u4").view(np.uint8),
        bitorder="little",
    )
    return bits[: arr.size], parity


def _grid(arr, carry):
    words, n, parity = stage1_words(arr, backend="jnp", carry_in=carry)
    return unpack_words_host(words, n), parity


_PATHS = {"stage1_swar_xla": _fold, "stage1_seq_xla": _seq,
          "stage1_words": _grid}


@pytest.mark.parametrize(
    "case", all_cases() + _multi_tile_cases(), ids=lambda c: c.name)
@pytest.mark.parametrize("carry", [0, 1])
@pytest.mark.parametrize("path", sorted(_PATHS))
def test_xla_path_matches_golden(path, carry, case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    mask, parity = _PATHS[path](arr, carry)
    np.testing.assert_array_equal(
        mask, golden.structural_mask(arr, carry_in=carry))
    assert int(parity) == golden.quote_parity_out(arr, carry_in=carry)


def test_fold_pack_layout_roundtrip():
    """Every bit position must round-trip through the sigma/fold layout:
    use a one-hot sweep over a small tile."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 4096 * 3, dtype=np.uint8)
    # force specific structural bytes at chosen positions
    for pos in (0, 1, 511, 512, 513, 4095, 4096, 8191, 12287):
        data[pos] = 0x2C
    data[data == 0x22] = 0x61  # drop quotes to make mask predictable
    arr = data
    w2d = jnp.asarray(pad_to_words(arr, row_align=8))
    tile = min(8, w2d.shape[0])
    packed, _ = stage1_swar_xla(w2d, 0, row_tile=tile)
    mask = unpack_packed_host(np.asarray(packed), arr.size, tile=tile)
    want = golden.structural_mask(arr)
    np.testing.assert_array_equal(mask, want)
