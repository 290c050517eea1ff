"""The relational layer over MESH-SHARDED tapes: typed columns, frames,
predicate pushdown, stats, group-by, order-by and joins must produce the
same results whether the tape lives on one device or is sharded across
the 8-device CPU mesh (TypedColumnsMixin contract).

Reference context: the reference has no relational layer at all and no
multi-device story (SURVEY.md §2.4); this is the mesh extension —
queries execute where the shards live, with XLA collectives doing the
cross-shard gathers."""

import jax
import numpy as np
import pytest

from csv_simd_tpu import create_from_bytes
from csv_simd_tpu.device_tape import DeviceTape
from csv_simd_tpu.frame import read_typed
from csv_simd_tpu.join import join_typed
from csv_simd_tpu.parallel.serving import ShardedPackedTape, ShardedTape
from csv_simd_tpu.parallel.sharded import make_mesh
from csv_simd_tpu.query import (
    column_stats,
    groupby_typed,
    order_records,
    select_records,
    value_counts,
)


def _mk_csv(n_rows: int = 500) -> bytes:
    rng = np.random.default_rng(11)
    rows = ["id,sym,qty,price,day"]
    syms = ["AAPL", "MSFT", '"GOOG"', "TSLA"]
    for i in range(n_rows):
        sym = syms[int(rng.integers(0, len(syms)))]
        qty = int(rng.integers(-50, 5000))
        price = f"{rng.integers(1, 9999) / 100:.2f}"
        day = f"2024-{int(rng.integers(1, 13)):02d}-{int(rng.integers(1, 29)):02d}"
        rows.append(f"{i},{sym},{qty},{price},{day}")
    return ("\n".join(rows) + "\n").encode()


@pytest.fixture(scope="module")
def setup():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    data = _mk_csv()
    tape = create_from_bytes(data, backend="golden")
    dev = DeviceTape.from_tape(tape)
    mesh = make_mesh(8)
    return data, dev, ShardedPackedTape(data, mesh), \
        ShardedTape.from_tape(tape, mesh)


def _assert_frames_equal(a, b):
    assert a.names == b.names
    assert len(a) == len(b)
    for n in a.names:
        va, vb = a[n], b[n]
        if va.dtype.kind == "f":
            np.testing.assert_allclose(va, vb, rtol=0, atol=0)
        else:
            assert list(va) == list(vb)
        oa, ob = a.ok(n), b.ok(n)
        assert (oa is None) == (ob is None)
        if oa is not None:
            assert (np.asarray(oa) == np.asarray(ob)).all()


@pytest.mark.parametrize("which", ["packed", "offsets"])
def test_read_typed_sharded_matches_device(setup, which):
    data, dev, spt, st = setup
    sharded = spt if which == "packed" else st
    f_dev = read_typed(dev)
    f_sh = read_typed(sharded)
    _assert_frames_equal(f_dev, f_sh)


def test_predicate_pushdown_sharded(setup):
    data, dev, spt, _ = setup
    where = [("qty", ">", 1000), ("sym", "==", "GOOG")]
    ids_dev = select_records(dev, where)
    ids_sh = select_records(spt, where)
    assert list(ids_dev) == list(ids_sh)
    assert len(ids_dev) > 0  # the fixture contains matches


def test_column_stats_sharded(setup):
    data, dev, spt, _ = setup
    s_dev = column_stats(dev, "qty")
    s_sh = column_stats(spt, "qty")
    assert s_dev == s_sh
    assert s_dev.sum is not None
    p_dev = column_stats(dev, "price", spec="decimal:2")
    p_sh = column_stats(spt, "price", spec="decimal:2")
    assert p_dev == p_sh


def test_groupby_sharded(setup):
    data, dev, spt, _ = setup
    g_dev = groupby_typed(dev, "sym", "qty")
    g_sh = groupby_typed(spt, "sym", "qty")
    assert list(g_dev["keys"]) == list(g_sh["keys"])
    for k in ("sum", "min", "max", "count"):
        assert list(g_dev[k]) == list(g_sh[k])
    # quoted "GOOG" decodes to GOOG in the group keys
    assert "GOOG" in list(g_sh["keys"])


def test_order_and_counts_sharded(setup):
    data, dev, spt, _ = setup
    o_dev = order_records(dev, "qty", descending=True, limit=25)
    o_sh = order_records(spt, "qty", descending=True, limit=25)
    assert list(o_dev) == list(o_sh)
    v_dev = value_counts(dev, "sym")
    v_sh = value_counts(spt, "sym")
    assert list(v_dev["keys"]) == list(v_sh["keys"])
    assert list(v_dev["count"]) == list(v_sh["count"])


def test_join_sharded_left_side(setup):
    data, dev, spt, _ = setup
    # dimension table: one row per symbol
    dim = b"sym,sector\nAAPL,tech\nGOOG,ads\nMSFT,tech\nTSLA,cars\n"
    f_dev = join_typed(dev, dim, "sym", columns=["id", "sym", "qty"])
    f_sh = join_typed(spt, dim, "sym", columns=["id", "sym", "qty"])
    _assert_frames_equal(f_dev, f_sh)
    assert "sector" in f_sh.names


def test_sql_over_sharded_tapes(setup):
    """The SQL front-end runs over mesh-sharded tapes unchanged — the
    whole statement executes where the shards live, matching the
    single-device result."""
    from csv_simd_tpu.sql import sql

    data, dev, spt, st_ = setup
    q = ("SELECT sym, COUNT(*), SUM(qty) AS tot FROM t "
         "WHERE qty > 0 GROUP BY sym HAVING COUNT(*) >= 5 "
         "ORDER BY tot DESC")
    r_dev = sql(q, dev)
    r_sh = sql(q, spt)
    r_st = sql(q, st_)
    for r in (r_sh, r_st):
        assert list(r_dev["sym"]) == list(r["sym"])
        assert r_dev["count"].tolist() == r["count"].tolist()
        assert r_dev["tot"].tolist() == r["tot"].tolist()
    f_dev = sql("SELECT id, qty FROM t WHERE sym = 'TSLA' "
                "ORDER BY qty DESC LIMIT 7", dev)
    f_sh = sql("SELECT id, qty FROM t WHERE sym = 'TSLA' "
               "ORDER BY qty DESC LIMIT 7", spt)
    _assert_frames_equal(f_dev, f_sh)


def test_sql_window_and_setops_over_sharded_tape(setup, monkeypatch):
    """Round-4 surface composes with sharding: window functions and
    set ops through sql() over the mesh-sharded offsets-free tape match
    the single-device tape exactly (the frame materializes via
    shard_map gathers; the window/setop executors then run on device)."""
    import csv_simd_tpu.setops as SO
    import csv_simd_tpu.window as W
    from csv_simd_tpu.sql import sql

    data, dev, spt, _st = setup
    monkeypatch.setattr(W, "DEVICE_WINDOW_MIN_ROWS", 1)
    monkeypatch.setattr(SO, "DEVICE_SETOP_MIN_ROWS", 1)
    q = ("SELECT id, SUM(qty) OVER (PARTITION BY sym ORDER BY qty) AS s,"
         " ROW_NUMBER() OVER (PARTITION BY sym ORDER BY qty) AS rn"
         " FROM t")
    sch = {"id": "int32", "qty": "int32"}
    a = sql(q, spt, schema=sch)
    b = sql(q, dev, schema=sch)
    for nm in ("id", "s", "rn"):
        assert [v for v in a[nm]] == [v for v in b[nm]], nm

    q2 = ("SELECT id, qty FROM t WHERE qty > 100 "
          "EXCEPT SELECT id, qty FROM t WHERE qty > 2000")
    a2 = sql(q2, spt, schema=sch)
    b2 = sql(q2, dev, schema=sch)
    assert a2["id"].tolist() == b2["id"].tolist()
    assert a2["qty"].tolist() == b2["qty"].tolist()
    assert len(a2) > 0
