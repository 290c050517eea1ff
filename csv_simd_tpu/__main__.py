"""CLI: index, inspect and serve CSV files.

The reference's binary is a stub that prints "not required"
(bin/main.rs:11-14); this is the real thing.

  python -m csv_simd_tpu info FILE [--backend B]
  python -m csv_simd_tpu field FILE RECORD FIELD [--backend B]
  python -m csv_simd_tpu record FILE RECORD [--backend B]
  python -m csv_simd_tpu column FILE FIELD [--limit N] [--type T]
      # --type int32|float32|float32exp|date|decimal parses on device
      # (decimal: exact scaled int64, --scale digits)
  python -m csv_simd_tpu frame FILE [--schema col=type,...] [--columns ...]
      # typed batch export (read_typed): schema inferred when omitted
  python -m csv_simd_tpu index FILE -o OUT.npz     # build + save artifact
  python -m csv_simd_tpu serve FILE --from-index OUT.npz RECORD FIELD
  python -m csv_simd_tpu stats FILE COL            # device aggregates
  python -m csv_simd_tpu describe FILE             # per-column summary
  python -m csv_simd_tpu groupby FILE KEY VALUE [--having EXPR]
  python -m csv_simd_tpu values FILE COL           # value_counts
  python -m csv_simd_tpu join LEFT RIGHT ON [--how inner|left|right|
      outer|semi|anti]
  python -m csv_simd_tpu sql "SELECT ... FROM t ..." FILE [FILE2]
  python -m csv_simd_tpu json-index FILE           # JSON experiment

The analytic commands (stats, describe, groupby, values, frame) accept
SEVERAL files: they form one logical corpus (CsvCorpus) and aggregate
per file with an associative combine, e.g.
  python -m csv_simd_tpu stats part1.csv part2.csv qty
  python -m csv_simd_tpu groupby part*.csv sym qty

Global flags: --backend {auto,golden,jnp,native}, --decode
(RFC-4180 unquote/unescape/trim on output), --validate-utf8,
--platform {auto,cpu,gpu}.
"""

from __future__ import annotations

import argparse
import sys


def _col_key(text: str):
    """Column reference from the command line: an integer is a column
    index, anything else a header name."""
    try:
        return int(text)
    except ValueError:
        return text


def _parse_one_pred(e):
    import re

    m = re.match(r"^\s*(\S+)\s+between\s+(\S+)\s+(\S+)\s*$", e)
    if m:
        return (_col_key(m.group(1)), "between",
                (m.group(2), m.group(3)))
    m = re.match(r"^\s*(\S+)\s+in\s+(\S+)\s*$", e)
    if m:
        return (_col_key(m.group(1)), "in", m.group(2).split("|"))
    m = re.match(
        r"^\s*(\S+)\s+(startswith|endswith|contains)\s+(.+?)\s*$", e
    )
    if m:
        return (_col_key(m.group(1)), m.group(2), m.group(3))
    m = re.match(r"^\s*(\S+)\s+(isnull|notnull)\s*$", e)
    if m:
        return (_col_key(m.group(1)), m.group(2), None)
    m = re.match(r"^\s*(\S+?)\s*(==|!=|<=|>=|<|>)\s*(.+?)\s*$", e)
    if m:
        return (_col_key(m.group(1)), m.group(2), m.group(3))
    raise SystemExit(f"cannot parse --where expression: {e!r}")


def _parse_where(exprs):
    """['qty > 100', 'sym in AAPL|MSFT', 'day between A B'] ->
    query predicates. Each --where expression may chain alternatives
    with ' or ' ('qty > 100 or sym == AAPL'); the expressions
    themselves AND together. Returns None when exprs is falsy."""
    if not exprs:
        return None
    preds = []
    for e in exprs:
        alts = [s for s in e.split(" or ") if s.strip()]
        if len(alts) > 1:
            try:
                preds.append(("or", [_parse_one_pred(a) for a in alts]))
                continue
            except SystemExit:
                # ' or ' was part of a VALUE (e.g. "desc contains
                # red or blue"): fall back to one predicate
                pass
        preds.append(_parse_one_pred(e))
    return preds


class _DecodedCli:
    """Tape facade routing value reads through the stage-2 decoder."""

    def __init__(self, tape, view):
        self._tape, self._view = tape, view

    def __getattr__(self, name):
        return getattr(self._tape, name)

    def __repr__(self):
        return repr(self._tape)

    def seek_field(self, r, f):
        return self._view.seek_field(r, f)

    def column(self, f):
        return self._view.column(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="csv_simd_tpu")
    p.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "golden", "jnp", "native"],
    )
    p.add_argument(
        "--decode", action="store_true",
        help="unquote/unescape/trim served values (stage-2 decode)",
    )
    p.add_argument(
        "--validate-utf8", action="store_true",
        help="refuse files that are not valid UTF-8",
    )
    p.add_argument(
        "--metrics", action="store_true",
        help="print per-stage timing/throughput spans to stderr on exit",
    )
    p.add_argument(
        "--platform", default="auto", choices=["auto", "cpu", "gpu"],
        help="run on this JAX platform; 'gpu' fails when no GPU is "
        "present (default: JAX's own choice)",
    )
    p.add_argument(
        "--delimiter", default=None, metavar="CHAR",
        help="field delimiter byte (default ','; the reference "
        "hardcoded this, tape.rs:216)",
    )
    p.add_argument(
        "--quote", default=None, metavar="CHAR",
        help="quote byte (default '\"')",
    )
    p.add_argument(
        "--header-quotes", action="store_true",
        help="parse the header quote-aware: quoted header names may "
        "contain delimiters/newlines (default: the reference's raw "
        "split, tape.rs:258-262)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("info")
    sp.add_argument("file")

    sp = sub.add_parser("field")
    sp.add_argument("file")
    sp.add_argument("record", type=int)
    sp.add_argument("field", type=int)

    sp = sub.add_parser("record")
    sp.add_argument("file")
    sp.add_argument("record", type=int)

    sp = sub.add_parser("column")
    sp.add_argument("file")
    sp.add_argument("field", type=int)
    sp.add_argument("--limit", type=int, default=20)
    sp.add_argument(
        "--type", default="bytes",
        choices=["bytes", "int32", "float32", "float32exp", "date",
                 "datetime", "decimal"],
        help="parse the column on device (typed jnp arrays; 'decimal' "
        "is exact scaled int64, see --scale)",
    )
    sp.add_argument(
        "--scale", type=int, default=2,
        help="decimal scale: values are int64 * 10^-scale (default 2)",
    )
    sp.add_argument(
        "--unit", default="s", choices=["s", "ms", "us"],
        help="datetime epoch unit (default s)",
    )

    sp = sub.add_parser("index")
    sp.add_argument("file")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument(
        "--format", default="offsets", choices=["offsets", "packed_seq"],
        help="offsets: int64 tape artifact; packed_seq: 1-bit/byte "
        "offsets-free bitmask (serves via PackedDeviceTape or load_tape)",
    )

    sp = sub.add_parser("serve")
    sp.add_argument("file")
    sp.add_argument("--from-index", required=True)
    sp.add_argument("record", type=int)
    sp.add_argument("field", type=int)

    sp = sub.add_parser(
        "frame",
        help="typed batch export: infer (or take) a schema and print "
        "columns parsed on device (read_typed endpoint)",
    )
    sp.add_argument("file", nargs="+",
                    help="CSV file(s); several files form one corpus")
    sp.add_argument(
        "--schema", default=None,
        help="comma list col=type (type: int32|float32|float|date|"
        "decimal[:scale]|str|bytes); default: infer from a row sample",
    )
    sp.add_argument(
        "--columns", default=None,
        help="comma list of column names to include (inference mode)",
    )
    sp.add_argument("--limit", type=int, default=10)
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
        help="serving tape kind: offsets index or offsets-free packed",
    )
    sp.add_argument(
        "--where", action="append", default=None, metavar="EXPR",
        help="row filter, repeatable (AND): 'col OP value' with OP in "
        "== != < <= > >=, or 'col between LO HI', 'col in A|B|C', "
        "'col startswith|endswith|contains TEXT', 'col isnull|notnull' "
        "(typed-parse failure); evaluated on device before "
        "materialization",
    )
    sp.add_argument(
        "--order-by", default=None, metavar="COLS",
        help="sort rows by these comma-separated columns (device sort "
        "for typed columns; parse-failures last); prefix a column "
        "with '-' for per-column descending (e.g. sym,-qty)",
    )
    sp.add_argument("--desc", action="store_true",
                    help="order-by descending (all columns)")
    sp.add_argument(
        "--head", type=int, default=None, metavar="N",
        help="materialize only the first N rows after where/order-by "
        "(top-k read; --limit only limits printing)",
    )

    sp = sub.add_parser(
        "values",
        help="distinct values of a column with row counts (device "
        "grouping for typed columns)",
    )
    sp.add_argument("file", nargs="+",
                    help="CSV file(s); several files form one corpus")
    sp.add_argument("column", help="column name or index")
    sp.add_argument(
        "--type", dest="spec", default=None,
        help="column type spec; default: infer",
    )
    sp.add_argument("--where", action="append", default=None,
                    metavar="EXPR", help="row filter (see frame --where)")
    sp.add_argument("--limit", type=int, default=30)
    sp.add_argument("--by-count", action="store_true",
                    help="print most-frequent first (default: key order)")
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "stats",
        help="aggregate a column on device (count/sum/min/max/mean "
        "without materializing values on host)",
    )
    sp.add_argument("file", nargs="+",
                    help="CSV file(s); several files form one corpus")
    sp.add_argument("column", help="column name or index")
    sp.add_argument(
        "--type", dest="spec", default=None,
        help="column type spec (int32|float32|float|date|datetime[:u]|"
        "decimal[:scale]); default: infer",
    )
    sp.add_argument("--where", action="append", default=None,
                    metavar="EXPR", help="row filter (see frame --where)")
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "describe",
        help="per-column summary: count/sum/min/max/mean/std + "
        "quantiles for numeric columns, distinct counts for text",
    )
    sp.add_argument("file", nargs="+",
                    help="CSV file(s); several files form one corpus")
    sp.add_argument("--columns", default=None,
                    help="comma list of columns (default all)")
    sp.add_argument("--where", action="append", default=None,
                    metavar="EXPR", help="row filter (see frame --where)")
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "groupby",
        help="device group-by: sort + segment-reduce a value column by "
        "a key column; only per-group results leave the device",
    )
    sp.add_argument("file", nargs="+",
                    help="CSV file(s); several files form one corpus")
    sp.add_argument(
        "key",
        help="key column (name or index); comma list for a composite "
        "key, e.g. sym,day",
    )
    sp.add_argument(
        "value",
        help="value column (name or index); comma list aggregates "
        "several columns against ONE key sort",
    )
    sp.add_argument("--where", action="append", default=None,
                    metavar="EXPR", help="row filter (see frame --where)")
    sp.add_argument(
        "--having", action="append", default=None, metavar="EXPR",
        help="group filter on aggregates (SQL HAVING): with ONE value "
        "column use bare targets ('count >= 10', 'sum > 100', "
        "'mean between 1 5'); with several value columns prefix the "
        "column ('qty.sum > 100'); repeatable (AND), ' or ' chains "
        "within one expression",
    )
    sp.add_argument("--limit", type=int, default=20)
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "join",
        help="equi-join two CSVs on a key column (device sort-merge) "
        "and print the joined typed frame",
    )
    sp.add_argument("left")
    sp.add_argument("right")
    sp.add_argument("on", help="key column (left name; also right "
                    "unless --right-on); comma list for a composite "
                    "key, e.g. sym,day")
    sp.add_argument("--right-on", default=None,
                    help="right-side key column(s), comma list for "
                    "composite")
    sp.add_argument(
        "--how", default="inner",
        choices=["inner", "left", "right", "outer", "semi", "anti"],
    )
    sp.add_argument("--columns", default=None,
                    help="comma list of left columns (default all)")
    sp.add_argument("--right-columns", default=None,
                    help="comma list of right columns (default all)")
    sp.add_argument("--where", action="append", default=None,
                    metavar="EXPR", help="left-side row filter")
    sp.add_argument("--right-where", action="append", default=None,
                    metavar="EXPR", help="right-side row filter")
    sp.add_argument("--limit", type=int, default=10)
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "sql",
        help="run a SQL SELECT over CSV file(s) — WHERE pushes down to "
        "device masks, GROUP BY/ORDER BY run the device relational "
        "layer (see csv_simd_tpu.sql for the grammar)",
    )
    sp.add_argument("query", help="SELECT statement; bare FROM/JOIN "
                    "names bind to the FILE argument(s) in order, or "
                    "quote file paths directly in the SQL")
    sp.add_argument("file", nargs="*",
                    help="CSV file(s) bound to the statement's bare "
                    "table names in order")
    sp.add_argument(
        "--schema", default=None, metavar="COL=SPEC,...",
        help="type overrides for the FROM table (e.g. qty=int32)",
    )
    sp.add_argument(
        "--right-schema", default=None, metavar="COL=SPEC,...",
        help="type overrides for the JOINed table",
    )
    sp.add_argument("--limit", type=int, default=20,
                    help="rows to display (does not change the query)")
    sp.add_argument(
        "--engine", default="offsets", choices=["offsets", "packed"],
    )

    sp = sub.add_parser(
        "json-index",
        help="JSON structural offsets + nesting depths (escape-aware)",
    )
    sp.add_argument("file")
    sp.add_argument("--limit", type=int, default=30)

    args = p.parse_args(argv)

    # pin the platform before anything touches jax.devices()
    if args.platform != "auto":
        from .utils.backend import select_platform

        select_platform(args.platform)

    from . import create
    from .errors import StructureError

    dialect = None
    if args.delimiter or args.quote or args.header_quotes:
        from .config import Dialect

        def _byte(s, what):
            b = s.encode()
            if len(b) != 1:
                raise SystemExit(f"--{what} must be a single byte")
            return b[0]

        dialect = Dialect(
            delimiter=(_byte(args.delimiter, "delimiter")
                       if args.delimiter else 0x2C),
            quote=_byte(args.quote, "quote") if args.quote else 0x22,
            header_quotes=args.header_quotes,
        )

    def _source(files):
        """One path stays a path (engine/backend flags apply); several
        build a CsvCorpus — the analytic commands then map per file and
        combine associatively (query.py corpus branches)."""
        if len(files) == 1:
            return files[0]
        from .corpus_api import CsvCorpus

        return CsvCorpus(files, backend=args.backend,
                         dialect=dialect,
                         validate_utf8=args.validate_utf8)

    try:
        if args.cmd == "stats":
            from .query import column_stats

            key = _col_key(args.column)
            st = column_stats(
                _source(args.file), key, args.spec, backend=args.backend,
                engine=args.engine, dialect=dialect,
                where=_parse_where(args.where),
            )
            import json

            print(json.dumps({
                "column": args.column, "count": st.count,
                "ok_count": st.ok_count, "sum": st.sum,
                "min": st.min, "max": st.max, "mean": st.mean,
            }))
            return 0
        if args.cmd == "describe":
            from .query import describe

            cols = ([_col_key(c) for c in args.columns.split(",")]
                    if args.columns else None)
            rep = describe(
                _source(args.file), columns=cols,
                backend=args.backend, engine=args.engine,
                dialect=dialect, where=_parse_where(args.where),
            )
            for name, e in rep.items():
                st = e["stats"]
                if "quantiles" in e:
                    q25, q50, q75 = e["quantiles"]
                    print(
                        f"  {name} [{e['type']}]: n={st.count} "
                        f"ok={st.ok_count} mean={st.mean} "
                        f"std={st.std and round(st.std, 6)} "
                        f"min={st.min} p25={q25} p50={q50} p75={q75} "
                        f"max={st.max}"
                    )
                else:
                    print(
                        f"  {name} [{e['type']}]: n={st.count} "
                        f"distinct={e['distinct']}"
                    )
            return 0
        if args.cmd == "groupby":
            from .query import groupby_typed

            key_cols = [_col_key(k) for k in args.key.split(",")]
            val_cols = [_col_key(v) for v in args.value.split(",")]
            g = groupby_typed(
                _source(args.file),
                key_cols if len(key_cols) > 1 else key_cols[0],
                val_cols if len(val_cols) > 1 else val_cols[0],
                backend=args.backend, engine=args.engine,
                dialect=dialect, where=_parse_where(args.where),
                having=_parse_where(args.having),
            )
            composite = isinstance(g["keys"], list)
            n = len(g["keys"][0]) if composite else len(g["keys"])
            print(f"{n} groups (key ascending)")
            for i in range(min(n, args.limit)):
                k = (",".join(str(a[i]) for a in g["keys"])
                     if composite else g["keys"][i])
                if "aggs" in g:
                    parts = " ".join(
                        f"{name}(sum={a['sum'][i]} min={a['min'][i]} "
                        f"max={a['max'][i]} n={a['count'][i]})"
                        for name, a in g["aggs"].items()
                    )
                    print(f"  {k}: rows={g['count'][i]} {parts}")
                else:
                    print(
                        f"  {k}: sum={g['sum'][i]} "
                        f"min={g['min'][i]} max={g['max'][i]} "
                        f"count={g['count'][i]}"
                    )
            return 0
        if args.cmd == "join":
            from .join import join_typed

            on_cols = [_col_key(k) for k in args.on.split(",")]
            ron_cols = ([_col_key(k) for k in args.right_on.split(",")]
                        if args.right_on else None)
            # composite whenever EITHER side lists several columns, so
            # a mismatched count reaches join_records's check instead
            # of silently joining on the first right column only
            composite = (len(on_cols) > 1
                         or (ron_cols is not None and len(ron_cols) > 1))
            fr = join_typed(
                args.left, args.right,
                on_cols if composite else on_cols[0],
                right_on=(
                    None if ron_cols is None
                    else (ron_cols if composite else ron_cols[0])
                ),
                how=args.how,
                columns=(args.columns.split(",") if args.columns
                         else None),
                right_columns=(args.right_columns.split(",")
                               if args.right_columns else None),
                where=_parse_where(args.where),
                right_where=_parse_where(args.right_where),
                backend=args.backend, engine=args.engine,
                dialect=dialect,
            )
            print(fr)
            for name in fr.names:
                vals = fr[name][: args.limit]
                print(f"  {name} [{fr.schema[name].type}]: "
                      + ", ".join(str(v) for v in vals))
            return 0
        if args.cmd == "sql":
            from .sql import sql as run_sql
            from .sql import table_refs

            def _sch(text):
                if not text:
                    return None
                return dict(kv.split("=", 1) for kv in text.split(","))

            refs = table_refs(args.query)
            if len(set(refs)) != len(refs) and len(args.file) > 1:
                raise SystemExit(
                    "the statement uses the same bare table name for "
                    "both join sides; quote the file paths in the SQL "
                    "instead (FROM 'a.csv' JOIN 'b.csv' ...)"
                )
            if len(args.file) > len(set(refs)):
                raise SystemExit(
                    f"{len(args.file)} files for {len(set(refs))} bare "
                    "table name(s) in the statement"
                )
            tables = dict(zip(refs, args.file))
            fr = run_sql(
                args.query,
                args.file[0] if args.file else None,
                tables=tables or None,
                schema=_sch(args.schema),
                right_schema=_sch(args.right_schema),
                backend=args.backend, engine=args.engine,
                dialect=dialect,
            )
            if isinstance(fr, str):  # EXPLAIN: the plan text
                print(fr)
                return 0
            print(fr)
            for name in fr.names:
                vals = fr[name][: args.limit]
                t = fr.schema[name].type
                print(f"  {name} [{t}]: "
                      + ", ".join(str(v) for v in vals))
            return 0
        if args.cmd == "values":
            from .query import value_counts

            vc = value_counts(
                _source(args.file), _col_key(args.column), args.spec,
                backend=args.backend, engine=args.engine,
                dialect=dialect, where=_parse_where(args.where),
            )
            keys, counts = vc["keys"], vc["count"]
            order = (
                list(reversed(counts.argsort(kind="stable").tolist()))
                if args.by_count else range(len(keys))
            )
            print(f"{len(keys)} distinct values")
            for i in list(order)[: args.limit]:
                print(f"  {keys[i]}: {counts[i]}")
            return 0
        if args.cmd == "frame":
            from .frame import read_typed

            schema = None
            if args.schema:
                schema = dict(
                    kv.split("=", 1) for kv in args.schema.split(",")
                )
            cols = args.columns.split(",") if args.columns else None
            order_keys, order_desc = None, False
            if args.order_by:
                raw = args.order_by.split(",")
                order_keys = [_col_key(k.lstrip("-")) for k in raw]
                order_desc = [args.desc or k.startswith("-")
                              for k in raw]
                if len(order_keys) == 1:
                    order_keys, order_desc = order_keys[0], order_desc[0]
            multi = len(args.file) > 1
            if multi and args.engine != "offsets":
                raise SystemExit(
                    "--engine applies to single files; a multi-file "
                    "corpus serves through its per-file device tapes"
                )
            fr = read_typed(
                _source(args.file), schema, columns=cols,
                backend=args.backend,
                engine=args.engine, dialect=dialect,
                # a corpus validates at build time (_source passes the
                # flag to CsvCorpus); re-validating per read would raise
                validate_utf8=args.validate_utf8 and not multi,
                where=_parse_where(args.where),
                order_by=order_keys, descending=order_desc,
                limit=args.head,
            )
            print(fr)
            for name in fr.names:
                c = fr.schema[name]
                t = f"{c.type}:{c.scale}" if c.type == "decimal" else c.type
                vals = fr[name][: args.limit]
                okm = fr.ok(name)

                def _show(v):
                    if isinstance(v, bytes):
                        return v.decode("utf-8", "replace")
                    if c.type == "decimal" and c.scale > 0:
                        q, r = divmod(abs(int(v)), 10**c.scale)
                        return f"{'-' if int(v) < 0 else ''}{q}.{r:0{c.scale}d}"
                    return str(v)

                shown = [
                    "<not ok>" if okm is not None and not okm[i]
                    else _show(v)
                    for i, v in enumerate(vals)
                ]
                print(f"  {name} [{t}]: {', '.join(shown)}")
            return 0
        if args.cmd == "json-index":
            import numpy as np

            from .experiments.json_device import json_depths_device

            with open(args.file, "rb") as f:
                raw = f.read()
            import jax.numpy as jnp

            # one device pass: the depths call already returns the
            # structural mask, so the offsets are its flatnonzero
            mask, depth = json_depths_device(
                jnp.asarray(np.frombuffer(raw, dtype=np.uint8))
            )
            offs = np.flatnonzero(np.asarray(mask))
            depth = np.asarray(depth)
            print(f"{len(offs)} structural chars")
            for o in offs[: args.limit]:
                ch = chr(raw[o])
                print(f"  @{int(o):>8d} {ch!r} depth={int(depth[o])}")
            return 0
        if args.cmd == "serve":
            from .artifact import load_tape

            with open(args.file, "rb") as f:
                data = f.read()
            tape = load_tape(args.from_index, data)
            val = tape.seek_field(args.record, args.field)
            print(val.decode("utf-8", "replace") if val is not None else "<out of range>")
            return 0

        if args.cmd == "index" and args.format == "packed_seq":
            # build the packed artifact directly — no offsets tape needed
            from .offsetfree import PackedDeviceTape

            with open(args.file, "rb") as f:
                raw = f.read()
            from .config import DEFAULT_DIALECT

            pt = PackedDeviceTape(raw, dialect or DEFAULT_DIALECT)
            pt.save(args.out)
            print(
                f"wrote {args.out}: packed_seq bitmask, "
                f"{int(pt.record_cnt)} records"
            )
            return 0
        tape = create(
            args.file, dialect=dialect, backend=args.backend,
            validate_utf8=args.validate_utf8,
        )
        if args.decode:
            from .decode import DecodedView

            tape = _DecodedCli(tape, DecodedView(tape))
        if args.cmd == "info":
            print(tape)
            print("header:", ", ".join(tape.header_names()))
            print("data records:", tape.num_data_records)
        elif args.cmd == "field":
            val = tape.seek_field(args.record, args.field)
            print(val.decode("utf-8", "replace") if val is not None else "<out of range>")
        elif args.cmd == "record":
            val = tape.seek_record(args.record)
            print(val.decode("utf-8", "replace") if val is not None else "<out of range>")
        elif args.cmd == "column":
            if args.type != "bytes":
                from .device_tape import DeviceTape

                dt = DeviceTape.from_tape(
                    tape._tape if isinstance(tape, _DecodedCli) else tape
                )
                parse = {
                    "int32": dt.column_int32,
                    "float32": dt.column_float32,
                    "float32exp": dt.column_float32_exp,
                    "date": dt.column_date_days,
                }.get(args.type)
                if args.type == "decimal":
                    vals, ok = dt.column_decimal64(args.field, args.scale)
                elif args.type == "datetime":
                    vals, ok = dt.column_datetime64(args.field, args.unit)
                else:
                    vals, ok = parse(args.field)
                import numpy as np

                if args.type == "datetime":
                    vals = np.asarray(vals).astype(
                        f"datetime64[{args.unit}]"
                    )
                for v, o in list(zip(np.asarray(vals), np.asarray(ok)))[
                    : args.limit
                ]:
                    if not o:
                        print("<not ok>")
                    elif args.type == "datetime":
                        print(str(v))
                    elif args.type == "decimal" and args.scale > 0:
                        q, r = divmod(abs(int(v)), 10**args.scale)
                        sign = "-" if int(v) < 0 else ""
                        print(f"{sign}{q}.{r:0{args.scale}d}")
                    elif args.type.startswith("float"):
                        print(float(v))
                    else:
                        print(int(v))
            else:
                for v in tape.column(args.field)[: args.limit]:
                    print(v.decode("utf-8", "replace"))
        elif args.cmd == "index":
            from .artifact import save_tape

            save_tape(tape, args.out)
            print(f"wrote {args.out}: {len(tape.index)} index entries")
    except StructureError as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        if getattr(args, "metrics", False):
            from .utils.metrics import GLOBAL

            print(GLOBAL.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    from .utils.backend import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
