"""Typed batch export: CSV file -> named NumPy column arrays.

The reference stops at serving raw field `&str`s one at a time
(record_source.rs:104-140); every downstream consumer re-parses text on
the host. On the device the end-to-end story is better: build the structural
index with the fused scan, then turn whole columns into typed arrays
with the device parsers (device_tape.py) — the bytes never leave HBM
until they are numbers. `read_typed` is that productized endpoint:

    frame = read_typed("trades.csv", {"price": "decimal:2",
                                      "qty": "int32",
                                      "day": "date"})
    frame["price"]   # (N,) int64, exact cents
    frame.ok("qty")  # (N,) bool parse-validity mask

Column types: int32, float32 (no exponent), float (float32 + exponent
notation), date (ISO -> numpy datetime64[D]), datetime[:unit] (ISO
timestamp -> datetime64[s|ms|us], exact epoch integers), decimal[:scale]
(EXACT scaled int64), str (stage-2 decoded text: trim/unquote/
unescape), bytes (raw field bytes). A schema of None infers types from
a row sample
(`infer_schema`). Gather windows are auto-sized from the true column
lengths (bucketed to limit recompiles), so no manual max_len tuning.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np

from .errors import InvalidCsvFormat

#: parser-minimum gather windows per type (parsers flag ok=False when a
#: field exceeds the window, so the window must cover the longest field)
_TYPE_MIN_LEN = {
    "int32": 16,
    "float32": 24,
    "float": 32,
    "date": 16,
    "datetime": 32,
    "decimal": 32,
    "str": 16,
    "bytes": 16,
}

_TYPES = tuple(_TYPE_MIN_LEN)


@dataclasses.dataclass(frozen=True)
class Col:
    """Resolved per-column spec. Usually written as a string —
    "decimal:4" == Col("decimal", scale=4), "str:128" == Col("str",
    max_len=128) — and normalized through `parse_spec`."""

    type: str
    max_len: Optional[int] = None  # gather window; None = auto-size
    scale: int = 2                 # decimal only: fixed-point digits
    trim: bool = True              # str only: strip outer spaces
    unit: str = "s"                # datetime only: "s" | "ms" | "us"

    def __post_init__(self):
        if self.type not in _TYPES:
            raise ValueError(
                f"unknown column type {self.type!r}; one of {_TYPES}"
            )
        if self.type == "datetime" and self.unit not in ("s", "ms", "us"):
            raise ValueError(
                f"datetime unit must be s/ms/us, got {self.unit!r}"
            )


def parse_spec(spec: Union[str, Col]) -> Col:
    if isinstance(spec, Col):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"column spec must be str or Col, got {type(spec)}")
    name, _, arg = spec.partition(":")
    name = name.strip().lower()
    if name == "decimal":
        return Col("decimal", scale=int(arg) if arg else 2)
    if name == "datetime":
        return Col("datetime", unit=arg or "s")
    if arg:
        return Col(name, max_len=int(arg))
    return Col(name)


class Frame:
    """Columnar result of `read_typed`: an ordered name -> array mapping
    plus per-column parse-validity masks and the resolved schema."""

    def __init__(self, names: List[str], columns: Dict[str, np.ndarray],
                 ok: Dict[str, Optional[np.ndarray]],
                 schema: Dict[str, Col], num_records: int):
        self.names = names
        self._columns = columns
        self._ok = ok
        self.schema = schema
        self.num_records = num_records
        #: record ids behind each row (set by read_typed; None for
        #: corpus concatenations, where per-file ids would be ambiguous)
        self.records: Optional[np.ndarray] = None
        #: device-resident parses of numeric columns (read_typed only:
        #: {name: (dev_vals, dev_ok)}) — transforms (take/slice/joins)
        #: construct fresh Frames and so DROP these, which is what
        #: keeps them from ever going stale
        self._dev: Dict[str, tuple] = {}

    def __getitem__(self, name: str):
        return self._columns[name]

    def ok(self, name: str) -> Optional[np.ndarray]:
        """Parse-validity mask for a typed column (None for bytes/str,
        which always materialize)."""
        return self._ok[name]

    def __len__(self) -> int:
        return self.num_records

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def keys(self) -> Iterable[str]:
        return list(self.names)

    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def to_pandas(self):
        """Optional pandas export (pandas must be importable). Not-ok
        rows of typed columns become NaN/NaT via the masks."""
        import pandas as pd  # noqa: deferred optional dep

        out = {}
        for n in self.names:
            col = self._columns[n]
            okm = self._ok[n]
            if okm is not None and not okm.all():
                s = pd.Series(col)
                out[n] = s.mask(~okm)
            else:
                out[n] = pd.Series(col)
        return pd.DataFrame(out)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{self.schema[n].type}" for n in self.names
        )
        return f"Frame(records={self.num_records}, columns=[{cols}])"

    def take(self, indices) -> "Frame":
        """Row-subset/permutation view materialized as a new Frame (the
        host analog of a gather: ORDER BY / LIMIT over an already-read
        corpus frame reduce to a take of the sort permutation)."""
        idx = np.asarray(indices, np.int64)
        cols = {n: self._columns[n][idx] for n in self.names}
        oks = {
            n: (self._ok[n][idx] if self._ok[n] is not None else None)
            for n in self.names
        }
        fr = Frame(list(self.names), cols, oks, dict(self.schema),
                   int(idx.size))
        if self.records is not None:
            fr.records = self.records[idx]
        return fr

    def to_csv(self, path=None, *, dialect=None, header: bool = True):
        """CSV bytes of this frame (see write_csv)."""
        return write_csv(self, path, dialect=dialect, header=header)

    # -- persistence: typed columnar artifact ("index+parse once,
    #    serve typed forever" — extends artifact.py's checkpoint story
    #    from offsets to parsed columns) --

    def save(self, path) -> None:
        """Write the frame as a .npz columnar artifact. Text columns
        (object arrays of str/bytes) are stored as a concatenated
        uint8 buffer + int64 offsets (no pickling, NUL-safe; fixed
        '|S' dtypes would strip embedded/trailing NULs)."""
        import json

        payload = {}
        meta = {"names": self.names, "num_records": self.num_records,
                "schema": {n: dataclasses.asdict(self.schema[n])
                           for n in self.names}}
        for n in self.names:
            col = self._columns[n]
            if col.dtype == object:
                bufs = [
                    v.encode("utf-8", "surrogateescape")
                    if isinstance(v, str) else bytes(v)
                    for v in col
                ]
                lens = np.array([len(b) for b in bufs], np.int64)
                payload[f"text_{n}"] = np.frombuffer(
                    b"".join(bufs), np.uint8
                )
                payload[f"offs_{n}"] = np.concatenate(
                    [[0], np.cumsum(lens)]
                ).astype(np.int64)
            else:
                payload[f"col_{n}"] = col
            okm = self._ok[n]
            if okm is not None:
                payload[f"ok_{n}"] = okm
        if self.records is not None:
            payload["records"] = self.records
        payload["meta"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8
        )
        with open(path, "wb") as f:
            np.savez(f, **payload)

    @classmethod
    def load(cls, path) -> "Frame":
        """Read a frame artifact written by save()."""
        import json

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            names = meta["names"]
            schema = {n: Col(**meta["schema"][n]) for n in names}
            cols: Dict[str, np.ndarray] = {}
            oks: Dict[str, Optional[np.ndarray]] = {}
            for n in names:
                if f"col_{n}" in z:
                    cols[n] = z[f"col_{n}"]
                else:
                    buf = z[f"text_{n}"].tobytes()
                    offs = z[f"offs_{n}"]
                    vals = [buf[offs[i]:offs[i + 1]]
                            for i in range(len(offs) - 1)]
                    if schema[n].type == "str":
                        vals = [v.decode("utf-8", "surrogateescape")
                                for v in vals]
                    cols[n] = np.array(vals, dtype=object)
                oks[n] = z[f"ok_{n}"] if f"ok_{n}" in z else None
            fr = cls(names, cols, oks, schema, meta["num_records"])
            if "records" in z:
                fr.records = z["records"]
        return fr


def _bucket(n: int) -> int:
    """Round a gather window up to a power of two (>=8) so repeated
    reads share jit cache entries instead of recompiling per length."""
    b = 8
    while b < n:
        b *= 2
    return b


def _resolve_tape(source, dialect, backend: str, engine: str,
                  validate_utf8: bool):
    """path/bytes/Tape/serving tape -> (serving tape, header names).

    A "serving tape" is anything exposing the TypedColumnsMixin
    contract (gather_fields + record_cnt/field_cnt): DeviceTape,
    PackedDeviceTape, and the mesh-sharded ShardedTape /
    ShardedPackedTape all qualify — passing a sharded tape runs the
    whole relational layer (filters, stats, group-by, joins, frames)
    across the device mesh."""
    from .device_tape import DeviceTape
    from .tape import Tape

    from .corpus_api import CsvCorpus

    if isinstance(source, CsvCorpus):
        # the corpus as one serving tape: per-file routed gathers (the
        # aggregate entry points shortcut with per-file map-reduce
        # BEFORE reaching here; this path serves id-addressed work
        # like joins and order_records)
        return source.serving_tape(), source.header_names()
    if hasattr(source, "gather_fields") and hasattr(source, "record_cnt"):
        names = getattr(getattr(source, "header", None), "names", None)
        if names is None:
            names = [f"c{i}" for i in range(int(source.field_cnt))]
        return source, names
    if isinstance(source, Tape):
        return DeviceTape.from_tape(source), source.header.names
    if isinstance(source, (bytes, bytearray, memoryview, np.ndarray)):
        if engine == "packed":
            from .config import DEFAULT_DIALECT
            from .offsetfree import PackedDeviceTape
            t = PackedDeviceTape(source, dialect or DEFAULT_DIALECT,
                                 validate_utf8=validate_utf8)
            return t, t.header.names
        from .api import create_from_bytes
        tape = create_from_bytes(source, dialect=dialect, backend=backend,
                                 validate_utf8=validate_utf8)
        return DeviceTape.from_tape(tape), tape.header.names
    # path
    if engine == "packed":
        from .api import create_packed
        t = create_packed(source, dialect, validate_utf8=validate_utf8)
        return t, t.header.names
    from .api import create
    tape = create(source, dialect=dialect, backend=backend,
                  validate_utf8=validate_utf8)
    return DeviceTape.from_tape(tape), tape.header.names


def _num_records(tape) -> int:
    n = getattr(tape, "num_data_records", None)
    if n is not None:
        return int(n)
    return max(int(tape.record_cnt) - 1, 0)


def _true_window(tape, field: int, minimum: int) -> int:
    """Gather window covering the column's longest field: one cheap
    probe gather (the returned lengths are TRUE lengths regardless of
    the probe's width), bucketed."""
    _, lengths, valid = tape.gather_column(field, max_len=8)
    ln = np.asarray(lengths)
    v = np.asarray(valid)
    longest = int(ln[v].max()) if v.any() else 0
    return _bucket(max(longest, minimum))


# -- schema inference ---------------------------------------------------

_INT_RE = re.compile(rb"^[+-]?\d+$")
_DEC_RE = re.compile(rb"^[+-]?(\d+\.\d*|\.\d+|\d+)$")
_FLOAT_RE = re.compile(rb"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_DATE_RE = re.compile(rb"^\d{4}-\d{2}-\d{2}$")
_DATETIME_RE = re.compile(
    rb"^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}:\d{2}(\.(\d+))?Z?$"
)


def _classify_values(vals: List[bytes]) -> Col:
    """Pick the narrowest type every sampled value satisfies. Empty
    fields are wildcards (missing data); all-empty -> str."""
    vals = [v.strip() for v in vals if v is not None]
    vals = [v for v in vals if v]
    if not vals:
        return Col("str")
    if all(_DATE_RE.match(v) for v in vals):
        return Col("date")
    dt = [_DATETIME_RE.match(v) for v in vals]
    if all(dt):
        frac = max(len(m.group(2) or b"") for m in dt)
        if frac <= 6:
            unit = "s" if frac == 0 else ("ms" if frac <= 3 else "us")
            return Col("datetime", unit=unit)
        return Col("str")  # sub-microsecond text: keep it exact as text
    if all(_INT_RE.match(v) for v in vals):
        in_i32 = True
        for v in vals:
            try:
                in_i32 &= -(2**31) <= int(v) <= 2**31 - 1
            except ValueError:  # pragma: no cover - regex precludes
                in_i32 = False
        if in_i32:
            return Col("int32")
        return Col("decimal", scale=0)  # exact int64 via the limb parser
    if all(_DEC_RE.match(v) for v in vals):
        frac = 0
        digits = 0
        for v in vals:
            body = v.lstrip(b"+-")
            if b"." in body:
                ip, fp = body.split(b".", 1)
                # the device parser counts TEXTUAL fractional digits
                # against the scale (exactness contract, no rounding),
                # so "1.50" needs scale >= 2 even though 1.5 == 1.50
                frac = max(frac, len(fp))
            else:
                ip = body
            digits = max(digits, len(ip.lstrip(b"0")) + frac)
        if digits <= 18 and frac <= 9:
            return Col("decimal", scale=frac)
        return Col("float")
    if all(_FLOAT_RE.match(v) for v in vals):
        return Col("float")
    return Col("str")


def infer_schema(tape, names: List[str], columns=None,
                 sample: int = 256) -> Dict[str, Col]:
    """Infer a per-column type from up to `sample` rows (evenly strided
    through the file so tail rows participate). Returns name -> Col."""
    n = _num_records(tape)
    sel = list(range(len(names))) if columns is None else columns
    take = min(n, sample)
    if take:
        recs = np.unique(
            (np.arange(take, dtype=np.int64) * max(n // take, 1))
            .clip(0, n - 1)
        ).astype(np.int32)
    else:
        recs = np.zeros(0, np.int32)
    schema: Dict[str, Col] = {}
    for f in sel:
        name = names[f]
        if not take:
            schema[name] = Col("str")
            continue
        w = _true_window(tape, f, 8)
        out, ln, v = tape.gather_fields(
            recs, np.full(recs.shape, f, np.int32), max_len=w
        )
        vals = tape.to_host_lists(out, ln, v)
        schema[name] = _classify_values(vals)
    return schema


# -- the endpoint -------------------------------------------------------

def _materialize(tape, field: int, col: Col, dialect, strict: bool,
                 name: str, records=None):
    window = col.max_len or _true_window(tape, field,
                                         _TYPE_MIN_LEN[col.type])
    if col.type == "int32":
        vals, okm = tape.column_int32(field, max_len=window,
                                      records=records)
    elif col.type == "float32":
        vals, okm = tape.column_float32(field, max_len=window,
                                        records=records)
    elif col.type == "float":
        vals, okm = tape.column_float32_exp(field, max_len=window,
                                            records=records)
    elif col.type == "decimal":
        vals, okm = tape.column_decimal64(field, scale=col.scale,
                                          max_len=window, records=records)
    elif col.type == "date":
        days, okm = tape.column_date_days(field, max_len=window,
                                          records=records)
        vals = np.asarray(days).astype("datetime64[D]")
    elif col.type == "datetime":
        epoch, okm = tape.column_datetime64(field, unit=col.unit,
                                            max_len=window,
                                            records=records)
        vals = np.asarray(epoch).astype(f"datetime64[{col.unit}]")
    elif col.type in ("str", "bytes"):
        recs = (np.arange(_num_records(tape), dtype=np.int32)
                if records is None else np.asarray(records, np.int32))
        if col.type == "str":
            out, ln, v = tape.gather_decoded(
                recs, np.full(recs.shape, field, np.int32),
                max_len=window, dialect=dialect, trim=col.trim,
            )
            raw = tape.to_host_lists(out, ln, v)
            return (
                np.array(
                    ["" if b is None
                     else b.decode("utf-8", errors="surrogateescape")
                     for b in raw],
                    dtype=object,
                ),
                None,
                None,
            )
        out, ln, v = tape.gather_fields(
            recs, np.full(recs.shape, field, np.int32), max_len=window
        )
        raw = tape.to_host_lists(out, ln, v)
        return np.array([b"" if b is None else b for b in raw],
                        dtype=object), None, None
    else:  # pragma: no cover - Col.__post_init__ precludes
        raise ValueError(col.type)
    # keep the DEVICE-resident parses for the numeric dtypes alongside
    # the host copies: downstream device executors (window/setops) can
    # then skip a host->device round trip of data that was already in
    # HBM (Frame transforms drop the handles — only fresh read_typed
    # output carries them, so they can never go stale)
    dev = (vals, okm) if col.type in ("int32", "float32", "float") \
        else None
    vals = np.asarray(vals)
    okm = np.asarray(okm, bool)
    if strict and not okm.all():
        bad = int(np.flatnonzero(~okm)[0])
        raise InvalidCsvFormat(
            f"column {name!r} row {bad} does not parse as {col.type}"
        )
    return vals, okm, dev


def _format_column(frame: Frame, name: str) -> List[bytes]:
    """Column values -> CSV field texts. Not-ok rows emit empty fields
    (missing data), so a round-trip re-parse flags them not-ok again."""
    col = frame[name]
    spec = frame.schema[name]
    okm = frame.ok(name)
    if spec.type == "decimal":
        s = spec.scale
        out = []
        for v in col:
            v = int(v)
            if s == 0:
                out.append(b"%d" % v)
            else:
                sign = b"-" if v < 0 else b""
                q, r = divmod(abs(v), 10 ** s)
                out.append(sign + b"%d.%0*d" % (q, s, r))
    elif spec.type in ("date", "datetime"):
        out = [np.datetime_as_string(v).encode() for v in col]
    elif spec.type in ("float32", "float"):
        # shortest text that re-parses to the same float32 (repr of the
        # float64 widening would print conversion noise: 1.100000023...)
        out = [
            np.format_float_positional(
                np.float32(v), unique=True, trim="-"
            ).encode()
            for v in col
        ]
    elif spec.type == "str":
        out = [v.encode("utf-8", "surrogateescape") for v in col]
    elif spec.type == "bytes":
        out = [bytes(v) for v in col]
    else:
        out = [b"%d" % int(v) for v in col]
    if okm is not None and not okm.all():
        out = [v if o else b"" for v, o in zip(out, okm)]
    return out


def write_csv(frame: Frame, path=None, *, dialect=None,
              header: bool = True) -> Optional[bytes]:
    """Frame -> CSV bytes (RFC-4180 quoting under the dialect): fields
    containing the delimiter, the quote char, or a newline are quoted
    with quotes doubled, so `read_typed(write_csv(f))` round-trips.
    Typed columns format canonically (decimal re-inserts the point per
    its scale; dates ISO; not-ok rows become empty fields). Writes to
    `path` when given, else returns the bytes.

    Completes the reference's one-way pipeline (csv -> index -> serve,
    README.md:4-6) into a round-trip."""
    from .config import DEFAULT_DIALECT

    d = dialect or DEFAULT_DIALECT
    delim = bytes([d.delimiter])
    quote = bytes([d.quote])
    needs = (delim, quote, b"\n", b"\r")

    def q(v: bytes) -> bytes:
        if any(c in v for c in needs):
            return quote + v.replace(quote, quote + quote) + quote
        return v

    cols = [_format_column(frame, n) for n in frame.names]
    lines = []
    if header:
        lines.append(delim.join(
            q(n.encode("utf-8")) for n in frame.names
        ))
    for i in range(frame.num_records):
        lines.append(delim.join(q(c[i]) for c in cols))
    blob = b"\n".join(lines) + b"\n"
    if path is None:
        return blob
    with open(path, "wb") as f:
        f.write(blob)
    return None


def _resolve_schema(tape, names, schema, columns, sample: int):
    """(resolved {name: Col}, output column order) for read_typed.

    - schema None: infer over `columns` (or all columns).
    - schema given, columns None: the schema defines the output set
      (back-compat); a spec of None or "auto" infers that column.
    - BOTH given: `columns` defines the output set and order; schema
      entries override inferred types. Schema entries naming columns
      outside the output set still resolve (typing predicates) but do
      not materialize."""
    def _idx(key) -> int:
        if isinstance(key, int):
            if not 0 <= key < len(names):
                raise KeyError(f"column index {key} out of range")
            return key
        try:
            return names.index(key)
        except ValueError:
            raise KeyError(
                f"no column {key!r}; header names: {names}"
            ) from None

    if schema is None:
        sel = None if columns is None else [_idx(c) for c in columns]
        inferred = infer_schema(tape, names, columns=sel, sample=sample)
        resolved = {n: parse_spec(s) for n, s in inferred.items()}
        return resolved, [n for n in names if n in resolved]
    overrides: Dict[str, object] = {}
    over_order = []
    for key, spec in schema.items():
        name = names[_idx(key)]
        if name in overrides:
            raise ValueError(
                f"schema names column {name!r} twice (by name and "
                "by index, or duplicate header names)"
            )
        overrides[name] = spec
        over_order.append(name)
    order = (over_order if columns is None
             else [names[_idx(c)] for c in columns])
    todo = [names.index(n) for n in dict.fromkeys(order + over_order)
            if overrides.get(n) in (None, "auto")]
    inferred = (infer_schema(tape, names, columns=todo, sample=sample)
                if todo else {})
    resolved = {}
    for n in dict.fromkeys(order + over_order):
        spec = overrides.get(n)
        resolved[n] = (parse_spec(spec) if spec not in (None, "auto")
                       else parse_spec(inferred[n]))
    return resolved, order


def read_typed(source, schema: Optional[Mapping] = None, *,
               columns: Optional[List[Union[str, int]]] = None,
               where=None, records=None, order_by=None,
               descending: bool = False,
               limit: Optional[int] = None, dialect=None,
               backend: str = "auto", engine: str = "offsets",
               validate_utf8: bool = False, strict: bool = False,
               sample: int = 256) -> Frame:
    """CSV -> Frame of typed NumPy arrays via the device parsers.

    source  — path, raw bytes, Tape, DeviceTape, or PackedDeviceTape.
    schema  — {column name or index: type spec} (see module docstring);
              None infers types from a `sample`-row probe. Columns not
              named in an explicit schema are skipped.
    columns — restrict inference to these columns (names or indices).
    engine  — "offsets" (DeviceTape over the offsets index) or "packed"
              (offsets-free PackedDeviceTape); only used when `source`
              is a path or bytes.
    records — explicit record ids to materialize (composes with ids
              from select_records/order_records/join_records; mutually
              exclusive with `where`).
    where   — predicate or list of predicates (AND), e.g.
              [("qty", ">", 100), ("sym", "==", "AAPL")] — evaluated on
              device BEFORE materialization (predicate pushdown): only
              matching rows are gathered/parsed/shipped. See
              query.select_records for the grammar. The selected record
              ids are returned as `frame.records`.
    order_by — column to sort rows by (ORDER BY): typed columns sort on
              device, str/bytes by decoded text, parse-failures last.
              `descending` flips direction; ties keep record order.
    limit   — keep only the first `limit` rows (after where/order_by);
              with order_by this is a top-k read — non-matching rows
              are never materialized.
    strict  — raise InvalidCsvFormat on the first row that fails a
              typed parse instead of returning ok masks.

    Typed values for not-ok rows are 0 (epoch for dates); check
    `frame.ok(name)`. Gather windows auto-size to the true column
    lengths, so oversized fields never silently truncate.

    A CsvCorpus source exports the whole corpus as one table: the
    output schema AND every predicate column's type resolve ONCE
    against the first file with data rows (or the given schema), then
    apply to every file — so results cannot depend on where the file
    boundaries fall. Columns concatenate in corpus order (per-file
    device tapes are cached on the corpus — no re-upload); per-row ok
    masks flag any file whose values don't fit the locked schema.
    `where` pushes down per file; `order_by`/`limit` sort the
    concatenated result on host (the key column may be any corpus
    column, not just an output column). `frame.records` holds GLOBAL
    corpus record ids. validate_utf8 applies at corpus build time —
    pass it to CsvCorpus(...) — and `engine` does not apply (corpus
    files serve through their per-file device tapes).
    """
    from .corpus_api import CsvCorpus

    if isinstance(source, CsvCorpus):
        if validate_utf8:
            raise ValueError(
                "validate_utf8 applies when the corpus is built: "
                "construct CsvCorpus(paths, validate_utf8=True)"
            )
        if engine != "offsets":
            raise ValueError(
                "a CsvCorpus serves through its per-file device tapes; "
                "engine= does not apply"
            )
        if records is not None:
            raise ValueError(
                "records= over a corpus: take() the full frame instead"
            )
        from .query import (
            _field_index,
            _lock_corpus_spec,
            _lock_where_schema,
            select_records,
        )

        names = source.header_names()
        devs = source.device_tapes()
        # resolve the output schema ONCE, corpus-wide (inference samples
        # every file; where-independent), and lock predicate columns the
        # same way — results must not depend on file boundaries
        from .query import infer_corpus_col

        if schema is None and columns is not None:
            # partial selection: infer only the selected columns
            schema = {c: "auto" for c in columns}
        if schema is None:
            selc = list(range(len(names)))
            resolved = {
                names[f]: infer_corpus_col(source, f, sample)
                for f in selc
            }
            order = [n for n in names if n in resolved]
        else:
            # "auto" entries lock corpus-wide (not from the first file
            # only) so results stay partition-invariant
            schema = {
                k: (infer_corpus_col(source, _field_index(names, k),
                                     sample)
                    if v in (None, "auto") else v)
                for k, v in schema.items()
            }
            need = [] if columns is None else [
                c for c in columns
                if names[_field_index(names, c)] not in {
                    names[_field_index(names, k)] for k in schema
                }
            ]
            for c in need:
                schema[names[_field_index(names, c)]] = infer_corpus_col(
                    source, _field_index(names, c), sample
                )
            resolved, order = _resolve_schema(devs[0], names, schema,
                                              columns, sample)
        sels = [None] * len(devs)
        if where is not None:
            wsch = _lock_where_schema(source, where, resolved, sample)
            sels = [
                select_records(dt, where, names=names, schema=wsch,
                               dialect=dialect, sample=sample)
                for dt in devs
            ]
        sub = [
            read_typed(dt, resolved, records=sel, dialect=dialect,
                       strict=strict, sample=sample)
            for dt, sel in zip(devs, sels)
        ]
        first = sub[0]
        cols = {
            n: np.concatenate([f[n] for f in sub]) for n in first.names
        }
        oks = {
            n: (np.concatenate([f.ok(n) for f in sub])
                if first.ok(n) is not None else None)
            for n in first.names
        }
        total = sum(len(f) for f in sub)
        out = Frame(first.names, cols, oks, first.schema, total)
        out.records = np.concatenate([
            (np.asarray(f.records, np.int64) + int(start))
            for f, start in zip(sub, source._starts[:-1])
        ]) if sub else np.zeros(0, np.int64)
        if order_by is not None:
            keys = (list(order_by)
                    if isinstance(order_by, (list, tuple))
                    else [order_by])
            descs = (list(descending)
                     if isinstance(descending, (list, tuple))
                     else [descending] * len(keys))  # keep SortDir intact
            if len(descs) != len(keys):
                raise ValueError(
                    f"descending has {len(descs)} entries for "
                    f"{len(keys)} order-by keys"
                )

            def _key_vals(key):
                key = names[_field_index(names, key)]
                if key in out._columns:
                    return out[key], out.ok(key)
                # ORDER BY a column outside the output set: parse it
                # per file under a corpus-locked spec
                kcol = (resolved.get(key)
                        or _lock_corpus_spec(source, key, None, sample))
                parts = [
                    _materialize(dt, names.index(key), kcol, dialect,
                                 False, key, records=sel)
                    for dt, sel in zip(devs, sels)
                ]
                kv = np.concatenate([p[0] for p in parts])
                kok = (np.concatenate([p[1] for p in parts])
                       if parts and parts[0][1] is not None else None)
                return kv, kok

            from .query import _host_multi_order_perm

            perm = _host_multi_order_perm(total, _key_vals,
                                          zip(keys, descs))
            return out.take(perm if limit is None else perm[:limit])
        if limit is not None:
            return out.take(np.arange(min(limit, total)))
        return out

    tape, names = _resolve_tape(source, dialect, backend, engine,
                                validate_utf8)

    def _idx(key) -> int:
        if isinstance(key, int):
            if not 0 <= key < len(names):
                raise KeyError(f"column index {key} out of range")
            return key
        try:
            return names.index(key)
        except ValueError:
            raise KeyError(
                f"no column {key!r}; header names: {names}"
            ) from None

    resolved, order = _resolve_schema(tape, names, schema, columns,
                                      sample)

    sel = None
    if records is not None:
        if where is not None:
            raise ValueError("pass either where= or records=, not both")
        sel = np.asarray(records, np.int32)
    elif where is not None:
        from .query import select_records

        sel = select_records(tape, where, names=names, schema=resolved,
                             dialect=dialect, sample=sample)
    if order_by is not None:
        from .query import order_records

        sel = order_records(tape, order_by, names=names, schema=resolved,
                            records=sel, descending=descending,
                            limit=limit, dialect=dialect, sample=sample)
    elif limit is not None:
        sel = (np.arange(min(limit, _num_records(tape)), dtype=np.int32)
               if sel is None else sel[:limit])
    num = _num_records(tape) if sel is None else int(sel.size)
    cols: Dict[str, np.ndarray] = {}
    oks: Dict[str, Optional[np.ndarray]] = {}
    dev_cols: Dict[str, tuple] = {}
    for name in order:
        vals, okm, dev = _materialize(tape, _idx(name), resolved[name],
                                      dialect, strict, name, records=sel)
        cols[name] = vals
        oks[name] = okm
        if dev is not None:
            dev_cols[name] = dev
    f = Frame(order, cols, oks, resolved, num)
    f._dev = dev_cols
    f.records = (np.arange(num, dtype=np.int32) if sel is None else sel)
    return f
