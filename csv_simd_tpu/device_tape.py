"""Device-resident tape: serving as XLA gathers.

The reference serves one field at a time from host memory
(record_source.rs:104-140). On the device the tape (offsets) and the
bytes can both live in HBM, and serving becomes *batched* gathers —
whole columns or arbitrary (record, field) batches in one fused device
computation, something the CPU library cannot express:

  slot  = (record + 1) * jump + field          (slot arithmetic, vectorised)
  start = index[slot] + 1; end = index[slot+1] (offset gathers)
  out[i, j] = bytes[start_i + j] masked to j < end_i - start_i
                                               (2-D byte gather)

Fixed shapes throughout: `max_len` bounds the field width (static), and
lengths are returned alongside so callers can trim. Out-of-range records
clamp to 0 and are reported in the validity mask.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .utils import as_u8


@functools.partial(jax.jit, static_argnames=("max_len",))
def _gather_fields(
    data: jnp.ndarray,       # (n_bytes,) uint8
    index: jnp.ndarray,      # (index_len,) int32
    records: jnp.ndarray,    # (N,) int32
    fields: jnp.ndarray,     # (N,) int32
    jump: jnp.ndarray,       # scalar int32
    field_cnt: jnp.ndarray,  # scalar int32
    record_cnt: jnp.ndarray, # scalar int32
    max_len: int,
):
    valid = (
        (records >= 0)
        & (records + 1 < record_cnt)
        & (fields >= 0)
        & (fields < field_cnt)
    )
    r = jnp.where(valid, records, 0)
    f = jnp.where(valid, fields, 0)
    slots = (r + 1) * jump + f
    starts = index[slots] + 1
    ends = index[slots + 1]
    lengths = jnp.where(valid, ends - starts, 0)
    pos = starts[:, None] + jnp.arange(max_len, dtype=jnp.int32)[None, :]
    in_range = pos < ends[:, None]
    pos = jnp.clip(pos, 0, data.shape[0] - 1)
    out = jnp.where(in_range & valid[:, None], data[pos], jnp.uint8(0))
    return out, lengths, valid


class TypedColumnsMixin:
    """Batched serving surface shared by every device tape (single-chip
    offsets, single-chip packed, and both mesh-sharded tapes).

    Everything here is derived from one primitive the concrete class
    must provide — `gather_fields(records, fields, max_len)` returning
    (bytes (N, max_len) uint8, TRUE lengths (N,), valid (N,)) — plus the
    scalar metadata `record_cnt` / `field_cnt` (and optionally
    `num_data_records`). That contract is what lets the relational layer
    (query.py / frame.py / join.py) run unchanged over a single chip or
    a whole mesh: predicate pushdown, typed parses, decode and stats all
    route through these methods."""

    def _num_data(self) -> int:
        n = getattr(self, "num_data_records", None)
        if n is not None:
            return int(n)
        return max(int(self.record_cnt) - 1, 0)

    def gather_column(self, field: int, max_len: int = 64):
        """One whole column in a single device gather."""
        n = self._num_data()
        return self.gather_fields(
            jnp.arange(n, dtype=jnp.int32),
            jnp.full((n,), field, jnp.int32),
            max_len,
        )

    def _column_gather(self, field: int, max_len: int, records=None):
        """gather_column, optionally restricted to `records` (int32 ids —
        the typed column_* methods route through this so predicate
        pushdown can parse only selected rows)."""
        if records is None:
            return self.gather_column(field, max_len)
        recs = jnp.asarray(records, jnp.int32)
        return self.gather_fields(
            recs, jnp.full(recs.shape, field, jnp.int32), max_len
        )

    def to_host_lists(self, out, lengths, valid, allow_truncated=False) -> list:
        """Decode a gather result into a list of bytes (None if invalid).

        `lengths` are TRUE field lengths; when a field is longer than the
        gather's max_len the buffer holds a prefix only. That raises here
        unless allow_truncated=True (then the prefix is returned)."""
        return _to_host_lists(out, lengths, valid, allow_truncated)

    # -- device-side typed columns: CSV text -> numeric jnp arrays
    #    without the bytes ever leaving HBM --

    def column_int32(self, field: int, max_len: int = 20, records=None):
        """Parse a whole column as int32 ON DEVICE (vectorised atoi).

        Accepted grammar: `[spaces][+|-]digits` — leading ASCII spaces,
        one optional sign, then decimal digits to the END of the field.
        Returns (values (N,) int32, ok (N,) bool). `ok` is False for:
        empty/sign-only fields, any non-digit after the digits start
        (including trailing spaces, quotes, underscores, hex), values
        outside int32 (INT32_MIN itself is accepted), and invalid rows.
        Values for not-ok rows are 0."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_int32(out, lengths, valid)

    def column_float32(self, field: int, max_len: int = 24, records=None):
        """Parse a column as float32 on device.

        Accepted grammar: `[spaces][+|-]digits[.digits]` and
        `[spaces][+|-][digits].digits` — no exponent notation, no
        inf/nan words, no trailing spaces; `ok` is False for those (use
        column_float32_exp for scientific notation). Values for not-ok
        rows are 0.0."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_float32(out, lengths, valid)

    def gather_decoded(self, records, fields, max_len: int = 64,
                       dialect=None, trim: bool = True):
        """Batched gather + device stage-2 decode (trim/unquote/`""`
        unescape as a compaction gather — decode.decode_field semantics,
        all on device). Returns (bytes, lengths, valid).

        Raises if any requested field is longer than max_len: decoding a
        truncated window would silently return wrong bytes (the closing
        quote may fall outside it), so unlike raw gathers there is no
        opt-in prefix mode — re-gather with a larger max_len."""
        from .config import DEFAULT_DIALECT

        d = dialect or DEFAULT_DIALECT
        out, lengths, valid = self.gather_fields(records, fields, max_len)
        _check_not_truncated(lengths, valid, max_len)
        spaces = (d.space, 0x09) if trim else ()
        return _decode_fields(out, lengths, valid, d.quote, spaces)

    def column_decoded(self, field: int, max_len: int = 64,
                       dialect=None, trim: bool = True) -> list:
        """Whole decoded column as host bytes — byte-equal to
        decode.DecodedView.column on the same tape."""
        n = self._num_data()
        out, ln, v = self.gather_decoded(
            jnp.arange(n, dtype=jnp.int32),
            jnp.full((n,), field, jnp.int32),
            max_len, dialect, trim,
        )
        return self.to_host_lists(out, ln, v)

    def column_float32_exp(self, field: int, max_len: int = 32,
                           records=None):
        """Float column parse accepting exponent notation (`1.5e-3`).
        See _parse_float32_exp for the precision contract."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_float32_exp(out, lengths, valid)

    def column_date_days(self, field: int, max_len: int = 12, records=None):
        """ISO `YYYY-MM-DD` column -> int32 days since 1970-01-01, on
        device (see _parse_date_days for the ok contract)."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_date_days(out, lengths, valid)

    def column_datetime64(self, field: int, unit: str = "s",
                          max_len: int = 32, records=None):
        """ISO timestamp column -> int64 epoch values in `unit`
        ("s" | "ms" | "us"), parsed on device.

        Grammar: `YYYY-MM-DD[ T]HH:MM:SS[.frac][Z]` — date validity as
        column_date_days, hours<24/minutes<60/seconds<60 (no leap
        seconds), fraction digits must FIT the unit exactly (ok=False
        for `.123` at unit="s" — no silent truncation; shorter fractions
        scale up exactly). Timezone offsets other than `Z` are not
        accepted. Returns (values (N,) int64, ok (N,) bool); values for
        not-ok rows are 0."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _combine_datetime(
            _parse_datetime_parts(out, lengths, valid, unit), unit
        )

    def column_decimal64(self, field: int, scale: int = 2,
                         max_len: int = 32, records=None):
        """EXACT fixed-point decimal column -> host int64 scaled by
        10^scale (e.g. scale=2: b\"12.34\" -> 1234). The digit math runs
        on device in three base-1e8 int32 limbs (the device code runs
        without 64-bit types); the limbs combine on host. Returns
        (values (N,) int64, ok (N,) bool) — ok is False for >scale
        fractional digits (NO silent rounding), >18 significant digits,
        exponents, or bad grammar; values for not-ok rows are 0. See
        _parse_decimal_limbs."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _combine_decimal(_parse_decimal_limbs(out, lengths, valid,
                                                     scale))

    def filter_equals(self, field: int, value: bytes, max_len: int = 64,
                      records=None):
        """Record ids whose `field` equals `value` exactly (byte compare
        on device). Returns a host int32 array of record indices (ids
        from `records` when given, else global)."""
        if len(value) > max_len:
            # a truncated needle would compare equal to any field that
            # merely shares the gathered window prefix + true length
            raise ValueError(
                f"filter_equals value is {len(value)} bytes but "
                f"max_len={max_len}; pass max_len >= len(value)"
            )
        out, lengths, valid = self._column_gather(field, max_len, records)
        v = np.zeros(max_len, dtype=np.uint8)
        raw = np.frombuffer(value, dtype=np.uint8)
        v[: raw.size] = raw
        hits = np.flatnonzero(
            np.asarray(_filter_equals(out, lengths, valid,
                                      jnp.asarray(v), len(value)))
        ).astype(np.int32)
        if records is None:
            return hits
        return np.asarray(records, np.int32)[hits]


class DeviceTape(TypedColumnsMixin):
    """Tape with bytes + index resident on device for batched serving.

    Construct from a host Tape (`DeviceTape.from_tape`) or raw parts. The
    scalar metadata mirrors RecordSource's getters; lookups return
    (bytes (N, max_len) uint8, lengths (N,), valid (N,)) device arrays.
    """

    def __init__(self, data: jnp.ndarray, index, jump: int,
                 field_cnt: int, record_cnt: int, header=None):
        self.data = data
        self.header = header  # optional Header (column names for frame.py)
        # guard BEFORE any int32 conversion (jnp.asarray would already
        # wrap an int64 host index when x64 is disabled): native/golden
        # backends emit int64 indexes for >= 2 GiB inputs, and a wrapped
        # offset would silently mis-serve
        idx_host = np.asarray(index)
        if idx_host.size and int(idx_host[-1]) >= 2**31:
            raise ValueError(
                "device tape uses int32 offsets: this index addresses "
                ">= 2 GiB; shard across devices (parallel.serving) "
                "or serve from the host Tape"
            )
        self.index = jnp.asarray(idx_host.astype(np.int32))
        self.jump = jnp.int32(jump)
        self.field_cnt = jnp.int32(field_cnt)
        self.record_cnt = jnp.int32(record_cnt)

    @classmethod
    def from_tape(cls, tape) -> "DeviceTape":
        raw = tape.data_bytes
        host = as_u8(raw)
        data = jnp.asarray(host)
        return cls(
            data, np.asarray(tape.index),
            tape.record_jump_size, tape.field_cnt, tape.record_cnt,
            header=tape.header,
        )

    def gather_fields(
        self, records, fields, max_len: int = 64
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Batched (record, field) -> (bytes, lengths, valid)."""
        return _gather_fields(
            self.data, self.index,
            jnp.asarray(records, jnp.int32), jnp.asarray(fields, jnp.int32),
            self.jump, self.field_cnt, self.record_cnt, max_len,
        )


def _check_not_truncated(lengths, valid, max_len: int) -> None:
    """Host-side guard: raise if any valid field's true length exceeds
    the gathered window (used by decode paths where a truncated window
    would produce silently-wrong output rather than a clean prefix)."""
    ln = np.asarray(lengths)
    v = np.asarray(valid)
    cut = np.flatnonzero(v & (ln > max_len))
    if cut.size:
        raise ValueError(
            f"gather window truncates {cut.size} field(s) (first at row "
            f"{int(cut[0])}: length {int(ln[cut[0]])} > max_len {max_len}); "
            "decode needs the whole field — re-gather with a larger max_len"
        )


def _to_host_lists(out, lengths, valid, allow_truncated=False) -> list:
    """Shared gather-result decoder (DeviceTape / PackedDeviceTape /
    sharded tapes): true lengths beyond the buffer width mean the gather
    truncated; refuse unless the caller opted in."""
    o = np.asarray(out)
    ln = np.asarray(lengths)
    v = np.asarray(valid)
    if not allow_truncated:
        cut = np.flatnonzero(v & (ln > o.shape[1]))
        if cut.size:
            raise ValueError(
                f"gather truncated {cut.size} field(s) (first at row "
                f"{int(cut[0])}: length {int(ln[cut[0]])} > max_len "
                f"{o.shape[1]}); re-gather with a larger max_len or pass "
                "allow_truncated=True"
            )
    return [
        bytes(o[i, : min(ln[i], o.shape[1])]) if v[i] else None
        for i in range(o.shape[0])
    ]



def _field_preamble(out, lengths):
    """Shared numeric-parser preamble: skip leading spaces, take one
    optional sign. Returns (b int32 bytes, pos grid, in_field mask,
    neg, dstart) — the four numeric kernels (_parse_int32/_parse_
    float32/_parse_decimal_limbs/_parse_float32_exp) must agree on this
    scan, and divergence here is exactly how the missing-digit-guard
    class of bug arises."""
    n, max_len = out.shape
    pos = jnp.arange(max_len, dtype=jnp.int32)[None, :]
    b = out.astype(jnp.int32)
    in_field = pos < lengths[:, None]
    is_space = (b == 0x20) & in_field
    lead_sp = jnp.cumprod(is_space, axis=1)  # 1 while in the lead run
    start = jnp.sum(lead_sp, axis=1)
    first = jnp.take_along_axis(b, start[:, None], axis=1)[:, 0]
    has_sign = (first == 0x2D) | (first == 0x2B)
    neg = first == 0x2D
    dstart = start + has_sign.astype(jnp.int32)
    return b, pos, in_field, neg, dstart


@jax.jit
def _parse_int32(out, lengths, valid):
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    is_digit_pos = (pos >= dstart[:, None]) & in_field
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    # every position from dstart to length must be a digit
    ok = valid & (lengths > dstart) & (lengths <= max_len) & jnp.all(
        ~is_digit_pos | good_digit, axis=1
    )

    # value = fold left: v = v*10 + d, flagging int32 overflow as we go
    # (v*10+d wraps iff v > 214748364, or v == 214748364 and d > 7)
    def step(carry, j):
        v, of = carry
        d = digit[:, j]
        use = is_digit_pos[:, j]
        wraps = (v > 214748364) | ((v == 214748364) & (d > 7))
        v2 = jnp.where(use, v * 10 + d, v)
        of2 = of | (use & wraps)
        return (v2, of2), None

    (val, overflow), _ = jax.lax.scan(
        step,
        (jnp.zeros(n, jnp.int32), jnp.zeros(n, bool)),
        jnp.arange(max_len),
    )
    # exception: exactly INT32_MIN (-2147483648) wraps during the
    # positive accumulation but negates back to the correct value.
    # Guard digit count + leading digit so a larger alias (e.g.
    # 6442450944 = 2^31 + 2^32) can't masquerade as it.
    digit_cnt = lengths - dstart
    first_digit = jnp.take_along_axis(b, dstart[:, None], axis=1)[:, 0]
    int_min = (
        overflow & neg & (val == jnp.int32(-(2**31)))
        & (digit_cnt == 10) & (first_digit == 0x32)
    )
    ok = ok & (~overflow | int_min)
    val = jnp.where(neg, -val, val)
    return jnp.where(ok, val, 0), ok


@jax.jit
def _parse_float32(out, lengths, valid):
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    dot_count = jnp.sum(is_dot & in_field, axis=1)
    # dot position (first dot; max_len if none)
    dot_pos = jnp.min(
        jnp.where(is_dot & in_field, pos, max_len), axis=1
    )
    body = (pos >= dstart[:, None]) & in_field
    # at least one digit: '.', '-.', '+.' are not numbers (same guard
    # as _parse_float32_exp's mant_digits and decimal's n_digits)
    n_digits = jnp.sum((body & good_digit).astype(jnp.int32), axis=1)
    ok = valid & (lengths > dstart) & (lengths <= max_len) & (dot_count <= 1) & (n_digits >= 1) & jnp.all(
        ~body | good_digit | (is_dot & (dot_count[:, None] == 1)), axis=1
    )

    def step(carry, j):
        v, scale = carry
        d = digit[:, j].astype(jnp.float32)
        is_d = body[:, j] & good_digit[:, j]
        after_dot = j > dot_pos
        v2 = jnp.where(is_d, v * 10.0 + d, v)
        scale2 = jnp.where(is_d & after_dot, scale * 10.0, scale)
        return (v2, scale2), None

    (val, scale), _ = jax.lax.scan(
        step,
        (jnp.zeros(n, jnp.float32), jnp.ones(n, jnp.float32)),
        jnp.arange(max_len),
    )
    val = val / scale
    val = jnp.where(neg, -val, val)
    return jnp.where(ok, val, jnp.float32(0)), ok


def _combine_decimal(limbs):
    """(hi, mid, lo, neg, ok) device limbs -> (int64 values, ok) on
    host. Kept out of jit: int64 only exists host-side."""
    h, m, l, neg, ok = (np.asarray(x) for x in limbs)
    v = h.astype(np.int64) * 10**16 + m.astype(np.int64) * 10**8 + l
    v = np.where(neg, -v, v)
    ok = np.asarray(ok, bool)
    return np.where(ok, v, 0), ok


@functools.partial(jax.jit, static_argnames=("scale",))
def _parse_decimal_limbs(out, lengths, valid, scale: int):
    """Exact fixed-point decimal parse, on device, in three base-1e8
    int32 limbs (the device code runs without 64-bit types; three limbs
    keep every intermediate < 2^31 while covering the full int64
    range).

    Grammar: `[spaces][+|-]digits[.digits]` (also `.5`, `5.`) — no
    exponent. The parsed number times 10^scale must be an INTEGER of at
    most 18 significant digits (|value| <= 1e18-1): `ok` is False for
    more than `scale` fractional digits (no silent rounding — exactness
    is the contract), magnitude overflow, and any grammar violation.
    Returns (hi, mid, lo, neg, ok): value = sign*(hi*1e16 + mid*1e8 + lo).
    """
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    dot_count = jnp.sum(is_dot & in_field, axis=1)
    dot_pos = jnp.min(jnp.where(is_dot & in_field, pos, max_len), axis=1)
    body = (pos >= dstart[:, None]) & in_field
    digit_at = body & good_digit
    n_digits = jnp.sum(digit_at, axis=1)
    frac_cnt = jnp.where(dot_count == 1, lengths - dot_pos - 1, 0)
    ok = (
        valid
        & (lengths > dstart)
        & (lengths <= max_len)
        & (dot_count <= 1)
        & (n_digits >= 1)
        & (frac_cnt <= scale)
        & (dot_pos >= dstart)
        & jnp.all(~body | good_digit | (is_dot & (dot_count[:, None] == 1)),
                  axis=1)
    )

    BASE = 10**8

    def mul10_add(carry, d, use):
        h, m, l, of = carry
        l2 = l * 10 + d
        m2 = m * 10 + l2 // BASE
        h2 = h * 10 + m2 // BASE
        # h is clamped at 1000 so h*10 stays far below 2^31; anything
        # past 18 integer digits flags overflow
        of2 = of | (use & (h2 > 999))
        h2 = jnp.minimum(h2, 1000)
        return (
            jnp.where(use, h2, h),
            jnp.where(use, m2 % BASE, m),
            jnp.where(use, l2 % BASE, l),
            of2,
        )

    def step(carry, j):
        return mul10_add(carry, digit[:, j], digit_at[:, j]), None

    zero = jnp.zeros(n, jnp.int32)
    (h, m, l, of), _ = jax.lax.scan(
        step, (zero, zero, zero, jnp.zeros(n, bool)), jnp.arange(max_len)
    )
    # scale up by 10^(scale - frac_cnt): `scale` masked x10 steps
    pad = scale - frac_cnt
    for k in range(scale):
        h, m, l, of = mul10_add((h, m, l, of), zero, k < pad)
    # 18 significant digits max: h <= 99 means |value| <= 1e18-1, well
    # inside int64 either sign
    ok = ok & ~of & (h <= 99)
    return h, m, l, neg, ok


@functools.partial(jax.jit, static_argnames=("quote", "spaces"))
def _decode_fields(out, lengths, valid, quote: int, spaces: tuple):
    """Device stage-2: trim -> unquote -> `""`-unescape as a fixed-shape
    gather-compaction over a gathered batch (N, max_len).

    Matches decode.decode_field byte-for-byte: trim strips the space
    chars OUTSIDE quotes first; a field is unquoted iff the trimmed span
    is >= 2 bytes with quote chars at both ends; doubled quotes collapse
    left-to-right ONLY inside a quoted field. The reference classified
    space/escape but never used them (stage1.rs:51, README.md:32) —
    this is that stage-2 on the device: per-byte keep mask + stable-order
    compaction gather, no data-dependent shapes."""
    n, L = out.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    b = out.astype(jnp.int32)
    in_field = pos < lengths[:, None]
    is_sp = jnp.zeros_like(in_field)
    for sp in spaces:
        is_sp = is_sp | (b == sp)
    is_sp = is_sp & in_field

    lead = jnp.cumprod(is_sp.astype(jnp.int32), axis=1)
    start = jnp.sum(lead, axis=1)
    tail_run = jnp.cumprod(
        jnp.flip((is_sp | ~in_field).astype(jnp.int32), axis=1), axis=1
    )
    trail = jnp.sum(tail_run, axis=1) - (L - lengths)
    end = lengths - trail
    start = jnp.minimum(start, end)  # all-space field -> empty

    first = jnp.take_along_axis(
        b, jnp.clip(start, 0, L - 1)[:, None], axis=1
    )[:, 0]
    last = jnp.take_along_axis(
        b, jnp.clip(end - 1, 0, L - 1)[:, None], axis=1
    )[:, 0]
    has_q = (end - start >= 2) & (first == quote) & (last == quote)
    start = start + has_q.astype(jnp.int32)
    end = end - has_q.astype(jnp.int32)

    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    q = in_span & (b == quote)
    prev_q = jnp.pad(q, ((0, 0), (1, 0)))[:, :L]
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(q & ~prev_q, pos, -1), axis=1
    )
    drop = q & (((pos - run_start) & 1) == 1) & has_q[:, None]
    keep = in_span & ~drop

    order = jnp.argsort(jnp.where(keep, pos, L + pos), axis=1)
    gathered = jnp.take_along_axis(out, order, axis=1)
    new_len = jnp.sum(keep, axis=1, dtype=jnp.int32)
    gathered = jnp.where(pos < new_len[:, None], gathered, jnp.uint8(0))
    return gathered, new_len, valid


@jax.jit
def _parse_float32_exp(out, lengths, valid):
    """Float parse WITH exponent notation:
    `[spaces][+|-]digits[.digits][(e|E)[+|-]digits]` (also `.5`, `5.`).
    Mantissa accumulates in float32, so >7 significant digits round
    slightly differently from a correctly-rounded double parse; exponent
    overflow saturates to +/-inf (ok stays True for well-formed text)."""
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)

    is_e = ((b == 0x65) | (b == 0x45)) & in_field
    e_cnt = jnp.sum(is_e, axis=1)
    epos = jnp.min(jnp.where(is_e, pos, max_len), axis=1)
    mant_end = jnp.minimum(epos, lengths)

    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    mant_body = (pos >= dstart[:, None]) & (pos < mant_end[:, None])
    dot_count = jnp.sum(is_dot & mant_body, axis=1)
    dot_pos = jnp.min(jnp.where(is_dot & mant_body, pos, max_len), axis=1)
    mant_digits = jnp.sum(mant_body & good_digit, axis=1)
    mant_ok = (
        (dot_count <= 1)
        & (mant_digits >= 1)
        & jnp.all(~mant_body | good_digit | is_dot, axis=1)
    )

    # exponent part (optional)
    has_e = epos < lengths
    es = epos + 1
    efirst = jnp.take_along_axis(b, jnp.clip(es, 0, max_len - 1)[:, None], axis=1)[:, 0]
    e_sign = (efirst == 0x2D) | (efirst == 0x2B)
    e_neg = (efirst == 0x2D) & has_e
    eds = es + e_sign.astype(jnp.int32)
    e_body = (pos >= eds[:, None]) & in_field
    e_ok = ~has_e | (
        (e_cnt == 1)
        & (lengths > eds)
        & jnp.all(~e_body | good_digit, axis=1)
    )
    # a field longer than the gather window would parse its PREFIX
    # cleanly (e.g. the exponent cut off) — never report ok on it
    ok = valid & mant_ok & e_ok & (lengths <= max_len)

    def step(carry, j):
        v, scale, ev = carry
        d = digit[:, j].astype(jnp.float32)
        is_d = mant_body[:, j] & good_digit[:, j]
        after_dot = j > dot_pos
        v2 = jnp.where(is_d, v * 10.0 + d, v)
        scale2 = jnp.where(is_d & after_dot, scale + 1, scale)
        is_ed = e_body[:, j] & good_digit[:, j]
        ev2 = jnp.where(is_ed, jnp.minimum(ev * 10 + digit[:, j], 9999), ev)
        return (v2, scale2, ev2), None

    (val, frac, ev), _ = jax.lax.scan(
        step,
        (
            jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.int32),
            jnp.zeros(n, jnp.int32),
        ),
        jnp.arange(max_len),
    )
    exp10 = jnp.where(e_neg, -ev, ev) - frac
    # split the scale to keep intermediates finite for moderate values
    val = val * jnp.power(jnp.float32(10.0), (exp10 // 2).astype(jnp.float32))
    val = val * jnp.power(jnp.float32(10.0), (exp10 - exp10 // 2).astype(jnp.float32))
    val = jnp.where(neg, -val, val)
    return jnp.where(ok, val, jnp.float32(0)), ok


def _ymd_to_days(y, m, day):
    """Hinnant civil_from_date: (year, month, day) -> days since
    1970-01-01, proleptic Gregorian, exact integer arithmetic."""
    yy = y - (m <= 2)
    era = jnp.floor_divide(yy, 400)
    yoe = yy - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = jnp.floor_divide(153 * mp + 2, 5) + day - 1
    doe = (yoe * 365 + jnp.floor_divide(yoe, 4)
           - jnp.floor_divide(yoe, 100) + doy)
    return era * 146097 + doe - 719468


_UNIT_DIGITS = {"s": 0, "ms": 3, "us": 6}


@functools.partial(jax.jit, static_argnames=("unit",))
def _parse_datetime_parts(out, lengths, valid, unit: str):
    """ISO `YYYY-MM-DD[ T]HH:MM:SS[.frac][Z]` -> (days, seconds-of-day,
    fraction scaled to `unit`, ok) — all int32, combined to int64 on
    host (_combine_datetime). Positions are fixed by the format, so the
    parse is pure fixed-index arithmetic: no scan needed. ok is False
    for bad digits/separators, invalid civil dates, hh>23/mm>59/ss>59,
    timezone suffixes other than Z, and fraction digits that exceed the
    unit's precision (exactness: `.123` at unit="s" refuses rather than
    truncates)."""
    n, max_len = out.shape
    if max_len < 21:
        # ValueError (not assert): the fixed-index fraction reads
        # below need 21 columns, and callers hit this with a bad
        # max_len argument — it must survive python -O
        raise ValueError(
            f"datetime parse needs a gather window >= 21, got {max_len}"
        )
    udig = _UNIT_DIGITS[unit]
    pos = jnp.arange(max_len, dtype=jnp.int32)[None, :]
    b = out.astype(jnp.int32)
    d = b - 0x30

    def dig(i):
        return d[:, i]

    ok = (
        valid
        & (lengths >= 19)
        & (lengths <= max_len)
        & (b[:, 4] == 0x2D)
        & (b[:, 7] == 0x2D)
        & ((b[:, 10] == 0x20) | (b[:, 10] == 0x54))
        & (b[:, 13] == 0x3A)
        & (b[:, 16] == 0x3A)
    )
    for i in (0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18):
        ok = ok & (dig(i) >= 0) & (dig(i) <= 9)
    y = dig(0) * 1000 + dig(1) * 100 + dig(2) * 10 + dig(3)
    m = dig(5) * 10 + dig(6)
    day = dig(8) * 10 + dig(9)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    mdays = jnp.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                      jnp.int32)
    dim = mdays[jnp.clip(m, 0, 12)] + (leap & (m == 2)).astype(jnp.int32)
    ok = ok & (m >= 1) & (m <= 12) & (day >= 1) & (day <= dim)

    hh = dig(11) * 10 + dig(12)
    mm = dig(14) * 10 + dig(15)
    ss = dig(17) * 10 + dig(18)
    ok = ok & (hh <= 23) & (mm <= 59) & (ss <= 59)

    last = jnp.take_along_axis(
        b, jnp.clip(lengths - 1, 0, max_len - 1)[:, None], axis=1
    )[:, 0]
    has_z = (last == 0x5A) & (lengths >= 20)
    end = lengths - has_z.astype(jnp.int32)  # fraction ends here
    has_frac = end > 19
    ok = ok & (~has_frac | ((b[:, 19] == 0x2E) & (end >= 21)))
    n_frac = jnp.where(has_frac, end - 20, 0)
    ok = ok & (n_frac <= udig)
    good_digit = (d >= 0) & (d <= 9)
    frac_pos = (pos >= 20) & (pos < end[:, None])
    ok = ok & jnp.all(~frac_pos | good_digit, axis=1)

    frac = jnp.zeros(n, jnp.int32)
    for k in range(udig):
        p = 20 + k
        use = (p < end) if p < max_len else jnp.zeros(n, bool)
        dk = jnp.where(use, d[:, min(p, max_len - 1)], 0)
        frac = frac * 10 + dk  # digits then zero-pad to unit precision

    days = _ymd_to_days(y, m, day)
    sod = hh * 3600 + mm * 60 + ss
    z = jnp.zeros(n, jnp.int32)
    return (jnp.where(ok, days, z), jnp.where(ok, sod, z),
            jnp.where(ok, frac, z), ok)


def _combine_datetime(parts, unit: str):
    """(days, sod, frac, ok) int32 device parts -> (int64 epoch in
    `unit`, ok) on host (int64 only exists host-side)."""
    days, sod, frac, ok = (np.asarray(x) for x in parts)
    mult = 10 ** _UNIT_DIGITS[unit]
    v = (days.astype(np.int64) * 86400 + sod) * mult + frac
    ok = np.asarray(ok, bool)
    return np.where(ok, v, 0), ok


@jax.jit
def _parse_date_days(out, lengths, valid):
    """`YYYY-MM-DD` -> days since 1970-01-01 (proleptic Gregorian,
    Hinnant's civil_from_days inverse — exact integer arithmetic, no
    per-row branching). ok is False for any other shape/length, month
    outside 1..12, or day outside the month's true length (leap years
    handled). Values for not-ok rows are 0."""
    n, max_len = out.shape
    b = out.astype(jnp.int32)
    d = b - 0x30

    def dig(i):
        return d[:, i]

    ok_shape = (
        valid
        & (lengths == 10)
        & (b[:, 4] == 0x2D)
        & (b[:, 7] == 0x2D)
    )
    digits_ok = jnp.ones(n, bool)
    for i in (0, 1, 2, 3, 5, 6, 8, 9):
        digits_ok = digits_ok & (dig(i) >= 0) & (dig(i) <= 9)
    y = dig(0) * 1000 + dig(1) * 100 + dig(2) * 10 + dig(3)
    m = dig(5) * 10 + dig(6)
    day = dig(8) * 10 + dig(9)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    mdays = jnp.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                      jnp.int32)
    dim = mdays[jnp.clip(m, 0, 12)] + (leap & (m == 2)).astype(jnp.int32)
    ok = ok_shape & digits_ok & (m >= 1) & (m <= 12) & (day >= 1) & (day <= dim)
    days = _ymd_to_days(y, m, day)
    return jnp.where(ok, days, 0), ok


@jax.jit
def _filter_equals(out, lengths, valid, needle, needle_len):
    max_len = out.shape[1]
    pos = jnp.arange(max_len)[None, :]
    in_field = pos < lengths[:, None]
    same = (out == needle[None, :]) | ~in_field
    return valid & (lengths == needle_len) & jnp.all(same, axis=1)
