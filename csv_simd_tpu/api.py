"""Top-level factory: file path / bytes -> Tape.

Reference: `csv_simd::create` (lib.rs:61-74) — open, mmap, parse header,
build structural index, assemble tape. Here the index build dispatches to a
selectable backend:

- "golden": pure NumPy oracle (always available, any host);
- "jnp":    the jitted XLA scan on JAX's default device;
- "native": multithreaded C++ host engine (ctypes; no device round trip);
- "auto":   "jnp".
"""

from __future__ import annotations

import mmap as _mmap
import os

from .errors import IoError
from .tape import Header, Tape
from .utils import as_u8


def _build_index(data: bytes, dialect, backend: str):
    from .utils.metrics import GLOBAL

    with GLOBAL.span(f"index_build[{backend}]", len(data)):
        if backend == "golden":
            from . import golden

            return golden.structural_index(data, dialect)
        from .index import build_index

        return build_index(data, dialect=dialect, backend=backend)


def _check_utf8(data) -> None:
    """Raise InvalidCsvFormat unless `data` is valid UTF-8. On an
    accelerator the full Keiser-Lemire check runs on device
    (ops/utf8.py), on a CPU host the NumPy one; the ASCII fast path is
    free either way. Opt-in (the reference's utf8check was dead code,
    avx/utf8check.rs — here it is a live, optional gate)."""
    from .errors import InvalidCsvFormat
    from .ops import utf8
    from .utils.backend import on_accelerator

    arr = as_u8(data)
    ok = (
        utf8.validate_utf8_device(arr) if arr.size and on_accelerator()
        else utf8.validate_utf8(arr)
    )
    if not ok:
        raise InvalidCsvFormat("input is not valid UTF-8")


def create_from_bytes(data: bytes, dialect=None, backend: str = "auto",
                      validate_utf8: bool = False) -> Tape:
    """Build a Tape from an in-memory byte buffer.

    validate_utf8=True gates the build on full UTF-8 validity
    (device-side Keiser-Lemire on an accelerator), raising
    InvalidCsvFormat."""
    from .config import DEFAULT_DIALECT

    dialect = dialect or DEFAULT_DIALECT
    if validate_utf8:
        _check_utf8(data)
    header = Header.parse(data, delimiter=dialect.delimiter,
                          quote_aware=dialect.header_quotes,
                          quote=dialect.quote)
    index = _build_index(data, dialect, backend)
    return Tape(data, index, header)


def create_packed(filename: str | os.PathLike, dialect=None,
                  validate_utf8: bool = False):
    """Build the offsets-free device serving tape (PackedDeviceTape)
    straight from a file: mmap + fused scan on device; the index is the
    packed bitmask + row popcount prefix (never an offsets array)."""
    import numpy as np

    from .config import DEFAULT_DIALECT
    from .offsetfree import PackedDeviceTape

    try:
        with open(filename, "rb") as f:
            mapped = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError as e:
        raise IoError(f"{filename}: {e}") from e
    except OSError as e:
        raise IoError(str(e)) from e
    data = np.frombuffer(mapped, dtype=np.uint8)
    return PackedDeviceTape(
        data, dialect or DEFAULT_DIALECT, validate_utf8=validate_utf8
    )


def create(filename: str | os.PathLike, dialect=None, backend: str = "auto",
           validate_utf8: bool = False) -> Tape:
    """Build a Tape from a CSV file.

    The file is memory-mapped and served zero-copy (the reference's mmap
    design, lib.rs:65): the Tape's bytes are a NumPy view of the mapping,
    so a 1 GiB file costs no copy on the host path."""
    import numpy as np

    try:
        with open(filename, "rb") as f:
            mapped = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError as e:
        # mmap refuses zero-length files; treat like the reference's Io error
        raise IoError(f"{filename}: {e}") from e
    except OSError as e:
        raise IoError(str(e)) from e
    data = np.frombuffer(mapped, dtype=np.uint8)
    return create_from_bytes(
        data, dialect=dialect, backend=backend, validate_utf8=validate_utf8
    )
