"""ctypes bindings to the native host engine (csvidx.cpp).

Built on first import with g++ (no pip deps); the .so is cached next to
the source and rebuilt when the source is newer. All entry points degrade
gracefully: `available()` is False if no compiler, and callers fall back
to the NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
from ..utils import as_u8

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csvidx.cpp")
_SO = os.path.join(_DIR, "_csvidx.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    # build beside the target and rename into place: processes that
    # build at once (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ invocation failed: {e}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(tmp, _SO)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        need_build = (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        )
        if need_build:
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(_SO)
        lib.host_stage1.restype = ctypes.c_int64
        lib.host_stage1.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ]
        lib.host_quote_parity.restype = ctypes.c_int
        lib.host_quote_parity.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.extract_offsets_v3.restype = ctypes.c_int64
        lib.extract_offsets_v3.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def host_stage1(
    data: bytes | np.ndarray,
    dialect=None,
    carry_in: int = 0,
    n_threads: int = 0,
    with_sentinel: bool = False,
) -> Tuple[np.ndarray, int]:
    """CPU stage-1: bytes -> (ascending int64 offsets, quote parity out).

    with_sentinel=True prepends the tape's 0 sentinel IN PLACE (the
    extractor writes past a preset slot 0), avoiding a full-index copy.
    Multithreaded two-phase parity stitch."""
    from ..config import DEFAULT_DIALECT

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    d = dialect or DEFAULT_DIALECT
    nl0 = d.newlines[0]
    nl1 = d.newlines[1] if len(d.newlines) > 1 else d.newlines[0]
    arr = as_u8(data)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lead = 1 if with_sentinel else 0
    # density heuristic (the reference reserves len/6, design_notes_2.md:14)
    # with growth-on-overflow — never allocate 8x the input up front
    cap = max(arr.size // 4 + 4096, 4096)
    while True:
        out = np.empty(cap + lead, dtype=np.int64)
        if lead:
            out[0] = 0
        parity = ctypes.c_int(0)
        cnt = lib.host_stage1(
            arr.ctypes.data, arr.size, d.delimiter, d.quote, nl0, nl1,
            carry_in & 1, n_threads, out.ctypes.data + 8 * lead, cap,
            ctypes.byref(parity),
        )
        if cnt >= 0:
            return out[: cnt + lead], int(parity.value)
        cap = min(cap * 4, arr.size + 1)


def host_quote_parity(data: bytes | np.ndarray, quote: int = 0x22,
                      carry_in: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    arr = as_u8(data)
    return lib.host_quote_parity(arr.ctypes.data, arr.size, quote, carry_in)


def extract_offsets_v3(
    packed: np.ndarray, tile: int, n_bytes: int, base: int = 0
) -> np.ndarray:
    """Decode the device kernel's fold-packed words straight to ascending
    absolute offsets (no byte-mask intermediate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    p = np.ascontiguousarray(packed, dtype=np.int32)
    cap = int(min(n_bytes, p.size * 32)) + 1
    out = np.empty(cap, dtype=np.int64)
    cnt = lib.extract_offsets_v3(
        p.ctypes.data, p.shape[0], tile, n_bytes, base, cap,
        out.ctypes.data,
    )
    if cnt < 0:
        raise ValueError(
            "packed words contain more set bits than n_bytes allows — "
            "corrupted or foreign packed array"
        )
    return out[:cnt]
