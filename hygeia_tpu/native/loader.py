"""ctypes binding for the native gzip CSV loader (fastload.cpp).

`load_matrix(path)` returns a float64 (rows, cols) array. Callers fall back
to NumPy readers and writers when the shared library cannot be built — call
`hygeia_tpu/native/build.sh` (or `ensure_built()`) to compile it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libfastload.so"
_lib = None


def ensure_built(quiet=True):
    """Compile the shared library if missing; returns True if available."""
    if _LIB_PATH.exists():
        return True
    try:
        subprocess.run(
            ["sh", str(_DIR / "build.sh")],
            check=True,
            capture_output=quiet,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not ensure_built():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.fastload_open.restype = ctypes.c_void_p
    lib.fastload_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    try:
        lib.fastload_open_ex.restype = ctypes.c_void_p
        lib.fastload_open_ex.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
    except AttributeError:
        pass  # stale .so; rebuilt on demand
    lib.fastload_parse.restype = ctypes.c_int
    lib.fastload_parse.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.fastload_close.restype = None
    lib.fastload_close.argtypes = [ctypes.c_void_p]
    try:
        lib.fastwrite_table.restype = ctypes.c_int
        lib.fastwrite_table.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_char,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fastwrite_ftable.restype = ctypes.c_int
        lib.fastwrite_ftable.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_char,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
    except AttributeError:
        # Stale .so from before the writers existed; rebuild on demand.
        pass
    _lib = lib
    return lib


def write_int_table_gz(path, values, *, index=None, header=None, sep="\t",
                       level=1, n_threads=None):
    """Write an integer table as gzip CSV via the native writer
    (fastwrite_table): per-thread row ranges are formatted with a tight
    itoa and deflated as independent gzip members, so decompressed bytes
    match pandas' to_csv for int tables at a fraction of the cost of a
    Python formatter.

    Returns True on success; False if the native library is unavailable
    (caller falls back to utils/io.write_csv)."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "fastwrite_table"):
        return False
    vals = np.ascontiguousarray(np.asarray(values), dtype=np.int64)
    if vals.ndim == 1:
        vals = vals[:, None]
    n_rows, n_cols = vals.shape
    idx_ptr = None
    if index is not None:
        idx = np.ascontiguousarray(np.asarray(index), dtype=np.int64)
        if len(idx) != n_rows:
            raise ValueError("index length mismatch")
        idx_ptr = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.fastwrite_table(
        str(path).encode(),
        header.encode() if header else None,
        idx_ptr,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_rows,
        n_cols,
        sep.encode(),
        int(level),
        n_threads or min(8, os.cpu_count() or 1),
    )
    return rc == 0


def write_float_table_gz(path, values, *, index=None, header=None, sep=",",
                         level=1, sig_digits=9, n_threads=None):
    """Write a float table as gzip CSV via the native writer
    (fastwrite_ftable): %.9g round-trips float32 values exactly (readers
    parse identical f32), though the textual form can differ from pandas'
    shortest-repr (documented in PARITY.md).

    Returns True on success; False if unavailable (caller falls back)."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "fastwrite_ftable"):
        return False
    vals = np.ascontiguousarray(np.asarray(values), dtype=np.float64)
    if vals.ndim == 1:
        vals = vals[:, None]
    n_rows, n_cols = vals.shape
    idx_ptr = None
    if index is not None:
        idx = np.ascontiguousarray(np.asarray(index), dtype=np.int64)
        if len(idx) != n_rows:
            raise ValueError("index length mismatch")
        idx_ptr = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.fastwrite_ftable(
        str(path).encode(),
        header.encode() if header else None,
        idx_ptr,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows,
        n_cols,
        sep.encode(),
        int(level),
        n_threads or min(8, os.cpu_count() or 1),
        int(sig_digits),
    )
    return rc == 0


def load_matrix(path, n_threads=None, skip_rows=0):
    """Load a (gzip) comma- or tab-separated numeric matrix as float64,
    optionally skipping header lines (the aggregate-stage tables carry one
    header row + a pos index column; callers slice the index off).

    Returns None if the native library is unavailable (caller falls back)."""
    lib = _get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    if skip_rows and not hasattr(lib, "fastload_open_ex"):
        return None
    if skip_rows:
        handle = lib.fastload_open_ex(
            str(path).encode(), skip_rows, ctypes.byref(rows), ctypes.byref(cols)
        )
    else:
        handle = lib.fastload_open(
            str(path).encode(), ctypes.byref(rows), ctypes.byref(cols)
        )
    if not handle:
        return None
    try:
        out = np.empty((rows.value, cols.value), np.float64)
        nt = n_threads or min(8, os.cpu_count() or 1)
        rc = lib.fastload_parse(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows.value, nt
        )
        if rc != 0:
            return None
        return out
    finally:
        lib.fastload_close(handle)
