"""CSV readers/writers matching the reference's file formats.

Two distinct conventions exist in the reference and both are preserved:

* Two-group count files (preprocess output, read by `infer`): header-less,
  comma-separated, one row per CpG site (`positions_{chrom}.txt.gz` etc.).
* Single-group engine files (R tidyverse convention,
  input_output_functions.R): headed CSVs; count matrices are stored
  (n_sites, n_samples) with `sample_i` columns; the theta vector is a single
  `data` column (read back by get_estimated_control_group_param,
  run_inference_two_groups.py:76-89).
"""

from __future__ import annotations

import csv
import gzip
import os

import numpy as np


def require_pandas(what):
    """pandas, which only the BED/gemBS preprocess verbs and BED export
    use; a clear error where it is not installed."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError(
            f"{what} needs pandas, an optional dependency: "
            "pip install 'hygeia-tpu[bed]'"
        ) from e
    return pandas


def _ensure_dir(path):
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)


def _open_text(path, mode):
    """Text handle on ``path``; gzip (level 1 when writing) for .gz names."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t", compresslevel=1, newline="")
    return open(path, mode, newline="")


def format_column(values, float_format=None):
    """CSV cells for one column, as pandas' to_csv writes them: integers
    and strings as str(), floats as the shortest repr of their own dtype
    (or ``float_format % v``), NaN as an empty cell."""
    a = np.asarray(values)
    if a.dtype.kind == "f":
        if float_format is not None:
            cells = np.array([float_format % v for v in a.tolist()], object)
        else:
            cells = a.astype(str).astype(object)
        cells[np.isnan(a)] = ""
        return cells
    return a.astype(str)


def write_csv(path, columns, header=None, sep=",", float_format=None):
    """Write equal-length 1-D columns as a delimited text table (gzip for
    .gz names) with the cell text of pandas' to_csv (format_column)."""
    _ensure_dir(path)
    cells = [format_column(c, float_format) for c in columns]
    with _open_text(path, "w") as f:
        if header is not None:
            f.write(sep.join(header) + "\n")
        if len(cells) == 1:
            # A lone empty cell would be a blank line; pandas quotes it.
            f.writelines((c or '""') + "\n" for c in cells[0])
        else:
            f.writelines(sep.join(row) + "\n" for row in zip(*cells))


def read_headed_table(path, sep=","):
    """(header, float64 (rows, cols) array) of a headed delimited table."""
    with _open_text(path, "r") as f:
        rows = list(csv.reader(f, delimiter=sep))
    header, body = rows[0], rows[1:]
    data = np.array(
        [[float(x) if x else np.nan for x in r] for r in body], np.float64
    ).reshape(len(body), len(header))
    return header, data


def write_float_table(path, values, *, index=None, header=None, sep=","):
    """Float table at %.9g (round-trips float32; integral values as "k.0")
    through the native writer, or a Python fallback of the same text."""
    from hygeia_tpu.native.loader import write_float_table_gz

    if str(path).endswith(".gz") and write_float_table_gz(
        path, values, index=index, header=header, sep=sep
    ):
        return
    v = np.asarray(values, np.float64)
    v = v[:, None] if v.ndim == 1 else v

    def cell(x):
        if np.isfinite(x) and x == int(x) and abs(x) < 1e15:
            return f"{int(x)}.0"
        return "%.9g" % x

    cols = [np.array([cell(x) for x in c.tolist()], object) for c in v.T]
    if index is not None:
        cols.insert(0, np.asarray(index, np.int64))
    write_csv(path, cols, header=header.split(sep) if header else None,
              sep=sep)


# ---------- two-group count files (header-less, comma-separated) ----------

def read_count_matrix(path, dtype=np.float32):
    """(T, S) matrix from a header-less comma-separated .txt.gz.

    Uses the native zlib/multithreaded parser (hygeia_tpu/native) when its
    shared library is available, with a NumPy fallback."""
    from hygeia_tpu.native.loader import load_matrix

    m = load_matrix(path)
    if m is None:
        with _open_text(path, "r") as f:
            rows = [r for r in csv.reader(f) if r]
        m = np.array(rows, np.float64).reshape(len(rows), -1 if rows else 0)
    return m.astype(dtype, copy=False)


def read_positions(path):
    return read_count_matrix(path, np.int64).ravel()


def write_count_matrix(path, arr):
    """np.savetxt(fmt="%s")-compatible writer: one row per site, shortest
    repr per cell, no header.

    Integer arrays take the native itoa + parallel-gzip writer
    (native/loader.write_int_table_gz) — same decompressed bytes ("%s" of
    an int has no decimal point; regression: test_more_components
    byte-identity, which routes its i64 case through this path)."""
    _ensure_dir(path)
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if np.issubdtype(a.dtype, np.integer) and str(path).endswith(".gz"):
        from hygeia_tpu.native.loader import write_int_table_gz

        if write_int_table_gz(path, a, sep=",", level=1):
            return
    write_csv(path, list(a.T))


# ---------- single-group engine files (headed CSVs) ----------

def read_headed_matrix(path):
    """(n_samples, n_sites): stored transposed with sample_i columns."""
    return read_headed_table(path)[1].T


def read_headed_column(path):
    return read_headed_table(path)[1][:, 0]


def write_headed_column(path, values, name):
    write_csv(path, [np.asarray(values)], header=[name])


def write_headed_matrix(path, matrix, prefix):
    """Write a (k, n) matrix with `{prefix}_i` columns (R convention: the
    count matrices are transposed to (n_sites, n_samples) first)."""
    m = np.asarray(matrix)
    write_csv(
        path, list(m), header=[f"{prefix}_{i + 1}" for i in range(m.shape[0])]
    )


def read_theta(path):
    """theta vector from the single-group `data`-column CSV."""
    header, data = read_headed_table(path)
    return data[:, header.index("data")]


def write_theta(path, theta):
    write_headed_column(path, theta, "data")


def theta_file_to_p_softmax(theta, n_regimes):
    """Rebuild (log P, omega_logit) from the packed theta exactly as
    get_estimated_control_group_param does (run_inference_two_groups.py:76-89):
    exponentiate the R(R-1) off-diagonal entries row-major, renormalise each
    row, take log (diagonal becomes log 0 = -inf)."""
    R = n_regimes
    theta = np.asarray(theta, np.float64)
    p = np.zeros((R, R))
    i = 0
    for r in range(R):
        for c in range(R):
            if c != r:
                p[r, c] = np.exp(theta[i])
                i += 1
        p[r] = p[r] / p[r].sum()
    with np.errstate(divide="ignore"):
        log_p = np.log(p)
    omega_logit = theta[-R:]
    return log_p, omega_logit


def savez_fast(path, arr, level=1):
    """np.savez_compressed-compatible single-array .npz writer at zlib
    level 1 (or ZIP_STORED when level=0).

    numpy pins its npz deflate at level 6; at production scale the INFER
    stage writes ~0.5 GB of trajectory archives per chromosome and the
    compression wall was a visible share of the warm stage. An .npz is
    just a zip of .npy members, so writing the member through zipfile with
    compresslevel=1 produces a file np.load reads
    identically (key "arr_0", like np.savez_compressed(path, arr)).
    level=0 writes STORED members — even level-1 deflate of the big
    trajectory archives is CPU-bound; np.load reads stored members
    identically and disk bandwidth absorbs the size."""
    import io as _io
    import zipfile

    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    buf = _io.BytesIO()
    np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
    if level:
        zf = zipfile.ZipFile(
            path, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=level
        )
    else:
        zf = zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED)
    with zf:
        zf.writestr("arr_0.npy", buf.getvalue())
