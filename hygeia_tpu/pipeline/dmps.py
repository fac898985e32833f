"""DMP (differentially methylated position) calling under FDR control.

Replaces get_dmps.py: the test statistic per site is the posterior
probability of the null, 1 - (1/B) * #{backward particles with control
regime != case regime} (get_dmps.py:46-69); sites are selected with the
plain and weighted FDR procedures at each threshold, with per-regime METEOR
frequency columns (:113-125) and position-gap false-negative weights
(:96-101: w_fn = 1 / mean of the 1,2,3-lag position differences)."""

from __future__ import annotations

import os

import numpy as np

from hygeia_tpu.pipeline.multiple_testing import fdr_procedure, weighted_fdr_procedure
from hygeia_tpu.utils import io as hio


def _regime_freqs(regimes, rows, n_regimes):
    freqs = np.zeros((len(rows), n_regimes))
    for i, row in enumerate(regimes[rows]):
        freqs[i] = np.bincount(row, minlength=n_regimes) / row.shape[0]
    return freqs


def _read_table(path):
    """(T, 1 + cols) float64 aggregate table (header row dropped, pos index
    in column 0) via the native loader, with a NumPy fallback."""
    from hygeia_tpu.native.loader import load_matrix

    m = load_matrix(path, skip_rows=1)
    if m is None:
        m = hio.read_headed_table(path, sep="\t")[1]
    return m


def call_dmps(
    results_dir,
    output_dir,
    chrom,
    *,
    n_regimes=6,
    fdr_thresholds=(0.01, 0.05),
    test_regime_combinations=False,
):
    os.makedirs(output_dir, exist_ok=True)
    ctrl = _read_table(
        os.path.join(results_dir, f"control_regimes_chrom_{chrom}.csv.gz")
    )[:, 1:].astype(np.int64)
    case = _read_table(
        os.path.join(results_dir, f"case_regimes_chrom_{chrom}.csv.gz")
    )[:, 1:].astype(np.int64)
    num_particles = ctrl.shape[-1]
    # Posterior probability of the null (same regime in both groups).
    null_stats = 1.0 - np.sum(ctrl != case, axis=1) / num_particles

    pos = _read_table(
        os.path.join(results_dir, f"split_probs_{chrom}.csv.gz")
    )[:, 0].astype(np.int64)
    # Mean of 1-, 2- and 3-lag position gaps (get_dmps.py:79-80); the first
    # sites, which lack a lag, take the reference's 1e5 fill.
    p = pos.astype(np.float64)
    gaps = np.full(len(p), np.nan)
    gaps[3:] = ((p[3:] - p[2:-1]) + (p[3:] - p[1:-2]) + (p[3:] - p[:-3])) / 3.0
    w_fp = np.ones(len(gaps))
    w_fn = 1.0 / np.where(np.isnan(gaps), 1e5, gaps)
    chrom_col = np.full(len(pos), str(chrom), object)

    meteor = [f"Control_METEOR_{i + 1}" for i in range(n_regimes)] + [
        f"Case_METEOR_{i + 1}" for i in range(n_regimes)
    ]

    def _write(name, rows, stats, fn_weights, with_freqs=True,
               float_format="%.4f"):
        cols = [chrom_col[rows], pos[rows], stats,
                np.broadcast_to(np.asarray(fn_weights, np.float64), (len(rows),))]
        header = ["chrom", "position", "null_stats", "false_negative_weight"]
        if with_freqs:
            cols += [*_regime_freqs(ctrl, rows, n_regimes).T,
                     *_regime_freqs(case, rows, n_regimes).T]
            header += meteor
        hio.write_csv(os.path.join(output_dir, name), cols, header=header,
                      float_format=float_format)

    for thr in fdr_thresholds:
        _, _, cutoff = fdr_procedure(null_stats, thr)
        rows = np.flatnonzero(null_stats < cutoff)
        _write(f"dmp_{thr}.csv", rows, null_stats[rows], 1.0)

        w_rows, _ = weighted_fdr_procedure(null_stats, thr, w_fp, w_fn)
        w_rows = np.sort(w_rows)
        _write(f"weighted_dmp_{thr}.csv", w_rows, null_stats[w_rows],
               w_fn[w_rows])

        if test_regime_combinations:
            for i in range(n_regimes):
                for j in range(n_regimes):
                    if i == j:
                        continue
                    stats_ij = 1.0 - np.sum((ctrl == i) & (case == j), axis=1) / num_particles
                    _, _, cut_ij = fdr_procedure(stats_ij, thr)
                    rows_ij = np.flatnonzero(stats_ij < cut_ij)
                    _write(f"dmp_{i}_{j}_{thr}.csv", rows_ij,
                           stats_ij[rows_ij], 1.0, with_freqs=False,
                           float_format=None)
                    wr, _ = weighted_fdr_procedure(stats_ij, thr, w_fp, w_fn)
                    wr = np.sort(wr)
                    _write(f"weighted_dmp_{i}_{j}_{thr}.csv", wr,
                           stats_ij[wr], w_fn[wr], with_freqs=False,
                           float_format=None)
