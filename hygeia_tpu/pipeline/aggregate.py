"""Aggregate per-(batch, seed) inference outputs into per-chromosome tables.

Replaces aggregate_results.py: walks `chrom_{chrom}_{batch}` result
directories, concatenates backward-simulation particle archives across seeds
(along the particle axis) and batches (along the genome axis), and writes the
per-chromosome csv.gz outputs with the reference's exact names and layout
(tab-separated, position-indexed; aggregate_results.py:165-206)."""

from __future__ import annotations

import os

import numpy as np

from hygeia_tpu.utils import io as hio


def aggregate_chromosome(
    results_dir,
    output_dir,
    chrom,
    *,
    seeds,
    num_particles,
    num_batches,
    compute_freqs=False,
    skip_missing=False,
):
    """skip_missing=False reproduces the reference exactly (aggregate_results
    .py:71-85 breaks at the first absent batch dir). skip_missing=True keeps
    going — the orchestrator uses it so one INFER unit that failed after all
    retries (errorStrategy ignore, nextflow.config:23-27) does not discard
    every later batch of the chromosome.

    Unit completion is keyed on the backward-particle archives, NOT on
    positions.csv.gz: infer_segment writes the trimmed input CSVs *before*
    inference runs, so a unit that died mid-compute (the OOM scenario the
    retry/ignore strategy targets) leaves positions.csv.gz present with no
    npz outputs — skip_missing must treat that as a missing batch rather
    than crash the AGGREGATE stage."""
    os.makedirs(output_dir, exist_ok=True)
    N = num_particles

    tables = {
        k: []
        for k in (
            "positions",
            "merged",
            "ctrl_regime",
            "case_regime",
            "ctrl_dur",
            "case_dur",
            "n_tot_ctrl",
            "n_tot_case",
            "obs_ctrl",
            "obs_case",
        )
    }
    processed = 0
    for batch in range(num_batches):
        data_dir = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
        pos_file = os.path.join(data_dir, "positions.csv.gz")
        if not os.path.isfile(pos_file):
            if skip_missing:
                continue
            break
        if skip_missing:
            # The archives are written only after inference succeeds; a unit
            # ignored after all retries may have the early input CSVs but no
            # archives. (With skip_missing=False a half-written unit raises,
            # like the reference's np.load would.)
            archives = [
                os.path.join(
                    data_dir,
                    f"optimal_backward_particles_{kind}_state_{N}_{seed}.npz",
                )
                for seed in range(seeds)
                for kind in ("merged", "control", "case")
            ]
            if not all(os.path.isfile(p) for p in archives):
                continue
        positions = hio.read_positions(pos_file)
        if positions.size == 0:
            # A zero-site batch: the reference's n_batches = 1 + n // S
            # convention (get_chrom_segments.py) creates an empty trailing
            # batch whenever the chromosome length is an exact multiple of
            # segment_size; its input files are empty. Zero rows, not a
            # failure — skip it in both modes.
            continue

        def _archives(kind):
            return [
                np.load(
                    os.path.join(
                        data_dir,
                        f"optimal_backward_particles_{kind}_state_{N}_{seed}.npz",
                    )
                )["arr_0"]
                for seed in range(seeds)
            ]

        # Seeds concatenate along the particle axis (aggregate_results.py:125-127).
        merged = np.concatenate(_archives("merged"), axis=-1)
        ctrl = np.concatenate(_archives("control"), axis=1)
        case = np.concatenate(_archives("case"), axis=1)

        tables["positions"].append(positions)
        tables["merged"].append(merged.astype(np.int8))
        # State archives are (T, B, 2) = (duration, regime) pairs.
        tables["ctrl_regime"].append(ctrl[:, :, 1].astype(np.int8))
        tables["case_regime"].append(case[:, :, 1].astype(np.int8))
        tables["ctrl_dur"].append(ctrl[:, :, 0].astype(np.int32))
        tables["case_dur"].append(case[:, :, 0].astype(np.int32))
        for key, fname in (
            ("n_tot_ctrl", "n_total_reads_control.csv.gz"),
            ("n_tot_case", "n_total_reads_case.csv.gz"),
            ("obs_ctrl", "observations_control.csv.gz"),
            ("obs_case", "observations_case.csv.gz"),
        ):
            tables[key].append(
                hio.read_count_matrix(os.path.join(data_dir, fname), np.int16)
            )
        processed += 1

    if processed == 0:
        raise FileNotFoundError(
            f"no batch outputs found under {results_dir} for chrom {chrom}"
        )

    index = np.concatenate(tables["positions"]).astype(np.int32)

    def _write(parts, name):
        values = np.concatenate(parts)
        # Native writer: itoa + parallel gzip members; the NumPy fallback
        # writes the same text (tests/test_pipeline.py).
        from hygeia_tpu.native.loader import write_int_table_gz

        header = ["pos"] + [str(c) for c in range(values.shape[1])]
        path = os.path.join(output_dir, name)
        if not write_int_table_gz(
            path, values, index=index, header="\t".join(header), sep="\t",
            level=1,
        ):
            hio.write_csv(path, [index, *values.T], header=header, sep="\t")
        return values

    ctrl_regimes = _write(tables["ctrl_regime"], f"control_regimes_chrom_{chrom}.csv.gz")
    case_regimes = _write(tables["case_regime"], f"case_regimes_chrom_{chrom}.csv.gz")
    merged_states = _write(tables["merged"], f"merge_states_chrom_{chrom}.csv.gz")
    hio.write_csv(
        os.path.join(output_dir, f"split_probs_{chrom}.csv.gz"),
        [index, (merged_states == 0).mean(axis=1)],
        header=["pos", "0"],
        sep="\t",
    )
    _write(tables["n_tot_ctrl"], f"n_total_reads_control_chrom_{chrom}.csv.gz")
    _write(tables["n_tot_case"], f"n_total_reads_case_chrom_{chrom}.csv.gz")
    _write(tables["obs_ctrl"], f"n_meth_reads_control_chrom_{chrom}.csv.gz")
    _write(tables["obs_case"], f"n_meth_reads_case_chrom_{chrom}.csv.gz")
    _write(tables["ctrl_dur"], f"control_durations_chrom_{chrom}.csv.gz")
    _write(tables["case_dur"], f"case_durations_chrom_{chrom}.csv.gz")

    if compute_freqs:
        for regimes, name in (
            (case_regimes, f"case_regimes_freq_{chrom}.csv"),
            (ctrl_regimes, f"control_regimes_freq_{chrom}.csv"),
        ):
            # Per-site regime frequencies: one column per regime value seen
            # anywhere, ascending; empty where a site never visits it.
            values = np.unique(regimes)
            freq = (regimes[:, :, None] == values).mean(axis=1)
            freq[freq == 0] = np.nan
            hio.write_csv(
                os.path.join(output_dir, name),
                [index, *freq.T],
                header=["pos"] + [str(v) for v in values],
                sep="\t",
            )
    return processed
