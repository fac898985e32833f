"""gemBS-format methylation preprocessing.

Replaces preprocess_gembs.py: gemBS tab files already carry per-CpG
methylated/unmethylated counts as `{sample}:non_conv` / `{sample}:conv`
columns keyed by `Pos0`, so no strand collapse is needed — filter to
(chr{chromosome}, Ref == 'CG'), outer-merge onto the reference CpG
positions, impute zeros, and write the same count-matrix outputs as the BED
path (reference :140-186, :188-260).

Note the gemBS path expects `chr`-prefixed contig names in both the CpG file
(`seqID == chr{chromosome}`, :109-111) and the sample files, unlike the BED
path which compares raw chromosome strings.

Per-sample failure semantics mirror the reference exactly (:144-184): a
sample whose chromosome slice is empty, whose required columns are missing,
or whose file is unreadable keeps its column SLOT as all-NaN columns (zero
counts after nan_to_num); a sample file that does not exist is skipped with
no column slot at all (the reference's `continue` at :147 — note this can
misalign the control/case column split downstream; preserved for parity,
tested byte-identically in tests/test_preprocess_gembs_property.py).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from hygeia_tpu.utils.io import require_pandas

logger = logging.getLogger(__name__)


def read_gembs_sample(path, chromosome, sample_id):
    """Return the (Pos0, non_conv, conv) slice for one sample, or None when
    the reference would fall back to all-NaN column slots (:156-172)."""
    pd = require_pandas("gemBS preprocessing")
    comp = "gzip" if str(path).endswith(".gz") else None
    df = pd.read_csv(path, sep="\t", compression=comp)
    df = df[(df["Contig"] == f"chr{chromosome}") & (df["Ref"] == "CG")]
    if df.empty:
        return None
    cols = ["Pos0", f"{sample_id}:non_conv", f"{sample_id}:conv"]
    if any(c not in df.columns for c in cols):
        return None
    return df[cols].copy()


def process_gembs(
    cpg_file_path,
    output_path,
    chromosome,
    *,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
):
    pd = require_pandas("gemBS preprocessing")
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    comp = "gzip" if str(cpg_file_path).endswith(".gz") else None
    cpg = pd.read_csv(cpg_file_path, sep="\t", compression=comp)
    cpg = cpg[cpg["seqID"] == f"chr{chromosome}"]
    if cpg.empty:
        raise ValueError(f"No CpG sites found for chromosome {chromosome}")

    merged = pd.DataFrame({"Pos0": (cpg["start"] - 1).astype(np.int64)})
    for paths, names in (
        (control_data_paths, control_id_names),
        (case_data_paths, case_id_names),
    ):
        for path, name in zip(paths, names):
            if not Path(path).exists():
                # Reference :145-147: missing file -> NO column slot.
                logger.error("gemBS sample file not found, skipping: %s", path)
                continue
            try:
                sample = read_gembs_sample(path, chromosome, name)
            except Exception as exc:  # reference :179-184
                logger.error("error processing gemBS sample %s: %s", name, exc)
                sample = None
            if sample is None:
                # Empty chromosome slice / missing columns / read error:
                # keep the column slot as NaN (zero counts after nan_to_num).
                merged[f"{name}:non_conv"] = np.nan
                merged[f"{name}:conv"] = np.nan
                continue
            merged = pd.merge(merged, sample, on="Pos0", how="outer")
    merged = merged.sort_values("Pos0").reset_index(drop=True)
    merged = merged[merged["Pos0"].notna()]

    positions = merged["Pos0"].to_numpy(np.int64)
    data = np.nan_to_num(merged.drop(columns=["Pos0"]).to_numpy(float))

    # Column split mirroring extract_count_arrays (:188-237) exactly, incl.
    # its shape guards (load-bearing when a missing file dropped a slot).
    n_control = len(control_id_names)
    n_case = len(case_id_names)
    empty = np.array([]).reshape(len(positions), 0)
    meth_control = total_control = meth_case = total_case = empty
    if n_control > 0:
        end = 2 * n_control
        if data.shape[1] >= end:
            meth_control = data[:, 0:end:2]
            total_control = meth_control + data[:, 1:end:2]
            if n_case > 0 and data.shape[1] > end:
                meth_case = data[:, end::2]
                total_case = meth_case + data[:, end + 1 :: 2]
    elif n_case > 0:
        meth_case = data[:, 0::2]
        total_case = meth_case + data[:, 1::2]

    files = {
        "positions": positions,
        "cpg_sites_merged": np.array([len(positions)]),
    }
    if meth_control.size > 0:
        files["n_methylated_reads_control"] = meth_control
        files["n_total_reads_control"] = total_control
    if meth_case.size > 0:
        files["n_methylated_reads_case"] = meth_case
        files["n_total_reads_case"] = total_case
    for name, arr in files.items():
        np.savetxt(
            output_path / f"{name}_{chromosome}.txt.gz", arr, delimiter=",", fmt="%s"
        )
    return len(positions)
