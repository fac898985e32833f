"""BED-format methylation preprocessing.

Replaces the reference's polars processor (preprocess_bed.py) with a pandas
implementation producing byte-identical count matrices:

1. per sample: filter to (chromosome, ref CG), collapse +/- strands by
   joining +.end == -.start (coverage-weighted methylation average, position
   = +.start, or -.start - 1 when only the minus strand is covered;
   reference collapse_strands :184-263),
2. counts: methylated = round(cov * pct / 100),
   unmethylated = round(cov * (100 - pct) / 100) (:317-327),
3. outer-join all samples onto the reference CpG positions (0-based,
   Pos0 = cpg.start - 1), imputing 0 reads where missing (:398-402),
4. write positions / n_methylated_reads_* / n_total_reads_* /
   cpg_sites_merged as comma-separated .txt.gz (:430-473).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from hygeia_tpu.utils.io import require_pandas

_BED_COLUMNS = [
    "chr",
    "start",
    "end",
    "name",
    "score",
    "strand",
    "thickStart",
    "thickEnd",
    "itemRgb",
    "coverage",
    "percent_methylated",
    "ref_genotype",
    "sample_genotype",
    "quality_score",
]


def collapse_strands(bed):
    """Merge +/- strand records of each CpG into one site."""
    pd = require_pandas("BED preprocessing")
    pos = bed[bed["strand"] == "+"]
    neg = bed[bed["strand"] == "-"]
    merged = pd.merge(
        pos,
        neg,
        left_on=["chr", "end"],
        right_on=["chr", "start"],
        how="outer",
        suffixes=("", "_neg"),
    )
    cov_p = merged["coverage"].fillna(0).astype(float)
    cov_n = merged["coverage_neg"].fillna(0).astype(float)
    pct_p = merged["percent_methylated"].fillna(0).astype(float)
    pct_n = merged["percent_methylated_neg"].fillna(0).astype(float)
    total = cov_p + cov_n
    start = merged["start"].where(
        merged["start"].notna(), merged["start_neg"] - 1
    )
    out = pd.DataFrame(
        {
            "start": start,
            "total_coverage": total,
            "avg_percent_methylated": np.where(
                total > 0, (cov_p * pct_p + cov_n * pct_n) / np.where(total > 0, total, 1.0), 0.0
            ),
        }
    )
    out = out[out["total_coverage"] > 0]
    return out.sort_values("start").reset_index(drop=True)


def _round_half_away(x):
    """Round half AWAY from zero on non-negative values.

    The reference's `.round()` is polars 1.8 == Rust `f64::round`, which
    rounds .5 away from zero; numpy's np.round is banker's rounding (half to
    even) and disagrees at every exact .5 (e.g. cov*pct/100 = 2.5: reference
    3, np.round 2). Counts are non-negative so floor(x + 0.5) suffices."""
    return np.floor(np.asarray(x, float) + 0.5)


def read_bed_sample(path, chromosome):
    """Read one BED methylation file -> collapsed per-CpG counts frame."""
    pd = require_pandas("BED preprocessing")
    bed = pd.read_csv(
        path,
        sep="\t",
        skiprows=1,
        header=None,
        names=_BED_COLUMNS,
        usecols=range(len(_BED_COLUMNS)),
    )
    bed = bed[
        (bed["chr"].astype(str) == str(chromosome)) & (bed["ref_genotype"] == "CG")
    ]
    if bed.empty:
        return pd.DataFrame(columns=["Pos0", "methylated", "unmethylated"])
    collapsed = collapse_strands(bed)
    cov = collapsed["total_coverage"].astype(float)
    pct = collapsed["avg_percent_methylated"].astype(float)
    return pd.DataFrame(
        {
            "Pos0": collapsed["start"].astype(np.int64),
            "methylated": _round_half_away(cov * pct / 100.0).astype(np.int64),
            "unmethylated": _round_half_away(
                cov * (100.0 - pct) / 100.0
            ).astype(np.int64),
        }
    )


def process_bed(
    cpg_file_path,
    output_path,
    chromosome,
    *,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
):
    """Run the full preprocessing; returns the number of CpG sites written."""
    pd = require_pandas("BED preprocessing")
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    cpg = pd.read_csv(cpg_file_path, sep="\t")
    cpg = cpg[cpg["seqID"].astype(str) == str(chromosome)]
    if cpg.empty:
        raise ValueError(f"No CpG sites found for chromosome {chromosome}")

    merged = pd.DataFrame({"Pos0": (cpg["start"] - 1).astype(np.int64)})

    def _add_group(paths, names):
        nonlocal merged
        for path, name in zip(paths, names):
            if not os.path.exists(path):
                # The reference logs the missing file and keeps the sample as
                # all-null columns (process_sample_data :288-296) -> zeros
                # after nan_to_num; the column slot must exist so later
                # samples keep their positions in the interleaved layout.
                merged[f"{name}:non_conv"] = np.nan
                merged[f"{name}:conv"] = np.nan
                continue
            sample = read_bed_sample(path, chromosome)
            sample = sample.rename(
                columns={
                    "methylated": f"{name}:non_conv",
                    "unmethylated": f"{name}:conv",
                }
            )
            merged = pd.merge(merged, sample, on="Pos0", how="outer")

    _add_group(control_data_paths, control_id_names)
    _add_group(case_data_paths, case_id_names)
    merged = merged.sort_values("Pos0").reset_index(drop=True)
    merged = merged[merged["Pos0"].notna()]

    positions = merged["Pos0"].to_numpy(np.int64)
    data = merged.drop(columns=["Pos0"]).to_numpy(float)
    data = np.nan_to_num(data)

    n_control = len(control_id_names)
    n_case = len(case_id_names)
    files = {
        "positions": positions,
        "cpg_sites_merged": np.array([len(positions)]),
    }
    if n_control:
        meth = data[:, 0 : 2 * n_control : 2]
        unmeth = data[:, 1 : 2 * n_control : 2]
        files["n_methylated_reads_control"] = meth
        files["n_total_reads_control"] = meth + unmeth
    if n_case:
        off = 2 * n_control
        meth = data[:, off::2]
        unmeth = data[:, off + 1 :: 2]
        files["n_methylated_reads_case"] = meth
        files["n_total_reads_case"] = meth + unmeth

    for name, arr in files.items():
        np.savetxt(
            output_path / f"{name}_{chromosome}.txt.gz", arr, delimiter=",", fmt="%s"
        )
    return len(positions)
