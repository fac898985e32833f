"""BED9 export of single-group regime probabilities.

Replaces bin/make_bed_file: each CpG site becomes a BED9 record named after
its most probable regime ("equiprobable" on ties), scored by the maximum
probability, coloured with the reference's fixed 6-regime palette
(make_bed_file:47-50)."""

from __future__ import annotations

import os

import numpy as np

from hygeia_tpu.utils.io import require_pandas

# Reference palette (make_bed_file:49); extended palettes cycle for R > 6.
_REGIME_COLOURS = [
    "248,118,109",
    "183,159,0",
    "0,186,56",
    "0,191,196",
    "97,156,255",
    "245,100,227",
]
_TIE_COLOUR = "128,128,128"


def make_bed(chrom, regimes_file, output_file, *, compress=False):
    """Write the BED9 track; with compress=True also bgzip-compress it to
    `<output_file>.gz` and build a tabix index `<output_file>.gz.tbi`,
    matching the reference module's `bgzip` + `tabix -p bed` post-steps
    (modules/single_group/4_generate_single_group_bed_files.nf:24-30).
    Returns the BED dataframe."""
    pd = require_pandas("BED export")
    regimes = pd.read_csv(regimes_file)
    regime_cols = [c for c in regimes.columns if c != "genomic_position"]
    probs = regimes[regime_cols].to_numpy(float)
    score = probs.max(axis=1)
    ties = (probs == score[:, None]).sum(axis=1) > 1
    best = probs.argmax(axis=1)
    names = np.where(ties, "equiprobable", np.asarray(regime_cols)[best])
    colours = np.where(
        ties,
        _TIE_COLOUR,
        np.asarray(
            [_REGIME_COLOURS[i % len(_REGIME_COLOURS)] for i in range(len(regime_cols))]
        )[best],
    )
    pos = regimes["genomic_position"].to_numpy(np.int64)
    bed = pd.DataFrame(
        {
            "chr": chrom,
            "start": pos - 1,
            "end": pos + 1,
            "name": names,
            "score": score,
            "strand": ".",
            "thickStart": pos - 1,
            "thickEnd": pos + 1,
            "itemRgb": colours,
        }
    ).sort_values(["chr", "start"])
    out_dir = os.path.dirname(output_file)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    bed.to_csv(output_file, sep="\t", header=False, index=False)
    if compress:
        from hygeia_tpu.utils.bgzf import compress_file
        from hygeia_tpu.utils.tabix import build_index

        gz_path = compress_file(str(output_file), delete_src=True)
        build_index(gz_path)
    return bed
