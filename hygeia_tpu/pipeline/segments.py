"""Chromosome segmentation: split a chromosome's CpG positions into
fixed-size segments of work (get_chrom_segments.py).

num_segments = 1 + n_positions // segment_size (reference :32 — note the
trailing partial segment always exists, even when n_positions is an exact
multiple; downstream batch tasks with an out-of-range index exit cleanly)."""

from __future__ import annotations

import numpy as np

from hygeia_tpu.utils import io as hio


def write_chrom_segments(input_file, chromosome, segment_size, output_csv):
    """Write the (chrom, segment_index) table for the chromosome whose
    positions file is ``input_file``; returns the number of segments."""
    return write_segments_csv(
        output_csv, len(hio.read_positions(input_file)), chromosome, segment_size
    )


def write_segments_csv(output_csv, n_positions, chromosome, segment_size):
    num_segments = 1 + n_positions // segment_size
    hio.write_csv(
        output_csv,
        [np.full(num_segments, str(chromosome), object), np.arange(num_segments)],
        header=["chrom", "segment_index"],
    )
    return num_segments
