"""Device-mesh construction for genome-block x seed parallelism.

The reference parallelises by fanning out (chromosome x segment x seed)
Nextflow tasks over containers with file staging (SURVEY.md section 2.4).
The equivalent here: a 2D ``jax.sharding.Mesh`` with axes

  "genome" — genome blocks (the sequence-parallel axis; each block is one
             halo-buffered segment, the analog of an INFER task),
  "seed"   — independent Monte-Carlo replicates (data parallel).

Work stays on-device end to end; only ingest/egress touches files.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_genome=None, n_seed=1, devices=None):
    """Build a (genome, seed) mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n_dev = devices.size
    if n_genome is None:
        n_genome = n_dev // n_seed
    if n_genome * n_seed != n_dev:
        raise ValueError(
            f"mesh {n_genome}x{n_seed} does not match {n_dev} devices"
        )
    return Mesh(devices.reshape(n_genome, n_seed), ("genome", "seed"))
