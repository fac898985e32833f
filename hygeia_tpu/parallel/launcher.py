"""Multi-process launch helper.

The reference scales out with AWS Batch + Nextflow file staging
(aws.config, run.sh); here the equivalent is one SPMD JAX program across
processes: every process runs the same pipeline entry, `jax.distributed`
connects them, and the global (genome x seed) mesh spans all their devices.
Only process 0 writes aggregate outputs.

A multi-process run starts when the coordinator is named, either through
the arguments or through ``JAX_COORDINATOR_ADDRESS`` (with
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, which jax.distributed reads
itself). Otherwise the call is a no-op and the run is a single process.
"""

from __future__ import annotations

import os


def initialize_distributed(
    coordinator_address=None, num_processes=None, process_id=None
):
    """Initialise jax.distributed for a multi-process run; returns the
    (process_index, process_count) pair. A failed start raises: a process
    that cannot join its cluster must not run on alone."""
    import jax

    if coordinator_address is not None or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    ):
        if not jax.distributed.is_initialized():
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    return jax.process_index(), jax.process_count()


def is_primary_host():
    import jax

    return jax.process_index() == 0
