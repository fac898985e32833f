"""Multi-host launcher test: a real 2-process jax.distributed CPU cluster.

The reference scales across machines with AWS Batch + file staging
(aws.config, nextflow.config:29); the analog here is jax.distributed over a
global mesh (parallel/launcher.py). This test spawns two OS processes
that connect through `initialize_distributed`, build one global mesh spanning
both processes' devices, and reduce across it with a psum over the "genome"
axis — covering the process_count > 1 code path end to end.
"""

import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
import jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P

from hygeia_tpu.parallel.launcher import initialize_distributed, is_primary_host

pid, port = int(sys.argv[1]), sys.argv[2]
idx, count = initialize_distributed(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert (idx, count) == (pid, 2), (idx, count)
assert is_primary_host() == (pid == 0)
assert len(jax.devices()) == 4  # global devices across both processes

mesh = jax.make_mesh((4,), ("genome",))

@partial(jax.shard_map, mesh=mesh, in_specs=P("genome"), out_specs=P())
def total(x):
    return jax.lax.psum(jnp.sum(x), "genome")

local = np.arange(6, dtype=np.float32).reshape(2, 3) + 100.0 * pid
garr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("genome")), local
)
out = jax.jit(total)(garr)
print("RESULT", float(np.asarray(out)), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum(tmp_path):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    # sum over both processes: (0+..+5) + (100+..+105) = 15 + 615 = 630
    for out in outs:
        assert "RESULT 630.0" in out, out


def test_no_coordinator_runs_as_one_process(monkeypatch):
    from hygeia_tpu.parallel.launcher import initialize_distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() == (0, 1)


def test_init_failure_propagates(monkeypatch):
    """A process that cannot join its cluster must not run on alone."""
    import jax
    import pytest

    from hygeia_tpu.parallel.launcher import initialize_distributed

    def refuse(**kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize", refuse)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        initialize_distributed(
            coordinator_address="localhost:1", num_processes=2, process_id=0
        )
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        initialize_distributed()
