"""Process set-up shared by every entry point: the persistent compile cache
and the device-memory budget that the INFER planners size their vmapped
unit batches against."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# <checkout>/.jax_cache (listed in .gitignore). A fixed path, because the
# path is part of the cache key: a directory that moves never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"

# The CPU backend reports no memory statistics; its planners assume this
# much memory for one dispatch's filter history.
CPU_MEMORY_BUDGET_BYTES = 16 * 2**30

# Share of the device's allocator limit the planners may fill with filter
# history; the rest holds emission tables, checkpoints and XLA scratch.
DEVICE_MEMORY_SHARE = 0.85


def setup_compile_cache():
    """Point JAX's persistent compile cache at one directory and return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache lives at ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def device_memory_budget(device=None):
    """Bytes of filter history one dispatch may hold on ``device``.

    ``HYGEIA_HBM_BUDGET_GB`` overrides. Otherwise the budget is a share of
    the allocator's ``bytes_limit``; the CPU backend, which reports no
    statistics, takes CPU_MEMORY_BUDGET_BYTES. An accelerator that reports
    none is an error: guessing its size risks an out-of-memory retry loop."""
    env = os.environ.get("HYGEIA_HBM_BUDGET_GB")
    if env:
        return float(env) * 2**30
    if device is None:
        import jax

        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return float(stats["bytes_limit"]) * DEVICE_MEMORY_SHARE
    if device.platform == "cpu":
        return float(CPU_MEMORY_BUDGET_BYTES)
    raise RuntimeError(
        f"{device.platform} device {device.device_kind!r} reports no memory "
        "statistics; set HYGEIA_HBM_BUDGET_GB"
    )


def require_gpu():
    """The first JAX device, which must be a GPU; SystemExit otherwise.
    Measurement paths never fall back to the CPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX's first device is {device.platform} "
            f"({device.device_kind})"
        )
    return device


def card_description():
    """Name and power limit of each card, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. Read by a child process that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
