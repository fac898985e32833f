"""Blocked theta-stage geometry — the ONE place it lives. The values define
the blocked theta output (PARITY.md); they have not been swept on a GPU.
Shared by the stage itself (single_group/blocked.py), the orchestrator's
per-chromosome and batched pre-pass call sites, and the pipeline's AOT
prewarm thread: these must agree or the prewarm compiles programs at stale
shapes and the two stage paths run different block geometry.
No jax import — safe to load from anywhere, including stub runs."""

THETA_BLOCK_SIZE = 49152
THETA_HALO = 4096
THETA_WARMUP_SITES = 65536
# Chromosomes below this length keep the sequential / t_limit-batched path.
THETA_BLOCK_THRESHOLD = 150_000
