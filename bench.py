"""Benchmark: two-group inference throughput (CpG sites/sec) on one GPU.

Workload: the production hot path (SURVEY.md section 3.1) — deterministic-
proposal particle filter with optimal finite-state resampling (M=50 ->
N=2400 particles) plus backward simulation (B=25 samples), R=6 regimes,
2 samples/group — vmapped over independent (segment, seed) work units to
fill the device, all inside one jit.

Baseline: the reference's containerised TF-2.3 CPU filter. It publishes no
numbers (BASELINE.md) and TF 2.3 cannot be installed here, so the baseline
was MEASURED with tools/reference_cpu_baseline.py — a NumPy f64 re-creation
of the reference algorithm with its exact loop structure (sequential
per-ancestor expansion, optimal resampling, (B, N) backward kernels;
cross-validated against this engine's logZ in tests/test_baseline_harness
.py): 116.6 sites/s at the production shape (T=2048, M=50 -> N=2400, B=25)
on a CPU. We charge the baseline DOUBLE that (233 sites/s) as
headroom for TF graph-mode executing the same per-step ops with lower
dispatch overhead than NumPy. vs_baseline = ours / 233. (BASELINE.json's
10x north-star is beaten at anything >10.)

Refuses to run without a GPU. Prints the card's name and power limit, then
ONE JSON line:
  {"metric": "cpg_sites_per_sec", "value": N, "unit": "sites/s",
   "vs_baseline": N, "device": {...}}
"""

import json
import os
import time

import numpy as np

# All benchmark compute sits inside one jit, so dispatch latency is not
# what is measured.
T = int(os.environ.get("HYGEIA_BENCH_T", 4096))
# Vmapped work units; not yet swept on the GPU. History memory at
# 32x4096 sites is ~4.7 GB.
UNITS = int(os.environ.get("HYGEIA_BENCH_UNITS", 32))
M = int(os.environ.get("HYGEIA_BENCH_M", 50))
B = int(os.environ.get("HYGEIA_BENCH_B", 25))
REPS = int(os.environ.get("HYGEIA_BENCH_REPS", 3))
# 2 x the measured 116.6 sites/s of tools/reference_cpu_baseline.py (see
# module docstring and BASELINE.md "Measured baseline").
BASELINE_SITES_PER_SEC = float(os.environ.get("HYGEIA_BASELINE_SPS", 233.0))


def main():
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.runtime import card_description, require_gpu, setup_compile_cache

    device = require_gpu()
    print(card_description(), flush=True)
    # Compilation is not part of the measured quantity (REPS run after a
    # warm-up call); the persistent cache only shortens the warm-up.
    setup_compile_cache()

    from hygeia_tpu.two_group.model import make_params
    from hygeia_tpu.two_group.filter import run_filter
    from hygeia_tpu.two_group.backward import backward_simulation
    from hygeia_tpu.ops.emissions import emission_log_prob_table

    R = 6
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(R, R))
    np.fill_diagonal(logits, -np.inf)
    p = np.where(np.isfinite(logits), np.exp(logits), 0.0)
    p /= p.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_p = np.log(p)
    params = make_params(
        mu=np.array([0.95, 0.05, 0.8, 0.2, 0.5, 0.5]),
        sigma=np.array([0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]),
        p_softmax_control=log_p,
        omega_logit_control=np.full(R, 2.0),
        omega_case=0.8,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=np.log(0.1),
        split_prob=0.01,
        minimum_duration=3,
        d_max=T + 1,
    )

    n = rng.poisson(20, size=(UNITS, T, 2)).astype(np.float32)
    y = np.minimum(rng.poisson(8, size=(UNITS, T, 2)), n).astype(np.float32)

    @jax.jit
    def bench_step(keys, y, n):
        def unit(key, y_u, n_u):
            e_c = emission_log_prob_table(y_u, n_u, params.alpha, params.beta)
            e_k = emission_log_prob_table(
                jnp.minimum(y_u + 1, n_u), n_u, params.alpha, params.beta
            )
            res = run_filter(key, params, e_c, e_k, M)
            traj = backward_simulation(
                jax.random.fold_in(key, 1),
                params,
                res.log_weights,
                res.particles,
                B,
            )
            # Reduce on-device so the transfer back is negligible.
            split = jnp.mean((traj[..., 0] == 0).astype(jnp.float32), axis=1)
            return res.log_normalizing_constant, split, res.degenerate_steps

        return jax.vmap(unit)(keys, y, n)

    keys = jax.random.split(jax.random.PRNGKey(0), UNITS)
    y_d, n_d = jnp.asarray(y), jnp.asarray(n)

    # Warm-up / compile.
    log_z, split, degen = bench_step(keys, y_d, n_d)
    log_z.block_until_ready()
    import sys

    if int(np.asarray(degen).sum()) or not np.isfinite(np.asarray(log_z)).all():
        print(
            f"WARNING: degenerate steps {np.asarray(degen).tolist()}, "
            f"logZ {np.asarray(log_z).tolist()}",
            file=sys.stderr,
        )

    times = []
    for rep in range(REPS):
        k = jax.random.split(jax.random.PRNGKey(rep + 1), UNITS)
        t0 = time.perf_counter()
        log_z, split, degen = bench_step(k, y_d, n_d)
        log_z.block_until_ready()
        times.append(time.perf_counter() - t0)

    elapsed = float(np.median(times))
    sites_per_sec = UNITS * T / elapsed
    print(
        json.dumps(
            {
                "metric": "cpg_sites_per_sec",
                "value": round(sites_per_sec, 1),
                "unit": "sites/s",
                "vs_baseline": round(sites_per_sec / BASELINE_SITES_PER_SEC, 2),
                "device": {
                    "platform": device.platform,
                    "kind": device.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
