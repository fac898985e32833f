"""The `infer` verb: segment+buffer windowing, filter + backward simulation,
reference-format outputs.

Replaces run_inference_two_groups.py: identical flags-level semantics —
segment slicing with halo buffers (:194-218), halo trimming via return_index
(:213-218), and output files with the reference's exact names (:246-255,
:298-322). Unlike the reference (one process per seed), `infer_segment` can
run several seeds in a single device invocation.
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from hygeia_tpu.runtime import device_memory_budget
from hygeia_tpu.utils.io import savez_fast
from hygeia_tpu.ops.emissions import emission_log_prob_table
from hygeia_tpu.two_group.model import make_params
from hygeia_tpu.two_group.filter import run_filter
from hygeia_tpu.two_group.backward import backward_simulation, smoothing_functionals
from hygeia_tpu.utils import io as hio

DEFAULT_MU = (0.95, 0.05, 0.80, 0.20, 0.50, 0.50)
DEFAULT_SIGMA = (0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751)

# Configurations already primed by prewarm_chromosome_streamed (in-process).
_PREWARMED = set()

# Device bytes one seed's filter history costs per (site, particle): XLA
# holds about twice the 15 B/particle-site history (filter._narrow) inside
# the fused program.
HISTORY_BYTES_PER_SITE_PARTICLE = 34


def shared_unit_width(groups, block_size, n_particles, n_seeds, *,
                      max_units=None, budget=None):
    """One vmap width S for every window-length group of a chromosome
    (``groups`` maps window length -> number of batches): as many units as
    the largest group holds, bounded by EVERY group's own memory cap, so no
    group's dispatch outgrows the device budget."""
    if budget is None:
        budget = device_memory_budget()
    cap = min(
        max(1, int(budget // (min(t_w, block_size) * n_particles
                              * HISTORY_BYTES_PER_SITE_PARTICLE)))
        for t_w in groups
    )
    if max_units is not None:
        cap = min(cap, int(max_units))
    return max(1, min(cap, max(n * n_seeds for n in groups.values())))


def _mark_when_all_succeed(cfg_key, jobs):
    """Wrap prewarm jobs so ``cfg_key`` joins _PREWARMED once every one of
    them has run without raising."""
    import threading

    lock = threading.Lock()
    left = [len(jobs)]

    def wrap(job):
        def run_job():
            job()
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    _PREWARMED.add(cfg_key)

        return run_job

    return [wrap(j) for j in jobs]


def segment_window(n_positions, batch, segment_size, buffer_size):
    """(slice_range, return_range) for a batch (run_inference_two_groups.py:
    194-218). Returns None if the batch index is out of range."""
    if batch * segment_size > n_positions:
        return None
    lo = max(0, batch * segment_size - buffer_size)
    hi = min((batch + 1) * segment_size + buffer_size, n_positions)
    n_slice = hi - lo
    if batch == 0:
        ret = range(0, min(n_slice, segment_size))
    else:
        ret = range(buffer_size, min(n_slice, buffer_size + segment_size))
    return range(lo, hi), ret


def prewarm_chromosome_streamed(
    *,
    n_positions,
    segment_size=100000,
    buffer_size=5000,
    n_seeds=2,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=50,
    num_samples_backward=25,
    streaming_blocks=16384,
    weight_dtype=jnp.float32,
    run=True,
):
    """Best-effort cache priming for the streamed-batched INFER stage.

    AOT-compiles the streamed program set at exactly the shapes
    infer_chromosome_streamed will request (window-length groups, one
    shared d_max + vmap width) so the compiles happen BEFORE (or, from a
    background thread, DURING) the single-group theta stage instead of
    serialising in front of the first INFER dispatch (the reference
    container pays no compile tax, modules/two_group/4_infer.nf:44-49).
    Whether this still pays with a local GPU compiler is not measured
    (ROADMAP). Shape planning mirrors
    infer_chromosome_streamed; drift only wastes the prewarm, never changes
    results.

    Idempotent per configuration: a second SUCCESSFUL run=True call (e.g.
    the warm pass of a two-pass bench) is a no-op; a failed attempt leaves
    the configuration unmarked so a retry can prime it."""
    from concurrent.futures import ThreadPoolExecutor

    from hygeia_tpu.two_group.streaming import aot_compile_jobs

    cfg_key = (
        int(n_positions), int(segment_size), int(buffer_size), int(n_seeds),
        tuple(np.asarray(mu, np.float64)), int(minimum_duration),
        int(num_resampled_particles), int(num_samples_backward),
        int(streaming_blocks), jnp.dtype(weight_dtype).name,
    )
    if cfg_key in _PREWARMED:
        return 0 if run else []

    mu = np.asarray(mu, np.float64)
    R = len(mu)
    M = num_resampled_particles
    N = M * (2 * R + R * R)
    B = num_samples_backward
    W = int(streaming_blocks)
    n_batches = 1 + n_positions // segment_size

    # Window-length groups (segment_window semantics).
    groups = {}
    for batch in range(n_batches):
        win = segment_window(n_positions, batch, segment_size, buffer_size)
        if win is None:
            continue
        t_w = win[0].stop - win[0].start
        groups[t_w] = groups.get(t_w, 0) + 1

    # Identity transition matrix placeholder (theta is not known yet; the
    # program shapes depend only on (R, min_duration, d_max, M, B, dtype)).
    p0 = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p0, 0.0)
    with np.errstate(divide="ignore"):
        log_p = np.log(p0)
    from hygeia_tpu.ops.distributions import logit as _logit

    # One d_max and one shared vmap width across groups, mirroring
    # infer_chromosome_streamed's program-count optimisation.
    d_max_all = max(64, max(groups) + 1)
    s_shared = shared_unit_width(groups, W, N, n_seeds)
    params = make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=log_p,
        omega_logit_control=np.asarray(_logit(jnp.full((R,), 0.9))),
        omega_case=omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=merge_log_prob,
        split_prob=split_prob,
        minimum_duration=minimum_duration,
        d_max=d_max_all,
    )
    jobs = []
    seen = set()
    for t_w in sorted(groups):
        jobs.extend(
            aot_compile_jobs(
                params, s_shared, t_w, M, B,
                block_size=W, weight_dtype=weight_dtype, seen=seen,
            )
        )
    if not run:
        # Callers (the orchestrator's prewarm thread) execute the jobs
        # themselves; the configuration counts as primed once every job
        # has succeeded.
        return _mark_when_all_succeed(cfg_key, jobs)
    # Compiles parallelise across a modest thread pool.
    ok = True
    with ThreadPoolExecutor(max_workers=min(8, max(1, len(jobs)))) as pool:
        futures = [pool.submit(j) for j in jobs]
        for f in futures:
            try:
                f.result()
            except Exception:  # noqa: BLE001 — priming is best-effort
                ok = False
    if ok:
        _PREWARMED.add(cfg_key)
    return len(jobs)


def infer_segment(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    batch=0,
    seed=0,
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    multinomial=False,
    robust=False,
    robust_beta=0.05,
    trace_dir=None,
    weight_dtype=jnp.float32,
    marginal=False,
    marginal_epsilon=0.01,
    marginal_window=64,
    max_seeds_per_call=None,
    streaming_blocks=None,
):
    """Run inference for one (chrom, batch, seed) work unit.

    robust=True swaps the BetaBinomial emissions for the beta-divergence
    score (the case_control_robust_regime_model variant, default beta 0.05
    per case_control_robust_regime_model.py:62).

    marginal=True replaces the store-everything filter + backward simulation
    with the adaptive-lag marginal filter (two_group/marginal.py — the
    reference's particle_filter_deterministic_proposal.py +
    smoothing_functions.py pair): O(1) memory in segment length, writing the
    split/regime probability outputs directly from smoothing functionals.
    No backward-particle archives are produced in this mode.

    max_seeds_per_call caps the vmapped seed chunk per device dispatch (on
    top of the device-memory budget) — the orchestrator lowers it on retry
    attempts the way Nextflow escalates task.attempt resources.

    streaming_blocks=W switches the monolithic fused filter+backward to the
    checkpointed streaming path (two_group/streaming.py): O(W*N) history
    memory instead of O(T*N), so several seeds stay resident per dispatch
    on long segments (residency is throughput on this latency-bound
    workload). Exact — same smoothing distribution, different RNG stream
    (PARITY.md). Same output files.

    trace_dir: if set, the device computation runs under jax.profiler.trace
    (viewable in TensorBoard/XProf) — the engine-level analog of the
    reference's Nextflow -with-trace artifacts."""
    mu = np.asarray(mu, np.float64)
    R = len(mu)

    theta = hio.read_theta(
        os.path.join(single_group_dir, f"theta_{chrom}.csv.gz")
    )
    p_softmax, omega_logit_control = hio.theta_file_to_p_softmax(theta, R)

    positions = hio.read_positions(os.path.join(data_dir, f"positions_{chrom}.txt.gz"))
    window = segment_window(len(positions), batch, segment_size, buffer_size)
    if window is None:
        print("Batch index is too large for the chromosome")
        return None
    sl, ret = window
    sl = slice(sl.start, sl.stop)
    ret = slice(ret.start, ret.stop)

    def _load(name):
        return hio.read_count_matrix(
            os.path.join(data_dir, f"{name}_{chrom}.txt.gz")
        )[sl]

    n_total_control = _load("n_total_reads_control")
    n_meth_control = _load("n_methylated_reads_control")
    n_total_case = _load("n_total_reads_case")
    n_meth_case = _load("n_methylated_reads_case")
    positions = positions[sl]
    assert np.sum(n_total_case < n_meth_case) == 0
    assert np.sum(n_total_control < n_meth_control) == 0
    T = n_total_control.shape[0]

    path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
    os.makedirs(path, exist_ok=True)

    # Save the trimmed inputs alongside the results (reference :246-255).
    hio.write_count_matrix(
        os.path.join(path, "observations_control.csv.gz"),
        n_meth_control.astype(np.int16)[ret],
    )
    hio.write_count_matrix(
        os.path.join(path, "observations_case.csv.gz"),
        n_meth_case.astype(np.int16)[ret],
    )
    hio.write_count_matrix(
        os.path.join(path, "n_total_reads_control.csv.gz"),
        n_total_control.astype(np.int16)[ret],
    )
    hio.write_count_matrix(
        os.path.join(path, "n_total_reads_case.csv.gz"),
        n_total_case.astype(np.int16)[ret],
    )
    hio.write_count_matrix(
        os.path.join(path, "positions.csv.gz"), positions[ret]
    )

    params = make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=p_softmax,
        omega_logit_control=omega_logit_control,
        omega_case=omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=merge_log_prob,
        split_prob=split_prob,
        minimum_duration=minimum_duration,
        d_max=max(64, T + 1),
    )
    if robust:
        from hygeia_tpu.ops.emissions import robust_emission_log_prob_table

        E_c = robust_emission_log_prob_table(
            n_meth_control, n_total_control, params.alpha, params.beta, robust_beta
        )
        E_k = robust_emission_log_prob_table(
            n_meth_case, n_total_case, params.alpha, params.beta, robust_beta
        )
    else:
        E_c = emission_log_prob_table(
            n_meth_control, n_total_control, params.alpha, params.beta
        )
        E_k = emission_log_prob_table(
            n_meth_case, n_total_case, params.alpha, params.beta
        )

    seeds = [seed] if np.isscalar(seed) else list(seed)
    all_log_norm = {s: {} for s in seeds}
    times = {s: {} for s in seeds}
    times_backward = {s: {} for s in seeds}
    hbm_budget = device_memory_budget()
    from contextlib import nullcontext

    def _maybe_trace():
        return jax.profiler.trace(str(trace_dir)) if trace_dir else nullcontext()

    for M in num_resampled_particles:
        N = M * (2 * R + R * R)
        # Filter + backward run FUSED in ONE jit program: the (T, N) history
        # (15 B/particle-site, filter._narrow — ~4.0 GB per seed on a full
        # 110k-site segment) is produced and consumed inside the program, so
        # no copy crosses a dispatch boundary. Seeds per dispatch are sized
        # against the device budget at HISTORY_BYTES_PER_SITE_PARTICLE.
        if marginal:
            per_seed = N * N * 8
        else:
            t_hist = min(T, int(streaming_blocks)) if streaming_blocks else T
            per_seed = t_hist * N * HISTORY_BYTES_PER_SITE_PARTICLE
        seeds_per_call = max(1, int(hbm_budget // max(per_seed, 1)))
        if max_seeds_per_call is not None:
            seeds_per_call = min(seeds_per_call, max_seeds_per_call)

        if marginal:
            _run_marginal_m(
                path, seeds, seeds_per_call, params, E_c, E_k, M, N, R, ret,
                marginal_epsilon, marginal_window, weight_dtype,
                all_log_norm, times, _maybe_trace,
            )
            continue

        # Seeds are vmapped: every Monte-Carlo replicate of this segment
        # runs in one device program (the reference launches one process
        # per seed; `each inference_seed`, modules/two_group/4_infer.nf:28).
        # The fused program reports one wall time per chunk, written to
        # optimal_time_{seed}.txt; optimal_time_backward_{seed}.txt records
        # 0 (the reference times two phases the fused program does not have
        # — PARITY.md).
        @jax.jit
        def fused_m(keys, bkeys):
            def one(key, bkey):
                res = run_filter(
                    key,
                    params,
                    E_c,
                    E_k,
                    M,
                    optimal_resampling=True,
                    multinomial_resampling=multinomial,
                    weight_dtype=weight_dtype,
                )
                traj = backward_simulation(
                    bkey, params, res.log_weights, res.particles,
                    num_samples_backward,
                )
                split, regime = smoothing_functionals(traj, R)
                return (
                    res.log_normalizing_constant,
                    res.degenerate_steps,
                    traj,
                    split,
                    regime,
                )

            return jax.vmap(one)(keys, bkeys)

        outs = {}
        for c0 in range(0, len(seeds), seeds_per_call):
            chunk = seeds[c0 : c0 + seeds_per_call]
            keys = jnp.stack([jax.random.PRNGKey(s) for s in chunk])
            bkeys = jnp.stack(
                [jax.random.fold_in(jax.random.PRNGKey(s), 1) for s in chunk]
            )
            with _maybe_trace():
                t0 = time.time()
                if streaming_blocks:
                    from hygeia_tpu.two_group.streaming import streamed_inference

                    traj_np, log_z_v, degen_v = streamed_inference(
                        keys, params, E_c, E_k, M, num_samples_backward,
                        block_size=int(streaming_blocks),
                        multinomial=multinomial,
                        weight_dtype=weight_dtype,
                    )
                    split_v, regime_v = _traj_functionals_np(traj_np, R)
                    traj_v = traj_np
                else:
                    log_z_v, degen_v, traj_v, split_v, regime_v = (
                        jax.block_until_ready(fused_m(keys, bkeys))
                    )
                t_chunk = time.time() - t0
            for i, s in enumerate(chunk):
                d = int(degen_v[i])
                if d:
                    # The reference dumps NaN diagnostics in its SMC loop
                    # (Smc.h:168-187); nonzero here means weight collapse.
                    print(f"WARNING: seed {s}: {d} degenerate filter steps")
                else:
                    print(f"seed {s}: degenerate_steps=0")
            for i, s in enumerate(chunk):
                outs[s] = (
                    float(log_z_v[i]),
                    np.asarray(traj_v[i]),
                    np.asarray(split_v[i]),
                    np.asarray(regime_v[i]),
                    t_chunk / len(chunk),
                    0.0,
                )
        for s in seeds:
            log_z, traj, split_s, regime_s, t_f, t_b = outs[s]
            times[s][N] = t_f
            times_backward[s][N] = t_b
            all_log_norm[s][N] = log_z
            # level=0 (stored): archive deflate is CPU-bound on this host
            # and serialised after compute (utils/io.savez_fast docstring).
            savez_fast(
                os.path.join(path, f"optimal_backward_particles_merged_state_{N}_{s}"),
                traj[:, :, 0].astype(np.int16)[ret],
                level=0,
            )
            savez_fast(
                os.path.join(path, f"optimal_backward_particles_control_state_{N}_{s}"),
                traj[:, :, 1:3].astype(np.int32)[ret],
                level=0,
            )
            savez_fast(
                os.path.join(path, f"optimal_backward_particles_case_state_{N}_{s}"),
                traj[:, :, 3:5].astype(np.int32)[ret],
                level=0,
            )
            savez_fast(
                os.path.join(path, f"optimal_split_probs_{N}_{s}"), split_s
            )
            savez_fast(
                os.path.join(path, f"optimal_regime_probs_{N}_{s}"), regime_s
            )

    flags = {
        "chrom": str(chrom), "batch": batch, "segment_size": segment_size,
        "buffer_size": buffer_size, "mu": list(map(float, mu)),
        "sigma": list(map(float, np.asarray(sigma, np.float64))),
        "minimum_duration": minimum_duration, "omega_case": omega_case,
        "merge_log_prob": float(merge_log_prob), "split_prob": split_prob,
        "num_resampled_particles": list(num_resampled_particles),
        "num_samples_backward": num_samples_backward,
        "multinomial": multinomial, "robust": robust, "marginal": marginal,
        "streaming_blocks": streaming_blocks,
    }
    for s in seeds:
        # The reference serialises its absl flags per run
        # (run_inference_two_groups.py:96-108).
        with open(os.path.join(path, f"flags{s}.txt"), "w") as f:
            for k, v in {**flags, "seed": s}.items():
                print(f"--{k}={v}", file=f)
        with open(
            os.path.join(path, f"log_normalizing_constants_optimal_{s}.txt"), "w"
        ) as f:
            print(all_log_norm[s], file=f)
        with open(os.path.join(path, f"optimal_time_{s}.txt"), "w") as f:
            print(times[s], file=f)
        with open(os.path.join(path, f"optimal_time_backward_{s}.txt"), "w") as f:
            print(times_backward[s], file=f)
    return all_log_norm if len(seeds) > 1 else all_log_norm[seeds[0]]


def _traj_functionals_np(traj_np, R):
    """split/regime smoothing functionals from a host (U, T, B, 5) int32
    trajectory batch — float32 like the device-side smoothing_functionals."""
    split_v = (traj_np[..., 0] == 0).mean(axis=2).astype(np.float32)
    regime_v = np.concatenate(
        [
            np.stack(
                [(traj_np[..., 2] == r).mean(axis=2) for r in range(R)], -1
            ),
            np.stack(
                [(traj_np[..., 4] == r).mean(axis=2) for r in range(R)], -1
            ),
        ],
        axis=-1,
    ).astype(np.float32)
    return split_v, regime_v


def infer_chromosome_streamed(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    seed=(0,),
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    multinomial=False,
    robust=False,
    robust_beta=0.05,
    weight_dtype=jnp.float32,
    streaming_blocks=16384,
    max_units_per_call=None,
):
    """Whole-chromosome INFER via the streaming engine with CROSS-SEGMENT
    unit batching: every (batch, seed) work unit whose device window has the
    same length is vmapped into the same streamed dispatches (streaming.py
    3-D emissions), instead of one `infer_segment` call per batch.

    Why: the filter scan is latency-bound in the number of resident units —
    residency is throughput — and a chromosome offers
    n_batches x n_seeds independent units while one segment offers only
    n_seeds. Windows group into at most three lengths (first batch misses
    the left halo, the last is the remainder; run_inference_two_groups.py:
    194-218), so interior batches all share one program.

    Outputs are BIT-IDENTICAL to running `infer_segment(streaming_blocks=W)`
    once per batch with the same seeds (same per-unit PRNG keys, same
    per-window d_max, vmap only adds the unit lane — covered by
    tests/test_streaming.py::test_infer_chromosome_streamed_matches_per_batch)
    except the optimal_time_* timing files.
    """
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    theta = hio.read_theta(
        os.path.join(single_group_dir, f"theta_{chrom}.csv.gz")
    )
    p_softmax, omega_logit_control = hio.theta_file_to_p_softmax(theta, R)
    positions_all = hio.read_positions(
        os.path.join(data_dir, f"positions_{chrom}.txt.gz")
    )

    def _load_full(name):
        return hio.read_count_matrix(
            os.path.join(data_dir, f"{name}_{chrom}.txt.gz")
        )

    n_total_control_all = _load_full("n_total_reads_control")
    n_meth_control_all = _load_full("n_methylated_reads_control")
    n_total_case_all = _load_full("n_total_reads_case")
    n_meth_case_all = _load_full("n_methylated_reads_case")
    assert np.sum(n_total_case_all < n_meth_case_all) == 0
    assert np.sum(n_total_control_all < n_meth_control_all) == 0

    seeds = [seed] if np.isscalar(seed) else list(seed)
    B = num_samples_backward
    W = int(streaming_blocks)
    n_batches = 1 + len(positions_all) // segment_size

    from hygeia_tpu.two_group.streaming import streamed_inference
    from concurrent.futures import ThreadPoolExecutor

    _io_pool = ThreadPoolExecutor(max_workers=2)
    io_futures = []
    post_prev = []  # previous chunk's postprocess futures (memory bound)
    # The try/finally guards the pool from its CREATION (an exception
    # anywhere below — including the window-building submits — must not
    # leak a 2-thread executor per orchestrator retry; commit c65cf86).
    try:
        # Per-batch windows, sliced counts, input CSVs (infer_segment
        # parity). The input-CSV writes ride the writer pool so their
        # zlib/formatting (GIL-releasing) overlaps the emission builds and
        # the first compute dispatch instead of serialising before it.
        wins = {}
        for batch in range(n_batches):
            window = segment_window(
                len(positions_all), batch, segment_size, buffer_size
            )
            if window is None:
                continue
            sl_r, ret_r = window
            sl = slice(sl_r.start, sl_r.stop)
            ret = slice(ret_r.start, ret_r.stop)
            counts = {
                "n_meth_control": n_meth_control_all[sl],
                "n_total_control": n_total_control_all[sl],
                "n_meth_case": n_meth_case_all[sl],
                "n_total_case": n_total_case_all[sl],
            }
            path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
            os.makedirs(path, exist_ok=True)
            for fname, arr in (
                ("observations_control.csv.gz", counts["n_meth_control"].astype(np.int16)[ret]),
                ("observations_case.csv.gz", counts["n_meth_case"].astype(np.int16)[ret]),
                ("n_total_reads_control.csv.gz", counts["n_total_control"].astype(np.int16)[ret]),
                ("n_total_reads_case.csv.gz", counts["n_total_case"].astype(np.int16)[ret]),
                ("positions.csv.gz", positions_all[sl][ret]),
            ):
                io_futures.append(
                    _io_pool.submit(
                        hio.write_count_matrix, os.path.join(path, fname), arr
                    )
                )
            wins[batch] = (sl.stop - sl.start, ret, counts, path)

        all_log_norm = {b: {s: {} for s in seeds} for b in wins}
        times = {b: {s: {} for s in seeds} for b in wins}

        # Group batches by device-window length: same T_w -> same d_max,
        # same program shapes -> batchable units.
        groups = {}
        for batch, (t_w, _, _, _) in wins.items():
            groups.setdefault(t_w, []).append(batch)

        # ONE d_max (the largest window) and ONE padded vmap width S across
        # all window-length groups: the hazard tables then share one shape
        # and the groups share the W-width block programs, roughly HALVING
        # the program count a fresh process must compile. Bit-parity is
        # preserved — deeper
        # hazard tables only add exact-zero one-hot terms to gather_rho's
        # row reductions, and pad lanes are independent under vmap
        # (test_infer_chromosome_streamed_matches_per_batch).
        d_max_all = max(64, max(groups) + 1)

        for M in num_resampled_particles:
            N = M * (2 * R + R * R)
            s_shared = shared_unit_width(
                {t_w: len(gb) for t_w, gb in groups.items()}, W, N,
                len(seeds), max_units=max_units_per_call,
            )
            params = make_params(
                mu=mu,
                sigma=sigma,
                p_softmax_control=p_softmax,
                omega_logit_control=omega_logit_control,
                omega_case=omega_case,
                kappa_control=np.full(R, 2.0),
                kappa_case=np.full(R, 2.0),
                merge_log_prob=merge_log_prob,
                split_prob=split_prob,
                minimum_duration=minimum_duration,
                d_max=d_max_all,
            )
            for t_w, group_batches in sorted(groups.items()):
                emis = {}
                for b in group_batches:
                    c = wins[b][2]
                    if robust:
                        from hygeia_tpu.ops.emissions import (
                            robust_emission_log_prob_table,
                        )

                        emis[b] = (
                            robust_emission_log_prob_table(
                                c["n_meth_control"], c["n_total_control"],
                                params.alpha, params.beta, robust_beta,
                            ),
                            robust_emission_log_prob_table(
                                c["n_meth_case"], c["n_total_case"],
                                params.alpha, params.beta, robust_beta,
                            ),
                        )
                    else:
                        from hygeia_tpu.ops.emissions import (
                            emission_log_prob_table_fused,
                        )

                        emis[b] = (
                            emission_log_prob_table_fused(
                                c["n_meth_control"], c["n_total_control"],
                                params.alpha, params.beta,
                            ),
                            emission_log_prob_table_fused(
                                c["n_meth_case"], c["n_total_case"],
                                params.alpha, params.beta,
                            ),
                        )

                units = [(b, s) for b in group_batches for s in seeds]
                units_per_call = s_shared

                for c0 in range(0, len(units), units_per_call):
                    chunk = units[c0 : c0 + units_per_call]
                    # EVERY chunk is padded to the shared vmap width by
                    # repeating its last unit (outputs dropped below): every
                    # distinct width S re-traces and compiles a new program,
                    # which costs more than the wasted lanes on this
                    # latency-bound scan.
                    n_pad = 0
                    if len(chunk) < units_per_call:
                        n_pad = units_per_call - len(chunk)
                        chunk = chunk + [chunk[-1]] * n_pad
                    keys = jnp.stack([jax.random.PRNGKey(s) for _, s in chunk])
                    E_c_u = jnp.stack([emis[b][0] for b, _ in chunk])
                    E_k_u = jnp.stack([emis[b][1] for b, _ in chunk])
                    t0 = time.time()
                    traj_np, log_z_v, degen_v = streamed_inference(
                        keys, params, E_c_u, E_k_u, M, B,
                        block_size=W,
                        multinomial=multinomial,
                        weight_dtype=weight_dtype,
                    )
                    t_chunk = time.time() - t0
                    if n_pad:
                        chunk = chunk[: len(chunk) - n_pad]
                    for i, (b, s) in enumerate(chunk):
                        d = int(degen_v[i])
                        if d:
                            print(
                                f"WARNING: batch {b} seed {s}: {d} degenerate "
                                "filter steps"
                            )
                        all_log_norm[b][s][N] = float(log_z_v[i])
                        times[b][s][N] = t_chunk / len(chunk)

                    # The ENTIRE per-unit postprocess (functional means over
                    # the (T, B) trajectory, archive slicing, 5 file writes)
                    # rides the pool: numpy reductions and zipfile CRC both
                    # release the GIL, so the ~1 s/unit of host work runs on
                    # both cores and overlaps any remaining device pulls
                    # instead of serialising after the chunk. Joined before
                    # the flags files below.
                    def _postprocess(i, b, s, traj_np=traj_np, N=N):
                        _, ret, _, path = wins[b]
                        traj = traj_np[i]
                        split_u, regime_u = _traj_functionals_np(
                            traj_np[i : i + 1], R
                        )
                        # level=0 (stored): archive deflate is CPU-bound
                        # (savez_fast docstring).
                        savez_fast(
                            os.path.join(
                                path,
                                f"optimal_backward_particles_merged_state_{N}_{s}",
                            ),
                            traj[:, :, 0].astype(np.int16)[ret],
                            0,
                        )
                        savez_fast(
                            os.path.join(
                                path,
                                f"optimal_backward_particles_control_state_{N}_{s}",
                            ),
                            traj[:, :, 1:3].astype(np.int32)[ret],
                            0,
                        )
                        savez_fast(
                            os.path.join(
                                path,
                                f"optimal_backward_particles_case_state_{N}_{s}",
                            ),
                            traj[:, :, 3:5].astype(np.int32)[ret],
                            0,
                        )
                        savez_fast(
                            os.path.join(path, f"optimal_split_probs_{N}_{s}"),
                            split_u[0],
                        )
                        savez_fast(
                            os.path.join(path, f"optimal_regime_probs_{N}_{s}"),
                            regime_u[0],
                        )

                    # Each future holds the whole chunk's traj_np alive;
                    # draining the PREVIOUS chunk first bounds host memory
                    # to <=2 chunk arrays while keeping the overlap of
                    # chunk k-1's writes with chunk k's device compute.
                    for f in post_prev:
                        f.result()
                    post_prev = [
                        _io_pool.submit(_postprocess, i, b, s)
                        for i, (b, s) in enumerate(chunk)
                    ]
                    io_futures.extend(post_prev)

    finally:
        # Join/shut the writer pool even when an attempt raises (the
        # orchestrator retries the whole unit; a leaked executor per
        # attempt would pile up threads). Success still surfaces any
        # writer exception below.
        _io_pool.shutdown(wait=True)
    for f in io_futures:
        f.result()  # surface any writer exception before declaring success

    for batch, (t_w, ret, counts, path) in wins.items():
        flags = {
            "chrom": str(chrom), "batch": batch, "segment_size": segment_size,
            "buffer_size": buffer_size, "mu": list(map(float, mu)),
            "sigma": list(map(float, np.asarray(sigma, np.float64))),
            "minimum_duration": minimum_duration, "omega_case": omega_case,
            "merge_log_prob": float(merge_log_prob), "split_prob": split_prob,
            "num_resampled_particles": list(num_resampled_particles),
            "num_samples_backward": num_samples_backward,
            "multinomial": multinomial, "robust": robust, "marginal": False,
            "streaming_blocks": streaming_blocks,
        }
        for s in seeds:
            with open(os.path.join(path, f"flags{s}.txt"), "w") as f:
                for k, v in {**flags, "seed": s}.items():
                    print(f"--{k}={v}", file=f)
            with open(
                os.path.join(
                    path, f"log_normalizing_constants_optimal_{s}.txt"
                ),
                "w",
            ) as f:
                print(all_log_norm[batch][s], file=f)
            with open(os.path.join(path, f"optimal_time_{s}.txt"), "w") as f:
                print(times[batch][s], file=f)
            with open(
                os.path.join(path, f"optimal_time_backward_{s}.txt"), "w"
            ) as f:
                print({n: 0.0 for n in times[batch][s]}, file=f)
    return all_log_norm


def infer_chromosome_meshed(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    mesh_shape,  # (n_genome, n_seed_mesh)
    boundary="halo",
    seed=(0, 1),
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    robust=False,
    robust_beta=0.05,
    weight_dtype=jnp.float32,
    rng_seed=0,
):
    """Whole-chromosome INFER stage on a (genome x seed) device mesh.

    The device-mesh expression of the reference's (segment x seed) Nextflow
    task fan-out (main.nf:44-75): every (batch, seed) work unit of the
    chromosome runs concurrently inside ONE pjit'd program via
    parallel/sharded.sharded_two_group_inference, instead of the sequential
    per-batch loop infer_segment serves. Outputs are written per
    (batch, seed) with infer_segment's exact file names and layouts, so
    AGGREGATE_RESULTS and GET_DMPS consume them unchanged.

    Deviations from the sequential path (documented in PARITY.md):
    * RNG streams are per-(block, seed) fold-ins, so outputs are
      statistically equivalent but not byte-equal to infer_segment's.
    * boundary="halo" uses symmetric zero-padded halos (the reference's
      first/last windows are asymmetric); boundary="exchange" replaces the
      halo approximation with exact ppermute boundary messages, and the
      per-batch logZ file then records the enclosing device window's logZ.
    * optimal_time_{seed}.txt records the mesh dispatch wall time divided by
      the number of work units (per-unit timing does not exist in a fused
      program); optimal_time_backward is reported as 0.
    """
    import jax.sharding
    import time as _time

    from hygeia_tpu.parallel.sharded import sharded_two_group_inference

    mu = np.asarray(mu, np.float64)
    R = len(mu)
    n_genome, n_seed_mesh = mesh_shape
    devices = jax.devices()
    if len(devices) < n_genome * n_seed_mesh:
        raise ValueError(
            f"mesh {n_genome}x{n_seed_mesh} needs {n_genome * n_seed_mesh} "
            f"devices, have {len(devices)}"
        )
    mesh = jax.sharding.Mesh(
        np.asarray(devices[: n_genome * n_seed_mesh]).reshape(
            n_genome, n_seed_mesh
        ),
        ("genome", "seed"),
    )

    theta = hio.read_theta(os.path.join(single_group_dir, f"theta_{chrom}.csv.gz"))
    p_softmax, omega_logit_control = hio.theta_file_to_p_softmax(theta, R)
    positions = hio.read_positions(
        os.path.join(data_dir, f"positions_{chrom}.txt.gz")
    )
    T = len(positions)

    def _load(name):
        return hio.read_count_matrix(os.path.join(data_dir, f"{name}_{chrom}.txt.gz"))

    n_total_control = _load("n_total_reads_control")
    n_meth_control = _load("n_methylated_reads_control")
    n_total_case = _load("n_total_reads_case")
    n_meth_case = _load("n_methylated_reads_case")
    assert np.sum(n_total_case < n_meth_case) == 0
    assert np.sum(n_total_control < n_meth_control) == 0

    # d_max covers the whole chromosome: exchange-mode warm starts carry
    # durations across block joins, so sojourns are bounded by T, not by the
    # block window.
    params = make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=p_softmax,
        omega_logit_control=omega_logit_control,
        omega_case=omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=merge_log_prob,
        split_prob=split_prob,
        minimum_duration=minimum_duration,
        d_max=max(64, T + 1),
    )
    emission_table_fn = None
    if robust:
        # Stable per-beta function object: sharded.py caches programs keyed
        # on this identity (a fresh closure per call would retrace every
        # robust INFER and leak one cache entry per call).
        from hygeia_tpu.ops.emissions import robust_emission_table_factory

        emission_table_fn = robust_emission_table_factory(float(robust_beta))

    seeds = [seed] if np.isscalar(seed) else list(seed)
    n_batches = 1 + T // segment_size
    B = num_samples_backward
    all_log_norm = {s: {} for s in seeds}
    times = {s: {} for s in seeds}

    for M in num_resampled_particles:
        N = M * (2 * R + R * R)
        t0 = _time.time()
        traj, log_z = sharded_two_group_inference(
            mesh,
            params,
            n_meth_control,
            n_total_control,
            n_meth_case,
            n_total_case,
            segment_size=segment_size,
            buffer_size=buffer_size,
            num_resampled_ancestors=M,
            num_samples_backward=B,
            seeds=seeds,
            base_key=rng_seed,
            weight_dtype=weight_dtype,
            boundary=boundary,
            emission_table_fn=emission_table_fn,
        )
        wall = _time.time() - t0
        per_unit = wall / max(1, n_batches * len(seeds))
        # traj: (n_blocks*segment_size, n_seeds*B, 5); log_z (halo):
        # (n_blocks, n_seeds) or (exchange): (n_genome, n_seeds).
        bpd = (traj.shape[0] // segment_size) // log_z.shape[0]

        for batch in range(n_batches):
            lo = batch * segment_size
            hi = min((batch + 1) * segment_size, T)
            path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
            os.makedirs(path, exist_ok=True)
            rows = slice(lo, hi)
            hio.write_count_matrix(
                os.path.join(path, "observations_control.csv.gz"),
                n_meth_control.astype(np.int16)[rows],
            )
            hio.write_count_matrix(
                os.path.join(path, "observations_case.csv.gz"),
                n_meth_case.astype(np.int16)[rows],
            )
            hio.write_count_matrix(
                os.path.join(path, "n_total_reads_control.csv.gz"),
                n_total_control.astype(np.int16)[rows],
            )
            hio.write_count_matrix(
                os.path.join(path, "n_total_reads_case.csv.gz"),
                n_total_case.astype(np.int16)[rows],
            )
            hio.write_count_matrix(
                os.path.join(path, "positions.csv.gz"), positions[rows]
            )
            traj_b = traj[rows]  # (hi-lo, n_seeds*B, 5)
            if boundary == "exchange":
                lz_row = log_z[min(batch // max(bpd, 1), log_z.shape[0] - 1)]
            else:
                lz_row = log_z[min(batch, log_z.shape[0] - 1)]
            for i, s in enumerate(seeds):
                tb = traj_b[:, i * B : (i + 1) * B]
                savez_fast(
                    os.path.join(
                        path, f"optimal_backward_particles_merged_state_{N}_{s}"
                    ),
                    tb[:, :, 0].astype(np.int16),
                )
                savez_fast(
                    os.path.join(
                        path, f"optimal_backward_particles_control_state_{N}_{s}"
                    ),
                    tb[:, :, 1:3].astype(np.int32),
                )
                savez_fast(
                    os.path.join(
                        path, f"optimal_backward_particles_case_state_{N}_{s}"
                    ),
                    tb[:, :, 3:5].astype(np.int32),
                )
                split_s = (tb[:, :, 0] == 0).mean(axis=1).astype(np.float32)
                regime_s = np.concatenate(
                    [
                        np.stack(
                            [(tb[:, :, 2] == r).mean(axis=1) for r in range(R)], -1
                        ),
                        np.stack(
                            [(tb[:, :, 4] == r).mean(axis=1) for r in range(R)], -1
                        ),
                    ],
                    axis=-1,
                ).astype(np.float32)
                savez_fast(
                    os.path.join(path, f"optimal_split_probs_{N}_{s}"), split_s
                )
                savez_fast(
                    os.path.join(path, f"optimal_regime_probs_{N}_{s}"), regime_s
                )
                all_log_norm[s].setdefault(batch, {})[N] = float(lz_row[i])
                times[s].setdefault(batch, {})[N] = per_unit

    flags = {
        "chrom": str(chrom), "segment_size": segment_size,
        "buffer_size": buffer_size, "mu": list(map(float, mu)),
        "sigma": list(map(float, np.asarray(sigma, np.float64))),
        "minimum_duration": minimum_duration, "omega_case": omega_case,
        "merge_log_prob": float(merge_log_prob), "split_prob": split_prob,
        "num_resampled_particles": list(num_resampled_particles),
        "num_samples_backward": num_samples_backward,
        "robust": robust, "mesh": f"{n_genome}x{n_seed_mesh}",
        "boundary": boundary,
    }
    for batch in range(n_batches):
        path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
        for s in seeds:
            with open(os.path.join(path, f"flags{s}.txt"), "w") as f:
                for k, v in {**flags, "batch": batch, "seed": s}.items():
                    print(f"--{k}={v}", file=f)
            with open(
                os.path.join(path, f"log_normalizing_constants_optimal_{s}.txt"),
                "w",
            ) as f:
                print(all_log_norm[s][batch], file=f)
            with open(os.path.join(path, f"optimal_time_{s}.txt"), "w") as f:
                print(times[s][batch], file=f)
            with open(
                os.path.join(path, f"optimal_time_backward_{s}.txt"), "w"
            ) as f:
                print({n: 0.0 for n in times[s][batch]}, file=f)
    return all_log_norm


def _run_marginal_m(
    path, seeds, seeds_per_call, params, E_c, E_k, M, N, R, ret,
    epsilon, window, weight_dtype, all_log_norm, times, maybe_trace,
):
    """Marginal-mode inner loop for one particle budget M: adaptive-lag
    smoothing functionals written as optimal_split_probs / optimal_regime_
    probs npz (same names/shapes the backward-simulation path produces)."""
    from hygeia_tpu.two_group.marginal import run_marginal_filter

    @jax.jit
    def run_m(keys):
        def one(key):
            res = run_marginal_filter(
                key,
                params,
                E_c,
                E_k,
                M,
                epsilon=epsilon,
                smoothing_window=window,
                weight_dtype=weight_dtype,
            )
            return res.log_normalizing_constant, res.functionals, res.spill_count

        return jax.vmap(one)(keys)

    for c0 in range(0, len(seeds), seeds_per_call):
        chunk = seeds[c0 : c0 + seeds_per_call]
        keys = jnp.stack([jax.random.PRNGKey(s) for s in chunk])
        with maybe_trace():
            t0 = time.time()
            log_z_v, fn_v, spill_v = jax.block_until_ready(run_m(keys))
            elapsed = time.time() - t0
        for i, s in enumerate(chunk):
            times[s][N] = elapsed / len(chunk)
            all_log_norm[s][N] = float(log_z_v[i])
            fn = np.asarray(fn_v[i])
            savez_fast(
                os.path.join(path, f"optimal_split_probs_{N}_{s}"), fn[ret, 0]
            )
            savez_fast(
                os.path.join(path, f"optimal_regime_probs_{N}_{s}"), fn[ret, 1:]
            )
            if int(spill_v[i]):
                print(
                    f"marginal filter seed {s}: {int(spill_v[i])} pending times "
                    "force-finalised (smoothing window spill)"
                )
