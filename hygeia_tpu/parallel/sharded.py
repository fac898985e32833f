"""Sharded two-group inference: halo-buffered genome blocks over a device
mesh, seeds data-parallel, everything inside one pjit'd program.

This is the device-mesh replacement for the reference's (segment x seed)
Nextflow task fan-out (main.nf:44-75, run_inference_two_groups.py:194-218):

* the chromosome is split into ``n_blocks`` windows of ``segment_size`` sites
  with ``buffer_size`` halo on BOTH sides (the chromosome is zero-padded at
  its edges, so every window has identical static shape; zero-read halo sites
  have log-likelihood 0 and are inert — this generalises the reference's
  asymmetric first/last windows),
* ``shard_map`` places blocks along the mesh "genome" axis and seeds along
  "seed"; each shard runs the full filter + backward simulation for its
  (block, seed) pairs via ``vmap``,
* halos are trimmed on-device; outputs come back with per-block leading axes
  to be reshaped into the chromosome.

No collectives are needed in the halo scheme (the halo absorbs boundary
error, exactly like the reference). ``boundary="exchange"`` activates the
v2 scheme (SURVEY.md s7 step 5): forward filter states and backward
trajectory states are passed between neighbouring genome shards with
``jax.lax.ppermute`` over the device interconnect, replacing the halo
approximation with real boundary messages at ~the same compute cost (a
short cold warmup tail plus one extra backward sweep instead of two halos).

Programs are built ONCE per (mesh, static config) and cached at module
level with the model parameter arrays riding as jit ARGUMENTS (replicated
P() specs) — a previous revision rebuilt ``jax.jit(run_shard)`` on every
call, which re-traced AND re-queried the compile cache per invocation.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from hygeia_tpu.ops.emissions import emission_log_prob_table
from hygeia_tpu.two_group.model import TwoGroupParams
from hygeia_tpu.two_group.filter import run_filter, run_filter_final
from hygeia_tpu.two_group.backward import (
    backward_simulation,
    backward_simulation_conditioned,
)
from hygeia_tpu.two_group.streaming import _fill_block, _pack_traj

# (scheme, mesh, static cfg) -> {"tables": jit, "run": jit}
_PROGRAMS = {}


def make_block_windows(arr, segment_size, buffer_size, n_blocks):
    """(T, S) -> (n_blocks, segment_size + 2*buffer_size, S) with zero-padded
    edges; block b covers sites [b*S - B, (b+1)*S + B) of the padded genome."""
    T, S = arr.shape
    total = n_blocks * segment_size
    padded = np.zeros((total + 2 * buffer_size, S), arr.dtype)
    padded[buffer_size : buffer_size + T] = arr[:total]
    win = segment_size + 2 * buffer_size
    out = np.stack(
        [padded[b * segment_size : b * segment_size + win] for b in range(n_blocks)]
    )
    return out


def _tables_program(emission_table_fn):
    if getattr(emission_table_fn, "needs_concrete", False):
        # Robust (beta-divergence) tables: the support-sum bound is
        # int(max(n)) — data-dependent, so the build cannot run under
        # jit/vmap tracing. Build per block on concrete arrays instead
        # (one-off per chromosome; the XLA ops inside are still fused).
        def tables(alpha, beta, mc, tc, mk, tk):
            def f(m, t):
                return jnp.stack(
                    [emission_table_fn(m[i], t[i], alpha, beta)
                     for i in range(m.shape[0])]
                )

            return f(mc, tc), f(mk, tk)

        return tables

    @jax.jit
    def tables(alpha, beta, mc, tc, mk, tk):
        f = jax.vmap(lambda m, t: emission_table_fn(m, t, alpha, beta))
        return f(mc, tc), f(mk, tk)

    return tables


def _halo_programs(
    mesh, n_regimes, min_duration, segment_size, buffer_size, M, B,
    weight_dtype_name, phantom_regime, emission_table_fn,
):
    cache_key = (
        "halo", mesh, n_regimes, min_duration, segment_size, buffer_size,
        M, B, weight_dtype_name, phantom_regime, emission_table_fn,
    )
    if cache_key in _PROGRAMS:
        return _PROGRAMS[cache_key]
    weight_dtype = jnp.dtype(weight_dtype_name)

    def run_one(params, key, e_c, e_k):
        res = run_filter(
            key,
            params,
            e_c,
            e_k,
            M,
            weight_dtype=weight_dtype,
            phantom_regime=phantom_regime,
            vma_axes=("genome", "seed"),
        )
        traj = backward_simulation(
            jax.random.fold_in(key, 1),
            params,
            res.log_weights,
            res.particles,
            B,
        )
        trimmed = traj[buffer_size : buffer_size + segment_size]
        # Pack the trajectory device-to-host pull to 2 B/element, as the
        # streamed path does. Durations are reconstructed host-side from the
        # reset bits + the block's first-site durations (streaming.py
        # _pack_traj/_fill_block round-trip contract).
        d0 = trimmed[0][:, jnp.array([1, 3])]  # (B, 2) first-site durations
        return _pack_traj(trimmed), d0, res.log_normalizing_constant

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # replicated model parameter arrays
            P("genome"),  # per-block emission tables
            P("genome"),
            P("genome", "seed"),  # keys
        ),
        out_specs=(
            P("genome", "seed"),
            P("genome", "seed"),
            P("genome", "seed"),
        ),
        # check_vma stays ON (the default): the cold-start carry promotion is
        # declared explicitly via vma_axes -> lax.pcast in run_filter.
    )
    def run_shard(arrs, e_c_blocks, e_k_blocks, key_blocks):
        params = TwoGroupParams(n_regimes, min_duration, *arrs)

        # e_*_blocks: (blocks_per_dev, win, R); key_blocks: (bpd, spd, 2)
        def per_block(e_c, e_k, ks):
            return jax.vmap(lambda k: run_one(params, k, e_c, e_k))(ks)

        return jax.vmap(per_block)(e_c_blocks, e_k_blocks, key_blocks)

    progs = {
        "tables": _tables_program(emission_table_fn),
        "run": jax.jit(run_shard),
    }
    _PROGRAMS[cache_key] = progs
    return progs


def sharded_two_group_inference(
    mesh,
    params: TwoGroupParams,
    n_meth_control,
    n_total_control,
    n_meth_case,
    n_total_case,
    *,
    segment_size,
    buffer_size,
    num_resampled_ancestors,
    num_samples_backward,
    seeds,
    base_key=0,
    weight_dtype=jnp.float32,
    boundary="halo",
    phantom_regime=None,
    emission_table_fn=None,
):
    """Run the whole chromosome across the mesh.

    Returns (trajectories, log_z):
      trajectories: (n_blocks * segment_size, n_seeds * B, 5) int32-valued
        backward-simulation states, halo-trimmed and genome-ordered
        (padding rows beyond the true T are zeros-of-the-prior; slice [:T]).
      log_z: (n_blocks, n_seeds) per-block log-normalising constants.

    boundary="halo" (default) reproduces the reference's scheme: independent
    blocks with 2*buffer_size halo sites absorbing boundary error.
    boundary="exchange" replaces halos with real boundary messages over the
    mesh (ppermute): forward filter states flow left-to-right and backward
    trajectory states right-to-left, so block joins are marginally
    consistent instead of halo-approximate. log_z then has shape
    (n_genome, n_seeds) — one entry per device window.

    emission_table_fn(n_meth, n_total, alpha, beta) -> (T, R) overrides the
    standard BetaBinomial table — the robust (beta-divergence) emission
    variant plugs in here (ops/emissions.robust_emission_log_prob_table).
    """
    if emission_table_fn is None:
        emission_table_fn = emission_log_prob_table
    if boundary == "exchange":
        return _exchange_two_group_inference(
            mesh,
            params,
            n_meth_control,
            n_total_control,
            n_meth_case,
            n_total_case,
            segment_size=segment_size,
            warmup_size=max(1, 2 * buffer_size),
            num_resampled_ancestors=num_resampled_ancestors,
            num_samples_backward=num_samples_backward,
            seeds=seeds,
            base_key=base_key,
            weight_dtype=weight_dtype,
            phantom_regime=phantom_regime,
            emission_table_fn=emission_table_fn,
        )
    if boundary != "halo":
        raise ValueError(f"unknown boundary scheme: {boundary!r}")
    n_genome = mesh.shape["genome"]
    n_seed_mesh = mesh.shape["seed"]
    n_seeds = len(seeds)
    T = n_meth_control.shape[0]
    n_blocks = max(1, -(-T // segment_size))
    # Round blocks up to a multiple of the mesh's genome axis.
    n_blocks = -(-n_blocks // n_genome) * n_genome
    if n_seeds % n_seed_mesh:
        raise ValueError("len(seeds) must be a multiple of the seed mesh axis")

    blocks = [
        make_block_windows(np.asarray(a, np.float32), segment_size, buffer_size, n_blocks)
        for a in (n_meth_control, n_total_control, n_meth_case, n_total_case)
    ]
    keys = jax.vmap(
        lambda b: jax.vmap(
            lambda s: jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(base_key), b), s)
        )(jnp.asarray(seeds, jnp.uint32))
    )(jnp.arange(n_blocks, dtype=jnp.uint32))  # (n_blocks, n_seeds, 2)

    B = num_samples_backward
    assert params.n_regimes <= 31, "2-byte trajectory packing needs r < 32"
    progs = _halo_programs(
        mesh, params.n_regimes, params.min_duration, segment_size,
        buffer_size, num_resampled_ancestors, B,
        jnp.dtype(weight_dtype).name, phantom_regime, emission_table_fn,
    )
    e_c, e_k = progs["tables"](
        params.alpha, params.beta, *[jnp.asarray(b) for b in blocks]
    )
    arrs = tuple(params[2:])
    packed, d0, log_z = progs["run"](arrs, e_c, e_k, keys)
    # Packed pull (2 B/element vs 20) + host duration reconstruction,
    # decoded straight into the final (n_blocks*seg, n_seeds*B, 5) layout
    # through a strided view (no extra transpose copy of the int32 array).
    packed = np.asarray(packed)  # (n_blocks, n_seeds, seg, B, 2) uint8
    d0 = np.asarray(d0)  # (n_blocks, n_seeds, B, 2) int32
    nb, ns, seg, b, _ = packed.shape
    traj = np.empty((nb * seg, ns * b, 5), np.int32)
    view = traj.reshape(nb, seg, ns, b, 5).transpose(0, 2, 1, 3, 4)
    for blk in range(nb):
        _fill_block(view[blk], packed[blk], d0[blk])
    return traj, np.asarray(log_z)


def _exchange_programs(
    mesh, n_regimes, min_duration, segment_size, warmup, M, B,
    weight_dtype_name, phantom_regime, emission_table_fn,
):
    cache_key = (
        "exchange", mesh, n_regimes, min_duration, segment_size, warmup,
        M, B, weight_dtype_name, phantom_regime, emission_table_fn,
    )
    if cache_key in _PROGRAMS:
        return _PROGRAMS[cache_key]
    weight_dtype = jnp.dtype(weight_dtype_name)
    n_genome = mesh.shape["genome"]
    right = [(i, i + 1) for i in range(n_genome - 1)]
    left = [(i + 1, i) for i in range(n_genome - 1)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("genome"), P("genome"), P("genome", "seed")),
        out_specs=(
            P("genome", "seed"),
            P("genome", "seed"),
            P("genome", "seed"),
        ),
    )
    def run_shard(arrs, e_c_blocks, e_k_blocks, key_blocks):
        params = TwoGroupParams(n_regimes, min_duration, *arrs)
        # e_*_blocks: (bpd, segment_size, R); key_blocks: (bpd, spd, 2).
        bpd = e_c_blocks.shape[0]
        win = bpd * segment_size
        W = int(min(warmup, win))
        R = e_c_blocks.shape[-1]
        e_c = e_c_blocks.reshape(win, R)
        e_k = e_k_blocks.reshape(win, R)
        ks = key_blocks[0]  # (spd, 2) — one stream per seed per window
        g = jax.lax.axis_index("genome")

        # 1. warmup tail -> boundary message right.
        def warm_one(k):
            return run_filter_final(
                jax.random.fold_in(k, 2),
                params,
                e_c[win - W :],
                e_k[win - W :],
                M,
                weight_dtype=weight_dtype,
                phantom_regime=phantom_regime,
                vma_axes=("genome", "seed"),
            )

        warm = jax.vmap(warm_one)(ks)  # pytree with leading (spd,)
        recv = jax.tree.map(
            lambda a: jax.lax.ppermute(a, "genome", right), warm
        )
        # axis_index-derived flags vary on "genome" only; promote to the full
        # manual axis set so the where() mixing with (genome, seed)-varying
        # filter states type-checks under check_vma.
        use_init = jax.lax.pcast(g > 0, ("seed",), to="varying")

        # 2. warm-started main filter.
        def filt_one(k, lw0, p0):
            return run_filter(
                k,
                params,
                e_c,
                e_k,
                M,
                weight_dtype=weight_dtype,
                init_state=(lw0, p0),
                use_init=use_init,
                phantom_regime=phantom_regime,
                vma_axes=("genome", "seed"),
            )

        res = jax.vmap(filt_one)(ks, recv[0], recv[1])

        # 3. backward round 1 -> first-site states left.
        def back_one(k, lw, parts):
            return backward_simulation(
                jax.random.fold_in(k, 1), params, lw, parts, B
            )

        traj1 = jax.vmap(back_one)(ks, res.log_weights, res.particles)
        first = traj1[:, 0]  # (spd, B, 5)
        recv_t = jax.lax.ppermute(first, "genome", left)
        use_term = jax.lax.pcast(g < n_genome - 1, ("seed",), to="varying")

        # 4. conditioned backward round 2.
        def back_two(k, lw, parts, term):
            return backward_simulation_conditioned(
                jax.random.fold_in(k, 3), params, lw, parts, term, use_term
            )

        traj = jax.vmap(back_two)(ks, res.log_weights, res.particles, recv_t)
        # Pack per contiguous device window (2 B/element D2H; durations
        # reconstructed host-side per window via _fill_block).
        packed = _pack_traj(traj)  # (spd, win, B, 2)
        d0 = traj[:, 0][:, :, jnp.array([1, 3])]  # (spd, B, 2)
        log_z = res.log_normalizing_constant[None, :]  # (1, spd)
        return packed[None], d0[None], log_z

    progs = {
        "tables": _tables_program(emission_table_fn),
        "run": jax.jit(run_shard),
    }
    _PROGRAMS[cache_key] = progs
    return progs


def _exchange_two_group_inference(
    mesh,
    params: TwoGroupParams,
    n_meth_control,
    n_total_control,
    n_meth_case,
    n_total_case,
    *,
    segment_size,
    warmup_size,
    num_resampled_ancestors,
    num_samples_backward,
    seeds,
    base_key,
    weight_dtype,
    phantom_regime=None,
    emission_table_fn=None,
):
    """Exact boundary-exchange block-parallel smoothing (SURVEY.md s7 step 5 v2).

    Each genome shard owns one contiguous window of ``bpd * segment_size``
    sites (bpd = blocks per device). Four phases, all inside one shard_map:

    1. warmup: a cold filter over the LAST ``warmup_size`` sites of the own
       window, final state shipped RIGHT (``ppermute``) — the right
       neighbour's boundary message (the analog of the reference's left halo,
       but the state itself is passed instead of recomputed).
    2. main filter: warm-started from the received state (shard 0
       cold-starts with the phantom initial distribution).
    3. backward round 1 (unconditioned): provides each shard's first-site
       trajectory states, shipped LEFT.
    4. backward round 2: re-simulated conditioned on the received next-block
       states (last shard keeps the unconditioned terminal draw).

    Per-site marginals are thereby boundary-consistent: a shard's last site
    is sampled from the backward kernel against its right neighbour's
    first-site law rather than from the filtered marginal. (Round-1/round-2
    trajectories are coupled only in distribution across joins, not
    sample-by-sample — sufficient for all downstream per-site functionals in
    aggregate_results/get_dmps; a fully pathwise-coupled variant would need a
    sequential K-round pipeline.)
    """
    n_genome = mesh.shape["genome"]
    n_seed_mesh = mesh.shape["seed"]
    n_seeds = len(seeds)
    T = n_meth_control.shape[0]
    n_blocks = max(1, -(-T // segment_size))
    n_blocks = -(-n_blocks // n_genome) * n_genome
    if n_seeds % n_seed_mesh:
        raise ValueError("len(seeds) must be a multiple of the seed mesh axis")
    M = num_resampled_ancestors
    B = num_samples_backward

    blocks = [
        make_block_windows(np.asarray(a, np.float32), segment_size, 0, n_blocks)
        for a in (n_meth_control, n_total_control, n_meth_case, n_total_case)
    ]
    # Keys per (device window, seed): fold in the window's first block index
    # so halo and exchange runs draw from unrelated streams.
    keys = jax.vmap(
        lambda g: jax.vmap(
            lambda s: jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(base_key), g), s
            )
        )(jnp.asarray(seeds, jnp.uint32))
    )(jnp.arange(n_blocks, dtype=jnp.uint32))  # (n_blocks, n_seeds, 2)

    assert params.n_regimes <= 31, "2-byte trajectory packing needs r < 32"
    progs = _exchange_programs(
        mesh, params.n_regimes, params.min_duration, segment_size,
        int(warmup_size), M, B, jnp.dtype(weight_dtype).name,
        phantom_regime, emission_table_fn,
    )
    e_c, e_k = progs["tables"](
        params.alpha, params.beta, *[jnp.asarray(b) for b in blocks]
    )
    arrs = tuple(params[2:])
    packed, d0, log_z = progs["run"](arrs, e_c, e_k, keys)
    # (n_genome, n_seeds, win, B, 2) uint8: decode per contiguous device
    # window, then lay out genome-major.
    packed = np.asarray(packed)
    d0 = np.asarray(d0)  # (n_genome, n_seeds, B, 2)
    ng, ns, win, b, _ = packed.shape
    bpd = win // segment_size
    dec = np.empty((ng, ns, win, b, 5), np.int32)
    for g in range(ng):
        _fill_block(dec[g], packed[g], d0[g])
    traj = (
        dec.reshape(ng, ns, bpd, segment_size, b, 5)
        .transpose(0, 2, 3, 1, 4, 5)
        .reshape(ng * bpd * segment_size, ns * b, 5)
    )
    return traj, np.asarray(log_z)  # log_z: (n_genome, n_seeds)
