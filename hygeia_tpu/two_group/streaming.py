"""Streaming (checkpointed) filter + backward simulation: O(block) memory.

The monolithic path (runner.infer_segment) materialises the full (T, N)
filter history — ~4 GB at the production shape (T=110k, N=2400), and XLA
holds ~2x the history inside the fused program, which caps the seeds per
dispatch. Throughput on this latency-bound workload comes from independent work units
amortising the per-step serial chain, so residency IS throughput.

This module trades one extra filter sweep for O(W) history memory — the
classic checkpoint/rematerialisation scheme, expressed with machinery the
engine already has:

1. FORWARD: per genome block of W sites, run the filter with
   ``return_history=False`` (identical realisation to the history-returning
   filter — same keys — unlike run_filter_final) warm-started from the
   previous block's final state. Store only the (N,)-sized per-block final
   states (checkpoints).
2. REVERSE: walk blocks right-to-left. Re-run block b's filter (same key,
   same warm start -> bit-identical history, O(W*N) live at once), then
   sample its trajectory segment with ``backward_simulation_conditioned``
   against the first-site states of the ALREADY-SAMPLED block b+1 — the
   exact pathwise backward factorisation x_t | x_{t+1} (the last block draws
   its terminal from the final weights, reproducing backward_simulation).

The result is an EXACT draw from the same smoothing distribution the
monolithic backward samples (per-block keys differ from the monolithic
stream, so realisations are statistically — not bitwise — equivalent;
tests/test_streaming.py checks logZ + marginals against the monolithic path
and exact enumeration, and pathwise continuity across block joins).

Memory per seed: one (W, N) block history (~0.6 GB at W=16384, N=2400)
instead of 4 GB, so many more seeds stay resident per device.

The per-block programs are built ONCE per static configuration and cached
at module level with the model parameters passed as jit arguments — a
previous revision rebuilt four jax.jit objects inside every call, paying
a retrace + compile-cache lookup per program per segment.

Reference scope: this replaces nothing in ucl-medical-genomics/hygeia — the
reference's only answer to segment memory is smaller Nextflow segments with
halo error (run_inference_two_groups.py:194-218). Streaming keeps the
segment exact end-to-end.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from hygeia_tpu.two_group.filter import run_filter
from hygeia_tpu.two_group.backward import backward_simulation_conditioned

# (M, B, multinomial, weight_dtype, phantom, n_regimes, min_duration) ->
# dict of jitted programs. TwoGroupParams' array leaves ride as jit
# arguments (no constant-embedding, no per-call retrace); its two static
# int fields are baked in via the cache key. Shapes (W vs tail, seed count)
# are handled by jit's own shape cache.
_PROGRAMS = {}


def _pack_traj(traj):
    """Pack (W, B, 5) int32 trajectories to (W, B, 2) uint8 for the D2H pull.

    The device-to-host transfer of trajectories is packed to 2 B/element
    (chosen where that transfer was slow and did not overlap compute; not
    yet measured on a GPU, ROADMAP). The duration fields are NOT
    transferred at all — backward simulation only draws transition-compatible
    pairs (the conditioned variant preserves this across block joins), and
    every compatible transition's durations follow one of three
    reconstructible rules (model.transition_log_prob):
      * d_next == 1                (changepoint; the reset bit)
      * d_next == d_prev + 1       (continuation)
      * d_k == d_c while m == 1    (merged branch a requires it — including
        merges FROM split states with d_k_prev != d_c_prev, where d_k resets
        to d_c_prev + 1, not to 1)
    so the reset bits + the merged flag + the trajectory's first-site
    durations reconstruct both int32 duration fields exactly on the host
    (_fill_block; round-trip covered by
    tests/test_streaming.py::test_pack_fill_roundtrip_*).
      byte0 = r_c | (d_c==1)<<5 | m<<6      byte1 = r_k | (d_k==1)<<5
    (r < 32 asserted by streamed_inference; field order is State's
    (m, d_c, r_c, d_k, r_k).)
    """
    m = traj[..., 0]
    b0 = (traj[..., 2] & 31) | jnp.where(traj[..., 1] == 1, 32, 0) | (m << 6)
    b1 = (traj[..., 4] & 31) | jnp.where(traj[..., 3] == 1, 32, 0)
    return jnp.stack([b0, b1], axis=-1).astype(jnp.uint8)


def _programs(M, B, multinomial, weight_dtype, phantom_regime, params):
    from hygeia_tpu.two_group.model import TwoGroupParams

    cfg = (
        M,
        B,
        multinomial,
        jnp.dtype(weight_dtype).name,
        phantom_regime,
        params.n_regimes,
        params.min_duration,
    )
    if cfg in _PROGRAMS:
        return _PROGRAMS[cfg]
    n_regimes, min_duration = params.n_regimes, params.min_duration

    def _filter_block(arrs, key, ec, ek, init, use_init, return_history):
        params = TwoGroupParams(n_regimes, min_duration, *arrs)
        return run_filter(
            key,
            params,
            ec,
            ek,
            M,
            multinomial_resampling=multinomial,
            weight_dtype=weight_dtype,
            phantom_regime=phantom_regime,
            init_state=init,
            use_init=use_init,
            return_history=return_history,
        )

    @jax.jit
    def fwd_cold(arrs, ks, ec, ek):
        def one(k, ec1, ek1):
            r = _filter_block(arrs, k, ec1, ek1, None, None, False)
            return r.log_weights, r.particles

        return jax.vmap(one)(ks, ec, ek)

    @jax.jit
    def fwd_warm(arrs, ks, ec, ek, lw0, p0):
        def one(k, ec1, ek1, l0, q0):
            r = _filter_block(
                arrs, k, ec1, ek1, (l0, q0), jnp.asarray(True), False
            )
            return r.log_weights, r.particles

        return jax.vmap(one)(ks, ec, ek, lw0, p0)

    _pack = _pack_traj

    @jax.jit
    def rev_cold(arrs, ks, bks, ec, ek, term, use_term):
        params = TwoGroupParams(n_regimes, min_duration, *arrs)

        def one(k, bk, ec1, ek1, tm):
            r = _filter_block(arrs, k, ec1, ek1, None, None, True)
            traj = backward_simulation_conditioned(
                bk, params, r.log_weights, r.particles, tm, use_term
            )
            return (
                _pack(traj),
                traj[0],  # (B, 5) first-site states: left-neighbour term + d0
                r.log_normalizing_constant,
                r.degenerate_steps,
            )

        return jax.vmap(one)(ks, bks, ec, ek, term)

    @jax.jit
    def rev_warm(arrs, ks, bks, ec, ek, lw0, p0, term, use_term):
        params = TwoGroupParams(n_regimes, min_duration, *arrs)

        def one(k, bk, ec1, ek1, l0, q0, tm):
            r = _filter_block(
                arrs, k, ec1, ek1, (l0, q0), jnp.asarray(True), True
            )
            traj = backward_simulation_conditioned(
                bk, params, r.log_weights, r.particles, tm, use_term
            )
            return (
                _pack(traj),
                traj[0],
                r.log_normalizing_constant,
                r.degenerate_steps,
            )

        return jax.vmap(one)(ks, bks, ec, ek, lw0, p0, term)

    progs = {
        "fwd_cold": fwd_cold,
        "fwd_warm": fwd_warm,
        "rev_cold": rev_cold,
        "rev_warm": rev_warm,
    }
    _PROGRAMS[cfg] = progs
    return progs


def aot_compile_jobs(
    params,
    n_units,
    t_w,
    num_resampled_ancestors,
    num_samples_backward,
    *,
    block_size,
    multinomial=False,
    weight_dtype=jnp.float32,
    phantom_regime=None,
    seen=None,
):
    """Zero-arg callables that AOT-compile every program a
    ``streamed_inference`` call of this shape will request.

    ``seen`` (a mutable set) dedupes across calls: window-length groups
    sharing d_max and the vmap width also share their W-width block
    programs, so only tail-width programs differ per group.

    Compiles parallelise across threads — the caller runs these jobs on a
    thread pool (runner.prewarm_chromosome_streamed) so a fresh process
    does not pay (programs x compile time) serially in front of the first
    INFER dispatch. After AOT, the first real call re-traces and hits the
    now-written cache entry."""
    import jax

    S = n_units
    W = int(min(block_size, t_w))
    tail = t_w % W if t_w > W else 0
    R = params.n_regimes
    B = num_samples_backward
    pg = _programs(
        num_resampled_ancestors, B, multinomial, weight_dtype,
        phantom_regime, params,
    )
    sds = jax.ShapeDtypeStruct
    arrs = tuple(
        sds(a.shape, a.dtype) for a in tuple(params[2:])
    )
    ks = sds((S, 2), jnp.uint32)
    term = sds((S, B, 5), jnp.int32)
    flag = sds((), jnp.bool_)

    def ec(w):
        return sds((S, w, R), jnp.float32)

    # Final filter state shapes (independent of the block width).
    state = jax.eval_shape(pg["fwd_cold"], arrs, ks, ec(W), ec(W))
    state_sd = jax.tree.map(lambda x: sds(x.shape, x.dtype), state)
    lw_sd, p_sd = state_sd

    jobs = []
    seen = set() if seen is None else seen

    def add(name, w, fn):
        if (name, w, S) in seen:
            return
        seen.add((name, w, S))
        jobs.append(fn)

    if t_w <= W:
        # Single block: only the reverse cold program runs, at width t_w.
        add(
            "rev_cold", W,
            lambda: pg["rev_cold"]
            .lower(arrs, ks, ks, ec(W), ec(W), term, flag)
            .compile(),
        )
        return jobs
    widths = [W] + ([tail] if tail else [])
    add(
        "fwd_cold", W,
        lambda: pg["fwd_cold"].lower(arrs, ks, ec(W), ec(W)).compile(),
    )
    add(
        "rev_cold", W,
        lambda: pg["rev_cold"]
        .lower(arrs, ks, ks, ec(W), ec(W), term, flag)
        .compile(),
    )
    for w in widths:
        add(
            "fwd_warm", w,
            lambda w=w: pg["fwd_warm"]
            .lower(arrs, ks, ec(w), ec(w), lw_sd, p_sd)
            .compile(),
        )
        add(
            "rev_warm", w,
            lambda w=w: pg["rev_warm"]
            .lower(arrs, ks, ks, ec(w), ec(w), lw_sd, p_sd, term, flag)
            .compile(),
        )
    return jobs


def streamed_inference(
    keys,  # (S, 2) uint32 — one PRNG key per work unit
    params,
    emission_control,  # (T, R) shared, or (S, T, R) per-unit
    emission_case,  # same shape as emission_control
    num_resampled_ancestors: int,
    num_samples_backward: int,
    *,
    block_size: int = 16384,
    multinomial=False,
    weight_dtype=jnp.float32,
    phantom_regime=None,
    timings: dict | None = None,
):
    """Returns (traj (S, T, B, 5) int32 np, log_z (S,) np, degenerate (S,) np).

    A "unit" is an independent (segment, seed) inference: S units are vmapped
    inside every block dispatch. With 2-D emissions all units share one
    segment's observations (seed parallelism); with 3-D (S, T, R) emissions
    each unit carries its own segment (cross-segment batching — the workload
    is latency-bound along the scan, so per-site cost is nearly flat in S
    until device memory runs out; residency IS throughput). The block loop
    runs on the host (n_blocks * 3 dispatches of ~seconds each — dispatch
    latency is noise). Pass ``timings={}`` to capture per-dispatch
    walls (lists keyed "fwd"/"rev"/"pull", seconds) for the perf harness.
    """
    keys = jnp.asarray(keys)
    S = keys.shape[0]
    e_c = jnp.asarray(emission_control)
    e_k = jnp.asarray(emission_case)
    if e_c.ndim == 2:
        e_c = jnp.broadcast_to(e_c[None], (S,) + e_c.shape)
        e_k = jnp.broadcast_to(e_k[None], (S,) + e_k.shape)
    T = e_c.shape[1]
    B = num_samples_backward
    W = int(min(block_size, T))
    n_blocks = -(-T // W)
    bounds = [(b * W, min((b + 1) * W, T)) for b in range(n_blocks)]

    pg = _programs(
        num_resampled_ancestors, B, multinomial, weight_dtype, phantom_regime,
        params,
    )
    arrs = tuple(params[2:])  # array leaves; statics ride in the program cfg

    def _t(kind, fn, block=True):
        # block=False times only the dispatch enqueue (used for the reverse
        # chain, which is deliberately left in flight — the drain loop's
        # "pull" walls then include the wait for each block's compute, so
        # reverse compute is read as sum(pull) - transfer time).
        if timings is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if block:
            out = jax.block_until_ready(out)
        timings.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def block_key(ks, b):
        return jax.vmap(lambda k: jax.random.fold_in(k, b))(ks)

    # --- forward checkpoint sweep ------------------------------------------
    ckpts = [None] * n_blocks  # ckpts[b] = final (lw, particles) of block b
    state = None
    for b, (lo, hi) in enumerate(bounds):
        if n_blocks == 1:
            break  # single block: the reverse sweep cold-starts directly
        ks = block_key(keys, b)
        if b == 0:
            state = _t("fwd", lambda: pg["fwd_cold"](arrs, ks, e_c[:, lo:hi], e_k[:, lo:hi]))
        else:
            state = _t(
                "fwd",
                lambda: pg["fwd_warm"](
                    arrs, ks, e_c[:, lo:hi], e_k[:, lo:hi], state[0], state[1]
                ),
            )
        if b < n_blocks - 1:
            # Only the PREVIOUS block's final state is needed as a warm
            # start during the reverse sweep.
            ckpts[b] = state

    # --- reverse conditioned-backward sweep ---------------------------------
    # The ENTIRE reverse chain is dispatched asynchronously first: each
    # block's conditioning terminal is the (S, B, 5) device-side first-site
    # slice of the block to its right, so no host value enters the chain.
    # The drain loop below then pulls each 2 B/element packed block and
    # decodes + reconstructs it on the host WHILE the device is still
    # computing earlier blocks — the per-block decode + duration
    # reconstruction would otherwise serialize after the sweep.
    assert params.n_regimes <= 31, "2-byte trajectory packing needs r < 32"
    chain = [None] * n_blocks
    term = jnp.zeros((S, B, 5), jnp.int32)  # dummy for the last block
    use_term = jnp.asarray(False)
    for b in range(n_blocks - 1, -1, -1):
        lo, hi = bounds[b]
        ks = block_key(keys, b)
        bks = jax.vmap(lambda k: jax.random.fold_in(k, 1))(ks)
        if b == 0:
            chain[b] = _t(
                "rev_enqueue",
                lambda: pg["rev_cold"](
                    arrs, ks, bks, e_c[:, lo:hi], e_k[:, lo:hi], term, use_term
                ),
                block=False,
            )
        else:
            lw0, p0 = ckpts[b - 1]
            chain[b] = _t(
                "rev_enqueue",
                lambda: pg["rev_warm"](
                    arrs, ks, bks, e_c[:, lo:hi], e_k[:, lo:hi], lw0, p0,
                    term, use_term,
                ),
                block=False,
            )
        # (S, B, 5) first-site states: the left neighbour's conditioning
        # terminal, consumed device-side — the chain never syncs on the host.
        term = chain[b][1]
        use_term = jnp.asarray(True)

    log_z = np.zeros((S,), np.float64)
    degen = np.zeros((S,), np.int64)
    traj_full = np.empty((S, T, B, 5), np.int32)
    for b in range(n_blocks - 1, -1, -1):  # completion order
        lo, hi = bounds[b]
        packed, first, lz, dg = chain[b]
        pk_b = _t("pull", lambda: np.asarray(packed))  # (S, W, B, 2) uint8
        d0_b = np.asarray(first[..., jnp.array([1, 3])])  # (S, B, 2) tiny
        _t("host", lambda: _fill_block(traj_full[:, lo:hi], pk_b, d0_b))
        log_z += np.asarray(lz, np.float64)
        degen += np.asarray(dg, np.int64)
    return traj_full, log_z, degen


def _fill_block(out, pk, d0):
    """Decode one packed block into `out` (S, W, B, 5) int32, reconstructing
    the duration fields from the reset bits.

    Control durations satisfy d_t == 1 (reset bit) or d_t == d_{t-1} + 1
    (transition support, model.py transition_log_prob) — including across
    block joins (conditioned backward) — so within a block
    d_t = t - last_reset_at_or_before(t) + 1, seeded with a virtual reset at
    position 1 - d0 (d0 = the block's first-site durations) that makes the
    formula exact before the first in-block reset.

    Case durations have a THIRD rule: the merged branch (model.py branch a)
    requires d_k == d_c whenever m == 1, and a merge from a split state with
    d_k_prev != d_c_prev resets d_k to d_c_prev + 1 — which may SHRINK d_k,
    so a max-accumulate over reset positions is wrong there. Every merged
    site is instead an explicit "virtual reset at t - d_c + 1" (making
    d_k == d_c exact on the merged run and seeding post-merge continuations,
    which increment off the merged d_c per the in_b gate), and the last
    explicit position is FORWARD-FILLED rather than max-accumulated.
    """
    S, W, B, _ = pk.shape
    t = np.arange(W, dtype=np.int32)[None, :, None]
    p0 = pk[..., 0]
    p1 = pk[..., 1]
    m = ((p0 >> 6) & 1).astype(bool)
    out[..., 0] = m
    out[..., 2] = p0 & 31
    out[..., 4] = p1 & 31
    # Control: reset-or-increment only; positions are monotone so
    # max-accumulate is exact.
    pos = np.where(
        ((p0 >> 5) & 1).astype(bool), t, (np.int32(1) - d0[:, None, :, 0])
    )
    np.maximum.accumulate(pos, axis=1, out=pos)
    d_c = (t - pos + 1).astype(np.int32)
    out[..., 1] = d_c
    # Case: explicit sites are d_k==1 resets (bit) and ALL merged sites
    # (d_k := d_c there). Forward-fill the last explicit virtual-reset
    # position; fall back to the block's first-site duration before any
    # explicit site.
    explicit = (((p1 >> 5) & 1).astype(bool)) | m
    pos_val = np.where(m, t - d_c + 1, t)
    last = np.maximum.accumulate(np.where(explicit, t, np.int32(-1)), axis=1)
    filled = np.take_along_axis(pos_val, np.maximum(last, 0), axis=1)
    pos_k = np.where(last >= 0, filled, np.int32(1) - d0[:, None, :, 1])
    out[..., 3] = t - pos_k + 1
