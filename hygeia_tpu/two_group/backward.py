"""Backward simulation over the stored filter history.

Mirrors backward_simulation (filter_and_smoother_algorithm.py:368-446): draw
B terminal particles from the final weights, then walk backwards sampling
ancestors from the backward kernel

    B_t(b, n)  propto  w_t^n * f(x_{t+1}^b | x_t^n)

(compute_log_backward_kernel_from_transition_matrix, smoothing_functions.py:
27-44). The reference's reverse tf.while_loop with boolean-masked dynamic
shapes becomes a reverse ``lax.scan`` over static (B, N) logits — dead
particle slots are excluded by their -inf weights instead of masking.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hygeia_tpu.two_group.model import State, TwoGroupParams

_NEG_INF = -jnp.inf


# NOTE on hazard lookups: an earlier revision precomputed a (T, N)
# "_hazard_history" for the whole particle history and threaded it through
# the scan. The hoisted tables add two (T, N) f32 scan inputs whose
# per-step slicing cost more than the row-gather they save, and the hoist's
# 2 x T x N x 4 B footprint is 2.1 GB at the production 110k-site segment.
# Hazards are therefore computed per step.


def _structured_rho(params: TwoGroupParams, cur: State):
    """Hazard lookups for a HISTORY-LAYOUT particle set without (N,) gathers.

    The two (N=2400,) gather_rho calls were most of the backward scan step
    where this was first built (not yet measured on a GPU). Filter history
    rows have (I, M)
    child structure (proposal.expand_states): every child with duration > 1
    carries its ancestor's (regime, duration+1) pair, which the no-change
    row (child slot 0) holds verbatim — so the (N,) lookups collapse to
    three (M,)-sized gathers plus the static duration-1 hazard row:

      * d <= 1  ->  rho_table[r, 0]           (static (R,) row, one-hot select)
      * d  > 1, control side / case side of cont+ctrl_cp rows
                ->  table[anc.r, anc.d + 1]   (= the slot-0 value, (M,) gather)
      * d  > 1, case side of the MERGE row (slot 2R-1: r_k = anc.r_c,
        d_k = anc.d_c + 1, proposal.py:94-107)
                ->  rho_case[anc.r_c, anc.d_c + 1]  ((M,) gather)

    Exact for every live particle the filter can produce, including the
    initial R*R proposals (all durations 1 -> the d <= 1 branch) and the
    t = 0 history row. Dead slots (-1 padding / children of dead ancestors)
    get rho = 0 -> log rho = -inf, which the -inf weight mask absorbs just
    like the garbage the clipped gather produced. Requires cur to be a
    filter-history row (N = I*M child layout) — NOT valid for arbitrary
    states; _backward_logits keeps the generic gather as the default.
    """
    from hygeia_tpu.two_group.proposal import num_children
    from hygeia_tpu.ops.hazard import gather_rho

    R = params.n_regimes
    I = num_children(R)
    N = cur.d_c.shape[0]
    if N % I:
        raise ValueError(
            f"history_layout requires N = I*M child layout (N={N}, I={I})"
        )
    M = N // I
    f32 = params.rho_case.dtype

    # Representative ancestor pairs from the no-change row (static slice).
    d_c0, r_c0 = cur.d_c[:M], cur.r_c[:M]
    d_k0, r_k0 = cur.d_k[:M], cur.r_k[:M]
    a_c = gather_rho(params.rho_control, d_c0, r_c0)  # (M,) cheap path
    c_cont = gather_rho(params.rho_case, d_k0, r_k0)
    c_merge = gather_rho(params.rho_case, d_c0, r_c0)

    rho1_c = params.rho_control[:, 0]  # duration-1 hazards (R,)
    rho1_k = params.rho_case[:, 0]
    regs = jnp.arange(R)
    sel_c = jnp.sum(
        jnp.where(cur.r_c[..., None] == regs, rho1_c.astype(f32), 0.0), axis=-1
    )
    sel_k = jnp.sum(
        jnp.where(cur.r_k[..., None] == regs, rho1_k.astype(f32), 0.0), axis=-1
    )

    d_c2 = cur.d_c.reshape(I, M)
    d_k2 = cur.d_k.reshape(I, M)
    is_merge_row = (jnp.arange(I) == 2 * R - 1)[:, None]  # (I, 1) static
    rho_c = jnp.where(d_c2 <= 1, sel_c.reshape(I, M), a_c[None, :])
    deep_k = jnp.where(is_merge_row, c_merge[None, :], c_cont[None, :])
    rho_k = jnp.where(d_k2 <= 1, sel_k.reshape(I, M), deep_k)
    return rho_c.reshape(N), rho_k.reshape(N)


def _backward_logits(
    params: TwoGroupParams, cur: State, nxt: State, lw_t, *, history_layout=False
):
    """Backward-kernel logits  lw_t[n] + log f(nxt[b] | cur[n])  as (B, N).

    Semantically identical to
        transition_log_prob(params, cur[None, :], nxt[:, None]) + mask
    (covered by tests/test_two_group_filter.py::test_backward_logits_
    matches_transition) but restructured: the generic density broadcasts
    every intermediate of its ~50-op branch tree to (B, N). Here every
    prev-only factor (hazards, merged rows, duration gate) is computed once
    at (N,), every next-only factor at (B,), the control transition row
    lookup is one exact one-hot matmul sandwich (N,R)@(R,R)@(R,B), and only
    ~25 ops touch (B, N).

    Branch structure mirrors case_control_regime_model.py:80-87 and
    case_control_distributions.py:138-151, 246-291 — see
    model.transition_log_prob for the reference-line commentary.

    PRECONDITION (live ancestors only): the one-hot row lookups drop
    _lookup_log_p's dead-index guard — an out-of-range regime (-1 padding
    particle) yields an all-zero one-hot and a 0.0 row contribution instead
    of -inf. Callers must carry -inf log-weights for dead slots (lw_t is
    added to every row here, so -inf ancestors can never be sampled); the
    kernel is NOT drop-in equivalent to transition_log_prob on padded states.

    history_layout=True replaces the two (N,) hazard gathers with the
    structural lookup (_structured_rho) —
    valid only when ``cur`` is a filter-history row in (I, M) child layout.
    """
    R = params.n_regimes
    from hygeia_tpu.ops.hazard import gather_rho

    f32 = params.rho_case.dtype
    NEG = _NEG_INF

    def ind(c):
        return jnp.where(c, 0.0, NEG)

    # ---- prev-only (N,) ----------------------------------------------------
    if history_layout:
        rho_c, rho_k = _structured_rho(params, cur)
    else:
        rho_c = gather_rho(params.rho_control, cur.d_c, cur.r_c)
        rho_k = gather_rho(params.rho_case, cur.d_k, cur.r_k)
    log_rho_c, log1m_rho_c = jnp.log(rho_c), jnp.log1p(-rho_c)
    log_rho_k, log1m_rho_k = jnp.log(rho_k), jnp.log1p(-rho_k)
    gate = jnp.minimum(cur.d_k, cur.d_c) >= params.min_duration
    lpm = params.log_p_merged
    to0 = jnp.where(cur.m == 0, lpm[0, 0], lpm[1, 0])
    to1 = jnp.where(cur.m == 0, lpm[0, 1], lpm[1, 1])

    # Control transition row values log_p[cur.r_c, nxt.r_c] as (N, B): an
    # exact one-hot sandwich (0/1 operands; HIGHEST keeps the products in
    # f32, never TF32/bf16).
    regs = jnp.arange(R)
    safe = jnp.where(jnp.isfinite(params.log_p_control), params.log_p_control, -1e30)
    oh_prev = (cur.r_c[:, None] == regs).astype(f32)  # (N, R)
    oh_nxt_rc = (nxt.r_c[:, None] == regs).astype(f32)  # (B, R)
    hi = jax.lax.Precision.HIGHEST
    rows = jax.lax.dot(oh_prev, safe, precision=hi)  # (N, R)
    lp_p_nb = jax.lax.dot(rows, oh_nxt_rc.T, precision=hi)  # (N, B)
    lp_p_ctrl = jnp.where(lp_p_nb.T <= -1e29, NEG, lp_p_nb.T)  # (B, N)

    # ---- next-only (B,) ----------------------------------------------------
    lp_a = ind((nxt.r_k == nxt.r_c) & (nxt.d_k == nxt.d_c))
    lp_unif_not_c = ind(nxt.r_k != nxt.r_c) - jnp.log(float(R - 1))
    lp_b = lp_unif_not_c + ind(nxt.d_k == 1)
    nxt_dc1 = nxt.d_c == 1
    nxt_dk1 = nxt.d_k == 1

    # ---- joint (B, N) -------------------------------------------------------
    cN = lambda x: x[None, :]
    nB = lambda x: x[:, None]

    lp_m = jnp.where(
        cN(gate),
        jnp.where(nB(nxt.m == 0), cN(to0), cN(to1)),
        ind(nB(nxt.m) == cN(cur.m)),
    )

    lp_c = jnp.where(
        nB(nxt_dc1),
        cN(log_rho_c) + lp_p_ctrl,
        cN(log1m_rho_c)
        + ind(cN(cur.d_c) == nB(nxt.d_c - 1))
        + ind(cN(cur.r_c) == nB(nxt.r_c)),
    )

    log_n_opts = jnp.where(
        nB(nxt.r_c) != cN(cur.r_k),
        jnp.log(jnp.asarray(R - 2, f32)),
        jnp.log(jnp.asarray(R - 1, f32)),
    )
    lp_unif2 = (
        nB(ind(nxt.r_k != nxt.r_c))
        + ind(nB(nxt.r_k) != cN(cur.r_k))
        - log_n_opts
    )
    lp_cbr = nB(ind(nxt_dk1)) + lp_unif2
    lp_d = jnp.where(
        nB(nxt_dk1),
        cN(log_rho_k) + lp_unif2,
        cN(log1m_rho_k)
        + ind(cN(cur.d_k + 1) == nB(nxt.d_k))
        + ind(cN(cur.r_k) == nB(nxt.r_k)),
    )
    in_b = cN(cur.m == 1) & nB(~nxt_dc1)
    in_c = (nB(nxt.r_c) == cN(cur.r_k)) & cN(cur.m == 0)
    lp_k = jnp.where(
        nB(nxt.m == 1),
        nB(lp_a),
        jnp.where(in_b, nB(lp_b), jnp.where(in_c, lp_cbr, lp_d)),
    )

    trans = lp_m + lp_c + lp_k
    return jnp.where(
        jnp.isfinite(trans) & cN(lw_t > NEG),
        cN(lw_t).astype(trans.dtype) + trans,
        NEG,
    )


def _categorical_rows(key, logits):
    """One categorical draw per row of (B, N) logits.

    jax.random.categorical's Gumbel argmax reduces the (B, N) logits in
    parallel, where an inverse-CDF comparison-count (cumsum + count)
    serialises its cumsum along the 2400-wide particle axis; the Gumbel form
    was about 3x faster where this was first built (not yet measured on a
    GPU). (The inverse-CDF trick suits resampling-style draws of M values
    from one weight row — see ops/resampling._count_below — where the
    cumsum is reused across draws.)
    """
    return jax.random.categorical(key, logits, axis=-1)


def backward_simulation(
    key,
    params: TwoGroupParams,
    log_weights,  # (T, N) unnormalised filter weights
    particles: State,  # pytree of five (T, N) arrays (FilterResult.particles)
    num_simulations: int,
):
    """Returns (T, B, 5) int32 sampled smoothing trajectories."""
    T, N = log_weights.shape
    B = num_simulations

    key, k_last = jax.random.split(key)
    last_lw = log_weights[T - 1]
    idx = jax.random.categorical(k_last, last_lw, shape=(B,))
    last_particle = State(*(f[T - 1][idx] for f in particles))  # fields (B,)

    # The scan consumes the FULL (T, N) history as xs with a terminal-step
    # mask rather than slicing off the last row: `log_weights[:T-1]` and the
    # five particle-field head slices each materialise a copy inside the jit
    # — ~6.3 GB extra at the production 110k-site segment, even with the
    # history donated.
    # Masking wastes one step's kernel evaluation out of T instead.
    def step(carry, inputs):
        nxt = carry  # State of (B,) — particle at time t+1
        lw_t, cur, k, is_last = inputs  # (N,), State of (N,), key, bool
        logits = _backward_logits(
            params, cur, nxt, lw_t, history_layout=True
        )  # (B, N)
        sel = _categorical_rows(k, logits)  # (B,)
        picked = State(
            *(jnp.where(is_last, n, f[sel]) for n, f in zip(nxt, cur))
        )
        return picked, picked

    # Reverse over t = T-1 .. 0. At t = T-1 the carry is the terminal draw
    # and the step emits it unchanged; each earlier step samples time t from
    # the backward kernel against the particle chosen for t+1. Keys are
    # derived per row so the stream matches the semantic step index.
    keys = jax.random.split(key, T)
    is_last = jnp.arange(T) == T - 1
    _, trajectory = jax.lax.scan(
        step,
        last_particle,
        (log_weights, particles, keys, is_last),
        reverse=True,
        unroll=4,
    )
    # History fields are mixed-width (int8 regimes, int32 durations); the
    # packed trajectory is small, so widen uniformly.
    return jnp.stack(
        [f.astype(jnp.int32) for f in trajectory], axis=-1
    )  # (T, B, 5)


def backward_simulation_conditioned(
    key,
    params: TwoGroupParams,
    log_weights,  # (T, N) filter weights
    particles: State,  # pytree of five (T, N) arrays
    terminal_state,  # (B, 5) int32 — next-block first-site states
    use_terminal,  # traced bool: condition on terminal_state?
):
    """Backward simulation conditioned on the NEXT genome block's trajectory.

    Exact boundary-exchange smoothing (parallel/sharded.py): block b receives
    block b+1's sampled states at its first site (one site to the right of
    block b's last site) and samples its own last site from the backward
    kernel B(b, n) ∝ w_{T-1}^n f(terminal_b | x_{T-1}^n) instead of from the
    filtered weights — making trajectories continuous across block joins.
    When ``use_terminal`` is False (the genome's last block) the terminal is
    drawn from the final weights, reproducing ``backward_simulation``.

    Returns (T, B, 5) int32 trajectories.
    """
    T, N = log_weights.shape
    B = terminal_state.shape[0]
    # Carry dtypes must match the (mixed-width) history fields the scan picks
    # from (int8 regimes/flag, int32 durations; see filter._narrow).
    nxt0 = State(
        *(
            terminal_state[:, i].astype(f.dtype)
            for i, f in enumerate(particles)
        )
    )

    def step(carry, inputs):
        nxt = carry  # (B,) State at time t+1
        lw_t, cur, k, is_term = inputs
        logits_cond = _backward_logits(
            params, cur, nxt, lw_t, history_layout=True
        )  # (B, N)
        # At the terminal step without conditioning, fall back to drawing
        # from the filtered weights (backward_simulation's terminal draw).
        logits_uncond = jnp.broadcast_to(
            lw_t[None, :].astype(logits_cond.dtype), logits_cond.shape
        )
        logits = jnp.where(is_term & ~use_terminal, logits_uncond, logits_cond)
        sel = _categorical_rows(k, logits)  # (B,)
        picked = State(*(f[sel] for f in cur))
        return picked, picked

    keys = jax.random.split(key, T)
    is_term = jnp.arange(T) == T - 1
    _, trajectory = jax.lax.scan(
        step,
        nxt0,
        (log_weights, particles, keys, is_term),
        reverse=True,
        unroll=4,
    )
    return jnp.stack(
        [f.astype(jnp.int32) for f in trajectory], axis=-1
    )  # (T, B, 5)


def smoothing_functionals(trajectory, n_regimes):
    """Split probabilities and regime marginals from backward trajectories.

    Mirrors test_function + reduce_mean (run_inference_two_groups.py:233-240,
    294-296): returns (split_probs (T,), regime_probs (T, 2R)) where columns
    0..R-1 are control regimes and R..2R-1 case regimes.
    """
    m = trajectory[..., 0]
    r_c = trajectory[..., 2]
    r_k = trajectory[..., 4]
    split = jnp.mean((m == 0).astype(jnp.float32), axis=1)
    ctrl = jnp.stack(
        [jnp.mean((r_c == i).astype(jnp.float32), axis=1) for i in range(n_regimes)],
        axis=-1,
    )
    case = jnp.stack(
        [jnp.mean((r_k == i).astype(jnp.float32), axis=1) for i in range(n_regimes)],
        axis=-1,
    )
    return split, jnp.concatenate([ctrl, case], axis=-1)
