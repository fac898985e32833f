"""Deterministic-proposal particle filter for the two-group model.

Re-design of filter_and_smoother_algorithm.py for XLA: the genome loop is
one ``lax.scan`` (static shapes; dead particle slots carry -inf weights), the
per-ancestor proposal while-loop is a vectorised (I, M) expansion, and the
observation density is a table gather. Weight algebra, resampling branches
and padding semantics mirror the reference exactly:

* _filter_first_step (:141-172): R**2 initial proposals scored against the
  phantom-state initial distribution, padded to N = M*I with -inf weights and
  -1 particles (expand_collapsed_results :334-365).
* _filter_one_step (:176-288): resample M ancestors (optimal finite-state,
  falling back per :201-219), expand, weight update with the optimal
  -min(0, log_c + log W_ancestor) correction (:244-270).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from hygeia_tpu.ops.resampling import (
    optimal_finite_state_resampling,
    unbiased_resampling,
)
from hygeia_tpu.two_group.model import (
    State,
    TwoGroupParams,
    transition_log_prob,
    paired_transition_log_prob,
    expand_score_and_observe,
    phantom_state,
)
from hygeia_tpu.two_group.proposal import expand_states, initial_states, num_children

_NEG_INF = -jnp.inf


# Cold-start filter state is built from deterministic proposal grids and
# replicated tables (unvarying under shard_map); promote it explicitly so
# the VMA checker can stay on (see utils/vma.py).
from hygeia_tpu.utils.vma import pcast_varying as _pcast_varying


def _narrow(state: State) -> State:
    """History storage dtypes: durations keep int32 (sojourns reach the
    segment length, 110k in production — int16 overflows), but the merged
    flag and the two regimes fit int8. 24 -> 15 bytes per particle-site cuts
    the (T, N) filter history from 6.3 GB to 4.0 GB per production segment,
    which matters most when XLA cannot reuse the donated input buffers."""
    return State(
        m=state.m.astype(jnp.int8),
        d_c=state.d_c,
        r_c=state.r_c.astype(jnp.int8),
        d_k=state.d_k,
        r_k=state.r_k.astype(jnp.int8),
    )


class FilterResult(NamedTuple):
    log_weights: jnp.ndarray  # (T, N) per-step-normalised log weights
    particles: State  # pytree of five (T, N) arrays (int32 durations, int8
    # merged flag/regimes — see _narrow). Kept as separate per-field arrays:
    # a stacked layout puts a length-5 axis last, which tiled layouts
    # pad (model.State.stack).
    log_normalizing_constant: jnp.ndarray  # scalar: sum of per-step shifts
    degenerate_steps: jnp.ndarray  # scalar int: steps where every particle
    # weight was non-finite and the filter reset to uniform (diagnostic; 0 in
    # healthy runs — nonzero signals numerical trouble, e.g. f32 tail hazards)


def run_filter(
    key,
    params: TwoGroupParams,
    emission_control,  # (T, R) table
    emission_case,  # (T, R) table
    num_resampled_ancestors: int,
    *,
    optimal_resampling: bool = True,
    multinomial_resampling: bool = False,
    weight_dtype=jnp.float32,
    phantom_regime=None,
    init_state=None,
    use_init=None,
    unroll: int = 8,
    vma_axes=(),
    return_history: bool = True,
) -> FilterResult:
    """Run the filter over T sites; returns full weight/particle history.

    return_history=False runs the IDENTICAL realisation (same keys, same
    per-site computations — unlike run_filter_final, whose key derivation
    differs) but emits no (T, N) ys: FilterResult.log_weights/particles then
    hold only the FINAL site's (N,) state. O(N) memory — the forward
    checkpoint sweep of the streaming backward (two_group/streaming.py).

    ``unroll`` sites are processed per lax.scan step, amortising the
    scan-step machinery (carry threading, ys update-slices, input slicing),
    whose cost does not depend on the particle count. The best factor on a
    GPU is not measured. Per-site RNG keys are derived with fold_in(key, t), so results
    are BIT-IDENTICAL for any unroll factor (covered by
    test_filter_unroll_invariance); trailing sites that don't fill the last
    chunk are computed masked and trimmed.

    The reference uses float64 weights (filter_and_smoother_algorithm.py:11)
    and lets the unnormalised weights accumulate over the whole segment —
    after 100k sites their magnitude reaches ~1e6, where float32 has ~0.25
    ulp and relative weights would be destroyed. We instead renormalise the
    carried weights every step (this changes no algorithmic quantity: all
    uses are shift-invariant) and accumulate the shifts into the
    log-normalising constant, making float32 safe. Pass float64 on
    CPU for parity testing.

    Warm start (exact boundary exchange across genome blocks): pass
    ``init_state = (log_weights (N,), particles State of (N,))`` — the final
    filter state of the *previous* genome block — and site 0 is scored with
    the regular transition from that state instead of the phantom-state
    initial distribution. ``use_init`` (traced bool, default True when
    init_state is given) selects warm vs cold at runtime so SPMD shards can
    branch on their mesh position (block 0 cold-starts).
    """
    R = params.n_regimes
    M = num_resampled_ancestors
    I = num_children(R)
    N = M * I
    T = emission_control.shape[0]

    key, k_init = jax.random.split(key)
    cold_lw, cold_states = _first_step(
        k_init,
        params,
        emission_control,
        emission_case,
        N,
        weight_dtype,
        phantom_regime,
    )
    cold_shift = logsumexp(cold_lw)
    cold_lw = cold_lw - cold_shift
    cold_lw, cold_states, cold_shift = _pcast_varying(
        (cold_lw, cold_states, cold_shift), vma_axes
    )

    if init_state is None:
        init_lw, init_states, init_shift = cold_lw, cold_states, cold_shift
    else:
        prev_lw, prev_particles = init_state
        key, k_warm = jax.random.split(key)
        warm_lw, warm_states = _one_step(
            k_warm,
            params,
            emission_control,
            emission_case,
            0,
            prev_lw.astype(weight_dtype),
            prev_particles,
            M,
            optimal_resampling,
            multinomial_resampling,
        )
        warm_lw = jnp.where(jnp.isnan(warm_lw), _NEG_INF, warm_lw)
        warm_shift = logsumexp(warm_lw)
        warm_lw = warm_lw - warm_shift
        if use_init is None:
            use_init = jnp.asarray(True)
        init_lw = jnp.where(use_init, warm_lw, cold_lw)
        init_states = State(
            *(jnp.where(use_init, w, c) for w, c in zip(warm_states, cold_states))
        )
        init_shift = jnp.where(use_init, warm_shift, cold_shift)

    def site_update(carry, t, k_step):
        prev_lw, prev_particles = carry
        new_lw, new_particles = _one_step(
            k_step,
            params,
            emission_control,
            emission_case,
            t,
            prev_lw,
            prev_particles,
            M,
            optimal_resampling,
            multinomial_resampling,
        )
        # Sanitise: any NaN weight becomes -inf (dead), and if the whole set
        # died (shift non-finite) reset to uniform so the filter can recover
        # instead of propagating NaN; counted in `degenerate_steps`.
        new_lw = jnp.where(jnp.isnan(new_lw), _NEG_INF, new_lw)
        shift = logsumexp(new_lw)
        degenerate = ~jnp.isfinite(shift)
        new_lw = jnp.where(
            degenerate,
            jnp.full_like(new_lw, -jnp.log(float(new_lw.shape[0]))),
            new_lw - jnp.where(degenerate, 0.0, shift),
        )
        shift = jnp.where(degenerate, 0.0, shift)
        return (new_lw, new_particles), (new_lw, new_particles, shift, degenerate)

    # History-buffer layout: the scan's ys ARE the returned history. Padding
    # slots sit at the FRONT and emit the (unadvanced) carry — i.e. the init
    # state — so the stacked ys read [init, ..., init, site 1, ..., site T-1].
    # With front_pad == 1 (whenever T % K == 0, true for the production
    # shapes) the ys are exactly the (T, N) history: NO trailing-slice copy
    # and NO init-row concatenate. Those two copies each duplicated the
    # ~4 GB history of a 110k-site segment and set the filter's peak
    # device memory. front_pad > 1 falls back to one slice (copy).
    K = max(1, int(unroll))
    n_steps = T - 1
    n_chunks = max(1, -(-T // K))
    front_pad = n_chunks * K - n_steps
    ts_pad = np.concatenate(
        [np.zeros(front_pad), np.arange(1, T)]
    ).astype(np.int32)
    valid_pad = np.concatenate([np.zeros(front_pad, bool), np.ones(n_steps, bool)])
    site_keys = jax.vmap(lambda t: jax.random.fold_in(key, t))(
        jnp.asarray(ts_pad, jnp.uint32)
    )

    def chunk_step(carry, inputs):
        ts_k, keys_k, valid_k = inputs
        outs = []
        for k in range(K):
            new_carry, out = site_update(carry, ts_k[k], keys_k[k])
            old_lw, old_parts = carry
            # Invalid (front-pad) slots: keep the old carry, emit it as the
            # history row, zero the shift.
            carry = jax.tree.map(
                lambda n, o: jnp.where(valid_k[k], n, o), new_carry, carry
            )
            if return_history:
                hist = (
                    jnp.where(valid_k[k], out[0], old_lw),
                    jax.tree.map(
                        lambda n, o: jnp.where(valid_k[k], n, o),
                        _narrow(out[1]),
                        _narrow(old_parts),
                    ),
                )
            else:
                hist = ()
            outs.append(
                hist + (jnp.where(valid_k[k], out[2], 0.0), out[3] & valid_k[k])
            )
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *outs)
        return carry, stacked

    xs = (
        jnp.asarray(ts_pad).reshape(n_chunks, K),
        site_keys.reshape((n_chunks, K) + site_keys.shape[1:]),
        jnp.asarray(valid_pad).reshape(n_chunks, K),
    )
    (final_lw, final_parts), ys = jax.lax.scan(
        chunk_step, (init_lw, init_states), xs
    )
    if return_history:
        lws, parts, shifts, degen = ys
    else:
        shifts, degen = ys
        return FilterResult(
            log_weights=final_lw,
            particles=final_parts,
            log_normalizing_constant=init_shift + jnp.sum(shifts),
            degenerate_steps=jnp.sum(degen),
        )
    skip = front_pad - 1  # rows before the init row; 0 in the zero-copy case
    all_lw = lws.reshape(n_chunks * K, -1)[skip:]
    all_parts = State(*(f.reshape(n_chunks * K, -1)[skip:] for f in parts))
    return FilterResult(
        log_weights=all_lw,
        particles=all_parts,
        log_normalizing_constant=init_shift + jnp.sum(shifts),
        degenerate_steps=jnp.sum(degen),
    )


def run_filter_final(
    key,
    params: TwoGroupParams,
    emission_control,  # (W, R) table — warmup window
    emission_case,  # (W, R)
    num_resampled_ancestors: int,
    *,
    optimal_resampling: bool = True,
    multinomial_resampling: bool = False,
    weight_dtype=jnp.float32,
    phantom_regime=None,
    vma_axes=(),
):
    """Cold-start filter that returns ONLY the final (log_weights, particles).

    Used as the warmup sweep of the exact boundary-exchange scheme
    (parallel/sharded.py): each genome block runs this on the tail of its
    left neighbour's window and ships the final state right via ppermute.
    No (W, N) history is materialised — O(N) memory.
    """
    R = params.n_regimes
    M = num_resampled_ancestors
    N = M * num_children(R)
    T = emission_control.shape[0]

    key, k_init = jax.random.split(key)
    lw, states = _first_step(
        k_init,
        params,
        emission_control,
        emission_case,
        N,
        weight_dtype,
        phantom_regime,
    )
    lw = lw - logsumexp(lw)
    lw, states = _pcast_varying((lw, states), vma_axes)

    def step(carry, inputs):
        prev_lw, prev_particles = carry
        t, k_step = inputs
        new_lw, new_particles = _one_step(
            k_step,
            params,
            emission_control,
            emission_case,
            t,
            prev_lw,
            prev_particles,
            M,
            optimal_resampling,
            multinomial_resampling,
        )
        new_lw = jnp.where(jnp.isnan(new_lw), _NEG_INF, new_lw)
        shift = logsumexp(new_lw)
        degenerate = ~jnp.isfinite(shift)
        new_lw = jnp.where(
            degenerate,
            jnp.full_like(new_lw, -jnp.log(float(new_lw.shape[0]))),
            new_lw - jnp.where(degenerate, 0.0, shift),
        )
        return (new_lw, new_particles), None

    ts = jnp.arange(1, T)
    keys = jax.random.split(key, T - 1)
    (final_lw, final_particles), _ = jax.lax.scan(step, (lw, states), (ts, keys))
    return final_lw, final_particles


def _first_step(
    key, params, emission_control, emission_case, n_max, weight_dtype, phantom_regime=None
):
    """R**2 initial proposals scored against the phantom-state prior.

    The phantom regime is sampled uniformly (InitialControlState._sample_n,
    case_control_distributions.py:67-74, via intitial_state_dist :234-244) —
    only proposals with merged=1 and control regime != phantom regime get
    finite weight, matching the reference's initial support.
    """
    R = params.n_regimes
    proposals = initial_states(R)  # (R*R,)
    if phantom_regime is None:
        phantom_r = jax.random.randint(key, (), 0, R)
    else:
        phantom_r = jnp.asarray(phantom_regime, jnp.int32)
    prev = phantom_state(phantom_r, (R * R,))
    trans_lp = transition_log_prob(params, prev, proposals, step0=True)
    obs_lp = emission_control[0, proposals.r_c] + emission_case[0, proposals.r_k]
    lw = (trans_lp + obs_lp).astype(weight_dtype)

    # Pad to N with -inf weights / -1 particles (expand_collapsed_results).
    n0 = R * R
    lw_full = jnp.full((n_max,), _NEG_INF, weight_dtype).at[:n0].set(lw)
    pad = jnp.full((n_max - n0,), -1, jnp.int32)
    fields = [
        jnp.concatenate([f.astype(jnp.int32), pad]) for f in proposals
    ]
    return lw_full, State(*fields)


def _one_step(
    key,
    params,
    emission_control,
    emission_case,
    t,
    prev_lw,
    prev_particles: State,
    M,
    optimal_resampling,
    multinomial_resampling,
    with_parents=False,
):
    """One filter step; static shapes throughout.

    with_parents=True additionally returns the (M,) resampled parent indices
    (the marginal filter's structured psi update keys its backward-kernel
    masks on the ancestors; two_group/marginal.py).

    Where the reference gathers only the finite-weight prefix
    (num_prev_particles slicing, :194-199), we keep the full N-buffer: dead
    ancestors (weight -inf) may be selected as top-M padding parents, and
    their children inherit -inf weights — algebraically identical.
    """
    dtype = prev_lw.dtype
    n_finite = jnp.sum(jnp.isfinite(prev_lw))
    # NORMALIZED-WEIGHT CONTRACT: every caller hands prev_lw renormalised
    # (run_filter/run_filter_final/marginal shift the carry every step, and
    # the warm/cold inits are shifted too), so logsumexp(prev_lw) == 0 up to
    # one f32 rounding. Treating it as exactly 0 removes two of the three
    # serialized full-N reduces per scan step (this one and the resampler's
    # entry normalise); the per-step shift accounting keeps the accumulated
    # logZ exactly telescoping either way, and the no-resample branch (the
    # exact-oracle path) never used log_z_prev at all.
    log_z_prev = jnp.zeros((), dtype)
    log_norm = prev_lw

    # --- resample M ancestors (resample block, :201-219) -------------------
    need_resample = n_finite > M
    if optimal_resampling:
        res = optimal_finite_state_resampling(
            key, log_norm.astype(jnp.float32), M, normalized=True
        )
    else:
        res = unbiased_resampling(
            key,
            log_norm.astype(jnp.float32),
            M,
            multinomial=multinomial_resampling,
            normalized=True,
        )
    # No-resample branch keeps the top-M slots; the indices come free from
    # the resampler's own top_k (ordering of prev_lw == ordering of the
    # normalised weights), avoiding a second top_k per scan step.
    parents = jnp.where(need_resample, res.parent_indices, res.top_m_indices)
    log_c = jnp.where(need_resample, res.log_c.astype(dtype), 0.0)
    use_unbiased = need_resample & res.use_unbiased

    anc = State(*(f[parents] for f in prev_particles))

    # --- fused expansion + densities + emission ----------------------------
    # Slot-structured kernel (model.expand_score_and_observe): the static
    # child-slot layout collapses the generic (I, M) branch tree to per-
    # region closed forms — bit-identical to expand_states +
    # paired_transition_log_prob + the one-hot emission selects
    # (equivalence tested).
    children, trans_lp, obs_lp = expand_score_and_observe(
        params, anc, emission_control[t], emission_case[t]
    )
    log_gamma = jnp.where(
        jnp.isfinite(trans_lp),
        trans_lp.astype(dtype) + obs_lp.astype(dtype),
        _NEG_INF,
    )

    # --- weight update (:244-270) ------------------------------------------
    prev_unnorm_anc = prev_lw[parents][None, :]  # (1, M)
    prev_norm_anc = log_norm[parents][None, :]
    w_no_resample = prev_unnorm_anc + log_gamma
    w_unbiased = (-jnp.log(float(M)) + log_z_prev) + log_gamma
    # Dead ancestors (weight -inf) must yield -inf children, not NaN from
    # (-inf) - min(0, log_c + (-inf)); guard explicitly.
    w_optimal = jnp.where(
        jnp.isfinite(prev_unnorm_anc),
        prev_unnorm_anc
        + log_gamma
        - jnp.minimum(jnp.zeros((), dtype), log_c + prev_norm_anc),
        _NEG_INF,
    )
    lw = jnp.where(
        ~need_resample,
        w_no_resample,
        jnp.where(use_unbiased, w_unbiased, w_optimal),
    )

    # Flatten (I, M) -> (N,) with n = i*M + m, matching the reference's
    # einsum-transpose + reshape (proposal_mappings :204, filter :228-229).
    new_lw = lw.reshape(-1)
    new_particles = State(*(f.reshape(-1) for f in children))
    if with_parents:
        return new_lw, new_particles, parents
    return new_lw, new_particles
