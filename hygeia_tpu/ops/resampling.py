"""Resampling schemes for the particle filters, as fixed-shape JAX ops.

Implements the three schemes the reference supports (Smc.h:16-21,
resampling_functions.py):

* multinomial
* systematic
* optimal finite-state (Fearnhead 1998)

All functions take `log_weights` of static length N (entries may be -inf for
dead particle slots) and return exactly `num_offspring` parent indices. The
reference's data-dependent while-loops (resampling_functions.py:12-23,56-69;
resample.h:333-342) are replaced by closed-form vectorised computations
(argsort + cumulative sums + searchsorted), which map onto the VPU without
serialising the scan step.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_NEG_INF = -jnp.inf


class ResampleResult(NamedTuple):
    parent_indices: jnp.ndarray  # (M,) int32
    log_c: jnp.ndarray  # scalar; 0.0 for unbiased schemes
    use_unbiased: jnp.ndarray  # scalar bool; True -> weight formula w/Z/M
    # C++-style post-resampling log-unnormalised weights for the M ancestors
    # (kept: previous weight; resampled: logZ - log_c). Mirrors
    # resample.h:350-364. Only meaningful for the optimal scheme.
    new_log_weights: jnp.ndarray  # (M,)
    # Top-M indices by weight (descending) — the keep_top_m fallback parents,
    # shared here so the filter's no-resample branch reuses this scheme's
    # top_k instead of running a second one per scan step.
    top_m_indices: jnp.ndarray  # (M,) int32


def _normalise(log_weights):
    log_z = jax.scipy.special.logsumexp(log_weights)
    return log_weights - log_z, log_z


_PREFIX_BLOCK = 128


def _cumsum_fast(x):
    """(N,) inclusive prefix sum via blocked lower-triangular matmuls.

    XLA's cumsum lowering serialises along the axis. Blocked form: reshape
    to (nb, 128), multiply by a 128x128 lower-triangular ones matrix
    (HIGHEST precision — f32 accumulation), then offset blocks by a tiny
    (nb,) cumsum. Summation order differs from sequential cumsum only in
    grouping; the realised-total rescaling used by every CDF consumer keeps
    the grids consistent. Whether this beats jnp.cumsum on a GPU is not
    measured (ROADMAP)."""
    n = x.shape[0]
    if n <= _PREFIX_BLOCK:
        return jnp.cumsum(x)
    nb = -(-n // _PREFIX_BLOCK)
    xp = jnp.pad(x, (0, nb * _PREFIX_BLOCK - n)).reshape(nb, _PREFIX_BLOCK)
    tril = jnp.tril(jnp.ones((_PREFIX_BLOCK, _PREFIX_BLOCK), x.dtype))
    within = jax.lax.dot(
        xp, tril.T, precision=jax.lax.Precision.HIGHEST
    )  # (nb, B) prefix within each block
    offs = jnp.concatenate(
        [jnp.zeros((1,), x.dtype), jnp.cumsum(within[:, -1])[:-1]]
    )
    return (within + offs[:, None]).reshape(-1)[:n]


def _member_mask(n, idx):
    """Boolean (n,) mask marking the positions in `idx` — built from a
    comparison table instead of a scatter (`.at[idx].set(True)` serialises
    inside a scan step)."""
    hits = jnp.arange(n)[None, :] == idx[:, None]  # (len(idx), n)
    return jnp.any(hits, axis=0), hits


def _count_below(q, t, *, strict_side_left=True):
    """Exact replacement for jnp.searchsorted(q, t, side=...) on sorted q.

    side="left"  -> first i with q_i >= t  == #{i: q_i <  t}
    side="right" -> first i with q_i >  t  == #{i: q_i <= t}

    Computed as a (len(t), len(q)) comparison + row-sum: pure VPU work that
    fuses into the surrounding step, instead of XLA's binary-search lowering
    (a log2(N)-deep while loop of dynamic gathers per query).
    """
    if strict_side_left:
        cmp = q[None, :] < t[:, None]
    else:
        cmp = q[None, :] <= t[:, None]
    return jnp.sum(cmp.astype(jnp.int32), axis=1)


def systematic_resampling(key, log_norm_weights, num_offspring):
    """Systematic resampling: M offspring from normalised log-weights.

    Mirrors resampling_functions.py:56-69 (and resample.h:119-141): grid
    points T_j = (j + U)/M against the weight CDF; offspring j gets the first
    index i with T_j <= Q_i. The sequential while-loop is replaced by
    `searchsorted` on the cumulative sum.
    """
    m = num_offspring
    u = jax.random.uniform(key, (), dtype=jnp.float32)
    q = _cumsum_fast(jnp.exp(log_norm_weights))
    # Scale the grid by the realised total mass: with f32 rounding the cumsum
    # total can fall below 1, and an unscaled grid point past it would select
    # a zero-weight (dead) slot, producing -inf ancestors.
    t = (jnp.arange(m, dtype=jnp.float32) + u) / m * q[-1]
    idx = _count_below(q, t)
    return jnp.clip(idx, 0, log_norm_weights.shape[0] - 1).astype(jnp.int32)


def multinomial_resampling(key, log_weights, num_offspring, *, normalized=False):
    """Multinomial resampling via inverse-CDF sampling.

    Exactly multinomial (M iid categorical draws), but costs M uniforms plus
    a cumsum + searchsorted instead of the Gumbel-max formulation's (M, N)
    noise tensor (an (M, N) threefry draw on every filter scan step).

    normalized=True: caller guarantees logsumexp(log_weights) == 0 (the
    filter renormalises its carried weights every step), skipping the entry
    reduce. The CDF grid is rescaled by the realised total either way, so
    the selection is identical up to f32 rounding.
    """
    n = log_weights.shape[0]
    if normalized:
        log_norm = log_weights
    else:
        log_norm, _ = _normalise(log_weights)
    q = _cumsum_fast(jnp.exp(log_norm))
    u = jax.random.uniform(key, (num_offspring,), dtype=jnp.float32)
    # side="right" (first q strictly above t): zero-weight slots have
    # q_i == q_{i-1} and can never be hit, even at exact CDF boundaries.
    idx = _count_below(q, u * q[-1], strict_side_left=False)
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)


def unbiased_resampling(key, log_weights, num_offspring, multinomial=False, *, normalized=False):
    """Unbiased (systematic or multinomial) resampling.

    Mirrors resampling_functions.py:71-80: all offspring get equal
    post-resampling weight Z/M (signalled by use_unbiased=True).
    """
    if normalized:
        log_norm, log_z = log_weights, jnp.zeros((), log_weights.dtype)
    else:
        log_norm, log_z = _normalise(log_weights)
    if multinomial:
        parents = multinomial_resampling(
            key, log_norm, num_offspring, normalized=True
        )
    else:
        parents = systematic_resampling(key, log_norm, num_offspring)
    new_w = jnp.full((num_offspring,), log_z - jnp.log(float(num_offspring)))
    _, top_idx = jax.lax.top_k(log_weights, num_offspring)
    return ResampleResult(
        parent_indices=parents,
        log_c=jnp.asarray(0.0, log_weights.dtype),
        use_unbiased=jnp.asarray(True),
        new_log_weights=new_w.astype(log_weights.dtype),
        top_m_indices=top_idx.astype(jnp.int32),
    )


def optimal_finite_state_resampling(key, log_weights, num_offspring, *, normalized=False):
    """Fearnhead's optimal finite-state resampling, fully vectorised.

    Finds the threshold c with sum_i min(1, c * W_i) = M, keeps the K
    particles with c*W_i > 1 deterministically, and systematic-resamples the
    remaining M-K offspring from the residual weights. Post-resampling
    unnormalised weights: kept -> previous weight, resampled -> Z/c.

    Mirrors resampling_functions.py:7-52 and resample.h:289-409, including:
    * the fallback to multinomial resampling with unbiased Z/M weights when
      log_c is non-finite (resampling_functions.py:42-47), and
    * the degenerate keep-top-M path when fewer than M particles have
      positive weight (resample.h:366-408).

    The reference's c-threshold fixed-point while-loop
    (resampling_functions.py:12-23) is replaced by a closed-form scan over
    candidate K values: K is the smallest k with c_k * q_k <= 1 where
    c_k = (M - k) / Q_k, q the sorted (desc) normalised weights and Q_k the
    suffix sum. Since K <= M by construction, only the top M+1 weights are
    needed — `lax.top_k` instead of a full N-element sort, and the residual
    systematic pass runs over the *unsorted* weights with the kept set
    masked out (ordering does not affect its unbiasedness). Equivalence with
    the iterative reference version is covered by tests/test_resampling.py.

    normalized=True: caller guarantees logsumexp(log_weights) == 0 (the
    filters renormalise their carried weights every step — filter.py), so
    the entry reduce is skipped. Every scan step otherwise pays THREE
    serialized full-N logsumexps (caller's, this one, and the residual's);
    the contract plus the realised-total residual rescale cuts that to one.
    """
    n = log_weights.shape[0]
    m = num_offspring
    dtype = log_weights.dtype

    if normalized:
        log_norm, log_z = log_weights, jnp.zeros((), dtype)
    else:
        log_norm, log_z = _normalise(log_weights)
    kk = min(m + 1, n)
    top_lw, top_idx = jax.lax.top_k(log_norm, kk)  # sorted desc
    top_q = jnp.exp(top_lw)
    # Q_k = suffix mass of the normalised weights from rank k on. Computed as
    # a sum of POSITIVE terms: reverse-cumsum over the top block plus the
    # directly-summed non-top tail. The obvious 1 - prefix_k form is
    # catastrophically cancellative in f32 once the top-M particles hold
    # nearly all the mass (suffix ~1e-6 vs ulp(1) ~1.2e-7 -> ~%-level noise
    # in log_c), which makes the consistency conditions below flip
    # incoherently between adjacent k, so NO candidate passes and the
    # multinomial fallback collapses a healthy particle set (observed: logZ
    # 2.4 nats low on a 10-site f64 parity test because one step fell back).
    top_mask, top_hits = _member_mask(n, top_idx)
    tail = jnp.sum(jnp.where(top_mask, 0.0, jnp.exp(log_norm)))
    suffix = jnp.cumsum(top_q[::-1])[::-1] + tail

    k_range = jnp.arange(kk, dtype=dtype)
    log_c_k = jnp.log(jnp.maximum(m - k_range, 0.0)) - jnp.log(suffix)
    # Candidate k is consistent iff c_k*q_k <= 1 and (k == 0 or c_k*q_{k-1} >= 1)
    # and k <= m. The previous-particle check is INCLUSIVE: at an exact
    # boundary tie c*q_{k-1} == 1 (which f32 rounding produces in practice —
    # residual-resampled particles share identical weights Z/c, and the
    # threshold can land on such a block), keeping vs resampling that
    # particle are equivalent (min(1, c*w) = c*w = 1), but a strict `>`
    # rejects every k and spuriously triggers the multinomial fallback,
    # collapsing the particle set and inflating logZ variance ~1e4-fold.
    below = log_c_k + top_lw <= 0.0
    prev_lw = jnp.concatenate([jnp.array([jnp.inf], dtype), top_lw[:-1]])
    above_prev = log_c_k + prev_lw >= 0.0
    ok = below & above_prev & (k_range <= m)
    any_ok = jnp.any(ok)
    k_star = jnp.argmax(ok)  # first consistent k
    # No consistent k (e.g. fewer than M finite weights): mirror the
    # reference's K >= N clamp with log_c = -inf (resampling_functions.py:29-31).
    k_star = jnp.where(any_ok, k_star, n)
    log_c = jnp.where(any_ok, log_c_k[jnp.clip(k_star, 0, kk - 1)], _NEG_INF)

    # Deterministically-kept parents: the top-K indices (already sorted desc).
    slots = jnp.arange(m)
    kept_parents = top_idx[jnp.clip(slots, 0, kk - 1)]

    # Residual systematic resampling over the unsorted weights with the kept
    # set masked out.
    kept_mask = jnp.any(top_hits & slots_mask(kk, k_star)[:, None], axis=0)
    # Residual CDF over the UNnormalised residual weights: the grid below is
    # rescaled by the realised total q_resid[-1] anyway, so normalising first
    # (a full-N logsumexp on the serial chain) changes nothing but rounding.
    resid_w = jnp.where(kept_mask, 0.0, jnp.exp(log_norm))
    key_sys, key_mult = jax.random.split(key)
    # Draw M offspring positions; only positions >= K are used.
    l = jnp.maximum(m - k_star, 1)
    u = jax.random.uniform(key_sys, (), dtype=jnp.float32)
    q_resid = _cumsum_fast(resid_w)
    # Grid scaled by the realised residual mass (see systematic_resampling):
    # prevents selecting past the last live particle under f32 rounding.
    t = (jnp.arange(m, dtype=jnp.float32) + u) / l.astype(jnp.float32) * q_resid[-1]
    sys_idx = jnp.clip(slots - k_star, 0, m - 1)
    resampled_parents = jnp.clip(_count_below(q_resid, t[sys_idx]), 0, n - 1)
    parents = jnp.where(slots < k_star, kept_parents, resampled_parents)

    # Post-resampling weights (C++ semantics, resample.h:350-364).
    new_w = jnp.where(slots < k_star, log_weights[parents], log_z - log_c)

    # Fallback when log_c is non-finite: multinomial with unbiased weights
    # (resampling_functions.py:42-47).
    bad = ~jnp.isfinite(log_c)
    mult_parents = multinomial_resampling(key_mult, log_norm, m, normalized=True)
    parents = jnp.where(bad, mult_parents, parents).astype(jnp.int32)
    new_w = jnp.where(bad, log_z - jnp.log(float(m)), new_w)
    log_c = jnp.where(bad, jnp.asarray(0.0, dtype), log_c)

    return ResampleResult(
        parent_indices=parents,
        log_c=log_c,
        use_unbiased=bad,
        new_log_weights=new_w.astype(dtype),
        top_m_indices=kept_parents.astype(jnp.int32),
    )


def slots_mask(kk, k_star):
    """Boolean vector marking the first k_star of kk top slots as kept."""
    return jnp.arange(kk) < k_star


def keep_top_m(log_weights, num_offspring):
    """Keep the M particles with the largest weights (no resampling).

    Mirrors Smc.h:432-441 / resample.h:366-375: ancestors are the top-M
    indices sorted descending; their weights pass through unchanged.
    (lax.top_k rather than a full sort: ties break by index like a stable
    descending argsort.)
    """
    vals, parents = jax.lax.top_k(log_weights, num_offspring)
    return ResampleResult(
        parent_indices=parents.astype(jnp.int32),
        log_c=jnp.asarray(0.0, log_weights.dtype),
        use_unbiased=jnp.asarray(False),
        new_log_weights=vals,
        top_m_indices=parents.astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# Conditional resampling (conditional-SMC support; off the reference's main
# path — Smc.h only uses the unconditional trio, see PARITY.md)
# ---------------------------------------------------------------------------


class ConditionalResampleResult(NamedTuple):
    parent_indices: jnp.ndarray  # (M,) int32; parent_indices[b] == a
    b: jnp.ndarray  # scalar int32 index of the distinguished offspring


def conditional_multinomial_resampling(
    key, log_weights, num_offspring, conditioning_parent, *, normalized=False
):
    """Conditional multinomial resampling (resample.h:65-78).

    M iid categorical parent draws, then — exactly as the reference — the
    distinguished offspring index is fixed at b = 0 and its parent forced to
    `conditioning_parent`.
    """
    parents = multinomial_resampling(
        key, log_weights, num_offspring, normalized=normalized
    )
    a = jnp.asarray(conditioning_parent, jnp.int32)
    parents = jnp.where(jnp.arange(num_offspring) == 0, a, parents)
    return ConditionalResampleResult(parents, jnp.asarray(0, jnp.int32))


def conditional_systematic_resampling(
    key, log_norm_weights, num_offspring, conditioning_parent, *, uniforms=None
):
    """Conditional systematic resampling (resample.h:154-281).

    Given normalised weights w and the parent index a of the conditioning
    path, (1) samples the distinguished offspring index b from the strata
    compatible with a (equal mass on interior strata, boundary strata get
    their overlap mass, resample.h:175-198), (2) restricts the systematic
    uniform to the [lb, ub] range compatible with (a, b) (resample.h:203-215),
    and (3) runs standard systematic resampling on the grid T_j = j + u
    against Q = cumsum(M*w), forcing parent[b] = a (resample.h:218-243).

    The reference's three sequential while-loops become comparison-count
    reductions (`_count_below`); the stratum draw uses the same inverse-CDF
    rule as the reference's sampleInt (misc.h:155-159), so given identical
    uniforms the output matches the C++ loop exactly (tests/test_offpath.py
    checks this against a direct NumPy port). The i == N degenerate guard
    (numerically zero weight of the conditioning path, resample.h:248-259)
    becomes the same full-passthrough fallback with b = a.

    `uniforms`: optional (u_systematic, u_stratum) pair overriding the key
    draws (used by the parity oracle test).
    """
    n = log_norm_weights.shape[0]
    m = num_offspring
    a = jnp.asarray(conditioning_parent, jnp.int32)
    if uniforms is None:
        k1, k2 = jax.random.split(key)
        u_raw = jax.random.uniform(k1, (), dtype=log_norm_weights.dtype)
        u_strat = jax.random.uniform(k2, (), dtype=log_norm_weights.dtype)
    else:
        u_raw, u_strat = (jnp.asarray(v, log_norm_weights.dtype) for v in uniforms)

    w = jnp.exp(log_norm_weights)
    q = _cumsum_fast(m * w)  # (n,)
    bins = jnp.clip(jnp.ceil(q) - 1, 0, m - 1).astype(jnp.int32)

    a_prev = jnp.maximum(a - 1, 0)
    bin_a = bins[a]
    q_a = q[a]
    bin_p = jnp.where(a > 0, bins[a_prev], bin_a)
    q_p = q[a_prev]
    degenerate = (a == 0) | (bin_a == bin_p)

    # Strata weights for the distinguished index (resample.h:181-195):
    # interior strata get 1, the last stratum gets Q(a) - bins(a), the first
    # gets bins(a-1) - Q(a-1) + 1.
    s = jnp.arange(m)
    w_aux = ((s > bin_p) & (s < bin_a)).astype(q.dtype)
    w_aux = jnp.where(s == bin_a, q_a - bin_a, w_aux)
    w_aux = jnp.where(s == bin_p, bin_p - q_p + 1.0, w_aux)
    cum_aux = _cumsum_fast(w_aux)
    # sampleInt: first index with cumsum >= u * total (inverse CDF).
    b_sampled = jnp.sum(
        (cum_aux < u_strat * cum_aux[-1]).astype(jnp.int32)
    ).astype(jnp.int32)
    b = jnp.where(degenerate, bin_a, b_sampled)

    # Restrict the systematic uniform to the (a, b)-compatible range
    # (resample.h:203-215).
    lb = jnp.where((a > 0) & (b == bin_p), q_p - bin_p, 0.0)
    ub = jnp.where(b == bin_a, q_a - bin_a, 1.0)
    u = lb + (ub - lb) * u_raw

    t = jnp.arange(m, dtype=q.dtype) + u
    count = _count_below(q, t)  # first i with T_j <= Q_i
    # The reference's second loop restarts at i = a for j > b
    # (resample.h:245-246), so later offspring never select parents < a.
    parents = jnp.where(s > b, jnp.maximum(count, a), count)
    # Degenerate i == N guard (resample.h:248-259): full passthrough.
    overflow = jnp.any((s > b) & (count > n - 1))
    parents = jnp.clip(parents, 0, n - 1).astype(jnp.int32)
    parents = jnp.where(s == b, a, parents)
    parents = jnp.where(overflow, s.astype(jnp.int32), parents)
    b = jnp.where(overflow, a, b)
    return ConditionalResampleResult(parents, b)
