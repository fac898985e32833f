"""Per-site emission log-likelihood tables.

The observation density depends on the latent state only through the regime
index r (Beta-Binomial with regime-specific shapes; singleGroup.h:611-627,
case_control_regime_model.py:197-231). Instead of evaluating the density per
particle (as both reference engines do), we precompute one (T, R) table

    E[t, r] = sum_s log BetaBinomial(y[t, s]; n[t, s], alpha_r, beta_r)

in a single vectorised pass; the filters then just gather E[t, r_particle].
This turns the per-step observation work from O(N * S) transcendental calls
into an int gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hygeia_tpu.ops.distributions import beta_binomial_log_pmf


def emission_log_prob_table(n_methylated, n_total, alpha, beta, dtype=None):
    """Build the (T, R) emission table.

    Args:
      n_methylated: (T, S) methylated read counts (float or int).
      n_total: (T, S) total read counts.
      alpha, beta: (R,) Beta shape parameters per regime.
      dtype: compute dtype; default float32. Pass float64 on CPU for
        bit-level parity comparisons against the reference's double engine.

    Sites with zero total reads contribute log BB(0; 0, a, b) = 0, matching
    the reference's behaviour on imputed all-missing sites
    (preprocess_bed.py:398-402 imputes 0 reads; BB(0;0) has mass 1).
    """
    dtype = dtype or jnp.float32
    y = jnp.asarray(n_methylated, dtype)[:, :, None]  # (T, S, 1)
    n = jnp.asarray(n_total, dtype)[:, :, None]
    a = jnp.asarray(alpha, dtype)[None, None, :]  # (1, 1, R)
    b = jnp.asarray(beta, dtype)[None, None, :]
    return jnp.sum(beta_binomial_log_pmf(y, n, a, b), axis=1)  # (T, R)


# Fused one-dispatch table build: the eager jnp chain above costs ~10
# separate device dispatches per table when called outside a jit — host
# overhead when the INFER stage builds 2 tables per work unit. Shape changes
# re-specialise via jit's own cache; `dtype` is static.
emission_log_prob_table_fused = jax.jit(
    emission_log_prob_table, static_argnames=("dtype",)
)


def robust_emission_log_prob_table(
    n_methylated, n_total, alpha, beta, beta_div=0.05, dtype=None
):
    """Robust (beta-divergence / Tsallis-score) emission table.

    Replaces the BetaBinomial log-pmf with the reference's robust score
    (robust_beta_binomial.py:29-38, used by case_control_robust_regime_model
    with beta = 0.05 default):

        s(y) = (1/b) f(y)^b  -  1/(b+1) * sum_x f(x)^(b+1)

    summed over samples. The support sum runs over x = 0 .. max(n)-1,
    reproducing the reference's `tf.range(max(total_count))` bound exactly
    (which excludes x = n for the highest-coverage site — a reference quirk
    kept for parity).
    """
    dtype = dtype or jnp.float32
    y = jnp.asarray(n_methylated, dtype)  # (T, S)
    n = jnp.asarray(n_total, dtype)
    a = jnp.asarray(alpha, dtype)
    b = jnp.asarray(beta, dtype)
    bd = jnp.asarray(beta_div, dtype)

    lp_y = beta_binomial_log_pmf(
        y[:, :, None], n[:, :, None], a[None, None, :], b[None, None, :]
    )  # (T, S, R)

    max_n = int(jnp.max(n))
    x = jnp.arange(max(max_n, 1), dtype=dtype)  # 0 .. max(n)-1
    lp_x = beta_binomial_log_pmf(
        x[:, None, None, None],
        n[None, :, :, None],
        a[None, None, None, :],
        b[None, None, None, :],
    )  # (X, T, S, R); -inf where x > n
    from jax.scipy.special import logsumexp as _lse

    integral = jnp.exp(_lse((bd + 1.0) * lp_x, axis=0)) / (bd + 1.0)
    score = jnp.exp(bd * lp_y) / bd - integral  # (T, S, R)
    return jnp.sum(score, axis=1)  # (T, R)


@functools.lru_cache(maxsize=None)
def robust_emission_table_factory(beta_div: float):
    """A STABLE function object per robust_beta value.

    sharded.py keys its module-level program cache on the emission-table
    function's identity; a fresh closure per call would defeat the cache
    (one retrace + compile-cache lookup per INFER call) and grow it
    unboundedly. lru_cache returns the same callable for the same float,
    so robust meshed runs hit the cache."""

    def fn(m, t, alpha, beta):
        return robust_emission_log_prob_table(m, t, alpha, beta, beta_div)

    # The robust table's support sum runs over x = 0..max(n)-1 with a
    # DATA-DEPENDENT bound (int(jnp.max(n))) — it cannot be traced.
    # sharded._tables_program checks this flag and builds the tables eagerly
    # on concrete arrays instead of inside jit/vmap.
    fn.needs_concrete = True
    return fn
