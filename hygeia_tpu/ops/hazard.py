"""Change-point hazard tables rho(d, r) for the shifted negative-binomial
sojourn model, plus their theta-gradients.

The reference memoises these per (regime, sojourn) with on-demand extension
(singleGroup.h:117-150, extendAuxiliaryQuantities :271-335). Here we instead
precompute fixed-size (R, D_max) tables in one vectorised cumsum pass — XLA
fuses the whole construction, and gathers into the table are cheap. Sojourn
times are clamped to D_max at lookup; choose D_max >= segment length for
exactness (sojourns cannot exceed the number of observed sites).

Two guard semantics exist in the reference and both are load-bearing for
output parity (SURVEY.md section 7 "hard parts" #4):

* C++ single-group (singleGroup.h:305-335): once the accumulated mass
  bigH >= 1, the previous entry is clamped to 0.99999, rho becomes 1.0 and an
  "exit status" latches for all larger sojourns.
* TF two-group (case_control_regime_model.py:111-168): rho = 0 where the
  hazard numerator is -inf (d < u), and any non-finite rho is replaced by the
  fixed value 0.1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc, betaln, digamma

from hygeia_tpu.ops.distributions import neg_binomial_log_pmf

_NEG_INF = -jnp.inf

# Matches the hard-coded clamp in singleGroup.h:311.
_BIG_H_CLAMP = 0.99999
# Matches fixed_value_inf in case_control_regime_model.py:131,161.
_FIXED_VALUE_INF = 0.1


def _exclusive_cumsum(x):
    """Exclusive cumulative sum along axis 1 (shift-then-cumsum, avoiding the
    catastrophic cancellation of cumsum(x) - x when 1 - bigH is near ulp)."""
    shifted = jnp.concatenate([jnp.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    return jnp.cumsum(shifted, axis=1)


def _survival_prev(little_h, shifted, kappa, omega, d, u):
    """(1 - bigHprev, exit_status): the survival before each sojourn and the
    C++ exit latch.

    float64 reproduces the reference's double recursion bit-for-bit: an
    exclusive running sum of littleH, latched once it reaches 1. In float32
    that recursion cancels — 1 - bigH keeps few digits once the survival
    falls below ~1e-4 — and its value then depends on the device's summation
    order (a GPU's parallel cumsum and a CPU's sequential one disagree by
    up to 0.25 in rho). So float32 takes the survival in closed form,
    S(k-1) = I_omega(k, kappa) as rho_two_group does, and latches where it
    falls to float32's resolution below 1: where the float32 running sum
    would reach 1."""
    if little_h.dtype == jnp.float64:
        big_h_prev = _exclusive_cumsum(little_h)
        surv = 1.0 - big_h_prev
        at_one = big_h_prev >= 1.0
    else:
        surv = jnp.where(d > u, betainc(jnp.maximum(shifted, 1.0), kappa, omega), 1.0)
        at_one = surv <= jnp.finfo(surv.dtype).epsneg
    exit_status = jnp.cumsum(at_one.astype(jnp.int32), axis=1) > 0
    return surv, exit_status


def _sojourns(d_max, dtype):
    """Sojourn values d = 1..d_max as a vector (index i holds sojourn i+1)."""
    return jnp.arange(1, d_max + 1, dtype=dtype)


def hazard_table(kappa, omega, u, d_max):
    """C++-semantics hazard table.

    Args:
      kappa, omega: (R,) negative-binomial parameters per regime.
      u: static int, minimum distance between change points.
      d_max: static int, table depth (sojourns 1..d_max).

    Returns:
      rho: (R, d_max) array; rho[r, d-1] is the change-point probability when
        the previous state had sojourn d in regime r.
      exit_status: (R, d_max) bool array; latched numerical-overflow flag
        (mirrors ModelParameters::getExitStatus, singleGroup.h:147-150).

    Mirrors extendAuxiliaryQuantities (singleGroup.h:305-320): for 0-based
    index d (sojourn d+1),
      littleH[d] = exp(log NB(d+1-u; kappa, omega))  for d >= u-1 else 0
      bigHprev[d] = sum_{i<d} littleH[i]
      exit[d] = any_{d'<=d} (bigHprev[d'] >= 1)
      rho[d] = 0 (d < u-1) | 1 (exit) | littleH[d] / (1 - bigHprev[d]).
    """
    dtype = jnp.result_type(kappa, omega, jnp.float32)
    d = _sojourns(d_max, dtype)[None, :]  # (1, D) sojourn values
    kappa = kappa[:, None].astype(dtype)
    omega = omega[:, None].astype(dtype)

    shifted = jnp.maximum(d - u, 0.0)
    little_h = jnp.where(
        d >= u, jnp.exp(neg_binomial_log_pmf(shifted, kappa, omega)), 0.0
    )
    surv_prev, exit_status = _survival_prev(little_h, shifted, kappa, omega, d, u)
    rho = jnp.where(
        d < u,
        0.0,
        jnp.where(exit_status, 1.0, little_h / surv_prev),
    )
    return rho, exit_status


def hazard_table_with_grads(kappa, omega, u, d_max, kappa_fixed=True):
    """C++-semantics hazard table plus d(log rho)/dtheta tables.

    Returns a dict with keys:
      rho, exit_status                       — as `hazard_table`
      grad_omega_log_rho: (R, d_max)         — w.r.t. theta_omega = logit(omega)
      grad_kappa_log_rho: (R, d_max) or None — w.r.t. theta_kappa = log(kappa)

    Mirrors singleGroup.h:322-331. Note the gradient accumulators keep
    accumulating past the exit latch (reference behaviour), with the clamped
    denominator 1 - 0.99999. The reference's grad_kappa accumulator reads the
    *omega* accumulator (singleGroup.h:329) — an apparent bug we do not
    reproduce; we use the kappa accumulator (documented deviation, only
    reachable with --is_kappa_fixed=false which is off by default).
    """
    dtype = jnp.result_type(kappa, omega, jnp.float32)
    d = _sojourns(d_max, dtype)[None, :]
    kappa_c = kappa[:, None].astype(dtype)
    omega_c = omega[:, None].astype(dtype)

    shifted = jnp.maximum(d - u, 0.0)
    little_h = jnp.where(
        d >= u, jnp.exp(neg_binomial_log_pmf(shifted, kappa_c, omega_c)), 0.0
    )
    surv_prev, exit_status = _survival_prev(
        little_h, shifted, kappa_c, omega_c, d, u
    )
    rho = jnp.where(
        d < u,
        0.0,
        jnp.where(exit_status, 1.0, little_h / surv_prev),
    )
    # Denominator with the reference's clamp after the exit latch
    # (singleGroup.h:311 sets bigH[d-1] = 0.99999 once exceeded).
    denom = jnp.where(exit_status, 1.0 - _BIG_H_CLAMP, surv_prev)

    # d log h / d theta_omega, theta_omega = logit(omega) (singleGroup.h:322).
    g_om_log_h = jnp.where(
        d >= u,
        (shifted / omega_c - kappa_c / (1.0 - omega_c)) * omega_c * (1.0 - omega_c),
        0.0,
    )
    if dtype == jnp.float64:
        g_om_big_h_prev = _exclusive_cumsum(little_h * g_om_log_h)
    else:
        # The running sum of d littleH / d theta_omega cancels like bigH
        # (see _survival_prev); in closed form it is -dS(k-1)/dtheta_omega
        # = -omega^k (1 - omega)^kappa / B(k, kappa) for k = d - u >= 1.
        k = jnp.maximum(shifted, 1.0)
        g_om_big_h_prev = jnp.where(
            d > u,
            -jnp.exp(
                k * jnp.log(omega_c) + kappa_c * jnp.log1p(-omega_c)
                - betaln(k, kappa_c)
            ),
            0.0,
        )
    grad_omega_log_rho = jnp.where(
        d < u, 0.0, g_om_log_h + g_om_big_h_prev / denom
    )

    grad_kappa_log_rho = None
    if not kappa_fixed:
        # theta_kappa = log(kappa) (singleGroup.h:328).
        g_ka_log_h = jnp.where(
            d >= u,
            kappa_c
            * (digamma(shifted + kappa_c) - digamma(kappa_c) - jnp.log1p(-omega_c)),
            0.0,
        )
        g_ka_big_h_prev = _exclusive_cumsum(little_h * g_ka_log_h)
        grad_kappa_log_rho = jnp.where(
            d < u, 0.0, g_ka_log_h + g_ka_big_h_prev / denom
        )

    return {
        "rho": rho,
        "exit_status": exit_status,
        "grad_omega_log_rho": grad_omega_log_rho,
        "grad_kappa_log_rho": grad_kappa_log_rho,
    }


def rho_two_group(kappa, omega, u, d_max):
    """TF-semantics hazard table for the two-group model.

    rho[r, d-1] = h(d-u) / S(d-u-1) with h the NB pmf and S the survival
    function, with the reference's guards (case_control_regime_model.py:120-138):
      * rho = 0 where d < u (log h = -inf),
      * any non-finite rho replaced by 0.1.
    Note `log_survival(d-u-1)` is forced to 0 when d <= u, so at d == u
    rho = pmf(0) exactly as in the reference.

    The survival function is exact: for X ~ NB(size kappa, success prob
    omega), S(k) = P(X > k) = I_omega(k+1, kappa) (regularised incomplete
    beta), the same identity TFP's NegativeBinomial uses. Where S underflows
    to 0 the ratio becomes non-finite and the 0.1 guard fires — exactly the
    reference's observed behaviour in the deep tail.
    """
    dtype = jnp.result_type(kappa, omega, jnp.float32)
    d = _sojourns(d_max, dtype)[None, :]
    kappa_c = kappa[:, None].astype(dtype)
    omega_c = omega[:, None].astype(dtype)

    shifted = jnp.maximum(d - u, 0.0)
    log_h = jnp.where(
        d >= u, neg_binomial_log_pmf(shifted, kappa_c, omega_c), _NEG_INF
    )
    # log S(k-1) for shifted value k: S(k-1) = I_omega(k, kappa).
    surv_prev = jax.scipy.special.betainc(jnp.maximum(shifted, 1.0), kappa_c, omega_c)
    log_surv_prev = jnp.where(d > u, jnp.log(surv_prev), 0.0)
    rho = jnp.where(log_h == _NEG_INF, 0.0, jnp.exp(log_h - log_surv_prev))
    rho = jnp.where(jnp.isfinite(rho), rho, _FIXED_VALUE_INF)
    return rho


def gather_rho(rho_table, d_prev, r_prev):
    """Look up rho for (sojourn d_prev, regime r_prev), clamping the sojourn
    to the table depth. Entry [r, d-1] holds sojourn d (singleGroup.h:124).

    For large index vectors (the backward pass's (N=2400,) lookups) this
    gathers CONTIGUOUS 128-element rows of the (R*ceil(W/128), 128)-reshaped
    table and picks the entry with a one-hot multiply-reduce — exact (0/1
    products in f32) and independent of the table depth. The layout was
    chosen where per-element gathers lowered to a scalar loop; whether it
    still pays on a GPU is not measured (ROADMAP). Small lookups (the
    filter's (M,)-sized ancestor indices) keep the plain path.
    """
    W = rho_table.shape[1]
    d_idx = jnp.clip(d_prev - 1, 0, W - 1)
    idx_shape = jnp.broadcast_shapes(jnp.shape(d_idx), jnp.shape(r_prev))
    n_elems = 1
    for s in idx_shape:
        n_elems *= int(s)
    if n_elems < 512:
        return rho_table[r_prev, d_idx]

    L = 128
    n_hi = -(-W // L)
    tab = jnp.pad(rho_table, ((0, 0), (0, n_hi * L - W))).reshape(-1, L)
    d_b = jnp.broadcast_to(d_idx, idx_shape).reshape(-1)
    r_b = jnp.broadcast_to(r_prev, idx_shape).reshape(-1)
    hi, lo = d_b // L, d_b % L
    rows = tab[r_b * n_hi + hi]  # (n, L) contiguous row gather
    oh = (lo[:, None] == jnp.arange(L)[None, :]).astype(rho_table.dtype)
    return jnp.sum(rows * oh, axis=-1).reshape(idx_shape)
