"""Hazard-table tests against direct NumPy ports of the reference recursions."""

import numpy as np
import pytest
import scipy.stats as st

from hygeia_tpu.ops.hazard import (
    hazard_table,
    hazard_table_with_grads,
    rho_two_group,
    gather_rho,
)

import jax.numpy as jnp


def _little_h(kappa_r, omega_r, u, d_max):
    """littleH values from our own log-pmf (f64), so the oracle recursion and
    the vectorised table consume identical inputs: the test verifies the
    cumsum/exit/gradient *recursion*, not lgamma ulp behaviour (which is
    amplified without bound by the 1/(1-bigH) conditioning near the latch)."""
    from hygeia_tpu.ops.distributions import neg_binomial_log_pmf

    d = np.arange(1, d_max + 1, dtype=np.float64)
    vals = np.where(
        d >= u,
        np.exp(
            np.asarray(
                neg_binomial_log_pmf(
                    jnp.asarray(np.maximum(d - u, 0.0)),
                    jnp.asarray(float(kappa_r)),
                    jnp.asarray(float(omega_r)),
                )
            )
        ),
        0.0,
    )
    return vals


def _cpp_reference_table(kappa, omega, u, d_max):
    """Direct NumPy port of extendAuxiliaryQuantities (singleGroup.h:271-335)."""
    R = len(kappa)
    rho = np.zeros((R, d_max))
    exit_status = np.zeros((R, d_max), dtype=bool)
    g_om = np.zeros((R, d_max))
    for r in range(R):
        little_vals = _little_h(kappa[r], omega[r], u, d_max)
        little = np.zeros(d_max)
        bigH = np.zeros(d_max)
        g_log_h = np.zeros(d_max)
        g_bigH = np.zeros(d_max)
        for d in range(u - 1, d_max):
            # sojourn = d + 1; shifted count = d + 1 - u
            x = d + 1 - u
            little[d] = little_vals[d]
            bigH_prev = bigH[d - 1] if d > 0 else 0.0
            exit_prev = exit_status[r, d - 1] if d > 0 else False
            if exit_prev or bigH_prev >= 1.0:
                bigH_prev_clamped = 0.99999
                rho[r, d] = 1.0
                exit_status[r, d] = True
                bigH[d] = bigH_prev  # untouched in this branch
            else:
                bigH_prev_clamped = bigH_prev
                bigH[d] = bigH_prev + little[d]
                rho[r, d] = little[d] / (1.0 - bigH_prev)
                exit_status[r, d] = False
            g_log_h[d] = (x / omega[r] - kappa[r] / (1 - omega[r])) * omega[r] * (
                1 - omega[r]
            )
            g_bigH_prev = g_bigH[d - 1] if d > 0 else 0.0
            g_bigH[d] = g_bigH_prev + little[d] * g_log_h[d]
            g_om[r, d] = g_log_h[d] + g_bigH_prev / (1.0 - bigH_prev_clamped)
    return rho, exit_status, g_om


def _well_conditioned_mask(kappa, omega, u, d_max, tol=1e-9):
    """Mask of table entries where 1 - bigH_prev > tol: outside it, rho is
    dominated by f64 summation-order noise in the reference itself (the
    division by 1 - bigH amplifies rounding without bound), and those
    sojourns carry ~tol prior mass — posterior-irrelevant by construction."""
    mask = np.zeros((len(kappa), d_max), dtype=bool)
    for r in range(len(kappa)):
        little = _little_h(kappa[r], omega[r], u, d_max)
        big_prev = np.concatenate([[0.0], np.cumsum(little)[:-1]])
        mask[r] = (1.0 - big_prev) > tol
    return mask


def test_hazard_table_matches_cpp_port():
    kappa = np.array([2.0, 2.0, 2.0])
    omega = np.array([0.95, 0.5, 0.1])
    u, d_max = 3, 200
    rho, exit_status = hazard_table(jnp.asarray(kappa), jnp.asarray(omega), u, d_max)
    ref_rho, ref_exit, _ = _cpp_reference_table(kappa, omega, u, d_max)
    mask = _well_conditioned_mask(kappa, omega, u, d_max)
    np.testing.assert_allclose(
        np.asarray(rho)[mask], ref_rho[mask], rtol=1e-7, atol=1e-12
    )
    np.testing.assert_array_equal(np.asarray(exit_status)[mask], ref_exit[mask])


def test_hazard_grads_match_cpp_port():
    kappa = np.array([2.0, 2.0])
    omega = np.array([0.9, 0.3])
    u, d_max = 2, 150
    out = hazard_table_with_grads(jnp.asarray(kappa), jnp.asarray(omega), u, d_max)
    ref_rho, _, ref_g = _cpp_reference_table(kappa, omega, u, d_max)
    mask = _well_conditioned_mask(kappa, omega, u, d_max)
    np.testing.assert_allclose(np.asarray(out["rho"])[mask], ref_rho[mask], rtol=1e-7)
    np.testing.assert_allclose(
        np.asarray(out["grad_omega_log_rho"])[mask], ref_g[mask], rtol=1e-4, atol=1e-9
    )


def test_grad_omega_log_rho_vs_finite_difference():
    """The analytic gradient must match d log rho / d logit(omega)."""
    kappa = np.array([2.0])
    u, d_max = 3, 50
    theta = 1.2  # logit(omega)
    eps = 1e-6

    def rho_at(th):
        om = 1 / (1 + np.exp(-th))
        r, _ = hazard_table(jnp.asarray(kappa), jnp.asarray([om]), u, d_max)
        return np.asarray(r)[0]

    out = hazard_table_with_grads(
        jnp.asarray(kappa), jnp.asarray([1 / (1 + np.exp(-theta))]), u, d_max
    )
    g = np.asarray(out["grad_omega_log_rho"])[0]
    fd = (np.log(rho_at(theta + eps)) - np.log(rho_at(theta - eps))) / (2 * eps)
    # Only where rho > 0 (d >= u) and not in the exit regime.
    mask = ~np.asarray(out["exit_status"])[0] & (np.arange(1, d_max + 1) >= u)
    np.testing.assert_allclose(g[mask], fd[mask], rtol=1e-4, atol=1e-6)


def test_rho_two_group_matches_tf_semantics():
    """Check against a direct scipy port of next_duration_*_rho
    (case_control_regime_model.py:111-138)."""
    kappa = np.array([2.0, 2.0])
    omega = np.array([0.8, 0.95])
    u, d_max = 3, 300
    table = np.asarray(rho_two_group(jnp.asarray(kappa), jnp.asarray(omega), u, d_max))
    for r in range(2):
        for d in range(1, d_max + 1):
            if d < u:
                expected = 0.0
            else:
                log_h = st.nbinom.logpmf(d - u, kappa[r], 1 - omega[r])
                if d > u:
                    log_s = st.nbinom.logsf(d - u - 1, kappa[r], 1 - omega[r])
                else:
                    log_s = 0.0
                expected = np.exp(log_h - log_s)
                if not np.isfinite(expected):
                    expected = 0.1
            np.testing.assert_allclose(
                table[r, d - 1], expected, rtol=1e-5, atol=1e-9,
                err_msg=f"r={r} d={d}",
            )


def test_gather_rho_clamps():
    kappa = jnp.asarray([2.0])
    omega = jnp.asarray([0.9])
    rho, _ = hazard_table(kappa, omega, 3, 20)
    v_in = gather_rho(rho, jnp.asarray([5]), jnp.asarray([0]))
    np.testing.assert_allclose(float(v_in[0]), float(rho[0, 4]))
    v_clamped = gather_rho(rho, jnp.asarray([100]), jnp.asarray([0]))
    np.testing.assert_allclose(float(v_clamped[0]), float(rho[0, 19]))


@pytest.mark.parametrize(
    "table, rtol", [("rho", 1e-3), ("grad_omega_log_rho", 1e-2)]
)
def test_float32_table_tracks_float64_recursion(table, rtol):
    """float32 takes the survival in closed form instead of 1 - running sum,
    which cancels below S ~ 1e-4 and depends on the device's summation
    order: it stays within float32 precision of the float64 recursion down
    to S = 1e-6, where the running-sum form is off by orders of magnitude."""
    kappa = np.full(4, 2.0)
    omega = np.array([0.2, 0.5, 0.9, 0.97])
    u, d_max = 3, 600
    ref = hazard_table_with_grads(jnp.asarray(kappa), jnp.asarray(omega), u, d_max)
    got = hazard_table_with_grads(
        jnp.asarray(kappa, jnp.float32), jnp.asarray(omega, jnp.float32), u, d_max
    )
    mask = _well_conditioned_mask(kappa, omega, u, d_max, tol=1e-6)
    np.testing.assert_allclose(
        np.asarray(got[table], np.float64)[mask], np.asarray(ref[table])[mask],
        rtol=rtol, atol=1e-6,
    )
    rho32, exit32 = hazard_table(
        jnp.asarray(kappa, jnp.float32), jnp.asarray(omega, jnp.float32), u, d_max
    )
    np.testing.assert_array_equal(np.asarray(rho32), np.asarray(got["rho"]))
    assert not np.asarray(exit32)[mask].any()
