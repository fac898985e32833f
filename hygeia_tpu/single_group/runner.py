"""The `estimate_parameters_and_regimes` and `simulate_data` verbs.

Replaces the Rscript CLIs (bin/estimate_parameters_and_regimes,
bin/simulate_data) with the same flags and CSV formats, driving the JAX
engine instead of the Rcpp one."""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from hygeia_tpu.ops.emissions import emission_log_prob_table
from hygeia_tpu.single_group.model import (
    make_model,
    parameters_to_theta,
    theta_to_parameters,
)
from hygeia_tpu.single_group.engine import EngineConfig, run_online_combined_inference
from hygeia_tpu.single_group import simulate as sg_simulate
from hygeia_tpu.utils import io as hio

DEFAULT_MU = (0.99, 0.01, 0.80, 0.20, 0.50, 0.50)
DEFAULT_SIGMA = (0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751)
DEFAULT_OMEGA = (0.995, 0.975, 0.950, 0.925, 0.900, 0.900)


def default_p(n_regimes):
    """Uniform off-diagonal initial transition matrix
    (bin/estimate_parameters_and_regimes:241-248)."""
    p = np.full((n_regimes, n_regimes), 1.0 / (n_regimes - 1))
    np.fill_diagonal(p, 0.0)
    return p


def estimate_parameters_and_regimes(
    *,
    n_methylated_reads_csv_file,
    genomic_positions_csv_file,
    n_total_reads_csv_file,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    u=2,
    kappa=(2.0,) * 6,
    omega=DEFAULT_OMEGA,
    p=None,
    is_kappa_fixed=True,
    n_particles=250,
    estimate_regime_probabilities=False,
    estimate_parameters=False,
    epsilon=0.01,
    normalise_gradients=False,
    use_adam=True,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    rng_seed=0,
    regime_probabilities_csv_file=None,
    theta_trace_csv_file=None,
    p_csv_file="p.csv",
    omega_csv_file="omega.csv",
    kappa_csv_file="kappa.csv",
    theta_file="theta.csv",
    smoothing_window=128,
    weight_dtype=jnp.float32,
    progress_every=0,
):
    """Mirror of bin/estimate_parameters_and_regimes:264-379."""
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    kappa = np.asarray(kappa, np.float64)
    model = make_model(mu, sigma, u, kappa, kappa_fixed=is_kappa_fixed, d_max=4096)

    positions = hio.read_headed_column(genomic_positions_csv_file).astype(np.int64)
    n_total = hio.read_headed_matrix(n_total_reads_csv_file).astype(np.float64)
    n_meth = hio.read_headed_matrix(n_methylated_reads_csv_file).astype(np.float64)
    # Engine expects (T, S); headed matrices come back (n_samples, n_sites).
    n_total, n_meth = n_total.T, n_meth.T
    T = n_total.shape[0]

    if estimate_parameters:
        # theta ~ N(0, I) prior (sampleFromParameterPriorCpp, singleGroup.cpp:18-35).
        theta_init = np.asarray(
            jax.random.normal(jax.random.PRNGKey(rng_seed), (model.dim_theta,))
        )
    else:
        p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
        theta_init = parameters_to_theta(
            p_mat, np.asarray(omega), kappa, kappa_fixed=is_kappa_fixed
        )

    E = emission_log_prob_table(n_meth, n_total, model.alpha, model.beta)
    cfg = EngineConfig(
        n_particles_max=n_particles,
        epsilon=epsilon,
        smoothing_window=smoothing_window,
        estimate_regimes=estimate_regime_probabilities,
        estimate_parameters=estimate_parameters,
        steps_per_update=n_steps_without_parameter_update,
        learning_rate_exponent=learning_rate_exponent,
        learning_rate_factor=learning_rate_factor,
        use_adam=use_adam,
        normalise_gradients=normalise_gradients,
        progress_every=progress_every,
    )
    run = jax.jit(
        lambda key, E: run_online_combined_inference(
            key, model, jnp.asarray(theta_init, weight_dtype), E, cfg,
            weight_dtype=weight_dtype,
        )
    )
    res = run(jax.random.PRNGKey(rng_seed), E)

    if estimate_regime_probabilities and regime_probabilities_csv_file:
        probs = np.asarray(res.regime_probs)
        hio.write_csv(
            regime_probabilities_csv_file,
            [positions[:T], *probs.T],
            header=["genomic_position"] + [f"regime_{i + 1}" for i in range(R)],
        )

    if estimate_parameters:
        trace = np.asarray(res.theta_trace)
        if theta_trace_csv_file:
            hio.write_csv(
                theta_trace_csv_file, list(trace.T),
                header=[f"theta_{i + 1}" for i in range(trace.shape[1])],
            )
        final = theta_to_parameters(trace[-1], R, kappa_fixed=is_kappa_fixed)
        hio.write_csv(
            _ensure(p_csv_file), list(np.asarray(final["p"]).T),
            header=[f"regime_{i + 1}" for i in range(R)],
        )
        hio.write_headed_column(omega_csv_file, final["omega"], "omega")
        hio.write_headed_column(
            kappa_csv_file, final.get("kappa", kappa), "kappa"
        )
        hio.write_theta(theta_file, trace[-1])
    return res


def _ensure(path):
    hio._ensure_dir(path)
    return path


def simulate_data(
    *,
    regimes_csv_file,
    n_methylated_reads_csv_file,
    genomic_positions_csv_file,
    n_total_reads_csv_file,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    p=None,
    omega=DEFAULT_OMEGA,
    kappa=(2.0,) * 6,
    u=2,
    n_samples=2,
    n_cpg_sites=1000,
    lambda_reads=20.0,
    rng_seed=0,
):
    """Mirror of bin/simulate_data + model_functions.R:116-195."""
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    model = make_model(mu, sigma, u, np.asarray(kappa), d_max=4096)
    p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
    theta = parameters_to_theta(p_mat, np.asarray(omega), np.asarray(kappa))

    rng = np.random.default_rng(rng_seed)
    n_total = rng.poisson(lambda_reads, size=(n_cpg_sites, n_samples)).astype(np.float64)
    sim = sg_simulate.simulate(
        jax.random.PRNGKey(rng_seed), model, theta, n_total
    )
    positions = np.arange(1, n_cpg_sites + 1)

    hio.write_headed_column(regimes_csv_file, np.asarray(sim.r), "regime")
    hio.write_headed_column(
        genomic_positions_csv_file, positions, "genomic_positions"
    )
    hio.write_headed_matrix(n_total_reads_csv_file, n_total.T, "sample")
    hio.write_headed_matrix(
        n_methylated_reads_csv_file, np.asarray(sim.n_methylated).T, "sample"
    )
    return sim


def approximate_log_normalizing_constant(
    *,
    n_replicates,
    n_methylated_reads,
    n_total_reads,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    u=2,
    kappa=(2.0,) * 6,
    omega=DEFAULT_OMEGA,
    p=None,
    n_particles=250,
    rng_seed=0,
    weight_dtype=jnp.float32,
):
    """Independent replicate estimates of the log-normalising constant.

    Replaces approximateLogNormalisingConstantCpp (singleGroup.cpp:195-279);
    replicates are vmapped over RNG keys in one device call instead of a
    sequential host loop.
    """
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    model = make_model(mu, sigma, u, np.asarray(kappa), d_max=4096)
    p_mat = default_p(R) if p is None else np.asarray(p, np.float64)
    theta = parameters_to_theta(p_mat, np.asarray(omega), np.asarray(kappa))
    E = emission_log_prob_table(
        np.asarray(n_methylated_reads), np.asarray(n_total_reads),
        model.alpha, model.beta,
    )
    cfg = EngineConfig(
        n_particles_max=n_particles,
        estimate_regimes=False,
        estimate_parameters=False,
    )
    keys = jax.random.split(jax.random.PRNGKey(rng_seed), n_replicates)
    run = jax.jit(
        jax.vmap(
            lambda key: run_online_combined_inference(
                key, model, jnp.asarray(theta, weight_dtype), E, cfg,
                weight_dtype=weight_dtype,
            ).log_normalizing_constant
        )
    )
    return np.asarray(run(keys))
