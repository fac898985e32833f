#!/usr/bin/env python3
"""GPU smoke check: hygeia's main path, compiled for the card, against the
repo's plain references.

Runs in ONE process (one JAX client owns the card) and exits non-zero at the
first phase that fails. Each phase prints one JSON line with its wall time
and its measured differences beside the tolerances. The card's name and
power limit (nvidia-smi) come first; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases of the default run (one card):

1. device        GPU present; card, JAX version, compile cache.
2. ops           emission and hazard tables against the NumPy f64
                 reference (tools/reference_cpu_baseline.py); the optimal
                 resampler on the GPU against the same program on the CPU.
3. two_group     filter + backward simulation against the reference's
                 per-ancestor NumPy filter (the mean bounds of
                 tests/test_baseline_harness.py; see compare_two_group).
4. single_group  the online SMC engine with parameter estimation, GPU
                 against CPU over 3 seeds.
5. main_path     `hygeia run --two_group` through hygeia_tpu.cli.main on a
                 chr21-scale simulated chromosome (400k sites); every stage
                 ok, DMP files present, posteriors finite and separating
                 the true split sites, pandas never imported.

``--four-gpus`` runs only the meshed path: `hygeia run --mesh 4x1
--boundary exchange` over four cards and the single-card streamed run it is
compared with.

Input data is generated from ``--seed``. ``--rehearse`` runs every phase at
toy sizes on whatever device JAX has (the CPU included) to check the
control flow; it ends with exit code 3 and prints no result line.

Run:  python chip_smoke.py [--seed S] [--four-gpus] [--rehearse]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))

MU = np.array([0.95, 0.05, 0.8, 0.2, 0.5, 0.5])
SIGMA = np.array([0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751])
R = 6

# Full widths (production shapes) and the --rehearse toy widths.
FULL = dict(
    emis_T=4096, res_M=50, res_vectors=8,
    tg_T=2048, tg_M=50, tg_B=25,
    sg_T=8192, sg_N=250,
    sites=400_000, batch=100_000, buffer=5_000, blocks=16384,
    M=50, B=25, n_particles=250,
)
TOY = dict(
    emis_T=256, res_M=10, res_vectors=4,
    tg_T=192, tg_M=20, tg_B=32,
    sg_T=300, sg_N=30,
    sites=4_000, batch=1_000, buffer=50, blocks=512,
    M=6, B=5, n_particles=40,
)
SEEDS = (0, 1, 2)


class PhaseFailed(Exception):
    pass


def _check(metrics, name, value, bound):
    """Record value beside its bound; a value at or past it fails the phase."""
    metrics[name] = {"value": float(value), "bound": float(bound)}
    if not value < bound:
        metrics["ok"] = False


def _check_close(metrics, name, got, want, *, rtol, atol=0.0):
    """np.allclose's rule, |got - want| <= atol + rtol * |want| everywhere,
    recorded as the worst ratio of the error to its allowance (bound 1)."""
    err = np.abs(got - want)
    allowed = atol + rtol * np.abs(want)
    worst = float(np.max(err / np.maximum(allowed, 1e-300)))
    metrics[name] = {
        "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
        "worst_err_over_allowance": {"value": worst, "bound": 1.0},
    }
    if not worst <= 1.0:
        metrics["ok"] = False


# --------------------------------------------------------------- phase 2


def log_p_matrix(rng):
    logits = rng.normal(size=(R, R))
    np.fill_diagonal(logits, -np.inf)
    pm = np.where(np.isfinite(logits), np.exp(logits), 0.0)
    pm /= pm.sum(1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(pm)


def two_group_params(log_p, d_max):
    from hygeia_tpu.two_group.model import make_params

    return make_params(
        mu=MU, sigma=SIGMA, p_softmax_control=log_p,
        omega_logit_control=np.full(R, 2.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0),
        merge_log_prob=np.log(0.1), split_prob=0.01,
        minimum_duration=3, d_max=d_max,
    )


def reference_params(log_p, d_max):
    import reference_cpu_baseline as refb

    lpm = np.log(np.array([[0.9, 0.1], [0.01, 0.99]]))
    omega_eff = 1.0 / (1.0 + np.exp(-2.0))
    rho_c = refb.nb_sojourn_rho(np.full(R, 2.0), np.full(R, omega_eff), 3, d_max)
    rho_k = refb.nb_sojourn_rho(np.full(R, 2.0), np.full(R, 0.8), 3, d_max)
    return refb.Params(R, MU, SIGMA, log_p, lpm, rho_c, rho_k, 3)


def counts(rng, T):
    n = rng.poisson(20, size=(T, 2)).astype(float)
    y = np.minimum(rng.poisson(8, size=(T, 2)), n)
    return y, n


def reference_emissions(p_np, y, n):
    import reference_cpu_baseline as refb

    a, b = p_np.alpha, p_np.beta

    def table(yy):
        return refb.betabin_logpmf(
            yy[:, None, :], n[:, None, :], a[None, :, None], b[None, :, None]
        ).sum(-1)

    return table(y), table(np.minimum(y + 1, n))


# Sojourn lengths at which the hazard tables are held to the f64 reference
# (the harness's range). Past d ~ 130 the f32 survival 1 - H(d-1) cancels
# to a few digits on any device, so the full width is compared with the
# CPU's f32 table instead and reported.
HAZARD_D = 64


def check_tables(seed, T, cpu):
    """Emission tables (both builders the pipeline uses) and hazard tables
    on the default device against the NumPy f64 reference."""
    import jax

    from hygeia_tpu.ops.emissions import (
        emission_log_prob_table,
        emission_log_prob_table_fused,
    )

    rng = np.random.default_rng(seed)
    log_p = log_p_matrix(rng)
    y, n = counts(rng, T)
    params = two_group_params(log_p, T + 2)
    p_np = reference_params(log_p, T + 2)
    e_ref, _ = reference_emissions(p_np, y, n)
    m = {"ok": True}
    for name, fn in (
        ("emission", emission_log_prob_table),
        ("emission_fused", emission_log_prob_table_fused),
    ):
        got = np.asarray(fn(y, n, params.alpha, params.beta), np.float64)
        _check_close(m, name, got, e_ref, rtol=1e-4)
    with jax.default_device(cpu):
        params_cpu = two_group_params(log_p, T + 2)
    # The reference indexes rho by sojourn d; the engine stores d at d-1.
    for name, ref, got, on_cpu in (
        ("hazard_control", p_np.rho_c, params.rho_control, params_cpu.rho_control),
        ("hazard_case", p_np.rho_k, params.rho_case, params_cpu.rho_case),
    ):
        got = np.asarray(got, np.float64)
        _check_close(m, name, got[:, :HAZARD_D], ref[:, 1 : HAZARD_D + 1],
                     rtol=1e-4, atol=1e-9)
        m[name]["full_width_max_abs_diff_vs_cpu_f32"] = float(
            np.max(np.abs(got - np.asarray(on_cpu, np.float64)))
        )
    return m


def check_resampling(seed, M, n_vectors, device, reference_device):
    """optimal_finite_state_resampling at N = M * (2R + R^2) on ``device``
    against the same program on ``reference_device``."""
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.ops.resampling import optimal_finite_state_resampling

    N = M * (2 * R + R * R)
    rng = np.random.default_rng(seed)
    # Continuous log-weights: ties between particles have probability 0.
    lw = rng.normal(scale=3.0, size=(n_vectors, N)).astype(np.float32)
    lw[:, rng.random(N) < 0.2] = -np.inf
    keys = jax.random.split(jax.random.PRNGKey(seed), n_vectors)
    fn = jax.jit(jax.vmap(lambda k, w: optimal_finite_state_resampling(k, w, M)))

    def run(dev):
        out = fn(jax.device_put(keys, dev), jax.device_put(jnp.asarray(lw), dev))
        return jax.tree.map(np.asarray, out)

    a, b = run(device), run(reference_device)
    m = {"ok": True}
    for name in ("top_m_indices", "parent_indices"):
        mismatched = int(np.sum(getattr(a, name) != getattr(b, name)))
        m[f"{name}_mismatches"] = {"value": mismatched, "bound": 0}
        if mismatched:
            m["ok"] = False
    for name in ("log_c", "new_log_weights"):
        x, y = getattr(a, name), getattr(b, name)
        fin = np.isfinite(y)
        if not np.array_equal(fin, np.isfinite(x)) or np.any(x[~fin] != y[~fin]):
            m["ok"] = False
        _check_close(m, name, x[fin], y[fin], rtol=1e-5)
    return m


# --------------------------------------------------------------- phase 3


def _traj_functionals(traj):
    split = (traj[:, :, 0] == 0).mean(axis=1)
    ctrl = np.stack([(traj[:, :, 2] == i).mean(axis=1) for i in range(R)], -1)
    case = np.stack([(traj[:, :, 4] == i).mean(axis=1) for i in range(R)], -1)
    return split, np.concatenate([ctrl, case], axis=-1)


def run_two_group_engine(seed, T, M, B, seeds=SEEDS):
    """Filter + backward simulation for each seed, vmapped in one program on
    the default device. Returns (logZ, split, regime, degenerate) arrays."""
    import jax

    from hygeia_tpu.ops.emissions import emission_log_prob_table
    from hygeia_tpu.two_group.backward import (
        backward_simulation,
        smoothing_functionals,
    )
    from hygeia_tpu.two_group.filter import run_filter

    rng = np.random.default_rng(seed)
    log_p = log_p_matrix(rng)
    y, n = counts(rng, T)
    params = two_group_params(log_p, T + 2)
    E_c = emission_log_prob_table(y, n, params.alpha, params.beta)
    E_k = emission_log_prob_table(np.minimum(y + 1, n), n, params.alpha, params.beta)

    @jax.jit
    def run(keys, bkeys):
        def one(key, bkey):
            res = run_filter(key, params, E_c, E_k, M)
            traj = backward_simulation(bkey, params, res.log_weights, res.particles, B)
            split, regime = smoothing_functionals(traj, R)
            return res.log_normalizing_constant, split, regime, res.degenerate_steps

        return jax.vmap(one)(keys, bkeys)

    keys = jax.numpy.stack([jax.random.PRNGKey(s) for s in seeds])
    bkeys = jax.numpy.stack([jax.random.PRNGKey(1000 + s) for s in seeds])
    return tuple(np.asarray(x) for x in run(keys, bkeys))


def run_two_group_reference(seed, T, M, B, seeds=SEEDS):
    import reference_cpu_baseline as refb

    rng = np.random.default_rng(seed)
    log_p = log_p_matrix(rng)
    y, n = counts(rng, T)
    p_np = reference_params(log_p, T + 2)
    e_c, e_k = reference_emissions(p_np, y, n)
    logz, split, regime = [], [], []
    for s in seeds:
        lz, traj = refb.run_reference_filter(np.random.default_rng(s), p_np, e_c, e_k, M, B)
        sp, rg = _traj_functionals(traj)
        logz.append(lz)
        split.append(sp)
        regime.append(rg)
    return np.array(logz), np.array(split), np.array(regime)


# Share of (site, marginal) entries whose |diff| may reach 0.4. The
# harness's entrywise max (< 0.4) holds at its T=192 but not at T=2048: the
# two mu = 0.5 regimes are nearly exchangeable, so independent 3-seed runs
# can put ~all mass on different ones at a few sites (PERF.md).
GROSS_DIFF, GROSS_SHARE = 0.4, 0.01


def compare_two_group(engine, reference):
    """The harness bounds: mean logZ within 0.5% relative; mean |diff| of the
    split and regime marginals under 0.03; under GROSS_SHARE of the entries
    differing by GROSS_DIFF or more."""
    logz_e, split_e, regime_e = engine[:3]
    logz_r, split_r, regime_r = reference
    m = {"ok": True}
    m_e, m_r = float(np.mean(logz_e)), float(np.mean(logz_r))
    m["logz_engine_mean"], m["logz_reference_mean"] = m_e, m_r
    _check(m, "logz_rel_diff", abs(m_e - m_r) / abs(m_e), 5e-3)
    for name, a, b in (("split", split_e, split_r), ("regime", regime_e, regime_r)):
        d = np.abs(np.mean(a, axis=0) - np.mean(b, axis=0))
        _check(m, f"{name}_mean_abs_diff", d.mean(), 0.03)
        _check(m, f"{name}_share_abs_diff_ge_{GROSS_DIFF}",
               np.mean(d >= GROSS_DIFF), GROSS_SHARE)
        m[f"{name}_max_abs_diff"] = float(d.max())
    return m


# --------------------------------------------------------------- phase 4


def run_single_group(seed, T, N, device, seeds=SEEDS):
    """run_online_combined_inference with parameter estimation for each
    seed (vmapped), on ``device``. A seed keys both the filter and the
    theta initialisation, as `estimate_parameters_and_regimes --rng_seed`
    does (the optimal resampler keeps nearly every particle, so the key
    alone barely moves the result). Returns (logZ (S,), final theta (S, D),
    mean regime probabilities (S, R))."""
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.ops.emissions import emission_log_prob_table
    from hygeia_tpu.single_group.engine import EngineConfig, run_online_combined_inference
    from hygeia_tpu.single_group.model import make_model

    mu = np.array([0.99, 0.01, 0.80, 0.20, 0.50, 0.50])
    sigma = np.array([0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751])
    rng = np.random.default_rng(seed)
    model = make_model(mu, sigma, 2, np.full(R, 2.0), d_max=4096)
    # Piecewise-constant methylation levels with geometric run lengths.
    regimes = np.repeat(rng.integers(0, R, T), rng.geometric(1 / 60, T))[:T]
    n = rng.poisson(20, size=(T, 2)).astype(np.float64)
    y = rng.binomial(n.astype(np.int64), mu[regimes][:, None]).astype(np.float64)
    E = np.asarray(emission_log_prob_table(y, n, model.alpha, model.beta), np.float32)
    cfg = EngineConfig(
        n_particles_max=N, estimate_regimes=True, estimate_parameters=True,
    )
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
    theta0 = np.stack([
        np.asarray(jax.random.normal(jax.random.PRNGKey(s), (model.dim_theta,)))
        for s in seeds
    ]).astype(np.float32)

    @jax.jit
    def run(keys, thetas, E):
        def one(key, theta):
            res = run_online_combined_inference(key, model, theta, E, cfg)
            probs = jnp.where(res.regime_valid[:, None], res.regime_probs, 0.0)
            mean_probs = probs.sum(0) / jnp.maximum(res.regime_valid.sum(), 1)
            return res.log_normalizing_constant, res.final_theta, mean_probs

        return jax.vmap(one)(keys, thetas)

    with jax.default_device(device):
        args = jax.device_put((keys, theta0, E), device)
        return tuple(np.asarray(x, np.float64) for x in run(*args))


def compare_single_group(got, reference, n_seeds=len(SEEDS)):
    """Each element of the seed means of logZ, final theta and mean regime
    probabilities: |mean(got) - mean(ref)| must stay within 3 standard
    errors of the reference seeds' spread, plus 1e-5 absolute."""
    m = {"ok": True}
    for name, a, b in zip(("logz", "final_theta", "mean_regime_probs"), got, reference):
        diff = np.abs(np.mean(a, axis=0) - np.mean(b, axis=0))
        bound = 3.0 * np.std(b, axis=0, ddof=1) / np.sqrt(n_seeds) + 1e-5
        excess = np.max(diff - bound)
        m[f"{name}_max_diff"] = float(np.max(diff))
        m[f"{name}_max_diff_minus_bound"] = {"value": float(excess), "bound": 0.0}
        if not excess <= 0.0:
            m["ok"] = False
    return m


# --------------------------------------------------------------- phase 5


def make_fixture(pre_dir, chrom, n_sites, seed):
    """The chr21-scale two-group fixture: uniform spacing, Poisson(30)
    depth, 2 samples per group, states from the generative model. Returns
    the true merged indicator per site (1 = merged, 0 = split)."""
    from hygeia_tpu.two_group.realistic import make_realistic_fixture

    fx = make_realistic_fixture(
        pre_dir, chrom, n_sites, n_samples=2, seed=seed, uniform=True
    )
    return np.asarray(fx.states[:, 0])


def check_trace(out_dir):
    """Every row of the run's trace.tsv must have status ok: the
    orchestrator ignores a unit that failed its retries and exits 0."""
    with open(Path(out_dir) / "trace.tsv") as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f]
    bad = [r for r in rows if r["status"] != "ok"]
    if not rows or bad:
        raise PhaseFailed(f"trace.tsv rows not ok: {bad or 'no rows'}")
    walls = {}
    for r in rows:
        walls[r["stage"]] = walls.get(r["stage"], 0.0) + float(r["wall_s"])
    return walls


def check_dmps(out_dir, chrom, thresholds=(0.01, 0.05)):
    """The GET_DMPS outputs exist and carry the reference's header."""
    header = (
        ["chrom", "position", "null_stats", "false_negative_weight"]
        + [f"Control_METEOR_{i + 1}" for i in range(R)]
        + [f"Case_METEOR_{i + 1}" for i in range(R)]
    )
    n_rows = {}
    for thr in thresholds:
        for prefix in ("dmp", "weighted_dmp"):
            path = Path(out_dir) / "6_GET_DMPS" / chrom / f"{prefix}_{thr}.csv"
            if not path.is_file():
                raise PhaseFailed(f"missing {path}")
            lines = path.read_text().splitlines()
            if not lines or lines[0].split(",") != header:
                raise PhaseFailed(f"malformed header in {path}")
            if any(len(line.split(",")) != len(header) for line in lines[1:]):
                raise PhaseFailed(f"malformed row in {path}")
            n_rows[path.name] = len(lines) - 1
    return n_rows


def split_posterior(out_dir, chrom):
    """(positions, split posterior) from the AGGREGATE stage's table."""
    from hygeia_tpu.utils.io import read_headed_table

    table = read_headed_table(
        Path(out_dir) / "5_AGGREGATE_RESULTS" / chrom / f"split_probs_{chrom}.csv.gz",
        sep="\t",
    )[1]
    return table[:, 0].astype(np.int64), table[:, 1]


def check_posteriors(out_dir, chrom, merged_truth):
    _, split = split_posterior(out_dir, chrom)
    if split.shape != merged_truth.shape:
        raise PhaseFailed(f"split posterior shape {split.shape}, want {merged_truth.shape}")
    if not np.all(np.isfinite(split)):
        raise PhaseFailed("non-finite split posterior")
    at_split = float(split[merged_truth == 0].mean())
    at_merged = float(split[merged_truth == 1].mean())
    if not at_split > at_merged:
        raise PhaseFailed(
            f"mean split posterior at split sites {at_split} not above "
            f"merged sites {at_merged}"
        )
    return {"mean_split_posterior_at_split_sites": at_split,
            "mean_split_posterior_at_merged_sites": at_merged,
            "true_split_share": float(np.mean(merged_truth == 0))}


def run_args(out_dir, pre_dir, chrom, size, streamed=True, extra=()):
    argv = [
        "run", "--two_group", "--output_dir", str(out_dir), "--chroms", chrom,
        "--preprocessed_dir", str(pre_dir), "--num_of_inference_seeds", "2",
        "--num_resampled_particles", str(size["M"]),
        "--num_samples_backward", str(size["B"]),
        "--n_particles", str(size["n_particles"]),
        "--batch_size", str(size["batch"]), "--buffer_size", str(size["buffer"]),
        "--max_retries", "0", "--no_resume",
    ]
    if streamed:
        argv += ["--run_streaming_blocks", str(size["blocks"]), "--run_stream_batched"]
    return argv + list(extra)


def per_seed_split(out_dir, n_particles_backward):
    """{seed: split posterior over the chromosome} from the INFER units'
    merged-state archives, which every INFER path trims to the unit's own
    sites (AGGREGATE's input)."""
    infer = Path(out_dir) / "4_INFER"
    dirs = sorted(infer.glob("chrom_*_*"), key=lambda p: int(p.name.rsplit("_", 1)[1]))
    name = "optimal_backward_particles_merged_state_{}_{}.npz"
    return {
        s: np.concatenate([
            (np.load(d / name.format(n_particles_backward, s))["arr_0"] == 0).mean(axis=1)
            for d in dirs
            if (d / name.format(n_particles_backward, s)).is_file()
        ])
        for s in (0, 1)
    }


# ----------------------------------------------------------------- driver


def _phase(name, fn):
    t0 = time.perf_counter()
    try:
        metrics = fn()
    except PhaseFailed as e:
        metrics = {"ok": False, "error": str(e)}
    metrics = {"phase": name, "wall_s": time.perf_counter() - t0, **metrics}
    metrics.setdefault("ok", True)
    print(json.dumps(metrics), flush=True)
    if not metrics["ok"]:
        raise SystemExit(f"phase {name} failed")
    return metrics


def _peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card meshed path and its single-card comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on any device, to check the control flow; exits 3")
    args = ap.parse_args(argv)

    import jax

    from hygeia_tpu.runtime import card_description, require_gpu, setup_compile_cache

    if args.rehearse:
        device, size = jax.devices()[0], TOY
    else:
        device, size = require_gpu(), FULL
        print(card_description(), flush=True)
    cache_dir = setup_compile_cache()
    n_devices = len(jax.devices())
    cpu = jax.devices("cpu")[0]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    chrom = "c21"
    pre = work / "pre"
    try:
        _phase("device", lambda: {
            "platform": device.platform, "device_kind": device.device_kind,
            "count": n_devices, "jax": jax.__version__, "compile_cache": cache_dir,
        })
        if args.four_gpus:
            if n_devices < 4:
                raise SystemExit(f"--four-gpus needs 4 devices, found {n_devices}")
            merged_truth = make_fixture(pre, chrom, size["sites"], args.seed)
            _phase("four_gpus", lambda: four_gpus(work, pre, chrom, size, merged_truth))
        else:
            default_phases(args.seed, size, device, cpu, work, pre, chrom)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if args.rehearse:
        print("rehearsal complete", flush=True)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind, "count": n_devices,
    }}), flush=True)
    return 0


def default_phases(seed, size, device, cpu, work, pre, chrom):
    def ops():
        m = check_tables(seed, size["emis_T"], cpu)
        m["resampling"] = check_resampling(
            seed, size["res_M"], size["res_vectors"], device, cpu
        )
        m["ok"] = m["ok"] and m["resampling"]["ok"]
        return m

    _phase("ops", ops)

    def two_group():
        shape = (seed, size["tg_T"], size["tg_M"], size["tg_B"])
        engine = run_two_group_engine(*shape)
        m = compare_two_group(engine, run_two_group_reference(*shape))
        m["degenerate_steps"] = engine[3].tolist()
        return m

    _phase("two_group", two_group)

    def single_group():
        shape = (seed, size["sg_T"], size["sg_N"])
        return compare_single_group(
            run_single_group(*shape, device), run_single_group(*shape, cpu)
        )

    _phase("single_group", single_group)

    def main_path():
        from hygeia_tpu.cli import main as hygeia

        t0 = time.perf_counter()
        merged_truth = make_fixture(pre, chrom, size["sites"], seed)
        fixture_s = time.perf_counter() - t0
        out = work / "out"
        t0 = time.perf_counter()
        hygeia(run_args(out, pre, chrom, size))
        m = {
            "sites": size["sites"], "fixture_wall_s": fixture_s,
            "run_wall_s_cold": time.perf_counter() - t0,
            "stage_wall_s_cold": check_trace(out),
            "dmp_rows": check_dmps(out, chrom),
            **check_posteriors(out, chrom, merged_truth),
            "peak_bytes_in_use": _peak_bytes(device),
        }
        if "pandas" in sys.modules:
            raise PhaseFailed("pandas was imported on the main path")
        m["pandas_imported"] = False
        return m

    _phase("main_path", main_path)


def four_gpus(work, pre, chrom, size, merged_truth):
    """`hygeia run --mesh 4x1 --boundary exchange` against the single-card
    streamed run: per seed, the mean |diff| of the two runs' split
    posteriors must stay within 1.5x the single-card run's seed-to-seed
    mean |diff|."""
    from hygeia_tpu.cli import main as hygeia

    walls = {}
    outs = {"mesh_4x1": work / "mesh", "single_card": work / "single"}
    for name, out in outs.items():
        t0 = time.perf_counter()
        if name == "mesh_4x1":
            hygeia(run_args(out, pre, chrom, size, streamed=False,
                            extra=("--mesh", "4x1", "--boundary", "exchange")))
        else:
            hygeia(run_args(out, pre, chrom, size))
        walls[name] = {"run_wall_s_cold": time.perf_counter() - t0,
                       "stage_wall_s_cold": check_trace(out)}
        check_dmps(out, chrom)
        check_posteriors(out, chrom, merged_truth)
    n_backward = size["M"] * (2 * R + R * R)
    mesh = per_seed_split(outs["mesh_4x1"], n_backward)
    single = per_seed_split(outs["single_card"], n_backward)
    seed_to_seed = float(np.mean(np.abs(single[0] - single[1])))
    between = float(np.mean([np.mean(np.abs(mesh[s] - single[s])) for s in (0, 1)]))
    agg = float(np.mean(np.abs(split_posterior(outs["mesh_4x1"], chrom)[1]
                               - split_posterior(outs["single_card"], chrom)[1])))
    m = {"walls": walls, "seed_to_seed_mean_abs_diff": seed_to_seed,
         "aggregated_mean_abs_diff": agg, "ok": True}
    _check(m, "mesh_vs_single_mean_abs_diff_per_seed", between, 1.5 * seed_to_seed)
    return m


if __name__ == "__main__":
    sys.exit(main())
