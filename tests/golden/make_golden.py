"""Regenerate the golden pipeline outputs under tests/golden/expected/.

Run from the repo root:  python tests/golden/make_golden.py

Why these goldens exist (SURVEY.md §4 "golden tests vs reference containers"):
the reference's own TF-2.3 binary cannot run in this environment (no pip
installs), so reference-produced golden files are unobtainable here. These
goldens are instead produced ONCE by this repo's deterministic CPU float64
path and checked in; tests/test_golden.py re-runs infer + aggregate +
get_dmps on the same fixture and compares every output file. That freezes
the full numeric behaviour of the pipeline — any refactor that changes an
output (weight algebra, windowing, aggregation layout, FDR math) fails the
test and must justify regenerating this directory. Behavioural parity with
the reference itself is established separately by the oracle suites
(exact-enumeration filter tests, SciPy density tests, the reference-ported
preprocess oracle, and tests/test_baseline_harness.py's independent
implementation agreement).
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# Match the test environment (tests/conftest.py): true float64 weights.
jax.config.update("jax_enable_x64", True)

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

GOLDEN = Path(__file__).resolve().parent
R = 6
MU = [0.95, 0.05, 0.80, 0.20, 0.50, 0.50]
SIGMA = [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]
T, SEG, BUF, M, B = 150, 90, 20, 6, 10
CHROM = "g"


def build_fixture(data_dir, sg_dir):
    """Deterministic inputs: simulated counts + a single-group theta file."""
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.ops.distributions import logit
    from hygeia_tpu.single_group.model import parameters_to_theta
    from hygeia_tpu.two_group.model import make_params
    from hygeia_tpu.two_group.simulate import simulate
    from hygeia_tpu.utils import io as hio

    rng = np.random.default_rng(42)
    P = rng.dirichlet(np.ones(R - 1), size=R)
    Pfull = np.zeros((R, R))
    for r in range(R):
        Pfull[r, [c for c in range(R) if c != r]] = P[r]
    omega = np.full(R, 0.9)
    theta = parameters_to_theta(Pfull, omega)
    data_dir.mkdir(parents=True, exist_ok=True)
    sg_dir.mkdir(parents=True, exist_ok=True)
    hio.write_theta(sg_dir / f"theta_{CHROM}.csv.gz", theta)

    with np.errstate(divide="ignore"):
        log_p = np.log(Pfull)
    params = make_params(
        mu=MU, sigma=SIGMA, p_softmax_control=log_p,
        omega_logit_control=np.asarray(logit(jnp.asarray(omega))),
        omega_case=0.8, kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=256, dtype=jnp.float64,
    )
    n_c = rng.poisson(30, size=(T, 2)).astype(np.float64)
    n_k = rng.poisson(30, size=(T, 2)).astype(np.float64)
    sim = simulate(jax.random.PRNGKey(7), params, n_c, n_k)
    hio.write_count_matrix(data_dir / f"positions_{CHROM}.txt.gz", np.arange(1, T + 1) * 13)
    hio.write_count_matrix(data_dir / f"n_total_reads_control_{CHROM}.txt.gz", n_c)
    hio.write_count_matrix(data_dir / f"n_total_reads_case_{CHROM}.txt.gz", n_k)
    hio.write_count_matrix(
        data_dir / f"n_methylated_reads_control_{CHROM}.txt.gz", np.asarray(sim.obs_control)
    )
    hio.write_count_matrix(
        data_dir / f"n_methylated_reads_case_{CHROM}.txt.gz", np.asarray(sim.obs_case)
    )


def run_pipeline(data_dir, sg_dir, out_root):
    """infer (2 batches x 2 seeds, f64 weights) + aggregate + get_dmps."""
    import jax.numpy as jnp

    from hygeia_tpu.pipeline.aggregate import aggregate_chromosome
    from hygeia_tpu.pipeline.dmps import call_dmps
    from hygeia_tpu.two_group.runner import infer_segment

    results = out_root / "4_INFER"
    N = M * (2 * R + R * R)
    for batch in range(2):
        infer_segment(
            data_dir=str(data_dir),
            single_group_dir=str(sg_dir),
            results_dir=str(results),
            chrom=CHROM,
            batch=batch,
            seed=[0, 1],
            segment_size=SEG,
            buffer_size=BUF,
            mu=MU,
            sigma=SIGMA,
            minimum_duration=3,
            num_resampled_particles=(M,),
            num_samples_backward=B,
            weight_dtype=jnp.float64,
        )
    agg = out_root / "5_AGGREGATE"
    aggregate_chromosome(
        str(results), str(agg), CHROM, seeds=2, num_particles=N, num_batches=4
    )
    dmp = out_root / "6_DMPS"
    call_dmps(str(agg), str(dmp), CHROM, n_regimes=R)
    return results, agg, dmp


if __name__ == "__main__":
    import shutil

    expected = GOLDEN / "expected"
    if expected.exists():
        shutil.rmtree(expected)
    fix = GOLDEN / "fixture"
    if fix.exists():
        shutil.rmtree(fix)
    build_fixture(fix / "data", fix / "single_group")
    run_pipeline(fix / "data", fix / "single_group", expected)
    # Timing files are machine-dependent — not golden.
    for p in expected.rglob("optimal_time*"):
        p.unlink()
    n_files = sum(1 for _ in expected.rglob("*") if _.is_file())
    print(f"golden outputs written: {n_files} files under {expected}")
