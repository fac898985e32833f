"""End-to-end production pipeline run: `hygeia run` at chromosome scale.

Simulates a chr21-like two-group chromosome (default 400k CpG sites,
2 samples/group; the fixture chip_smoke.py's main-path phase also uses),
writes the preprocessed count files, then runs the FULL orchestrated
pipeline in this process — single-group theta pass, streamed
cross-segment-batched INFER, AGGREGATE, GET_DMPS — on the default JAX
device, and prints per-stage walls plus one end-to-end sites/s JSON line
for a cold pass (compiles included) and a warm pass.

Match: the reference pipeline end-to-end (main.nf:16-95).

Run:  python tools/production_pipeline.py
Knobs: HYGEIA_PROD_T (default 400000), HYGEIA_PROD_CHROMS (1),
       HYGEIA_PROD_SEEDS (2), HYGEIA_PROD_BLOCKS (16384),
       HYGEIA_PROD_DIR (a fresh temporary dir), HYGEIA_PROD_M (50),
       HYGEIA_PROD_B (25),
       HYGEIA_PROD_REALISTIC (1 = chr21-like fixture: island/sea CpG
       spacing, ~55% missingness, overdispersed depth —
       two_group/realistic.py — instead of the uniform synthetic inputs).
"""

import json
import os
import tempfile
import time


def main():
    import jax

    from hygeia_tpu.pipeline.orchestrator import run_two_group
    from hygeia_tpu.runtime import setup_compile_cache
    from hygeia_tpu.two_group.realistic import make_realistic_fixture

    setup_compile_cache()
    T = int(os.environ.get("HYGEIA_PROD_T", 400_000))
    n_chroms = int(os.environ.get("HYGEIA_PROD_CHROMS", 1))
    n_seeds = int(os.environ.get("HYGEIA_PROD_SEEDS", 2))
    blocks = int(os.environ.get("HYGEIA_PROD_BLOCKS", 16384))
    M = int(os.environ.get("HYGEIA_PROD_M", 50))
    B = int(os.environ.get("HYGEIA_PROD_B", 25))
    realistic = int(os.environ.get("HYGEIA_PROD_REALISTIC", 0))
    root = os.environ.get("HYGEIA_PROD_DIR") or tempfile.mkdtemp(
        prefix="hygeia_prod_"
    )
    pre = os.path.join(root, "pre")
    out = os.path.join(root, "out")

    chrom_names = [f"c{21 + i}" for i in range(n_chroms)]
    t0 = time.perf_counter()
    for ci, cname in enumerate(chrom_names):
        if not os.path.exists(os.path.join(pre, f"positions_{cname}.txt.gz")):
            make_realistic_fixture(
                pre, cname, T, n_samples=2, seed=1 + ci,
                uniform=not realistic,
            )
    sim_s = time.perf_counter() - t0
    print(json.dumps({"stage": "simulate+write", "wall_s": round(sim_s, 1)}), flush=True)

    device = jax.devices()[0]
    # Two passes in one process: the first pays compilation, the second is
    # the steady-state production number (what a fleet run amortises to).
    for label in ("cold", "warm"):
        out_l = out + "_" + label
        t0 = time.perf_counter()
        run_two_group(
            output_dir=out_l,
            chroms=chrom_names,
            preprocessed_dir=pre,
            segment_size=100_000,
            buffer_size=5_000,
            inference_seeds=tuple(range(n_seeds)),
            num_resampled_particles=M,
            num_samples_backward=B,
            n_particles_single_group=250,
            streaming_blocks=blocks,
            stream_batched=True,
            resume=True,
        )
        pipe_s = time.perf_counter() - t0

        # Per-stage walls from the run's own trace artifact.
        stages = {}
        with open(os.path.join(out_l, "trace.tsv")) as f:
            next(f)
            for line in f:
                stage, chrom, wall, skipped, attempts, status = line.rstrip(
                    "\n"
                ).split("\t")
                stages[stage] = stages.get(stage, 0.0) + float(wall)
        print(json.dumps({"pass": label, "per_stage_wall_s": stages}), flush=True)
        print(
            json.dumps(
                {
                    "metric": f"pipeline_end_to_end_{label}",
                    "device": device.device_kind,
                    "chroms": n_chroms,
                    "sites": T * n_chroms,
                    "seeds": n_seeds,
                    "wall_s": pipe_s,
                    "sites_per_sec": T * n_chroms / pipe_s,
                    "dir": root,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
