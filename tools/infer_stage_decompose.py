"""Decompose the warm INFER[streambatched] stage wall: per-phase walls of
infer_chromosome_streamed on an existing preprocessed fixture, with
streamed_inference's internal timings surfaced.

Run: HYGEIA_DEC_PRE=<dir>/pre HYGEIA_DEC_SG=<dir>/sg PYTHONPATH=. \
     python tools/infer_stage_decompose.py
"""

import json
import os
import tempfile
import time


def main():
    import jax

    from hygeia_tpu.runtime import setup_compile_cache

    setup_compile_cache()

    from hygeia_tpu.two_group import streaming
    from hygeia_tpu.two_group.runner import infer_chromosome_streamed

    pre = os.environ["HYGEIA_DEC_PRE"]
    sg = os.environ["HYGEIA_DEC_SG"]
    chrom = os.environ.get("HYGEIA_DEC_CHROM", "c21")
    out = os.environ.get("HYGEIA_DEC_OUT") or tempfile.mkdtemp(prefix="infer_dec_")

    # Wrap streamed_inference to capture its internal walls.
    real = streaming.streamed_inference
    captured = []

    def wrapped(*a, **k):
        t = {}
        k["timings"] = t
        r = real(*a, **k)
        captured.append(t)
        return r

    streaming.streamed_inference = wrapped

    for label in ("cold", "warm"):
        t0 = time.time()
        infer_chromosome_streamed(
            data_dir=pre,
            single_group_dir=sg,
            results_dir=out + "_" + label,
            chrom=chrom,
            seed=[0, 1],
            segment_size=100_000,
            buffer_size=5_000,
            num_resampled_particles=(50,),
            num_samples_backward=25,
            streaming_blocks=16384,
        )
        wall = time.time() - t0
        phases = {}
        for t in captured:
            for kk, vs in t.items():
                phases[kk] = phases.get(kk, 0.0) + sum(vs)
        captured.clear()
        print(
            json.dumps({"pass": label, "device": jax.devices()[0].device_kind,
                        "stage_wall_s": wall, "device_phases_s": phases}),
            flush=True,
        )


if __name__ == "__main__":
    main()
