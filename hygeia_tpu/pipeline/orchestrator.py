"""Pipeline orchestrator: the `hygeia run` verb.

Replaces the Nextflow DSL2 workflow (main.nf:16-95): a DAG of the six
two-group stages (or four single-group stages) over (chromosome x segment x
seed) work units, executed in ONE process so the accelerator is acquired
once. Stage completion is recorded with on-disk markers (the `-resume`
work-dir caching analog, run.sh:7,13); a re-run skips completed stages.

Output tree mirrors the reference's publishDir layout:
  1_PREPROCESS/ 2_ESTIMATE_PARAMETERS_AND_REGIMES/ 3_GET_CHROM_SEGMENTS/
  4_INFER/ 5_AGGREGATE_RESULTS/ 6_GET_DMPS/   (modules/*/[1-6]_*.nf)
"""

from __future__ import annotations

import json
import os
import platform
import time
from pathlib import Path

import numpy as np

from hygeia_tpu import __version__ as _VERSION


class StageTrace:
    """Per-stage wall-clock trace — the analog of Nextflow's
    timeline/report/trace artifacts (nextflow.config:36-51). Written as a
    TSV (`trace.tsv`) plus `versions.yml` per run directory (the
    versions-emission convention of every reference module, e.g.
    modules/two_group/4_infer.nf:54-57)."""

    def __init__(self, output_dir):
        self.path = Path(output_dir)
        self.rows = []
        self.t0 = time.time()

    def record(self, stage, chrom, seconds, skipped=False, attempts=1, status="ok"):
        self.rows.append(
            (stage, str(chrom), round(seconds, 3), skipped, attempts, status)
        )

    def flush(self):
        self.path.mkdir(parents=True, exist_ok=True)
        with open(self.path / "trace.tsv", "w") as f:
            f.write("stage\tchrom\twall_s\tskipped\tattempts\tstatus\n")
            for r in self.rows:
                f.write("\t".join(str(x) for x in r) + "\n")
        self._write_timeline()
        self._write_report()
        self._write_dag()
        with open(self.path / "versions.yml", "w") as f:
            f.write(
                f'hygeia_tpu: "{_VERSION}"\npython: "{platform.python_version()}"\n'
            )
        try:
            import jax

            with open(self.path / "versions.yml", "a") as f:
                f.write(f'jax: "{jax.__version__}"\n')
        except Exception:
            pass

    # Nextflow emits timeline/report/dag HTML artifacts per run
    # (nextflow.config:36-51, `-with-report -with-dag`); these are the
    # single-process analogs built from the recorded stage rows.

    def _write_timeline(self):
        total = max(sum(r[2] for r in self.rows), 1e-9)
        bars, acc = [], 0.0
        for stage, chrom, wall, skipped, attempts, status in self.rows:
            left, width = 100.0 * acc / total, max(100.0 * wall / total, 0.3)
            acc += wall
            colour = (
                "#bbb" if skipped else
                "#d9534f" if str(status).startswith("ignored") else "#5b8def"
            )
            label = f"{stage} [{chrom}] {wall:.2f}s" + (
                f" x{attempts}" if attempts > 1 else ""
            )
            bars.append(
                f'<div class="row"><div class="bar" style="margin-left:{left:.2f}%;'
                f'width:{width:.2f}%;background:{colour}"></div>'
                f"<span>{label}</span></div>"
            )
        html = (
            "<!doctype html><meta charset='utf-8'><title>hygeia timeline</title>"
            "<style>body{font:12px sans-serif;margin:20px}.row{display:flex;"
            "align-items:center;margin:2px 0}.bar{height:12px;border-radius:2px;"
            "flex:none}span{margin-left:6px;white-space:nowrap}</style>"
            f"<h2>hygeia_tpu run timeline — {total:.1f}s total</h2>"
            + "".join(bars)
        )
        (self.path / "timeline.html").write_text(html)

    def _write_report(self):
        rows = "".join(
            f"<tr><td>{s}</td><td>{c}</td><td>{w:.3f}</td><td>{sk}</td>"
            f"<td>{a}</td><td>{st}</td></tr>"
            for s, c, w, sk, a, st in self.rows
        )
        n_ignored = sum(1 for r in self.rows if str(r[5]).startswith("ignored"))
        html = (
            "<!doctype html><meta charset='utf-8'><title>hygeia report</title>"
            "<style>body{font:13px sans-serif;margin:20px}table{border-collapse:"
            "collapse}td,th{border:1px solid #ccc;padding:3px 8px}</style>"
            f"<h2>hygeia_tpu run report</h2><p>{len(self.rows)} stage executions, "
            f"{n_ignored} ignored after retries, total "
            f"{sum(r[2] for r in self.rows):.1f}s</p>"
            "<table><tr><th>stage</th><th>unit</th><th>wall_s</th>"
            "<th>skipped</th><th>attempts</th><th>status</th></tr>"
            + rows + "</table>"
        )
        (self.path / "report.html").write_text(html)

    def _write_dag(self):
        stages = []
        for s, *_ in self.rows:
            base = s.split("[")[0]
            if base not in stages:
                stages.append(base)
        edges = "".join(
            f'  "{a}" -> "{b}";\n' for a, b in zip(stages, stages[1:])
        )
        (self.path / "dag.dot").write_text(
            "digraph hygeia {\n  rankdir=LR;\n  node [shape=box,"
            " style=rounded];\n" + edges + "}\n"
        )


def _log_prewarm_failure(err):
    """A failed prewarm job only forfeits its overlap, but is never silent."""
    import sys

    print(f"prewarm job failed: {err!r}", file=sys.stderr, flush=True)


class StageFailed(RuntimeError):
    """A pipeline stage failed after exhausting its retries and the error
    strategy was `terminate` (the commented-out alternative in
    nextflow.config:25)."""


def _attempt(
    fn,
    *,
    trace: "StageTrace",
    stage,
    chrom,
    max_retries=5,
    ignore=True,
    logger=None,
):
    """Run one pipeline work unit under the reference's error strategy:
    retry up to ``max_retries`` times, then ``ignore`` (nextflow.config:23-27:
    ``errorStrategy = { task.attempt <= maxRetries ? 'retry' : 'ignore' }``).

    Each attempt is passed its 1-based attempt number — the analog of
    Nextflow's escalating ``task.attempt`` resources
    (modules/two_group/4_infer.nf:10) so callers can grow memory-shaped knobs
    (e.g. halve the vmapped seed chunk) per attempt.

    Returns True if the unit succeeded, False if it was ignored after all
    retries. Raises StageFailed instead when ignore=False.
    """
    t0 = time.time()
    last_err = None
    for attempt in range(1, max_retries + 2):  # first try + max_retries
        try:
            fn(attempt)
            trace.record(stage, chrom, time.time() - t0, attempts=attempt)
            return True
        except Exception as e:  # noqa: BLE001 — task isolation, like Nextflow
            last_err = e
            if logger:
                logger(f"{stage}[{chrom}] attempt {attempt} failed: {e!r}")
    trace.record(
        stage,
        chrom,
        time.time() - t0,
        attempts=max_retries + 1,
        status=f"ignored: {type(last_err).__name__}",
    )
    if not ignore:
        raise StageFailed(f"{stage}[{chrom}] failed after retries") from last_err
    return False


# (WorkdirMirror, output root) of the run in progress, or None. Set by the
# pipeline entry points when `bucket_dir` is given; _finish mirrors the tree
# after every completed stage so `-bucket-dir`-style resume works across
# machines (run.sh:6, aws.config:1-12). Module-level (not threaded through
# the ~20 _stage/_finish call sites) because one process orchestrates one
# run at a time; each entry point resets it.
_ACTIVE_MIRROR = None


def _set_mirror(bucket_dir, out, resume, trace=None):
    global _ACTIVE_MIRROR
    if not bucket_dir:
        _ACTIVE_MIRROR = None
        return
    from hygeia_tpu.utils.staging import WorkdirMirror

    mirror = WorkdirMirror(bucket_dir)
    if resume:
        fetched = mirror.restore(out)
        if fetched and trace is not None:
            trace.record("BUCKET_RESTORE", "-", 0.0, status=f"{fetched} files")
    _ACTIVE_MIRROR = (mirror, Path(out))


def _marker(path: Path) -> Path:
    return path / ".done"


def _stage(path: Path, resume: bool):
    """Returns True if the stage should run (and ensures the directory)."""
    path.mkdir(parents=True, exist_ok=True)
    if resume and _marker(path).exists():
        return False
    return True


def _finish(path: Path, meta=None):
    _marker(path).write_text(json.dumps(meta or {"t": time.time()}))
    if _ACTIVE_MIRROR is not None:
        mirror, root = _ACTIVE_MIRROR
        try:
            Path(path).resolve().relative_to(root.resolve())
        except ValueError:
            return  # marker outside the mirrored run (stale global)
        mirror.sync_up(root)


def run_two_group(
    *,
    output_dir,
    chroms,
    cpg_file_path=None,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
    preprocessed_dir=None,
    mu=(0.95, 0.05, 0.80, 0.20, 0.50, 0.50),
    sigma=(0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751),
    u=3,
    segment_size=100000,
    buffer_size=5000,
    inference_seeds=(0, 1),
    num_resampled_particles=50,
    num_samples_backward=25,
    n_particles_single_group=250,
    epsilon=0.01,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    fdr_thresholds=(0.01, 0.05),
    resume=True,
    rng_seed=0,
    stub_run=False,
    max_retries=5,
    mesh_shape=None,
    boundary="halo",
    streaming_blocks=None,
    stream_batched=False,
    bucket_dir=None,
):
    """Full two-group pipeline for a list of chromosomes.

    Either provide BED inputs (cpg_file_path + *_data_paths) or a
    `preprocessed_dir` that already holds the per-chromosome count files.

    stub_run=True wires the DAG without computation (the Nextflow
    `-stub-run` analog: every module has a stub block emitting empty
    outputs, e.g. modules/two_group/4_infer.nf:60-71).

    mesh_shape=(n_genome, n_seed): run the INFER stage on a device mesh —
    all (batch x seed) work units of a chromosome in ONE pjit'd program
    (parallel/sharded.py) instead of the sequential per-batch loop. This is
    the device-mesh form of the reference's Nextflow task fan-out
    (main.nf:44-75). `boundary` selects halo (reference-like buffered
    windows) or exchange (exact ppermute boundary messages). Downstream
    stages (AGGREGATE_RESULTS, GET_DMPS) are untouched: the meshed INFER
    writes the same per-(batch, seed) file set.
    """
    if stream_batched and not streaming_blocks:
        raise ValueError(
            "stream_batched requires streaming_blocks "
            "(--run_stream_batched only applies to the streamed INFER path; "
            "set --run_streaming_blocks)"
        )
    out = Path(output_dir)
    R = len(mu)
    n_backward_total = num_resampled_particles * (2 * R + R * R)
    trace = StageTrace(out)
    _set_mirror(bucket_dir, out, resume, trace)
    # Multi-host entry (the AWS-Batch-scale analog): no-op single-host,
    # connects jax.distributed when coordinator env hints are set.
    if not stub_run:
        from hygeia_tpu.parallel.launcher import initialize_distributed

        initialize_distributed()

    if stub_run:
        _stub_two_group(out, chroms, inference_seeds, n_backward_total)
        trace.flush()
        return out

    # ---- 2 (batched pre-pass): when counts for every chromosome exist up
    # front (preprocessed_dir mode), run the theta stage for ALL pending
    # chromosomes in ONE vmapped device program — one sequential chain is
    # latency-bound and vmapped chains share each scan step, and the engine's
    # t_limit masking makes ragged batching bit-identical per chromosome.
    # On failure the markers stay unset and the per-chromosome path below
    # handles each individually (retry/ignore semantics unchanged).
    # Prewarm the pipeline's device-program set in the background from the
    # very start: a fresh process otherwise pays each program's compile (or
    # compile-cache read) SERIALLY in front of each stage's first dispatch.
    # Theta-stage jobs are submitted first (needed first); all compiles
    # parallelise on one pool (best-effort — a failed job only forfeits the
    # overlap, and is logged to stderr).
    if preprocessed_dir is not None and not stub_run:
        import threading

        def _prewarm():
            try:
                from concurrent.futures import ThreadPoolExecutor

                from hygeia_tpu.utils import io as _hio

                n_pos = len(
                    _hio.read_positions(
                        Path(preprocessed_dir) / f"positions_{chroms[0]}.txt.gz"
                    )
                )
                jobs = []
                from hygeia_tpu.single_group import theta_config as _tc

                if len(chroms) == 1 and n_pos >= _tc.THETA_BLOCK_THRESHOLD:
                    # The blocked theta stage will run (same thresholds as
                    # _single_group_on_counts, via theta_config).
                    from hygeia_tpu.single_group.blocked import (
                        aot_compile_jobs as _theta_jobs,
                    )
                    from hygeia_tpu.single_group.engine import EngineConfig
                    from hygeia_tpu.single_group.model import make_model

                    model = make_model(
                        np.asarray(mu), np.asarray(sigma), u,
                        np.full(len(mu), 2.0), d_max=4096,
                    )
                    cfg = EngineConfig(
                        n_particles_max=n_particles_single_group,
                        epsilon=epsilon,
                        estimate_regimes=True,
                        estimate_parameters=True,
                        steps_per_update=n_steps_without_parameter_update,
                        learning_rate_exponent=learning_rate_exponent,
                        learning_rate_factor=learning_rate_factor,
                    )
                    jobs += _theta_jobs(model, cfg, n_pos)
                if streaming_blocks and stream_batched:
                    from hygeia_tpu.two_group.runner import (
                        prewarm_chromosome_streamed,
                    )

                    jobs += prewarm_chromosome_streamed(
                        n_positions=n_pos,
                        segment_size=segment_size,
                        buffer_size=buffer_size,
                        n_seeds=len(inference_seeds),
                        mu=mu,
                        sigma=sigma,
                        minimum_duration=u,
                        num_resampled_particles=num_resampled_particles,
                        num_samples_backward=num_samples_backward,
                        streaming_blocks=streaming_blocks,
                        run=False,
                    )
                with ThreadPoolExecutor(max_workers=8) as pool:
                    for f in [pool.submit(j) for j in jobs]:
                        try:
                            f.result()
                        except Exception as e:  # noqa: BLE001
                            _log_prewarm_failure(e)
            except Exception as e:  # noqa: BLE001 — priming is best-effort
                _log_prewarm_failure(e)

        threading.Thread(target=_prewarm, daemon=True).start()

    sg_batched_done: set = set()  # chroms completed by the batched pass
    # (tracked in-process, not only via .done markers: with --no_resume the
    # per-chromosome loop ignores markers and would re-run the stage twice).
    if preprocessed_dir is not None and len(chroms) > 1:
        sg_root = out / "2_ESTIMATE_PARAMETERS_AND_REGIMES"
        pending = [c for c in chroms if _stage(sg_root / str(c), resume)]
        if len(pending) > 1:

            def _sg_batched(attempt):
                _single_group_on_counts_batched(
                    [
                        (Path(preprocessed_dir), sg_root / str(c), c, "control")
                        for c in pending
                    ],
                    mu=mu,
                    sigma=sigma,
                    u=u,
                    n_particles=n_particles_single_group,
                    epsilon=epsilon,
                    steps_per_update=n_steps_without_parameter_update,
                    learning_rate_exponent=learning_rate_exponent,
                    learning_rate_factor=learning_rate_factor,
                    rng_seed=rng_seed,
                )
                for c in pending:
                    _finish(sg_root / str(c))

            if _attempt(
                _sg_batched,
                trace=trace,
                stage="ESTIMATE_PARAMETERS_AND_REGIMES[batched]",
                chrom=",".join(map(str, pending)),
                max_retries=1,
            ):
                sg_batched_done.update(pending)

    for chrom in chroms:
        # ---- 1: preprocess ------------------------------------------------
        pre_dir = out / "1_PREPROCESS" / str(chrom)
        if preprocessed_dir is not None:
            pre_dir = Path(preprocessed_dir)
        elif _stage(pre_dir, resume):
            from hygeia_tpu.pipeline.preprocess_bed import process_bed

            process_bed(
                cpg_file_path,
                pre_dir,
                chrom,
                control_data_paths=control_data_paths,
                control_id_names=control_id_names,
                case_data_paths=case_data_paths,
                case_id_names=case_id_names,
            )
            _finish(pre_dir)

        # ---- 2: single-group estimation on the CONTROL group --------------
        # (modules/two_group/2_estimate_parameters_and_regimes.nf:39-52 runs
        # the engine on control reads with both estimation flags).
        sg_dir = out / "2_ESTIMATE_PARAMETERS_AND_REGIMES" / str(chrom)
        if chrom not in sg_batched_done and _stage(sg_dir, resume):

            def _sg_stage(attempt):
                _single_group_on_counts(
                    pre_dir,
                    sg_dir,
                    chrom,
                    group="control",
                    mu=mu,
                    sigma=sigma,
                    u=u,
                    n_particles=n_particles_single_group,
                    epsilon=epsilon,
                    steps_per_update=n_steps_without_parameter_update,
                    learning_rate_exponent=learning_rate_exponent,
                    learning_rate_factor=learning_rate_factor,
                    rng_seed=rng_seed,
                )
                _finish(sg_dir)

            if not _attempt(
                _sg_stage,
                trace=trace,
                stage="ESTIMATE_PARAMETERS_AND_REGIMES",
                chrom=chrom,
                max_retries=max_retries,
            ):
                # Everything downstream needs theta: skip the chromosome
                # (the reference's ignore drops this chrom's outputs too).
                continue
        else:
            trace.record("ESTIMATE_PARAMETERS_AND_REGIMES", chrom, 0.0, skipped=True)

        # ---- 3: segments --------------------------------------------------
        seg_dir = out / "3_GET_CHROM_SEGMENTS" / str(chrom)
        from hygeia_tpu.utils import io as hio

        positions = hio.read_positions(pre_dir / f"positions_{chrom}.txt.gz")
        n_batches = 1 + len(positions) // segment_size
        if _stage(seg_dir, resume):
            from hygeia_tpu.pipeline.segments import write_segments_csv

            write_segments_csv(
                seg_dir / f"chrom_segments_{chrom}.csv", len(positions),
                chrom, segment_size,
            )
            _finish(seg_dir)

        # ---- 4: infer over (batch x seed) ---------------------------------
        infer_dir = out / "4_INFER"
        from hygeia_tpu.two_group.runner import infer_segment

        any_unit_failed = False
        if mesh_shape is not None:
            # Meshed INFER: the whole chromosome's (batch x seed) grid in one
            # device program. One work unit -> one marker/retry scope.
            from hygeia_tpu.two_group.runner import infer_chromosome_meshed

            unit = infer_dir / f"unit_{chrom}_meshed"
            if not _stage(unit, resume):
                trace.record("INFER[mesh]", chrom, 0.0, skipped=True)
            else:

                def _infer_meshed(attempt):
                    infer_chromosome_meshed(
                        data_dir=str(pre_dir),
                        single_group_dir=str(sg_dir),
                        results_dir=str(infer_dir),
                        chrom=chrom,
                        mesh_shape=mesh_shape,
                        boundary=boundary,
                        seed=list(inference_seeds),
                        segment_size=segment_size,
                        buffer_size=buffer_size,
                        mu=mu,
                        sigma=sigma,
                        minimum_duration=u,
                        num_resampled_particles=(num_resampled_particles,),
                        num_samples_backward=num_samples_backward,
                        rng_seed=rng_seed,
                    )
                    _finish(unit)

                ok = _attempt(
                    _infer_meshed,
                    trace=trace,
                    stage="INFER[mesh]",
                    chrom=chrom,
                    max_retries=max_retries,
                )
                any_unit_failed |= not ok
        if mesh_shape is None and stream_batched and streaming_blocks:
            # Cross-segment batched streamed INFER: the chromosome's whole
            # (batch x seed) unit grid rides one sequence of streamed
            # dispatches (runner.infer_chromosome_streamed) — the
            # single-device counterpart of the meshed path (residency is
            # throughput). One marker/retry scope per chromosome; retries halve
            # the per-dispatch unit cap like the sequential path's seed cap.
            from hygeia_tpu.two_group.runner import infer_chromosome_streamed

            unit = infer_dir / f"unit_{chrom}_streambatched"
            if not _stage(unit, resume):
                trace.record("INFER[streambatched]", chrom, 0.0, skipped=True)
            else:

                def _infer_streambatched(attempt):
                    infer_chromosome_streamed(
                        data_dir=str(pre_dir),
                        single_group_dir=str(sg_dir),
                        results_dir=str(infer_dir),
                        chrom=chrom,
                        seed=list(inference_seeds),
                        segment_size=segment_size,
                        buffer_size=buffer_size,
                        mu=mu,
                        sigma=sigma,
                        minimum_duration=u,
                        num_resampled_particles=(num_resampled_particles,),
                        num_samples_backward=num_samples_backward,
                        streaming_blocks=streaming_blocks,
                        max_units_per_call=max(
                            1, (len(inference_seeds) * n_batches) >> (attempt - 1)
                        ),
                    )
                    _finish(unit)

                ok = _attempt(
                    _infer_streambatched,
                    trace=trace,
                    stage="INFER[streambatched]",
                    chrom=chrom,
                    max_retries=max_retries,
                )
                any_unit_failed |= not ok
            seq_batches = ()
        elif mesh_shape is None:
            seq_batches = range(n_batches)
        else:
            seq_batches = ()
        for batch in seq_batches:
            # All seeds of a batch run vmapped in one device program.
            unit = infer_dir / f"unit_{chrom}_{batch}"
            if not _stage(unit, resume):
                trace.record(f"INFER[{batch}]", chrom, 0.0, skipped=True)
                continue

            def _infer_unit(attempt, batch=batch):
                infer_segment(
                    data_dir=str(pre_dir),
                    single_group_dir=str(sg_dir),
                    results_dir=str(infer_dir),
                    chrom=chrom,
                    batch=batch,
                    seed=list(inference_seeds),
                    segment_size=segment_size,
                    buffer_size=buffer_size,
                    mu=mu,
                    sigma=sigma,
                    minimum_duration=u,
                    num_resampled_particles=(num_resampled_particles,),
                    num_samples_backward=num_samples_backward,
                    streaming_blocks=streaming_blocks,
                    # Escalate like task.attempt resources (4_infer.nf:10):
                    # halve the per-dispatch seed chunk on each retry so an
                    # device OOM on the full vmapped seed batch backs off.
                    max_seeds_per_call=max(1, len(inference_seeds) >> (attempt - 1)),
                )
                _finish(unit)

            ok = _attempt(
                _infer_unit,
                trace=trace,
                stage=f"INFER[{batch}]",
                chrom=chrom,
                max_retries=max_retries,
            )
            any_unit_failed |= not ok

        # ---- 5: aggregate --------------------------------------------------
        # A unit ignored after all retries must not kill the chromosome:
        # aggregate whatever completed (skip_missing), like the reference's
        # errorStrategy 'ignore' feeding AGGREGATE only successful tasks.
        agg_dir = out / "5_AGGREGATE_RESULTS" / str(chrom)
        if _stage(agg_dir, resume):
            from hygeia_tpu.pipeline.aggregate import aggregate_chromosome

            def _agg_stage(attempt):
                aggregate_chromosome(
                    str(infer_dir),
                    str(agg_dir),
                    chrom,
                    seeds=len(inference_seeds),
                    num_particles=n_backward_total,
                    num_batches=n_batches,
                    skip_missing=any_unit_failed,
                )
                _finish(agg_dir)

            if not _attempt(
                _agg_stage,
                trace=trace,
                stage="AGGREGATE_RESULTS",
                chrom=chrom,
                max_retries=max_retries,
            ):
                continue

        # ---- 6: DMPs -------------------------------------------------------
        dmp_dir = out / "6_GET_DMPS" / str(chrom)
        if _stage(dmp_dir, resume):
            from hygeia_tpu.pipeline.dmps import call_dmps

            def _dmp_stage(attempt):
                call_dmps(
                    str(agg_dir),
                    str(dmp_dir),
                    chrom,
                    n_regimes=R,
                    fdr_thresholds=fdr_thresholds,
                )
                _finish(dmp_dir)

            _attempt(
                _dmp_stage,
                trace=trace,
                stage="GET_DMPS",
                chrom=chrom,
                max_retries=max_retries,
            )

    trace.flush()
    if _ACTIVE_MIRROR is not None:
        _ACTIVE_MIRROR[0].sync_up(out)  # pick up trace/report artifacts
    return out


def _stub_two_group(out, chroms, inference_seeds, n_backward_total):
    """Create the full output tree with empty files (DAG wiring test)."""
    for chrom in chroms:
        for stage in (
            f"1_PREPROCESS/{chrom}",
            f"2_ESTIMATE_PARAMETERS_AND_REGIMES/{chrom}",
            f"3_GET_CHROM_SEGMENTS/{chrom}",
            "4_INFER",
            f"5_AGGREGATE_RESULTS/{chrom}",
            f"6_GET_DMPS/{chrom}",
        ):
            (out / stage).mkdir(parents=True, exist_ok=True)
        for name in (
            f"1_PREPROCESS/{chrom}/positions_{chrom}.txt.gz",
            f"2_ESTIMATE_PARAMETERS_AND_REGIMES/{chrom}/theta_{chrom}.csv.gz",
            f"3_GET_CHROM_SEGMENTS/{chrom}/chrom_segments_{chrom}.csv",
            f"5_AGGREGATE_RESULTS/{chrom}/split_probs_{chrom}.csv.gz",
            f"6_GET_DMPS/{chrom}/dmp_0.05.csv",
        ):
            (out / name).touch()
        for seed in inference_seeds:
            d = out / "4_INFER" / f"chrom_{chrom}_0"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"optimal_backward_particles_merged_state_{n_backward_total}_{seed}.npz").touch()


# (statics, EngineConfig) -> jitted combined-inference program with the
# model arrays + emission table riding as arguments (see the rule-6b/6d
# comment at the call site).
_SG_PROGRAMS = {}


def _sg_engine_program(R, u, kappa_fixed, d_max, cfg, batched=False):
    key_c = (R, u, kappa_fixed, d_max, cfg, batched)
    if key_c in _SG_PROGRAMS:
        return _SG_PROGRAMS[key_c]
    import jax
    import jax.numpy as jnp  # noqa: F401

    from hygeia_tpu.single_group.model import SingleGroupModel
    from hygeia_tpu.single_group.engine import run_online_combined_inference

    def _model(alpha, beta, kappa0):
        return SingleGroupModel(
            n_regimes=R, u=u, kappa_fixed=kappa_fixed, d_max=d_max,
            alpha=alpha, beta=beta, kappa0=kappa0,
        )

    if batched:
        # vmapped ragged chromosomes (see _single_group_on_counts_batched).
        @jax.jit
        def run(keys, alpha, beta, kappa0, theta_inits, Es, t_limits):
            model = _model(alpha, beta, kappa0)

            def one(key, th, E, tl):
                return run_online_combined_inference(
                    key, model, th, E, cfg, t_limit=tl
                )

            return jax.vmap(one)(keys, theta_inits, Es, t_limits)

    else:

        @jax.jit
        def run(key, alpha, beta, kappa0, theta_init, E):
            model = _model(alpha, beta, kappa0)
            return run_online_combined_inference(key, model, theta_init, E, cfg)

    _SG_PROGRAMS[key_c] = run
    return run


def _single_group_on_counts(
    pre_dir,
    sg_dir,
    chrom,
    *,
    group,
    mu,
    sigma,
    u,
    n_particles,
    epsilon,
    steps_per_update,
    learning_rate_exponent,
    learning_rate_factor,
    rng_seed,
    estimate_regimes=True,
    estimate_parameters=True,
    theta_fixed=None,
    theta_block_size=None,  # default: theta_config.THETA_BLOCK_SIZE
    theta_halo=None,
    theta_block_threshold=None,
):
    """Run the single-group engine directly on preprocessed count matrices
    and write the reference-named outputs (theta_{chrom}.csv.gz etc.)."""
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.ops.emissions import emission_log_prob_table
    from hygeia_tpu.single_group.model import make_model
    from hygeia_tpu.single_group.engine import (
        EngineConfig,
        run_online_combined_inference,
    )
    from hygeia_tpu.utils import io as hio

    pre_dir, sg_dir = Path(pre_dir), Path(sg_dir)
    R = len(mu)
    kappa = np.full(R, 2.0)
    n_total = hio.read_count_matrix(pre_dir / f"n_total_reads_{group}_{chrom}.txt.gz")
    n_meth = hio.read_count_matrix(
        pre_dir / f"n_methylated_reads_{group}_{chrom}.txt.gz"
    )
    positions = hio.read_positions(pre_dir / f"positions_{chrom}.txt.gz")
    model = make_model(np.asarray(mu), np.asarray(sigma), u, kappa, d_max=4096)
    if theta_fixed is not None:
        theta_init = np.asarray(theta_fixed)
    elif estimate_parameters:
        theta_init = np.asarray(
            jax.random.normal(jax.random.PRNGKey(rng_seed), (model.dim_theta,))
        )
    else:
        from hygeia_tpu.single_group.runner import default_p, DEFAULT_OMEGA
        from hygeia_tpu.single_group.model import parameters_to_theta

        theta_init = parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA[:R]), kappa)
    E = emission_log_prob_table(n_meth, n_total, model.alpha, model.beta)
    cfg = EngineConfig(
        n_particles_max=n_particles,
        epsilon=epsilon,
        estimate_regimes=estimate_regimes,
        estimate_parameters=estimate_parameters,
        steps_per_update=steps_per_update,
        learning_rate_exponent=learning_rate_exponent,
        learning_rate_factor=learning_rate_factor,
    )
    from hygeia_tpu.single_group import theta_config as _tc

    if theta_block_size is None:
        theta_block_size = _tc.THETA_BLOCK_SIZE
    if theta_halo is None:
        theta_halo = _tc.THETA_HALO
    if theta_block_threshold is None:
        theta_block_threshold = _tc.THETA_BLOCK_THRESHOLD
    T = E.shape[0]
    if theta_block_size and T >= theta_block_threshold:
        # Within-chromosome blocked path: one sequential chain is
        # latency-bound at this shape; halo-buffered blocks of THIS
        # chromosome run vmapped after a sequential theta warmup
        # (single_group/blocked.py; parity: tests/test_blocked_engine.py).
        from hygeia_tpu.single_group.blocked import (
            run_online_combined_inference_blocked,
        )

        res = run_online_combined_inference_blocked(
            jax.random.PRNGKey(rng_seed),
            model,
            np.asarray(theta_init, np.float32),
            np.asarray(E),
            cfg,
            block_size=theta_block_size,
            halo=theta_halo,
        )
    else:
        # Program cached at module level with the table/model arrays as jit
        # ARGUMENTS: a fresh `jax.jit(lambda ...)` per stage call re-traced
        # and re-compiled every chromosome and baked the (T, R) emission
        # table in as a multi-MB program constant.
        prog = _sg_engine_program(
            model.n_regimes, model.u, model.kappa_fixed, model.d_max, cfg
        )
        res = prog(
            jax.random.PRNGKey(rng_seed),
            model.alpha,
            model.beta,
            model.kappa0,
            jnp.asarray(theta_init, jnp.float32),
            E,
        )

    _write_sg_outputs(
        sg_dir, chrom, positions,
        np.asarray(res.regime_probs) if estimate_regimes else None,
        np.asarray(res.theta_trace), R, kappa,
    )


def _write_sg_outputs(sg_dir, chrom, positions, probs, trace, R, kappa):
    """Reference-named single-group stage outputs (theta_{chrom}.csv.gz etc.)
    — shared by the per-chromosome and the batched stage paths."""
    from hygeia_tpu.single_group.model import theta_to_parameters
    from hygeia_tpu.utils import io as hio

    sg_dir = Path(sg_dir)
    # The theta trace is (T, dim_theta) floats: the %.9g table writer
    # round-trips the f32 values exactly (text may differ from pandas'
    # shortest repr — PARITY.md).
    if probs is not None:
        cols = [f"regime_{i + 1}" for i in range(R)]
        hio.write_float_table(
            sg_dir / f"regime_probabilities_{chrom}.csv.gz",
            probs,
            index=np.asarray(positions[: len(probs)]),
            header="genomic_position," + ",".join(cols),
        )
    hio.write_float_table(
        sg_dir / f"theta_trace_{chrom}.csv.gz",
        trace,
        header=",".join(f"theta_{i + 1}" for i in range(trace.shape[1])),
    )
    final = theta_to_parameters(trace[-1], R)
    hio.write_csv(
        sg_dir / f"p_{chrom}.csv.gz", list(np.asarray(final["p"]).T),
        header=[f"regime_{i + 1}" for i in range(R)],
    )
    hio.write_headed_column(sg_dir / f"omega_{chrom}.csv.gz", final["omega"], "omega")
    hio.write_headed_column(sg_dir / f"kappa_{chrom}.csv.gz", kappa, "kappa")
    hio.write_theta(sg_dir / f"theta_{chrom}.csv.gz", trace[-1])


def _single_group_on_counts_batched(
    units,  # [(pre_dir, sg_dir, chrom, group)]
    *,
    mu,
    sigma,
    u,
    n_particles,
    epsilon,
    steps_per_update,
    learning_rate_exponent,
    learning_rate_factor,
    rng_seed,
    estimate_parameters=True,
    estimate_regimes=True,
    theta_fixed=None,  # optional [(D,) per unit] — module-3 fixed-theta pass
):
    """ESTIMATE_PARAMETERS_AND_REGIMES for SEVERAL chromosomes in ONE
    vmapped device program (ragged lengths via the engine's t_limit
    masking — bit-exact per lane; across PROGRAM variants (batched vs
    per-unit) XLA may reassociate f32 reductions, so per-chromosome
    outputs equal the per-unit runs to reduction-order ulp.
    tests: test_t_limit_masking_matches_unbatched_run,
    test_batched_single_group_stage_matches_per_chromosome).

    Why: one sequential theta chain is latency-bound, and vmapped chains
    share each scan step. The reference has no analog — its module 2 is one
    container per chromosome
    (modules/two_group/2_estimate_parameters_and_regimes.nf).
    """
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.ops.emissions import emission_log_prob_table
    from hygeia_tpu.single_group.model import make_model
    from hygeia_tpu.single_group.engine import EngineConfig
    from hygeia_tpu.utils import io as hio

    R = len(mu)
    U = len(units)
    kappa = np.full(R, 2.0)
    model = make_model(np.asarray(mu), np.asarray(sigma), u, kappa, d_max=4096)
    cfg = EngineConfig(
        n_particles_max=n_particles,
        epsilon=epsilon,
        estimate_regimes=estimate_regimes,
        estimate_parameters=estimate_parameters,
        steps_per_update=steps_per_update,
        learning_rate_exponent=learning_rate_exponent,
        learning_rate_factor=learning_rate_factor,
    )
    if theta_fixed is not None:
        thetas = np.stack([np.asarray(t) for t in theta_fixed])
    elif estimate_parameters:
        thetas = np.broadcast_to(
            np.asarray(
                jax.random.normal(
                    jax.random.PRNGKey(rng_seed), (model.dim_theta,)
                )
            ),
            (U, model.dim_theta),
        )
    else:
        from hygeia_tpu.single_group.runner import default_p, DEFAULT_OMEGA
        from hygeia_tpu.single_group.model import parameters_to_theta

        thetas = np.broadcast_to(
            parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA[:R]), kappa),
            (U, model.dim_theta),
        )

    tables, t_limits, positions_all = [], [], []
    for pre_dir, _sg, chrom, group in units:
        pre_dir = Path(pre_dir)
        n_total = hio.read_count_matrix(
            pre_dir / f"n_total_reads_{group}_{chrom}.txt.gz"
        )
        n_meth = hio.read_count_matrix(
            pre_dir / f"n_methylated_reads_{group}_{chrom}.txt.gz"
        )
        positions_all.append(
            hio.read_positions(pre_dir / f"positions_{chrom}.txt.gz")
        )
        tables.append(
            np.asarray(
                emission_log_prob_table(
                    n_meth, n_total, model.alpha, model.beta
                )
            )
        )
        t_limits.append(tables[-1].shape[0])

    from hygeia_tpu.single_group import theta_config as _tc

    if min(t_limits) >= _tc.THETA_BLOCK_THRESHOLD:
        # Large chromosomes: blocked-multi — ALL (chromosome, block) units
        # of the batch ride one vmapped program with per-unit theta lanes
        # (single_group/blocked.py), instead of one whole-chromosome lane
        # per unit (better residency AND no t_limit freeze cost).
        from hygeia_tpu.single_group.blocked import (
            run_online_combined_inference_blocked_multi,
        )

        res_list = run_online_combined_inference_blocked_multi(
            jax.random.PRNGKey(rng_seed),
            model,
            [np.asarray(t, np.float32) for t in thetas],
            tables,
            cfg,
            block_size=_tc.THETA_BLOCK_SIZE,
            halo=_tc.THETA_HALO,
        )
        for i, (_pre, sg_dir, chrom, _g) in enumerate(units):
            sg_dir = Path(sg_dir)
            sg_dir.mkdir(parents=True, exist_ok=True)
            res = res_list[i]
            _write_sg_outputs(
                sg_dir, chrom, positions_all[i],
                np.asarray(res.regime_probs) if estimate_regimes else None,
                np.asarray(res.theta_trace), R, kappa,
            )
        return

    t_max = max(t_limits)
    E = np.zeros((U, t_max, R), np.float32)
    for i, tab in enumerate(tables):
        E[i, : tab.shape[0]] = tab  # zero rows past the limit are masked

    prog = _sg_engine_program(
        model.n_regimes, model.u, model.kappa_fixed, model.d_max, cfg,
        batched=True,
    )
    keys = jnp.stack(
        [jax.random.PRNGKey(rng_seed)] * U
    )  # same key per unit, matching the sequential path exactly
    res = prog(
        keys,
        model.alpha,
        model.beta,
        model.kappa0,
        jnp.asarray(thetas, jnp.float32),
        jnp.asarray(E),
        jnp.asarray(t_limits, jnp.int32),
    )
    probs = np.asarray(res.regime_probs)
    traces = np.asarray(res.theta_trace)
    for i, (_pre, sg_dir, chrom, _g) in enumerate(units):
        sg_dir = Path(sg_dir)
        sg_dir.mkdir(parents=True, exist_ok=True)
        T_u = t_limits[i]
        # trace row t = theta after step t (row 0 = init): a length-T_u
        # chromosome has T_u rows. The previous `: T_u - 1` slice dropped
        # the final row — wrong exactly when the last ADAM update lands on
        # step T_u - 1 (round-5 review finding).
        _write_sg_outputs(
            sg_dir, chrom, positions_all[i],
            probs[i, :T_u] if estimate_regimes else None,
            traces[i, :T_u], R, kappa,
        )


def read_sample_sheet(path):
    """Parse the reference's sample-sheet CSV (header `id,file`; main.nf:21-24
    splits it the same way) into [(sample_id, bed_path), ...]."""
    import csv

    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            rows.append((row["id"].strip(), row["file"].strip()))
    return rows


def run_single_group(
    *,
    output_dir,
    chroms,
    samples=None,  # [(sample_id, preprocessed_dir)] — already-preprocessed inputs
    sample_sheet=None,  # CSV with id,file columns (raw BED inputs; main.nf:21-24)
    raw_samples=None,  # [(sample_id, bed_path)] — raw BED inputs, pre-parsed
    cpg_file_path=None,  # required with sample_sheet/raw_samples
    mu=(0.99, 0.01, 0.80, 0.20, 0.50, 0.50),
    sigma=(0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751),
    u=3,
    n_particles=250,
    epsilon=0.01,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    resume=True,
    rng_seed=0,
    stub_run=False,
    max_retries=5,
    group="case",
    bucket_dir=None,
):
    """Single-group path (main.nf:20-30): per (sample, chrom) —
    SINGLE_GRP_PREPROCESS (modules/single_group/1_preprocess.nf, the sample's
    BED preprocessed as the 'case' group) → ESTIMATE_PARAMETERS (module 2,
    theta learned from a prior init) → ESTIMATE_REGIMES (module 3, fixed
    learned parameters) → BED export with bgzip + tabix index (module 4).

    Inputs: EITHER `sample_sheet`/`raw_samples` + `cpg_file_path` (raw BED,
    preprocessing runs as stage 1), OR `samples` = [(sample_id, dir)] of
    already-preprocessed count dirs holding n_total_reads_{group}_{chrom}
    files (`group` names which count files to read; our own preprocess stage
    emits 'case', matching 1_preprocess.nf:29-35).
    """
    out = Path(output_dir)
    trace = StageTrace(out)
    _set_mirror(bucket_dir, out, resume, trace)
    if not stub_run:
        from hygeia_tpu.parallel.launcher import initialize_distributed

        initialize_distributed()

    if sample_sheet is not None and raw_samples is None:
        raw_samples = read_sample_sheet(sample_sheet)

    if stub_run:
        _stub_single_group(
            out, chroms, [s for s, _ in (raw_samples or samples or ())]
        )
        trace.flush()
        return out

    units = []  # (sample_id, chrom, pre_dir, group)
    if raw_samples is not None:
        from hygeia_tpu.pipeline.preprocess_bed import process_bed

        for sample_id, bed_path in raw_samples:
            for chrom in chroms:
                pre_dir = out / "1_PREPROCESS" / sample_id / str(chrom)
                if _stage(pre_dir, resume):

                    def _pre_stage(attempt, sample_id=sample_id, bed_path=bed_path,
                                   chrom=chrom, pre_dir=pre_dir):
                        process_bed(
                            cpg_file_path,
                            pre_dir,
                            chrom,
                            case_data_paths=[bed_path],
                            case_id_names=[sample_id],
                        )
                        _finish(pre_dir)

                    if not _attempt(
                        _pre_stage,
                        trace=trace,
                        stage="SINGLE_GRP_PREPROCESS",
                        chrom=f"{sample_id}:{chrom}",
                        max_retries=max_retries,
                    ):
                        continue
                else:
                    trace.record(
                        "SINGLE_GRP_PREPROCESS", f"{sample_id}:{chrom}", 0.0,
                        skipped=True,
                    )
                units.append((sample_id, chrom, pre_dir, "case"))
    else:
        for sample_id, pre_dir in samples:
            for chrom in chroms:
                units.append((sample_id, chrom, Path(pre_dir), group))

    # Batched pre-passes over the whole (sample x chrom) grid: the theta
    # chains are sequential and latency-bound, so one vmapped ragged program
    # per pass fills the device (see the two-group batched stage; engine
    # t_limit masking keeps per-unit outputs identical). Failures leave
    # markers unset and fall through to the per-unit path below.
    sg_kw = dict(
        mu=mu, sigma=sigma, u=u, n_particles=n_particles, epsilon=epsilon,
        steps_per_update=n_steps_without_parameter_update,
        learning_rate_exponent=learning_rate_exponent,
        learning_rate_factor=learning_rate_factor, rng_seed=rng_seed,
    )
    est_batched_done: set = set()  # dirs completed by the batched passes
    reg_batched_done: set = set()  # (in-process: --no_resume ignores markers)
    if len(units) > 1:
        est_dir_of = lambda sid, ch: out / "2_ESTIMATE_PARAMETERS" / sid / str(ch)
        reg_dir_of = lambda sid, ch: out / "3_ESTIMATE_REGIMES" / sid / str(ch)
        pending1 = [
            (pre, est_dir_of(sid, ch), ch, grp)
            for sid, ch, pre, grp in units
            if _stage(est_dir_of(sid, ch), resume)
        ]
        if len(pending1) > 1:

            def _est_batched(attempt):
                _single_group_on_counts_batched(
                    pending1, estimate_parameters=True,
                    estimate_regimes=False, **sg_kw,
                )
                for _pre, d, _c, _g in pending1:
                    _finish(d)

            if _attempt(
                _est_batched, trace=trace,
                stage="ESTIMATE_PARAMETERS[batched]",
                chrom=f"{len(pending1)} units", max_retries=1,
            ):
                est_batched_done.update(d for _pre, d, _c, _g in pending1)
        pending2 = []
        theta2 = []
        from hygeia_tpu.utils import io as hio

        for sid, ch, pre, grp in units:
            est_d, reg_d = est_dir_of(sid, ch), reg_dir_of(sid, ch)
            theta_file = est_d / f"theta_{ch}.csv.gz"
            if _stage(reg_d, resume) and theta_file.exists():
                pending2.append((pre, reg_d, ch, grp))
                theta2.append(hio.read_theta(theta_file))
        if len(pending2) > 1:

            def _reg_batched(attempt):
                _single_group_on_counts_batched(
                    pending2, estimate_parameters=False,
                    estimate_regimes=True, theta_fixed=theta2, **sg_kw,
                )
                for _pre, d, _c, _g in pending2:
                    _finish(d)

            if _attempt(
                _reg_batched, trace=trace,
                stage="ESTIMATE_REGIMES[batched]",
                chrom=f"{len(pending2)} units", max_retries=1,
            ):
                reg_batched_done.update(d for _pre, d, _c, _g in pending2)

    for sample_id, chrom, pre_dir, grp in units:
        unit_tag = f"{sample_id}:{chrom}"

        # Pass 1: parameter estimation (module 2).
        est_dir = out / "2_ESTIMATE_PARAMETERS" / sample_id / str(chrom)
        if est_dir not in est_batched_done and _stage(est_dir, resume):

            def _est_stage(attempt):
                _single_group_on_counts(
                    pre_dir, est_dir, chrom, group=grp, mu=mu, sigma=sigma,
                    u=u, n_particles=n_particles, epsilon=epsilon,
                    steps_per_update=n_steps_without_parameter_update,
                    learning_rate_exponent=learning_rate_exponent,
                    learning_rate_factor=learning_rate_factor,
                    rng_seed=rng_seed,
                    estimate_regimes=False, estimate_parameters=True,
                )
                _finish(est_dir)

            if not _attempt(
                _est_stage, trace=trace, stage="ESTIMATE_PARAMETERS",
                chrom=unit_tag, max_retries=max_retries,
            ):
                continue
        else:
            trace.record("ESTIMATE_PARAMETERS", unit_tag, 0.0, skipped=True)

        # Pass 2: regime estimation with the learned parameters (module 3).
        reg_dir = out / "3_ESTIMATE_REGIMES" / sample_id / str(chrom)
        if reg_dir not in reg_batched_done and _stage(reg_dir, resume):

            def _reg_stage(attempt):
                from hygeia_tpu.utils import io as hio

                theta = hio.read_theta(est_dir / f"theta_{chrom}.csv.gz")
                _single_group_on_counts(
                    pre_dir, reg_dir, chrom, group=grp, mu=mu, sigma=sigma,
                    u=u, n_particles=n_particles, epsilon=epsilon,
                    steps_per_update=n_steps_without_parameter_update,
                    learning_rate_exponent=learning_rate_exponent,
                    learning_rate_factor=learning_rate_factor,
                    rng_seed=rng_seed,
                    estimate_regimes=True, estimate_parameters=False,
                    theta_fixed=theta,
                )
                _finish(reg_dir)

            if not _attempt(
                _reg_stage, trace=trace, stage="ESTIMATE_REGIMES",
                chrom=unit_tag, max_retries=max_retries,
            ):
                continue
        else:
            trace.record("ESTIMATE_REGIMES", unit_tag, 0.0, skipped=True)

        # BED export + bgzip + tabix (module 4: 4_generate_single_group_bed_
        # files.nf:24-30; output tree name matches its publishDir).
        bed_dir = out / "4_SINGLE_GROUP_OUTPUT" / sample_id
        bed_marker = bed_dir / f".done_{chrom}"
        if not (resume and bed_marker.exists()):
            bed_dir.mkdir(parents=True, exist_ok=True)

            def _bed_stage(attempt):
                from hygeia_tpu.pipeline.bed import make_bed

                make_bed(
                    chrom,
                    reg_dir / f"regime_probabilities_{chrom}.csv.gz",
                    bed_dir / f"{sample_id}_regimes_{chrom}.bed",
                    compress=True,
                )
                bed_marker.write_text(json.dumps({"t": time.time()}))

            _attempt(
                _bed_stage, trace=trace, stage="GENERATE_SINGLE_GROUP_BED_FILES",
                chrom=unit_tag, max_retries=max_retries,
            )
        else:
            trace.record(
                "GENERATE_SINGLE_GROUP_BED_FILES", unit_tag, 0.0, skipped=True
            )

    trace.flush()
    return out


def _stub_single_group(out, chroms, sample_ids):
    """Empty-output DAG wiring for the single-group path (the stub blocks of
    modules/single_group/*.nf)."""
    for sample_id in sample_ids:
        for chrom in chroms:
            for stage, names in (
                (f"1_PREPROCESS/{sample_id}/{chrom}",
                 (f"positions_{chrom}.txt.gz",
                  f"n_total_reads_case_{chrom}.txt.gz",
                  f"n_methylated_reads_case_{chrom}.txt.gz",
                  f"cpg_sites_merged_{chrom}.txt.gz")),
                (f"2_ESTIMATE_PARAMETERS/{sample_id}/{chrom}",
                 (f"theta_trace_{chrom}.csv.gz", f"p_{chrom}.csv.gz",
                  f"kappa_{chrom}.csv.gz", f"omega_{chrom}.csv.gz",
                  f"theta_{chrom}.csv.gz")),
                (f"3_ESTIMATE_REGIMES/{sample_id}/{chrom}",
                 (f"regime_probabilities_{chrom}.csv.gz",)),
                (f"4_SINGLE_GROUP_OUTPUT/{sample_id}",
                 (f"{sample_id}_regimes_{chrom}.bed.gz",
                  f"{sample_id}_regimes_{chrom}.bed.gz.tbi")),
            ):
                d = out / stage
                d.mkdir(parents=True, exist_ok=True)
                for name in names:
                    (d / name).touch()
