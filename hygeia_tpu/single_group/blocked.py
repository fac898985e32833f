"""Within-chromosome blocked single-group inference: the theta stage's
sequential chain, parallelised over halo-buffered genome blocks.

Why: the combined theta chain (ESTIMATE_PARAMETERS_AND_REGIMES,
OnlineCombinedInference.h:48-118) is the warm pipeline's largest stage —
ONE sequential lax.scan is latency-bound at this shape (vmapped units
share each scan step), and the reference's
answer is a whole-chromosome 80-minute container
(modules/single_group/2_estimate_parameters.nf:10-12). The answer here:
fill the device with blocks of ONE chromosome.

Scheme (two device programs, both cached at module level so no call
re-traces them):

1. WARMUP — a sequential params-only chain over the first
   ``warmup_sites`` sites moves theta most of the way to convergence
   (the ADAM chain is inherently sequential; its convergence horizon is
   far shorter than a chromosome). Skipped when parameters are fixed.
2. BLOCKS — the whole chromosome is split into ``block_size``-site blocks,
   each extended LEFT by ``halo`` sites (block 0 starts cold at site 0,
   exactly like the sequential chain; the reference's asymmetric first
   window, run_inference_two_groups.py:199-218). All blocks run the FULL
   combined engine vmapped in one program — fresh filters whose halo
   absorbs the cold start (the filter forgets initial conditions
   geometrically), theta chains continued from the warmup's (theta, ADAM
   moments, iteration count). Every window holds exactly win real sites:
   the ragged tail is handled by anchoring the LAST window at the
   chromosome end (overlapping its predecessor) instead of the engine's
   t_limit masking, whose whole-carry freeze (a where() over psi and the
   (win, R) output buffer EVERY step) made the blocks slower than the
   sequential chain where this was first built — big scan-carried buffers
   price the step in passes over device memory.

Outputs:
* regime probabilities: per-block smoothing estimates, halo rows dropped —
  these match the sequential chain within halo error
  (tests/test_blocked_engine.py).
* theta: the mean of the block-final thetas (parallel SGA chains on the
  same objective from a common warm start; averaging reduces the
  per-block noise). theta_trace rows are the per-block traces stitched
  in genome order with the final row set to the averaged theta (the row
  downstream theta_{chrom}.csv.gz is built from). Deviation from the
  reference's single-chain trace is documented in PARITY.md.

Determinism: block b draws from fold_in(key, 1_000_003 + b); the warmup
chain uses the caller's key directly, so its realisation is bit-identical
to the sequential chain's prefix.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from hygeia_tpu.single_group.model import SingleGroupModel
from hygeia_tpu.single_group.engine import (
    EngineConfig,
    EngineResult,
    run_online_combined_inference,
)
from hygeia_tpu.single_group.theta_config import (
    THETA_BLOCK_SIZE,
    THETA_HALO,
    THETA_WARMUP_SITES,
)

# (model statics, cfg statics, variant) -> jitted program. Shapes (warmup
# length, window, n_blocks) ride jit's own shape cache; model/emission
# arrays ride as ARGUMENTS (rules 6b/6d).
_PROGRAMS = {}

_BLOCK_KEY_SALT = 1_000_003


def _programs(model: SingleGroupModel, config: EngineConfig):
    statics = (
        model.n_regimes,
        model.u,
        model.kappa_fixed,
        model.d_max,
        config,
    )
    if statics in _PROGRAMS:
        return _PROGRAMS[statics]
    n_regimes, u, kappa_fixed, d_max = statics[:4]

    def _model(alpha, beta, kappa0):
        return SingleGroupModel(
            n_regimes=n_regimes, u=u, kappa_fixed=kappa_fixed, d_max=d_max,
            alpha=alpha, beta=beta, kappa0=kappa0,
        )

    warm_cfg = config._replace(estimate_regimes=False)
    su = config.steps_per_update

    @jax.jit
    def single(key, alpha, beta, kappa0, theta_init, E):
        return run_online_combined_inference(
            key, _model(alpha, beta, kappa0), theta_init, E, config
        )

    @jax.jit
    def warmup_multi(keys, alpha, beta, kappa0, theta_inits, E):
        # Vmapped warmup chains — one per CHROMOSOME (the multi-chromosome
        # blocked stage; each chromosome learns its own theta).
        def one(key, th, E1):
            res = run_online_combined_inference(
                key, _model(alpha, beta, kappa0), th, E1, warm_cfg
            )
            n_upd = max(0, (E1.shape[0] - 1) // su)
            upd_rows = res.theta_trace[jnp.arange(1, n_upd + 1) * su]
            return res.final_theta, res.final_opt_state, upd_rows

        return jax.vmap(one)(keys, theta_inits, E)

    @jax.jit
    def blocks(keys, alpha, beta, kappa0, theta0s, adam0s, E_blocks):
        # No t_limit: its whole-carry freeze (tree_map of where over psi and
        # the (win, R) output buffer) priced every step in passes over
        # device memory and made the vmapped blocks slower than the
        # sequential chain. All windows are full-length real sites instead —
        # the ragged tail is handled by overlapping the last window.
        # theta0s/adam0s carry a PER-UNIT leading axis so blocks of SEVERAL
        # chromosomes (each with its own warm theta) ride one program.
        model = _model(alpha, beta, kappa0)

        def one(key, th0, ad0, E):
            res = run_online_combined_inference(
                key, model, th0, E, config, adam_init=ad0
            )
            # theta changes ONLY at update steps (t % su == 0): return the
            # update-step rows instead of the full (win, D) trace (~70 MB
            # at production shape, ~0.3 MB as update rows). The host
            # expands back to the bit-identical full trace.
            win = E.shape[0]
            n_upd = max(0, (win - 1) // su)
            upd_rows = res.theta_trace[jnp.arange(1, n_upd + 1) * su]
            return (
                res.log_normalizing_constant,
                res.regime_probs,
                res.regime_valid,
                res.spill_count,
                res.final_theta,
                res.final_score,
                upd_rows,
            )

        return jax.vmap(one)(keys, theta0s, adam0s, E_blocks)

    progs = {
        "warmup_multi": warmup_multi,
        "single": single,
        "blocks": blocks,
    }
    _PROGRAMS[statics] = progs
    return progs


def aot_compile_jobs(
    model: SingleGroupModel,
    config: EngineConfig,
    T: int,
    *,
    block_size: int = THETA_BLOCK_SIZE,
    halo: int = THETA_HALO,
    warmup_sites: int = THETA_WARMUP_SITES,
):
    """Zero-arg callables AOT-compiling the blocked theta-stage program set
    (warmup + blocks) for a chromosome of T sites — program acquisition
    costs ~20 s each on this backend even on cache hits but parallelises
    across threads; the pipeline orchestrator runs these at start-up
    alongside the INFER prewarm (streaming.aot_compile_jobs)."""
    import jax

    progs = _programs(model, config)
    n_blocks = max(1, -(-T // block_size))
    win = block_size + halo
    sds = jax.ShapeDtypeStruct
    D = model.dim_theta
    R = model.n_regimes
    key_sd = sds((2,), jnp.uint32)
    a_sd = sds(model.alpha.shape, model.alpha.dtype)
    b_sd = sds(model.beta.shape, model.beta.dtype)
    k_sd = sds(model.kappa0.shape, model.kappa0.dtype)
    th_sd = sds((D,), jnp.float32)
    if n_blocks == 1 or T < win:
        return [
            lambda: progs["single"]
            .lower(key_sd, a_sd, b_sd, k_sd, th_sd, sds((T, R), jnp.float32))
            .compile()
        ]
    jobs = []
    if config.estimate_parameters:
        Tw = int(min(T, warmup_sites))
        jobs.append(
            lambda: progs["warmup_multi"]
            .lower(
                sds((1, 2), jnp.uint32), a_sd, b_sd, k_sd,
                sds((1, D), jnp.float32), sds((1, Tw, R), jnp.float32),
            )
            .compile()
        )
    th_u = sds((n_blocks, D), jnp.float32)
    adam_sd = (th_u, th_u, sds((n_blocks,), jnp.int32))
    jobs.append(
        lambda: progs["blocks"]
        .lower(
            sds((n_blocks, 2), jnp.uint32), a_sd, b_sd, k_sd, th_u, adam_sd,
            sds((n_blocks, win, R), jnp.float32),
        )
        .compile()
    )
    return jobs


def run_online_combined_inference_blocked(
    key,
    model: SingleGroupModel,
    theta_init,
    emissions,  # (T, R) emission log-lik table, concrete (host) array
    config: EngineConfig,
    *,
    block_size: int = THETA_BLOCK_SIZE,
    halo: int = THETA_HALO,
    warmup_sites: int = THETA_WARMUP_SITES,
) -> EngineResult:
    """Blocked drop-in for run_online_combined_inference at chromosome scale.

    Returns an EngineResult whose regime_probs/theta_trace are assembled on
    the host from the per-block device outputs (see the module docstring
    for the exact semantics of each field)."""
    return run_online_combined_inference_blocked_multi(
        key, model, [theta_init], [emissions], config,
        block_size=block_size, halo=halo, warmup_sites=warmup_sites,
    )[0]


def run_online_combined_inference_blocked_multi(
    key,
    model: SingleGroupModel,
    theta_inits,  # [C] per-chromosome initial thetas
    emissions_list,  # [C] per-chromosome (T_c, R) tables (equal T_c not required)
    config: EngineConfig,
    *,
    block_size: int = THETA_BLOCK_SIZE,
    halo: int = THETA_HALO,
    warmup_sites: int = THETA_WARMUP_SITES,
):
    """Blocked theta stage over SEVERAL chromosomes in one program set:
    per-chromosome warmup chains run vmapped (cropped to the shared
    min(T_c, warmup_sites) prefix length), then ALL (chromosome, block)
    units ride ONE vmapped blocks program with per-unit (theta, ADAM)
    lanes — the device fills regardless of how the genome is split into
    chromosomes. Returns [C] EngineResults.

    Chromosomes too short to block (fewer than 2 blocks) fall back to the
    sequential single program individually."""
    C = len(emissions_list)
    Es = [np.asarray(E, np.float32) for E in emissions_list]
    R = Es[0].shape[1]
    D = model.dim_theta
    win = block_size + halo
    su = config.steps_per_update
    progs = _programs(model, config)

    results: list = [None] * C
    blocked_idx = []
    for c, E in enumerate(Es):
        T = E.shape[0]
        if max(1, -(-T // block_size)) == 1 or T < win:
            # Degenerate: sequential chain through the cached program.
            results[c] = progs["single"](
                key, model.alpha, model.beta, model.kappa0,
                jnp.asarray(theta_inits[c], jnp.float32), jnp.asarray(E),
            )
        else:
            blocked_idx.append(c)
    if not blocked_idx:
        return results

    def _expand_trace(upd, j_lo, j_hi, base):
        # Row j of a chain's trace = base theta before the first update,
        # then update row j//su - 1 (theta changes only at update steps).
        j = np.arange(j_lo, j_hi)
        rows = np.concatenate([np.asarray(base, np.float32)[None], upd], axis=0)
        return rows[np.minimum(j // su, len(upd))]

    # AOT-compile the blocks program CONCURRENTLY with the warmup chains'
    # execution (program acquisition costs ~20 s even on cache hits and
    # parallelises; best-effort).
    import threading

    n_blocks_c = {
        c: max(1, -(-Es[c].shape[0] // block_size)) for c in blocked_idx
    }
    n_units = sum(n_blocks_c.values())

    def _prewarm_blocks():
        try:
            sds = jax.ShapeDtypeStruct
            th_sd = sds((n_units, D), jnp.float32)
            progs["blocks"].lower(
                sds((n_units, 2), jnp.uint32),
                sds(model.alpha.shape, model.alpha.dtype),
                sds(model.beta.shape, model.beta.dtype),
                sds(model.kappa0.shape, model.kappa0.dtype),
                th_sd,
                (th_sd, th_sd, sds((n_units,), jnp.int32)),
                sds((n_units, win, R), jnp.float32),
            ).compile()
        except Exception:  # noqa: BLE001
            pass

    threading.Thread(target=_prewarm_blocks, daemon=True).start()

    # ---- 1. per-chromosome theta warmup prefixes (vmapped) ---------------
    theta_init_np = {
        c: np.asarray(theta_inits[c], np.float32) for c in blocked_idx
    }
    if config.estimate_parameters:
        Tw = int(min(warmup_sites, min(Es[c].shape[0] for c in blocked_idx)))
        Ew = jnp.asarray(
            np.stack([Es[c][:Tw] for c in blocked_idx])
        )  # (Cb, Tw, R)
        keys_w = jnp.stack([key] * len(blocked_idx))
        th_w = jnp.stack(
            [jnp.asarray(theta_init_np[c]) for c in blocked_idx]
        )
        theta0s_c, adam0s_c, upd_w = progs["warmup_multi"](
            keys_w, model.alpha, model.beta, model.kappa0, th_w, Ew
        )
        upd_w = np.asarray(upd_w)
        warm_traces = {
            c: _expand_trace(upd_w[i], 0, Tw, theta_init_np[c])
            for i, c in enumerate(blocked_idx)
        }
    else:
        theta0s_c = jnp.stack(
            [jnp.asarray(theta_init_np[c]) for c in blocked_idx]
        )
        Z = jnp.zeros((len(blocked_idx), D), jnp.float32)
        adam0s_c = (Z, Z, jnp.zeros((len(blocked_idx),), jnp.int32))
        warm_traces = {}

    # ---- 2. halo-buffered block windows for ALL chromosomes --------------
    # Every window holds exactly `win` REAL sites (no padding, no t_limit —
    # whose whole-carry freeze measured slower than sequential). Block b of
    # a chromosome outputs [b*bs, (b+1)*bs) from window
    # [b*bs - halo, b*bs - halo + win); block 0 cold-starts at site 0 like
    # the sequential chain, and the LAST block's window is anchored at the
    # chromosome end, overlapping its predecessor.
    E_blocks = np.zeros((n_units, win, R), np.float32)
    unit_meta = []  # (chrom idx, within-block start, global start, global end)
    u = 0
    for ci, c in enumerate(blocked_idx):
        E = Es[c]
        T = E.shape[0]
        for b in range(n_blocks_c[c]):
            g_start = b * block_size
            g_end = min(T, g_start + block_size)
            if b == n_blocks_c[c] - 1:
                s = T - win  # anchor the ragged tail at the end (overlap)
            else:
                s = max(0, g_start - halo)
            E_blocks[u] = E[s : s + win]
            unit_meta.append((ci, g_start - s, g_start, g_end))
            u += 1

    # Keys use the WITHIN-chromosome block index (like the orchestrator's
    # sequential path, which reuses one rng_seed per chromosome), so a
    # chromosome's multi-batch realisation matches its single-chromosome
    # blocked run.
    block_ids = jnp.asarray(
        [_BLOCK_KEY_SALT + m[2] // block_size for m in unit_meta],
        dtype=jnp.uint32,
    )
    keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(block_ids)
    ci_arr = np.asarray([m[0] for m in unit_meta])
    theta0s = jnp.asarray(np.asarray(theta0s_c)[ci_arr])
    adam0s = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[ci_arr]), adam0s_c)
    res_b = progs["blocks"](
        keys, model.alpha, model.beta, model.kappa0, theta0s, adam0s,
        jnp.asarray(E_blocks),
    )

    # ---- 3. host assembly -------------------------------------------------
    log_z_b, probs_b, valid_b, spill_b, final_theta_b, score_b, upd_b = res_b
    probs_b = np.asarray(probs_b)  # (n_units, win, R)
    valid_b = np.asarray(valid_b)
    upd_b = np.asarray(upd_b)  # (n_units, n_upd, D) update-step theta rows
    log_z_b = np.asarray(log_z_b)
    spill_b = np.asarray(spill_b)
    final_theta_b = np.asarray(final_theta_b)
    score_b = np.asarray(score_b)
    theta0s_np = np.asarray(theta0s_c)

    for ci, c in enumerate(blocked_idx):
        T = Es[c].shape[0]
        probs = np.zeros((T, R), np.float32)
        valid = np.zeros((T,), bool)
        trace = np.zeros((T, D), np.float32)
        rows = [u for u, m in enumerate(unit_meta) if m[0] == ci]
        for u in rows:
            _, lo, g_start, g_end = unit_meta[u]
            n = g_end - g_start
            probs[g_start:g_end] = probs_b[u, lo : lo + n]
            valid[g_start:g_end] = valid_b[u, lo : lo + n]
            trace[g_start:g_end] = _expand_trace(
                upd_b[u], lo, lo + n, theta0s_np[ci]
            )
        if c in warm_traces:
            # The warmup chain's trace is the sequential-parity prefix.
            n = min(len(warm_traces[c]), T)
            trace[:n] = warm_traces[c][:n]
        if config.estimate_parameters:
            final_theta = np.mean(final_theta_b[rows], axis=0)
        else:
            final_theta = theta_init_np[c]
        trace[-1] = final_theta  # theta_{chrom}.csv.gz reads the last row
        results[c] = EngineResult(
            regime_probs=probs,
            regime_valid=valid,
            theta_trace=trace,
            log_normalizing_constant=np.float64(np.sum(log_z_b[rows])),
            spill_count=np.sum(spill_b[rows]),
            final_theta=final_theta,
            final_score=np.mean(score_b[rows], axis=0),
            final_opt_state=None,
        )
    return results
