"""Single-group online combined inference: discrete change-point SMC +
adaptive-lag marginal smoothing + online score-based parameter estimation,
as ONE ``lax.scan`` over CpG sites.

Re-design of the C++ engine for XLA:

* Smc (Smc.h): particle-count growth N_t = min(R(t+1), N_max) is
  *deterministic in t*, so the dynamic particle vectors become one fixed
  N_max buffer with layout [continuations | fresh CP particles | dead], and
  all branch decisions are computed from the step index. Weights are
  renormalised each step (shift-invariant algebra; shifts accumulate into
  the log-normalising constant) so float32 is safe.
* OnlineMarginalSmoothing (OnlineMarginalSmoothing.h): the variable pending
  set becomes a fixed ring buffer of S_cap entries with a valid mask;
  entries finalise when all R filtered variances drop below epsilon
  (:219-231), and if the buffer fills, the oldest pending entry is
  force-finalised (spill counter reported — the reference's unbounded
  std::vector has no such cap).
* OnlineParameterEstimation + GradientAscent: the per-particle score
  statistics phi follow the same ancestor/backward-kernel recursion
  (:135-170); theta is updated every `steps_per_update` steps with the
  reference's exact ADAM variant and a/(i+1)^b learning-rate schedule
  (GradientAscent.h:109-155).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from hygeia_tpu.ops.resampling import optimal_finite_state_resampling
from hygeia_tpu.single_group.model import (
    SingleGroupModel,
    ThetaTables,
    build_tables,
)

# Every f32 contraction names its precision: on a GPU the default runs f32
# matmuls in TF32 (10-bit mantissa); the one-hot lookups must stay exact and
# the psi/phi recursions compound rounding over every site.
_HIGHEST = jax.lax.Precision.HIGHEST

_NEG_INF = -jnp.inf


class EngineConfig(NamedTuple):
    n_particles_max: int = 250  # N_max (CLI --n_particles default)
    epsilon: float = 0.01  # smoothing finalisation threshold
    smoothing_window: int = 128  # S_cap ring-buffer depth
    estimate_regimes: bool = True
    estimate_parameters: bool = False
    steps_per_update: int = 200  # --n_steps_without_parameter_update
    learning_rate_exponent: float = 0.1
    learning_rate_factor: float = 0.01
    use_adam: bool = True
    normalise_gradients: bool = False
    # Progress print every N sites, 0 = off (the reference prints every 1000
    # SMC steps, OnlineCombinedInference.h:77-85). Static: when 0 no debug
    # callback is traced into the scan at all.
    progress_every: int = 0
    # lax.scan unroll factor: amortises per-step scan machinery over several
    # sites (not yet swept on a GPU).
    scan_unroll: int = 1


class EngineResult(NamedTuple):
    regime_probs: jnp.ndarray  # (T, R) marginal smoothing estimates
    regime_valid: jnp.ndarray  # (T,) bool — False only if spilled over T cap
    theta_trace: jnp.ndarray  # (T, dim_theta)
    log_normalizing_constant: jnp.ndarray  # scalar
    spill_count: jnp.ndarray  # times the smoothing ring buffer overflowed
    final_theta: jnp.ndarray  # (dim_theta,)
    final_score: jnp.ndarray  # (dim_theta,) filtered mean of phi at the last
    # step — the Poyiadjis score estimate of d log Z / d theta (diagnostics
    # and the Fisher-identity test in tests/)
    final_opt_state: tuple = None  # (adam_m, adam_v, adam_iter) — lets the
    # blocked within-chromosome path continue the ADAM chain (lr schedule
    # and moments) from a sequential warmup run


def _grad_p_block_columns(R):
    """Static (R, R) column-index map: colidx[r_prev, j] is the theta column
    of P-row-gradient entry j for block r_prev (j == r_prev unused -> last
    col sentinel handled by caller masking)."""
    col = np.zeros((R, R), np.int32)
    for rp in range(R):
        for j in range(R):
            if j == rp:
                col[rp, j] = 0  # masked out by caller
            else:
                pos = j if j < rp else j - 1
                col[rp, j] = rp * (R - 1) + pos
    # Plain numpy: consumed only by the static scatter-tensor build in
    # _prepare_engine, which may run inside a trace (jnp constants become
    # tracers there and cannot be indexed into numpy).
    return col


def _prepare_engine(
    key,
    model: SingleGroupModel,
    theta_init,
    emissions,  # (T, R) emission log-lik table (ops/emissions)
    config: EngineConfig,
    weight_dtype=jnp.float32,
):
    """Build (carry0, step, shift0) for the combined algorithm.

    The scan carry IS the engine's full resumable state (particles, weights,
    psi/phi statistics, theta + ADAM state, hazard tables, finalised output
    buffer, RNG key) — run_online_combined_inference scans it over all T
    sites in one jit; run_online_combined_inference_chunked scans it chunk
    by chunk with an on-disk checkpoint between chunks (the intra-run
    recovery unit SURVEY.md s5 calls for; the reference's finest unit is a
    whole Nextflow task).
    """
    R = model.n_regimes
    N = config.n_particles_max
    M_cap = N - R
    S_cap = config.smoothing_window
    D = model.dim_theta
    T = emissions.shape[0]
    eps = config.epsilon
    dtype = weight_dtype

    theta_init = jnp.asarray(theta_init, dtype)
    tables0 = build_tables(model, theta_init)
    col_map = _grad_p_block_columns(R)

    # ---- initialisation (Smc::initialise + computeInitialWeightsCp) -------
    slot = jnp.arange(N)
    d0 = jnp.where(slot < R, 1, 0).astype(jnp.int32)
    r0 = jnp.where(slot < R, slot, 0).astype(jnp.int32)
    w0 = jnp.where(
        slot < R,
        -jnp.log(float(R)) + emissions[0, r0].astype(dtype),
        _NEG_INF,
    )
    shift0 = logsumexp(w0)
    w0 = w0 - shift0

    # Smoothing state: psi entry for time 0 in ring slot 0.
    psi0 = jnp.zeros((S_cap, R, N), dtype)
    test0 = (r0[None, :] == jnp.arange(R)[:, None]).astype(dtype)  # (R, N)
    psi0 = psi0.at[0].set(jnp.where(slot[None, :] < R, test0, 0.0))
    psi_time0 = jnp.full((S_cap,), T, jnp.int32).at[0].set(0)
    psi_valid0 = jnp.zeros((S_cap,), bool).at[0].set(True)
    # Finalised regime estimates leave the scan through a RING buffer of
    # 2*S_cap rows (slot = time % (2*S_cap)) + per-step ys emission of the
    # row for time t - S_cap, NOT a carried (T, R) buffer: the old buffer's
    # whole-array select on the spill branch priced every step in passes
    # over device memory once T grew or the engine was vmapped. Exactness
    # is preserved by a hard max-lag: any entry still
    # pending at age S_cap is force-finalised (counted in spill_count), so
    # pending times always lie in (t - S_cap, t] and the emitted row is
    # final. The reference's pending set is unbounded
    # (OnlineMarginalSmoothing.h:197-255) but its epsilon criterion
    # finalises at far smaller lags in practice; S_cap is configurable.
    # Depth 2*S_cap slots (slot = time % (2*S_cap)) + ONE spare sentinel row:
    # invalid psi entries carry psi_time = T, whose modulo would alias a real
    # slot and — via duplicate-index scatter — overwrite a real finalised row
    # with stale data. Invalid entries scatter into the spare row instead.
    ring0 = jnp.zeros((2 * S_cap + 1, R), jnp.float32)
    ring_valid0 = jnp.zeros((2 * S_cap + 1,), bool)

    # Parameter-estimation state (initialisePhi: gradients of the initial
    # density and observation density are zero, singleGroup.h:630-638,707-717).
    phi0 = jnp.zeros((N, D), dtype)
    grad_prev0 = jnp.zeros((D,), dtype)  # initialiseGradients
    adam_m0 = jnp.zeros((D,), dtype)
    adam_v0 = jnp.zeros((D,), dtype)

    carry0 = dict(
        d=d0,
        r=r0,
        w=w0,
        psi=psi0,
        psi_time=psi_time0,
        psi_valid=psi_valid0,
        ring=ring0,
        ring_valid=ring_valid0,
        spill=jnp.zeros((), jnp.int32),
        phi=phi0,
        theta=theta_init,
        grad_prev=grad_prev0,
        adam_m=adam_m0,
        adam_v=adam_v0,
        adam_iter=jnp.zeros((), jnp.int32),
        tables=tables0,
        score=jnp.zeros((D,), dtype),
        key=key,
    )

    regimes = jnp.arange(R)
    hi_prec = jax.lax.Precision.HIGHEST

    # Static P-gradient scatter tensor: scat[r, j, :] is the one-hot D-row
    # for P-block entry j of regime-row r (0 where j == r). Replaces the
    # per-step col_map[r_prev] row gather + (N, R, D) comparison build with
    # one small exact one-hot matmul.
    _scat_np = np.zeros((R, R, D), np.float32)
    for _r in range(R):
        for _j in range(R):
            if _j != _r:
                _scat_np[_r, _j, int(col_map[_r, _j])] = 1.0
    scat_p = jnp.asarray(_scat_np, dtype)

    n_haz = 3 if model.kappa_fixed else 4

    def _haz_trio(tables, d_prev, r_prev):
        """(rho, exit, grad_omega[, grad_kappa]) at (d_prev, r_prev), each
        shaped like the (flat) index arrays.

        The engine previously issued SIX (N,)-sized lookups per scan step
        across the density/gradient helpers. Stacking the three per-regime
        tables into one (3R, W) table and concatenating the index vectors
        crosses gather_rho's >=512-element threshold, so ONE 128-wide-row
        gather serves all of them (see gather_rho)."""
        from hygeia_tpu.ops.hazard import gather_rho

        parts = [tables.rho, tables.exit_status.astype(tables.rho.dtype),
                 tables.grad_omega_log_rho]
        if not model.kappa_fixed:
            parts.append(tables.grad_kappa_log_rho)
        stacked = jnp.concatenate(parts, axis=0)  # (n_haz*R, W)
        d3 = jnp.concatenate([d_prev] * n_haz)
        r3 = jnp.concatenate(
            [r_prev + j * R for j in range(n_haz)]
        )
        v = gather_rho(stacked, d3, r3)
        n = d_prev.shape[0]
        out = [v[j * n : (j + 1) * n] for j in range(n_haz)]
        out[1] = out[1] > 0.5  # exit flag back to bool
        return out

    def _cp_log_density_from(tables, trio, d_prev, r_prev, q):
        """log f((1, q) | (d_prev, r_prev)) as (Q, N), from the precomputed
        hazard trio. The log_P row lookup is an exact one-hot matmul instead
        of an (R, N) fancy gather; -inf rows ride
        through as -1e30 sentinels and are restored after."""
        rho, exit_s = trio[0], trio[1]
        log_rho_term = jnp.where(exit_s, 0.0, jnp.log(rho))[None, :]
        valid = (q[:, None] != r_prev[None, :]) & (d_prev[None, :] >= model.u)
        oh_prev = (r_prev[:, None] == regimes[None, :]).astype(dtype)  # (N, R)
        safe = jnp.where(jnp.isfinite(tables.log_P), tables.log_P, -1e30)
        rows = jax.lax.dot(oh_prev, safe, precision=hi_prec)  # (N, R)
        log_p_qn = jnp.where(rows <= -1e29, _NEG_INF, rows).T  # (R=Q, N)
        return jnp.where(valid, log_rho_term + log_p_qn, _NEG_INF), oh_prev

    def _cont_log_density_from(trio_a):
        # Guard rho <= 1 exactly as the C++ does (singleGroup.h:599-605):
        # near the exit latch rho can numerically exceed 1, and log1p(-rho)
        # would be NaN rather than -inf.
        rho, exit_s = trio_a[0], trio_a[1]
        return jnp.where(exit_s | (rho > 1.0), _NEG_INF, jnp.log1p(-rho))

    def _grad_cont_from(trio_a, r_prev):
        """(..., D) gradient of the continuation log-density
        (singleGroup.h:679-698): only the omega (and kappa) entries of the
        previous regime are nonzero, scaled by -rho/(1-rho); zero on exit."""
        rho, exit_s, g_om = trio_a[0], trio_a[1], trio_a[2]
        coef = jnp.where(exit_s | (rho >= 1.0), 0.0, -rho / (1.0 - rho))
        onehot_om = (
            jnp.arange(D)[None, :] == (R * (R - 1) + r_prev)[..., None]
        ).astype(dtype)
        grad = onehot_om * (coef * g_om)[..., None]
        if not model.kappa_fixed:
            g_ka = trio_a[3]
            onehot_ka = (
                jnp.arange(D)[None, :] == (R * R + r_prev)[..., None]
            ).astype(dtype)
            grad = grad + onehot_ka * (coef * g_ka)[..., None]
        return grad

    def _grad_cp_from(tables, trio, oh_prev, d_prev, r_prev, q):
        """(Q, N, D) gradient of the change-point log-density
        (singleGroup.h:655-677): omega entry = grad_omega_log_rho (kept even
        on exit, reference behaviour), P-block entries 1[j==q] - P[r_prev,j];
        zero where the density itself is zero. Row lookups of P and the
        column map ride the one-hot matmuls (exact 0/1 products)."""
        valid = (q[:, None] != r_prev[None, :]) & (d_prev[None, :] >= model.u)
        g_om = trio[2]  # (N,)
        cols = jnp.arange(D)[None, None, :]
        om_col = (R * (R - 1) + r_prev)[None, :, None]
        grad = (cols == om_col).astype(dtype) * g_om[None, :, None]  # (Q,N,D)
        if not model.kappa_fixed:
            g_ka = trio[3]
            ka_col = (R * R + r_prev)[None, :, None]
            grad = grad + (cols == ka_col).astype(dtype) * g_ka[None, :, None]
        # P-row block: scatter values v_j = 1[j==q] - P[r_prev, j], j != r_prev.
        j = jnp.arange(R)
        rows_p = jax.lax.dot(
            oh_prev, tables.P.astype(dtype), precision=hi_prec
        )  # (N, R)
        vals = (
            (j[None, None, :] == q[:, None, None]).astype(dtype)
            - rows_p[None, :, :]
        )  # (Q, N, R)
        # One-hot scatter over the P columns: scat_p[r] selected per particle.
        onehot_p = jnp.einsum(
            "nr,rjd->njd", oh_prev, scat_p, precision=_HIGHEST
        )  # (N, R, D)
        grad = grad + jnp.einsum(
            "qnr,nrd->qnd", vals, onehot_p, precision=_HIGHEST
        )
        return jnp.where(valid[:, :, None], grad, 0.0)

    def step(carry, t, emissions=emissions, t_off=0, t_limit=None):
        # `emissions` is a default-bound closure for the one-shot path (whose
        # caller jits with the table as a traced argument); the CHUNKED path
        # overrides it with a PER-CHUNK slice plus the chunk's site offset,
        # so its own jit neither bakes the (T, R) table in as a multi-MB
        # program constant (a 24 MB literal at T=1e6) nor keys the chunk programs
        # on the chromosome length (chunk-shaped tables -> at most two
        # program shapes per config, any T).
        tables: ThetaTables = carry["tables"]
        d_prev, r_prev, w_prev = carry["d"], carry["r"], carry["w"]

        if config.progress_every:
            # Reference prints "Step t ..." every 1000 sites
            # (OnlineCombinedInference.h:77-85); opt-in because the host
            # callback forces a device sync at each firing.
            jax.lax.cond(
                t % config.progress_every == 0,
                lambda tt: jax.debug.print(
                    "single-group engine: step {}", tt, ordered=False
                ),
                lambda tt: None,
                t,
            )

        # Deterministic particle-count schedule (Smc.h:197-206).
        n_prev = jnp.minimum(R * t, N)
        m_t = jnp.minimum(R * (t + 1), N) - R
        at_capacity = n_prev + R > N

        # ---- resampleCp (Smc.h:406-450) -----------------------------------
        n_finite = jnp.sum(jnp.isfinite(w_prev))
        key = jax.random.fold_in(carry["key"], t)
        # The carried weights are renormalised every step (w_new - shift
        # below), so the resampler runs under the normalized contract; the
        # top-M fallback reuses the resampler's own top_k (the separate
        # keep_top_m was a SECOND full top_k(N, M_cap) per scan step).
        res = optimal_finite_state_resampling(
            key, w_prev.astype(jnp.float32), M_cap, normalized=True
        )
        top_parents = res.top_m_indices
        iota_n = jnp.arange(N)
        w_safe = jnp.where(jnp.isfinite(w_prev), w_prev, -1e30)
        oh_top = (top_parents[:, None] == iota_n[None, :]).astype(dtype)
        top_w_raw = jax.lax.dot(oh_top, w_safe[:, None], precision=hi_prec)[:, 0]
        top_w = jnp.where(top_w_raw <= -1e29, _NEG_INF, top_w_raw)
        # C++ fallback on non-finite log_c keeps top-M (resample.h:366-375),
        # unlike the TF multinomial fallback baked into the op.
        use_optimal = at_capacity & (n_finite > M_cap) & ~res.use_unbiased
        anc = jnp.where(
            at_capacity,
            jnp.where(use_optimal, res.parent_indices, top_parents),
            jnp.arange(M_cap),  # growth phase: identity passthrough
        )
        anc_w = jnp.where(
            at_capacity,
            jnp.where(use_optimal, res.new_log_weights.astype(dtype), top_w),
            w_prev[: M_cap],
        )

        # ---- sampleParticlesCp + computeWeightsCp (Smc.h:504-574) ---------
        # ALL per-slot ancestor lookups ride exact one-hot matmuls instead
        # of (N,)-sized gathers (six such lookups dominated the engine step
        # where this was first built). oh_full maps
        # slots -> resampled-ancestor rows (iota-only), oh_anc maps those
        # rows -> previous-particle columns; their product is the slot ->
        # prev-particle one-hot reused by the mixing matrix below.
        is_cont = slot < m_t
        is_fresh = (slot >= m_t) & (slot < m_t + R)
        anc_full = jnp.clip(jnp.where(is_cont, slot, 0), 0, M_cap - 1)
        oh_full = (anc_full[:, None] == jnp.arange(M_cap)[None, :]).astype(dtype)
        oh_anc = (anc[:, None] == iota_n[None, :]).astype(dtype)  # (M_cap, N)
        oh_a = jax.lax.dot(oh_full, oh_anc, precision=hi_prec)  # (N, N)

        # Hazard trio at every previous particle (ONE stacked row-gather).
        trio = _haz_trio(tables, d_prev, r_prev)
        tri_ext = jnp.stack(
            [trio[0], trio[1].astype(dtype)]
            + [trio[j] for j in range(2, n_haz)]
            + [d_prev.astype(dtype), r_prev.astype(dtype)],
            axis=1,
        )  # (N, n_haz + 2)
        vals_cont = jax.lax.dot(oh_a, tri_ext, precision=hi_prec)
        trio_a = [vals_cont[:, 0], vals_cont[:, 1] > 0.5] + [
            vals_cont[:, j] for j in range(2, n_haz)
        ]
        d_a = vals_cont[:, n_haz].astype(jnp.int32)
        r_a = vals_cont[:, n_haz + 1].astype(jnp.int32)

        d_new = jnp.where(is_cont, d_a + 1, jnp.where(is_fresh, 1, 0)).astype(
            jnp.int32
        )
        r_new = jnp.where(is_cont, r_a, jnp.where(is_fresh, slot - m_t, 0)).astype(
            jnp.int32
        )
        obs_t = emissions[t - t_off].astype(dtype)  # (R,)
        obs_new = jnp.sum(
            jnp.where(r_new[:, None] == regimes[None, :], obs_t[None, :], 0.0),
            axis=-1,
        )
        cont_lp = _cont_log_density_from(trio_a) + obs_new
        anc_w_safe = jnp.where(jnp.isfinite(anc_w), anc_w, -1e30)
        w_anc_full_raw = jax.lax.dot(
            oh_full, anc_w_safe[:, None], precision=hi_prec
        )[:, 0]
        w_anc_full = jnp.where(w_anc_full_raw <= -1e29, _NEG_INF, w_anc_full_raw)
        w_cont = w_anc_full + cont_lp

        # Fresh weights marginalise over all previous particles (Smc.h:561-573).
        cp_lp, oh_prev = _cp_log_density_from(
            tables, trio, d_prev, r_prev, regimes
        )  # (R, N) log f((1,q) | prev_n)
        safe_prev_w = jnp.where(jnp.isfinite(w_prev), w_prev, _NEG_INF)
        w_fresh_q = logsumexp(cp_lp.astype(dtype) + safe_prev_w[None, :], axis=1) + obs_t
        fresh_idx = jnp.clip(slot - m_t, 0, R - 1)
        w_fresh_full = jnp.sum(
            jnp.where(fresh_idx[:, None] == regimes[None, :], w_fresh_q[None, :], 0.0),
            axis=-1,
        )
        w_new = jnp.where(is_cont, w_cont, jnp.where(is_fresh, w_fresh_full, _NEG_INF))
        shift = logsumexp(w_new)
        w_new = w_new - shift
        w_self = jnp.exp(w_new)  # self-normalised weights (dead slots -> 0)
        w_self = jnp.where(jnp.isfinite(w_new), w_self, 0.0)

        # ---- evaluateBackwardKernels (Smc.h:288-326) ----------------------
        logB = cp_lp.astype(dtype) + safe_prev_w[None, :]  # (R, N)
        logBZ = logsumexp(logB, axis=1, keepdims=True)
        B = jnp.where(jnp.isfinite(logBZ), jnp.exp(logB - logBZ), 0.0)  # (R, N)

        # Mixing matrix M[n, j]: the linear map taking any per-particle
        # statistic at t-1 to its value at t — one-hot ancestor columns for
        # continuation slots, backward-kernel columns for fresh slots, zero
        # for dead slots. The psi and phi recursions then become single
        # (.., N) x (N, N) matmuls instead of large gathers.
        cont_onehot = (oh_a * is_cont[:, None].astype(dtype)).T  # (N, N)
        onehot_fresh = (
            (fresh_idx[:, None] == regimes[None, :]) & is_fresh[:, None]
        ).astype(dtype)  # (N, R)
        mix = cont_onehot + jnp.einsum(
            "jq,qn->nj", onehot_fresh, B, precision=_HIGHEST
        )  # (N, N)

        # ---- OnlineMarginalSmoothing::update ------------------------------
        psi, psi_time, psi_valid = carry["psi"], carry["psi_time"], carry["psi_valid"]
        ring, ring_valid, spill = carry["ring"], carry["ring_valid"], carry["spill"]
        ring_mod = ring.shape[0] - 1  # 2 * S_cap slots + sentinel row
        if config.estimate_regimes:
            # updatePsi (:148-195) as one mixing matmul.
            psi_new = jnp.einsum("srn,nj->srj", psi, mix, precision=_HIGHEST)
            psi_new = jnp.where(psi_valid[:, None, None], psi_new, 0.0)

            # initialisePsi for time t: insert into a free ring slot; if full,
            # force-finalise the oldest pending entry first (spill path).
            means_pre = jnp.einsum(
                "srn,n->sr", psi_new, w_self, precision=_HIGHEST
            )  # (S, R)
            has_free = jnp.any(~psi_valid)
            free_slot = jnp.argmax(~psi_valid)
            oldest = jnp.argmin(jnp.where(psi_valid, psi_time, T + 1))
            ins = jnp.where(has_free, free_slot, oldest)
            spill = spill + jnp.where(has_free, 0, 1)
            # Spilled entry's time is in (t - S_cap, t): its ring slot can't
            # collide with slot_t below. jnp.where with a scalar pred over
            # the (2*S_cap, R) ring is a few KB — this select over the old
            # (T, R) buffer was the vmapped engine's dominant per-step cost.
            spill_slot = psi_time[ins] % ring_mod
            ring = jnp.where(
                has_free,
                ring,
                ring.at[spill_slot].set(means_pre[ins].astype(jnp.float32)),
            )
            ring_valid = jnp.where(
                has_free, ring_valid, ring_valid.at[spill_slot].set(True)
            )
            # Inserting time t: clear the ring slot it will finalise into
            # (it currently holds time t - 2*S_cap, already emitted).
            slot_t = t % ring_mod
            ring_valid = ring_valid.at[slot_t].set(False)

            test_t = (r_new[None, :] == regimes[:, None]).astype(dtype) * (
                (is_cont | is_fresh)[None, :]
            ).astype(dtype)
            psi_new = psi_new.at[ins].set(test_t)
            psi_time = psi_time.at[ins].set(t)
            psi_valid = psi_valid.at[ins].set(True)

            # storeEstimates (:197-255): finalise entries whose R variances
            # all drop below epsilon; on the final step finalise everything;
            # entries reaching age S_cap are force-finalised (max-lag cap —
            # guarantees pending times stay in (t - S_cap, t] so the ring
            # emission below is final; counted with the spills).
            means = jnp.einsum("srn,n->sr", psi_new, w_self, precision=_HIGHEST)
            second = jnp.einsum(
                "srn,n->sr", (psi_new - means[:, :, None]) ** 2, w_self,
                precision=_HIGHEST,
            )
            all_below = jnp.all(second < eps, axis=1)
            is_final = t == (T if t_limit is None else t_limit) - 1
            aged = psi_time <= t - S_cap
            spill = spill + jnp.sum(
                psi_valid & aged & ~all_below & ~is_final, dtype=jnp.int32
            )
            fin = psi_valid & (all_below | is_final | aged)
            # Invalid entries (psi_time = T sentinel) scatter into the spare
            # sentinel row, never a live slot.
            slots = jnp.where(psi_valid, psi_time % ring_mod, ring_mod)
            write_vals = jnp.where(
                fin[:, None], means.astype(jnp.float32), ring[slots]
            )
            ring = ring.at[slots].set(write_vals)
            ring_valid = ring_valid.at[slots].set(
                jnp.where(fin, True, ring_valid[slots])
            )
            psi_valid = psi_valid & ~fin
        else:
            # Smoothing disabled (useOnlineMarginalSmoothing false,
            # OnlineCombinedInference.h:89-96): psi machinery is dead weight;
            # pass the (unused) buffers through untouched so XLA elides them.
            psi_new = psi

        # ---- OnlineParameterEstimation::update ----------------------------
        phi = carry["phi"]
        theta = carry["theta"]
        grad_prev = carry["grad_prev"]
        adam_m, adam_v, adam_iter = carry["adam_m"], carry["adam_v"], carry["adam_iter"]
        if config.estimate_parameters:
            # phi recursion via the mixing matmul: the ancestor/backward-mix
            # of phi_prev is mix^T phi_prev; the per-slot gradient increments
            # are added separately (continuation gradients at the ancestor
            # state; fresh gradients B-averaged, Smc-layout of
            # OnlineParameterEstimation.h:135-170).
            g_cont = _grad_cont_from(trio_a, r_a)  # (N, D)
            g_cp = _grad_cp_from(
                tables, trio, oh_prev, d_prev, r_prev, regimes
            )  # (R, N, D)
            g_fresh = jnp.einsum("qn,qnd->qd", B, g_cp, precision=_HIGHEST)  # (R, D)
            grad_term = jnp.where(
                is_cont[:, None],
                g_cont,
                jnp.where(is_fresh[:, None], g_fresh[fresh_idx], 0.0),
            )
            phi_new = jnp.einsum("nj,nd->jd", mix, phi, precision=_HIGHEST) + grad_term
            phi_new = jnp.where((is_cont | is_fresh)[:, None], phi_new, 0.0)
            score = jnp.einsum("nd,n->d", phi_new, w_self, precision=_HIGHEST)
            do_update = (t % config.steps_per_update) == 0
            grad_curr = score
            gradient = grad_curr - grad_prev
            lr = config.learning_rate_factor / jnp.power(
                adam_iter.astype(dtype) + 1.0, config.learning_rate_exponent
            )
            if config.use_adam:
                b1, b2, aeps = 0.9, 0.999, 1e-8
                m2 = b1 * adam_m + (1 - b1) * gradient
                v2 = b2 * adam_v + (1 - b2) * gradient * gradient
                it1 = adam_iter.astype(dtype) + 1.0
                delta = (
                    lr
                    * m2
                    / (jnp.sqrt(v2 / (1.0 - jnp.power(b2, it1))) + aeps)
                    / (1.0 - jnp.power(b1, it1))
                )
            else:
                g = gradient
                if config.normalise_gradients:
                    g = g / jnp.maximum(jnp.sum(jnp.abs(g)), 1e-30)
                m2, v2 = adam_m, adam_v
                delta = lr * g
            theta2 = theta + delta
            theta = jnp.where(do_update, theta2, theta)
            adam_m = jnp.where(do_update, m2, adam_m)
            adam_v = jnp.where(do_update, v2, adam_v)
            adam_iter = adam_iter + jnp.where(do_update, 1, 0)
            grad_prev = jnp.where(do_update, grad_curr, grad_prev)
            # Under shard_map the rebuilt tables derive partly from replicated
            # model constants (unvarying) while the carried tables are
            # varying; promote the rebuild branch so both cond branches have
            # identical VMA types (utils/vma.py).
            from hygeia_tpu.utils.vma import pcast_varying as _pcast

            tables = jax.lax.cond(
                do_update,
                lambda th: jax.tree.map(
                    lambda n, o: _pcast(n, tuple(jax.typeof(o).vma)),
                    build_tables(model, th),
                    tables,
                ),
                lambda th: tables,
                theta,
            )
            phi = phi_new
        else:
            score = carry["score"]

        carry_out = dict(
            d=d_new,
            r=r_new,
            w=w_new,
            psi=psi_new,
            psi_time=psi_time,
            psi_valid=psi_valid,
            ring=ring,
            ring_valid=ring_valid,
            spill=spill,
            phi=phi,
            theta=theta,
            grad_prev=grad_prev,
            adam_m=adam_m,
            adam_v=adam_v,
            adam_iter=adam_iter,
            tables=tables,
            score=score,
            key=carry["key"],
        )
        if t_limit is not None:
            # Ragged batching (vmapped chromosomes of different lengths —
            # the orchestrator's batched theta stage): steps at t >= t_limit
            # freeze the carry wholesale (including the RNG key, so the live
            # prefix is BIT-IDENTICAL to an unbatched run of length t_limit)
            # and contribute zero to the log-normalising constant.
            live = t < t_limit
            carry_out = jax.tree_util.tree_map(
                lambda new, old: jnp.where(live, new, old), carry_out, carry
            )
            theta = carry_out["theta"]
            shift = jnp.where(live, shift, jnp.zeros_like(shift))
        # End-of-step emission: the row for time t - S_cap is final (max-lag
        # cap) and leaves the scan as ys — computed from the (possibly
        # frozen) carry so t_limit runs emit their tail rows correctly while
        # steps past the limit replay stale slots (sliced off by callers).
        te = t - S_cap
        e_slot = te % (carry_out["ring"].shape[0] - 1)
        emit_row = carry_out["ring"][e_slot]
        emit_valid = (te >= 0) & carry_out["ring_valid"][e_slot]
        return carry_out, (theta, shift, emit_row, emit_valid)

    # Initial-step smoothing estimate may finalise immediately; the reference
    # calls storeEstimates at initialise() too (OnlineMarginalSmoothing.h:40-50).
    means0 = jnp.einsum("srn,n->sr", psi0, jnp.exp(w0), precision=_HIGHEST)
    second0 = jnp.einsum(
        "srn,n->sr", (psi0 - means0[:, :, None]) ** 2, jnp.exp(w0), precision=_HIGHEST
    )
    fin0 = psi_valid0 & jnp.all(second0 < eps, axis=1) & (T > 1)
    carry0["ring"] = jnp.where(
        fin0[0],
        carry0["ring"].at[0].set(means0[0].astype(jnp.float32)),
        carry0["ring"],
    )
    carry0["ring_valid"] = carry0["ring_valid"].at[0].set(fin0[0])
    carry0["psi_valid"] = psi_valid0 & ~fin0

    return carry0, step, shift0


def _assemble_regime_outputs(emit_rows, emit_valid, ring, ring_valid, T, S_cap):
    """Reassemble the (T, R) regime-probability table from the per-step ys
    emissions (row t of the scan emitted time t - S_cap) and the final ring
    (which holds the last min(T, S_cap) times). Works on jnp or np arrays;
    static shapes only."""
    ring_mod = ring.shape[0] - 1  # last row is the sentinel spare
    if T <= S_cap:
        idx = jnp.arange(T) % ring_mod
        return ring[idx], ring_valid[idx]
    head = emit_rows[S_cap - 1 :]  # times 0 .. T-1-S_cap
    head_valid = emit_valid[S_cap - 1 :]
    tail_idx = jnp.arange(T - S_cap, T) % ring_mod
    return (
        jnp.concatenate([head, ring[tail_idx]]),
        jnp.concatenate([head_valid, ring_valid[tail_idx]]),
    )


def _result_from_carry(carry_f, theta_init, theta_trace, log_z, probs, valid):
    theta_full = jnp.concatenate([jnp.asarray(theta_init)[None], theta_trace], axis=0)
    return EngineResult(
        regime_probs=probs,
        regime_valid=valid,
        theta_trace=theta_full,
        log_normalizing_constant=log_z,
        spill_count=carry_f["spill"],
        final_theta=carry_f["theta"],
        final_score=carry_f["score"],
        final_opt_state=(
            carry_f["adam_m"],
            carry_f["adam_v"],
            carry_f["adam_iter"],
        ),
    )


def run_online_combined_inference(
    key,
    model: SingleGroupModel,
    theta_init,
    emissions,  # (T, R) emission log-lik table (ops/emissions)
    config: EngineConfig,
    weight_dtype=jnp.float32,
    vma_axes=(),
    t_limit=None,
    adam_init=None,
):
    """Run the combined algorithm over T sites in one scan.

    t_limit (traced scalar, optional): effective chromosome length for
    ragged batching — steps at t >= t_limit freeze the carry (bit-identical
    live prefix to an unbatched run of length t_limit; zero logZ
    contribution), and the adaptive-lag force-finalisation fires at
    t_limit - 1 instead of T - 1. Callers slice outputs to [:t_limit].

    adam_init ((adam_m, adam_v, adam_iter), optional): warm-start the ADAM
    optimizer state — the blocked within-chromosome path seeds every block
    from a sequential warmup chain's final state so the a/(i+1)^b learning
    rate keeps decaying instead of restarting hot. grad_prev intentionally
    stays 0: a fresh block's filtered score accumulates from 0, so its first
    update's gradient (score - 0) is the same per-window score difference
    the sequential chain computes.

    Mirrors OnlineCombinedInference::run (OnlineCombinedInference.h:48-118):
    initialise, then per step: smc.iterate -> evaluateBackwardKernels ->
    smoothing.update -> parameterEstimation.update.

    vma_axes: mesh axis names when running under shard_map with the VMA
    checker on — the deterministic cold-start carry is promoted to varying
    over them (utils/vma.py).
    """
    T = emissions.shape[0]
    carry0, step, shift0 = _prepare_engine(
        key, model, theta_init, emissions, config, weight_dtype
    )
    if adam_init is not None:
        m0, v0, it0 = adam_init
        carry0 = dict(
            carry0,
            adam_m=jnp.asarray(m0, weight_dtype),
            adam_v=jnp.asarray(v0, weight_dtype),
            adam_iter=jnp.asarray(it0, jnp.int32),
        )
    if vma_axes:
        from hygeia_tpu.utils.vma import pcast_varying

        carry0, shift0 = pcast_varying((carry0, shift0), vma_axes)
    ts = jnp.arange(1, T, dtype=jnp.int32)
    if t_limit is None:
        body = step
    else:
        t_lim = jnp.asarray(t_limit, jnp.int32)

        def body(c, t):
            return step(c, t, t_limit=t_lim)

    carry_f, (theta_trace, shifts, emit_rows, emit_valid) = jax.lax.scan(
        body, carry0, ts, unroll=config.scan_unroll
    )
    probs, valid = _assemble_regime_outputs(
        emit_rows, emit_valid, carry_f["ring"], carry_f["ring_valid"],
        T, config.smoothing_window,
    )
    return _result_from_carry(
        carry_f, theta_init, theta_trace, shift0 + jnp.sum(shifts), probs, valid
    )


def run_online_combined_inference_chunked(
    key,
    model: SingleGroupModel,
    theta_init,
    emissions,
    config: EngineConfig,
    *,
    chunk_size,
    checkpoint_path=None,
    resume=True,
    weight_dtype=jnp.float32,
):
    """Chunked variant with intra-run checkpoint/resume.

    Scans ``chunk_size`` sites per device call; after each chunk the full
    engine carry (particles, weights, psi/phi, theta, ADAM moments, hazard
    tables, output buffer, RNG key) plus the theta trace and accumulated
    log-normalising constant are written to ``checkpoint_path`` (.npz). A
    killed run restarted with ``resume=True`` continues from the last
    completed chunk — the analog of Nextflow's -resume, but at CpG-block
    rather than whole-task granularity (SURVEY.md s5 checkpoint/resume).

    Returns the same EngineResult as the one-shot runner. The checkpoint
    file is removed on successful completion.
    """
    import os

    T = emissions.shape[0]
    carry0, step, shift0 = _prepare_engine(
        key, model, theta_init, emissions, config, weight_dtype
    )
    leaves0, treedef = jax.tree_util.tree_flatten(carry0)

    ts_all = np.arange(1, T, dtype=np.int32)
    n_steps = len(ts_all)
    start = 0
    log_z = np.float64(shift0)
    trace_parts = []
    shifts_parts = []
    emit_parts = []
    emit_valid_parts = []

    _CK_VERSION = 2  # v2: ring-buffer smoothing output + emit ys

    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path, allow_pickle=False)
        if (
            int(ck["T"]) == T
            and int(ck["n_leaves"]) == len(leaves0)
            and int(ck.get("version", 1)) == _CK_VERSION
        ):
            leaves0 = [jnp.asarray(ck[f"leaf_{i}"]) for i in range(len(leaves0))]
            start = int(ck["next_step"])
            log_z = np.float64(ck["log_z"])
            if ck["theta_trace"].size:
                trace_parts = [ck["theta_trace"]]
            if ck["shifts"].size:
                shifts_parts = [ck["shifts"]]
            if ck["emit_rows"].size:
                emit_parts = [ck["emit_rows"]]
                emit_valid_parts = [ck["emit_valid"]]
    carry = jax.tree_util.tree_unflatten(treedef, leaves0)

    emissions_arg = jnp.asarray(emissions)

    @jax.jit
    def run_chunk(carry, ts, em_chunk, t0):
        # t0 rides as a TRACED scalar (a static one would re-specialise the
        # program per chunk).
        return jax.lax.scan(
            lambda c, t: step(c, t, em_chunk, t0),
            carry,
            ts,
            unroll=config.scan_unroll,
        )

    while start < n_steps:
        stop = min(start + chunk_size, n_steps)
        t0_site = int(ts_all[start])
        carry, (theta_trace, shifts, emit_rows, emit_valid) = run_chunk(
            carry,
            jnp.asarray(ts_all[start:stop]),
            jax.lax.slice_in_dim(
                emissions_arg, t0_site, int(ts_all[stop - 1]) + 1
            ),
            jnp.asarray(t0_site, jnp.int32),
        )
        jax.block_until_ready(shifts)
        trace_parts.append(np.asarray(theta_trace))
        shifts_parts.append(np.asarray(shifts))
        emit_parts.append(np.asarray(emit_rows))
        emit_valid_parts.append(np.asarray(emit_valid))
        log_z = log_z + np.asarray(shifts, np.float64).sum()
        start = stop
        if checkpoint_path and start < n_steps:
            leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(carry)]
            tmp = str(checkpoint_path) + ".tmp.npz"
            np.savez(
                tmp,
                version=_CK_VERSION,
                T=T,
                n_leaves=len(leaves),
                next_step=start,
                log_z=np.float64(log_z),
                theta_trace=np.concatenate(trace_parts, axis=0),
                shifts=np.concatenate(shifts_parts, axis=0),
                emit_rows=np.concatenate(emit_parts, axis=0),
                emit_valid=np.concatenate(emit_valid_parts, axis=0),
                **{f"leaf_{i}": l for i, l in enumerate(leaves)},
            )
            os.replace(tmp, checkpoint_path)

    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    theta_trace = (
        jnp.asarray(np.concatenate(trace_parts, axis=0))
        if trace_parts
        else jnp.zeros((0, len(np.asarray(theta_init))), weight_dtype)
    )
    R = emissions.shape[1]
    emit_rows_all = (
        np.concatenate(emit_parts, axis=0)
        if emit_parts
        else np.zeros((0, R), np.float32)
    )
    emit_valid_all = (
        np.concatenate(emit_valid_parts, axis=0)
        if emit_valid_parts
        else np.zeros((0,), bool)
    )
    probs, valid = _assemble_regime_outputs(
        emit_rows_all,
        emit_valid_all,
        np.asarray(carry["ring"]),
        np.asarray(carry["ring_valid"]),
        T,
        config.smoothing_window,
    )
    return _result_from_carry(
        carry, jnp.asarray(theta_init, weight_dtype), theta_trace,
        jnp.asarray(log_z), probs, valid,
    )
