"""Marginal-filter variant: two-group filtering with adaptive-lag online
marginal smoothing — constant memory in T.

The production path (filter.py + backward.py) stores the full (T, N) history
for backward simulation. This variant instead propagates per-pending-time
smoothing statistics psi through the backward kernels

    B_t(n, j) propto w_{t-1}^j * f(x_t^n | x_{t-1}^j)

finalising a time's estimates once the filtered variance of all its test
functions drops below epsilon — the reference's marginal-filter pair
(particle_filter_deterministic_proposal.py + smoothing_functions.py:63-202,
compute_log_backward_kernel :27-44), with the bounded ring buffer of the
single-group engine replacing the unbounded pending list.

Test functions (run_inference_two_groups.py:233-240): F = 1 + 2R columns —
split indicator, R control-regime indicators, R case-regime indicators.

The psi recursion is one (S*F, N) x (N, N) matmul per site — unlike the rest
of the pipeline this path is matmul-heavy, and it is the memory-safe choice
for very long unsegmented scans.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from hygeia_tpu.two_group.model import State, TwoGroupParams
from hygeia_tpu.two_group.backward import _backward_logits
from hygeia_tpu.two_group.filter import _first_step, _one_step
from hygeia_tpu.two_group.proposal import num_children

# Every f32 contraction names its precision: on a GPU the default runs f32
# matmuls in TF32 (10-bit mantissa); the one-hot lookups must stay exact and
# the psi/phi recursions compound rounding over every site.
_HIGHEST = jax.lax.Precision.HIGHEST

_NEG_INF = -jnp.inf


class MarginalResult(NamedTuple):
    functionals: jnp.ndarray  # (T, 1 + 2R): split prob, control regs, case regs
    valid: jnp.ndarray  # (T,) bool
    log_normalizing_constant: jnp.ndarray
    spill_count: jnp.ndarray


def _test_functions(state: State, n_regimes):
    """(F, N) indicator matrix for the smoothing functionals."""
    split = (state.m == 0).astype(jnp.float32)[None, :]
    regs = jnp.arange(n_regimes)[:, None]
    ctrl = (state.r_c[None, :] == regs).astype(jnp.float32)
    case = (state.r_k[None, :] == regs).astype(jnp.float32)
    return jnp.concatenate([split, ctrl, case], axis=0)


def _compact_rep(f, R, M):
    """Full (N = I*M) per-particle array -> the C = 2R*M + R*R compact
    column layout: the first 2R*M columns map identity (cont / ctrl-CP /
    case-CP / merge slots, one per (slot, ancestor)), the R*R independent
    proposal classes take their m = 0 representative — exact for any
    STATE-DERIVED quantity because every class member carries the same
    static state (proposal.expand_states: indep children are ancestor-
    independent)."""
    C0 = 2 * R * M
    return jnp.concatenate([f[:C0], f[C0:].reshape(R * R, M)[:, 0]])


def _compact_sum(f, R, M):
    """Weight-like quantities sum over each indep class (the backward kernel
    marginalises w_j over state-equal predecessors)."""
    C0 = 2 * R * M
    return jnp.concatenate([f[:C0], f[C0:].reshape(R * R, M).sum(-1)])


def num_compact_columns(R, M):
    return 2 * R * M + R * R


def _structured_psi_update(
    params: TwoGroupParams, prev: State, lw_prev, anc: State, psi,
):
    """psi @ B_norm^T over the FULL (N,) column layout.

    Thin wrapper over the compact core: compacts psi by class-weighted
    average (exact — within an indep class the kernel column is
    w_j * h(state), so sum_j psi_j G_j = h * sum_j psi_j w_j), runs the
    compact update, and re-expands. The marginal filter itself carries psi
    compactly and calls the core directly; this wrapper exists for the
    equivalence tests against the generic (N, N) einsum.
    """
    R = params.n_regimes
    M = anc.m.shape[0]
    C0 = 2 * R * M
    f32 = psi.dtype
    w = jnp.where(jnp.isfinite(lw_prev), jnp.exp(lw_prev), 0.0).astype(f32)
    wt = w[C0:].reshape(R * R, M)
    wsum = wt.sum(-1)
    tail = jnp.einsum(
        "sfkm,km->sfk",
        psi[..., C0:].reshape(psi.shape[:-1] + (R * R, M)),
        wt, precision=_HIGHEST,
    )
    tail = jnp.where(
        wsum > 0.0, tail / jnp.where(wsum > 0.0, wsum, 1.0), 0.0
    )
    psi_c = jnp.concatenate([psi[..., :C0], tail], axis=-1)
    out_c = _structured_psi_update_compact(
        params, prev, w, anc, psi_c
    )
    head = out_c[..., :C0]
    ind = jnp.broadcast_to(
        out_c[..., C0:, None], out_c.shape[:-1] + (R * R, M)
    ).reshape(out_c.shape[:-1] + (R * R * M,))
    return jnp.concatenate([head, ind], axis=-1)


def _structured_psi_update_compact(
    params: TwoGroupParams, prev: State, w_full, anc: State, psi_c,
):
    """psi_c @ B_norm^T without materialising the (N, N) backward kernel —
    psi carried over the C = 2R*M + R*R COMPACT column layout.

    The generic path evaluates the ~50-op transition branch tree on the full
    (N_new, N_prev) = 5.76M-entry grid every site. But the
    new particle set has (I, M) child structure (proposal.expand_states), so
    every child ROW of B factorises into per-prev-j scalars x small equality
    masks keyed on the child's ANCESTOR fields x (at most) one rank-R regime
    factor:

      cont (slot 0)       predecessors must match the ancestor's control pair
                          exactly (continuation support); merged children
                          need ONLY the control match (branch a constrains
                          the next state, not the predecessor), unmerged
                          children add the case match. One (M, N) column set.
      ctrl-CP (R-1)       control side marginalises over ALL prev (rho_c_j *
                          P[r_c_j, r']); case side pins (d_k, r_k) to the
                          ancestor. The in_c exclusion (r' == r_k_j) can
                          never bind under the case mask because the slot
                          regime enumerates {0..R-1}\\{r_k_anc}. Rank-R via
                          the r_c one-hot: (M*R, N) columns, the P factor
                          applied after the matmul.
      case-CP (R-1)       control continuation mask + a case factor that
                          depends on prev only through (m_j, rho_k_j, r_k_j):
                          merged prev -> forced-split 1/(R-1) (in_b, since
                          nxt.d_c >= 2); unmerged prev -> rho_k_j *
                          1[q != r_k_j]/(R-2) (the in_c collision cannot
                          fire: it needs r_k_j == r_c_j, impossible for live
                          unmerged states). 1[q != r_k_j] = full r_k-one-hot
                          sum minus the q column: (M + M*R, N) columns.
      merge (slot 2R-1)   control match + chain-to-merged: (M, N) columns
                          (zeroed for merged ancestors, whose merge children
                          are dead — proposal.py merge_dur=0).
      indep (R*R)         children are STATIC states shared by all ancestors:
                          build the (R*R, N) rows densely (86k entries of
                          cheap arithmetic) and replicate the result over M.

    One (S*F + 1, N) x (N, C~=786) matmul (the +1 ones-row produces the row
    denominators) replaces the 5.76M-entry tree + the (S*F, N) x (N, N)
    einsum. Rows whose denominator is 0 (dead children) return psi = 0,
    matching the generic path's non-finite-logsumexp guard. Equivalence with
    the einsum-over-_backward_logits path on live children is covered by
    tests/test_marginal_filter.py::test_structured_psi_update_matches_generic.

    Reference scope: same quantity as smoothing_functions.py:27-59's
    backward kernel applied to the psi recursion (:85); the structure is a
    redesign with no reference counterpart.
    """
    from hygeia_tpu.two_group.backward import _structured_rho

    R = params.n_regimes
    M = anc.m.shape[0]
    SF = psi_c.shape[0] * psi_c.shape[1]
    f32 = psi_c.dtype
    hi = jax.lax.Precision.HIGHEST

    # Per-prev-particle scalars. The hazard lookup needs the FULL (I, M)
    # history layout (_structured_rho); rho and the weights are then
    # compacted — weights SUM over each indep class (kernel marginalisation),
    # state-derived scalars take the class representative.
    rho_c_f, rho_k_f = _structured_rho(params, prev)
    rho_c = _compact_rep(rho_c_f.astype(f32), R, M)
    rho_k = _compact_rep(rho_k_f.astype(f32), R, M)
    w = _compact_sum(w_full.astype(f32), R, M)
    prevc = State(*(_compact_rep(f, R, M) for f in prev))
    N = prevc.m.shape[0]  # compact column count C
    one_m_rc = 1.0 - rho_c
    gate = jnp.minimum(prevc.d_k, prevc.d_c) >= params.min_duration
    pm = jnp.exp(params.log_p_merged).astype(f32)
    m0 = (prevc.m == 0).astype(f32)
    m1 = (prevc.m == 1).astype(f32)
    to0 = jnp.where(prevc.m == 0, pm[0, 0], pm[1, 0])
    to1 = jnp.where(prevc.m == 0, pm[0, 1], pm[1, 1])
    chain0 = jnp.where(gate, to0, m0)  # P(m -> 0 | prev), incl. the gate
    chain1 = jnp.where(gate, to1, m1)
    regs = jnp.arange(R)
    oh_rc = (prevc.r_c[:, None] == regs).astype(f32)  # (C, R)
    oh_rk = (prevc.r_k[:, None] == regs).astype(f32)
    P = jnp.where(
        jnp.isfinite(params.log_p_control), jnp.exp(params.log_p_control), 0.0
    ).astype(f32)
    Prow = jax.lax.dot(oh_rc, P, precision=hi)  # (N, R): P[r_c_j, :]

    maskC = (
        (prevc.d_c[None, :] == anc.d_c[:, None])
        & (prevc.r_c[None, :] == anc.r_c[:, None])
    ).astype(f32)  # (M, C)
    maskK = (
        (prevc.d_k[None, :] == anc.d_k[:, None])
        & (prevc.r_k[None, :] == anc.r_k[:, None])
    ).astype(f32)

    # --- column operands (C, N) ---------------------------------------------
    anc_merged = (anc.m == 1)[:, None]
    col_cont = (w * one_m_rc)[None, :] * maskC * jnp.where(
        anc_merged,
        chain1[None, :],
        (chain0 * (1.0 - rho_k) * m0)[None, :] * maskK,
    )
    col_merge = (w * chain1 * one_m_rc)[None, :] * maskC * (anc.m == 0)[:, None]
    cC = w * chain0 * rho_c * (1.0 - rho_k)
    colH1 = (cC[None, None, :] * maskK[:, None, :]) * oh_rc.T[None, :, :]  # (M,R,N)
    # R - 2 guards R == 2 (the branch's indicator is then identically 0 and
    # 0 * finite == 0, where 0 * inf would be NaN).
    Rm2 = float(max(R - 2, 1))
    a1 = w * chain0 * one_m_rc * m1 / float(R - 1)
    colT1 = a1[None, :] * maskC
    a2 = w * chain0 * one_m_rc * rho_k * m0 / Rm2
    colH2 = (a2[None, None, :] * maskC[:, None, :]) * oh_rk.T[None, :, :]  # (M,R,N)

    kk = np.arange(R * R)
    i_idx, q_idx = kk // R, kk % R
    Prow_i = Prow.T[i_idx]  # (R*R, N) static gather over a host index
    eq_rk_i = oh_rk.T[i_idx]  # (R*R, N): 1[r_k_j == i]
    neq_rk_q = 1.0 - oh_rk.T[q_idx]
    n_opts = jnp.where(eq_rk_i == 1.0, float(R - 1), Rm2)
    casefac = jnp.where(
        (m0[None, :] == 1.0) & (eq_rk_i == 1.0),
        1.0 / float(R - 1),
        rho_k[None, :] * neq_rk_q / n_opts,
    )
    col_ind = (
        (w * rho_c)[None, :]
        * Prow_i
        * jnp.where(
            (i_idx == q_idx)[:, None], chain1[None, :], chain0[None, :] * casefac
        )
    )  # (R*R, N)

    G = jnp.concatenate(
        [
            col_cont,  # M
            colH1.reshape(M * R, N),  # M*R
            colT1,  # M
            colH2.reshape(M * R, N),  # M*R
            col_merge,  # M
            col_ind,  # R*R
        ],
        axis=0,
    )
    SFp = SF + 1
    psi_aug = jnp.concatenate(
        [psi_c.reshape(SF, N), jnp.ones((1, N), f32)], axis=0
    )
    # Materialise G before the dot: without the barrier XLA fuses the whole
    # column build into the dot's operand load and recomputes it per psi
    # row-tile, making the matmul scale like S_cap * (operand build) instead
    # of S_cap * MACs.
    G = jax.lax.optimization_barrier(G)
    Y = jax.lax.dot(psi_aug, G.T, precision=_HIGHEST)

    off = 0
    y_cont = Y[:, off : off + M]; off += M
    H1 = Y[:, off : off + M * R].reshape(SFp, M, R); off += M * R
    yT1 = Y[:, off : off + M]; off += M
    H2 = Y[:, off : off + M * R].reshape(SFp, M, R); off += M * R
    y_merge = Y[:, off : off + M]; off += M
    y_ind = Y[:, off : off + R * R]

    # ctrl-CP: apply the P[., r'(s, m)] factor post-matmul (one-hot, exact).
    sA = jnp.arange(R - 1, dtype=jnp.int32)[:, None]
    ctrl_regime = jnp.where(sA < anc.r_k[None, :], sA, sA + 1)  # (R-1, M)
    oh_ctrl = (ctrl_regime[..., None] == regs).astype(f32)  # (R-1, M, R)
    P_sel = jnp.einsum("smr,xr->smx", oh_ctrl, P, precision=_HIGHEST)  # P[x, r'(s,m)]
    y_ctrl = jnp.einsum("zmx,smx->zsm", H1, P_sel, precision=_HIGHEST)

    # case-CP: T1 (q-independent) + sum_y H2 - H2 at y = q(s, m).
    jB = jnp.arange(R - 1, dtype=jnp.int32)[:, None]
    case_regime = jnp.where(jB < anc.r_c[None, :], jB, jB + 1)  # (R-1, M)
    oh_case = (case_regime[..., None] == regs).astype(f32)
    H2_sel = jnp.einsum("zmy,smy->zsm", H2, oh_case, precision=_HIGHEST)
    y_case = (yT1 + H2.sum(-1))[:, None, :] - H2_sel

    num = jnp.concatenate(
        [
            jnp.concatenate(
                [y_cont[:, None, :], y_ctrl, y_case, y_merge[:, None, :]],
                axis=1,
            ).reshape(SFp, 2 * R * M),  # slot-major, matching n = i*M + m
            y_ind,  # one column per indep class
        ],
        axis=1,
    )  # (SFp, C)
    denom = num[-1]
    psi_new = jnp.where(
        denom[None, :] > 0.0, num[:-1] / jnp.where(denom > 0.0, denom, 1.0), 0.0
    )
    return psi_new.reshape(psi_c.shape)


def run_marginal_filter(
    key,
    params: TwoGroupParams,
    emission_control,
    emission_case,
    num_resampled_ancestors: int,
    *,
    epsilon=0.01,
    smoothing_window=64,
    weight_dtype=jnp.float32,
    structured=True,
):
    R = params.n_regimes
    M = num_resampled_ancestors
    N = M * num_children(R)
    T = emission_control.shape[0]
    F = 1 + 2 * R
    S_cap = smoothing_window
    dtype = weight_dtype

    key, k0 = jax.random.split(key)
    lw0, st0 = _first_step(k0, params, emission_control, emission_case, N, dtype)
    shift0 = logsumexp(lw0)
    lw0 = lw0 - shift0
    w_self0 = jnp.where(jnp.isfinite(lw0), jnp.exp(lw0), 0.0)

    # Structured mode carries psi over the COMPACT column layout (C =
    # 2R*M + R*R instead of N = I*M = 2R*M + R*R*M): the R*R independent
    # proposal children are ancestor-independent STATES shared by all M
    # ancestors, so their psi columns are provably equal — storing one
    # column per class shrinks the buffer (the step's memory-traffic driver)
    # ~3.8x at the production M = 50. Exact, not approximate; the first
    # step's R*R live initial particles occupy full positions < 2R*M and
    # ride the identity part of the mapping.
    C = num_compact_columns(R, M) if structured else N
    st0_cols = State(*(_compact_rep(f, R, M) for f in st0)) if structured else st0
    psi0 = jnp.zeros((S_cap, F, C), jnp.float32)
    psi0 = psi0.at[0].set(_test_functions(st0_cols, R))
    psi_time0 = jnp.full((S_cap,), T, jnp.int32).at[0].set(0)
    psi_valid0 = jnp.zeros((S_cap,), bool).at[0].set(True)
    out0 = jnp.zeros((T + 1, F), jnp.float32)
    out_valid0 = jnp.zeros((T + 1,), bool)

    def step(carry, inputs):
        lw, prev_state, psi, psi_time, psi_valid, out, out_valid, spill = carry
        t, k = inputs
        new_lw, new_state, parents = _one_step(
            k, params, emission_control, emission_case, t, lw,
            prev_state, M, True, False, with_parents=True,
        )
        shift = logsumexp(new_lw)
        new_lw = new_lw - shift
        # Cast to the psi/out dtype (f32): with f64 weights the means would
        # otherwise promote and the out-buffer scatter would downcast.
        # In compact mode the filtered-mean weights SUM over each indep
        # class (psi is class-constant there, so the weighted mean is
        # unchanged — exact).
        w_self = jnp.where(jnp.isfinite(new_lw), jnp.exp(new_lw), 0.0).astype(
            jnp.float32
        )
        if structured:
            w_self = _compact_sum(w_self, R, M)
            new_cols = State(*(_compact_rep(f, R, M) for f in new_state))
        else:
            new_cols = new_state

        # The psi buffer (S_cap, F, N) is the marginal step's device-memory
        # footprint (~8 MB/unit at window 64), so every full-buffer pass is
        # a round trip to device memory and the step is traffic-bound in the
        # window size. Passes are kept to: the update's matmul read, the
        # carry write, and ONE fused read for the means/sum-of-squares
        # reductions.
        if structured:
            # Structured psi update: the (I, M) child layout collapses the
            # (N, N) backward-kernel grid to masked low-rank column
            # operands — see _structured_psi_update.
            # The update is row-linear in psi, so the validity mask is
            # applied to the INPUT rows (fused into the matmul's operand
            # load) instead of as an extra pass over the output.
            anc = State(*(f[parents] for f in prev_state))
            psi_in = jnp.where(psi_valid[:, None, None], psi, 0.0)
            w_prev = jnp.where(jnp.isfinite(lw), jnp.exp(lw), 0.0).astype(
                jnp.float32
            )
            psi_new = _structured_psi_update_compact(
                params, prev_state, w_prev, anc, psi_in
            )
        else:
            # Generic path (the oracle of the structured update):
            # backward kernels over the full (N_new x N_prev) grid via the
            # backward-specialised kernel (backward._backward_logits).
            logB = _backward_logits(
                params, prev_state, new_state, lw, history_layout=True
            )
            logBZ = logsumexp(logB, axis=1, keepdims=True)
            B = jnp.where(
                jnp.isfinite(logBZ), jnp.exp(logB - logBZ), 0.0
            ).astype(jnp.float32)
            # psi recursion: (S, F, N_prev) x (N_new, N_prev)^T.
            psi_in = jnp.where(psi_valid[:, None, None], psi, 0.0)
            psi_new = jnp.einsum("sfj,nj->sfn", psi_in, B, precision=_HIGHEST)

        # Ring-buffer insert for time t (force-finalise oldest on overflow).
        # Only the victim ROW's filtered mean is needed — a (F, N) einsum,
        # not a full-buffer pass.
        has_free = jnp.any(~psi_valid)
        ins = jnp.where(
            has_free,
            jnp.argmax(~psi_valid),
            jnp.argmin(jnp.where(psi_valid, psi_time, T + 1)),
        )
        means_ins = jnp.einsum("fn,n->f", psi_new[ins], w_self, precision=_HIGHEST)
        spill = spill + jnp.where(has_free, 0, 1)
        out = jnp.where(
            has_free, out, out.at[psi_time[ins]].set(means_ins)
        )
        out_valid = jnp.where(
            has_free, out_valid, out_valid.at[psi_time[ins]].set(True)
        )
        psi_new = psi_new.at[ins].set(_test_functions(new_cols, R))
        psi_time = psi_time.at[ins].set(t)
        psi_valid = psi_valid.at[ins].set(True)

        # Finalisation: all F filtered variances below epsilon (or last step).
        # var = E[x^2] - E[x]^2 lets XLA fuse both reductions into one read
        # of the buffer; x in [0, 1] so the f32 cancellation error (~1e-7
        # absolute) is far below any usable epsilon.
        means = jnp.einsum("sfn,n->sf", psi_new, w_self, precision=_HIGHEST)
        sumsq = jnp.einsum("sfn,n->sf", psi_new * psi_new, w_self, precision=_HIGHEST)
        var = sumsq - means * means
        fin = psi_valid & (jnp.all(var < epsilon, axis=1) | (t == T - 1))
        out = out.at[psi_time].set(jnp.where(fin[:, None], means, out[psi_time]))
        out_valid = out_valid.at[psi_time].set(
            jnp.where(fin, True, out_valid[psi_time])
        )
        psi_valid = psi_valid & ~fin

        carry = (
            new_lw, new_state, psi_new, psi_time, psi_valid,
            out, out_valid, spill,
        )
        return carry, shift

    keys = jax.random.split(key, T - 1)
    carry0 = (
        lw0, st0, psi0, psi_time0, psi_valid0, out0, out_valid0,
        jnp.zeros((), jnp.int32),
    )
    # ts must be int32: psi_time is an int32 buffer and `.at[ins].set(t)`
    # with a default-int64 t (x64 test config) is an unsafe downcast.
    carry_f, shifts = jax.lax.scan(
        step, carry0, (jnp.arange(1, T, dtype=jnp.int32), keys)
    )
    (_, _, _, _, _, out, out_valid, spill) = carry_f
    return MarginalResult(
        functionals=out[:T],
        valid=out_valid[:T],
        log_normalizing_constant=shift0 + jnp.sum(shifts),
        spill_count=spill,
    )
