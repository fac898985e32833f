"""Case/control (merged/split) change-point regime model as pure functions.

Re-design of the reference's TFP distribution classes
(case_control_regime_model.py, case_control_distributions.py): the latent
state is a 5-tuple of int arrays

    State = (m, d_c, r_c, d_k, r_k)
      m   in {0,1}  : merged indicator (1 = case copies control)
      d_c, r_c      : control (sojourn, regime)
      d_k, r_k      : case (sojourn, regime)

and the transition density is one fully-vectorised branch tree (jnp.where)
over broadcastable arrays — no Distribution objects, no per-particle loops.
Hazards come from precomputed (R, D_max) tables (ops/hazard.rho_two_group).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from hygeia_tpu.ops.distributions import (
    inv_logit,
    mu_sigma_to_alpha_beta,
)
from hygeia_tpu.ops.hazard import rho_two_group, gather_rho

_NEG_INF = -jnp.inf


class State(NamedTuple):
    """Batch of latent states; all fields share a broadcastable int32 shape."""

    m: jnp.ndarray
    d_c: jnp.ndarray
    r_c: jnp.ndarray
    d_k: jnp.ndarray
    r_k: jnp.ndarray

    def stack(self):
        """Pack into (5, ...) int32 — storage layout for the filter history.

        The field axis LEADS: tiled device layouts pad the last dimension,
        so a trailing length-5 axis can pad many times over. With (5, N)
        blocks the last dim is the particle axis and packs densely.

        Field order [m, d_c, r_c, d_k, r_k]; external outputs (npz files)
        transpose back to the reference's (duration, regime) pair layout
        (aggregate_results.py:139-142)."""
        return jnp.stack(
            [self.m, self.d_c, self.r_c, self.d_k, self.r_k], axis=0
        ).astype(jnp.int32)

    @staticmethod
    def unstack(arr):
        return State(arr[0], arr[1], arr[2], arr[3], arr[4])


class TwoGroupParams(NamedTuple):
    """Model parameters (all device arrays; n_regimes/min_duration static)."""

    n_regimes: int
    min_duration: int
    mu: jnp.ndarray  # (R,)
    sigma: jnp.ndarray  # (R,)
    alpha: jnp.ndarray  # (R,)
    beta: jnp.ndarray  # (R,)
    log_p_control: jnp.ndarray  # (R, R) log transition probs, -inf diagonal
    log_p_merged: jnp.ndarray  # (2, 2) log merged-indicator transition probs
    rho_control: jnp.ndarray  # (R, D_max) hazard table for the control group
    rho_case: jnp.ndarray  # (R, D_max) hazard table for the case group


def make_params(
    *,
    mu,
    sigma,
    p_softmax_control,
    omega_logit_control,
    omega_case,
    kappa_control,
    kappa_case,
    merge_log_prob,
    split_prob,
    minimum_duration,
    d_max,
    dtype=jnp.float32,
):
    """Build TwoGroupParams exactly the way run_inference_two_groups.py does.

    Args mirror the reference CLI (run_inference_two_groups.py:19-73,110-167):
      p_softmax_control: (R, R) log-probabilities of the control regime
        transition matrix (rows normalised over off-diagonals, -inf diag), as
        produced from the single-group theta file
        (get_estimated_control_group_param, :76-89).
      omega_logit_control: (R,) theta components logit(omega) from the
        single-group fit. The reference applies inv_logit twice and the model
        applies one logit, so the *effective* NB success probability is
        inv_logit(omega_logit_control) (:144-150 with :117-119).
      omega_case: scalar; effective NB success probability for the case group
        (flag default 0.8; the double transform cancels identically).
      merge_log_prob / split_prob: the 2x2 merged-indicator chain
        (:164-167), rows [[1-pm, pm], [ps, 1-ps]].
    """
    mu = jnp.asarray(mu, dtype)
    sigma = jnp.asarray(sigma, dtype)
    R = int(mu.shape[0])
    alpha, beta = mu_sigma_to_alpha_beta(mu, sigma)

    logp = jnp.asarray(p_softmax_control, dtype)
    # Renormalise rows over off-diagonal entries with -inf diagonal, matching
    # _next_regime_control_probs (case_control_regime_model.py:90-94).
    logp = jnp.where(jnp.eye(R, dtype=bool), _NEG_INF, logp)
    logp = logp - jax_logsumexp(logp, axis=1, keepdims=True)

    pm = np.exp(merge_log_prob)
    ps = split_prob
    log_p_merged = jnp.asarray(
        np.log(np.array([[1.0 - pm, pm], [ps, 1.0 - ps]])), dtype
    )

    omega_control_eff = inv_logit(jnp.asarray(omega_logit_control, dtype))
    omega_case_eff = jnp.asarray(omega_case, dtype) * jnp.ones((R,), dtype)

    rho_c = rho_two_group(
        jnp.asarray(kappa_control, dtype), omega_control_eff, minimum_duration, d_max
    )
    rho_k = rho_two_group(
        jnp.asarray(kappa_case, dtype), omega_case_eff, minimum_duration, d_max
    )
    return TwoGroupParams(
        n_regimes=R,
        min_duration=int(minimum_duration),
        mu=mu,
        sigma=sigma,
        alpha=alpha,
        beta=beta,
        log_p_control=logp,
        log_p_merged=log_p_merged,
        rho_control=rho_c,
        rho_case=rho_k,
    )


def jax_logsumexp(x, axis=None, keepdims=False):
    import jax.scipy.special as jsp

    return jsp.logsumexp(x, axis=axis, keepdims=keepdims)


def _log_indicator(cond):
    return jnp.where(cond, 0.0, _NEG_INF)


# Sentinel standing in for -inf during the one-hot matmul lookup below; any
# result at or below _RESTORE_INF is mapped back to -inf (genuine transition
# log-probs are orders of magnitude above it).
_SAFE_NEG = -1e30
_RESTORE_INF = -1e29


def _lookup_log_p(log_p, r_prev, r_nxt, R):
    """log_p[r_prev, r_nxt] for broadcastable int batches, gather-free.

    A table gather keyed on a particle axis can lower to an XLA scalar loop
    — inside the backward scan a per-step cost. Instead: one-hot
    select-reduce with -inf encoded as -1e30
    so the products stay exact (one nonzero term per output), then restored.
    Out-of-range indices (the -1 padding particles) yield all-zero one-hots
    and a result of -inf; every consumer masks those slots by their -inf
    weights anyway.
    """
    regs = jnp.arange(R)
    safe = jnp.where(jnp.isfinite(log_p), log_p, _SAFE_NEG)
    oh_prev = (r_prev[..., None] == regs).astype(safe.dtype)
    oh_nxt = (r_nxt[..., None] == regs).astype(safe.dtype)
    # tmp[..., i] = safe[i, r_nxt[...]]. HIGHEST precision keeps the f32
    # table from being rounded to TF32/bf16 — the one-hot operand makes the
    # full-precision product exact (one nonzero term per output).
    tmp = jnp.einsum(
        "...j,ij->...i", oh_nxt, safe, precision=jax.lax.Precision.HIGHEST
    )
    val = jnp.sum(oh_prev * tmp, axis=-1)
    # All-zero one-hot rows (padding) produce 0 with no mass selected; send
    # them to -inf along with restored sentinel values.
    dead = jnp.sum(oh_prev, axis=-1) * jnp.sum(oh_nxt, axis=-1) == 0
    return jnp.where((val <= _RESTORE_INF) | dead, _NEG_INF, val)


def transition_log_prob(
    params: TwoGroupParams,
    prev: State,
    nxt: State,
    *,
    step0=False,
    rho_c=None,
    rho_k=None,
):
    """log f(nxt | prev), fully vectorised over broadcastable State batches.

    Mirrors, branch for branch:
      merged chain     — _next_merged_state_probs (case_control_regime_model.py:80-87)
      control          — ControlStateTransition._log_prob (case_control_distributions.py:138-151)
      case (4 branches)— CaseStateTransition._log_prob (case_control_distributions.py:246-291)

    step0=True applies the phantom-state overrides: merged probs [[0,1],[0,1]]
    and rho == 1 (case_control_regime_model.py:84,136,166).

    rho_c / rho_k: optional precomputed hazards at the PREV states (same
    broadcast shape as prev.d_c). The backward pass evaluates this density
    against the stored particle history every step; the hazards depend only
    on prev, so it hoists the table lookups out of its scan and passes them
    here (two (T, N) gathers total instead of two (N,) gathers per step).

    This function performs NO table gathers keyed on a large batch axis —
    the merged rows are a 2-way select, the control transition row is a
    one-hot x one-hot matmul sandwich (exact: one nonzero term per output),
    and the hazards are either precomputed or gathered at small prev shapes
    by gather_rho. Large (next x prev)-shaped gathers were the dominant cost
    of the backward pass where this was first built.
    """
    R = params.n_regimes
    dtypef = params.rho_case.dtype

    # --- merged indicator --------------------------------------------------
    gate = jnp.minimum(prev.d_k, prev.d_c) >= params.min_duration
    # prev.m is binary: select between the two rows instead of gathering.
    lpm = params.log_p_merged  # (2, 2)
    lp_chain = jnp.where(
        nxt.m == 0,
        jnp.where(prev.m == 0, lpm[0, 0], lpm[1, 0]),
        jnp.where(prev.m == 0, lpm[0, 1], lpm[1, 1]),
    )
    lp_identity = _log_indicator(nxt.m == prev.m)
    if step0:
        lp_m = _log_indicator(nxt.m == 1)
    else:
        lp_m = jnp.where(gate, lp_chain, lp_identity)

    # --- control state -----------------------------------------------------
    if step0:
        rho_c = jnp.ones_like(prev.d_c, params.rho_control.dtype)
    elif rho_c is None:
        rho_c = gather_rho(params.rho_control, prev.d_c, prev.r_c)
    lp_p_ctrl = _lookup_log_p(params.log_p_control, prev.r_c, nxt.r_c, R)
    lp_ctrl_cp = jnp.log(rho_c) + lp_p_ctrl
    lp_ctrl_cont = (
        jnp.log1p(-rho_c)
        + _log_indicator(prev.d_c == nxt.d_c - 1)
        + _log_indicator(prev.r_c == nxt.r_c)
    )
    lp_c = jnp.where(nxt.d_c == 1, lp_ctrl_cp, lp_ctrl_cont)

    # --- case state --------------------------------------------------------
    if step0:
        rho_k = jnp.ones_like(prev.d_k, params.rho_case.dtype)
    elif rho_k is None:
        rho_k = gather_rho(params.rho_case, prev.d_k, prev.r_k)

    # Branch a: currently merged -> case is an exact copy of control.
    lp_a = _log_indicator((nxt.r_k == nxt.r_c) & (nxt.d_k == nxt.d_c))

    # Uniform log-prob over regimes != nxt.r_c (R-1 options).
    lp_unif_not_c = _log_indicator(nxt.r_k != nxt.r_c) - jnp.log(float(R - 1))
    # Branch b: just unmerged (prev merged, control did not jump): forced case
    # jump, uniform over regimes != current control regime.
    lp_b = lp_unif_not_c + _log_indicator(nxt.d_k == 1)

    # Branches c/d regime factor: uniform over regimes excluding both the
    # current control regime and the previous case regime. n_opts is R-1 or
    # R-2 only — select between the two precomputed logs instead of a
    # (next x prev)-shaped transcendental.
    log_n_opts = jnp.where(
        nxt.r_c != prev.r_k,
        jnp.log(jnp.asarray(R - 2, dtypef)),
        jnp.log(jnp.asarray(R - 1, dtypef)),
    )
    lp_unif_not_c_not_prev = (
        _log_indicator((nxt.r_k != nxt.r_c) & (nxt.r_k != prev.r_k))
        - log_n_opts
    )
    # Branch c: collision — control jumped into the case's regime while split:
    # forced case jump.
    lp_c_branch = _log_indicator(nxt.d_k == 1) + lp_unif_not_c_not_prev
    # Branch d: free case evolution under the hazard.
    lp_d_cp = jnp.log(rho_k) + lp_unif_not_c_not_prev
    lp_d_cont = (
        jnp.log1p(-rho_k)
        + _log_indicator(prev.d_k + 1 == nxt.d_k)
        + _log_indicator(prev.r_k == nxt.r_k)
    )
    lp_d = jnp.where(nxt.d_k == 1, lp_d_cp, lp_d_cont)

    in_a = nxt.m == 1
    in_b = (prev.m == 1) & (nxt.d_c != 1)
    in_c = (nxt.r_c == prev.r_k) & (prev.m == 0)
    lp_k = jnp.where(in_a, lp_a, jnp.where(in_b, lp_b, jnp.where(in_c, lp_c_branch, lp_d)))

    return lp_m + lp_c + lp_k


def paired_transition_log_prob(params: "TwoGroupParams", anc: State, children: State):
    """log f(children[i, m] | anc[m]) as (I, M) — the filter's paired layout.

    Same restructuring as _backward_logits (prev-only factors computed once
    at (M,), ~half the joint-grid ops of the generic density), but for
    children PAIRED with their ancestor along the M axis instead of an outer
    (B, N) product. Equivalence with transition_log_prob is covered by
    tests/test_two_group_filter.py::test_paired_logits_matches_transition.

    PRECONDITION (live ancestors only): unlike transition_log_prob, the
    one-hot row lookups here drop _lookup_log_p's dead-index guard — a
    padding ancestor (regime -1) yields an all-zero one-hot and a row of
    0.0 instead of -inf. Every caller must mask dead ancestor slots via
    -inf weights (the filter does: dead parents propagate -inf through the
    weight update), so the kernel is NOT drop-in equivalent to
    transition_log_prob on padded states.
    """
    R = params.n_regimes
    f32 = params.rho_case.dtype
    NEG = _NEG_INF

    def ind(c):
        return jnp.where(c, 0.0, NEG)

    # ---- ancestor-only (M,) -------------------------------------------------
    rho_c = gather_rho(params.rho_control, anc.d_c, anc.r_c)
    rho_k = gather_rho(params.rho_case, anc.d_k, anc.r_k)
    log_rho_c, log1m_rho_c = jnp.log(rho_c), jnp.log1p(-rho_c)
    log_rho_k, log1m_rho_k = jnp.log(rho_k), jnp.log1p(-rho_k)
    gate = jnp.minimum(anc.d_k, anc.d_c) >= params.min_duration
    lpm = params.log_p_merged
    to0 = jnp.where(anc.m == 0, lpm[0, 0], lpm[1, 0])
    to1 = jnp.where(anc.m == 0, lpm[0, 1], lpm[1, 1])
    regs = jnp.arange(R)
    safe = jnp.where(jnp.isfinite(params.log_p_control), params.log_p_control, -1e30)
    oh_anc = (anc.r_c[:, None] == regs).astype(f32)  # (M, R)
    rows = jax.lax.dot(oh_anc, safe, precision=jax.lax.Precision.HIGHEST)  # (M, R)

    aM = lambda x: x[None, :]  # ancestor (M,) -> (1, M)

    # ---- joint (I, M) --------------------------------------------------------
    lp_m = jnp.where(
        aM(gate),
        jnp.where(children.m == 0, aM(to0), aM(to1)),
        ind(children.m == aM(anc.m)),
    )

    # Control row value log_p[anc.r_c[m], children.r_c[i, m]]: one-hot select
    # over the precomputed rows (exact; avoids an (I, M)-keyed gather).
    oh_ch = (children.r_c[..., None] == regs).astype(f32)  # (I, M, R)
    lp_p_raw = jnp.sum(rows[None, :, :] * oh_ch, axis=-1)
    lp_p_ctrl = jnp.where(lp_p_raw <= -1e29, NEG, lp_p_raw)
    lp_c = jnp.where(
        children.d_c == 1,
        aM(log_rho_c) + lp_p_ctrl,
        aM(log1m_rho_c)
        + ind(aM(anc.d_c) == children.d_c - 1)
        + ind(aM(anc.r_c) == children.r_c),
    )

    lp_a = ind((children.r_k == children.r_c) & (children.d_k == children.d_c))
    lp_unif_not_c = ind(children.r_k != children.r_c) - jnp.log(float(R - 1))
    lp_b = lp_unif_not_c + ind(children.d_k == 1)
    log_n_opts = jnp.where(
        children.r_c != aM(anc.r_k),
        jnp.log(jnp.asarray(R - 2, f32)),
        jnp.log(jnp.asarray(R - 1, f32)),
    )
    lp_unif2 = (
        ind(children.r_k != children.r_c)
        + ind(children.r_k != aM(anc.r_k))
        - log_n_opts
    )
    lp_cbr = ind(children.d_k == 1) + lp_unif2
    lp_d = jnp.where(
        children.d_k == 1,
        aM(log_rho_k) + lp_unif2,
        aM(log1m_rho_k)
        + ind(aM(anc.d_k + 1) == children.d_k)
        + ind(aM(anc.r_k) == children.r_k),
    )
    in_b = aM(anc.m == 1) & (children.d_c != 1)
    in_c = (children.r_c == aM(anc.r_k)) & aM(anc.m == 0)
    lp_k = jnp.where(
        children.m == 1,
        lp_a,
        jnp.where(in_b, lp_b, jnp.where(in_c, lp_cbr, lp_d)),
    )
    return lp_m + lp_c + lp_k



def expand_score_and_observe(params: "TwoGroupParams", anc: State, row_c, row_k):
    """Fused proposal expansion + paired transition density + emission lookup.

    Returns (children State (I, M), trans_lp (I, M), obs_lp (I, M)) — bit-
    identical to expand_states + paired_transition_log_prob + the one-hot
    emission select (tests/test_two_group_model.py::test_expand_score_and_
    observe_matches_composition), but exploiting the STATIC child-slot
    layout (proposal.expand_states docstring): per slot REGION the generic
    ~50-op (I, M) branch tree collapses to closed forms —

      cont (slot 0)        every factor is ancestor-only -> (M,) vector
      ctrl-CP (R-1 slots)  one (R-1, M) select between two STATIC row
                           slices of the ancestor's log_p row (the
                           enumerate-{0..R-1}\\{r_k} shift), rest (M,)
      case-CP (R-1 slots)  one (R-1, M) regime compare, rest (M,)
      merge (slot 2R-1)    ancestor-only -> (M,)
      indep (R*R slots)    child fields are CONSTANTS -> log_p/emission
                           lookups become static gathers; per-ancestor
                           factors enter via a single (R, M) eq_rk table

    Branch-selection identities used (verified against the generic tree's
    case logic, case_control_distributions.py:138-151, 246-291): e.g. a
    ctrl-CP child has c.r_c != r_k and c.r_k == r_k by construction, so
    in_c is statically false and lp_unif2 is -inf on the d_k==0 edge;
    continuation children satisfy their duration/regime indicators
    identically 0. Ancestors with duration 0 (merge children of merged
    parents) take the changepoint branch at the next site — handled by the
    (M,) d==0 predicates, NOT assumed away.

    Emission lookups ride the same structure: the (I, M, R) one-hot sums
    reduce to (M,) selects (cont/merge), shifted static slices (CP blocks),
    and a STATIC (R*R,) gather for the indep block.

    PRECONDITION (live ancestors only): same as paired_transition_log_prob.
    """
    R = params.n_regimes
    f32 = params.rho_case.dtype
    NEG = _NEG_INF
    M = anc.m.shape[0]

    def ind(c):
        return jnp.where(c, jnp.asarray(0.0, f32), NEG)

    m_p, d_c, r_c, d_k, r_k = anc.m, anc.d_c, anc.r_c, anc.d_k, anc.r_k

    # ---- ancestor-only (M,) -------------------------------------------------
    rho_c = gather_rho(params.rho_control, d_c, r_c)
    rho_k = gather_rho(params.rho_case, d_k, r_k)
    log_rho_c, log1m_rho_c = jnp.log(rho_c), jnp.log1p(-rho_c)
    log_rho_k, log1m_rho_k = jnp.log(rho_k), jnp.log1p(-rho_k)
    gate = jnp.minimum(d_k, d_c) >= params.min_duration
    lpm = params.log_p_merged
    to0 = jnp.where(m_p == 0, lpm[0, 0], lpm[1, 0])
    to1 = jnp.where(m_p == 0, lpm[0, 1], lpm[1, 1])
    regs = jnp.arange(R)
    safe = jnp.where(jnp.isfinite(params.log_p_control), params.log_p_control, -1e30)
    oh_anc = (r_c[:, None] == regs).astype(f32)  # (M, R)
    rows = jax.lax.dot(oh_anc, safe, precision=jax.lax.Precision.HIGHEST)  # (M, R)
    rowsT = rows.T  # (R, M): rowsT[x] = log_p[r_c[m], x] (unguarded)

    def guard(x):
        return jnp.where(x <= -1e29, NEG, x)

    diag_lp = guard(jnp.sum(rows * oh_anc, axis=-1))  # log_p[r_c, r_c]
    eq_rk = regs[:, None] == r_k[None, :]  # (R, M): eq_rk[x] = (x == r_k)
    # Emission row selects for ancestor-valued regimes.
    obs_c_anc = jnp.sum(jnp.where(oh_anc == 1.0, row_c, 0.0), axis=-1)  # row_c[r_c]
    oh_anc_k = (r_k[:, None] == regs).astype(f32)
    obs_k_anck = jnp.sum(jnp.where(oh_anc_k == 1.0, row_k, 0.0), axis=-1)  # row_k[r_k]
    obs_c_anck = jnp.sum(jnp.where(oh_anc_k == 1.0, row_c, 0.0), axis=-1)  # row_c[r_k]
    obs_k_anc = jnp.sum(jnp.where(oh_anc == 1.0, row_k, 0.0), axis=-1)  # row_k[r_c]
    log_Rm1 = jnp.log(jnp.asarray(R - 1, f32))
    log_Rm2 = jnp.log(jnp.asarray(R - 2, f32))

    # Shared (M,) sub-terms.
    lp_m_cp = jnp.where(gate, to0, ind(m_p == 0))  # children.m == 0 regions
    # continuation-style control factor: d_c==0 ancestors changepoint back.
    lp_c_cont = jnp.where(d_c == 0, log_rho_c + diag_lp, log1m_rho_c)
    lp_k_cont_unmerged = jnp.where((r_c == r_k) | (d_k == 0), NEG, log1m_rho_k)

    # ---- cont (slot 0): c = (m_p, d_c+1, r_c, d_k+1, r_k) ------------------
    lp_m_cont = jnp.where(gate, jnp.where(m_p == 0, to0, to1), jnp.asarray(0.0, f32))
    lp_k0 = jnp.where(
        m_p == 1, ind((r_k == r_c) & (d_k == d_c)), lp_k_cont_unmerged
    )
    lp_cont = lp_m_cont + lp_c_cont + lp_k0  # (M,)
    obs_cont = obs_c_anc + obs_k_anck

    # ---- ctrl-CP (R-1 slots): c = (0, 1, enum\{r_k}, d_k+1, r_k) -----------
    sA = jnp.arange(R - 1)[:, None]  # (R-1, 1) of s-1 for s in 1..R-1
    shift_mask = sA < r_k[None, :]
    lp_p_sel = guard(jnp.where(shift_mask, rowsT[:-1], rowsT[1:]))  # (R-1, M)
    lp_k_ctrlcp = jnp.where(d_k == 0, NEG, log1m_rho_k)
    lp_ctrl = lp_m_cp[None] + (log_rho_c[None] + lp_p_sel) + lp_k_ctrlcp[None]
    ctrl_regime = jnp.where(shift_mask, sA, sA + 1).astype(jnp.int32)
    obs_ctrl = (
        jnp.where(shift_mask, row_c[:-1, None], row_c[1:, None]) + obs_k_anck[None]
    )

    # ---- case-CP (R-1 slots): c = (0, d_c+1, r_c, 1, enum\{r_c}) -----------
    jB = jnp.arange(R - 1)[:, None]
    shift_mask_k = jB < r_c[None, :]
    case_regime = jnp.where(shift_mask_k, jB, jB + 1).astype(jnp.int32)
    log_n_opts = jnp.where(r_c != r_k, log_Rm2, log_Rm1)  # (M,)
    lp_unif2_case = (
        ind(case_regime != r_k[None, :]) - log_n_opts[None]
    )  # (R-1, M)
    in_b = (m_p == 1) & (d_c != 0)
    in_c = (r_c == r_k) & (m_p == 0)
    lp_k_case = jnp.where(
        in_b[None],
        -log_Rm1,
        lp_unif2_case + jnp.where(in_c, jnp.asarray(0.0, f32), log_rho_k)[None],
    )
    lp_case = (lp_m_cp + lp_c_cont)[None] + lp_k_case
    obs_case = obs_c_anc[None] + jnp.where(
        shift_mask_k, row_k[:-1, None], row_k[1:, None]
    )

    # ---- merge (slot 2R-1): c = (1, md, r_c, md, r_c), md = m_p?0:d_c+1 ----
    merge_dur = jnp.where(m_p == 0, d_c + 1, 0)
    lp_m_merge = jnp.where(gate, to1, ind(m_p == 1))
    lp_c_merge = jnp.where(
        (m_p == 0) & (d_c == 0),
        log_rho_c + diag_lp,
        jnp.where(m_p == 1, NEG, log1m_rho_c),
    )
    lp_merge = lp_m_merge + lp_c_merge  # lp_k (lp_a) == 0
    obs_merge = obs_c_anc + obs_k_anc

    # ---- indep (R*R slots): c = (i==j, 1, i, 1, j) — static children -------
    kk = np.arange(R * R, dtype=np.int32)  # host-static: gathers fold
    I_rc = kk // R  # (R*R,) static
    I_rk = kk % R
    I_m = (I_rc == I_rk).astype(np.int32)
    lp_m_ind = jnp.where(
        gate[None],
        jnp.where((I_m == 0)[:, None], to0[None], to1[None]),
        ind(I_m[:, None] == m_p[None]),
    )
    lp_c_ind = log_rho_c[None] + guard(rowsT)[I_rc]  # (R*R, M) static gather
    eq_rk_f = eq_rk  # (R, M) bool
    lp_unif2_ind = ind(~eq_rk_f[I_rk]) - jnp.where(
        ~eq_rk_f[I_rc], log_Rm2, log_Rm1
    )
    in_c_ind = eq_rk_f[I_rc] & (m_p == 0)[None]
    lp_k_ind = jnp.where(
        (I_m == 1)[:, None],
        jnp.asarray(0.0, f32),
        lp_unif2_ind + jnp.where(in_c_ind, jnp.asarray(0.0, f32), log_rho_k[None]),
    )
    lp_ind = lp_m_ind + lp_c_ind + lp_k_ind
    obs_ind = (row_c[I_rc] + row_k[I_rk])[:, None]  # STATIC (R*R,) gather

    # ---- assemble (I, M) ----------------------------------------------------
    trans_lp = jnp.concatenate(
        [lp_cont[None], lp_ctrl, lp_case, lp_merge[None], lp_ind], axis=0
    )
    obs_lp = jnp.concatenate(
        [
            obs_cont[None],
            obs_ctrl,
            obs_case,
            obs_merge[None],
            jnp.broadcast_to(obs_ind, (R * R, M)),
        ],
        axis=0,
    )

    bT = lambda x: jnp.broadcast_to(x, (R - 1, M)).astype(jnp.int32)
    i32 = lambda x: x.astype(jnp.int32)
    children = State(
        m=jnp.concatenate(
            [
                i32(m_p)[None],
                jnp.zeros((2 * (R - 1), M), jnp.int32),
                jnp.ones((1, M), jnp.int32),
                jnp.broadcast_to(I_m[:, None], (R * R, M)),
            ],
            axis=0,
        ),
        d_c=jnp.concatenate(
            [
                i32(d_c + 1)[None],
                jnp.ones((R - 1, M), jnp.int32),
                bT(i32(d_c + 1)[None]),
                i32(merge_dur)[None],
                jnp.ones((R * R, M), jnp.int32),
            ],
            axis=0,
        ),
        r_c=jnp.concatenate(
            [
                i32(r_c)[None],
                ctrl_regime,
                bT(i32(r_c)[None]),
                i32(r_c)[None],
                jnp.broadcast_to(I_rc[:, None], (R * R, M)),
            ],
            axis=0,
        ),
        d_k=jnp.concatenate(
            [
                i32(d_k + 1)[None],
                bT(i32(d_k + 1)[None]),
                jnp.ones((R - 1, M), jnp.int32),
                i32(merge_dur)[None],
                jnp.ones((R * R, M), jnp.int32),
            ],
            axis=0,
        ),
        r_k=jnp.concatenate(
            [
                i32(r_k)[None],
                bT(i32(r_k)[None]),
                case_regime,
                i32(r_c)[None],
                jnp.broadcast_to(I_rk[:, None], (R * R, M)),
            ],
            axis=0,
        ),
    )
    return children, trans_lp, obs_lp


def phantom_state(phantom_regime, batch_shape=()):
    """The phantom previous state used for the initial distribution
    (intitial_state_dist, case_control_regime_model.py:234-244): merged, with
    zero sojourns, in a uniformly-random regime."""
    r = jnp.broadcast_to(jnp.asarray(phantom_regime, jnp.int32), batch_shape)
    z = jnp.zeros_like(r)
    return State(m=jnp.ones_like(r), d_c=z, r_c=r, d_k=z, r_k=r)


def observation_log_prob(emission_control, emission_case, t, state: State):
    """Gather the per-site emission table (ops/emissions) at the particle
    regimes; replaces observation_fn (case_control_regime_model.py:197-231)."""
    return emission_control[t, state.r_c] + emission_case[t, state.r_k]
