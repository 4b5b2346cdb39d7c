"""Steady-state Kalman filtering/smoothing: the time recursion as matmuls.

For a time-invariant linear-Gaussian SSM the Kalman gain converges to its
Riccati fixed point; once the gain is frozen, the filtered-mean recursion
``m_t = A m_{t-1} + u_t`` (``A = (I - K∞H) F`` constant) is an affine scan
with a CONSTANT matrix. That collapses the O(log T)-depth associative scan
of :mod:`bayesianfiltering_tpu.ops.associative` — whose per-level combines
are per-timestep 5-tuple small-matrix algebra — into log2(T) plain
``(T, dx) @ (dx, dx)`` matmuls (Kogge–Stone doubling: level k adds
``A^{2^k} v[t - 2^k]``). The first ``head`` steps
run the exact time-varying filter so the transient is exact; past the head
the frozen gain differs from the exact one only by the (exponentially
decaying) Riccati residual.

This is an approximation the reference has no analog of (its only linear
handling is running linear models through the EKF, e.g.
ref: docs/experiments/adaptive_experiment.py:60-65); it answers "filter a
million-step stationary stream" while agreeing with the exact filter to
f32 rounding once the gain has converged. Its speed against the
associative filter on the GPU is not measured.

Use :func:`steady_state_gains` to inspect convergence (``rel_delta`` is
the last Riccati-iteration relative change; it should be ~f32 eps — if it
is not, the model's transient outlives ``num_iters`` and the exact
:func:`~bayesianfiltering_tpu.ops.associative.parallel_kalman_filter` is
the right tool).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.ops.linear import (
    ParamsLGSSM,
    PosteriorKalman,
    _biases,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu.utils.linalg import (
    fast_cholesky,
    psd_solve,
    symmetrize,
    tri_inv_lower,
)

_LOG_2PI = math.log(2.0 * math.pi)


class SteadyStateGains(NamedTuple):
    """Riccati fixed point of the filter (and the smoother's companions).

    ``rel_delta`` is ``||P_pred_k - P_pred_{k-1}||_F / ||P_pred_k||_F`` at
    the final iteration — the convergence certificate.
    """

    predicted_covariance: jax.Array   # P∞ (pre-update)
    filtered_covariance: jax.Array    # (I - KH) P∞
    innovation_covariance: jax.Array  # S∞ = H P∞ Hᵀ + R
    gain: jax.Array                   # K∞
    closed_loop: jax.Array            # A = (I - K∞H) F
    smoother_gain: jax.Array          # G∞ = P_f∞ Fᵀ P∞⁻¹
    smoothed_covariance: jax.Array    # fixed point of the RTS cov recursion
    rel_delta: jax.Array


@with_matmul_precision
def steady_state_gains(params: ParamsLGSSM,
                       num_iters: int = 128) -> SteadyStateGains:
    """Iterate the filter's covariance recursion from the model's own
    ``initial_covariance`` for ``num_iters`` steps (data-independent, tiny),
    then derive every steady-state quantity from the fixed point."""
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance

    def ric(P_pred, _):
        S = symmetrize(H @ P_pred @ H.T + R)
        K = psd_solve(S, H @ P_pred).T
        P_filt = symmetrize(P_pred - K @ S @ K.T)
        P_next = symmetrize(F @ P_filt @ F.T + Q)
        return P_next, None

    P1, _ = lax.scan(ric, params.initial_covariance, None,
                     length=num_iters - 1)
    P_pred, _ = ric(P1, None)
    rel_delta = (jnp.linalg.norm(P_pred - P1) /
                 jnp.maximum(jnp.linalg.norm(P_pred), 1e-30))

    S = symmetrize(H @ P_pred @ H.T + R)
    K = psd_solve(S, H @ P_pred).T
    P_filt = symmetrize(P_pred - K @ S @ K.T)
    A = F - K @ (H @ F)
    G = psd_solve(P_pred, F @ P_filt).T

    def stein(sP, _):
        return symmetrize(P_filt + G @ (sP - P_pred) @ G.T), None

    sP, _ = lax.scan(stein, P_filt, None, length=num_iters)
    return SteadyStateGains(P_pred, P_filt, S, K, A, G, sP, rel_delta)


def _affine_scan_constant(A: jax.Array, u: jax.Array) -> jax.Array:
    """Inclusive scan of ``v_t = A v_{t-1} + u_t`` (``v_{-1} = 0``) with a
    CONSTANT matrix, in ceil(log2 T) rounds of one ``(T, dx) @ (dx, dx)``
    matmul each (Kogge–Stone: round k adds ``A^{2^k} v[t - 2^k]``). The
    round-k matrices are position-independent — that is what a constant-A
    affine operator buys over the general associative-scan combine."""
    T = u.shape[0]
    v = u
    Ak_T = A.T
    offset = 1
    while offset < T:
        v = jnp.concatenate([v[:offset], v[offset:] + v[:-offset] @ Ak_T],
                            axis=0)
        Ak_T = Ak_T @ Ak_T
        offset *= 2
    return v


def _resolve_head(head: int, T: int) -> int:
    if head < 1:
        raise ValueError(f"head must be >= 1, got {head}")
    return min(head, T)


@with_matmul_precision
def steady_state_kalman_filter(params: ParamsLGSSM, emissions: jax.Array,
                               head: int = 64,
                               num_iters: int = 128) -> PosteriorKalman:
    """Kalman filter with frozen steady-state gain past an exact head.

    The first ``head`` steps run :func:`ops.linear.kalman_filter` exactly
    (time-varying gains, exact covariances and loglik); from step ``head``
    on, the gain is frozen at the ``num_iters``-step Riccati fixed point
    and the mean recursion is evaluated in log2(T) matmuls
    (:func:`_affine_scan_constant`). Covariances past the head are the
    (broadcast) steady-state matrices. Exact for t < head; past the head
    the means/loglik differ from the exact filter by the gain's remaining
    Riccati residual (see ``steady_state_gains(...).rel_delta``).
    """
    T = emissions.shape[0]
    head = _resolve_head(head, T)
    if T <= head:
        return kalman_filter(params, emissions)

    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)
    dy = H.shape[-2]
    ss = steady_state_gains(params, num_iters=max(num_iters, head))

    post_head = kalman_filter(params, emissions[:head])
    m_pred_head = post_head.predicted_means[-1]   # prediction of step `head`

    # Tail filtered means: m_t = A m_{t-1} + u_t with
    # u_t = (I - KH) c + K (y_t - d); the boundary term folds the exact
    # head's final prediction into u_head.
    K, A = ss.gain, ss.closed_loop
    IKH_c = c - K @ (H @ c)
    ys = emissions[head:]
    u = IKH_c + (ys - d) @ K.T
    u = u.at[0].set(m_pred_head - K @ (H @ m_pred_head) + K @ (ys[0] - d))
    m_filt_tail = _affine_scan_constant(A, u)
    m_pred_tail = m_filt_tail @ F.T + c           # prediction of t+1

    # Tail loglik: innovations against the steady innovation covariance.
    # m_pred at tail step t (prediction of t given 0..t-1) is
    # m_pred_tail[t-1] for t > head and m_pred_head at t = head.
    pm_prev = jnp.concatenate([m_pred_head[None], m_pred_tail[:-1]], axis=0)
    innov = ys - pm_prev @ H.T - d
    chol = fast_cholesky(ss.innovation_covariance)
    linv = tri_inv_lower(chol)
    z = innov @ linv.T
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    ll_tail = -0.5 * ((T - head) * (dy * _LOG_2PI + logdet)
                      + jnp.sum(jnp.square(z)))

    n_tail = T - head
    bcast = lambda M: jnp.broadcast_to(M, (n_tail,) + M.shape)
    return PosteriorKalman(
        post_head.marginal_loglik + ll_tail,
        jnp.concatenate([post_head.filtered_means, m_filt_tail], axis=0),
        jnp.concatenate([post_head.filtered_covariances,
                         bcast(ss.filtered_covariance)], axis=0),
        jnp.concatenate([post_head.predicted_means, m_pred_tail], axis=0),
        jnp.concatenate([post_head.predicted_covariances,
                         bcast(ss.predicted_covariance)], axis=0),
    )


@with_matmul_precision
def steady_state_kalman_smoother(params: ParamsLGSSM, emissions: jax.Array,
                                 head: int = 64,
                                 num_iters: int = 128) -> PosteriorKalman:
    """RTS smoother on top of :func:`steady_state_kalman_filter`.

    The smoothed-mean deviation ``w_t = s_t - m_filt_t`` obeys the backward
    affine recurrence ``w_t = G (w_{t+1} + m_filt_{t+1} - m_pred_{t+1})``
    with the constant steady smoother gain — the same log-depth constant-
    matrix scan, reversed. Smoothed covariances: the steady Stein fixed
    point in the converged interior, the exact backward recursion over the
    end-of-sequence transient (last ``head`` steps) and over the exact
    head (time-varying gains there).
    """
    T = emissions.shape[0]
    head = _resolve_head(head, T)
    if T <= 2 * head:
        return kalman_smoother(params, emissions)

    F = params.dynamics_matrix
    post = steady_state_kalman_filter(params, emissions, head=head,
                                      num_iters=num_iters)
    ss = steady_state_gains(params, num_iters=max(num_iters, head))
    G = ss.smoother_gain
    fm, pm = post.filtered_means, post.predicted_means
    fP, pP = post.filtered_covariances, post.predicted_covariances

    # Backward means over t >= head with frozen G (exact there: the filter
    # covariances are steady past the head). g_t = G (m_f[t+1] - m_p[t]),
    # predicted_means[t] being the prediction OF t+1.
    g = (fm[head + 1:] - pm[head:-1]) @ G.T          # length T - head - 1
    w_tail = _affine_scan_constant(G, jnp.flip(g, axis=0))
    w_tail = jnp.flip(w_tail, axis=0)                 # w_t for head <= t < T-1
    sm_tail = jnp.concatenate([fm[head:-1] + w_tail, fm[-1:]], axis=0)

    # Exact sequential backward pass over the head (time-varying gains).
    def back(carry, inputs):
        sm_next, sP_next = carry
        m_f, P_f, m_p, P_p = inputs
        Gt = psd_solve(P_p, F @ P_f).T
        sm = m_f + Gt @ (sm_next - m_p)
        sP = symmetrize(P_f + Gt @ (sP_next - P_p) @ Gt.T)
        return (sm, sP), (sm, sP)

    # Boundary at t = head: smoothed mean from the tail, steady smoothed cov
    # (filter covs are converged there).
    bound = (sm_tail[0], ss.smoothed_covariance)
    _, (sm_head, sP_head) = lax.scan(
        back, bound, (fm[:head], fP[:head], pm[:head], pP[:head]),
        reverse=True)

    # Covariance transient at the sequence end: sP_{T-1} = P_f∞, relaxing
    # backward to the Stein fixed point over ~head steps; steady in between.
    def back_cov(sP_next, _):
        sP = symmetrize(ss.filtered_covariance
                        + G @ (sP_next - ss.predicted_covariance) @ G.T)
        return sP, sP
    n_end = min(head, T - head - 1)
    _, sP_end = lax.scan(back_cov, ss.filtered_covariance, None,
                         length=n_end, reverse=True)
    n_mid = T - head - n_end - 1
    sP_mid = jnp.broadcast_to(ss.smoothed_covariance,
                              (n_mid,) + ss.smoothed_covariance.shape)
    sP_tail = jnp.concatenate(
        [sP_mid, sP_end, ss.filtered_covariance[None]], axis=0)

    return post._replace(
        smoothed_means=jnp.concatenate([sm_head, sm_tail], axis=0),
        smoothed_covariances=jnp.concatenate([sP_head, sP_tail], axis=0),
    )


__all__ = [
    "SteadyStateGains",
    "steady_state_gains",
    "steady_state_kalman_filter",
    "steady_state_kalman_smoother",
]
