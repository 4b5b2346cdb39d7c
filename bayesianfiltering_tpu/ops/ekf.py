"""Extended-Kalman-filter step primitives (non-additive noise).

Math parity with the reference primitives:
* predict    — ref: gaussfiltax/inference.py:51-70
  ``μ⁺ = f(m, q₀, u)``, ``Σ⁺ = F_x P F_xᵀ + F_q Q F_qᵀ``
* condition  — ref: gaussfiltax/inference.py:72-105
  ``S = H_r R H_rᵀ + H_x P H_xᵀ``, ``K = (S⁻¹ H_x P)ᵀ``,
  ``Σ = P − K S Kᵀ``, ``μ = m + K (y − h(m, r₀, u))``
* fused step — ref: gaussfiltax/inference.py:107-120

Numerics: the innovation solve goes through a Cholesky factorization
(:func:`~bayesianfiltering_tpu.utils.linalg.chol_and_inv_lower`) instead of
the reference's LU-with-scalar-jitter; the same factor is reused for the
observation log-likelihood, so one factorization serves gain + likelihood.
All functions are rank-polymorphic over leading batch dimensions *of the
Gaussian* when the callables are vmapped by the caller (the filters vmap
over mixture components).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from bayesianfiltering_tpu.utils.linalg import chol_and_inv_lower, symmetrize

_LOG_2PI = math.log(2.0 * math.pi)


class EKFUpdate(NamedTuple):
    log_likelihood: jax.Array
    mean: jax.Array
    cov: jax.Array
    jacobian: jax.Array  # H_x at the prior mean
    gain: jax.Array


def ekf_predict(
    m: jax.Array,
    P: jax.Array,
    f: Callable,
    F_x: Callable,
    F_q: Callable,
    Q: jax.Array,
    q0: jax.Array,
    u,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """First-order EKF predict with non-additive dynamics noise.

    Returns ``(mu_pred, Sigma_pred, F_x(m))`` exactly like the reference
    ``_predict`` (ref: gaussfiltax/inference.py:51-70).
    """
    Fx = F_x(m, q0, u)
    Fq = F_q(m, q0, u)
    mu_pred = f(m, q0, u)
    Sigma_pred = symmetrize(Fx @ P @ Fx.T + Fq @ Q @ Fq.T)
    return mu_pred, Sigma_pred, Fx


# Relative floor added to the innovation covariance diagonal. A few ULPs of
# the largest diagonal entry: invisible numerically, but keeps the Cholesky
# alive when f32 rounding drives a collapsed S slightly indefinite. (The
# reference gets accidental regularization from adding the scalar 1e-6 to
# every entry of S, ref: gaussfiltax/utils.py:258 — an absolute perturbation
# that is enormous next to its R=2.5e-5 BOT noise; this is the principled
# version.)
_REL_JITTER = 1e-6


def chol_update_precomputed(m, P, Hx, Rt, innov, jitter=0.0):
    """Joseph-form Cholesky measurement update on PRECOMPUTED linearizations.

    The shared implementation of the update math: the bank kernel's XLA
    reference and VJP (ops/bank_update.py) and the chunked update
    (:func:`ekf_condition_on_chunked`) route through this function, and
    :func:`_chol_update` is the same formula on a raw linearization, so the
    numerics cannot drift apart. Returns ``(ll, mean, cov, gain)``.
    """
    dy = innov.shape[-1]
    S = symmetrize(Rt + Hx @ P @ Hx.T)
    floor = _REL_JITTER * jnp.max(jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1)))
    S = S + (jitter + floor) * jnp.eye(S.shape[-1], dtype=S.dtype)
    chol, linv = chol_and_inv_lower(S)
    hp = Hx @ P
    K = (linv.T @ (linv @ hp)).T
    A = jnp.eye(P.shape[-1], dtype=P.dtype) - K @ Hx
    posterior_cov = symmetrize(A @ P @ A.T + K @ Rt @ K.T)
    posterior_mean = m + K @ innov
    z = linv @ innov
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)))
    ll = -0.5 * (dy * _LOG_2PI + logdet + jnp.sum(jnp.square(z)))
    return ll, posterior_mean, posterior_cov, K


def _residual(y, yhat, residual_fn=None):
    """Innovation ``y ⊖ ŷ``: plain subtraction unless the model supplies a
    residual (e.g. utils.angles.angular_residual for bearing emissions —
    the unwrapped ±2π innovation is how the reference's filters diverge on
    its BOT benchmark)."""
    y = jnp.atleast_1d(y)
    yhat = jnp.atleast_1d(yhat)
    return y - yhat if residual_fn is None else residual_fn(y, yhat)


def _chol_update(P, Hx, Hr, R, m, y, yhat, jitter: float, residual_fn=None):
    """Shared innovation-form update given linearization (Hx, Hr) at m."""
    dy = y.shape[-1] if y.ndim else 1
    Rt = Hr @ R @ Hr.T
    S = symmetrize(Rt + Hx @ P @ Hx.T)
    floor = _REL_JITTER * jnp.max(jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1)))
    S = S + (jitter + floor) * jnp.eye(S.shape[-1], dtype=S.dtype)
    chol, linv = chol_and_inv_lower(S)
    hp = Hx @ P
    K = (linv.T @ (linv @ hp)).T
    # Joseph-form covariance downdate: algebraically equal to P − K S Kᵀ but
    # PSD by construction — the difference form goes indefinite under f32
    # cancellation when S is tiny (e.g. the BOT bearing noise R=2.5e-5),
    # which is how the reference's filters NaN out on that model.
    A = jnp.eye(P.shape[-1], dtype=P.dtype) - K @ Hx
    posterior_cov = symmetrize(A @ P @ A.T + K @ Rt @ K.T)
    innov = _residual(y, yhat, residual_fn)
    posterior_mean = m + K @ innov
    # log N(y | yhat, S) on the same factor
    z = linv @ innov
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)))
    ll = -0.5 * (dy * _LOG_2PI + logdet + jnp.sum(jnp.square(z)))
    return ll, posterior_mean, posterior_cov, K


def ekf_condition_on(
    m: jax.Array,
    P: jax.Array,
    h: Callable,
    H_x: Callable,
    H_r: Callable,
    R: jax.Array,
    r0: jax.Array,
    u,
    y: jax.Array,
    jitter: float = 0.0,
    residual_fn=None,
) -> EKFUpdate:
    """First-order EKF measurement update with non-additive noise.

    Same contract as the reference ``_condition_on``
    (ref: gaussfiltax/inference.py:72-105): returns
    ``(ll, mean, cov, H_x(m), K)``.
    """
    Hx = H_x(m, r0, u)
    Hr = H_r(m, r0, u)
    yhat = h(m, r0, u)
    y = jnp.atleast_1d(y)
    ll, mean, cov, K = _chol_update(P, Hx, Hr, R, m, y, yhat, jitter,
                                    residual_fn)
    return EKFUpdate(ll, mean, cov, Hx, K)


def ekf_condition_on_iterated(
    m: jax.Array,
    P: jax.Array,
    h: Callable,
    H_x: Callable,
    H_r: Callable,
    R: jax.Array,
    r0: jax.Array,
    u,
    y: jax.Array,
    num_iter: int = 1,
    jitter: float = 0.0,
    residual_fn=None,
) -> EKFUpdate:
    """Iterated EKF update: relinearize ``num_iter`` times around the current
    posterior mean (IEKF). ``num_iter=1`` reduces to :func:`ekf_condition_on`.

    The reference accepts a ``num_iter`` argument on every filter but never
    uses it (ref: gaussfiltax/inference.py:303-310 docstring); here it is
    honored. The likelihood/gain/jacobian reported are those of the final
    iteration's linearization point.
    """
    y = jnp.atleast_1d(y)
    num_iter = _static_num_iter(num_iter)
    if num_iter <= 0:
        return _degenerate_update(m, P, y)

    # Statically unrolled: num_iter is a Python int in every caller, and a
    # lax.fori_loop here would compile to a while-loop inside the filters'
    # scan.
    lin_point = m
    out = None
    for it in range(num_iter):
        Hx = H_x(lin_point, r0, u)
        Hr = H_r(lin_point, r0, u)
        # IEKF innovation correction: yhat accounts for the shift between
        # linearization point and prior mean (zero at the first iteration).
        yhat = jnp.atleast_1d(h(lin_point, r0, u))
        if it > 0:
            yhat = yhat + Hx @ (m - lin_point)
        ll, mean, cov, K = _chol_update(P, Hx, Hr, R, m, y, yhat, jitter,
                                        residual_fn)
        lin_point = mean
        out = EKFUpdate(ll, mean, cov, Hx, K)
    return out


def ekf_condition_on_chunked(
    m, P, h, H_x, H_r, R, r0, u, y, chunk=128, num_iter=1, jitter=0.0,
    residual_fn=None,
) -> EKFUpdate:
    """Sequential (chunked) EKF measurement update for large emission dims.

    Processes the emission vector in ``chunk``-sized blocks, one Kalman
    update per block — the classical "sequential processing" form. EXACT
    (same posterior and total log-likelihood as the joint update) whenever
    the effective emission noise ``Rt = H_r R H_rᵀ`` is block-diagonal
    w.r.t. the chunking (e.g. diagonal sensor noise, the BASELINE Lorenz-96
    config); an approximation otherwise — cross-chunk noise correlations
    are dropped. Each block factorizes a ``(chunk, chunk)`` innovation
    covariance instead of one ``(dy, dy)``.

    Chunk boundaries are static; per-chunk innovations are corrected for
    the mean motion of earlier chunks (``inn_c −= H_c (m_cur − m_lin)``),
    so within one linearization the recursion is algebraically the joint
    update.

    Returns an :class:`EKFUpdate`; the ``gain`` field holds the per-chunk
    gains concatenated to (dx, dy) (diagnostic — the joint gain is not
    materialized).
    """
    y = jnp.atleast_1d(y)
    dy = y.shape[-1]
    num_iter = _static_num_iter(num_iter)
    if num_iter <= 0:
        return _degenerate_update(m, P, y)
    chunk = int(chunk)
    bounds = [(lo, min(lo + chunk, dy)) for lo in range(0, dy, chunk)]
    lin = m
    out = None
    for it in range(num_iter):
        Hx = jnp.reshape(H_x(lin, r0, u), (-1, m.shape[-1]))
        Hr = jnp.reshape(H_r(lin, r0, u), (Hx.shape[0], -1))
        yhat = jnp.atleast_1d(h(lin, r0, u))
        if it > 0:
            yhat = yhat + Hx @ (m - lin)
        Rt = Hr @ R @ Hr.T
        innov_full = _residual(y, yhat, residual_fn)
        ll_total = jnp.zeros(())
        cur_m, cur_P = m, P
        gains = []
        for lo, hi in bounds:
            Hc = Hx[lo:hi]
            inn = innov_full[lo:hi] - Hc @ (cur_m - m)
            ll, cur_m, cur_P, K = chol_update_precomputed(
                cur_m, cur_P, Hc, Rt[lo:hi, lo:hi], inn, jitter)
            ll_total = ll_total + ll
            gains.append(K)
        lin = cur_m
        out = EKFUpdate(ll_total, cur_m, cur_P, Hx,
                        jnp.concatenate(gains, axis=-1))
    return out


def ekf_condition_on_ref(
    m: jax.Array,
    P: jax.Array,
    h: Callable,
    H_x: Callable,
    H_r: Callable,
    R: jax.Array,
    r0: jax.Array,
    u,
    y: jax.Array,
) -> EKFUpdate:
    """Reference-exact EKF update for golden-parity mode.

    Reproduces the reference's formulas VERBATIM, quirks included
    (ref: gaussfiltax/inference.py:72-105 + utils.py:256-259): the gain
    comes from an LU solve of ``S + 1e-6`` with the scalar added to every
    entry (not the diagonal), the covariance uses the cancellation-prone
    difference form ``P − K S Kᵀ``, and the log-likelihood is evaluated on
    the unperturbed ``S``. Use only for parity testing — the default
    :func:`ekf_condition_on` is the numerically sound path.
    """
    Hx = H_x(m, r0, u)
    Hr = H_r(m, r0, u)
    S = Hr @ R @ Hr.T + Hx @ P @ Hx.T
    K = jnp.linalg.solve(S + 1e-6, Hx @ P).T
    posterior_cov = P - K @ S @ K.T
    yhat = jnp.atleast_1d(h(m, r0, u))
    innov = jnp.atleast_1d(y) - yhat
    posterior_mean = m + K @ innov
    chol = jnp.linalg.cholesky(S)
    z = jax.scipy.linalg.solve_triangular(chol, innov, lower=True)
    dy = innov.shape[-1]
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)))
    ll = -0.5 * (dy * _LOG_2PI + logdet + jnp.sum(jnp.square(z)))
    return EKFUpdate(ll, posterior_mean, posterior_cov, Hx, K)


def ekf_step(
    m: jax.Array,
    P: jax.Array,
    f: Callable,
    F_x: Callable,
    F_q: Callable,
    Q: jax.Array,
    q0: jax.Array,
    u,
    h: Callable,
    H_x: Callable,
    H_r: Callable,
    R: jax.Array,
    r0: jax.Array,
    y: jax.Array,
    jitter: float = 0.0,
):
    """Fused predict + update (ref: gaussfiltax/inference.py:107-120).

    Returns ``(ll, posterior_mean, posterior_cov)``.
    """
    mu_pred, Sigma_pred, _ = ekf_predict(m, P, f, F_x, F_q, Q, q0, u)
    out = ekf_condition_on(mu_pred, Sigma_pred, h, H_x, H_r, R, r0, u, y, jitter)
    return out.log_likelihood, out.mean, out.cov


def _static_num_iter(num_iter) -> int:
    """num_iter must be a static Python int: the iteration loop is unrolled
    at trace time (a lax loop here would compile to a while-loop inside the
    filters' scan)."""
    try:
        return int(num_iter)
    except TypeError as e:
        raise TypeError(
            "num_iter must be a static Python int (got a traced value); "
            "the relinearization loop is unrolled at trace time"
        ) from e


def _degenerate_update(m, P, y):
    """num_iter=0: a well-defined no-op update (prior passes through),
    matching the old fori_loop(0, 0) semantics."""
    dy = y.shape[-1]
    dx = m.shape[-1]
    return EKFUpdate(
        jnp.zeros(()), m, P, jnp.zeros((dy, dx), P.dtype),
        jnp.zeros((dx, dy), P.dtype),
    )


__all__ = [
    "EKFUpdate",
    "chol_update_precomputed",
    "ekf_predict",
    "ekf_condition_on",
    "ekf_condition_on_iterated",
    "ekf_condition_on_chunked",
    "ekf_condition_on_ref",
    "ekf_step",
]
