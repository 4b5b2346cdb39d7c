"""Unscented-transform step primitives (additive and non-additive noise).

Math parity with the reference UKF primitives
(ref: gaussfiltax/inference.py:122-224). The reference folds the unscented
weights into inline arithmetic with the 2n non-center sigma points from
``utils._get_sigma_points`` and the center point handled analytically; that
scheme equals the textbook UT with
``W₀ᵐ = λ/(n+λ)``, ``Wᵢᵐ = 1/(2(n+λ))``, ``W₀ᶜ = W₀ᵐ + 1 − α² + β``.

Conscious fix: the reference's *additive* predict computes the center-point
covariance term as ``(f(m)−μ) @ (f(m)−μ).T`` (ref:
gaussfiltax/inference.py:143), which for 1-D arrays is an inner product —
a scalar — rather than the intended outer product (its non-additive sibling
uses ``einsum('i,j->ij', ...)`` at :173). We implement the intended outer
product everywhere.

Layout: sigma-point propagation is a single ``vmap`` (2n or 2(n+nq) rows,
batched again over mixture components by the callers); covariance
accumulation is one ``einsum`` contraction.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import vmap

from bayesianfiltering_tpu.utils.linalg import fast_cholesky, symmetrize, tri_inv_lower
from bayesianfiltering_tpu.utils.sigma_points import (
    sigma_points,
    sigma_points_blockdiag,
)
import math

_LOG_2PI = math.log(2.0 * math.pi)


class ParamsUKF(NamedTuple):
    """Unscented-transform parameters (ref: gaussfiltax/inference.py:41-49).

    ``sqrt_method`` selects the sigma-point factorization: "sqrtm" is the
    reference's symmetric square root (eigh-based here; an O(n³)
    eigendecomposition per transform), "cholesky" is the standard UT choice
    and much cheaper at high state dimension (BASELINE config 5, dx=512).
    """

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0
    sqrt_method: str = "sqrtm"


def _ut_moments(center_out, pts_out, lamda, n_aug, alpha, beta):
    """Mean/cov of the transformed distribution from 2n points + center."""
    denom = 2.0 * (lamda + n_aug)
    mu = jnp.sum(pts_out, axis=0) / denom + center_out * (lamda / (lamda + n_aug))
    centered = pts_out - mu
    w0c = lamda / (lamda + n_aug) + 1.0 - alpha**2 + beta
    cov = jnp.einsum("ij,ik->jk", centered, centered) / denom + w0c * jnp.outer(
        center_out - mu, center_out - mu
    )
    return mu, cov, centered


def _augment(m, P, bias, noise_cov):
    """Stack state and noise into one augmented Gaussian (block-diagonal)."""
    dx = m.shape[-1]
    dn = bias.shape[-1]
    mA = jnp.concatenate([m, bias])
    PA = jnp.zeros((dx + dn, dx + dn), dtype=P.dtype)
    PA = PA.at[:dx, :dx].set(P).at[dx:, dx:].set(noise_cov)
    return mA, PA


def ukf_predict_additive(
    m, P, f: Callable, u, Q, uparams: ParamsUKF, q0
) -> Tuple[jax.Array, jax.Array]:
    """UT predict, additive noise (ref: gaussfiltax/inference.py:122-144)."""
    dx = m.shape[-1]
    # Additive noise enters as +q; evaluate at the zero noise point like the
    # reference (ref: gaussfiltax/inference.py:136) regardless of the bias arg.
    q0 = jnp.zeros((dx,), dtype=m.dtype)
    lamda = uparams.alpha**2 * (dx + uparams.kappa) - dx
    pts = sigma_points(m, P, lamda, uparams.sqrt_method)
    new_pts = vmap(f, in_axes=(0, None, None))(pts, q0, u)
    center = f(m, q0, u)
    mu, cov, _ = _ut_moments(center, new_pts, lamda, dx, uparams.alpha, uparams.beta)
    return mu, symmetrize(cov + Q)


def ukf_predict_nonadditive(
    m, P, f: Callable, u, Q, uparams: ParamsUKF, q0
) -> Tuple[jax.Array, jax.Array]:
    """UT predict, non-additive noise via state-noise augmentation
    (ref: gaussfiltax/inference.py:146-174)."""
    dx = m.shape[-1]
    nq = q0.shape[-1]
    n_aug = dx + nq
    lamda = uparams.alpha**2 * (n_aug + uparams.kappa) - n_aug
    pts = sigma_points_blockdiag(m, P, q0, Q, lamda, uparams.sqrt_method)
    fA = lambda xA, uu: f(xA[:dx], xA[dx:], uu)
    new_pts = vmap(fA, in_axes=(0, None))(pts, u)
    center = f(m, q0, u)
    mu, cov, _ = _ut_moments(center, new_pts, lamda, n_aug, uparams.alpha, uparams.beta)
    return mu, symmetrize(cov)


def ukf_condition_on_additive(
    m, P, h: Callable, R, u, y, uparams: ParamsUKF, r0=None, residual_fn=None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """UT measurement update, additive noise
    (ref: gaussfiltax/inference.py:176-196). Returns (ll, mean, cov)."""
    dx = m.shape[-1]
    y = jnp.atleast_1d(y)
    r0 = jnp.zeros(y.shape[-1], dtype=m.dtype)
    lamda = uparams.alpha**2 * (dx + uparams.kappa) - dx
    pts = sigma_points(m, P, lamda, uparams.sqrt_method)
    new_pts = vmap(h, in_axes=(0, None, None))(pts, r0, u)
    center = h(m, r0, u)
    mu_y, S, centered = _ut_moments(center, new_pts, lamda, dx, uparams.alpha,
                                    uparams.beta)
    S = symmetrize(S + R)
    C = jnp.einsum("ij,ik->jk", centered, pts - m) / (2.0 * (lamda + dx))
    return _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn)


def ukf_condition_on_nonadditive(
    m, P, h: Callable, R, u, y, uparams: ParamsUKF, r0=None, residual_fn=None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """UT measurement update, non-additive noise via augmentation
    (ref: gaussfiltax/inference.py:198-224). Returns (ll, mean, cov)."""
    dx = m.shape[-1]
    nr = r0.shape[-1]
    n_aug = dx + nr
    y = jnp.atleast_1d(y)
    lamda = uparams.alpha**2 * (n_aug + uparams.kappa) - n_aug
    pts = sigma_points_blockdiag(m, P, r0, R, lamda, uparams.sqrt_method)
    hA = lambda xA, uu: h(xA[:dx], xA[dx:], uu)
    new_pts = vmap(hA, in_axes=(0, None))(pts, u)
    center = h(m, r0, u)
    mu_y, S, centered = _ut_moments(center, new_pts, lamda, n_aug, uparams.alpha,
                                    uparams.beta)
    S = symmetrize(S)
    C = jnp.einsum("ij,ik->jk", centered, pts[:, :dx] - m) / (2.0 * (lamda + n_aug))
    return _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn)


def _ukf_gain_update(m, P, mu_y, S, C, y, residual_fn=None):
    """Shared Cholesky gain/likelihood: K = (S⁻¹C)ᵀ.

    The covariance downdate uses the Joseph-equivalent grouped form
    ``P − KC − (KC)ᵀ + K S Kᵀ``: with the statistically-linearized
    ``H = C P⁻¹`` this equals ``(I−KH) P (I−KH)ᵀ + K Ω Kᵀ`` exactly, so
    unlike the naive ``P − K S Kᵀ`` it does not go indefinite under f32
    cancellation on near-singular innovation covariances (the same rationale
    as the EKF path's Joseph form, ops/ekf.py; the BOT benchmark runs at
    R=2.5e-5 where the difference form loses all significant digits).
    """
    from bayesianfiltering_tpu.ops.ekf import _REL_JITTER

    dy = y.shape[-1]
    floor = _REL_JITTER * jnp.max(jnp.abs(jnp.diagonal(S)))
    S = S + floor * jnp.eye(dy, dtype=S.dtype)
    chol = fast_cholesky(S)
    linv = tri_inv_lower(chol)
    K = (linv.T @ (linv @ C)).T
    KC = K @ C
    # K S Kᵀ through the factor: (K L)(K L)ᵀ is PSD by construction.
    KL = K @ chol
    posterior_cov = symmetrize(P - KC - KC.T + KL @ KL.T)
    from bayesianfiltering_tpu.ops.ekf import _residual

    innov = _residual(y, mu_y, residual_fn)
    posterior_mean = m + K @ innov
    z = linv @ innov
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    ll = -0.5 * (dy * _LOG_2PI + logdet + jnp.sum(jnp.square(z)))
    return ll, posterior_mean, posterior_cov


def _ut_emission_moments(m, P, h: Callable, R, u, uparams: ParamsUKF, r0):
    """UT moments of the emission at (m, P), non-additive noise:
    returns (mu_y, S, C) with C the (dy, dx) cross-covariance."""
    dx = m.shape[-1]
    nr = r0.shape[-1]
    n_aug = dx + nr
    lamda = uparams.alpha**2 * (n_aug + uparams.kappa) - n_aug
    pts = sigma_points_blockdiag(m, P, r0, R, lamda, uparams.sqrt_method)
    hA = lambda xA, uu: h(xA[:dx], xA[dx:], uu)
    new_pts = vmap(hA, in_axes=(0, None))(pts, u)
    center = h(m, r0, u)
    mu_y, S, centered = _ut_moments(center, new_pts, lamda, n_aug, uparams.alpha,
                                    uparams.beta)
    C = jnp.einsum("ij,ik->jk", centered, pts[:, :dx] - m) / (2.0 * (lamda + n_aug))
    return mu_y, symmetrize(S), C


def ukf_condition_on_nonadditive_iterated(
    m, P, h: Callable, R, u, y, uparams: ParamsUKF, r0, num_iter: int = 1,
    residual_fn=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Iterated posterior-linearization UKF update (IPLF).

    ``num_iter=1`` is exactly :func:`ukf_condition_on_nonadditive`. For
    ``num_iter>1``, each iteration statistically linearizes the emission
    around the *current posterior* ``(m_i, P_i)`` — ``H = C P_i⁻¹``,
    ``b = μ_y − H m_i``, residual ``Ω = S − H P_i Hᵀ`` — and re-runs the
    Kalman update of the prior ``(m, P)`` with that affine model
    (García-Fernández et al., "Posterior linearization filter", 2015).
    This is the UKF-moments analog of the IEKF relinearization loop in
    :func:`bayesianfiltering_tpu.ops.ekf.ekf_condition_on_iterated`; the
    reference accepts ``num_iter`` on its UKF filters but ignores it
    (ref: gaussfiltax/inference.py:379-456).
    """
    from bayesianfiltering_tpu.ops.ekf import _static_num_iter

    num_iter = _static_num_iter(num_iter)
    if num_iter <= 1:
        return ukf_condition_on_nonadditive(m, P, h, R, u, y, uparams, r0,
                                            residual_fn)
    from bayesianfiltering_tpu.ops.ekf import _residual
    from bayesianfiltering_tpu.utils.linalg import psd_solve

    y = jnp.atleast_1d(y)
    dx = m.shape[-1]
    eye = jnp.eye(dx, dtype=P.dtype)

    def body(carry):
        m_i, P_i, _ = carry
        mu_y, S_i, C = _ut_emission_moments(m_i, P_i, h, R, u, uparams, r0)
        # Statistical linearization around (m_i, P_i).
        H = psd_solve(P_i, C.T).T                      # (dy, dx)
        omega = symmetrize(S_i - H @ P_i @ H.T)        # SLR residual cov
        # Kalman update of the PRIOR (m, P) under y = Hx + b + e, e~N(0, Ω).
        S = symmetrize(H @ P @ H.T + omega)
        floor = 1e-6 * jnp.max(jnp.abs(jnp.diagonal(S)))
        S = S + floor * jnp.eye(S.shape[-1], dtype=S.dtype)
        chol = fast_cholesky(S)
        linv = tri_inv_lower(chol)
        hp = H @ P
        K = (linv.T @ (linv @ hp)).T
        innov = _residual(y, mu_y + H @ (m - m_i), residual_fn)
        m_new = m + K @ innov
        A = eye - K @ H
        P_new = symmetrize(A @ P @ A.T + K @ omega @ K.T)
        z = linv @ innov
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        ll = -0.5 * (y.shape[-1] * _LOG_2PI + logdet + jnp.sum(jnp.square(z)))
        return m_new, P_new, ll

    # Statically unrolled: a lax.fori_loop here compiles to a while-loop
    # inside the filters' scan (same pathology as the EKF path, ops/ekf.py).
    carry = (m, P, jnp.zeros((), P.dtype))
    for _ in range(num_iter):
        carry = body(carry)
    m_out, P_out, ll = carry
    return ll, m_out, P_out


__all__ = [
    "ParamsUKF",
    "ukf_predict_additive",
    "ukf_predict_nonadditive",
    "ukf_condition_on_additive",
    "ukf_condition_on_nonadditive",
    "ukf_condition_on_nonadditive_iterated",
]
