"""Sigma-point construction for unscented transforms.

Two generations exist in the reference:

* modern JAX UKF — ``_get_sigma_points`` (ref: gaussfiltax/utils.py:247-254)
  builds 2n points ``m ± sqrt(n+λ)·S`` where ``S = Re(sqrtm(P))`` via SciPy's
  Schur-based ``sqrtm`` (complex intermediates). The *center*
  point is handled analytically by the caller
  (ref: gaussfiltax/inference.py:141-143). We keep that contract but build
  ``S`` with a symmetric PSD square root — identical for PSD input.
* legacy NumPy UKF — ``split_to_sigma_points`` (ref: gaussfiltax/utils.py:52-65)
  builds 2n+1 points (center first) from Cholesky columns.

Both are exposed; ``method=`` selects the factorization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from bayesianfiltering_tpu.utils.linalg import fast_cholesky, sqrtm_psd


def sigma_points(m: jax.Array, P: jax.Array, lamda, method: str = "sqrtm") -> jax.Array:
    """2n sigma points ``m ± sqrt(n+λ) s_i`` (no center point).

    Drop-in for ref: gaussfiltax/utils.py:247-254. ``method="sqrtm"`` uses the
    symmetric PSD square root (matches the reference's ``sqrtm`` on PSD
    input); ``method="cholesky"`` uses the Cholesky factor (cheaper — one
    triangular factorization instead of an eigendecomposition — and the
    standard UT choice; spread differs from "sqrtm" only through the
    factorization, both are exact to second order).
    """
    dx = m.shape[-1]
    if method == "cholesky":
        factor = fast_cholesky(P)
    else:
        factor = sqrtm_psd(P)
    scale = jnp.sqrt(dx + lamda)
    offsets = scale * jnp.swapaxes(factor, -1, -2)  # rows are scaled factor columns
    plus = m[..., None, :] + offsets
    minus = m[..., None, :] - offsets
    return jnp.concatenate([plus, minus], axis=-2)


# Reference-compatible alias (ref call sites use utils._get_sigma_points).
_get_sigma_points = sigma_points


def sigma_points_blockdiag(m: jax.Array, P: jax.Array, bias: jax.Array,
                           C: jax.Array, lamda,
                           method: str = "sqrtm") -> jax.Array:
    """2·(dx+dn) sigma points of the augmented Gaussian
    ``N([m; bias], blkdiag(P, C))`` with the factor built block-wise.

    For PD blocks ``chol(blkdiag(P, C)) = blkdiag(chol(P), chol(C))`` (and
    the symmetric PSD root likewise), so this returns bit-for-bit the same
    points as ``sigma_points(concat(m, bias), blkdiag(P, C), ...)`` — the
    reference's augmented form (ref: gaussfiltax/inference.py:151-157) —
    while factoring dx² + dn² instead of (dx+dn)², so the non-additive UKF
    paths build their augmented points here.
    """
    dx, dn = m.shape[-1], bias.shape[-1]
    na = dx + dn
    if method == "cholesky":
        fP, fC = fast_cholesky(P), fast_cholesky(C)
    else:
        fP, fC = sqrtm_psd(P), sqrtm_psd(C)
    scale = jnp.sqrt(na + lamda)
    offx = scale * jnp.swapaxes(fP, -1, -2)   # rows = scaled factor columns
    offn = scale * jnp.swapaxes(fC, -1, -2)
    zx = jnp.zeros(offx.shape[:-2] + (dx, dn), P.dtype)
    zn = jnp.zeros(offn.shape[:-2] + (dn, dx), P.dtype)
    off = jnp.concatenate([
        jnp.concatenate([offx, zx], axis=-1),
        jnp.concatenate([zn, offn], axis=-1),
    ], axis=-2)
    mA = jnp.concatenate([m, bias], axis=-1)[..., None, :]
    return jnp.concatenate([mA + off, mA - off], axis=-2)


def split_to_sigma_points(mean: jax.Array, cov: jax.Array, lamda) -> jax.Array:
    """2n+1 sigma points, center first, Cholesky columns (legacy UKF).

    JAX-native rewrite of ref: gaussfiltax/utils.py:52-65.
    """
    mean = jnp.atleast_1d(mean)
    cov = jnp.atleast_2d(cov)
    dx = mean.shape[-1]
    factor = fast_cholesky(cov)
    scale = jnp.sqrt(dx + lamda)
    offsets = scale * factor.T  # row i = scaled column i of the factor
    center = mean[None, :]
    return jnp.concatenate([center, mean + offsets, mean - offsets], axis=0)


def unscented_weights(n: int, alpha: float, beta: float, kappa: float):
    """Standard UT weights (mean and covariance) for 2n+1 points.

    The reference folds these into inline arithmetic
    (ref: gaussfiltax/inference.py:141-143): center mean weight ``λ/(n+λ)``,
    center covariance weight ``λ/(n+λ) + 1 − α² + β``, side weights
    ``1/(2(n+λ))`` — which is exactly the textbook scheme returned here.

    Returns:
        (lamda, w_mean, w_cov): scaling parameter and weight vectors of
        length 2n+1 (center first).
    """
    lamda = alpha**2 * (n + kappa) - n
    side = 1.0 / (2.0 * (n + lamda))
    w_mean = jnp.full((2 * n + 1,), side).at[0].set(lamda / (n + lamda))
    w_cov = w_mean.at[0].add(1.0 - alpha**2 + beta)
    return lamda, w_mean, w_cov


__all__ = [
    "sigma_points",
    "_get_sigma_points",
    "split_to_sigma_points",
    "unscented_weights",
]
