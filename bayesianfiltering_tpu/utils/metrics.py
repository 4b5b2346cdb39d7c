"""Error metrics, mixture moments, and divergences.

Covers the metric surface of the reference's utils (jax-native instead of
NumPy): ``mse``/``rmse`` (ref: gaussfiltax/utils.py:179-187), ``collapse``
moment-matching of a mixture (ref: gaussfiltax/utils.py:10-18),
``normal_KL_div`` (ref: gaussfiltax/utils.py:34-39), ``W_distance``
(ref: build/lib/codebase/utils.py:139-147), ``gaussian_logpdf``
(ref: gaussfiltax/utils.py:75-79) and the small scalar helpers ``gm``,
``loss``, ``dec_to_base`` (ref: gaussfiltax/utils.py:68-83,21-31).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from bayesianfiltering_tpu.distributions import mvn_logpdf


def mse(x_est: jax.Array, x_base: jax.Array) -> jax.Array:
    """Mean squared error, normalized by the number of timesteps.

    Reference semantics (ref: gaussfiltax/utils.py:179-182): the sum runs
    over *all* entries but the divisor is only the leading (time) dimension.
    """
    t = x_est.shape[0]
    return jnp.sum(jnp.square(x_est - x_base)) / t


def rmse(x_est: jax.Array, x_base: jax.Array) -> jax.Array:
    """Root MSE with the reference's time-only normalization
    (ref: gaussfiltax/utils.py:184-187)."""
    return jnp.sqrt(mse(x_est, x_base))


def collapse(means: jax.Array, covariances: jax.Array, weights: jax.Array):
    """Moment-match a Gaussian mixture to a single Gaussian.

    Vectorized equivalent of the reference's Python loop
    (ref: gaussfiltax/utils.py:10-18): one matvec + one batched outer-product
    contraction, so it fuses into surrounding filter code.

    Args:
        means: (M, dx) component means.
        covariances: (M, dx, dx) component covariances.
        weights: (M,) mixture weights.

    Returns:
        (mean, cov) of the collapsed Gaussian.
    """
    mean_out = jnp.einsum("m,mi->i", weights, means)
    diff = means - mean_out
    cov_out = jnp.einsum("m,mij->ij", weights, covariances) + jnp.einsum(
        "m,mi,mj->ij", weights, diff, diff
    )
    return mean_out, cov_out


def normal_KL_div(mean1, mean2, cov1, cov2) -> jax.Array:
    """KL(N1 || N2) between full-covariance Gaussians.

    Matches the reference formula (ref: gaussfiltax/utils.py:34-39),
    including its use of the elementwise product in the trace term
    ``trace(Omega * cov1)`` — kept because downstream experiments calibrated
    against it; the textbook ``trace(Omega @ cov1)`` variant is available as
    :func:`normal_kl`.
    """
    mean1, mean2 = jnp.atleast_1d(mean1), jnp.atleast_1d(mean2)
    cov1, cov2 = jnp.atleast_2d(cov1), jnp.atleast_2d(cov2)
    d = cov1.shape[-1]
    omega = jnp.linalg.inv(cov2)
    diff = mean1 - mean2
    kl = (
        jnp.log(jnp.linalg.det(cov2) / jnp.linalg.det(cov1))
        - d
        + diff @ omega @ diff
        + jnp.trace(omega * cov1)
    )
    return kl / 2


def normal_kl(mean1, mean2, cov1, cov2) -> jax.Array:
    """Textbook KL(N1 || N2) using Cholesky-based solves."""
    mean1, mean2 = jnp.atleast_1d(mean1), jnp.atleast_1d(mean2)
    cov1, cov2 = jnp.atleast_2d(cov1), jnp.atleast_2d(cov2)
    d = cov1.shape[-1]
    chol2 = jnp.linalg.cholesky(cov2)
    diff = mean2 - mean1
    z = jax.scipy.linalg.solve_triangular(chol2, diff, lower=True)
    sol = jax.scipy.linalg.cho_solve((chol2, True), cov1)
    chol1 = jnp.linalg.cholesky(cov1)
    logdet2 = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol2)))
    logdet1 = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol1)))
    return 0.5 * (jnp.trace(sol) + z @ z - d + logdet2 - logdet1)


def W_distance(means, covs, particles, weights) -> jax.Array:
    """Mixture-vs-particles spread metric (ref: build/lib/codebase/utils.py:139-147).

    Vectorized: sum_n sum_i w_n (cov_n + (mean_n - x_i)^2) / num_particles.
    """
    means = jnp.atleast_1d(means)
    num_prt = particles.shape[0]
    sq = jnp.square(means[:, None] - particles[None, :])  # (N, P, ...)
    per_n = covs[:, None] + sq
    return jnp.sum(weights[:, None] * jnp.sum(per_n, axis=tuple(range(2, per_n.ndim)))) / num_prt


def gaussian_logpdf(y, m, S) -> jax.Array:
    """Cholesky Gaussian log-density (ref: gaussfiltax/utils.py:75-79), jax-native."""
    return mvn_logpdf(jnp.squeeze(jnp.atleast_1d(y)), jnp.squeeze(jnp.atleast_1d(m)),
                      jnp.atleast_2d(S))


def gm(x, means, sigma, num_comp):
    """Scalar Gaussian-mixture pdf (ref: gaussfiltax/utils.py:68-72)."""
    means = jnp.asarray(means)
    z = (x - means) / sigma
    pdfs = jnp.exp(-0.5 * z**2) / (sigma * jnp.sqrt(2 * jnp.pi))
    return jnp.sum(pdfs) / num_comp


def loss(D, Pv, L, Nv, H) -> jax.Array:
    """Splitting-covariance objective (ref: gaussfiltax/utils.py:82-83)."""
    return (2 * L**2 / Nv) * jnp.trace(Pv - D) + 0.25 * jnp.trace(D @ H) ** 2


def dec_to_base(num: int, base: int) -> str:
    """Integer base conversion, max base 36 (ref: gaussfiltax/utils.py:21-31)."""
    if num <= 0:
        return ""
    digits = []
    while num > 0:
        dig = int(num % base)
        digits.append(str(dig) if dig < 10 else chr(ord("A") + dig - 10))
        num //= base
    return "".join(reversed(digits))


__all__ = [
    "mse",
    "rmse",
    "collapse",
    "normal_KL_div",
    "normal_kl",
    "W_distance",
    "gaussian_logpdf",
    "gm",
    "loss",
    "dec_to_base",
]
